"""Levenberg-Marquardt core, fully jit-compiled.

Replacement for the reference's cminpack lmdif/lmder drivers
(ref: src/mmSolver/adjust/adjust_cminpack_lmdif.cpp:61-202,
adjust_cminpack_lmder.cpp): analytic Jacobians via jax.jacfwd (the
reference computes forward/central finite differences through the scene
graph, adjust_solveFunc.cpp:305-525), Marquardt diagonal damping like
cminpack's mode-1 auto scaling, and the classic Nielsen mu/nu update.
The whole minimization — residuals, Jacobian, normal equations, damping
loop — is one lax.while_loop in one XLA program: zero host round-trips
per iteration.

Stop reasons mirror cminpack's info codes in spirit:
  1 ftol (relative cost reduction), 2 xtol (step size), 3 gtol
  (gradient inf-norm), 4 max iterations, 5 singular/failed step.
"""

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from mayamatchmovesolver_tpu.solver import linalg


class LMConfig(NamedTuple):
    """Tolerances follow the reference solver flags: iterations, tau,
    eps1 (gtol), eps2 (xtol), eps3 (ftol)
    (ref: docs/source/commands_solve.rst:28-36, adjust_data.h:133-186)."""

    max_iterations: int = 20
    tau: float = 1e-3
    eps1: float = 1e-6  # gradient inf-norm tolerance (gtol)
    eps2: float = 1e-6  # parameter step tolerance (xtol)
    eps3: float = 1e-6  # relative cost-reduction tolerance (ftol)
    jacobian_mode: str = "fwd"  # 'fwd' (n_params JVPs) or 'rev' (m VJPs)


class LMResult(NamedTuple):
    x: jax.Array
    residuals: jax.Array
    cost: jax.Array  # 0.5 * ||r||^2
    cost_initial: jax.Array
    iterations: jax.Array
    func_evals: jax.Array
    jacobian_evals: jax.Array
    stop_reason: jax.Array  # int32, see module docstring
    gradient_norm: jax.Array


class _State(NamedTuple):
    x: jax.Array
    r: jax.Array
    jtj: jax.Array
    jtr: jax.Array
    cost: jax.Array
    mu: jax.Array
    nu: jax.Array
    it: jax.Array
    nfev: jax.Array
    njev: jax.Array
    stop: jax.Array


# Public alias: the resumable-solve state passed between lm_init /
# lm_run_block dispatches (and serialized by solver/checkpoint.py).
LMState = _State


def _make_normal_system(residual_fn, mode):
    """residual + JtJ + Jtr in one pass.

    fwd mode: jax.linearize shares the primal computation with the n
    tangent passes (one scene evaluation total per system, vs the
    reference's 1 + n full finite-difference evaluations,
    adjust_solveFunc.cpp:305-525).  rev mode: one VJP per residual row
    via jacrev (better when m << n).
    """
    # The J^T J / J^T r reductions are pinned to full float32: on the
    # GPU a float32 matmul at default precision may run in TF32 (a
    # 10-bit mantissa), which loses the conditioning the normal
    # equations need (CPU matmuls are always full precision, so CPU
    # tests cannot catch a missing pin).  Scene evaluation inside
    # residual_fn keeps the caller's precision.
    _hi = jax.lax.Precision.HIGHEST

    if mode == "rev":
        jac_fn = jax.jacrev(residual_fn)

        def system(x):
            r = residual_fn(x)
            j = jac_fn(x)
            return (
                r,
                jnp.matmul(j.T, j, precision=_hi),
                jnp.matmul(j.T, r, precision=_hi),
            )

        return system

    def system(x):
        r, lin = jax.linearize(residual_fn, x)
        basis = jnp.eye(x.shape[0], dtype=x.dtype)
        jt = jax.vmap(lin)(basis)  # (n, m): row i = J @ e_i
        return (
            r,
            jnp.matmul(jt, jt.T, precision=_hi),
            jnp.matmul(jt, r, precision=_hi),
        )

    return system


def _solve_damped(jtj, jtr, mu, diag_floor=1e-12):
    """Solve (JtJ + mu*diag(JtJ)) dx = -Jtr via Cholesky.

    Marquardt scaling (damping proportional to diag) matches cminpack's
    internal column scaling mode used by the reference
    (ref: adjust_cminpack_lmdif.cpp mode=1).  The system is solved in
    Jacobi-preconditioned form — S (JtJ + mu D) S y = -S Jtr with
    S = diag(JtJ)^-1/2, dx = S y — which is the same linear system but
    with unit diagonal, so mixed-unit parameter sets (mm focal +
    degrees + world units: column norms spanning 3+ decades) stay
    within float32's conditioning budget.  Uses the package's own
    Cholesky (solver/linalg.py).
    """
    d = jnp.maximum(jnp.diag(jtj), diag_floor)
    s = jax.lax.rsqrt(d)
    a = jtj * (s[:, None] * s[None, :])
    a = a + mu * jnp.eye(a.shape[0], dtype=a.dtype)
    # The factorization's inner products must accumulate in full f32
    # (TF32 products lose the conditioning the Jacobi scaling bought).
    with jax.default_matmul_precision("float32"):
        y = linalg.solve_spd(a, -(s * jtr))
    return s * y


def lm_init(residual_fn: Callable, x0, config: LMConfig = LMConfig()):
    """Initial LM state: residual + normal system at x0.  Jittable.

    mu is DIMENSIONLESS (Marquardt convention): the damping term is
    mu*diag(JtJ), so mu0 = tau directly.  (Nielsen's variant scales
    mu0 by max(diag) because it damps with mu*I; mixing the two — as
    an earlier revision did — over-damps pixel-unit problems by ~1e5
    and stalls the first step below xtol.)"""
    normal_system = _make_normal_system(residual_fn, config.jacobian_mode)
    x0 = jnp.asarray(x0)
    r0, jtj0, jtr0 = normal_system(x0)
    cost0 = 0.5 * jnp.sum(r0 * r0)
    mu0 = config.tau
    return _State(
        x=x0,
        r=r0,
        jtj=jtj0,
        jtr=jtr0,
        cost=cost0,
        mu=jnp.asarray(mu0, x0.dtype),
        nu=jnp.asarray(2.0, x0.dtype),
        it=jnp.asarray(0, jnp.int32),
        nfev=jnp.asarray(1, jnp.int32),
        njev=jnp.asarray(1, jnp.int32),
        stop=jnp.asarray(0, jnp.int32),
    )


def lm_run_block(
    residual_fn: Callable,
    state: _State,
    config: LMConfig = LMConfig(),
    iteration_limit=None,
) -> _State:
    """Run LM iterations until convergence or `iteration_limit` total
    iterations (a dynamic scalar — the same compiled program serves
    every block).  Resumable: feed the returned state back in with a
    larger limit.  This is the cooperative-interruption primitive the
    reference gets from checking MComputation::isInterruptRequested
    inside its residual callback (adjust_solveFunc.cpp:567-571): the
    host regains control between blocks with the full solver state.
    """
    normal_system = _make_normal_system(residual_fn, config.jacobian_mode)
    if iteration_limit is None:
        iteration_limit = config.max_iterations
    limit = jnp.minimum(
        jnp.asarray(iteration_limit, jnp.int32), config.max_iterations
    )

    def cond(s: _State):
        return (s.stop == 0) & (s.it < limit)

    body = _make_body(normal_system, config)
    return jax.lax.while_loop(cond, body, state)


def lm_finalize(state: _State, cost_initial) -> LMResult:
    """Wrap a (possibly interrupted) state as an LMResult."""
    stop = jnp.where(state.stop == 0, 4, state.stop)
    return LMResult(
        x=state.x,
        residuals=state.r,
        cost=state.cost,
        cost_initial=cost_initial,
        iterations=state.it,
        func_evals=state.nfev,
        jacobian_evals=state.njev,
        stop_reason=stop,
        gradient_norm=jnp.max(jnp.abs(state.jtr)),
    )


def levenberg_marquardt(
    residual_fn: Callable, x0, config: LMConfig = LMConfig()
) -> LMResult:
    """Minimize 0.5*||residual_fn(x)||^2.  Jittable end-to-end."""
    state = lm_init(residual_fn, x0, config)
    final = lm_run_block(residual_fn, state, config)
    return lm_finalize(final, state.cost)


def _make_body(normal_system, config: LMConfig):
    """One LM iteration (the while_loop body), shared by the fused and
    the block-resumable drivers."""

    def body(s: _State):
        dx = _solve_damped(s.jtj, s.jtr, s.mu)
        dx_ok = jnp.all(jnp.isfinite(dx))
        dx = jnp.where(dx_ok, dx, 0.0)

        xnorm = jnp.linalg.norm(s.x)
        step_small = jnp.linalg.norm(dx) <= config.eps2 * (
            xnorm + config.eps2
        )

        x_new = s.x + dx
        # One linearize pass gives residual AND normal system at the
        # trial point; on rejection it is discarded via select.  (The
        # main consumer is the vmapped per-frame solve, where a
        # lax.cond would execute both branches anyway.)
        r_new, jtj_new, jtr_new = normal_system(x_new)
        cost_new = 0.5 * jnp.sum(r_new * r_new)

        d = jnp.maximum(jnp.diag(s.jtj), 1e-12)
        predicted = 0.5 * jnp.dot(dx, s.mu * d * dx - s.jtr)
        predicted = jnp.maximum(predicted, 1e-300)
        rho = (s.cost - cost_new) / predicted

        accept = dx_ok & (rho > 0.0) & jnp.isfinite(cost_new)

        r2 = jnp.where(accept, r_new, s.r)
        jtj2 = jnp.where(accept, jtj_new, s.jtj)
        jtr2 = jnp.where(accept, jtr_new, s.jtr)

        mu_accept = s.mu * jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
        )
        mu_new = jnp.where(accept, mu_accept, s.mu * s.nu)
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)

        cost2 = jnp.where(accept, cost_new, s.cost)
        x2 = jnp.where(accept, x_new, s.x)

        gnorm = jnp.max(jnp.abs(jtr2))
        ftol_hit = accept & (
            (s.cost - cost_new) <= config.eps3 * jnp.maximum(s.cost, 1e-300)
        )
        gtol_hit = gnorm <= config.eps1
        xtol_hit = step_small
        failed = (~dx_ok) | (~jnp.isfinite(mu_new))

        stop = jnp.where(
            failed,
            5,
            jnp.where(
                gtol_hit,
                3,
                jnp.where(xtol_hit, 2, jnp.where(ftol_hit, 1, 0)),
            ),
        ).astype(jnp.int32)

        return _State(
            x=x2,
            r=r2,
            jtj=jtj2,
            jtr=jtr2,
            cost=cost2,
            mu=mu_new,
            nu=nu_new,
            it=s.it + 1,
            nfev=s.nfev + 1 + accept.astype(jnp.int32),
            njev=s.njev + accept.astype(jnp.int32),
            stop=stop,
        )

    return body
