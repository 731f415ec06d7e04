"""Multi-device bundle adjustment: frame-block sharding over a Mesh.

The reference is single-process and single-threaded (SURVEY.md section
2.3); this module is the multi-device capability it never had.  The frame
axis — the reference's only batch axis
(ref: lib/rust/mmscenegraph/src/scene/flat.rs:172 evaluates all frames in
a flat array) — becomes the sharded data axis:

  * animated attribute channels (A, F) are sharded along F;
  * each device evaluates its own frame block and accumulates its local
    contribution J_f^T J_f and J_f^T r_f to the normal equations of the
    *shared* (static) parameters;
  * one psum over the 'frames' mesh axis reduces the camera system,
    which is small and replicated — the classic distributed-BA
    reduced-camera-system pattern (Schur elimination of per-frame
    parameters happens block-locally).

Collectives are XLA psums (NCCL between GPUs); nothing here is
device-count specific, so the same code runs on a virtual CPU mesh or
on the cards of one host.
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mayamatchmovesolver_tpu.scene.attrblock import AttrBlock
from mayamatchmovesolver_tpu.solver import linalg
from mayamatchmovesolver_tpu.solver import problem as problem_mod



def make_frame_mesh(devices=None, axis_name="frames"):
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (axis_name,))


def _local_problem(problem, anim_block, mask_block, num_local_frames):
    """Rebuild the problem as seen by one shard: its anim columns are the
    whole (local) frame range."""
    attrs_local = AttrBlock(
        static_values=problem.attrs.static_values, anim_values=anim_block
    )
    return dataclasses.replace(
        problem,
        attrs=attrs_local,
        frame_indices=jnp.arange(num_local_frames, dtype=jnp.int32),
        marker_frame_mask=mask_block,
    )


class ShardedLMState(NamedTuple):
    params: jax.Array
    cost: jax.Array
    jtj: jax.Array
    jtr: jax.Array
    mu: jax.Array
    nu: jax.Array
    it: jax.Array
    stop: jax.Array
    nfev: jax.Array  # counted residual evaluations (real, not derived)
    njev: jax.Array  # counted Jacobian evaluations


def sharded_normal_system(problem, mesh, axis_name="frames"):
    """Returns a jitted fn params -> (cost, jtj, jtr), psum-reduced.

    Requires: all parameters static (param_frames == -1); solve frames ==
    baked frames (problem.frame_indices covers the anim axis in order).
    """
    n = mesh.devices.size
    num_frames = int(problem.num_frames)
    if num_frames % n != 0:
        raise ValueError(
            "frame count %d not divisible by %d devices — pad frames"
            % (num_frames, n)
        )
    local_frames = num_frames // n

    def local_fn(static_values, anim_block, mask_block, params):
        # All array state enters as shard_map operands (closing over
        # committed arrays mixes Auto/Manual mesh contexts).
        prob = _local_problem(
            dataclasses.replace(
                problem,
                attrs=AttrBlock(
                    static_values=static_values,
                    anim_values=anim_block,
                ),
            ),
            anim_block,
            mask_block,
            local_frames,
        )

        def residual(p):
            attrs = problem_mod.insert_parameters(prob, p)
            r, _ = problem_mod.measure_residuals(prob, attrs)
            return r

        r = residual(params)
        j = jax.jacfwd(residual)(params)
        jtj = jax.lax.psum(j.T @ j, axis_name)
        jtr = jax.lax.psum(j.T @ r, axis_name)
        cost = jax.lax.psum(0.5 * jnp.sum(r * r), axis_name)
        return cost, jtj, jtr

    fn = shard_map(
        local_fn,
        mesh=mesh,
        in_specs=(P(), P(None, axis_name), P(None, axis_name), P()),
        out_specs=(P(), P(), P()),
    )

    @jax.jit
    def wrapped(params):
        # jit is load-bearing: an EAGER shard_map dispatches every
        # primitive separately across the mesh (measured ~2 min per
        # evaluation on an 8-virtual-device CPU mesh vs <1 s compiled).
        return fn(
            problem.attrs.static_values,
            problem.attrs.anim_values,
            problem.marker_frame_mask,
            params,
        )

    return wrapped


def sharded_levenberg_marquardt(
    problem,
    x0,
    mesh,
    max_iterations=20,
    tau=1e-3,
    eps1=1e-6,
    eps2=1e-6,
    eps3=1e-6,
    axis_name="frames",
):
    """LM over frame-sharded normal equations.  The damping loop runs
    replicated; each iteration re-reduces JtJ/Jtr across the mesh.

    Semantics mirror solver/lm.py (which mirrors the reference's
    cminpack driver, adjust_cminpack_lmdif.cpp:61); only the data layout
    differs.
    """
    # Full f32 for the normal equations (see ba.solve_ba).
    with jax.default_matmul_precision("float32"):
        return _sharded_lm_impl(
            problem, x0, mesh, max_iterations, tau, eps1, eps2, eps3,
            axis_name,
        )


def _sharded_lm_impl(problem, x0, mesh, max_iterations, tau, eps1,
                     eps2, eps3, axis_name):
    normal_fn = sharded_normal_system(problem, mesh, axis_name)

    cost0, jtj0, jtr0 = normal_fn(x0)
    # Dimensionless Marquardt mu: damping is mu*diag(JtJ) (see
    # solver/lm.py lm_init).
    mu0 = jnp.asarray(tau, x0.dtype)

    def cond(s):
        return (s.stop == 0) & (s.it < max_iterations)

    def body(s):
        # The state CARRIES the normal system at the current iterate
        # (like solver/lm.py): one sharded evaluation per iteration —
        # the trial point's system doubles as the next iteration's on
        # acceptance and is discarded via select on rejection.
        d = jnp.maximum(jnp.diag(s.jtj), 1e-12)
        dx = linalg.solve_spd(s.jtj + s.mu * jnp.diag(d), -s.jtr)
        x_new = s.params + dx
        cost_new, jtj_new, jtr_new = normal_fn(x_new)

        predicted = jnp.maximum(
            0.5 * jnp.dot(dx, s.mu * d * dx - s.jtr), 1e-300
        )
        rho = (s.cost - cost_new) / predicted
        accept = (rho > 0.0) & jnp.all(jnp.isfinite(dx))

        mu_new = jnp.where(
            accept,
            s.mu * jnp.maximum(1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3),
            s.mu * s.nu,
        )
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)
        params = jnp.where(accept, x_new, s.params)
        cost2 = jnp.where(accept, cost_new, s.cost)
        jtj2 = jnp.where(accept, jtj_new, s.jtj)
        jtr2 = jnp.where(accept, jtr_new, s.jtr)

        small_step = jnp.linalg.norm(dx) <= eps2 * (
            jnp.linalg.norm(s.params) + eps2
        )
        small_grad = jnp.max(jnp.abs(jtr2)) <= eps1
        small_red = accept & (
            (s.cost - cost_new) <= eps3 * jnp.maximum(s.cost, 1e-300)
        )
        stop = jnp.where(
            small_grad, 3, jnp.where(small_step, 2,
                                     jnp.where(small_red, 1, 0))
        ).astype(jnp.int32)
        return ShardedLMState(
            params=params, cost=cost2, jtj=jtj2, jtr=jtr2,
            mu=mu_new, nu=nu_new, it=s.it + 1, stop=stop,
            nfev=s.nfev + 1, njev=s.njev + 1,
        )

    init = ShardedLMState(
        params=x0,
        cost=cost0,
        jtj=jtj0,
        jtr=jtr0,
        mu=jnp.asarray(mu0, x0.dtype),
        nu=jnp.asarray(2.0, x0.dtype),
        it=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(0, jnp.int32),
        nfev=jnp.asarray(1, jnp.int32),
        njev=jnp.asarray(1, jnp.int32),
    )
    return jax.lax.while_loop(cond, body, init)


def shard_problem_arrays(problem, mesh, axis_name="frames"):
    """Device_put the frame-sharded leaves onto the mesh."""
    anim_sharding = NamedSharding(mesh, P(None, axis_name))
    anim = jax.device_put(problem.attrs.anim_values, anim_sharding)
    mask = jax.device_put(problem.marker_frame_mask, anim_sharding)
    attrs = AttrBlock(
        static_values=jax.device_put(
            problem.attrs.static_values, NamedSharding(mesh, P())
        ),
        anim_values=anim,
    )
    return dataclasses.replace(problem, attrs=attrs,
                               marker_frame_mask=mask)
