"""Distributed bundle adjustment: frame-sharded Schur + collective CG.

The scalable multi-host path (BASELINE config #5: keyframe-block
sharded 1000-frame shots).  Everything the reference lacks
(SURVEY.md section 2.3 — it is single-process): the frame axis is
sharded over the device mesh; each device owns its frame block's
camera parameters, observations and Jacobian blocks; bundles (the
3D points) and the shared border parameters (static focal / lens
coefficients — the arrowhead; ref: docs/source/solver_design.rst:
188-218) are the *replicated* state reduced across devices.

Per LM iteration:
  1. each device builds its local per-observation Jacobian blocks
     (solver/ba.py assemble_normal_blocks) — zero communication;
  2. bundle blocks A_b, border blocks (Hbs, Hss, g_s) and gradients
     are psum-reduced ((B, 3, 3) + (B, 3) + O(S) — tiny);
  3. the reduced arrowhead system over [camera blocks | border] is
     solved by preconditioned conjugate gradients where each matvec
     costs TWO psums of O(B)+O(S) floats:
       v_b   = sum_{m,f} W_mf x_f + Hbs_b x_s            (psum)
       z_b   = A_b^-1 v_b
       out_c = B_f x_f + Hcs_f x_s - sum_m W_mf^T z_b     (local)
       out_s = psum(sum_f Hcs_f^T x_f) + Hss x_s
               - sum_b Hbs_b^T z_b                        (psum)
     with block-Jacobi preconditioning (exact per-frame Schur
     diagonal + the border's own reduced block);
  4. bundle back-substitution is local + one psum.

So the per-iteration communication volume is O(B + S) floats times
(CG iterations + 3) — independent of frame count: scaling efficiency
stays high as frames/devices grow, which is the whole point of
Schur-complement distribution.

The LM loop uses the true gain ratio with Nielsen's mu update and the
same eps1/2/3 stopping semantics as solver/lm.py — converged problems
stop early instead of burning max_iterations.

Objective parity with the single-device path: every residual and
Jacobian block is produced by solver/ba.py's _observation_residual via
ba_cost / assemble_normal_blocks on a dataclasses.replace'd view of
the SAME BAProblem, so the static loss_type/loss_scale fields (robust
loss: trivial / soft-L1 / Cauchy, ref: adjust_base.cpp:132-187), the
behind-camera inflation and the NaN guards are identical here — an
outlier-contaminated shot computes the same objective sharded or not
(tests/test_parallel/test_sharded.py::
test_sharded_ba_robust_loss_outliers).  Box-constrained attributes
never reach either BA backend: the bridge classifies them out to the
dense LM's sine reparameterization before dispatch
(solver/ba_bridge.py _attr_has_bounds).
"""

import dataclasses
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from mayamatchmovesolver_tpu.core import transform as tfm_math
from mayamatchmovesolver_tpu.solver import ba as ba_mod
from mayamatchmovesolver_tpu.solver import linalg



class ShardedBAResult(NamedTuple):
    cam_params: jax.Array  # (F, 6) global
    bnd_params: jax.Array  # (B, 3)
    shared_params: jax.Array  # (S,)
    cost: jax.Array
    cost_initial: jax.Array
    iterations: jax.Array
    stop_reason: jax.Array  # 1 ftol, 2 xtol, 3 gtol, 4 maxiter
    func_evals: int = 0  # counted trial-cost evaluations (+ initial)
    jacobian_evals: int = 0  # counted block assemblies


def shard_ba_problem(problem: ba_mod.BAProblem, mesh: Mesh,
                     axis_name="frames") -> ba_mod.BAProblem:
    """Device_put the frame-axis leaves onto the mesh."""
    f_shard = NamedSharding(mesh, P(None, axis_name))
    cam_shard = NamedSharding(mesh, P(axis_name, None))
    rep = NamedSharding(mesh, P())
    return dataclasses.replace(
        problem,
        marker_uv=jax.device_put(problem.marker_uv, f_shard),
        weight=jax.device_put(problem.weight, f_shard),
        mkr_bnd_index=jax.device_put(problem.mkr_bnd_index, rep),
        mkr_cam_block=jax.device_put(problem.mkr_cam_block, rep),
        cam_params=jax.device_put(problem.cam_params, cam_shard),
        bnd_params=jax.device_put(problem.bnd_params, rep),
        shared_params=jax.device_put(problem.shared_params, rep),
        intrinsics=jax.device_put(problem.intrinsics, cam_shard),
        lens_params=jax.device_put(problem.lens_params, rep),
        lens_pixel_aspect=jax.device_put(
            problem.lens_pixel_aspect, rep
        ),
    )


def sharded_solve_ba(
    problem: ba_mod.BAProblem,
    mesh: Mesh,
    max_iterations=20,
    tau=1e-3,
    cg_iterations=30,
    eps1=1e-8,
    eps2=1e-8,
    eps3=1e-8,
    axis_name="frames",
) -> ShardedBAResult:
    """Frame-sharded LM/Schur/CG bundle adjustment with a replicated
    shared-parameter border.

    problem arrays may be host-global; they are sharded on entry.
    Returns globally-assembled results.
    """
    if problem.num_cameras > 1:
        raise ValueError(
            "the frame-sharded BA supports one camera per problem; "
            "solve multi-camera rigs with ba.solve_ba(linear_solver="
            "'cg') on one chip, or split per camera"
        )
    num_frames = problem.cam_params.shape[0]
    n_dev = mesh.devices.size
    if num_frames % n_dev != 0:
        raise ValueError(
            "frame count %d not divisible by %d devices"
            % (num_frames, n_dev)
        )
    num_bundles = problem.bnd_params.shape[0]
    num_shared = int(problem.shared_params.shape[0])

    def lm_loop(marker_uv, weight, mkr_bnd_index, mkr_cam_block,
                cam_params, bnd_params, shared_params, intrinsics):
        """Runs per-shard; explicit collectives."""

        def local_problem(cam, bnd):
            return dataclasses.replace(
                problem,
                marker_uv=marker_uv,
                weight=weight,
                mkr_bnd_index=mkr_bnd_index,
                mkr_cam_block=mkr_cam_block,
                cam_params=cam,
                bnd_params=bnd,
                intrinsics=intrinsics,
            )

        def cost_of(cam, bnd, sh):
            c = ba_mod.ba_cost(local_problem(cam, bnd), cam, bnd, sh)
            return jax.lax.psum(c, axis_name)

        def gn_step(cam, bnd, sh, mu):
            blocks = ba_mod.assemble_normal_blocks(
                local_problem(cam, bnd), cam, bnd, sh
            )
            cost = jax.lax.psum(blocks.cost, axis_name)

            # psum the bundle/border members (frame-local members stay
            # local: b_blocks, g_cam, w_mf, hcs).
            a_blocks = jax.lax.psum(blocks.a_blocks, axis_name)
            g_bnd = jax.lax.psum(blocks.g_bnd, axis_name)
            if num_shared:
                hbs = jax.lax.psum(blocks.hbs, axis_name)
                hss = jax.lax.psum(blocks.hss, axis_name)
                g_sh = jax.lax.psum(blocks.g_sh, axis_name)
            else:
                hbs, hss, g_sh = blocks.hbs, blocks.hss, blocks.g_sh
            w_mf = blocks.w_mf
            hcs = blocks.hcs

            p_c = cam.shape[-1]
            eye_c = jnp.eye(p_c, dtype=cam.dtype)
            a_damped = ba_mod._damp(a_blocks, mu)
            b_damped = ba_mod._damp(blocks.b_blocks, mu)
            a_inv = tfm_math.inverse3(a_damped)
            a_inv_m = a_inv[mkr_bnd_index]

            g_bnd_pre = jnp.einsum("mab,mb->ma", a_inv_m,
                                   g_bnd[mkr_bnd_index])
            rhs_c = -(blocks.g_cam - jnp.einsum(
                "mfab,ma->fb", w_mf, g_bnd_pre
            ))
            if num_shared:
                hss_damped = ba_mod._damp(hss, mu)
                y_bs = jnp.einsum("bac,bcs->bas", a_inv, hbs)
                rhs_s = -(g_sh - jnp.einsum("bas,ba->s", y_bs, g_bnd))
            else:
                y_bs = jnp.zeros(
                    (num_bundles, 3, 0), cam.dtype
                )
                hss_damped = hss
                rhs_s = jnp.zeros((0,), cam.dtype)

            def matvec(x_c, x_s):
                # One arrowhead-reduced-system matvec; two psums.
                v_m = jnp.einsum("mfab,fb->ma", w_mf, x_c)
                v_b = jax.lax.psum(
                    jax.ops.segment_sum(
                        v_m, mkr_bnd_index, num_segments=num_bundles
                    ),
                    axis_name,
                )
                if num_shared:
                    v_b = v_b + jnp.einsum("bas,s->ba", hbs, x_s)
                z_b = jnp.einsum("bac,bc->ba", a_inv, v_b)
                z_m = z_b[mkr_bnd_index]
                out_c = jnp.einsum("fab,fb->fa", b_damped, x_c)
                out_c = out_c - jnp.einsum("mfab,ma->fb", w_mf, z_m)
                if num_shared:
                    out_c = out_c + jnp.einsum("fas,s->fa", hcs, x_s)
                    out_s = jax.lax.psum(
                        jnp.einsum("fas,fa->s", hcs, x_c), axis_name
                    )
                    out_s = out_s + hss_damped @ x_s
                    out_s = out_s - jnp.einsum("bas,ba->s", hbs, z_b)
                else:
                    out_s = x_s
                return out_c, out_s

            # Preconditioner: the *exact* per-frame Schur diagonal
            # block S_ff = B_f - sum_m W_mf^T A_m^-1 W_mf (all local —
            # no communication), plus the border's reduced block.
            # Plain B_f block-Jacobi is far too weak for this
            # pixel^2-scaled system and lets CG diverge.
            s_diag = b_damped - jnp.einsum(
                "mfab,mac,mfcd->fbd", w_mf, a_inv_m, w_mf
            )
            s_diag = s_diag + 1e-8 * jnp.maximum(
                jnp.diagonal(s_diag, axis1=-2, axis2=-1), 1e-12
            )[..., None] * eye_c
            if num_shared:
                s_ss = hss_damped - jnp.einsum("bas,bat->st", hbs, y_bs)
                s_ss = s_ss + 1e-8 * jnp.maximum(
                    jnp.diag(s_ss), 1e-12
                ) * jnp.eye(num_shared, dtype=cam.dtype)

            def precond(v_c, v_s):
                p_cc = linalg.cholesky_solve(s_diag, v_c)
                if num_shared:
                    p_ss = linalg.cholesky_solve(s_ss, v_s)
                else:
                    p_ss = v_s
                return p_cc, p_ss

            def pdot(a_c, a_s, b_c, b_s):
                # Camera part varies over shards (psum); border part is
                # replicated (plain sum, NOT psum'd — psumming would
                # overcount it n_dev times).
                return jax.lax.psum(
                    jnp.sum(a_c * b_c), axis_name
                ) + jnp.sum(a_s * b_s)

            # Preconditioned CG with breakdown guards: a non-positive
            # curvature (rounding-induced indefiniteness) freezes the
            # iterate instead of exploding.
            x0_c = jnp.zeros_like(rhs_c)
            x0_s = jnp.zeros_like(rhs_s)
            r0_c, r0_s = rhs_c, rhs_s
            z0_c, z0_s = precond(r0_c, r0_s)

            def cg_body(_, state):
                x_c, x_s, r_c, r_s, z_c, z_s, p_cv, p_sv = state
                ap_c, ap_s = matvec(p_cv, p_sv)
                rz = pdot(r_c, r_s, z_c, z_s)
                pap = pdot(p_cv, p_sv, ap_c, ap_s)
                ok = (pap > 0.0) & (rz > 0.0)
                alpha = jnp.where(ok, rz / jnp.where(ok, pap, 1.0), 0.0)
                x_c = x_c + alpha * p_cv
                x_s = x_s + alpha * p_sv
                r_c_new = jnp.where(ok, r_c - alpha * ap_c, r_c)
                r_s_new = jnp.where(ok, r_s - alpha * ap_s, r_s)
                z_c_new, z_s_new = precond(r_c_new, r_s_new)
                beta = jnp.where(
                    ok,
                    pdot(r_c_new, r_s_new, z_c_new, z_s_new)
                    / jnp.where(ok, rz, 1.0),
                    0.0,
                )
                p_c_new = jnp.where(ok, z_c_new + beta * p_cv, p_cv)
                p_s_new = jnp.where(ok, z_s_new + beta * p_sv, p_sv)
                return (x_c, x_s, r_c_new, r_s_new, z_c_new, z_s_new,
                        p_c_new, p_s_new)

            dx_cam, dx_sh, _, _, _, _, _, _ = jax.lax.fori_loop(
                0, cg_iterations, cg_body,
                (x0_c, x0_s, r0_c, r0_s, z0_c, z0_s, z0_c, z0_s),
            )

            # Bundle back-substitution (one psum).
            w_dx = jax.lax.psum(
                jax.ops.segment_sum(
                    jnp.einsum("mfab,fb->ma", w_mf, dx_cam),
                    mkr_bnd_index,
                    num_segments=num_bundles,
                ),
                axis_name,
            )
            rhs_b = g_bnd + w_dx
            if num_shared:
                rhs_b = rhs_b + jnp.einsum("bas,s->ba", hbs, dx_sh)
            dx_bnd = -jnp.einsum("bij,bj->bi", a_inv, rhs_b)

            # Gradient inf-norm + predicted reduction (replicated).
            gnorm = jax.lax.pmax(
                jnp.max(jnp.abs(blocks.g_cam)), axis_name
            )
            gnorm = jnp.maximum(gnorm, jnp.max(jnp.abs(g_bnd)))
            if num_shared:
                gnorm = jnp.maximum(gnorm, jnp.max(jnp.abs(g_sh)))
            diag_b = jnp.maximum(jnp.diagonal(
                blocks.b_blocks, axis1=-2, axis2=-1), 1e-12)
            diag_a = jnp.maximum(jnp.diagonal(
                a_blocks, axis1=-2, axis2=-1), 1e-12)
            pred = jax.lax.psum(
                0.5 * mu * jnp.sum(diag_b * dx_cam * dx_cam)
                - 0.5 * jnp.sum(dx_cam * blocks.g_cam),
                axis_name,
            )
            pred = pred + 0.5 * mu * jnp.sum(diag_a * dx_bnd * dx_bnd)
            pred = pred - 0.5 * jnp.sum(dx_bnd * g_bnd)
            if num_shared:
                diag_s = jnp.maximum(jnp.diag(hss), 1e-12)
                pred = pred + 0.5 * (
                    mu * jnp.sum(diag_s * dx_sh * dx_sh)
                    - jnp.sum(dx_sh * g_sh)
                )
            return cost, dx_cam, dx_bnd, dx_sh, gnorm, pred

        cost0 = cost_of(cam_params, bnd_params, shared_params)
        mu0 = jnp.asarray(tau, cam_params.dtype)

        def cond(s):
            cam, bnd, sh, cost, mu, nu, it, stop, nfev, njev = s
            return (stop == 0) & (it < max_iterations)

        def body(s):
            cam, bnd, sh, cost, mu, nu, it, stop, nfev, njev = s
            _, dx_cam, dx_bnd, dx_sh, gnorm, pred = gn_step(
                cam, bnd, sh, mu
            )
            # Acceptance must be decided from *replicated* quantities
            # only (shard_map tracks varying axes): dx_bnd/dx_sh and
            # the psum-reduced cost are replicated; a NaN in any
            # shard's dx_cam poisons cost_new, so it is caught there.
            cam_new = cam + dx_cam
            bnd_new = bnd + dx_bnd
            sh_new = sh + dx_sh
            cost_new = cost_of(cam_new, bnd_new, sh_new)
            pred = jnp.maximum(pred, 1e-300)
            rho = (cost - cost_new) / pred
            accept = (
                (rho > 0.0)
                & jnp.isfinite(cost_new)
                & jnp.all(jnp.isfinite(dx_bnd))
                & jnp.all(jnp.isfinite(dx_sh))
            )
            cam = jnp.where(accept, cam_new, cam)
            bnd = jnp.where(accept, bnd_new, bnd)
            sh = jnp.where(accept, sh_new, sh)
            mu_accept = mu * jnp.maximum(
                1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
            )
            mu_new = jnp.where(accept, mu_accept, mu * nu)
            nu_new = jnp.where(accept, 2.0, nu * 2.0)

            # eps1/2/3 stopping (replicated scalars; step/x norms are
            # psum-reduced over the frame shards).
            step_sq = jax.lax.psum(
                jnp.sum(dx_cam * dx_cam), axis_name
            ) + jnp.sum(dx_bnd * dx_bnd) + jnp.sum(dx_sh * dx_sh)
            x_sq = jax.lax.psum(
                jnp.sum(cam * cam), axis_name
            ) + jnp.sum(bnd * bnd) + jnp.sum(sh * sh)
            step_norm = jnp.sqrt(step_sq)
            x_norm = jnp.sqrt(x_sq)
            ftol_hit = accept & (
                (cost - cost_new) <= eps3 * jnp.maximum(cost, 1e-300)
            )
            xtol_hit = step_norm <= eps2 * (x_norm + eps2)
            gtol_hit = gnorm <= eps1
            stop_new = jnp.where(
                gtol_hit,
                3,
                jnp.where(
                    xtol_hit, 2, jnp.where(ftol_hit, 1, 0)
                ),
            ).astype(jnp.int32)
            cost = jnp.where(accept, cost_new, cost)
            # Counted evaluations: one block assembly (gn_step) and
            # one trial cost per iteration.
            return (cam, bnd, sh, cost, mu_new, nu_new, it + 1,
                    stop_new, nfev + 1, njev + 1)

        (cam, bnd, sh, cost, mu, nu, it, stop, nfev,
         njev) = jax.lax.while_loop(
            cond,
            body,
            (cam_params, bnd_params, shared_params, cost0,
             mu0, jnp.asarray(2.0, cam_params.dtype),
             jnp.asarray(0, jnp.int32), jnp.asarray(0, jnp.int32),
             jnp.asarray(1, jnp.int32), jnp.asarray(0, jnp.int32)),
        )
        stop = jnp.where(stop == 0, 4, stop)
        return cam, bnd, sh, cost, cost0, it, stop, nfev, njev

    fn = shard_map(
        lm_loop,
        mesh=mesh,
        in_specs=(
            P(None, axis_name),  # marker_uv
            P(None, axis_name),  # weight
            P(),                 # mkr_bnd_index
            P(),                 # mkr_cam_block
            P(axis_name, None),  # cam_params
            P(),                 # bnd_params
            P(),                 # shared_params
            P(axis_name, None),  # intrinsics
        ),
        out_specs=(
            P(axis_name, None),  # cam
            P(),                 # bnd
            P(),                 # shared
            P(),                 # cost
            P(),                 # cost0
            P(),                 # iterations
            P(),                 # stop
            P(),                 # nfev
            P(),                 # njev
        ),
    )
    # Full f32 for the normal equations (see ba.solve_ba).
    with jax.default_matmul_precision("float32"):
        cam, bnd, sh, cost, cost0, it, stop, nfev, njev = fn(
            problem.marker_uv,
            problem.weight,
            problem.mkr_bnd_index,
            problem.mkr_cam_block,
            problem.cam_params,
            problem.bnd_params,
            problem.shared_params,
            problem.intrinsics,
        )
    return ShardedBAResult(
        cam_params=cam,
        bnd_params=bnd,
        shared_params=sh,
        cost=cost,
        cost_initial=cost0,
        iterations=it,
        stop_reason=stop,
        func_evals=nfev,
        jacobian_evals=njev,
    )
