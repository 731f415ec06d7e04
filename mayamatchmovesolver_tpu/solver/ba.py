"""Structured bundle adjustment: Schur complement over camera/bundle
blocks with a shared-parameter border (arrowhead), batched block
einsums, never forming the dense Jacobian.

This is the replacement for the reference's dense
cminpack QR over a finite-difference Jacobian
(ref: adjust_cminpack_lmdif.cpp:61-202, adjust_solveFunc.cpp:305-525;
the sparsity the reference only exploits by *culling* evaluations via
errorToParamList bitmaps, adjust_solveFunc.cpp:187-226, is here the
explicit block structure of the normal equations).

Problem shape (the classic BA arrowhead; the reference documents the
static-attribute coupling as its central scaling hazard,
ref: docs/source/solver_design.rst:188-218):
  * camera parameters: (C*F, 6) — per-(camera, frame) 6-DoF pose
    blocks, independent across frames (C=1 is the common case;
    multi-camera rigs put every camera's frame blocks side by side);
  * bundle parameters: (B, 3) — world positions, independent across
    bundles;
  * shared (border) parameters: (S,) — static attributes coupling ALL
    frames: focal length and/or lens-distortion coefficients (ref:
    countUpNumberOfUnknownParameters treats static attrs as one
    parameter across the whole frame range,
    adjust_relationships.cpp:223);
  * residual r_{m,f} depends on (camera frame f, bundle b(m), shared).

Per-observation residuals include the same physics as the dense path:
behind-camera x1e6 inflation (adjust_measureErrors.cpp:262-270), lens
distortion applied to the reprojected point
(adjust_measureErrors.cpp:249-270,464-480) and the robust loss
rescaling (adjust_base.cpp:132-187).

Per-observation Jacobians come from vmap(jacfwd) of a *tiny* function
(2 outputs, 6+3+S inputs), so the Jacobian work is one fused batched
kernel over (M, F).  The normal equations are assembled with batched
einsums, bundles are eliminated in closed form (batched 3x3
inverses), and the reduced arrowhead system over
[per-frame camera blocks | border]

    [ S_cc  S_cs ] [dx_c]   [rhs_c]
    [ S_sc  S_ss ] [dx_s] = [rhs_s]

is solved with our any-dtype Cholesky.  An LM loop with the true gain
ratio (predicted-vs-actual reduction) and Nielsen's mu update wraps it,
with the same eps1/2/3 stopping semantics as solver/lm.py.
"""

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp

from mayamatchmovesolver_tpu.core import camera as cam_math
from mayamatchmovesolver_tpu.core import transform as tfm_math
from mayamatchmovesolver_tpu.core.constants import MM_TO_INCH
from mayamatchmovesolver_tpu.scene.flatscene import NEAR_CLIP_PLANE_CM
from mayamatchmovesolver_tpu.solver import linalg
from mayamatchmovesolver_tpu.solver import loss as loss_mod

CAM_PARAMS_POSE = 6  # tx ty tz rx ry rz

# Behind-camera residual inflation, shared with the dense path
# (ref: src/mmSolver/adjust/adjust_measureErrors.cpp:262-270).
BEHIND_CAMERA_ERROR_FACTOR = 1.0e6


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Arrays fully describing the structured BA problem (a pytree;
    configuration fields are static so they select compiled variants)."""

    marker_uv: jax.Array  # (M, F, 2) observed, film-fit-scaled space
    weight: jax.Array  # (M, F) sqrt-applied marker weights * mask
    mkr_bnd_index: jax.Array  # (M,) bundle index per marker
    # Camera-block offset per marker: cam_index * F.  Zeros for the
    # single-camera case; multi-camera rigs (stereo / witness cams,
    # C cameras) lay cam_params out camera-major as (C*F, 6) and each
    # marker indexes its own camera's frame blocks.
    mkr_cam_block: jax.Array  # (M,) int32
    cam_params: jax.Array  # (C*F, 6) initial camera pose params
    bnd_params: jax.Array  # (B, 3) initial bundle positions
    shared_params: jax.Array  # (S,) border params: [focal?] + lens
    intrinsics: jax.Array  # (F, 8) [focal, fbw_mm, fbh_mm, offx_mm,
    #                       offy_mm, far_cm, cam_scale, render_aspect]
    lens_params: jax.Array  # (P_l,) full fixed lens parameter vector
    lens_pixel_aspect: jax.Array  # () pixel aspect for the lens model
    film_fit: int = dataclasses.field(metadata={"static": True})
    rotate_order: int = dataclasses.field(metadata={"static": True})
    image_width: float = dataclasses.field(metadata={"static": True})
    # Border layout: focal first (if solved), then the lens parameters
    # selected by lens_solve_mask, in model field order.
    solve_focal: bool = dataclasses.field(metadata={"static": True})
    lens_model_type: str = dataclasses.field(metadata={"static": True})
    lens_solve_mask: Tuple[bool, ...] = dataclasses.field(
        metadata={"static": True}
    )
    loss_type: int = dataclasses.field(metadata={"static": True})
    loss_scale: float = dataclasses.field(metadata={"static": True})

    def _replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    @property
    def num_cameras(self):
        return self.cam_params.shape[0] // self.marker_uv.shape[1]

    @property
    def num_shared(self):
        focal_slots = self.num_cameras if self.solve_focal else 0
        return focal_slots + sum(
            1 for m in self.lens_solve_mask if m
        )


class BAResult(NamedTuple):
    cam_params: jax.Array
    bnd_params: jax.Array
    shared_params: jax.Array
    cost: jax.Array
    cost_initial: jax.Array
    iterations: jax.Array
    stop_reason: jax.Array  # 1 ftol, 2 xtol, 3 gtol, 4 maxiter, 5 fail
    gradient_norm: jax.Array
    # Counted (not derived) evaluation totals: func_evals = cost-only
    # evaluations (initial cost + one trial cost per iteration);
    # jacobian_evals = block assemblies (residual + all Jacobian
    # blocks, one per iteration).  Ref: the reference's measured
    # counters in adjust_results.h:59-940.
    func_evals: int = 0
    jacobian_evals: int = 0


def _static_cfg(problem: BAProblem):
    return (
        problem.film_fit,
        problem.rotate_order,
        problem.image_width,
        problem.solve_focal,
        # Border focal slots: one per camera when focal is solved (a
        # stereo rig solves one focal per physical lens; C=1 keeps the
        # single shared focal).  Shape-derived, so it stays static.
        problem.num_cameras if problem.solve_focal else 0,
        problem.lens_model_type,
        problem.lens_solve_mask,
        problem.loss_type,
        problem.loss_scale,
    )


def _lens_model(model_type, values):
    from mayamatchmovesolver_tpu.models import scenelens

    return scenelens._build_model(model_type, values)


def _observation_residual(cam_vec, bnd_vec, shared_vec, intr, weight,
                          lens_fixed, pixel_aspect, static_cfg, uv,
                          focal_slot=0):
    """Residual of ONE (marker, frame) observation; the unit the
    Jacobians differentiate.  cam_vec: (6,), bnd_vec: (3,),
    shared_vec: (S,), weight: scalar sqrt-weight*mask; focal_slot
    selects this observation's camera's border focal (multi-camera
    rigs solve one focal per camera).

    Matches the dense path's marker residual exactly
    (solver/problem.py measure_residuals): film-fit projection, lens
    distortion of the reprojected point, behind-camera x1e6, NaN guard,
    sqrt-weight scaling, then the robust-loss rescale."""
    (film_fit, rotate_order, image_width, solve_focal, num_focal_slots,
     lens_model_type, lens_solve_mask, loss_type, loss_scale) = static_cfg

    tx, ty, tz, rx, ry, rz = cam_vec[:6]
    s_idx = 0
    if solve_focal:
        # jnp view: problem leaves are host numpy arrays, and a numpy
        # array cannot be indexed by the vmap tracer focal_slot.
        focal = jnp.asarray(shared_vec)[focal_slot]
        s_idx = num_focal_slots
    else:
        focal = intr[0]
    fbw_mm, fbh_mm = intr[1], intr[2]
    offx_mm, offy_mm = intr[3], intr[4]
    far_cm, cam_scale, render_aspect = intr[5], intr[6], intr[7]

    cam_world = tfm_math.trs_matrix(
        tx, ty, tz, rx, ry, rz, 1.0, 1.0, 1.0, rotate_order
    )
    cam_inv = tfm_math.affine_inverse(cam_world)
    proj = cam_math.projection_matrix(
        focal,
        fbw_mm * MM_TO_INCH,
        fbh_mm * MM_TO_INCH,
        offx_mm * MM_TO_INCH,
        offy_mm * MM_TO_INCH,
        render_aspect,
        1.0,
        film_fit,
        NEAR_CLIP_PLANE_CM,
        far_cm,
        cam_scale,
    )
    p = jnp.concatenate([bnd_vec, jnp.ones(1, bnd_vec.dtype)])
    p_cam = cam_inv @ p
    clip = proj @ p_cam
    point_xy = clip[:2] / clip[3] * 0.5

    # Lens distortion of the reprojected point, with the dense path's
    # NaN fallback (ref: adjust_measureErrors.cpp:249-270,464-480).
    if lens_model_type:
        from mayamatchmovesolver_tpu.models import base as lens_base
        from mayamatchmovesolver_tpu.models import tde

        values = []
        si = s_idx
        for pi, solved in enumerate(lens_solve_mask):
            if solved:
                values.append(shared_vec[si])
                si += 1
            else:
                values.append(lens_fixed[pi])
        model = _lens_model(lens_model_type, values)
        fb = lens_base.FilmBack(
            film_back_width_cm=fbw_mm * 0.1,
            film_back_height_cm=fbh_mm * 0.1,
            lens_center_offset_x_cm=offx_mm * 0.1,
            lens_center_offset_y_cm=offy_mm * 0.1,
            pixel_aspect=pixel_aspect,
        )
        mapped = tde.distort(model, fb, point_xy)
        point_xy = jnp.where(jnp.isfinite(mapped), mapped, point_xy)

    # Behind-camera: the camera looks down its local -Z, so a point
    # with positive camera-space z is behind (piecewise-constant
    # factor, like the dense path's jnp.where weight).
    behind = p_cam[2] > 0.0
    factor = jnp.where(behind, BEHIND_CAMERA_ERROR_FACTOR, 1.0)

    d = (uv - point_xy) * image_width
    d = jnp.where(jnp.isfinite(d), d, 0.0)
    r = d * (factor * weight)
    return loss_mod.apply_loss_to_residuals(r, loss_type, loss_scale)


def _gather_cam(x, cam_block, num_frames):
    """Per-marker view of camera-major block arrays: (C*F, ...) ->
    (M, F, ...) selecting each marker's camera's frame blocks."""
    frame_ids = jnp.arange(num_frames)
    return x[cam_block[:, None] + frame_ids[None, :]]


def _scatter_frames(contrib_mf, cam_block, num_cam_blocks):
    """Scatter-add (M, F, ...) per-observation contributions into the
    camera-major block axis (C*F, ...)."""
    m, f = contrib_mf.shape[:2]
    seg = (cam_block[:, None] + jnp.arange(f)[None, :]).reshape(-1)
    return jax.ops.segment_sum(
        contrib_mf.reshape((m * f,) + contrib_mf.shape[2:]),
        seg, num_segments=num_cam_blocks,
    )


import os as _os

# Jacobian assembly backend: 'ad' (per-observation forward AD, the
# default) or 'analytic' (per-frame Q Jacobians + explicit
# perspective/lens/loss chain rule).  Both compute identical blocks
# (tests/test_solver/test_ba_schur.py agreement oracle — the
# dual-backend pattern the reference gets from MayaDAG vs
# MMSceneGraph).  Measured round 5 on the real chip, inside the fused
# LM loop: AD 373 it/s vs analytic 261 at F=200/B=100, and parity
# within 5% at F=1024/B=2048 — XLA hoists the per-frame camera-stack
# computation out of the marker vmap and fuses the tangent chains
# better than the materialized analytic intermediates, so forward AD
# stays the production path and the analytic backend serves as the
# independent correctness oracle.
_BA_ASSEMBLY = _os.environ.get("MMSOLVER_TPU_BA_ASSEMBLY", "ad")


def _residual_and_blocks(problem: BAProblem, cam_params, bnd_params,
                         shared_params):
    """All residuals + per-observation Jacobian blocks, batched.

    Returns (r, j_cam, j_bnd, j_shared) shaped (M, F, 2[, ...])."""
    multi_cam_lens = (
        bool(problem.lens_model_type)
        and cam_params.shape[0] != problem.marker_uv.shape[1]
    )
    if _BA_ASSEMBLY == "analytic" and not multi_cam_lens:
        return _residual_and_blocks_analytic(
            problem, cam_params, bnd_params, shared_params
        )
    # Default: per-observation forward AD (see _BA_ASSEMBLY — measured
    # faster in the fused loop; the multi-camera + lens combination is
    # AD-only).
    return _residual_and_blocks_ad(
        problem, cam_params, bnd_params, shared_params
    )


def _residual_and_blocks_ad(problem: BAProblem, cam_params, bnd_params,
                            shared_params):
    """Per-observation forward-AD assembly (vmap(jacfwd) of the tiny
    observation function) — the independent oracle the analytic path
    is tested against."""
    static = _static_cfg(problem)
    bnd_per_marker = bnd_params[problem.mkr_bnd_index]  # (M, 3)

    def obs(cam_vec, bnd_vec, shared, intr, w, uv, slot):
        return _observation_residual(
            cam_vec, bnd_vec, shared, intr, w,
            problem.lens_params, problem.lens_pixel_aspect, static, uv,
            focal_slot=slot,
        )

    jac = jax.jacfwd(obs, argnums=(0, 1, 2))

    num_frames = problem.marker_uv.shape[1]
    single_cam = cam_params.shape[0] == num_frames
    focal_slots = problem.mkr_cam_block // num_frames  # (M,) cam index

    def per_marker(bnd_vec, uv_row, w_row, cam_rows, intr_rows, slot):
        def frame_fn(cam_vec, intr, w, uv):
            return (
                obs(cam_vec, bnd_vec, shared_params, intr, w, uv,
                    slot),
                jac(cam_vec, bnd_vec, shared_params, intr, w, uv,
                    slot),
            )

        r, (jc, jb, js) = jax.vmap(frame_fn)(
            cam_rows, intr_rows, w_row, uv_row
        )
        return r, jc, jb, js

    if single_cam:
        # Fast path: every marker shares the frame axis' camera
        # blocks — broadcast through the vmap closure instead of
        # materializing (M, F, ...) gathers.
        r, j_cam, j_bnd, j_sh = jax.vmap(
            lambda bnd_vec, uv_row, w_row, slot: per_marker(
                bnd_vec, uv_row, w_row, cam_params, problem.intrinsics,
                slot,
            )
        )(bnd_per_marker, problem.marker_uv, problem.weight,
          focal_slots)
    else:
        cam_rows = _gather_cam(cam_params, problem.mkr_cam_block,
                               num_frames)
        intr_rows = _gather_cam(problem.intrinsics,
                                problem.mkr_cam_block, num_frames)
        r, j_cam, j_bnd, j_sh = jax.vmap(per_marker)(
            bnd_per_marker, problem.marker_uv, problem.weight,
            cam_rows, intr_rows, focal_slots,
        )
    # r: (M, F, 2); j_cam: (M, F, 2, 6); j_bnd: (M, F, 2, 3);
    # j_sh: (M, F, 2, S).
    return r, j_cam, j_bnd, j_sh


def _frame_q_system(problem: BAProblem, cam_params, shared_params):
    """Per-frame-block projection system Q_f = P_f @ inv(M_f) and its
    Jacobians wrt the 6 pose params (and the border focal when
    solved), computed ONCE per frame block.

    The per-observation residual factors as
        clip = Q_f @ [X_m, 1],   xy = clip_{0:2} / clip_3 * 0.5,
    so every camera-side derivative is a chain through Q — computing
    dQ by forward AD per FRAME (C*F tiny problems) instead of per
    OBSERVATION turns the Jacobian assembly from M*F full-pipeline
    tangent passes into a handful of (F,4,4,k) x (M,4) einsums
    (measured: 156 ms -> ~35 ms per assembly at F=1024/B=2048 on one
    chip).  Returns (q, dq_dcam, dq_dfocal_or_None, minv_row2)."""
    (film_fit, rotate_order, _image_width, solve_focal,
     num_focal_slots, _lmt, _mask, _lt, _ls) = _static_cfg(problem)
    intr = problem.intrinsics  # (C*F, 8), camera-major like cam blocks
    num_frames = problem.marker_uv.shape[1]
    num_blocks = cam_params.shape[0]
    if solve_focal:
        cam_index = jnp.arange(num_blocks) // num_frames
        focal_vec = jnp.asarray(shared_params)[cam_index]
    else:
        focal_vec = intr[:, 0]

    def qrow(cam_vec, focal, intr_row):
        tx, ty, tz, rx, ry, rz = cam_vec[:6]
        cam_world = tfm_math.trs_matrix(
            tx, ty, tz, rx, ry, rz, 1.0, 1.0, 1.0, rotate_order
        )
        cam_inv = tfm_math.affine_inverse(cam_world)
        proj = cam_math.projection_matrix(
            focal,
            intr_row[1] * MM_TO_INCH,
            intr_row[2] * MM_TO_INCH,
            intr_row[3] * MM_TO_INCH,
            intr_row[4] * MM_TO_INCH,
            intr_row[7],
            1.0,
            film_fit,
            NEAR_CLIP_PLANE_CM,
            intr_row[5],
            intr_row[6],
        )
        return proj @ cam_inv, cam_inv[2]

    q, row2 = jax.vmap(qrow)(cam_params, focal_vec, intr)
    dq_dcam = jax.vmap(
        jax.jacfwd(lambda c, f, i: qrow(c, f, i)[0], argnums=0)
    )(cam_params, focal_vec, intr)  # (CF, 4, 4, 6)
    dq_dfocal = None
    if solve_focal:
        dq_dfocal = jax.vmap(
            jax.jacfwd(lambda c, f, i: qrow(c, f, i)[0], argnums=1)
        )(cam_params, focal_vec, intr)  # (CF, 4, 4)
    return q, dq_dcam, dq_dfocal, row2


def _residual_and_blocks_analytic(problem: BAProblem, cam_params,
                                  bnd_params, shared_params):
    """Analytic-chain-rule twin of _residual_and_blocks_ad: same
    (r, j_cam, j_bnd, j_shared) tensors, assembled from per-frame Q
    Jacobians + the perspective-divide / lens / loss chains instead of
    per-observation forward AD (the two paths are each other's
    agreement oracle, tests/test_solver/test_ba_schur.py)."""
    (film_fit, rotate_order, image_width, solve_focal, num_focal_slots,
     lens_model_type, lens_solve_mask, loss_type,
     loss_scale) = _static_cfg(problem)
    num_frames = problem.marker_uv.shape[1]
    num_markers = problem.marker_uv.shape[0]
    single_cam = cam_params.shape[0] == num_frames
    dtype = cam_params.dtype
    n_lens_solved = sum(1 for m in lens_solve_mask if m)
    num_shared = (num_focal_slots if solve_focal else 0) + n_lens_solved

    q, dq_dcam, dq_dfocal, row2 = _frame_q_system(
        problem, cam_params, shared_params
    )

    bnd_m = bnd_params[problem.mkr_bnd_index]  # (M, 3)
    xh = jnp.concatenate(
        [bnd_m, jnp.ones((num_markers, 1), dtype)], axis=-1
    )  # (M, 4)

    if single_cam:
        clip = jnp.einsum("fij,mj->mfi", q, xh)
        dclip_dcam = jnp.einsum("fijk,mj->mfik", dq_dcam, xh)
        z_cam = jnp.einsum("fj,mj->mf", row2, xh)
        # dclip/dX columns come straight from Q (homogeneous linear).
        q_rows = q[None]  # (1, F, 4, 4) broadcasting over markers
        dclip_df = (
            jnp.einsum("fij,mj->mfi", dq_dfocal, xh)
            if solve_focal else None
        )
    else:
        q_g = _gather_cam(q, problem.mkr_cam_block, num_frames)
        dq_g = _gather_cam(dq_dcam, problem.mkr_cam_block, num_frames)
        row2_g = _gather_cam(row2, problem.mkr_cam_block, num_frames)
        clip = jnp.einsum("mfij,mj->mfi", q_g, xh)
        dclip_dcam = jnp.einsum("mfijk,mj->mfik", dq_g, xh)
        z_cam = jnp.einsum("mfj,mj->mf", row2_g, xh)
        q_rows = q_g
        dclip_df = None
        if solve_focal:
            dqf_g = _gather_cam(dq_dfocal, problem.mkr_cam_block,
                                num_frames)
            dclip_df = jnp.einsum("mfij,mj->mfi", dqf_g, xh)

    w_clip = clip[..., 3]  # (M, F)
    inv_w = 0.5 / w_clip
    xy = clip[..., :2] * inv_w[..., None]  # (M, F, 2)

    def divide_chain(dclip_xy, dclip_w):
        # d(xy_i) = (dclip_i - 2 xy_i dclip_3) * 0.5 / clip_3
        return (
            dclip_xy - 2.0 * xy[..., :, None] * dclip_w[..., None, :]
        ) * inv_w[..., None, None]

    j_xy_cam = divide_chain(
        dclip_dcam[..., :2, :], dclip_dcam[..., 3, :]
    )  # (M, F, 2, 6)
    # Bundle columns: dclip/dX = Q[:, :3].
    j_xy_bnd = (
        q_rows[..., :2, :3]
        - 2.0 * xy[..., :, None] * q_rows[..., 3:4, :3]
    ) * inv_w[..., None, None]  # (M, F, 2, 3)
    j_xy_foc = None
    if solve_focal:
        j_xy_foc = (
            (dclip_df[..., :2]
             - 2.0 * xy * dclip_df[..., 3:4]) * inv_w[..., None]
        )  # (M, F, 2)

    # Lens distortion of the reprojected point: forward AD over the
    # LENS MATH ONLY (2 + S_l tangents of a small polynomial), with
    # the dense path's per-component NaN fallback.
    if lens_model_type:
        from mayamatchmovesolver_tpu.models import base as lens_base
        from mayamatchmovesolver_tpu.models import tde

        s_idx = num_focal_slots if solve_focal else 0
        lens_solved = jax.lax.dynamic_slice(
            shared_params, (s_idx,), (n_lens_solved,)
        ) if n_lens_solved else jnp.zeros((0,), dtype)

        def lens_point(xy_pt, solved_vec, fbw_mm, fbh_mm, offx_mm,
                       offy_mm):
            values = []
            si = 0
            for pi, solved in enumerate(lens_solve_mask):
                if solved:
                    values.append(solved_vec[si])
                    si += 1
                else:
                    values.append(problem.lens_params[pi])
            model = _lens_model(lens_model_type, values)
            fb = lens_base.FilmBack(
                film_back_width_cm=fbw_mm * 0.1,
                film_back_height_cm=fbh_mm * 0.1,
                lens_center_offset_x_cm=offx_mm * 0.1,
                lens_center_offset_y_cm=offy_mm * 0.1,
                pixel_aspect=problem.lens_pixel_aspect,
            )
            return tde.distort(model, fb, xy_pt)

        def undistort_point(pt, solved_vec, fbw_mm, fbh_mm, offx_mm,
                            offy_mm):
            values = []
            si = 0
            for pi, solved in enumerate(lens_solve_mask):
                if solved:
                    values.append(solved_vec[si])
                    si += 1
                else:
                    values.append(problem.lens_params[pi])
            model = _lens_model(lens_model_type, values)
            fb = lens_base.FilmBack(
                film_back_width_cm=fbw_mm * 0.1,
                film_back_height_cm=fbh_mm * 0.1,
                lens_center_offset_x_cm=offx_mm * 0.1,
                lens_center_offset_y_cm=offy_mm * 0.1,
                pixel_aspect=problem.lens_pixel_aspect,
            )
            return tde.undistort(model, fb, pt)

        # Models whose distort direction is the ITERATIVE fixed-point
        # inverse (ldpk convention: classic and anamorphic are native
        # in the undistort direction).  Differentiating through the
        # 20-iteration loop is the single hottest per-observation cost
        # at production scale (measured ~100 ms of a 171 ms assembly
        # at F=1024/B=2048); the implicit-function theorem gives the
        # same Jacobian from ONE jacfwd of the loop-free undistort
        # polynomial at the converged point:
        #     U(mapped; theta) = xy  =>  dmapped/dxy   = G^{-1},
        #                                dmapped/dtheta = -G^{-1} H
        # with G = dU/dpt (2x2), H = dU/dtheta.
        ift = lens_model_type in (
            "tde_classic",
            "tde_anamorphic_std_deg4",
            "tde_anamorphic_std_deg4_rescaled",
        )

        if ift:
            def lens_val_jac(xy_pt, fbw, fbh, ox, oy):
                mapped = lens_point(xy_pt, lens_solved, fbw, fbh, ox,
                                    oy)
                g, h = jax.jacfwd(undistort_point, argnums=(0, 1))(
                    mapped, lens_solved, fbw, fbh, ox, oy
                )
                det = g[0, 0] * g[1, 1] - g[0, 1] * g[1, 0]
                inv_det = 1.0 / det
                g_inv = jnp.array(
                    [[g[1, 1], -g[0, 1]], [-g[1, 0], g[0, 0]]],
                    dtype=g.dtype,
                ) * inv_det
                l_xy = g_inv
                l_sh = -(g_inv @ h) if n_lens_solved else h
                return mapped, l_xy, l_sh
        else:
            def lens_val_jac(xy_pt, fbw, fbh, ox, oy):
                mapped = lens_point(xy_pt, lens_solved, fbw, fbh, ox,
                                    oy)
                l_xy, l_sh = jax.jacfwd(lens_point, argnums=(0, 1))(
                    xy_pt, lens_solved, fbw, fbh, ox, oy
                )
                return mapped, l_xy, l_sh

        intr = problem.intrinsics
        per_frame = jax.vmap(lens_val_jac, in_axes=(0, 0, 0, 0, 0))
        per_obs = jax.vmap(per_frame, in_axes=(0, None, None, None,
                                               None))
        mapped, l_xy, l_sh = per_obs(
            xy, intr[:, 1], intr[:, 2], intr[:, 3], intr[:, 4]
        )  # (M, F, 2), (M, F, 2, 2), (M, F, 2, S_l)
        ok = jnp.isfinite(mapped)  # per component, like the AD path
        pt = jnp.where(ok, mapped, xy)
        j_pt_cam = jnp.where(
            ok[..., None],
            jnp.einsum("mfij,mfjk->mfik", l_xy, j_xy_cam),
            j_xy_cam,
        )
        j_pt_bnd = jnp.where(
            ok[..., None],
            jnp.einsum("mfij,mfjk->mfik", l_xy, j_xy_bnd),
            j_xy_bnd,
        )
        j_pt_lens = jnp.where(ok[..., None], l_sh, 0.0)
        j_pt_foc = None
        if solve_focal:
            j_pt_foc = jnp.where(
                ok,
                jnp.einsum("mfij,mfj->mfi", l_xy, j_xy_foc),
                j_xy_foc,
            )
    else:
        pt = xy
        j_pt_cam = j_xy_cam
        j_pt_bnd = j_xy_bnd
        j_pt_lens = jnp.zeros(
            (num_markers, num_frames, 2, 0), dtype
        )
        j_pt_foc = j_xy_foc

    # Residual: d = (uv - pt) * W, NaN-guarded, behind-camera x1e6,
    # sqrt-weight (all matching _observation_residual exactly; the
    # where-conditions are piecewise constant so AD and the chain rule
    # agree on the masks).
    d = (problem.marker_uv - pt) * image_width
    fin = jnp.isfinite(d)
    d = jnp.where(fin, d, 0.0)
    factor = jnp.where(z_cam > 0.0, BEHIND_CAMERA_ERROR_FACTOR, 1.0)
    scale = factor * problem.weight  # (M, F)
    r_pre = d * scale[..., None]
    j_scale = -(image_width * scale)[..., None, None]
    j_cam = jnp.where(fin[..., None], j_pt_cam * j_scale, 0.0)
    j_bnd = jnp.where(fin[..., None], j_pt_bnd * j_scale, 0.0)
    j_lens = jnp.where(fin[..., None], j_pt_lens * j_scale, 0.0)
    j_foc = None
    if solve_focal:
        j_foc = jnp.where(fin, j_pt_foc * j_scale[..., 0], 0.0)

    # Robust loss rescale g(r) = r * s(r): elementwise, so its
    # Jacobian is the diagonal alpha = dg/dr obtained from one jvp
    # with a ones tangent.
    if loss_type != int(loss_mod.RobustLossType.TRIVIAL):
        r, alpha = jax.jvp(
            lambda t: loss_mod.apply_loss_to_residuals(
                t, loss_type, loss_scale
            ),
            (r_pre,), (jnp.ones_like(r_pre),),
        )
        j_cam = alpha[..., None] * j_cam
        j_bnd = alpha[..., None] * j_bnd
        j_lens = alpha[..., None] * j_lens
        if solve_focal:
            j_foc = alpha * j_foc
    else:
        r = r_pre

    # Border columns: [focal slots | solved lens params].
    if num_shared:
        cols = []
        if solve_focal:
            slots = problem.mkr_cam_block // num_frames  # (M,)
            onehot = jax.nn.one_hot(
                slots, num_focal_slots, dtype=dtype
            )  # (M, num_focal_slots)
            cols.append(
                j_foc[..., None] * onehot[:, None, None, :]
            )
        if n_lens_solved:
            cols.append(j_lens)
        j_sh = jnp.concatenate(cols, axis=-1)
    else:
        j_sh = jnp.zeros((num_markers, num_frames, 2, 0), dtype)
    return r, j_cam, j_bnd, j_sh


def ba_residuals(problem: BAProblem, cam_params, bnd_params,
                 shared_params=None):
    """Residual tensor (M, F, 2) without Jacobians — the cheap
    accept/reject evaluation, and the ground-truth synthesis hook for
    tests/bench (observations generated through the model itself)."""
    if shared_params is None:
        shared_params = problem.shared_params
    static = _static_cfg(problem)
    bnd_per_marker = bnd_params[problem.mkr_bnd_index]

    def obs(cam_vec, bnd_vec, intr, w, uv, slot):
        return _observation_residual(
            cam_vec, bnd_vec, shared_params, intr, w,
            problem.lens_params, problem.lens_pixel_aspect, static, uv,
            focal_slot=slot,
        )

    num_frames = problem.marker_uv.shape[1]
    focal_slots = problem.mkr_cam_block // num_frames
    if cam_params.shape[0] == num_frames:  # single camera fast path
        return jax.vmap(
            lambda bnd_vec, uv_row, w_row, slot: jax.vmap(
                lambda cam_vec, intr, w, uv: obs(
                    cam_vec, bnd_vec, intr, w, uv, slot
                )
            )(cam_params, problem.intrinsics, w_row, uv_row)
        )(bnd_per_marker, problem.marker_uv, problem.weight,
          focal_slots)
    cam_rows = _gather_cam(cam_params, problem.mkr_cam_block,
                           num_frames)
    intr_rows = _gather_cam(problem.intrinsics, problem.mkr_cam_block,
                            num_frames)
    return jax.vmap(
        lambda bnd_vec, uv_row, w_row, cams, intrs, slot: jax.vmap(
            lambda cam_vec, intr, w, uv: obs(cam_vec, bnd_vec, intr, w,
                                             uv, slot)
        )(cams, intrs, w_row, uv_row)
    )(bnd_per_marker, problem.marker_uv, problem.weight,
      cam_rows, intr_rows, focal_slots)


def ba_cost(problem: BAProblem, cam_params, bnd_params, shared_params):
    """Cost without Jacobians (cheaper accept/reject check)."""
    r = ba_residuals(problem, cam_params, bnd_params, shared_params)
    return 0.5 * jnp.sum(r * r)


# Backwards-compatible private alias (bench/tests synthesize
# observations through the residual program itself).
def _ba_cost_only(problem, cam_params, bnd_params):
    return ba_cost(problem, cam_params, bnd_params,
                   problem.shared_params)


def _damp(block, mu, floor=1e-12):
    """Marquardt damping: add mu*diag to a (..., n, n) block."""
    d = jnp.maximum(jnp.diagonal(block, axis1=-2, axis2=-1), floor)
    return block + mu * d[..., None] * jnp.eye(
        block.shape[-1], dtype=block.dtype
    )


class NormalBlocks(NamedTuple):
    """Local (per-shard) normal-equation blocks of the arrowhead
    system; the sharded path psums the bundle/border members."""

    cost: jax.Array  # local 0.5*||r||^2
    b_blocks: jax.Array  # (F, 6, 6) per-frame camera blocks
    g_cam: jax.Array  # (F, 6)
    a_blocks: jax.Array  # (B, 3, 3) per-bundle blocks (local sum)
    g_bnd: jax.Array  # (B, 3) (local sum)
    w_mf: jax.Array  # (M, F, 3, 6) bundle-camera coupling
    hcs: jax.Array  # (F, 6, S) camera-border coupling
    hbs: jax.Array  # (B, 3, S) bundle-border coupling (local sum)
    hss: jax.Array  # (S, S) border block (local sum)
    g_sh: jax.Array  # (S,) (local sum)
    hbs_m: jax.Array  # (M, 3, S) per-marker bundle-border coupling


def assemble_normal_blocks(problem: BAProblem, cam_params, bnd_params,
                           shared_params) -> NormalBlocks:
    """Assemble every block of the arrowhead normal equations from the
    batched per-observation Jacobians (batched einsums)."""
    r, j_cam, j_bnd, j_sh = _residual_and_blocks(
        problem, cam_params, bnd_params, shared_params
    )
    num_bundles = bnd_params.shape[0]
    num_cam_blocks = cam_params.shape[0]
    single_cam = num_cam_blocks == problem.marker_uv.shape[1]
    cost = 0.5 * jnp.sum(r * r)

    if single_cam:
        # Every marker shares the frame axis' camera blocks: plain
        # einsum reductions over markers (the fast path).
        b_blocks = jnp.einsum("mfra,mfrb->fab", j_cam, j_cam)
        g_cam = jnp.einsum("mfra,mfr->fa", j_cam, r)
    else:
        # Multi-camera rig: scatter each observation into its
        # camera's (cam*F + f) block.
        b_blocks = _scatter_frames(
            jnp.einsum("mfra,mfrb->mfab", j_cam, j_cam),
            problem.mkr_cam_block, num_cam_blocks,
        )
        g_cam = _scatter_frames(
            jnp.einsum("mfra,mfr->mfa", j_cam, r),
            problem.mkr_cam_block, num_cam_blocks,
        )

    a_m = jnp.einsum("mfra,mfrb->mab", j_bnd, j_bnd)  # (M, 3, 3)
    a_blocks = jax.ops.segment_sum(
        a_m, problem.mkr_bnd_index, num_segments=num_bundles
    )
    g_bnd_m = jnp.einsum("mfra,mfr->ma", j_bnd, r)
    g_bnd = jax.ops.segment_sum(
        g_bnd_m, problem.mkr_bnd_index, num_segments=num_bundles
    )

    # W_{m,f} = Jb^T Jc per observation (3 x 6), grouped by marker.
    w_mf = jnp.einsum("mfra,mfrb->mfab", j_bnd, j_cam)

    # Border couplings.
    if single_cam:
        hcs = jnp.einsum("mfra,mfrs->fas", j_cam, j_sh)  # (CF, 6, S)
    else:
        hcs = _scatter_frames(
            jnp.einsum("mfra,mfrs->mfas", j_cam, j_sh),
            problem.mkr_cam_block, num_cam_blocks,
        )
    hbs_m = jnp.einsum("mfra,mfrs->mas", j_bnd, j_sh)  # (M, 3, S)
    hbs = jax.ops.segment_sum(
        hbs_m, problem.mkr_bnd_index, num_segments=num_bundles
    )
    hss = jnp.einsum("mfrs,mfrt->st", j_sh, j_sh)  # (S, S)
    g_sh = jnp.einsum("mfrs,mfr->s", j_sh, r)  # (S,)

    return NormalBlocks(
        cost=cost, b_blocks=b_blocks, g_cam=g_cam, a_blocks=a_blocks,
        g_bnd=g_bnd, w_mf=w_mf, hcs=hcs, hbs=hbs, hss=hss, g_sh=g_sh,
        hbs_m=hbs_m,
    )


def reduce_arrowhead(blocks: NormalBlocks, mkr_bnd_index, mu):
    """Eliminate bundles from the arrowhead normal equations.

    Returns (s_dense, rhs, a_inv, diag, g) where s_dense is the
    (F*6+S, F*6+S) reduced system over [camera blocks | border], rhs
    its right-hand side, a_inv the damped per-bundle inverses for
    back-substitution, diag the undamped diagonal of the full system
    (for the gain ratio) and g the full gradient pieces."""
    num_frames = blocks.b_blocks.shape[0]
    p_c = blocks.b_blocks.shape[-1]
    num_shared = blocks.hss.shape[0]

    a_damped = _damp(blocks.a_blocks, mu)
    b_damped = _damp(blocks.b_blocks, mu)

    a_inv = tfm_math.inverse3(a_damped)  # (B, 3, 3)
    a_inv_m = a_inv[mkr_bnd_index]  # (M, 3, 3)

    # Reduced camera-camera system: S_cc = blkdiag(B_f) - sum_m
    # W_{m,f}^T A_m^{-1} W_{m,f'}.
    y_mf = jnp.einsum("mab,mfbc->mfac", a_inv_m, blocks.w_mf)
    s_cross = jnp.einsum("mfab,mgac->fbgc", blocks.w_mf, y_mf)
    s = -s_cross
    idx = jnp.arange(num_frames)
    s = s.at[idx, :, idx, :].add(b_damped)
    s_cc = s.reshape(num_frames * p_c, num_frames * p_c)

    # Camera RHS: g_cam - sum_m W^T A^-1 g_bnd.
    g_bnd_pre = jnp.einsum(
        "mab,mb->ma", a_inv_m, blocks.g_bnd[mkr_bnd_index]
    )
    rhs_c = blocks.g_cam - jnp.einsum(
        "mfab,ma->fb", blocks.w_mf, g_bnd_pre
    )

    if num_shared:
        hss_damped = _damp(blocks.hss, mu)
        # Border elimination pieces: Y_b = A_b^-1 Hbs_b.
        y_bs = jnp.einsum("bac,bcs->bas", a_inv, blocks.hbs)  # (B,3,S)
        y_bs_m = y_bs[mkr_bnd_index]  # (M, 3, S)
        s_cs = blocks.hcs - jnp.einsum(
            "mfab,mas->fbs", blocks.w_mf, y_bs_m
        )  # (F, 6, S)
        s_ss = hss_damped - jnp.einsum(
            "bas,bat->st", blocks.hbs, y_bs
        )  # (S, S)
        rhs_s = blocks.g_sh - jnp.einsum(
            "bas,ba->s", y_bs, blocks.g_bnd
        )
        n = num_frames * p_c + num_shared
        s_dense = jnp.zeros((n, n), s_cc.dtype)
        s_dense = s_dense.at[: num_frames * p_c,
                             : num_frames * p_c].set(s_cc)
        s_cs_flat = s_cs.reshape(num_frames * p_c, num_shared)
        s_dense = s_dense.at[: num_frames * p_c,
                             num_frames * p_c:].set(s_cs_flat)
        s_dense = s_dense.at[num_frames * p_c:,
                             : num_frames * p_c].set(s_cs_flat.T)
        s_dense = s_dense.at[num_frames * p_c:,
                             num_frames * p_c:].set(s_ss)
        rhs = jnp.concatenate([rhs_c.reshape(-1), rhs_s])
    else:
        s_dense = s_cc
        rhs = rhs_c.reshape(-1)
    return s_dense, rhs, a_inv


def _schur_normal_step(problem: BAProblem, cam_params, bnd_params,
                       shared_params, mu):
    """One damped Gauss-Newton step via Schur elimination of bundles
    plus the shared-parameter border.

    Returns (dx_cam, dx_bnd, dx_shared, cost, gnorm, predicted) where
    predicted is the LM model's predicted cost reduction
    0.5*(dx^T(mu*D)dx - dx^T g) for the gain ratio."""
    if problem.num_cameras > 1:
        raise ValueError(
            "the dense Cholesky Schur step supports one camera; "
            "multi-camera rigs solve with linear_solver='cg'"
        )
    blocks = assemble_normal_blocks(
        problem, cam_params, bnd_params, shared_params
    )
    num_frames, p_c = cam_params.shape
    num_shared = shared_params.shape[0]

    s_dense, rhs, a_inv = reduce_arrowhead(
        blocks, problem.mkr_bnd_index, mu
    )
    dx_all = -linalg.solve_spd(s_dense, rhs)
    dx_cam = dx_all[: num_frames * p_c].reshape(num_frames, p_c)
    dx_sh = dx_all[num_frames * p_c:]

    # Back-substitute bundles:
    # dx_b = -A^-1 (g_b + sum_f W dx_cam_f + Hbs dx_s).
    w_dx = jnp.einsum("mfab,fb->ma", blocks.w_mf, dx_cam)
    w_dx_b = jax.ops.segment_sum(
        w_dx, problem.mkr_bnd_index,
        num_segments=bnd_params.shape[0],
    )
    rhs_b = blocks.g_bnd + w_dx_b
    if num_shared:
        rhs_b = rhs_b + jnp.einsum("bas,s->ba", blocks.hbs, dx_sh)
    dx_bnd = -jnp.einsum("bij,bj->bi", a_inv, rhs_b)

    gnorm = jnp.maximum(
        jnp.max(jnp.abs(blocks.g_cam)), jnp.max(jnp.abs(blocks.g_bnd))
    )
    if num_shared:
        gnorm = jnp.maximum(gnorm, jnp.max(jnp.abs(blocks.g_sh)))

    # Predicted reduction of the LM model (for the true gain ratio):
    # with (H + mu D) dx = -g, pred = 0.5*(dx^T (mu D) dx - dx^T g).
    diag_b = jnp.maximum(
        jnp.diagonal(blocks.b_blocks, axis1=-2, axis2=-1), 1e-12
    )
    diag_a = jnp.maximum(
        jnp.diagonal(blocks.a_blocks, axis1=-2, axis2=-1), 1e-12
    )
    pred = 0.5 * (
        mu * jnp.sum(diag_b * dx_cam * dx_cam)
        + mu * jnp.sum(diag_a * dx_bnd * dx_bnd)
        - jnp.sum(dx_cam * blocks.g_cam)
        - jnp.sum(dx_bnd * blocks.g_bnd)
    )
    if num_shared:
        diag_s = jnp.maximum(jnp.diag(blocks.hss), 1e-12)
        pred = pred + 0.5 * (
            mu * jnp.sum(diag_s * dx_sh * dx_sh)
            - jnp.sum(dx_sh * blocks.g_sh)
        )
    return dx_cam, dx_bnd, dx_sh, blocks.cost, gnorm, pred


def _schur_cg_step(problem: BAProblem, cam_params, bnd_params,
                   shared_params, mu, cg_iterations, cg_rtol=1e-12):
    """One damped Gauss-Newton step via Schur elimination of bundles
    with the reduced [camera | border] system solved by preconditioned
    conjugate gradients instead of a dense Cholesky.

    Same semantics as _schur_normal_step, different linear solver: the
    (F*6)^2 dense factorization is latency-bound (O(F*6) sequential
    tiny steps), while every CG matvec is a handful of large einsums,
    fully parallel over observations and frames.  The preconditioner is the
    exact per-frame Schur diagonal block + the border's own reduced
    block — the same one that keeps the distributed CG convergent
    (parallel/ba_sharded.py)."""
    blocks = assemble_normal_blocks(
        problem, cam_params, bnd_params, shared_params
    )
    num_cam_blocks, p_c = cam_params.shape
    num_frames = problem.marker_uv.shape[1]
    single_cam = num_cam_blocks == num_frames
    num_shared = shared_params.shape[0]
    num_bundles = bnd_params.shape[0]
    mkr_bnd_index = problem.mkr_bnd_index
    cam_block = problem.mkr_cam_block

    a_damped = _damp(blocks.a_blocks, mu)
    b_damped = _damp(blocks.b_blocks, mu)
    a_inv = tfm_math.inverse3(a_damped)
    a_inv_m = a_inv[mkr_bnd_index]
    w_mf = blocks.w_mf
    hcs = blocks.hcs
    eye_c = jnp.eye(p_c, dtype=cam_params.dtype)

    def wt_scatter(z_m):
        """sum_m W_mf^T z_m scattered into the camera blocks."""
        if single_cam:
            return jnp.einsum("mfab,ma->fb", w_mf, z_m)
        return _scatter_frames(
            jnp.einsum("mfab,ma->mfb", w_mf, z_m), cam_block,
            num_cam_blocks,
        )

    def w_apply(x_c):
        """sum_f W_mf x_{block(m, f)} per marker."""
        if single_cam:
            return jnp.einsum("mfab,fb->ma", w_mf, x_c)
        x_rows = _gather_cam(x_c, cam_block, num_frames)  # (M, F, 6)
        return jnp.einsum("mfab,mfb->ma", w_mf, x_rows)

    g_bnd_pre = jnp.einsum(
        "mab,mb->ma", a_inv_m, blocks.g_bnd[mkr_bnd_index]
    )
    rhs_c = -(blocks.g_cam - wt_scatter(g_bnd_pre))
    if num_shared:
        hss_damped = _damp(blocks.hss, mu)
        y_bs = jnp.einsum("bac,bcs->bas", a_inv, blocks.hbs)
        rhs_s = -(blocks.g_sh - jnp.einsum(
            "bas,ba->s", y_bs, blocks.g_bnd
        ))
    else:
        hss_damped = blocks.hss
        rhs_s = jnp.zeros((0,), cam_params.dtype)

    def matvec(x_c, x_s):
        v_m = w_apply(x_c)
        v_b = jax.ops.segment_sum(
            v_m, mkr_bnd_index, num_segments=num_bundles
        )
        if num_shared:
            v_b = v_b + jnp.einsum("bas,s->ba", blocks.hbs, x_s)
        z_b = jnp.einsum("bac,bc->ba", a_inv, v_b)
        z_m = z_b[mkr_bnd_index]
        out_c = jnp.einsum("fab,fb->fa", b_damped, x_c)
        out_c = out_c - wt_scatter(z_m)
        if num_shared:
            out_c = out_c + jnp.einsum("fas,s->fa", hcs, x_s)
            out_s = jnp.einsum("fas,fa->s", hcs, x_c)
            out_s = out_s + hss_damped @ x_s
            out_s = out_s - jnp.einsum("bas,ba->s", blocks.hbs, z_b)
        else:
            out_s = x_s
        return out_c, out_s

    # Exact per-frame Schur diagonal preconditioner (+ border block).
    if single_cam:
        s_corr = jnp.einsum("mfab,mac,mfcd->fbd", w_mf, a_inv_m, w_mf)
    else:
        s_corr = _scatter_frames(
            jnp.einsum("mfab,mac,mfcd->mfbd", w_mf, a_inv_m, w_mf),
            cam_block, num_cam_blocks,
        )
    s_diag = b_damped - s_corr
    s_diag = s_diag + 1e-8 * jnp.maximum(
        jnp.diagonal(s_diag, axis1=-2, axis2=-1), 1e-12
    )[..., None] * eye_c
    if num_shared:
        s_ss = hss_damped - jnp.einsum("bas,bat->st", blocks.hbs, y_bs)
        s_ss = s_ss + 1e-8 * jnp.maximum(
            jnp.diag(s_ss), 1e-12
        ) * jnp.eye(num_shared, dtype=cam_params.dtype)

    def precond(v_c, v_s):
        p_cc = linalg.cholesky_solve(s_diag, v_c)
        if num_shared:
            p_ss = linalg.cholesky_solve(s_ss, v_s)
        else:
            p_ss = v_s
        return p_cc, p_ss

    def pdot(a_c, a_s, b_c, b_s):
        return jnp.sum(a_c * b_c) + jnp.sum(a_s * b_s)

    x0_c = jnp.zeros_like(rhs_c)
    x0_s = jnp.zeros_like(rhs_s)
    z0_c, z0_s = precond(rhs_c, rhs_s)
    rz0 = pdot(rhs_c, rhs_s, z0_c, z0_s)
    # Early exit once the preconditioned residual has dropped 6 orders
    # (more than enough for an inexact-Newton LM step): converged
    # iterates stop paying matvecs instead of spinning to the cap.
    rz_tol = cg_rtol * jnp.maximum(rz0, 1e-300)

    def cg_cond(state):
        it, x_c, x_s, r_c, r_s, z_c, z_s, p_cv, p_sv, rz = state
        return (it < cg_iterations) & (rz > rz_tol)

    def cg_body(state):
        it, x_c, x_s, r_c, r_s, z_c, z_s, p_cv, p_sv, rz = state
        ap_c, ap_s = matvec(p_cv, p_sv)
        pap = pdot(p_cv, p_sv, ap_c, ap_s)
        ok = (pap > 0.0) & (rz > 0.0)
        alpha = jnp.where(ok, rz / jnp.where(ok, pap, 1.0), 0.0)
        x_c = x_c + alpha * p_cv
        x_s = x_s + alpha * p_sv
        r_c_new = jnp.where(ok, r_c - alpha * ap_c, r_c)
        r_s_new = jnp.where(ok, r_s - alpha * ap_s, r_s)
        z_c_new, z_s_new = precond(r_c_new, r_s_new)
        rz_new = pdot(r_c_new, r_s_new, z_c_new, z_s_new)
        beta = jnp.where(ok, rz_new / jnp.where(ok, rz, 1.0), 0.0)
        return (it + 1, x_c, x_s, r_c_new, r_s_new, z_c_new, z_s_new,
                jnp.where(ok, z_c_new + beta * p_cv, p_cv),
                jnp.where(ok, z_s_new + beta * p_sv, p_sv),
                jnp.where(ok, rz_new, jnp.zeros_like(rz_new)))

    (_, dx_cam, dx_sh, _, _, _, _, _, _, _) = jax.lax.while_loop(
        cg_cond, cg_body,
        (jnp.asarray(0, jnp.int32), x0_c, x0_s, rhs_c, rhs_s,
         z0_c, z0_s, z0_c, z0_s, rz0),
    )

    # Bundle back-substitution.
    w_dx = w_apply(dx_cam)
    w_dx_b = jax.ops.segment_sum(
        w_dx, mkr_bnd_index, num_segments=num_bundles
    )
    rhs_b = blocks.g_bnd + w_dx_b
    if num_shared:
        rhs_b = rhs_b + jnp.einsum("bas,s->ba", blocks.hbs, dx_sh)
    dx_bnd = -jnp.einsum("bij,bj->bi", a_inv, rhs_b)

    gnorm = jnp.maximum(
        jnp.max(jnp.abs(blocks.g_cam)), jnp.max(jnp.abs(blocks.g_bnd))
    )
    if num_shared:
        gnorm = jnp.maximum(gnorm, jnp.max(jnp.abs(blocks.g_sh)))
    diag_b = jnp.maximum(
        jnp.diagonal(blocks.b_blocks, axis1=-2, axis2=-1), 1e-12
    )
    diag_a = jnp.maximum(
        jnp.diagonal(blocks.a_blocks, axis1=-2, axis2=-1), 1e-12
    )
    pred = 0.5 * (
        mu * jnp.sum(diag_b * dx_cam * dx_cam)
        + mu * jnp.sum(diag_a * dx_bnd * dx_bnd)
        - jnp.sum(dx_cam * blocks.g_cam)
        - jnp.sum(dx_bnd * blocks.g_bnd)
    )
    if num_shared:
        diag_s = jnp.maximum(jnp.diag(blocks.hss), 1e-12)
        pred = pred + 0.5 * (
            mu * jnp.sum(diag_s * dx_sh * dx_sh)
            - jnp.sum(dx_sh * blocks.g_sh)
        )
    return dx_cam, dx_bnd, dx_sh, blocks.cost, gnorm, pred


class _BAState(NamedTuple):
    cam: jax.Array
    bnd: jax.Array
    sh: jax.Array
    cost: jax.Array
    mu: jax.Array
    nu: jax.Array
    it: jax.Array
    stop: jax.Array
    gnorm: jax.Array
    nfev: int = 1
    njev: int = 0


def solve_ba(
    problem: BAProblem,
    max_iterations=20,
    tau=1e-3,
    eps1=1e-8,
    eps2=1e-8,
    eps3=1e-8,
    linear_solver="cholesky",
    cg_iterations=30,
) -> BAResult:
    """LM over the arrowhead-structured normal equations.  Jittable.

    Stopping mirrors solver/lm.py (and cminpack in spirit): eps1 =
    gradient inf-norm (gtol), eps2 = relative step size (xtol), eps3 =
    relative cost reduction on an accepted step (ftol).

    linear_solver: 'cholesky' factors the reduced [camera | border]
    system exactly (best convergence per iteration; its sequential
    column dependency makes it latency-bound for large F);
    'cg' solves it with block-preconditioned conjugate gradients —
    every matvec is batched einsum work, the right choice for long
    shots (same structure the distributed path uses,
    parallel/ba_sharded.py)."""
    if linear_solver not in ("cholesky", "cg"):
        raise ValueError("linear_solver must be 'cholesky' or 'cg'")
    if problem.num_cameras > 1 and linear_solver != "cg":
        raise ValueError(
            "multi-camera BAProblem requires linear_solver='cg'"
        )
    # A float32 matmul at default precision may run in TF32 (10-bit
    # mantissa) on the GPU; the normal equations' einsum reductions and
    # the Schur elimination need full f32 or the arrowhead system loses
    # the conditioning it needs (CPU matmuls are always full precision,
    # so CPU tests cannot catch a missing pin).
    with jax.default_matmul_precision("float32"):
        return _solve_ba_impl(
            problem, max_iterations, tau, eps1, eps2, eps3,
            linear_solver, cg_iterations,
        )


# Public alias: the resumable-solve state passed between ba_init /
# ba_run_block dispatches (the BA counterpart of lm.py's LMState).
BAState = _BAState


def ba_init(problem: BAProblem, tau=1e-3) -> _BAState:
    """Initial BA state (cost at the starting parameters).  Jittable.

    The block-resumable primitive trio ba_init / ba_run_block /
    ba_finalize mirrors lm.py's lm_init / lm_run_block / lm_finalize —
    the host regains control between iteration blocks for progress
    reporting / cooperative interruption on long BA solves (ref:
    MComputation::isInterruptRequested polled in the reference's
    residual callback, adjust_solveFunc.cpp:567-571)."""
    cost0 = ba_cost(
        problem, problem.cam_params, problem.bnd_params,
        problem.shared_params,
    )
    return _BAState(
        cam=problem.cam_params,
        bnd=problem.bnd_params,
        sh=problem.shared_params,
        cost=cost0,
        mu=jnp.asarray(tau, problem.cam_params.dtype),
        nu=jnp.asarray(2.0, problem.cam_params.dtype),
        it=jnp.asarray(0, jnp.int32),
        stop=jnp.asarray(0, jnp.int32),
        gnorm=jnp.asarray(jnp.inf, problem.cam_params.dtype),
        nfev=jnp.asarray(1, jnp.int32),
        njev=jnp.asarray(0, jnp.int32),
    )


def ba_run_block(problem, state, limit, max_iterations=20,
                 eps1=1e-8, eps2=1e-8, eps3=1e-8,
                 linear_solver="cholesky", cg_iterations=30):
    """Run LM iterations until convergence or `limit` TOTAL
    iterations (a dynamic scalar — one compiled program serves every
    block).  Resumable: feed the returned state back with a larger
    limit.  Jittable."""
    with jax.default_matmul_precision("float32"):
        limit = jnp.minimum(
            jnp.asarray(limit, jnp.int32), max_iterations
        )
        body = _make_ba_body(problem, eps1, eps2, eps3, linear_solver,
                             cg_iterations)

        def cond(s):
            return (s.stop == 0) & (s.it < limit)

        return jax.lax.while_loop(cond, body, state)


def ba_finalize(state: _BAState, cost_initial) -> BAResult:
    """Wrap a (possibly interrupted) state as a BAResult."""
    stop = jnp.where(state.stop == 0, 4, state.stop)
    return BAResult(
        cam_params=state.cam,
        bnd_params=state.bnd,
        shared_params=state.sh,
        cost=state.cost,
        cost_initial=cost_initial,
        iterations=state.it,
        stop_reason=stop,
        gradient_norm=state.gnorm,
        func_evals=state.nfev,
        jacobian_evals=state.njev,
    )


def _solve_ba_impl(problem, max_iterations, tau, eps1, eps2, eps3,
                   linear_solver="cholesky", cg_iterations=30):
    init = ba_init(problem, tau)
    cost0 = init.cost

    def cond(s):
        return (s.stop == 0) & (s.it < max_iterations)

    body = _make_ba_body(problem, eps1, eps2, eps3, linear_solver,
                         cg_iterations)
    final = jax.lax.while_loop(cond, body, init)
    return ba_finalize(final, cost0)


def _make_ba_body(problem, eps1, eps2, eps3, linear_solver,
                  cg_iterations):
    """One gain-ratio LM iteration (the while_loop body), shared by
    the fused and the block-resumable drivers."""

    def body(s):
        if linear_solver == "cg":
            dx_cam, dx_bnd, dx_sh, cost, gnorm, pred = _schur_cg_step(
                problem, s.cam, s.bnd, s.sh, s.mu, cg_iterations
            )
        else:
            (dx_cam, dx_bnd, dx_sh, cost, gnorm,
             pred) = _schur_normal_step(
                problem, s.cam, s.bnd, s.sh, s.mu
            )
        ok = (
            jnp.all(jnp.isfinite(dx_cam))
            & jnp.all(jnp.isfinite(dx_bnd))
            & jnp.all(jnp.isfinite(dx_sh))
        )
        dx_cam = jnp.where(ok, dx_cam, 0.0)
        dx_bnd = jnp.where(ok, dx_bnd, 0.0)
        dx_sh = jnp.where(ok, dx_sh, 0.0)

        cam_new = s.cam + dx_cam
        bnd_new = s.bnd + dx_bnd
        sh_new = s.sh + dx_sh
        cost_new = ba_cost(problem, cam_new, bnd_new, sh_new)

        # True gain ratio + Nielsen's update (same as lm.py:234-236).
        pred = jnp.maximum(pred, 1e-300)
        rho = (cost - cost_new) / pred
        accept = ok & (rho > 0.0) & jnp.isfinite(cost_new)

        cam2 = jnp.where(accept, cam_new, s.cam)
        bnd2 = jnp.where(accept, bnd_new, s.bnd)
        sh2 = jnp.where(accept, sh_new, s.sh)
        cost2 = jnp.where(accept, cost_new, cost)
        mu_accept = s.mu * jnp.maximum(
            1.0 / 3.0, 1.0 - (2.0 * rho - 1.0) ** 3
        )
        mu_new = jnp.where(accept, mu_accept, s.mu * s.nu)
        nu_new = jnp.where(accept, 2.0, s.nu * 2.0)

        step_norm = jnp.sqrt(
            jnp.sum(dx_cam * dx_cam)
            + jnp.sum(dx_bnd * dx_bnd)
            + jnp.sum(dx_sh * dx_sh)
        )
        x_norm = jnp.sqrt(
            jnp.sum(s.cam * s.cam)
            + jnp.sum(s.bnd * s.bnd)
            + jnp.sum(s.sh * s.sh)
        )
        ftol_hit = accept & (
            (cost - cost_new) <= eps3 * jnp.maximum(cost, 1e-300)
        )
        xtol_hit = step_norm <= eps2 * (x_norm + eps2)
        gtol_hit = gnorm <= eps1
        failed = (~ok) | (~jnp.isfinite(mu_new))
        stop = jnp.where(
            failed,
            5,
            jnp.where(
                gtol_hit,
                3,
                jnp.where(xtol_hit, 2, jnp.where(ftol_hit, 1, 0)),
            ),
        ).astype(jnp.int32)
        return _BAState(
            cam=cam2, bnd=bnd2, sh=sh2, cost=cost2, mu=mu_new,
            nu=nu_new, it=s.it + 1, stop=stop, gnorm=gnorm,
            # One block assembly (residual + Jacobian blocks) and one
            # trial cost evaluation per iteration, counted in-state.
            nfev=s.nfev + 1, njev=s.njev + 1,
        )

    return body


def make_ba_problem(
    marker_uv,
    weight,
    mkr_bnd_index,
    cam_params,
    bnd_params,
    mkr_cam_index=None,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    film_offset_x_mm=0.0,
    film_offset_y_mm=0.0,
    far_clip_cm=10000.0,
    camera_scale=1.0,
    render_width=1920,
    render_height=1080,
    film_fit=1,
    rotate_order=0,
    image_width: Optional[float] = None,
    solve_focal=False,
    lens_model_type="",
    lens_params: Optional[Sequence[float]] = None,
    lens_solve_names: Optional[Sequence[str]] = None,
    lens_pixel_aspect=1.0,
    loss_type=0,
    loss_scale=1.0,
    intrinsics=None,
) -> BAProblem:
    """Assemble a BAProblem.

    Shared (border) parameters — the reference's static attributes
    (focal length, lens coefficients) coupling all frames — are
    initialized from focal_length_mm / lens_params:
      * solve_focal=True puts ONE focal length into the border (the
        reference's static focal attribute semantics);
      * lens_solve_names lists lens parameter fields to solve (any
        subset of the model's fields); the rest stay fixed.
    intrinsics may override the derived (F, 8) per-frame array.
    """
    import numpy as _np

    # Leaves stay HOST numpy arrays: they upload batched at jit
    # dispatch instead of one eager transfer each.
    marker_uv = _np.asarray(marker_uv)
    num_frames = marker_uv.shape[1]
    num_markers = marker_uv.shape[0]
    dtype = marker_uv.dtype

    cam_params = _np.asarray(cam_params, dtype)
    num_cameras = cam_params.shape[0] // num_frames
    if cam_params.shape[0] % num_frames != 0:
        raise ValueError(
            "cam_params rows (%d) must be num_cameras * num_frames "
            "(F=%d)" % (cam_params.shape[0], num_frames)
        )
    if mkr_cam_index is None:
        mkr_cam_block = _np.zeros(num_markers, _np.int32)
    else:
        mkr_cam_block = (
            _np.asarray(mkr_cam_index, _np.int32) * num_frames
        )
    if intrinsics is None:
        intr_row = _np.asarray(
            [
                focal_length_mm,
                film_back_width_mm,
                film_back_height_mm,
                film_offset_x_mm,
                film_offset_y_mm,
                far_clip_cm,
                camera_scale,
                float(render_width) / float(render_height),
            ],
            dtype,
        )
        intrinsics = _np.broadcast_to(
            intr_row, (num_cameras * num_frames, 8)
        )
    else:
        intrinsics = _np.asarray(intrinsics, dtype)
        if intrinsics.shape[0] != num_cameras * num_frames:
            raise ValueError(
                "intrinsics rows must match cam_params rows"
            )

    if lens_model_type:
        from mayamatchmovesolver_tpu.models import scenelens

        fields = scenelens._MODEL_FIELDS[lens_model_type]
        defaults = scenelens._MODEL_DEFAULTS[lens_model_type]
        if lens_params is None:
            lens_values = [float(getattr(defaults, n)) for n in fields]
        elif isinstance(lens_params, dict):
            lens_values = [
                float(lens_params.get(n, float(getattr(defaults, n))))
                for n in fields
            ]
        else:
            lens_values = [float(v) for v in lens_params]
            if len(lens_values) != len(fields):
                raise ValueError(
                    "lens_params needs %d values for %s"
                    % (len(fields), lens_model_type)
                )
        solve_names = set(lens_solve_names or ())
        unknown = solve_names - set(fields)
        if unknown:
            raise ValueError(
                "unknown lens fields for %s: %r"
                % (lens_model_type, sorted(unknown))
            )
        lens_solve_mask = tuple(n in solve_names for n in fields)
    else:
        lens_values = []
        lens_solve_mask = ()
        if lens_solve_names:
            raise ValueError("lens_solve_names without lens_model_type")

    shared = []
    if solve_focal:
        # One border focal per camera (C=1: the single shared focal),
        # initialized from each camera's intrinsics row.
        intr_np = _np.asarray(intrinsics)
        for ci in range(num_cameras):
            shared.append(float(intr_np[ci * num_frames, 0]))
    for pi, solved in enumerate(lens_solve_mask):
        if solved:
            shared.append(lens_values[pi])

    return BAProblem(
        marker_uv=marker_uv,
        weight=_np.sqrt(_np.maximum(_np.asarray(weight, dtype), 0.0)),
        mkr_bnd_index=_np.asarray(mkr_bnd_index, _np.int32),
        mkr_cam_block=_np.asarray(mkr_cam_block, _np.int32),
        cam_params=cam_params,
        bnd_params=_np.asarray(bnd_params, dtype),
        shared_params=_np.asarray(shared, dtype),
        intrinsics=intrinsics,
        lens_params=_np.asarray(lens_values, dtype),
        lens_pixel_aspect=_np.asarray(lens_pixel_aspect, dtype),
        film_fit=int(film_fit),
        rotate_order=int(rotate_order),
        image_width=float(image_width or render_width),
        solve_focal=bool(solve_focal),
        lens_model_type=str(lens_model_type),
        lens_solve_mask=lens_solve_mask,
        loss_type=int(loss_type),
        loss_scale=float(loss_scale),
    )
