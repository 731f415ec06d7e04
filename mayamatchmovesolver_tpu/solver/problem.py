"""Solve-problem definition: parameters <-> attributes, residual assembly.

This is the replacement for the reference's SolverData +
solveFunc residual callback (ref: src/mmSolver/adjust/adjust_solveFunc.cpp:529,
adjust_measureErrors.cpp:392-521, adjust_setParameters.cpp:174-250):

  * a parameter vector maps onto attribute storage by pure scatter
    (setParameters) — static attrs or (animated attr, frame) cells;
  * the scene is evaluated for all frames at once;
  * residuals are the weighted pixel deviations plus optional
    stiffness/smoothness soft constraints.

Everything is differentiable: the solver gets analytic Jacobians via
jax.jacfwd instead of the reference's finite differences
(adjust_solveFunc.cpp:305-525).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from mayamatchmovesolver_tpu.scene.attrblock import AttrBlock
from mayamatchmovesolver_tpu.scene import flatscene
from mayamatchmovesolver_tpu.solver import bounds
from mayamatchmovesolver_tpu.solver import loss as loss_mod

# Behind-camera residual inflation
# (ref: src/mmSolver/adjust/adjust_measureErrors.cpp:262-270).
BEHIND_CAMERA_ERROR_FACTOR = 1.0e6

ERRORS_PER_MARKER = 2


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SolveProblem:
    """A fully-specified least-squares problem over scene attributes."""

    scene: flatscene.FlatScene
    attrs: AttrBlock  # initial attribute values
    frame_indices: jax.Array  # (F,) int32 into the baked frame axis

    # Parameter layout.  param_codes[i] is the packed attr code the i-th
    # parameter writes; param_frames[i] is the baked frame index for
    # animated attrs or -1 for static
    # (ref equivalent: paramToAttrList, adjust_base.cpp:260-300).
    param_codes: jax.Array  # (P,) int32
    param_frames: jax.Array  # (P,) int32
    param_min: jax.Array  # (P,)
    param_max: jax.Array  # (P,)
    param_offset: jax.Array  # (P,)
    param_scale: jax.Array  # (P,)

    # Stiffness/smoothness soft constraints
    # (ref: adjust_measureErrors.cpp:311-387).  Each entry penalizes an
    # attribute cell's deviation from a target value.  Targets are LIVE:
    # mode 1 (stiffness) gathers the previous frame's value from the
    # *current* attribute state each evaluation, mode 2 (smoothness) the
    # linear prediction from the two previous frames — exactly like the
    # reference, which re-reads the neighboring-frame attr values inside
    # measureErrors with the candidate parameters applied.  mode 0 uses
    # the fixed stiff_target.
    stiff_codes: jax.Array  # (K,) int32 attr codes
    stiff_frames: jax.Array  # (K,) int32 baked frame index (-1 static)
    stiff_prev_frames: jax.Array  # (K,) int32 previous-frame index
    stiff_prev2_frames: jax.Array  # (K,) int32 frame-before-previous
    stiff_mode: jax.Array  # (K,) int32: 0 fixed, 1 stiffness, 2 smooth
    stiff_weight: jax.Array  # (K,)
    stiff_variance: jax.Array  # (K,)
    stiff_target: jax.Array  # (K,) fixed targets (mode 0 only)

    # Line straightness constraints (the reference's Line entities +
    # mmLineBestFit capability contributing to the solve; ref:
    # src/mmSolver/node/MMLineBestFitNode.cpp:94, node_line_utils.cpp,
    # python/mmSolver/_api/line.py): each line is a padded set of
    # marker indices whose reprojected bundles must be collinear in
    # screen space.  Residual = perpendicular deviation from the
    # closed-form TLS line fit, per (line-member, frame).
    line_mkr_index: jax.Array  # (L, K) int32, padded
    line_mkr_mask: jax.Array  # (L, K) bool, False on padding
    line_weight: jax.Array  # (L,)

    # Marker-frame error enablement beyond marker enable/weight: the
    # reference's errorMeasurements / frameIndexEnable culling
    # (adjust_measureErrors.cpp:430-444) becomes a static mask tensor.
    marker_frame_mask: jax.Array  # (M, F) bool

    # Optional per-camera lens bindings (models/scenelens.SceneLens);
    # None disables lens distortion in the residual path
    # (ref: constructLensModelList, adjust_base.cpp:1002).
    lens: object

    # Loss configuration; static so it selects the compiled variant.
    loss_type: int = dataclasses.field(metadata={"static": True})
    loss_scale: float = dataclasses.field(metadata={"static": True})

    # Image width used to convert normalized deviation into pixels
    # (ref: adjust_measureErrors.cpp dx * imageWidth).
    image_width: float = dataclasses.field(metadata={"static": True})

    @property
    def num_params(self):
        return self.param_codes.shape[0]

    @property
    def num_frames(self):
        return self.frame_indices.shape[0]

    @property
    def num_marker_errors(self):
        return (
            self.scene.num_markers * self.num_frames * ERRORS_PER_MARKER
        )

    @property
    def num_line_errors(self):
        return (
            self.line_mkr_index.shape[0]
            * self.line_mkr_index.shape[1]
            * self.num_frames
        )


def initial_parameters(problem: SolveProblem):
    """Read current attr values and map to internal (unbounded) params.

    (ref: get_initial_parameters, adjust_base.cpp:260-300.)
    """
    codes = problem.param_codes
    idx = jnp.maximum(codes, 0) // 2
    attrs = problem.attrs
    s = attrs.static_values[jnp.clip(idx, 0, attrs.num_static - 1)]
    frame = jnp.clip(problem.param_frames, 0, attrs.num_frames - 1)
    a = attrs.anim_values[jnp.clip(idx, 0, attrs.num_anim - 1), frame]
    external = jnp.where(codes % 2 == 1, a, s)
    return bounds.external_to_internal(
        external,
        problem.param_min,
        problem.param_max,
        problem.param_offset,
        problem.param_scale,
    )


def insert_parameters(problem: SolveProblem, params) -> AttrBlock:
    """Scatter internal parameters into a fresh AttrBlock.

    (ref: setParameters, adjust_setParameters.cpp:174-250.)
    """
    external = bounds.internal_to_external(
        params,
        problem.param_min,
        problem.param_max,
        problem.param_offset,
        problem.param_scale,
    )
    attrs = problem.attrs
    codes = problem.param_codes
    is_static = (codes >= 0) & (codes % 2 == 0)
    is_anim = (codes >= 0) & (codes % 2 == 1)
    idx = jnp.maximum(codes, 0) // 2

    sidx = jnp.where(is_static, idx, attrs.num_static)  # OOB rows dropped
    static_values = attrs.static_values.at[sidx].set(
        external.astype(attrs.static_values.dtype), mode="drop"
    )
    aidx = jnp.where(is_anim, idx, attrs.num_anim)
    frame = jnp.clip(problem.param_frames, 0, attrs.num_frames - 1)
    anim_values = attrs.anim_values.at[aidx, frame].set(
        external.astype(attrs.anim_values.dtype), mode="drop"
    )
    return AttrBlock(static_values=static_values, anim_values=anim_values)


def _gather_cell_values(attrs: AttrBlock, codes, frames):
    """Value of attr `codes` at baked-frame `frames` (-1 -> static)."""
    idx = jnp.maximum(codes, 0) // 2
    s = attrs.static_values[jnp.clip(idx, 0, attrs.num_static - 1)]
    a = attrs.anim_values[
        jnp.clip(idx, 0, attrs.num_anim - 1),
        jnp.clip(frames, 0, attrs.num_frames - 1),
    ]
    v = jnp.where(codes % 2 == 1, a, s)
    return jnp.where(codes < 0, jnp.zeros_like(v), v)


def measure_residuals(problem: SolveProblem, attrs: AttrBlock,
                      apply_loss=True, distort_fn=None):
    """Evaluate the scene and assemble the residual vector.

    Returns (residuals, aux) where residuals is
    (M*F*2 + K,) — marker x/y deviations in pixels then soft constraints —
    and aux carries the user-facing deviation stats
    (ref: measureErrors, adjust_measureErrors.cpp:392-521).

    distort_fn, if given, maps projected points through a lens model:
    (problem, attrs, point_xy)->point_xy
    (ref: adjust_measureErrors.cpp:464-480 lens distortion hook).
    """
    ev = flatscene.evaluate(problem.scene, attrs, problem.frame_indices)
    point_xy = ev.point_xy
    if distort_fn is not None:
        point_xy = distort_fn(problem, attrs, point_xy)
    elif problem.lens is not None:
        from mayamatchmovesolver_tpu.models import scenelens

        point_xy = scenelens.apply_scene_lens(
            problem.lens, problem.scene, attrs, problem.frame_indices,
            point_xy, problem.scene.mkr_cam_index, direction="distort",
        )

    mask = (
        problem.marker_frame_mask
        & (ev.marker_enable > 0.5)
        & (ev.marker_weight > 0.0)
    )  # (M, F)

    weight = jnp.sqrt(jnp.maximum(ev.marker_weight, 0.0))
    behind = jnp.where(ev.behind_camera, BEHIND_CAMERA_ERROR_FACTOR, 1.0)

    # Signed residual; the reference uses fabs() which has the same
    # least-squares objective but a kinked derivative
    # (adjust_measureErrors.cpp:278-282) — signed is strictly better for
    # analytic Jacobians.
    d = (ev.marker_xy - point_xy) * problem.image_width  # (M, F, 2)
    d = jnp.where(jnp.isfinite(d), d, 0.0)
    r_mkr = d * (weight * behind * mask)[..., None]
    marker_residuals = r_mkr.reshape(-1)

    # Deviation stats exclude weight/loss, include behind-factor
    # (ref: adjust_measureErrors.cpp:285-292, errorDistanceList).
    # Non-finite deviations are excluded like the reference skips
    # non-finite errors (ref: adjust_base.cpp:356-360).
    dist = (
        jnp.linalg.norm(ev.marker_xy - point_xy, axis=-1)
        * problem.image_width
    )
    mask = mask & jnp.isfinite(dist)
    dist = jnp.where(jnp.isfinite(dist), dist, 0.0)
    n_measured = jnp.maximum(jnp.sum(mask), 1)
    masked_dist = jnp.where(mask, dist, 0.0)
    error_avg = jnp.sum(masked_dist) / n_measured
    error_max = jnp.max(jnp.where(mask, dist, -jnp.inf))
    error_min = jnp.min(jnp.where(mask, dist, jnp.inf))

    # Stiffness/smoothness: err = (1/gaussian(x, target, var) - 1) * w
    # (ref: adjust_measureErrors.cpp:311-387).  Live targets: prev-frame
    # values come from the candidate `attrs`, so the soft constraint
    # tracks the solve instead of going stale (the reference evaluates
    # stiffAttr/smoothAttr values with current parameters applied).
    x = _gather_cell_values(attrs, problem.stiff_codes, problem.stiff_frames)
    prev = _gather_cell_values(
        attrs, problem.stiff_codes, problem.stiff_prev_frames
    )
    prev2 = _gather_cell_values(
        attrs, problem.stiff_codes, problem.stiff_prev2_frames
    )
    target = jnp.where(
        problem.stiff_mode == 1,
        prev,
        jnp.where(
            problem.stiff_mode == 2,
            2.0 * prev - prev2,
            problem.stiff_target,
        ),
    )
    z = (x - target) ** 2 / (
        2.0 * problem.stiff_variance**2
    )
    soft = (jnp.exp(z) - 1.0) * problem.stiff_weight

    # Line straightness: perpendicular deviation of each member's
    # reprojected bundle from the weighted TLS line fit of its group,
    # per frame (capability of mmLineBestFit as a live residual;
    # ref: MMLineBestFitNode.cpp:94, math/line.rs fit_line_to_points).
    if problem.line_mkr_index.shape[0]:
        li = problem.line_mkr_index  # (L, K)
        pts = point_xy[li]  # (L, K, F, 2)
        # A member participates when it is real (not padding) and its
        # marker is enabled on that frame.  The collection's
        # marker_frame_mask governs reprojection errors only — a line
        # added to the solve keeps all its enabled members.
        member = (
            problem.line_mkr_mask[:, :, None]
            & (ev.marker_enable > 0.5)[li]
        )  # (L, K, F)
        wf = member.astype(pts.dtype)
        n = jnp.maximum(jnp.sum(wf, axis=1), 1.0)  # (L, F)
        mean = jnp.sum(pts * wf[..., None], axis=1) / n[..., None]
        d = (pts - mean[:, None]) * wf[..., None]  # (L, K, F, 2)
        sxx = jnp.sum(d[..., 0] ** 2, axis=1)
        syy = jnp.sum(d[..., 1] ** 2, axis=1)
        sxy = jnp.sum(d[..., 0] * d[..., 1], axis=1)
        theta = 0.5 * jnp.arctan2(2.0 * sxy, sxx - syy)  # (L, F)
        normal_x = -jnp.sin(theta)
        normal_y = jnp.cos(theta)
        perp = (
            d[..., 0] * normal_x[:, None] + d[..., 1] * normal_y[:, None]
        )  # (L, K, F)
        line_res = (
            perp
            * problem.line_weight[:, None, None]
            * problem.image_width
        )
        line_res = jnp.where(jnp.isfinite(line_res), line_res, 0.0)
        line_residuals = line_res.reshape(-1)
    else:
        line_residuals = jnp.zeros(0, marker_residuals.dtype)

    residuals = jnp.concatenate([marker_residuals, line_residuals, soft])
    if apply_loss:
        residuals = loss_mod.apply_loss_to_residuals(
            residuals, problem.loss_type, problem.loss_scale
        )

    aux = {
        "error_avg": error_avg,
        "error_min": error_min,
        "error_max": error_max,
        "per_marker_frame_distance": dist,
        "mask": mask,
        "num_measured": jnp.sum(mask),
    }
    return residuals, aux


def residual_fn(problem: SolveProblem, distort_fn=None):
    """params -> residual vector, the function the LM core differentiates.

    (The reference equivalent is one solveFunc call: setParameters +
    measureErrors; ref: adjust_solveFunc.cpp:529-622.)
    """

    def fn(params):
        attrs = insert_parameters(problem, params)
        residuals, _ = measure_residuals(problem, attrs,
                                         distort_fn=distort_fn)
        return residuals

    return fn


def make_marker_frame_mask(num_markers, num_frames, enabled_pairs=None):
    if enabled_pairs is None:
        return np.ones((num_markers, num_frames), dtype=bool)
    mask = np.zeros((num_markers, num_frames), dtype=bool)
    for m, f in enabled_pairs:
        mask[m, f] = True
    return mask
