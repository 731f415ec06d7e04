"""Flattened scene representation and its batched evaluator.

Redesign of the reference's FlatScene
(ref: lib/rust/mmscenegraph/src/scene/flat.rs:41-358): the editable DAG
is baked (scenegraph.py) into flat index arrays — parent indices per
transform, camera/bundle transform indices, marker->camera/bundle links —
and evaluation is one jit-compiled function producing world matrices and
reprojected marker/point pairs for *all* (node, frame) combinations at
once.

Key departure from the reference: instead of a serial loop over
transforms (ref: math/dag.rs:234-320), world matrices are composed with
pointer-doubling over the parent array — O(log depth) batched 4x4 matmul
sweeps, each fully parallel over (transform, frame), which XLA fuses
into a few elementwise programs.
"""

import dataclasses
import math
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mayamatchmovesolver_tpu.core import camera as cam_math
from mayamatchmovesolver_tpu.core import transform as tfm_math
from mayamatchmovesolver_tpu.core.constants import MM_TO_INCH
from mayamatchmovesolver_tpu.scene.attrblock import (
    AttrBlock,
    gather_attr_values,
)

# The reference hard-codes the near clip plane during scene-graph
# evaluation (ref: lib/rust/mmscenegraph/src/math/dag.rs:150-154).
NEAR_CLIP_PLANE_CM = 0.1

# Column layout of tfm_attr_codes.
TFM_ATTRS = ("tx", "ty", "tz", "rx", "ry", "rz", "sx", "sy", "sz")
# Column layout of cam_attr_codes.
CAM_ATTRS = (
    "sensor_width_mm",
    "sensor_height_mm",
    "focal_length_mm",
    "lens_offset_x_mm",
    "lens_offset_y_mm",
    "near_clip_cm",
    "far_clip_cm",
    "camera_scale",
)
# Column layout of mkr_attr_codes.  overscan_x/y come from the marker's
# MarkerGroup (shared attr codes; ATTR_NONE evaluates as 1.0) — the
# capability of the reference's MarkerGroup/mmMarkerScale overscan
# (ref: src/mmSolver/node/MMMarkerScaleNode.cpp,
# python/mmSolver/_api/markergroup.py).
MKR_ATTRS = ("tx", "ty", "weight", "enable", "overscan_x", "overscan_y")


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FlatScene:
    """Baked, static-shape scene structure (a pytree).

    Index arrays are data leaves so one compiled evaluate() serves many
    scenes of the same shape; `doubling_steps` is static metadata.
    """

    # Transforms, topologically sorted (parent index < child index).
    tfm_attr_codes: jax.Array  # (T, 9) int32
    tfm_rotate_order: jax.Array  # (T,) int32
    tfm_parent: jax.Array  # (T,) int32, -1 for roots

    # Cameras.
    cam_tfm_index: jax.Array  # (C,) int32
    cam_attr_codes: jax.Array  # (C, 8) int32
    cam_film_fit: jax.Array  # (C,) int32
    cam_render_size: jax.Array  # (C, 2) float (width, height) pixels

    # Bundles.
    bnd_tfm_index: jax.Array  # (B,) int32

    # Markers.
    mkr_cam_index: jax.Array  # (M,) int32
    mkr_bnd_index: jax.Array  # (M,) int32
    mkr_attr_codes: jax.Array  # (M, 6) int32

    doubling_steps: int = dataclasses.field(metadata={"static": True})

    @property
    def num_transforms(self):
        return self.tfm_attr_codes.shape[0]

    @property
    def num_cameras(self):
        return self.cam_tfm_index.shape[0]

    @property
    def num_bundles(self):
        return self.bnd_tfm_index.shape[0]

    @property
    def num_markers(self):
        return self.mkr_cam_index.shape[0]


class SceneEval(NamedTuple):
    """Everything evaluate() produces, shaped (N, F, ...)."""

    tfm_world: jax.Array  # (T, F, 4, 4)
    cam_world: jax.Array  # (C, F, 4, 4)
    cam_world_inv: jax.Array  # (C, F, 4, 4)
    cam_proj: jax.Array  # (C, F, 4, 4)
    bnd_world_point: jax.Array  # (B, F, 3)
    point_xy: jax.Array  # (M, F, 2) reprojected bundle, marker space
    marker_xy: jax.Array  # (M, F, 2) film-fit-scaled marker position
    marker_weight: jax.Array  # (M, F)
    marker_enable: jax.Array  # (M, F)
    behind_camera: jax.Array  # (M, F) bool


def doubling_steps_for_depth(max_depth):
    """Pointer-doubling sweeps needed for a hierarchy of given depth
    (number of edges on the longest root-to-leaf path)."""
    if max_depth <= 0:
        return 0
    return max(1, int(math.ceil(math.log2(max_depth + 1))))


def compute_world_matrices(scene: FlatScene, local_matrices):
    """Compose local matrices up parent chains via pointer doubling.

    local_matrices: (T, F, 4, 4).  Returns world matrices, same shape.
    Replaces the reference's sequential parent-index walk
    (ref: lib/rust/mmscenegraph/src/math/dag.rs:234-320) with
    log2(depth) fully-batched matmul sweeps.
    """
    world = local_matrices
    parent = scene.tfm_parent
    for _ in range(scene.doubling_steps):
        has_parent = parent >= 0
        pidx = jnp.maximum(parent, 0)
        parent_world = world[pidx]
        composed = jnp.einsum(
            "tfij,tfjk->tfik",
            parent_world,
            world,
            preferred_element_type=world.dtype,
        )
        world = jnp.where(has_parent[:, None, None, None], composed, world)
        parent = jnp.where(has_parent, parent[pidx], -1)
    return world


def evaluate(scene: FlatScene, attrs: AttrBlock, frame_indices) -> SceneEval:
    """Evaluate the whole scene for all frames at once.

    frame_indices: (F,) int32 indices into the baked frame axis.
    Replicates FlatScene::evaluate
    (ref: lib/rust/mmscenegraph/src/scene/flat.rs:172-358) but batched:
    every (transform, frame), (camera, frame) and (marker, frame) value is
    produced by one traced program.
    """
    frame_indices = jnp.asarray(frame_indices, dtype=jnp.int32)

    # ---- Transform local + world matrices. -------------------------------
    tv = gather_attr_values(attrs, scene.tfm_attr_codes, frame_indices)
    # tv: (T, 9, F) -> (T, F) per channel.
    tvals = {name: tv[:, i, :] for i, name in enumerate(TFM_ATTRS)}
    # Scale attrs default to 1.0 when absent (ATTR_NONE gathers to 0).
    scale_default = scene.tfm_attr_codes[:, 6:9] < 0  # (T, 3)
    sx = jnp.where(scale_default[:, 0:1], 1.0, tvals["sx"])
    sy = jnp.where(scale_default[:, 1:2], 1.0, tvals["sy"])
    sz = jnp.where(scale_default[:, 2:3], 1.0, tvals["sz"])

    local = tfm_math.trs_matrix(
        tvals["tx"],
        tvals["ty"],
        tvals["tz"],
        tvals["rx"],
        tvals["ry"],
        tvals["rz"],
        sx,
        sy,
        sz,
        scene.tfm_rotate_order[:, None],
    )  # (T, F, 4, 4)
    tfm_world = compute_world_matrices(scene, local)

    # ---- Cameras. --------------------------------------------------------
    cam_world = tfm_world[scene.cam_tfm_index]  # (C, F, 4, 4)
    cam_world_inv = tfm_math.affine_inverse(cam_world)

    cv = gather_attr_values(attrs, scene.cam_attr_codes, frame_indices)
    cvals = {name: cv[:, i, :] for i, name in enumerate(CAM_ATTRS)}
    camera_scale = jnp.where(
        (scene.cam_attr_codes[:, 7] < 0)[:, None], 1.0, cvals["camera_scale"]
    )
    render_w = scene.cam_render_size[:, 0:1]
    render_h = scene.cam_render_size[:, 1:2]
    cam_proj = cam_math.projection_matrix(
        cvals["focal_length_mm"],
        cvals["sensor_width_mm"] * MM_TO_INCH,
        cvals["sensor_height_mm"] * MM_TO_INCH,
        cvals["lens_offset_x_mm"] * MM_TO_INCH,
        cvals["lens_offset_y_mm"] * MM_TO_INCH,
        render_w,
        render_h,
        scene.cam_film_fit[:, None],
        NEAR_CLIP_PLANE_CM,
        cvals["far_clip_cm"],
        camera_scale,
    )  # (C, F, 4, 4)

    # ---- Bundles. --------------------------------------------------------
    bnd_world = tfm_world[scene.bnd_tfm_index]  # (B, F, 4, 4)
    bnd_world_point = bnd_world[..., :3, 3]

    # ---- Markers: reproject + film-fit-scaled marker positions. ----------
    view_proj = jnp.einsum(
        "cfij,cfjk->cfik",
        cam_proj,
        cam_world_inv,
        preferred_element_type=cam_proj.dtype,
    )
    mkr_vp = view_proj[scene.mkr_cam_index]  # (M, F, 4, 4)
    mkr_bnd_pos = bnd_world_point[scene.mkr_bnd_index]  # (M, F, 3)
    p_h = jnp.concatenate(
        [mkr_bnd_pos, jnp.ones_like(mkr_bnd_pos[..., :1])], axis=-1
    )
    clip = jnp.einsum("mfij,mfj->mfi", mkr_vp, p_h)
    point_xy = clip[..., :2] / clip[..., 3:4] * 0.5

    # Behind-camera detection: dot(camera forward, camera->bundle) < 0
    # (ref: src/mmSolver/adjust/adjust_measureErrors.cpp:262-270).  The
    # camera looks down its local -Z axis.
    mkr_cam_world = cam_world[scene.mkr_cam_index]  # (M, F, 4, 4)
    cam_forward = -mkr_cam_world[..., :3, 2]
    cam_pos = mkr_cam_world[..., :3, 3]
    to_bnd = mkr_bnd_pos - cam_pos
    behind_camera = (
        jnp.sum(cam_forward * to_bnd, axis=-1) < 0.0
    )  # normalization is irrelevant to the sign

    # Marker attr values.
    mv = gather_attr_values(attrs, scene.mkr_attr_codes, frame_indices)
    mkr_tx, mkr_ty = mv[:, 0, :], mv[:, 1, :]
    weight_code = scene.mkr_attr_codes[:, 2]
    enable_code = scene.mkr_attr_codes[:, 3]
    marker_weight = jnp.where((weight_code < 0)[:, None], 1.0, mv[:, 2, :])
    marker_enable = jnp.where((enable_code < 0)[:, None], 1.0, mv[:, 3, :])
    # MarkerGroup overscan scale (defaults to 1 when unset).
    osx = jnp.where(
        (scene.mkr_attr_codes[:, 4] < 0)[:, None], 1.0, mv[:, 4, :]
    )
    osy = jnp.where(
        (scene.mkr_attr_codes[:, 5] < 0)[:, None], 1.0, mv[:, 5, :]
    )
    mkr_tx = mkr_tx * osx
    mkr_ty = mkr_ty * osy

    # Film-fit scaling of the marker position so marker and reprojected
    # point live in the same space (ref: scene/flat.rs:73-97, 330-344).
    sensor_aspect = cvals["sensor_width_mm"] / cvals["sensor_height_mm"]
    render_aspect = render_w / render_h  # (C, 1)
    fit_sx, fit_sy = cam_math.marker_film_fit_scale(
        scene.cam_film_fit[:, None], sensor_aspect, render_aspect
    )  # (C, F)
    mkr_xy = jnp.stack(
        [
            mkr_tx * fit_sx[scene.mkr_cam_index],
            mkr_ty * fit_sy[scene.mkr_cam_index],
        ],
        axis=-1,
    )

    return SceneEval(
        tfm_world=tfm_world,
        cam_world=cam_world,
        cam_world_inv=cam_world_inv,
        cam_proj=cam_proj,
        bnd_world_point=bnd_world_point,
        point_xy=point_xy,
        marker_xy=mkr_xy,
        marker_weight=marker_weight,
        marker_enable=marker_enable,
        behind_camera=behind_camera,
    )


def marker_fit_scale(scene: FlatScene, attrs: AttrBlock, frame_indices):
    """Per-marker film-fit scale factors, shaped ((M, F), (M, F)).

    Raw marker tx/ty attributes live in pre-film-fit marker space; the
    evaluator multiplies them by these factors to place them in the same
    screen space as reprojected points (ref: scene/flat.rs:73-97).
    """
    cv = gather_attr_values(attrs, scene.cam_attr_codes, frame_indices)
    sensor_aspect = cv[:, CAM_ATTRS.index("sensor_width_mm"), :] / cv[
        :, CAM_ATTRS.index("sensor_height_mm"), :
    ]
    render_aspect = scene.cam_render_size[:, 0:1] / scene.cam_render_size[
        :, 1:2
    ]
    fit_sx, fit_sy = cam_math.marker_film_fit_scale(
        scene.cam_film_fit[:, None], sensor_aspect, render_aspect
    )
    return fit_sx[scene.mkr_cam_index], fit_sy[scene.mkr_cam_index]


def set_marker_screen_positions(
    scene: FlatScene, attrs: AttrBlock, frame_indices, screen_xy
):
    """Write screen-space positions into the raw marker tx/ty attributes.

    screen_xy: (M, F, 2) in the reprojected-point screen space (the space
    of SceneEval.point_xy / marker_xy).  The inverse film-fit scale is
    applied so that a subsequent evaluate() reproduces marker_xy ==
    screen_xy.  Used to synthesize ground-truth tracks for tests and the
    camera-solve bootstrap (the reference instead loads tracker files that
    are already in marker space).  Returns a new AttrBlock.
    """
    fsx, fsy = marker_fit_scale(scene, attrs, frame_indices)
    # MarkerGroup overscan also scales raw markers at evaluation.
    ov = gather_attr_values(
        attrs, scene.mkr_attr_codes[:, 4:6], frame_indices
    )
    osx = np.where(
        np.asarray(scene.mkr_attr_codes[:, 4] < 0)[:, None],
        1.0, np.asarray(ov[:, 0, :]),
    )
    osy = np.where(
        np.asarray(scene.mkr_attr_codes[:, 5] < 0)[:, None],
        1.0, np.asarray(ov[:, 1, :]),
    )
    raw = np.stack(
        [
            np.asarray(screen_xy)[..., 0] / (np.asarray(fsx) * osx),
            np.asarray(screen_xy)[..., 1] / (np.asarray(fsy) * osy),
        ],
        axis=-1,
    )  # (M, F, 2)
    fi = np.asarray(frame_indices)
    anim = np.array(attrs.anim_values)
    static = np.array(attrs.static_values)
    codes = np.asarray(scene.mkr_attr_codes)
    for m in range(codes.shape[0]):
        for ci in (0, 1):  # tx, ty columns of MKR_ATTRS
            code = int(codes[m, ci])
            if code < 0:
                continue
            if code % 2 == 1:
                anim[code // 2, fi] = raw[m, :, ci]
            else:
                static[code // 2] = raw[m, 0, ci]
    return attrs._replace(
        static_values=jnp.asarray(static), anim_values=jnp.asarray(anim)
    )


def flat_scene_from_numpy(
    tfm_attr_codes,
    tfm_rotate_order,
    tfm_parent,
    cam_tfm_index,
    cam_attr_codes,
    cam_film_fit,
    cam_render_size,
    bnd_tfm_index,
    mkr_cam_index,
    mkr_bnd_index,
    mkr_attr_codes,
):
    """Assemble a FlatScene from host arrays, deriving doubling_steps."""
    tfm_parent = np.asarray(tfm_parent, dtype=np.int32)
    depth = np.zeros(tfm_parent.shape[0], dtype=np.int64)
    for i, p in enumerate(tfm_parent):
        depth[i] = 0 if p < 0 else depth[p] + 1
    max_depth = int(depth.max()) if depth.size else 0
    return FlatScene(
        tfm_attr_codes=jnp.asarray(tfm_attr_codes, dtype=jnp.int32),
        tfm_rotate_order=jnp.asarray(tfm_rotate_order, dtype=jnp.int32),
        tfm_parent=jnp.asarray(tfm_parent),
        cam_tfm_index=jnp.asarray(cam_tfm_index, dtype=jnp.int32),
        cam_attr_codes=jnp.asarray(cam_attr_codes, dtype=jnp.int32),
        cam_film_fit=jnp.asarray(cam_film_fit, dtype=jnp.int32),
        cam_render_size=jnp.asarray(
            cam_render_size, dtype=jnp.result_type(float)
        ),
        bnd_tfm_index=jnp.asarray(bnd_tfm_index, dtype=jnp.int32),
        mkr_cam_index=jnp.asarray(mkr_cam_index, dtype=jnp.int32),
        mkr_bnd_index=jnp.asarray(mkr_bnd_index, dtype=jnp.int32),
        mkr_attr_codes=jnp.asarray(mkr_attr_codes, dtype=jnp.int32),
        doubling_steps=doubling_steps_for_depth(max_depth),
    )


# Jit-compiled evaluate for EAGER host callers (the bridge, tools):
# without this every evaluate() outside a jit context dispatches each
# primitive separately instead of one fused program.  (Callers inside
# jit keep using evaluate.)
evaluate_jit = jax.jit(evaluate)
