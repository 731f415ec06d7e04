"""SolveProblem -> BAProblem bridge: route product-surface solves onto
the structured Schur BA backends.

The reference dispatches every registered solver backend behind ONE
command surface on any scene (ref: the solver-type registry and
solveFrames dispatch, src/mmSolver/adjust/adjust_base.cpp:80-127,713).
This module gives this framework the same property for its flagship
backends: when a solve() request has the bundle-adjustment shape —
animated 6-DoF camera pose + static bundle positions (+ static focal /
lens coefficients) — it is converted into a solver/ba.py BAProblem and
solved through the Schur/arrowhead path (or parallel/ba_sharded.py on
a device mesh) instead of the dense LM.  Requests outside that shape
fall back to the dense path, with the reason reported.

The conversion is exact, not approximate: the BA residual implements
the same physics as the dense path (film-fit projection, lens
distortion of the reprojected point, behind-camera inflation, robust
loss, sqrt-weights), so the two backends agree to round-off — the
backend matrix is tested like the reference's MayaDAG/MMSceneGraph
agreement oracle (ref: tests/test/test_solver/test1.py:124-158).
"""

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from mayamatchmovesolver_tpu.scene.attrblock import AttrBlock
from mayamatchmovesolver_tpu.scene import flatscene
from mayamatchmovesolver_tpu.solver import ba as ba_mod

_POSE_NAMES = ("tx", "ty", "tz", "rx", "ry", "rz")


@dataclasses.dataclass
class BABridge:
    """A BAProblem plus the scatter map back into the AttrBlock."""

    problem: ba_mod.BAProblem
    frame_indices: np.ndarray  # (F,)
    pose_codes: np.ndarray  # (C, 6) animated camera channel codes
    bnd_codes: np.ndarray  # (B, 3) static bundle channel codes
    # Static focal codes when solve_focal: one per camera, in border
    # order (None when focal is not solved).
    focal_codes: Optional[List[int]]
    lens_codes: List[int]  # solved lens param codes, border order

    def apply_result(self, attrs: AttrBlock,
                     result: ba_mod.BAResult) -> AttrBlock:
        """Scatter the BA solution back into a fresh AttrBlock
        (the BA path's setParameters counterpart,
        ref: adjust_setParameters.cpp:174-250)."""
        import jax
        import jax.numpy as jnp

        # One bulk fetch (each separate conversion would be its own
        # blocking device-to-host transfer).
        anim, static, cam_all, bnd, shared = jax.device_get((
            attrs.anim_values, attrs.static_values,
            result.cam_params, result.bnd_params,
            result.shared_params,
        ))
        anim = np.array(anim)
        static = np.array(static)
        cam_all = np.asarray(cam_all)
        num_frames = len(self.frame_indices)
        for ci in range(self.pose_codes.shape[0]):
            cam = cam_all[ci * num_frames: (ci + 1) * num_frames]
            for i, code in enumerate(self.pose_codes[ci]):
                anim[code // 2, self.frame_indices] = cam[:, i]
        static[self.bnd_codes // 2] = np.asarray(bnd)
        shared = np.asarray(shared)
        si = 0
        if self.focal_codes is not None:
            for code in self.focal_codes:
                static[code // 2] = shared[si]
                si += 1
        for code in self.lens_codes:
            static[code // 2] = shared[si]
            si += 1
        return AttrBlock(
            static_values=jnp.asarray(static),
            anim_values=jnp.asarray(anim),
        )


def _attr_has_bounds(attr):
    return (
        np.isfinite(attr.min_value)
        or np.isfinite(attr.max_value)
        or attr.offset_value != 0.0
        or attr.scale_value != 1.0
    )


def build_ba_bridge(
    scene,
    attrs: AttrBlock,
    frame_indices,
    solve_attrs,
    options,
    marker_frame_mask=None,
    stiffness=None,
    lens=None,
    lines=None,
) -> Tuple[Optional[BABridge], str]:
    """Classify a solve request; return (BABridge, "") when it has the
    BA shape, else (None, reason).

    The accepted shape (the reference's standard matchmove solve):
      * root-transform cameras with unit scale — ONE camera, or a
        multi-camera rig (stereo / witness cams) with uniform film
        fit / rotate order / render size (camera blocks lay out
        camera-major; multi-camera solves run the CG linear solver);
      * solve attrs = every camera's six animated pose channels, every
        bundle's three static translate channels, optionally (single
        camera only) the static focal length and static lens
        coefficients (layer 0);
      * no box constraints / offsets (BA has no reparameterization);
      * no stiffness/smoothness or line constraints.
    """
    if stiffness is not None and len(stiffness.get("codes", ())):
        return None, "stiffness/smoothness constraints"
    if lines is not None and (
        np.asarray(lines.get("mkr_index", ())).size
    ):
        return None, "line constraints"
    num_cameras = int(scene.num_cameras)
    # ONE bulk fetch of every scene table used below: each separate
    # np.asarray() of a device-resident FlatScene leaf would be its own
    # blocking device-to-host transfer.
    import jax

    (cam_tfms, tfm_parent, bnd_tfms, film_fits, rot_orders_all,
     render_sizes, tfm_codes_dev, cam_attr_codes_dev, mkr_bnd_index,
     mkr_cam_index) = (
        np.asarray(x) for x in jax.device_get((
            scene.cam_tfm_index, scene.tfm_parent,
            scene.bnd_tfm_index, scene.cam_film_fit,
            scene.tfm_rotate_order, scene.cam_render_size,
            scene.tfm_attr_codes, scene.cam_attr_codes,
            scene.mkr_bnd_index, scene.mkr_cam_index,
        ))
    )
    if np.any(tfm_parent[cam_tfms] != -1):
        return None, "camera is not a root transform"

    if np.any(tfm_parent[bnd_tfms] != -1):
        return None, "parented bundles"
    rot_orders = rot_orders_all[cam_tfms]
    if num_cameras > 1:
        # Multi-camera rigs (stereo / witness cams): camera blocks are
        # laid out camera-major; the static film-fit/rotate-order pair
        # must be uniform (they select the compiled program).
        if not (np.all(film_fits == film_fits[0])
                and np.all(rot_orders == rot_orders[0])):
            return None, "cameras differ in film fit / rotate order"
        sizes = render_sizes
        if not np.allclose(sizes, sizes[0]):
            return None, "cameras differ in render size"

    frame_indices = np.asarray(frame_indices, dtype=np.int32)
    num_frames = len(frame_indices)
    tfm_codes = tfm_codes_dev
    pose_code_table = tfm_codes[cam_tfms][:, :6]  # (C, 6)
    cam_attr_code_table = cam_attr_codes_dev  # (C, 8)
    focal_codes = cam_attr_code_table[:, 2]
    bnd_code_table = tfm_codes[bnd_tfms][:, :3]  # (B, 3)

    # Attribute tables ride the same bulk-fetch rule.
    anim, static = jax.device_get(
        (attrs.anim_values, attrs.static_values)
    )
    anim = np.asarray(anim)
    static = np.asarray(static)

    def cell(code, frames):
        code = int(code)
        if code < 0:
            return np.zeros(len(frames))
        if code % 2 == 1:
            return anim[code // 2, frames]
        return np.full(len(frames), static[code // 2])

    # Camera scale must be identity: the BA residual models cameras as
    # pure rigid transforms.
    for ci in range(num_cameras):
        sc_codes = tfm_codes[cam_tfms[ci], 6:9]
        sc = np.stack([cell(c, frame_indices) for c in sc_codes])
        sc = np.where((sc_codes < 0)[:, None], 1.0, sc)
        if not np.allclose(sc, 1.0):
            return None, "camera has non-unit scale"

    # Lens layout (single camera, single layer, layer-0 prefix).
    lens_model_type = ""
    lens_param_codes = None
    lens_pa_code = None
    if lens is not None and lens.has_any():
        if num_cameras > 1:
            return None, "lens distortion on a multi-camera rig"
        stacks = lens.model_types
        if len(stacks) != 1 or len(stacks[0]) != 1:
            return None, "multi-layer or multi-camera lens stack"
        from mayamatchmovesolver_tpu.models import scenelens

        lens_model_type = stacks[0][0]
        n_lp = len(scenelens._MODEL_FIELDS[lens_model_type])
        codes_row = np.asarray(lens.param_codes[0, 0])
        lens_param_codes = codes_row[:n_lp]
        lens_pa_code = int(codes_row[scenelens.MAX_LENS_PARAMS - 1])
        if np.any(lens_param_codes % 2 == 1):
            return None, "animated lens parameters"
        if lens_pa_code >= 0 and lens_pa_code % 2 == 1:
            return None, "animated lens pixel aspect"

    # Classify every solve attribute.
    pose_solved = {}  # (cam_index, channel) -> code
    bnd_solved = {}  # bnd_index -> set(channel)
    solve_focal = False
    focal_solved_cams = set()
    lens_solved_positions = []  # positions into the lens field order
    for attr in solve_attrs:
        if _attr_has_bounds(attr):
            return None, "box constraints on %r" % attr.name
        code = int(attr.code)
        pose_pos = np.nonzero(pose_code_table == code)
        if pose_pos[0].size:
            if code % 2 != 1:
                return None, "static camera pose attr %s" % attr.name
            pose_solved[(int(pose_pos[0][0]), int(pose_pos[1][0]))] = \
                code
            continue
        focal_pos = np.nonzero(focal_codes == code)[0]
        if focal_pos.size:
            if code % 2 != 0:
                return None, "animated focal length"
            # The border holds one focal per camera; track which.
            solve_focal = True
            focal_solved_cams.add(int(focal_pos[0]))
            continue
        bnd_pos = np.nonzero(bnd_code_table == code)
        if bnd_pos[0].size:
            if code % 2 != 0:
                return None, "animated bundle attr"
            bnd_solved.setdefault(int(bnd_pos[0][0]), set()).add(
                int(bnd_pos[1][0])
            )
            continue
        if lens_param_codes is not None:
            lp = np.nonzero(lens_param_codes == code)[0]
            if lp.size:
                lens_solved_positions.append(int(lp[0]))
                continue
        return None, "attribute %s.%s outside the BA shape" % (
            getattr(attr.node, "name", "?"), attr.name
        )

    if solve_focal and len(focal_solved_cams) != num_cameras:
        # The border solves one focal PER camera; a partial set would
        # silently free unsolved cameras' focals too.
        return None, "focal solved on %d of %d cameras" % (
            len(focal_solved_cams), num_cameras
        )
    if len(pose_solved) != 6 * num_cameras:
        return None, "camera pose not fully solved (%d/%d channels)" % (
            len(pose_solved), 6 * num_cameras
        )
    num_bundles = bnd_code_table.shape[0]
    if len(bnd_solved) != num_bundles or any(
        len(chs) != 3 for chs in bnd_solved.values()
    ):
        return None, "bundles not fully solved (%d/%d with tx/ty/tz)" % (
            sum(1 for chs in bnd_solved.values() if len(chs) == 3),
            num_bundles,
        )

    # ---- Extract the BAProblem arrays. --------------------------------
    import jax.numpy as jnp

    ev = flatscene.evaluate_jit(scene, attrs,
                                jnp.asarray(frame_indices))
    marker_xy, marker_weight, marker_enable = jax.device_get(
        (ev.marker_xy, ev.marker_weight, ev.marker_enable)
    )
    marker_uv = np.asarray(marker_xy)
    weight = np.asarray(marker_weight) * (
        np.asarray(marker_enable) > 0.5
    )
    if marker_frame_mask is not None:
        weight = weight * np.asarray(marker_frame_mask, dtype=float)

    # Camera-major pose + intrinsics blocks: (C*F, 6) / (C*F, 8).
    render_w, render_h = render_sizes[0]
    cam_blocks = []
    intr_blocks = []
    for ci in range(num_cameras):
        cam_blocks.append(np.stack(
            [anim[c // 2, frame_indices]
             for c in pose_code_table[ci]], axis=-1,
        ))
        cac = cam_attr_code_table[ci]
        cv = np.stack([cell(c, frame_indices) for c in cac], axis=0)
        cam_scale = np.where(cac[7] < 0, 1.0, cv[7])
        intr_blocks.append(np.stack(
            [
                cv[2],  # focal_length_mm
                cv[0],  # sensor_width_mm
                cv[1],  # sensor_height_mm
                cv[3],  # lens_offset_x_mm
                cv[4],  # lens_offset_y_mm
                cv[6],  # far_clip_cm
                np.broadcast_to(cam_scale, cv[0].shape),
                np.full(num_frames, render_w / render_h),
            ],
            axis=-1,
        ))
    cam_params = np.concatenate(cam_blocks, axis=0)  # (C*F, 6)
    intrinsics = np.concatenate(intr_blocks, axis=0)  # (C*F, 8)
    bnd_params = static[bnd_code_table // 2]  # (B, 3)

    lens_values = None
    lens_solve_names = None
    lens_pixel_aspect = 1.0
    lens_codes_border = []
    if lens_model_type:
        from mayamatchmovesolver_tpu.models import scenelens

        fields = scenelens._MODEL_FIELDS[lens_model_type]
        defaults = scenelens._MODEL_DEFAULTS[lens_model_type]
        lens_values = [
            float(static[c // 2]) if c >= 0
            else float(getattr(defaults, fields[i]))
            for i, c in enumerate(lens_param_codes)
        ]
        if lens_pa_code is not None and lens_pa_code >= 0:
            lens_pixel_aspect = float(static[lens_pa_code // 2])
        lens_solve_names = [
            fields[p] for p in sorted(set(lens_solved_positions))
        ]
        lens_codes_border = [
            int(lens_param_codes[p])
            for p in sorted(set(lens_solved_positions))
        ]

    dtype = static.dtype
    problem = ba_mod.make_ba_problem(
        marker_uv=marker_uv.astype(dtype),
        weight=weight.astype(dtype),
        mkr_bnd_index=mkr_bnd_index,
        cam_params=cam_params.astype(dtype),
        bnd_params=bnd_params.astype(dtype),
        mkr_cam_index=mkr_cam_index,
        focal_length_mm=float(intrinsics[0, 0]),
        film_fit=int(film_fits[0]),
        rotate_order=int(rot_orders[0]),
        render_width=float(render_w),
        render_height=float(render_h),
        image_width=float(options.image_width),
        solve_focal=solve_focal,
        lens_model_type=lens_model_type,
        lens_params=lens_values,
        lens_solve_names=lens_solve_names,
        lens_pixel_aspect=lens_pixel_aspect,
        loss_type=int(options.robust_loss_type),
        loss_scale=float(options.robust_loss_scale),
        intrinsics=intrinsics.astype(dtype),
    )
    bridge = BABridge(
        problem=problem,
        frame_indices=frame_indices,
        pose_codes=pose_code_table.astype(np.int64),
        bnd_codes=bnd_code_table.astype(np.int64),
        focal_codes=(
            [int(c) for c in focal_codes] if solve_focal else None
        ),
        lens_codes=lens_codes_border,
    )
    return bridge, ""
