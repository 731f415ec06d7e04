"""World <-> screen-space conversion over frames.

Capabilities of the reference's screen-space tools
(ref: python/mmSolver/tools/screenspacetransform/lib.py:32
create_screen_space_locator, tools/screenspacerigbake — bake a
transform into (screenX, screenY, depth) channels driven under the
camera, tools/screenspacemotiontrail — per-frame screen positions as a
trail).  There the conversion is a Maya node rig evaluated by the DG;
here it is two closed-form batched functions over the flat scene's
camera matrices, jit/vmap-safe.

Screen space is the solver's marker space: x, y in [-0.5, 0.5] (NDC
halved, ref: math/reprojection.rs:55-63); depth is the positive
distance along the camera's viewing direction (-Z), so
(screen_xy, depth) is a complete, invertible camera-relative
parameterization of a world point.
"""

import jax.numpy as jnp

from mayamatchmovesolver_tpu.core import reprojection
from mayamatchmovesolver_tpu.scene import flatscene


def world_to_screen(ev: flatscene.SceneEval, points_world, cam_index=0):
    """World points -> (screen_xy, depth) per frame.

    ev: SceneEval from scene.evaluate() (carries cam_proj /
    cam_world_inv shaped (C, F, 4, 4)).
    points_world: (..., F, 3) world positions per frame (broadcasts:
    a static (3,) point works too).
    Returns (screen_xy (..., F, 2), depth (..., F)).
    """
    proj = ev.cam_proj[cam_index]  # (F, 4, 4)
    winv = ev.cam_world_inv[cam_index]
    points_world = jnp.asarray(points_world)
    if points_world.ndim == 1:
        points_world = jnp.broadcast_to(
            points_world, proj.shape[:1] + (3,)
        )
    p = jnp.concatenate(
        [points_world, jnp.ones_like(points_world[..., :1])], axis=-1
    )
    cam_space = jnp.einsum("fij,...fj->...fi", winv, p)
    clip = jnp.einsum("fij,...fj->...fi", proj, cam_space)
    w = jnp.where(jnp.abs(clip[..., 3:]) < 1e-12, 1e-12, clip[..., 3:])
    screen_xy = clip[..., :2] / w * 0.5
    depth = -cam_space[..., 2]
    return screen_xy, depth


def screen_to_world(ev: flatscene.SceneEval, screen_xy, depth,
                    cam_index=0):
    """Inverse of world_to_screen: (screen_xy, depth) -> world points.

    Uses the projection matrix's sparse structure
    (core/camera.py projection_matrix: rows
    [m00 0 m02 0; 0 m11 m12 0; 0 0 m22 m23; 0 0 -1 0]) to unproject
    analytically — no 4x4 inverse:
      w_clip = depth,  x_ndc = 2 * sx
      x_cam = (x_ndc * depth - m02 * z_cam) / m00,   z_cam = -depth.
    """
    proj = ev.cam_proj[cam_index]  # (F, 4, 4)
    cam_world = ev.cam_world[cam_index]
    screen_xy = jnp.asarray(screen_xy)
    depth = jnp.asarray(depth)
    m00 = proj[..., 0, 0]
    m02 = proj[..., 0, 2]
    m11 = proj[..., 1, 1]
    m12 = proj[..., 1, 2]
    z_cam = -depth
    x_cam = (2.0 * screen_xy[..., 0] * depth - m02 * z_cam) / m00
    y_cam = (2.0 * screen_xy[..., 1] * depth - m12 * z_cam) / m11
    cam_space = jnp.stack(
        [x_cam, y_cam, z_cam, jnp.ones_like(z_cam)], axis=-1
    )
    world = jnp.einsum("fij,...fj->...fi", cam_world, cam_space)
    return world[..., :3]


def motion_trail(scene, attrs, frame_indices, tfm_index, cam_index=0):
    """Screen-space motion trail of a transform over frames.

    (ref: tools/screenspacemotiontrail — a locator trail of a node's
    screen positions.)  tfm_index: index into the baked transform list.
    Returns (screen_xy (F, 2), depth (F,)).
    """
    ev = flatscene.evaluate_jit(scene, attrs, frame_indices)
    points = ev.tfm_world[tfm_index, :, :3, 3]  # (F, 3)
    return world_to_screen(ev, points, cam_index=cam_index)


def screen_space_rig_bake(scene, attrs, frame_indices, tfm_index,
                          cam_index=0):
    """Bake a transform's world positions into screen-space channels.

    (ref: tools/screenspacerigbake/tool.py — bakes a rig of
    screenX/screenY/screenDepth channels under the camera.)
    Returns dict(screen_x (F,), screen_y (F,), depth (F,)).
    """
    screen_xy, depth = motion_trail(
        scene, attrs, frame_indices, tfm_index, cam_index
    )
    return {
        "screen_x": screen_xy[..., 0],
        "screen_y": screen_xy[..., 1],
        "depth": depth,
    }


def screen_space_rig_unbake(scene, attrs, frame_indices, screen_x,
                            screen_y, depth, cam_index=0):
    """Inverse bake: screen channels -> world positions per frame
    (ref: screenspacerigbake's 'remove rig' restores world motion)."""
    ev = flatscene.evaluate_jit(scene, attrs, frame_indices)
    screen_xy = jnp.stack(
        [jnp.asarray(screen_x), jnp.asarray(screen_y)], axis=-1
    )
    return screen_to_world(ev, screen_xy, depth, cam_index=cam_index)
