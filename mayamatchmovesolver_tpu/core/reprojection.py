"""3D -> 2D screen-space reprojection.

Replicates lib/rust/mmscenegraph/src/math/reprojection.rs:28-63: a world
point is taken through inv(camera_world) then the projection matrix, the
homogeneous result is divided by w, and NDC is halved into the
[-0.5, 0.5] "marker" coordinate space used throughout the solver
(ref also: src/mmSolver/adjust/adjust_measureErrors.cpp:242-246).
"""

import jax.numpy as jnp


def camera_inverse(camera_world_matrix):
    """Inverse of a camera world matrix, batched.

    The reference uses a general 4x4 inverse
    (ref: lib/rust/mmscenegraph/src/math/reprojection.rs:34-38); TRS
    world matrices are affine so the closed-form affine inverse is exact
    and needs no LU decomposition.
    """
    from mayamatchmovesolver_tpu.core.transform import affine_inverse

    return affine_inverse(camera_world_matrix)


def reproject_homogeneous(projection_matrix, camera_world_inv, point_world):
    """Project world points; returns homogeneous (..., 4) clip coords.

    point_world: (..., 3) world-space positions.
    """
    p = jnp.concatenate(
        [point_world, jnp.ones_like(point_world[..., :1])], axis=-1
    )
    cam_space = jnp.einsum("...ij,...j->...i", camera_world_inv, p)
    return jnp.einsum("...ij,...j->...i", projection_matrix, cam_space)


def reproject(projection_matrix, camera_world_inv, point_world):
    """NDC coordinates (x, y, z_ndc) after perspective division."""
    clip = reproject_homogeneous(projection_matrix, camera_world_inv, point_world)
    return clip[..., :3] / clip[..., 3:4]


def reproject_as_normalized_coord(
    projection_matrix, camera_world_inv, point_world
):
    """Screen xy in the [-0.5, 0.5] marker coordinate space.

    (ref: lib/rust/mmscenegraph/src/math/reprojection.rs:55-63 — NDC * 0.5.)
    """
    ndc = reproject(projection_matrix, camera_world_inv, point_world)
    return ndc[..., :2] * 0.5
