"""TRS transform mathematics, batched and differentiable.

Replicates the semantics of the reference's transform math
(ref: lib/rust/mmscenegraph/src/math/transform.rs:338-453 — Maya-style
matrix = T @ R @ S with Euler rotate orders, angles in degrees) as
vectorized JAX functions.  All functions broadcast over arbitrary leading
batch dimensions so frames/transforms can be vmapped or simply batched.

Convention: column vectors, world_point = world_matrix @ [x, y, z, 1]^T.
A child's world matrix is parent_world @ local
(ref: lib/rust/mmscenegraph/src/math/dag.rs:300-320).
"""

import jax
import jax.numpy as jnp
import numpy as np

from mayamatchmovesolver_tpu.core.constants import (
    DEGREES_TO_RADIANS,
    RADIANS_TO_DEGREES,
    ROTATE_ORDER_PERMS,
)

# Even permutations (cyclic) of (X, Y, Z) get sign +1, odd get -1; used in
# the closed-form Euler extraction below.
_PERM_SIGNS = np.array([1.0, 1.0, 1.0, -1.0, -1.0, -1.0])


def _axis_rotation_matrices(rx_rad, ry_rad, rz_rad):
    """Stacked (..., 3, 3, 3) rotation matrices about X, Y and Z."""
    rx_rad, ry_rad, rz_rad = jnp.broadcast_arrays(
        jnp.asarray(rx_rad), jnp.asarray(ry_rad), jnp.asarray(rz_rad)
    )
    shape = rx_rad.shape
    zero = jnp.zeros(shape, dtype=jnp.result_type(rx_rad, ry_rad, rz_rad))
    one = zero + 1.0
    sx, cx = jnp.sin(rx_rad), jnp.cos(rx_rad)
    sy, cy = jnp.sin(ry_rad), jnp.cos(ry_rad)
    sz, cz = jnp.sin(rz_rad), jnp.cos(rz_rad)
    mx = jnp.stack(
        [one, zero, zero, zero, cx, -sx, zero, sx, cx], axis=-1
    ).reshape(shape + (3, 3))
    my = jnp.stack(
        [cy, zero, sy, zero, one, zero, -sy, zero, cy], axis=-1
    ).reshape(shape + (3, 3))
    mz = jnp.stack(
        [cz, -sz, zero, sz, cz, zero, zero, zero, one], axis=-1
    ).reshape(shape + (3, 3))
    return jnp.stack([mx, my, mz], axis=-3)


def euler_to_rotation_matrix(rx_deg, ry_deg, rz_deg, rotate_order):
    """3x3 rotation from Euler angles in degrees with per-element rotate order.

    rotate_order is an integer (array) in [0, 6) following RotateOrder.
    For apply-order (first, second, third), the combined matrix acting on
    column vectors is M[third] @ M[second] @ M[first]
    (ref: lib/rust/mmscenegraph/src/math/transform.rs:433-440).
    """
    mats = _axis_rotation_matrices(
        rx_deg * DEGREES_TO_RADIANS,
        ry_deg * DEGREES_TO_RADIANS,
        rz_deg * DEGREES_TO_RADIANS,
    )
    perms = jnp.asarray(ROTATE_ORDER_PERMS)[rotate_order]  # (..., 3)
    # A scalar rotate order with batched angles must broadcast up to the
    # angle batch shape for take_along_axis.
    perms = jnp.broadcast_to(perms, mats.shape[:-3] + (3,))
    first = jnp.take_along_axis(
        mats, perms[..., 0:1, None, None], axis=-3
    ).squeeze(-3)
    second = jnp.take_along_axis(
        mats, perms[..., 1:2, None, None], axis=-3
    ).squeeze(-3)
    third = jnp.take_along_axis(
        mats, perms[..., 2:3, None, None], axis=-3
    ).squeeze(-3)
    # Full-precision products: a float32 matmul at default precision
    # may run in TF32 on the GPU, which poisons the rotation chain.
    compose = lambda a, b: jnp.einsum(  # noqa: E731
        "...ij,...jk->...ik", a, b, precision=jax.lax.Precision.HIGHEST
    )
    return compose(third, compose(second, first))


def trs_matrix(tx, ty, tz, rx, ry, rz, sx, sy, sz, rotate_order):
    """4x4 Maya-style transform matrix: T @ R @ S.

    Angles are degrees (ref: lib/rust/mmscenegraph/src/math/transform.rs:560,
    where attribute values are converted with DEGREES_TO_RADIANS).
    Broadcasts over leading dims; returns (..., 4, 4).
    """
    r3 = euler_to_rotation_matrix(rx, ry, rz, rotate_order)
    dtype = r3.dtype
    shape = r3.shape[:-2]
    tx, ty, tz, sx, sy, sz = jnp.broadcast_arrays(
        jnp.asarray(tx, dtype),
        jnp.asarray(ty, dtype),
        jnp.asarray(tz, dtype),
        jnp.asarray(sx, dtype),
        jnp.asarray(sy, dtype),
        jnp.asarray(sz, dtype),
    )
    # Fuse T @ R @ S without building three explicit 4x4s: the upper 3x3 is
    # R * diag(s) (columns scaled) and the last column is the translation.
    rs = r3 * jnp.stack([sx, sy, sz], axis=-1)[..., None, :]
    zero = jnp.zeros(shape, dtype)
    one = zero + 1.0
    t_col = jnp.stack([tx, ty, tz], axis=-1)[..., None]
    top = jnp.concatenate([rs, t_col], axis=-1)  # (..., 3, 4)
    bottom = jnp.stack([zero, zero, zero, one], axis=-1)[..., None, :]
    return jnp.concatenate([top, bottom], axis=-2)


def matrix_to_euler(rotation3, rotate_order):
    """Extract Euler angles (degrees) from a (...,3,3) rotation matrix.

    Inverse of euler_to_rotation_matrix for any of the six Tait-Bryan
    orders.  Uses the closed-form: for apply order (i, j, k) with parity
    sign e, theta_j = asin(-e*R[k,i]), theta_i = atan2(e*R[k,j], R[k,k]),
    theta_k = atan2(e*R[j,i], R[i,i]).
    (ref behavior: lib/rust/mmscenegraph/src/math/transform.rs:644-688,
    which goes through quaternions; the result is identical away from
    gimbal lock.)
    """
    rotate_order = jnp.broadcast_to(
        jnp.asarray(rotate_order), rotation3.shape[:-2]
    )
    perms = jnp.asarray(ROTATE_ORDER_PERMS)[rotate_order]  # (..., 3)
    sign = jnp.asarray(_PERM_SIGNS, rotation3.dtype)[rotate_order]
    i, j, k = perms[..., 0], perms[..., 1], perms[..., 2]

    def _at(row, col):
        rows = jnp.take_along_axis(
            rotation3, row[..., None, None].astype(jnp.int32), axis=-2
        ).squeeze(-2)
        return jnp.take_along_axis(
            rows, col[..., None].astype(jnp.int32), axis=-1
        ).squeeze(-1)

    tj = jnp.arcsin(jnp.clip(-sign * _at(k, i), -1.0, 1.0))
    ti = jnp.arctan2(sign * _at(k, j), _at(k, k))
    tk = jnp.arctan2(sign * _at(j, i), _at(i, i))

    angles_by_axis = jnp.zeros(rotation3.shape[:-2] + (3,), rotation3.dtype)
    angles_by_axis = _scatter_axis(angles_by_axis, i, j, k, ti, tj, tk)
    return angles_by_axis * RADIANS_TO_DEGREES


def _scatter_axis(out, i, j, k, ti, tj, tk):
    axis_ids = jnp.arange(3)
    shape = out.shape
    i = jnp.broadcast_to(i[..., None], shape)
    j = jnp.broadcast_to(j[..., None], shape)
    k = jnp.broadcast_to(k[..., None], shape)
    ti = jnp.broadcast_to(ti[..., None], shape)
    tj = jnp.broadcast_to(tj[..., None], shape)
    tk = jnp.broadcast_to(tk[..., None], shape)
    out = jnp.where(axis_ids == i, ti, out)
    out = jnp.where(axis_ids == j, tj, out)
    out = jnp.where(axis_ids == k, tk, out)
    return out


def inverse3(m):
    """Closed-form (adjugate) inverse of (..., 3, 3) matrices.

    Used instead of jnp.linalg.inv: for 3x3 the adjugate needs no LU
    decomposition, is cheaper and is exactly differentiable.
    """
    a, b, c = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    d, e, f = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    g, h, i = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    co_a = e * i - f * h
    co_b = -(d * i - f * g)
    co_c = d * h - e * g
    det = a * co_a + b * co_b + c * co_c
    adj = jnp.stack(
        [
            co_a, -(b * i - c * h), (b * f - c * e),
            co_b, (a * i - c * g), -(a * f - c * d),
            co_c, -(a * h - b * g), (a * e - b * d),
        ],
        axis=-1,
    ).reshape(m.shape)
    return adj / det[..., None, None]


def affine_inverse(matrix4):
    """Inverse of (..., 4, 4) affine matrices (bottom row 0,0,0,1).

    World matrices from TRS hierarchies are always affine, so this
    replaces the reference's general 4x4 inverse
    (ref: lib/rust/mmscenegraph/src/math/reprojection.rs:34-38) exactly.
    """
    r = matrix4[..., :3, :3]
    t = matrix4[..., :3, 3]
    r_inv = inverse3(r)
    t_inv = -jnp.einsum("...ij,...j->...i", r_inv, t)
    top = jnp.concatenate([r_inv, t_inv[..., None]], axis=-1)
    bottom = jnp.zeros_like(matrix4[..., 3:4, :]).at[..., 0, 3].set(1.0)
    return jnp.concatenate([top, bottom], axis=-2)


def decompose_matrix(matrix4, rotate_order):
    """Split a (...,4,4) TRS matrix into (t, r_deg, s) arrays of shape (...,3).

    Matches the reference's decompose: scale from column norms, rotation
    from the scale-normalized 3x3 (ref:
    lib/rust/mmscenegraph/src/math/transform.rs:644-688).
    """
    t = matrix4[..., :3, 3]
    s = jnp.linalg.norm(matrix4[..., :3, :3], axis=-2)
    r3 = matrix4[..., :3, :3] / s[..., None, :]
    r_deg = matrix_to_euler(r3, rotate_order)
    return t, r_deg, s
