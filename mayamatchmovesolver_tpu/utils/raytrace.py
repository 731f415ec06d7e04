"""Ray ↔ triangle-mesh intersection.

Counterpart of the reference's raytrace utility
(ref: python/mmSolver/utils/raytrace.py:51-279 — `closest_intersect`
and `closest_intersect_with_normal` via Maya's MFnMesh
closestIntersection): here the mesh is plain arrays (vertices,
triangles) and intersection is a fully batched Moller-Trumbore test
over every (ray, triangle) pair in one fused XLA computation — the
backing op for the ray-cast-marker capability
(ref: python/mmSolver/tools/raycastmarker).
"""

import functools

import jax
import jax.numpy as jnp

__all__ = [
    "intersect_rays_mesh",
    "closest_intersect",
    "closest_intersect_with_normal",
]


@functools.partial(jax.jit, static_argnames=("test_both_directions",))
def intersect_rays_mesh(
    origins,
    directions,
    vertices,
    triangles,
    max_dist=9999.9,
    tolerance=1e-7,
    test_both_directions=False,
):
    """Batched Moller-Trumbore intersection.

    origins: (R, 3) ray origins; directions: (R, 3) (need not be unit).
    vertices: (V, 3); triangles: (T, 3) int vertex indices.
    max_dist/tolerance mirror the reference's flags
    (ref: utils/raytrace.py:181-234).

    Returns (hit_point (R, 3), hit_normal (R, 3), hit_dist (R,),
    hit_mask (R,) bool).  Distances are in units of |direction|.
    """
    origins = jnp.atleast_2d(jnp.asarray(origins))
    directions = jnp.atleast_2d(jnp.asarray(directions))
    vertices = jnp.asarray(vertices)
    triangles = jnp.asarray(triangles, dtype=jnp.int32)

    v0 = vertices[triangles[:, 0]]  # (T, 3)
    e1 = vertices[triangles[:, 1]] - v0
    e2 = vertices[triangles[:, 2]] - v0

    d = directions[:, None, :]  # (R, 1, 3)
    o = origins[:, None, :]

    pvec = jnp.cross(d, e2[None, :, :])  # (R, T, 3)
    det = jnp.sum(e1[None, :, :] * pvec, axis=-1)  # (R, T)
    inv_det = jnp.where(jnp.abs(det) < tolerance, 0.0, 1.0 / det)

    tvec = o - v0[None, :, :]
    u = jnp.sum(tvec * pvec, axis=-1) * inv_det
    qvec = jnp.cross(tvec, e1[None, :, :])
    v = jnp.sum(d * qvec, axis=-1) * inv_det
    t = jnp.sum(e2[None, :, :] * qvec, axis=-1) * inv_det

    valid = (
        (jnp.abs(det) >= tolerance)
        & (u >= 0.0)
        & (v >= 0.0)
        & (u + v <= 1.0)
    )
    if test_both_directions:
        # Accept hits behind the origin too, ranked by |t|
        # (ref: utils/raytrace.py test_both_directions flag).
        dist = jnp.abs(t)
        valid = valid & (dist <= max_dist) & (dist > tolerance)
    else:
        dist = t
        valid = valid & (t > tolerance) & (t <= max_dist)

    big = jnp.asarray(jnp.inf, dist.dtype)
    ranked = jnp.where(valid, jnp.abs(dist), big)
    best = jnp.argmin(ranked, axis=-1)  # (R,)
    hit_mask = jnp.take_along_axis(valid, best[:, None], axis=-1)[:, 0]

    r_idx = jnp.arange(origins.shape[0])
    t_best = t[r_idx, best]
    hit_point = origins + t_best[:, None] * directions
    n = jnp.cross(e1, e2)  # (T, 3) geometric normal
    n = n / jnp.maximum(
        jnp.linalg.norm(n, axis=-1, keepdims=True), tolerance
    )
    hit_normal = n[best]
    return hit_point, hit_normal, t_best, hit_mask


def closest_intersect(
    point,
    direction,
    vertices,
    triangles,
    test_both_directions=False,
    max_dist=9999.9,
    tolerance=1e-7,
):
    """Single-ray convenience wrapper; returns the hit point or None
    (ref: python/mmSolver/utils/raytrace.py:181)."""
    hit, _, _, ok = intersect_rays_mesh(
        point,
        direction,
        vertices,
        triangles,
        max_dist=max_dist,
        tolerance=tolerance,
        test_both_directions=test_both_directions,
    )
    if not bool(ok[0]):
        return None
    return hit[0]


def closest_intersect_with_normal(
    point,
    direction,
    vertices,
    triangles,
    test_both_directions=False,
    max_dist=9999.9,
    tolerance=1e-7,
):
    """Returns (hit_point, hit_normal) or (None, None)
    (ref: python/mmSolver/utils/raytrace.py:235)."""
    hit, normal, _, ok = intersect_rays_mesh(
        point,
        direction,
        vertices,
        triangles,
        max_dist=max_dist,
        tolerance=tolerance,
        test_both_directions=test_both_directions,
    )
    if not bool(ok[0]):
        return None, None
    return hit[0], normal[0]
