"""Two-view geometry: essential matrix, RANSAC, pose, triangulation,
homography.

Counterpart of the reference's SfM layer
(ref: src/mmSolver/sfm/camera_relative_pose.cpp:94-157
`robust_relative_pose` via openMVG ACRANSAC 8-point essential;
sfm/homography.cpp; vendored external/openMVG solvers).  Design
differences, deliberately:

  * RANSAC is hypothesis-parallel — all minimal samples are drawn up
    front and every model is estimated and scored with one vmap, so the
    whole robust estimation is a single XLA program (the reference
    iterates hypotheses serially on CPU);
  * null spaces come from the package's Jacobi eigensolver
    (solver/linalg.py), which batches under vmap in any dtype.

Points are in normalized camera coordinates (undistorted, focal-divided
bearing directions with z=1 implied), matching what the reference feeds
openMVG after marker-to-bearing conversion.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mayamatchmovesolver_tpu.core.transform import inverse3
from mayamatchmovesolver_tpu.solver import linalg


class RelativePose(NamedTuple):
    rotation: jax.Array  # (3, 3) camera2-from-camera1
    translation: jax.Array  # (3,) unit norm
    essential: jax.Array  # (3, 3)
    inliers: jax.Array  # (N,) bool
    num_inliers: jax.Array


def _normalize_points(pts):
    """Hartley normalization: zero-mean, mean distance sqrt(2)."""
    mean = jnp.mean(pts, axis=-2, keepdims=True)
    centered = pts - mean
    scale = jnp.sqrt(2.0) / jnp.maximum(
        jnp.mean(jnp.linalg.norm(centered, axis=-1), axis=-1), 1e-12
    )
    t = jnp.zeros(pts.shape[:-2] + (3, 3), pts.dtype)
    t = t.at[..., 0, 0].set(scale)
    t = t.at[..., 1, 1].set(scale)
    t = t.at[..., 2, 2].set(1.0)
    t = t.at[..., 0, 2].set(-scale * mean[..., 0, 0])
    t = t.at[..., 1, 2].set(-scale * mean[..., 0, 1])
    return centered * scale[..., None, None], t


def eight_point_essential(pts1, pts2):
    """Essential matrix from >=8 correspondences (normalized coords).

    Linear 8-point with Hartley normalization, then projection onto the
    essential manifold (two equal singular values, third zero) — the
    same pipeline openMVG's solver uses
    (ref: external/openMVG essential-matrix solvers).
    pts1, pts2: (..., N, 2).
    """
    n1, t1 = _normalize_points(pts1)
    n2, t2 = _normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    ones = jnp.ones_like(x1)
    # Constraint rows: p2^T E p1 = 0.
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
        axis=-1,
    )  # (..., N, 9)
    ata = jnp.swapaxes(a, -1, -2) @ a
    e_vec = linalg.smallest_eigenvector(ata)
    e = e_vec.reshape(e_vec.shape[:-1] + (3, 3))
    # Denormalize: E = T2^T E_n T1.
    e = jnp.swapaxes(t2, -1, -2) @ e @ t1
    return project_to_essential(e)


def project_to_essential(e):
    """Project onto the essential manifold: singular values (s, s, 0)."""
    # Eigendecompose E^T E = V diag(s^2) V^T.
    w, v = linalg.jacobi_eigh(jnp.swapaxes(e, -1, -2) @ e)
    s = jnp.sqrt(jnp.maximum(w, 0.0))  # ascending
    # U columns = E v / s (guard the null direction).
    u = e @ v / jnp.maximum(s[..., None, :], 1e-12)
    s_avg = 0.5 * (s[..., 1] + s[..., 2])
    target = jnp.stack(
        [jnp.zeros_like(s_avg), s_avg, s_avg], axis=-1
    )
    return u @ (target[..., :, None] * jnp.swapaxes(v, -1, -2))


def sampson_error(e, pts1, pts2):
    """First-order geometric (Sampson) distance, per correspondence."""
    ones = jnp.ones_like(pts1[..., :1])
    p1 = jnp.concatenate([pts1, ones], axis=-1)
    p2 = jnp.concatenate([pts2, ones], axis=-1)
    ep1 = jnp.einsum("...ij,...nj->...ni", e, p1)
    etp2 = jnp.einsum("...ji,...nj->...ni", e, p2)
    num = jnp.einsum("...ni,...ni->...n", p2, ep1) ** 2
    den = (
        ep1[..., 0] ** 2
        + ep1[..., 1] ** 2
        + etp2[..., 0] ** 2
        + etp2[..., 1] ** 2
    )
    return num / jnp.maximum(den, 1e-30)


def _skew(v):
    zero = jnp.zeros_like(v[..., 0])
    return jnp.stack(
        [
            jnp.stack([zero, -v[..., 2], v[..., 1]], axis=-1),
            jnp.stack([v[..., 2], zero, -v[..., 0]], axis=-1),
            jnp.stack([-v[..., 1], v[..., 0], zero], axis=-1),
        ],
        axis=-2,
    )


def triangulate_linear(r1, t1, r2, t2, pts1, pts2):
    """DLT triangulation for projections P_i = [R_i | t_i].

    pts: (..., N, 2) normalized camera coords.  Returns (..., N, 3)
    world points.  (ref capability: openMVG triangulation used by
    mmSolverCmd triangulation paths and triangulatebundle.py.)
    """

    def row_pair(r, t, pts):
        # For P = [R|t] and x = (u, v): rows u*P3-P1, v*P3-P2.
        p1 = jnp.concatenate([r[..., 0, :], t[..., 0:1]], axis=-1)
        p2 = jnp.concatenate([r[..., 1, :], t[..., 1:2]], axis=-1)
        p3 = jnp.concatenate([r[..., 2, :], t[..., 2:3]], axis=-1)
        u = pts[..., 0:1]
        v = pts[..., 1:2]
        ra = u * p3[..., None, :] - p1[..., None, :]
        rb = v * p3[..., None, :] - p2[..., None, :]
        return ra, rb

    ra1, rb1 = row_pair(r1, t1, pts1)
    ra2, rb2 = row_pair(r2, t2, pts2)
    a = jnp.stack([ra1, rb1, ra2, rb2], axis=-2)  # (..., N, 4, 4)
    ata = jnp.swapaxes(a, -1, -2) @ a
    x = linalg.smallest_eigenvector(ata)  # (..., N, 4)
    return x[..., :3] / jnp.where(
        jnp.abs(x[..., 3:]) < 1e-12, 1e-12, x[..., 3:]
    )


def decompose_essential(e, pts1, pts2, inlier_mask=None):
    """The four (R, t) factorizations of E; pick the one with the most
    points in front of both cameras (cheirality), like openMVG's
    RelativePoseFromEssential."""
    w_m, v = linalg.jacobi_eigh(jnp.swapaxes(e, -1, -2) @ e)
    # Reorder to descending singular values (Jacobi gives ascending).
    v = v[..., ::-1]
    u = e @ v
    # The third column of U corresponds to E's (near-)zero singular
    # value, so dividing by it amplifies noise; rebuild U with
    # Gram-Schmidt on the two well-conditioned columns plus a cross
    # product — guaranteed proper rotation.
    u0 = u[..., :, 0]
    u0 = u0 / jnp.linalg.norm(u0, axis=-1, keepdims=True)
    u1 = u[..., :, 1]
    u1 = u1 - jnp.sum(u1 * u0, axis=-1, keepdims=True) * u0
    u1 = u1 / jnp.linalg.norm(u1, axis=-1, keepdims=True)
    u2 = jnp.cross(u0, u1)
    u = jnp.stack([u0, u1, u2], axis=-1)
    v = v.at[..., :, 2].set(v[..., :, 2] * jnp.sign(linalg.det3(v))[..., None])

    w = jnp.asarray(
        [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], e.dtype
    )
    vt = jnp.swapaxes(v, -1, -2)
    r_a = u @ w @ vt
    r_b = u @ jnp.swapaxes(w, -1, -2) @ vt
    t_u = u[..., :, 2]

    candidates = [
        (r_a, t_u),
        (r_a, -t_u),
        (r_b, t_u),
        (r_b, -t_u),
    ]
    if inlier_mask is None:
        inlier_mask = jnp.ones(pts1.shape[:-1], bool)

    def count_front(rt):
        r, t = rt
        eye = jnp.broadcast_to(jnp.eye(3, dtype=e.dtype), r.shape)
        zero = jnp.zeros_like(t)
        x = triangulate_linear(eye, zero, r, t, pts1, pts2)
        z1 = x[..., 2]
        x2 = jnp.einsum("...ij,...nj->...ni", r, x) + t[..., None, :]
        z2 = x2[..., 2]
        ok = (z1 > 0) & (z2 > 0) & inlier_mask
        return jnp.sum(ok, axis=-1)

    counts = jnp.stack([count_front(c) for c in candidates], axis=-1)
    best = jnp.argmax(counts, axis=-1)
    rs = jnp.stack([c[0] for c in candidates], axis=-3)
    ts = jnp.stack([c[1] for c in candidates], axis=-2)
    r_best = jnp.take_along_axis(
        rs, best[..., None, None, None], axis=-3
    ).squeeze(-3)
    t_best = jnp.take_along_axis(
        ts, best[..., None, None], axis=-2
    ).squeeze(-2)
    return r_best, t_best


def robust_relative_pose(
    pts1,
    pts2,
    key=None,
    num_hypotheses=256,
    sample_size=8,
    inlier_threshold=1e-4,
) -> RelativePose:
    """RANSAC 8-point essential + cheirality pose selection.

    (ref: robust_relative_pose, sfm/camera_relative_pose.cpp:94-157.)
    All hypotheses evaluated in one vmap; threshold is squared Sampson
    distance in normalized coords.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n = pts1.shape[-2]
    idx = jax.vmap(
        lambda k: jax.random.choice(
            k, n, shape=(sample_size,), replace=False
        )
    )(jax.random.split(key, num_hypotheses))

    def estimate(sample_idx):
        return eight_point_essential(pts1[sample_idx], pts2[sample_idx])

    es = jax.vmap(estimate)(idx)  # (H, 3, 3)
    errors = jax.vmap(lambda e: sampson_error(e, pts1, pts2))(es)
    inliers = errors < inlier_threshold  # (H, N)
    scores = jnp.sum(inliers, axis=-1)
    best = jnp.argmax(scores)
    e_best = es[best]
    inl = inliers[best]

    # Refit on all inliers of the best model (weighted LSQ refit).
    weights = inl.astype(pts1.dtype)
    e_refit = _weighted_essential(pts1, pts2, weights)
    err_refit = sampson_error(e_refit, pts1, pts2)
    inl_refit = err_refit < inlier_threshold
    use_refit = jnp.sum(inl_refit) >= jnp.sum(inl)
    e_final = jnp.where(use_refit, e_refit, e_best)
    inl_final = jnp.where(use_refit, inl_refit, inl)

    r, t = decompose_essential(e_final, pts1, pts2, inl_final)
    return RelativePose(
        rotation=r,
        translation=t,
        essential=e_final,
        inliers=inl_final,
        num_inliers=jnp.sum(inl_final),
    )


def _weighted_essential(pts1, pts2, weights):
    n1, t1 = _normalize_points(pts1)
    n2, t2 = _normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    ones = jnp.ones_like(x1)
    a = jnp.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones],
        axis=-1,
    )
    aw = a * weights[..., None]
    ata = jnp.swapaxes(aw, -1, -2) @ a
    e_vec = linalg.smallest_eigenvector(ata)
    e = e_vec.reshape(e_vec.shape[:-1] + (3, 3))
    e = jnp.swapaxes(t2, -1, -2) @ e @ t1
    return project_to_essential(e)


def estimate_homography(pts1, pts2, weights=None):
    """Linear DLT homography (ref: sfm/homography.cpp capability)."""
    n1, t1 = _normalize_points(pts1)
    n2, t2 = _normalize_points(pts2)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    zero = jnp.zeros_like(x1)
    one = jnp.ones_like(x1)
    row1 = jnp.stack(
        [-x1, -y1, -one, zero, zero, zero, x2 * x1, x2 * y1, x2], axis=-1
    )
    row2 = jnp.stack(
        [zero, zero, zero, -x1, -y1, -one, y2 * x1, y2 * y1, y2], axis=-1
    )
    a = jnp.concatenate([row1, row2], axis=-2)
    if weights is not None:
        w2 = jnp.concatenate([weights, weights], axis=-1)
        a_w = a * w2[..., None]
    else:
        a_w = a
    ata = jnp.swapaxes(a_w, -1, -2) @ a
    h_vec = linalg.smallest_eigenvector(ata)
    h = h_vec.reshape(h_vec.shape[:-1] + (3, 3))
    h = inverse3(t2) @ h @ t1
    return h / h[..., 2:3, 2:3]


def homography_transfer_error(h, pts1, pts2):
    ones = jnp.ones_like(pts1[..., :1])
    p1 = jnp.concatenate([pts1, ones], axis=-1)
    hp = jnp.einsum("...ij,...nj->...ni", h, p1)
    proj = hp[..., :2] / jnp.where(
        jnp.abs(hp[..., 2:]) < 1e-12, 1e-12, hp[..., 2:]
    )
    return jnp.sum((proj - pts2) ** 2, axis=-1)


class ResectionPose(NamedTuple):
    rotation: jax.Array  # (3, 3) world-to-camera
    translation: jax.Array  # (3,)
    inliers: jax.Array  # (N,) bool
    num_inliers: jax.Array


def reprojection_error_sq(r, t, points3d, points2d):
    """Squared reprojection error in normalized camera coords; points
    behind the camera score +inf (never inliers)."""
    pc = jnp.einsum("...ij,...nj->...ni", r, points3d) + t[..., None, :]
    z = pc[..., 2]
    proj = pc[..., :2] / jnp.where(jnp.abs(z[..., None]) < 1e-12,
                                   1e-12, z[..., None])
    err = jnp.sum((proj - points2d) ** 2, axis=-1)
    return jnp.where(z > 0, err, jnp.inf)


def robust_resection_pose(
    points3d,
    points2d,
    key=None,
    num_hypotheses=256,
    sample_size=6,
    inlier_threshold=1e-4,
    weights=None,
) -> ResectionPose:
    """RANSAC camera resection: hypothesis-parallel 6-point DLT minimal
    samples, reprojection-error inlier scoring, weighted refit on the
    winning consensus set.

    The reference's pose-from-known-points is ACRANSAC-robust
    (ref: src/mmSolver/sfm/camera_from_known_points.cpp:97-202, the
    ACRANSAC call at :129) — plain DLT (resection_pose) breaks under
    outlier correspondences; this is the robust equivalent, with every
    hypothesis estimated and scored in one vmap (single XLA program).

    weights, if given, mask the valid observations: zero-weight points
    are never sampled and never counted as inliers (fixed shapes for
    jit, like robust_relative_pose).
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    n = points3d.shape[-2]
    if weights is None:
        weights = jnp.ones(n, points3d.dtype)
    valid = weights > 0
    probs = weights / jnp.maximum(jnp.sum(weights), 1e-12)
    idx = jax.vmap(
        lambda k: jax.random.choice(
            k, n, shape=(sample_size,), replace=False, p=probs
        )
    )(jax.random.split(key, num_hypotheses))

    def estimate(sample_idx):
        return resection_pose(
            points3d[sample_idx], points2d[sample_idx]
        )

    rs, ts = jax.vmap(estimate)(idx)  # (H, 3, 3), (H, 3)
    errors = jax.vmap(
        lambda r, t: reprojection_error_sq(r, t, points3d, points2d)
    )(rs, ts)  # (H, N)
    inliers = (errors < inlier_threshold) & valid
    scores = jnp.sum(inliers, axis=-1)
    best = jnp.argmax(scores)
    r_best, t_best, inl = rs[best], ts[best], inliers[best]

    # Weighted-DLT refit on the winning consensus set.
    w_refit = inl.astype(points3d.dtype) * weights
    r_refit, t_refit = resection_pose(points3d, points2d,
                                      weights=w_refit)
    err_refit = reprojection_error_sq(r_refit, t_refit, points3d,
                                      points2d)
    inl_refit = (err_refit < inlier_threshold) & valid
    use_refit = jnp.sum(inl_refit) >= jnp.sum(inl)
    r_final = jnp.where(use_refit, r_refit, r_best)
    t_final = jnp.where(use_refit, t_refit, t_best)
    inl_final = jnp.where(use_refit, inl_refit, inl)
    return ResectionPose(
        rotation=r_final,
        translation=t_final,
        inliers=inl_final,
        num_inliers=jnp.sum(inl_final),
    )


def resection_pose(points3d, points2d, weights=None):
    """Camera pose from known 3D points (DLT + nearest-rotation),
    normalized 2D coords.  (ref: camera_from_known_points resection,
    sfm/camera_from_known_points.cpp.)

    weights, if given, mask/weight observations — pass the full padded
    point set with zero weights for missing data so the shapes (and the
    compiled program) stay fixed.
    """
    x, y, z = points3d[..., 0], points3d[..., 1], points3d[..., 2]
    u, v = points2d[..., 0], points2d[..., 1]
    zero = jnp.zeros_like(x)
    one = jnp.ones_like(x)
    row1 = jnp.stack(
        [x, y, z, one, zero, zero, zero, zero,
         -u * x, -u * y, -u * z, -u],
        axis=-1,
    )
    row2 = jnp.stack(
        [zero, zero, zero, zero, x, y, z, one,
         -v * x, -v * y, -v * z, -v],
        axis=-1,
    )
    a = jnp.concatenate([row1, row2], axis=-2)  # (..., 2N, 12)
    if weights is not None:
        w2 = jnp.concatenate([weights, weights], axis=-1)[..., None]
        a = a * w2
    ata = jnp.swapaxes(a, -1, -2) @ a
    p_vec = linalg.smallest_eigenvector(ata)
    p = p_vec.reshape(p_vec.shape[:-1] + (3, 4))
    m = p[..., :3]
    # Fix the sign so that points land in front of the camera.
    depths = jnp.einsum("...ij,...nj->...ni", m, points3d)[..., 2] \
        + p[..., 2, 3][..., None]
    depth_votes = jnp.sign(depths)
    if weights is not None:
        depth_votes = depth_votes * (weights > 0)
    sign = jnp.sign(jnp.sum(depth_votes, axis=-1))
    sign = jnp.where(sign == 0, 1.0, sign)
    p = p * sign[..., None, None]
    m = p[..., :3]
    scale = jnp.cbrt(jnp.abs(linalg.det3(m)))
    m_n = m / scale[..., None, None]
    r = linalg.svd3_rotation(m_n)
    t = p[..., 3] / scale[..., None]
    return r, t
