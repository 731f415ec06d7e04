"""SfM two-view tests with synthetic ground truth."""

import jax
import jax.numpy as jnp
import numpy as np

from mayamatchmovesolver_tpu.sfm import twoview
from mayamatchmovesolver_tpu.solver import linalg


def _synthetic_pair(n=40, seed=1, noise=0.0, outliers=0):
    rng = np.random.RandomState(seed)
    pts3d = np.stack(
        [
            rng.uniform(-2, 2, n),
            rng.uniform(-1.5, 1.5, n),
            rng.uniform(4, 10, n),
        ],
        axis=-1,
    )
    # Camera 1 at identity; camera 2 rotated+translated.
    angle = np.radians(8.0)
    r = np.array(
        [
            [np.cos(angle), 0, np.sin(angle)],
            [0, 1, 0],
            [-np.sin(angle), 0, np.cos(angle)],
        ]
    )
    t = np.array([1.0, 0.15, 0.1])
    t = t / np.linalg.norm(t)

    p1 = pts3d[:, :2] / pts3d[:, 2:]
    pc2 = pts3d @ r.T + t
    p2 = pc2[:, :2] / pc2[:, 2:]
    if noise:
        p1 = p1 + rng.normal(0, noise, p1.shape)
        p2 = p2 + rng.normal(0, noise, p2.shape)
    if outliers:
        idx = rng.choice(n, outliers, replace=False)
        p2[idx] += rng.uniform(0.1, 0.3, (outliers, 2))
    return (
        jnp.asarray(p1), jnp.asarray(p2), r, t, pts3d
    )


def test_jacobi_eigh_matches_numpy():
    rng = np.random.RandomState(0)
    m = rng.randn(9, 9)
    a = m @ m.T
    w, v = linalg.jacobi_eigh(jnp.asarray(a))
    w_np, v_np = np.linalg.eigh(a)
    # Transcendentals bound the Jacobi sweeps' accuracy; tolerance
    # leaves room for backends with ~1e-7 relative sin/cos.
    np.testing.assert_allclose(np.asarray(w), w_np, atol=1e-5, rtol=1e-5)
    # Eigenvectors up to sign.
    for i in range(9):
        vi = np.asarray(v[:, i])
        ref = v_np[:, i]
        assert min(
            np.linalg.norm(vi - ref), np.linalg.norm(vi + ref)
        ) < 2e-5


def test_eight_point_essential_exact():
    p1, p2, r, t, _ = _synthetic_pair()
    e = twoview.eight_point_essential(p1, p2)
    err = twoview.sampson_error(e, p1, p2)
    assert float(jnp.max(err)) < 1e-12

    # E should match [t]x R up to scale.
    tx = np.array(
        [[0, -t[2], t[1]], [t[2], 0, -t[0]], [-t[1], t[0], 0]]
    )
    e_true = tx @ r
    e_np = np.asarray(e)
    e_np = e_np / np.linalg.norm(e_np)
    e_true = e_true / np.linalg.norm(e_true)
    assert min(
        np.abs(e_np - e_true).max(), np.abs(e_np + e_true).max()
    ) < 1e-6


def test_robust_relative_pose_recovers_rotation_with_outliers():
    p1, p2, r, t, _ = _synthetic_pair(n=60, noise=1e-5, outliers=10)
    pose = twoview.robust_relative_pose(
        p1, p2, key=jax.random.PRNGKey(3), num_hypotheses=128,
        inlier_threshold=1e-6,
    )
    assert int(pose.num_inliers) >= 45
    r_got = np.asarray(pose.rotation)
    np.testing.assert_allclose(r_got, r, atol=2e-3)
    t_got = np.asarray(pose.translation)
    t_got = t_got * np.sign(np.dot(t_got, t))
    np.testing.assert_allclose(t_got, t, atol=2e-3)


def test_triangulation_recovers_points():
    p1, p2, r, t, pts3d = _synthetic_pair(n=25)
    eye = jnp.eye(3)
    zero = jnp.zeros(3)
    x = twoview.triangulate_linear(
        eye, zero, jnp.asarray(r), jnp.asarray(t), p1, p2
    )
    np.testing.assert_allclose(np.asarray(x), pts3d, atol=1e-6)


def test_homography_plane():
    rng = np.random.RandomState(5)
    h_true = np.array(
        [[1.1, 0.05, 0.02], [-0.03, 0.95, -0.01], [0.04, -0.02, 1.0]]
    )
    p1 = rng.uniform(-0.5, 0.5, (30, 2))
    p1h = np.concatenate([p1, np.ones((30, 1))], axis=-1)
    p2h = p1h @ h_true.T
    p2 = p2h[:, :2] / p2h[:, 2:]
    h = twoview.estimate_homography(jnp.asarray(p1), jnp.asarray(p2))
    err = twoview.homography_transfer_error(h, jnp.asarray(p1),
                                            jnp.asarray(p2))
    assert float(jnp.max(err)) < 1e-12


def test_resection_pose():
    p1, p2, r, t, pts3d = _synthetic_pair(n=30)
    r_got, t_got = twoview.resection_pose(jnp.asarray(pts3d), p2)
    np.testing.assert_allclose(np.asarray(r_got), r, atol=1e-6)
    np.testing.assert_allclose(np.asarray(t_got), t, atol=1e-6)


def test_robust_resection_survives_outliers():
    """30% outlier correspondences: plain DLT drifts, RANSAC resection
    recovers the pose (ref: the ACRANSAC-robust pose-from-known-points,
    src/mmSolver/sfm/camera_from_known_points.cpp:97-202)."""
    rng = np.random.RandomState(11)
    p1, p2, r, t, pts3d = _synthetic_pair(n=40)
    p2 = np.asarray(p2)
    # Corrupt 30% of the 2D observations grossly.
    bad = rng.choice(40, size=12, replace=False)
    p2_bad = p2.copy()
    p2_bad[bad] += rng.uniform(0.2, 0.6, (12, 2)) * np.sign(
        rng.randn(12, 2)
    )

    # Plain DLT is poisoned by the outliers...
    r_dlt, t_dlt = twoview.resection_pose(
        jnp.asarray(pts3d), jnp.asarray(p2_bad)
    )
    dlt_err = float(np.abs(np.asarray(r_dlt) - r).max())
    assert dlt_err > 1e-3, dlt_err  # visibly wrong

    # ...RANSAC rejects them and recovers the exact pose.
    pose = twoview.robust_resection_pose(
        jnp.asarray(pts3d), jnp.asarray(p2_bad),
        key=jax.random.PRNGKey(3), num_hypotheses=96,
        inlier_threshold=1e-6,
    )
    np.testing.assert_allclose(np.asarray(pose.rotation), r, atol=1e-5)
    np.testing.assert_allclose(
        np.asarray(pose.translation), t, atol=1e-5
    )
    assert int(pose.num_inliers) == 40 - 12
    # The inlier mask identifies exactly the corrupted rows.
    inl = np.asarray(pose.inliers)
    assert not inl[bad].any()
    assert inl[np.setdiff1d(np.arange(40), bad)].all()


def test_robust_resection_with_padded_weights():
    """Zero-weight padding rows are never sampled nor counted."""
    p1, p2, r, t, pts3d = _synthetic_pair(n=30)
    pts3d_pad = np.concatenate(
        [pts3d, np.zeros((10, 3))], axis=0
    )
    p2_pad = np.concatenate([np.asarray(p2), np.zeros((10, 2))], axis=0)
    w = np.concatenate([np.ones(30), np.zeros(10)])
    pose = twoview.robust_resection_pose(
        jnp.asarray(pts3d_pad), jnp.asarray(p2_pad),
        key=jax.random.PRNGKey(0), num_hypotheses=64,
        weights=jnp.asarray(w),
    )
    np.testing.assert_allclose(np.asarray(pose.rotation), r, atol=1e-5)
    assert int(pose.num_inliers) == 30
    assert not np.asarray(pose.inliers)[30:].any()
