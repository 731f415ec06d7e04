"""Camera solve from scratch: incremental SfM bootstrap + BA refine.

Counterpart of the reference's camera_solve pipeline
(ref: python/mmSolver/_api/solvercamerautils.py:958-1290):
  1. score frames by shared-marker connectivity (_compute_connected_
     frame_scores, solvercamerautils.py:135);
  2. robust relative pose between the best-connected frame pair
     (mmCameraRelativePose command -> our robust_relative_pose);
  3. triangulate bundles (solvercamerautils.py:690);
  4. resection the remaining frames from triangulated points;
  5. full bundle adjustment over all poses + bundles (our solver);
  6. origin-frame normalization (_set_camera_origin_frame,
     solvercamerautils.py:730).

Marker input is (M, F, 2) in the solver's [-0.5, 0.5] screen space plus
an (M, F) enable mask; intrinsics are focal length + film back.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from mayamatchmovesolver_tpu.sfm import twoview


class CameraSolveResult(NamedTuple):
    # Camera pose per frame: world-from-camera rotation + position.
    rotations: np.ndarray  # (F, 3, 3)
    positions: np.ndarray  # (F, 3)
    points3d: np.ndarray  # (M, 3)
    point_valid: np.ndarray  # (M,) bool
    frame_solved: np.ndarray  # (F,) bool


def markers_to_bearings(marker_xy, focal_length_mm, film_back_width_mm,
                        render_aspect):
    """Marker space [-0.5, 0.5] -> normalized CV-convention bearings.

    From the projection matrix derivation (core/camera.py, horizontal
    film fit): x_cam/(-z_cam) = marker_x * film_back_w / focal and
    y_cam/(-z_cam) = marker_y * film_back_w / (render_aspect * focal)
    (the y projection scale carries the image aspect; the film-fit
    marker scaling keeps observations in the same space).  The SfM math
    runs in the right-handed OpenCV frame (x right, y DOWN, z forward),
    hence the sign flip on v.

    Two input conventions are valid and give identical bearings under
    horizontal film fit: film-fit-scaled screen space paired with the
    true render aspect, or raw marker space paired with the film-back
    aspect (fbw/fbh) — because raw marker y is film-back-normalized
    (y_cam/(-z) = marker_y * fbh / focal).  Mixing them distorts the
    y bearings anisotropically.
    """
    u = marker_xy[..., 0] * film_back_width_mm / focal_length_mm
    v = -marker_xy[..., 1] * film_back_width_mm / (
        render_aspect * focal_length_mm
    )
    return jnp.stack([u, v], axis=-1)


def connected_frame_scores(enable_mask):
    """(ref: _compute_connected_frame_scores,
    solvercamerautils.py:135) — per-frame count of enabled markers."""
    return np.asarray(enable_mask).sum(axis=0)


def best_frame_pair(enable_mask, min_separation=5):
    """Pick the pair of frames sharing the most markers with at least
    min_separation frames between them (baseline heuristic like the
    reference's start/end-frame choice).  Vectorized: the full F x F
    co-visibility matrix is one matmul, fine at 1000+ frames."""
    enable = (np.asarray(enable_mask) > 0.5).astype(np.float64)
    num_frames = enable.shape[1]
    shared = enable.T @ enable  # (F, F) co-visible marker counts
    sep = np.abs(np.arange(num_frames)[:, None] - np.arange(num_frames))
    shared = np.where(
        (sep >= min_separation) & (np.arange(num_frames)[:, None]
                                   < np.arange(num_frames)),
        shared, -1.0,
    )
    flat = int(np.argmax(shared))
    a, b = divmod(flat, num_frames)
    if shared[a, b] < 0:
        return (0, min(num_frames - 1, min_separation))
    return (int(a), int(b))


def triangulate_multiview(cam_r, cam_t, bearings, weights):
    """DLT triangulation of every marker from ALL solved frames at once.

    cam_r: (F, 3, 3) camera-from-world rotations, cam_t: (F, 3),
    bearings: (M, F, 2) normalized CV coords, weights: (M, F)
    observation weights (zero = unseen/unsolved).  Returns (M, 3) CV
    world points.  This is the per-bundle refinement the reference runs
    as _triangulate_bundles (ref: solvercamerautils.py:690) — here each
    bundle sees every camera simultaneously instead of a pair.
    """
    from mayamatchmovesolver_tpu.solver import linalg

    p1 = jnp.concatenate([cam_r[:, 0, :], cam_t[:, 0:1]], axis=-1)
    p2 = jnp.concatenate([cam_r[:, 1, :], cam_t[:, 1:2]], axis=-1)
    p3 = jnp.concatenate([cam_r[:, 2, :], cam_t[:, 2:3]], axis=-1)
    u = bearings[..., 0:1]
    v = bearings[..., 1:2]
    ra = u * p3[None] - p1[None]  # (M, F, 4)
    rb = v * p3[None] - p2[None]
    w = weights[..., None]
    rows = jnp.concatenate([ra * w, rb * w], axis=1)  # (M, 2F, 4)
    ata = jnp.einsum("mfi,mfj->mij", rows, rows)
    x = linalg.smallest_eigenvector(ata)
    denom = jnp.where(jnp.abs(x[..., 3:]) < 1e-12, 1e-12, x[..., 3:])
    return x[..., :3] / denom


def reprojection_errors_cv(cam_r, cam_t, points3d, bearings):
    """Per-(marker, frame) bearing-space reprojection error + depth.

    Returns (error (M, F), depth (M, F)); depth <= 0 means behind the
    camera (CV convention: z forward)."""
    pc = (
        jnp.einsum("fij,mj->mfi", cam_r, points3d) + cam_t[None]
    )  # (M, F, 3)
    depth = pc[..., 2]
    proj = pc[..., :2] / jnp.where(
        jnp.abs(depth[..., None]) < 1e-12, 1e-12, depth[..., None]
    )
    err = jnp.linalg.norm(proj - bearings, axis=-1)
    return err, depth


def filter_bad_bundles(
    cam_r, cam_t, points3d, bearings, enable, solved, valid,
    focal_length_mm=35.0, film_back_width_mm=36.0,
    image_width=1920.0, max_error_px=9.0,
):
    """Invalidate bundles with high reprojection error or observations
    behind the camera (ref: the bad-bundle filtering of camera_solve,
    solvercamerautils.py:182-227 — reprojection-error and
    behind-camera culls).  Returns the updated valid mask."""
    err, depth = jax.jit(reprojection_errors_cv)(
        jnp.asarray(cam_r), jnp.asarray(cam_t), jnp.asarray(points3d),
        jnp.asarray(bearings),
    )
    err = np.asarray(err)
    depth = np.asarray(depth)
    obs = np.asarray(enable, bool) & np.asarray(solved, bool)[None, :]
    # bearing error -> pixels: marker_x = u * focal/fbw; px = marker*W.
    err_px = err * (focal_length_mm / film_back_width_mm) * image_width
    n_obs = np.maximum(obs.sum(axis=1), 1)
    mean_err = np.where(obs, err_px, 0.0).sum(axis=1) / n_obs
    behind = np.any(obs & (depth <= 0.0), axis=1)
    ok = (mean_err <= max_error_px) & ~behind & (obs.sum(axis=1) >= 2)
    return np.asarray(valid, bool) & ok


def camera_solve(
    marker_xy,
    enable_mask,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    render_aspect=None,
    key=None,
    min_pair_separation=5,
    refine_rounds=2,
    image_width=1920.0,
    max_bundle_error_px=9.0,
) -> CameraSolveResult:
    """Incremental SfM over all frames; returns per-frame poses and
    triangulated points in an arbitrary (origin-normalized) scale.

    render_aspect defaults to the film-back aspect (square-pixel
    aspect-matched delivery, the common case)."""
    marker_xy = np.asarray(marker_xy, dtype=np.float64)
    enable = np.asarray(enable_mask) > 0.5
    num_markers, num_frames = enable.shape
    if key is None:
        key = jax.random.PRNGKey(42)
    if render_aspect is None:
        render_aspect = film_back_width_mm / film_back_height_mm

    bearings = np.asarray(
        markers_to_bearings(
            jnp.asarray(marker_xy), focal_length_mm, film_back_width_mm,
            render_aspect,
        )
    )  # (M, F, 2)

    f0, f1 = best_frame_pair(enable, min_pair_separation)
    shared = enable[:, f0] & enable[:, f1]
    if shared.sum() < 8:
        raise ValueError(
            "not enough shared markers (%d) between frames %d and %d"
            % (int(shared.sum()), f0, f1)
        )

    # Every device call below is jitted: run eagerly, each primitive of
    # the RANSAC and Jacobi loops would compile and dispatch on its own.
    pose = jax.jit(
        lambda b0, b1, k: twoview.robust_relative_pose(
            b0, b1, key=k, num_hypotheses=128, inlier_threshold=1e-5,
        )
    )(
        jnp.asarray(bearings[shared, f0]),
        jnp.asarray(bearings[shared, f1]),
        key,
    )
    r1 = np.asarray(pose.rotation)
    t1 = np.asarray(pose.translation)

    # Camera-from-world per frame: frame f0 = identity.
    cam_r = np.zeros((num_frames, 3, 3))
    cam_t = np.zeros((num_frames, 3))
    solved = np.zeros(num_frames, bool)
    cam_r[f0] = np.eye(3)
    cam_t[f0] = 0.0
    cam_r[f1] = r1
    cam_t[f1] = t1
    solved[f0] = solved[f1] = True

    # Triangulate every marker seen in both anchor frames (full padded
    # set; invalid rows are masked out afterwards).
    pts3d = np.zeros((num_markers, 3))
    valid = np.zeros(num_markers, bool)
    triangulate = jax.jit(twoview.triangulate_linear)
    tri = np.asarray(
        triangulate(
            jnp.eye(3), jnp.zeros(3), jnp.asarray(r1), jnp.asarray(t1),
            jnp.asarray(bearings[:, f0]),
            jnp.asarray(bearings[:, f1]),
        )
    )
    pts3d[shared] = tri[shared]
    valid[shared] = np.asarray(pose.inliers)

    # Incremental resection of remaining frames, most-connected first
    # (ref: _solve_relative_poses loop, solvercamerautils.py:574).
    # All calls use the full padded point set with zero weights for
    # missing observations, so one compiled program serves every frame.
    # Resection is RANSAC-robust like the reference's ACRANSAC
    # pose-from-known-points (ref: camera_from_known_points.cpp:97-202):
    # an outlier track or a badly-triangulated bundle must not poison
    # the frame's pose.
    resect = jax.jit(
        lambda p3, p2, w, k: twoview.robust_resection_pose(
            p3, p2, key=k, num_hypotheses=64, weights=w,
            inlier_threshold=4e-4,
        )
    )
    order = np.argsort(-connected_frame_scores(enable & valid[:, None]))
    for f in order:
        if solved[f]:
            continue
        seen = enable[:, f] & valid
        if seen.sum() < 6:
            continue
        pose_f = resect(
            jnp.asarray(pts3d),
            jnp.asarray(bearings[:, f]),
            jnp.asarray(seen, dtype=np.float64),
            jax.random.PRNGKey(int(f)),
        )
        cam_r[f] = np.asarray(pose_f.rotation)
        cam_t[f] = np.asarray(pose_f.translation)
        solved[f] = True

        # Triangulate new points against the anchor frame.
        new = enable[:, f] & enable[:, f0] & ~valid
        if new.sum() > 0:
            tri = np.asarray(
                triangulate(
                    jnp.eye(3), jnp.zeros(3),
                    jnp.asarray(cam_r[f]), jnp.asarray(cam_t[f]),
                    jnp.asarray(bearings[:, f0]),
                    jnp.asarray(bearings[:, f]),
                )
            )
            pts3d[new] = tri[new]
            valid[new] = True

    # Refinement rounds (ref: the reference iterates relative poses,
    # per-bundle adjusts, filters bad bundles and triangulates more,
    # solvercamerautils.py:574-726): multi-view retriangulation of every
    # marker seen from >= 2 solved frames, bad-bundle culling, then
    # re-resection of all frames (including previously unsolvable ones)
    # from the improved structure.
    tri_mv = jax.jit(triangulate_multiview)
    resect_all = jax.jit(jax.vmap(
        lambda p3, b_col, w_col: twoview.resection_pose(
            p3, b_col, weights=w_col
        ),
        in_axes=(None, 0, 0),
    ))
    for _ in range(max(int(refine_rounds), 0)):
        obs = enable & solved[None, :]  # (M, F)
        seen2 = obs.sum(axis=1) >= 2
        if not seen2.any():
            break
        w = (obs & seen2[:, None]).astype(np.float64)
        tri = np.asarray(
            tri_mv(
                jnp.asarray(cam_r), jnp.asarray(cam_t),
                jnp.asarray(bearings), jnp.asarray(w),
            )
        )
        pts3d[seen2] = tri[seen2]
        valid = valid | seen2
        valid = filter_bad_bundles(
            cam_r, cam_t, pts3d, bearings, enable, solved, valid,
            focal_length_mm=focal_length_mm,
            film_back_width_mm=film_back_width_mm,
            image_width=image_width,
            max_error_px=max_bundle_error_px,
        )
        if valid.sum() < 6:
            # Over-aggressive cull (e.g. very noisy input): keep the
            # pre-cull structure rather than collapse the solve.
            valid = valid | seen2
        # Re-resect every frame from the refined, filtered structure —
        # one vmapped resection over the frame axis.
        seen_f = enable & valid[:, None]  # (M, F)
        resectable = seen_f.sum(axis=0) >= 6
        rs, ts = resect_all(
            jnp.asarray(pts3d),
            jnp.asarray(np.transpose(bearings, (1, 0, 2))),
            jnp.asarray(seen_f.T, dtype=np.float64),
        )
        rs = np.asarray(rs)
        ts = np.asarray(ts)
        cam_r[resectable] = rs[resectable]
        cam_t[resectable] = ts[resectable]
        solved = solved | resectable

    # Convert from the CV frame back to the Maya camera convention.
    # With S = diag(1,-1,-1) mapping CV camera axes (y down, z forward)
    # to Maya camera axes (y up, z backward):
    #   maya camera world rotation R_m = S R_cv^T S
    #   maya camera position       c_m = S (-R_cv^T t_cv)
    #   maya world points          p_m = S p_cv
    s = np.diag([1.0, -1.0, -1.0])
    centers = -np.einsum("fji,fj->fi", cam_r, cam_t)
    world_r = np.einsum(
        "ij,fkj,kl->fil", s, cam_r, s
    )  # S @ R_cv^T @ S
    world_t = centers @ s.T
    points_m = pts3d @ s.T

    return CameraSolveResult(
        rotations=world_r,
        positions=world_t,
        points3d=points_m,
        point_valid=valid,
        frame_solved=solved,
    )


def refine_with_bundle_adjustment(
    result: CameraSolveResult,
    marker_xy,
    enable_mask,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    render_aspect=None,
    image_width=1920.0,
    max_iterations=25,
    solve_focal=False,
):
    """Full BA polish of the incremental SfM result — the reference's
    final per-bundle + global bundle-adjust passes
    (ref: _bundle_adjust, solvercamerautils.py:380) via our structured
    Schur solver.

    Returns (refined CameraSolveResult, BAResult).
    """
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu.core.transform import matrix_to_euler
    from mayamatchmovesolver_tpu.solver import ba

    if render_aspect is None:
        render_aspect = film_back_width_mm / film_back_height_mm

    num_markers, num_frames = np.asarray(enable_mask).shape
    # Camera params: tx ty tz rx ry rz from the recovered poses.
    eulers = np.asarray(
        matrix_to_euler(
            jnp.asarray(result.rotations),
            jnp.zeros(result.rotations.shape[0], jnp.int32),
        )
    )
    cam_params = np.concatenate([result.positions, eulers], axis=-1)

    weight = np.asarray(enable_mask, float) * result.point_valid[:, None]
    problem = ba.make_ba_problem(
        marker_uv=np.asarray(marker_xy),
        weight=weight,
        mkr_bnd_index=np.arange(num_markers),
        cam_params=cam_params,
        bnd_params=result.points3d,
        focal_length_mm=focal_length_mm,
        film_back_width_mm=film_back_width_mm,
        film_back_height_mm=film_back_height_mm,
        render_width=int(image_width),
        render_height=int(round(image_width / render_aspect)),
        image_width=image_width,
        solve_focal=solve_focal,
    )
    ba_result = ba.solve_ba(problem, max_iterations=max_iterations)

    cam_out = np.asarray(ba_result.cam_params)
    from mayamatchmovesolver_tpu.core.transform import (
        euler_to_rotation_matrix,
    )

    rotations = np.asarray(
        euler_to_rotation_matrix(
            jnp.asarray(cam_out[:, 3]),
            jnp.asarray(cam_out[:, 4]),
            jnp.asarray(cam_out[:, 5]),
            jnp.zeros(num_frames, jnp.int32),
        )
    )
    refined = CameraSolveResult(
        rotations=rotations,
        positions=cam_out[:, :3],
        points3d=np.asarray(ba_result.bnd_params),
        point_valid=result.point_valid,
        frame_solved=result.frame_solved,
    )
    return refined, ba_result


def camera_solve_full(
    marker_xy,
    enable_mask,
    focal_length_mm=35.0,
    film_back_width_mm=36.0,
    film_back_height_mm=24.0,
    render_aspect=None,
    image_width=1920.0,
    solve_focal=False,
    key=None,
    min_pair_separation=5,
    refine_rounds=2,
    max_bundle_error_px=9.0,
    ba_iterations=50,
    origin_frame=0,
    scene_scale=1.0,
):
    """The complete from-scratch camera solve: incremental SfM,
    bad-bundle filtering, global bundle adjustment (optionally solving
    focal length), and origin-frame normalization — the counterpart of
    the reference's camera_solve driver
    (ref: python/mmSolver/_api/solvercamerautils.py:958-1290).

    Returns (CameraSolveResult, BAResult, solved_focal_length_mm).

    Focal solving (ref: the focal attrs passed into _bundle_adjust,
    solvercamerautils.py:380-520): ONE shared focal parameter is freed
    in the BA's arrowhead border in a first pass (a matchmove shot has
    one physical lens — the reference's static-attribute semantics),
    then a fixed-focal BA polishes poses and structure at the solved
    value.
    """
    result = camera_solve(
        marker_xy, enable_mask,
        focal_length_mm=focal_length_mm,
        film_back_width_mm=film_back_width_mm,
        film_back_height_mm=film_back_height_mm,
        render_aspect=render_aspect,
        key=key,
        min_pair_separation=min_pair_separation,
        refine_rounds=refine_rounds,
        image_width=image_width,
        max_bundle_error_px=max_bundle_error_px,
    )
    focal = float(focal_length_mm)
    if solve_focal:
        refined, ba_result = refine_with_bundle_adjustment(
            result, marker_xy, enable_mask,
            focal_length_mm=focal,
            film_back_width_mm=film_back_width_mm,
            film_back_height_mm=film_back_height_mm,
            render_aspect=render_aspect,
            image_width=image_width,
            max_iterations=ba_iterations,
            solve_focal=True,
        )
        # solve_focal puts ONE focal in the BA border (the reference's
        # static-attribute semantics) — read it back directly.
        focal = float(np.asarray(ba_result.shared_params)[0])
        result = refined
    refined, ba_result = refine_with_bundle_adjustment(
        result, marker_xy, enable_mask,
        focal_length_mm=focal,
        film_back_width_mm=film_back_width_mm,
        film_back_height_mm=film_back_height_mm,
        render_aspect=render_aspect,
        image_width=image_width,
        max_iterations=ba_iterations,
        solve_focal=False,
    )
    refined = set_origin_frame(
        refined, origin_frame=origin_frame, scene_scale=scene_scale
    )
    return refined, ba_result, focal


def set_origin_frame(result: CameraSolveResult, origin_frame=0,
                     scene_scale=1.0) -> CameraSolveResult:
    """Normalize so the origin frame's camera sits at the world origin
    with identity orientation, and scale the scene
    (ref: _set_camera_origin_frame, solvercamerautils.py:730)."""
    r0 = result.rotations[origin_frame]
    p0 = result.positions[origin_frame]
    r0_inv = r0.T
    rotations = np.einsum("ij,fjk->fik", r0_inv, result.rotations)
    positions = (
        np.einsum("ij,fj->fi", r0_inv, result.positions - p0) * scene_scale
    )
    points3d = (
        np.einsum("ij,mj->mi", r0_inv, result.points3d - p0) * scene_scale
    )
    return CameraSolveResult(
        rotations=rotations,
        positions=positions,
        points3d=points3d,
        point_valid=result.point_valid,
        frame_solved=result.frame_solved,
    )
