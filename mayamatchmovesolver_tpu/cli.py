"""Command-line interface.

Replaces the reference's Maya-command surface with a standalone CLI
(SURVEY.md section 7 step 8): the capabilities of the mmSolver /
mmCameraSolve commands and the tools/lensdistortion binary
(ref: src/mmSolver/cmd/MMSolverCmd.cpp:109, MMCameraSolveCmd,
tools/lensdistortion/src/main.cpp).

    python -m mayamatchmovesolver_tpu.cli solve --markers t.uv ...
    python -m mayamatchmovesolver_tpu.cli camera-solve --markers t.uv ...
    python -m mayamatchmovesolver_tpu.cli lensdistort --model tde_classic
        --distortion 0.1 --width 1920 --height 1080 --output st.exr
    python -m mayamatchmovesolver_tpu.cli formats
"""

import argparse
import json
import sys

import numpy as np


def _cmd_formats(args):
    from mayamatchmovesolver_tpu.io import get_formats

    for ext, name in sorted(get_formats().items()):
        print("%s\t%s" % (ext, name))
    return 0


def _load_markers(path, image_width, image_height):
    from mayamatchmovesolver_tpu.io import read

    info, mkr_data = read(
        path, image_width=image_width, image_height=image_height
    )
    if not mkr_data:
        raise SystemExit("no markers parsed from %r" % path)
    return info, mkr_data


def _marker_arrays(mkr_data, start, end):
    frames = list(range(start, end + 1))
    m = len(mkr_data)
    f = len(frames)
    uv = np.zeros((m, f, 2))
    enable = np.zeros((m, f))
    for i, md in enumerate(mkr_data):
        for fi, frame in enumerate(frames):
            x = md.x.get_value(frame)
            y = md.y.get_value(frame)
            if x is None or y is None:
                continue
            uv[i, fi] = (x - 0.5, y - 0.5)
            enable[i, fi] = float(md.enable.get_value(frame, 1))
    return uv, enable, frames


def _frame_range_of(mkr_data):
    lo, hi = None, None
    for md in mkr_data:
        rng = md.frame_range()
        if rng is None:
            continue
        lo = rng[0] if lo is None else min(lo, rng[0])
        hi = rng[1] if hi is None else max(hi, rng[1])
    if lo is None:
        raise SystemExit("markers contain no frames")
    return lo, hi


def _cmd_camera_solve(args):
    from mayamatchmovesolver_tpu.sfm import camerasolve

    _, mkr_data = _load_markers(
        args.markers, args.image_width, args.image_height
    )
    start, end = (
        (args.start_frame, args.end_frame)
        if args.start_frame is not None
        else _frame_range_of(mkr_data)
    )
    uv, enable, frames = _marker_arrays(mkr_data, start, end)
    result = camerasolve.camera_solve(
        uv, enable,
        focal_length_mm=args.focal_length,
        film_back_width_mm=args.film_back_width,
        film_back_height_mm=args.film_back_height,
    )
    result = camerasolve.set_origin_frame(result)
    out = {
        "frames": frames,
        "camera": {
            "positions": result.positions.tolist(),
            "rotations": result.rotations.tolist(),
            "frame_solved": result.frame_solved.tolist(),
        },
        "points": {
            "positions": result.points3d.tolist(),
            "valid": result.point_valid.tolist(),
            "names": [md.name for md in mkr_data],
        },
    }
    text = json.dumps(out, indent=1)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print("wrote %s (%d frames solved, %d points)" % (
            args.output, int(result.frame_solved.sum()),
            int(result.point_valid.sum()),
        ))
    else:
        print(text)
    return 0


def _cmd_solve(args):
    """Refine camera pose per frame against markers with known 3D
    bundle positions (uvtrack v3/v4 '3d' blocks), or triangulated ones."""
    from mayamatchmovesolver_tpu.core.constants import FilmFit
    from mayamatchmovesolver_tpu.io import markers_to_scene
    from mayamatchmovesolver_tpu.scene import SceneGraph
    from mayamatchmovesolver_tpu.solver import (
        SolverOptions,
        solve_per_frame,
    )

    _, mkr_data = _load_markers(
        args.markers, args.image_width, args.image_height
    )
    start, end = (
        (args.start_frame, args.end_frame)
        if args.start_frame is not None
        else _frame_range_of(mkr_data)
    )
    sg = SceneGraph(frame_range=(start, end))
    n = sg.num_frames
    # Initial camera pose: zeros, or --camera JSON (the reference's
    # mmSolver command reads the current scene state; the CLI takes an
    # initial guess the same way, e.g. a previous solve's output).
    init = {c: np.zeros(n) for c in ("tx", "ty", "tz", "rx", "ry", "rz")}
    if getattr(args, "camera", None):
        with open(args.camera) as f:
            cam_data = json.load(f)
        cam_block = cam_data.get("camera", cam_data)
        for c in init:
            if c in cam_block:
                vals = np.atleast_1d(np.asarray(cam_block[c], float))
                init[c] = np.broadcast_to(vals, (n,)) if vals.size in (
                    1, n
                ) else np.resize(vals, n)
    cam = sg.create_camera(
        "cam",
        tx=init["tx"], ty=init["ty"], tz=init["tz"],
        rx=init["rx"], ry=init["ry"], rz=init["rz"],
        focal_length_mm=args.focal_length,
        sensor_width_mm=args.film_back_width,
        sensor_height_mm=args.film_back_height,
        film_fit=FilmFit.HORIZONTAL,
        render_width=args.image_width or 1920,
        render_height=args.image_height or 1080,
    )
    created = markers_to_scene(mkr_data, sg, cam)
    scene, attrs = sg.bake()

    from mayamatchmovesolver_tpu.solver import registry, solve

    solver_type = None
    if getattr(args, "solver_type", None):
        names = {name: idx for idx, name in registry.get_solver_types()}
        solver_type = names[args.solver_type]
    options = SolverOptions(
        iterations=args.iterations,
        image_width=float(args.image_width or 1920),
        solver_type=solver_type,
    )
    solve_attrs = [cam.attr(c) for c in ("tx", "ty", "tz",
                                         "rx", "ry", "rz")]
    solve_bundles = bool(getattr(args, "solve_bundles", False)) or (
        solver_type in (registry.SOLVER_TYPE_BA_SCHUR,
                        registry.SOLVER_TYPE_BA_SHARDED)
    )
    if solve_bundles:
        # Joint camera+bundle solve over all frames at once — routed
        # through the structured Schur BA backend when requested
        # (ref: the reference's one mmSolver command dispatching every
        # registered solver, adjust_base.cpp:80-127,713).
        for _, bnd in created:
            solve_attrs += [bnd.attr(c) for c in ("tx", "ty", "tz")]
        new_attrs, result = solve(
            scene, attrs, list(range(n)), solve_attrs, options
        )
    else:
        new_attrs, result = solve_per_frame(
            scene, attrs, list(range(n)), solve_attrs, options
        )
    for line in result.as_key_value_strings():
        print(line)
    if args.output:
        anim = np.asarray(new_attrs.anim_values)
        out = {
            "frames": list(range(start, end + 1)),
            "camera": {
                c: anim[cam.attr(c).code // 2].tolist()
                for c in ("tx", "ty", "tz", "rx", "ry", "rz")
            },
        }
        with open(args.output, "w") as f:
            json.dump(out, f, indent=1)
        print("wrote %s" % args.output)
    return 0 if result.success else 1


def _cmd_lensdistort(args):
    from mayamatchmovesolver_tpu import models
    from mayamatchmovesolver_tpu.io import exr
    from mayamatchmovesolver_tpu.models import scenelens
    from mayamatchmovesolver_tpu.ops import stmap as stmap_mod

    fb = models.FilmBack.create(
        width_cm=args.film_back_width / 10.0,
        height_cm=args.film_back_height / 10.0,
    )
    if args.model == scenelens.LENS_MODEL_CLASSIC:
        model = models.TdeClassic.create(
            distortion=args.distortion,
            anamorphic_squeeze=args.anamorphic_squeeze,
            curvature_x=args.curvature_x,
            curvature_y=args.curvature_y,
            quartic_distortion=args.quartic_distortion,
        )
    elif args.model == scenelens.LENS_MODEL_RADIAL_DEG4:
        model = models.TdeRadialStdDeg4.create(
            degree2_distortion=args.distortion,
            degree4_distortion=args.quartic_distortion,
        )
    else:
        raise SystemExit("unsupported model for CLI: %r" % args.model)

    image = np.asarray(
        stmap_mod.stmap(model, fb, args.width, args.height,
                    direction=args.direction)
    )
    exr.write_pixels(args.output, image)
    print(
        "wrote %s (%dx%d %s ST map)"
        % (args.output, args.width, args.height, args.direction)
    )
    return 0


def _cmd_reproject(args):
    """Batch 3D -> 2D reprojection (ref: the mmReprojection command,
    src/mmSolver/cmd/MMReprojectionCmd.cpp — world points through a
    camera to marker/normalized/pixel coords, batched over frames)."""
    from mayamatchmovesolver_tpu.utils import reproject as reproject_mod

    with open(args.camera) as f:
        cam_data = json.load(f)
    cam = cam_data.get("camera", cam_data)
    frames = cam_data.get("frames")
    channels = [np.atleast_1d(np.asarray(cam[c], np.float64))
                for c in ("tx", "ty", "tz", "rx", "ry", "rz")]
    n_frames = max(ch.shape[0] for ch in channels)
    channels = [np.broadcast_to(ch, (n_frames,)) for ch in channels]
    if frames is None:
        frames = list(range(n_frames))

    with open(args.points) as f:
        pts_data = json.load(f)
    if isinstance(pts_data, dict):
        pts_data = pts_data.get("points", pts_data)
        if isinstance(pts_data, dict):
            pts_data = pts_data["positions"]
    points = np.asarray(pts_data, np.float64)  # (P, 3)
    if points.ndim != 2 or points.shape[1] != 3:
        raise SystemExit("points must be a (P, 3) array")

    world = np.asarray(reproject_mod.camera_world_matrix_from_trs(
        *[c for c in channels]
    ))  # (F, 4, 4)
    xy = np.asarray(reproject_mod.reproject_points(
        points[:, None, :], world[None],
        focal_length_mm=args.focal_length,
        film_back_width_mm=args.film_back_width,
        film_back_height_mm=args.film_back_height,
        render_width=args.image_width,
        render_height=args.image_height,
        as_pixels=args.space == "pixels",
        as_normalized=args.space == "normalized",
    ))  # (P, F, 2)
    out = {
        "frames": list(frames),
        "space": args.space,
        "points": xy.tolist(),
    }
    text = json.dumps(out, indent=1)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
        print("wrote %s (%d points x %d frames)"
              % (args.output, xy.shape[0], xy.shape[1]))
    else:
        print(text)
    return 0


def _cmd_affects(args):
    """Marker <-> attribute relationship analysis (ref: the
    mmSolverAffects command, MMSolverAffectsCmd.cpp:214 — here the
    'returnString' mode as JSON: per-marker affecting attributes, the
    used/unused split, and problem sizing)."""
    from mayamatchmovesolver_tpu.core.constants import FilmFit
    from mayamatchmovesolver_tpu.io import markers_to_scene
    from mayamatchmovesolver_tpu.scene import SceneGraph
    from mayamatchmovesolver_tpu.solver import affects

    _, mkr_data = _load_markers(
        args.markers, args.image_width, args.image_height
    )
    start, end = (
        (args.start_frame, args.end_frame)
        if args.start_frame is not None
        else _frame_range_of(mkr_data)
    )
    sg = SceneGraph(frame_range=(start, end))
    n = sg.num_frames
    cam = sg.create_camera(
        "cam",
        tx=np.zeros(n), ty=np.zeros(n), tz=np.zeros(n),
        rx=np.zeros(n), ry=np.zeros(n), rz=np.zeros(n),
        focal_length_mm=args.focal_length,
        sensor_width_mm=args.film_back_width,
        sensor_height_mm=args.film_back_height,
        film_fit=FilmFit.HORIZONTAL,
        render_width=args.image_width or 1920,
        render_height=args.image_height or 1080,
    )
    markers = [mkr for mkr, _bnd in markers_to_scene(mkr_data, sg, cam)]
    attrs = [cam.attr(c) for c in ("tx", "ty", "tz", "rx", "ry", "rz")]
    for m in markers:
        for ch in ("tx", "ty", "tz"):
            attrs.append(m.bundle.attr(ch))
    matrix = affects.marker_attr_affects(markers, attrs)
    used_m, unused_m, used_a, unused_a = (
        affects.split_used_markers_and_attributes(markers, attrs)
    )
    attr_name = ["%s.%s" % (a.node.name, a.name) for a in attrs]
    out = {
        "markers": [m.name for m in markers],
        "attributes": attr_name,
        "affects": {
            m.name: [attr_name[j] for j in np.nonzero(matrix[mi])[0]]
            for mi, m in enumerate(markers)
        },
        "used_markers": [m.name for m in used_m],
        "unused_markers": [m.name for m in unused_m],
        "used_attributes": [
            "%s.%s" % (a.node.name, a.name) for a in used_a
        ],
        "unused_attributes": [
            "%s.%s" % (a.node.name, a.name) for a in unused_a
        ],
    }
    _write_or_print(out, args.output)
    return 0


def _cmd_validate(args):
    """Scene/problem validation without solving (ref: the
    mmSolverSceneGraph command's convertibility check,
    MMSolverSceneGraphCmd.cpp:141, plus the compile-layer validation
    twins, _execute/main.py:51 and the sizing checks
    adjust_base.cpp:864-882)."""
    from mayamatchmovesolver_tpu.core.constants import FilmFit
    from mayamatchmovesolver_tpu.io import markers_to_scene
    from mayamatchmovesolver_tpu.scene import SceneGraph
    from mayamatchmovesolver_tpu.solver import (
        SolverOptions,
        build_problem,
        count_errors_and_parameters,
    )

    _, mkr_data = _load_markers(
        args.markers, args.image_width, args.image_height
    )
    start, end = (
        (args.start_frame, args.end_frame)
        if args.start_frame is not None
        else _frame_range_of(mkr_data)
    )
    sg = SceneGraph(frame_range=(start, end))
    n = sg.num_frames
    cam = sg.create_camera(
        "cam",
        tx=np.zeros(n), ty=np.zeros(n), tz=np.zeros(n),
        rx=np.zeros(n), ry=np.zeros(n), rz=np.zeros(n),
        focal_length_mm=args.focal_length,
        sensor_width_mm=args.film_back_width,
        sensor_height_mm=args.film_back_height,
        film_fit=FilmFit.HORIZONTAL,
        render_width=args.image_width or 1920,
        render_height=args.image_height or 1080,
    )
    markers_to_scene(mkr_data, sg, cam)
    scene, attrs = sg.bake()
    solve_attrs = [cam.attr(c) for c in ("tx", "ty", "tz",
                                         "rx", "ry", "rz")]
    options = SolverOptions(image_width=float(args.image_width or 1920))
    problem = build_problem(scene, attrs, np.arange(n), solve_attrs,
                            options)
    num_errors, num_params_static = count_errors_and_parameters(problem)
    per_frame_params = len(solve_attrs)
    out = {
        "frames": [start, end],
        "num_markers": len(mkr_data),
        "num_errors": num_errors,
        "num_parameters": int(problem.num_params),
        "solvable": num_errors >= int(problem.num_params),
        "per_frame_solvable": (
            2 * len(mkr_data) >= per_frame_params
        ),
    }
    _write_or_print(out, args.output)
    return 0 if out["solvable"] else 1


def _cmd_camera_matrix(args):
    """Camera projection / world matrices for given parameters (ref:
    the mmTestCameraMatrix command, MMTestCameraMatrixCmd.cpp — matrix
    parity checks)."""
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu.core import camera as cam_mod
    from mayamatchmovesolver_tpu.core.constants import FilmFit
    from mayamatchmovesolver_tpu.utils import reproject as rep

    proj = np.asarray(cam_mod.projection_matrix(
        jnp.asarray(float(args.focal_length)),
        jnp.asarray(args.film_back_width / 25.4),
        jnp.asarray(args.film_back_height / 25.4),
        jnp.asarray(0.0), jnp.asarray(0.0),
        float(args.image_width), float(args.image_height),
        int(FilmFit.HORIZONTAL),
        0.1, 10000.0, 1.0,
    ))
    world = np.asarray(rep.camera_world_matrix_from_trs(
        *[np.atleast_1d(v) for v in args.trs]
    ))[0]
    out = {
        "projection_matrix": proj.tolist(),
        "camera_world_matrix": world.tolist(),
        # world -> clip: view transform (inverse camera world) then
        # projection, same composition the engine uses.
        "world_projection_matrix": (
            proj @ np.linalg.inv(world)
        ).tolist(),
    }
    _write_or_print(out, args.output)
    return 0


def _cmd_solver_types(args):
    """List registered solver backends (ref: the mmSolverType command,
    src/mmSolver/cmd/MMSolverTypeCmd.cpp — query name/index/default)."""
    from mayamatchmovesolver_tpu.solver import registry

    default_index, _ = registry.get_solver_type_default()
    out = [
        {"index": idx, "name": name, "default": idx == default_index}
        for idx, name in registry.get_solver_types()
    ]
    print(json.dumps(out))
    return 0


def _two_frame_bearings(args, min_shared):
    """Correspondences between two frames of a markers file, as
    normalized CV bearings (markers enabled on both frames only).

    min_shared: smallest usable correspondence count for the calling
    command (8 for the essential-matrix RANSAC which samples 8 points
    without replacement; 4 for homography DLT)."""
    from mayamatchmovesolver_tpu.sfm import camerasolve

    _, mkr_data = _load_markers(
        args.markers, args.image_width, args.image_height
    )
    start, end = _frame_range_of(mkr_data)
    uv, enable, frames = _marker_arrays(mkr_data, start, end)
    try:
        ia = frames.index(args.frame_a)
        ib = frames.index(args.frame_b)
    except ValueError:
        raise SystemExit(
            "frames %d/%d outside marker range %d-%d"
            % (args.frame_a, args.frame_b, start, end)
        )
    both = (enable[:, ia] > 0.5) & (enable[:, ib] > 0.5)
    if both.sum() < min_shared:
        raise SystemExit(
            "only %d markers enabled on both frames (need >= %d)"
            % (int(both.sum()), min_shared)
        )
    # Raw marker space pairs with the film-back aspect (screen space
    # would pair with the render aspect — see markers_to_bearings).
    aspect = float(args.film_back_width) / float(args.film_back_height)
    bearings = np.asarray(
        camerasolve.markers_to_bearings(
            uv[both][:, (ia, ib)], args.focal_length,
            args.film_back_width, aspect,
        )
    )  # (M, 2, 2)
    names = [md.name for md, keep in zip(mkr_data, both) if keep]
    return bearings[:, 0], bearings[:, 1], names


def _cmd_relative_pose(args):
    """Two-view relative pose (ref: the mmCameraRelativePose command,
    src/mmSolver/cmd/MMCameraRelativePoseCmd.cpp — ACRANSAC essential
    matrix + pose; here hypothesis-parallel vmapped RANSAC)."""
    from mayamatchmovesolver_tpu.sfm import twoview

    pts_a, pts_b, names = _two_frame_bearings(args, min_shared=8)
    pose = twoview.robust_relative_pose(
        _jnp_array(pts_a), _jnp_array(pts_b)
    )
    inliers = np.asarray(pose.inliers)
    out = {
        "frame_a": args.frame_a,
        "frame_b": args.frame_b,
        "rotation": np.asarray(pose.rotation).tolist(),
        "translation": np.asarray(pose.translation).tolist(),
        "essential": np.asarray(pose.essential).tolist(),
        "num_inliers": int(pose.num_inliers),
        "inlier_markers": [n for n, i in zip(names, inliers) if i],
    }
    _write_or_print(out, args.output)
    return 0


def _cmd_homography(args):
    """Homography between two frames' markers (ref: the
    mmMarkerHomography command, MMMarkerHomographyCmd.cpp)."""
    from mayamatchmovesolver_tpu.sfm import twoview

    pts_a, pts_b, names = _two_frame_bearings(args, min_shared=4)
    h = np.asarray(
        twoview.estimate_homography(_jnp_array(pts_a), _jnp_array(pts_b))
    )
    err = np.asarray(
        twoview.homography_transfer_error(
            _jnp_array(h), _jnp_array(pts_a), _jnp_array(pts_b)
        )
    )
    out = {
        "frame_a": args.frame_a,
        "frame_b": args.frame_b,
        "homography": h.tolist(),
        "rms_transfer_error": float(np.sqrt(np.mean(err))),
        "markers": names,
    }
    _write_or_print(out, args.output)
    return 0


def _cmd_pose_from_points(args):
    """Camera pose from known 3D points at one frame (ref: the
    mmCameraPoseFromPoints command, MMCameraPoseFromPointsCmd.cpp —
    DLT resection)."""
    from mayamatchmovesolver_tpu.sfm import camerasolve, twoview

    _, mkr_data = _load_markers(
        args.markers, args.image_width, args.image_height
    )
    start, end = _frame_range_of(mkr_data)
    uv, enable, frames = _marker_arrays(mkr_data, start, end)
    try:
        fi = frames.index(args.frame)
    except ValueError:
        raise SystemExit("frame %d outside marker range" % args.frame)

    with open(args.points) as f:
        pts_data = json.load(f)
    names = None
    point_valid = None
    if isinstance(pts_data, dict):
        block = pts_data.get("points", pts_data)
        if isinstance(block, dict):
            names = block.get("names")
            point_valid = block.get("valid")
            pts_data = block["positions"]
        else:
            pts_data = block
    points3d = np.asarray(pts_data, np.float64)
    if args.points_convention == "maya":
        # camera-solve emits Maya-world points (p_m = S p_cv with
        # S = diag(1,-1,-1), camerasolve.py); resection runs in the
        # CV frame, so map them back before the DLT.
        points3d = points3d * np.array([1.0, -1.0, -1.0])
    if point_valid is None:
        point_valid = [True] * points3d.shape[0]

    marker_names = [md.name for md in mkr_data]
    if names is not None:
        index_of = {n: i for i, n in enumerate(names)}
        rows = [index_of.get(n, -1) for n in marker_names]
    else:
        rows = list(range(min(len(marker_names), points3d.shape[0])))
        rows += [-1] * (len(marker_names) - len(rows))
    # Unsolved/culled bundles (valid=false in camera-solve output) hold
    # zeros/garbage; the DLT has no RANSAC, so drop them up front.
    keep = np.array(
        [r >= 0 and bool(point_valid[r]) and enable[i, fi] > 0.5
         for i, r in enumerate(rows)]
    )
    if keep.sum() < 6:
        raise SystemExit(
            "only %d usable marker<->3D correspondences" % int(keep.sum())
        )
    p3 = points3d[[r for r, k in zip(rows, keep) if k]]
    aspect = float(args.film_back_width) / float(args.film_back_height)
    p2 = np.asarray(
        camerasolve.markers_to_bearings(
            uv[keep, fi], args.focal_length,
            args.film_back_width, aspect,
        )
    )
    # RANSAC-robust resection, like the reference's ACRANSAC
    # pose-from-known-points (ref: camera_from_known_points.cpp:97-202):
    # outlier correspondences are rejected by consensus, not dropped by
    # a single median heuristic.
    pose = twoview.robust_resection_pose(
        _jnp_array(p3), _jnp_array(p2), num_hypotheses=256
    )
    r = np.asarray(pose.rotation)
    t = np.asarray(pose.translation)
    num_inliers = int(pose.num_inliers)
    # Maya-convention camera placement alongside the raw CV pose
    # (same mapping camera-solve uses, camerasolve.py:319-331).
    s = np.diag([1.0, -1.0, -1.0])
    out = {
        "frame": args.frame,
        "convention": "cv",
        "rotation": r.tolist(),
        "translation": t.tolist(),
        "camera_position_maya": (s @ (-r.T @ t)).tolist(),
        "camera_rotation_maya": (s @ r.T @ s).tolist(),
        "markers": [n for n, k in zip(marker_names, keep) if k],
        "num_inliers": num_inliers,
    }
    _write_or_print(out, args.output)
    return 0


def _cmd_calibrate(args):
    """One/two-vanishing-point camera calibration (ref: the
    mmCameraCalibrate node + calibratecamera tool,
    src/mmSolver/node/MMCameraCalibrateNode.cpp:194,
    src/mmSolver/calibrate/vanishing_point.h:42-70).

    Point coordinates are in marker space ([-0.5, 0.5] across the film
    back width, y up), the same space the vanishing module and marker
    files use."""
    from mayamatchmovesolver_tpu.core.constants import RotateOrder
    from mayamatchmovesolver_tpu.core.transform import matrix_to_euler
    from mayamatchmovesolver_tpu.sfm import vanishing

    common = dict(
        focal_length_mm=args.focal_length,
        film_back_width_mm=args.film_back_width,
        film_back_height_mm=args.film_back_height,
        origin_point=np.asarray(args.origin_point, np.float64),
        principal_point=np.asarray(args.principal_point, np.float64),
        scene_scale_mode=vanishing.SceneScaleMode(args.scene_scale_mode),
        scene_scale_distance_cm=args.scene_scale_distance,
    )
    if args.vanishing_point_b is not None and args.horizon is not None:
        raise SystemExit(
            "--vanishing-point-b and --horizon are mutually exclusive: "
            "two-VP mode derives the horizon from the vanishing points"
        )
    if args.vanishing_point_b is not None:
        calib = vanishing.calibrate_two_vanishing_points(
            vanishing_point_a=np.asarray(args.vanishing_point_a,
                                         np.float64),
            vanishing_point_b=np.asarray(args.vanishing_point_b,
                                         np.float64),
            **common,
        )
    elif args.horizon is not None:
        calib = vanishing.calibrate_one_vanishing_point(
            vanishing_point_a=np.asarray(args.vanishing_point_a,
                                         np.float64),
            horizon_point_a=np.asarray(args.horizon[:2], np.float64),
            horizon_point_b=np.asarray(args.horizon[2:], np.float64),
            **common,
        )
    else:
        raise SystemExit(
            "need either --vanishing-point-b or --horizon"
        )
    rot = np.asarray(calib.rotation_matrix)
    out = {
        "ok": bool(calib.ok),
        "focal_length_mm": float(calib.focal_length_mm),
        "rotation_matrix": rot.tolist(),
        "rotation_euler_xyz_deg": [
            float(v)
            for v in np.asarray(
                matrix_to_euler(_jnp_array(rot), int(RotateOrder.XYZ))
            )
        ],
        "position": np.asarray(calib.translation).tolist(),
    }
    _write_or_print(out, args.output)
    return 0 if out["ok"] else 1


def _jnp_array(x):
    import jax.numpy as jnp

    return jnp.asarray(x)


def _write_or_print(out, output_path):
    text = json.dumps(out, indent=1)
    if output_path:
        with open(output_path, "w") as f:
            f.write(text)
        print("wrote %s" % output_path)
    else:
        print(text)


def _cmd_image_info(args):
    """Width/height/pixel query (ref: the mmReadImage command,
    src/mmSolver/cmd/MMReadImageCmd.cpp:49)."""
    from mayamatchmovesolver_tpu.io import image as image_mod

    width, height = image_mod.image_size(args.path)
    out = {"path": args.path, "width": width, "height": height}
    if args.pixel is not None:
        img, _ = image_mod.read_image(args.path)
        x, y = args.pixel
        if not (0 <= x < img.shape[1] and 0 <= y < img.shape[0]):
            raise SystemExit("pixel (%d, %d) out of bounds" % (x, y))
        out["pixel"] = [float(v) for v in img[y, x]]
    print(json.dumps(out))
    return 0


def _cmd_image_convert(args):
    """Resize + format conversion (ref: the mmConvertImage command,
    src/mmSolver/cmd/MMConvertImageCmd.cpp:188)."""
    from mayamatchmovesolver_tpu.io import image as image_mod

    width, height = image_mod.convert_image(
        args.input, args.output, scale=args.scale
    )
    print("wrote %s (%dx%d)" % (args.output, width, height))
    return 0


def _cmd_image_warp(args):
    """Warp pixels through a lens model or an ST-map file (the
    consumer half of the lensdistort verb's maps; ref: the reference
    generates ST maps for compositor STMap nodes,
    tools/lensdistortion)."""
    import numpy as np

    from mayamatchmovesolver_tpu.io import image as image_mod
    from mayamatchmovesolver_tpu.ops import warp as warp_mod

    img, _ = image_mod.read_image(args.input)
    if args.stmap:
        st, _ = image_mod.read_image(args.stmap)
        out = np.asarray(warp_mod.warp_image(img, st))
    else:
        from mayamatchmovesolver_tpu import models

        fb = models.FilmBack.create(
            width_cm=args.film_back_width / 10.0,
            height_cm=args.film_back_height / 10.0,
        )
        model = models.TdeClassic.create(
            distortion=args.distortion,
            anamorphic_squeeze=args.anamorphic_squeeze,
            curvature_x=args.curvature_x,
            curvature_y=args.curvature_y,
            quartic_distortion=args.quartic_distortion,
        )
        out = np.asarray(warp_mod.warp_image_with_lens(
            img, model, fb, direction=args.direction,
        ))
    image_mod.write_image(args.output, out)
    print("wrote %s (%dx%d warped)" % (
        args.output, out.shape[1], out.shape[0]
    ))
    return 0


def main(argv=None):
    from mayamatchmovesolver_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    parser = argparse.ArgumentParser(
        prog="mmsolver",
        description="matchmove solver CLI",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    sub.add_parser("formats", help="list marker file formats")

    def add_marker_args(p):
        p.add_argument("--markers", required=True)
        p.add_argument("--image-width", type=int, default=1920)
        p.add_argument("--image-height", type=int, default=1080)
        p.add_argument("--start-frame", type=int, default=None)
        p.add_argument("--end-frame", type=int, default=None)
        p.add_argument("--focal-length", type=float, default=35.0)
        p.add_argument("--film-back-width", type=float, default=36.0)
        p.add_argument("--film-back-height", type=float, default=24.0)
        p.add_argument("--output", default=None)

    p = sub.add_parser("camera-solve",
                       help="SfM bootstrap: solve camera from 2D tracks")
    add_marker_args(p)

    p = sub.add_parser(
        "affects",
        help="marker <-> attribute relationship analysis",
    )
    add_marker_args(p)

    p = sub.add_parser(
        "validate",
        help="problem sizing / solvability check without solving",
    )
    add_marker_args(p)

    p = sub.add_parser(
        "camera-matrix",
        help="camera projection/world matrices for given parameters",
    )
    p.add_argument("--trs", type=float, nargs=6, required=True,
                   metavar=("TX", "TY", "TZ", "RX", "RY", "RZ"))
    p.add_argument("--focal-length", type=float, default=35.0)
    p.add_argument("--film-back-width", type=float, default=36.0)
    p.add_argument("--film-back-height", type=float, default=24.0)
    p.add_argument("--image-width", type=int, default=1920)
    p.add_argument("--image-height", type=int, default=1080)
    p.add_argument("--output", default=None)

    p = sub.add_parser("solve", help="per-frame pose refinement solve")
    add_marker_args(p)
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--camera", default=None,
                   help="initial camera JSON (tx..rz values/arrays)")
    p.add_argument("--solver-type", default=None,
                   choices=["lm_jax", "ba_schur", "lm_sharded",
                            "ba_schur_sharded"],
                   help="solver backend (see `solver-types`); the "
                        "ba_* backends solve camera AND bundles "
                        "jointly via the structured Schur path")
    p.add_argument("--solve-bundles", action="store_true",
                   help="solve bundle positions jointly with the "
                        "camera (all frames at once)")

    p = sub.add_parser("lensdistort", help="write a lens ST-map EXR")
    p.add_argument("--model", default="tde_classic")
    p.add_argument("--width", type=int, default=1920)
    p.add_argument("--height", type=int, default=1080)
    p.add_argument("--direction", choices=["distort", "undistort"],
                   default="distort")
    p.add_argument("--distortion", type=float, default=0.0)
    p.add_argument("--anamorphic-squeeze", type=float, default=1.0)
    p.add_argument("--curvature-x", type=float, default=0.0)
    p.add_argument("--curvature-y", type=float, default=0.0)
    p.add_argument("--quartic-distortion", type=float, default=0.0)
    p.add_argument("--film-back-width", type=float, default=36.0)
    p.add_argument("--film-back-height", type=float, default=24.0)
    p.add_argument("--output", required=True)

    p = sub.add_parser(
        "reproject", help="batch 3D->2D reprojection through a camera"
    )
    p.add_argument("--camera", required=True,
                   help="camera JSON (solve/camera-solve output)")
    p.add_argument("--points", required=True,
                   help="JSON (P, 3) array or camera-solve output")
    p.add_argument("--space", choices=["marker", "normalized", "pixels"],
                   default="marker")
    p.add_argument("--image-width", type=int, default=1920)
    p.add_argument("--image-height", type=int, default=1080)
    p.add_argument("--focal-length", type=float, default=35.0)
    p.add_argument("--film-back-width", type=float, default=36.0)
    p.add_argument("--film-back-height", type=float, default=24.0)
    p.add_argument("--output", default=None)

    sub.add_parser("solver-types", help="list solver backends")

    def add_two_frame_args(p):
        p.add_argument("--markers", required=True)
        p.add_argument("--frame-a", type=int, required=True)
        p.add_argument("--frame-b", type=int, required=True)
        p.add_argument("--image-width", type=int, default=1920)
        p.add_argument("--image-height", type=int, default=1080)
        p.add_argument("--focal-length", type=float, default=35.0)
        p.add_argument("--film-back-width", type=float, default=36.0)
        p.add_argument("--film-back-height", type=float, default=24.0)
        p.add_argument("--output", default=None)

    p = sub.add_parser(
        "relative-pose",
        help="two-view relative pose from shared markers",
    )
    add_two_frame_args(p)

    p = sub.add_parser(
        "homography", help="homography between two frames' markers"
    )
    add_two_frame_args(p)

    p = sub.add_parser(
        "pose-from-points",
        help="camera pose from known 3D points at a frame",
    )
    p.add_argument("--markers", required=True)
    p.add_argument("--points", required=True,
                   help="JSON (P, 3) array or camera-solve output")
    p.add_argument("--points-convention", choices=["maya", "cv"],
                   default="maya",
                   help="frame of the 3D points: 'maya' (y up, z toward"
                        " viewer — what camera-solve writes; default) or"
                        " 'cv' (y down, z forward)")
    p.add_argument("--frame", type=int, required=True)
    p.add_argument("--image-width", type=int, default=1920)
    p.add_argument("--image-height", type=int, default=1080)
    p.add_argument("--focal-length", type=float, default=35.0)
    p.add_argument("--film-back-width", type=float, default=36.0)
    p.add_argument("--film-back-height", type=float, default=24.0)
    p.add_argument("--output", default=None)

    p = sub.add_parser(
        "calibrate",
        help="vanishing-point camera calibration",
    )
    p.add_argument("--origin-point", type=float, nargs=2, required=True,
                   metavar=("X", "Y"))
    p.add_argument("--principal-point", type=float, nargs=2,
                   default=(0.0, 0.0), metavar=("X", "Y"))
    p.add_argument("--vanishing-point-a", type=float, nargs=2,
                   required=True, metavar=("X", "Y"))
    p.add_argument("--vanishing-point-b", type=float, nargs=2,
                   default=None, metavar=("X", "Y"))
    p.add_argument("--horizon", type=float, nargs=4, default=None,
                   metavar=("AX", "AY", "BX", "BY"),
                   help="horizon line points for one-VP mode")
    p.add_argument("--focal-length", type=float, default=35.0)
    p.add_argument("--film-back-width", type=float, default=36.0)
    p.add_argument("--film-back-height", type=float, default=24.0)
    p.add_argument("--scene-scale-mode", type=int, default=0)
    p.add_argument("--scene-scale-distance", type=float, default=1.0)
    p.add_argument("--output", default=None)

    p = sub.add_parser("image-info",
                       help="query image width/height/pixel")
    p.add_argument("path")
    p.add_argument("--pixel", type=int, nargs=2, default=None,
                   metavar=("X", "Y"))

    p = sub.add_parser("image-convert",
                       help="convert/resize an image file")
    p.add_argument("input")
    p.add_argument("output")
    p.add_argument("--scale", type=float, default=1.0)

    p = sub.add_parser("image-warp",
                       help="warp an image through a lens or ST map")
    p.add_argument("input")
    p.add_argument("--output", required=True)
    p.add_argument("--stmap", default=None,
                   help="ST-map image (e.g. from the lensdistort "
                        "verb); omit to warp through a lens model")
    p.add_argument("--direction", choices=["distort", "undistort"],
                   default="distort")
    p.add_argument("--distortion", type=float, default=0.0)
    p.add_argument("--anamorphic-squeeze", type=float, default=1.0)
    p.add_argument("--curvature-x", type=float, default=0.0)
    p.add_argument("--curvature-y", type=float, default=0.0)
    p.add_argument("--quartic-distortion", type=float, default=0.0)
    p.add_argument("--film-back-width", type=float, default=36.0)
    p.add_argument("--film-back-height", type=float, default=24.0)

    args = parser.parse_args(argv)
    if args.command == "formats":
        return _cmd_formats(args)
    if args.command == "camera-solve":
        return _cmd_camera_solve(args)
    if args.command == "solve":
        return _cmd_solve(args)
    if args.command == "affects":
        return _cmd_affects(args)
    if args.command == "validate":
        return _cmd_validate(args)
    if args.command == "camera-matrix":
        return _cmd_camera_matrix(args)
    if args.command == "lensdistort":
        return _cmd_lensdistort(args)
    if args.command == "reproject":
        return _cmd_reproject(args)
    if args.command == "image-info":
        return _cmd_image_info(args)
    if args.command == "image-warp":
        return _cmd_image_warp(args)
    if args.command == "image-convert":
        return _cmd_image_convert(args)
    if args.command == "solver-types":
        return _cmd_solver_types(args)
    if args.command == "relative-pose":
        return _cmd_relative_pose(args)
    if args.command == "homography":
        return _cmd_homography(args)
    if args.command == "pose-from-points":
        return _cmd_pose_from_points(args)
    if args.command == "calibrate":
        return _cmd_calibrate(args)
    parser.error("unknown command")


if __name__ == "__main__":
    sys.exit(main())
