"""End-to-end smoke test of the solver on an NVIDIA GPU.

Drives the main paths once, at the sizes of real shots, through the
entry points a user calls.  Everything runs in this one process: a JAX
process reserves most of the card's memory when it starts, so a second
one (a CLI subprocess, say) would fail for want of it.

Phases (one card, the default):
  0. the device: a GPU, or exit non-zero (there is no CPU fallback);
  1. solve() on the Schur BA path: 1,000 frames x 300 bundles on a
     1920x1080 plate, animated camera, static focal and 3DE classic
     distortion solved in the arrowhead border;
  2. the Schur BA on the GPU in float32 against the plain reference —
     the dense LM in float64 on the CPU backend at "highest" matmul
     precision — on a 100-frame, 40-bundle shot;
  3. solve_per_frame(): 6-DoF pose over all 1,000 frames of shot 1;
  4. solve_ba() at production scale: 1024 frames x 2048 bundles with a
     focal + distortion border and the CG linear solver;
  5. the CLI in process: camera-solve, then solve --solver-type
     ba_schur, on a uvtrack file of a 200-frame, 60-track subset of
     shot 1;
  6. stmap() at DCI 4K for the four 3DE models in both directions
     against stmap_xla in float64 on the CPU, and lensdistort writing
     one 4K EXR.

`--four-cards` runs only the frame-sharded BA (solver type
ba_schur_sharded) over a 4-card mesh and its comparison with the
one-card Schur BA.

    python chip_smoke.py [--seed N] [--four-cards]

The last line of standard output is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}};
any failed check raises before it.
"""

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

import bench

# ---------------------------------------------------------------------------
# Bounds.  Synthetic shots have exact observations, so every solve can
# reach ~0 px; the bounds leave room only for float32 round-off on the
# card and for the iteration budget.

# Phase 1 / 4-card: final RMS after 25 LM iterations.  Float32
# projections of a 1920 px plate carry ~1e-4 px of round-off; the
# bound is two orders above that and far below the sub-pixel error a
# matchmove is judged by.
SHOT_RMS_PX = 0.05
# Border recovery from a start 1.5 mm and 0.04 off: focal is coupled to
# camera depth (the dolly-zoom direction) and settles last.
FOCAL_TOL_MM = 0.25
DISTORTION_TOL = 2e-3

# Phase 2: GPU float32 Schur BA vs the CPU float64 dense LM.  Both
# start from the same point and minimise the same cost; they differ in
# dtype (float32 vs float64), in the linear solver (Schur + CG vs dense
# Cholesky) and in the order of the GPU's scatter-adds.  Float32 keeps
# ~1e-7 relative; the BA's conditioning (focal against camera depth)
# magnifies that by 1e2-1e3 in the solved values, and the bounds sit
# above that.
AGREE_RMS_PX = 1e-3
AGREE_FOCAL_MM = 1e-2
AGREE_DISTORTION = 1e-4
# Camera and bundle positions (scene units) and camera orientations
# (degrees) are compared after a similarity alignment: the BA gauge (a
# similarity transform of cameras and bundles that leaves every
# reprojection unchanged) is fixed only by the common start, and the
# two solvers drift along it differently (by ~0.05 units here).
AGREE_TRANSLATE = 2e-4
AGREE_ROTATE_DEG = 2e-3

# Phase 3: per-frame pose recovery from a start ~0.3 units / 1.5 deg
# off, with bundles, focal and lens at their true values.
POSE_TRANSLATE = 1e-3
POSE_ROTATE_DEG = 1e-2
POSE_RMS_PX = 1e-2

# Phase 4: production-scale solve_ba from a 0.5 mm / 0.02 border start.
PRODUCTION_COST_REDUCTION = 1e3

# Phase 5: the CLI solve on a clean uvtrack file.
CLI_RMS_PX = 0.05

# Phase 6: ST maps in unit coordinates, 2e-5 = 0.08 px at 4096 px —
# float32 evaluation of the lens polynomial and its fixed-point inverse
# against float64.
STMAP_TOL = 2e-5

DCI_4K = (4096, 2160)

_POSE = ("tx", "ty", "tz", "rx", "ry", "rz")


class Context:
    """What the phases share: the seed, the card label and the shot of
    phase 1."""

    def __init__(self, seed, card):
        self.seed = seed
        self.card = card
        self.shot = None


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=7,
                        help="seed of the synthetic shots")
    parser.add_argument("--four-cards", action="store_true",
                        help="run only the frame-sharded BA over 4 "
                             "cards and its one-card comparison")
    return parser.parse_args(argv)


def check_device(devices, count=None):
    """The first device must be a GPU (and, when `count` is given,
    there must be exactly that many).  Returns the device summary of
    the last output line."""
    dev = devices[0]
    if dev.platform != "gpu":
        raise RuntimeError(
            "chip_smoke needs a GPU; JAX found %r (%s)"
            % (dev.platform, dev.device_kind)
        )
    if count is not None and len(devices) != count:
        raise RuntimeError(
            "expected %d GPUs, JAX found %d" % (count, len(devices))
        )
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(devices)}


def card_label():
    """Name and power limit of the card(s), as nvidia-smi reports
    them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    return out


def _first_card(label):
    return label.splitlines()[0].strip()


def _timing(ctx, text):
    print("%s  [%s]" % (text, _first_card(ctx.card)), flush=True)


def _check(cond, message):
    if not cond:
        raise AssertionError(message)


def _static(attrs, attr):
    return float(np.asarray(attrs.static_values)[attr.code // 2])


def _shot(num_frames, num_bundles, seed, dtype=np.float32):
    """The synthetic shot of phases 1-3 (and the 4-card phase): truth
    attrs plus the lens+focal start."""
    scene, attrs, sg, cam, bundles, lens = bench._synthetic_tracked_scene(
        num_frames, num_bundles, lens_distortion=0.1, seed=seed,
        dtype=dtype,
    )
    return dict(
        scene=scene, truth=attrs, start=bench._perturb_lens_focal(attrs,
                                                                   cam),
        cam=cam, bundles=bundles, lens=lens,
        solve_attrs=bench._lens_focal_solve_attrs(cam, bundles),
        num_frames=num_frames,
    )


def _timed_solve(shot, options):
    from mayamatchmovesolver_tpu.solver import solve

    t0 = time.perf_counter()
    attrs, result = solve(
        shot["scene"], shot["start"], np.arange(shot["num_frames"]),
        shot["solve_attrs"], options, lens=shot["lens"],
    )
    return attrs, result, time.perf_counter() - t0


def _check_border(attrs, shot, label):
    focal = _static(attrs, shot["cam"].attr("focal_length_mm"))
    dist = _static(attrs, shot["cam"].attr("lens_distortion"))
    _check(abs(focal - 35.0) < FOCAL_TOL_MM,
           "%s: focal %.4f not within %g of 35" % (label, focal,
                                                   FOCAL_TOL_MM))
    _check(abs(dist - 0.1) < DISTORTION_TOL,
           "%s: distortion %.5f not within %g of 0.1"
           % (label, dist, DISTORTION_TOL))
    return focal, dist


# ---------------------------------------------------------------------------
# Phases.


def phase_product_ba(ctx, num_frames=1000, num_bundles=300,
                     iterations=25):
    """Phase 1: solve() on the Schur BA path at shot size."""
    from mayamatchmovesolver_tpu.solver import SolverOptions, registry

    t0 = time.perf_counter()
    shot = _shot(num_frames, num_bundles, ctx.seed)
    ctx.shot = shot
    _timing(ctx, "phase 1: synthesised %d frames x %d bundles in %.2f s"
            % (num_frames, num_bundles, time.perf_counter() - t0))
    options = SolverOptions(
        iterations=iterations, image_width=1920.0,
        accept_only_better=False,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
    )
    _, _, first_s = _timed_solve(shot, options)
    attrs, result, warm_s = _timed_solve(shot, options)
    _check(result.solver_type_name == "ba_schur",
           "phase 1 left the Schur path: %s (%s)"
           % (result.solver_type_name, result.reason_string))
    _check(result.error_final < SHOT_RMS_PX,
           "phase 1: error_final %g px >= %g"
           % (result.error_final, SHOT_RMS_PX))
    focal, dist = _check_border(attrs, shot, "phase 1")
    _timing(ctx, "phase 1: solve() ba_schur first %.3f s, warm %.3f s, "
            "%d iterations, %.2f LM it/s; error %.4g -> %.4g px; "
            "focal %.4f, distortion %.5f"
            % (first_s, warm_s, result.iterations,
               result.iterations / warm_s, result.error_initial,
               result.error_final, focal, dist))


def _similarity(a, b):
    """Scale, rotation and shift (s, q, d) minimising |s q a + d - b|
    over rows of (N, 3) point sets (Umeyama 1991)."""
    mu_a, mu_b = a.mean(0), b.mean(0)
    a0, b0 = a - mu_a, b - mu_b
    u, sig, vt = np.linalg.svd(b0.T @ a0 / len(a))
    flip = np.eye(3)
    flip[2, 2] = np.sign(np.linalg.det(u) * np.linalg.det(vt))
    q = u @ flip @ vt
    s = np.trace(np.diag(sig) @ flip) / np.mean(np.sum(a0 * a0, 1))
    return s, q, mu_b - s * q @ mu_a


def _gauge_aligned_difference(shot, attrs_a, attrs_b):
    """Differences between two solutions of one shot once the BA gauge
    is removed: returns (raw position drift, aligned position
    difference, aligned camera orientation difference in degrees)."""
    import jax

    from mayamatchmovesolver_tpu.core.transform import (
        euler_to_rotation_matrix,
    )

    cam = shot["cam"]
    frames = np.arange(shot["num_frames"])

    def unpack(attrs):
        anim = np.asarray(attrs.anim_values, np.float64)
        static = np.asarray(attrs.static_values, np.float64)
        pose = [anim[cam.attr(c).code // 2, frames] for c in _POSE]
        bundles = np.array([[static[b.attr(c).code // 2]
                             for c in ("tx", "ty", "tz")]
                            for b in shot["bundles"]])
        points = np.concatenate([bundles, np.stack(pose[:3], -1)])
        with jax.enable_x64(True), \
                jax.default_device(jax.devices("cpu")[0]):
            rot = np.asarray(euler_to_rotation_matrix(*pose[3:], 0))
        return points, rot

    pts_a, rot_a = unpack(attrs_a)
    pts_b, rot_b = unpack(attrs_b)
    s, q, d = _similarity(pts_a, pts_b)
    aligned = s * pts_a @ q.T + d
    # A world similarity turns camera orientations R into q R.  For
    # rotations |A - B|_F = 2 sqrt(2) sin(angle / 2), which stays
    # accurate at small angles where the trace formula does not.
    chord = np.linalg.norm(q @ rot_a - rot_b, axis=(1, 2))
    angle = 2.0 * np.arcsin(np.minimum(chord / (2.0 * np.sqrt(2.0)), 1))
    return (float(np.max(np.abs(pts_a - pts_b))),
            float(np.max(np.abs(aligned - pts_b))),
            float(np.degrees(np.max(angle))))


def phase_reference_agreement(ctx, num_frames=100, num_bundles=40,
                              iterations=25):
    """Phase 2: GPU float32 Schur BA vs the CPU float64 dense LM."""
    import jax

    from mayamatchmovesolver_tpu.solver import SolverOptions, registry

    def run(solver_type, dtype):
        shot = _shot(num_frames, num_bundles, ctx.seed, dtype=dtype)
        options = SolverOptions(
            iterations=iterations, image_width=1920.0,
            accept_only_better=False, solver_type=solver_type,
        )
        attrs, result, seconds = _timed_solve(shot, options)
        return shot, jax.device_get(attrs), result, seconds

    shot, attrs_gpu, res_gpu, gpu_s = run(
        registry.SOLVER_TYPE_BA_SCHUR, np.float32
    )
    _check(res_gpu.solver_type_name == "ba_schur",
           "phase 2 left the Schur path: %s" % res_gpu.reason_string)
    with jax.enable_x64(True), \
            jax.default_device(jax.devices("cpu")[0]), \
            jax.default_matmul_precision("highest"):
        ref_shot, attrs_ref, res_ref, ref_s = run(
            registry.SOLVER_TYPE_LM_DENSE, np.float64
        )
    _check(res_ref.solver_type_name == "lm_jax",
           "phase 2 reference is not the dense LM")

    cam = shot["cam"]
    gauge, d_translate, d_rotate = _gauge_aligned_difference(
        shot, attrs_gpu, attrs_ref
    )
    d_focal = abs(_static(attrs_gpu, cam.attr("focal_length_mm"))
                  - _static(attrs_ref, cam.attr("focal_length_mm")))
    d_dist = abs(_static(attrs_gpu, cam.attr("lens_distortion"))
                 - _static(attrs_ref, cam.attr("lens_distortion")))
    d_rms = abs(res_gpu.error_final - res_ref.error_final)
    print("phase 2: gauge drift %.3g; after alignment |d| translate "
          "%.3g, rotate %.3g deg; focal %.3g mm, distortion %.3g, rms "
          "%.3g px (gpu %.4g, ref %.4g)"
          % (gauge, d_translate, d_rotate, d_focal, d_dist, d_rms,
             res_gpu.error_final, res_ref.error_final), flush=True)
    for name, value, bound in (
        ("translate", d_translate, AGREE_TRANSLATE),
        ("rotate", d_rotate, AGREE_ROTATE_DEG),
        ("focal", d_focal, AGREE_FOCAL_MM),
        ("distortion", d_dist, AGREE_DISTORTION),
        ("rms", d_rms, AGREE_RMS_PX),
    ):
        _check(value <= bound, "phase 2: %s differs by %g > %g"
               % (name, value, bound))
    _timing(ctx, "phase 2: gpu ba_schur f32 %.3f s vs cpu dense LM f64 "
            "%.3f s, agreement within bounds" % (gpu_s, ref_s))


def phase_pose_sweep(ctx, iterations=20):
    """Phase 3: solve_per_frame over every frame of the phase-1 shot."""
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu.solver import (
        SolverOptions,
        solve_per_frame,
    )

    shot = ctx.shot
    cam = shot["cam"]
    truth = shot["truth"]
    anim = np.array(truth.anim_values)
    for ch, delta in [("tx", 0.2), ("ty", -0.15), ("tz", 0.3),
                      ("rx", 1.0), ("ry", -1.5), ("rz", 0.5)]:
        anim[cam.attr(ch).code // 2] += delta
    start = truth._replace(anim_values=jnp.asarray(anim))
    pose_attrs = [cam.attr(c) for c in _POSE]
    frames = np.arange(shot["num_frames"])
    # eps=0: every frame runs all iterations, so it/s counts real work.
    options = SolverOptions(iterations=iterations, image_width=1920.0,
                            accept_only_better=False,
                            eps1=0.0, eps2=0.0, eps3=0.0)

    def run():
        t0 = time.perf_counter()
        attrs, result = solve_per_frame(
            shot["scene"], start, frames, pose_attrs, options,
            lens=shot["lens"],
        )
        return attrs, result, time.perf_counter() - t0

    _, _, first_s = run()
    attrs, result, warm_s = run()
    solved = np.asarray(attrs.anim_values)
    true_anim = np.asarray(truth.anim_values)
    err_t = max(np.max(np.abs(solved[cam.attr(c).code // 2]
                              - true_anim[cam.attr(c).code // 2]))
                for c in _POSE[:3])
    err_r = max(np.max(np.abs(solved[cam.attr(c).code // 2]
                              - true_anim[cam.attr(c).code // 2]))
                for c in _POSE[3:])
    _check(err_t < POSE_TRANSLATE and err_r < POSE_ROTATE_DEG,
           "phase 3: pose not recovered (translate %g, rotate %g deg)"
           % (err_t, err_r))
    _check(result.error_final < POSE_RMS_PX,
           "phase 3: error_final %g px" % result.error_final)
    its = result.iterations * len(frames) / warm_s
    _timing(ctx, "phase 3: solve_per_frame %d frames first %.3f s, warm "
            "%.3f s, %.1f LM it/s; |pose error| %.3g / %.3g deg; "
            "error %.4g -> %.4g px"
            % (len(frames), first_s, warm_s, its, err_t, err_r,
               result.error_initial, result.error_final))


def phase_production_ba(ctx, num_frames=1024, num_bundles=2048,
                        iterations=10, cg_iterations=30):
    """Phase 4: solve_ba() at production scale with the CG solver."""
    import jax

    from mayamatchmovesolver_tpu.solver import ba

    problem, (true_focal, true_dist) = bench._production_ba_problem(
        num_frames, num_bundles, seed=ctx.seed
    )
    solve = jax.jit(
        lambda p: ba.solve_ba(p, max_iterations=iterations,
                              linear_solver="cg",
                              cg_iterations=cg_iterations)
    )

    def run():
        t0 = time.perf_counter()
        result = jax.device_get(solve(problem))
        return result, time.perf_counter() - t0

    _, first_s = run()
    result, warm_s = run()
    focal, dist = (float(v) for v in result.shared_params)
    reduction = float(result.cost_initial) / max(float(result.cost),
                                                 1e-30)
    _check(reduction > PRODUCTION_COST_REDUCTION,
           "phase 4: cost reduction %g" % reduction)
    _check(abs(focal - true_focal) < FOCAL_TOL_MM,
           "phase 4: focal %.4f" % focal)
    _check(abs(dist - true_dist) < DISTORTION_TOL,
           "phase 4: distortion %.5f" % dist)
    _timing(ctx, "phase 4: solve_ba %d x %d first %.3f s, warm %.3f s, "
            "%d iterations, %.2f LM it/s; cost / %.3g; focal %.4f, "
            "distortion %.5f"
            % (num_frames, num_bundles, first_s, warm_s,
               int(result.iterations), int(result.iterations) / warm_s,
               reduction, focal, dist))


def _write_uvtrack(path, shot, num_frames, num_tracks, rng):
    """uvtrack v4 of the shot's undistorted tracks for the first
    frames and bundles, with 3D bundle positions perturbed off the
    truth."""
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu.scene import flatscene

    scene, truth = shot["scene"], shot["truth"]
    frames = jnp.arange(num_frames)
    point_xy = np.asarray(
        flatscene.evaluate_jit(scene, truth, frames).point_xy
    )
    fsx, fsy = (np.asarray(s) for s in
                flatscene.marker_fit_scale(scene, truth, frames))
    uv = np.stack([point_xy[..., 0] / fsx, point_xy[..., 1] / fsy],
                  axis=-1) + 0.5
    static = np.asarray(truth.static_values, np.float64)
    points = []
    for i in range(num_tracks):
        b = shot["bundles"][i]
        xyz = [static[b.attr(c).code // 2] for c in ("tx", "ty", "tz")]
        xyz = np.asarray(xyz) + rng.normal(0.0, 0.05, 3)
        points.append({
            "name": "m%d" % i, "id": i, "set_name": "smoke",
            "per_frame": [
                {"frame": f + 1, "pos": uv[i, f].tolist(),
                 "pos_dist": uv[i, f].tolist(), "weight": 1.0}
                for f in range(num_frames)
            ],
            "3d": {"x": xyz[0], "y": xyz[1], "z": xyz[2],
                   "x_lock": False, "y_lock": False, "z_lock": False},
        })
    with open(path, "w") as f:
        json.dump({"version": 4, "points": points}, f)


def _run_cli(argv):
    from mayamatchmovesolver_tpu import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue(), time.perf_counter() - t0


def phase_cli(ctx, num_frames=200, num_tracks=60, iterations=40):
    """Phase 5: camera-solve and solve --solver-type ba_schur."""
    shot = ctx.shot
    cam = shot["cam"]
    rng = np.random.RandomState(ctx.seed)
    with tempfile.TemporaryDirectory() as tmp:
        uv_path = os.path.join(tmp, "shot.uv")
        _write_uvtrack(uv_path, shot, num_frames, num_tracks, rng)

        rc, out, cs_s = _run_cli([
            "camera-solve", "--markers", uv_path,
            "--output", os.path.join(tmp, "sfm.json"),
        ])
        _check(rc == 0, "phase 5: camera-solve exit %r\n%s" % (rc, out))
        with open(os.path.join(tmp, "sfm.json")) as f:
            sfm = json.load(f)
        n_solved = int(np.sum(sfm["camera"]["frame_solved"]))
        n_points = int(np.sum(sfm["points"]["valid"]))
        _check(n_solved >= num_frames // 2 and n_points >= 8,
               "phase 5: camera-solve solved %d frames, %d points"
               % (n_solved, n_points))

        # Initial camera: the truth moved like the lens+focal start.
        anim = np.asarray(shot["truth"].anim_values, np.float64)
        init = {c: anim[cam.attr(c).code // 2, :num_frames].tolist()
                for c in _POSE}
        init["tx"] = [v + 0.1 for v in init["tx"]]
        init["ry"] = [v - 0.8 for v in init["ry"]]
        init_path = os.path.join(tmp, "init.json")
        with open(init_path, "w") as f:
            json.dump({"camera": init}, f)
        rc, out, solve_s = _run_cli([
            "solve", "--markers", uv_path, "--camera", init_path,
            "--iterations", str(iterations),
            "--solver-type", "ba_schur",
            "--output", os.path.join(tmp, "solved.json"),
        ])
    lines = dict(line.split("=", 1) for line in out.splitlines()
                 if "=" in line and not line.startswith("error_per"))
    _check(rc == 0 and lines.get("success") == "1",
           "phase 5: solve failed (rc %r)\n%s" % (rc, out[:2000]))
    _check(lines.get("solver_type") == "ba_schur",
           "phase 5: solve left the Schur path: %s"
           % lines.get("reason_string"))
    error_final = float(lines["error_final"])
    _check(error_final < CLI_RMS_PX,
           "phase 5: error_final %g px" % error_final)
    _timing(ctx, "phase 5: cli camera-solve %.3f s (%d frames, %d "
            "points); cli solve ba_schur %.3f s, error_final %.4g px"
            % (cs_s, n_solved, n_points, solve_s, error_final))


def _stmap_models(models):
    return [
        ("classic", models.TdeClassic.create(
            distortion=0.15, anamorphic_squeeze=1.05,
            curvature_x=0.02, curvature_y=-0.01,
            quartic_distortion=0.03)),
        ("radial_deg4", models.TdeRadialStdDeg4.create(
            degree2_distortion=0.12, degree2_u=0.01, degree2_v=-0.02,
            degree4_distortion=0.04, degree4_u=-0.005,
            degree4_v=0.008, cylindric_direction=25.0,
            cylindric_bending=0.1)),
        ("anamorphic_deg4", models.TdeAnamorphicStdDeg4.create(
            degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
            degree2_cy22=-0.01, degree4_cx04=0.01, degree4_cy04=-0.005,
            degree4_cx24=0.004, degree4_cy24=0.002,
            degree4_cx44=-0.003, degree4_cy44=0.001,
            lens_rotation=4.0, squeeze_x=1.1, squeeze_y=0.95)),
        ("anamorphic_deg4_rescaled",
         models.TdeAnamorphicStdDeg4Rescaled.create(
             degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
             degree2_cy22=-0.01, degree4_cx04=0.01,
             degree4_cy04=-0.005, lens_rotation=-3.0, squeeze_x=1.05,
             squeeze_y=1.0, rescale=1.1)),
    ]


def _film_back(models):
    return models.FilmBack.create(width_cm=3.6, height_cm=2.4,
                                  offset_x_cm=0.05, offset_y_cm=-0.02)


def phase_stmap(ctx, size=DCI_4K, repeats=5):
    """Phase 6: stmap() for every 3DE model and direction, and the
    lensdistort CLI writing one EXR."""
    import jax
    import jax.numpy as jnp

    from mayamatchmovesolver_tpu import models
    from mayamatchmovesolver_tpu.io import exr
    from mayamatchmovesolver_tpu.ops import stmap as stmap_mod

    width, height = size
    fb = _film_back(models)
    with jax.enable_x64(True), \
            jax.default_device(jax.devices("cpu")[0]):
        fb64 = _film_back(models)
        ref_models = dict(_stmap_models(models))
    worst = 0.0
    run_s = 0.0
    n_maps = 0
    for name, model in _stmap_models(models):
        for direction in ("distort", "undistort"):
            out = jax.block_until_ready(
                stmap_mod.stmap(model, fb, width, height, direction)
            )
            t0 = time.perf_counter()
            for _ in range(repeats):
                out = jax.block_until_ready(
                    stmap_mod.stmap(model, fb, width, height, direction)
                )
            run_s += time.perf_counter() - t0
            n_maps += repeats
            out = np.asarray(out)
            with jax.enable_x64(True), \
                    jax.default_device(jax.devices("cpu")[0]):
                ref = np.asarray(stmap_mod.stmap_xla(
                    ref_models[name], fb64, width, height, direction,
                    dtype=jnp.float64,
                ))
            _check(out.shape == (height, width, 4),
                   "phase 6: %s shape %r" % (name, out.shape))
            diff = float(np.max(np.abs(out[..., :2] - ref[..., :2])))
            _check(np.isfinite(diff) and diff <= STMAP_TOL,
                   "phase 6: %s/%s differs from float64 by %g > %g"
                   % (name, direction, diff, STMAP_TOL))
            worst = max(worst, diff)

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "st.exr")
        rc, out_text, cli_s = _run_cli([
            "lensdistort", "--model", "tde_classic",
            "--distortion", "0.1", "--curvature-x", "0.02",
            "--width", str(width), "--height", str(height),
            "--output", path,
        ])
        _check(rc == 0, "phase 6: lensdistort exit %r" % rc)
        img, _ = exr.read_pixels(path)
    _check(img.shape == (height, width, 4) and np.all(np.isfinite(img)),
           "phase 6: lensdistort wrote %r" % (img.shape,))
    _timing(ctx, "phase 6: stmap %dx%d, 4 models x 2 directions: %.2f "
            "maps/s; max |d| vs float64 %.3g; lensdistort with EXR "
            "write %.3f s" % (width, height, n_maps / run_s, worst,
                              cli_s))


def _peak_bytes(devices):
    """Peak device memory each card's arrays took so far."""
    return [d.memory_stats()["peak_bytes_in_use"] for d in devices]


def phase_four_cards(ctx, num_frames=1024, num_bundles=300,
                     iterations=25):
    """Frame-sharded BA over the 4-card mesh against the one-card Schur
    BA on the same shot."""
    import jax

    from mayamatchmovesolver_tpu.parallel import ba_sharded, make_frame_mesh
    from mayamatchmovesolver_tpu.solver import SolverOptions, registry
    from mayamatchmovesolver_tpu.solver import ba_bridge

    devices = jax.devices()
    shot = _shot(num_frames, num_bundles, ctx.seed)

    def options(solver_type):
        return SolverOptions(iterations=iterations, image_width=1920.0,
                             accept_only_better=False,
                             solver_type=solver_type)

    sharded_opts = options(registry.SOLVER_TYPE_BA_SHARDED)
    _, _, first_s = _timed_solve(shot, sharded_opts)
    attrs_s, res_s, warm_s = _timed_solve(shot, sharded_opts)
    peaks = _peak_bytes(devices)

    # Placement: the frame axis is split over every card.
    bridge, reason = ba_bridge.build_ba_bridge(
        shot["scene"], shot["start"], np.arange(num_frames),
        shot["solve_attrs"], sharded_opts, lens=shot["lens"],
    )
    _check(bridge is not None, "4 cards: not a BA shot: %s" % reason)
    placed = ba_sharded.shard_ba_problem(bridge.problem,
                                         make_frame_mesh(devices))
    uv = placed.marker_uv
    shard_devices = {s.device for s in uv.addressable_shards}
    _check(uv.sharding.device_set == set(devices)
           and shard_devices == set(devices)
           and all(s.data.shape[1] == num_frames // len(devices)
                   for s in uv.addressable_shards),
           "4 cards: observations are not split over every card")
    _check(min(peaks) > 0.25 * max(peaks),
           "4 cards: work not spread, peak bytes %r" % (peaks,))

    attrs_1, res_1, one_s = _timed_solve(
        shot, options(registry.SOLVER_TYPE_BA_SCHUR)
    )
    _check(res_1.solver_type_name == "ba_schur",
           "4 cards: one-card solve left the Schur path")
    for label, attrs, res in (("sharded", attrs_s, res_s),
                              ("one card", attrs_1, res_1)):
        _check(res.error_final < SHOT_RMS_PX,
               "4 cards: %s error_final %g" % (label, res.error_final))
        _check_border(attrs, shot, "4 cards " + label)
    cam = shot["cam"]
    d_focal = abs(_static(attrs_s, cam.attr("focal_length_mm"))
                  - _static(attrs_1, cam.attr("focal_length_mm")))
    d_dist = abs(_static(attrs_s, cam.attr("lens_distortion"))
                 - _static(attrs_1, cam.attr("lens_distortion")))
    d_rms = abs(res_s.error_final - res_1.error_final)
    _check(d_focal <= AGREE_FOCAL_MM and d_dist <= AGREE_DISTORTION
           and d_rms <= AGREE_RMS_PX,
           "4 cards: sharded vs one card differ: focal %g, distortion "
           "%g, rms %g" % (d_focal, d_dist, d_rms))
    _timing(ctx, "4 cards: ba_schur_sharded %d x %d first %.3f s, warm "
            "%.3f s, %.2f LM it/s, error %.4g px; one card ba_schur "
            "%.3f s, error %.4g px; |d| focal %.3g, distortion %.3g; "
            "peak bytes per card %s"
            % (num_frames, num_bundles, first_s, warm_s,
               res_s.iterations / warm_s, res_s.error_final, one_s,
               res_1.error_final, d_focal, d_dist, peaks))


ONE_CARD_PHASES = (phase_product_ba, phase_reference_agreement,
                   phase_pose_sweep, phase_production_ba, phase_cli,
                   phase_stmap)


def selected_phases(args):
    if args.four_cards:
        return (phase_four_cards,)
    return ONE_CARD_PHASES


def main(argv=None):
    args = parse_args(argv)
    import jax

    from mayamatchmovesolver_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    device = check_device(jax.devices(), 4 if args.four_cards else None)
    card = card_label()
    print(card, flush=True)
    print("phase 0: %s x %d" % (device["kind"], device["count"]),
          flush=True)
    ctx = Context(args.seed, card)
    t0 = time.perf_counter()
    for phase in selected_phases(args):
        phase(ctx)
    _timing(ctx, "all phases %.1f s" % (time.perf_counter() - t0))
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
