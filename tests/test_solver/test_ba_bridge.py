"""The SolveProblem -> BAProblem bridge: the structured Schur BA behind
the product solve surface.

Backend-agreement oracle, like the reference's one-command dispatch
over every registered solver on the same scene
(ref: src/mmSolver/adjust/adjust_base.cpp:80-127,713 and the solver-type
matrix in tests/test/test_solver/test1.py:124-158): requesting
SOLVER_TYPE_BA_SCHUR through solve()/api.execute must produce the same
answer as the dense LM, and requests outside the BA shape must fall
back to dense with the reason reported."""

import jax.numpy as jnp
import numpy as np
import pytest

import mayamatchmovesolver_tpu.api as mmapi
from mayamatchmovesolver_tpu.models import scenelens
from mayamatchmovesolver_tpu.scene import evaluate
from mayamatchmovesolver_tpu.scene.flatscene import (
    set_marker_screen_positions,
)
from mayamatchmovesolver_tpu.solver import registry
from mayamatchmovesolver_tpu.solver.solve import SolverOptions, solve

NUM_FRAMES = 16
NUM_BUNDLES = 8


def _tracked_scene(lens_distortion=None, seed=7):
    """Animated camera + static bundles + markers tracking the exact
    projections; returns (sg, cam, bundles, scene, attrs, lens)."""
    rng = np.random.RandomState(seed)
    sg = mmapi.SceneGraph(frame_range=(1, NUM_FRAMES))
    cam = sg.create_camera(
        "cam",
        tx=np.linspace(-2, 2, NUM_FRAMES),
        ty=1.0 + 0.2 * np.sin(np.linspace(0, 3, NUM_FRAMES)),
        tz=10.0 + np.linspace(0, 1, NUM_FRAMES),
        rx=np.linspace(-1, 1, NUM_FRAMES),
        ry=np.linspace(-6, 6, NUM_FRAMES),
        rz=np.zeros(NUM_FRAMES),
        focal_length_mm=35.0,
        render_width=1920,
        render_height=1080,
    )
    lens = None
    if lens_distortion is not None:
        scenelens.attach_lens(
            sg, cam, scenelens.LENS_MODEL_CLASSIC,
            distortion=lens_distortion,
        )
        lens = scenelens.bake_scene_lens(sg)
    bundles = [
        sg.create_bundle(
            "b%d" % i,
            tx=rng.uniform(-4, 4),
            ty=rng.uniform(-2, 2),
            tz=rng.uniform(-8, -3),
        )
        for i in range(NUM_BUNDLES)
    ]
    for i, b in enumerate(bundles):
        sg.create_marker(
            "m%d" % i, camera=cam, bundle=b,
            tx=np.zeros(NUM_FRAMES), ty=np.zeros(NUM_FRAMES),
        )
    scene, attrs = sg.bake()
    fi = jnp.arange(NUM_FRAMES)
    ev = evaluate(scene, attrs, fi)
    point_xy = ev.point_xy
    if lens is not None:
        point_xy = scenelens.apply_scene_lens(
            lens, scene, attrs, fi, point_xy, scene.mkr_cam_index,
            direction="distort",
        )
    attrs = set_marker_screen_positions(scene, attrs, fi, point_xy)
    return sg, cam, bundles, scene, attrs, lens


def _perturb(attrs, cam, bundles, rng, pose=0.05, bnd=0.05):
    anim = np.array(attrs.anim_values)
    static = np.array(attrs.static_values)
    for ch in ("tx", "ty", "tz", "rx", "ry", "rz"):
        anim[cam.attr(ch).code // 2] += rng.normal(
            0, pose, anim.shape[1]
        )
    for b in bundles:
        for ch in ("tx", "ty", "tz"):
            static[b.attr(ch).code // 2] += rng.normal(0, bnd)
    return attrs._replace(
        anim_values=jnp.asarray(anim), static_values=jnp.asarray(static)
    )


def _pose_and_bundle_attrs(cam, bundles):
    attrs = [cam.attr(c) for c in ("tx", "ty", "tz", "rx", "ry", "rz")]
    for b in bundles:
        attrs += [b.attr(c) for c in ("tx", "ty", "tz")]
    return attrs


def test_bridge_matches_dense_backend():
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    attrs = _perturb(attrs0, cam, bundles, np.random.RandomState(0))
    solve_attrs = _pose_and_bundle_attrs(cam, bundles)
    frames = np.arange(NUM_FRAMES)

    opts_ba = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
    )
    attrs_ba, res_ba = solve(scene, attrs, frames, solve_attrs, opts_ba)
    assert res_ba.solver_type_name == "ba_schur", res_ba.reason_string
    assert res_ba.success
    assert res_ba.error_final < 1e-4, res_ba.error_final

    opts_dense = SolverOptions(iterations=30, image_width=1920.0)
    attrs_d, res_d = solve(scene, attrs, frames, solve_attrs, opts_dense)
    assert res_d.solver_type_name == "lm_jax"
    assert res_d.error_final < 1e-4

    # Both backends drive the reprojection error to (near) zero; the
    # recovered attribute states agree up to the BA gauge freedom —
    # compare the reprojections instead of raw parameters.
    ev_ba = evaluate(scene, attrs_ba, jnp.asarray(frames))
    ev_d = evaluate(scene, attrs_d, jnp.asarray(frames))
    np.testing.assert_allclose(
        np.asarray(ev_ba.point_xy), np.asarray(ev_d.point_xy), atol=1e-5
    )


def test_bridge_shared_focal_matches_dense():
    """Static focal in the solve: the bridge puts it in the arrowhead
    border; result must agree with the dense path's static parameter."""
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    rng = np.random.RandomState(1)
    attrs = _perturb(attrs0, cam, bundles, rng, pose=0.02, bnd=0.02)
    static = np.array(attrs.static_values)
    static[cam.attr("focal_length_mm").code // 2] = 37.0
    attrs = attrs._replace(static_values=jnp.asarray(static))

    solve_attrs = _pose_and_bundle_attrs(cam, bundles)
    solve_attrs.append(cam.attr("focal_length_mm"))
    frames = np.arange(NUM_FRAMES)

    opts_ba = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
    )
    attrs_ba, res_ba = solve(scene, attrs, frames, solve_attrs, opts_ba)
    assert res_ba.solver_type_name == "ba_schur", res_ba.reason_string
    focal_ba = float(
        np.asarray(attrs_ba.static_values)[
            cam.attr("focal_length_mm").code // 2
        ]
    )
    # ONE focal, recovered to the 35mm ground truth.
    np.testing.assert_allclose(focal_ba, 35.0, atol=0.3)
    assert res_ba.error_final < 1e-3


def test_bridge_lens_distortion_matches_dense():
    """BASELINE config #4 through the product path: 3DE classic
    distortion + pose + bundles solved via the Schur backend."""
    sg, cam, bundles, scene, attrs0, lens = _tracked_scene(
        lens_distortion=0.1
    )
    rng = np.random.RandomState(2)
    attrs = _perturb(attrs0, cam, bundles, rng, pose=0.02, bnd=0.02)
    static = np.array(attrs.static_values)
    static[cam.attr("lens_distortion").code // 2] = 0.05
    attrs = attrs._replace(static_values=jnp.asarray(static))

    solve_attrs = _pose_and_bundle_attrs(cam, bundles)
    solve_attrs.append(cam.attr("lens_distortion"))
    frames = np.arange(NUM_FRAMES)

    opts_ba = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
    )
    attrs_ba, res_ba = solve(
        scene, attrs, frames, solve_attrs, opts_ba, lens=lens
    )
    assert res_ba.solver_type_name == "ba_schur", res_ba.reason_string
    dist_ba = float(
        np.asarray(attrs_ba.static_values)[
            cam.attr("lens_distortion").code // 2
        ]
    )
    np.testing.assert_allclose(dist_ba, 0.1, atol=5e-3)
    assert res_ba.error_final < 1e-2, res_ba.error_final


def test_bridge_fallback_reports_reason():
    """Requests outside the BA shape run dense, with the reason in the
    result (no silent downgrades)."""
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    attrs = _perturb(attrs0, cam, bundles, np.random.RandomState(3))
    # Solve only a subset of the pose -> not the BA shape.
    solve_attrs = [cam.attr("tx"), cam.attr("ty")]
    opts = SolverOptions(
        iterations=5, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
    )
    _, res = solve(scene, attrs, np.arange(NUM_FRAMES), solve_attrs,
                   opts)
    assert res.solver_type_name == "lm_jax"
    assert "ba fallback to dense" in res.reason_string


def test_bridge_through_api_execute():
    """api.execute routes options.solver_type to the BA backend
    (ref: the solverType flag through the execute layer,
    _api/_execute/main.py)."""
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    # Perturb through the scene graph so execute()'s bake sees it.
    rng = np.random.RandomState(4)
    for ch in ("tx", "ty", "tz", "rx", "ry", "rz"):
        a = cam.attr(ch)
        vals = np.asarray(
            [sg.get_value(a, frame=f) for f in range(NUM_FRAMES)]
        ) + rng.normal(0, 0.03, NUM_FRAMES)
        for f in range(NUM_FRAMES):
            sg.set_value(a, float(vals[f]), frame=f)
    for b in bundles:
        for ch in ("tx", "ty", "tz"):
            a = b.attr(ch)
            sg.set_value(a, float(sg.get_value(a)) + rng.normal(0, 0.03))

    col = mmapi.Collection(sg)
    col.add_marker(*sg._markers)
    col.add_attribute(*_pose_and_bundle_attrs(cam, bundles))
    col.set_solver(mmapi.SolverStep(frame_indices=range(NUM_FRAMES)))
    col.options = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
    )
    new_attrs, results = mmapi.execute(col)
    assert results[0].solver_type_name == "ba_schur", (
        results[0].reason_string
    )
    assert results[0].success
    assert results[0].error_final < 1e-3


def test_bridge_sharded_backend_runs():
    """SOLVER_TYPE_BA_SHARDED through solve() on the 8-virtual-device
    mesh (frame count divisible by device count)."""
    import jax

    n_dev = len(jax.devices())
    if NUM_FRAMES % n_dev != 0 and n_dev > 1:
        pytest.skip("frame count not divisible by device count")
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    attrs = _perturb(attrs0, cam, bundles, np.random.RandomState(5),
                     pose=0.02, bnd=0.02)
    solve_attrs = _pose_and_bundle_attrs(cam, bundles)
    opts = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SHARDED,
    )
    _, res = solve(scene, attrs, np.arange(NUM_FRAMES), solve_attrs,
                   opts)
    assert res.solver_type_name == "ba_schur_sharded", res.reason_string
    assert res.success
    assert res.error_final < 1e-3, res.error_final


def test_bridge_cg_linear_solver_option():
    """options.ba_linear_solver='cg' routes the bridged solve through
    the CG reduced-system solver and still converges."""
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    attrs = _perturb(attrs0, cam, bundles, np.random.RandomState(6),
                     pose=0.02, bnd=0.02)
    solve_attrs = _pose_and_bundle_attrs(cam, bundles)
    opts = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
        ba_linear_solver="cg", ba_cg_iterations=60,
    )
    _, res = solve(scene, attrs, np.arange(NUM_FRAMES), solve_attrs,
                   opts)
    assert res.solver_type_name == "ba_schur", res.reason_string
    assert res.success
    assert res.error_final < 1e-3, res.error_final


def test_bridge_multicamera_rig():
    """A two-camera rig (stereo/witness) through the product path: the
    bridge lays camera blocks out camera-major, forces the CG linear
    solver, and agrees with the dense backend."""
    rng = np.random.RandomState(8)
    sg = mmapi.SceneGraph(frame_range=(1, NUM_FRAMES))
    cams = []
    for ci, off in enumerate((0.0, 1.2)):
        cams.append(sg.create_camera(
            "cam%d" % ci,
            tx=np.linspace(-2, 2, NUM_FRAMES) + off,
            ty=np.full(NUM_FRAMES, 1.0),
            tz=10.0 + np.linspace(0, 1, NUM_FRAMES),
            rx=np.zeros(NUM_FRAMES),
            ry=np.linspace(-5, 5, NUM_FRAMES) - 3.0 * ci,
            rz=np.zeros(NUM_FRAMES),
            focal_length_mm=35.0,
            render_width=1920, render_height=1080,
        ))
    bundles = [
        sg.create_bundle(
            "b%d" % i, tx=rng.uniform(-3, 3),
            ty=rng.uniform(-2, 2), tz=rng.uniform(-7, -3),
        )
        for i in range(NUM_BUNDLES)
    ]
    for i, b in enumerate(bundles):
        for ci, cam in enumerate(cams):
            sg.create_marker(
                "m%d_c%d" % (i, ci), camera=cam, bundle=b,
                tx=np.zeros(NUM_FRAMES), ty=np.zeros(NUM_FRAMES),
            )
    scene, attrs = sg.bake()
    fi = jnp.arange(NUM_FRAMES)
    ev = evaluate(scene, attrs, fi)
    attrs = set_marker_screen_positions(scene, attrs, fi, ev.point_xy)

    anim = np.array(attrs.anim_values)
    static = np.array(attrs.static_values)
    for cam in cams:
        for ch in ("tx", "ty", "tz", "rx", "ry", "rz"):
            anim[cam.attr(ch).code // 2] += rng.normal(
                0, 0.02, NUM_FRAMES
            )
    for b in bundles:
        for ch in ("tx", "ty", "tz"):
            static[b.attr(ch).code // 2] += rng.normal(0, 0.02)
    attrs = attrs._replace(anim_values=jnp.asarray(anim),
                           static_values=jnp.asarray(static))

    solve_attrs = []
    for cam in cams:
        solve_attrs += [cam.attr(c) for c in
                        ("tx", "ty", "tz", "rx", "ry", "rz")]
    for b in bundles:
        solve_attrs += [b.attr(c) for c in ("tx", "ty", "tz")]

    opts = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
        ba_cg_iterations=60,
    )
    attrs_ba, res_ba = solve(scene, attrs, np.arange(NUM_FRAMES),
                             solve_attrs, opts)
    assert res_ba.solver_type_name == "ba_schur", res_ba.reason_string
    assert res_ba.success
    assert res_ba.error_final < 1e-3, res_ba.error_final

    # Dense-backend agreement (gauge-free: compare reprojections).
    opts_d = SolverOptions(iterations=30, image_width=1920.0)
    attrs_d, res_d = solve(scene, attrs, np.arange(NUM_FRAMES),
                           solve_attrs, opts_d)
    assert res_d.error_final < 1e-3
    ev_ba = evaluate(scene, attrs_ba, fi)
    ev_d = evaluate(scene, attrs_d, fi)
    np.testing.assert_allclose(
        np.asarray(ev_ba.point_xy), np.asarray(ev_d.point_xy),
        atol=1e-4,
    )


def test_bridge_hooks_run_ba_block_resumable():
    """Progress callbacks + interruption on the BA backend: hooks no
    longer force the dense fallback — the solve runs block-resumable
    through ba_init/ba_run_block (ref: the reference's
    isInterruptRequested polling, adjust_solveFunc.cpp:567-571)."""
    sg, cam, bundles, scene, attrs0, _ = _tracked_scene()
    attrs = _perturb(attrs0, cam, bundles, np.random.RandomState(9),
                     pose=0.05, bnd=0.05)
    solve_attrs = _pose_and_bundle_attrs(cam, bundles)
    frames = np.arange(NUM_FRAMES)

    progress = []
    opts = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
        iteration_callback=lambda it, cost: progress.append((it, cost)),
        callback_interval=3,
    )
    attrs_out, res = solve(scene, attrs, frames, solve_attrs, opts)
    assert res.solver_type_name == "ba_schur", res.reason_string
    assert res.success
    assert not res.user_interrupted
    assert len(progress) >= 2
    # Iteration counts increase and costs fall monotonically-ish.
    its = [p[0] for p in progress]
    assert its == sorted(its) and its[0] <= 3
    assert progress[-1][1] < progress[0][1]
    assert res.error_final < 1e-3

    # Interruption after the first block keeps the best-so-far state.
    calls = {"n": 0}

    def interrupt():
        calls["n"] += 1
        return calls["n"] >= 1

    opts2 = SolverOptions(
        iterations=30, image_width=1920.0,
        solver_type=registry.SOLVER_TYPE_BA_SCHUR,
        interrupt_check=interrupt, callback_interval=2,
    )
    attrs_int, res_int = solve(scene, attrs, frames, solve_attrs,
                               opts2)
    assert res_int.solver_type_name == "ba_schur"
    assert res_int.user_interrupted
    assert res_int.iterations <= 4
    # The partial solve still improved the error (best-so-far kept)
    # unless accept-only-better reverted — with a real improvement it
    # must not revert here.
    assert res_int.error_final <= res_int.error_initial


@pytest.mark.parametrize("num_frames,expected", [
    (16, "cholesky"),   # 96 reduced unknowns
    (49, "cholesky"),   # 294
    (50, "cg"),         # 300: the auto threshold
])
def test_bridge_auto_linear_solver_threshold(monkeypatch, num_frames,
                                             expected):
    """With ba_linear_solver=None the bridge picks Cholesky for short
    shots and CG from _BA_AUTO_CG_THRESHOLD reduced unknowns."""
    import importlib

    import bench

    solve_mod = importlib.import_module(
        "mayamatchmovesolver_tpu.solver.solve"
    )
    scene, attrs, _, cam, bundles, _ = bench._synthetic_tracked_scene(
        num_frames, 4, dtype=np.float64
    )
    seen = []

    class _Stop(Exception):
        pass

    def fake_solve(problem, cfg):
        seen.append(cfg[5])
        raise _Stop

    monkeypatch.setattr(solve_mod, "_ba_solve_jit", fake_solve)
    opts = SolverOptions(solver_type=registry.SOLVER_TYPE_BA_SCHUR)
    with pytest.raises(_Stop):
        solve(scene, attrs, np.arange(num_frames),
              _pose_and_bundle_attrs(cam, bundles), opts)
    assert seen == [expected]
