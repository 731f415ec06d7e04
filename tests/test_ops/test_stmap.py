"""ST-map tests: the XLA map against its float64 evaluation and the
point-wise lens models (ref: distortion kernels,
lib/cppbind/mmlens/src/distortion_process.rs).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mayamatchmovesolver_tpu import models
from mayamatchmovesolver_tpu.models import tde
import mayamatchmovesolver_tpu.ops.stmap as stmap_mod


def test_stmap_xla_identity_for_passthrough():
    fb = models.FilmBack.create()
    out = stmap_mod.stmap_xla(
        models.Passthrough(), fb, 64, 32, direction="distort"
    )
    out = np.asarray(out)
    # Identity ST map: pixel centers map to themselves.
    xs = (np.arange(64) + 0.5) / 64
    np.testing.assert_allclose(out[5, :, 0], xs, atol=1e-6)
    assert out.shape == (32, 64, 4)
    np.testing.assert_allclose(out[..., 3], 1.0)


def test_stmap_xla_distort_undistort_inverse():
    fb = models.FilmBack.create()
    model = models.TdeClassic.create(distortion=0.1)
    dist = np.asarray(
        stmap_mod.stmap_xla(model, fb, 32, 24, direction="distort")
    )
    undist = np.asarray(
        stmap_mod.stmap_xla(model, fb, 32, 24, direction="undistort")
    )
    # Distortion moves points opposite to undistortion (to first order
    # around the center).
    center_row = 12
    d = dist[center_row, :, 0] - (np.arange(32) + 0.5) / 32
    u = undist[center_row, :, 0] - (np.arange(32) + 0.5) / 32
    mask = np.abs(d) > 1e-5
    assert np.all(np.sign(d[mask]) == -np.sign(u[mask]))


def _all_models():
    return [
        (
            "classic",
            models.TdeClassic.create(
                distortion=0.15, anamorphic_squeeze=1.05,
                curvature_x=0.02, curvature_y=-0.01,
                quartic_distortion=0.03,
            ),
        ),
        (
            "radial_deg4",
            models.TdeRadialStdDeg4.create(
                degree2_distortion=0.12, degree2_u=0.01, degree2_v=-0.02,
                degree4_distortion=0.04, degree4_u=-0.005,
                degree4_v=0.008, cylindric_direction=25.0,
                cylindric_bending=0.1,
            ),
        ),
        (
            "anamorphic_deg4",
            models.TdeAnamorphicStdDeg4.create(
                degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
                degree2_cy22=-0.01, degree4_cx04=0.01,
                degree4_cy04=-0.005, degree4_cx24=0.004,
                degree4_cy24=0.002, degree4_cx44=-0.003,
                degree4_cy44=0.001, lens_rotation=4.0, squeeze_x=1.1,
                squeeze_y=0.95,
            ),
        ),
        (
            "anamorphic_deg4_rescaled",
            models.TdeAnamorphicStdDeg4Rescaled.create(
                degree2_cx02=0.05, degree2_cy02=0.03, degree2_cx22=0.02,
                degree2_cy22=-0.01, degree4_cx04=0.01,
                degree4_cy04=-0.005, lens_rotation=-3.0, squeeze_x=1.05,
                squeeze_y=1.0, rescale=1.1,
            ),
        ),
    ]


def _film_back():
    return models.FilmBack.create(
        width_cm=3.6, height_cm=2.4, offset_x_cm=0.05, offset_y_cm=-0.02
    )


@pytest.mark.parametrize("direction", ["distort", "undistort"])
@pytest.mark.parametrize("name,model", _all_models())
def test_stmap_matches_pointwise_models(name, model, direction):
    """stmap() of every 3DE model in both directions equals the lens
    model applied point by point to the pixel-centre grid."""
    fb = _film_back()
    w, h = 40, 24
    out = np.asarray(stmap_mod.stmap(model, fb, w, h, direction))
    assert out.shape == (h, w, 4) and out.dtype == np.float32
    ys = (np.arange(h) + 0.5) / h
    xs = (np.arange(w) + 0.5) / w
    gy, gx = np.meshgrid(ys, xs, indexing="ij")
    pts = jnp.asarray(np.stack([gx - 0.5, gy - 0.5], axis=-1))
    fn = tde.distort if direction == "distort" else tde.undistort
    expect = np.asarray(fn(model, fb, pts)) + 0.5
    np.testing.assert_allclose(out[..., :2], expect, atol=2e-6,
                               err_msg="%s/%s" % (name, direction))
    np.testing.assert_array_equal(out[..., 2], 0.0)
    np.testing.assert_array_equal(out[..., 3], 1.0)


def test_stmap_dispatch_takes_xla_path_and_raises(monkeypatch):
    """A single model goes to stmap_xla, and a failure there reaches
    the caller: nothing swallows it."""
    calls = []

    def failing(*args, **kwargs):
        calls.append(args)
        raise RuntimeError("lowering failed")

    monkeypatch.setattr(stmap_mod, "stmap_xla", failing)
    with pytest.raises(RuntimeError, match="lowering failed"):
        stmap_mod.stmap(models.TdeClassic.create(distortion=0.1),
                        _film_back(), 16, 8)
    assert len(calls) == 1
