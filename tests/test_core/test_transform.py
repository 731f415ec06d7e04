"""Transform math tests.

Round-trip and parity checks mirroring the reference's
test_decompose_matrix (ref: lib/rust/mmscenegraph/src/math/transform.rs:739-810).
"""

import jax.numpy as jnp
import numpy as np
import pytest

from mayamatchmovesolver_tpu.core import transform as tfm
from mayamatchmovesolver_tpu.core.constants import RotateOrder


def _numpy_trs(tx, ty, tz, rx, ry, rz, sx, sy, sz, order):
    rad = np.radians
    cx, sx_ = np.cos(rad(rx)), np.sin(rad(rx))
    cy, sy_ = np.cos(rad(ry)), np.sin(rad(ry))
    cz, sz_ = np.cos(rad(rz)), np.sin(rad(rz))
    mx = np.array([[1, 0, 0], [0, cx, -sx_], [0, sx_, cx]])
    my = np.array([[cy, 0, sy_], [0, 1, 0], [-sy_, 0, cy]])
    mz = np.array([[cz, -sz_, 0], [sz_, cz, 0], [0, 0, 1]])
    mats = {"x": mx, "y": my, "z": mz}
    names = {
        RotateOrder.XYZ: "xyz", RotateOrder.YZX: "yzx",
        RotateOrder.ZXY: "zxy", RotateOrder.XZY: "xzy",
        RotateOrder.YXZ: "yxz", RotateOrder.ZYX: "zyx",
    }[RotateOrder(order)]
    first, second, third = names
    r = mats[third] @ mats[second] @ mats[first]
    m = np.eye(4)
    m[:3, :3] = r @ np.diag([sx, sy, sz])
    m[:3, 3] = [tx, ty, tz]
    return m


@pytest.mark.parametrize("order", list(RotateOrder))
def test_trs_matrix_matches_numpy_oracle(order):
    vals = (0.0, 42.0, -3.0, 45.0, 15.0, 5.0, 2.0, 3.0, 4.0)
    got = np.asarray(tfm.trs_matrix(*vals, int(order)))
    want = _numpy_trs(*vals, order)
    np.testing.assert_allclose(got, want, atol=1e-12)


@pytest.mark.parametrize("order", list(RotateOrder))
def test_decompose_round_trip(order):
    # Mirrors the reference's decompose test values
    # (ref: math/transform.rs:742-752).
    vals = (0.0, 42.0, 0.0, 45.0, 15.0, 5.0, 2.0, 3.0, 4.0)
    m = tfm.trs_matrix(*vals, int(order))
    t, r, s = tfm.decompose_matrix(m, jnp.asarray(int(order)))
    np.testing.assert_allclose(np.asarray(t), [0.0, 42.0, 0.0], atol=1e-9)
    np.testing.assert_allclose(np.asarray(r), [45.0, 15.0, 5.0], atol=1e-6)
    np.testing.assert_allclose(np.asarray(s), [2.0, 3.0, 4.0], atol=1e-9)
    m2 = tfm.trs_matrix(
        t[0], t[1], t[2], r[0], r[1], r[2], s[0], s[1], s[2], int(order)
    )
    np.testing.assert_allclose(np.asarray(m2), np.asarray(m), atol=1e-9)


def test_batched_orders():
    orders = jnp.arange(6)
    rx = jnp.full((6,), 30.0)
    m = tfm.euler_to_rotation_matrix(rx, 10.0, 20.0, orders)
    assert m.shape == (6, 3, 3)
    for i in range(6):
        single = tfm.euler_to_rotation_matrix(30.0, 10.0, 20.0, i)
        # The f64 rotation chain bottoms out around 1e-9.
        np.testing.assert_allclose(np.asarray(m[i]), np.asarray(single),
                                   atol=1e-7)


def test_rotation_is_orthonormal():
    m = tfm.euler_to_rotation_matrix(33.0, -71.0, 118.0, 4)
    np.testing.assert_allclose(
        np.asarray(m) @ np.asarray(m).T, np.eye(3), atol=1e-7
    )
    assert np.isclose(float(np.linalg.det(np.asarray(m))), 1.0)
