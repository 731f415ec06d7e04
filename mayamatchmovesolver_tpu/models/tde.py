"""3DEqualizer-compatible lens distortion models.

From-scratch JAX implementations of the published 3DE/ldpk model math the
reference wraps (ref: lib/cppbind/mmlens/src/distortion_structs.h and the
vendored ldpk 2.8 headers in external/archives/ldpk-2.8.tar):

  * TdeClassic                 — "3DE Classic LD Model" (degree-2
                                 anamorphic + degree-4 radial mixed)
  * TdeRadialStdDeg4           — "3DE4 Radial, Standard - Degree 4"
                                 with decentering + cylindric bending
  * TdeAnamorphicStdDeg4       — "3DE4 Anamorphic, Standard - Degree 4"
                                 with lens rotation + squeeze x/y
  * TdeAnamorphicStdDeg4Rescaled — + rescale parameter
  * Passthrough                — identity

All parameter fields are arrays (broadcastable), so lens parameters can
be batched per-frame and solved by bundle adjustment.  `undistort_dn` is
the analytic polynomial; `distort_dn` is the fixed-point inverse.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

from mayamatchmovesolver_tpu.models.base import (
    FilmBack,
    apply_in_marker_space,
    diag2,
    fixed_point_inverse,
    inverse2,
    mat2_apply,
    mat2_mul,
    rotation_matrix_2d,
)

DEG2RAD = jnp.pi / 180.0


class Passthrough(NamedTuple):
    """Identity lens (ref: mmlens lens_model_passthrough.cpp)."""


class TdeClassic(NamedTuple):
    """(ref: ldpk classic_3de_mixed_distortion; parameter order matches
    mmlens Parameters3deClassic: distortion, anamorphic_squeeze,
    curvature_x, curvature_y, quartic_distortion.)"""

    distortion: jax.Array
    anamorphic_squeeze: jax.Array
    curvature_x: jax.Array
    curvature_y: jax.Array
    quartic_distortion: jax.Array

    @staticmethod
    def create(distortion=0.0, anamorphic_squeeze=1.0, curvature_x=0.0,
               curvature_y=0.0, quartic_distortion=0.0):
        arr = lambda v: jnp.asarray(v, jnp.result_type(float))  # noqa: E731
        return TdeClassic(
            arr(distortion), arr(anamorphic_squeeze), arr(curvature_x),
            arr(curvature_y), arr(quartic_distortion),
        )


def _classic_undistort_dn(p: TdeClassic, xy):
    ld, sq, cx, cy, qu = (
        p.distortion, p.anamorphic_squeeze, p.curvature_x,
        p.curvature_y, p.quartic_distortion,
    )
    # Derived coefficients of the mixed model.
    cxx = ld / sq
    cxy = (ld + cx) / sq
    cyx = ld + cy
    cyy = ld
    cxxx = qu / sq
    cxxy = 2.0 * qu / sq
    cxyy = qu / sq
    cyxx = qu
    cyyx = 2.0 * qu
    cyyy = qu

    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    x4, y4 = x2 * x2, y2 * y2
    xy2 = x2 * y2
    qx = x * (1.0 + cxx * x2 + cxy * y2 + cxxx * x4 + cxxy * xy2 + cxyy * y4)
    qy = y * (1.0 + cyx * x2 + cyy * y2 + cyxx * x4 + cyyx * xy2 + cyyy * y4)
    return jnp.stack([qx, qy], axis=-1)


class TdeRadialStdDeg4(NamedTuple):
    """(ref: ldpk radial_decentered_distortion + cylindric_extender_2;
    mmlens Parameters3deRadialStdDeg4 ordering: degree2_distortion,
    degree2_u, degree2_v, degree4_distortion, degree4_u, degree4_v,
    cylindric_direction (deg), cylindric_bending.)"""

    degree2_distortion: jax.Array
    degree2_u: jax.Array
    degree2_v: jax.Array
    degree4_distortion: jax.Array
    degree4_u: jax.Array
    degree4_v: jax.Array
    cylindric_direction: jax.Array
    cylindric_bending: jax.Array

    @staticmethod
    def create(degree2_distortion=0.0, degree2_u=0.0, degree2_v=0.0,
               degree4_distortion=0.0, degree4_u=0.0, degree4_v=0.0,
               cylindric_direction=0.0, cylindric_bending=0.0):
        arr = lambda v: jnp.asarray(v, jnp.result_type(float))  # noqa: E731
        return TdeRadialStdDeg4(
            arr(degree2_distortion), arr(degree2_u), arr(degree2_v),
            arr(degree4_distortion), arr(degree4_u), arr(degree4_v),
            arr(cylindric_direction), arr(cylindric_bending),
        )


def _cylindric_matrix(phi_deg, b):
    """(ref: ldpk cylindric_extender_2 matrix.)"""
    q = jnp.sqrt(1.0 + b)
    c = jnp.cos(phi_deg * DEG2RAD)
    s = jnp.sin(phi_deg * DEG2RAD)
    m00 = c * c * q + s * s / q
    m01 = (q - 1.0 / q) * c * s
    m11 = c * c / q + s * s * q
    return jnp.stack(
        [
            jnp.stack([m00, m01], axis=-1),
            jnp.stack([m01, m11], axis=-1),
        ],
        axis=-2,
    )


def _radial_deg4_core(p: TdeRadialStdDeg4, xy):
    c2, u2, v2 = p.degree2_distortion, p.degree2_u, p.degree2_v
    c4, u4, v4 = p.degree4_distortion, p.degree4_u, p.degree4_v
    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    xy_ = x * y
    r2 = x2 + y2
    r4 = r2 * r2
    radial = 1.0 + c2 * r2 + c4 * r4
    qx = (
        x * radial
        + (r2 + 2.0 * x2) * (u2 + u4 * r2)
        + 2.0 * xy_ * (v2 + v4 * r2)
    )
    qy = (
        y * radial
        + (r2 + 2.0 * y2) * (v2 + v4 * r2)
        + 2.0 * xy_ * (u2 + u4 * r2)
    )
    return jnp.stack([qx, qy], axis=-1)


def _radial_deg4_undistort_dn(p: TdeRadialStdDeg4, xy):
    # undistort: cylindric.eval(radial.eval(p))
    # (ref: distortion_structs.h Distortion3deRadialStdDeg4::eval).
    m = _cylindric_matrix(p.cylindric_direction, p.cylindric_bending)
    return mat2_apply(m, _radial_deg4_core(p, xy))


def _radial_deg4_distort_dn(p: TdeRadialStdDeg4, xy):
    # distort: radial.map_inverse(cylindric.eval_inv(p))
    # (ref: distortion_structs.h Distortion3deRadialStdDeg4::map_inverse).
    m = _cylindric_matrix(p.cylindric_direction, p.cylindric_bending)
    target = mat2_apply(inverse2(m), xy)
    return fixed_point_inverse(lambda q: _radial_deg4_core(p, q), target)


class TdeAnamorphicStdDeg4(NamedTuple):
    """(ref: ldpk generic_anamorphic_distortion<4> + rotation/squeeze
    extenders; mmlens Parameters3deAnamorphicStdDeg4 ordering.)"""

    degree2_cx02: jax.Array
    degree2_cy02: jax.Array
    degree2_cx22: jax.Array
    degree2_cy22: jax.Array
    degree4_cx04: jax.Array
    degree4_cy04: jax.Array
    degree4_cx24: jax.Array
    degree4_cy24: jax.Array
    degree4_cx44: jax.Array
    degree4_cy44: jax.Array
    lens_rotation: jax.Array  # degrees
    squeeze_x: jax.Array
    squeeze_y: jax.Array

    @staticmethod
    def create(degree2_cx02=0.0, degree2_cy02=0.0, degree2_cx22=0.0,
               degree2_cy22=0.0, degree4_cx04=0.0, degree4_cy04=0.0,
               degree4_cx24=0.0, degree4_cy24=0.0, degree4_cx44=0.0,
               degree4_cy44=0.0, lens_rotation=0.0, squeeze_x=1.0,
               squeeze_y=1.0):
        arr = lambda v: jnp.asarray(v, jnp.result_type(float))  # noqa: E731
        return TdeAnamorphicStdDeg4(
            arr(degree2_cx02), arr(degree2_cy02), arr(degree2_cx22),
            arr(degree2_cy22), arr(degree4_cx04), arr(degree4_cy04),
            arr(degree4_cx24), arr(degree4_cy24), arr(degree4_cx44),
            arr(degree4_cy44), arr(lens_rotation), arr(squeeze_x),
            arr(squeeze_y),
        )


class TdeAnamorphicStdDeg4Rescaled(NamedTuple):
    """(ref: mmlens Parameters3deAnamorphicStdDeg4Rescaled — the deg-4
    anamorphic with an extra rescale factor.)"""

    degree2_cx02: jax.Array
    degree2_cy02: jax.Array
    degree2_cx22: jax.Array
    degree2_cy22: jax.Array
    degree4_cx04: jax.Array
    degree4_cy04: jax.Array
    degree4_cx24: jax.Array
    degree4_cy24: jax.Array
    degree4_cx44: jax.Array
    degree4_cy44: jax.Array
    lens_rotation: jax.Array
    squeeze_x: jax.Array
    squeeze_y: jax.Array
    rescale: jax.Array

    @staticmethod
    def create(degree2_cx02=0.0, degree2_cy02=0.0, degree2_cx22=0.0,
               degree2_cy22=0.0, degree4_cx04=0.0, degree4_cy04=0.0,
               degree4_cx24=0.0, degree4_cy24=0.0, degree4_cx44=0.0,
               degree4_cy44=0.0, lens_rotation=0.0, squeeze_x=1.0,
               squeeze_y=1.0, rescale=1.0):
        arr = lambda v: jnp.asarray(v, jnp.result_type(float))  # noqa: E731
        return TdeAnamorphicStdDeg4Rescaled(
            arr(degree2_cx02), arr(degree2_cy02), arr(degree2_cx22),
            arr(degree2_cy22), arr(degree4_cx04), arr(degree4_cy04),
            arr(degree4_cx24), arr(degree4_cy24), arr(degree4_cx44),
            arr(degree4_cy44), arr(lens_rotation), arr(squeeze_x),
            arr(squeeze_y), arr(rescale),
        )


def _anamorphic_core(p, xy):
    """Polynomial in polar form: factor_x/y = sum over even (i_phi<=i_r)
    of c[i_phi][i_r] * cos(i_phi*phi) * r^i_r, with c00 = 1.

    cos(2phi) and cos(4phi) are computed from Cartesian ratios so the
    function stays smooth near the origin (no atan2).
    """
    x, y = xy[..., 0], xy[..., 1]
    x2, y2 = x * x, y * y
    r2 = x2 + y2
    r4 = r2 * r2
    safe_r2 = jnp.maximum(r2, 1e-30)
    cos2 = (x2 - y2) / safe_r2
    cos4 = 2.0 * cos2 * cos2 - 1.0

    fx = (
        1.0
        + p.degree2_cx02 * r2
        + p.degree4_cx04 * r4
        + cos2 * (p.degree2_cx22 * r2 + p.degree4_cx24 * r4)
        + cos4 * p.degree4_cx44 * r4
    )
    fy = (
        1.0
        + p.degree2_cy02 * r2
        + p.degree4_cy04 * r4
        + cos2 * (p.degree2_cy22 * r2 + p.degree4_cy24 * r4)
        + cos4 * p.degree4_cy44 * r4
    )
    return jnp.stack([x * fx, y * fy], axis=-1)


def _anamorphic_matrices(p, pixel_aspect, rescale=None):
    """The two concatenated extender matrices of the mmlens wiring
    (ref: distortion_structs.h Distortion3deAnamorphicStdDeg4):
      A = R(rot) @ Sx(sq_x) @ Sy(sq_y) [@ Rescale] @ Pa(pixel_aspect)
      B = Pa [@ Rescale] @ R(rot)
    """
    rot = rotation_matrix_2d(p.lens_rotation * DEG2RAD)
    sx = diag2(p.squeeze_x, jnp.ones_like(p.squeeze_x))
    sy = diag2(jnp.ones_like(p.squeeze_y), p.squeeze_y)
    pa = diag2(pixel_aspect, jnp.ones_like(jnp.asarray(pixel_aspect)))
    if rescale is None:
        a = mat2_mul(mat2_mul(mat2_mul(rot, sx), sy), pa)
        b = mat2_mul(pa, rot)
    else:
        # The reference's rescale extender scales x only (it reuses
        # squeeze_x_extender; ref: distortion_structs.h:289-299).
        rs = diag2(rescale, jnp.ones_like(rescale))
        a = mat2_mul(mat2_mul(mat2_mul(mat2_mul(rot, sx), sy), rs), pa)
        b = mat2_mul(mat2_mul(pa, rs), rot)
    return a, b


def _anamorphic_undistort_dn(p, xy, pixel_aspect, rescale=None):
    a, b = _anamorphic_matrices(p, pixel_aspect, rescale)
    inner = mat2_apply(inverse2(b), xy)
    return mat2_apply(a, _anamorphic_core(p, inner))


def _anamorphic_distort_dn(p, xy, pixel_aspect, rescale=None):
    a, b = _anamorphic_matrices(p, pixel_aspect, rescale)
    target = mat2_apply(inverse2(a), xy)
    inv = fixed_point_inverse(lambda q: _anamorphic_core(p, q), target)
    return mat2_apply(b, inv)


# ---------------------------------------------------------------------------
# Uniform dispatch.

def undistort_dn(model, xy_dn, film_back: FilmBack = None):
    """Remove distortion in diagonally-normalized space."""
    if isinstance(model, Passthrough):
        return xy_dn
    if isinstance(model, TdeClassic):
        return _classic_undistort_dn(model, xy_dn)
    if isinstance(model, TdeRadialStdDeg4):
        return _radial_deg4_undistort_dn(model, xy_dn)
    if isinstance(model, TdeAnamorphicStdDeg4):
        pa = film_back.pixel_aspect if film_back is not None else 1.0
        return _anamorphic_undistort_dn(model, xy_dn, pa)
    if isinstance(model, TdeAnamorphicStdDeg4Rescaled):
        pa = film_back.pixel_aspect if film_back is not None else 1.0
        return _anamorphic_undistort_dn(model, xy_dn, pa, model.rescale)
    raise TypeError("unknown lens model: %r" % (type(model),))


def distort_dn(model, xy_dn, film_back: FilmBack = None):
    """Apply distortion (iterative inverse of undistort)."""
    if isinstance(model, Passthrough):
        return xy_dn
    if isinstance(model, TdeClassic):
        return fixed_point_inverse(
            lambda q: _classic_undistort_dn(model, q), xy_dn
        )
    if isinstance(model, TdeRadialStdDeg4):
        return _radial_deg4_distort_dn(model, xy_dn)
    if isinstance(model, TdeAnamorphicStdDeg4):
        pa = film_back.pixel_aspect if film_back is not None else 1.0
        return _anamorphic_distort_dn(model, xy_dn, pa)
    if isinstance(model, TdeAnamorphicStdDeg4Rescaled):
        pa = film_back.pixel_aspect if film_back is not None else 1.0
        return _anamorphic_distort_dn(model, xy_dn, pa, model.rescale)
    raise TypeError("unknown lens model: %r" % (type(model),))


def undistort(model, film_back: FilmBack, xy_marker):
    """Remove distortion in the solver's [-0.5, 0.5] screen space
    (ref: LensModel::applyModelUndistort, lens_model_3de_classic.cpp:37)."""
    return apply_in_marker_space(
        lambda dn: undistort_dn(model, dn, film_back), film_back, xy_marker
    )


def distort(model, film_back: FilmBack, xy_marker):
    """Apply distortion in the solver's [-0.5, 0.5] screen space
    (ref: LensModel::applyModelDistort, lens_model_3de_classic.cpp:75)."""
    return apply_in_marker_space(
        lambda dn: distort_dn(model, dn, film_back), film_back, xy_marker
    )
