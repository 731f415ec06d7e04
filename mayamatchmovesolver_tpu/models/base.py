"""Lens distortion framework: coordinate spaces and direction protocol.

Replicates the reference's mmlens conventions
(ref: lib/cppbind/mmlens/include/mmlens/lib.h:36-77 and
lens_model.h:36-120): models operate in *diagonally normalized* (dn)
coordinates — film-back cm divided by half the film-back diagonal, with
the lens center offset removed.  Public entry points take "marker"
coordinates in [-0.5, 0.5] (the solver's screen space) and convert.

Direction naming, matching the reference:
  undistort  = remove distortion  (analytic polynomial 'eval')
  distort    = apply distortion   (iterative inverse, 'map_inverse')
(ref: distortion_operations.h:32-99.)

Each concrete model is a pytree NamedTuple of parameter arrays (all
broadcastable leading dims) + pure functions; everything differentiates
for solving lens parameters in bundle adjustment.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp

# Fixed-point inversion iterations.  ldpk iterates until 1e-6 with max
# 20 + 2 post-iterations (ref: ldpk generic_distortion_base, via
# external/archives/ldpk-2.8.tar); under jit we run a fixed count.
DISTORT_INVERSE_ITERATIONS = 20


class FilmBack(NamedTuple):
    """Camera parameters the lens models need
    (ref: mmlens CameraParameters, src/_cxxbridge.cpp:446-453)."""

    film_back_width_cm: jax.Array
    film_back_height_cm: jax.Array
    lens_center_offset_x_cm: jax.Array
    lens_center_offset_y_cm: jax.Array
    pixel_aspect: jax.Array

    @staticmethod
    def create(width_cm=3.6, height_cm=2.4, offset_x_cm=0.0,
               offset_y_cm=0.0, pixel_aspect=1.0):
        as_arr = lambda v: jnp.asarray(v, jnp.result_type(float))  # noqa: E731
        return FilmBack(
            as_arr(width_cm), as_arr(height_cm), as_arr(offset_x_cm),
            as_arr(offset_y_cm), as_arr(pixel_aspect),
        )


def film_back_radius_cm(fb: FilmBack):
    """Half film-back diagonal (ref: lib.h:36-43)."""
    return jnp.sqrt(
        fb.film_back_width_cm**2 + fb.film_back_height_cm**2
    ) / 2.0


def unit_to_dn(fb: FilmBack, xy_unit):
    """[0,1] unit film coords -> diagonally normalized (ref: lib.h:45-58)."""
    radius = film_back_radius_cm(fb)
    x = (
        (xy_unit[..., 0] - 0.5) * fb.film_back_width_cm
        - fb.lens_center_offset_x_cm
    ) / radius
    y = (
        (xy_unit[..., 1] - 0.5) * fb.film_back_height_cm
        - fb.lens_center_offset_y_cm
    ) / radius
    return jnp.stack([x, y], axis=-1)


def dn_to_unit(fb: FilmBack, xy_dn):
    """(ref: lib.h:60-77)."""
    radius = film_back_radius_cm(fb)
    x_cm = xy_dn[..., 0] * radius + fb.film_back_width_cm / 2.0 \
        + fb.lens_center_offset_x_cm
    y_cm = xy_dn[..., 1] * radius + fb.film_back_height_cm / 2.0 \
        + fb.lens_center_offset_y_cm
    return jnp.stack(
        [x_cm / fb.film_back_width_cm, y_cm / fb.film_back_height_cm],
        axis=-1,
    )


def fixed_point_inverse(eval_fn, q_dn, iterations=DISTORT_INVERSE_ITERATIONS):
    """Solve eval_fn(p) = q for p with the ldpk fixed-point scheme
    p <- p + (q - eval_fn(p)), fixed iteration count for jit."""

    p0 = q_dn - (eval_fn(q_dn) - q_dn)

    def body(_, p):
        return p + (q_dn - eval_fn(p))

    return jax.lax.fori_loop(0, iterations, body, p0)


def marker_to_unit(xy_marker):
    """Solver screen space [-0.5, 0.5] -> unit [0, 1]
    (ref: lens_model_3de_classic.cpp:63-71)."""
    return xy_marker + 0.5


def unit_to_marker(xy_unit):
    return xy_unit - 0.5


def apply_in_marker_space(fn_dn, fb: FilmBack, xy_marker):
    """Lift a dn-space mapping to the solver's [-0.5, 0.5] space."""
    unit = marker_to_unit(xy_marker)
    dn = unit_to_dn(fb, unit)
    out_dn = fn_dn(dn)
    out_unit = dn_to_unit(fb, out_dn)
    return unit_to_marker(out_unit)


def rotation_matrix_2d(phi_rad):
    c, s = jnp.cos(phi_rad), jnp.sin(phi_rad)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def diag2(a, b):
    a, b = jnp.broadcast_arrays(jnp.asarray(a), jnp.asarray(b))
    zero = jnp.zeros_like(a)
    return jnp.stack(
        [jnp.stack([a, zero], axis=-1), jnp.stack([zero, b], axis=-1)],
        axis=-2,
    )


def inverse2(m):
    det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    inv = jnp.stack(
        [
            jnp.stack([m[..., 1, 1], -m[..., 0, 1]], axis=-1),
            jnp.stack([-m[..., 1, 0], m[..., 0, 0]], axis=-1),
        ],
        axis=-2,
    )
    return inv / det[..., None, None]


# The 2x2 products are written out elementwise: exact in every dtype,
# whereas a matmul at default precision may run in TF32 on the GPU.


def mat2_mul(a, b):
    """(..., 2, 2) @ (..., 2, 2)."""
    return jnp.stack(
        [
            jnp.stack([a[..., i, 0] * b[..., 0, j]
                       + a[..., i, 1] * b[..., 1, j] for j in (0, 1)],
                      axis=-1)
            for i in (0, 1)
        ],
        axis=-2,
    )


def mat2_apply(m, xy):
    """(..., 2, 2) matrices applied to (..., 2) points."""
    x, y = xy[..., 0], xy[..., 1]
    return jnp.stack(
        [m[..., 0, 0] * x + m[..., 0, 1] * y,
         m[..., 1, 0] * x + m[..., 1, 1] * y],
        axis=-1,
    )
