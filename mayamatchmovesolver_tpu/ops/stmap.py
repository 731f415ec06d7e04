"""Lens distortion ST-map generation.

Replaces the reference's rayon-parallel per-scanline image distortion
engine (ref: lib/cppbind/mmlens/src/distortion_process.rs:26-70 and the
tools/lensdistortion CLI): for every pixel of the output image, compute
where it samples in the input (distort or undistort), producing an
RGBA float32 ST-map (R=S, G=T, B=0, A=1).

The map is one jitted XLA program per (model type, size, direction):
pixel coordinates come from iota, and the lens polynomial (and its
fixed-point inverse for the distort direction) runs elementwise, so
XLA fuses the whole map into one pass that writes only the output.
"""

import functools

import jax
import jax.numpy as jnp

from mayamatchmovesolver_tpu.models import tde


@functools.partial(
    jax.jit, static_argnames=("width", "height", "direction", "dtype")
)
def stmap_xla(model, film_back, width, height, direction="distort",
              dtype=jnp.float32):
    """Whole-image ST map via plain XLA (any model type).

    Pixel centers sample at (x+0.5)/w, (y+0.5)/h in unit space, like
    the reference's image loops (ref: distortion_process.rs per-pixel
    identity coordinates).  `dtype` is the evaluation precision.
    Returns (H, W, 4) float32.
    """
    ys = (jnp.arange(height, dtype=dtype) + 0.5) / height
    xs = (jnp.arange(width, dtype=dtype) + 0.5) / width
    grid_y, grid_x = jnp.meshgrid(ys, xs, indexing="ij")
    pts_marker = jnp.stack([grid_x - 0.5, grid_y - 0.5], axis=-1)
    if direction == "distort":
        out = tde.distort(model, film_back, pts_marker)
    else:
        out = tde.undistort(model, film_back, pts_marker)
    out_unit = out + 0.5
    rgba = jnp.concatenate(
        [
            out_unit,
            jnp.zeros_like(out_unit[..., :1]),
            jnp.ones_like(out_unit[..., :1]),
        ],
        axis=-1,
    )
    return rgba.astype(jnp.float32)


def stmap(model, film_back, width, height, direction="distort"):
    """ST map of one lens model, or of a lens-layer stack.

    `model` may be a sequence of models — a lens-layer stack chained
    like the reference's m_inputLensModel list
    (ref: lib/cppbind/mmlens/src/distortion_layers.rs:255); see
    stmap_stack."""
    # Lens models are NamedTuples; only a plain list/tuple is a stack.
    if isinstance(model, (list, tuple)) and not hasattr(model, "_fields"):
        return stmap_stack(model, film_back, width, height, direction)
    return stmap_xla(model, film_back, width, height, direction)


def stmap_stack(models, film_back, width, height, direction="distort"):
    """ST map for a multi-layer lens stack.

    The first layer runs through the single-layer path; each
    subsequent layer is applied point-wise to the previous layer's
    output coordinates — one elementwise map over the (H, W)
    coordinate planes (the reference chains per-point virtual calls,
    lens_model.h:36-120).
    """
    models = list(models)
    if not models:
        return stmap(tde.Passthrough(), film_back, width, height,
                     direction)
    if direction != "distort":
        models = models[::-1]
    out = stmap(models[0], film_back, width, height, direction)
    for model in models[1:]:
        pts_marker = out[..., :2].astype(jnp.result_type(float)) - 0.5
        if direction == "distort":
            mapped = tde.distort(model, film_back, pts_marker)
        else:
            mapped = tde.undistort(model, film_back, pts_marker)
        out = jnp.concatenate(
            [(mapped + 0.5).astype(jnp.float32), out[..., 2:]], axis=-1
        )
    return out
