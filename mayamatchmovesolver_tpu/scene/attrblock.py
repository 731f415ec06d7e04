"""Structure-of-arrays attribute storage.

Redesign of the reference's AttrDataBlock
(ref: lib/rust/mmscenegraph/src/attr/datablock.rs:29-90): attributes are
either *static* (one value) or *dense-animated* (one value per frame of a
contiguous frame range).  Instead of enum AttrIds we pack every attribute
reference into a single int32 code so index arrays stay flat and
gatherable inside jit:

    code == ATTR_NONE (-1)  -> no attribute (evaluates to 0.0)
    code % 2 == 0           -> static attribute   index = code // 2
    code % 2 == 1           -> animated channel   index = code // 2

Values live in two dense arrays: static (S,) and anim (A, F) where F is
the baked frame count.  Solvers scatter parameter vectors into a copy of
these arrays; everything stays functional for autodiff.
"""

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

ATTR_NONE = -1


def static_code(index):
    return index * 2


def anim_code(index):
    return index * 2 + 1


def is_static_code(code):
    return (code >= 0) & (code % 2 == 0)


def is_anim_code(code):
    return (code >= 0) & (code % 2 == 1)


def code_index(code):
    return code // 2


class AttrBlock(NamedTuple):
    """Pytree of attribute value arrays.

    static_values: (S,) float array.
    anim_values:   (A, F) float array — dense per-frame channels over the
                   baked frame range (ref: attr/datablock.rs AnimDense).
    """

    static_values: jax.Array
    anim_values: jax.Array

    @property
    def num_static(self):
        return self.static_values.shape[0]

    @property
    def num_anim(self):
        return self.anim_values.shape[0]

    @property
    def num_frames(self):
        return self.anim_values.shape[1]


def gather_attr_values(attrs: AttrBlock, codes, frame_indices):
    """Evaluate attribute codes at frames.

    codes: int array (...,) of packed attr codes.
    frame_indices: int array (F,) indexing the baked frame axis.
    Returns (..., F) float values; ATTR_NONE yields 0.0.

    Equivalent to AttrDataBlock::get_attr_value looped over codes/frames
    (ref: lib/rust/mmscenegraph/src/attr/datablock.rs), but as two gathers
    plus a select so it is one fused XLA op.
    """
    codes = jnp.asarray(codes)
    idx = jnp.maximum(codes, 0) // 2
    s = attrs.static_values[jnp.clip(idx, 0, attrs.num_static - 1)]
    a = attrs.anim_values[jnp.clip(idx, 0, attrs.num_anim - 1)][
        ..., frame_indices
    ]
    out = jnp.where((codes % 2 == 1)[..., None], a, s[..., None])
    return jnp.where((codes < 0)[..., None], jnp.zeros_like(out), out)


def gather_attr_values_static(attrs: AttrBlock, codes, frame_index=0):
    """Evaluate attribute codes at a single frame; returns (...,) values."""
    return gather_attr_values(
        attrs, codes, jnp.asarray([frame_index], dtype=jnp.int32)
    )[..., 0]


def set_attr_values(attrs: AttrBlock, code, values, frame_indices=None):
    """Write values into one attribute, returning a new AttrBlock.

    Host-side helper (the write-back half of the reference's
    set_maya_attribute_values, adjust_base.cpp:297-342): a static code
    takes a scalar; an animated code takes per-frame values at
    `frame_indices` (all frames when None).
    """
    import jax.numpy as jnp

    code = int(code)
    if code < 0:
        raise ValueError("cannot write ATTR_NONE")
    idx = code_index(code)
    if is_static_code(code):
        static = np.array(attrs.static_values)
        static[idx] = float(np.asarray(values).reshape(-1)[0])
        return attrs._replace(static_values=jnp.asarray(static))
    anim = np.array(attrs.anim_values)
    if frame_indices is None:
        anim[idx, :] = np.asarray(values)
    else:
        anim[idx, np.asarray(frame_indices)] = np.asarray(values)
    return attrs._replace(anim_values=jnp.asarray(anim))


class AttrBlockBuilder:
    """Host-side builder accumulating attributes before baking to arrays."""

    def __init__(self, num_frames, dtype=np.float64):
        self._static = []
        self._anim = []
        self.num_frames = int(num_frames)
        self.dtype = dtype

    def add_static(self, value):
        self._static.append(float(value))
        return static_code(len(self._static) - 1)

    def add_anim(self, values):
        values = np.asarray(values, dtype=self.dtype)
        if values.shape != (self.num_frames,):
            raise ValueError(
                "animated attribute needs %d frame values, got shape %r"
                % (self.num_frames, values.shape)
            )
        self._anim.append(values)
        return anim_code(len(self._anim) - 1)

    def add(self, value):
        """Static if scalar, animated if per-frame array."""
        if np.ndim(value) == 0:
            return self.add_static(value)
        return self.add_anim(value)

    def set_value(self, code, value, frame=None):
        """Edit an attribute in place before bake — the editable-graph
        half of the reference's Attr::setValue
        (ref: src/mmSolver/mayahelper/maya_attr.h:304).  A static code
        takes a scalar; an animated one takes all-frames values, or a
        scalar at `frame`."""
        idx = code_index(code)
        if is_static_code(code):
            self._static[idx] = float(value)
        elif frame is None:
            self._anim[idx] = np.broadcast_to(
                np.asarray(value, self.dtype), (self.num_frames,)
            ).copy()
        else:
            self._anim[idx][int(frame)] = float(value)

    def get_value(self, code, frame=None):
        """Read an attribute pre-bake (Attr::getValue counterpart,
        ref: maya_attr.h:304).  Static -> scalar; animated -> the
        per-frame array, or the scalar at `frame`."""
        idx = code_index(code)
        if is_static_code(code):
            return self._static[idx]
        if frame is None:
            return self._anim[idx].copy()
        return float(self._anim[idx][int(frame)])

    def bake(self, dtype=None):
        dtype = dtype or self.dtype
        static = np.asarray(self._static, dtype=dtype)
        if static.size == 0:
            static = np.zeros((1,), dtype=dtype)
        if self._anim:
            anim = np.stack(self._anim).astype(dtype)
        else:
            anim = np.zeros((1, self.num_frames), dtype=dtype)
        return AttrBlock(
            static_values=jnp.asarray(static), anim_values=jnp.asarray(anim)
        )
