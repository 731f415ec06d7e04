"""Solver state checkpoint / resume.

The reference persists solver state through the Maya scene (Collection
node serialization, collection.py:375-415) and undo stacks; this
framework checkpoints the attribute block + solve configuration to an
npz so long solves resume across processes (SURVEY.md section 5
"checkpoint/resume").
"""

import json

import jax.numpy as jnp
import numpy as np

from mayamatchmovesolver_tpu.scene.attrblock import AttrBlock

FORMAT_VERSION = 1


def save_attrs(file_path, attrs: AttrBlock, metadata=None):
    """Write the attribute block (+ JSON metadata) to an npz."""
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        static_values=np.asarray(attrs.static_values),
        anim_values=np.asarray(attrs.anim_values),
        metadata=json.dumps(metadata or {}),
    )


def load_attrs(file_path):
    """Returns (AttrBlock, metadata dict)."""
    with np.load(file_path, allow_pickle=False) as data:
        version = int(data["format_version"])
        if version != FORMAT_VERSION:
            raise ValueError(
                "unsupported checkpoint version: %d" % version
            )
        attrs = AttrBlock(
            static_values=jnp.asarray(data["static_values"]),
            anim_values=jnp.asarray(data["anim_values"]),
        )
        metadata = json.loads(str(data["metadata"]))
    return attrs, metadata


def save_solve_state(file_path, attrs, params=None, iteration=0,
                     cost=None, extra=None):
    """Checkpoint mid-solve state (params vector + progress counters)."""
    meta = dict(extra or {})
    meta["iteration"] = int(iteration)
    if cost is not None:
        meta["cost"] = float(cost)
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        static_values=np.asarray(attrs.static_values),
        anim_values=np.asarray(attrs.anim_values),
        params=(
            np.asarray(params) if params is not None else np.zeros(0)
        ),
        metadata=json.dumps(meta),
    )


def load_solve_state(file_path):
    """Returns (AttrBlock, params or None, metadata)."""
    with np.load(file_path, allow_pickle=False) as data:
        attrs = AttrBlock(
            static_values=jnp.asarray(data["static_values"]),
            anim_values=jnp.asarray(data["anim_values"]),
        )
        params = np.asarray(data["params"])
        metadata = json.loads(str(data["metadata"]))
    return attrs, (params if params.size else None), metadata


def save_lm_state(file_path, state, metadata=None):
    """Checkpoint a full resumable LM state (solver/lm.py LMState —
    the per-iteration-block state the chunked driver passes between
    dispatches).  Resume by loading and feeding it back into
    lm.lm_run_block (SURVEY §5 "checkpoint of the
    parameter vector + solver state per LM iteration block")."""
    arrays = {f: np.asarray(getattr(state, f)) for f in state._fields}
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        metadata=json.dumps(metadata or {}),
        **{"lm_" + k: v for k, v in arrays.items()},
    )


def load_lm_state(file_path):
    """Returns (LMState, metadata dict)."""
    from mayamatchmovesolver_tpu.solver import lm as lm_mod

    with np.load(file_path, allow_pickle=False) as data:
        fields = {
            f: jnp.asarray(data["lm_" + f])
            for f in lm_mod.LMState._fields
            if "lm_" + f in data
        }
        # Fields added after a checkpoint was written (e.g. the
        # round-5 evaluation counters) default to zero.
        for f in lm_mod.LMState._fields:
            fields.setdefault(f, jnp.asarray(0, jnp.int32))
        metadata = json.loads(str(data["metadata"]))
    return lm_mod.LMState(**fields), metadata


def save_ba_state(file_path, state, metadata=None):
    """Checkpoint a resumable BA state (solver/ba.py BAState — the
    block state the chunked BA driver passes between dispatches).
    Resume by loading and feeding it back into ba.ba_run_block."""
    arrays = {f: np.asarray(getattr(state, f)) for f in state._fields}
    np.savez_compressed(
        file_path,
        format_version=FORMAT_VERSION,
        metadata=json.dumps(metadata or {}),
        **{"ba_" + k: v for k, v in arrays.items()},
    )


def load_ba_state(file_path):
    """Returns (BAState, metadata dict)."""
    from mayamatchmovesolver_tpu.solver import ba as ba_mod

    with np.load(file_path, allow_pickle=False) as data:
        fields = {
            f: jnp.asarray(data["ba_" + f])
            for f in ba_mod.BAState._fields
            if "ba_" + f in data
        }
        for f in ba_mod.BAState._fields:
            fields.setdefault(f, jnp.asarray(0, jnp.int32))
        metadata = json.loads(str(data["metadata"]))
    return ba_mod.BAState(**fields), metadata
