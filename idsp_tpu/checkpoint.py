"""Checkpoint/resume for streaming state.

The reference's architecture makes checkpointing trivial because all
mutable state is plain data separate from config (SURVEY.md §5:
`PLLState`, `DirectForm*`, ring buffers, most with serde derives) —
this package preserves that: every filter state here is a pytree of
arrays, and block-boundary carries are exactly the checkpoint payload.

Two backends:
* orbax (preferred when available): async-capable, sharded-array-aware.
* a plain numpy `.npz` fallback with pytree structure preserved.

The npz payload records the pytree structure string and per-leaf
shape/dtype; `restore` validates both against the ``like`` template and
raises instead of silently mis-assigning leaves.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import jax


class CheckpointStructureError(ValueError):
    """Checkpoint payload does not match the restore template."""


def save(path: str, state: Any, *, backend: str = "auto") -> None:
    """Save a state pytree.

    Args:
      backend: "orbax", "npz", or "auto" (orbax when importable, npz
        otherwise).  Orbax failures are only swallowed in "auto" mode
        when orbax itself is missing — a genuine save error propagates.
    """
    if backend not in ("auto", "orbax", "npz"):
        raise ValueError(f"unknown checkpoint backend {backend!r}")
    if backend in ("auto", "orbax"):
        try:
            import orbax.checkpoint as ocp
        except ImportError:
            if backend == "orbax":
                raise
        else:
            path = os.path.abspath(path)
            ckptr = ocp.StandardCheckpointer()
            ckptr.save(path, state, force=True)
            ckptr.wait_until_finished()
            return
    leaves, treedef = jax.tree.flatten(state)
    meta = {
        "treedef": str(treedef),
        "leaves": [
            {"shape": list(np.shape(l)), "dtype": str(np.asarray(l).dtype)}
            for l in leaves
        ],
    }
    np.savez(
        path if path.endswith(".npz") else path + ".npz",
        treedef=json.dumps(meta),
        **{f"leaf_{i}": np.asarray(l) for i, l in enumerate(leaves)},
    )


def restore(path: str, like: Any) -> Any:
    """Restore a state pytree with the structure/dtypes of ``like``.

    Raises CheckpointStructureError if the stored tree structure or any
    leaf shape disagrees with the template (a structure mismatch must
    not surface as a silent wrong-leaf assignment).
    """
    try:
        import orbax.checkpoint as ocp
    except ImportError:
        pass
    else:
        if os.path.isdir(path):
            ckptr = ocp.StandardCheckpointer()
            return ckptr.restore(os.path.abspath(path), like)
    npz = path if path.endswith(".npz") else path + ".npz"
    data = np.load(npz)
    leaves, treedef = jax.tree.flatten(like)
    meta = json.loads(str(data["treedef"]))
    if isinstance(meta, dict):
        if meta["treedef"] != str(treedef):
            raise CheckpointStructureError(
                "stored pytree structure does not match restore template:\n"
                f"  stored:   {meta['treedef']}\n"
                f"  template: {treedef}"
            )
        if len(meta["leaves"]) != len(leaves):
            raise CheckpointStructureError(
                f"stored {len(meta['leaves'])} leaves, template has "
                f"{len(leaves)}"
            )
        for i, (m, l) in enumerate(zip(meta["leaves"], leaves)):
            if tuple(m["shape"]) != tuple(np.shape(l)):
                raise CheckpointStructureError(
                    f"leaf {i}: stored shape {tuple(m['shape'])} != "
                    f"template shape {tuple(np.shape(l))}"
                )
            want = str(np.asarray(l).dtype)
            if m["dtype"] != want:
                # A silent cast (e.g. stored int64 wrapping into an
                # int32 template) would corrupt state undetectably.
                raise CheckpointStructureError(
                    f"leaf {i}: stored dtype {m['dtype']} != template "
                    f"dtype {want}"
                )
    # (legacy payloads stored only a str(treedef); fall through without
    # metadata validation)
    new_leaves = [
        jax.numpy.asarray(data[f"leaf_{i}"], l.dtype)
        for i, l in enumerate(leaves)
    ]
    return jax.tree.unflatten(treedef, new_leaves)
