"""Checkpoint / resume of the full DDLO state.

The reference has NO checkpointing (SURVEY.md §5): its closest artifacts
are the ``save_pcd`` map snapshot (map.cc:158-189) and the continuous
pose-file append (odom.cc:704-709). For long sweeps this framework
adds real save/restore of the complete pytree state — odometry pose +
keyframe store + tracker slots (+ optionally the global map) — as a flat
``.npz`` of leaves plus the treedef, so a replay can resume mid-sequence
bit-exactly.
"""

from __future__ import annotations

import json
from typing import Any, Optional, Tuple

import jax
import numpy as np


def save(path: str, state: Any, meta: Optional[dict] = None) -> None:
    """Save any pytree of arrays to ``path`` (.npz)."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    arrays = {f"leaf_{i}": np.asarray(leaf) for i, leaf in enumerate(leaves)}
    arrays["__meta__"] = np.frombuffer(
        json.dumps(meta or {}).encode(), dtype=np.uint8
    )
    np.savez_compressed(path, **arrays)


def restore(path: str, like: Any) -> Tuple[Any, dict]:
    """Restore a pytree saved by :func:`save` into the structure of
    ``like`` (an example state with the right treedef/shapes)."""
    data = np.load(path)
    _, treedef = jax.tree_util.tree_flatten(like)
    n = treedef.num_leaves
    leaves = [data[f"leaf_{i}"] for i in range(n)]
    meta = json.loads(bytes(data["__meta__"]).decode()) if "__meta__" in data else {}
    like_leaves = jax.tree_util.tree_leaves(like)
    for i, (got, want) in enumerate(zip(leaves, like_leaves)):
        if tuple(got.shape) != tuple(np.shape(want)):
            raise ValueError(
                f"leaf {i}: checkpoint shape {got.shape} != state shape "
                f"{np.shape(want)} — capacities/config changed since save"
            )
    return jax.tree_util.tree_unflatten(treedef, leaves), meta
