"""Checkpoint / resume for training state.

The reference's only resume mechanism is stage-level artifact caching
("skip if output exists", reference: model/count_co_events.py:84-89,
model/w2vec_aids.py:49-53); a crash mid-training restarts the stage. Here
training loops additionally checkpoint their full state (params, optimizer
accumulators, step counter, RNG key) so long runs resume mid-stage — the
Orbax-style sharded-array checkpointing noted in SURVEY.md §5.4, kept
dependency-light: pytree leaves -> npz + structure manifest.
"""
from __future__ import annotations

import json
import logging
import os
import tempfile
from typing import Any, Dict, Optional, Tuple

import jax
import numpy as np

log = logging.getLogger(__name__)


def save_checkpoint(
    path: str, state: Any, step: int, meta: Optional[Dict] = None
) -> None:
    """Atomically persist a pytree + step counter. `meta` (a small JSON-able
    dict, e.g. vocab size / config fingerprint) is stored alongside and
    validated on load — a stale checkpoint from a run with a different
    configuration must be discarded, not silently restored (JAX clamps
    out-of-range gather indices, so a vocab mismatch would otherwise train
    on corrupted tables without erroring)."""
    leaves, treedef = jax.tree_util.tree_flatten(state)
    payload = {f"leaf_{i}": np.asarray(x) for i, x in enumerate(leaves)}
    payload["__step__"] = np.asarray(step, np.int64)
    if meta is not None:
        payload["__meta__"] = np.asarray(json.dumps(meta, sort_keys=True))
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        np.savez(tmp, **payload)
        # np.savez appends .npz to the name
        os.replace(tmp + ".npz", path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def load_checkpoint(
    path: str, like: Any, expect_meta: Optional[Dict] = None
) -> Optional[Tuple[Any, int]]:
    """Restore a pytree with the structure of `like`. None if absent.

    The checkpoint is DISCARDED (None, with a warning) rather than restored
    when it does not match the caller's expectation: leaf count or leaf
    shapes differ from `like`, or the stored meta dict differs from
    `expect_meta`. Shapes come from the file, not the template, so without
    this check a checkpoint written under a different vocab/dim would load
    "successfully" and corrupt training downstream."""
    if not os.path.exists(path):
        return None
    z = np.load(path)
    leaves, treedef = jax.tree_util.tree_flatten(like)
    n_stored = sum(1 for k in z.files if k.startswith("leaf_"))
    if n_stored != len(leaves):
        log.warning(
            "checkpoint %s discarded: %d leaves stored, %d expected",
            path, n_stored, len(leaves),
        )
        return None
    for i, leaf in enumerate(leaves):
        want = np.shape(leaf)
        got = z[f"leaf_{i}"].shape
        if tuple(got) != tuple(want):
            log.warning(
                "checkpoint %s discarded: leaf %d shape %s != expected %s",
                path, i, got, want,
            )
            return None
    if expect_meta is not None:
        stored = (
            json.loads(str(z["__meta__"])) if "__meta__" in z.files else None
        )
        want_meta = json.loads(json.dumps(expect_meta, sort_keys=True))
        if stored != want_meta:
            log.warning(
                "checkpoint %s discarded: meta %s != expected %s",
                path, stored, want_meta,
            )
            return None
    restored = [
        jax.numpy.asarray(z[f"leaf_{i}"]) for i in range(len(leaves))
    ]
    state = jax.tree_util.tree_unflatten(treedef, restored)
    return state, int(z["__step__"])
