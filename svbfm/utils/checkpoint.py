"""Checkpoint/resume for training state pytrees.

The reference has essentially no checkpointing (the only parameter dumps are
the initial V to ``v_file.txt``, ``fm_model.h:98``, and ``-out`` predictions;
its ``num_complete_iter`` resume hooks were never built —
``fm_learn_vb_simultaneous.h:20``).  Here any learner state (a pytree
dataclass of jax/numpy arrays) checkpoints atomically to a single ``.npz`` with
its iteration counter and an optional metadata dict, and restores into the
exact pytree structure (shardings re-applied by the learner's
``init_state``-style placement on first use).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Optional, Tuple

import jax
import numpy as np


def _flatten_with_names(tree):
    flat, treedef = jax.tree_util.tree_flatten_with_path(tree)
    names, leaves = [], []
    for path, leaf in flat:
        names.append(jax.tree_util.keystr(path))
        leaves.append(np.asarray(leaf))
    return names, leaves, treedef


def save_checkpoint(path: str, state: Any, step: int,
                    meta: Optional[dict] = None) -> None:
    """Atomically write ``state`` (+ step + meta) to ``path`` (.npz)."""
    names, leaves, _ = _flatten_with_names(state)
    payload = {f"leaf_{i}": leaf for i, leaf in enumerate(leaves)}
    payload["__names__"] = np.asarray(names)
    payload["__step__"] = np.asarray(step)
    payload["__meta__"] = np.asarray(json.dumps(meta or {}))
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str, template: Any) -> Tuple[Any, int, dict]:
    """Restore a checkpoint into the structure of ``template``.

    Leaf order/names must match the template's pytree (guarded)."""
    with np.load(path, allow_pickle=False) as z:
        names = [str(n) for n in z["__names__"]]
        step = int(z["__step__"])
        meta = json.loads(str(z["__meta__"]))
        leaves = [z[f"leaf_{i}"] for i in range(len(names))]
    t_names, t_leaves, treedef = _flatten_with_names(template)
    if t_names != names:
        raise ValueError(
            f"checkpoint structure mismatch: {names[:3]}... vs {t_names[:3]}...")
    for name, a, b in zip(names, leaves, t_leaves):
        if a.shape != b.shape:
            raise ValueError(f"checkpoint leaf {name} shape {a.shape} != "
                             f"expected {b.shape}")
    state = jax.tree_util.tree_unflatten(treedef, leaves)
    return state, step, meta


def latest_checkpoint(ckpt_dir: str, prefix: str = "ckpt") -> Optional[str]:
    """Path of the highest-step ``<prefix>_<step>.npz`` in ``ckpt_dir``."""
    if not os.path.isdir(ckpt_dir):
        return None
    best, best_step = None, -1
    for fn in os.listdir(ckpt_dir):
        if fn.startswith(prefix + "_") and fn.endswith(".npz"):
            try:
                step = int(fn[len(prefix) + 1:-4])
            except ValueError:
                continue
            if step > best_step:
                best, best_step = os.path.join(ckpt_dir, fn), step
    return best


class CheckpointManager:
    """Keeps the ``max_to_keep`` newest ``ckpt_<step>.npz`` files."""

    def __init__(self, ckpt_dir: str, prefix: str = "ckpt",
                 max_to_keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.prefix = prefix
        self.max_to_keep = max_to_keep

    def save(self, state: Any, step: int, meta: Optional[dict] = None) -> str:
        path = os.path.join(self.ckpt_dir, f"{self.prefix}_{step}.npz")
        save_checkpoint(path, state, step, meta)
        self._gc()
        return path

    def restore_latest(self, template: Any):
        path = latest_checkpoint(self.ckpt_dir, self.prefix)
        if path is None:
            return None
        return load_checkpoint(path, template)

    def _gc(self) -> None:
        entries = []
        for fn in os.listdir(self.ckpt_dir):
            if fn.startswith(self.prefix + "_") and fn.endswith(".npz"):
                try:
                    entries.append((int(fn[len(self.prefix) + 1:-4]), fn))
                except ValueError:
                    pass
        entries.sort()
        for _step, fn in entries[:-self.max_to_keep or None]:
            os.unlink(os.path.join(self.ckpt_dir, fn))
