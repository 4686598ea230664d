"""Fault-tolerant checkpointing: atomic, content-hashed, auto-resuming
(counterpart of ``repro.checkpoint.manager``, in its on-disk format).

Layout: <dir>/step_<N:08d>/
    arrays.npz      flattened leaves (key = "/"-joined tree path)
    meta.json       step, content hash, sorted keys, wall time, extra

A tree is nested dicts (keys sorted, as JAX flattens them) whose leaves
are numpy arrays, torch tensors or Python scalars; each leaf is saved as
``np.asarray`` of it on the host, so a Python int is saved as numpy's
default integer, as JAX's manager saves it. The content hash is the same
sha256 over the sorted keys and the leaves' bytes, so the same state
hashes the same in both packages and a checkpoint written by either
restores in the other. Writes go to a temporary directory and are
published by an atomic rename; ``restore_latest`` walks the steps down
and skips a checkpoint whose hash fails. Async mode copies the state to
the host at once and writes it on a thread.
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _flatten(tree, prefix: str = "") -> dict[str, np.ndarray]:
    if not isinstance(tree, dict):
        return {prefix: _host(tree)}
    flat = {}
    for k in sorted(tree):
        flat.update(_flatten(tree[k], f"{prefix}/{k}" if prefix else str(k)))
    return flat


def _content_hash(flat: dict[str, np.ndarray]) -> str:
    """JAX's hash: sha256 over each sorted key and its leaf's bytes (read
    through the buffer, not copied out as JAX's ``tobytes`` does)."""
    h = hashlib.sha256()
    for k in sorted(flat):
        h.update(k.encode())
        h.update(memoryview(np.ascontiguousarray(flat[k])).cast("B"))
    return h.hexdigest()


def _unflatten(like, flat: dict, prefix: str = ""):
    if not isinstance(like, dict):
        ref = _host(like)
        return np.asarray(flat[prefix], dtype=ref.dtype).reshape(ref.shape)
    return {k: _unflatten(v, flat, f"{prefix}/{k}" if prefix else str(k))
            for k, v in like.items()}


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3,
                 async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------
    def save(self, step: int, tree: Any, extra: Optional[dict] = None):
        flat = _flatten(tree)                  # device -> host copy now
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_sync, args=(step, flat, extra))
            self._thread.start()
        else:
            self._save_sync(step, flat, extra)

    def _save_sync(self, step: int, flat: dict, extra: Optional[dict]):
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}"
        tmp.mkdir(parents=True, exist_ok=True)
        np.savez(tmp / "arrays.npz", **flat)
        meta = {
            "step": step,
            "hash": _content_hash(flat),
            "keys": sorted(flat),
            "time": time.time(),
            "extra": extra or {},
        }
        (tmp / "meta.json").write_text(json.dumps(meta))
        final = self.dir / f"step_{step:08d}"
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)                 # atomic publish
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.dir.glob("step_*"))
        for old in steps[:-self.keep]:
            shutil.rmtree(old, ignore_errors=True)

    # -- restore ------------------------------------------------------
    def steps(self) -> list[int]:
        return sorted(int(p.name.split("_")[1])
                      for p in self.dir.glob("step_*"))

    def meta(self, step: int) -> dict:
        return json.loads(
            (self.dir / f"step_{step:08d}" / "meta.json").read_text())

    def restore(self, step: int, like: Any) -> Any:
        """The tree saved at ``step`` as numpy leaves of ``like``'s
        structure, dtypes and shapes; raises if its hash fails."""
        path = self.dir / f"step_{step:08d}"
        meta = json.loads((path / "meta.json").read_text())
        with np.load(path / "arrays.npz") as z:
            flat = {k: z[k] for k in z.files}
        if _content_hash(flat) != meta["hash"]:
            raise IOError(f"checkpoint {step} failed integrity check")
        return _unflatten(like, flat)

    def restore_latest(self, like: Any) -> tuple[Optional[int], Any]:
        """Newest checkpoint that passes integrity; (None, like) if none."""
        for step in reversed(self.steps()):
            try:
                return step, self.restore(step, like)
            except Exception:
                continue
        return None, like
