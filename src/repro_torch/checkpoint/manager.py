"""Checkpointing: atomic, keep-k, async (port of the JAX package's
``checkpoint/manager.py``), on the reference's on-disk format, so a
checkpoint written by either package restores in the other.

One ``arrays.npz`` per step, keyed by the JAX key string of each leaf's
path (``[0]['groups'][0]['l0']['attn']['wq']``, written here without
JAX), and a ``meta.json`` sidecar with ``step`` and ``time``.  A bf16
leaf is stored as its raw 2-byte bits (``'<V2'``), as ``np.savez``
stores an ``ml_dtypes`` bfloat16 array, and read back through the
template's dtype.  Writes go to ``.tmp_step_*`` and are renamed to
``step_%08d``; the ``latest`` symlink flips last through ``os.replace``,
so a preemption mid-write never corrupts the newest complete checkpoint.
Async mode snapshots on the calling thread (a copy, so an in-place
optimizer step cannot reach the checkpoint) and writes on a daemon
thread.  Restore places leaves on the template's device; inside a
``distributed.sharding_context`` each leaf listed in ``axes_tree`` is
placed on the current mesh by its logical axes (the reference's elastic
rescale: the checkpoint holds whole arrays, whatever mesh wrote them).
A DTensor leaf is saved whole (gathered on every rank).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.models.params import (tree_flatten_with_path,
                                       tree_unflatten_like)
from repro_torch.obs.clock import now, to_wall


def keystr(path) -> str:
    """``jax.tree_util.keystr`` of a key path of dict keys and sequence
    indices."""
    return "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]"
                   for k in path)


def _flatten(tree) -> dict:
    return {keystr(p): leaf for p, leaf in tree_flatten_with_path(tree)}


def _to_host(leaf) -> np.ndarray:
    """A host copy of one leaf, never a view of live memory."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf)
    from repro_torch.distributed import sharding   # imports this module
    t = sharding.full(leaf.detach())
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
        return t.to("cpu", copy=True).numpy().view("V2")
    return t.to("cpu", copy=True).numpy()


def _from_host(arr: np.ndarray, tmpl) -> torch.Tensor:
    """A leaf in fresh torch memory on the template's device, with the
    template's dtype (never a view of the loaded buffer)."""
    if not isinstance(tmpl, torch.Tensor):
        return torch.tensor(arr)
    if arr.dtype.kind == "V":                       # bf16 bits
        if arr.dtype.itemsize != 2 or tmpl.dtype != torch.bfloat16:
            raise ValueError(f"raw {arr.dtype} leaf for a {tmpl.dtype} "
                             "template leaf")
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device=tmpl.device, dtype=tmpl.dtype, copy=True)


@dataclasses.dataclass
class CheckpointManager:
    directory: str
    keep: int = 3
    async_save: bool = False

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None

    # -- save ---------------------------------------------------------------
    def save(self, step: int, tree, metadata: Optional[dict] = None):
        """Snapshot to host memory synchronously; write async if enabled."""
        host = {k: _to_host(v) for k, v in _flatten(tree).items()}
        meta = {"step": step, "time": to_wall(now()), **(metadata or {})}
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, host, meta), daemon=True)
            self._thread.start()
        else:
            self._write(step, host, meta)

    def _write(self, step: int, host: dict, meta: dict):
        tmp = os.path.join(self.directory, f".tmp_step_{step:08d}")
        final = os.path.join(self.directory, f"step_{step:08d}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **host)
        with open(os.path.join(tmp, "meta.json"), "w") as f:
            json.dump(meta, f)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)                       # atomic publish
        latest = os.path.join(self.directory, "latest")
        tmp_link = latest + ".tmp"
        if os.path.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(os.path.basename(final), tmp_link)
        os.replace(tmp_link, latest)
        self._gc()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore --------------------------------------------------------------
    def all_steps(self):
        out = []
        for d in os.listdir(self.directory):
            if d.startswith("step_") and os.path.isdir(
                    os.path.join(self.directory, d)):
                out.append(int(d.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                axes_tree=None):
        """Restore into the structure of ``template`` (values ignored; its
        leaves give each restored leaf's dtype and device).  Returns
        (tree, meta), or (None, None) when there is no checkpoint.  With
        an active sharding context and ``axes_tree`` (the template's
        logical axes), every leaf it lists is placed under the current
        mesh's rules."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        path = os.path.join(self.directory, f"step_{step:08d}")
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        from repro_torch.distributed import sharding
        ctx = sharding.current_ctx()
        axes = dict(sharding.axes_leaves(axes_tree)) \
            if ctx is not None and axes_tree is not None else {}
        leaves = []
        with np.load(os.path.join(path, "arrays.npz")) as blobs:
            for p, tmpl in tree_flatten_with_path(template):
                t = _from_host(blobs[keystr(p)], tmpl)
                if p in axes:
                    t = sharding.place(t, axes[p], ctx)
                leaves.append(t)
        return tree_unflatten_like(template, leaves), meta
