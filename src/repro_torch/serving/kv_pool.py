"""Slot-based KV cache pool (port of the JAX package's
``serving/kv_pool.py``).

One fixed ``(max_slots, max_len)`` cache tree is allocated up front from
``api.cache_schema`` and lives for the engine's lifetime; requests borrow
a slot (the batch index) and return it on completion.  Each leaf keeps
its own time length: ``max_len``, or a ``local`` layer's window where
that is shorter, into which ``insert`` copies a rolled prefill cache
whole.  A ``mamba`` layer's entry (``"ssm"``: conv windows and the f32
state) has no time axis at all: ``insert`` copies a slot's rows whole.
A pool with a window or SSM leaf cannot roll back, extract or write
prefix segments (the reference's precondition, ``can_cache_prefix``),
and so cannot suspend or resume a slot either.  The forward
writes decode, chunked-prefill and verify K/V into the pool tensors in
place (where the reference donates the pool through each jitted step).
Rollback truncates rejected draft positions out of the pool
(speculative decoding).

The pool tensors are never rebound: the engine's captured CUDA graphs
(``serving/graphs.py``) hold them by address.  So where the reference
returns a new pool from a donated ``dynamic_update_slice``, every write
here is a ``copy_`` into a slice of the existing tensors.

Prefix caching adds an immutable segment layer
(``repro_torch.serving.prefix_cache``): ``extract_prefix`` copies the
first ``length`` cache positions of a slot out of the pool into a fresh
segment tree (``api.prefix_segment_schema``: batch 1, ``length``
positions; one strided copy per cache leaf) and ``write_prefix`` copies
a segment back into a slot at offset 0, in place.  Segments are never
mutated — a slot that received one only ever appends *past* the copied
prefix — so one cached prefix can seed any number of slots.  A copy
builds nothing (no graph: a segment's address differs per segment), so
there is nothing to warm and no build to count.

Preemption generalizes the same two primitives into whole-slot
``suspend``/``resume``: ``suspend`` extracts the slot's live prefix at a
chunk-quantized length and moves it to host memory (a blocking copy, so
the slot can be freed the moment it returns), and ``resume`` writes it
back into any slot and restores the exact live length.  The quantized
tail past the live length holds whatever the victim's last forward left
there, and is never attended: decode masks positions ``>= length`` and
any later write overwrites them — the argument that makes prefix-segment
admission safe too.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Set

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import params as P


def _rows(path, leaf, slot: int, length: int) -> torch.Tensor:
    """The view of ``slot``'s first ``length`` positions of one cache
    leaf, batch dim kept: K (reps,1,KV,hd,length), V (reps,1,KV,length,hd)."""
    rows = leaf[:, slot:slot + 1]
    return rows[..., :length] if path[-1] == "k" else rows[..., :length, :]


def _time_len(path, leaf) -> int:
    return leaf.shape[-1] if path[-1] == "k" else leaf.shape[-2]


def _leaves(tree) -> list:
    """(path, leaf) of every cache leaf, in tree order."""
    out = []
    P.tree_map_with_path(lambda p, leaf: out.append((p, leaf)), tree)
    return out


@dataclasses.dataclass(frozen=True)
class SuspendedSlot:
    """Host-side snapshot of a preempted slot's KV state.

    ``caches`` is a segment tree (leaf batch dims 1, time dim ``phys``)
    in host memory; ``length`` is the exact live length at suspension;
    ``phys`` the chunk-quantized extent that was copied (``length``
    rounded up to a multiple of the suspend quantum)."""
    caches: Any
    length: int
    phys: int


class SlotKVPool:
    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int,
                 device="cuda"):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.caches = api.init_caches(cfg, max_slots, max_len, device)
        # rollback truncates by absolute time position, which is only
        # meaningful when every leaf is a full-length self-attn cache
        # (K (reps,S,KV,hd,T), V (reps,S,KV,T,hd)); rolling windows index
        # time modulo the window, and SSM state has no time
        self._can_rollback = all(
            set(e) == {"self"} and e["self"]["k"].shape[-1] == max_len
            and e["self"]["v"].shape[-2] == max_len
            for g in self.caches for e in g)
        self._free: List[int] = list(range(max_slots))[::-1]   # pop() -> 0 first
        self._free_set: Set[int] = set(self._free)
        self.lengths = np.zeros(max_slots, np.int64)

    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def num_occupied(self) -> int:
        return self.max_slots - len(self._free)

    def _check_allocated(self, slot: int, op: str) -> None:
        if not 0 <= slot < self.max_slots:
            raise ValueError(
                f"{op}: slot {slot} outside [0, {self.max_slots})")
        if slot in self._free_set:
            raise ValueError(f"{op}: slot {slot} is not allocated")

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError("no free KV slots")
        slot = self._free.pop()
        self._free_set.remove(slot)
        return slot

    def free(self, slot: int) -> None:
        self._check_allocated(slot, "free")      # double free raises here
        self.lengths[slot] = 0
        self._free.append(slot)
        self._free_set.add(slot)

    def commit(self, slot: int, n: int) -> None:
        """Account ``n`` newly written cache positions to ``slot``
        (bookkeeping only — the forward already wrote them in place)."""
        self._check_allocated(slot, "commit")
        if n < 0:
            raise ValueError(f"commit: negative token count {n}")
        new_len = int(self.lengths[slot]) + n
        if new_len > self.max_len:
            raise ValueError(
                f"commit: slot {slot} length {new_len} exceeds the pool's "
                f"{self.max_len}")
        self.lengths[slot] = new_len

    def rollback(self, slot: int, n: int) -> None:
        """Truncate the last ``n`` committed positions of ``slot``: zero
        their cache entries in place and shrink the slot's length, so
        rejected draft tokens leave no trace: the cache is bit-identical
        to one that never saw them."""
        self.rollback_many({slot: n})

    def rollback_many(self, per_slot) -> None:
        """Roll back several slots in one masked write per cache leaf
        (the spec engine truncates every rejected draft suffix of a round
        at once).  ``per_slot``: {slot: n}.  Validates every entry before
        touching anything."""
        starts = np.copy(self.lengths)
        for slot, n in per_slot.items():
            self._check_allocated(slot, "rollback")
            length = int(self.lengths[slot])
            if not 0 <= n <= length:
                raise ValueError(
                    f"rollback: slot {slot} cannot roll back {n} of "
                    f"{length} positions")
            starts[slot] = length - n
        if all(n == 0 for n in per_slot.values()):
            return
        if not self._can_rollback:
            raise ValueError(
                "rollback needs full-length self-attention caches; "
                "rolling-window and SSM cache layouts cannot truncate by "
                "position")
        # one (S, T) drop mask from device copies of the two (S,) vectors,
        # so no shape depends on how much is rolled back
        k0 = self.caches[0][0]["self"]["k"]
        t = torch.arange(k0.shape[-1], device=k0.device)
        s = torch.from_numpy(starts).to(k0.device)[:, None]
        e = torch.from_numpy(self.lengths).to(k0.device)[:, None]
        drop = (t >= s) & (t < e)                           # (S, T)
        S, T = drop.shape
        drop_k, drop_v = drop.view(1, S, 1, 1, T), drop.view(1, S, 1, T, 1)
        with torch.no_grad():
            for g in self.caches:
                for entry in g:
                    entry["self"]["k"].masked_fill_(drop_k, 0)
                    entry["self"]["v"].masked_fill_(drop_v, 0)
        for slot in per_slot:
            self.lengths[slot] = starts[slot]

    def insert(self, prefill_caches, src_idx: int, slot: int,
               length: int) -> None:
        """Copy request ``src_idx`` of a prefill cache tree into ``slot``,
        in place: K/V at time offset 0 (a shorter time dim is allowed),
        an SSM entry's conv windows and state whole (no time axis)."""
        self._check_allocated(slot, "insert")
        with torch.no_grad():
            for pool_g, pref_g in zip(self.caches, prefill_caches):
                for pool_e, pref_e in zip(pool_g, pref_g):
                    if "self" in pool_e:
                        pk, pv = pool_e["self"]["k"], pool_e["self"]["v"]
                        fk, fv = pref_e["self"]["k"], pref_e["self"]["v"]
                        t = fk.shape[-1]             # K (reps,B,KV,hd,T)
                        pk[:, slot, :, :, :t] = fk[:, src_idx]
                        pv[:, slot, :, :t, :] = fv[:, src_idx]
                    if "ssm" in pool_e:
                        for name, pl in pool_e["ssm"].items():
                            pl[:, slot].copy_(pref_e["ssm"][name][:, src_idx])
        self.lengths[slot] = length

    # ---- prefix segments (repro_torch.serving.prefix_cache) -------------
    @property
    def can_cache_prefix(self) -> bool:
        """Prefix segments slice the time axis by absolute position —
        only meaningful for full-length self-attention caches (the
        precondition of rollback too)."""
        return self._can_rollback

    def extract_prefix(self, slot: int, length: int):
        """Copy cache positions ``[0, length)`` of ``slot`` out of the
        pool into a fresh segment tree (leaf batch dims 1): one strided
        copy per cache leaf."""
        self._check_allocated(slot, "extract_prefix")
        if not self.can_cache_prefix:
            raise ValueError(
                "extract_prefix needs full-length self-attention caches")
        if not 0 < length <= self.max_len:
            raise ValueError(
                f"extract_prefix: length {length} outside (0, {self.max_len}]")
        return P.tree_map_with_path(
            lambda p, leaf: _rows(p, leaf, slot, length).clone(
                memory_format=torch.contiguous_format), self.caches)

    def write_prefix(self, seg, slot: int) -> None:
        """Copy a segment into ``slot`` at offset 0, in place (one
        ``copy_`` per cache leaf; the pool tensors keep their addresses).
        The *whole* segment is copied: positions past the caller's
        matched length are overwritten by the suffix prefill or decode
        before they can be attended, and masked until then.  The segment
        itself is only read (it seeds arbitrarily many slots)."""
        self._check_allocated(slot, "write_prefix")
        if not self.can_cache_prefix:
            raise ValueError(
                "write_prefix needs full-length self-attention caches")
        seg_leaves = _leaves(seg)
        seg_t = {_time_len(p, leaf) for p, leaf in seg_leaves}
        if len(seg_t) != 1 or not 0 < min(seg_t) <= self.max_len:
            raise ValueError(
                f"write_prefix: segment time dims {sorted(seg_t)} do not "
                f"fit this pool's (0, {self.max_len}] positions")
        t = seg_t.pop()
        with torch.no_grad():
            for (p, pl), (_, sl) in zip(_leaves(self.caches), seg_leaves):
                _rows(p, pl, slot, t).copy_(sl)

    # ---- whole-slot suspend/resume (preemption) --------------------------
    def suspend(self, slot: int, quantum: int) -> SuspendedSlot:
        """Snapshot ``slot``'s live KV state to host memory so the slot
        can be freed and the request resumed later bit-identically.

        The copy length is the slot's live length rounded up to a
        multiple of ``quantum`` (the engine's prefill chunk), as the
        reference quantizes it.  The device-to-host copy blocks, so the
        caller may free the slot as soon as this returns; this method
        only reads the pool."""
        self._check_allocated(slot, "suspend")
        if quantum <= 0:
            raise ValueError(f"suspend: quantum {quantum} must be positive")
        length = int(self.lengths[slot])
        if length <= 0:
            raise ValueError(
                f"suspend: slot {slot} has no committed positions")
        phys = min(-(-length // quantum) * quantum, self.max_len)
        seg = self.extract_prefix(slot, phys)
        return SuspendedSlot(caches=P.tree_map(lambda t: t.to("cpu"), seg),
                             length=length, phys=phys)

    def resume(self, seg: SuspendedSlot, slot: int) -> None:
        """Restore a suspended request's KV state into (freshly
        allocated) ``slot``, in place, and reinstate its exact live
        length.  Positions in ``[length, phys)`` hold what they held at
        suspension and stay unattendable, so the restored slot equals the
        suspended one over every attendable position."""
        if not isinstance(seg, SuspendedSlot):
            raise TypeError(
                f"resume: expected a SuspendedSlot, got {type(seg).__name__}")
        self.write_prefix(seg.caches, slot)
        self.lengths[slot] = seg.length
