"""Slot-based KV cache pool (port of the core of the JAX package's
``serving/kv_pool.py``).

One fixed ``(max_slots, max_len)`` cache tree is allocated up front from
``api.cache_schema`` and lives for the engine's lifetime; requests borrow
a slot (the batch index) and return it on completion.  The forward
writes decode, chunked-prefill and verify K/V into the pool tensors in
place (where the reference donates the pool through each jitted step).
Rollback truncates rejected draft positions out of the pool
(speculative decoding).  Prefix segments and suspend/resume come with
the prefix cache and preemption."""
from __future__ import annotations

from typing import List, Set

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


class SlotKVPool:
    def __init__(self, cfg: ModelConfig, max_slots: int, max_len: int,
                 device="cuda"):
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.caches = api.init_caches(cfg, max_slots, max_len, device)
        # rollback truncates by absolute time position, which is only
        # meaningful when every leaf is a full-length self-attn cache
        # (K (reps,S,KV,hd,T), V (reps,S,KV,T,hd))
        self._can_rollback = all(
            e["self"]["k"].shape[-1] == max_len
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
        """Copy request ``src_idx`` of a prefill cache tree (a shorter time
        dim is allowed) into ``slot`` at time offset 0, in place."""
        self._check_allocated(slot, "insert")
        for pool_g, pref_g in zip(self.caches, prefill_caches):
            for pool_e, pref_e in zip(pool_g, pref_g):
                pk, pv = pool_e["self"]["k"], pool_e["self"]["v"]
                fk, fv = pref_e["self"]["k"], pref_e["self"]["v"]
                t = fk.shape[-1]                 # K (reps,B,KV,hd,T)
                pk[:, slot, :, :, :t] = fk[:, src_idx]
                pv[:, slot, :, :t, :] = fv[:, src_idx]
        self.lengths[slot] = length
