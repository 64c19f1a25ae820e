"""``repro_torch.obs.flight`` — deterministic capture of serving incidents
(port of the JAX package's ``obs/flight``).

The engine is a deterministic state machine over two nondeterministic
input streams: request submissions and clock observations.  Its
bit-identity gates (cache hit == cold prefill, rollback == never
drafted, resume == never preempted), every step a CUDA graph and the
kernels' fixed-order sums mean that feeding both streams back verbatim
reproduces every runtime decision (the rung the controller picked, when
spec decoding switched gamma, who got preempted) and every served
token, bit for bit.  The :class:`FlightRecorder` is the capture side;
:mod:`repro_torch.obs.flight.replay` re-drives an engine from it.

One ordered JSONL stream of records, in the reference's format:

* ``header`` — schema version, engine config, params and ladder
  fingerprints, and caller-supplied reconstruction metadata (arch /
  seed / ladder path) so the replay CLI can rebuild the engine.
* ``clock`` — one record per engine clock read (``t`` plus the consuming
  call-site tag ``s``), captured by wrapping the engine's injected clock
  (:mod:`repro_torch.obs.clock`).
* ``submit`` — the raw arguments of each ``Engine.submit`` call.
* ``decision`` — every resulting runtime decision (rung / gamma /
  drafter switches, preemptions, resumes, rejects, prefix evictions,
  saliency-drift edges), recorded for verification on replay.
* ``finish`` — each request's terminal record: finish reason, the full
  token stream and the per-token rung residency.

Black-box mode: records land in a bounded in-memory ring (the engine's
emit sites are ``is not None`` checks when the recorder is off) and are
written out only on a trigger: engine exception, SLO-breach escalation,
``saliency_drift`` edge, SIGUSR1, or the gateway's
``GET /v1/debug/flight``.  An optional JSONL ``sink`` streams every
record from the start; that file is complete and therefore replayable.
A ring dump that overflowed is marked ``complete: false`` and the replay
loader refuses it.

The fingerprints hash the bytes the reference hashes, in its order and
under numpy's dtype and shape spellings, so a recording made by one
package carries the other's fingerprints for the same configuration,
weights and ladder.
"""
from __future__ import annotations

import collections
import concurrent.futures
import dataclasses
import hashlib
import json
import os
import threading
import weakref
from typing import Any, Dict, List, Optional

import torch

from repro_torch.obs.clock import ReplayClock, ReplayDivergence

# Flight recording format version; the replay loader gates on it.
FLIGHT_SCHEMA_VERSION = 1

# SLO-breach reasons that trigger a black-box dump: the controller
# escalated because latency or queue pressure broke the objective.
_SLO_BREACH_REASONS = ("tpot", "queue")


def _leaves(tree):
    """Leaves of a dict/list/tuple tree in ``jax.tree_util.tree_leaves``
    order: dict keys sorted, sequences in index order, ``None`` empty."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def _host_bytes(leaf):
    """(numpy's dtype name, numpy's shape tuple, the raw bytes as a flat
    host array) of one leaf, as the reference hashes it; bf16 goes
    through a 16-bit integer view, which numpy cannot hold as such."""
    t = torch.as_tensor(leaf).detach()
    head = (str(t.dtype).removeprefix("torch.").encode(),
            str(tuple(t.shape)).encode())
    t = t.cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return head, t.numpy().reshape(-1)


def _hash_leaves(h, leaves) -> None:
    """Feed ``leaves`` in order, each leaf's copy to the host overlapping
    the hash of the one before (both release the interpreter lock; at
    full width the copies move 16 GB)."""
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        nxt = pool.submit(_host_bytes, leaves[0]) if leaves else None
        for i in range(len(leaves)):
            (dtype, shape), data = nxt.result()
            if i + 1 < len(leaves):
                nxt = pool.submit(_host_bytes, leaves[i + 1])
            h.update(dtype)
            h.update(shape)
            h.update(data)


def _reference_repr(pol) -> str:
    """A policy's repr as the reference's ``SparsityPolicy`` prints it:
    the port has no ``interpret`` field (the reference's Pallas
    interpret-mode switch), which the reference prints as ``None``."""
    return repr(pol).replace(", role_backends=",
                             ", interpret=None, role_backends=", 1)


def config_fingerprint(ecfg) -> str:
    """Stable hash of an :class:`EngineConfig`: the frozen dataclass repr
    (every field that shapes engine decisions), as the reference prints
    it."""
    text = repr(ecfg).replace(repr(ecfg.policy),
                              _reference_repr(ecfg.policy), 1)
    return hashlib.sha256(text.encode()).hexdigest()[:16]


# the last params hashed: weak references to their leaves, each leaf's
# version counter (it moves on every in-place write) and the hash; at
# full width one hash reads 16 GB, and a replay engine over the same
# tensors asks again
_PARAMS_FP: List[tuple] = []


def params_fingerprint(params) -> str:
    """Content hash of the model parameters.  Replay gates on it so a
    reconstruction mismatch (another arch or seed) is diagnosed by name
    instead of surfacing as a token divergence at index 0.  Computed
    once per parameter content: asked again for the very same tensors,
    none written since, it returns the hash it kept."""
    leaves = list(_leaves(params))
    versions = [t._version for t in leaves]
    if _PARAMS_FP:
        refs, kept_versions, fp = _PARAMS_FP[0]
        if len(refs) == len(leaves) and kept_versions == versions and all(
                r() is t for r, t in zip(refs, leaves)):
            return fp
    h = hashlib.sha256()
    _hash_leaves(h, leaves)
    fp = h.hexdigest()[:16]
    _PARAMS_FP[:] = [([weakref.ref(t) for t in leaves], versions, fp)]
    return fp


def ladder_fingerprint(ladder) -> Optional[str]:
    """Hash of a :class:`PolicyLadder`'s decision-relevant content:
    budgets, per-rung policy reprs and every sp-tree leaf's bytes.  Two
    ladders with equal fingerprints drive the engine identically."""
    if ladder is None:
        return None
    h = hashlib.sha256()
    h.update(repr(tuple(ladder.budgets)).encode())
    for pol in ladder.policies:
        h.update(_reference_repr(pol).encode())
    for sp in ladder.sps:
        _hash_leaves(h, list(_leaves(sp)))
    return h.hexdigest()[:16]


def _config_to_dict(ecfg) -> dict:
    """JSON image of an EngineConfig for the replay CLI.  The policy is
    covered by the fingerprint; only whether it is dense is recorded."""
    out = {f: getattr(ecfg, f) for f in (
        "max_slots", "max_len", "prefill_chunk", "prefill_dense_frac",
        "prefill_strategy", "eos_id", "initial_rung", "prefix_cache",
        "prefix_cache_tokens")}
    out["policy_dense"] = ecfg.policy.is_dense
    for name in ("slo", "spec", "scheduler"):
        sub = getattr(ecfg, name)
        out[name] = None if sub is None else dataclasses.asdict(sub)
    return out


class _RecordingClock:
    """Wraps the engine's base clock: every read is logged to the
    recorder (with its call-site tag) before being returned."""

    __slots__ = ("_base", "_recorder")

    def __init__(self, base, recorder: "FlightRecorder"):
        self._base = base
        self._recorder = recorder

    def now(self, site: str = "") -> float:
        t = self._base.now(site)
        self._recorder._append({"k": "clock", "t": t, "s": site})
        return t


class FlightRecorder:
    """Engine-boundary capture into a bounded ring (+ optional full
    JSONL sink) with dump-on-trigger.

    One recorder serves one engine: :meth:`attach_engine` (called by the
    engine at construction when ``Telemetry.flight`` is set) writes the
    header record and returns the recording clock the engine reads time
    through.

    ``capacity``   ring size in records (black-box retention window).
    ``sink``       optional path: stream every record as JSONL from the
                   start — the complete recording replay needs.
    ``dump_dir``   where triggered ring dumps land
                   (``flight-<reason>-<n>.jsonl``); None disables dumps.
    ``max_dumps``  cap on triggered dumps per run.
    ``meta``       caller-supplied reconstruction info for the replay
                   CLI (arch, reduced, seed, ladder_path, ...).

    The engine thread appends while the gateway's thread may read: every
    reader copies the ring first (:meth:`_snapshot`), under the lock that
    each append takes.
    """

    def __init__(self, capacity: int = 4096, sink: Optional[str] = None,
                 dump_dir: Optional[str] = None, max_dumps: int = 16,
                 meta: Optional[dict] = None):
        if capacity <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        if max_dumps < 0:
            raise ValueError(f"max_dumps must be >= 0, got {max_dumps}")
        self.capacity = capacity
        self.dump_dir = dump_dir
        self.max_dumps = max_dumps
        self.meta = dict(meta or {})
        self._ring = collections.deque(maxlen=capacity)
        self.count = 0
        # the ring and the count change together, under this lock, so a
        # reader on another thread (the gateway's debug handler) copies a
        # ring whose last record is record ``count - 1``
        self._lock = threading.Lock()
        self.dumps: List[str] = []
        self._header: Optional[dict] = None
        self._attached = False
        self._fh = None
        self._sink_path = sink
        if sink:
            # held for the recorder's lifetime, closed in close()
            self._fh = open(sink, "w")  # noqa: SIM115

    # ------------------------------------------------------------------
    # wiring
    # ------------------------------------------------------------------
    def attach_engine(self, engine) -> _RecordingClock:
        """Write the header record for ``engine`` and return the
        recording clock it must read time through.  One engine per
        recorder: the stream is a single totally ordered history."""
        if self._attached:
            raise RuntimeError(
                "FlightRecorder already attached: one recorder records "
                "one engine's history")
        self._attached = True
        self._header = {
            "k": "header",
            "flight_schema_version": FLIGHT_SCHEMA_VERSION,
            "config_fingerprint": config_fingerprint(engine.ecfg),
            "params_fingerprint": params_fingerprint(engine.params),
            "ladder_fingerprint": ladder_fingerprint(engine.ladder),
            "num_rungs": engine.num_rungs,
            "ecfg": _config_to_dict(engine.ecfg),
            "meta": self.meta,
        }
        self._append(self._header)
        return _RecordingClock(engine.clock, self)

    @property
    def dropped(self) -> int:
        """Records evicted from the ring (0 <=> the ring alone still
        holds the complete history)."""
        return max(0, self.count - self.capacity)

    # ------------------------------------------------------------------
    # record kinds
    # ------------------------------------------------------------------
    def _append(self, rec: dict) -> None:
        with self._lock:
            self._ring.append(rec)
            self.count += 1
        if self._fh is not None:
            self._fh.write(json.dumps(rec) + "\n")
            self._fh.flush()

    def record_submit(self, prompt, max_new_tokens: int, eos_id,
                      arrival_time, priority, tenant: str,
                      queue_deadline_s) -> None:
        """The raw ``Engine.submit`` arguments, recorded before the
        admission decision and before any clock read the call makes, so
        the replay loop can re-issue the call verbatim."""
        self._append({
            "k": "submit",
            "prompt": [int(t) for t in prompt],
            "max_new_tokens": int(max_new_tokens),
            "eos_id": None if eos_id is None else int(eos_id),
            "arrival_time": None if arrival_time is None
            else float(arrival_time),
            "priority": int(priority),
            "tenant": tenant,
            "queue_deadline_s": None if queue_deadline_s is None
            else float(queue_deadline_s),
        })

    def decision(self, kind: str, **fields) -> None:
        """A runtime decision (rung_switch, preempt, resume, reject,
        gamma_switch, drafter_switch, prefix_evict, saliency_drift...),
        recorded for replay verification; SLO-breach escalations and
        saliency-drift edges also trigger a black-box dump."""
        rec = {"k": "decision", "kind": kind}
        rec.update(fields)
        self._append(rec)
        if kind == "rung_switch" \
                and fields.get("reason") in _SLO_BREACH_REASONS \
                and fields.get("to_rung", 0) > fields.get("from_rung", 0):
            self.dump("slo_breach")
        elif kind == "saliency_drift":
            self.dump("saliency_drift")

    def finish(self, request_id: int, reason: Optional[str],
               tokens: List[int], token_rungs: List[int]) -> None:
        """A request's terminal record: the bit-identity payload."""
        self._append({
            "k": "finish", "request": int(request_id), "reason": reason,
            "tokens": [int(t) for t in tokens],
            "token_rungs": [int(r) for r in token_rungs],
        })

    # ------------------------------------------------------------------
    # dump-on-trigger
    # ------------------------------------------------------------------
    def _snapshot(self) -> tuple:
        """(ring copy, count) consistent with each other: taken under the
        lock ``_append`` holds, so the engine thread cannot append between
        the two reads or while the deque is copied."""
        with self._lock:
            return list(self._ring), self.count

    def dump(self, reason: str) -> Optional[str]:
        """Write the ring's current contents to
        ``dump_dir/flight-<reason>-<n>.jsonl``.  The first line is a dump
        prologue naming the trigger and whether the ring still holds the
        complete history.  Returns the path, or None when dumping is
        disabled or the per-run cap is reached."""
        if self.dump_dir is None or len(self.dumps) >= self.max_dumps:
            return None
        os.makedirs(self.dump_dir, exist_ok=True)
        path = os.path.join(
            self.dump_dir, f"flight-{reason}-{len(self.dumps)}.jsonl")
        records, count = self._snapshot()
        with open(path, "w") as f:
            f.write(json.dumps({
                "k": "dump", "reason": reason, "count": count,
                "retained": len(records),
                "complete": count <= self.capacity}) + "\n")
            for rec in records:
                f.write(json.dumps(rec) + "\n")
        self.dumps.append(path)
        return path

    def debug_snapshot(self) -> Dict[str, Any]:
        """Ring contents + counters for the gateway's
        ``GET /v1/debug/flight``."""
        records, count = self._snapshot()
        dropped = max(0, count - self.capacity)
        return {
            "flight_schema_version": FLIGHT_SCHEMA_VERSION,
            "count": count,
            "retained": len(records),
            "dropped": dropped,
            "complete": dropped == 0,
            "sink": self._sink_path,
            "dumps": list(self.dumps),
            "records": records,
        }

    def records(self, kind: Optional[str] = None) -> List[dict]:
        """Retained records, oldest first, optionally filtered by ``k``."""
        records, _ = self._snapshot()
        if kind is None:
            return records
        return [r for r in records if r.get("k") == kind]

    # ------------------------------------------------------------------
    def close(self) -> None:
        """Seal the sink with an end record (replay uses it to assert the
        stream was not truncated mid-write).  Idempotent."""
        if self._fh is not None:
            self._fh.write(json.dumps(
                {"k": "end", "count": self.count, "complete": True}) + "\n")
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "FlightRecorder":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


__all__ = [
    "FLIGHT_SCHEMA_VERSION", "FlightRecorder",
    "config_fingerprint", "params_fingerprint", "ladder_fingerprint",
    "ReplayClock", "ReplayDivergence",
]
