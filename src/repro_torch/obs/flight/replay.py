"""Bit-identical replay of a flight recording (port of the JAX package's
``obs/flight/replay.py``).

    PYTHONPATH=src python -m repro_torch.obs.flight.replay dump.jsonl [--device cpu]

:func:`replay` re-drives a fresh engine from a recording: a
:class:`~repro_torch.obs.clock.ReplayClock` feeds every recorded clock
observation back verbatim, the replay loop re-issues every recorded
submission in order, and the replay engine records its own flight
stream, which must match the recording record for record.  Gates:

* whole-trace token bit-identity (every ``finish`` record's tokens),
* matching rung residency (every ``finish`` record's ``token_rungs``),
* identical decision stream (rung/gamma/drafter switches, preemptions,
  resumes, rejects, evictions: same order, same fields),
* no step built after warmup (decode, chunk, verify, probe): where the
  reference counts retraces, the port counts graph builds,
* the recording fully consumed (no leftover inputs, engine idle).

On failure the report carries a structured first-divergence diff: for a
token mismatch the request id, the first differing token index and the
rung at that index on both sides; otherwise the first differing record
index with both sides.  The CLI prints the report as JSON and exits
nonzero.

Engine reconstruction: the CLI rebuilds the engine from the recording's
header: ``meta.arch``/``meta.reduced``/``meta.seed`` re-init the params
(``api.init_model``), ``meta.ladder_path`` reloads the ladder npz
(fingerprint-checked against the recording), and the serialized
``ecfg`` restores the engine config.  Library callers with other setups
(weights carried from elsewhere, calibrated fixed policies) pass
``engine_factory`` instead: a callable ``(clock, telemetry) -> Engine``.
A recording made by the JAX package replays here through such a factory
over the same weights and ladder.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from typing import Callable, List, Optional

from repro_torch.obs.clock import ReplayClock, ReplayDivergence
from repro_torch.obs.flight import (FLIGHT_SCHEMA_VERSION, FlightRecorder,
                                    ladder_fingerprint)

# record kinds that drive replay (inputs) against those verified by it
_INPUT_KINDS = ("clock", "submit")


@dataclasses.dataclass
class Recording:
    """A parsed flight recording: the header plus the ordered records
    (header/dump/end framing stripped)."""
    header: dict
    records: List[dict]

    @property
    def inputs(self) -> List[dict]:
        return [r for r in self.records if r.get("k") in _INPUT_KINDS]


@dataclasses.dataclass
class ReplayReport:
    """Outcome of one replay.  ``ok`` is the conjunction of every gate;
    ``failures`` names the broken ones; ``divergence`` is the structured
    first-divergence diff (None when identical).  ``retraces`` holds the
    builds after warmup per step kind, under the reference's name."""
    ok: bool
    failures: List[str]
    divergence: Optional[dict]
    requests: int
    tokens: int
    records_compared: int
    retraces: dict

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def load_recording(path: str) -> Recording:
    """Parse a flight JSONL file (full sink or triggered ring dump).
    Refuses dumps whose ring overflowed (an incomplete history cannot be
    replayed) and recordings of another flight schema."""
    with open(path) as f:
        records = [json.loads(ln) for ln in f if ln.strip()]
    if not records:
        raise ValueError(f"{path}: empty flight recording")
    if records[0].get("k") == "dump":
        prologue, records = records[0], records[1:]
        if not prologue.get("complete"):
            raise ValueError(
                f"{path}: ring dump is incomplete ({prologue['count']} "
                f"records recorded, {prologue['retained']} retained) — "
                "replay needs the full history; arm a JSONL sink "
                "(--flight-record PATH) or a larger --flight-ring")
    if records and records[-1].get("k") == "end":
        records = records[:-1]
    if not records or records[0].get("k") != "header":
        raise ValueError(
            f"{path}: not a flight recording (no header record)")
    header = records[0]
    version = header.get("flight_schema_version")
    if version != FLIGHT_SCHEMA_VERSION:
        raise ValueError(
            f"{path}: flight schema v{version} != supported "
            f"v{FLIGHT_SCHEMA_VERSION}")
    return Recording(header=header, records=records[1:])


# ---------------------------------------------------------------------------
# engine reconstruction from the header
# ---------------------------------------------------------------------------

def engine_factory_from_header(header: dict, device="cuda") -> Callable:
    """Build a ``(clock, telemetry) -> Engine`` factory from a
    recording's header, with the params initialised on ``device``.
    Covers engines the serve CLI can construct: seeded params (arch +
    seed) with an optional ladder npz; fixed-policy engines must prefill
    and decode dense (a calibrated non-dense fixed policy needs a
    caller factory)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.device import resolve_device
    from repro_torch.models import api
    from repro_torch.serving.controller import SLOConfig
    from repro_torch.serving.engine import Engine, EngineConfig
    from repro_torch.serving.scheduler import SchedulerConfig
    from repro_torch.serving.spec import SpecConfig
    from repro_torch.sparsity import PolicyLadder

    meta = header.get("meta", {})
    if "arch" not in meta:
        raise ValueError(
            "recording header has no meta.arch — re-record with "
            "reconstruction metadata, or call replay() with an explicit "
            "engine_factory")
    device = resolve_device(device)
    cfg = get_config(meta["arch"])
    if meta.get("reduced", True):
        cfg = reduced(cfg)
    params = api.init_model(cfg, meta.get("seed", 0), device=device)

    ladder = None
    if header.get("ladder_fingerprint") is not None:
        path = meta.get("ladder_path")
        if not path:
            raise ValueError(
                "recording used a ladder but meta.ladder_path is unset — "
                "pass an engine_factory that rebuilds it")
        ladder = PolicyLadder.load(path, device=device)
        got = ladder_fingerprint(ladder)
        want = header["ladder_fingerprint"]
        if got != want:
            raise ValueError(
                f"ladder artifact {path} fingerprint {got} != recorded "
                f"{want}: the artifact changed since the recording")

    e = dict(header["ecfg"])
    if ladder is None and not e.pop("policy_dense", True):
        raise ValueError(
            "recording used a non-dense fixed policy, which the header "
            "cannot reconstruct — pass an engine_factory")
    e.pop("policy_dense", None)

    def detuple(v):
        # JSON turns tuples into lists; the configs are tuple-typed,
        # possibly nested (and the config fingerprint hashes reprs)
        return tuple(detuple(x) for x in v) if isinstance(v, list) else v

    for name, cls in (("slo", SLOConfig), ("spec", SpecConfig),
                      ("scheduler", SchedulerConfig)):
        if e.get(name) is not None:
            e[name] = cls(**{k: detuple(v) for k, v in e[name].items()})
    ecfg = EngineConfig(**e)

    def factory(clock, telemetry):
        return Engine(params, cfg, ecfg, None, device=device, ladder=ladder,
                      telemetry=telemetry, clock=clock)

    return factory


# ---------------------------------------------------------------------------
# divergence diffing
# ---------------------------------------------------------------------------

def _first_divergence(recorded: List[dict],
                      replayed: List[dict]) -> Optional[dict]:
    """Record-by-record diff; token mismatches get the request-level
    deep diff (request id, token index, rung at that index)."""
    n = min(len(recorded), len(replayed))
    for i in range(n):
        a, b = recorded[i], replayed[i]
        if a == b:
            continue
        out = {"record": i, "recorded": a, "replayed": b}
        if a.get("k") == "finish" and b.get("k") == "finish" \
                and a.get("request") == b.get("request"):
            ta, tb = a.get("tokens", []), b.get("tokens", [])
            ra, rb = a.get("token_rungs", []), b.get("token_rungs", [])
            idx = next((j for j in range(min(len(ta), len(tb)))
                        if ta[j] != tb[j]), min(len(ta), len(tb)))
            out.update({
                "request": a["request"], "token_index": idx,
                "recorded_token": ta[idx] if idx < len(ta) else None,
                "replayed_token": tb[idx] if idx < len(tb) else None,
                "recorded_rung": ra[idx] if idx < len(ra) else None,
                "replayed_rung": rb[idx] if idx < len(rb) else None,
            })
        return out
    if len(recorded) != len(replayed):
        i = n
        return {"record": i,
                "recorded": recorded[i] if i < len(recorded) else None,
                "replayed": replayed[i] if i < len(replayed) else None}
    return None


def _builds_after_warmup(engine) -> dict:
    """Steps built after warmup, per kind (the reference's
    ``_retraces``: its segment executables have no counterpart here, a
    segment copy builds nothing)."""
    return {k: v for k, v in (
        ("decode", engine.decode_retraces_after_warmup),
        ("chunk", engine.chunk_retraces_after_warmup),
        ("verify", engine.verify_retraces_after_warmup),
        ("probe", engine.probe_retraces_after_warmup),
    ) if v is not None}


# ---------------------------------------------------------------------------
# the harness
# ---------------------------------------------------------------------------

def replay(recording, engine_factory: Optional[Callable] = None,
           device="cuda") -> ReplayReport:
    """Re-drive a fresh engine from ``recording`` (a path or a
    :class:`Recording`) and gate bit-identity.

    ``engine_factory(clock, telemetry) -> Engine`` builds the replay
    engine; it must pass both arguments through to the Engine
    constructor and arm no other nondeterministic telemetry.  When None,
    the factory is rebuilt from the recording header, on ``device``."""
    from repro_torch.obs import Telemetry
    from repro_torch.serving.scheduler import QueueFull

    if not isinstance(recording, Recording):
        recording = load_recording(recording)
    if engine_factory is None:
        engine_factory = engine_factory_from_header(recording.header,
                                                    device=device)

    inputs = recording.inputs
    clock = ReplayClock(inputs)
    mirror = FlightRecorder(capacity=len(recording.records) + 64)
    engine = engine_factory(clock, Telemetry(flight=mirror))

    failures: List[str] = []
    divergence: Optional[dict] = None
    try:
        if engine.decode_retraces_after_warmup is None:
            engine.warmup()
        while not clock.exhausted:
            rec = clock.peek()
            if rec["k"] == "submit":
                clock.cursor += 1
                try:
                    engine.submit(
                        rec["prompt"], rec["max_new_tokens"],
                        eos_id=rec["eos_id"],
                        arrival_time=rec["arrival_time"],
                        priority=rec["priority"], tenant=rec["tenant"],
                        queue_deadline_s=rec["queue_deadline_s"])
                except QueueFull:
                    pass            # the recorded run was rejected too:
                #                     the mirrored reject decision proves it
            else:
                # a clock record at the cursor belongs to the next engine
                # step; step() consumes it (and its successors) through
                # the ReplayClock
                engine.step()
        # recorded streams end at an idle engine; drain any deterministic
        # leftovers (none read the clock once the inputs are exhausted,
        # or the ReplayClock raises)
        while engine.scheduler.has_work():
            engine.step()
    except ReplayDivergence as e:
        failures.append(f"desynchronized: {e}")
        divergence = e.detail or None
    finally:
        engine.close()

    # fingerprint gates: same config, same params, same ladder content
    for key in ("config_fingerprint", "params_fingerprint",
                "ladder_fingerprint"):
        if mirror._header is not None \
                and recording.header.get(key) != mirror._header.get(key):
            failures.append(
                f"{key} mismatch: recorded "
                f"{recording.header.get(key)} != replayed "
                f"{mirror._header.get(key)}")

    if not clock.exhausted and not failures:
        failures.append(
            f"replay stalled: {len(inputs) - clock.cursor} recorded "
            f"inputs left unconsumed at record {clock.cursor}")
    if engine.scheduler.has_work():
        failures.append("replay engine not idle after the recording")

    replayed = mirror.records()[1:]         # drop the header record
    if divergence is None:
        divergence = _first_divergence(recording.records, replayed)
        if divergence is not None:
            failures.append(
                f"stream divergence at record {divergence['record']}")

    builds = _builds_after_warmup(engine)
    if any(v != 0 for v in builds.values()):
        failures.append(f"post-warmup retraces: {builds}")

    finishes = [r for r in recording.records if r.get("k") == "finish"]
    return ReplayReport(
        ok=not failures, failures=failures, divergence=divergence,
        requests=len(finishes),
        tokens=sum(len(r.get("tokens", ())) for r in finishes),
        records_compared=min(len(recording.records), len(replayed)),
        retraces=builds)


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="repro_torch.obs.flight.replay",
        description="Re-drive an engine from a flight recording and "
                    "gate token bit-identity, rung residency, and "
                    "zero post-warmup retraces.")
    ap.add_argument("dump", help="flight JSONL (full sink or ring dump)")
    ap.add_argument("--inject-divergence", action="store_true",
                    help="corrupt one recorded token before comparing "
                         "(exercises the first-divergence report; the "
                         "replay must then exit nonzero)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the rebuilt engine (default "
                         "cuda; cpu is an opt-in)")
    args = ap.parse_args(argv)

    recording = load_recording(args.dump)
    if args.inject_divergence:
        fin = next((r for r in recording.records
                    if r.get("k") == "finish" and r.get("tokens")), None)
        if fin is None:
            raise SystemExit(
                "--inject-divergence needs a finish record with tokens")
        fin["tokens"][len(fin["tokens"]) // 2] += 1
    report = replay(recording, device=args.device)
    print(json.dumps(report.to_dict(), indent=2))
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
