"""Serving CLI for the port: a thin front end over the continuous-batching
engine (``repro_torch.serving``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31_8b \\
        --mode pallas --sparsity 0.5 --batch 8 --prompt-len 128 --gen 32

``--arch`` takes the decoders the port serves: llama31_8b (the
default), deepseek_67b, the Gemma family, gemma_2b, gemma2_2b and
gemma3_4b, the granite MoE models, granite_moe_1b_a400m and
granite_moe_3b_a800m, mamba2_130m and the jamba_v01_52b hybrid (which
fits the card only ``--reduced``); ``--calib-quick`` and
``--policy-artifact`` serve a calibrated plan on every one of them.
gemma2_2b and gemma3_4b have ``local`` layers, whose rolling-window
caches, and mamba2_130m and jamba ``mamba`` layers, whose conv and SSM
state have no time axis, resolve ``--prefill-strategy auto`` to whole-prompt prefill
and rule out ``--prefix-cache``, ``--preemption``, ``--spec-gamma`` and
``--quality-probe-rate``, which the engine refuses as the reference's
does.  Full width and the card are the defaults;
``--reduced`` (the tiny same-family config) and ``--device cpu`` are
opt-ins.  Weights are random from ``--seed``.  The paper's §5.1 recipe
applies: the first half of each prompt prefills dense, later chunks and
every decode step run under the ``--mode`` backend.

The prompts are the JAX CLI's: ``SyntheticLM(DataConfig(vocab,
prompt_len, batch)).batch(0)``.

``--calib-quick`` calibrates WiSparse on those prompts (paper Alg. 1-4,
``core/pipeline.run_pipeline``, with the JAX CLI's small budget) and
serves the plan under ``--mode``; ``--sensitive-backend`` runs another
backend on the blocks the search found most sensitive.
``--policy-artifact PATH`` serves a saved plan instead: the npz that
``plan.to_policy(...).save(path, sp=plan.stacked_sp)`` writes, from this
package or the JAX one.

Without calibration the sp tree is built from the weights
(``default_sp_stacked``): g = column norms, alpha = 1, keep_frac =
1 - sparsity.  Its threshold tau is set to -inf for ``pallas`` (the
reference's uncalibrated +inf would zero every projection that
backend runs), so ``pallas`` sparsity comes from the block top-k at
keep_frac alone.  ``mask`` thresholds on tau and needs calibration, so
uncalibrated it falls back to ``topk_shared``, as the reference CLI does.

``--ladder PATH`` serves a saved policy ladder (the npz that
``PolicyLadder.save`` writes, from this package or the JAX one) from
rung ``--rung``; ``--slo-tpot-p95`` > 0 arms the adaptive controller,
which moves between rungs under that TPOT target and the
``--slo-max-queue`` queue bound.

Speculative decoding: ``--spec-gamma N`` (with ``--ladder``) drafts N
tokens per verify at the ``--spec-drafter`` rung and verifies at the
pinned ``--rung``: token-identical output to plain decode at that rung,
fewer verifier passes per token.  The verifier rung must decode dense
(rung 0 of a calibrated ladder); the engine rejects sparse verifiers,
whose shared top-k saliency would break the parity guarantee.
``--spec-adaptive`` lets the acceptance EWMA tune gamma at runtime.

Prefix caching: ``--prefix-cache`` reuses KV across requests that share
a prompt prefix (a radix tree over token ids); ``--prefix-cache-tokens``
bounds the cached tokens (LRU eviction, 0 = unbounded).  It needs a
prefix-deterministic prefill: dense (``--sparsity 0``) or ``mask``, and
the engine refuses the rest.  Admission control: ``--max-queue N``
bounds the admission queue (a submission beyond it raises
``QueueFull``), and ``--preemption`` suspends the least important
decoding request to host memory when a more important arrival needs its
slot; the victim resumes bit-identically.  ``--max-slots``,
``--max-len``, ``--chunk`` and ``--prefill-strategy`` size the engine
(by default one slot per request, room for prompt + generation, chunks
of 32).

Gateway: ``--gateway`` serves the HTTP/1.1 + SSE API front door
(``repro_torch.serving.gateway``) instead of replaying the synthetic
prompts — ``POST /v1/generate`` (streaming and not), ``GET /v1/health``,
``GET /metrics`` — on ``--gateway-host``/``--gateway-port``
(``--gateway-port 0`` binds an ephemeral port, and the CLI prints
``gateway listening on http://HOST:PORT`` once it accepts connections,
so a script can connect).  Every step is built before it listens.
``--max-queue`` rejections surface as HTTP 429 with ``Retry-After``.
SIGTERM/Ctrl-C stops accepting connections, drains in-flight requests,
flushes the telemetry sinks and exits 0.

Observability (``repro_torch.obs``): ``--metrics-out`` appends JSONL
engine snapshots every ``--metrics-every`` steps by default;
``--metrics-format prom`` instead rewrites the file with a Prometheus
text-exposition dump, and ``--metrics-port`` serves the same text live
at ``http://127.0.0.1:PORT/metrics``.  ``--trace-out`` writes a Chrome
trace-event JSON of per-request spans, ``--events-out`` streams the
structured event log (rung and gamma switches with reasons, prefix
evictions, KV rollbacks, admission decisions, graph builds) as JSONL,
and ``--profile-dir`` captures a ``torch.profiler`` trace of the whole
run there.  Tokens are identical with telemetry on or off.

Quality and flight (``repro_torch.obs.quality``, ``repro_torch.obs.flight``):
``--quality-probe-rate R`` shadow-probes that fraction of decode steps
against the dense reference (agreement, Eq. 6 reconstruction error,
saliency drift past ``--quality-drift-threshold``, roofline counters;
all in the exposition and the snapshots).  ``--flight-record`` arms the
flight recorder's ring of ``--flight-ring`` records; ``--flight-record
PATH`` also streams the complete recording to PATH, which ``python -m
repro_torch.obs.flight.replay PATH`` replays bit for bit.
``--flight-dump-dir D`` receives the ring on a trigger: an exception,
an SLO breach, a saliency-drift edge, ``GET /v1/debug/flight`` or
SIGUSR1 (``kill -USR1 <pid>``).

``--legacy`` runs the static-batch loop instead of the engine
(:func:`generate`, the reference's numerics reference: the engine's
whole-prompt prefill gives its tokens for equal-length prompts), with
the prefill and decode policies and the sp tree the flags above build;
the engine's flags (the prefix cache, admission control, the gateway,
telemetry, the quality probe and the flight recorder) are refused
beside it.  Its decode step is built once (a CUDA graph on the card,
``serving/graphs.BatchDecodeSteps``).
"""
from __future__ import annotations

import argparse
import json
import os
import signal

import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline
from repro_torch.core.allocation import EvoConfig
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.models import model as M
from repro_torch.serving import (Engine, EngineConfig, SchedulerConfig,
                                 SLOConfig, SpecConfig)
from repro_torch.serving.graphs import BatchDecodeSteps
from repro_torch.serving.metrics import latency_percentiles
from repro_torch.sparsity import PolicyLadder, SparsityPolicy


def generate(params, cfg, prompts, gen_tokens: int, sp_stacked=None, *,
             prefill_sparse_frac: float = 0.5, policy=None):
    """prompts: (B, P) integer tokens.  Returns the (B, gen_tokens) greedy
    tokens, on the host.

    The reference's static-batch loop: the whole prompt prefills sparse
    under ``policy.for_phase("prefill_sparse")`` and ``sp_stacked`` when
    ``prefill_sparse_frac >= 1``, else dense under
    ``for_phase("prefill_dense")`` with no sp tree (its conservative
    reading of §5.1's half-dense prefill); the caches are padded to P +
    ``gen_tokens`` positions (``api.pad_caches``); then ``gen_tokens -
    1`` greedy decode steps under ``for_phase("decode")``, every row at
    position P + i.  ``policy=None`` is ``SparsityPolicy.uniform("mask")``
    (dense-equivalent without calibrated thresholds).  The decode step
    is built once per call (:class:`BatchDecodeSteps`; the reference
    jits one per call) and the tokens stay on the device until the end.
    An enc-dec model's prefill here has no frames, so it stashes no cross
    cache and the padding raises ``ValueError``, as the reference's
    does."""
    if policy is None:
        policy = SparsityPolicy.uniform("mask")
    dev = params["embed"].device
    prompts = torch.as_tensor(prompts, device=dev).long()
    B, P = prompts.shape
    total = P + gen_tokens
    prefill_sparse = prefill_sparse_frac >= 1.0
    with torch.no_grad():
        logits, caches = M.forward(
            params, cfg, tokens=prompts, mode="prefill",
            sp=sp_stacked if prefill_sparse else None,
            policy=policy.for_phase(
                "prefill_sparse" if prefill_sparse else "prefill_dense"))
        caches = api.pad_caches(cfg, caches, B, total)
    steps = BatchDecodeSteps(cfg, params,
                             [(policy.for_phase("decode"), sp_stacked)],
                             B, total, dev)
    out = steps.decode(0, caches, torch.argmax(logits, -1), P, gen_tokens)
    return out.cpu()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.serve")
    ap.add_argument("--arch", default="llama31_8b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the tiny same-family config instead of "
                         "the full-width one")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is an opt-in)")
    ap.add_argument("--sparsity", type=float, default=0.5)
    ap.add_argument("--mode", default="pallas",
                    choices=["mask", "topk_shared", "topk_block", "pallas"])
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--batch", type=int, default=4,
                    help="number of requests to submit")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--calib-quick", action="store_true",
                    help="small-budget WiSparse calibration on the prompts")
    ap.add_argument("--legacy", action="store_true",
                    help="static-batch reference loop instead of the engine")
    ap.add_argument("--sensitive-backend", default=None,
                    choices=["off", "mask"],
                    help="mixed per-block policy: run this backend on the "
                         "most sensitive blocks of a calibrated plan "
                         "(requires --calib-quick)")
    ap.add_argument("--sensitive-frac", type=float, default=0.25,
                    help="fraction of blocks treated as sensitive")
    ap.add_argument("--policy-artifact", default=None,
                    help="serve the policy and sp tree of this saved npz "
                         "artifact (overrides --sparsity/--mode)")
    ap.add_argument("--ladder", default=None,
                    help="PolicyLadder npz artifact for adaptive serving "
                         "(overrides --sparsity/--mode)")
    ap.add_argument("--rung", type=int, default=0,
                    help="ladder rung to start on (and to pin, without "
                         "--slo-tpot-p95)")
    ap.add_argument("--slo-tpot-p95", type=float, default=0.0,
                    help="target p95 inter-token latency in seconds; > 0 "
                         "arms the adaptive controller (needs --ladder)")
    ap.add_argument("--slo-max-queue", type=int, default=8,
                    help="queued requests beyond which the controller "
                         "escalates")
    ap.add_argument("--spec-gamma", type=int, default=0,
                    help="speculative decoding: draft tokens per verify "
                         "(> 0 arms spec decode; needs --ladder)")
    ap.add_argument("--spec-drafter", type=int, default=1,
                    help="ladder rung that drafts (must be sparser than "
                         "the verifier rung pinned by --rung)")
    ap.add_argument("--spec-adaptive", action="store_true",
                    help="tune gamma from the acceptance EWMA at runtime")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="reuse KV across requests sharing a prompt "
                         "prefix (radix tree over token ids; needs "
                         "chunked prefill + dense/mask prefill policy)")
    ap.add_argument("--prefix-cache-tokens", type=int, default=0,
                    help="cached-token budget for --prefix-cache "
                         "(LRU eviction; 0 = unbounded)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="bounded admission queue: reject new submissions "
                         "beyond this many queued requests (0 = unbounded)")
    ap.add_argument("--preemption", action="store_true",
                    help="suspend the least-important decoding request to "
                         "host memory when a more important arrival needs "
                         "its KV slot; the victim resumes bit-identically")
    ap.add_argument("--max-slots", type=int, default=0,
                    help="KV pool slots (0 = batch size)")
    ap.add_argument("--max-len", type=int, default=0,
                    help="KV pool length (0 = prompt+gen)")
    ap.add_argument("--chunk", type=int, default=32,
                    help="prefill chunk size (chunked strategy)")
    ap.add_argument("--prefill-strategy", default="auto",
                    choices=["auto", "chunked", "whole"])
    ap.add_argument("--metrics-out", default=None,
                    help="write engine/controller metrics to this file "
                         "while serving (format per --metrics-format)")
    ap.add_argument("--metrics-every", type=int, default=16,
                    help="engine steps between metrics writes")
    ap.add_argument("--metrics-format", default="jsonl",
                    choices=["jsonl", "prom"],
                    help="--metrics-out format: append JSONL snapshots, "
                         "or rewrite a Prometheus text-exposition dump "
                         "(textfile-collector style)")
    ap.add_argument("--metrics-port", type=int, default=0,
                    help="serve live Prometheus exposition at "
                         "http://127.0.0.1:PORT/metrics (0 = off)")
    ap.add_argument("--trace-out", default=None,
                    help="write per-request spans as Chrome trace-event "
                         "JSON (Perfetto-loadable) to this file")
    ap.add_argument("--events-out", default=None,
                    help="stream the structured event log (rung/gamma "
                         "switches, evictions, rollbacks, graph builds) "
                         "as JSONL to this file")
    ap.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the run into "
                         "this directory")
    ap.add_argument("--quality-probe-rate", type=float, default=0.0,
                    help="sample this fraction of decode steps through a "
                         "shadow dense probe (token agreement, recon "
                         "error, saliency drift, roofline counters; "
                         "0 = off)")
    ap.add_argument("--quality-drift-threshold", type=float, default=None,
                    help="EWMA saliency-overlap level below which a "
                         "saliency_drift event fires, in (0, 1) (needs "
                         "--quality-probe-rate > 0; default 0.5)")
    ap.add_argument("--gateway", action="store_true",
                    help="serve the HTTP/1.1 + SSE API front door "
                         "(repro_torch.serving.gateway) instead of "
                         "replaying synthetic prompts; SIGTERM/Ctrl-C "
                         "drains in-flight requests before exiting")
    ap.add_argument("--gateway-host", default="127.0.0.1",
                    help="gateway listen address (needs --gateway)")
    ap.add_argument("--gateway-port", type=int, default=8080,
                    help="gateway listen port (0 = ephemeral, printed once "
                         "bound; needs --gateway)")
    ap.add_argument("--flight-record", nargs="?", const="", default=None,
                    metavar="PATH",
                    help="arm the flight recorder (repro_torch.obs.flight): "
                         "bare = black-box ring only; with PATH, also "
                         "stream the complete recording as JSONL to PATH "
                         "(replayable via python -m "
                         "repro_torch.obs.flight.replay)")
    ap.add_argument("--flight-ring", type=int, default=4096,
                    help="flight-recorder ring capacity in records "
                         "(needs --flight-record)")
    ap.add_argument("--flight-dump-dir", default=None,
                    help="directory for triggered black-box dumps "
                         "(exception / SLO breach / saliency drift / "
                         "SIGUSR1 / GET /v1/debug/flight; needs "
                         "--flight-record)")
    return ap


def validate_args(args) -> None:
    if not 0.0 <= args.sparsity < 1.0:
        raise SystemExit(f"--sparsity must be in [0, 1), got {args.sparsity}")
    for name in ("prompt-len", "gen", "batch", "chunk", "metrics-every"):
        v = getattr(args, name.replace("-", "_"))
        if v <= 0:
            raise SystemExit(f"--{name} must be > 0, got {v}")
    for name in ("max-slots", "max-len"):
        v = getattr(args, name.replace("-", "_"))
        if v < 0:
            raise SystemExit(f"--{name} must be >= 0 (0 = from the "
                             f"requests), got {v}")
    if args.sensitive_backend is not None and not args.calib_quick:
        raise SystemExit("--sensitive-backend needs a calibrated plan: "
                         "add --calib-quick")
    if args.policy_artifact is not None and args.calib_quick:
        raise SystemExit("--policy-artifact serves a saved plan; drop "
                         "--calib-quick")
    if args.rung < 0:
        raise SystemExit(f"--rung must be >= 0, got {args.rung}")
    if args.max_queue < 0:
        raise SystemExit(f"--max-queue must be >= 0, got {args.max_queue}")
    if args.prefix_cache_tokens and not args.prefix_cache:
        raise SystemExit("--prefix-cache-tokens needs --prefix-cache to "
                         "arm the prefix cache")
    if args.slo_tpot_p95 > 0 and args.ladder is None:
        raise SystemExit("--slo-tpot-p95 needs --ladder: the controller "
                         "switches between ladder rungs")
    if args.rung != 0 and args.ladder is None:
        raise SystemExit("--rung needs --ladder: a fixed-policy engine "
                         "has only rung 0")
    if args.ladder is not None and (args.policy_artifact is not None
                                    or args.calib_quick):
        raise SystemExit("--ladder serves a saved ladder; drop "
                         "--policy-artifact/--calib-quick")
    if args.spec_gamma > 0:
        if args.ladder is None:
            raise SystemExit("--spec-gamma needs --ladder: the drafter "
                             "and verifier are ladder rungs")
        if args.slo_tpot_p95 > 0:
            raise SystemExit("--spec-gamma conflicts with --slo-tpot-p95: "
                             "spec decoding pins the verifier rung")
    elif args.spec_adaptive or args.spec_drafter != 1:
        raise SystemExit("--spec-drafter/--spec-adaptive need "
                         "--spec-gamma > 0 to arm speculative decoding")
    if args.prefix_cache and args.legacy:
        raise SystemExit("--prefix-cache needs the engine path, not "
                         "--legacy")
    if args.legacy and (args.trace_out or args.events_out
                        or args.metrics_port or args.metrics_out):
        raise SystemExit("telemetry flags (--trace-out/--events-out/"
                         "--metrics-*) need the engine path, not --legacy")
    if args.gateway:
        if args.legacy:
            raise SystemExit("--gateway needs the engine path, not "
                             "--legacy")
        if args.metrics_out:
            raise SystemExit("--gateway owns the engine loop; drop "
                             "--metrics-out and scrape GET /metrics "
                             "instead")
        if args.metrics_port:
            raise SystemExit("--gateway already serves /metrics on its "
                             "own port; drop --metrics-port")
        if args.gateway_port < 0:
            raise SystemExit(f"--gateway-port must be >= 0 "
                             f"(0 = ephemeral), got {args.gateway_port}")
    elif (args.gateway_host != "127.0.0.1" or args.gateway_port != 8080):
        raise SystemExit("--gateway-host/--gateway-port need --gateway "
                         "to start the API front door")
    if args.quality_probe_rate < 0 or args.quality_probe_rate > 1:
        raise SystemExit(
            f"--quality-probe-rate must be in (0, 1], or 0 to disable "
            f"probing, got {args.quality_probe_rate}")
    if args.quality_probe_rate > 0 and args.legacy:
        raise SystemExit("--quality-probe-rate needs the engine path, "
                         "not --legacy")
    if args.quality_drift_threshold is not None:
        if args.quality_probe_rate <= 0:
            raise SystemExit("--quality-drift-threshold needs "
                             "--quality-probe-rate > 0 to arm the "
                             "quality monitor")
        if not 0.0 < args.quality_drift_threshold < 1.0:
            raise SystemExit(
                f"--quality-drift-threshold must be in (0, 1), got "
                f"{args.quality_drift_threshold}")
    if (args.max_queue or args.preemption) and args.legacy:
        raise SystemExit("--max-queue/--preemption need the engine path, "
                         "not --legacy")
    if args.flight_ring <= 0:
        raise SystemExit(f"--flight-ring must be > 0, got "
                         f"{args.flight_ring}")
    if args.flight_record is not None and args.legacy:
        raise SystemExit("--flight-record needs the engine path, not "
                         "--legacy: the recorder captures the engine's "
                         "submission and clock streams")
    if args.flight_record is None:
        if args.flight_ring != 4096:
            raise SystemExit("--flight-ring needs --flight-record to arm "
                             "the flight recorder")
        if args.flight_dump_dir is not None:
            raise SystemExit("--flight-dump-dir needs --flight-record to "
                             "arm the flight recorder")
    if args.flight_dump_dir is not None:
        d = args.flight_dump_dir
        if os.path.exists(d):
            if not os.path.isdir(d):
                raise SystemExit(f"--flight-dump-dir {d!r} exists and is "
                                 "not a directory")
            if not os.access(d, os.W_OK):
                raise SystemExit(f"--flight-dump-dir {d!r} is not "
                                 "writable")


def validate_rungs(args, num_rungs: int) -> None:
    """Range-check rung-valued flags against the loaded ladder."""
    if not 0 <= args.rung < num_rungs:
        raise SystemExit(
            f"--rung {args.rung} out of range: the loaded ladder has "
            f"rungs 0..{num_rungs - 1}")
    if args.spec_gamma > 0 and not 0 <= args.spec_drafter < num_rungs:
        raise SystemExit(
            f"--spec-drafter {args.spec_drafter} out of range: the "
            f"loaded ladder has rungs 0..{num_rungs - 1}")


def build_policy(args, params, cfg, prompts, device):
    """(policy, sp) for the flags; prints what it chose and why."""
    if args.policy_artifact is not None:
        policy, sp = SparsityPolicy.load(args.policy_artifact, device=device)
        print(f"loaded policy {policy.to_dict()} from {args.policy_artifact}")
        return policy, sp
    if args.sparsity == 0:
        return SparsityPolicy.dense(), None
    if args.calib_quick:
        plan = pipeline.run_pipeline(
            params, cfg, {"tokens": prompts}, args.sparsity,
            evo=EvoConfig(generations=2, offspring=4, eps=0.1),
            delta=0.25, coord_passes=0, log=print)
        print("calibrated plan:", plan.summary())
        return plan.to_policy(
            backend=args.mode, sensitive_backend=args.sensitive_backend,
            sensitive_frac=args.sensitive_frac), plan.stacked_sp
    mode = args.mode
    if mode == "mask":
        print("mask needs calibrated thresholds -> using topk_shared")
        mode = "topk_shared"
    tau = float("-inf") if mode == "pallas" else float("inf")
    if mode == "pallas":
        print("pallas: sp tree with tau=-inf (uncalibrated; the reference's "
              "tau=+inf would zero every projection), sparsity from the "
              f"block top-k at keep_frac={1.0 - args.sparsity}")
    sp = default_sp_stacked(params, cfg, keep_frac=1.0 - args.sparsity,
                            tau=tau)
    return SparsityPolicy.uniform(mode, k_max_frac=1.0 - args.sparsity), sp


def main(argv=None):
    args = build_parser().parse_args(argv)
    validate_args(args)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    params = api.init_model(cfg, args.seed, device=device)
    prompts = SyntheticLM(DataConfig(cfg.vocab_size, args.prompt_len,
                                     args.batch)).batch(0)
    ladder = policy = sp = None
    if args.ladder is not None:
        ladder = PolicyLadder.load(args.ladder, device=device)
        print(f"loaded {len(ladder)}-rung ladder (budgets "
              f"{list(ladder.budgets)}) from {args.ladder}")
        validate_rungs(args, len(ladder))
    else:
        policy, sp = build_policy(args, params, cfg, prompts, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    if args.legacy:
        # as the reference's: a ladder's rungs are not served here, dense
        t0 = obs.now()
        toks = generate(params, cfg, prompts, args.gen, sp,
                        policy=policy or SparsityPolicy.dense())
        dt = obs.now() - t0
        n = toks.numel()
        print(f"generated {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s on "
              f"{where})")
        print("sample:", toks[0][:16].numpy())
        return toks
    slo = None
    if args.slo_tpot_p95 > 0:
        slo = SLOConfig(tpot_p95=args.slo_tpot_p95,
                        max_queue=args.slo_max_queue)
    spec = None
    if args.spec_gamma > 0:
        spec = SpecConfig(gamma=args.spec_gamma,
                          drafter_rung=args.spec_drafter,
                          verifier_rung=args.rung,
                          adaptive=args.spec_adaptive,
                          gamma_max=max(4, args.spec_gamma))
    scheduler = None
    if args.max_queue or args.preemption:
        scheduler = SchedulerConfig(max_queue=args.max_queue,
                                    preemption=args.preemption)
    ecfg = EngineConfig(
        max_slots=args.max_slots or args.batch,
        max_len=args.max_len or args.prompt_len + args.gen,
        prefill_chunk=args.chunk, policy=policy,
        prefill_strategy=args.prefill_strategy,
        slo=slo, initial_rung=args.rung, spec=spec,
        prefix_cache=args.prefix_cache,
        prefix_cache_tokens=args.prefix_cache_tokens,
        scheduler=scheduler)
    telemetry = None
    flight = None
    if args.flight_record is not None:
        flight = obs.FlightRecorder(
            capacity=args.flight_ring,
            sink=args.flight_record or None,
            dump_dir=args.flight_dump_dir,
            meta={"arch": args.arch, "reduced": args.reduced,
                  "seed": args.seed,
                  "ladder_path": None if args.ladder is None
                  else os.path.abspath(args.ladder)})
    if (args.trace_out or args.events_out or args.profile_dir
            or args.quality_probe_rate > 0 or flight is not None):
        quality = None
        if args.quality_probe_rate > 0:
            qkw = dict(probe_rate=args.quality_probe_rate)
            if args.quality_drift_threshold is not None:
                qkw["drift_threshold"] = args.quality_drift_threshold
            quality = obs.QualityMonitor(obs.QualityConfig(**qkw))
        # trace_sink makes Engine.close() (context-manager exit, or the
        # gateway's drain) export the Chrome trace even when serving
        # raises
        telemetry = obs.Telemetry(
            tracer=obs.SpanTracer() if args.trace_out else None,
            events=obs.EventLog(sink=args.events_out)
            if args.events_out else None,
            annotate_dispatch=args.profile_dir is not None,
            profiler=obs.ProfilerSession(args.profile_dir)
            if args.profile_dir else None,
            quality=quality,
            flight=flight,
            trace_sink=args.trace_out)
    engine = Engine(params, cfg, ecfg, sp, device=device, ladder=ladder,
                    telemetry=telemetry)
    if flight is not None and hasattr(signal, "SIGUSR1"):
        # operator-triggered black-box dump: kill -USR1 <pid>
        signal.signal(signal.SIGUSR1, lambda *_: flight.dump("sigusr1"))

    if args.gateway:
        from repro_torch.serving.gateway import Gateway
        gw = Gateway(engine, host=args.gateway_host, port=args.gateway_port)
        gw.on_ready = lambda port: print(
            f"gateway listening on http://{args.gateway_host}:{port} "
            f"(POST /v1/generate, GET /v1/health, GET /metrics) on "
            f"{where}; SIGTERM/Ctrl-C drains", flush=True)
        _start_profiler(telemetry)
        gw.serve_forever()
        print("gateway drained; engine stats:", engine.stats.summary())
        _report_telemetry(args, telemetry)
        return {}

    server = None
    if args.metrics_port:
        server = obs.serve_metrics(engine.metrics_exposition,
                                   port=args.metrics_port)
        print(f"serving metrics at "
              f"http://127.0.0.1:{server.server_port}/metrics")
    _start_profiler(telemetry)
    t0 = obs.now()
    for b in range(args.batch):
        engine.submit(prompts[b], args.gen)
    try:
        # the context manager closes the engine (and flushes every
        # telemetry sink) even when the loop raises
        with engine:
            out = run_with_metrics(engine, args.metrics_out,
                                   args.metrics_every, args.metrics_format)
    finally:
        if server is not None:
            server.shutdown()
        _report_telemetry(args, telemetry)
    dt = obs.now() - t0
    n = sum(len(t) for t in out.values())
    print(f"generated {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s on "
          f"{where})")
    print("engine stats:", engine.stats.summary())
    print("latency:", {k: round(v, 3) for k, v in
                       latency_percentiles(engine.states.values()).items()
                       if v is not None})
    if engine.controller is not None:
        print("controller:", engine.controller.snapshot(),
              "transitions:", engine.controller.transitions)
    if engine.spec_decoder is not None:
        print("spec:", engine.spec_decoder.snapshot())
        print("retraces after warmup: decode",
              engine.decode_retraces_after_warmup, "verify",
              engine.verify_retraces_after_warmup)
    if engine.prefix_cache is not None:
        print("prefix cache:", engine.prefix_cache.snapshot())
    print("sample:", out[0][:16])
    return out


def _start_profiler(telemetry) -> None:
    if (telemetry is not None and telemetry.profiler is not None
            and not telemetry.profiler.start()):
        print("profiler capture unavailable:", telemetry.profiler.error)


def _report_telemetry(args, telemetry) -> None:
    """Say what ``Engine.close()`` flushed (the export itself already
    happened inside close — this only reports)."""
    if telemetry is None:
        return
    if telemetry.tracer is not None:
        print(f"wrote {len(telemetry.tracer.events)} trace events "
              f"to {args.trace_out}")
    if telemetry.events is not None:
        print(f"logged {telemetry.events.count} events"
              + (f" to {args.events_out}" if args.events_out else ""))
    if telemetry.profiler is not None and telemetry.profiler.error is None:
        print(f"wrote profiler trace to {telemetry.profiler.trace_path}")


def run_with_metrics(engine, metrics_out=None, every: int = 16,
                     fmt: str = "jsonl"):
    """Drive the engine to completion, writing metrics every ``every``
    steps (and once at the end) when ``metrics_out`` is set.

    ``fmt="jsonl"`` appends engine snapshots; ``fmt="prom"`` rewrites
    the file with the current Prometheus text exposition each time —
    the node-exporter textfile-collector pattern, scrapeable without a
    port."""
    if metrics_out is None:
        return engine.run()
    if fmt not in ("jsonl", "prom"):
        raise ValueError(f"unknown metrics format {fmt!r}")

    if fmt == "prom":
        def write():
            with open(metrics_out, "w") as f:
                f.write(engine.metrics_exposition())
        steps = 0
        while engine.scheduler.has_work():
            engine.step()
            steps += 1
            if steps % every == 0:
                write()
        write()
        return {rid: rs.tokens for rid, rs in engine.states.items()}

    steps = 0
    with open(metrics_out, "a") as f:
        while engine.scheduler.has_work():
            engine.step()
            steps += 1
            if steps % every == 0:
                f.write(json.dumps(engine.snapshot()) + "\n")
        f.write(json.dumps(engine.snapshot()) + "\n")
    return {rid: rs.tokens for rid, rs in engine.states.items()}


if __name__ == "__main__":
    main()
