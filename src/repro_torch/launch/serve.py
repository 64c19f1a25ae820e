"""Serving CLI for the port: a thin front end over the continuous-batching
engine (``repro_torch.serving``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama31_8b \\
        --mode pallas --sparsity 0.5 --batch 8 --prompt-len 128 --gen 32

Full width and the card are the defaults; ``--reduced`` (the tiny
same-family config) and ``--device cpu`` are opt-ins.  Weights are random
from ``--seed``.  The paper's §5.1 recipe applies: the first half of each
prompt prefills dense, later chunks and every decode step run under the
``--mode`` backend.

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
The gateway and telemetry come with later slices.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import obs
from repro_torch.configs import get_config, reduced
from repro_torch.core import pipeline
from repro_torch.core.allocation import EvoConfig
from repro_torch.core.sp_schema import default_sp_stacked
from repro_torch.data import DataConfig, SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.models import api
from repro_torch.serving import Engine, EngineConfig, SLOConfig, SpecConfig
from repro_torch.sparsity import PolicyLadder, SparsityPolicy


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
    return ap


def validate_args(args) -> None:
    if not 0.0 <= args.sparsity < 1.0:
        raise SystemExit(f"--sparsity must be in [0, 1), got {args.sparsity}")
    for name in ("prompt-len", "gen", "batch"):
        v = getattr(args, name.replace("-", "_"))
        if v <= 0:
            raise SystemExit(f"--{name} must be > 0, got {v}")
    if args.sensitive_backend is not None and not args.calib_quick:
        raise SystemExit("--sensitive-backend needs a calibrated plan: "
                         "add --calib-quick")
    if args.policy_artifact is not None and args.calib_quick:
        raise SystemExit("--policy-artifact serves a saved plan; drop "
                         "--calib-quick")
    if args.rung < 0:
        raise SystemExit(f"--rung must be >= 0, got {args.rung}")
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
    # one slot per request, room for prompt + generation
    ecfg = EngineConfig(max_slots=args.batch,
                        max_len=args.prompt_len + args.gen, policy=policy,
                        slo=slo, initial_rung=args.rung, spec=spec)
    engine = Engine(params, cfg, ecfg, sp, device=device, ladder=ladder)
    t0 = obs.now()
    for b in range(args.batch):
        engine.submit(prompts[b], args.gen)
    out = engine.run()
    dt = obs.now() - t0
    n = sum(len(t) for t in out.values())
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"generated {n} tokens in {dt:.2f}s ({n / dt:.1f} tok/s on "
          f"{where})")
    print("engine stats:", engine.stats.summary())
    if engine.controller is not None:
        print("controller:", engine.controller.snapshot(),
              "transitions:", engine.controller.transitions)
    if engine.spec_decoder is not None:
        print("spec:", engine.spec_decoder.snapshot())
        print("retraces after warmup: decode",
              engine.decode_retraces_after_warmup, "verify",
              engine.verify_retraces_after_warmup)
    print("sample:", out[0][:16])
    return out


if __name__ == "__main__":
    main()
