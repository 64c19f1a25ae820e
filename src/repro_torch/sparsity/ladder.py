"""Policy ladder: a monotone family of calibrated sparsity policies (port
of the JAX package's ``sparsity/ladder.py``).

A :class:`PolicyLadder` holds calibrated WiSparse plans at several
global budgets — rung 0 the densest (usually fully dense), the last rung
the sparsest — so the serving controller
(``repro_torch.serving.controller``) can move between rungs as load
changes.

Calibration cost stays near a single cold search: each rung's
evolutionary block allocation warm-starts from the adjacent rung's block
ratios with the previous ratios as a per-block floor, and its greedy
intra-block stage starts from the previous rung's per-linear ratios.
The floor also guarantees the ladder invariant: a higher-budget rung
never keeps more channels than a lower one in any block.

The whole ladder ships as one self-contained versioned npz artifact
(kind ``"ladder"``), in the JAX package's format, so a ladder written by
either package loads in the other: rung policies in the JSON meta, rung
0's full sp tree plus per-rung deltas for the calibrated leaves
(``alpha``/``tau``/``keep_frac``; the weight-column norms ``g`` are
shared and stored once), and since artifact v4 the quality baselines
(per-rung per-block Eq. 6 reconstruction MSE and saliency channel sets).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.sparsity.policy import (ARTIFACT_VERSION, SparsityPolicy,
                                         _flatten_sp, _read_artifact,
                                         _unflatten_sp)


@dataclasses.dataclass(frozen=True)
class PolicyLadder:
    """Ordered rungs of (budget, policy, stacked sp tree), densest first.

    budgets       global prune-ratio targets, strictly ascending
    policies      one :class:`SparsityPolicy` per rung
    sps           one stacked sp tree per rung (rungs share ``g``)
    block_ratios  per-rung per-block prune ratios from calibration
                  (None for uniform/uncalibrated ladders)
    baselines     calibration-time quality baselines (artifact v4):
                  ``{"recon": (rungs, blocks) Eq. 6 MSE array,
                  "channels": per-rung tuple of per-block saliency
                  channel-index arrays}``; None for uniform ladders and
                  pre-v4 artifacts
    """

    budgets: Tuple[float, ...]
    policies: Tuple[SparsityPolicy, ...]
    sps: tuple
    block_ratios: Optional[tuple] = None
    baselines: Optional[dict] = None

    def __post_init__(self):
        for f in ("budgets", "policies", "sps"):
            v = getattr(self, f)
            if not isinstance(v, tuple):
                object.__setattr__(self, f, tuple(v))
        if self.block_ratios is not None and \
                not isinstance(self.block_ratios, tuple):
            object.__setattr__(self, "block_ratios",
                               tuple(self.block_ratios))
        n = len(self.budgets)
        if n == 0:
            raise ValueError("a ladder needs at least one rung")
        if len(self.policies) != n or len(self.sps) != n:
            raise ValueError(
                f"ladder rung count mismatch: {n} budgets, "
                f"{len(self.policies)} policies, {len(self.sps)} sp trees")
        for a, b in zip(self.budgets, self.budgets[1:]):
            if not a < b:
                raise ValueError(
                    f"ladder budgets must be strictly ascending, got "
                    f"{self.budgets}")
        for i, pol in enumerate(self.policies):
            if not isinstance(pol, SparsityPolicy):
                raise TypeError(
                    f"rung {i} policy must be a SparsityPolicy, "
                    f"got {type(pol)!r}")

    def __len__(self) -> int:
        return len(self.budgets)

    def rung(self, i: int):
        """(policy, sp) for rung ``i`` (0 = densest)."""
        return self.policies[i], self.sps[i]

    # ------------------------------------------------------------------
    # constructors
    # ------------------------------------------------------------------
    @classmethod
    def uniform(cls, params, cfg, budgets: Sequence[float] = (0.0, 0.5, 0.7),
                backend: str = "topk_shared", **kw) -> "PolicyLadder":
        """Uncalibrated ladder: uniform keep ratios per rung over the
        default sp schema (rung 0 at budget 0.0 runs dense).  Its sp
        trees carry the reference's uncalibrated ``tau=+inf``, which
        zeroes every projection of the thresholding backends (``mask``,
        ``pallas``).  The calibrated path is :func:`calibrate_ladder`."""
        from repro_torch.core.sp_schema import default_sp_stacked
        budgets = tuple(float(b) for b in budgets)
        policies, sps = [], []
        for b in budgets:
            sps.append(default_sp_stacked(params, cfg, keep_frac=1.0 - b))
            if b <= 0.0:
                policies.append(SparsityPolicy.dense(**kw))
            else:
                policies.append(SparsityPolicy.uniform(
                    backend, k_max_frac=max(1.0 - b, 1e-6), **kw))
        return cls(budgets=budgets, policies=tuple(policies),
                   sps=tuple(sps))

    # ------------------------------------------------------------------
    # self-contained artifact (kind="ladder")
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """One versioned npz for the whole ladder.  Rung 0's sp tree is
        stored in full; later rungs store only the leaves that differ
        from rung 0."""
        meta = {
            "version": ARTIFACT_VERSION,
            "kind": "ladder",
            "budgets": list(self.budgets),
            "policies": [p.to_dict() for p in self.policies],
            "block_ratios": None if self.block_ratios is None else
            [np.asarray(r, float).tolist() for r in self.block_ratios],
            # v4: recon MSEs ride the JSON meta, channel index sets go in
            # as qc{rung}/d{depth} arrays
            "quality": None if self.baselines is None else {
                "recon":
                np.asarray(self.baselines["recon"], float).tolist()},
        }
        arrays = {}
        if self.baselines is not None:
            for r, per_block in enumerate(self.baselines["channels"]):
                for d, ch in enumerate(per_block):
                    arrays[f"qc{r}/d{d}"] = np.asarray(ch, np.int64)
        base = _flatten_sp(self.sps[0])
        for k, v in base.items():
            arrays[f"sp0/{k}"] = v
        for i, sp in enumerate(self.sps[1:], start=1):
            flat = _flatten_sp(sp)
            if flat.keys() != base.keys():
                raise ValueError(
                    f"rung {i} sp tree structure differs from rung 0; "
                    "ladder rungs must share one sp schema")
            for k, v in flat.items():
                if not np.array_equal(v, base[k]):
                    arrays[f"sp{i}/{k}"] = v
        with open(path, "wb") as f:
            np.savez(f, __meta__=np.array(json.dumps(meta)), **arrays)

    @classmethod
    def load(cls, path: str, device="cpu") -> "PolicyLadder":
        """Rebuild a ladder from its artifact, the sp trees' tensors on
        ``device``; needs no checkpoint.  Rungs load ``g`` from the one
        stored copy, each into its own tensors."""
        meta, z = _read_artifact(path)
        if meta.get("kind") != "ladder":
            raise ValueError(
                f"{path} is a {meta.get('kind', 'policy')!r} artifact; "
                "load it with repro_torch.sparsity.SparsityPolicy.load")
        policies = tuple(
            SparsityPolicy.from_artifact_dict(p, meta["version"])
            for p in meta["policies"])
        base = {k[len("sp0/"):]: z[k] for k in z.files
                if k.startswith("sp0/")}
        sps = [_unflatten_sp(base, device)]
        for i in range(1, len(policies)):
            flat = dict(base)
            pre = f"sp{i}/"
            for k in z.files:
                if k.startswith(pre):
                    flat[k[len(pre):]] = z[k]
            sps.append(_unflatten_sp(flat, device))
        br = meta.get("block_ratios")
        baselines = None
        qb = meta.get("quality")        # absent in pre-v4 artifacts
        if qb is not None:
            recon = np.asarray(qb["recon"], float)
            channels = tuple(
                tuple(z[f"qc{r}/d{d}"] for d in range(recon.shape[1]))
                for r in range(recon.shape[0]))
            baselines = {"recon": recon, "channels": channels}
        return cls(budgets=tuple(meta["budgets"]), policies=policies,
                   sps=tuple(sps),
                   block_ratios=None if br is None else
                   tuple(np.asarray(r) for r in br),
                   baselines=baselines)


def calibrate_ladder(params, cfg, calib_batch,
                     budgets: Sequence[float] = (0.0, 0.3, 0.5, 0.7), *,
                     backend: str = "topk_shared",
                     sensitive_backend: Optional[str] = None,
                     sensitive_frac: float = 0.25,
                     evo=None, warm_generations: Optional[int] = None,
                     delta: float = 0.05, coord_passes: int = 0,
                     ctx=None, log=None, quality_baselines: bool = True,
                     saliency_topk: int = 32) -> PolicyLadder:
    """Calibrate a monotone policy ladder at several global budgets.

    The calibration context is built once (or passed in as ``ctx``); the
    first sparse rung runs the full evolutionary search and every later
    rung warm-starts from the previous rung's plan with
    ``warm_generations`` generations (default: a quarter of the cold
    budget).  Budget 0.0 is the dense rung: no search, alphas 0, keep 1,
    but the same sp tree schema, so the serving engine swaps rung sp
    trees without rebuilding anything.

    ``quality_baselines`` additionally records, per rung and block, the
    Eq. 6 reconstruction MSE on the calibration batch and the top
    ``saliency_topk`` saliency channels of the block input, shipped in
    the v4 artifact.
    """
    from repro_torch.core import unstacked as U
    from repro_torch.core.allocation import EvoConfig
    from repro_torch.core.calibration import build_context
    from repro_torch.core.pipeline import run_pipeline

    log = log or (lambda *_: None)
    evo = evo or EvoConfig()
    budgets = tuple(float(b) for b in budgets)
    if any(b < 0.0 or b >= 1.0 for b in budgets):
        raise ValueError(f"ladder budgets must be in [0, 1), got {budgets}")

    if ctx is None:
        log("building calibration context ...")
        ctx = build_context(params, cfg, calib_batch)

    policies, sps, block_ratios = [], [], []
    prev_plan = None
    for i, b in enumerate(sorted(budgets)):
        if b <= 0.0:
            log(f"rung {i}: dense (budget 0)")
            ratios = {(d, p): 1.0 for d in range(ctx.num_blocks)
                      for p in ctx.keys_by_depth[d]}
            sp = U.restack_sp(cfg, ctx.make_sp({}, ratios))
            policies.append(SparsityPolicy.dense())
            sps.append(sp)
            block_ratios.append(np.zeros(ctx.num_blocks))
            continue
        gens = None if prev_plan is None else (
            warm_generations if warm_generations is not None
            else max(1, evo.generations // 4))
        log(f"rung {i}: budget {b:.2f} "
            f"({'warm, %d gens' % gens if gens is not None else 'cold'})")
        plan = run_pipeline(params, cfg, calib_batch, b, evo=evo,
                            delta=delta, coord_passes=coord_passes,
                            log=log, ctx=ctx, warm_start=prev_plan,
                            generations=gens)
        policies.append(plan.to_policy(
            backend=backend, sensitive_backend=sensitive_backend,
            sensitive_frac=sensitive_frac))
        sps.append(plan.stacked_sp)
        block_ratios.append(np.asarray(plan.block_ratios, float))
        prev_plan = plan

    baselines = None
    if quality_baselines:
        log("recording quality baselines (Eq. 6 recon + saliency) ...")
        baselines = _quality_baselines(cfg, ctx, sps, saliency_topk)

    return PolicyLadder(budgets=tuple(sorted(budgets)),
                        policies=tuple(policies), sps=tuple(sps),
                        block_ratios=tuple(block_ratios),
                        baselines=baselines)


def _quality_baselines(cfg, ctx, sps, saliency_topk: int) -> dict:
    """Per-rung per-block calibration-time quality references: the Eq. 6
    reconstruction MSE under each rung's sp tree, and the top-k saliency
    channel set of each block's calibration input, by the rule (and
    representative leaf) that the serving-time monitor applies."""
    from repro_torch.obs.quality import (rep_saliency_leaf,
                                         saliency_channels, unstack_sp)

    feats = [np.mean(np.abs(ctx.block_io[d].detach().float().cpu().numpy()),
                     axis=(0, 1)) for d in range(ctx.num_blocks)]
    recon = np.zeros((len(sps), ctx.num_blocks))
    channels = []
    for i, sp in enumerate(sps):
        per_depth = unstack_sp(cfg, sp)
        per_block = []
        for d in range(ctx.num_blocks):
            recon[i, d] = float(ctx.block_mse(d, per_depth[d]))
            leaf = rep_saliency_leaf(per_depth[d], cfg.d_model)
            per_block.append(
                np.zeros((0,), np.int64) if leaf is None else
                saliency_channels(feats[d], leaf[0], leaf[1],
                                  saliency_topk))
        channels.append(tuple(per_block))
    return {"recon": recon, "channels": tuple(channels)}
