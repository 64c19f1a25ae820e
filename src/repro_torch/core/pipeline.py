"""Alg. 1 — the full WiSparse pipeline (port of the JAX package's
``core/pipeline.py``).

    p_block  <- evolutionary block-level allocation        (Alg. 3)
    p_layer  <- greedy intra-block allocation              (Alg. 4)
    alpha    <- block-wise grid search                     (Alg. 2)
    tau_l    <- Eq. 7 quantile at the final (alpha, ratio)

Returns a ``SparsePlan`` holding per-depth sp dicts (calibration/eval form)
plus the re-stacked sp tree the serving model consumes.

Shipping a plan: ``SparsePlan.save``/``load_ratios`` round-trip the search
*outputs* (ratios/alphas/taus) as json — enough to rebuild sp against a
checkpoint.  For a **self-contained** artifact that needs no checkpoint
(it also carries the weight-column norms ``g``), use
``plan.to_policy().save(path, sp=plan.stacked_sp)`` /
``repro_torch.sparsity.SparsityPolicy.load`` — that is what a serving fleet
loads.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import alpha_search, allocation, unstacked as U
from repro_torch.core.calibration import CalibContext, Key, build_context
from repro_torch.core.allocation import EvoConfig


@dataclasses.dataclass
class SparsePlan:
    cfg: ModelConfig
    p_target: float
    block_ratios: np.ndarray                  # per-block prune ratios
    layer_ratios: Dict[Key, float]            # per-linear prune ratios
    alphas: Dict[Key, float]
    taus: Dict[Key, float]
    per_depth_sp: list                        # calibration/unstacked form
    stacked_sp: list                          # serving-model form

    def summary(self) -> dict:
        return {
            "p_target": self.p_target,
            "block_ratios": [round(float(x), 4) for x in self.block_ratios],
            "mean_alpha": round(float(np.mean(list(self.alphas.values()))), 4)
            if self.alphas else 0.0,
        }

    def save(self, path: str):
        blob = {
            "p_target": self.p_target,
            "block_ratios": np.asarray(self.block_ratios).tolist(),
            "layer_ratios": {f"{d}|{p}": v for (d, p), v
                             in self.layer_ratios.items()},
            "alphas": {f"{d}|{p}": v for (d, p), v in self.alphas.items()},
            "taus": {f"{d}|{p}": v for (d, p), v in self.taus.items()},
        }
        with open(path, "w") as f:
            json.dump(blob, f)

    @staticmethod
    def load_ratios(path: str):
        with open(path) as f:
            blob = json.load(f)

        def parse(d):
            out = {}
            for k, v in d.items():
                # split once: a "|" inside the path component must survive
                # the round-trip, not silently truncate the key
                depth, p = k.split("|", 1)
                out[(int(depth), p)] = v
            return out

        return (blob["p_target"], np.array(blob["block_ratios"]),
                parse(blob["layer_ratios"]), parse(blob["alphas"]),
                parse(blob["taus"]))

    def to_policy(self, backend: str = "topk_shared",
                  sensitive_backend=None, sensitive_frac: float = 0.25,
                  **kw):
        """Execution policy for this plan — see
        :meth:`repro_torch.sparsity.SparsityPolicy.from_plan`."""
        from repro_torch.sparsity import SparsityPolicy
        return SparsityPolicy.from_plan(
            self, backend=backend, sensitive_backend=sensitive_backend,
            sensitive_frac=sensitive_frac, **kw)


def run_pipeline(params, cfg: ModelConfig, calib_batch, p_target: float,
                 evo: EvoConfig = EvoConfig(), delta: float = 0.05,
                 alpha_default: float = 1.0, coord_passes: int = 1,
                 skip_coarse: bool = False, skip_fine: bool = False,
                 skip_alpha: bool = False, log=None,
                 ctx: Optional[CalibContext] = None,
                 warm_start: Optional["SparsePlan"] = None,
                 generations: Optional[int] = None) -> SparsePlan:
    """Full WiSparse calibration.  The skip_* flags reproduce the paper's
    Table-2 ablation rows (activation-only / +weight / +coarse / +fine).

    ``warm_start``: a plan calibrated at an adjacent (lower) budget — both
    search stages start from (and never undercut) its ratios, which is
    what makes a calibrated ladder monotone per block.  ``generations``
    caps the evolutionary budget for that refinement search."""
    log = log or (lambda *_: None)
    if ctx is None:
        log("building calibration context ...")
        ctx = build_context(params, cfg, calib_batch)

    # default alphas during allocation: the plain |x|*g rule (alpha=1, WINA
    # -like) unless ablating weight-awareness entirely (alpha=0).
    base_alpha = {(d, p): alpha_default for d in range(ctx.num_blocks)
                  for p in ctx.keys_by_depth[d]}

    p_init = p_min = layer_init = None
    if warm_start is not None:
        if warm_start.p_target > p_target:
            raise ValueError(
                f"warm_start plan budget {warm_start.p_target} exceeds "
                f"p_target {p_target}; ladder budgets must be ascending")
        p_init = p_min = np.asarray(warm_start.block_ratios, np.float64)
        layer_init = dict(warm_start.layer_ratios)

    if skip_coarse:
        p_block = np.full(ctx.num_blocks, p_target)
        if p_init is not None:
            p_block = np.maximum(p_block, p_init)
    else:
        log("coarse search: evolutionary block-level allocation (Alg. 3)")
        p_block = allocation.block_level_allocation(
            ctx, p_target, evo, base_alpha, log,
            p_init=p_init, p_min=p_min, generations=generations)

    layer_ratios: Dict[Key, float] = {}
    if skip_fine:
        for d in range(ctx.num_blocks):
            for p in ctx.keys_by_depth[d]:
                layer_ratios[(d, p)] = float(p_block[d])
        if layer_init is not None:
            for k, v in layer_init.items():
                layer_ratios[k] = max(layer_ratios.get(k, 0.0), v)
    else:
        log("fine search: greedy intra-block allocation (Alg. 4)")
        for d in range(ctx.num_blocks):
            layer_ratios.update(allocation.intra_block_allocation(
                ctx, d, float(p_block[d]), delta, base_alpha,
                p_init=layer_init))

    keep_ratios = {k: 1.0 - v for k, v in layer_ratios.items()}

    if skip_alpha:
        alphas = dict(base_alpha)
    else:
        log("alpha search: block-wise grid (Alg. 2)")
        alphas = alpha_search.search_all_alphas(
            ctx, keep_ratios, coord_passes=coord_passes,
            progress=lambda d, n: log(f"  alpha block {d + 1}/{n}"))

    taus = {k: ctx.tau_for(k, alphas.get(k, 0.0), keep_ratios[k])
            for k in layer_ratios}
    per_depth_sp = ctx.make_sp(alphas, keep_ratios)
    stacked_sp = U.restack_sp(cfg, per_depth_sp)
    return SparsePlan(cfg, p_target, p_block, layer_ratios, alphas, taus,
                      per_depth_sp, stacked_sp)


def activation_only_plan(params, cfg: ModelConfig, calib_batch,
                         p_target: float,
                         ctx: Optional[CalibContext] = None) -> SparsePlan:
    """TEAL-style baseline: alpha=0 (activation-only), uniform allocation.
    The paper's 'Activation only' ablation row."""
    if ctx is None:
        ctx = build_context(params, cfg, calib_batch)
    ratios = {(d, p): 1.0 - p_target for d in range(ctx.num_blocks)
              for p in ctx.keys_by_depth[d]}
    alphas = {k: 0.0 for k in ratios}
    taus = {k: ctx.tau_for(k, 0.0, ratios[k]) for k in ratios}
    per_depth_sp = ctx.make_sp(alphas, ratios)
    return SparsePlan(cfg, p_target,
                      np.full(ctx.num_blocks, p_target),
                      {k: p_target for k in ratios}, alphas, taus,
                      per_depth_sp, U.restack_sp(cfg, per_depth_sp))
