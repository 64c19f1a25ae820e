"""Alg. 2 — lightweight block-wise grid search for the weight exponents
(a copy of the JAX package's ``core/alpha_search.py``).

For each block, candidate exponents alpha in [0, 1.5] (31-point grid, step
0.05 per §5.1) are scored by the MSE between the dense and sparse block
outputs on the block's own calibration inputs; thresholds for each candidate
come from Eq. 7 at the block's keep ratios.  A first pass searches one
shared alpha for the whole block (the paper's Alg. 2); optional coordinate
passes then refine each linear's alpha_l individually ("layer-specific
exponent", §4.2).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.core.calibration import CalibContext, Key

GRID = tuple(np.round(np.arange(0.0, 1.5001, 0.05), 4))


def search_block_alpha(ctx: CalibContext, depth: int,
                       ratios: Dict[Key, float],
                       grid=GRID, coord_passes: int = 1) -> Dict[Key, float]:
    """Returns {key: alpha} for all linears of block `depth`."""
    keys = [(depth, p) for p in ctx.keys_by_depth[depth]]
    if not keys:
        return {}

    def block_err(alphas: Dict[Key, float]) -> float:
        dl = ctx.layers[depth]
        sp = _sp_for_block(ctx, dl, alphas, ratios)
        return ctx.block_mse(depth, sp)

    # pass 0: shared alpha over the whole block (paper Alg. 2)
    best_a, best_e = 0.0, np.inf
    for a in grid:
        e = block_err({k: a for k in keys})
        if e < best_e:
            best_a, best_e = a, e
    alphas = {k: best_a for k in keys}

    # coordinate refinement: per-layer alpha_l
    for _ in range(coord_passes):
        improved = False
        for k in keys:
            cur = alphas[k]
            for a in grid:
                if a == cur:
                    continue
                trial = dict(alphas)
                trial[k] = a
                e = block_err(trial)
                if e < best_e - 1e-12:
                    best_e, alphas, improved = e, trial, True
        if not improved:
            break
    return alphas


def _sp_for_block(ctx: CalibContext, dl, alphas, ratios):
    from repro_torch.core import unstacked as U
    sp = U.default_layer_sp(dl.params)
    for path in ctx.keys_by_depth[dl.depth]:
        key = (dl.depth, path)
        a = float(alphas.get(key, 0.0))
        r = float(ratios.get(key, 1.0))
        U.set_sp_leaf(sp, path, "alpha", a)
        U.set_sp_leaf(sp, path, "tau", ctx.tau_for(key, a, r))
        U.set_sp_leaf(sp, path, "keep_frac", r)
    return sp


def search_all_alphas(ctx: CalibContext, ratios: Dict[Key, float],
                      grid=GRID, coord_passes: int = 1,
                      progress=None) -> Dict[Key, float]:
    out: Dict[Key, float] = {}
    for d in range(ctx.num_blocks):
        out.update(search_block_alpha(ctx, d, ratios, grid, coord_passes))
        if progress:
            progress(d, ctx.num_blocks)
    return out
