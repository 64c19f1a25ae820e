"""Mixed-granularity sparsity allocation (paper §4.3); a copy of the
JAX package's ``core/allocation.py`` (numpy over a calibration context),
with its RNG streams and comparison order unchanged.

Coarse (Alg. 3): evolutionary search over *block-level* prune ratios under a
global average constraint; fitness is the token-level KL divergence between
dense and sparse model outputs on the calibration set (Eq. 8).  Mutation is
localized (a small fraction of blocks, fixed step eps), offspring-only, no
crossover — per the paper's EvoPress-style setup.

Fine (Alg. 4): within each block, a greedy loop adds sparsity increments to
whichever linear layer increases the block's output reconstruction error
the least, until the block meets its budget.

Warm starts (ladder calibration, a later slice of the port): both stages
accept the adjacent budget's solution as a starting point — the coarse
search via ``p_init`` (uniformly shifted to the new budget) plus a
``p_min`` floor that keeps every block at least as sparse as the previous
rung (the ladder's monotonicity invariant), the fine stage via a
per-linear ``p_init`` the greedy loop only ever adds to.  ``generations``
overrides the EvoConfig budget per call, so warm-started rungs run short
refinement searches instead of full cold ones.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np

from repro_torch.core.calibration import CalibContext, Key


@dataclasses.dataclass(frozen=True)
class EvoConfig:
    generations: int = 400          # paper §5.1
    offspring: int = 64
    eps: float = 0.005              # 0.5% mutation step
    mutate_frac: float = 0.1        # 10% of blocks per mutation
    max_sparsity: float = 0.95
    seed: int = 0
    elitist: bool = True


def weighted_average(ctx: CalibContext, p: np.ndarray) -> float:
    w = np.array([ctx.block_weight(d) for d in range(ctx.num_blocks)])
    return float(np.sum(p * w) / np.sum(w))


def _ratios_uniform_block(ctx: CalibContext, p: np.ndarray) -> Dict[Key, float]:
    """All linears in block d share keep ratio 1-p[d] (coarse-stage view)."""
    ratios = {}
    for d in range(ctx.num_blocks):
        for path in ctx.keys_by_depth[d]:
            ratios[(d, path)] = 1.0 - float(p[d])
    return ratios


def block_fitness(ctx: CalibContext, p: np.ndarray,
                  alphas: Optional[Dict[Key, float]] = None) -> float:
    """KL fitness of a block-ratio vector under coarse-stage semantics
    (all linears in a block share its ratio) — the objective Alg. 3
    minimizes, exposed for warm-start/convergence diagnostics."""
    sp = ctx.make_sp(alphas or {}, _ratios_uniform_block(ctx, p))
    return ctx.fitness(sp)


def _repair_down(ctx: CalibContext, q: np.ndarray, p_target: float,
                 p_min: np.ndarray, eps: float, rng) -> np.ndarray:
    """Randomly walk blocks down by eps (never below p_min) until the
    weighted average meets the budget."""
    guard = 0
    while weighted_average(ctx, q) > p_target + 1e-9 and guard < 10000:
        b = rng.integers(len(q))
        q[b] = max(q[b] - eps, p_min[b])
        guard += 1
    return q


def _repair_up(ctx: CalibContext, q: np.ndarray, p_target: float,
               max_sparsity: float, eps: float, rng) -> np.ndarray:
    """Randomly walk blocks up by eps (never above max_sparsity) until
    the weighted average reaches the budget — clipping a warm start at
    max_sparsity sheds budget mass, and nothing downstream restores it
    (the KL fitness *prefers* denser candidates, so an under-budget rung
    would silently ship less sparsity than its label)."""
    guard = 0
    while weighted_average(ctx, q) < p_target - 1e-9 and guard < 10000:
        if not (q < max_sparsity - 1e-12).any():
            break                       # budget infeasible at this cap
        b = rng.integers(len(q))
        q[b] = min(q[b] + eps, max_sparsity)
        guard += 1
    return q


def block_level_allocation(ctx: CalibContext, p_target: float,
                           cfg: EvoConfig = EvoConfig(),
                           alphas: Optional[Dict[Key, float]] = None,
                           log=None, *,
                           p_init: Optional[np.ndarray] = None,
                           p_min: Optional[np.ndarray] = None,
                           generations: Optional[int] = None) -> np.ndarray:
    """Alg. 3.  Returns per-block prune ratios p (averaging to p_target).

    p_init       warm start: search from these ratios (uniformly shifted
                 to the new budget) instead of the uniform vector.
    p_min        per-block floor the search never crosses — with the
                 previous rung's ratios here, every candidate (and the
                 result) keeps at most as many channels per block as that
                 rung (ladder monotonicity).
    generations  per-call override of cfg.generations (warm-started
                 searches refine; they don't need the cold budget).
    """
    N = ctx.num_blocks
    rng = np.random.default_rng(cfg.seed)
    alphas = alphas or {}
    gens = cfg.generations if generations is None else generations
    p_min = np.zeros(N) if p_min is None else \
        np.asarray(p_min, np.float64).copy()
    if weighted_average(ctx, p_min) > p_target + 1e-9:
        raise ValueError(
            f"p_min averages to {weighted_average(ctx, p_min):.4f} > "
            f"budget {p_target}; ladder budgets must be ascending")

    def fitness(p):
        return block_fitness(ctx, p, alphas)

    if p_init is None:
        p = np.full(N, p_target, np.float64)
    else:
        p = np.asarray(p_init, np.float64).copy()
        # block weights are normalized, so a uniform shift moves the
        # weighted average by exactly the shift; clipping to the feasible
        # band can move it either way, so repair in both directions
        p += p_target - weighted_average(ctx, p)
    p = np.clip(p, p_min, cfg.max_sparsity)
    p = _repair_up(ctx, p, p_target, cfg.max_sparsity, cfg.eps, rng)
    p = _repair_down(ctx, p, p_target, p_min, cfg.eps, rng)
    best_fit = fitness(p)
    if log:
        log(f"gen 0 {'warm' if p_init is not None else 'uniform'} "
            f"KL={best_fit:.6f}")

    for gen in range(1, gens + 1):
        offspring = []
        for _ in range(cfg.offspring):
            q = p.copy()
            flips = max(1, int(round(N * cfg.mutate_frac)))
            for b in rng.choice(N, flips, replace=False):
                q[b] = min(q[b] + cfg.eps, cfg.max_sparsity)
            q = _repair_down(ctx, q, p_target, p_min, cfg.eps, rng)
            offspring.append(q)
        fits = [fitness(q) for q in offspring]
        i = int(np.argmin(fits))
        if not cfg.elitist or fits[i] < best_fit:
            p, best_fit = offspring[i], fits[i]
        if log and (gen % max(1, gens // 10) == 0):
            log(f"gen {gen} KL={best_fit:.6f} "
                f"spread=[{p.min():.3f},{p.max():.3f}]")
    return p


def intra_block_allocation(ctx: CalibContext, depth: int, p_block: float,
                           delta: float = 0.05,
                           alphas: Optional[Dict[Key, float]] = None,
                           max_sparsity: float = 0.95, *,
                           p_init: Optional[Dict[Key, float]] = None
                           ) -> Dict[Key, float]:
    """Alg. 4.  Returns per-linear prune ratios for block `depth` whose
    size-weighted average meets p_block.

    p_init: warm start — the greedy loop begins from these per-linear
    ratios (a previous ladder rung's fine allocation) and only ever adds
    sparsity, so the result is elementwise >= the starting point."""
    alphas = alphas or {}
    paths = ctx.keys_by_depth[depth]
    if not paths:
        return {}
    keys = [(depth, p) for p in paths]
    sizes = np.array([ctx.sizes[k] for k in keys])
    p_init = p_init or {}
    p = {k: float(p_init.get(k, 0.0)) for k in keys}

    def effective():
        vals = np.array([p[k] for k in keys])
        return float(np.sum(vals * sizes) / np.sum(sizes))

    def block_err(trial):
        from repro_torch.core.alpha_search import _sp_for_block
        ratios = {k: 1.0 - v for k, v in trial.items()}
        sp = _sp_for_block(ctx, ctx.layers[depth], alphas, ratios)
        return ctx.block_mse(depth, sp)

    guard = 0
    while effective() < p_block - 1e-9 and guard < 10000:
        best_err, best_key = np.inf, None
        for k in keys:
            if p[k] + delta > max_sparsity:
                continue
            trial = dict(p)
            trial[k] = p[k] + delta
            err = block_err(trial)
            if err < best_err:
                best_err, best_key = err, k
        if best_key is None:
            break
        p[best_key] += delta
        guard += 1
    return p


def allocate(ctx: CalibContext, p_target: float,
             evo: EvoConfig = EvoConfig(), delta: float = 0.05,
             alphas: Optional[Dict[Key, float]] = None, log=None, *,
             p_init: Optional[np.ndarray] = None,
             p_min: Optional[np.ndarray] = None,
             layer_init: Optional[Dict[Key, float]] = None,
             generations: Optional[int] = None):
    """Coarse-to-fine: returns (block_ratios p, per-linear prune ratios).
    The keyword-only args warm-start both stages from an adjacent ladder
    rung's solution (see :func:`block_level_allocation`)."""
    p = block_level_allocation(ctx, p_target, evo, alphas, log,
                               p_init=p_init, p_min=p_min,
                               generations=generations)
    per_linear: Dict[Key, float] = {}
    for d in range(ctx.num_blocks):
        per_linear.update(intra_block_allocation(
            ctx, d, float(p[d]), delta, alphas, p_init=layer_init))
        if log:
            log(f"block {d} fine allocation done (p_B={p[d]:.3f})")
    return p, per_linear
