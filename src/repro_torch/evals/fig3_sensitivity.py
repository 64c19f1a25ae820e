"""Paper Fig. 3 / Observation 2: block-wise sensitivity to
sparsification (port of the JAX package's
``benchmarks/fig3_sensitivity.py``).

Sparsify one block at a time (all other blocks dense) at 40/50/60% and
report the relative change in held-out PPL.  The paper's claim: block
sensitivity is heterogeneous and non-monotonic in depth."""
from __future__ import annotations

from repro_torch.evals.common import driver_model, eval_metrics

SPARSITIES = (0.4, 0.5, 0.6)


def block_deltas(params, cfg, data_cfg, ctx, p, dense_ppl) -> list:
    """Held-out PPL change (%) with block d alone sparsified at ``p``
    (alpha 1, every projection of the block at keep 1 - p), per d."""
    deltas = []
    for d in range(ctx.num_blocks):
        ratios = {(d, path): 1.0 - p for path in ctx.keys_by_depth[d]}
        alphas = {(d, path): 1.0 for path in ctx.keys_by_depth[d]}
        sp = ctx.make_sp(alphas, ratios)
        m = eval_metrics(params, cfg, data_cfg, sp)
        deltas.append((m["ppl"] - dense_ppl) / dense_ppl * 100)
    return deltas


def run(log=print, device="cuda", model=None):
    """Fig. 3's rows on ``model`` = (params, cfg, data_cfg), by default
    the trained reduced model."""
    (params, cfg, data_cfg), (ctx, _) = driver_model(model, device)
    dense = eval_metrics(params, cfg, data_cfg, None)
    rows = []
    spread = {}
    for p in SPARSITIES:
        deltas = block_deltas(params, cfg, data_cfg, ctx, p, dense["ppl"])
        spread[p] = (min(deltas), max(deltas))
        log(f"p={p:.0%} dPPL% per block: "
            + " ".join(f"{d:+.2f}" for d in deltas))
        rows.append((f"fig3/p{int(p*100)}", 0.0,
                     ";".join(f"{d:+.3f}" for d in deltas)))
    hetero = spread[0.5][1] > 2 * max(abs(spread[0.5][0]), 1e-6) or \
        (spread[0.5][1] - spread[0.5][0]) > 0.05
    rows.append(("fig3/heterogeneous", 0.0, str(bool(hetero))))
    log(f"sensitivity heterogeneous across blocks: {hetero}")
    return rows


if __name__ == "__main__":
    run()
