"""Paper Table 2: component ablation at 50% sparsity (port of the JAX
package's ``benchmarks/table2_ablation.py``).

Rows: activation-only -> +weight importance -> +coarse (block) search ->
+fine (layer) search.  The paper's claim is strict ordering (58.64 ->
61.57 -> 62.10 -> 63.57 avg accuracy); the row ``ordering_holds`` says
whether the same ordering holds on calibration KL (printed, not
asserted, as in the reference)."""
from __future__ import annotations

from repro_torch.core import pipeline
from repro_torch.core.allocation import EvoConfig
from repro_torch.device import sync
from repro_torch.evals.common import driver_model, eval_metrics
from repro_torch.obs.clock import now


def run(log=print, device="cuda", model=None):
    """Table 2's rows on ``model`` = (params, cfg, data_cfg), by default
    the trained reduced model."""
    (params, cfg, data_cfg), (ctx, batch) = driver_model(model, device)
    evo = EvoConfig(generations=4, offspring=8, eps=0.1, seed=0)
    p = 0.5
    variants = [
        ("act_only", dict(skip_coarse=True, skip_fine=True, skip_alpha=True,
                          alpha_default=0.0)),
        ("plus_weight", dict(skip_coarse=True, skip_fine=True,
                             coord_passes=0)),
        ("plus_coarse", dict(skip_fine=True, coord_passes=0, evo=evo)),
        ("plus_fine", dict(coord_passes=0, evo=evo, delta=0.25)),
    ]
    rows = []
    kls = []
    for name, kw in variants:
        t0 = now()
        plan = pipeline.run_pipeline(params, cfg, batch, p, ctx=ctx, **kw)
        sync(params["embed"].device)
        us = (now() - t0) * 1e6
        kl = ctx.fitness(plan.per_depth_sp)
        m = eval_metrics(params, cfg, data_cfg, plan.per_depth_sp)
        kls.append(kl)
        log(f"{name:12s} KL={kl:.5f} ppl={m['ppl']:.3f} "
            f"agree={m['top1_agree']:.3f}")
        rows.append((f"table2/{name}", us,
                     f"kl={kl:.5f};ppl={m['ppl']:.4f};"
                     f"agree={m['top1_agree']:.4f}"))
    ordered = all(kls[i] >= kls[i + 1] - 1e-9 for i in range(len(kls) - 1))
    log(f"ablation ordering (act>=+w>=+coarse>=+fine on KL): {ordered}")
    rows.append(("table2/ordering_holds", 0.0, str(ordered)))
    return rows


if __name__ == "__main__":
    run()
