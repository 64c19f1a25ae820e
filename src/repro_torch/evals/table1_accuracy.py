"""Paper Table 1 (proxy): accuracy-retention vs sparsity for the
training-free methods, on the in-repo trained small LM (port of the JAX
package's ``benchmarks/table1_accuracy.py``).

Methods: activation-only (TEAL-style |x| criterion), WINA-style (|x|*g,
alpha=1, uniform), full WiSparse (searched alpha + mixed-granularity
allocation).  Metric: held-out PPL and top-1 agreement with the dense
model — the offline analogue of the paper's task-accuracy retention.
"""
from __future__ import annotations

from repro_torch.core import pipeline
from repro_torch.core.allocation import EvoConfig
from repro_torch.device import sync
from repro_torch.evals.common import driver_model, eval_metrics
from repro_torch.obs.clock import now

SPARSITIES = (0.3, 0.4, 0.5)
EVO = EvoConfig(generations=4, offspring=8, eps=0.1, seed=0)


def plans_at(params, cfg, batch, ctx, sparsity, evo=EVO) -> dict:
    """The three methods' plans at ``sparsity``: name -> (plan, seconds
    to make it)."""
    makers = {
        "teal_act_only": lambda: pipeline.activation_only_plan(
            params, cfg, batch, sparsity, ctx=ctx),
        "wina_alpha1": lambda: pipeline.run_pipeline(
            params, cfg, batch, sparsity, skip_coarse=True, skip_fine=True,
            skip_alpha=True, alpha_default=1.0, ctx=ctx),
        "wisparse_full": lambda: pipeline.run_pipeline(
            params, cfg, batch, sparsity, evo=evo, delta=0.25,
            coord_passes=0, ctx=ctx),
    }
    out = {}
    for name, make in makers.items():
        t0 = now()
        plan = make()
        sync(params["embed"].device)
        out[name] = (plan, now() - t0)
    return out


def run(log=print, device="cuda", model=None):
    """Table 1's rows on ``model`` = (params, cfg, data_cfg), by default
    the trained reduced model."""
    (params, cfg, data_cfg), (ctx, batch) = driver_model(model, device)
    rows = []
    dense = eval_metrics(params, cfg, data_cfg, None)
    log(f"dense: ppl={dense['ppl']:.3f}")
    rows.append(("table1/dense/ppl", 0.0, f"{dense['ppl']:.4f}"))

    for sparsity in SPARSITIES:
        plans = plans_at(params, cfg, batch, ctx, sparsity)
        us = sum(s for _, s in plans.values()) * 1e6
        for name, (plan, _) in plans.items():
            m = eval_metrics(params, cfg, data_cfg, plan.per_depth_sp)
            retention = dense["ppl"] / m["ppl"]
            log(f"p={sparsity:.0%} {name:16s} ppl={m['ppl']:.3f} "
                f"kl={m['kl']:.4f} agree={m['top1_agree']:.3f} "
                f"retention={retention:.3f}")
            rows.append((f"table1/{name}/p{int(sparsity*100)}", us,
                         f"ppl={m['ppl']:.4f};kl={m['kl']:.5f};"
                         f"agree={m['top1_agree']:.4f}"))
    return rows


if __name__ == "__main__":
    run()
