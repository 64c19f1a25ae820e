"""Paper Fig. 6: calibrated alpha values across layers/projection types
(port of the JAX package's ``benchmarks/fig6_alpha.py``)."""
from __future__ import annotations

import numpy as np

from repro_torch.core import alpha_search
from repro_torch.evals.common import driver_model


def run(log=print, device="cuda", model=None):
    """Fig. 6's rows on ``model`` = (params, cfg, data_cfg), by default
    the trained reduced model."""
    _, (ctx, _) = driver_model(model, device)
    ratios = {(d, p): 0.5 for d in range(ctx.num_blocks)
              for p in ctx.keys_by_depth[d]}
    alphas = alpha_search.search_all_alphas(ctx, ratios, coord_passes=1)
    by_proj = {}
    for (_d, path), a in alphas.items():
        by_proj.setdefault(path, []).append(a)
    rows = []
    for path, vals in sorted(by_proj.items()):
        log(f"alpha[{path}]: mean={np.mean(vals):.3f} "
            f"range=[{min(vals):.2f},{max(vals):.2f}]")
        rows.append((f"fig6/alpha/{path.replace('/', '_')}", 0.0,
                     f"mean={np.mean(vals):.4f};min={min(vals):.2f};"
                     f"max={max(vals):.2f}"))
    nontrivial = any(np.std(v) > 0 or np.mean(v) not in (0.0,)
                     for v in by_proj.values())
    rows.append(("fig6/alphas_nontrivial", 0.0, str(bool(nontrivial))))
    return rows


if __name__ == "__main__":
    run()
