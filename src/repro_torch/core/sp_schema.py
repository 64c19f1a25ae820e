"""Builder for stacked sparsity-parameter trees (port of the JAX
package's ``core/sp_schema.default_sp_stacked``)."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_linear as sl
from repro_torch.core.unstacked import SPARSIFIABLE


def default_sp_stacked(params, cfg: ModelConfig, keep_frac: float = 1.0,
                       alpha: float = 1.0, tau: float = float("inf")):
    """Concrete stacked sp tree from model weights: g = column norms,
    uniform alpha/keep_frac/tau, one f32 entry per stacked layer.

    ``tau`` defaults to the reference's ``+inf`` ("unused by the top-k
    serving backends").  The ``mask`` and ``pallas`` backends threshold
    on it, and at ``+inf`` every projection they run returns zeros; pass
    ``tau=-inf`` (the dense-equivalent mask of ``default_sp``) to serve
    ``pallas`` uncalibrated, so the sparsity comes from the block top-k
    at ``keep_frac`` alone."""
    groups = []
    for gi, (pattern, _reps) in enumerate(cfg.layer_groups()):
        gp = params["groups"][gi]

        def rec(d):
            out = {}
            for k, v in d.items():
                if isinstance(v, dict):
                    sub = rec(v)
                    if sub:
                        out[k] = sub
                elif k in SPARSIFIABLE and torch.is_tensor(v) and v.dim() == 3:
                    # stacked weight (reps, n, m); one rep at a time keeps
                    # the f32 temporaries at one layer's size
                    g = torch.stack([sl.column_norms(v[r])
                                     for r in range(v.shape[0])])
                    ones = torch.ones(v.shape[0], dtype=torch.float32,
                                      device=v.device)
                    out[k] = {"g": g,
                              "alpha": ones * alpha,
                              "tau": ones * tau,
                              "keep_frac": ones * keep_frac}
                elif k in SPARSIFIABLE and torch.is_tensor(v) and v.dim() > 3:
                    raise NotImplementedError(
                        "per-expert (MoE) sp trees come with the MoE slice")
            return out

        groups.append({f"l{j}": rec(gp[f"l{j}"])
                       for j in range(len(pattern))})
    return groups
