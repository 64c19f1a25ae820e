"""Schema and builders of stacked sparsity-parameter trees (port of the
JAX package's ``core/sp_schema.py``): the form the model's layer loop
consumes, and the abstract inputs the dry run places."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_linear as sl
from repro_torch.core.unstacked import SPARSIFIABLE
from repro_torch.models.params import (ParamSpec, abstract_params,
                                       logical_axes, stacked)


def _rec_schema(d):
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            sub = _rec_schema(v)
            if sub:
                out[k] = sub
        elif isinstance(v, ParamSpec) and k in SPARSIFIABLE and \
                len(v.shape) >= 2:
            if len(v.shape) == 3:      # MoE (E, n, m): per-expert g
                gspec = ParamSpec(v.shape[:2], v.axes[:2], dtype="float32")
            else:
                gspec = ParamSpec(v.shape[:1], v.axes[:1], dtype="float32")
            out[k] = {
                "g": gspec,
                "alpha": ParamSpec((), (), dtype="float32"),
                "tau": ParamSpec((), (), dtype="float32"),
                "keep_frac": ParamSpec((), (), dtype="float32"),
            }
    return out


def sparsity_schema(cfg: ModelConfig):
    """List over layer groups of stacked sp ParamSpec trees (g carries
    its weight's input axis, so it shards with the weight's rows)."""
    from repro_torch.models.model import layer_schema
    groups = []
    for pattern, reps in cfg.layer_groups():
        gd = {}
        for j, kind in enumerate(pattern):
            sub = _rec_schema(layer_schema(cfg, kind,
                                           cross=(cfg.family == "encdec")))
            gd[f"l{j}"] = stacked(sub, reps, "layers")
        groups.append(gd)
    return groups


def abstract_sp(cfg: ModelConfig):
    """(meta sp tree, its logical axes)."""
    schema = sparsity_schema(cfg)
    return abstract_params(schema, "float32"), logical_axes(schema)


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
                elif k in SPARSIFIABLE and torch.is_tensor(v) and \
                        v.dim() in (3, 4):
                    # stacked weight (reps, n, m), or (reps, E, n, m) with
                    # one g per expert; one matrix at a time keeps the f32
                    # temporaries at one expert's size
                    g = torch.stack([
                        sl.column_norms(v[r]) if v.dim() == 3 else
                        sl.expert_column_norms(v[r])
                        for r in range(v.shape[0])])
                    ones = torch.ones(v.shape[0], dtype=torch.float32,
                                      device=v.device)
                    out[k] = {"g": g,
                              "alpha": ones * alpha,
                              "tau": ones * tau,
                              "keep_frac": ones * keep_frac}
            return out

        groups.append({f"l{j}": rec(gp[f"l{j}"])
                       for j in range(len(pattern))})
    return groups
