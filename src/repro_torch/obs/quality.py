"""The calibration side of the JAX package's ``obs/quality.py``: the
helpers that :func:`repro_torch.sparsity.ladder.calibrate_ladder` uses to
record a ladder's quality baselines.  The serving-time
``QualityMonitor`` that compares live traffic against them is not
ported yet (``ROADMAP.md`` queue 1 item 6)."""
from __future__ import annotations

import numpy as np
import torch


def rep_saliency_leaf(sp_d, d_model: int):
    """First sparsifiable leaf of a per-depth sp dict whose ``g`` norms
    live on the block-input channel axis -> (g, alpha) as numpy, or
    ``None`` when the block has no such leaf.  Deterministic (sorted
    walk), so calibration and serving always pick the same leaf."""
    def walk(node):
        if not isinstance(node, dict):
            return None
        if "g" in node and "alpha" in node:
            g = np.asarray(torch.as_tensor(node["g"]).detach().cpu(),
                           np.float32)
            if g.ndim == 1 and g.shape[0] == d_model:
                return g, float(torch.as_tensor(node["alpha"]))
            return None
        for k in sorted(node):
            found = walk(node[k])
            if found is not None:
                return found
        return None
    return walk(sp_d)


def saliency_channels(x_mean_abs: np.ndarray, g: np.ndarray, alpha: float,
                      k: int) -> np.ndarray:
    """Top-k channel indices of the WiSparse saliency score
    ``|x| * max(g, 1e-12)^alpha`` (sorted, for stable set compares)."""
    scores = np.asarray(x_mean_abs, np.float32) \
        * np.maximum(np.asarray(g, np.float32), 1e-12) ** float(alpha)
    k = min(int(k), scores.shape[0])
    return np.sort(np.argpartition(-scores, k - 1)[:k]).astype(np.int64)


def unstack_sp(cfg, sp):
    """Stacked group sp tree -> per-depth sp list (inverse of
    :func:`repro_torch.core.unstacked.restack_sp`); the leaves are views
    of the stacked tensors."""
    def index(node, r):
        if isinstance(node, dict):
            return {k: index(v, r) for k, v in node.items()}
        return node[r]

    per_depth = []
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        gsp = sp[gi]
        for r in range(reps):
            for j in range(len(pattern)):
                per_depth.append(index(gsp[f"l{j}"], r))
    return per_depth
