"""Unstacked (per-depth Python loop) model execution for calibration and
search (port of the JAX package's ``core/unstacked.py``).

Calibration unstacks the layer groups into a list of per-depth layers and
reuses the model's own ``layer_apply``, so the numerics are the serving
forward's.  The port supports the layers its model runs (``attn``,
``local`` and ``global`` attention or a ``mamba`` block, with a dense
MLP, a MoE FFN or none, each layer run as its own kind, jamba's mixed
pattern positions included); an expert leaf's sp entry carries one g
row per expert, (E, n) per depth and (reps, E, n) stacked.  On
whisper the depths are the decoder's, each with its ``cross`` leaves;
the encoder runs whole (dense, as the reference's calibration runs it)
and its output feeds every block's cross-attention.  On InternVL the
patch embeddings precede the tokens, so every block's rows include
them.

The capture hook keys activations on ``id(w)``, and ``tensor[r]`` makes a
new Python object on every call.  So :func:`unstack_layers` builds each
depth's weight views once, and those very objects are what the layer
loop hands to ``project``.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model as M
from repro_torch.models import params as P
from repro_torch.models.layers import rmsnorm, sinusoidal_positions

# weight-leaf names WiSparse sparsifies: every channel-sparse linear in the
# zoo (attention q/k/v/o, MLP gate/up/down, SSM input/output projections);
# convs, norms, routers and the SSD recurrence stay dense
SPARSIFIABLE = {
    "wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wi",
    "in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj",
}


@dataclasses.dataclass
class DepthLayer:
    depth: int
    kind: Tuple[str, str]            # (mixer, ffn)
    group: int
    rep: int
    pos: int
    params: dict


def unstack_layers(cfg: ModelConfig, params) -> List[DepthLayer]:
    M.check_supported(cfg)
    layers, depth = [], 0
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        gp = params["groups"][gi]
        for r in range(reps):
            for j, kind in enumerate(pattern):
                lp = P.tree_map(lambda a, r=r: a[r], gp[f"l{j}"])
                layers.append(DepthLayer(depth, tuple(kind), gi, r, j, lp))
                depth += 1
    return layers


def _stack(trees):
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def restack_sp(cfg: ModelConfig, per_depth_sp: List[Optional[dict]]):
    """Per-depth sparsity dicts -> stacked group sp tree for the serving
    model."""
    out, d = [], 0
    for pattern, reps in cfg.layer_groups():
        slots = [[] for _ in pattern]
        for _r in range(reps):
            for j in range(len(pattern)):
                slots[j].append(per_depth_sp[d])
                d += 1
        out.append({f"l{j}": _stack(slots[j]) for j in range(len(pattern))})
    return out


def sparsifiable_leaves(layer_params: dict, prefix: str = ""):
    """Yield (path, weight) for sparsifiable linears within one layer, in
    sorted key order (the order every search stage walks them)."""
    for k, v in sorted(layer_params.items()):
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from sparsifiable_leaves(v, path + "/")
        elif k in SPARSIFIABLE and v.dim() >= 2:
            yield path, v


def default_layer_sp(layer_params: dict):
    """Dense-equivalent sp dict (alpha=0, tau=-inf, keep=1) mirroring the
    sparsifiable subtree of one layer's params."""
    from repro_torch.core import sparse_linear as sl

    def rec(d):
        out = {}
        for k, v in d.items():
            if isinstance(v, dict):
                sub = rec(v)
                if sub:
                    out[k] = sub
            elif k in SPARSIFIABLE and v.dim() == 3:
                # MoE (E, n_in, n_out): one g per expert
                out[k] = {**sl.default_sp(v[0]),
                          "g": sl.expert_column_norms(v)}
            elif k in SPARSIFIABLE and v.dim() >= 2:
                out[k] = sl.default_sp(v)
        return out

    return rec(layer_params)


def set_sp_leaf(sp: dict, path: str, key: str, value):
    """Set one scalar of the sp leaf at ``path`` to a 0-d f32 tensor on
    the leaf's device (the leaf dict is copied, never mutated)."""
    node = sp
    parts = path.split("/")
    for p in parts[:-1]:
        node = node[p]
    leaf = dict(node[parts[-1]])
    leaf[key] = torch.as_tensor(value, dtype=torch.float32,
                                device=leaf["g"].device)
    node[parts[-1]] = leaf


def get_sp_leaf(sp: dict, path: str) -> dict:
    node = sp
    for p in path.split("/"):
        node = node[p]
    return node


def forward_unstacked(params, cfg: ModelConfig, tokens, *, layers=None,
                      per_depth_sp=None, patch_embeds=None, frames=None,
                      collect_block_inputs=False, policy=None,
                      enc_out=None):
    """Full forward via the Python-loop layer list.  Returns
    (f32 logits, block_inputs or None).  ``policy``: the SparsityPolicy
    driving every projection (depth ranges resolve per layer here; None
    runs dense).  ``frames`` run whisper's encoder under ``policy``
    without its capture (the encoder's inputs are no calibration key,
    and at full width they would be 32 layers x 6 projections x B*1500
    rows); ``enc_out``, when given, stands in for that encoder output.
    ``patch_embeds`` precede the tokens."""
    from repro_torch.core import sparse_linear as _sl
    policy = policy if policy is not None else _sl.DENSE
    layers = layers or unstack_layers(cfg, params)
    if enc_out is None and cfg.family == "encdec" and frames is not None:
        enc_out = M.encode(params, frames, cfg,
                           policy=dataclasses.replace(policy, capture=None))
    x = M.embed_tokens(params, tokens, cfg)
    if patch_embeds is not None:
        x = torch.cat([patch_embeds.to(x.dtype), x], 1)
    if cfg.family == "encdec":
        x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                     x.device).to(x.dtype)[None]
    block_inputs = [] if collect_block_inputs else None
    for dl in layers:
        if collect_block_inputs:
            block_inputs.append(x)
        sp = per_depth_sp[dl.depth] if per_depth_sp is not None else None
        x, _ = M.layer_apply(dl.params, x, cfg, dl.kind, sp, None, None,
                             "train", policy=policy.resolve_depth(dl.depth),
                             enc_out=enc_out)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return M.lm_logits(params, x, cfg), block_inputs


def block_forward(dl: DepthLayer, x, cfg: ModelConfig, sp=None, enc_out=None,
                  policy=None):
    """One transformer block (paper's unit of sensitivity analysis);
    ``enc_out`` feeds an enc-dec block's cross-attention."""
    from repro_torch.core import sparse_linear as _sl
    policy = policy if policy is not None else _sl.DENSE
    out, _ = M.layer_apply(dl.params, x, cfg, dl.kind, sp, None, None,
                           "train", policy=policy.resolve_depth(dl.depth),
                           enc_out=enc_out)
    return out
