"""Mixture-of-Experts FFN with capacity-bounded gather dispatch (port of
the JAX package's ``models/moe.py``, with its sharding constraints).

A group is the batch dim of x, in every mode: one token per group in
decode, one request's chunk in chunked prefill, one slot's window in
verify.  Within a group each token routes to its top-k experts, a stable
sort by expert id gives each assignment its position in its expert, and
assignments past the capacity are dropped.  The (E, C) dispatch table of
each group gathers the experts' rows; every expert, the pad experts
included, runs its projections over its C rows of every group, as the
reference computes them, through one expert-batched projection each
(``core/sparse_linear.project_experts``: under ``pallas`` one launch of
each kernel for all experts).  The combine adds each token's gated expert outputs in
ascending expert id, in x's dtype.

Every op reads shapes only, never a device value, so the decode, chunk
and verify steps that run it can be captured as CUDA graphs.

On a mesh the routing and dispatch run on each rank's rows (groups are
independent), the dispatched rows are laid out ``("batch", "experts",
None, None)`` as the reference constrains them, the expert projections
run as DTensor products, and the combine gathers every expert's rows
for the rank's tokens.
"""
from __future__ import annotations

import torch

from repro_torch.core.sparse_linear import project_experts
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.kernels.select import topk_ids
from repro_torch.models.layers import gelu, silu
from repro_torch.models.params import ParamSpec


def moe_schema(cfg):
    """Router and stacked expert weights.  E is padded up to the
    reference's TP width (``cfg.num_experts_padded``); pad experts carry
    ``-inf`` router logits and are never routed to."""
    d, f, e = cfg.d_model, cfg.expert_d_ff, cfg.num_experts_padded
    return {
        "router": ParamSpec((d, e), ("embed", None), scale=0.02),
        "wi_gate": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wi_up": ParamSpec((e, d, f), ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((e, f, d), ("experts", "expert_mlp", "embed")),
    }


def _capacity(tokens_per_group: int, cfg) -> int:
    """Rows per expert per group: the reference's expression, over the
    unpadded expert count."""
    c = int(tokens_per_group * cfg.num_experts_per_tok / cfg.num_experts
            * cfg.capacity_factor) + 1
    return max(c, 1)


def expert_rows(cfg, groups: int, tokens_per_group: int) -> int:
    """Rows each expert projection sees for x of (groups, tokens, D)."""
    return groups * _capacity(tokens_per_group, cfg)


def route(p, x, cfg):
    """(gate (B,S,K) f32, experts (B,S,K)): the router's f32-accumulated
    logits, pad experts at ``-inf``, softmax, the top K in ``lax.top_k``
    order, gates renormalised by ``max(sum, 1e-9)``."""
    E = cfg.num_experts_padded
    logits = x.float() @ p["router"].float()                    # (B,S,E)
    if E != cfg.num_experts:
        logits[..., cfg.num_experts:] = float("-inf")
    probs = torch.softmax(logits, dim=-1)
    topk = topk_ids(probs, cfg.num_experts_per_tok)
    gate = probs.gather(-1, topk)
    gate = gate / torch.clamp(gate.sum(-1, keepdim=True), min=1e-9)
    return gate, topk


def dispatch(topk, S: int, C: int, E: int):
    """Per group, the stable sort of the S*K assignments by expert id.
    Returns (disp (B,E,C) token ids with S the pad row, pos (B,S,K) each
    assignment's position in its expert, counts (B,E)).

    The reference scatters ``where(keep, pos, 0)``: a dropped assignment
    writes the pad row at position 0 of its expert, after the kept one
    there (``src/repro/models/moe.py:79-81``; the last write wins).  So an
    expert over capacity loses its position-0 token; written here
    explicitly, since a scatter with repeated indices has no order on the
    card."""
    B, _, K = topk.shape
    A = S * K
    dev = topk.device
    exp_id = topk.reshape(B, A)
    exp_s, order = torch.sort(exp_id, dim=-1, stable=True)
    counts = torch.zeros(B, E, dtype=torch.long, device=dev).scatter_add_(
        1, exp_s, torch.ones_like(exp_s))
    starts = torch.cumsum(counts, 1) - counts
    pos_s = torch.arange(A, device=dev) - starts.gather(1, exp_s)
    keep = pos_s < C
    tok_s = torch.div(order, K, rounding_mode="floor")
    # kept assignments own distinct table cells; dropped ones write one
    # spare cell past the table
    cell = torch.where(keep, exp_s * C + pos_s, E * C)
    disp = torch.full((B, E * C + 1), S, dtype=torch.long, device=dev)
    disp.scatter_(1, cell, torch.where(keep, tok_s, S))
    disp = disp[:, :E * C].reshape(B, E, C)
    disp[:, :, 0] = torch.where(counts > C, S, disp[:, :, 0])
    pos = torch.empty_like(pos_s).scatter_(1, order, pos_s)
    return disp, pos.reshape(B, S, K), counts


def moe_apply(p, x, cfg, sp=None, policy=None):
    """x: (B, S, D) -> (B, S, D).  Groups = batch dim.

    ``policy``: the layer's SparsityPolicy; the expert projections run
    under its ``moe/wi_gate``, ``moe/wi_up`` and ``moe/wo`` roles, with
    no token weights (the reference passes ``token_weights=None``)."""
    sp = sp or {}
    B, S, D = x.shape
    E, C = cfg.num_experts_padded, _capacity(S, cfg)
    xe, gate, topk, pos = sharding.local_call(
        lambda x, router: _route_dispatch(x, router, cfg, C),
        (x, p["router"]), (("batch", None, None), (None, None)),
        (("batch", None, None, None), ("batch", None, None),
         ("batch", None, None), ("batch", None, None)))
    xe = constrain(xe, "batch", "experts", None, None)
    # experts first: (E, B*C, D), each expert's rows of every group
    xe = xe.transpose(0, 1).reshape(E, B * C, D)

    def ff(name, h):
        return project_experts(h.contiguous(), p[name], sp.get(name),
                               policy=policy, role=f"moe/{name}")

    def groups_first(t, *axes):                 # (E,B*C,X) -> (B,E,C,X)
        return constrain(sharding.unflatten(t, 1, (B, C)).transpose(0, 1),
                         *axes)

    act = silu if cfg.mlp_activation == "swiglu" else gelu
    h = act(ff("wi_gate", xe)) * ff("wi_up", xe)                 # (E,B*C,F)
    h = groups_first(h, "batch", "experts", None, "expert_mlp")
    ye = ff("wo", h.transpose(0, 1).reshape(E, B * C, -1))       # (E,B*C,D)
    ye = groups_first(ye, "batch", "experts", None, None)
    out = sharding.local_call(
        lambda ye, gate, topk, pos: _combine(ye, gate, topk, pos, C),
        (ye, gate, topk, pos),
        (("batch", None, None, None), ("batch", None, None),
         ("batch", None, None), ("batch", None, None)),
        ("batch", None, None))
    return constrain(out, "batch", None, "embed_act").to(x.dtype)


def _route_dispatch(x, router, cfg, C: int):
    """One rank's groups: (xe (B,E,C,D) each expert's dispatched rows,
    gate (B,S,K), topk (B,S,K), pos (B,S,K))."""
    B, S, D = x.shape
    E = cfg.num_experts_padded
    gate, topk = route({"router": router}, x, cfg)
    disp, pos, _ = dispatch(topk, S, C, E)
    xg = torch.cat([x, x.new_zeros(B, 1, D)], 1)                 # (B,S+1,D)
    xe = xg.gather(1, disp.reshape(B, E * C, 1).expand(-1, -1, D))
    return xe.reshape(B, E, C, D), gate, topk, pos


def _combine(ye, gate, topk, pos, C: int):
    """ye (B,E,C,D) every expert's outputs for one rank's groups -> (B,S,D)
    in ye's dtype.  Token (b, s)'s K assignments in ascending expert id,
    each read at its position (clipped; a dropped one is gated to 0) and
    added in x's dtype, as the reference's sorted scatter-add adds
    them."""
    B, E, _, D = ye.shape
    S, K = topk.shape[1], topk.shape[2]
    ye = ye.transpose(0, 1)                                      # (E,B,C,D)
    eid, k_of = torch.sort(topk, dim=-1)                         # (B,S,K)
    g_k = gate.gather(-1, k_of)
    p_k = pos.gather(-1, k_of)
    kept = (p_k < C).to(g_k.dtype)
    rows = (eid * B + torch.arange(B, device=ye.device)[:, None, None]) * C \
        + torch.clamp(p_k, max=C - 1)
    vals = ye.reshape(E * B * C, D).index_select(0, rows.reshape(-1))
    vals = vals.reshape(B, S, K, D) * (g_k * kept).to(ye.dtype)[..., None]
    out = vals[:, :, 0]
    for k in range(1, K):
        out = out + vals[:, :, k]
    return out
