"""Model assembly for dense-attention decoders (port of the JAX package's
``models/model.py`` for ``("attn", "dense")`` layers — llama31_8b).

Parameters keep the reference's stacked layout: ``params["groups"][g]``
is a dict of ``(reps, ...)`` tensors per pattern position (``"l0"``), so
key paths match the JAX tree leaf for leaf.  Where the reference scans
a group with ``lax.scan``, the port runs a Python loop over the stacked
layers, indexing each rep's view; per-block policies fold in per layer
through ``SparsityPolicy.resolve_depth``.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
emits caches), ``decode`` (one token per row against the pool caches,
written in place), ``chunk`` (one request's prefill chunk written in
place into its pool slot) and ``verify`` (a window of tokens per pool
row at per-row offsets, written in place: speculative decoding).  The
chunk and verify offsets and the chunk's slot are device tensors, read
by the device alone, so both steps can be captured as CUDA graphs.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_linear
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import apply_rope, dense, rmsnorm, rope_angles
from repro_torch.models.mlp import mlp_apply, mlp_schema
from repro_torch.models.params import ParamSpec, stacked

SUPPORTED_KIND = ("attn", "dense")
MODES = ("train", "prefill", "decode", "chunk", "verify")


def check_supported(cfg: ModelConfig) -> None:
    kinds = set(cfg.layer_kinds())
    if kinds != {SUPPORTED_KIND} or cfg.family in ("encdec", "vlm"):
        raise NotImplementedError(
            f"{cfg.name}: the port serves dense-attention decoders "
            f"({SUPPORTED_KIND} layers); got family {cfg.family!r} with "
            f"layer kinds {sorted(kinds)}")


# ---------------------------------------------------------------------------
# Schema
# ---------------------------------------------------------------------------

def attn_schema(cfg: ModelConfig):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, H * hd), ("embed", "heads_flat")),
        "wk": ParamSpec((d, KV * hd), ("embed", "kv_flat")),
        "wv": ParamSpec((d, KV * hd), ("embed", "kv_flat")),
        "wo": ParamSpec((H * hd, d), ("heads_flat", "embed")),
    }


def layer_schema(cfg: ModelConfig, kind):
    if tuple(kind) != SUPPORTED_KIND:
        raise NotImplementedError(f"layer kind {kind} is not ported")
    return {
        "ln1": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "attn": attn_schema(cfg),
        "ln2": ParamSpec((cfg.d_model,), (None,), init="zeros"),
        "mlp": mlp_schema(cfg),
    }


def model_schema(cfg: ModelConfig):
    check_supported(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    s = {
        "embed": ParamSpec((V, D), ("vocab", "embed")),
        "final_norm": ParamSpec((D,), (None,), init="zeros"),
        "groups": [stacked({f"l{j}": layer_schema(cfg, kind)
                            for j, kind in enumerate(pattern)},
                           reps, "layers")
                   for pattern, reps in cfg.layer_groups()],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    return s


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _index(tree, r: int):
    """Rep ``r`` of a stacked tree: views, so cache writes land in place."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _index(v, r) for k, v in tree.items()}
    return tree[r]


def attn_apply(p, x, cfg: ModelConfig, sp=None, cache=None, positions=None,
               mode: str = "train", slot=None, policy=None,
               token_weights=None):
    """Self-attention for one layer.

    ``decode``: x (B,1,D), ``positions`` (B,) tensor, ``cache`` the
    layer's pool views, written in place after the new token is attended
    explicitly.  ``chunk``: x (1,C,D) one request's chunk, ``positions``
    the chunk-start offset as a (1,) tensor, ``slot`` its pool slot as a
    0-d tensor; the chunk's K/V are written at (slot, offset) and the
    slot's row is then read by index.  ``verify``: x (S,C,D) one window
    per pool row, ``positions`` (S,) per-row offsets; the window's K/V
    are written and the whole pool attended in place.  Both write before
    they attend, as the reference's donated ``dynamic_update_slice``
    does."""
    sp = sp or {}
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    tw = token_weights

    def proj(name, xin):
        return dense(xin, p[name], sp.get(name), policy=policy,
                     role=f"attn/{name}", token_weights=tw)

    q = proj("wq", x).reshape(B, S, H, hd)
    k = proj("wk", x).reshape(B, S, KV, hd)
    v = proj("wv", x).reshape(B, S, KV, hd)

    if cfg.rope_theta:
        if mode == "decode":
            pos = positions[:, None]
        elif mode in ("chunk", "verify"):
            pos = positions.reshape(-1, 1) + torch.arange(S, device=x.device)
        else:
            pos = torch.arange(S, device=x.device)[None]
        cos, sin = rope_angles(pos, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)

    if mode in ("chunk", "verify"):
        kc, vc = cache["k"], cache["v"]          # pool: (S,KV,hd,T)/(S,KV,T,hd)
        if mode == "chunk":
            rows, offs = slot.reshape(1), positions.reshape(1)
        else:
            rows, offs = torch.arange(B, device=x.device), positions
        attn_lib.cache_write_window(kc, vc, k, v, rows, offs)
        if mode == "chunk":
            ks, vs = kc.index_select(0, rows), vc.index_select(0, rows)
        else:
            ks, vs = kc, vc                      # every pool row, in place
        out = attn_lib.chunk_attention(q, ks, vs, offs,
                                       attn_softcap=cfg.attn_softcap)
        return proj("wo", out.reshape(B, S, H * hd)), {"k": kc, "v": vc}

    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        k_new, v_new = k[:, 0], v[:, 0]               # (B,KV,hd)
        out = attn_lib.decode_attention(
            q[:, 0], kc, vc, positions, k_new, v_new,
            attn_softcap=cfg.attn_softcap)[:, None]
        attn_lib.cache_write_kv(kc, vc, k_new, v_new, positions)
        new_cache = {"k": kc, "v": vc}
    else:
        out = attn_lib.flash_attention(q, k, v, attn_softcap=cfg.attn_softcap)
        new_cache = None
        if mode == "prefill":
            # decode-layout caches: K as (B,KV,hd,T), V as (B,KV,T,hd)
            new_cache = {"k": k.permute(0, 2, 3, 1).contiguous(),
                         "v": v.permute(0, 2, 1, 3).contiguous()}
    return proj("wo", out.reshape(B, S, H * hd)), new_cache


def layer_apply(p, x, cfg: ModelConfig, sp=None, cache=None, positions=None,
                mode: str = "train", slot=None, policy=None,
                token_weights=None):
    """One pre-norm decoder layer.  ``policy`` is already depth-resolved;
    None runs dense.  Returns (x, {"self": cache} or None)."""
    if policy is None:
        policy = sparse_linear.DENSE
    sp = sp or {}
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    h, nc = attn_apply(p["attn"], h, cfg, sp.get("attn"),
                       (cache or {}).get("self"), positions, mode, slot=slot,
                       policy=policy, token_weights=token_weights)
    x = x + h
    h = rmsnorm(x, p["ln2"], cfg.norm_eps)
    x = x + mlp_apply(p["mlp"], h, cfg, sp.get("mlp"), policy=policy,
                      token_weights=token_weights)
    return x, ({"self": nc} if nc is not None else None)


def run_groups(groups, x, cfg: ModelConfig, *, mode="train", caches=None,
               positions=None, sp=None, slot=None, policy=None,
               token_weights=None):
    """Run every stacked layer group in depth order.  Returns (x, caches):
    the pool caches updated in place for decode/chunk/verify, fresh
    stacked caches for prefill, None for train."""
    fresh = []
    depth = 0
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        gp = groups[gi]
        gc = caches[gi] if caches is not None else None
        gsp = sp[gi] if sp is not None else None
        made = [[] for _ in pattern]
        for r in range(reps):
            for j, _kind in enumerate(pattern):
                lpol = policy.resolve_depth(depth) if policy is not None \
                    else None
                x, nc = layer_apply(
                    _index(gp[f"l{j}"], r), x, cfg,
                    _index(gsp[f"l{j}"], r) if gsp is not None else None,
                    _index(gc[j], r) if gc is not None else None,
                    positions, mode, slot=slot, policy=lpol,
                    token_weights=token_weights)
                if mode == "prefill":
                    made[j].append(nc)
                depth += 1
        if mode == "prefill":
            fresh.append(tuple(
                {"self": {n: torch.stack([c["self"][n] for c in per])
                          for n in ("k", "v")}} for per in made))
    if mode == "prefill":
        return x, fresh
    return x, (caches if mode in ("decode", "chunk", "verify") else None)


def embed_tokens(params, tokens, cfg: ModelConfig):
    e = params["embed"][tokens]
    if cfg.scale_embed:
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype)
    return e


def lm_logits(params, x, cfg: ModelConfig):
    """(B,S,D) -> f32 logits (B,S,V), accumulated in f32."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    if x2.is_cuda and x2.dtype != torch.float32:
        # f32 output from the low-precision operands, without an f32 copy
        # of the (V, D) head
        logits = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        logits = x2.float() @ w.float()
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits.reshape(B, S, -1)


def forward(params, cfg: ModelConfig, *, tokens, mode="train", caches=None,
            positions=None, sp=None, slot=None, policy=None,
            token_weights=None):
    """Unified forward.

    train/prefill: tokens (B,S).
    decode:        tokens (B,), positions (B,) tensor, caches = the pool.
    chunk:         tokens (1,C) one request's prefill chunk, positions =
                   chunk-start offset (a (1,) tensor), slot = its pool
                   slot (a 0-d tensor), caches = the full slot pool.
    verify:        tokens (S,C) one window per pool row, positions (S,)
                   per-row start offsets, caches = the full slot pool.

    Returns (logits, caches): train -> (B,S,V), None; prefill -> (B,V)
    at the last position, fresh caches; decode -> (B,V), pool updated in
    place; chunk/verify -> (B,C,V), pool updated in place.
    """
    if mode not in MODES:
        raise NotImplementedError(
            f"forward mode {mode!r}: the port runs {MODES}")
    if policy is None:
        policy = sparse_linear.DENSE
    if mode == "decode":
        tokens = tokens[:, None]
    x = embed_tokens(params, tokens, cfg)
    x, new_caches = run_groups(
        params["groups"], x, cfg, mode=mode, caches=caches,
        positions=positions, sp=sp, slot=slot, policy=policy,
        token_weights=token_weights)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if mode == "decode":
        return lm_logits(params, x, cfg)[:, 0], new_caches
    if mode == "prefill":
        return lm_logits(params, x[:, -1:], cfg)[:, 0], new_caches
    return lm_logits(params, x, cfg), new_caches
