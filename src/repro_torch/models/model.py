"""Model assembly (port of the JAX package's ``models/model.py`` for
layers whose mixer is ``attn``, ``local`` or ``global`` attention or a
Mamba2 SSD block and whose FFN is a dense MLP, a Mixture-of-Experts FFN
or none: llama31_8b, deepseek_67b, the Gemma family (gemma_2b,
gemma2_2b, gemma3_4b), the granite MoE models (granite_moe_1b_a400m,
granite_moe_3b_a800m), mamba2_130m, the jamba hybrid, the enc-dec
whisper_large_v3 and the VLM internvl2_26b).

Whisper adds an encoder stack (``params["encoder"]``: one stacked group
of bidirectional ``attn_bidir`` layers with a plain GELU MLP, then a
final norm) over precomputed frame embeddings (the conv frontend is a
stub in the reference too), and ``ln_cross``/``cross`` on every decoder
layer: cross-attention over the encoder output, or over the layer's own
input when no frames are given, as the reference.  Its positions are
sinusoidal (no RoPE).  In ``prefill`` each layer stashes the encoder
output's cross K/V, projected dense whatever the policy (the
reference's stash passes no sp tree), as the static cache that
``decode`` attends without a new-token term.  The encoder always runs
dense: no caller passes it an sp tree.  InternVL prepends precomputed
patch embeddings (its vision tower is a stub in the reference) to the
token embeddings in ``train`` and ``prefill``.

Parameters keep the reference's stacked layout: ``params["groups"][g]``
is a dict of ``(reps, ...)`` tensors per pattern position (``"l0"``), so
key paths match the JAX tree leaf for leaf.  Where the reference scans
a group with ``lax.scan``, the port runs a Python loop over the stacked
layers, indexing each rep's view; per-block policies fold in per layer
through ``SparsityPolicy.resolve_depth``.

``local`` layers attend over the last ``cfg.sliding_window`` positions.
Their prefill caches keep only those positions, rolled so that slot
``p % window`` holds position ``p``, and decode reads and writes them
as a rolling window whenever the cache's time length equals the window.

Modes: ``train`` (full sequence, no cache), ``prefill`` (full sequence,
emits caches), ``decode`` (one token per row against the pool caches,
written in place), ``chunk`` (one request's prefill chunk written in
place into its pool slot) and ``verify`` (a window of tokens per pool
row at per-row offsets, written in place: speculative decoding).  The
chunk and verify offsets and the chunk's slot are device tensors, read
by the device alone, so both steps can be captured as CUDA graphs.
Chunk and verify refuse ``local`` layers, as the reference does: a
rolling window cannot resume mid-prompt or roll back; and ``mamba``
layers, whose state has no time axis to write at an offset; and the
enc-dec and VLM families, whose frames or patches no serving step
carries (the reference's engine refuses them, so none of its entry
points reaches these modes with them).
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_linear
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import constrain
from repro_torch.models import attention as attn_lib
from repro_torch.models.layers import (dense, rmsnorm, rope_qk,
                                       sinusoidal_at, sinusoidal_positions,
                                       softcap)
from repro_torch.models.mlp import mlp_apply, mlp_schema
from repro_torch.models.moe import moe_apply, moe_schema
from repro_torch.models.params import ParamSpec, stacked
from repro_torch.models.ssm import mamba_apply, mamba_schema

ATTN_KINDS = ("attn", "local", "global", "attn_bidir")
MIXERS = ATTN_KINDS + ("mamba",)
FFN_KINDS = ("dense", "moe", "none")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
# families whose inputs go beyond tokens (frames, patch embeddings)
MULTIMODAL = ("encdec", "vlm")
# whisper's encoder: one stacked group of this pattern, encoder_layers deep
ENC_PATTERN = (("attn_bidir", "dense"),)
# mixers whose caches are full length, so chunk and verify can write them
# at any offset; a ``local`` layer's window cache rolls, and a ``mamba``
# layer's state has no time axis
CHUNKABLE_MIXERS = ("attn", "global")
MODES = ("train", "prefill", "decode", "chunk", "verify")


def chunkable(cfg: ModelConfig) -> bool:
    """Whether every layer of ``cfg`` runs the chunk and verify modes."""
    return {m for m, _ in cfg.layer_kinds()} <= set(CHUNKABLE_MIXERS)


def has_ssm(cfg: ModelConfig) -> bool:
    """Whether ``cfg`` has a ``mamba`` layer."""
    return any(m == "mamba" for m, _ in cfg.layer_kinds())


def _supported_kind(kind) -> bool:
    mixer, ffn = kind
    return mixer in MIXERS and ffn in FFN_KINDS


def check_supported(cfg: ModelConfig) -> None:
    """Refuse a family or a layer kind the port does not run."""
    kinds = set(cfg.layer_kinds())
    if cfg.family not in FAMILIES or not all(map(_supported_kind, kinds)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs mixers {MIXERS}, "
            f"FFNs {FFN_KINDS} and families {FAMILIES}; got family "
            f"{cfg.family!r} with layer kinds {sorted(kinds)}")


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


def layer_schema(cfg: ModelConfig, kind, cross: bool = False):
    """One layer's params: ``ln1`` and the mixer, with ``cross``
    ``ln_cross`` and the cross-attention (an enc-dec decoder layer),
    then ``ln2`` and the FFN unless it is ``none`` (a mamba2 layer has
    no ``ln2``)."""
    if not _supported_kind(kind):
        raise NotImplementedError(f"layer kind {kind} is not ported")
    mixer, ffn = kind
    s = {"ln1": ParamSpec((cfg.d_model,), (None,), init="zeros")}
    if mixer == "mamba":
        s["mamba"] = mamba_schema(cfg)
    else:
        s["attn"] = attn_schema(cfg)
    if cross:
        s["ln_cross"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        s["cross"] = attn_schema(cfg)
    if ffn != "none":
        s["ln2"] = ParamSpec((cfg.d_model,), (None,), init="zeros")
        if ffn == "moe":
            s["moe"] = moe_schema(cfg)
        else:
            s["mlp"] = mlp_schema(cfg)
    return s


def model_schema(cfg: ModelConfig):
    check_supported(cfg)
    V, D = cfg.vocab_size, cfg.d_model
    cross = cfg.family == "encdec"
    s = {
        "embed": ParamSpec((V, D), ("vocab", "embed")),
        "final_norm": ParamSpec((D,), (None,), init="zeros"),
        "groups": [stacked({f"l{j}": layer_schema(cfg, kind, cross)
                            for j, kind in enumerate(pattern)},
                           reps, "layers")
                   for pattern, reps in cfg.layer_groups()],
    }
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    if cross:
        s["encoder"] = {
            "groups": [stacked({f"l{j}": layer_schema(cfg, kind)
                                for j, kind in enumerate(ENC_PATTERN)},
                               cfg.encoder_layers, "layers")],
            "final_norm": ParamSpec((D,), (None,), init="zeros"),
        }
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


def attn_apply(p, x, cfg: ModelConfig, kind: str = "attn", sp=None,
               cache=None, positions=None, mode: str = "train", slot=None,
               policy=None, token_weights=None, kv_override=None,
               role_base: str = "attn", aligned: bool = False):
    """Self-attention for one layer of mixer ``kind`` (``attn_bidir``:
    no causal mask), or cross-attention over ``kv_override`` (B,F,D)
    under the roles ``{role_base}/w*``.

    Cross-attention projects ``wk``/``wv`` over ``kv_override`` without
    token weights (encoder rows are not the step's tokens) and attends
    all F rows; in ``decode`` it projects only ``wq`` and ``wo`` and
    attends the static cache ``{k: (B,KV,hd,F), v: (B,KV,F,hd)}``.

    ``decode``: x (B,1,D), ``positions`` (B,) tensor, ``cache`` the
    layer's pool views, written in place after the new token is attended
    explicitly.  ``chunk``: x (1,C,D) one request's chunk, ``positions``
    the chunk-start offset as a (1,) tensor, ``slot`` its pool slot as a
    0-d tensor; the chunk's K/V are written at (slot, offset) and the
    slot's row is then read by index.  ``verify``: x (S,C,D) one window
    per pool row, ``positions`` (S,) per-row offsets; the window's K/V
    are written and the whole pool attended in place.  Both write before
    they attend, as the reference's donated ``dynamic_update_slice``
    does.

    A ``local`` layer attends over the last ``cfg.sliding_window``
    positions; in ``prefill`` its cache keeps the last window of them,
    rolled so that slot ``p % window`` holds position ``p``, and in
    ``decode`` a cache whose time length is the window rolls.

    ``aligned`` (decode): every row decodes the same position, so each
    cache takes one slice write (:func:`attention.cache_write_kv`)."""
    sp = sp or {}
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    win = cfg.sliding_window if kind == "local" else 0
    tw = token_weights
    if win and mode == "verify":
        raise NotImplementedError(
            "speculative verify does not support local-attention "
            "layers (rolling-window caches cannot roll back)")
    if win and mode == "chunk":
        raise NotImplementedError(
            "chunked prefill does not support local-attention layers; "
            "use the engine's whole-prompt prefill strategy")

    if mode in ("chunk", "verify") and sharding.is_sharded(x):
        raise NotImplementedError(
            f"{mode} mode runs outside a sharding context (the serving "
            "engine never enters one, as the reference's does not)")

    def proj(name, xin, weights=tw, row_parallel=False):
        return dense(xin, p[name], sp.get(name), row_parallel,
                     policy=policy, role=f"{role_base}/{name}",
                     token_weights=weights)

    def out_proj(out):
        return proj("wo", sharding.flatten(out, 2, 2), row_parallel=True)

    def heads(t, n):                              # (B,S,n*hd) -> (B,S,n,hd)
        return sharding.unflatten(t, -1, (n, hd))

    q = heads(proj("wq", x), H)
    if kv_override is not None:                      # cross-attention
        if mode == "decode":
            kc, vc = cache["k"], cache["v"]
            F = kc.shape[-1]
            out = attn_lib.decode_attention(
                q[:, 0], kc, vc,
                torch.full((B,), F, dtype=torch.long, device=x.device)
            )[:, None]
        else:
            F = kv_override.shape[1]
            k = heads(proj("wk", kv_override, None), KV)
            v = heads(proj("wv", kv_override, None), KV)
            q = constrain(q, "batch", None, "heads", None)
            out = attn_lib.flash_attention(q, k, v, causal=False)
        return out_proj(out), None

    k = heads(proj("wk", x), KV)
    v = heads(proj("wv", x), KV)

    if cfg.rope_theta:
        if mode == "decode":
            pos = positions[:, None]
        elif mode in ("chunk", "verify"):
            pos = positions.reshape(-1, 1) + torch.arange(S, device=x.device)
        else:
            pos = torch.arange(S, device=x.device)[None]
        q, k = rope_qk(q, k, pos, cfg.rope_theta)
    q = constrain(q, "batch", None, "heads", None)

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
        return out_proj(out), {"k": kc, "v": vc}

    if mode == "decode":
        kc, vc = cache["k"], cache["v"]
        rolling = bool(win) and win == kc.shape[-1]
        k_new, v_new = k[:, 0], v[:, 0]               # (B,KV,hd)
        out = attn_lib.decode_attention(
            q[:, 0], kc, vc, positions, k_new, v_new, rolling=rolling,
            attn_softcap=cfg.attn_softcap)[:, None]
        attn_lib.cache_write_kv(kc, vc, k_new, v_new, positions,
                                rolling=rolling, aligned=aligned)
        new_cache = {"k": kc, "v": vc}
    else:
        out = attn_lib.flash_attention(q, k, v, causal=kind != "attn_bidir",
                                       window=win,
                                       attn_softcap=cfg.attn_softcap)
        new_cache = None
        if mode == "prefill":
            ck, cv = k, v
            if win and win < S:                  # rolling window cache
                # slot j of k[:, -win:] holds position S-win+j; roll right
                # by S % win so slot (p % win) holds position p
                def roll(t):
                    return torch.roll(t[:, -win:], S % win, dims=1)
                kv_axes = ("batch", None, "kv_heads", None)
                ck, cv = (sharding.local_call(roll, (t,), (kv_axes,),
                                              kv_axes) for t in (k, v))
            # decode-layout caches: K as (B,KV,hd,T), V as (B,KV,T,hd)
            new_cache = {
                "k": constrain(ck.permute(0, 2, 3, 1).contiguous(),
                               "batch", "kv_heads", None, "kv_seq"),
                "v": constrain(cv.permute(0, 2, 1, 3).contiguous(),
                               "batch", "kv_heads", "kv_seq", None)}
    return out_proj(out), new_cache


def layer_apply(p, x, cfg: ModelConfig, kind, sp=None, cache=None,
                positions=None, mode: str = "train", slot=None, policy=None,
                token_weights=None, enc_out=None, aligned: bool = False):
    """One pre-norm layer of ``kind`` (mixer, ffn).  ``policy`` is
    already depth-resolved; None runs dense.  Returns (x, {"self":
    cache} on an attention layer, {"ssm": cache} on a mamba layer, or
    None); an enc-dec decoder layer adds {"cross": cache} in
    ``prefill`` when ``enc_out`` is given: the cross K/V of the encoder
    output, projected dense."""
    if policy is None:
        policy = sparse_linear.DENSE
    mixer, ffn = kind
    sp = sp or {}
    cache = cache or {}
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if mixer == "mamba":
        if mode in ("chunk", "verify"):
            raise NotImplementedError(
                "chunked prefill / speculative verify do not support SSM "
                "layers; use the engine's whole-prompt prefill strategy")
        h, nc = mamba_apply(p["mamba"], h, cfg, sp.get("mamba"),
                            cache.get("ssm"), mode, policy=policy,
                            token_weights=token_weights)
        key = "ssm"
    else:
        h, nc = attn_apply(p["attn"], h, cfg, mixer, sp.get("attn"),
                           cache.get("self"), positions, mode, slot=slot,
                           policy=policy, token_weights=token_weights,
                           aligned=aligned)
        key = "self"
    x = x + constrain(h, "batch", None, "embed_act")
    new_cache = {key: nc} if nc is not None else {}
    if "cross" in p:
        h = rmsnorm(x, p["ln_cross"], cfg.norm_eps)
        h, _ = attn_apply(p["cross"], h, cfg, "attn_bidir", sp.get("cross"),
                          cache.get("cross"), positions, mode,
                          policy=policy, token_weights=token_weights,
                          kv_override=enc_out if enc_out is not None else x,
                          role_base="cross")
        if mode == "prefill" and enc_out is not None:
            # the static cross K/V for decode, in the decode layouts
            B, F = enc_out.shape[:2]
            KV, hd = cfg.num_kv_heads, cfg.head_dim
            ck = dense(enc_out, p["cross"]["wk"], policy=policy)
            cv = dense(enc_out, p["cross"]["wv"], policy=policy)
            ck = sharding.unflatten(ck, -1, (KV, hd))
            cv = sharding.unflatten(cv, -1, (KV, hd))
            new_cache["cross"] = {
                "k": ck.permute(0, 2, 3, 1).contiguous(),
                "v": cv.permute(0, 2, 1, 3).contiguous()}
        x = x + constrain(h, "batch", None, "embed_act")
    if ffn == "moe":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        # expert rows are dispatched tokens: no token weights
        x = x + moe_apply(p["moe"], h, cfg, sp.get("moe"), policy=policy)
    elif ffn == "dense":
        h = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + constrain(mlp_apply(p["mlp"], h, cfg, sp.get("mlp"),
                                    policy=policy,
                                    token_weights=token_weights),
                          "batch", None, "embed_act")
    x = constrain(x, "batch", None, "embed_act")
    return x, (new_cache or None)


def _unbind(tree, reps: int) -> list:
    """Per-rep trees of a stacked tree, each leaf split by one
    ``unbind``: its backward stacks the reps' grads once, where indexing
    each rep would add a zero-filled grad of the whole stack per rep."""
    if isinstance(tree, dict):
        per = {k: _unbind(v, reps) for k, v in tree.items()}
        return [{k: v[r] for k, v in per.items()} for r in range(reps)]
    return list(torch.unbind(tree, 0))


def _save_matmuls(_ctx, op, *_args, **_kwargs):
    """The ``dots`` remat policy: keep the outputs of products without
    batch dims (the projections' ``mm``), recompute the rest, as the
    reference's ``checkpoint_dots_with_no_batch_dims``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_wrap(fn, remat: str):
    """``none`` keeps every activation for the backward; ``dots`` keeps
    only the projections' outputs; anything else (``full``) keeps none
    and recomputes the layer body in the backward."""
    if remat == "none":
        return fn
    kw = {}
    if remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_matmuls)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def run_groups(groups, x, cfg: ModelConfig, *, mode="train", caches=None,
               positions=None, sp=None, slot=None, policy=None,
               token_weights=None, remat: str = "none", enc_out=None,
               patterns=None, aligned: bool = False):
    """Run every stacked layer group in depth order.  Returns (x, caches):
    the pool caches updated in place for decode/chunk/verify, fresh
    stacked caches for prefill, None for train.  ``remat`` (train mode
    only) wraps each rep's layers, as the reference wraps its scan
    body.  ``patterns`` (default ``cfg.layer_groups()``) gives the
    groups' (pattern, reps): the encoder passes its own."""
    fresh = []
    depth = 0
    for gi, (pattern, reps) in enumerate(patterns or cfg.layer_groups()):
        gp = groups[gi]
        gc = caches[gi] if caches is not None else None
        gsp = sp[gi] if sp is not None else None
        made = [[] for _ in pattern]
        rep_params = _unbind(gp, reps) if mode == "train" else None
        for r in range(reps):
            # every loop variable bound now: remat runs body again in the
            # backward, after the loop has moved on to later groups
            def body(x, r=r, depth=depth, pattern=pattern, gp=gp, gc=gc,
                     gsp=gsp, rep_params=rep_params):
                ncs = []
                for j, kind in enumerate(pattern):
                    lpol = policy.resolve_depth(depth + j) \
                        if policy is not None else None
                    x, nc = layer_apply(
                        rep_params[r][f"l{j}"] if rep_params is not None
                        else _index(gp[f"l{j}"], r), x, cfg, kind,
                        _index(gsp[f"l{j}"], r) if gsp is not None else None,
                        _index(gc[j], r) if gc is not None else None,
                        positions, mode, slot=slot, policy=lpol,
                        token_weights=token_weights, enc_out=enc_out,
                        aligned=aligned)
                    ncs.append(nc)
                return x, ncs
            x, ncs = _remat_wrap(body, remat if mode == "train"
                                 else "none")(x)
            if mode == "prefill":
                for j, nc in enumerate(ncs):
                    made[j].append(nc)
            depth += len(pattern)
        if mode == "prefill":
            fresh.append(tuple(_stack_reps(per) for per in made))
    if mode == "prefill":
        return x, fresh
    return x, (caches if mode in ("decode", "chunk", "verify") else None)


def _stack_reps(trees):
    """Per-rep cache trees of one pattern position -> one tree of
    (reps, ...) tensors."""
    if isinstance(trees[0], dict):
        return {k: _stack_reps([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def embed_tokens(params, tokens, cfg: ModelConfig):
    """Token rows of the embedding (scaled by sqrt(d) where the config
    says).  Under a mesh each rank looks its tokens up in its own vocab
    rows (the table's d_model dim made whole) and the rows held
    elsewhere come from the other ranks' partial sums."""
    emb = params["embed"]
    if sharding.is_sharded(emb):
        vocab = sharding.mesh_axes_for(("vocab", None), emb.shape)[0]
        v0 = 0 if vocab is None else sharding.chunk_start(
            emb.device_mesh, vocab, emb.shape[0])

        def lookup(table, tok):
            ids = tok - v0
            here = (ids >= 0) & (ids < table.shape[0])
            rows = table[torch.clamp(ids, 0, table.shape[0] - 1)]
            return rows * here[..., None].to(rows.dtype)
        e = constrain(sharding.local_call(
            lookup, (emb, tokens), (("vocab", None), ("batch", None)),
            ("batch", None, None), out_partial=("vocab",)),
            "batch", None, "embed_act")
    else:
        e = emb[tokens]
    if cfg.scale_embed:
        e = e * torch.tensor(cfg.d_model ** 0.5, dtype=e.dtype)
    return e


def _on_card(t) -> bool:
    """Whether ``t`` takes the card's path: on the card, and on meta
    tensors, which stand for the card in the dry run's counts."""
    return t.is_cuda or t.is_meta


def _mm_f32(a, b):
    """``a @ b`` of low-precision operands, accumulated and returned in
    f32 (``torch.mm(out_dtype=)`` on the card; the CPU has no such op)."""
    if _on_card(a):
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


# vocab columns per step of the head's backward: bounds its f32 temporaries
HEAD_CHUNK = 32768


def _split3(g):
    """An f32 tensor as three bf16 terms whose f32 sum is ``g`` exactly
    (8 significand bits each; bf16 has f32's exponent range)."""
    hi = g.bfloat16()
    r = g - hi.float()
    mid = r.bfloat16()
    return hi, mid, (r - mid.float()).bfloat16()


class _HeadProduct(torch.autograd.Function):
    """``torch.mm(x, w, out_dtype=float32)`` of bf16 operands with a
    backward, which the op lacks.  The backward multiplies the f32 logit
    grads, as the reference's transposed f32-output ``einsum`` does: per
    chunk of vocab columns the grads split exactly into three bf16 terms
    (``_split3``), each multiplied on the tensor cores with f32
    accumulation, so only the f32 sums' order differs from an f32
    product, and no f32 copy of the (D, V) head is made."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return _mm_f32(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device) \
            if ctx.needs_input_grad[0] else None
        gw = torch.empty_like(w) if ctx.needs_input_grad[1] else None
        xt = x.T
        for c in range(0, w.shape[1], HEAD_CHUNK):
            wc = w[:, c:c + HEAD_CHUNK]
            terms = _split3(g[:, c:c + HEAD_CHUNK])
            if gx is not None:
                for t in terms:
                    gx += _mm_f32(t, wc.T)
            if gw is not None:
                acc = _mm_f32(xt, terms[0])
                acc += _mm_f32(xt, terms[1])
                acc += _mm_f32(xt, terms[2])
                gw[:, c:c + HEAD_CHUNK] = acc
        return (None if gx is None else gx.to(x.dtype)), gw


def lm_logits(params, x, cfg: ModelConfig):
    """(B,S,D) -> f32 logits (B,S,V), accumulated in f32.  Under a mesh
    each rank multiplies its rows by its vocab columns (the head's own
    layout): the logits come out ``("batch", None, "vocab")``."""
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = sharding.local_call(
        _head, (x, w), (("batch", None, None), (None, "vocab")),
        ("batch", None, "vocab"))
    logits = softcap(logits, cfg.logit_softcap)
    return constrain(logits, "batch", None, "vocab")


def _head(x, w):
    B, S, D = x.shape
    x2 = x.reshape(B * S, D)
    if _on_card(x2) and x2.dtype != torch.float32:
        # f32 output from the low-precision operands, without an f32 copy
        # of the (V, D) head
        if torch.is_grad_enabled() and (x2.requires_grad or w.requires_grad):
            logits = _HeadProduct.apply(x2, w)
        else:
            logits = _mm_f32(x2, w)
    else:
        logits = x2.float() @ w.float()
    return logits.reshape(B, S, -1)


def encode(params, frames, cfg: ModelConfig, sp=None, remat: str = "none",
           policy=None):
    """Whisper's encoder over precomputed conv-frontend frame embeddings
    (B,F,D): sinusoidal positions, the ``attn_bidir`` stack (train mode:
    no caches), the final norm.  Per-block backend ranges index decoder
    depth, so the encoder runs the policy's default backend; without
    ``sp`` (no caller passes one) every projection is dense."""
    if policy is not None:
        policy = policy.resolve_depth(None)
    enc = params["encoder"]
    x = frames + constrain(sinusoidal_positions(
        frames.shape[1], cfg.d_model, frames.device).to(frames.dtype)[None],
        None, None, "embed_act")
    x, _ = run_groups(enc["groups"], x, cfg, mode="train", sp=sp,
                      remat=remat, policy=policy,
                      patterns=[(ENC_PATTERN, cfg.encoder_layers)])
    return rmsnorm(x, enc["final_norm"], cfg.norm_eps)


def forward(params, cfg: ModelConfig, *, tokens, frames=None,
            patch_embeds=None, mode="train", caches=None, positions=None,
            sp=None, sp_enc=None, slot=None, policy=None, token_weights=None,
            remat: str = "none", aligned: bool = False):
    """Unified forward.

    train/prefill: tokens (B,S[-P]) [+ frames (B,F,D) | patch_embeds
                   (B,P,D)].
    decode:        tokens (B,), positions (B,) tensor, caches = the pool.
    chunk:         tokens (1,C) one request's prefill chunk, positions =
                   chunk-start offset (a (1,) tensor), slot = its pool
                   slot (a 0-d tensor), caches = the full slot pool.
    verify:        tokens (S,C) one window per pool row, positions (S,)
                   per-row start offsets, caches = the full slot pool.

    Enc-dec: ``frames`` run the encoder (:func:`encode`, under ``sp_enc``)
    and the decoder's cross-attention attends its output; sinusoidal
    positions are added to the token embeddings (at ``positions`` in
    decode).  VLM: ``patch_embeds`` are cast to x's dtype and precede
    the tokens.  Chunk and verify refuse both families.

    Returns (logits, caches): train -> (B,S,V), None; prefill -> (B,V)
    at the last position, fresh caches; decode -> (B,V), pool updated in
    place; chunk/verify -> (B,C,V), pool updated in place.  ``remat``
    (train mode): ``none``, ``dots`` or ``full`` (:func:`_remat_wrap`).
    ``aligned`` (decode): every row decodes ``positions[0]``, so each
    cache write is one slice write.

    Under a ``distributed.sharding_context`` with params placed on its
    mesh (``sharding.distribute``), the same code runs on DTensors, with
    the reference's ``constrain`` sites as redistributions.
    """
    if mode not in MODES:
        raise NotImplementedError(
            f"forward mode {mode!r}: the port runs {MODES}")
    if mode in ("chunk", "verify") and cfg.family in MULTIMODAL:
        raise NotImplementedError(
            f"{mode} mode serves token-only models, not {cfg.family}")
    if policy is None:
        policy = sparse_linear.DENSE
    if sharding.is_sharded(params["embed"]):
        # the step's inputs, laid out as the reference's in_shardings
        tokens = constrain(tokens, "batch", "seq")
        if positions is not None:
            positions = constrain(positions, "batch")
    enc_out = None
    if cfg.family == "encdec" and frames is not None:
        enc_out = encode(params, frames, cfg, sp=sp_enc, remat=remat,
                         policy=policy)
    if mode == "decode":
        x = embed_tokens(params, tokens[:, None], cfg)
        if cfg.family == "encdec" and cfg.rope_theta == 0.0:
            x = x + sharding.local_call(
                lambda pos: sinusoidal_at(pos, cfg.d_model)[:, None].to(
                    x.dtype), (positions,), (("batch",),),
                ("batch", None, None))
    else:
        x = embed_tokens(params, tokens, cfg)
        if patch_embeds is not None:                   # VLM stub frontend
            x = torch.cat([patch_embeds.to(x.dtype), x], 1)
        if cfg.family == "encdec":
            x = x + constrain(sinusoidal_positions(
                x.shape[1], cfg.d_model, x.device).to(x.dtype)[None],
                None, None, "embed_act")
        if mode in ("train", "prefill"):
            x = constrain(x, "batch", None, "embed_act")
    x, new_caches = run_groups(
        params["groups"], x, cfg, mode=mode, caches=caches,
        positions=positions, sp=sp, slot=slot, policy=policy,
        token_weights=token_weights, remat=remat, enc_out=enc_out,
        aligned=aligned)
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if mode == "decode":
        return lm_logits(params, x, cfg)[:, 0], new_caches
    if mode == "prefill":
        return lm_logits(params, x[:, -1:], cfg)[:, 0], new_caches
    return lm_logits(params, x, cfg), new_caches
