"""Attention (port of the JAX package's ``models/attention.py``): causal
prefill/train attention, optionally limited to a sliding window (gemma's
``local`` layers), single-query decode attention against the
pre-transposed cache plus an explicit new-token term, over a full-length
or a rolling-window cache, multi-token attention against the cache at a
shared or per-row device offset (chunked prefill, speculative verify),
and the in-place cache writes of one token (decode, rolling or not) and
of a window of tokens (chunk, verify).  Bidirectional attention (whisper's encoder)
and cross-attention (its decoder against the encoder output) are
``flash_attention(causal=False)`` over T keys, and cross-attention's
decode attends a static cache of encoder frames with no new-token term.

The reference wrote these in jnp, not Pallas, so plain torch ops are the
port.  Scores and softmax run in f32 as in the reference
(``preferred_element_type=f32``): operands are upcast before each
product, and probabilities are cast to the cache dtype before the PV
product, where the reference casts them.  Caches keep the reference
layouts: K ``(B, KV, hd, T)`` and V ``(B, KV, T, hd)``; a rolling cache
(``T`` equal to the window) holds position ``p`` in slot ``p % T``.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.distributed import sharding
from repro_torch.models.layers import softcap as _softcap

NEG_INF = -1e30

# logical axes of the attention operands on a mesh: the query heads take
# the kv heads' name, so a shard holds whole GQA groups
_Q = ("batch", None, "kv_heads", None)          # q (B,S,H,hd), k/v (B,T,KV,hd)
_QH = ("batch", None, "heads", None)            # q split by its own heads
_KVR = ("batch", None, None, None)              # k/v whole over the heads
_Q1 = ("batch", "kv_heads", None)               # q (B,H,hd), k/v_new (B,KV,hd)
_KC = ("batch", "kv_heads", None, "kv_seq")     # K cache (B,KV,hd,T)
_VC = ("batch", "kv_heads", "kv_seq", None)     # V cache (B,KV,T,hd)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    attn_softcap: float = 0.0):
    """:func:`_flash_attention` on local shards under a mesh: rows and
    kv-head groups are independent.  Where the kv heads cannot shard
    over the mesh but the query heads can (8 kv heads, model = 16), each
    rank takes its query heads and the kv head each of them reads, as
    GSPMD splits the reference's ``heads``-constrained queries."""
    kw = dict(causal=causal, window=window, attn_softcap=attn_softcap)
    if sharding.is_sharded(q, k, v):
        hq = sharding.mesh_axes_for(_QH, q.shape)[2]
        hk = sharding.mesh_axes_for(_Q, k.shape)[2]
        if hq is not None and hk is None:
            h0 = sharding.chunk_start(q.device_mesh, hq, q.shape[2])
            G = q.shape[2] // k.shape[2]

            def run(q, k, v):
                kv = (h0 + torch.arange(q.shape[2], device=q.device)) // G
                return _flash_attention(q, k.index_select(2, kv),
                                        v.index_select(2, kv), **kw)
            return sharding.local_call(
                run, (q, k, v), (_QH, _KVR, _KVR), _QH)
    return sharding.local_call(
        lambda k, v, q: _flash_attention(q, k, v, **kw),
        (k, v, q), (_Q, _Q, _Q), _Q)


def _flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                     attn_softcap: float = 0.0):
    """q: (B,S,H,hd); k, v: (B,T,KV,hd) -> (B,S,H,hd).  ``causal`` keeps,
    for the query at position s, the keys at t <= s (T = S); without it
    every query attends all T keys (the encoder's bidirectional layers,
    cross-attention over T encoder frames).

    ``window`` > 0 keeps, for the query at position q, the keys at
    positions t with ``q - window < t <= q`` (the reference's
    ``_local_attention``, which it takes when ``window < T``).

    One masked pass over the whole key range.  Without a window the
    reference's online softmax over kv chunks (the largest divisor of T
    up to 1024: 750 for whisper's 1500 frames) is the same computation
    for T <= 1024 and equal up to f32 rounding beyond; it casts the
    unnormalised probabilities to v's dtype and divides after the PV
    product.  Its window path normalises first (a softmax per query
    chunk), then casts, and so does this one.  The f32 scores of one
    call take ``B*H*S*T*4`` bytes (650 MB at B = 1, H = 8, S = T = 4500;
    720 MB in a whisper encoder layer at B = 4, H = 20, S = T = 1500)."""
    B, S, H, hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    local = bool(window) and window < T
    qr = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4).float()
    kr = k.permute(0, 2, 3, 1).float()[:, :, None]         # (B,KV,1,hd,T)
    s = _softcap(torch.matmul(qr, kr) * scale, attn_softcap)  # (B,KV,G,S,T)
    if causal or local:
        qpos = torch.arange(S, device=q.device)[:, None]
        kpos = torch.arange(T, device=q.device)[None, :]
        mask = kpos <= qpos
        if local:
            mask &= kpos > qpos - window
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    if local:
        p = torch.softmax(s, -1)
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    vr = v.permute(0, 2, 1, 3)[:, :, None]                 # (B,KV,1,T,hd)
    out = torch.matmul(p.to(v.dtype).float(), vr.float())
    if not local:
        out = out / torch.clamp(p.sum(-1), min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _time_shards(k_cache):
    """(offset of this rank's cache slots, all-reduce over the mesh dims
    the cache's time axis is sharded over, or None) of a K cache."""
    axes = sharding.dim_axes(k_cache, 3)
    if not axes:
        return 0, None
    from torch.distributed import _functional_collectives as funcol
    mesh = k_cache.device_mesh
    dims = [sharding.axis_names(mesh).index(a) for a in axes]

    def reduce(t, op):
        for d in dims:
            t = funcol.wait_tensor(funcol.all_reduce(t, op, (mesh, d)))
        return t
    return sharding.chunk_start(mesh, axes, k_cache.shape[3]), reduce


def decode_attention(q, k_cache, v_cache, positions, k_new=None,
                     v_new=None, *, rolling: bool = False,
                     attn_softcap: float = 0.0):
    """:func:`_decode_attention` on local shards under a mesh.  A cache
    whose time axis is sharded (``kv_seq``) is attended flash-decoding
    style: each rank scores its own slots, and the softmax's max, sum
    and PV product are all-reduced over the time shards."""
    if not sharding.is_sharded(q, k_cache, v_cache, positions, k_new):
        return _decode_attention(q, k_cache, v_cache, positions, k_new,
                                 v_new, rolling=rolling,
                                 attn_softcap=attn_softcap)
    t0, reduce = _time_shards(k_cache)
    run = functools.partial(_decode_attention, rolling=rolling,
                            attn_softcap=attn_softcap, t0=t0,
                            T=k_cache.shape[-1], reduce=reduce)
    news = (k_new, v_new) if k_new is not None else ()
    return sharding.local_call(
        lambda kc, vc, q, pos, *kv: run(q, kc, vc, pos, *kv),
        (k_cache, v_cache, q, positions) + news,
        (_KC, _VC, _Q1, ("batch",)) + (_Q1,) * len(news), _Q1)


def _decode_attention(q, k_cache, v_cache, positions, k_new=None,
                      v_new=None, *, rolling: bool = False,
                      attn_softcap: float = 0.0, t0: int = 0, T=None,
                      reduce=None):
    """Single new query vs a pre-transposed cache plus an explicit
    new-token term.

    q: (B,H,hd); k_cache: (B,KV,hd,T); v_cache: (B,KV,T,hd); positions
    (B,): cache slots at ``positions`` and beyond are masked.  k_new/v_new
    (B,KV,hd) carry the current token, attended explicitly (an online
    softmax over [cache, new token]) and written to the cache separately
    by :func:`cache_write_kv`.  Without them (cross-attention over a
    static cache of encoder frames, ``positions`` = T) the query attends
    the cache alone: a softmax, then the PV product of the probabilities
    cast to the cache dtype, as the reference.

    ``rolling``: slot ``p % T`` holds position ``p`` (a local layer's
    window cache).  Before the position wraps, the slots below it are
    valid; after, every slot but ``positions % T``, which holds the
    position that just left the window.  The mask is computed on the
    device from the positions tensor, so the step can be captured.

    ``t0``, ``T`` and ``reduce``: the caches hold slots ``[t0, t0 +
    local T)`` of ``T``, and ``reduce(t, op)`` all-reduces over the other
    time shards (None: the whole cache is here)."""
    B, H, hd = q.shape
    KV, Tl = k_cache.shape[1], k_cache.shape[3]
    T = Tl if T is None else T
    G = H // KV
    scale = hd ** -0.5
    qr = q.reshape(B, KV, G, hd).float()
    s = _softcap(torch.matmul(qr, k_cache.float()) * scale, attn_softcap)
    slot = torch.arange(t0, t0 + Tl, device=q.device)[None, :]
    pos = positions[:, None]
    valid = slot < pos
    if rolling:
        valid = torch.where(pos < T, valid, slot != pos % T)
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    if reduce is None:
        def reduce(t, _op):
            return t
    if k_new is None:
        if t0 == 0 and Tl == T:
            p = torch.softmax(s, -1)
        else:
            e = torch.exp(s - reduce(s.amax(-1), "max")[..., None])
            p = e / reduce(e.sum(-1), "sum")[..., None]
        out = reduce(torch.matmul(p.to(v_cache.dtype).float(),
                                  v_cache.float()), "sum")
        return out.reshape(B, H, hd).to(q.dtype)
    s_new = (qr * k_new.float()[:, :, None, :]).sum(-1) * scale
    s_new = _softcap(s_new, attn_softcap)
    m = torch.maximum(reduce(s.amax(-1), "max"), s_new)
    e = torch.exp(s - m[..., None])
    e_new = torch.exp(s_new - m)
    l = reduce(e.sum(-1), "sum") + e_new
    out = reduce(torch.matmul(e.to(v_cache.dtype).float(), v_cache.float()),
                 "sum")
    out = out + e_new[..., None] * v_new.float()[:, :, None, :]
    out = out / l[..., None]
    return out.reshape(B, H, hd).to(q.dtype)


def chunk_attention(q, k_cache, v_cache, offset, *, attn_softcap: float = 0.0):
    """Multi-token attention: C new queries per row against a cache that
    already holds their own K/V at [offset, offset+C), so the causal mask
    ``t <= qpos`` covers the past context and the in-chunk triangle in
    one pass.

    q: (B,C,H,hd); k_cache: (B,KV,hd,T); v_cache: (B,KV,T,hd); offset: the
    start position as a device tensor, 0-d or (1,) shared across the batch
    (chunked prefill) or (B,) per row (speculative verify).  It is never
    read on the host, so the step can be captured as a CUDA graph."""
    B, C, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[3]
    G = H // KV
    scale = hd ** -0.5
    qr = q.reshape(B, C, KV, G, hd).permute(0, 2, 3, 1, 4).float()
    s = torch.matmul(qr, k_cache.float()[:, :, None]) * scale   # (B,KV,G,C,T)
    s = _softcap(s, attn_softcap)
    off = torch.as_tensor(offset, device=q.device).reshape(-1)   # (1,)|(B,)
    qpos = off[:, None] + torch.arange(C, device=q.device)       # (1|B,C)
    valid = torch.arange(T, device=q.device) <= qpos[..., None]  # (1|B,C,T)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, -1)
    out = torch.matmul(p.to(v_cache.dtype).float(),
                       v_cache.float()[:, :, None])          # (B,KV,G,C,hd)
    return out.permute(0, 3, 1, 2, 4).reshape(B, C, H, hd).to(q.dtype)


def cache_write_window(k_cache, v_cache, k_new, v_new, rows, offsets):
    """Write C new positions per row into a layer's caches, in place.

    k_cache: (S,KV,hd,T); v_cache: (S,KV,T,hd); k/v_new: (B,C,KV,hd) as
    projected; rows (B,) the pool rows written; offsets (B,) each row's
    first position.  Both index tensors stay on the device (one
    ``index_put_`` per cache, no host read), where the reference uses a
    donated ``dynamic_update_slice`` per row."""
    C = k_new.shape[1]
    t = offsets.long()[:, None] + torch.arange(C, device=offsets.device)
    r = rows.long()[:, None]                                      # (B,1)
    k_cache[r, :, :, t] = k_new.to(k_cache.dtype)      # indexed: (B,C,KV,hd)
    v_cache[r, :, t, :] = v_new.to(v_cache.dtype)
    return k_cache, v_cache


def cache_write_kv(k_cache, v_cache, k_new, v_new, positions, *,
                   rolling: bool = False, aligned: bool = False):
    """Write one token per row into a layer's caches, in place.

    k_cache: (B,KV,hd,T); v_cache: (B,KV,T,hd); k/v_new: (B,KV,hd);
    positions (B,); ``rolling`` writes position p at slot ``p % T``.  The
    reference returns updated copies through a donated
    ``dynamic_update_slice``; here the pool tensors are updated in place
    and returned for the same call shape: one ``index_put_`` per cache,
    or with ``aligned`` (every row decodes the same position,
    ``positions[0]``) one slice write per cache (``index_copy_`` of one
    time slot, read on the device).  Under a mesh each rank writes its
    own shard of the caches; a time-sharded cache takes the slot on the
    rank that holds it."""
    if not sharding.is_sharded(k_cache, v_cache, k_new, positions):
        _write_kv(k_cache, v_cache, k_new, v_new, positions,
                  rolling=rolling, aligned=aligned)
        return k_cache, v_cache
    t0, _ = _time_shards(k_cache)
    sharding.local_call(
        functools.partial(_write_kv, rolling=rolling, aligned=aligned,
                          t0=t0, T=k_cache.shape[-1]),
        (k_cache, v_cache, k_new, v_new, positions),
        (_KC, _VC, _Q1, _Q1, ("batch",)), (), inplace=(0, 1))
    return k_cache, v_cache


def _write_kv(k_cache, v_cache, k_new, v_new, positions, *, rolling: bool,
              aligned: bool, t0: int = 0, T=None):
    """:func:`cache_write_kv` on caches holding slots ``[t0, t0 + local
    T)`` of ``T``: a slot outside them is left as it is."""
    B, Tl = k_cache.shape[0], k_cache.shape[-1]
    T = Tl if T is None else T
    pos = positions.long()
    if rolling:
        pos = pos % T
    kn, vn = k_new.to(k_cache.dtype), v_new.to(v_cache.dtype)
    if aligned:
        pos = pos[:1]
    rows = torch.arange(B, device=k_cache.device)
    if t0 or Tl != T:
        # a slot held by another rank: write back what is there
        here = (pos >= t0) & (pos < t0 + Tl)
        pos = torch.clamp(pos - t0, 0, Tl - 1)
        if aligned:
            kn = torch.where(here, kn, k_cache.index_select(3, pos)[..., 0])
            vn = torch.where(here, vn, v_cache.index_select(2, pos)[:, :, 0])
        else:
            kn = torch.where(here[:, None, None], kn,
                             k_cache[rows, :, :, pos])
            vn = torch.where(here[:, None, None], vn,
                             v_cache[rows, :, pos, :])
    if aligned:
        k_cache.index_copy_(3, pos, kn[..., None])
        v_cache.index_copy_(2, pos, vn[:, :, None])
    else:
        k_cache[rows, :, :, pos] = kn
        v_cache[rows, :, pos, :] = vn
