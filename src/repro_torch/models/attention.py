"""Attention (port of the JAX package's ``models/attention.py``): causal
prefill/train attention, single-query decode attention against the
pre-transposed cache plus an explicit new-token term, multi-token
attention against the cache at a shared or per-row device offset
(chunked prefill, speculative verify), and the in-place cache writes of
one token (decode) and of a window of tokens (chunk, verify).  Sliding
windows and cross-attention come with the archs that use them.

The reference wrote these in jnp, not Pallas, so plain torch ops are the
port.  Scores and softmax run in f32 as in the reference
(``preferred_element_type=f32``): operands are upcast before each
product, and probabilities are cast to the cache dtype before the PV
product, where the reference casts them.  Caches keep the reference
layouts: K ``(B, KV, hd, T)`` and V ``(B, KV, T, hd)``.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def _softcap(s, cap: float):
    return cap * torch.tanh(s / cap) if cap else s


def flash_attention(q, k, v, *, attn_softcap: float = 0.0):
    """Causal attention.  q: (B,S,H,hd); k, v: (B,S,KV,hd) -> (B,S,H,hd).

    One pass over the whole key range (the reference's online softmax
    over 1024-key chunks is the same computation for S <= 1024, and equal
    up to f32 rounding beyond)."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    G = H // KV
    scale = hd ** -0.5
    qr = q.reshape(B, S, KV, G, hd).permute(0, 2, 3, 1, 4).float()
    kr = k.permute(0, 2, 3, 1).float()[:, :, None]         # (B,KV,1,hd,T)
    s = _softcap(torch.matmul(qr, kr) * scale, attn_softcap)  # (B,KV,G,S,T)
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1)
    vr = v.permute(0, 2, 1, 3)[:, :, None]                 # (B,KV,1,T,hd)
    out = torch.matmul(p.to(v.dtype).float(), vr.float())
    out = out / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def decode_attention(q, k_cache, v_cache, positions, k_new, v_new, *,
                     attn_softcap: float = 0.0):
    """Single new query vs a pre-transposed cache plus an explicit
    new-token term.

    q: (B,H,hd); k_cache: (B,KV,hd,T); v_cache: (B,KV,T,hd); positions
    (B,): cache slots at ``positions`` and beyond are masked.  k_new/v_new
    (B,KV,hd) carry the current token, attended explicitly (an online
    softmax over [cache, new token]) and written to the cache separately
    by :func:`cache_write_kv`."""
    B, H, hd = q.shape
    KV, T = k_cache.shape[1], k_cache.shape[3]
    G = H // KV
    scale = hd ** -0.5
    qr = q.reshape(B, KV, G, hd).float()
    s = _softcap(torch.matmul(qr, k_cache.float()) * scale, attn_softcap)
    valid = torch.arange(T, device=q.device)[None, :] < positions[:, None]
    s = torch.where(valid[:, None, None, :], s, torch.full_like(s, NEG_INF))
    s_new = (qr * k_new.float()[:, :, None, :]).sum(-1) * scale
    s_new = _softcap(s_new, attn_softcap)
    m = torch.maximum(s.amax(-1), s_new)
    e = torch.exp(s - m[..., None])
    e_new = torch.exp(s_new - m)
    l = e.sum(-1) + e_new
    out = torch.matmul(e.to(v_cache.dtype).float(), v_cache.float())
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


def cache_write_kv(k_cache, v_cache, k_new, v_new, positions):
    """Write one token per row into a layer's caches, in place.

    k_cache: (B,KV,hd,T); v_cache: (B,KV,T,hd); k/v_new: (B,KV,hd);
    positions (B,).  The reference returns updated copies through a
    donated ``dynamic_update_slice``; here the pool tensors are updated
    in place (``index_put_``) and returned for the same call shape."""
    B = k_cache.shape[0]
    rows = torch.arange(B, device=k_cache.device)
    pos = positions.long()
    k_cache[rows, :, :, pos] = k_new.to(k_cache.dtype)
    v_cache[rows, :, pos, :] = v_new.to(v_cache.dtype)
    return k_cache, v_cache
