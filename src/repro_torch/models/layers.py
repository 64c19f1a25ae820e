"""Shared primitive layers (port of the JAX package's ``models/layers.py``):
the sparsity-aware dense projection, RMSNorm, half-split rotary
embeddings, whisper's sinusoidal absolute positions, the logit softcap,
SiLU and tanh-approximated GELU."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear
from repro_torch.distributed import sharding


def dense(x, w, sp=None, row_parallel: bool = False, *, policy=None,
          role=None, token_weights=None):
    """y = x @ W, optionally channel-sparsified per WiSparse (see
    :func:`repro_torch.core.sparse_linear.project`; ``row_parallel``
    marks a weight whose input dim is model-sharded)."""
    return sparse_linear.project(x, w, sp, row_parallel, policy=policy,
                                 role=role, token_weights=token_weights)


def rmsnorm(x, scale, eps: float = 1e-6):
    """f32 RMSNorm with a ``(1 + scale)`` gain, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


def softcap(x, cap: float):
    """``cap * tanh(x / cap)``; a zero cap leaves x as it is (gemma2's
    attention and final-logit caps)."""
    if not cap:
        return x
    return cap * torch.tanh(x / cap)


def gelu(x):
    """GELU with the tanh approximation, as ``jax.nn.gelu(approximate=True)``."""
    return F.gelu(x, approximate="tanh")


def silu(x):
    return F.silu(x)


def rope_angles(positions, head_dim: int, theta: float):
    """positions: (...,) int -> cos, sin of shape (..., head_dim//2), f32."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=positions.device) / half))
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., P, n_heads, head_dim); cos/sin: (..., P, head_dim//2).
    Half-split rotation (first half / second half), computed in f32."""
    dt = x.dtype
    xf = x.float()
    half = xf.shape[-1] // 2
    x1, x2 = xf[..., :half], xf[..., half:]
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], -1).to(dt)


def rope_qk(q, k, pos, theta: float):
    """RoPE on q (B,S,H,hd) and k (B,S,KV,hd) at positions ``pos``
    ((B|1, S) ints), on local shards under a mesh (the angles are built
    from ``arange``): rows and heads are independent."""
    pos_axes = ("batch", None) if pos.shape[0] == q.shape[0] and \
        pos.shape[0] > 1 else (None, None)
    ang = pos_axes + (None,)
    cos, sin = sharding.local_call(
        lambda p: rope_angles(p, q.shape[-1], theta), (pos,), (pos_axes,),
        (ang, ang))
    return tuple(sharding.local_call(apply_rope, (t, cos, sin),
                                     (axes, ang, ang), axes)
                 for t, axes in ((q, ("batch", None, "heads", None)),
                                 (k, ("batch", None, "kv_heads", None))))


def sinusoidal_at(positions, dim: int):
    """Sinusoidal absolute position embedding at ``positions`` (...,) ->
    (..., dim) f32: ``[sin, cos]`` of ``positions * 10000^(-i / (half -
    1))``; the caller casts it to x's dtype."""
    half = dim // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device)
        / max(half - 1, 1))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def sinusoidal_positions(length: int, dim: int, device=None):
    """Whisper-style sinusoidal absolute position embedding (length, dim)."""
    return sinusoidal_at(torch.arange(length, device=device), dim)
