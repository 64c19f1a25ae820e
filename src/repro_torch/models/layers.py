"""Shared primitive layers (port of the JAX package's ``models/layers.py``):
the sparsity-aware dense projection, RMSNorm, half-split rotary
embeddings and SiLU."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import sparse_linear


def dense(x, w, sp=None, *, policy=None, role=None, token_weights=None):
    """y = x @ W, optionally channel-sparsified per WiSparse (see
    :func:`repro_torch.core.sparse_linear.project`)."""
    return sparse_linear.project(x, w, sp, policy=policy, role=role,
                                 token_weights=token_weights)


def rmsnorm(x, scale, eps: float = 1e-6):
    """f32 RMSNorm with a ``(1 + scale)`` gain, cast back to x's dtype."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(dt)


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
