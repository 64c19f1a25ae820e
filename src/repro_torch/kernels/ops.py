"""End-to-end WiSparse projection on the block kernels — the
``backend="pallas"`` path of ``repro_torch.core.sparse_linear`` (port of
the JAX package's ``kernels/ops.py``):

  1. fused scoring + per-channel threshold mask (Eq. 4/5) + per-block
     aggregate scores, static-budget top-k block selection (k from the
     policy's ``k_max_frac``, in ``jax.lax.top_k``'s order) and the rank
     mask (ranks past the layer's ``keep_frac`` get their x zeroed, so
     the per-layer allocation still binds): one ``score_select`` launch,
  2. block-gather matmul over exactly the kept blocks
     (``sparse_matmul_shared`` kernel; with ``per_seq=True`` the
     ``sparse_matmul_per_seq`` kernel, every row given the shared ids,
     as the reference does),
  3. the cast of the f32 result to x's dtype.

On the card a projection of contiguous inputs whose channel dim is a
multiple of the block is these three launches and nothing else.
``alpha``, ``tau`` and ``keep_frac`` stay device tensors throughout: a
host read (``.item()``) per projection would add one sync per
projection, 224 per decode step at llama31_8b's depth.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import sparse_matmul as K


def channel_plan(n: int, block: int = 128):
    """Channel-block geometry of :func:`wisparse_project`: resolved block
    width, zero-padded channel count and block count (full-width blocks
    via padding, never narrower fallback blocks)."""
    blk = min(block, n)
    n_padded = n + (-n % blk)
    return blk, n_padded, n_padded // blk


def wisparse_project(x, w, sp, *, block: int = 128, k_frac: float = 1.0,
                     per_seq: bool = False, token_weights=None):
    """x: (..., n); w: (n, *out).  Returns x W with WiSparse block
    sparsity, in x's dtype.

    per_seq: run the per-row kernel, ``sparse_matmul_per_seq``, with the
    shared top-k ids copied to every row (the reference's only use of
    that kernel; no serving path sets it).

    token_weights: per-row weights for the shared block-score aggregate
    (the serving engine's active-slot / real-token mask, fused into the
    kernel); None disables weighting."""
    n = w.shape[0]
    w2 = w.reshape(n, -1)
    lead = x.shape[:-1]
    xf = x.reshape(-1, n)
    blk, n_padded, nb = channel_plan(n, block)
    g = sp["g"]
    pad = n_padded - n
    if pad:
        # padded channels score |0|*g^a = 0 and multiply zero weight rows,
        # so the tail block just aggregates fewer real channels
        xf = F.pad(xf, (0, pad))
        w2 = F.pad(w2, (0, 0, 0, pad))
        g = F.pad(g, (0, pad))
    kb = max(1, min(nb, round(nb * k_frac)))

    tw = token_weights
    if tw is not None and tw.numel() != xf.shape[0]:
        raise ValueError(
            f"token_weights has {tw.numel()} rows but the projection sees "
            f"{xf.shape[0]} token rows; pass token_weights=None for "
            "dispatch-reshaped projections")
    xm, idx, _ = K.score_select(xf.contiguous(), g, sp["alpha"], sp["tau"],
                                sp["keep_frac"], kb=kb, blk=blk,
                                row_weights=tw)
    # entries ranked past keep_frac keep their own (zeroed) block ids, so
    # their kernel contribution is exactly zero
    if per_seq:
        y = K.sparse_matmul_per_seq(xm, w2.contiguous(),
                                    idx.expand(xf.shape[0], kb).contiguous(),
                                    blk=blk)
    else:
        y = K.sparse_matmul_shared(xm, w2.contiguous(), idx, blk=blk)
    return y.to(x.dtype).reshape(lead + w.shape[1:])
