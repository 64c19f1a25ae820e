"""Plain PyTorch versions of the WiSparse kernels (mirror of the JAX
package's ``kernels/ref.py``).

The kernel wrappers in :mod:`repro_torch.kernels.sparse_matmul` run these
for tensors on the CPU; ``chip_smoke.py`` holds the CUDA kernels against
them on the card.  Each is written independently of its kernel (batched
gathers and reductions, not the kernel's loop structure).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.select import topk_ids


def ref_sparse_matmul_shared(x, w, block_idx, blk: int):
    """y = sum over kept blocks of x[:, blk_i] @ w[blk_i, :] in f32.
    Duplicate block ids contribute once per occurrence (the pad contract:
    pad entries must point at zeroed x blocks).  Block ids are clamped to
    the valid range, as the reference's ``dynamic_slice`` clamps."""
    B, n = x.shape
    m = w.shape[1]
    nb = n // blk
    idx = block_idx.long().clamp(0, nb - 1)
    xs = x.reshape(B, nb, blk)[:, idx].float()           # (B, kb, blk)
    ws = w.reshape(nb, blk, m)[idx].float()              # (kb, blk, m)
    return torch.einsum("bkc,kcm->bm", xs, ws)


def ref_sparse_matmul_per_seq(x, w, block_idx, blk: int):
    """Per-row kept-block sets: row b of y is
    ``ref_sparse_matmul_shared(x[b:b+1], w, block_idx[b], blk)``."""
    return torch.cat([ref_sparse_matmul_shared(x[b:b + 1], w, block_idx[b],
                                               blk)
                      for b in range(x.shape[0])], 0)


def ref_score_mask(x, g, alpha, tau, blk: int, row_weights=None):
    """(xm, bs): Eq. 4 scores ``s = |x| * max(g, 1e-12)^alpha`` in f32,
    the Eq. 5 mask ``s >= tau`` applied to x (dtype kept), and per
    channel-block score sums of the kept scores, each row weighted by
    ``row_weights`` (ones when None)."""
    B, n = x.shape
    gf = torch.clamp(g.float(), min=1e-12)
    s = x.float().abs() * torch.pow(gf, torch.as_tensor(alpha, dtype=torch.float32,
                                                        device=x.device))
    keep = s >= torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    xm = torch.where(keep, x, torch.zeros_like(x))
    ks = torch.where(keep, s, torch.zeros_like(s))
    if row_weights is not None:
        ks = ks * row_weights.reshape(B, 1).float()
    bs = ks.sum(0).reshape(n // blk, blk).sum(-1)
    return xm, bs


def ref_score_select(x, g, alpha, tau, keep_frac, blk: int, kb: int,
                     row_weights=None):
    """(xm, idx, bs): :func:`ref_score_mask`, then the top ``kb`` blocks
    by ``bs`` in :func:`topk_ids` order (int32), then the rank mask: x is
    zeroed outside the blocks ranked below
    ``min(kb, round(keep_frac * nb))`` (the layer's own budget under the
    static ``kb``; ``torch.round`` rounds half to even, as ``jnp.round``
    does)."""
    xm, bs = ref_score_mask(x, g, alpha, tau, blk, row_weights)
    nb = x.shape[1] // blk
    idx = topk_ids(bs, kb)
    kf = torch.as_tensor(keep_frac, dtype=torch.float32, device=x.device)
    kb_l = torch.round(kf * nb)
    keep_blocks = torch.zeros(nb, dtype=torch.bool, device=x.device)
    keep_blocks[idx] = torch.arange(kb, device=x.device) < kb_l
    keep = keep_blocks.repeat_interleave(blk)[None]
    xm = torch.where(keep, xm, torch.zeros_like(xm))
    return xm, idx.to(torch.int32), bs


def ref_wisparse_project(x, w, sp, k_blocks: int, blk: int):
    """Full-op version: score -> mask -> top-k blocks (rank-limited by the
    layer's keep_frac) -> gathered matmul."""
    xm, idx, _ = ref_score_select(x, sp["g"], sp["alpha"], sp["tau"],
                                  sp["keep_frac"], blk, k_blocks)
    return ref_sparse_matmul_shared(xm, w, idx, blk)
