"""WiSparse sparse-projection dispatch (port of the JAX package's
``core/sparse_linear.py``).

``project(x, w, sp, policy=...)`` is the one function every linear
layer of the model runs through.  ``sp`` carries the per-layer WiSparse
parameters as device tensors:

    g          (n_in,)  weight-column L2 norms               (paper Eq. 4)
    alpha      ()       layer exponent alpha_l               (paper Eq. 4)
    tau        ()       inference threshold tau_l            (paper Eq. 5)
    keep_frac  ()       keep ratio 1 - p_l (gather backends)

The static execution config is an explicit :class:`SparsityPolicy`;
``policy=None`` means dense.  The reference's grouped top-k path for
row-parallel weights on a mesh (``row_parallel``,
``_topk_gather_grouped``) waits for the sharding slice; without a mesh
the reference takes the path below.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.select import topk_ids
from repro_torch.sparsity import VALID_BACKENDS, SparsityPolicy

__all__ = ["SparsityPolicy", "VALID_BACKENDS", "DENSE", "project", "scores",
           "column_norms", "default_sp"]

# the default execution when no policy is passed: plain dense matmuls
DENSE = SparsityPolicy.dense()


def _saliency(xf, sp, tok_w=None):
    """Per-channel shared saliency over all token rows (optionally
    weighted by the serving engine's token weights)."""
    s = scores(xf, sp["g"], sp["alpha"])                 # (rows, n_in)
    if tok_w is None:
        return s.mean(0)
    if tok_w.numel() != s.shape[0]:
        raise ValueError(
            f"token_weights has {tok_w.numel()} rows but the projection sees "
            f"{s.shape[0]} token rows; pass token_weights=None for "
            "dispatch-reshaped projections")
    twf = tok_w.reshape(-1, 1).float()
    return (s * twf).sum(0) / torch.clamp(twf.sum(), min=1.0)


def _matmul(x, w):
    """x (..., n_in) @ w (n_in, *out), output dtype == input dtype (the
    reference's ``preferred_element_type=x.dtype``)."""
    y = x.reshape(-1, x.shape[-1]) @ w.reshape(w.shape[0], -1)
    return y.reshape(x.shape[:-1] + w.shape[1:])


def scores(x, g, alpha):
    """Weight-aware importance score  s_i = |x_i| * g_i^alpha  (Eq. 4)."""
    gf = torch.clamp(g.float(), min=1e-12)
    return x.float().abs() * torch.pow(gf, alpha)


def project(x, w, sp: Optional[dict] = None, *,
            policy: Optional[SparsityPolicy] = None,
            role: Optional[str] = None, token_weights=None):
    """Dispatch one projection under ``policy`` (depth ranges are already
    folded in by the model's layer loop; only role overrides remain to
    resolve here).  ``policy=None`` runs dense."""
    if policy is None:
        policy = DENSE
    if policy.capture is not None:
        policy.capture.record(w, x)
    backend = policy.backend_at(role=role)
    if sp is None or backend == "off":
        return _matmul(x, w)
    if backend == "mask":
        s = scores(x, sp["g"], sp["alpha"])
        m = (s >= sp["tau"]).to(x.dtype)               # Eq. 5
        return _matmul(x * m, w)
    if backend in ("topk_shared", "topk_block"):
        return _topk_gather(x, w, sp, policy, backend=backend,
                            token_weights=token_weights)
    if backend == "pallas":
        from repro_torch.kernels import ops as kops
        return kops.wisparse_project(x, w, sp, block=policy.block,
                                     k_frac=policy.k_max_frac,
                                     token_weights=token_weights)
    raise ValueError(    # unreachable: policies validate at construction
        f"unknown sparsity backend {backend}")


def _topk_gather(x, w, sp, policy, *, backend: str, token_weights=None):
    """Shared-mask gather path: aggregate weight-aware scores over all
    tokens in the call, keep the top k_max channels (static), mask ranks
    beyond the layer's own keep_frac, gather the matching weight rows and
    run a compact f32 matmul.

    ``topk_block`` selects whole blocks by the *sum of the mean,
    unthresholded* saliency — a different rule from the ``pallas``
    kernels' thresholded, row-weighted block scores; both are kept as the
    reference has them."""
    n_in = w.shape[0]
    xf = x.reshape(-1, n_in)
    sal = _saliency(xf, sp, token_weights)                       # (n_in,)
    dev = x.device
    if backend == "topk_block":
        b = policy.block
        nb = max(n_in // b, 1)
        if n_in % b:
            pad = nb * b + b - n_in
            sal = torch.nn.functional.pad(sal, (0, pad))
            nb += 1
        blk = sal.reshape(nb, -1).sum(1)
        kb_max = max(1, round(nb * policy.k_max_frac))
        bidx = topk_ids(blk, kb_max)
        idx = (bidx[:, None] * b + torch.arange(b, device=dev)[None, :]
               ).reshape(-1)
        # the reference clamps tail-block ids to the last channel
        idx = torch.clamp(idx, max=n_in - 1)
        k_l = torch.round(sp["keep_frac"] * nb)
        rank_ok = torch.arange(kb_max, device=dev) < k_l
        rank_ok = rank_ok.repeat_interleave(b)
    else:
        k_max = max(1, round(n_in * policy.k_max_frac))
        idx = topk_ids(sal, k_max)
        k_l = torch.round(sp["keep_frac"] * n_in)
        rank_ok = torch.arange(k_max, device=dev) < k_l
    ws = w.reshape(n_in, -1).index_select(0, idx)                # (k, m)
    xs = xf.index_select(1, idx) * rank_ok.to(x.dtype)
    y = xs.float() @ ws.float()
    return y.to(x.dtype).reshape(x.shape[:-1] + w.shape[1:])


def column_norms(w) -> torch.Tensor:
    """g_i = ||W[i, :]||_2 over all output dims; w: (n_in, *out)."""
    wf = w.reshape(w.shape[0], -1).float()
    return torch.sqrt((wf * wf).sum(1))


def default_sp(w) -> dict:
    """Dense-equivalent sparsity params (alpha=0, tau=-inf, keep=1)."""
    dev = w.device
    return {
        "g": column_norms(w),
        "alpha": torch.zeros((), dtype=torch.float32, device=dev),
        "tau": torch.full((), float("-inf"), dtype=torch.float32, device=dev),
        "keep_frac": torch.ones((), dtype=torch.float32, device=dev),
    }
