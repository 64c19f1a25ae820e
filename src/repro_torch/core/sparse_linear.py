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
``policy=None`` means dense.

On a mesh (operands are DTensors under a
``distributed.sharding_context``) ``off`` and ``mask`` run as DTensor
ops, and the shared saliency is reduced over every row of every shard.
The top-k gathers run on local shards (``sharding.local_call``): the
weight rows they gather are made whole, its output columns stay where
they are.  A ``row_parallel`` weight (its input dim model-sharded:
``wo``, ``mlp/wo``, ``out_proj``) under ``topk_shared``/``topk_block``
takes the reference's balanced per-shard selection
(:func:`_topk_gather_grouped`, G = the ``model`` axis size when it
divides ``n_in``): each shard keeps its top ``k/G`` channels, so the
gather stays local and the per-shard products are summed.  The
``pallas`` kernels are not partitioned (nor is the reference's Pallas
call): they run on the whole operands, gathered on every rank, and give
the unsharded result.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed import sharding
from repro_torch.kernels.select import topk_ids
from repro_torch.sparsity import VALID_BACKENDS, SparsityPolicy

__all__ = ["SparsityPolicy", "VALID_BACKENDS", "DENSE", "project",
           "project_experts", "scores", "column_norms",
           "expert_column_norms", "default_sp"]

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


def project(x, w, sp: Optional[dict] = None, row_parallel: bool = False,
            *, policy: Optional[SparsityPolicy] = None,
            role: Optional[str] = None, token_weights=None):
    """Dispatch one projection under ``policy`` (depth ranges are already
    folded in by the model's layer loop; only role overrides remain to
    resolve here).  ``policy=None`` runs dense.

    ``row_parallel`` statically marks weights whose *input* dim is
    model-sharded (o_proj/down_proj/out_proj): under a sharding context
    whose ``model`` axis has size G dividing ``n_in`` the top-k gather
    backends select a balanced per-shard channel budget
    (:func:`_topk_gather_grouped`)."""
    if policy is None:
        policy = DENSE
    if policy.capture is not None:
        policy.capture.record(w, x)
    ctx = sharding.current_ctx() if row_parallel and sp is not None \
        else None
    if ctx is not None and policy.backend_at(role=role) in (
            "topk_shared", "topk_block"):
        g = sharding.mesh_sizes(ctx.mesh).get("model", 1)
        if g > 1 and w.shape[0] % g == 0:
            return _topk_gather_grouped(x, w, sp, policy, g,
                                        token_weights=token_weights)
    return _dispatch(x, w, sp, policy, role, token_weights=token_weights)


def project_experts(x, w, sp: Optional[dict] = None, *,
                    policy: Optional[SparsityPolicy] = None,
                    role: Optional[str] = None):
    """One expert-batched projection: x (E, R, n), w (E, n, m) -> (E, R,
    m) in x's dtype, expert e's equal to ``project(x[e], w[e], {**sp,
    "g": sp["g"][e]})`` under the same policy: the reference's
    ``jax.vmap`` of ``dense()`` over a MoE layer's experts
    (``models/moe.py``).  ``sp["g"]`` is (E, n); ``alpha``, ``tau`` and
    ``keep_frac`` are the layer's, shared by its experts.  There are no
    token weights: dispatch permutes and capacity-bounds the rows.

    A calibration capture records ``(w, x)`` only when the expert leaf
    has no sp entry, as the reference's ``apply_dense`` does: x is (E,
    B*C, n), each expert's rows of every group in (group, position)
    order, the reference's (B, E, C, n) capture with the expert axis
    moved first, capacity-padding rows included."""
    if policy is None:
        policy = DENSE
    if policy.capture is not None and sp is None:
        policy.capture.record(w, x)
    return _dispatch(x, w, sp, policy, role, experts=True)


def _dispatch(x, w, sp, policy, role, *, token_weights=None,
              experts: bool = False):
    """The backends of :func:`project` (x (..., n), w (n, *out)) and, with
    ``experts``, of :func:`project_experts` (x (E, R, n), w (E, n, m), g
    (E, n))."""
    backend = policy.backend_at(role=role)
    mm = torch.bmm if experts else _matmul
    if sp is None or backend == "off":
        return mm(x, w)
    g = sp["g"][:, None, :] if experts else sp["g"]
    if backend == "mask":
        m = (scores(x, g, sp["alpha"]) >= sp["tau"]).to(x.dtype)   # Eq. 5
        return mm(x * m, w)
    if backend in ("topk_shared", "topk_block"):
        keep = sp["keep_frac"]
        if experts:
            sal = scores(x, g, sp["alpha"]).mean(1)              # (E, n)
            return sharding.local_call(
                lambda wl, xl, sl, kl: _topk_gather(xl, wl, sl, kl, policy,
                                                    backend),
                (w, x, sal, keep),
                (("experts", None, None), ("experts", "batch", None),
                 ("experts", None), ()),
                ("experts", "batch", None))
        n_in = w.shape[0]
        xf = x.reshape(1, -1, n_in)
        sal = _saliency(xf[0], sp, token_weights)[None]          # (1, n)
        # the weight's output columns stay sharded as they are
        y = sharding.local_call(
            lambda wl, xl, sl, kl: _topk_gather(xl, wl, sl, kl, policy,
                                                backend),
            (w.reshape(1, n_in, -1), xf, sal, keep),
            ((None, None, "w_out"), (None, "batch", None), (None, None), ()),
            (None, "batch", "w_out"),
            rules={"w_out": (sharding.dim_axes(w, 1),)})
        return y[0].reshape(x.shape[:-1] + w.shape[1:])
    if backend == "pallas":
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            raise NotImplementedError(
                f"{role}: the pallas kernels have no backward; train under "
                "off, mask or topk_* (or without an sp tree)")
        from repro_torch.kernels import ops as kops
        # not partitioned: every operand whole on every rank
        keys = sorted(sp)
        if experts:
            def run(xl, wl, *spl):
                return kops.wisparse_project_experts(
                    xl, wl, dict(zip(keys, spl)), block=policy.block,
                    k_frac=policy.k_max_frac)
            args = (x, w)
        else:
            def run(xl, wl, twl, *spl):
                return kops.wisparse_project(
                    xl, wl, dict(zip(keys, spl)), block=policy.block,
                    k_frac=policy.k_max_frac, token_weights=twl)
            args = (x, w, token_weights)
        args += tuple(sp[k] for k in keys)
        return sharding.local_call(run, args, (None,) * len(args),
                                   (None,) * x.dim())
    raise ValueError(    # unreachable: policies validate at construction
        f"unknown sparsity backend {backend}")


def _topk_gather(x, w, sal, keep_frac, policy, backend: str):
    """Shared-mask gather path, per batch entry e of x (E, R, n), w (E, n,
    m) and its saliency ``sal`` (E, n) aggregated over e's rows (a plain
    projection is E = 1): keep the top k_max channels (static) in
    ``lax.top_k`` order, mask ranks beyond the layer's own keep_frac,
    gather the matching weight rows and run a compact f32 matmul.

    ``topk_block`` selects whole blocks by the *sum of the mean,
    unthresholded* saliency — a different rule from the ``pallas``
    kernels' thresholded, row-weighted block scores; both are kept as the
    reference has them."""
    E, R, n_in = x.shape
    m = w.shape[2]
    dev = x.device
    if backend == "topk_block":
        b = policy.block
        nb = max(n_in // b, 1)
        if n_in % b:
            sal = torch.nn.functional.pad(sal, (0, nb * b + b - n_in))
            nb += 1
        blk = sal.reshape(E, nb, -1).sum(2)
        kb_max = max(1, round(nb * policy.k_max_frac))
        bidx = topk_ids(blk, kb_max)                              # (E, kb)
        idx = (bidx[:, :, None] * b + torch.arange(b, device=dev)
               ).reshape(E, -1)
        # the reference clamps tail-block ids to the last channel
        idx = torch.clamp(idx, max=n_in - 1)
        k_l = torch.round(keep_frac * nb)
        rank_ok = (torch.arange(kb_max, device=dev) < k_l).repeat_interleave(b)
    else:
        k_max = max(1, round(n_in * policy.k_max_frac))
        idx = topk_ids(sal, k_max)                                # (E, k)
        k_l = torch.round(keep_frac * n_in)
        rank_ok = torch.arange(k_max, device=dev) < k_l
    k = idx.shape[1]
    ws = w.gather(1, idx[:, :, None].expand(E, k, m))            # (E, k, m)
    xs = x.gather(2, idx[:, None, :].expand(E, R, k)) * rank_ok.to(x.dtype)
    return torch.bmm(xs.float(), ws.float()).to(x.dtype)


def _topk_gather_grouped(x, w, sp, policy, groups: int, token_weights=None):
    """Balanced grouped selection (the reference's, for row-parallel
    weights): the input-channel dim splits into (groups, n/groups), each
    group keeps its top-(k/groups) channels in ``lax.top_k`` order
    (ranks past the layer's ``keep_frac * n/groups`` masked), gathers
    within the group (shard-local for model-sharded weight rows),
    contracts in f32 and the groups are summed.  The same global budget;
    the selection is per-shard balanced.  On a mesh each rank contracts
    its own groups and the f32 partial sums are reduced before the cast
    to x's dtype."""
    n_in = w.shape[0]
    G = groups
    ng = n_in // G
    xf = x.reshape(-1, n_in)
    sal = _saliency(xf, sp, token_weights).reshape(G, ng)
    k_max = max(1, round(ng * policy.k_max_frac))
    wg = sharding.constrain(w.reshape(G, ng, -1), "grouped_in", None, None)

    def run(wl, sl, xl, keep):
        idx = topk_ids(sl, k_max)                                # (g, k)
        k_l = torch.round(keep * ng)
        rank_ok = torch.arange(k_max, device=xl.device) < k_l    # (k,)
        g, m = wl.shape[0], wl.shape[2]
        ws = wl.gather(1, idx[:, :, None].expand(g, k_max, m))   # (g, k, m)
        xs = xl.gather(2, idx[None].expand(xl.shape[0], g, k_max))
        xs = xs * rank_ok.to(xs.dtype)
        return torch.einsum("bgk,gkm->bm", xs.float(), ws.float())

    y = sharding.local_call(
        run, (wg, sal, xf.reshape(-1, G, ng), sp["keep_frac"]),
        (("grouped_in", None, None), ("grouped_in", None),
         ("batch", "grouped_in", None), ()),
        ("batch", None), out_partial=("grouped_in",))
    if sharding.is_sharded(y):
        y = y.redistribute(y.device_mesh, [
            p if p.is_shard() else sharding.replicate()
            for p in y.placements])
    return y.to(x.dtype).reshape(x.shape[:-1] + w.shape[1:])


def column_norms(w) -> torch.Tensor:
    """g_i = ||W[i, :]||_2 over all output dims; w: (n_in, *out)."""
    wf = w.reshape(w.shape[0], -1).float()
    return torch.sqrt((wf * wf).sum(1))


def expert_column_norms(w) -> torch.Tensor:
    """(E, n_in) column norms of an expert weight (E, n_in, n_out), one
    expert at a time (the reference's ``jax.vmap(column_norms)``)."""
    return torch.stack([column_norms(we) for we in w])


def default_sp(w) -> dict:
    """Dense-equivalent sparsity params (alpha=0, tau=-inf, keep=1)."""
    dev = w.device
    return {
        "g": column_norms(w),
        "alpha": torch.zeros((), dtype=torch.float32, device=dev),
        "tau": torch.full((), float("-inf"), dtype=torch.float32, device=dev),
        "keep_frac": torch.ones((), dtype=torch.float32, device=dev),
    }
