"""Shared fixtures of the evaluation drivers (port of the JAX package's
``benchmarks/common.py``): one small trained model and its calibration
context, built once per process, the held-out metrics, and a timer that
waits for the card."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.device import resolve_device, sync
from repro_torch.obs.clock import now

_STATE = {}


def _wait(out) -> None:
    """Wait for the device work behind ``out`` (a tensor, or a tuple or
    list holding some)."""
    for t in out if isinstance(out, (tuple, list)) else (out,):
        if isinstance(t, torch.Tensor):
            sync(t.device)


def timed(fn, *args, reps=3, warmup=1):
    """(µs per call of ``fn(*args)``, its last output), each call waited
    for on its device before the clock is read."""
    for _ in range(warmup):
        _wait(fn(*args))
    t0 = now()
    for _ in range(reps):
        out = fn(*args)
        _wait(out)
    return (now() - t0) / reps * 1e6, out   # us


def trained_model(steps: int = 60, seq: int = 64, batch: int = 8,
                  device="cuda"):
    """Train the reduced llama3.1 config on synthetic data on ``device``
    (cached per process under the reference's key, whatever the
    device)."""
    key = ("trained", steps, seq, batch)
    if key not in _STATE:
        from repro_torch.launch.train import train
        _STATE[key] = train(
            arch="llama31_8b", use_reduced=True, steps=steps, batch=batch,
            seq=seq, lr=3e-3, log=lambda *a: None, device=device)
    return _STATE[key]


def build_calibration(params, cfg, data_cfg):
    """(calibration context, batch) of ``params`` on 4 sequences of
    ``data_cfg``'s synthetic language (step 991), on the params'
    device."""
    from repro_torch.core import calibration
    from repro_torch.data import SyntheticLM

    calib = SyntheticLM(dataclasses.replace(data_cfg, global_batch=4)
                        ).batch(991)
    batch = {"tokens": torch.from_numpy(calib).to(params["embed"].device)}
    return calibration.build_context(params, cfg, batch), batch


def calib_context(device="cuda"):
    """(ctx, batch) of :func:`trained_model` (cached)."""
    if "ctx" not in _STATE:
        _STATE["ctx"] = build_calibration(*trained_model(device=device)[:3])
    return _STATE["ctx"]


def driver_model(model, device):
    """The (params, cfg, data_cfg) a driver runs on, and its calibration
    (ctx, batch): ``model``'s, or :func:`trained_model`'s on the resolved
    ``device``."""
    dev = resolve_device(device)
    if model is None:
        return trained_model(device=dev)[:3], calib_context(device=dev)
    return tuple(model), build_calibration(*model)


def eval_metrics(params, cfg, data_cfg, per_depth_sp=None):
    """Held-out PPL + KL + top-1 agreement vs dense, the sparse forward
    under ``mask`` with ``per_depth_sp``."""
    from repro_torch.core import unstacked as U
    from repro_torch.data import eval_batch
    from repro_torch.sparsity import SparsityPolicy

    toks = torch.from_numpy(eval_batch(data_cfg, n=4)).to(
        params["embed"].device)
    policy = SparsityPolicy.uniform("mask") if per_depth_sp is not None \
        else SparsityPolicy.dense()
    with torch.no_grad():
        logits, _ = U.forward_unstacked(params, cfg, toks,
                                        per_depth_sp=per_depth_sp,
                                        policy=policy)
        dense_logits, _ = U.forward_unstacked(params, cfg, toks)
    lg = logits[:, :-1].float()
    lab = toks[:, 1:].long()
    lse = torch.logsumexp(lg, -1)
    pick = lg.gather(-1, lab[..., None])[..., 0]
    ppl = float(torch.exp(torch.mean(lse - pick)))
    pd = torch.log_softmax(dense_logits.float(), -1)
    ps = torch.log_softmax(logits.float(), -1)
    kl = float(torch.mean(torch.sum(torch.exp(pd) * (pd - ps), -1)))
    agree = float((logits.argmax(-1) == dense_logits.argmax(-1))
                  .float().mean())
    return {"ppl": ppl, "kl": kl, "top1_agree": agree}


class _KeptCounter:
    """Stands in a policy's ``capture`` slot: for each projection of a
    known weight it counts the input entries that Eq. 5 keeps
    (``|x| g^alpha >= tau``) under the layer's sp, weighted by the
    weight's size."""

    def __init__(self, weights: dict, per_depth_sp):
        self.weights, self.sp = weights, per_depth_sp
        self.kept = self.total = 0.0

    def record(self, w, x):
        from repro_torch.core import sparse_linear as sl
        from repro_torch.core import unstacked as U

        key = self.weights.get(id(w))
        if key is None:
            return
        leaf = U.get_sp_leaf(self.sp[key[0]], key[1])
        keep = sl.scores(x, leaf["g"], leaf["alpha"]) >= leaf["tau"]
        self.kept += float(keep.float().mean()) * w.numel()
        self.total += w.numel()


def kept_fraction(params, cfg, data_cfg, per_depth_sp) -> float:
    """The share of the sparsified weights' rows that ``per_depth_sp``
    keeps on :func:`eval_metrics`' held-out tokens under ``mask``: each
    projection's kept input entries over all of them, weighted by its
    weight's size (1 - the budget where every threshold splits its
    scores exactly; more where scores tie at tau).  Expert projections
    record nothing under a sparse plan, so they are not in it."""
    from repro_torch.core import unstacked as U
    from repro_torch.data import eval_batch
    from repro_torch.sparsity import SparsityPolicy

    layers = U.unstack_layers(cfg, params)
    weights = {id(w): (dl.depth, path) for dl in layers
               for path, w in U.sparsifiable_leaves(dl.params)}
    counter = _KeptCounter(weights, per_depth_sp)
    toks = torch.from_numpy(eval_batch(data_cfg, n=4)).to(
        params["embed"].device)
    with torch.no_grad():
        U.forward_unstacked(params, cfg, toks, layers=layers,
                            per_depth_sp=per_depth_sp,
                            policy=SparsityPolicy.uniform(
                                "mask", capture=counter))
    return counter.kept / counter.total if counter.total else float("nan")


def calib_kept_fraction(ctx, per_depth_sp) -> float:
    """The share of the sparsified weights' rows that ``per_depth_sp``
    keeps on its calibration tokens (``ctx.acts``, the dense model's
    captured inputs, where Eq. 7 set its thresholds), weighted by each
    weight's active size: 1 - the budget where every threshold splits
    its scores exactly, more where scores tie at tau."""
    from repro_torch.core import sparse_linear as sl
    from repro_torch.core import unstacked as U

    kept = total = 0.0
    for (d, path), x in ctx.acts.items():
        leaf = U.get_sp_leaf(per_depth_sp[d], path)
        g = leaf["g"][:, None, :] if leaf["g"].dim() == 2 else leaf["g"]
        keep = sl.scores(x, g, leaf["alpha"]) >= leaf["tau"]
        kept += float(keep.float().mean()) * ctx.sizes[(d, path)]
        total += ctx.sizes[(d, path)]
    return kept / total
