"""AdamW with f32 master params, global-norm clipping and optional
int8-compressed gradients with error feedback (port of the JAX
package's ``optim/adamw.py``) over the port's parameter trees (dicts and
lists of tensors, as in ``models/params.py``).

Model params may be bf16; the optimizer keeps f32 master copies and
moments.  ``update`` writes the moments, the master copies and the
params in place (the analog of the reference's donated buffers) and
keeps no grads past the step.  Every scalar of the step (the schedule,
the bias corrections, the clip factor) is an f32 tensor, as in the
reference, so the step runs on the params' device with no host read.

On a mesh (DTensor params, placed by ``LOGICAL_RULES_TRAIN``) the
moments and master copies take the params' placements (the reference's
ZeRO-style sharding of ``embed`` over ``data``), each grad is
redistributed to its param's layout first (a reduce-scatter of a partial
sum), and the norm and the int8 scale reduce over every shard.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.distributed import sharding
from repro_torch.models.params import tree_leaves, tree_map

F32 = torch.float32


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    warmup_steps: int = 100
    decay_steps: int = 10_000
    lr_min: float = 3e-5
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False     # int8 + error feedback (cross-pod DP)


def schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``lr_peak``, then cosine decay to ``lr_min`` at
    ``decay_steps``: an f32 tensor (``step`` an int tensor)."""
    step = torch.as_tensor(step).to(F32)
    warm = cfg.lr_peak * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.decay_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(params, cfg: AdamWConfig):
    # a copy even of an f32 leaf: params must not alias the master copy,
    # which update() writes in place
    def zeros(p):
        return torch.zeros_like(p, dtype=F32)

    state = {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "master": tree_map(lambda p: p.detach().to(F32, copy=True), params),
        "step": torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device),
    }
    if cfg.compress_grads:
        state["ef"] = tree_map(zeros, params)
    return state


def global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(leaf.to(F32)))
                          for leaf in tree_leaves(tree)))


def _quantize_int8(g, ef):
    """Error-feedback int8 quantization (per-tensor scale): the rounding
    residual is carried to the next step instead of being lost.  Returns
    (dequantized grad, new residual).  ``torch.round`` rounds half to
    even, as ``jnp.round`` does."""
    g = g.to(F32) + ef
    scale = torch.clamp(torch.max(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127)
    deq = q * scale
    return deq, g - deq


def _like(g, m):
    """``g`` in the layout of the state leaf ``m`` (the identity off a
    mesh)."""
    if sharding.is_sharded(g) and tuple(g.placements) != tuple(m.placements):
        return g.redistribute(m.device_mesh, m.placements)
    return g


@torch.no_grad()
def update(grads, state, params, cfg: AdamWConfig):
    """One step.  Returns (params, state, {"grad_norm", "lr"}); params
    and state are the objects passed in, written in place."""
    step = state["step"] + 1
    g_leaves = [_like(g, m) for g, m in zip(tree_leaves(grads),
                                            tree_leaves(state["m"]),
                                            strict=True)]
    if cfg.compress_grads:
        pairs = [_quantize_int8(g, ef)
                 for g, ef in zip(g_leaves, tree_leaves(state["ef"]),
                                  strict=True)]
        g_leaves = [deq for deq, _ in pairs]
        for ef, (_, res) in zip(tree_leaves(state["ef"]), pairs):
            ef.copy_(res)
        del pairs
    gnorm = global_norm(g_leaves)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    lr = schedule(cfg, step)
    stepf = step.to(F32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, dtype=F32, device=stepf.device),
                        stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, dtype=F32, device=stepf.device),
                        stepf)
    for g, m, v, master, p in zip(
            g_leaves, tree_leaves(state["m"]), tree_leaves(state["v"]),
            tree_leaves(state["master"]), tree_leaves(params), strict=True):
        # the reference's order: clip, m, v, bias-corrected u, then
        # master - lr * (u + wd * master); each product rounded apart
        g = g.to(F32) * clip
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * torch.square(g))
        del g
        u = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        master.sub_(u.add_(cfg.weight_decay * master).mul_(lr))
        del u
        p.copy_(master)                  # cast to the param dtype last
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
