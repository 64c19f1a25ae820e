"""FLOPs and bytes of one serving step, counted from the model config and
the sparsity policy (the port's counterpart of the JAX package's
``launch/roofline.executable_costs``, which reads them from XLA's
``cost_analysis()``; PyTorch has no such analysis).

:func:`step_costs` counts what the step must do at the least:

* every projection's weight bytes as its kernel reads them (all of them
  dense; the ``k_max_frac · nb`` gathered channel blocks under
  ``pallas``, the gathered rows under ``topk_shared``/``topk_block``)
  and ``2·rows·in·out`` FLOPs per product over the channels it reads;
* a MoE layer's router product (``2·rows·d·E`` FLOPs over the
  ``d × E`` router, read once) and its three expert projections as the
  port computes them: every one of the ``E`` experts, the pad experts
  included, over its ``groups · C`` dispatched rows (``C`` the capacity
  of the step's tokens per group, ``models/moe._capacity``), each
  expert's weight read as its projection reads it (its ``k_max_frac``
  share under ``pallas`` and the gather backends);
* the attention's K and V reads at each layer's cache length in the
  cache dtype (the pool length, or the window on a ``local`` layer,
  whose cache rolls), and its two products (scores and values,
  ``4·rows·H·hd·T`` FLOPs);
* a ``mamba`` layer's six projections (``in_z``, ``in_x``, ``in_B``,
  ``in_C``, ``in_dt``, ``out_proj``) as above, its conv weights,
  ``A_log``, ``D``, ``dt_bias`` and gated-norm weight, and every slot's
  conv windows (model dtype) and f32 SSM state, each read once and
  written once; its products are the conv's tap sums (``2·rows·W·C``
  over the ``C = d_inner + 2·N`` conv channels) and the state's
  read-out (``2·rows·H·P·N``), while the state update (an outer
  product, scaled and added) is elementwise;
* the embedding rows gathered and the LM head (the embedding itself
  when the head is tied, as in the Gemma family);
* the norms' weights (their elementwise work is no product, and is left
  out of the FLOPs as ``torch.utils.flop_counter`` leaves it out).

Activations that stay on chip are not counted.  The quality monitor
(``obs/quality.py``) uses it for its per-rung roofline counters and
decode utilization, and ``chip_smoke.py`` prints it beside the measured
steps.

The mesh half (the reference's ``launch/roofline.py`` after its HLO
parsing) turns the dry run's per-device counts into three terms per
(arch x shape x mesh) cell, each a prediction from the H100 SXM data
sheet (``launch/constants.py``), not a measurement:

    compute    = FLOPs per device            / 989 TF/s bf16
    memory     = bytes per device            / 3.35 TB/s HBM3
    collective = collective bytes per device / 450 GB/s NVLink (one way)

with all-reduce bytes counted twice on the wire (reduce-scatter +
all-gather).  MODEL_FLOPS = 6*N_active*tokens (train) or
2*N_active*tokens (serve); its ratio to the counted FLOPs exposes remat,
causal overcount and redundant (replicated) work."""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.kernels.ops import channel_plan
from repro_torch.launch import constants as C
from repro_torch.models.model import chunkable
from repro_torch.models.moe import expert_rows

_ELEM = {"bfloat16": 2, "float32": 4}


def _sp_leaf(sp, gi: int, j: int, path: str):
    """Layer (group gi, pattern slot j)'s sp leaf at ``path``, or None."""
    if sp is None:
        return None
    node = sp[gi].get(f"l{j}")
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _projection(rows: int, n: int, m: int, backend: str, policy,
                elem: int) -> Tuple[float, float]:
    """(FLOPs, weight bytes) of one (rows, n) @ (n, m) projection."""
    if backend == "pallas":
        blk, _, nb = channel_plan(n, policy.block)
        k = max(1, min(nb, round(nb * policy.k_max_frac))) * blk
    elif backend == "topk_shared":
        k = max(1, round(n * policy.k_max_frac))
    elif backend == "topk_block":
        b = policy.block
        nb = max(n // b, 1) + (1 if n % b else 0)
        k = max(1, round(nb * policy.k_max_frac)) * b
    else:                       # off, mask: the whole weight
        k = n
    return 2.0 * rows * k * m, float(k * m * elem)


def step_costs(cfg, ecfg, policy, sp, phase: str, gamma=None
               ) -> Tuple[float, float]:
    """(FLOPs, bytes) of one engine step.

    ``phase``: ``"decode"`` (the batched slot decode, ``max_slots`` rows),
    ``"chunk"`` (one request's prefill chunk, ``prefill_chunk`` rows
    against one slot's cache) or ``"verify"`` (the speculative verify,
    ``max_slots · (gamma + 1)`` rows).  ``policy`` is the policy the step
    runs (a rung's phase policy) and ``sp`` its stacked sp tree (None
    runs every projection dense, as ``core/sparse_linear.project``
    does).  An arch with ``local`` or ``mamba`` layers has no chunk or
    verify step."""
    if phase not in ("decode", "chunk", "verify"):
        raise ValueError(f"unknown step phase {phase!r}")
    if phase == "verify" and gamma is None:
        raise ValueError("a verify step needs its gamma")
    if phase != "decode" and not chunkable(cfg):
        raise ValueError(
            f"{cfg.name} has local-attention or SSM layers: no {phase} "
            "step")
    elem = _ELEM[cfg.dtype]
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    S, C = ecfg.max_slots, ecfg.prefill_chunk
    T = ecfg.pool_len
    # x of the step: (groups, tokens per group, d)
    groups, tokens = {"decode": (S, 1), "chunk": (1, C),
                      "verify": (S, (gamma or 0) + 1)}[phase]
    rows = groups * tokens
    slots_read = 1 if phase == "chunk" else S
    attn = (("attn/wq", d, H * hd), ("attn/wk", d, KV * hd),
            ("attn/wv", d, KV * hd), ("attn/wo", H * hd, d))
    di, N, Hs = cfg.d_inner, cfg.ssm_state, cfg.ssm_nheads
    W, conv_c = cfg.ssm_conv, cfg.d_inner + 2 * cfg.ssm_state
    mamba = (("mamba/in_z", d, di), ("mamba/in_x", d, di),
             ("mamba/in_B", d, N), ("mamba/in_C", d, N),
             ("mamba/in_dt", d, Hs), ("mamba/out_proj", di, d))
    ffn_shapes = {
        "dense": (("mlp/wi_gate", d, cfg.d_ff), ("mlp/wi_up", d, cfg.d_ff),
                  ("mlp/wo", cfg.d_ff, d)),
        "moe": (("moe/wi_gate", d, cfg.expert_d_ff),
                ("moe/wi_up", d, cfg.expert_d_ff),
                ("moe/wo", cfg.expert_d_ff, d)),
        "none": ()}
    E = cfg.num_experts_padded
    e_rows = expert_rows(cfg, groups, tokens) if E else 0
    flops = 0.0
    nbytes = float(rows * d * elem)                  # embedding rows
    depth = 0
    for gi, (pattern, reps) in enumerate(cfg.layer_groups()):
        for _r in range(reps):
            for j, (mixer, ffn) in enumerate(pattern):
                Tl = min(cfg.sliding_window, T) if mixer == "local" else T
                lpol = policy.resolve_depth(depth)
                mix = mamba if mixer == "mamba" else attn
                for role, n, m in mix + ffn_shapes[ffn]:
                    expert = role.startswith("moe/")
                    backend = lpol.backend_at(role=role)
                    if _sp_leaf(sp, gi, j, role) is None:
                        backend = "off"
                    f, b = _projection(e_rows if expert else rows, n, m,
                                       backend, lpol, elem)
                    flops += f * (E if expert else 1)
                    nbytes += b * (E if expert else 1)
                if ffn == "moe":         # the router, in f32 from x's dtype
                    flops += 2.0 * rows * d * E
                    nbytes += float(d * E * elem)
                if mixer == "mamba":
                    # conv weights, A_log, D and dt_bias (f32), the norm;
                    # every slot's conv windows and f32 state, read and
                    # written; the conv sums and the state's read-out
                    nbytes += float(W * conv_c * elem + 3 * Hs * 4
                                    + di * elem)
                    nbytes += 2.0 * slots_read * (
                        (W - 1) * conv_c * elem
                        + Hs * cfg.ssm_head_dim * N * 4)
                    flops += 2.0 * rows * W * conv_c \
                        + 2.0 * rows * Hs * cfg.ssm_head_dim * N
                else:
                    # K and V of every slot the step attends, at the
                    # layer's cache length, then the two attention
                    # products
                    nbytes += 2.0 * slots_read * KV * hd * Tl * elem
                    flops += 4.0 * rows * H * hd * Tl
                # ln1, and ln2 where the layer has an FFN
                nbytes += (1.0 if ffn == "none" else 2.0) * d * elem
                depth += 1
    nbytes += d * elem                               # final norm
    flops += 2.0 * rows * d * cfg.vocab_size         # LM head
    nbytes += float(cfg.vocab_size * d * elem)
    return flops, nbytes


# ---------------------------------------------------------------------------
# The mesh half: roofline terms of one dry-run cell
# ---------------------------------------------------------------------------

def wire_bytes(coll: Dict[str, int]) -> float:
    """Per-device wire bytes: all-reduce counts 2x (RS+AG decomposition)."""
    total = 0.0
    for k, v in coll.items():
        total += 2 * v if k == "all-reduce" else v
    return total


def active_matmul_params(cfg) -> float:
    """N_active: per-token matmul params (MoE scaled by k/E), head
    included: the reference's arithmetic over the port's schema."""
    import numpy as np

    from repro_torch.models import model as M
    from repro_torch.models.params import tree_flatten_with_path

    total = 0.0
    for path, spec in tree_flatten_with_path(M.model_schema(cfg)):
        keys = [str(k) for k in path]
        if keys[-1] in ("embed", "lm_head"):
            continue                      # head counted separately below
        if len(spec.shape) < 2:
            continue
        shape = spec.shape
        # drop the stacked-layers dim from the product, multiply back reps
        if any(k.startswith("l") and k[1:].isdigit() for k in keys):
            reps, shape = shape[0], shape[1:]
        else:
            reps = 1
        p = float(np.prod(shape)) * reps
        if len(shape) == 3:               # MoE expert weight (E, n, m)
            p *= cfg.num_experts_per_tok / cfg.num_experts
        total += p
    total += float(cfg.vocab_size) * cfg.d_model   # unembedding matmul
    return total


def model_flops(cfg, shape) -> float:
    n = active_matmul_params(cfg)
    if shape.mode == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.mode == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch          # decode: one token per seq


@dataclasses.dataclass
class Roofline:
    """Roofline terms of one cell on H100 SXM cards (data-sheet rates)."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float      # counted on each rank's local shards
    bytes_per_device: float
    coll_bytes: float            # per-device wire bytes
    model_flops_total: float

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / C.PEAK_FLOPS_BF16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / C.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll_bytes / C.NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Roofline step time: max of the three terms (full overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        total = self.flops_per_device * self.chips
        return self.model_flops_total / max(total, 1.0)

    @property
    def mfu(self) -> float:
        """Model-FLOPs utilization at the roofline step time."""
        return (self.model_flops_total
                / (max(self.step_time_s, 1e-30) * self.chips
                   * C.PEAK_FLOPS_BF16))

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "model_flops": self.model_flops_total,
            "useful_ratio": self.useful_flops_ratio,
            "mfu": self.mfu,
        }
