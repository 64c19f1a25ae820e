"""Calibration context: captured activations, dense references, Eq. 7
thresholds and the fitness / block-error evaluators (port of the JAX
package's ``core/calibration.py``).

Built once per (model, calibration set); every WiSparse search stage
(alpha grid, evolutionary block allocation, greedy layer allocation) runs
against this context (paper §4.2-4.3).

The reference keeps the captured activations on the host and caches one
fully sorted score array per (linear, alpha).  At llama31_8b's full width
and 512 calibration tokens that is 224 linears x 31 alphas of 2.1M-7.3M
floats each, about 80 GB.  The port keeps the activations where the model
ran, computes each threshold's order statistic there, and caches only the
scalar tau per (linear, alpha, keep ratio).  ``p`` and the index
arithmetic stay Python floats and ints, exactly as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import sparse_linear as sl
from repro_torch.core import unstacked as U
from repro_torch.sparsity import CaptureSink, SparsityPolicy

Key = Tuple[int, str]                       # (depth, leaf path e.g. "attn/wq")

# calibration/eval execution: paper-exact per-token mask numerics
_MASK = SparsityPolicy.uniform("mask")


@dataclasses.dataclass
class CalibContext:
    cfg: ModelConfig
    params: dict
    layers: list
    batch: dict
    dense_logits: torch.Tensor
    block_io: list                          # len D+1: dense input to block d
    acts: Dict[Key, torch.Tensor]           # captured linear inputs (T, n)
    g: Dict[Key, torch.Tensor]              # weight-column norms (n,) f32
    sizes: Dict[Key, float]                 # active-compute weights
    keys_by_depth: Dict[int, List[str]]
    enc_out: Optional[torch.Tensor] = None
    _tau_cache: dict = dataclasses.field(default_factory=dict)
    _dense_logp: Optional[tuple] = None

    # -- thresholds (Eq. 7) ------------------------------------------------
    def scores_for(self, key: Key, alpha: float) -> torch.Tensor:
        """The positive Eq. 4 scores of one linear's captured inputs,
        sorted ascending, on the activations' device (zero scores are
        dropped, as the reference drops MoE capacity padding)."""
        x = self.acts[key]
        gf = torch.clamp(self.g[key], min=1e-12)
        s = (x.float().abs() * torch.pow(gf, float(alpha))).reshape(-1)
        s = torch.sort(s).values
        n_pos = int((s > 0).sum())
        return s[s.numel() - n_pos:]

    def tau_for(self, key: Key, alpha: float, keep_ratio: float) -> float:
        p = float(np.clip(1.0 - keep_ratio, 0.0, 1.0))
        if p <= 0.0:
            return -np.inf
        ck = (key, round(float(alpha), 4), float(keep_ratio))
        if ck not in self._tau_cache:
            s = self.scores_for(key, alpha)
            idx = min(int(p * len(s)), len(s) - 1)
            self._tau_cache[ck] = float(s[idx])
        return self._tau_cache[ck]

    # -- sp construction ---------------------------------------------------
    def make_sp(self, alphas: Dict[Key, float], ratios: Dict[Key, float]):
        """Per-depth sp list with thresholds derived from keep ratios."""
        out = []
        for dl in self.layers:
            sp = U.default_layer_sp(dl.params)
            for path in self.keys_by_depth[dl.depth]:
                key = (dl.depth, path)
                a = float(alphas.get(key, 0.0))
                r = float(ratios.get(key, 1.0))
                U.set_sp_leaf(sp, path, "alpha", a)
                U.set_sp_leaf(sp, path, "tau", self.tau_for(key, a, r))
                U.set_sp_leaf(sp, path, "keep_frac", r)
            out.append(sp)
        return out

    # -- evaluators ----------------------------------------------------------
    def fitness(self, per_depth_sp) -> float:
        """Token-averaged KL(dense || sparse) on the calibration set (Eq. 8)."""
        if self._dense_logp is None:
            dense = torch.log_softmax(self.dense_logits.float(), -1)
            self._dense_logp = (dense, torch.exp(dense))
        dense, pd = self._dense_logp
        with torch.no_grad():
            logits, _ = U.forward_unstacked(
                self.params, self.cfg, self.batch["tokens"],
                layers=self.layers, per_depth_sp=per_depth_sp, policy=_MASK)
            ls = torch.log_softmax(logits.float(), -1)
            return float(torch.mean(torch.sum(pd * (dense - ls), -1)))

    def block_mse(self, depth: int, sp_d) -> float:
        """Block-output reconstruction error vs the dense block (Eq. 6)."""
        with torch.no_grad():
            y = U.block_forward(self.layers[depth], self.block_io[depth],
                                self.cfg, sp_d, self.enc_out, policy=_MASK)
            y_ref = self.block_io[depth + 1].float()
            return float(torch.mean(torch.square(y.float() - y_ref)))

    @property
    def num_blocks(self) -> int:
        return len(self.layers)

    def block_weight(self, depth: int) -> float:
        return sum(self.sizes[(depth, p)] for p in self.keys_by_depth[depth])


def build_context(params, cfg: ModelConfig, batch) -> CalibContext:
    """Run the dense model once over the calibration batch, capturing every
    linear's inputs and each block's dense input/output.  ``batch["tokens"]``
    (numpy or a tensor) moves to the params' device."""
    layers = U.unstack_layers(cfg, params)
    device = params["embed"].device
    tokens = torch.as_tensor(batch["tokens"]).to(device, torch.long)
    id2key: Dict[int, Key] = {}
    g, sizes, keys_by_depth = {}, {}, {}
    for dl in layers:
        names = []
        for path, w in U.sparsifiable_leaves(dl.params):
            key = (dl.depth, path)
            id2key[id(w)] = key
            g[key] = sl.column_norms(w)
            # compute weight: the element count (the reference's MoE
            # top-k scaling comes with the MoE slice)
            sizes[key] = float(w.numel())
            names.append(path)
        keys_by_depth[dl.depth] = names

    cap = CaptureSink()
    with torch.no_grad():
        logits, block_io = U.forward_unstacked(
            params, cfg, tokens, layers=layers, collect_block_inputs=True,
            policy=SparsityPolicy.dense(capture=cap))
        block_io = list(block_io)
        # the last block's output (the input of the final norm)
        block_io.append(U.block_forward(layers[-1], block_io[-1], cfg))

    acts: Dict[Key, list] = {}
    for wid, x in cap:
        key = id2key.get(wid)
        if key is not None:
            acts.setdefault(key, []).append(x.reshape(-1, x.shape[-1]))
    acts_t = {key: chunks[0] if len(chunks) == 1 else torch.cat(chunks, 0)
              for key, chunks in acts.items()}

    return CalibContext(
        cfg=cfg, params=params, layers=layers, batch={"tokens": tokens},
        dense_logits=logits, block_io=block_io, acts=acts_t, g=g,
        sizes=sizes, keys_by_depth=keys_by_depth)
