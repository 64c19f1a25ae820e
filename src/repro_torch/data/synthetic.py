"""Synthetic data pipeline (a copy of the JAX package's
``data/synthetic.py``: it is numpy only, and the port imports nothing
of that package).

No external corpus (Pile, CodeAlpaca, MetaMathQA) is read; instead a
structured synthetic language over a configurable vocab that a small LM
can actually learn (so WiSparse calibration/eval on the trained model is meaningful):

  * Zipfian unigram base distribution,
  * first-order Markov "grammar" (sparse row-stochastic transitions),
  * periodic copy motifs (algorithmic structure -> non-trivial attention).

The stream is deterministic in (seed, host_id, num_hosts, step): each host
draws a disjoint slice of the global batch (straggler-deterministic, no
coordination needed) and any step can be regenerated exactly — together
with checkpointing this makes training restart bit-identical.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    branch: int = 8               # Markov out-degree per state
    motif_len: int = 16           # copied motif length
    motif_period: int = 64        # every k tokens, repeat a recent span


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        V = cfg.vocab_size
        # Zipf weights over the vocab
        w = 1.0 / np.arange(1, V + 1) ** cfg.zipf_a
        self.unigram = w / w.sum()
        # sparse Markov transitions: each token -> `branch` successors
        self.succ = rng.integers(0, V, size=(V, cfg.branch))
        self.succ_p = rng.dirichlet(np.ones(cfg.branch), size=V)

    def sample_sequence(self, rng: np.random.Generator) -> np.ndarray:
        cfg = self.cfg
        out = np.empty(cfg.seq_len, np.int32)
        tok = rng.choice(len(self.unigram), p=self.unigram)
        t = 0
        while t < cfg.seq_len:
            if t and t % cfg.motif_period == 0 and t >= cfg.motif_len:
                # algorithmic structure: copy a recent motif verbatim
                span = out[t - cfg.motif_len:t]
                n = min(cfg.motif_len, cfg.seq_len - t)
                out[t:t + n] = span[:n]
                t += n
                tok = int(out[t - 1])
                continue
            j = rng.choice(cfg.branch, p=self.succ_p[tok])
            tok = int(self.succ[tok, j])
            out[t] = tok
            t += 1
        return out

    def batch(self, step: int, host_id: int = 0, num_hosts: int = 1
              ) -> np.ndarray:
        """Deterministic (step, host) -> (local_batch, seq_len) int32."""
        cfg = self.cfg
        assert cfg.global_batch % num_hosts == 0
        local = cfg.global_batch // num_hosts
        rows = []
        for i in range(local):
            global_row = host_id * local + i
            rng = np.random.default_rng(
                (cfg.seed, step, global_row))
            rows.append(self.sample_sequence(rng))
        return np.stack(rows)

    def iterator(self, start_step: int = 0, host_id: int = 0,
                 num_hosts: int = 1) -> Iterator[np.ndarray]:
        step = start_step
        while True:
            yield self.batch(step, host_id, num_hosts)
            step += 1


def eval_batch(cfg: DataConfig, n: int = 4, step_offset: int = 10_000_000):
    """Held-out batch: same language (same Markov tables), sequence seeds
    disjoint from any reachable training step."""
    ds = SyntheticLM(dataclasses.replace(cfg, global_batch=n))
    return ds.batch(step_offset)
