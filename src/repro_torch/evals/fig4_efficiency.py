"""Paper Fig. 4: efficiency vs sparsity (port of the JAX package's
``benchmarks/fig4_efficiency.py``).

Left panel (FLOPs): per-token matmul FLOPs at 0-50% sparsity — the paper
reports a near-linear reduction (1.92 -> 1.03 TFLOPs at 50% on Llama-3.1
-8B); computed analytically for the full llama31_8b config.

Right panel (throughput): the block-gather matmul
(``kernels.sparse_matmul.sparse_matmul_shared``: the Hopper kernel on
the card, its plain version on the CPU) against a dense product at the
reference's shapes, and the modeled decode step gain from the port's
dry-run records (``python -m repro_torch.launch.dryrun --out``, at
sparsity 0 into :data:`BASE` and 0.5 into :data:`SPARSE`).
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.evals.common import timed
from repro_torch.launch import roofline as R

BASE = "experiments/torch_dryrun_baseline.jsonl"
SPARSE = "experiments/torch_dryrun_sparse.jsonl"
# the kernel rows: 4 rows through a 2048 x 2048 f32 weight in 128-channel
# blocks, every second block kept
B, N, M, BLK = 4, 2048, 2048, 128


def kernel_inputs(seed: int = 0) -> tuple:
    """The kernel rows' numpy inputs: x (B, N) and w (N, M) standard
    normal f32 from ``seed``, the kept block ids (every second) int32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, N), dtype=np.float32)
    w = rng.standard_normal((N, M), dtype=np.float32)
    return x, w, np.arange(0, N // BLK, 2, dtype=np.int32)


def kernel_rows(dev, log=print) -> tuple:
    """(the dense product's and the block gather's rows, the gather's
    output) on ``dev``: the Hopper kernel on a card, its plain version
    on the CPU."""
    from repro_torch.kernels import sparse_matmul as K

    x, w, idx = (torch.from_numpy(a).to(dev) for a in kernel_inputs())
    us_dense, _ = timed(lambda x: x @ w, x)
    us_sparse, y = timed(
        lambda x: K.sparse_matmul_shared(x, w, idx, blk=BLK), x)
    note = "hopper-kernel" if dev.type == "cuda" else "plain-version-CPU"
    flops_dense = 2 * B * N * M
    flops_sparse = flops_dense // 2
    rows = [("fig4/kernel_dense_matmul", us_dense, f"flops={flops_dense}"),
            ("fig4/kernel_gather_50pct", us_sparse,
             f"flops={flops_sparse};note={note}")]
    log(f"kernel: dense {us_dense:.0f}us vs gather@50% {us_sparse:.0f}us "
        f"({note}; FLOPs/bytes halve structurally)")
    return rows, y


def _load(path):
    out = {}
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("status") == "ok":
                out[(r["arch"], r["shape"], r["mesh"])] = r
    return out


def run(log=print, device="cuda"):
    dev = resolve_device(device)
    rows = []
    cfg = get_config("llama31_8b")
    n_active = R.active_matmul_params(cfg)
    dense_tf = 2 * n_active / 1e12
    for p in (0.0, 0.3, 0.4, 0.5):
        # attention projections + MLP sparsify; head stays dense
        head = cfg.vocab_size * cfg.d_model
        sparse_tf = 2 * ((n_active - head) * (1 - p) + head) / 1e12
        log(f"sparsity={p:.0%}: {sparse_tf:.3f} TFLOPs/token "
            f"({sparse_tf/dense_tf:.1%} of dense)")
        rows.append((f"fig4/flops_per_token/p{int(p*100)}", 0.0,
                     f"{sparse_tf:.4f}TF;frac={sparse_tf/dense_tf:.4f}"))

    # kernel-level: dense matmul vs block-gather at 50% kept blocks
    rows += kernel_rows(dev, log)[0]

    # modeled decode throughput gain from the dry-run roofline records
    if os.path.exists(BASE) and os.path.exists(SPARSE):
        base, sp = _load(BASE), _load(SPARSE)
        for k in sorted(set(base) & set(sp)):
            if k[1].startswith("decode") and k[2] == "single":
                tb = max(base[k]["roofline"]["compute_s"],
                         base[k]["roofline"]["memory_s"])
                ts = max(sp[k]["roofline"]["compute_s"],
                         sp[k]["roofline"]["memory_s"])
                gain = tb / ts if ts > 0 else float("nan")
                rows.append((f"fig4/modeled_decode_gain/{k[0]}", 0.0,
                             f"x{gain:.2f}"))
                log(f"modeled decode mem/compute speedup {k[0]}: x{gain:.2f}")
    return rows


if __name__ == "__main__":
    run()
