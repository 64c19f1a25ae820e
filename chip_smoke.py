#!/usr/bin/env python3
"""Drive the PyTorch/H100 port's main path once on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --host-only [--src DIR]

In order, it:

1. prints the card's name and power limit (``nvidia-smi``) and stops,
   with a nonzero exit, when ``torch.cuda.is_available()`` is false;
2. builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` with
   ``nvcc`` (printing each kernel's register / shared-memory report),
   times each kernel wrapper's host cost per call at the decode shapes,
   times the whole ``pallas`` projection (``ops.wisparse_project``)
   against the dense product at every projection shape (B = 8, 32, 448)
   and counts the CUDA kernels one projection launches
   (``torch.profiler``; it must be 3: ``score_select``, the matmul, the
   cast), and times one projection of each plain gather backend
   (``topk_shared``, ``topk_block``) at B = 8.  ``--host-only`` stops
   here; ``--src`` times another tree's package, so two commits can be
   compared in one call;
3. holds each kernel against its plain PyTorch version on the card, on
   the kernel test shapes in f32 and bf16 and at llama31_8b's projection
   shapes, and times the kernel, the plain version and (for the
   matmuls) dense ``torch.matmul`` by CUDA-graph replay.
   ``score_select`` runs at B = 8 (decode slots), 32 (one prefill
   chunk) and 448 (a whole prompt), with a finite tau and keep_frac 0.5
   and 0.375 under k_frac 0.5: xm bit-equal, idx equal (or differing
   only between block scores within the tolerance, printed), two
   launches bit-equal, timed as one launch of the cluster kernel.  The
   matmul kernels run at B = 8 and 32; at every projection shape each
   must give the same bits in two launches, and its line shows its
   split-K grid, its share of the bound and the v1 kernel's time beside
   this run's; a per-decode-layer summary follows.
   ``sparse_matmul_per_seq`` gets a distinct random half of the blocks
   per row there, and its only entry point,
   ``ops.wisparse_project(per_seq=True)``, is driven at every projection
   shape and held against ``per_seq=False``;
4. checks a reduced llama31_8b on the card against the same model on the
   CPU (plain kernel versions): forward logits and served greedy tokens;
5. serves full-width llama31_8b (32 layers, d_model 4096, bf16, random
   weights from a fixed seed) through the port's ``Engine``: 12 requests
   with ragged prompts of 64-448 tokens, 32 new tokens each, dense and
   under ``SparsityPolicy.uniform("pallas", k_max_frac=0.5)`` with an
   uncalibrated sp tree (``keep_frac=0.5``, ``tau=-inf``), each twice in
   the order dense, pallas, pallas, dense.  The decode step runs as a
   CUDA graph captured once per engine (``serving/graphs.py``).  The
   kernels' launch counts are zeroed just before each engine is built
   and read just after its run; on a ``pallas`` run the launches that
   ran (each launch recorded in the capture taken once per replay) must
   equal the sparse projections executed (224 per decode step, per
   sparse prefill chunk and per warm step before a capture), on a dense
   run zero.  A window of each run's decode steps is traced with
   ``torch.profiler`` for the device busy share of those same steps;
6. calibrates a ``pallas`` policy ladder (``sparsity.calibrate_ladder``,
   paper Alg. 1-4 per rung, with the serve CLI's ``--calib-quick``
   budget) on the same full-width model at budgets 0.0, 0.5 (the cold
   search) and 0.7 (warm-started), on 4 x 128 synthetic tokens, with the
   quality baselines; prints each rung's stage wall times, the block
   ratios, the mean alpha, the device memory peak and the 0.5 rung's KL
   beside the activation-only plan's, and checks the 0.5 rung's budget,
   that every threshold of a sparsified linear is finite, the 0.7 rung's
   budget and the ladder's monotonicity;
7. saves the 0.5 rung as a ``pallas`` policy artifact under ``build/``,
   loads it back and serves phase 5's trace once from it, checking the
   launch counts as in phase 5;
8. saves the ladder as a v4 artifact under ``build/``, loads it back and
   serves phase 5's trace from it twice under the SLO controller
   (``tpot_p95=1e6``, ``max_queue=2``, ``dwell=2``): at least two rungs
   visited, ``"queue"`` and ``"idle"`` transitions, no decode step built
   after warmup (every rung's graph is captured once), a rung for every
   token, the same tokens and transitions in both runs, launches as in
   phase 5;
9. holds the captured decode step against the eager one at full width,
   B = 8, dense and ``pallas``: equal greedy tokens, the logits' max abs
   error, host and device time per step;
10. prints one JSON line describing every kernel, then, as its last line,
   ``{"ok": true, "device": {...}}``.  The ``launches`` of ``score_select``
   and ``sparse_matmul_shared`` come from phase 5's first ``pallas``
   run; those of ``sparse_matmul_per_seq`` from phase 3's
   ``wisparse_project(per_seq=True)`` calls, since no serving path
   reaches that kernel.

Any failed check raises, so the script exits nonzero and prints no
result line.  It imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))

import numpy as np
import torch

SEED = 0
# kernel test shapes (B, n, m, blk): tests/test_kernels.py SHAPES + AWKWARD
SHAPES = [(1, 256, 128, 128), (4, 512, 384, 128), (8, 1024, 512, 256),
          (3, 384, 256, 128)]
AWKWARD = [(5, 256, 257, 128), (13, 384, 131, 128), (9, 512, 384, 256),
           (1, 128, 1, 128)]
# llama31_8b projections of one layer, (role, n, m)
LAYER = [("attn/wq", 4096, 4096), ("attn/wk", 4096, 1024),
         ("attn/wv", 4096, 1024), ("attn/wo", 4096, 4096),
         ("mlp/wi_gate", 4096, 14336), ("mlp/wi_up", 4096, 14336),
         ("mlp/wo", 14336, 4096)]
BLK = 128
KEEP = 0.5
# Tolerances.  Kernel and plain version both upcast their inputs to f32
# exactly (bf16 -> f32 is exact) and accumulate in f32, so they differ only
# in summation order: |err| <= 1e-4 + 1e-4*|ref| covers f32 rounding over
# sums of up to 14336 terms.  The score mask itself is a comparison: inputs
# are made tie-free (no score within 0.1% of tau), so xm must match
# exactly.
RTOL = ATOL = 1e-4
# reduced model, card vs CPU, f32: the same tolerance the CPU parity tests
# use for logits (sums in another order over 2 layers)
LOGIT_ATOL = 1e-4
# decode steps of each serving run traced by torch.profiler (busy share)
WINDOW = 8
# Times of the v1 matmul kernels (one thread block per 64 columns walking
# the kept blocks on CUDA cores; us, CUDA-graph replay, bf16, 50% kept,
# cold L2, this script on an NVIDIA H100 80GB HBM3 at 700 W), printed
# beside this run's: (B, role) -> (sparse_matmul_shared,
# sparse_matmul_per_seq)
V1_US = {
    (8, "attn/wq"): (53.53, 42.51), (8, "attn/wk"): (49.66, 27.67),
    (8, "attn/wv"): (49.66, 28.50), (8, "attn/wo"): (54.09, 44.33),
    (8, "mlp/wi_gate"): (59.16, 145.92), (8, "mlp/wi_up"): (59.09, 146.57),
    (8, "mlp/wo"): (189.34, 163.75),
    (32, "attn/wq"): (56.06, 137.65), (32, "attn/wk"): (47.44, 38.21),
    (32, "attn/wv"): (47.36, 37.83), (32, "attn/wo"): (56.22, 136.45),
    (32, "mlp/wi_gate"): (151.52, 549.30), (32, "mlp/wi_up"): (151.92, 547.95),
    (32, "mlp/wo"): (190.02, 559.12)}
# The unfused score_mask kernel (one thread block per channel block,
# scoring and block sums only; the selection then ran as a dozen PyTorch
# ops), per decode layer at B = 8 (us, CUDA-graph replay, this script on
# an NVIDIA H100 80GB HBM3 at 700 W), printed beside score_select's
SCORE_MASK_UNFUSED_US = 18.06


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def peak_rates(name: str):
    """(bytes/s, bf16 FLOP/s, f32 FLOP/s) of the card, from NVIDIA's data
    sheets: H100 SXM 3.35 TB/s, 989 TF bf16, 67 TF f32; PCIe 2.0 TB/s,
    756 TF bf16, 51 TF f32."""
    if "PCIe" in name:
        return 2.0e12, 756e12, 51e12
    return 3.35e12, 989e12, 67e12


def bound_ms(nbytes: float, flops: float, dtype, rates):
    mem, bf16, f32 = rates
    t_mem = nbytes / mem
    t_ops = flops / (bf16 if dtype == torch.bfloat16 else f32)
    return 1e3 * max(t_mem, t_ops), ("bytes" if t_mem >= t_ops else
                                     "operations")


def graph_ms(fn, reps: int = 20, replays: int = 5) -> float:
    """Device time per call of ``fn(i)``: ``reps`` calls captured in one
    CUDA graph, replayed ``replays`` times between CUDA events, so the
    host's launch overhead (tens of microseconds per PyTorch op on the
    card's host) is not in the number."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(3):          # allocator and cuBLAS workspace warm-up
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * replays)


def launched(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"kernel launch failed: cudaError {err}")


def direct_matmul(K, build, name, x, ws, idx, m, kb, per_seq):
    """``fn(i)`` calling the C entry of the block-gather matmul ``name``
    on weight copy ``ws[i % len(ws)]``, with its output and split-K
    scratch allocated once here (kernel-only timing), and its plan."""
    B, n = x.shape
    plan = K.launch_plan(B, n, m, kb, BLK, per_seq, x.element_size())
    y = torch.empty(B, m, device=x.device)
    scratch, cnt = K.matmul_scratch(plan, x.device)
    entry = getattr(build.library(), "wisparse_" + name)

    def fn(i):
        launched(entry(x.data_ptr(), ws[i % len(ws)].data_ptr(),
                       idx.data_ptr(), y.data_ptr(),
                       None if scratch is None else scratch.data_ptr(),
                       None if cnt is None else cnt.data_ptr(), B, n, m, BLK,
                       kb, plan.rows, plan.cols, plan.splits, 1,
                       torch.cuda.current_stream().cuda_stream))
    return fn, plan


def bit_equal(name: str, fn) -> None:
    """Two launches of the same inputs give the same bits (in each output
    where ``fn`` returns a tuple)."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    if not isinstance(a, tuple):
        a, b = (a,), (b,)
    if not all(torch.equal(u, v) for u, v in zip(a, b)):
        raise AssertionError(f"{name}: two launches differ")


def tie_free(x: np.ndarray, g: np.ndarray, alpha: float, tau: float,
             dtype) -> np.ndarray:
    """Scale by 1.05 every x whose score lands within 0.1% of tau, so the
    threshold decision cannot depend on rounding (pow implementations)."""
    xq = torch.from_numpy(x).to(dtype).float().numpy().astype(np.float64)
    s = np.abs(xq) * np.maximum(g.astype(np.float64), 1e-12) ** alpha
    near = np.abs(s - tau) <= 1e-3 * max(abs(tau), 1e-3)
    x = x.copy()
    x[near] *= 1.05
    return x


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    err = (got.float() - want.float()).abs()
    lim = ATOL + RTOL * want.float().abs()
    if bool((err > lim).any()):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version, max abs err "
            f"{float(err.max()):.3e}")
    return float(err.max())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_select(name: str, got, want, kb_l: int) -> float:
    """``score_select``'s (xm, idx, bs) against its plain version's: bs
    within the tolerance; idx equal, or else every pair of ids that
    differ has plain block scores within the bs tolerance of each other
    (a near tie that the summation order breaks either way; printed); xm
    bit-equal to the plain mask zeroed outside the first ``kb_l`` blocks
    of the kernel's own idx (the plain xm itself when idx is equal).
    Returns the largest bs error."""
    xm, idx, bs = got
    xm_r, idx_r, bs_r = want
    err = check_close(f"{name} bs", bs, bs_r)
    if not torch.equal(idx, idx_r):
        ranks = (idx != idx_r).nonzero().flatten().tolist()
        for r in ranks:
            a, b = float(bs_r[idx[r].long()]), float(bs_r[idx_r[r].long()])
            if abs(a - b) > ATOL + RTOL * abs(b):
                raise AssertionError(
                    f"{name}: idx[{r}] = {int(idx[r])} (plain bs {a}) where "
                    f"the plain version ranks {int(idx_r[r])} (plain bs {b})")
        print(f"  {name}: idx differs from the plain version at ranks "
              f"{ranks}, between block scores within the tolerance: kernel "
              f"{idx[ranks].tolist()}, plain {idx_r[ranks].tolist()}")
        blk = xm.shape[1] // bs.numel()
        kept = torch.zeros(bs.numel(), dtype=torch.bool, device=xm.device)
        kept[idx[:kb_l].long()] = True
        xm_r = torch.where(kept.repeat_interleave(blk)[None], xm_r,
                           torch.zeros_like(xm_r))
        if torch.unique(idx).numel() != idx.numel():
            raise AssertionError(f"{name}: idx repeats a block: {idx}")
    if not torch.equal(xm, xm_r):
        raise AssertionError(f"{name}: xm differs from the plain version")
    return err


def rank_limit(keep_frac: float, nb: int, kb: int) -> int:
    """min(kb, round(keep_frac * nb)), the product in f32 and rounded half
    to even, as the kernel and the plain version take it."""
    return min(kb, int(torch.round(torch.tensor(keep_frac) * nb)))


def check_kernel_shapes(K, ref, dev) -> dict:
    """All three kernels on SHAPES + AWKWARD in f32 and bf16:
    ``score_select`` with keep_frac 0.5 and 0.375 under k_frac 0.5 (and
    its mask alone, ``score_mask``), with finite taus."""
    errs = {"score_select": 0.0, "sparse_matmul_shared": 0.0}
    rng = np.random.default_rng(SEED)
    for (B, n, m, blk) in SHAPES + AWKWARD:
        for dtype in (torch.float32, torch.bfloat16):
            x = rng.standard_normal((B, n)).astype(np.float32)
            w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
            g = (np.abs(rng.standard_normal(n)) + 0.1).astype(np.float32)
            xt = torch.from_numpy(x).to(dev, dtype)
            wt = torch.from_numpy(w).to(dev, dtype)
            idx = torch.arange(0, n // blk, 2, dtype=torch.int32, device=dev)
            y = K.sparse_matmul_shared(xt, wt, idx, blk=blk)
            torch.cuda.synchronize()
            assert y.shape == (B, m) and y.dtype == torch.float32
            errs["sparse_matmul_shared"] = max(
                errs["sparse_matmul_shared"], check_close(
                    f"sparse_matmul_shared {B, n, m, blk} {dtype}", y,
                    ref.ref_sparse_matmul_shared(xt, wt, idx, blk)))
            nb = n // blk
            kb = max(1, round(nb * KEEP))
            for alpha, tau in ((0.0, 0.3), (0.7, 0.5), (1.5, 1.0)):
                xs = torch.from_numpy(tie_free(x, g, alpha, tau, dtype)).to(
                    dev, dtype)
                gt = torch.from_numpy(g).to(dev)
                a = torch.tensor(alpha, device=dev)
                t = torch.tensor(tau, device=dev)
                rw = torch.from_numpy(rng.random(B).astype(np.float32)).to(dev)
                xm, bs = K.score_mask(xs, gt, a, t, blk=blk, row_weights=rw)
                torch.cuda.synchronize()
                xm_r, bs_r = ref.ref_score_mask(xs, gt, a, t, blk, rw)
                if not torch.equal(xm, xm_r):
                    raise AssertionError(
                        f"score_mask {B, n, blk} {dtype} a={alpha}: masked x "
                        "differs from the plain version")
                errs["score_select"] = max(errs["score_select"], check_close(
                    f"score_mask {B, n, blk} {dtype}", bs, bs_r))
                for keep in (KEEP, 0.375):
                    kf = torch.tensor(keep, device=dev)
                    name = f"score_select {B, n, blk} {dtype} a={alpha} " \
                        f"keep={keep}"
                    got = K.score_select(xs, gt, a, t, kf, kb=kb, blk=blk,
                                         row_weights=rw)
                    torch.cuda.synchronize()
                    errs["score_select"] = max(
                        errs["score_select"], check_select(
                            name, got, ref.ref_score_select(
                                xs, gt, a, t, kf, blk, kb, rw),
                            rank_limit(keep, nb, kb)))
                    bit_equal(name, lambda: K.score_select(
                        xs, gt, a, t, kf, kb=kb, blk=blk, row_weights=rw))
    errs["sparse_matmul_per_seq"] = 0.0
    for (B, n, m, blk) in SHAPES + AWKWARD:
        nb = n // blk
        kb = max(nb // 2, 1)
        ids = np.stack([(np.arange(kb) + b) % nb for b in range(B)])
        for dtype in (torch.float32, torch.bfloat16):
            x = rng.standard_normal((B, n)).astype(np.float32)
            w = (rng.standard_normal((n, m)) * 0.1).astype(np.float32)
            xt = torch.from_numpy(x).to(dev, dtype)
            wt = torch.from_numpy(w).to(dev, dtype)
            idx = torch.from_numpy(ids.astype(np.int32)).to(dev)
            y = K.sparse_matmul_per_seq(xt, wt, idx, blk=blk)
            torch.cuda.synchronize()
            assert y.shape == (B, m) and y.dtype == torch.float32
            errs["sparse_matmul_per_seq"] = max(
                errs["sparse_matmul_per_seq"], check_close(
                    f"sparse_matmul_per_seq {B, n, m, blk} {dtype}", y,
                    ref.ref_sparse_matmul_per_seq(xt, wt, idx, blk)))
    print(f"kernel shapes: {len(SHAPES + AWKWARD)} shapes x f32/bf16 agree "
          f"(score_select: 3 taus x keep_frac {KEEP}/0.375, two launches "
          f"bit-equal), sparse_matmul_per_seq too (max abs err {errs})")
    return errs


def direct_select(build, x, g, alpha, tau, keep, rw, kb):
    """``fn(i)`` calling ``score_select``'s C entry on outputs allocated
    once here (kernel-only timing)."""
    B, n = x.shape
    xm = torch.empty_like(x)
    idx = torch.empty(kb, dtype=torch.int32, device=x.device)
    bs = torch.empty(n // BLK, device=x.device)
    entry = build.library().wisparse_score_select

    def fn(i):
        launched(entry(x.data_ptr(), g.data_ptr(), alpha.data_ptr(),
                       tau.data_ptr(), keep.data_ptr(), rw.data_ptr(),
                       xm.data_ptr(), idx.data_ptr(), bs.data_ptr(), B, n,
                       BLK, kb, 1,
                       torch.cuda.current_stream().cuda_stream))
    return fn


def main_path_kernels(K, ref, build, dev, rates) -> tuple:
    """The kernels at llama31_8b's projection shapes, bf16.
    ``score_select`` at B = 8 (decode), 32 (one prefill chunk) and 448
    (a whole prompt), alpha 1 and a finite tau (a quarter of the mean
    g, so about a fifth of the channels fall below it), k_frac 0.5 with
    keep_frac 0.5 and 0.375.
    ``sparse_matmul_shared`` at B = 8 and 32 on the kept blocks of
    ``score_select`` (keep_frac 0.5), its weights rotated through copies
    that exceed the 50 MB L2 so each launch reads them cold."""
    rng = np.random.default_rng(SEED + 1)
    rows = []
    errs = {"score_select": 0.0, "sparse_matmul_shared": 0.0}
    for B in (8, 32, 448):
        for role, n, m in LAYER:
            dt = torch.bfloat16
            x = torch.from_numpy(rng.standard_normal((B, n)).astype(
                np.float32)).to(dev, dt)
            w = (torch.randn(n, m, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED)) * 0.02).to(dt)
            g = torch.sqrt((w.float() ** 2).sum(1))
            alpha = torch.tensor(1.0, device=dev)
            tau = 0.25 * g.mean()
            rw = torch.ones(B, device=dev)
            nb = n // BLK
            kb = round(nb * KEEP)
            for keep in (0.375, KEEP):
                kf = torch.tensor(keep, device=dev)
                name = f"score_select {role} B={B} keep={keep}"
                got = K.score_select(x, g, alpha, tau, kf, kb=kb, blk=BLK,
                                     row_weights=rw)
                torch.cuda.synchronize()
                errs["score_select"] = max(errs["score_select"], check_select(
                    name, got, ref.ref_score_select(x, g, alpha, tau, kf, BLK,
                                                    kb, rw),
                    rank_limit(keep, nb, kb)))
                bit_equal(name, lambda: K.score_select(
                    x, g, alpha, tau, kf, kb=kb, blk=BLK, row_weights=rw))
            xk, idx, _ = got                    # keep_frac 0.5
            t_sel = graph_ms(direct_select(build, x, g, alpha, tau, kf, rw,
                                           kb))
            t_sel_plain = graph_ms(lambda i: ref.ref_score_select(
                x, g, alpha, tau, kf, BLK, kb, rw))
            # x read, xm written, g, alpha, tau and keep_frac, the row
            # weights, bs and idx
            sel_bytes = 2 * B * n * 2 + n * 4 + 12 + B * 4 + nb * 4 + kb * 4
            sel_bound, sel_by = bound_ms(sel_bytes, 6.0 * B * n,
                                         torch.float32, rates)
            row = {"B": B, "role": role, "n": n, "m": m, "kb": kb,
                   "score_select": {
                       "ms": t_sel, "plain_ms": t_sel_plain,
                       "library_ms": None, "bound_ms": sel_bound,
                       "bound_by": sel_by}}
            line = (f"  B={B:3d} {role:12s} n={n:5d} m={m:5d} kb={kb:3d} | "
                    f"score_select {t_sel * 1e3:6.2f} us"
                    f" (plain {t_sel_plain * 1e3:7.2f}, bound "
                    f"{sel_bound * 1e3:5.2f} us)")
            if B <= 32:
                y = K.sparse_matmul_shared(xk, w, idx, blk=BLK)
                torch.cuda.synchronize()
                bit_equal(f"sparse_matmul_shared {role} B={B}",
                          lambda: K.sparse_matmul_shared(xk, w, idx, blk=BLK))
                errs["sparse_matmul_shared"] = max(
                    errs["sparse_matmul_shared"], check_close(
                        f"sparse_matmul_shared {role} B={B}", y,
                        ref.ref_sparse_matmul_shared(xk, w, idx, BLK)))
                copies = max(1, math.ceil(200e6 / (n * m * 2)))
                ws = [w] + [w.clone() for _ in range(copies - 1)]
                mm_kernel, plan = direct_matmul(
                    K, build, "sparse_matmul_shared", xk, ws, idx, m, kb,
                    False)
                t_mm = graph_ms(mm_kernel)
                t_mm_plain = graph_ms(lambda i: ref.ref_sparse_matmul_shared(
                    xk, ws[i % copies], idx, BLK))
                t_mm_lib = graph_ms(lambda i: torch.matmul(xk,
                                                           ws[i % copies]))
                del ws
                # the kept x blocks, the kept weight rows, the ids and y
                mm_bytes = (B * kb * BLK * 2 + kb * BLK * m * 2 + kb * 4
                            + B * m * 4)
                mm_bound, mm_by = bound_ms(mm_bytes, 2.0 * B * kb * BLK * m,
                                           dt, rates)
                row["sparse_matmul_shared"] = {
                    "ms": t_mm, "plain_ms": t_mm_plain,
                    "library_ms": t_mm_lib, "bound_ms": mm_bound,
                    "bound_by": mm_by, "splits": plan.splits,
                    "blocks": math.prod(plan.grid)}
                line += (f" | sparse_matmul_shared {t_mm * 1e3:8.2f} us (v1 "
                         f"{V1_US[B, role][0]:7.2f}, plain "
                         f"{t_mm_plain * 1e3:8.2f}, torch.matmul dense "
                         f"{t_mm_lib * 1e3:8.2f}, bound "
                         f"{mm_bound * 1e3:6.2f} = "
                         f"{100 * mm_bound / t_mm:5.1f}%, grid {plan.grid})")
            rows.append(row)
            print(line)
    return rows, errs


def projection_us(ops, dev) -> dict:
    """Device time of one whole ``pallas`` projection
    (``ops.wisparse_project``: bf16, alpha 1, tau -inf, keep_frac and
    k_frac 0.5, unit row weights) against the dense bf16 product it
    replaces, at llama31_8b's 7 projection shapes and B = 8, 32 and 448,
    by CUDA-graph replay with the weights rotated through copies beyond
    L2; and the CUDA kernels one projection launches (``torch.profiler``
    over one warm call at attn/wq, B = 8).  Uses only the public
    signature, so it times any tree's package (``--src``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(SEED + 4)
    out = {"rows": []}
    for B in (8, 32, 448):
        for role, n, m in LAYER:
            x = torch.from_numpy(rng.standard_normal((B, n)).astype(
                np.float32)).to(dev, torch.bfloat16)
            w = (torch.randn(n, m, device=dev) * 0.02).to(torch.bfloat16)
            sp1 = {"g": torch.sqrt((w.float() ** 2).sum(1)),
                   "alpha": torch.tensor(1.0, device=dev),
                   "tau": torch.tensor(float("-inf"), device=dev),
                   "keep_frac": torch.tensor(KEEP, device=dev)}
            rw = torch.ones(B, device=dev)
            if B == 8 and role == "attn/wq":
                ops.wisparse_project(x, w, sp1, block=BLK, k_frac=KEEP,
                                     token_weights=rw)
                torch.cuda.synchronize()
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    ops.wisparse_project(x, w, sp1, block=BLK, k_frac=KEEP,
                                         token_weights=rw)
                    torch.cuda.synchronize()
                kern = [(e.key, e.count) for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA]
                out["launches_per_projection"] = sum(c for _k, c in kern)
                out["launched"] = kern
            copies = max(1, math.ceil(200e6 / (n * m * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            t_proj = graph_ms(lambda i: ops.wisparse_project(
                x, ws[i % copies], sp1, block=BLK, k_frac=KEEP,
                token_weights=rw))
            t_dense = graph_ms(lambda i: x @ ws[i % copies])
            del ws
            out["rows"].append({"B": B, "role": role, "pallas_us": 1e3 * t_proj,
                                "dense_us": 1e3 * t_dense})
    for B in (8, 32, 448):
        per = [r for r in out["rows"] if r["B"] == B]
        out[f"per_layer_B{B}"] = {
            "pallas_us": sum(r["pallas_us"] for r in per),
            "dense_us": sum(r["dense_us"] for r in per)}
    return out


def per_seq_kernel(K, ref, ops, build, dev, rates) -> tuple:
    """``sparse_matmul_per_seq`` at llama31_8b's projection shapes, B = 8
    and B = 32, bf16: each row keeps a distinct random half of the
    blocks, and x is zero outside them, so dense ``torch.matmul`` on the
    same x computes the same function (the library yardstick).  Weights
    rotate through copies that exceed the 50 MB L2.  Then its entry
    point, ``wisparse_project(per_seq=True)``, runs once at every shape
    with the launch counts zeroed just before and read just after, and
    must equal ``per_seq=False`` (in f32).  Returns (rows, max err,
    launches)."""
    rng = np.random.default_rng(SEED + 2)
    rows, err = [], 0.0
    dt = torch.bfloat16
    cases = []
    for B in (8, 32):
        for role, n, m in LAYER:
            nb = n // BLK
            kb = round(nb * KEEP)
            ids_np = np.stack([rng.permutation(nb)[:kb] for _ in range(B)])
            keep = np.zeros((B, nb), bool)
            keep[np.arange(B)[:, None], ids_np] = True
            x = rng.standard_normal((B, n)).astype(np.float32)
            x *= np.repeat(keep, BLK, axis=1)
            xk = torch.from_numpy(x).to(dev, dt)
            w = (torch.randn(n, m, device=dev, generator=torch.Generator(
                device=dev).manual_seed(SEED)) * 0.02).to(dt)
            idx = torch.from_numpy(ids_np.astype(np.int32)).to(dev)
            y = K.sparse_matmul_per_seq(xk, w, idx, blk=BLK)
            torch.cuda.synchronize()
            bit_equal(f"sparse_matmul_per_seq {role} B={B}",
                      lambda: K.sparse_matmul_per_seq(xk, w, idx, blk=BLK))
            err = max(err, check_close(
                f"sparse_matmul_per_seq {role} B={B}", y,
                ref.ref_sparse_matmul_per_seq(xk, w, idx, BLK)))

            copies = max(1, math.ceil(200e6 / (n * m * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            kernel, plan = direct_matmul(K, build, "sparse_matmul_per_seq",
                                         xk, ws, idx, m, kb, True)
            t_k = graph_ms(kernel)
            t_plain = graph_ms(lambda i: ref.ref_sparse_matmul_per_seq(
                xk, ws[i % copies], idx, BLK))
            t_lib = graph_ms(lambda i: torch.matmul(xk, ws[i % copies]))
            del ws
            union = int(keep.any(0).sum())
            # the kept x blocks, the union of kept weight rows, the ids, y
            nbytes = (B * kb * BLK * 2 + union * BLK * m * 2 + B * kb * 4
                      + B * m * 4)
            bms, by = bound_ms(nbytes, 2.0 * B * kb * BLK * m, dt, rates)
            rows.append({"B": B, "role": role, "n": n, "m": m, "kb": kb,
                         "union_blocks": union, "ms": t_k,
                         "plain_ms": t_plain, "library_ms": t_lib,
                         "bound_ms": bms, "bound_by": by,
                         "splits": plan.splits})
            print(f"  B={B:2d} {role:12s} n={n:5d} m={m:5d} kb={kb:3d} "
                  f"union {union:3d} | sparse_matmul_per_seq "
                  f"{t_k * 1e3:8.2f} us (v1 {V1_US[B, role][1]:7.2f}, "
                  f"plain {t_plain * 1e3:8.2f}, torch.matmul dense "
                  f"{t_lib * 1e3:8.2f}, bound {bms * 1e3:6.2f} = "
                  f"{100 * bms / t_k:5.1f}%, grid {plan.grid})")
            g = torch.sqrt((w.float() ** 2).sum(1))
            sp1 = {"g": g, "alpha": torch.tensor(1.0, device=dev),
                   "tau": torch.tensor(float("-inf"), device=dev),
                   "keep_frac": torch.tensor(KEEP, device=dev)}
            # f32, so that the two paths' outputs are not rounded to bf16
            # (one bf16 step is 0.4%, above the tolerance)
            xr = torch.from_numpy(rng.standard_normal((B, n)).astype(
                np.float32)).to(dev)
            cases.append((role, B, xr, w.float(), sp1))

    shared = [ops.wisparse_project(xr, w, sp1, block=BLK, k_frac=KEEP)
              for _r, _B, xr, w, sp1 in cases]
    torch.cuda.synchronize()
    K.reset_launch_counts()
    per_seq = [ops.wisparse_project(xr, w, sp1, block=BLK, k_frac=KEEP,
                                    per_seq=True)
               for _r, _B, xr, w, sp1 in cases]
    torch.cuda.synchronize()
    launches = K.launch_counts["sparse_matmul_per_seq"]
    if launches != len(cases):
        raise AssertionError(f"wisparse_project(per_seq=True) launched "
                             f"sparse_matmul_per_seq {launches} times over "
                             f"{len(cases)} calls")
    for (role, B, *_), a, b in zip(cases, per_seq, shared):
        err = max(err, check_close(
            f"wisparse_project per_seq vs shared {role} B={B}", a, b))
    print(f"wisparse_project(per_seq=True) == per_seq=False at "
          f"{len(cases)} projection shapes; {launches} per-seq launches")
    return rows, err, launches


def wrapper_host_us(K, ops, dev, calls: int = 50, rounds: int = 7) -> dict:
    """Host microseconds per call of each kernel wrapper (and of the whole
    ``pallas`` projection, ``ops.wisparse_project``; ``score_select`` only
    where the tree has it) at llama31_8b's 7
    projection shapes, B = 8, bf16, half of the blocks kept: the time
    until ``calls`` back-to-back calls have returned, without a sync in
    between, over ``calls``; the median of ``rounds`` rounds per shape,
    then the mean over the shapes.  The queue stays far from full, so this
    is the host's cost of a launch, the quantity that sets a decode step
    while the device idles.  Uses only the wrappers' public signatures, so
    it times any tree's package (``--src``)."""
    from repro_torch import obs
    rng = np.random.default_rng(SEED + 3)
    B, dt = 8, torch.bfloat16
    per = {"score_mask": [], "sparse_matmul_shared": [],
           "sparse_matmul_per_seq": [], "wisparse_project": []}
    if hasattr(K, "score_select"):      # absent from trees before it
        per["score_select"] = []
    for _role, n, m in LAYER:
        nb = n // BLK
        kb = round(nb * KEEP)
        x = torch.from_numpy(rng.standard_normal((B, n)).astype(
            np.float32)).to(dev, dt)
        w = (torch.randn(n, m, device=dev) * 0.02).to(dt)
        g = torch.sqrt((w.float() ** 2).sum(1))
        alpha = torch.tensor(1.0, device=dev)
        tau = torch.tensor(float("-inf"), device=dev)
        rw = torch.ones(B, device=dev)
        ids = np.stack([rng.permutation(nb)[:kb] for _ in range(B)])
        idx = torch.from_numpy(ids[0].astype(np.int32)).to(dev)
        idx2 = torch.from_numpy(ids.astype(np.int32)).to(dev)
        sp1 = {"g": g, "alpha": alpha, "tau": tau,
               "keep_frac": torch.tensor(KEEP, device=dev)}
        fns = {
            "score_mask": lambda: K.score_mask(x, g, alpha, tau, blk=BLK,
                                               row_weights=rw),
            "sparse_matmul_shared": lambda: K.sparse_matmul_shared(
                x, w, idx, blk=BLK),
            "sparse_matmul_per_seq": lambda: K.sparse_matmul_per_seq(
                x, w, idx2, blk=BLK),
            "wisparse_project": lambda: ops.wisparse_project(
                x, w, sp1, block=BLK, k_frac=KEEP, token_weights=rw),
            "score_select": lambda: K.score_select(
                x, g, alpha, tau, sp1["keep_frac"], kb=kb, blk=BLK,
                row_weights=rw)}
        for name in per:
            fn = fns[name]
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
            times = []
            for _ in range(rounds):
                t0 = obs.now()
                for _ in range(calls):
                    fn()
                times.append((obs.now() - t0) / calls)
                torch.cuda.synchronize()
            per[name].append(1e6 * float(np.median(times)))
        del w
    return {k: {"mean_us": float(np.mean(v)), "per_shape_us": v}
            for k, v in per.items()}


def layer_summary(rows, ps_rows, proj) -> None:
    """Per decode layer (the 7 projection shapes summed): score_select at
    B = 8, 32 and 448 against its bound and the unfused ``score_mask``;
    each matmul kernel at B = 8 and 32 beside the v1 kernel's time, dense
    ``torch.matmul`` and its bound; the whole ``pallas`` projection
    against dense."""
    for B in (8, 32, 448):
        per = [r["score_select"] for r in rows if r["B"] == B]
        bnd = sum(p["bound_ms"] for p in per)
        print(f"per decode layer B={B:3d} score_select "
              f"{sum(p['ms'] for p in per) * 1e3:7.2f} us (unfused "
              f"score_mask alone at B=8: {SCORE_MASK_UNFUSED_US:.2f}; "
              f"plain {sum(p['plain_ms'] for p in per) * 1e3:8.2f}; bound "
              f"{bnd * 1e3:6.2f} us); whole pallas projection "
              f"{proj[f'per_layer_B{B}']['pallas_us']:8.2f} us, dense "
              f"{proj[f'per_layer_B{B}']['dense_us']:8.2f} us")
    for B in (8, 32):
        sh = [r for r in rows if r["B"] == B]
        ps = [r for r in ps_rows if r["B"] == B]
        for name, per, col in (
                ("sparse_matmul_shared",
                 [r["sparse_matmul_shared"] for r in sh], 0),
                ("sparse_matmul_per_seq", ps, 1)):
            ms = sum(p["ms"] for p in per)
            lib = sum(p["library_ms"] for p in per)
            bnd = sum(p["bound_ms"] for p in per)
            old = sum(V1_US[B, r["role"]][col] for r in sh)
            faster = sum(1e3 * p["ms"] < V1_US[B, r["role"]][col]
                         for p, r in zip(per, sh))
            print(f"per decode layer B={B:2d} {name:22s} {ms * 1e3:8.2f} us "
                  f"(v1 {old:8.2f}; torch.matmul dense {lib * 1e3:7.2f}; "
                  f"bound {bnd * 1e3:7.2f} = {100 * bnd / ms:5.1f}%); faster "
                  f"than v1 at {faster}/{len(per)} shapes")


# ---------------------------------------------------------------------------
# phase 4: reduced model, card against CPU
# ---------------------------------------------------------------------------

def reduced_model_check(dev) -> None:
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.models import api, model as M, params as P
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    cfg = reduced(get_config("llama31_8b"))
    cpu = torch.device("cpu")
    params_c = api.init_model(cfg, SEED, device=cpu)
    sp_c = default_sp_stacked(params_c, cfg, keep_frac=KEEP,
                              tau=float("-inf"))
    params_g = P.tree_map(lambda t: t.to(dev), params_c)
    sp_g = P.tree_map(lambda t: t.to(dev), sp_c)
    pol = SparsityPolicy.uniform("pallas", k_max_frac=KEEP, block=16)
    toks = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, cfg.vocab_size, (2, 24)))
    with torch.no_grad():
        lg, _ = M.forward(params_g, cfg, tokens=toks.to(dev), mode="prefill",
                          sp=sp_g, policy=pol)
        lc, _ = M.forward(params_c, cfg, tokens=toks, mode="prefill",
                          sp=sp_c, policy=pol)
    err = max_err(lg.cpu(), lc)
    if not err <= LOGIT_ATOL:
        raise AssertionError(f"reduced llama logits: card vs CPU err {err}")
    outs = []
    rng = np.random.default_rng(SEED)
    prompts = [rng.integers(0, cfg.vocab_size, p) for p in (20, 9, 33)]
    for d, params, sp in ((dev, params_g, sp_g), (cpu, params_c, sp_c)):
        eng = Engine(params, cfg, EngineConfig(
            max_slots=2, max_len=64, prefill_chunk=16, policy=pol), sp,
            device=d)
        for p in prompts:
            eng.submit(p, 6)
        outs.append(eng.run())
    if outs[0] != outs[1]:
        raise AssertionError(f"reduced llama engine tokens: card {outs[0]} "
                             f"!= CPU {outs[1]}")
    print(f"reduced llama31_8b on the card vs CPU: logits max abs err "
          f"{err:.2e} (<= {LOGIT_ATOL}); engine tokens equal {outs[0]}")


# ---------------------------------------------------------------------------
# phase 5: full-width serving
# ---------------------------------------------------------------------------

def full_width_model(dev):
    """llama31_8b at full width and depth, random weights from SEED."""
    from repro_torch import obs
    from repro_torch.configs import get_config
    from repro_torch.models import api

    cfg = get_config("llama31_8b")
    assert cfg.num_layers == 32 and cfg.d_model == 4096
    t0 = obs.now()
    params = api.init_model(cfg, SEED, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"llama31_8b: {n_params / 1e9:.2f}B params ({cfg.dtype}), init "
          f"{obs.now() - t0:.1f} s, device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.1f} GB")
    return cfg, params


def serving_trace(cfg) -> dict:
    """Phase 5's trace: 12 ragged prompts, 32 new tokens each, 8 slots,
    and an independent count of its sparse prefill chunks (§5.1: chunks
    that start at or past ceil(P/2) run sparse)."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(64, 449, 12)
    prompts = [rng.integers(0, cfg.vocab_size, int(p)) for p in lens]
    ecfg = dict(max_slots=8, max_len=512, prefill_chunk=32)
    C = ecfg["prefill_chunk"]
    sparse_chunks = sum(1 for p in lens for off in range(0, int(p), C)
                        if off >= math.ceil(int(p) * 0.5))
    return {"prompts": prompts, "ecfg": ecfg, "gen": 32,
            "sparse_chunks": sparse_chunks}


def serve_once(name, params, cfg, policy, sp, trace, dev, K, ladder=None,
               slo=None) -> dict:
    """One run of the trace through a fresh ``Engine`` (from ``policy``
    and ``sp``, or from ``ladder`` under ``slo``), with the kernels'
    launch counts zeroed just before the engine is built and read just
    after the run.  The decode step runs as a CUDA graph per rung: the
    wrappers count a kernel once where it is captured, and its replays
    count nothing, so the launches that ran are the counts with each
    captured launch taken once per replay (``DecodeSteps.launches``).
    On a sparse rung they must equal the sparse projections executed:
    224 per decode step, per sparse prefill chunk and per rung's eager
    warm step before its capture; a dense run launches none."""
    from repro_torch import obs
    from repro_torch.serving import Engine, EngineConfig

    gen = trace["gen"]
    K.reset_launch_counts()
    eng = Engine(params, cfg, EngineConfig(policy=policy, slo=slo,
                                           **trace["ecfg"]),
                 sp, device=dev, ladder=ladder)
    for p in trace["prompts"]:
        eng.submit(p, gen)
    t0 = obs.now()
    out, res = drive(eng)
    torch.cuda.synchronize()
    res["wall_s"] = obs.now() - t0
    counts = dict(K.launch_counts)
    g = eng.decode_graphs
    launches = g.launches(counts)
    for rid, toks in out.items():
        if len(toks) != gen or not all(0 <= t < cfg.vocab_size
                                       for t in toks):
            raise AssertionError(f"{name}: request {rid} gave {toks}")
    per_pass = 7 * cfg.num_layers
    served = ("score_select", "sparse_matmul_shared")
    policies = ladder.policies if ladder is not None else [eng.policy]
    sparse = [not p.for_phase("decode").is_dense for p in policies]
    if policy is not None and ladder is None and not policy.is_dense:
        if trace["sparse_chunks"] != res["prefill_sparse_chunks"]:
            raise AssertionError(
                f"{name}: sparse prefill chunks: engine "
                f"{res['prefill_sparse_chunks']} != expected "
                f"{trace['sparse_chunks']}")
    if not any(sparse):
        if any(counts.values()):
            raise AssertionError(f"{name}: dense run launched kernels: "
                                 f"{counts}")
    else:
        steps = sum(n + 1 for n, sp_r, built in zip(
            g.steps, sparse, [g.built(r) for r in range(len(g))])
            if sp_r and built)
        want = per_pass * (steps + res["prefill_sparse_chunks"])
        for k in served:
            for r, sp_r in enumerate(sparse):
                if g.built(r) and g.captured[r][k] != (per_pass if sp_r
                                                       else 0):
                    raise AssertionError(
                        f"{name}: rung {r}'s graph captured "
                        f"{g.captured[r][k]} {k} launches")
            if launches[k] != want:
                raise AssertionError(
                    f"{name}: {k} launched {launches[k]} times, expected "
                    f"{want} = {per_pass} x ({steps} decode steps and warm "
                    f"steps on sparse rungs + "
                    f"{res['prefill_sparse_chunks']} sparse prefill chunks)")
        if launches["sparse_matmul_per_seq"]:
            raise AssertionError(f"{name}: a serving run launched "
                                 "sparse_matmul_per_seq")
        res["launches"] = {k: launches[k] for k in served}
        res["launches_counted"] = {k: counts[k] for k in served}
        res["launches_per_decode_step"] = per_pass
    res["decode_replays"] = list(g.steps)
    res["captures"] = g.builds
    if eng.controller is not None:
        c = eng.controller
        res["transitions"] = list(c.transitions)
        res["residency"] = list(c.residency)
        res["decode_retraces_after_warmup"] = \
            eng.decode_retraces_after_warmup
        res["token_rungs"] = {rid: list(rs.token_rungs)
                              for rid, rs in eng.states.items()}
    res["tokens"] = out
    return res


def _fmt(res: dict) -> str:
    return ", ".join(f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in res.items()
                     if k not in ("tokens", "token_rungs"))


def serve_full_width(dev, K, cfg, params, trace) -> dict:
    """Phase 5: dense and uncalibrated ``pallas``, each twice in the
    order dense, pallas, pallas, dense."""
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.sparsity import SparsityPolicy

    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    modes = {"dense": (SparsityPolicy.dense(), None),
             "pallas": (SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
                        sp)}
    # warm both paths (cuBLAS handles, allocator) outside the measured runs
    for pol, s in modes.values():
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        eng.submit(trace["prompts"][0][:40], 2)
        eng.run()

    # each mode runs twice, in the order dense, pallas, pallas, dense, so
    # the spread between a mode's two runs shows the host's variance
    # within one call with the code held fixed
    runs = {"dense": [], "pallas": []}
    for name in ("dense", "pallas", "pallas", "dense"):
        pol, s = modes[name]
        res = serve_once(name, params, cfg, pol, s, trace, dev, K)
        if runs[name] and res["tokens"] != runs[name][0]["tokens"]:
            raise AssertionError(f"{name}: the second run's greedy tokens "
                                 "differ from the first's")
        runs[name].append(res)
        print(f"{name:6s} run {len(runs[name])}: {_fmt(res)}")
    for name, rs in runs.items():
        p50 = [r["decode_step_p50_ms"] for r in rs]
        print(f"{name:6s}: decode step p50 {p50[0]:.2f} / {p50[1]:.2f} ms in "
              f"its two runs (spread {100 * (max(p50) / min(p50) - 1):.1f}%); "
              "greedy tokens equal across the two runs")
    print(f"greedy tokens equal to dense at the same position: "
          f"{agreement(runs['dense'][0], runs['pallas'][0]):.3f} "
          "(random weights; informative only)")
    return runs


def agreement(a: dict, b: dict) -> float:
    return float(np.mean([x == y for rid in a["tokens"]
                          for x, y in zip(a["tokens"][rid],
                                          b["tokens"][rid])]))


# ---------------------------------------------------------------------------
# phase 6: full-width calibration
# ---------------------------------------------------------------------------

LADDER_BUDGETS = (0.0, 0.5, 0.7)


def _sp_scalars(cfg, sp, key: str) -> dict:
    """{(depth, path): the sp leaf scalar ``key``} of a stacked sp tree."""
    from repro_torch.core import unstacked as U
    from repro_torch.obs.quality import unstack_sp
    out = {}
    for d, spd in enumerate(unstack_sp(cfg, sp)):
        for path in _leaf_paths(spd):
            out[(d, path)] = float(U.get_sp_leaf(spd, path)[key])
    return out


def _leaf_paths(node, prefix=""):
    for k in sorted(node):
        if "g" in node[k]:
            yield prefix + k
        else:
            yield from _leaf_paths(node[k], prefix + k + "/")


def calibrate_full_width(cfg, params):
    """WiSparse Alg. 1-4 on the full-width model as a ``pallas`` policy
    ladder (``sparsity.calibrate_ladder``) at budgets 0.0 (dense), 0.5
    (the cold search) and 0.7 (warm-started from the 0.5 rung), with the
    serve CLI's ``--calib-quick`` budget, on 4 x 128 synthetic tokens,
    with the v4 quality baselines.  Prints each rung's stage wall times;
    checks the 0.5 rung as one plan (budget, finite thresholds, KL
    beside the activation-only plan's) and the ladder's monotonicity.
    Returns (ladder, info)."""
    from repro_torch import obs
    from repro_torch.core import calibration, pipeline
    from repro_torch.core.allocation import EvoConfig, weighted_average
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.obs.quality import unstack_sp
    from repro_torch.sparsity import calibrate_ladder

    evo = EvoConfig(generations=2, offspring=4, eps=0.1)
    toks = SyntheticLM(DataConfig(cfg.vocab_size, 128, 4)).batch(0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    marks = [("context", obs.now())]

    def log(msg):
        torch.cuda.synchronize()
        print(f"  [{obs.now() - marks[0][1]:7.1f} s] {msg}")
        for stage, text in (("coarse (Alg. 3)", "coarse search"),
                            ("fine (Alg. 4)", "fine search"),
                            ("alpha (Alg. 2)", "alpha search:"),
                            ("rung", "rung "),
                            ("baselines", "recording quality baselines")):
            if msg.startswith(text):
                label = msg.split(":")[0] if stage == "rung" else stage
                marks.append((label, obs.now()))

    ctx = calibration.build_context(params, cfg, {"tokens": toks})
    torch.cuda.synchronize()
    log(f"calibration context: {len(ctx.acts)} linears captured over "
        f"{toks.size} tokens")
    ladder = calibrate_ladder(params, cfg, None, LADDER_BUDGETS,
                              backend="pallas", evo=evo, delta=0.25,
                              coord_passes=0, ctx=ctx, log=log)
    torch.cuda.synchronize()
    marks.append(("end", obs.now()))
    peak = torch.cuda.max_memory_allocated() - base
    # wall time of each stage, and of each rung from its own mark to the
    # next rung's (or the baselines')
    stages, rung_s, rung = [], {}, None
    for (label, t), (_next, t1) in zip(marks, marks[1:]):
        if label.startswith("rung "):
            rung = label
            rung_s[rung] = 0.0
        elif rung is not None and label != "baselines":
            stages.append((f"{rung} {label}", t1 - t))
        if rung is not None and label != "baselines":
            rung_s[rung] += t1 - t
        if label in ("context", "baselines"):
            stages.append((label, t1 - t))
    total = marks[-1][1] - marks[0][1]
    print("ladder calibration wall times (s): " + ", ".join(
        f"{k} {v:.2f}" for k, v in stages) + f"; total {total:.2f}")
    print("per rung (s): " + ", ".join(f"{k} {v:.2f}"
                                       for k, v in rung_s.items()))

    # the 0.5 rung is the cold search: check it as one calibrated plan
    p_target = LADDER_BUDGETS[1]
    ratios = np.asarray(ladder.block_ratios[1])
    keep = _sp_scalars(cfg, ladder.sps[1], "keep_frac")
    taus = _sp_scalars(cfg, ladder.sps[1], "tau")
    alphas = _sp_scalars(cfg, ladder.sps[1], "alpha")
    kl = ctx.fitness(unstack_sp(cfg, ladder.sps[1]))
    act = pipeline.activation_only_plan(params, cfg, None, p_target, ctx=ctx)
    kl_act = ctx.fitness(act.per_depth_sp)
    print(f"rung 1 block ratios: {[round(float(x), 4) for x in ratios]}")
    print(f"rung 2 block ratios: "
          f"{[round(float(x), 4) for x in ladder.block_ratios[2]]}")
    print(f"mean alpha {np.mean(list(alphas.values())):.4f}; device memory "
          f"peak above the model {peak / 1e9:.2f} GB (total "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB)")
    print(f"KL (Eq. 8) on the calibration tokens: rung 1 {kl:.6g}, "
          f"activation-only plan {kl_act:.6g} (random weights; "
          "informative only)")
    print(f"quality baselines: recon per rung (mean over blocks) "
          f"{[float(np.mean(r)) for r in ladder.baselines['recon']]}")
    avg = weighted_average(ctx, ratios)
    if not p_target - evo.eps <= avg <= p_target + 1e-9:
        raise AssertionError(f"size-weighted block ratio {avg} is outside "
                             f"[{p_target - evo.eps}, {p_target}]")
    bad = [k for k, t in taus.items() if keep[k] < 1.0
           and not math.isfinite(t)]
    if bad:
        raise AssertionError(f"non-finite taus of sparsified linears: {bad}")
    if len(taus) != 7 * cfg.num_layers:
        raise AssertionError(f"{len(taus)} taus, expected "
                             f"{7 * cfg.num_layers}")
    for lo, hi in zip(ladder.block_ratios, ladder.block_ratios[1:]):
        if not np.all(np.asarray(hi) >= np.asarray(lo) - 1e-9):
            raise AssertionError("ladder block ratios are not monotone")
    avg2 = weighted_average(ctx, np.asarray(ladder.block_ratios[2]))
    if not LADDER_BUDGETS[2] - evo.eps <= avg2 <= LADDER_BUDGETS[2] + 1e-9:
        raise AssertionError(f"rung 2's size-weighted block ratio {avg2} "
                             f"is outside its budget")
    print(f"budget: rung 1's size-weighted block ratio {avg:.6f} in "
          f"[{p_target - evo.eps}, {p_target}], rung 2's {avg2:.6f}; every "
          "tau of a sparsified linear is finite; the ladder is monotone "
          "per block")
    info = {"stages_s": dict(stages), "rungs_s": rung_s, "total_s": total,
            "peak_gb": peak / 1e9, "kl": kl, "kl_activation_only": kl_act,
            "weighted_ratio": avg, "weighted_ratio_rung2": avg2}
    del ctx, act
    torch.cuda.empty_cache()
    return ladder, info


# ---------------------------------------------------------------------------
# phase 7: serve the calibrated plan from its artifact
# ---------------------------------------------------------------------------

def serve_calibrated(dev, K, cfg, params, trace, ladder, runs) -> dict:
    """Phase 7: the ladder's 0.5 rung as one calibrated plan, saved as a
    ``pallas`` policy artifact, loaded back and served once."""
    from repro_torch.sparsity import SparsityPolicy

    policy, plan_sp = ladder.rung(1)
    out_dir = os.path.join(HERE, "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "calibrated_plan.npz")
    policy.save(path, sp=plan_sp)
    loaded, sp = SparsityPolicy.load(path, device=dev)
    if loaded != policy:
        raise AssertionError(f"artifact policy {loaded} != saved {policy}")
    got, want = list(_leaves(sp)), list(_leaves(plan_sp))
    if len(got) != len(want) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError("artifact sp tree differs from the plan's")
    print(f"artifact {os.path.relpath(path, HERE)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB): policy "
          f"{loaded.to_dict()}")
    res = serve_once("calibrated", params, cfg, loaded, sp, trace, dev, K)
    print(f"calibrated pallas run: {_fmt(res)}")
    keys = ("decode_tok_s", "decode_step_p50_ms", "decode_step_p95_ms",
            "ttft_p50_ms", "decode_device_busy")
    for name, r in [("dense 1", runs["dense"][0]),
                    ("dense 2", runs["dense"][1]),
                    ("pallas 1 (uncalibrated)", runs["pallas"][0]),
                    ("calibrated", res)]:
        print(f"  {name:24s} " + ", ".join(f"{k} {r[k]:.4g}" for k in keys))
    print(f"calibrated greedy tokens equal to dense at the same position: "
          f"{agreement(runs['dense'][0], res):.3f} (random weights; "
          "informative only)")
    return res


# ---------------------------------------------------------------------------
# phase 8: serve the calibrated ladder under the SLO controller
# ---------------------------------------------------------------------------

def serve_ladder(dev, K, cfg, params, trace, ladder) -> list:
    """Save the ladder as a v4 artifact under ``build/``, load it back
    and serve phase 5's trace from it twice under
    ``SLOConfig(tpot_p95=1e6, max_queue=2, dwell=2, hysteresis=0.25)``:
    the TPOT target is out of reach, so the controller acts on queue
    depth alone and both runs must make the same transitions and tokens.
    Each run must visit at least two rungs, escalate ("queue") and come
    back down ("idle"), build no decode step after warmup, attribute
    every token to a rung, and launch the kernels as ``serve_once``
    checks."""
    from repro_torch.serving import SLOConfig
    from repro_torch.sparsity import PolicyLadder

    path = os.path.join(HERE, "build", "chip_smoke", "ladder.npz")
    ladder.save(path)
    loaded = PolicyLadder.load(path, device=dev)
    if loaded.budgets != ladder.budgets or loaded.policies != \
            ladder.policies:
        raise AssertionError("ladder artifact: budgets or policies differ")
    for a, b in zip(loaded.sps, ladder.sps):
        ga, gb = list(_leaves(a)), list(_leaves(b))
        if len(ga) != len(gb) or not all(torch.equal(x, y)
                                         for x, y in zip(ga, gb)):
            raise AssertionError("ladder artifact: sp trees differ")
    if not np.array_equal(loaded.baselines["recon"],
                          ladder.baselines["recon"]) or not all(
            np.array_equal(x, y)
            for ra, rb in zip(loaded.baselines["channels"],
                              ladder.baselines["channels"])
            for x, y in zip(ra, rb)):
        raise AssertionError("ladder artifact: quality baselines differ")
    print(f"ladder artifact {os.path.relpath(path, HERE)} "
          f"({os.path.getsize(path) / 1e6:.1f} MB, v4 with baselines): "
          f"budgets {list(loaded.budgets)}, policies "
          f"{[p.backend for p in loaded.policies]}")
    slo = SLOConfig(tpot_p95=1e6, max_queue=2, dwell=2, hysteresis=0.25)
    runs = []
    for i in range(2):
        res = serve_once(f"ladder {i + 1}", params, cfg, None, None, trace,
                         dev, K, ladder=loaded, slo=slo)
        reasons = {t[3] for t in res["transitions"]}
        visited = sum(1 for r in res["residency"] if r > 0)
        if visited < 2 or not {"queue", "idle"} <= reasons:
            raise AssertionError(
                f"ladder run {i + 1}: visited {visited} rungs, transitions "
                f"{res['transitions']}")
        if res["decode_retraces_after_warmup"] != 0:
            raise AssertionError(
                f"ladder run {i + 1}: {res['decode_retraces_after_warmup']} "
                "decode builds after warmup")
        if res["captures"] != len(loaded):
            raise AssertionError(f"ladder run {i + 1}: {res['captures']} "
                                 "captures")
        for rid, toks in res["tokens"].items():
            if len(res["token_rungs"][rid]) != len(toks):
                raise AssertionError(
                    f"ladder run {i + 1}: request {rid} has "
                    f"{len(res['token_rungs'][rid])} token rungs for "
                    f"{len(toks)} tokens")
        if runs and (res["tokens"] != runs[0]["tokens"]
                     or res["transitions"] != runs[0]["transitions"]
                     or res["token_rungs"] != runs[0]["token_rungs"]):
            raise AssertionError("the two ladder runs differ in tokens, "
                                 "token rungs or transitions")
        total = sum(res["residency"])
        res["residency_share"] = [r / total for r in res["residency"]]
        runs.append(res)
        print(f"ladder run {i + 1}: {_fmt(res)}")
    print(f"ladder: {len(runs[0]['transitions'])} transitions "
          f"{runs[0]['transitions']}; residency per rung "
          f"{runs[0]['residency']}; decode_retraces_after_warmup 0; "
          "tokens, token rungs and transitions equal across the two runs")
    return runs


# ---------------------------------------------------------------------------
# phase 9: the captured decode step against the eager one
# ---------------------------------------------------------------------------

def graph_vs_eager(dev, cfg, params, trace, steps: int = 8) -> dict:
    """At full width, B = 8, dense and uncalibrated ``pallas``: 8 requests
    (the trace's first 8 prompts, cut to 64 tokens) prefilled, then at
    each of ``steps`` decode steps the eager step and the graph replay on
    the same inputs (the eager step writes the new K/V first, the replay
    the same values again).  Greedy tokens must be equal; prints the
    logits' max abs error and, per step, the host time until the argmax
    is on the host and the CUDA-event span of the step (the device's
    timeline from the step's first kernel to its last)."""
    from repro_torch import obs
    from repro_torch.core.sp_schema import default_sp_stacked
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.metrics import percentile
    from repro_torch.sparsity import SparsityPolicy

    sp = default_sp_stacked(params, cfg, keep_frac=KEEP, tau=float("-inf"))
    out = {}
    for name, pol, s in (
            ("dense", SparsityPolicy.dense(), None),
            ("pallas", SparsityPolicy.uniform("pallas", k_max_frac=KEEP),
             sp)):
        eng = Engine(params, cfg, EngineConfig(policy=pol, **trace["ecfg"]),
                     s, device=dev)
        for p in trace["prompts"][:8]:
            eng.submit(p[:64], 64)
        while eng.scheduler.prefilling or eng.scheduler.has_queued():
            eng.step()
        g = eng.decode_graphs
        err, times = 0.0, {"eager": [], "graph": []}
        for _ in range(steps):
            tokens, positions, active = eng.decode_inputs()
            if active.sum() != 8:
                raise AssertionError(f"{name}: {active.sum()} active slots")
            res = {}
            for kind in ("eager", "graph"):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = obs.now()
                start.record()
                if kind == "eager":
                    logits = g.eager(0, tokens, positions, active)
                    nxt = torch.argmax(logits, -1).cpu().numpy()
                else:
                    nxt, logits = g(0, tokens, positions, active)
                end.record()
                t1 = obs.now()
                torch.cuda.synchronize()
                times[kind].append((1e3 * (t1 - t0),
                                    start.elapsed_time(end)))
                res[kind] = (nxt, logits.float().clone())
            if not np.array_equal(res["eager"][0], res["graph"][0]):
                raise AssertionError(f"{name}: graph replay tokens "
                                     f"{res['graph'][0]} != eager "
                                     f"{res['eager'][0]}")
            err = max(err, max_err(res["graph"][1], res["eager"][1]))
            eng.step()                 # one real step (a replay) onward
        row = {"logits_max_abs_err": err}
        for kind, ts in times.items():
            row[f"{kind}_host_ms_p50"] = percentile([h for h, _ in ts], 50)
            row[f"{kind}_span_ms_p50"] = percentile([d for _, d in ts], 50)
        out[name] = row
        print(f"graph vs eager, {name}, B=8, {steps} steps: greedy tokens "
              f"equal; logits max abs err {err:.3g}; host ms per step "
              f"eager {row['eager_host_ms_p50']:.2f} / graph "
              f"{row['graph_host_ms_p50']:.2f}; event span ms eager "
              f"{row['eager_span_ms_p50']:.2f} / graph "
              f"{row['graph_span_ms_p50']:.2f} (p50)")
        del eng
    return out


def drive(eng, window: int = WINDOW) -> tuple:
    """Run ``eng`` to the end, one step at a time, and measure its steps.

    The first ``window`` decode steps of the pure-decode tail (every
    request admitted and prefilled, the longest needing at least
    ``window`` more steps) run under ``torch.profiler`` tracing the card
    only.  Their device time (kernels and copies) over their own wall
    time is the device busy share; tracing adds host time to those
    steps, so the share is also given against the unprofiled p50.  The
    headline metrics (decode tok/s, step p50/p95) come from the other
    decode steps, which run unprofiled."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.metrics import percentile
    sched = eng.scheduler
    steps = []          # (kind, tokens emitted, wall s, profiled)
    prof, profiled, device_us = None, 0, 0.0
    while sched.has_work():
        if (prof is None and not profiled and not sched.has_queued()
                and not sched.prefilling and sched.decoding
                and max(rs.request.max_new_tokens - len(rs.tokens)
                        for rs in sched.decoding.values()) >= window):
            prof = profile(activities=[ProfilerActivity.CUDA])
            prof.start()
        emitted = len(sched.decoding)
        before = eng.stats.decode_time      # the engine's own step clock
        kind = eng.step()
        if kind == "decode":
            steps.append((kind, emitted, eng.stats.decode_time - before,
                          prof is not None))
        elif prof is not None:
            raise AssertionError(f"a {kind} step in the profiled window")
        if prof is not None and kind == "decode":
            profiled += 1
            if profiled == window:
                torch.cuda.synchronize()
                prof.stop()
                device_us = sum(
                    e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA)
                prof = None
    if profiled != window:
        raise AssertionError(f"profiled {profiled} decode steps, wanted "
                             f"{window}")
    if not device_us > 0:
        raise AssertionError("torch.profiler recorded no device time")
    st = eng.stats
    plain = [(n, w) for _k, n, w, pr in steps if not pr]
    win = [w for _k, _n, w, pr in steps if pr]
    walls = [w for _n, w in plain]
    return ({rid: rs.tokens for rid, rs in eng.states.items()}, {
        "decode_tok_s": sum(n for n, _w in plain) / sum(walls),
        "decode_step_p50_ms": 1e3 * percentile(walls, 50),
        "decode_step_p95_ms": 1e3 * percentile(walls, 95),
        "ttft_p50_ms": 1e3 * percentile(st.ttft_s, 50),
        "prefill_chunk_p50_ms": 1e3 * percentile(st.prefill_step_s, 50),
        "decode_steps": st.decode_steps,
        "prefill_chunks": st.prefill_chunks,
        "prefill_sparse_chunks": st.prefill_sparse_chunks,
        "generated_tokens": sum(len(rs.tokens) for rs in eng.states.values()),
        "window_steps": len(win),
        "window_step_wall_ms": 1e3 * sum(win) / len(win),
        "window_step_device_ms": device_us / 1e3 / len(win),
        "decode_device_busy": device_us / 1e6 / sum(win),
        # the profiler lengthens the window's steps on the host; against
        # the same run's unprofiled p50 the share is larger
        "device_ms_over_p50": device_us / 1e3 / len(win) / (
            1e3 * percentile(walls, 50)),
    })


def _leaves(tree):
    """The tensors of a nested dict/list tree, dict keys in sorted order
    (so two trees built in different key orders line up)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    elif tree is not None:
        yield tree


def gather_backends_us(dev) -> dict:
    """Device time of one ``topk_shared`` and one ``topk_block``
    projection (``core/sparse_linear.project``: plain PyTorch backends
    with no kernel of their own; bf16, alpha 1, tau -inf, keep_frac and
    k_max_frac 0.5, unit token weights) at llama31_8b's 7 projection
    shapes, B = 8, by CUDA-graph replay with the weights rotated through
    copies beyond L2.  Uses only the public signature, so it times any
    tree's package (``--src``)."""
    from repro_torch.core import sparse_linear
    from repro_torch.sparsity import SparsityPolicy
    rng = np.random.default_rng(SEED + 5)
    out = {}
    for backend in ("topk_shared", "topk_block"):
        pol = SparsityPolicy.uniform(backend, k_max_frac=KEEP, block=BLK)
        per = []
        for _role, n, m in LAYER:
            x = torch.from_numpy(rng.standard_normal((8, n)).astype(
                np.float32)).to(dev, torch.bfloat16)
            w = (torch.randn(n, m, device=dev) * 0.02).to(torch.bfloat16)
            sp1 = {"g": torch.sqrt((w.float() ** 2).sum(1)),
                   "alpha": torch.tensor(1.0, device=dev),
                   "tau": torch.tensor(float("-inf"), device=dev),
                   "keep_frac": torch.tensor(KEEP, device=dev)}
            rw = torch.ones(8, device=dev)
            copies = max(1, math.ceil(200e6 / (n * m * 2)))
            ws = [w] + [w.clone() for _ in range(copies - 1)]
            per.append(1e3 * graph_ms(lambda i: sparse_linear.project(
                x, ws[i % copies], sp1, policy=pol, token_weights=rw)))
            del ws
        out[backend] = {"per_layer_us": sum(per), "per_shape_us": per}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host-only", action="store_true",
                    help="build the kernels, print the wrappers' host time "
                         "per call, the pallas projection's device time per "
                         "shape and the gather backends' device time as "
                         "JSON lines, and stop")
    ap.add_argument("--src", default=os.path.join(HERE, "src"),
                    help="directory holding the repro_torch package (for "
                         "--host-only against another tree)")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.src))
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: chip_smoke.py needs a "
              "CUDA card", file=sys.stderr)
        return 2
    smi = nvidia_smi()
    print(smi)
    from repro_torch import obs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import sparse_matmul as K

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    rates = peak_rates(name)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}")

    t_start = t0 = obs.now()
    build.library()
    print(f"kernels built in {obs.now() - t0:.1f} s\n{build.build_log()}")
    host = wrapper_host_us(K, ops, dev)
    print(json.dumps({"wrapper_host_us": host, "src": args.src}))
    proj = projection_us(ops, dev)
    print(json.dumps({"projection": proj, "src": args.src}))
    print(f"one pallas projection launches {proj['launches_per_projection']} "
          f"CUDA kernels: {proj['launched']}")
    print(json.dumps({"gather_backends": gather_backends_us(dev),
                      "src": args.src}))
    if args.host_only:
        return 0
    if proj["launches_per_projection"] != 3:
        raise AssertionError("a pallas projection should launch 3 kernels "
                             "(score_select, the matmul, the cast)")

    errs = check_kernel_shapes(K, ref, dev)
    rows, errs2 = main_path_kernels(K, ref, build, dev, rates)
    ps_rows, ps_err, ps_launches = per_seq_kernel(K, ref, ops, build, dev,
                                                  rates)
    layer_summary(rows, ps_rows, proj)
    reduced_model_check(dev)
    cfg, params = full_width_model(dev)
    trace = serving_trace(cfg)
    results = serve_full_width(dev, K, cfg, params, trace)
    ladder, calib = calibrate_full_width(cfg, params)
    calibrated = serve_calibrated(dev, K, cfg, params, trace, ladder,
                                  results)
    ladder_runs = serve_ladder(dev, K, cfg, params, trace, ladder)
    gve = graph_vs_eager(dev, cfg, params, trace)
    keep = ("tokens", "token_rungs")
    print(json.dumps({"serving": {
        "runs": {f"{n} {i + 1}": {k: v for k, v in r.items()
                                  if k not in keep}
                 for n, rs in [*results.items(), ("ladder", ladder_runs)]
                 for i, r in enumerate(rs)},
        "calibrated": {k: v for k, v in calibrated.items() if k not in keep},
        "calibration": calib, "graph_vs_eager": gve}}))

    decode_rows = [r for r in rows if r["B"] == 8]
    kernels = []
    for kname, src, line in (("score_select", "score_select.cu", 319),
                             ("sparse_matmul_shared",
                              "sparse_matmul_shared.cu", 211)):
        per = [r[kname] for r in decode_rows]
        lib = [p["library_ms"] for p in per]
        kernels.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/sparse_matmul.py:{line}",
            "launches": results["pallas"][0]["launches"][kname],
            "max_abs_err": max(errs[kname], errs2[kname]),
            # one decode layer's 7 projections at B = 8, summed
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": sum(p["bound_ms"] for p in per),
            "bound_by": ("bytes" if all(p["bound_by"] == "bytes"
                                         for p in per) else "operations"),
            "library_ms": None if lib[0] is None else sum(lib),
        })
    per = [r for r in ps_rows if r["B"] == 8]
    kernels.append({
        "name": "sparse_matmul_per_seq", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sparse_matmul_per_seq.cu",
        "replaces": "src/repro/kernels/sparse_matmul.py:266",
        "launches": ps_launches,
        "max_abs_err": max(errs["sparse_matmul_per_seq"], ps_err),
        "ms": sum(p["ms"] for p in per),
        "plain_ms": sum(p["plain_ms"] for p in per),
        "bound_ms": sum(p["bound_ms"] for p in per),
        "bound_by": ("bytes" if all(p["bound_by"] == "bytes" for p in per)
                     else "operations"),
        "library_ms": sum(p["library_ms"] for p in per),
    })
    print(f"chip_smoke.py phases took {obs.now() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
