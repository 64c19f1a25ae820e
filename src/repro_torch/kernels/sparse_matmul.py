"""Wrappers for the WiSparse Hopper kernels (port of the JAX package's
``kernels/sparse_matmul.py``).

``score_select`` (with ``score_mask``, the same kernel without the
selection), ``sparse_matmul_shared`` and ``sparse_matmul_per_seq`` take
the route by the device of the tensors they are given: a CUDA tensor
launches the CUDA kernel in ``csrc/`` (built at first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor runs the
plain PyTorch version in :mod:`repro_torch.kernels.ref`.  There is no
fallback from one to the other.  Each wrapper adds one to
:data:`launch_counts` where it launches its kernel, and nowhere else, so
a run can show that it went through the kernels.

The kernels launch on PyTorch's current stream, do not synchronise, and
allocate nothing: the wrappers allocate outputs with ``torch.empty`` and
keep the matmuls' split-K scratch per device (:func:`matmul_scratch`).  The TPU tile geometry of
``shared_plan``/``score_mask_plan`` does not carry over (Hopper runs its
own tiles, masked at ragged edges in the kernels, and chosen by
:func:`launch_plan`); what the port keeps is the channel-block contract,
checked here: ``n % blk == 0``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import math

import torch

from repro_torch.kernels import build, ref

DEFAULT_BLK = 128

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {"score_select": 0, "sparse_matmul_shared": 0,
                 "sparse_matmul_per_seq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Geometry of the block-gather matmul kernels (csrc/gather_mma.cuh).  The
# plan below owns it and passes it to the C entries, which refuse a column
# tile other than the one they are compiled for (256 bytes of a weight
# row) and a per-seq slice of more than MAX_SLICE_BLOCKS block ids.  The
# split count aims at a number of thread blocks per launch (one per SM of
# an H100 for the shared kernel's deeper stages, two for per-seq) and stays
# at or below MAX_SPLITS: the last block of a column tile sums the S
# partial tiles alone, which at S = 32 cost more than the extra blocks
# gained.  PERF.md holds the variants measured against these choices.
TILE_COLS = {2: 128, 4: 64}          # element bytes -> columns per tile
MAX_SLICE_BLOCKS = 128
TARGET_BLOCKS_SHARED = 132
TARGET_BLOCKS_PER_SEQ = 2 * 132
MAX_SPLITS = 16


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """Grid and scratch of one block-gather matmul launch.

    The grid is (tiles_m, splits, tiles_b); ``workspace`` f32 values of
    split-K partials and ``counters`` int32 arrival counters are needed
    when ``splits > 1`` (both 0 otherwise)."""
    rows: int          # batch rows per thread block
    cols: int          # columns per thread block
    tiles_m: int
    tiles_b: int
    splits: int
    units: int         # kb positions (shared) or nb block ids (per-seq)
    workspace: int
    counters: int

    @property
    def grid(self):
        return (self.tiles_m, self.splits, self.tiles_b)

    def slice(self, s: int) -> range:
        """Positions of idx (shared) or block ids (per-seq) of slice s."""
        return range(s * self.units // self.splits,
                     (s + 1) * self.units // self.splits)


@functools.lru_cache(maxsize=1024)
def launch_plan(B: int, n: int, m: int, kb: int, blk: int, per_seq: bool,
                elem_bytes: int = 2) -> LaunchPlan:
    """Split-K plan of ``sparse_matmul_shared`` (slices of the kb
    positions of idx) or ``sparse_matmul_per_seq`` (slices of the n/blk
    block ids), from the shapes alone: no device read.  Cached per shape
    (a decode step asks for the same few plans 224 times)."""
    nb = n // blk
    rows = 8 if B <= 8 else 16 if B <= 16 else 32
    cols = TILE_COLS[elem_bytes]
    tiles_m = math.ceil(m / cols)
    tiles_b = math.ceil(B / rows)
    units = nb if per_seq else kb
    target = TARGET_BLOCKS_PER_SEQ if per_seq else TARGET_BLOCKS_SHARED
    splits = max(1, min(units, MAX_SPLITS,
                        round(target / (tiles_m * tiles_b))))
    if per_seq:
        splits = max(splits, math.ceil(nb / MAX_SLICE_BLOCKS))
    split = splits > 1
    return LaunchPlan(rows, cols, tiles_m, tiles_b, splits, units,
                      splits * B * m if split else 0,
                      tiles_m * tiles_b if split else 0)


# device -> (f32 workspace, zeroed int32 arrival counters) shared by the
# matmul launches of that device, grown on demand.  Each launch leaves the
# counters zero, and a later launch on the same stream reuses both only
# after the earlier one has finished.  Launches on one device that overlap
# in time (two streams) must not share them: the port launches on one
# stream.  A captured CUDA graph keeps the pointers it saw, so a capture
# must follow the largest plan's first launch.
_scratch: dict = {}


def matmul_scratch(plan: LaunchPlan, device):
    """(workspace, counters) for ``plan`` on ``device``: the device's f32
    workspace (at least ``plan.workspace`` values) and zeroed int32
    counters (at least ``plan.counters``), or (None, None) for one slice.
    Allocates only when a plan needs more than any before it."""
    if plan.splits == 1:
        return None, None
    ws, cnt = _scratch.get(device, (None, None))
    if ws is None or ws.numel() < plan.workspace:
        ws = torch.empty(max(1 << 20, plan.workspace), dtype=torch.float32,
                         device=device)
    if cnt is None or cnt.numel() < plan.counters:
        cnt = torch.zeros(max(4096, plan.counters), dtype=torch.int32,
                          device=device)
    _scratch[device] = ws, cnt
    return ws, cnt


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(device: torch.device) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")


def score_select(x, g, alpha, tau, keep_frac, *, kb: int,
                 blk: int = DEFAULT_BLK, row_weights=None):
    """Returns (xm (B,n) in x.dtype, idx (kb,) int32, bs (n//blk,) f32):
    Eq. 4/5 scoring and per-block score sums (as :func:`score_mask`),
    the top ``kb`` blocks by ``bs`` (largest first, the lower id first
    among equal sums: ``jax.lax.top_k``'s order), and x zeroed outside
    the blocks ranked below ``min(kb, round(keep_frac * n/blk))``.

    ``alpha``, ``tau`` and ``keep_frac`` are one-element f32 tensors on
    x's device (the sp tree's own; the kernel reads them where they lie,
    so no host sync), or floats, which are copied to the device;
    ``row_weights`` (B,) optionally weights each row's block-score
    contribution (the engine's active-slot / real-token mask)."""
    B, n = x.shape
    blk = min(blk, n)
    if n % blk:
        raise ValueError(f"channel dim {n} is not a multiple of blk {blk}")
    if not 1 <= kb <= n // blk:
        raise ValueError(f"kb {kb} outside [1, {n // blk}]")
    if x.device.type == "cpu":
        return ref.ref_score_select(x, g, alpha, tau, keep_frac, blk, kb,
                                    row_weights)
    if not x.is_cuda:
        raise ValueError(f"score_select: unsupported device {x.device}")
    return _launch_score(x, g, alpha, tau, keep_frac, blk, kb, row_weights)


def score_mask(x, g, alpha, tau, *, blk: int = DEFAULT_BLK, row_weights=None):
    """Returns (x_masked (B,n) in x.dtype, block_scores (n//blk,) f32) —
    Eq. 4/5 fused, no block selection: the ``score_select`` kernel with
    no rank limit (it counts as a ``score_select`` launch)."""
    B, n = x.shape
    blk = min(blk, n)
    _check(n % blk == 0, f"channel dim {n} is not a multiple of blk {blk}")
    if x.device.type == "cpu":
        return ref.ref_score_mask(x, g, alpha, tau, blk, row_weights)
    _check(x.is_cuda, f"score_mask: unsupported device {x.device}")
    xm, _, bs = _launch_score(x, g, alpha, tau, None, blk, n // blk,
                              row_weights)
    return xm, bs


def _f32_scalar(v, device, what: str):
    """``v`` as a one-element f32 tensor on ``device``; the sp tree's own
    scalars pass through as they are."""
    if not (isinstance(v, torch.Tensor) and v.dtype == torch.float32
            and v.device == device):
        v = torch.as_tensor(v, dtype=torch.float32, device=device)
    if v.numel() != 1:
        raise ValueError(f"score_select: {what} must be a scalar")
    return v


def _launch_score(x, g, alpha, tau, keep_frac, blk, kb, row_weights):
    """Check the inputs of a CUDA ``score_select`` launch (with the
    selection when ``keep_frac`` is given, else the mask alone), launch
    it on the current stream and count it.  Messages are formatted only
    on failure: this runs 224 times per decode step."""
    B, n = x.shape
    dev = x.device
    if x.dtype not in _DTYPE_CODES or not x.is_contiguous():
        raise ValueError(f"score_select: x must be a contiguous float32 or "
                         f"bfloat16 tensor, got {x.dtype}")
    if not (g.shape == (n,) and g.dtype == torch.float32 and g.device == dev
            and g.is_contiguous()):
        raise ValueError(f"score_select: g must be a contiguous ({n},) f32 "
                         f"tensor on {dev}")
    a = _f32_scalar(alpha, dev, "alpha")
    t = _f32_scalar(tau, dev, "tau")
    select = keep_frac is not None
    kf = _f32_scalar(keep_frac, dev, "keep_frac") if select else None
    rw = row_weights
    if rw is not None:
        if rw.dim() != 1 or rw.dtype != torch.float32 or \
                not rw.is_contiguous():
            rw = rw.reshape(B).to(torch.float32).contiguous()
        if rw.shape != (B,) or rw.device != dev:
            raise ValueError(f"score_select: row_weights must be ({B},) on "
                             f"{dev}")
    xm = torch.empty_like(x)
    bs = torch.empty(n // blk, dtype=torch.float32, device=dev)
    idx = torch.empty(kb, dtype=torch.int32, device=dev) if select else None
    err = build.library().wisparse_score_select(
        x.data_ptr(), g.data_ptr(), a.data_ptr(), t.data_ptr(),
        kf.data_ptr() if select else None,
        None if rw is None else rw.data_ptr(), xm.data_ptr(),
        idx.data_ptr() if select else None, bs.data_ptr(), B, n, blk, kb,
        _DTYPE_CODES[x.dtype], _stream(dev))
    _raise_on(err, "score_select")
    launch_counts["score_select"] += 1
    return xm, idx, bs


def sparse_matmul_shared(x, w, block_idx, *, blk: int = DEFAULT_BLK):
    """y[b, :] = sum_{kept blocks i} x[b, blk_i] @ w[blk_i, :], f32.

    x: (B, n) already per-channel masked; w: (n, m) of x's dtype;
    block_idx: (kb,) int32 kept channel-block ids (a repeated id counts
    once per occurrence).  Returns (B, m) float32."""
    B, n = x.shape
    m = w.shape[1]
    blk = min(blk, n)
    _check(w.shape[0] == n, f"w rows {w.shape[0]} != x channels {n}")
    _check(n % blk == 0, f"channel dim {n} is not a multiple of blk {blk}")
    _check(block_idx.dim() == 1, "block_idx must be 1-d")
    if x.device.type == "cpu":
        return ref.ref_sparse_matmul_shared(x, w, block_idx, blk)
    _check(x.is_cuda, f"sparse_matmul_shared: unsupported device {x.device}")
    _check(x.dtype in _DTYPE_CODES and w.dtype == x.dtype,
           f"sparse_matmul_shared: x {x.dtype} / w {w.dtype} must be one of "
           "float32/bfloat16, and equal")
    _check(block_idx.dtype == torch.int32, "block_idx must be int32")
    _check(w.device == x.device and block_idx.device == x.device,
           "sparse_matmul_shared: x, w and block_idx must share a device")
    _check(x.is_contiguous() and w.is_contiguous()
           and block_idx.is_contiguous(),
           "sparse_matmul_shared: inputs must be contiguous")
    return _launch_matmul("sparse_matmul_shared", x, w, block_idx, blk,
                          block_idx.shape[0], per_seq=False)


def sparse_matmul_per_seq(x, w, block_idx, *, blk: int = DEFAULT_BLK):
    """y[b, :] = sum_{i} x[b, blk_i(b)] @ w[blk_i(b), :], f32: one kept
    block list per row.

    x: (B, n) already per-channel masked; w: (n, m) of x's dtype;
    block_idx: (B, kb) int32 (a repeated id counts once per occurrence).
    Returns (B, m) float32."""
    B, n = x.shape
    m = w.shape[1]
    blk = min(blk, n)
    _check(w.shape[0] == n, f"w rows {w.shape[0]} != x channels {n}")
    _check(n % blk == 0, f"channel dim {n} is not a multiple of blk {blk}")
    _check(block_idx.dim() == 2 and block_idx.shape[0] == B,
           f"block_idx must be ({B}, kb), got {tuple(block_idx.shape)}")
    if x.device.type == "cpu":
        return ref.ref_sparse_matmul_per_seq(x, w, block_idx, blk)
    _check(x.is_cuda, f"sparse_matmul_per_seq: unsupported device {x.device}")
    _check(x.dtype in _DTYPE_CODES and w.dtype == x.dtype,
           f"sparse_matmul_per_seq: x {x.dtype} / w {w.dtype} must be one "
           "of float32/bfloat16, and equal")
    _check(block_idx.dtype == torch.int32, "block_idx must be int32")
    _check(w.device == x.device and block_idx.device == x.device,
           "sparse_matmul_per_seq: x, w and block_idx must share a device")
    _check(x.is_contiguous() and w.is_contiguous()
           and block_idx.is_contiguous(),
           "sparse_matmul_per_seq: inputs must be contiguous")
    return _launch_matmul("sparse_matmul_per_seq", x, w, block_idx, blk,
                          block_idx.shape[1], per_seq=True)


def _launch_matmul(name, x, w, block_idx, blk, kb, *, per_seq):
    """Launch the checked inputs on the kernel ``name`` and count it."""
    B, n = x.shape
    m = w.shape[1]
    plan = launch_plan(B, n, m, kb, blk, per_seq, x.element_size())
    y = torch.empty(B, m, dtype=torch.float32, device=x.device)
    ws, cnt = matmul_scratch(plan, x.device)
    err = getattr(build.library(), "wisparse_" + name)(
        _ptr(x), _ptr(w), _ptr(block_idx), _ptr(y),
        None if ws is None else _ptr(ws), None if cnt is None else _ptr(cnt),
        B, n, m, blk, kb, plan.rows, plan.cols, plan.splits,
        _DTYPE_CODES[x.dtype], _stream(x.device))
    _raise_on(err, name)
    launch_counts[name] += 1
    return y
