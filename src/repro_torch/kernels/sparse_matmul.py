"""Wrappers for the WiSparse Hopper kernels (port of the JAX package's
``kernels/sparse_matmul.py``).

``score_mask``, ``sparse_matmul_shared`` and ``sparse_matmul_per_seq``
take the route by the device of the tensors they are given: a CUDA
tensor launches the CUDA kernel in ``csrc/`` (built at first use by
:mod:`repro_torch.kernels.build`) or raises; a CPU tensor runs the
plain PyTorch version in :mod:`repro_torch.kernels.ref`.  There is no
fallback from one to the other.  Each wrapper adds one to
:data:`launch_counts` where it launches its kernel, and nowhere else, so
a run can show that it went through the kernels.

The kernels launch on PyTorch's current stream, do not synchronise, and
allocate nothing: the wrappers allocate outputs with ``torch.empty``.
The TPU tile geometry of ``shared_plan``/``score_mask_plan`` does not
carry over (Hopper runs its own tiles, masked at ragged edges in the
kernels); what the port keeps is the channel-block contract, checked
here: ``n % blk == 0``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import ref

DEFAULT_BLK = 128

# kernel name -> launches since the last reset_launch_counts()
launch_counts = {"score_mask": 0, "sparse_matmul_shared": 0,
                 "sparse_matmul_per_seq": 0}

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


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


def score_mask(x, g, alpha, tau, *, blk: int = DEFAULT_BLK, row_weights=None):
    """Returns (x_masked (B,n) in x.dtype, block_scores (n//blk,) f32) —
    Eq. 4/5 fused.  ``alpha``/``tau`` are one-element f32 tensors on x's
    device (the sp tree's own; the kernel reads them where they lie), or
    floats, which are copied to the device; ``row_weights`` (B,)
    optionally weights each row's block-score contribution (the engine's
    active-slot / real-token mask)."""
    B, n = x.shape
    blk = min(blk, n)
    _check(n % blk == 0, f"channel dim {n} is not a multiple of blk {blk}")
    if x.device.type == "cpu":
        return ref.ref_score_mask(x, g, alpha, tau, blk, row_weights)
    _check(x.is_cuda, f"score_mask: unsupported device {x.device}")
    _check(x.dtype in _DTYPE_CODES, f"score_mask: x dtype {x.dtype}")
    _check(x.is_contiguous(), "score_mask: x must be contiguous")
    _check(g.shape == (n,) and g.dtype == torch.float32
           and g.device == x.device and g.is_contiguous(),
           f"score_mask: g must be a contiguous ({n},) f32 tensor on "
           f"{x.device}")
    # no-ops (no copy, no launch) for the sp tree's f32 device scalars
    a = torch.as_tensor(alpha, dtype=torch.float32, device=x.device)
    t = torch.as_tensor(tau, dtype=torch.float32, device=x.device)
    _check(a.numel() == 1 and t.numel() == 1,
           "score_mask: alpha and tau must be scalars")
    rw = None
    if row_weights is not None:
        rw = row_weights.reshape(B).to(torch.float32).contiguous()
        _check(rw.device == x.device, "score_mask: row_weights device")
    xm = torch.empty_like(x)
    bs = torch.empty(n // blk, dtype=torch.float32, device=x.device)
    from repro_torch.kernels.build import library
    err = library().wisparse_score_mask(
        _ptr(x), _ptr(g), _ptr(a), _ptr(t),
        None if rw is None else _ptr(rw), _ptr(xm), _ptr(bs), B, n, blk,
        _DTYPE_CODES[x.dtype], _stream(x.device))
    _raise_on(err, "score_mask")
    launch_counts["score_mask"] += 1
    return xm, bs


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
    from repro_torch.kernels.build import library
    y = torch.empty(B, m, dtype=torch.float32, device=x.device)
    # the C entry refuses (cudaErrorInvalidValue) a blk whose tiles need
    # more than 48 KB of shared memory
    err = library().wisparse_sparse_matmul_shared(
        _ptr(x), _ptr(w), _ptr(block_idx), _ptr(y), B, n, m, blk,
        block_idx.shape[0], _DTYPE_CODES[x.dtype], _stream(x.device))
    _raise_on(err, "sparse_matmul_shared")
    launch_counts["sparse_matmul_shared"] += 1
    return y


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
    from repro_torch.kernels.build import library
    y = torch.empty(B, m, dtype=torch.float32, device=x.device)
    # the C entry refuses (cudaErrorInvalidValue) a blk whose staged x
    # chunk needs more than 48 KB of shared memory
    err = library().wisparse_sparse_matmul_per_seq(
        _ptr(x), _ptr(w), _ptr(block_idx), _ptr(y), B, n, m, blk,
        block_idx.shape[1], _DTYPE_CODES[x.dtype], _stream(x.device))
    _raise_on(err, "sparse_matmul_per_seq")
    launch_counts["sparse_matmul_per_seq"] += 1
    return y
