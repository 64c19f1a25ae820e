"""Launch geometry of the port's CUDA kernels: a Python mirror of what
their C entries launch, and the library's own query of it.

The C entries decide each launch's grid, block, dynamic shared memory
and cluster (``csrc/score_select.cu``'s ``Geometry``, which also picks
the expert selection's form and both selections' spread form; for the
matmuls
``csrc/gather_mma.cuh``'s ``grid_of`` and ``Layout::kBytes``, with the
split from :func:`repro_torch.kernels.sparse_matmul.launch_plan`, and
the tile form's persistent grid, ``csrc/sparse_matmul_tile.cuh``, which
:func:`repro_torch.kernels.sparse_matmul.expert_plan` picks for both
shared entries).  A
launch outside the card's limits shows only on the card, as
``cudaErrorInvalidValue`` from the entry.  The mirror lets a check on the
CPU cover every served shape (``repro_torch.analysis``'s
``launch-geometry``); on the card the same check holds the mirror against
:func:`launch_info`, which calls ``wisparse_launch_info``: the geometry
computed by the launches' own code, with nothing launched.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

from repro_torch.kernels import sparse_matmul as K

# an H100's limits, for the CPU check (on the card they are read from the
# device: ``launch_info("device")``)
H100_LIMITS = {"threads": 1024, "smem_optin": 232448, "cluster": 16,
               "sms": 132, "grid_yz": 65535}

# csrc/score_select.cu: threads per block, the largest cluster, the
# shared-memory cap the entry checks and the channel-block limit
SCORE_THREADS = 512
SCORE_CLUSTER = 16
SCORE_MAX_SMEM = 232448
SCORE_MAX_BLOCKS = 8192
# its per-expert form (score_select_experts): channel blocks of this
# size, at most this many warps, and the (channel blocks per warp, rows
# per lane) instantiations, tried in order (kExpertNJ, kExpertRU)
SCORE_EXPERT_BLK = 128
SCORE_EXPERT_WARPS = 16
SCORE_EXPERT_CONFIGS = ((1, 1), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
                        (1, 8), (1, 12), (1, 16), (2, 1), (2, 2), (2, 4),
                        (2, 8))
# its spread form (whole-prefill rows, both entries; the row thresholds,
# threads, channel-block limit and the form's own predicate are in
# kernels/sparse_matmul.py, which the wrapper reads too): target blocks
# per SM, the warps whose sums share its shared memory, and the loads in
# flight per thread (the expert entry's least rows per thread and slab)
SCORE_SPREAD_PER_SM = 4
SCORE_SPREAD_UNROLL = 8
SCORE_SPREAD_WARPS = K.SCORE_SPREAD_THREADS // 32
# csrc/gather_mma.cuh: threads per block
MATMUL_THREADS = 256
# csrc/sparse_matmul_tile.cuh: threads per block, ring stages, the ids
# held in shared memory
TILE_THREADS = 384
TILE_STAGES = 4
TILE_MAX_IDS = 128

KERNELS = ("score_select", "score_select_experts", "sparse_matmul_shared",
           "sparse_matmul_shared_experts", "sparse_matmul_per_seq")
_DTYPE_OF_ELEM = {4: 0, 2: 1}    # element bytes -> the entries' dtype code


@dataclasses.dataclass(frozen=True)
class Geometry:
    """One launch: grid and cluster dims (x, y, z), threads per block,
    dynamic shared memory bytes; ``ok`` is False where the C entry would
    refuse the arguments (``cudaErrorInvalidValue``)."""
    grid: tuple
    threads: int
    smem: int
    cluster: tuple
    ok: bool = True
    # score_select: "cluster", "expert NJxRU" or "spread"; the matmuls:
    # "tile" for the tile form, else the default
    form: str = "cluster"


def expert_config(B: int, n: int, blk: int, elem_bytes: int = 2,
                  aligned: bool = True):
    """The per-expert form's (index, warps) for ``score_select_experts``
    at R = ``B`` rows of n channels, or None where one expert's slab does
    not fit one block: 16-byte units (``aligned``), channel blocks of
    ``SCORE_EXPERT_BLK``, and the first ``SCORE_EXPERT_CONFIGS`` entry
    that holds a warp's channel blocks (nb over min(16, nb) warps) and a
    lane's rows (R over the rows a warp takes at once: 32 lanes over a
    block's 16-byte units, 2 in bf16, 1 in f32)."""
    if not (aligned and blk == SCORE_EXPERT_BLK):
        return None
    nb = n // blk
    warps = min(SCORE_EXPERT_WARPS, nb)
    nj = -(-nb // warps)
    ru = -(-B // (32 * (16 // elem_bytes) // blk))
    for i, (cnj, cru) in enumerate(SCORE_EXPERT_CONFIGS):
        if nj <= cnj and ru <= cru:
            return i, warps
    return None


def spread_slabs(B: int, nb: int, blk: int, elem_bytes: int = 2,
                 sms: int = H100_LIMITS["sms"], E: int = 1,
                 experts: bool = False) -> tuple:
    """The spread form's (slabs, rows per slab) at B rows (per expert,
    over ``E`` experts): about ``SCORE_SPREAD_PER_SM`` blocks per SM over
    the E x nb channel blocks, each slab whole row groups (a block's
    threads over a block row's 16-byte units) and, for the expert entry
    (``experts``), at least ``SCORE_SPREAD_UNROLL`` rows per thread, as
    ``Geometry`` in ``csrc/score_select.cu`` cuts them."""
    bv = blk // (16 // elem_bytes)
    rg = K.SCORE_SPREAD_THREADS // bv
    least = rg * SCORE_SPREAD_UNROLL if experts else rg
    cells = nb * E
    s0 = max(1, min(-(-B // least),
                    -(-(SCORE_SPREAD_PER_SM * sms) // cells)))
    rows = -(-(-(-B // s0)) // rg) * rg
    return -(-B // rows), rows


def score_select_geometry(E: int, B: int, n: int, blk: int, kb: int,
                          elem_bytes: int = 2, aligned: bool = True,
                          sms: int = H100_LIMITS["sms"],
                          experts: bool = False) -> Geometry:
    """``score_select`` (E = 1) or, with ``experts``,
    ``score_select_experts`` at (E, B, n).  The expert entry's per-expert
    form where :func:`expert_config` fits: min(E, SMs) blocks of 32 x
    warps threads, static shared memory only, no cluster.  The spread
    form where ``sparse_matmul.score_form`` names it: a (nb, slabs, E)
    grid (:func:`spread_slabs`; E = 1 for the 2-D entry) of
    ``SCORE_SPREAD_THREADS`` threads, shared memory for blk g^alpha values
    and max(nb, warps) sums, no cluster (the geometry of both its
    launches).  Else one
    cluster of C = min(16, nb, max(1, SMs / E)) blocks per expert; shared
    memory for the nb block sums, a flag and blk g^alpha values per owned
    channel block, and the partial sums of one row group.  A thread loads
    16 bytes where ``aligned`` (x and xm 16-byte aligned) and blk holds
    whole 16-byte units, else one element."""
    nb = n // blk if blk > 0 else 0
    ok = (0 < E <= 65535 and B > 0 and n > 0 and blk > 0 and n % blk == 0
          and nb <= SCORE_MAX_BLOCKS and 1 <= kb <= nb)
    if not ok:
        return Geometry((0, 0, 0), 0, 0, (0, 0, 0), False)
    cfg = expert_config(B, n, blk, elem_bytes, aligned) if experts else None
    if cfg is not None:
        nj, ru = SCORE_EXPERT_CONFIGS[cfg[0]]
        return Geometry((min(E, sms), 1, 1), 32 * cfg[1], 0, (1, 1, 1),
                        form=f"expert {nj}x{ru}")
    if K.score_form(B, n, blk, elem_bytes, aligned, experts) == "spread":
        slabs, _rows = spread_slabs(B, nb, blk, elem_bytes, sms, E, experts)
        return Geometry((nb, slabs, E), K.SCORE_SPREAD_THREADS,
                        4 * (blk + max(nb, SCORE_SPREAD_WARPS)), (1, 1, 1),
                        form="spread")
    vec = 16 // elem_bytes
    units = vec if aligned and blk % vec == 0 else 1
    C = min(SCORE_CLUSTER, nb, max(1, sms // E))
    lmax = -(-nb // C)
    vmax = lmax * (blk // units)
    smem = 4 * (nb + lmax + lmax * blk + max(SCORE_THREADS, vmax))
    return Geometry((C, E, 1), SCORE_THREADS, smem, (C, 1, 1),
                    smem <= SCORE_MAX_SMEM)


def matmul_smem(elem_bytes: int, rows: int, per_seq: bool) -> int:
    """``Layout<T, rows, per_seq>::kBytes``: the cp.async ring (stages of
    kKC weight rows x the column tile and the rows' x values, rows padded
    by 16 bytes) and the slice's ids (per-seq: occurrence counts, the
    kept list, the passes and the list length).  Tile form (rows ==
    ``TILE_ROWS``, bf16): ``tile::kBytes``, the TMA ring (an x tile of
    TILE_ROWS x TILE_DEPTH and a W tile of TILE_DEPTH x TILE_WIDE per
    stage), 1024 bytes to align it, two mbarriers per stage, the ids."""
    if rows == K.TILE_ROWS:
        stage = (K.TILE_ROWS + K.TILE_WIDE) * K.TILE_DEPTH * elem_bytes
        return TILE_STAGES * stage + 1024 + 2 * TILE_STAGES * 8 + \
            4 * TILE_MAX_IDS
    kkc, stages = (64, 4) if per_seq else (128, 3)
    cols = K.TILE_COLS[elem_bytes]
    pad = 16 // elem_bytes           # 16 bytes of padding per row
    ring = stages * (kkc * (cols + pad) + rows * (kkc + pad)) * elem_bytes
    slice_ = K.MAX_SLICE_BLOCKS
    counts = (rows * slice_ + 2 * slice_ + 4) if per_seq else slice_
    return ring + 4 * counts


def tile_ctas(plan: K.LaunchPlan, sms: int = H100_LIMITS["sms"]) -> int:
    """``tile::ctas``: the tile form's persistent CTAs, one per SM (every
    tile where there are fewer), the count kept coprime with the row
    tiles where the CTAs walk more than one tile each."""
    tiles = plan.tiles_m * plan.tiles_b * plan.experts
    g = min(tiles, sms)
    if tiles > sms:
        while g > 1 and math.gcd(g, plan.tiles_b) != 1:
            g -= 1
    return g


def tile_walk(plan: K.LaunchPlan, sms: int = H100_LIMITS["sms"]) -> list:
    """The (expert, row tile, column tile) each persistent CTA of the tile
    form computes, in its order: CTA b takes the linear tiles b, b + G,
    ... (G = :func:`tile_ctas`) of the order (expert, column tile, row
    tile), row tile fastest, as ``tile_of`` in the kernel decodes them."""
    rt, ct = plan.tiles_b, plan.tiles_m
    tiles = rt * ct * plan.experts
    g = tile_ctas(plan, sms)
    return [[(t // (rt * ct), t % rt, t // rt % ct)
             for t in range(b, tiles, g)] for b in range(g)]


def matmul_geometry(kernel: str, plan: K.LaunchPlan, B: int, n: int, m: int,
                    blk: int, kb: int, elem_bytes: int = 2,
                    sms: int = H100_LIMITS["sms"]) -> Geometry:
    """One block-gather matmul launch of ``plan``: grid (column tiles,
    splits, row tiles x experts), 256 threads, ``matmul_smem``; ``ok``
    as the C entry checks the plan (tile rows 8/16/32, the column tile it
    is compiled for, at most 65535 row tiles, 1 <= splits <= kb or, per
    seq, <= nb with no slice over ``MAX_SLICE_BLOCKS`` ids).  The tile
    form (``plan.rows == TILE_ROWS``, the shared kernels only): grid
    (:func:`tile_ctas`, 1, 1), 384 threads, form "tile"; ``ok`` for bf16,
    one slice, the TILE_WIDE column tile, blk a multiple of TILE_DEPTH
    and n, m multiples of 8."""
    per_seq = kernel == "sparse_matmul_per_seq"
    E, S = plan.experts, plan.splits
    nb = n // blk if blk > 0 else 0
    ok = (E > 0 and B > 0 and n > 0 and m > 0 and blk > 0 and kb > 0
          and n % blk == 0 and 1 <= S <= 65535)
    if plan.rows == K.TILE_ROWS:
        ok = (ok and not per_seq and S == 1 and elem_bytes == 2
              and plan.cols == K.TILE_WIDE and blk % K.TILE_DEPTH == 0
              and n % 8 == 0 and m % 8 == 0)
        return Geometry((tile_ctas(plan, sms), 1, 1), TILE_THREADS,
                        matmul_smem(elem_bytes, plan.rows, per_seq),
                        (1, 1, 1), ok, "tile")
    if per_seq:
        ok = ok and E == 1 and S <= nb and -(-nb // S) <= K.MAX_SLICE_BLOCKS
    else:
        ok = ok and S <= kb
    ok = ok and plan.rows in (8, 16, 32) and \
        math.ceil(B / plan.rows) * E <= 65535 and \
        plan.cols == K.TILE_COLS[elem_bytes]
    cols = K.TILE_COLS[elem_bytes]
    grid = (math.ceil(m / cols), S, math.ceil(B / plan.rows) * E)
    return Geometry(grid, MATMUL_THREADS,
                    matmul_smem(elem_bytes, plan.rows, per_seq), (1, 1, 1),
                    ok)


def launch_info(kernel: str, E: int = 1, B: int = 0, n: int = 0, m: int = 0,
                blk: int = 0, kb: int = 0, rows: int = 0, cols: int = 0,
                splits: int = 0, elem_bytes: int = 2, aligned: bool = True):
    """The C library's answer (``wisparse_launch_info``) for one launch:
    (Geometry, active) where ``active`` is how many such clusters (or,
    in the per-expert and spread forms, blocks) can run at once
    (score_select only), or,
    for ``kernel="device"``, the card's limits as a dict.  Builds the
    library on first use and launches nothing."""
    from repro_torch.kernels import build
    out = (ctypes.c_int * 10)()
    err = build.library().wisparse_launch_info(
        kernel.encode(), E, B, n, m, blk, kb, rows, cols, splits,
        _DTYPE_OF_ELEM[elem_bytes], int(aligned), out)
    if kernel == "device":
        if err:
            raise RuntimeError(f"wisparse_launch_info(device): cudaError {err}")
        return {"threads": out[0], "smem_optin": out[1], "sms": out[2],
                "grid_x": out[3], "grid_yz": min(out[4], out[5])}
    if err == 1:                # cudaErrorInvalidValue: the entry refuses
        return Geometry((0, 0, 0), 0, 0, (0, 0, 0), False), 0
    if err:
        raise RuntimeError(f"wisparse_launch_info({kernel}): cudaError {err}")
    if out[9] == 0:
        form = "cluster"
    elif out[9] == -1:
        form = "spread"
    elif kernel.startswith("sparse_matmul"):
        form = "tile"
    else:
        form = "expert {}x{}".format(*SCORE_EXPERT_CONFIGS[out[9] - 1])
    return (Geometry(tuple(out[0:3]), out[3], out[4], tuple(out[5:8]),
                     form=form), out[8])
