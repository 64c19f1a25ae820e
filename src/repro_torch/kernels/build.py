"""Build and load the port's CUDA kernels (``kernels/csrc``) at first use.

Each ``.cu`` source is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a``; the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The library lands in
``build/repro_torch_kernels/<hash>/`` at the root of the checkout (listed
in ``.gitignore``), keyed by a hash of the sources and flags, so a later
process reuses it and an edited source rebuilds.  Nothing is built when
the module is imported: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch_kernels"
LIB_NAME = "libwisparse_kernels.so"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# name -> argtypes; every entry returns a cudaError_t as int
SIGNATURES = {
    # x, g, alpha, tau, keep_frac, rw, xm, idx, bs, B, n, blk, kb, dtype,
    # workspace, its length, form (-1 the shape's, 0 cluster, 1 spread),
    # stream
    "wisparse_score_select": (_P,) * 9 + (_I,) * 5 + (_P,) + (_I,) * 2
    + (_P,),
    # x, w, idx, y, workspace, counters, B, n, m, blk, kb, rows, cols,
    # splits, dtype, stream
    "wisparse_sparse_matmul_shared": (_P,) * 6 + (_I,) * 9 + (_P,),
    "wisparse_sparse_matmul_per_seq": (_P,) * 6 + (_I,) * 9 + (_P,),
    # the expert-batched forms (a leading expert axis E):
    # x, g, alpha, tau, keep_frac, xm, idx, bs, E, B, n, blk, kb, dtype,
    # workspace, its length, form (as above), stream
    "wisparse_score_select_experts": (_P,) * 8 + (_I,) * 6 + (_P,)
    + (_I,) * 2 + (_P,),
    # x, w, idx, y, workspace, counters, E, B, n, m, blk, kb, rows, cols,
    # splits, dtype, stream
    "wisparse_sparse_matmul_shared_experts": (_P,) * 6 + (_I,) * 10 + (_P,),
    # the launch-geometry query (launches nothing): kernel name, E, B, n,
    # m, blk, kb, rows, cols, splits, dtype, aligned, out (10 int32)
    "wisparse_launch_info": (ctypes.c_char_p,) + (_I,) * 11 + (_P,),
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "port's CUDA kernels are built from source at first use")


def sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile (if not already built) and return the library path.  The
    ``-Xptxas=-v`` report (registers, shared memory, spills per kernel)
    is kept beside the library as ``build.log``."""
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        procs = []
        for src in sources():
            obj = pathlib.Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for src, _obj, proc in procs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(log))
        tmp_lib = pathlib.Path(tmp) / LIB_NAME
        link = subprocess.run(
            [nvcc, "-shared", "-Wno-deprecated-gpu-targets", "-o",
             str(tmp_lib),
             *[str(o) for _s, o, _p in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)     # atomic: a reader never sees half
    return lib


@functools.lru_cache(maxsize=1)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call, then cached for
    the process)."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def build_log() -> str:
    path = BUILD_ROOT / source_hash() / "build.log"
    return path.read_text() if path.exists() else ""
