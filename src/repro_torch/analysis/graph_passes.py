"""Global passes: build the serving warmup set through the engine's own
construction sites and check what its steps do to the pool, how they are
keyed, and what the kernels would launch (the counterpart of the JAX
package's ``analysis/jaxpr_passes.py``, whose donation, static-args and
Pallas BlockSpec passes have no meaning without XLA or a TPU).

Three rules:

  * ``graph-in-place`` (for ``jit-donation``) — every step of the warmup
    set (decode per rung, chunked prefill per (rung, phase policy), the
    speculative verify, the pool's segment ops) writes the pool in
    place: every pool leaf keeps its address, no op the step dispatches
    returns a fresh tensor of a whole leaf's (or one layer's slice of
    it) shape and dtype, and on the card a capture retains less than one
    leaf.  A whole-leaf copy per step is the torch form of a dropped
    donation: a pool's worth of traffic per step, and a captured graph
    that writes a copy the next step never reads.
  * ``graph-keys`` (for ``jit-static-args``) — every CUDA-graph capture
    in the serving files lies inside ``GraphSpace.capture`` (so every
    capture is a counted build), every step key is a frozen dataclass
    or a tuple of such (ints allowed), hashable and equal to its deep
    copy, and a second warmup and a request served under deep-copied
    ladder policies build nothing (an identity-hashed policy would be a
    silent rebuild per call: what ``*_retraces_after_warmup == 0``
    guards at run time).
  * ``launch-geometry`` (for ``pallas-blockspec``) — the matmuls' split-K
    plans (``kernels.sparse_matmul.launch_plan``) and every kernel's
    grid, block, shared memory and cluster (``kernels.geometry``) over
    the JAX pass's awkward shapes and every projection of ten served
    archs at published width, B in {1, 8, 32, 448}, kb in {1, nb/2, nb}:
    slices partition the kept blocks, reads stay in the padded weight,
    the scratch the engine reserves covers every plan, and every launch
    fits the H100 (1024 threads, 232,448 B of opt-in shared memory,
    clusters of at most 16).  On the card the limits are read from the
    device, the mirror is held against the library's own
    ``wisparse_launch_info`` at every shape, and every ``score_select``
    cluster shape must be able to run (``cudaOccupancyMaxActiveClusters``).

The warmup set is the JAX pass's: reduced llama31_8b, a uniform 3-rung
ladder (0.0/0.5/0.7, the ``pallas`` backend the port serves), 4 slots,
``max_len`` 64, chunk 16, gamma 2.  Steps run eagerly on the CPU; on the
card they are captured and replayed.
"""
from __future__ import annotations

import ast
import copy
import dataclasses
import functools
import itertools
import math
import os
from typing import List

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.ast_passes import _dotted, _parents, \
    _walk_with_parents
from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AnalysisError, GlobalPass, register

# the serving shapes of the warmup set — tiny on purpose (reduced config)
_SLOTS = 4
_MAX_LEN = 64
_CHUNK = 16
_GAMMA = 2
_BUDGETS = (0.0, 0.5, 0.7)

_GRAPHS = "src/repro_torch/serving/graphs.py"
_POOL = "src/repro_torch/serving/kv_pool.py"


def _line_of(repo_root: str, relpath: str, needle: str) -> int:
    """1-based line of the first occurrence of ``needle`` (anchor for
    findings that belong to a construction site, not a single token)."""
    try:
        with open(os.path.join(repo_root, relpath), encoding="utf-8") as fh:
            for i, line in enumerate(fh, 1):
                if needle in line:
                    return i
    except OSError:
        pass
    return 1


@functools.lru_cache(maxsize=2)
def _model(device: str):
    """Reduced llama31_8b and its uniform 3-rung ``pallas`` ladder, built
    once per process and device."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import api
    from repro_torch.sparsity import PolicyLadder

    cfg = reduced(get_config("llama31_8b"))
    params = api.init_model(cfg, 0, device=device)
    ladder = PolicyLadder.uniform(params, cfg, budgets=_BUDGETS,
                                  backend="pallas")
    return cfg, params, ladder


def _engine(device: str):
    """The warmup set through the engine's own construction sites: a
    ladder engine with speculative decoding (drafter rung 1, the dense
    rung 0 verifying at gamma 2), which builds every step at
    construction."""
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.spec import SpecConfig

    cfg, params, ladder = _model(device)
    ecfg = EngineConfig(max_slots=_SLOTS, max_len=_MAX_LEN,
                        prefill_chunk=_CHUNK, initial_rung=0,
                        spec=SpecConfig(gamma=_GAMMA, drafter_rung=1,
                                        verifier_rung=0))
    return Engine(params, cfg, ecfg, device=device, ladder=ladder)


def _pool_leaves(pool) -> list:
    from repro_torch.models import params as P
    return P.tree_leaves(pool.caches)


# ---------------------------------------------------------------------------
# graph-in-place
# ---------------------------------------------------------------------------

class _FreshLeafCopies(TorchDispatchMode):
    """Records every op output with the shape and dtype of a whole pool
    leaf, or of one layer's slice of it, that is not a view of the pool
    (an in-place op returns its own pool tensor: not a copy)."""

    def __init__(self, leaves):
        super().__init__()
        self._pool = {t.untyped_storage().data_ptr() for t in leaves}
        self._sigs = set()
        for t in leaves:
            self._sigs.add((tuple(t.shape), t.dtype))
            self._sigs.add((tuple(t.shape[1:]), t.dtype))
        self.copies: List[str] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if isinstance(t, torch.Tensor) and \
                    (tuple(t.shape), t.dtype) in self._sigs and \
                    t.untyped_storage().data_ptr() not in self._pool:
                self.copies.append(f"{func} -> {tuple(t.shape)} {t.dtype}")
        return out


def _graph_pool_bytes(pool_id) -> int:
    """Bytes of live allocations in the CUDA-graph memory pool
    ``pool_id`` (the allocator's snapshot)."""
    total = 0
    for seg in torch.cuda.memory_snapshot():
        if tuple(seg.get("segment_pool_id", ())) != tuple(pool_id):
            continue
        total += sum(b["size"] for b in seg["blocks"]
                     if b["state"] == "active_allocated")
    return total


@register
class GraphInPlacePass(GlobalPass):
    """Every warmup-set step writes the pool in place: no leaf moves or
    is copied whole.

    For each rung's decode step, each (rung, prefill phase policy)'s
    chunk step and the gamma-2 verify — built by ``Engine`` through
    ``DecodeSteps`` / ``ChunkSteps`` / ``SpecDecoder`` — and for the
    pool's ``write_prefix``, ``rollback_many``, ``suspend`` and
    ``resume``, checks (a) that every pool leaf keeps its ``data_ptr``
    and (b), under a ``TorchDispatchMode``, that no dispatched op returns
    a fresh tensor of a whole leaf's (or one layer's) shape and dtype.
    The f32 attention upcasts of a bf16 pool are another dtype: a cost,
    not a copy of the pool.  On the card (c): what each
    ``GraphSpace.capture`` leaves allocated in the graph's memory pool
    stays under one leaf's bytes.  Findings point at ``_Steps.build`` or
    the pool op.
    """

    rule = "graph-in-place"

    def run(self, repo_root: str, device: str = "cuda") -> List[Finding]:
        from repro_torch.serving import graphs

        findings: List[Finding] = []
        build_line = _line_of(repo_root, _GRAPHS, "    def build(self")
        cuda = torch.device(device).type == "cuda"
        retained: list = []
        orig_capture = graphs.GraphSpace.capture
        if cuda:
            # a throwaway capture first: the capture stream's one-time
            # cuBLAS workspace must not land in the engine's graph pool
            a = torch.ones(16, 16, device=device)
            graphs.GraphSpace(torch.device(device)).capture(lambda: (a @ a,))

            def measured(space, run):
                before = _graph_pool_bytes(space.pool)
                out = orig_capture(space, run)
                retained.append(_graph_pool_bytes(space.pool) - before)
                return out
            graphs.GraphSpace.capture = measured
        try:
            eng = _engine(device)
        finally:
            graphs.GraphSpace.capture = orig_capture
        leaves = _pool_leaves(eng.pool)
        ptrs = [t.data_ptr() for t in leaves]
        leaf_bytes = min(t.numel() * t.element_size() for t in leaves)

        def check(name, rel, line, fn):
            mode = _FreshLeafCopies(_pool_leaves(eng.pool))
            with torch.no_grad(), mode:
                fn()
            now = [t.data_ptr() for t in _pool_leaves(eng.pool)]
            moved = sum(a != b for a, b in zip(now, ptrs))
            ptrs[:] = now           # each finding names the step that moved
            if moved:
                findings.append(Finding(
                    rule=self.rule, path=rel, line=line,
                    message=(f"{name}: {moved} pool leaves moved — the "
                             "captured graphs hold the pool by address, "
                             "so a rebound leaf is one they never read "
                             "again"),
                    snippet=f"{name} moved"))
            if mode.copies:
                findings.append(Finding(
                    rule=self.rule, path=rel, line=line,
                    message=(f"{name}: {len(mode.copies)} ops return a "
                             "fresh copy of a whole pool leaf (first: "
                             f"{mode.copies[0]}) — write the pool in place "
                             "(copy_, index_copy_, masked_fill_), or every "
                             "step moves a pool's worth of bytes"),
                    snippet=f"{name} copies"))

        for name, fn in self._steps(eng):
            check(name, _GRAPHS, build_line, fn)
        for op, fn in self._pool_ops(eng.pool):
            check(op, _POOL, _line_of(repo_root, _POOL, f"def {op}("), fn)
        if cuda:
            if not retained or not max(retained) > 0:
                raise AnalysisError(
                    "graph-in-place: no allocation seen in the engine's "
                    "graph pool across its captures (cannot read the "
                    "allocator's snapshot)")
            worst = max(retained)
            if worst >= leaf_bytes:
                findings.append(Finding(
                    rule=self.rule, path=_GRAPHS, line=build_line,
                    message=(f"a capture retained {worst} B in the graph "
                             f"pool, at least one pool leaf ({leaf_bytes} "
                             "B): a step keeps a copy of the pool"),
                    snippet="capture retains a leaf"))
            # replays move nothing either
            for name, fn in self._replays(eng):
                check(name, _GRAPHS, build_line, fn)
        return findings

    @staticmethod
    def _steps(eng):
        """(name, eager call) of every step of the warmup set, on inputs
        that write the pool's slack and the first slots."""
        dev = eng.device
        S = eng.ecfg.max_slots
        tokens = np.zeros(S, np.int64)
        positions = np.zeros(S, np.int64)
        active = np.ones(S, np.float32)
        out = []
        for r in range(eng.num_rungs):
            out.append((f"decode[rung={r}]", functools.partial(
                eng.decode_graphs.eager, r, tokens, positions, active)))
        ch = eng.chunk_graphs
        for i, (r, pol) in enumerate(ch.keys):
            out.append((f"chunk[rung={r},{pol.backend}]", functools.partial(
                ch.eager, i, np.zeros((1, _CHUNK), np.int64), 0, 0,
                np.ones(_CHUNK, np.float32))))
        vs = eng.spec_decoder.verify_steps
        for g in vs.keys:
            out.append((f"verify[gamma={g}]", functools.partial(
                vs.eager, torch.zeros((S, g + 1), dtype=torch.long,
                                      device=dev),
                torch.zeros(S, dtype=torch.long, device=dev),
                torch.ones((S, g + 1), dtype=torch.float32, device=dev))))
        return out

    @staticmethod
    def _replays(eng):
        """(name, replay) of the captured decode and chunk steps."""
        S = eng.ecfg.max_slots
        z = np.zeros(S, np.int64)
        out = [(f"replay decode[rung={r}]", functools.partial(
            eng.decode_graphs, r, z, z, np.ones(S, np.float32)))
            for r in range(eng.num_rungs)]
        out += [(f"replay chunk[{i}]", functools.partial(
            eng.chunk_graphs, i, np.zeros((1, _CHUNK), np.int64), 0, 0,
            np.ones(_CHUNK, np.float32)))
            for i in range(len(eng.chunk_graphs))]
        return out

    @staticmethod
    def _pool_ops(pool):
        """(op, call) of the pool's segment ops, in an order that leaves
        the pool as empty as it found it."""
        state = {}

        def write_prefix():
            a = pool.alloc()
            pool.commit(a, 2 * _CHUNK)
            b = pool.alloc()
            pool.write_prefix(pool.extract_prefix(a, _CHUNK), b)
            pool.commit(b, _CHUNK)
            state.update(a=a, b=b)

        def rollback_many():
            pool.rollback_many({state["a"]: 3, state["b"]: 2})

        def suspend():
            state["sus"] = pool.suspend(state["a"], _CHUNK)
            pool.free(state["a"])

        def resume():
            c = pool.alloc()
            pool.resume(state["sus"], c)
            pool.free(c)
            pool.free(state["b"])

        return [("write_prefix", write_prefix),
                ("rollback_many", rollback_many), ("suspend", suspend),
                ("resume", resume)]


# ---------------------------------------------------------------------------
# graph-keys
# ---------------------------------------------------------------------------

_CAPTURE_CALLS = frozenset({("torch", "cuda", "graph"),
                            ("torch", "cuda", "CUDAGraph"),
                            ("torch", "cuda", "make_graphed_callables")})
_ATOMS = (int, str, float, bool, type(None))


@register
class GraphKeysPass(GlobalPass):
    """Every capture is a counted build, and every step key is stable.

    Walks ``serving/graphs.py``, ``serving/engine.py``,
    ``serving/spec.py``, ``obs/quality.py`` and ``launch/serve.py`` for
    ``torch.cuda.graph(`` / ``torch.cuda.CUDAGraph(`` sites, each of
    which must lie in ``GraphSpace.capture`` (a capture anywhere else is
    a build no ``*_retraces_after_warmup`` counts); requires every key
    of the warmup set's steps to be a frozen dataclass or a tuple of
    such (ints allowed), hashable, and hash- and ``==``-equal to its
    deep copy; then serves the engine under deep copies of its ladder's
    policies — a second ``warmup()`` and one request — and requires no
    build (``ChunkSteps.index`` finds each copy at its built index).
    """

    rule = "graph-keys"
    _FILES = (
        "src/repro_torch/serving/graphs.py",
        "src/repro_torch/serving/engine.py",
        "src/repro_torch/serving/spec.py",
        "src/repro_torch/obs/quality.py",
        "src/repro_torch/launch/serve.py",
    )

    def run(self, repo_root: str, device: str = "cuda") -> List[Finding]:
        findings = self.capture_sites(repo_root)
        eng = _engine(device)
        site = (_GRAPHS, _line_of(repo_root, _GRAPHS, "class _Steps"))
        kinds = [s for s in eng._step_kinds() if s is not None]
        for steps in kinds:
            for key in steps.keys:
                findings.extend(self.check_key(key, site))
        findings.extend(self._rebuild_free(eng, kinds, site))
        return findings

    def capture_sites(self, repo_root: str) -> List[Finding]:
        """Capture sites outside ``GraphSpace.capture`` in ``_FILES``."""
        findings: List[Finding] = []
        sites = 0
        for rel in self._FILES:
            path = os.path.join(repo_root, rel)
            if not os.path.exists(path):
                continue
            with open(path, encoding="utf-8") as fh:
                source = fh.read()
            lines = source.splitlines()
            for node in _walk_with_parents(ast.parse(source, filename=rel)):
                if not (isinstance(node, ast.Call)
                        and _dotted(node.func) in _CAPTURE_CALLS):
                    continue
                sites += 1
                if self._in_space_capture(node):
                    continue
                findings.append(Finding(
                    rule=self.rule, path=rel, line=node.lineno,
                    message=(f"{'.'.join(_dotted(node.func))}() outside "
                             "GraphSpace.capture — a capture there is a "
                             "build no step counts (the retraces-after-"
                             "warmup gates miss it) and no key guards"),
                    snippet=lines[node.lineno - 1].strip()))
        if not sites:
            findings.append(Finding(
                rule=self.rule, path=self._FILES[0], line=1,
                message=("found no CUDA-graph capture site in the serving "
                         "files — the pass has lost track of where steps "
                         "are captured; update GraphKeysPass._FILES"),
                snippet="no capture sites"))
        return findings

    @staticmethod
    def _in_space_capture(node) -> bool:
        fn = next((p for p in _parents(node)
                   if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                                     ast.Lambda))), None)
        if not isinstance(fn, ast.FunctionDef) or fn.name != "capture":
            return False
        cls = getattr(fn, "_repro_parent", None)
        return isinstance(cls, ast.ClassDef) and cls.name == "GraphSpace"

    def check_key(self, key, site) -> List[Finding]:
        """Findings for one step key (``site``: (path, line))."""
        rel, line = site
        out: List[Finding] = []

        def finding(msg):
            return Finding(rule=self.rule, path=rel, line=line,
                           message=msg, snippet=f"key {key!r:.60}")

        bad = self._unfrozen(key)
        if bad is not None:
            out.append(finding(
                f"step key part {type(bad).__name__} is not a frozen "
                "dataclass, a tuple of such or an atom — a mutable key can "
                "change under a built step's feet"))
        try:
            # in-process key stability: steps are not persisted, so the
            # builtin hash is exactly what the key table uses
            h0 = hash(key)  # repro: ignore[no-builtin-hash-persistence]
            h1 = hash(copy.deepcopy(key))  # repro: ignore[no-builtin-hash-persistence]
        except TypeError as e:
            out.append(finding(
                f"step key is unhashable ({e}) — the step table cannot "
                "hold it"))
            return out
        if h0 != h1 or key != copy.deepcopy(key):
            out.append(finding(
                "step key hash/eq is identity-based: a deep copy hashes "
                "differently, so every equal-but-distinct policy object "
                "is a fresh build (a silent capture per call)"))
        return out

    def _unfrozen(self, key):
        """The first part of ``key`` that is not an atom, a frozen
        dataclass or a tuple of such (None if all are)."""
        if isinstance(key, _ATOMS):
            return None
        if isinstance(key, tuple):
            return next((b for b in map(self._unfrozen, key)
                         if b is not None), None)
        if dataclasses.is_dataclass(key) and not isinstance(key, type) \
                and key.__dataclass_params__.frozen:
            return None
        return key

    def _rebuild_free(self, eng, kinds, site) -> List[Finding]:
        """Deep-copied ladder policies find the built steps: the chunk
        index of each copy, a second warmup and one served request build
        nothing."""
        rel, line = site
        out: List[Finding] = []
        builds = [s.builds for s in kinds]
        phases = copy.deepcopy(eng._rung_phases)
        for r, (pd, ps, _dec) in enumerate(phases):
            for orig, pol in zip(eng._rung_phases[r][:2], (pd, ps)):
                try:
                    i = eng.chunk_graphs.index(r, pol)
                except KeyError:
                    i = None
                if i != eng.chunk_graphs.index(r, orig):
                    out.append(Finding(
                        rule=self.rule, path=rel, line=line,
                        message=(f"ChunkSteps.index(rung {r}, deep copy of "
                                 f"{orig.backend!r}) = {i}, not the built "
                                 "step: an equal policy is another key"),
                        snippet=f"index rung {r}"))
        eng._rung_phases = phases
        try:
            eng.warmup()
            eng.submit(np.arange(1, _CHUNK + 5, dtype=np.int64), 3)
            eng.run()
        except KeyError as e:
            out.append(Finding(
                rule=self.rule, path=rel, line=line,
                message=(f"serving under deep-copied ladder policies looked "
                         f"up a step that was never built (key {e})"),
                snippet="unbuilt key under copied policies"))
        after = [s.builds for s in kinds]
        if after != builds:
            out.append(Finding(
                rule=self.rule, path=rel, line=line,
                message=(f"serving under deep-copied ladder policies "
                         f"built steps again: builds {builds} -> {after}"),
                snippet="rebuild under copied policies"))
        return out


# ---------------------------------------------------------------------------
# launch-geometry
# ---------------------------------------------------------------------------

# the archs the port serves or trains at published width
_ARCHS = ("llama31_8b", "gemma2_2b", "gemma3_4b", "granite_moe_1b_a400m",
          "granite_moe_3b_a800m", "mamba2_130m", "whisper_large_v3",
          "internvl2_26b", "deepseek_67b", "jamba_v01_52b")
_BATCHES = (1, 8, 32, 448)
# the prompt lengths served by whole prefill at published width (one
# period of jamba_v01_52b in chip_smoke.py's phase 24): a MoE arch's
# expert rows at each are its capacity for one prompt, 641 at 4096 tokens
_WHOLE_PREFILL = (4096, 1536, 704, 1408, 3136, 2368, 2944, 1728)
# the 2-D rows of the whole prefills chip_smoke.py serves at published
# width, where the shared matmul takes its tile form and score_select its
# spread form: phase 24's lengths above, phase 16's (gemma2_2b: 4314,
# 4430 and two prompts of 4326), phase 18's (mamba2_130m: 4099 and three
# of 8192) and phase 20's (whisper_large_v3's cross wk/wv over one and
# four utterances' 1500 frames)
_WHOLE_PREFILL_2D = _WHOLE_PREFILL + (4314, 4430, 8652, 4099, 24576, 1500,
                                      6000)


@register
class LaunchGeometryPass(GlobalPass):
    """Kernel launch geometry: plans partition, reads stay in bounds,
    every launch fits the card.

    Sweeps ``launch_plan`` and the launch mirrors of
    ``kernels.geometry`` over the JAX pass's awkward shapes (prime dims,
    f32 and bf16) and every projection shape of ten archs at published
    width (``serving.graphs.matmul_shapes`` on meta params, as the dry
    run builds them), B in {1, 8, 32, 448} and, for the 2-D kernels, the
    rows of each served whole prefill (``_WHOLE_PREFILL_2D``; expert rows
    of the MoE archs at those decode and chunk sizes, and at the whole
    prefill of each ``_WHOLE_PREFILL`` length), kb in {1, nb/2, nb}.  On
    the card the limits come from the device and the mirror is held
    against ``wisparse_launch_info``.  Both shared matmuls' plans are
    ``expert_plan``'s (the 2-D entry's at one expert); in the tile form
    the persistent CTAs must walk each (expert, row tile, column tile)
    once, checked once per tile plan; in the selections' spread form the
    partial sums (one per channel block, row slab and expert) must fit
    the ``MIN_WORKSPACE`` values every spread launch is given.  ``report``
    keeps the number of
    shapes, of comparisons, each kernel's largest shared memory and
    headroom, the forms ``score_select`` (cluster, spread) and
    ``score_select_experts`` took, and the matmuls' (``matmul_forms``,
    and per kernel ``matmul_forms_by_kernel``).
    """

    rule = "launch-geometry"
    _REL = "src/repro_torch/kernels/sparse_matmul.py"
    _GEO = "src/repro_torch/kernels/geometry.py"

    # (B, n, m): production-ish plus the prime/awkward dims
    _SHAPES = (
        (8, 4096, 4096),
        (8, 4096, 11008),
        (1, 5120, 13824),
        (3, 2048, 311),      # prime output dim
        (7, 384, 640),       # prime batch
        (5, 256, 509),       # prime output under one column tile
        (1, 128, 128),
    )

    def __init__(self):
        self.report: dict = {}

    def shapes(self) -> list:
        """(B, n, m, blk, elem_bytes, experts) of the sweep."""
        from repro_torch.configs import get_config
        from repro_torch.kernels.ops import channel_plan
        from repro_torch.models import api, moe
        from repro_torch.serving.graphs import matmul_shapes

        out = set()
        for B, n, m in self._SHAPES:
            blk, n_padded, _ = channel_plan(n)
            out.update((B, n_padded, m, blk, e, 1) for e in (2, 4))
        for arch in _ARCHS:
            cfg = get_config(arch)
            abstract, _, _ = api.abstract_model(cfg)
            erows = {moe.expert_rows(cfg, b, 1) for b in _BATCHES} | \
                {moe.expert_rows(cfg, 1, t)
                 for t in _BATCHES + _WHOLE_PREFILL} \
                if cfg.num_experts else set()
            out.update(matmul_shapes(abstract, {128},
                                     set(_BATCHES + _WHOLE_PREFILL_2D),
                                     erows))
        return sorted(out)

    def run(self, repo_root: str, device: str = "cuda") -> List[Finding]:
        from repro_torch.kernels import geometry as G
        from repro_torch.kernels import sparse_matmul as K

        cuda = torch.device(device).type == "cuda"
        limits = dict(G.H100_LIMITS)
        if cuda:
            with torch.cuda.device(torch.device(device)):
                limits.update(G.launch_info("device"))
        findings: List[Finding] = []
        seen = set()
        plan_line = _line_of(repo_root, self._REL, "def launch_plan")
        geo_line = _line_of(repo_root, self._GEO, "def score_select_geometry")
        smem = {k: 0 for k in G.KERNELS}
        forms = {"score_select": set(), "score_select_experts": set()}
        matmul_forms = {}
        walked_plans = set()
        report = {"shapes": 0, "compared": 0, "min_active_clusters": None}

        def finding(rel, line, msg, snippet):
            if (rel, snippet) not in seen:    # one per kind of fault
                seen.add((rel, snippet))
                findings.append(Finding(rule=self.rule, path=rel, line=line,
                                        message=msg, snippet=snippet))

        def check_geometry(kernel, geo, where, query):
            if not geo.ok:
                finding(self._GEO, geo_line,
                        f"{kernel} {where}: the C entry refuses this "
                        "launch (cudaErrorInvalidValue)", f"{kernel} refused")
                return
            smem[kernel] = max(smem[kernel], geo.smem)
            if geo.threads > limits["threads"]:
                finding(self._GEO, geo_line,
                        f"{kernel} {where}: {geo.threads} threads per block "
                        f"exceed the card's {limits['threads']}",
                        f"{kernel} threads")
            if geo.smem > limits["smem_optin"]:
                finding(self._GEO, geo_line,
                        f"{kernel} {where}: {geo.smem} B of dynamic shared "
                        f"memory exceed the card's {limits['smem_optin']} B "
                        "opt-in limit", f"{kernel} smem")
            if int(np.prod(geo.cluster)) > limits["cluster"]:
                finding(self._GEO, geo_line,
                        f"{kernel} {where}: a cluster of "
                        f"{int(np.prod(geo.cluster))} blocks exceeds "
                        f"{limits['cluster']}", f"{kernel} cluster")
            if max(geo.grid[1:]) > limits["grid_yz"]:
                finding(self._GEO, geo_line,
                        f"{kernel} {where}: grid {geo.grid} exceeds "
                        f"{limits['grid_yz']} in y or z", f"{kernel} grid")
            if query is None:
                return
            got, active = query()
            report["compared"] += 1
            if got != dataclasses.replace(geo, ok=True):
                finding(self._GEO, geo_line,
                        f"{kernel} {where}: the Python mirror {geo} differs "
                        f"from wisparse_launch_info's {got}",
                        f"{kernel} mirror")
            if kernel.startswith("score_select"):
                prev = report["min_active_clusters"]
                report["min_active_clusters"] = active if prev is None \
                    else min(prev, active)
                if active < 1:
                    finding(self._GEO, geo_line,
                            f"{kernel} {where}: cudaOccupancyMaxActiveClusters"
                            f" is 0 for cluster {geo.cluster}: the launch "
                            "cannot run", f"{kernel} occupancy")

        def check_plan(kernel, plan, B, n, m, blk, kb, elem, where):
            units = list(itertools.chain.from_iterable(
                plan.slice(s) for s in range(plan.splits)))
            if units != list(range(plan.units)) or any(
                    len(plan.slice(s)) == 0 for s in range(plan.splits)):
                finding(self._REL, plan_line,
                        f"{kernel} {where}: the {plan.splits} slices do not "
                        f"partition 0..{plan.units} (each unit once, none "
                        "empty)", f"{kernel} slices")
            if plan.splits > K.MAX_SPLITS:
                finding(self._REL, plan_line,
                        f"{kernel} {where}: {plan.splits} splits exceed "
                        f"MAX_SPLITS {K.MAX_SPLITS}", f"{kernel} splits")
            if kernel == "sparse_matmul_per_seq" and max(
                    len(plan.slice(s)) for s in range(plan.splits)) > \
                    K.MAX_SLICE_BLOCKS:
                finding(self._REL, plan_line,
                        f"{kernel} {where}: a slice holds more than "
                        f"MAX_SLICE_BLOCKS {K.MAX_SLICE_BLOCKS} ids",
                        f"{kernel} slice")
            gx, gy, gz = plan.grid
            split = plan.splits > 1
            if plan.workspace != (plan.splits * plan.experts * B * m
                                  if split else 0) or \
                    plan.counters != (gx * gz if split else 0):
                finding(self._REL, plan_line,
                        f"{kernel} {where}: workspace {plan.workspace} / "
                        f"counters {plan.counters} are not what the kernel "
                        f"indexes (S x E x B x m partials, one counter per "
                        f"(row tile, column tile))", f"{kernel} scratch")
            # the kernel streams a kept block as chunks of kkc weight rows
            # from id * blk; columns past m are masked in the kernel, so
            # the grid need only cover m
            nb = n // blk
            kkc = 64 if kernel == "sparse_matmul_per_seq" or \
                plan.form == "tile" else 128
            last = max(i * blk + c * kkc + min(kkc, blk - c * kkc)
                       for i in (0, nb - 1) for c in range(-(-blk // kkc)))
            if last > n or gx * plan.cols < m or (gx - 1) * plan.cols >= m:
                finding(self._REL, plan_line,
                        f"{kernel} {where}: a weight tile read leaves the "
                        f"padded ({n}, {m}) with ids 0 and {nb - 1}",
                        f"{kernel} bounds")
            if plan.form == "tile" and plan not in walked_plans:
                # the persistent CTAs compute every (expert, row tile,
                # column tile) once (the walk is the plan's: one check each)
                walked_plans.add(plan)
                walked = sorted(itertools.chain.from_iterable(
                    G.tile_walk(plan, sms)))
                if walked != sorted(itertools.product(
                        range(plan.experts), range(plan.tiles_b),
                        range(plan.tiles_m))):
                    finding(self._GEO, geo_line,
                            f"{kernel} {where}: the tile form's CTAs do not "
                            "walk each (expert, row tile, column tile) once",
                            f"{kernel} tile walk")
            matmul_forms.setdefault(kernel, set()).add(plan.form)
            geo = G.matmul_geometry(kernel, plan, B, n, m, blk, kb, elem, sms)
            query = functools.partial(
                G.launch_info, kernel, plan.experts, B, n, m, blk, kb,
                plan.rows, plan.cols, plan.splits, elem) if cuda else None
            check_geometry(kernel, geo, where, query)

        sms = limits["sms"]
        for B, n, m, blk, elem, E in self.shapes():
            report["shapes"] += 1
            nb = n // blk
            where = f"at (E={E}, B={B}, n={n}, m={m}, {8 * elem}-bit)"
            mm = [("sparse_matmul_shared_experts" if E > 1
                   else "sparse_matmul_shared", False)]
            if E == 1:
                mm.append(("sparse_matmul_per_seq", True))
            reserved = K.launch_plan(B, n, m, nb, blk, False, elem, E)
            for kb in sorted({1, max(1, nb // 2), nb}):
                for kernel, per_seq in mm:
                    plan = K.launch_plan(B, n, m, kb, blk, True, elem) \
                        if per_seq else \
                        K.expert_plan(B, n, m, kb, blk, elem, E)
                    check_plan(kernel, plan, B, n, m, blk, kb, elem,
                               f"{where} kb={kb}")
                    if not per_seq and (
                            plan.workspace > max(K.MIN_WORKSPACE,
                                                 reserved.workspace)
                            or plan.counters > max(K.MIN_COUNTERS,
                                                   reserved.counters)):
                        finding(self._REL,
                                _line_of(repo_root, self._REL,
                                         "def reserve_matmul_scratch"),
                                f"{kernel} {where} kb={kb}: the plan needs "
                                "more split-K scratch than "
                                "reserve_matmul_scratch reserves",
                                f"{kernel} reserve")
                kernel = "score_select_experts" if E > 1 else "score_select"
                for aligned in (True, False):
                    geo = G.score_select_geometry(E, B, n, blk, kb, elem,
                                                  aligned, sms, E > 1)
                    forms[kernel].add(geo.form.split()[0])
                    query = functools.partial(
                        G.launch_info, kernel, E, B, n, 0, blk, kb, 0, 0, 0,
                        elem, aligned) if cuda else None
                    check_geometry(kernel, geo,
                                   f"{where} kb={kb} aligned={aligned}",
                                   query)
                    # one f32 partial per (channel block, slab, expert) in
                    # the workspace every spread launch is given
                    if geo.form == "spread" and \
                            math.prod(geo.grid) > K.MIN_WORKSPACE:
                        finding(self._REL,
                                _line_of(repo_root, self._REL,
                                         "def score_workspace"),
                                f"{kernel} {where}: the spread form's "
                                f"{math.prod(geo.grid)} partial sums exceed "
                                "the workspace's MIN_WORKSPACE values",
                                f"{kernel} workspace")
        findings.extend(self._channel_plan(repo_root))
        report["smem"] = smem
        report["forms"] = {k: sorted(v) for k, v in forms.items()}
        report["matmul_forms"] = sorted(set().union(*matmul_forms.values()))
        report["matmul_forms_by_kernel"] = {
            k: sorted(v) for k, v in sorted(matmul_forms.items())}
        report["headroom"] = {k: limits["smem_optin"] - v
                              for k, v in smem.items()}
        report["limits"] = limits
        self.report = report
        return findings

    def _channel_plan(self, repo_root: str) -> List[Finding]:
        """The ``ops.channel_plan`` contract: full-width blocks via
        padding, never a narrower fallback block."""
        from repro_torch.kernels.ops import channel_plan
        ops_rel = "src/repro_torch/kernels/ops.py"
        line = _line_of(repo_root, ops_rel, "def channel_plan")
        out = []
        for n in (128, 256, 311, 384, 509, 4096, 64, 1):
            blk, n_padded, nb = channel_plan(n)
            if n_padded % blk or n_padded < n or n_padded - n >= blk \
                    or nb != n_padded // blk or blk != min(128, n):
                out.append(Finding(
                    rule=self.rule, path=ops_rel, line=line,
                    message=(f"channel_plan(n={n}) broke the padded "
                             f"full-width-block contract: blk={blk}, "
                             f"n_padded={n_padded}, nb={nb}"),
                    snippet=f"channel_plan({n})"))
        return out
