"""AST passes: the port's serving-correctness contracts, checked at lint
time (the counterpart of the JAX package's ``analysis/ast_passes.py``).

Each pass encodes an invariant that was previously enforced only
dynamically (by running the engine under pytest, or on the card) or
socially (by review).  The rule ids are stable — they are what
``# repro: ignore[rule-id]`` suppressions and the committed baseline
reference; the first four are the JAX checker's, scoped to the port's
paths, so one suppression comment serves both checkers.

Rules:
  * ``no-raw-time``            — all timestamps flow through ``repro_torch.obs.clock``
  * ``no-builtin-hash-persistence`` — salted ``hash()`` never feeds persisted state
  * ``no-thread-local-serving``     — no ambient thread-local serving state
  * ``hot-path-zero-cost``     — telemetry touch points guard with identity checks
  * ``host-sync-in-step``      — no host sync in the code captured steps run
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding
from repro_torch.analysis.registry import AstPass, register


def _dotted(node: ast.AST) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a", "b", "c"); None for non-name-rooted chains."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def _snippet(source_lines: List[str], lineno: int) -> str:
    if 1 <= lineno <= len(source_lines):
        return source_lines[lineno - 1].strip()
    return ""


def _walk_with_parents(tree: ast.AST):
    """Yield every node; each node gains a ``_repro_parent`` backlink."""
    for parent in ast.walk(tree):
        for child in ast.iter_child_nodes(parent):
            child._repro_parent = parent  # type: ignore[attr-defined]
    return ast.walk(tree)


def _parents(node: ast.AST):
    while True:
        node = getattr(node, "_repro_parent", None)
        if node is None:
            return
        yield node


# ---------------------------------------------------------------------------
# no-raw-time
# ---------------------------------------------------------------------------

@register
class NoRawTime(AstPass):
    """Raw ``time.time/monotonic/perf_counter`` reads outside ``obs/clock.py``.

    Every serving-path timestamp must flow through
    ``repro_torch.obs.clock`` (``now()`` / an injected engine clock) or
    the flight recorder cannot capture it and replay diverges (the
    record -> replay bit-identity of ``tests/test_torch_flight.py``).
    The clock module itself is exempt: it holds the port's only raw
    reads.  ``time.sleep`` stays legal: it advances no clocks.
    """

    rule = "no-raw-time"
    _CALLS = frozenset({
        "time", "monotonic", "perf_counter",
        "time_ns", "monotonic_ns", "perf_counter_ns",
    })

    def applies_to(self, relpath: str) -> bool:
        return not relpath.replace("\\", "/").endswith(
            "repro_torch/obs/clock.py")

    def check(self, relpath, source, tree):
        lines = source.splitlines()
        findings = []
        # `from time import monotonic` makes the raw read invisible to a
        # call-site scan, so the import itself is the violation
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.module == "time":
                for alias in node.names:
                    if alias.name in self._CALLS:
                        findings.append(Finding(
                            rule=self.rule, path=relpath, line=node.lineno,
                            message=(f"importing time.{alias.name} bypasses "
                                     "repro_torch.obs.clock — read time "
                                     "through "
                                     "obs.now() / the engine clock"),
                            snippet=_snippet(lines, node.lineno)))
            if isinstance(node, ast.Call):
                chain = _dotted(node.func)
                if chain and len(chain) == 2 and chain[0] == "time" \
                        and chain[1] in self._CALLS:
                    findings.append(Finding(
                        rule=self.rule, path=relpath, line=node.lineno,
                        message=(f"raw time.{chain[1]}() read — serving "
                                 "timestamps must flow through "
                                 "repro_torch.obs.clock (now()/to_wall()) "
                                 "so the "
                                 "flight recorder can capture and replay "
                                 "them"),
                        snippet=_snippet(lines, node.lineno)))
        return findings


# ---------------------------------------------------------------------------
# no-builtin-hash-persistence
# ---------------------------------------------------------------------------

@register
class NoBuiltinHashPersistence(AstPass):
    """Builtin ``hash()`` feeding seeds, artifact keys, or serialized state.

    Builtin str/bytes hashing is salted per process (PYTHONHASHSEED), so
    any value derived from ``hash()`` that outlives the process — RNG
    fold-in tags, artifact/cache keys, anything written to disk — breaks
    cross-process reproducibility: per-leaf init keys seeded with
    ``hash(path)`` make "seed 0" params differ across processes, which
    is why ``models/params.py`` derives them with ``zlib.crc32``.
    Intra-process uses are flagged too — suppress with a justification
    if the value provably never escapes the process (``__hash__``
    delegation is exempt).
    """

    rule = "no-builtin-hash-persistence"

    def check(self, relpath, source, tree):
        lines = source.splitlines()
        findings = []
        for node in _walk_with_parents(tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "hash"):
                continue
            # delegating from __hash__ is in-process by construction
            in_hash_method = any(
                isinstance(p, ast.FunctionDef) and p.name == "__hash__"
                for p in _parents(node))
            if in_hash_method:
                continue
            findings.append(Finding(
                rule=self.rule, path=relpath, line=node.lineno,
                message=("builtin hash() is salted per process "
                         "(PYTHONHASHSEED) — deriving seeds, artifact keys "
                         "or persisted values from it breaks cross-process "
                         "determinism (a params-init seed bug class); "
                         "use "
                         "zlib.crc32 / hashlib on stable bytes instead"),
                snippet=_snippet(lines, node.lineno)))
        return findings


# ---------------------------------------------------------------------------
# no-thread-local-serving
# ---------------------------------------------------------------------------

@register
class NoThreadLocalServing(AstPass):
    """Thread-local / ContextVar serving state must not reappear.

    Execution state rides in the explicit, hashable ``SparsityPolicy``
    threaded through every forward and keyed into every built step:
    ambient state would make a captured step depend on invisible inputs
    (a graph captured under one thread's mode replayed under another's,
    capture leaks between engines).  Any ``threading.local()`` or
    ``contextvars.ContextVar`` in ``serving/`` or ``models/`` is such
    state.
    """

    rule = "no-thread-local-serving"

    def applies_to(self, relpath: str) -> bool:
        p = "/" + relpath.replace("\\", "/")
        return "/serving/" in p or "/models/" in p

    def check(self, relpath, source, tree):
        lines = source.splitlines()
        findings = []
        bad_chains = {
            ("threading", "local"): "threading.local()",
            ("contextvars", "ContextVar"): "contextvars.ContextVar",
        }
        for node in ast.walk(tree):
            chain = None
            if isinstance(node, ast.Call):
                chain = _dotted(node.func)
            elif isinstance(node, ast.ClassDef):
                for base in node.bases:
                    bchain = _dotted(base)
                    if bchain and bchain in bad_chains:
                        chain = bchain
                        break
            if isinstance(node, ast.ImportFrom):
                if node.module == "threading" and any(
                        a.name == "local" for a in node.names):
                    chain = ("threading", "local")
                if node.module == "contextvars" and any(
                        a.name == "ContextVar" for a in node.names):
                    chain = ("contextvars", "ContextVar")
            if chain and chain in bad_chains:
                findings.append(Finding(
                    rule=self.rule, path=relpath, line=node.lineno,
                    message=(f"{bad_chains[chain]} in the serving/model "
                             "path — execution state rides in the "
                             "explicit SparsityPolicy; thread state makes "
                             "built steps depend on invisible inputs and "
                             "breaks engine isolation"),
                    snippet=_snippet(lines, node.lineno)))
        return findings


# ---------------------------------------------------------------------------
# hot-path-zero-cost
# ---------------------------------------------------------------------------

_SINKS = frozenset({"events", "tracer", "quality", "flight", "metrics",
                    "spans"})


@register
class HotPathZeroCost(AstPass):
    """Telemetry touch points in the engine hot path must be identity-guarded.

    The zero-cost-when-off contract (``tests/test_torch_obs.py``'s
    null-path tests): with telemetry disarmed the engine holds
    ``NULL_TELEMETRY`` whose sink fields are ``None``, and every emit
    site in ``serving/engine.py`` / ``serving/scheduler.py`` must reach
    a sink only under an ``is not None`` (or ``is NULL_*``) identity
    check — never through a truthiness test or an unconditional
    attribute chain, both of which either allocate or crash when
    telemetry is off.  The pass tracks ``self.obs.<sink>`` chains and
    local aliases (``ev = self.obs.events``) and requires a dominating
    identity guard for every dereference.
    """

    rule = "hot-path-zero-cost"

    def applies_to(self, relpath: str) -> bool:
        p = relpath.replace("\\", "/")
        return p.endswith(("repro_torch/serving/engine.py",
                           "repro_torch/serving/scheduler.py"))

    # -- sink expression recognition ------------------------------------
    def _sink_key(self, node: ast.AST,
                  aliases: Dict[str, str]) -> Optional[str]:
        """'events' etc. if ``node`` evaluates to a telemetry sink."""
        if isinstance(node, ast.Name):
            return aliases.get(node.id)
        chain = _dotted(node)
        # self.obs.events / eng.obs.tracer / telemetry.flight ...
        if chain and len(chain) >= 2 and chain[-1] in _SINKS \
                and ("obs" in chain[:-1]
                     or chain[0] in ("telemetry", "tele")):
            return chain[-1]
        return None

    def _guard_exprs(self, test: ast.AST,
                     aliases: Dict[str, str],
                     positive: bool) -> Set[str]:
        """Sink keys proven non-None by ``test`` being true (positive)
        or false (negative): ``X is not None``, ``X is None`` inverted,
        ``not (...)``, and ``and`` chains (positive) / ``or`` chains
        (negative)."""
        out: Set[str] = set()
        if isinstance(test, ast.BoolOp):
            wanted = ast.And if positive else ast.Or
            if isinstance(test.op, wanted):
                for v in test.values:
                    out |= self._guard_exprs(v, aliases, positive)
            return out
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self._guard_exprs(test.operand, aliases, not positive)
        if isinstance(test, ast.Compare) and len(test.ops) == 1:
            lhs, op, rhs = test.left, test.ops[0], test.comparators[0]
            is_none = isinstance(rhs, ast.Constant) and rhs.value is None
            key = self._sink_key(lhs, aliases)
            if key and is_none:
                if isinstance(op, ast.IsNot) and positive:
                    out.add(key)
                if isinstance(op, ast.Is) and not positive:
                    out.add(key)
        return out

    def check(self, relpath, source, tree):
        lines = source.splitlines()
        findings: List[Finding] = []
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            findings.extend(self._check_fn(fn, relpath, lines))
        return findings

    def _check_fn(self, fn, relpath, lines) -> List[Finding]:
        aliases: Dict[str, str] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                key = self._sink_key(node.value, {})
                if key:
                    aliases[node.targets[0].id] = key

        findings: List[Finding] = []
        for node in _walk_with_parents(fn):
            if not isinstance(node, ast.Attribute):
                continue
            key = self._sink_key(node.value, aliases)
            if key is None:
                continue
            if self._is_exempt(node, aliases):
                continue
            if not self._is_guarded(node, key, aliases, fn):
                findings.append(Finding(
                    rule=self.rule, path=relpath, line=node.lineno,
                    message=(f"telemetry sink .{key} dereferenced without "
                             "a dominating `is not None` identity guard — "
                             "the zero-cost-when-off contract "
                             "requires every hot-path emit site to check "
                             "the sink identity before touching it"),
                    snippet=_snippet(lines, node.lineno)))
        return findings

    def _is_exempt(self, node: ast.Attribute,
                   aliases: Dict[str, str]) -> bool:
        """The guard test itself and bare alias assignments are legal."""
        parent = getattr(node, "_repro_parent", None)
        # operand of `is` / `is not` — that IS the guard
        if isinstance(parent, ast.Compare) and any(
                isinstance(op, (ast.Is, ast.IsNot)) for op in parent.ops):
            return True
        return False

    def _is_guarded(self, node: ast.AST, key: str,
                    aliases: Dict[str, str], fn) -> bool:
        # lexical ancestors: if/while/ifexp whose test proves the sink
        child = node
        for parent in _parents(node):
            if isinstance(parent, (ast.If, ast.While)):
                in_body = any(child is s or self._contains(s, node)
                              for s in parent.body)
                in_orelse = any(child is s or self._contains(s, node)
                                for s in parent.orelse)
                if in_body and key in self._guard_exprs(
                        parent.test, aliases, True):
                    return True
                if in_orelse and key in self._guard_exprs(
                        parent.test, aliases, False):
                    return True
            if isinstance(parent, ast.IfExp):
                if self._contains(parent.body, node) and key in \
                        self._guard_exprs(parent.test, aliases, True):
                    return True
                if self._contains(parent.orelse, node) and key in \
                        self._guard_exprs(parent.test, aliases, False):
                    return True
            if isinstance(parent, ast.BoolOp):
                # `x is not None and x.emit(...)` short-circuit guard
                positive = isinstance(parent.op, ast.And)
                proven: Set[str] = set()
                for v in parent.values:
                    if self._contains(v, node):
                        if key in proven:
                            return True
                        break
                    proven |= self._guard_exprs(v, aliases, positive)
            child = parent
        # early-return guard: a preceding `if x is None: return/raise`
        # in any enclosing statement list dominates the rest of the list
        return self._early_return_guarded(node, key, aliases, fn)

    @staticmethod
    def _contains(tree: ast.AST, node: ast.AST) -> bool:
        return any(n is node for n in ast.walk(tree))

    def _early_return_guarded(self, node, key, aliases, fn) -> bool:
        _ABORTS = (ast.Return, ast.Raise, ast.Continue, ast.Break)
        for parent in list(_parents(node)) + [fn]:
            for field in ("body", "orelse", "finalbody"):
                stmts = getattr(parent, field, None)
                if not isinstance(stmts, list):
                    continue
                idx = next((i for i, s in enumerate(stmts)
                            if self._contains(s, node)), None)
                if idx is None:
                    continue
                for s in stmts[:idx]:
                    if isinstance(s, ast.If) and s.body and \
                            isinstance(s.body[-1], _ABORTS) and \
                            key in self._guard_exprs(s.test, aliases, False):
                        return True
        return False


# ---------------------------------------------------------------------------
# host-sync-in-step
# ---------------------------------------------------------------------------

# modules whose direct calls yield tensors (``torch.zeros``, ``F.pad``,
# ``torch.linalg.norm`` ...); deeper chains (``torch.cuda.*``,
# ``torch.backends.*``) are host APIs
_TENSOR_ROOTS = (("torch",), ("torch", "nn", "functional"), ("F",),
                 ("torch", "linalg"), ("torch", "fft"), ("torch", "special"))
# torch.* calls whose results are Python objects, not tensors
_STATIC_TORCH = frozenset({
    "finfo", "iinfo", "device", "dtype", "Size", "is_tensor",
    "is_floating_point", "is_complex", "get_default_dtype",
    "is_grad_enabled", "is_inference_mode_enabled", "promote_types",
    "result_type", "can_cast", "broadcast_shapes", "no_grad",
    "enable_grad", "inference_mode", "set_grad_enabled", "Generator",
    "manual_seed"})
# attribute reads and methods of a tensor that yield static metadata
_STATIC_TENSOR_ATTRS = frozenset({
    "shape", "dtype", "device", "ndim", "is_cuda", "is_meta", "is_sparse",
    "layout", "requires_grad", "is_leaf", "names", "itemsize", "nbytes"})
_STATIC_TENSOR_METHODS = frozenset({
    "numel", "dim", "ndimension", "size", "element_size", "nelement",
    "is_contiguous", "data_ptr", "stride", "storage_offset", "get_device",
    "is_floating_point", "is_complex", "untyped_storage"})
# methods that copy a device value to the host
_SYNC_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
# ops whose output shape depends on the data
_DATA_SHAPED = frozenset({"nonzero", "masked_select", "unique",
                          "unique_consecutive", "argwhere"})
# builtins that never yield a tensor (bool/int/float are flagged apart)
_HOST_BUILTINS = frozenset({
    "len", "isinstance", "issubclass", "type", "id", "hasattr", "getattr",
    "callable", "repr", "str", "print", "range", "enumerate", "zip", "tuple",
    "list", "dict", "set", "frozenset", "sorted", "reversed", "iter",
    "super", "format", "bool", "int", "float"})
_BOOL_TORCH = frozenset({
    "isnan", "isinf", "isfinite", "isneginf", "isposinf", "logical_and",
    "logical_or", "logical_not", "logical_xor", "eq", "ne", "gt", "ge", "lt",
    "le", "isin", "isclose", "signbit"})
_HOST_ROOTS = ("np", "numpy", "math")


@register
class HostSyncInStep(AstPass):
    """Host syncs in the code the captured steps run.

    Everything under ``models/`` and ``kernels/`` (but the nvcc build
    ``kernels/build.py``) and ``core/sparse_linear.py`` runs inside the
    engine's steps, which are captured once as CUDA graphs and replayed
    (``serving/graphs.py``).  A read of a device value on the host there
    — ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``bool`` /
    ``int`` / ``float`` of a tensor, an ``if`` / ``while`` / ``assert`` /
    conditional expression on a tensor, an op whose output shape depends
    on the data (``torch.nonzero``, ``masked_select``, ``unique``,
    indexing with a boolean mask) — raises "operation not permitted when
    stream is capturing" under capture, and in eager mode costs one host
    sync per call.  The dataflow is the JAX checker's conservative
    fixpoint (``traced-value-branch``): tensors are what torch calls,
    ``torch.Tensor``-annotated arguments and methods of tensors yield;
    the four host-read methods are flagged on anything not known to be a
    host value (numpy, Python).  Reads of ``.shape``, ``.dtype``,
    ``.device``, ``.ndim`` and ``.numel()``, and identity checks, stay
    legal: they are static.
    """

    rule = "host-sync-in-step"

    def applies_to(self, relpath: str) -> bool:
        p = "/" + relpath.replace("\\", "/")
        if "/repro_torch/kernels/" in p:
            return not p.endswith("/repro_torch/kernels/build.py")
        return "/repro_torch/models/" in p or \
            p.endswith("/repro_torch/core/sparse_linear.py")

    def check(self, relpath, source, tree):
        lines = source.splitlines()
        findings: List[Finding] = []
        funcs = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for fn in funcs:
            findings.extend(self._check_fn(fn, relpath, lines))
        return findings

    # -- value classes ----------------------------------------------------
    @staticmethod
    def _torch_call(chain) -> bool:
        for root in _TENSOR_ROOTS:
            if chain[:len(root)] == root and len(chain) == len(root) + 1:
                return chain[-1] not in _STATIC_TORCH
        return False

    def _tensor(self, node, env) -> bool:
        """Does ``node`` evaluate to a tensor?"""
        tensors = env[0]
        if isinstance(node, ast.Name):
            return node.id in tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_TENSOR_ATTRS:
                return False
            return self._tensor(node.value, env)
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            if chain is not None and self._torch_call(chain):
                return True
            if isinstance(node.func, ast.Attribute):
                if not self._tensor(node.func.value, env):
                    return False
                return node.func.attr not in _STATIC_TENSOR_METHODS and \
                    node.func.attr not in _SYNC_METHODS
            if isinstance(node.func, ast.Name):
                if node.func.id in _HOST_BUILTINS:
                    return False
                return any(self._tensor(a, env) for a in node.args)
            return False
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return False        # identity checks never read values
            return any(self._tensor(n, env)
                       for n in [node.left] + node.comparators)
        if isinstance(node, (ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.IfExp,
                             ast.Subscript, ast.Tuple, ast.List,
                             ast.Starred)):
            return any(self._tensor(c, env) for c in ast.iter_child_nodes(node)
                       if isinstance(c, ast.expr))
        return False

    def _bool_tensor(self, node, env) -> bool:
        """Does ``node`` evaluate to a boolean tensor (a mask)?"""
        masks = env[1]
        if isinstance(node, ast.Name):
            return node.id in masks
        if isinstance(node, ast.Compare):
            return not all(isinstance(op, (ast.Is, ast.IsNot, ast.In,
                                           ast.NotIn)) for op in node.ops) \
                and self._tensor(node, env)
        if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Invert):
            return self._bool_tensor(node.operand, env)
        if isinstance(node, ast.BinOp) and isinstance(
                node.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self._bool_tensor(node.left, env) or \
                self._bool_tensor(node.right, env)
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            if chain is not None and self._torch_call(chain):
                return chain[-1] in _BOOL_TORCH
            if isinstance(node.func, ast.Attribute) and \
                    self._tensor(node.func.value, env):
                name = node.func.attr
                if name == "to":
                    return any(_dotted(a) == ("torch", "bool")
                               for a in node.args)
                return name == "bool" or name in _BOOL_TORCH
        return False

    def _host(self, node, env) -> bool:
        """Is ``node`` known to be a host value (numpy, Python)?"""
        if isinstance(node, ast.Name):
            return node.id in env[2]
        if isinstance(node, (ast.Constant, ast.JoinedStr, ast.List,
                             ast.Tuple, ast.Dict, ast.ListComp)):
            return True
        if isinstance(node, ast.Call):
            chain = _dotted(node.func)
            if chain is not None and chain[0] in _HOST_ROOTS:
                return True
            if isinstance(node.func, ast.Attribute):
                return node.func.attr in _SYNC_METHODS - {"cpu"} or \
                    self._host(node.func.value, env)
        if isinstance(node, ast.Attribute):
            return self._host(node.value, env)
        return False

    # -- per function -------------------------------------------------------
    def _env(self, fn):
        tensors: Set[str] = set()
        masks: Set[str] = set()
        hosts: Set[str] = set()
        args = fn.args
        for a in args.posonlyargs + args.args + args.kwonlyargs:
            ann = _dotted(a.annotation) if a.annotation is not None else None
            if ann in (("torch", "Tensor"), ("Tensor",)):
                tensors.add(a.arg)
        env = (tensors, masks, hosts)
        assigns = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign):
                assigns.append((node.targets, node.value))
            elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) and \
                    node.value is not None:
                assigns.append(([node.target], node.value))
        for _ in range(3):          # tiny fixpoint; chains are short
            for targets, val in assigns:
                names = []
                for t in targets:
                    if isinstance(t, ast.Name):
                        names.append(t.id)
                    elif isinstance(t, (ast.Tuple, ast.List)):
                        names.extend(e.id for e in t.elts
                                     if isinstance(e, ast.Name))
                if self._tensor(val, env):
                    tensors.update(names)
                if self._bool_tensor(val, env):
                    masks.update(names)
                if self._host(val, env):
                    hosts.update(names)
        return env

    def _check_fn(self, fn, relpath, lines) -> List[Finding]:
        env = self._env(fn)
        findings = []

        def flag(node, what):
            findings.append(Finding(
                rule=self.rule, path=relpath, line=node.lineno,
                message=(f"{what} in code a captured step runs — under "
                         "CUDA graph capture it raises \"operation not "
                         "permitted when stream is capturing\"; eagerly it "
                         "costs one host sync per call.  Keep the value on "
                         "the device (torch.where, masked ops, a static "
                         "budget) or read it off the step's path"),
                snippet=_snippet(lines, node.lineno)))

        for node in ast.walk(fn):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                if self._tensor(node.test, env):
                    kind = {ast.If: "if", ast.While: "while",
                            ast.IfExp: "a conditional expression"}[type(node)]
                    flag(node, f"{kind} on a tensor value")
            elif isinstance(node, ast.Assert):
                if self._tensor(node.test, env):
                    flag(node, "assert on a tensor value")
            elif isinstance(node, ast.Call):
                self._check_call(node, env, flag)
            elif isinstance(node, ast.Subscript) and \
                    isinstance(node.ctx, ast.Load):
                idx = node.slice
                parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
                if self._tensor(node.value, env) and any(
                        self._bool_tensor(p, env) for p in parts):
                    flag(node, "indexing with a boolean mask (a data-shaped "
                               "result)")
        return findings

    def _check_call(self, node, env, flag) -> None:
        func = node.func
        chain = _dotted(func)
        static_size = any(kw.arg == "size" for kw in node.keywords)
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
                and not node.args and not self._host(func.value, env):
            flag(node, f".{func.attr}() of a device value")
        elif isinstance(func, ast.Name) and func.id in ("bool", "int",
                                                        "float") \
                and any(self._tensor(a, env) for a in node.args):
            flag(node, f"{func.id}() of a tensor value")
        elif chain is not None and self._torch_call(chain) and \
                not static_size and (
                    chain[-1] in _DATA_SHAPED
                    or (chain[-1] == "where" and len(node.args) == 1)):
            flag(node, f"torch.{chain[-1]} without a static size (a "
                       "data-shaped result)")
        elif isinstance(func, ast.Attribute) and func.attr in _DATA_SHAPED \
                and not static_size and self._tensor(func.value, env):
            flag(node, f".{func.attr}() without a static size (a "
                       "data-shaped result)")
