"""Pass registry and the analysis runner (the port's counterpart of the
JAX package's ``analysis/registry.py``).

Two pass families plug into one registry:

  * :class:`AstPass` — per-file syntactic passes over ``ast`` trees of
    everything under the scan roots (``src/repro_torch`` by default;
    ``chip_smoke.py``, a measuring script, stays outside).  Each pass
    narrows itself with :meth:`AstPass.applies_to`, so e.g.
    ``hot-path-zero-cost`` only ever parses the engine and scheduler.
  * :class:`GlobalPass` — whole-tree semantic passes
    (``repro_torch.analysis.graph_passes``) that build the model and the
    serving warmup set on a device and inspect what the steps do and
    what the kernels would launch.  They are registered lazily so
    ``--ast-only`` runs never import the model.

The runner applies inline suppressions (``# repro: ignore[rule]``)
before returning, so a pass never needs to know about them.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.analysis.findings import (Finding, is_suppressed,
                                           parse_suppressions)

DEFAULT_ROOTS = ("src/repro_torch",)


class AnalysisError(RuntimeError):
    """A pass could not run at all (distinct from finding violations)."""


class AnalysisPass:
    rule: str = ""
    severity: str = "error"

    def describe(self) -> str:
        return (self.__doc__ or "").strip().splitlines()[0]


class AstPass(AnalysisPass):
    """Per-file pass: ``check`` sees one parsed module at a time."""

    def applies_to(self, relpath: str) -> bool:
        return True

    def check(self, relpath: str, source: str,
              tree: ast.Module) -> List[Finding]:
        raise NotImplementedError


class GlobalPass(AnalysisPass):
    """Whole-tree pass: ``run`` owns its own model building, on
    ``device`` (a CUDA card, or the CPU when the caller asks)."""

    def run(self, repo_root: str, device: str = "cuda") -> List[Finding]:
        raise NotImplementedError


_AST_PASSES: Dict[str, AstPass] = {}
_GLOBAL_PASSES: Dict[str, GlobalPass] = {}


def register(p):
    """Register a pass (usable as a class decorator)."""
    inst = p() if isinstance(p, type) else p
    if not inst.rule:
        raise ValueError(f"{type(inst).__name__} has no rule id")
    table = _AST_PASSES if isinstance(inst, AstPass) else _GLOBAL_PASSES
    if inst.rule in table:
        raise ValueError(f"duplicate rule id {inst.rule!r}")
    table[inst.rule] = inst
    return p


def ast_passes() -> Dict[str, AstPass]:
    import repro_torch.analysis.ast_passes  # noqa: F401  (registers on import)
    return dict(_AST_PASSES)


def global_passes() -> Dict[str, GlobalPass]:
    import repro_torch.analysis.graph_passes  # noqa: F401  (registers on import)
    return dict(_GLOBAL_PASSES)


def iter_python_files(repo_root: str,
                      roots: Sequence[str] = DEFAULT_ROOTS) -> Iterable[str]:
    """Repo-relative paths of every ``.py`` file under the scan roots,
    sorted for deterministic finding order."""
    out = []
    for root in roots:
        base = os.path.join(repo_root, root)
        if os.path.isfile(base) and base.endswith(".py"):
            out.append(os.path.relpath(base, repo_root))
            continue
        for dirpath, dirnames, filenames in os.walk(base):
            dirnames[:] = [d for d in dirnames if d != "__pycache__"]
            for fn in filenames:
                if fn.endswith(".py"):
                    out.append(os.path.relpath(os.path.join(dirpath, fn),
                                               repo_root))
    return sorted(out)


def run_ast_passes(repo_root: str,
                   roots: Sequence[str] = DEFAULT_ROOTS,
                   rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Run every registered AST pass (or just ``rules``) over the scan
    roots; inline suppressions already applied."""
    passes = ast_passes()
    if rules is not None:
        unknown = set(rules) - set(passes) - set(global_passes())
        if unknown:
            raise AnalysisError(f"unknown rule ids: {sorted(unknown)}")
        passes = {r: p for r, p in passes.items() if r in rules}
    findings: List[Finding] = []
    for rel in iter_python_files(repo_root, roots):
        active = [p for p in passes.values() if p.applies_to(rel)]
        if not active:
            continue
        path = os.path.join(repo_root, rel)
        with open(path, encoding="utf-8") as fh:
            source = fh.read()
        try:
            tree = ast.parse(source, filename=rel)
        except SyntaxError as e:
            findings.append(Finding(
                rule="syntax-error", path=rel, line=e.lineno or 1,
                message=f"cannot parse: {e.msg}"))
            continue
        suppressions = parse_suppressions(source)
        seen = set()
        for p in active:
            for f in p.check(rel, source, tree):
                # passes that walk both a function and its enclosing
                # scope can emit one site twice — keep the first
                key = (f.rule, f.path, f.line)
                if key not in seen and not is_suppressed(f, suppressions):
                    seen.add(key)
                    findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def run_global_passes(repo_root: str,
                      rules: Optional[Sequence[str]] = None,
                      device: str = "cuda") -> List[Finding]:
    """Run every registered global pass (or just ``rules``) on
    ``device``; ``repro_torch.device.resolve_device`` refuses ``cuda``
    without a card (no silent CPU fallback)."""
    from repro_torch.device import resolve_device
    dev = str(resolve_device(device))
    passes = global_passes()
    if rules is not None:
        passes = {r: p for r, p in passes.items() if r in rules}
    findings: List[Finding] = []
    for p in passes.values():
        findings.extend(p.run(repo_root, dev))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def find_repo_root(start: Optional[str] = None) -> str:
    """Walk up from ``start`` (default: this package) to the directory
    holding the scan roots — works from an installed ``src`` layout and
    from a checkout."""
    d = os.path.abspath(start or os.path.dirname(__file__))
    while True:
        if os.path.isdir(os.path.join(d, "src")) and \
                os.path.isfile(os.path.join(d, "pyproject.toml")):
            return d
        parent = os.path.dirname(d)
        if parent == d:
            raise AnalysisError(
                "cannot locate the repo root (no pyproject.toml above "
                f"{start or os.path.dirname(__file__)}); pass --root")
        d = parent
