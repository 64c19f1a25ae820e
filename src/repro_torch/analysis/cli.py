"""The command line: ``python -m repro_torch.analysis [--baseline] [--format ...]``.

The JAX checker's flags (``python -m repro.analysis``) plus ``--device``,
where the global passes build and run the warmup set (default ``cuda``;
``cpu`` only when asked: nothing falls back).

Exit status: 0 when no (non-baselined) findings, 1 when findings
remain, 2 on usage/configuration errors (unreadable baseline, missing
justification, unknown rule, no card for ``--device cuda``).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional

from repro_torch.analysis.findings import (DEFAULT_BASELINE, Baseline,
                                           BaselineError, Finding)
from repro_torch.analysis.registry import (DEFAULT_ROOTS, AnalysisError,
                                           ast_passes, find_repo_root,
                                           global_passes, run_ast_passes,
                                           run_global_passes)
from repro_torch.device import resolve_device


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static invariant checker for the PyTorch port "
                    "(AST passes + warmup-set, graph-key and launch "
                    "geometry passes).")
    p.add_argument("--root", default=None,
                   help="repository root (default: walk up from this "
                        "package / cwd)")
    p.add_argument("--roots", default=",".join(DEFAULT_ROOTS),
                   help="comma-separated source roots relative to the "
                        f"repo root (default: {','.join(DEFAULT_ROOTS)})")
    p.add_argument("--baseline", nargs="?", const=DEFAULT_BASELINE,
                   default=None, metavar="FILE",
                   help="filter findings through a committed baseline "
                        f"(default file: {DEFAULT_BASELINE})")
    p.add_argument("--write-baseline", metavar="FILE",
                   help="write the current findings as a new baseline "
                        "(justifications start as TODO and must be "
                        "filled in before the file loads)")
    p.add_argument("--format", choices=("text", "json"), default="text")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule ids to run (default: all)")
    p.add_argument("--ast-only", action="store_true",
                   help="skip the global passes (no model built; used by "
                        "fast pre-commit hooks)")
    p.add_argument("--list-rules", action="store_true",
                   help="print every registered rule and exit")
    p.add_argument("--device", default="cuda",
                   help="device of the global passes (default: cuda; "
                        "pass cpu to run them on the CPU)")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = _parser().parse_args(argv)
    all_ast = ast_passes()
    all_global = global_passes()
    if args.list_rules:
        for rule, p in sorted(all_ast.items()):
            print(f"{rule:30s} [ast]    {p.describe()}")
        for rule, p in sorted(all_global.items()):
            print(f"{rule:30s} [global] {p.describe()}")
        return 0

    rules = None
    if args.rules:
        rules = {r.strip() for r in args.rules.split(",") if r.strip()}
        unknown = rules - set(all_ast) - set(all_global)
        if unknown:
            print(f"error: unknown rule(s): {', '.join(sorted(unknown))}; "
                  f"known: {', '.join(sorted(set(all_ast) | set(all_global)))}",
                  file=sys.stderr)
            return 2

    try:
        repo_root = find_repo_root(args.root)
    except AnalysisError as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    roots = tuple(r.strip() for r in args.roots.split(",") if r.strip())

    findings: List[Finding] = []
    ast_rules = None if rules is None else sorted(rules & set(all_ast))
    if ast_rules is None or ast_rules:
        findings.extend(run_ast_passes(repo_root, roots=roots,
                                       rules=ast_rules))
    if not args.ast_only:
        glob_rules = None if rules is None else sorted(rules & set(all_global))
        if glob_rules is None or glob_rules:
            try:
                device = str(resolve_device(args.device))
            except RuntimeError as e:
                print(f"error: --device {args.device}: {e}", file=sys.stderr)
                return 2
            findings.extend(run_global_passes(repo_root, rules=glob_rules,
                                              device=device))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))

    if args.write_baseline:
        Baseline.from_findings(
            findings, justification="TODO: justify or fix").save(
                args.write_baseline)
        print(f"wrote {len(findings)} finding(s) to {args.write_baseline}"
              " — fill in every justification before committing")
        return 0

    baselined = 0
    if args.baseline:
        base_path = args.baseline
        if not os.path.isabs(base_path):
            base_path = os.path.join(repo_root, base_path)
        try:
            base = Baseline.load(base_path)
        except OSError as e:
            print(f"error: baseline {base_path}: {e}", file=sys.stderr)
            return 2
        except BaselineError as e:
            print(f"error: {e}", file=sys.stderr)
            return 2
        kept = base.filter(findings)
        baselined = len(findings) - len(kept)
        findings = kept

    if args.format == "json":
        print(json.dumps({
            "findings": [f.to_dict() for f in findings],
            "baselined": baselined,
        }, indent=2, sort_keys=True))
    else:
        for f in findings:
            print(f.format())
        tail = f" ({baselined} baselined)" if baselined else ""
        print(f"{len(findings)} finding(s){tail}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main())
