"""``python -m repro_torch.evals [--only NAME] [--device cpu]``: the
paper's evaluation drivers' ``name,us_per_call,derived`` rows, in the
order and format of the JAX package's ``benchmarks/run.py``.  Each
driver's log goes to stderr; a driver that raises is reported there and
makes the command exit non-zero after the rows of the others."""
from __future__ import annotations

import argparse
import importlib
import sys
import traceback

from repro_torch.device import resolve_device

MODULES = [
    "repro_torch.evals.table1_accuracy",
    "repro_torch.evals.table2_ablation",
    "repro_torch.evals.fig3_sensitivity",
    "repro_torch.evals.fig4_efficiency",
    "repro_torch.evals.fig6_alpha",
    "repro_torch.evals.roofline_report",
]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(prog="repro_torch.evals")
    ap.add_argument("--only", default=None,
                    help="run the drivers whose module name holds this")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu is an opt-in)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    all_rows = []
    failed = []
    for mod_name in MODULES:
        if args.only and args.only not in mod_name:
            continue
        print(f"# === {mod_name} ===", file=sys.stderr, flush=True)
        try:
            mod = importlib.import_module(mod_name)
            all_rows.extend(mod.run(log=lambda *a: print(
                *a, file=sys.stderr, flush=True), device=dev))
        except Exception:
            traceback.print_exc()
            failed.append(mod_name)
    print("name,us_per_call,derived")
    for name, us, derived in all_rows:
        print(f"{name},{us:.1f},{derived}")
    if failed:
        raise SystemExit(f"evaluation drivers failed: {failed}")
    return all_rows


if __name__ == "__main__":
    main()
