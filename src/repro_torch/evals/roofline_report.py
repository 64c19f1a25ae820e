"""Roofline report: renders the port's dry-run JSONL records into the
§Roofline table (per arch x shape x mesh: three terms, bottleneck,
useful-FLOPs ratio, MFU, whether the peak fits one card's memory); port
of the JAX package's ``benchmarks/roofline_report.py``.

The records are ``python -m repro_torch.launch.dryrun --out``'s, at
sparsity 0 into :data:`BASE` and 0.5 into :data:`SPARSE`; the JAX dry
run's records live under other names and are never rendered here.  The
terms are H100 SXM data-sheet predictions (``launch/roofline.Roofline``)
and the fit column holds the peak against ``CARD_HBM_BYTES``."""
from __future__ import annotations

import json
import os

from repro_torch.device import resolve_device
from repro_torch.launch.constants import CARD_HBM_BYTES

BASE = "experiments/torch_dryrun_baseline.jsonl"
SPARSE = "experiments/torch_dryrun_sparse.jsonl"


def load(path):
    recs = {}
    if not os.path.exists(path):
        return recs
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            key = (r["arch"], r["shape"], r["mesh"], r.get("sparsity", 0.0))
            recs[key] = r            # later records win (re-runs)
    return recs


def fmt_row(r):
    rl = r["roofline"]
    peak = r["memory"]["peak_bytes_estimate"]
    fits = "OK" if peak <= CARD_HBM_BYTES else "OVER"
    return (f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
            f"{rl['compute_s']*1e3:.2f} | {rl['memory_s']*1e3:.2f} | "
            f"{rl['collective_s']*1e3:.2f} | {rl['bottleneck']} | "
            f"{rl['useful_ratio']:.2f} | {rl['mfu']:.3f} | "
            f"{peak / 2**30:.2f} {fits} |")


HEADER = ("| arch | shape | mesh | compute ms | memory ms | coll ms | "
          "bottleneck | useful | MFU | peak GiB/card |\n"
          "|---|---|---|---|---|---|---|---|---|---|")


def render(log=print, sparsity=0.0, path=BASE):
    recs = load(path)
    log(HEADER)
    n_ok = n_err = 0
    for key in sorted(recs):
        r = recs[key]
        if key[3] != sparsity:
            continue
        if r.get("status") != "ok":
            log(f"| {key[0]} | {key[1]} | {key[2]} | FAILED: "
                f"{r.get('error', '?')[:60]} |")
            n_err += 1
            continue
        log(fmt_row(r))
        n_ok += 1
    return n_ok, n_err


def run(log=print, device="cuda"):
    """The report's rows (a host-side driver: ``device`` is resolved as
    every driver's is, and nothing runs on it)."""
    resolve_device(device)
    rows = []
    for name, path, sp in (("baseline", BASE, 0.0),
                           ("sparse50", SPARSE, 0.5)):
        if not os.path.exists(path):
            continue
        log(f"\n== roofline {name} ==")
        ok, err = render(log, sparsity=sp, path=path)
        rows.append((f"roofline/{name}/cells_ok", 0.0, str(ok)))
        rows.append((f"roofline/{name}/cells_failed", 0.0, str(err)))
    # always-present coverage row
    rows.append(("roofline/reports_rendered", 0.0, str(len(rows) // 2)))
    return rows


if __name__ == "__main__":
    run()
