"""repro_torch.analysis — static invariant checker for the PyTorch port
(the counterpart of the JAX package's ``repro.analysis``).

Enforces, before the card, the contracts the port's runtime gates only
catch after the fact: clock unification (``no-raw-time``),
process-stable persisted keys (``no-builtin-hash-persistence``),
policy-not-thread-local serving state (``no-thread-local-serving``),
zero-cost-when-off telemetry (``hot-path-zero-cost``), no host sync in
the code the captured steps run (``host-sync-in-step``), pool writes
that stay in place and every capture a counted build with stable keys
(``graph-in-place``, ``graph-keys``), and kernel launch geometry inside
the H100's limits (``launch-geometry``).

Run ``python -m repro_torch.analysis --help``; suppress a single line
with ``# repro: ignore[rule-id]`` (the JAX checker's syntax: one comment
serves both); grandfather findings in ``analysis-baseline-torch.json``
(every entry needs a written justification).
"""
from repro_torch.analysis.findings import (Baseline, BaselineError, Finding,
                                           is_suppressed, parse_suppressions)
from repro_torch.analysis.registry import (AnalysisError, AstPass,
                                           GlobalPass, ast_passes,
                                           find_repo_root, global_passes,
                                           register, run_ast_passes,
                                           run_global_passes)

__all__ = [
    "AnalysisError", "AstPass", "Baseline", "BaselineError", "Finding",
    "GlobalPass", "ast_passes", "find_repo_root", "global_passes",
    "is_suppressed", "parse_suppressions", "register", "run_ast_passes",
    "run_global_passes",
]
