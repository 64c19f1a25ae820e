"""Findings, inline suppressions and the committed baseline (the port's
own copy of the JAX package's ``analysis/findings.py``: same syntax, same
baseline format, so one ``# repro: ignore[rule-id]`` comment serves both
checkers).

A :class:`Finding` is one rule violation at one source location.  Passes
produce them; the runner (``repro_torch.analysis.registry``) filters them
through two escape hatches before they can fail a run:

  * **inline suppressions** — ``# repro: ignore[rule-id]`` on the
    flagged line (or ``# repro: ignore`` to silence every rule there).
    Suppressions are for sites where the invariant genuinely does not
    apply; the comment itself is the justification's anchor.
  * **the baseline** — a committed JSON file of grandfathered findings
    (``analysis-baseline-torch.json`` at the repo root).  Every entry
    must carry a written ``justification``; the CLI refuses a baseline
    with empty ones.  Baseline entries match by *fingerprint* (rule id,
    relative path, stripped source line text) rather than line number,
    so unrelated edits above a grandfathered site don't resurrect it.

New findings — anything not suppressed and not baselined — exit the CLI
nonzero, which is what makes the checker a tripwire for the invariants
instead of a dashboard.
"""
from __future__ import annotations

import dataclasses
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

SEVERITIES = ("error", "warning")

# `# repro: ignore` or `# repro: ignore[rule-a, rule-b]`
_SUPPRESS_RE = re.compile(
    r"#\s*repro:\s*ignore(?:\[([A-Za-z0-9_,\s-]*)\])?")

BASELINE_VERSION = 1
DEFAULT_BASELINE = "analysis-baseline-torch.json"


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation: ``rule`` is the registry id (kebab-case),
    ``path`` is repo-relative, ``line`` is 1-based, ``snippet`` is the
    stripped source line (the baseline fingerprint component)."""
    rule: str
    path: str
    line: int
    message: str
    severity: str = "error"
    snippet: str = ""

    def __post_init__(self):
        if self.severity not in SEVERITIES:
            raise ValueError(f"severity {self.severity!r} not in {SEVERITIES}")

    @property
    def fingerprint(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def format(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}[{self.rule}] "
                f"{self.message}")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def parse_suppressions(source: str) -> Dict[int, Optional[frozenset]]:
    """Line -> suppressed rule ids (``None`` = all rules) for one file.
    Only the flagged line's own trailing comment counts — a suppression
    can't silently cover a whole block."""
    out: Dict[int, Optional[frozenset]] = {}
    for i, line in enumerate(source.splitlines(), 1):
        m = _SUPPRESS_RE.search(line)
        if not m:
            continue
        rules = m.group(1)
        if rules is None:
            out[i] = None
        else:
            out[i] = frozenset(r.strip() for r in rules.split(",") if r.strip())
    return out


def is_suppressed(f: Finding, suppressions: Dict[int, Optional[frozenset]]) -> bool:
    rules = suppressions.get(f.line, False)
    if rules is False:
        return False
    return rules is None or f.rule in rules


class BaselineError(ValueError):
    """The baseline file is malformed or carries unjustified entries."""


class Baseline:
    """Grandfathered findings, keyed by fingerprint with per-key counts
    (two identical offending lines in one file need a count of 2)."""

    def __init__(self, entries: Sequence[dict] = ()):
        self.entries = list(entries)
        self._counts: Dict[Tuple[str, str, str], int] = {}
        for e in self.entries:
            fp = (e["rule"], e["path"], e.get("snippet", ""))
            self._counts[fp] = self._counts.get(fp, 0) + int(e.get("count", 1))

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as fh:
            doc = json.load(fh)
        if doc.get("version") != BASELINE_VERSION:
            raise BaselineError(
                f"{path}: baseline version {doc.get('version')!r}, "
                f"expected {BASELINE_VERSION}")
        entries = doc.get("findings", [])
        for e in entries:
            for field in ("rule", "path"):
                if not e.get(field):
                    raise BaselineError(f"{path}: entry missing {field!r}: {e}")
            just = str(e.get("justification", "")).strip()
            if not just or just.upper().startswith("TODO"):
                raise BaselineError(
                    f"{path}: baselined finding {e['rule']} at {e['path']} "
                    f"has no written justification — every grandfathered "
                    f"finding must say why it is allowed to stand "
                    f"(--write-baseline emits TODO placeholders on "
                    f"purpose; fill them in)")
        return cls(entries)

    @classmethod
    def from_findings(cls, findings: Sequence[Finding],
                      justification: str = "TODO: justify") -> "Baseline":
        counts: Dict[Tuple[str, str, str], int] = {}
        for f in findings:
            counts[f.fingerprint] = counts.get(f.fingerprint, 0) + 1
        entries = [
            {"rule": rule, "path": path, "snippet": snippet, "count": n,
             "justification": justification}
            for (rule, path, snippet), n in sorted(counts.items())
        ]
        return cls(entries)

    def save(self, path: str) -> None:
        doc = {"version": BASELINE_VERSION, "findings": self.entries}
        with open(path, "w") as fh:
            json.dump(doc, fh, indent=2, sort_keys=True)
            fh.write("\n")

    def filter(self, findings: Sequence[Finding]) -> List[Finding]:
        """Findings NOT covered by the baseline (new findings).  Each
        baseline entry absorbs at most ``count`` matching findings."""
        budget = dict(self._counts)
        fresh = []
        for f in findings:
            if budget.get(f.fingerprint, 0) > 0:
                budget[f.fingerprint] -= 1
            else:
                fresh.append(f)
        return fresh
