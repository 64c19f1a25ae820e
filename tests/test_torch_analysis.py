"""repro_torch.analysis, the port's static checker: corpus precision,
the four rules it shares with the JAX checker held against that checker
(``repro.analysis``) on the JAX corpus renamed to the port's paths,
suppressions, baseline semantics, and the CLI's rows and exit codes
against the JAX CLI's.

The corpus test is *exact*: the AST passes must flag every line marked
``# EXPECT: <rule-id>`` of an AST rule under
``tests/torch_analysis_corpus`` and nothing else."""
import json
import os
import re
import shutil

import pytest

from repro.analysis import run_ast_passes as jax_run_ast_passes
from repro.analysis.cli import main as jax_cli_main
from repro_torch.analysis import (Baseline, BaselineError, Finding,
                                  is_suppressed, parse_suppressions,
                                  run_ast_passes)
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.registry import ast_passes
from torch_threads import one_thread_module  # noqa: F401 (autouse)

HERE = os.path.dirname(__file__)
REPO = os.path.abspath(os.path.join(HERE, os.pardir))
CORPUS = os.path.join(HERE, "torch_analysis_corpus")
JAX_CORPUS = os.path.join(HERE, "analysis_corpus")
SHARED = ("no-raw-time", "no-builtin-hash-persistence",
          "no-thread-local-serving", "hot-path-zero-cost")

_EXPECT_RE = re.compile(r"#\s*EXPECT:\s*([A-Za-z0-9-]+)")


def expected_findings(root=CORPUS, rules=None):
    """(path, line, rule) of every EXPECT marker under ``root/src``
    (of ``rules`` only, when given)."""
    expected = set()
    for dirpath, _, files in os.walk(os.path.join(root, "src")):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            with open(path) as fh:
                for i, line in enumerate(fh, 1):
                    m = _EXPECT_RE.search(line)
                    if m and (rules is None or m.group(1) in rules):
                        expected.add((rel, i, m.group(1)))
    return expected


def renamed_jax_corpus(tmp_path):
    """A copy of the JAX corpus with ``src/repro`` renamed to
    ``src/repro_torch`` (and a pyproject.toml, for the CLIs)."""
    dst = tmp_path / "renamed"
    shutil.copytree(JAX_CORPUS, dst)
    os.rename(dst / "src" / "repro", dst / "src" / "repro_torch")
    (dst / "pyproject.toml").write_text("")
    return str(dst)


def _port_path(path: str) -> str:
    return path.replace("src/repro/", "src/repro_torch/", 1)


# ---------------------------------------------------------------------------
# AST passes: corpus precision
# ---------------------------------------------------------------------------

def test_corpus_flags_exactly_the_marked_lines():
    expected = expected_findings(rules=set(ast_passes()))
    assert expected, "corpus has no EXPECT markers — did the files move?"
    got = {(f.path, f.line, f.rule)
           for f in run_ast_passes(CORPUS, roots=("src",))}
    assert not expected - got, f"rules failed to flag: {expected - got}"
    assert not got - expected, f"rules over-flagged: {got - expected}"


def test_corpus_covers_every_ast_rule():
    covered = {rule for _, _, rule in expected_findings()}
    assert set(ast_passes()) <= covered
    assert set(ast_passes()) == set(SHARED) | {"host-sync-in-step"}


def test_shared_rules_agree_with_the_jax_checker(tmp_path):
    """On the JAX corpus renamed to the port's paths, the four shared
    rules give exactly the (line, rule) set the JAX checker gives on the
    original."""
    want = {(_port_path(f.path), f.line, f.rule)
            for f in jax_run_ast_passes(JAX_CORPUS, roots=("src",),
                                        rules=list(SHARED))}
    assert want == {(_port_path(p), i, r) for p, i, r in
                    expected_findings(JAX_CORPUS, SHARED)}
    got = {(f.path, f.line, f.rule)
           for f in run_ast_passes(renamed_jax_corpus(tmp_path),
                                   roots=("src",), rules=list(SHARED))}
    assert got == want


def test_the_jax_checker_does_not_see_the_port_paths():
    """The reverse: the JAX rules scoped to its paths (hot path, clock)
    stay off the port corpus, which is why the port has rules of its
    own.  Its engine's hot-path trigger is found by the port only."""
    jax_got = {(f.path, f.rule) for f in jax_run_ast_passes(
        CORPUS, roots=("src",), rules=["hot-path-zero-cost"])}
    assert jax_got == set()
    port = {(f.path, f.rule) for f in run_ast_passes(
        CORPUS, roots=("src",), rules=["hot-path-zero-cost"])}
    assert port == {("src/repro_torch/serving/engine.py",
                     "hot-path-zero-cost")}


@pytest.mark.parametrize("source,flagged", [
    ("def f(x: torch.Tensor):\n    return x.max().item()\n", True),
    ("def f(x: torch.Tensor):\n    return int(x.shape[0])\n", False),
    ("def f(x: torch.Tensor):\n    if x is None:\n        return 0\n", False),
    ("def f(x: torch.Tensor):\n    return x[x > 0]\n", True),
    ("def f(x: torch.Tensor):\n    x[x > 0] = 0\n    return x\n", False),
    ("def f(x: torch.Tensor):\n    return torch.where(x > 0, x, 0)\n", False),
    ("def f(a):\n    return np.asarray(a).tolist()\n", False),
    ("def f(x: torch.Tensor):\n    n = x.numel()\n    if n > 4:\n"
     "        return x\n", False),
])
def test_host_sync_cases(tmp_path, source, flagged):
    """Each construct alone in a model file: flagged or legal."""
    d = tmp_path / "src" / "repro_torch" / "models"
    d.mkdir(parents=True)
    (d / "m.py").write_text("import numpy as np\nimport torch\n\n" + source)
    got = run_ast_passes(str(tmp_path), roots=("src",),
                         rules=["host-sync-in-step"])
    assert bool(got) == flagged, got


def test_host_sync_scope(tmp_path):
    """The rule covers models/, kernels/ (not the nvcc build) and
    core/sparse_linear.py, the code the captured steps run."""
    body = "import torch\n\ndef f(x: torch.Tensor):\n    return x.item()\n"
    for rel in ("models/a.py", "kernels/b.py", "kernels/build.py",
                "core/sparse_linear.py", "core/calibration.py",
                "serving/engine.py"):
        path = tmp_path / "src" / "repro_torch" / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(body)
    got = {f.path for f in run_ast_passes(str(tmp_path), roots=("src",),
                                          rules=["host-sync-in-step"])}
    assert got == {"src/repro_torch/models/a.py",
                   "src/repro_torch/kernels/b.py",
                   "src/repro_torch/core/sparse_linear.py"}


def test_inline_suppression_silences_one_rule_on_one_line():
    src = ("import time\n"
           "a = time.time()  # repro: ignore[no-raw-time]\n"
           "b = time.time()  # repro: ignore[some-other-rule]\n"
           "c = time.time()  # repro: ignore\n")
    sup = parse_suppressions(src)

    def f(line):
        return Finding(rule="no-raw-time", path="x.py", line=line,
                       message="m")

    assert is_suppressed(f(2), sup)
    assert not is_suppressed(f(3), sup)
    assert is_suppressed(f(4), sup)
    assert not is_suppressed(f(1), sup)


def test_one_suppression_serves_both_checkers(tmp_path):
    """The port's clock module carries the JAX checker's inline ignores;
    the port exempts the module, the JAX checker honours the comments."""
    clock = os.path.join(REPO, "src", "repro_torch", "obs", "clock.py")
    d = tmp_path / "src" / "repro_torch" / "obs"
    d.mkdir(parents=True)
    shutil.copy(clock, d / "clock.py")
    assert run_ast_passes(str(tmp_path), roots=("src",)) == []
    assert jax_run_ast_passes(str(tmp_path), roots=("src",)) == []
    (d / "clock.py").write_text(re.sub(
        r"\s*# repro: ignore\[no-raw-time\].*", "",
        (d / "clock.py").read_text()))
    assert run_ast_passes(str(tmp_path), roots=("src",)) == []
    assert jax_run_ast_passes(str(tmp_path), roots=("src",))


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------

def test_baseline_roundtrip_absorbs_exactly_its_findings(tmp_path):
    findings = run_ast_passes(CORPUS, roots=("src",))
    base = Baseline.from_findings(findings, justification="corpus test")
    assert base.filter(findings) == []
    fresh = Finding(rule="no-raw-time", path="src/new.py", line=3,
                    message="m", snippet="t = time.time()")
    assert base.filter(findings + [fresh]) == [fresh]
    dup = findings[0]
    assert base.filter(findings + [dup]) == [dup]
    path = tmp_path / "base.json"
    base.save(str(path))
    assert Baseline.load(str(path)).filter(findings) == []


def test_baseline_refuses_unjustified_entries(tmp_path):
    path = tmp_path / "base.json"
    path.write_text(json.dumps({
        "version": 1,
        "findings": [{"rule": "host-sync-in-step", "path": "a.py",
                      "snippet": "x", "justification": "  "}],
    }))
    with pytest.raises(BaselineError, match="justification"):
        Baseline.load(str(path))
    path.write_text(json.dumps({"version": 99, "findings": []}))
    with pytest.raises(BaselineError, match="version"):
        Baseline.load(str(path))


def test_baseline_is_line_number_robust():
    f1 = Finding(rule="r", path="p.py", line=10, message="m",
                 snippet="x = hash(k)")
    base = Baseline.from_findings([f1], justification="j")
    moved = Finding(rule="r", path="p.py", line=42, message="m",
                    snippet="x = hash(k)")
    assert base.filter([moved]) == []


def test_port_baseline_ships_empty():
    doc = json.loads(open(os.path.join(REPO,
                                       "analysis-baseline-torch.json")).read())
    assert doc == {"findings": [], "version": 1}
    assert Baseline.load(os.path.join(
        REPO, "analysis-baseline-torch.json")).entries == []


def test_tree_is_clean_under_ast_passes():
    """The acceptance bar: the port carries zero AST findings."""
    assert run_ast_passes(REPO) == []


# ---------------------------------------------------------------------------
# CLI, against the JAX CLI
# ---------------------------------------------------------------------------

def _rows(doc, port):
    """The JSON rows without the message (each checker words its own),
    paths in the port's layout."""
    return sorted((_port_path(f["path"]) if not port else f["path"],
                   f["line"], f["rule"], f["severity"], f["snippet"])
                  for f in doc["findings"])


@pytest.mark.parametrize("rules", [SHARED, SHARED[:1], SHARED[3:]])
def test_cli_rows_and_exit_codes_equal_the_jax_cli(tmp_path, capsys, rules):
    renamed = renamed_jax_corpus(tmp_path)
    (tmp_path / "jc").mkdir()
    shutil.copytree(JAX_CORPUS, tmp_path / "jc" / "c")
    (tmp_path / "jc" / "c" / "pyproject.toml").write_text("")
    common = ["--ast-only", "--format", "json", "--roots", "src",
              "--rules", ",".join(rules)]
    rc_j = jax_cli_main(common + ["--root", str(tmp_path / "jc" / "c")])
    doc_j = json.loads(capsys.readouterr().out)
    rc_t = cli_main(common + ["--root", renamed])
    doc_t = json.loads(capsys.readouterr().out)
    assert rc_j == rc_t == 1
    assert _rows(doc_t, True) == _rows(doc_j, False)
    assert all(f["message"] for f in doc_t["findings"])
    assert doc_t["baselined"] == doc_j["baselined"] == 0


def test_cli_exit_codes_equal_the_jax_cli(tmp_path, capsys):
    """Clean tree 0, unknown rule 2, unjustified baseline 2, justified
    baseline 0, missing root 2: the same codes from both CLIs."""
    renamed = renamed_jax_corpus(tmp_path)
    jc = tmp_path / "jc"
    shutil.copytree(JAX_CORPUS, jc)
    (jc / "pyproject.toml").write_text("")
    clean = tmp_path / "clean"
    (clean / "src").mkdir(parents=True)
    (clean / "pyproject.toml").write_text("")
    rules = ["--rules", ",".join(SHARED), "--roots", "src", "--ast-only"]
    for argv_j, argv_t in [
            (["--root", str(clean)] + rules, ["--root", str(clean)] + rules),
            (["--ast-only", "--root", str(jc), "--rules", "nope"],
             ["--ast-only", "--root", renamed, "--rules", "nope"])]:
        rc_j, rc_t = jax_cli_main(argv_j), cli_main(argv_t)
        assert rc_j == rc_t, (argv_t, rc_j, rc_t)
    capsys.readouterr()
    for root, main, name in ((str(jc), jax_cli_main, "j.json"),
                             (renamed, cli_main, "t.json")):
        base = str(tmp_path / name)
        assert main(rules + ["--root", root, "--write-baseline", base]) == 0
        assert main(rules + ["--root", root, "--baseline", base]) == 2
        doc = json.loads(open(base).read())
        for e in doc["findings"]:
            e["justification"] = "known-bad corpus, grandfathered on purpose"
        with open(base, "w") as fh:
            json.dump(doc, fh)
        assert main(rules + ["--root", root, "--baseline", base]) == 0
        assert main(rules + ["--root", root, "--baseline",
                             str(tmp_path / "missing.json")]) == 2
    out = capsys.readouterr().out
    assert out.count("baselined") == 2


@pytest.mark.parametrize("ast_only", [True, False])
def test_cli_port_corpus_exits_one_with_its_expect_lines(capsys, tmp_path,
                                                         ast_only):
    """The AST passes alone flag the AST rules' EXPECT lines; the whole
    run on the CPU adds graph-keys' capture sites, and so flags every
    EXPECT line of the corpus (its global passes build the port's own
    warmup set, which is clean)."""
    shutil.copytree(CORPUS, tmp_path / "c")
    (tmp_path / "c" / "pyproject.toml").write_text("")
    rc = cli_main(["--root", str(tmp_path / "c"), "--roots", "src",
                   "--format", "json", "--device", "cpu"]
                  + (["--ast-only"] if ast_only else []))
    doc = json.loads(capsys.readouterr().out)
    assert rc == 1
    assert {(f["path"], f["line"], f["rule"]) for f in doc["findings"]} == \
        expected_findings(rules=set(ast_passes()) if ast_only else None)


def test_cli_clean_tree_and_list_rules(capsys):
    assert cli_main(["--ast-only", "--root", REPO, "--baseline"]) == 0
    assert "0 finding(s)" in capsys.readouterr().out
    assert cli_main(["--list-rules"]) == 0
    listed = capsys.readouterr().out
    for rule in SHARED + ("host-sync-in-step", "graph-in-place",
                          "graph-keys", "launch-geometry"):
        assert rule in listed


def test_cli_refuses_cuda_without_a_card(capsys, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli_main(["--root", REPO, "--rules", "launch-geometry"]) == 2
    assert "is_available" in capsys.readouterr().err
