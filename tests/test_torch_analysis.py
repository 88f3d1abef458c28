"""The port's linter (``repro_torch.analysis``): every rule fires on its
bad fixture and stays silent on its good twin, and the engine — a copy of
``repro.analysis.engine`` — is held against the reference's on the same
sources: suppressions, the syntax-error finding, the JSON report and the
framework-neutral rule (numpy's legacy rng) give the same rule ids, lines,
columns and keys.  The CLI's exit codes are the reference's, and the port's
own tree lints clean through the real module invocation."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
from repro.analysis.__main__ import main as ref_cli
from repro_torch.analysis import (RULES, lint_file, lint_paths, lint_source,
                                  render_human, render_json)
from repro_torch.analysis.__main__ import main as cli_main
from repro_torch.analysis.engine import (DEFAULT_EXCLUDED_DIRS,
                                         iter_python_files)

REPO = Path(__file__).resolve().parent.parent
FIXTURES = REPO / "tests" / "fixtures" / "torch_analysis"

#: rule id → (bad fixture, good fixture, minimum error count): one for each
#: reference rule, the counterpart named in the rules module's table
RULE_FIXTURES = {
    "no-silent-rebuild": ("rebuild_bad.py", "rebuild_good.py", 3),
    "dtype-discipline": ("sim/dtype_bad.py", "sim/dtype_good.py", 5),
    "checkpoint-purity": ("purity_bad.py", "purity_good.py", 4),
    "hidden-host-sync": ("hostsync_bad.py", "hostsync_good.py", 4),
    "rng-discipline": ("rng_bad.py", "rng_good.py", 5),
    "kernel-wrapper-constraints": ("kernels_bad.py", "kernels_good.py", 6),
}
#: the float64 oracle's half of dtype-discipline (its path decides)
ORACLE = ("oracle_bad/core/costmodel.py", "oracle_good/core/costmodel.py", 3)
BAD = [bad for bad, _, _ in RULE_FIXTURES.values()] + [ORACLE[0]]


def _rows(findings):
    return [(f.rule, f.severity, f.line, f.col, f.message) for f in findings]


# -- rule catalog --------------------------------------------------------------

def test_one_counterpart_per_reference_rule():
    assert set(RULES) == set(RULE_FIXTURES)
    assert len(RULES) == len(ref_analysis.RULES) == 6
    for r in RULES.values():
        assert r.severity in ("error", "warning")
        assert r.summary
    # the rules whose hazard is the same keep the reference's id
    assert {"dtype-discipline", "hidden-host-sync", "rng-discipline"} \
        <= set(RULES) & set(ref_analysis.RULES)


# -- per-rule bad + good fixtures ----------------------------------------------

@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_rule_triggers_on_bad_fixture(rule_id):
    bad, _, min_errors = RULE_FIXTURES[rule_id]
    findings, _ = lint_file(FIXTURES / bad)
    errors = [f for f in findings if f.rule == rule_id
              and f.severity == "error"]
    assert len(errors) >= min_errors, [f.render() for f in findings]
    # the fixture triggers ONLY its own rule
    assert {f.rule for f in findings} == {rule_id}, \
        [f.render() for f in findings]


@pytest.mark.parametrize("rule_id", sorted(RULE_FIXTURES))
def test_rule_silent_on_good_fixture(rule_id):
    _, good, _ = RULE_FIXTURES[rule_id]
    findings, _ = lint_file(FIXTURES / good)
    assert findings == [], [f.render() for f in findings]


def test_oracle_half_of_dtype_discipline():
    findings, _ = lint_file(FIXTURES / ORACLE[0])
    assert len(findings) == ORACLE[2]
    assert {f.rule for f in findings} == {"dtype-discipline"}
    assert lint_file(FIXTURES / ORACLE[1])[0] == []


@pytest.mark.parametrize("rule_id,severities", [
    ("no-silent-rebuild", {"error", "warning"}),
    ("hidden-host-sync", {"error", "warning"}),
])
def test_severities(rule_id, severities):
    """A loop-invariant rebuild / a tensor pulled per iteration is an
    error; a per-iteration program / a receiver of unknown device only a
    warning (suppressible)."""
    findings, _ = lint_file(FIXTURES / RULE_FIXTURES[rule_id][0])
    assert {f.severity for f in findings} == severities


def test_c1_products_need_a_dominating_guard():
    """The FP32 guard counts only where it runs before the product on every
    path: a guard in another branch, or after the product, does not."""
    src = ("import torch\n"
           "from repro_torch.core.torchmodel import require_fp32_matmul\n"
           "def f(x, w, weighted):\n"
           "    if not weighted:\n"
           "        return x @ w\n"
           "    require_fp32_matmul(x, 'the product')\n"
           "    return torch.matmul(x, w)\n")
    findings, _ = lint_source("src/repro_torch/sim/f.py", src)
    assert [(f.rule, f.line) for f in findings] == [("dtype-discipline", 5)]
    # outside core/, sim/ and search/ the product is not the cost model's
    assert lint_source("src/repro_torch/models/f.py", src)[0] == []


def test_kernel_helper_moves_the_check_to_its_callers():
    """``_launch(name, tensors)`` hands its tuple's pointers to the launch:
    the tensors are checked where the tuple is built, not in the helper."""
    src = (FIXTURES / "kernels_bad.py").read_text()
    findings, _ = lint_source("kernels_bad.py", src)
    helper = [f for f in findings if "`y`" in f.message]
    lines = src.splitlines()
    assert [lines[f.line - 1].strip() for f in helper] == [
        "_lib.k_launch(x.data_ptr(), y.data_ptr(), out.data_ptr())  "
        "# y: no check",
        '_launch("k", (x, y))  # y reaches the helper unchecked']


# -- the engine against the reference's -----------------------------------------

_TRIGGER = "import numpy as np\nx = np.random.rand(3){}\n"
_SOURCES = {
    "plain": _TRIGGER.format(""),
    "same-line": _TRIGGER.format("  # repro: ignore[rng-discipline]"),
    "bare": _TRIGGER.format("  # repro: ignore"),
    "file-level": "# repro: ignore-file[rng-discipline]\n"
                  + _TRIGGER.format(""),
    "other-rule": _TRIGGER.format("  # repro: ignore[hidden-host-sync]"),
    "syntax": "def broken(:\n",
    "legacy-rng": (FIXTURES / "rng_bad.py").read_text(),
}


@pytest.mark.parametrize("case", sorted(_SOURCES))
def test_engine_matches_the_reference(case):
    """Suppressions (same-line, bare, file-level, another rule's id), the
    syntax-error finding and numpy's legacy rng: the same rows and the same
    suppressed count from both engines, restricted to the rule they share
    (the syntax finding is not a rule: it always comes)."""
    src = _SOURCES[case]
    ours, n_ours = lint_source("t.py", src, select={"rng-discipline"})
    theirs, n_theirs = ref_analysis.lint_source("t.py", src,
                                                select={"rng-discipline"})
    mine = [r for r in _rows(ours) if r[0] != "rng-discipline"
            or "np.random" in r[4]]
    assert mine == _rows(theirs) and n_ours == n_theirs
    expect = {"plain": 1, "same-line": 0, "bare": 0, "file-level": 0,
              "other-rule": 1, "syntax": 1, "legacy-rng": 2}[case]
    assert len(theirs) == expect


def test_syntax_error_is_a_finding():
    findings, _ = lint_source("t.py", "def broken(:\n")
    assert findings[0].rule == "syntax" and findings[0].severity == "error"


def test_json_report_schema_matches_the_reference():
    path = FIXTURES / "rng_bad.py"
    ours = json.loads(render_json(lint_paths([path])))
    theirs = json.loads(ref_analysis.render_json(
        ref_analysis.lint_paths([path])))
    assert ours["version"] == theirs["version"] == 1
    assert set(ours) == set(theirs) == {"version", "paths", "files_checked",
                                        "counts", "findings"}
    assert set(ours["counts"]) == set(theirs["counts"]) \
        == {"error", "warning", "suppressed"}
    assert ours["files_checked"] == theirs["files_checked"] == 1
    assert ours["counts"]["error"] == 5 and theirs["counts"]["error"] == 2
    for row in ours["findings"]:
        assert set(row) == {"rule", "severity", "path", "line", "col",
                            "message"}
        assert row["rule"] in RULES and row["line"] >= 1
    # the numpy rows are the reference's, row for row
    numpy_rows = [r for r in ours["findings"] if "np.random" in r["message"]]
    assert numpy_rows == theirs["findings"]
    assert render_human(lint_paths([path])).endswith(
        "5 error(s), 0 warning(s), 0 suppressed — 1 file(s) checked")


def test_fixture_dirs_excluded_by_default():
    walked = list(iter_python_files([REPO / "tests"]))
    assert not any("fixtures" in f.parts for f in walked)
    assert DEFAULT_EXCLUDED_DIRS == ref_analysis.engine.DEFAULT_EXCLUDED_DIRS
    assert lint_paths([FIXTURES])["files_checked"] == 0
    report = lint_paths([FIXTURES], excluded_dirs=frozenset())
    assert report["files_checked"] == 14 and report["counts"]["error"] >= 30


# -- the CLI --------------------------------------------------------------------

@pytest.mark.parametrize("argv,code", [
    (["--select", "not-a-rule", "FIX"], 2),
    (["--list-rules"], 0),
    (["FIX/rng_good.py"], 0),
    (["FIX/hostsync_bad.py", "--select", "rng-discipline"], 0),
])
def test_cli_exit_codes_match_the_reference(argv, code, capsys):
    argv = [a.replace("FIX", str(FIXTURES)) for a in argv]
    assert cli_main(argv) == code
    assert ref_cli(argv) == code


def test_cli_list_rules(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in RULE_FIXTURES:
        assert rid in out


@pytest.mark.parametrize("bad", BAD)
def test_cli_bad_fixture_fails_json(bad, capsys):
    rc = cli_main(["--json", str(FIXTURES / bad)])
    assert rc == 1
    blob = json.loads(capsys.readouterr().out)
    assert blob["counts"]["error"] >= 3


def test_cli_strict_fails_on_warnings(tmp_path, capsys):
    """Warnings alone pass, and fail under --strict, as the reference's."""
    f = tmp_path / "w.py"
    f.write_text("import torch\n"
                 "def g(xs):\n"
                 "    return [x.item() for x in xs]\n")
    assert cli_main([str(f)]) == 0
    assert cli_main(["--strict", str(f)]) == 1


def test_port_tree_lints_clean_via_module_invocation():
    """Acceptance: ``python -m repro_torch.analysis src/repro_torch`` exits
    0 — and so does the bare command, whose default path is the port."""
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"}
    for args in (["src/repro_torch"], []):
        proc = subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", *args],
            cwd=REPO, capture_output=True, text=True, env=env)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "0 error(s), 0 warning(s)" in proc.stdout
