"""The port's static-analysis gate (stellar_tpu_torch/analysis) against the
JAX package's (stellar_tpu/analysis), on this CPU host.

1. The gate itself: the port's analyzer over the whole ``stellar_tpu_torch``
   package reports zero unsuppressed violations, as
   tests/test_analysis.py::test_analysis_clean does for the JAX package.
2. The seam: the port scopes its path-scoped rules by the path after the
   last ``stellar_tpu`` or ``stellar_tpu_torch`` segment, so a violation
   planted in a ``stellar_tpu_torch/ledger/`` file fires; the JAX
   package's analyzer does not see that path as ``ledger/``.
3. The rules: every rule fixture of tests/analysis_fixtures gives the same
   violations (rule, line) under both analyzers.
4. The port's own ``# analysis: locked-by _wedge_lock`` markers
   (crypto/sigbackend.py) are enforced.

Tolerance: exact — equal rule ids, lines and counts.
"""

import json
import os
import re
import subprocess
import sys

import pytest

import stellar_tpu_torch
from stellar_tpu.analysis import analyze_paths as jax_analyze_paths
from stellar_tpu.analysis import analyze_source as jax_analyze_source
from stellar_tpu_torch.analysis import analyze_paths, analyze_source, rule_ids
from stellar_tpu_torch.analysis.__main__ import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "analysis_fixtures")
PKG_DIR = os.path.dirname(os.path.abspath(stellar_tpu_torch.__file__))
WALL_CLOCK = "import time\n\n\ndef f():\n    return time.time()\n"


def _hits(report):
    return sorted((v.rule, v.line) for v in report.violations)


def test_analysis_clean():
    """The port carries zero unsuppressed violations, with >=6 rules active
    over the full module + native-C surface, and every suppression has its
    rationale."""
    report = analyze_paths([PKG_DIR])
    assert not report.parse_errors, report.parse_errors
    assert not report.violations, "\n".join(v.render() for v in report.violations)
    assert len(report.rules) >= 6
    assert report.files_scanned > 100  # the whole package, not a subdir
    assert all(s.rationale for s in report.suppressed)


@pytest.mark.parametrize("plane", ["ledger", "scp", "history", "scenarios"])
def test_path_scoped_rule_fires_on_a_port_path(tmp_path, plane):
    """A wall-clock read planted in ``stellar_tpu_torch/<plane>/`` is a
    determinism violation for the port's analyzer; for the JAX package's,
    which scopes by the last ``stellar_tpu`` segment only, the path falls
    through to its basename and the rule stays silent."""
    d = tmp_path / "stellar_tpu_torch" / plane
    d.mkdir(parents=True)
    (d / "planted.py").write_text(WALL_CLOCK)
    port = analyze_paths([str(tmp_path)])
    assert [v.rule for v in port.violations] == ["determinism"]
    assert port.violations[0].path.endswith(f"stellar_tpu_torch/{plane}/planted.py")
    assert not jax_analyze_paths([str(tmp_path)]).violations
    # outside a scoped plane the rule does not fire for either
    (d / "planted.py").unlink()
    other = tmp_path / "stellar_tpu_torch" / "util"
    other.mkdir()
    (other / "planted.py").write_text(WALL_CLOCK)
    assert not analyze_paths([str(tmp_path)]).violations


def test_jax_paths_scope_the_same(tmp_path):
    """Under a ``stellar_tpu/`` path both analyzers scope alike."""
    d = tmp_path / "stellar_tpu" / "herder"
    d.mkdir(parents=True)
    (d / "planted.py").write_text(WALL_CLOCK)
    assert _hits(analyze_paths([str(tmp_path)])) == _hits(
        jax_analyze_paths([str(tmp_path)])
    ) == [("determinism", 5)]


def _fixtures():
    return sorted(f for f in os.listdir(FIXTURES) if f.endswith((".py", ".c")))


@pytest.mark.parametrize("name", _fixtures())
def test_rule_fixture_matches_jax(name):
    path = os.path.join(FIXTURES, name)
    text = open(path).read()
    m = re.search(r"analysis-fixture-path:\s*(\S+)", text)
    assert m, name
    port = analyze_source(text, m.group(1), path=path)
    jax = jax_analyze_source(text, m.group(1), path=path)
    assert _hits(port) == _hits(jax)
    assert len(port.suppressed) == len(jax.suppressed)
    assert bool(port.violations) == ("_pos." in name)


def test_wedge_lock_markers_are_enforced():
    """The port's gpu backend declares its stall latch and counters locked by
    ``_wedge_lock``; an access outside ``with self._wedge_lock`` is a
    locked-field violation."""
    rel = "crypto/sigbackend.py"
    src = open(os.path.join(PKG_DIR, rel)).read()
    assert src.count("# analysis: locked-by _wedge_lock") == 6
    assert not analyze_source(src, rel).violations
    planted = src.replace(
        "    def stats(self) -> dict:\n        s = self._verifier.stats()\n",
        "    def stats(self) -> dict:\n        self._wedged_until.clear()\n"
        "        s = self._verifier.stats()\n",
    )
    assert planted != src
    assert [v.rule for v in analyze_source(planted, rel).violations] == ["locked-field"]


def test_cli_defaults_to_the_port(capsys):
    assert cli_main(["--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert doc["clean"] and doc["files_scanned"] > 100
    assert cli_main(["--rules"]) == 0
    out = capsys.readouterr().out
    assert all(rid in out for rid in rule_ids())


def test_cli_module_exit_codes(tmp_path):
    """``python -m stellar_tpu_torch.analysis``: 0 clean, 1 on a planted
    violation under a port path."""
    d = tmp_path / "stellar_tpu_torch" / "overlay"
    d.mkdir(parents=True)
    f = d / "clean.py"
    f.write_text("def f(app):\n    return app.clock.now()\n")
    base = [sys.executable, "-m", "stellar_tpu_torch.analysis", str(tmp_path), "--json"]
    p = subprocess.run(base, capture_output=True, text=True, cwd=REPO, timeout=120)
    assert p.returncode == 0, p.stdout + p.stderr
    assert json.loads(p.stdout)["files_scanned"] == 1
    f.write_text(WALL_CLOCK)
    p = subprocess.run(base, capture_output=True, text=True, cwd=REPO, timeout=120)
    assert p.returncode == 1, p.stdout + p.stderr
    assert [v["rule"] for v in json.loads(p.stdout)["violations"]] == ["determinism"]
