"""mpklint on the port, by the port's own analyzer (``repro_torch.analysis``,
pure stdlib): the committed ``src/repro_torch`` carries zero unsuppressed
findings with no baseline file, as ``tests/test_analysis.py::
test_repo_tree_is_clean`` holds ``src/repro``; every suppression names its
reason; and the gate bites: the port's ``run_world`` waiting a fixed 0.5 s
instead of its remaining budget, or a suppression taken away, is a new
finding.

Parity with the reference's analyzer (``repro.analysis``): the same
findings (rule, path, line, severity, message, fix hint, suppressed) and
the same ``--json`` report, byte for byte, on ``src/repro``, on
``src/repro_torch``, on every fixture of ``tests/fixtures/analysis`` and
on the seeded bugs of ``tests/test_analysis.py``; the port's
``python -m repro_torch.analysis`` defaults to ``src/repro_torch`` and
exits 0 there."""
import functools
import io
import json
import shutil
import subprocess
import sys
import tokenize
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro.analysis.engine as ref_engine
from repro_torch.analysis import analyze_paths
from repro_torch.analysis.engine import run

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
REF = ROOT / "src" / "repro"
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"


def _suppressions(path: Path):
    """The ``# mpklint: disable=`` comments of a module (comments only: the
    analyzer's own docstrings quote the syntax)."""
    toks = tokenize.generate_tokens(io.StringIO(path.read_text()).readline)
    return [t.string for t in toks
            if t.type == tokenize.COMMENT and "mpklint: disable=" in t.string]


@functools.lru_cache(maxsize=None)
def _tree_reports(tree: str):
    """(the port's report, the reference's) on ``src/<tree>``, no
    baseline; each tree is analyzed once a module."""
    path = ROOT / "src" / tree
    return analyze_paths([path]), ref_analysis.analyze_paths([path])


def test_port_tree_is_clean_without_a_baseline():
    report = _tree_reports("repro_torch")[0]
    assert report.parse_errors == []
    assert [f.render() for f in report.new] == []


def test_every_port_suppression_gives_a_reason():
    lines = [(p, c) for p in PORT.rglob("*.py") for c in _suppressions(p)]
    assert len(lines) >= 12
    for path, line in lines:
        reason = line.split("reason=", 1)[1].strip() if "reason=" in line else ""
        assert len(reason) > 10, (path, line)


def test_fixed_poll_wait_in_run_world_fails_mpk106(tmp_path):
    src = (PORT / "launch" / "world.py").read_text()
    old = "timeout=min(0.5, max(0.0, deadline - time.monotonic())))"
    assert old in src
    seeded = tmp_path / "world.py"
    seeded.write_text(src.replace(old, "timeout=0.5)", 1))
    assert any(f.rule == "MPK106" for f in analyze_paths([seeded]).new)


def test_unsuppressed_swallow_fails_mpk105(tmp_path):
    src = (PORT / "core" / "faultwire.py").read_text()
    old = "    # mpklint: disable=MPK105 reason=best-effort peek; malformed routes -> sid 0\n"
    assert old in src
    seeded = tmp_path / "faultwire.py"
    seeded.write_text(src.replace(old, "", 1))
    assert any(f.rule == "MPK105" for f in analyze_paths([seeded]).new)


# ---------------------------------------------------------------------------
# parity with the reference's analyzer
# ---------------------------------------------------------------------------

def _key(report):
    return [(f.rule, f.path, f.line, f.severity, f.message, f.hint,
             f.suppressed, f.baselined) for f in report.findings]


def _same(paths, reports=None):
    """Both analyzers on ``paths`` (or their ``reports``) → the port's
    report, after holding its findings and the JSON report that ``--json``
    prints equal to the reference's."""
    mine, theirs = reports or (analyze_paths(paths),
                               ref_analysis.analyze_paths(paths))
    assert _key(mine) == _key(theirs)
    assert mine.parse_errors == theirs.parse_errors
    assert (json.dumps(mine.to_dict(), indent=2)
            == json.dumps(theirs.to_dict(), indent=2))
    return mine


def _fixture_paths():
    return sorted(p for d in FIXTURES.iterdir() for p in d.iterdir())


@pytest.mark.parametrize("tree", ["repro", "repro_torch"])
def test_same_findings_as_the_reference_on_both_trees(tree):
    report = _same(None, _tree_reports(tree))
    assert report.findings                   # suppressed ones, at least


@pytest.mark.parametrize("path", _fixture_paths(), ids=lambda p: f"{p.parent.name}/{p.name}")
def test_same_findings_as_the_reference_on_every_fixture(path):
    _same([path])


def _seeded_framestats(tmp_path):
    src = (REF / "core" / "framing.py").read_text()
    old = "    def bump(self, **deltas: int) -> None:"
    assert old in src
    seeded = tmp_path / "framing.py"
    seeded.write_text(src.replace(old, old + "\n        self._count += 1", 1))
    return seeded, "MPK001"


def _seeded_wallclock(tmp_path):
    src = (REF / "core" / "transports.py").read_text()
    old = "        slot = ring.slots[self._tickets % ring.capacity]"
    assert old in src
    seeded = tmp_path / "transports.py"
    seeded.write_text(src.replace(
        old, "        deadline = time.time() + 1.0\n" + old, 1))
    return seeded, "MPK103"


def _seeded_spec_drift(tmp_path):
    proj = tmp_path / "proj"
    (proj / "docs").mkdir(parents=True)
    (proj / "src").mkdir()
    shutil.copy(REF / "core" / "framing.py", proj / "src" / "framing.py")
    spec = (ROOT / "docs" / "protocol.md").read_text()
    (proj / "docs" / "protocol.md").write_text(
        spec.replace("0x4D504B4C", "0x4D504BFF"))
    return proj / "src", "MPK201"


def _seeded_port_framing_spec_drift(tmp_path):
    """The port's framing beside a drifted spec: its wire constants are the
    reference's, so the spec rule reads them the same way."""
    proj = tmp_path / "proj_torch"
    (proj / "docs").mkdir(parents=True)
    (proj / "src").mkdir()
    shutil.copy(PORT / "core" / "framing.py", proj / "src" / "framing.py")
    spec = (ROOT / "docs" / "protocol.md").read_text()
    (proj / "docs" / "protocol.md").write_text(
        spec.replace("0x4D504B4C", "0x4D504BFF"))
    return proj / "src", "MPK201"


@pytest.mark.parametrize("seed", [_seeded_framestats, _seeded_wallclock,
                                  _seeded_spec_drift,
                                  _seeded_port_framing_spec_drift],
                         ids=lambda f: f.__name__.lstrip("_"))
def test_same_findings_as_the_reference_on_seeded_bugs(seed, tmp_path):
    path, rule = seed(tmp_path)
    report = _same([path])
    assert any(f.rule == rule for f in report.new)


@pytest.mark.parametrize("args", [
    ["--json", "tests/fixtures/analysis/mpk001/bad.py"],
    ["--json", "tests/fixtures/analysis/mpk201/bad"],
    ["--json", "--baseline", "analysis/baseline.json", "src/repro"],
    ["tests/fixtures/analysis/mpk000/bad.py"], ["no/such/path.py"]],
    ids=["json-bad", "json-spec", "json-baseline", "text-mpk000", "missing"])
def test_cli_report_and_exit_code_equal_the_reference(args, capsys, monkeypatch):
    monkeypatch.chdir(ROOT)
    rc = run(args)
    mine = capsys.readouterr().out
    assert ref_engine.run(args) == rc
    assert capsys.readouterr().out == mine


def test_write_baseline_equals_the_reference(tmp_path, capsys):
    bad = str(FIXTURES / "mpk001" / "bad.py")
    assert run(["--write-baseline", str(tmp_path / "a.json"), bad]) == 0
    assert ref_engine.run(["--write-baseline", str(tmp_path / "b.json"), bad]) == 0
    assert (tmp_path / "a.json").read_text() == (tmp_path / "b.json").read_text()
    assert run(["--baseline", str(tmp_path / "b.json"), bad]) == 0
    capsys.readouterr()


def test_module_cli_defaults_to_the_port_and_exits_zero():
    r = subprocess.run([sys.executable, "-m", "repro_torch.analysis"], cwd=ROOT,
                       env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new finding(s)" in r.stdout and "in 1 path(s)" in r.stdout
    assert "src/repro_torch/" in r.stdout and "src/repro/" not in r.stdout
