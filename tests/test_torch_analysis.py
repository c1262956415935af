"""mpklint (``repro.analysis``, pure stdlib, any tree) on the port: the
committed ``src/repro_torch`` carries zero unsuppressed findings with no
baseline file, as ``tests/test_analysis.py::test_repo_tree_is_clean``
holds ``src/repro``; every suppression names its reason; and the gate
bites: the port's ``run_world`` waiting a fixed 0.5 s instead of its
remaining budget, or a suppression taken away, is a new finding."""
from pathlib import Path

from repro.analysis import analyze_paths

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"


def test_port_tree_is_clean_without_a_baseline():
    report = analyze_paths([PORT])
    assert report.parse_errors == []
    assert [f.render() for f in report.new] == []


def test_every_port_suppression_gives_a_reason():
    lines = [(p, line) for p in PORT.rglob("*.py")
             for line in p.read_text().splitlines() if "mpklint: disable=" in line]
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
