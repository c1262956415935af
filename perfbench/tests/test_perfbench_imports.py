"""What the benchmark imports: nothing it runs imports JAX or the JAX
package (``repro``), and the references import nothing of the program
(``repro_torch``) either. Top-level names are compared whole:
``repro_torch`` is not ``repro``."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench.harness import bench

PERFBENCH = bench.PERFBENCH
NEVER = {"jax", "jaxlib", "flax", "repro"}


def _py_files():
    return sorted(p for p in PERFBENCH.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path: Path):
    """The modules a file imports, by full name (relative imports resolved
    inside the benchmark's package)."""
    tree = ast.parse(path.read_text(), str(path))
    pkg = ".".join(path.relative_to(PERFBENCH.parent).with_suffix("").parts[:-1])
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parts = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                base = ".".join(parts + ([base] if base else []))
            out.add(base)
            out |= {f"{base}.{a.name}" for a in node.names}
    return out


def _top(name):
    return name.split(".", 1)[0]


@pytest.mark.parametrize("path", _py_files(), ids=lambda p: str(p.relative_to(PERFBENCH)))
def test_no_file_imports_jax_or_the_jax_package(path):
    bad = {m for m in _imports(path) if _top(m) in NEVER}
    assert not bad, f"{path.name} imports {sorted(bad)}"


def _module_file(name):
    if _top(name) != "perfbench":
        return None
    rel = Path(*name.split(".")[1:])
    for cand in (PERFBENCH / rel.with_suffix(".py"), PERFBENCH / rel / "__init__.py"):
        if cand.exists():
            return cand
    return None


@pytest.mark.parametrize("family", sorted(p.stem for p in (PERFBENCH / "reference").glob("*.py")
                                          if p.stem != "__init__"))
def test_references_import_nothing_of_the_program(family):
    """Followed through the benchmark's own modules they import."""
    seen, todo, found = set(), [PERFBENCH / "reference" / f"{family}.py"], set()
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        for m in _imports(f):
            if _top(m) in NEVER | {"repro_torch"}:
                found.add(m)
            nxt = _module_file(m)
            if nxt is not None:
                todo.append(nxt)
    assert not found, f"reference/{family}.py reaches {sorted(found)}"


def test_nothing_reads_the_old_benchmark_folder():
    """The JAX package's benchmark folder is neither read nor imported."""
    old = "bench" + "marks"
    for path in _py_files():
        text = path.read_text()
        assert f"{old}/" not in text and f"import {old}" not in text \
            and f"from {old}" not in text, path


def test_a_run_loads_no_jax():
    """What the port itself loads counts too: a whole run at the CPU's size
    in a fresh process leaves no forbidden module in ``sys.modules``."""
    code = ("import sys, torch\n"
            "from perfbench.tests.tiny import tiny_cell\n"
            "from perfbench.harness.cell import run_cell\n"
            "from perfbench.harness.line import forbidden_modules\n"
            "torch.set_num_threads(1)\n"
            "for w in ('grok-1-314b.serve', 'qwen3-14b.train'):\n"
            "    run_cell(tiny_cell(w), 5, 0.5, False, torch.device('cpu'), 0.0)\n"
            "print('FORBIDDEN', forbidden_modules())\n")
    root = str(PERFBENCH.parent)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.path.join(root, "src")]))
    p = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip().splitlines()[-1] == "FORBIDDEN []"
