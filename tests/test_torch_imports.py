"""The port stands alone: every ``repro_torch`` module imports without JAX
and without the ``repro`` package, and ``chip_smoke.py`` imports neither.

The import check runs in a subprocess because this test process already
imported JAX (``tests/conftest.py``)."""
import ast
import functools
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"

_PROBE = r"""
import importlib, importlib.abc, pkgutil, sys
sys.modules["jax"] = None                       # any `import jax` fails


class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name == "repro" or name.startswith("repro."):
            raise ImportError(f"repro_torch must not import {name}")
        return None


sys.meta_path.insert(0, Refuse())
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
print(" ".join(names))
print(len(names))
"""


@functools.lru_cache(maxsize=None)
def _probe():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    return out.stdout.strip().splitlines()


def test_every_module_imports_without_jax_or_repro():
    assert int(_probe()[-1]) >= 20


def test_process_and_fault_modules_import_without_jax_or_repro():
    """The process transports, the fault fabric and the planners are among
    the modules the probe imports with JAX and ``repro`` refused."""
    names = set(_probe()[-2].split())
    assert {"repro_torch.core.procwire", "repro_torch.core.faultwire",
            "repro_torch.runtime.elastic", "repro_torch.runtime.fault",
            "repro_torch.runtime.serve"} <= names


def test_port_children_start_from_the_forkserver_only():
    """CUDA does not survive fork: every child of the port starts from the
    forkserver, on the CPU and on the card alike, and no source asks for
    the fork start method or forks by hand."""
    from repro_torch.core import procwire
    assert procwire._CTX.get_start_method() == "forkserver"
    for path in (SRC / "repro_torch").rglob("*.py"):
        text = path.read_text()
        assert 'get_context("fork")' not in text, path
        assert "get_context('fork')" not in text, path
        assert "os.fork(" not in text, path


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split(".")[0]


def test_chip_smoke_imports_neither_jax_nor_repro():
    roots = set(_imported_roots(ROOT / "chip_smoke.py"))
    assert not roots & {"jax", "jaxlib", "repro"}, roots


def test_port_sources_name_neither_jax_nor_repro():
    for path in (SRC / "repro_torch").rglob("*.py"):
        roots = set(_imported_roots(path))
        assert not roots & {"jax", "jaxlib", "repro"}, (path, roots)


FABRIC_MODULES = ("repro_torch.core.fabric", "repro_torch.core.ring_attention",
                  "repro_torch.models.moe_ep", "repro_torch.runtime.pipeline",
                  "repro_torch.optim.compression", "repro_torch.launch.mesh",
                  "repro_torch.launch.world")


def test_fabric_modules_import_without_jax_or_repro():
    """The device fabric and its users are among the modules the probe
    imports with JAX and ``repro`` refused, and none of them asks for the
    fork start method (their ranks start from the forkserver)."""
    names = set(_probe()[-2].split())
    assert set(FABRIC_MODULES) <= names
    for mod in FABRIC_MODULES:
        path = SRC / (mod.replace(".", "/") + ".py")
        text = path.read_text()
        assert "fork\")" not in text.replace("forkserver\")", ""), path
        assert "fork')" not in text.replace("forkserver')", ""), path
        assert not set(_imported_roots(path)) & {"jax", "jaxlib", "repro"}, path
    from repro_torch.launch import world
    assert world._CTX.get_start_method() == "forkserver"
