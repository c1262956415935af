"""What one cell is made of, found by name.

``BENCHMARK.json`` names a cell (a workload); the cell names its
configuration and its traffic mix. Everything else is a file of its own
that this module finds from those names, so a later change adds a cell by
adding files and entries, never by editing one:

* ``configs/<config>.json``   — the model configuration as it is run;
* ``traffic/<traffic>.json``  — the traffic mix; its ``mode`` names
  ``modes/<mode>.py``, which drives the program;
* ``limits/<workload>.json``  — the limits that decide ``correct``;
* ``reference/<family>.py``   — the plain reference of the configuration's
  family (``family`` in its file), and the family's own model counts
  where it defines them (``costs``);
* ``metrics/<metric>.py``     — the reader of one per-layer metric.

Every path is relative to a checkout's root (``ROOT`` by default).
"""
from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Dict, List

from perfbench.harness.model import FILE_KEY, ROOT_KEY

PERFBENCH = Path(__file__).resolve().parents[1]
ROOT = PERFBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_config(file: str, root: Path = ROOT) -> dict:
    """The configuration file ``file`` (relative to the checkout ``root``),
    with the checkout and the file recorded in it, so that what reads it
    finds the family's files in that checkout (``model.ROOT_KEY``,
    ``model.FILE_KEY``)."""
    cfg = load_json(Path(root) / file)
    cfg[ROOT_KEY], cfg[FILE_KEY] = str(root), file
    return cfg


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""
    name: str
    spec: dict                      # the workload's entry
    config: dict                    # configs/<config>.json
    traffic: dict                   # traffic/<traffic>.json
    limits: dict                    # limits/<workload>.json
    end_to_end: List[dict] = field(default_factory=list)
    per_layer: List[dict] = field(default_factory=list)
    root: Path = ROOT

    @property
    def mode(self) -> str:
        return self.traffic["mode"]

    @property
    def chips(self) -> int:
        return int(self.spec.get("chips", 1))


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``<root>/BENCHMARK.json``, with its
    configuration, traffic, limits and the metrics it reports. Raises
    KeyError for a workload the benchmark does not name."""
    root = Path(root)
    bench = load_json(root / "BENCHMARK.json")
    specs = {w["name"]: w for w in bench["workloads"]}
    if workload not in specs:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(it has {sorted(specs)})")
    spec = specs[workload]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_config(configs[spec["config"]]["file"], root)
    traffic = load_json(root / "perfbench" / "traffic" / f"{spec['traffic']}.json")
    limits = load_json(root / "perfbench" / "limits" / f"{workload}.json")
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    unlisted = [m["name"] for m in bench["per_layer"] if "workloads" not in m]
    if unlisted:
        raise ValueError(f"per-layer metrics {unlisted} list no workloads")
    per_layer = [m for m in bench["per_layer"] if workload in m["workloads"]]
    return Cell(workload, spec, config, traffic, limits, e2e, per_layer,
                root)


_MODULES: Dict[Path, ModuleType] = {}


def _load(root: Path, folder: str, name: str) -> ModuleType:
    """``<root>/perfbench/<folder>/<name>.py``, loaded by its path (a
    metric's name may hold dots) and kept."""
    path = (Path(root) / "perfbench" / folder / f"{name}.py").resolve()
    mod = _MODULES.get(path)
    if mod is None:
        tag = "".join(c if c.isalnum() else "_" for c in f"{folder}_{name}")
        spec = importlib.util.spec_from_file_location(f"perfbench._found.{tag}", path)
        if spec is None or not path.exists():
            raise FileNotFoundError(f"no {folder} file {path}")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _MODULES[path] = mod
    return mod


def mode_module(mode: str, root: Path = ROOT) -> ModuleType:
    return _load(root, "modes", mode)


def reference_module(family: str, root: Path = ROOT) -> ModuleType:
    return _load(root, "reference", family)


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    return _load(root, "metrics", name)
