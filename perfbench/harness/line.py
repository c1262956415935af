"""The run's result: the last line of standard output, the numbers compared
for ``correct`` on standard error, and the refusals (no card, or the JAX
package loaded)."""
from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, List, Optional

# top-level module names that no run may hold once its window has closed:
# JAX and the JAX package the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules(modules=None) -> List[str]:
    """The forbidden top-level names in ``modules`` (default
    ``sys.modules``), compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    tops = {m.split(".", 1)[0] for m in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def card_info(chips: int) -> dict:
    """The card's name and the number the run uses, and its power limit
    (``nvidia-smi``; None where it cannot be read)."""
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": chips}
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30, check=True).stdout
        info["power_limit"] = smi.strip().splitlines()[0].split(",")[-1].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        info["power_limit"] = None
    return info


def checks_text(checks: Dict[str, dict]) -> List[str]:
    """One line a compared number: its name, value and limit."""
    return [f"check {k}: {v['value']!r} (limit {v['limit']!r}, "
            f"{'ok' if v['ok'] else 'FAILED'})" for k, v in checks.items()]


def result_line(*, correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                checks: Dict[str, dict],
                breakdown: Optional[dict] = None) -> str:
    """The last line of standard output, its keys in the contract's order
    and the compared numbers last."""
    doc = {"correct": bool(correct), "attempted": int(attempted),
           "failed": int(failed), "metrics": metrics, "device": device}
    if breakdown is not None:
        doc["breakdown"] = breakdown
    doc["checks"] = {k: {"value": v["value"], "limit": v["limit"]}
                     for k, v in checks.items()}
    return json.dumps(doc)


def emit(line: str, checks: Dict[str, dict]) -> None:
    """The result line last on standard output, the compared numbers last
    on standard error."""
    sys.stdout.flush()
    for text in checks_text(checks):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(line, flush=True)
