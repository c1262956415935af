"""mpklint: AST-driven concurrency & protocol-invariant analyzer (the
port's own copy of ``repro.analysis``: the same rules, ids, severities,
messages, suppressions, baseline format and exit codes, pure stdlib).

The MPKLink data plane's "secure AND efficient" claim rests on discipline
the type system cannot see: MAC-verify before any payload read, zero-copy
views that must not outlive their slot, monotonic clocks on every
deadline, and locks guarding every cross-thread counter.  Each of those
rules was once broken and fixed by hand; this package turns them into
machine-checked rules (see docs/analysis.md for the catalog).  The port's
wire is byte for byte the reference's, so ``docs/protocol.md`` is its
spec too.

Usage:

    python -m repro_torch.analysis [--json] [--baseline analysis/baseline.json] \
        [paths...]          # paths default to src/repro_torch

Pure stdlib (``ast`` + the repo's own docs as ground truth) — no
third-party dependencies.
"""
from repro_torch.analysis.engine import (  # noqa: F401
    Baseline,
    Finding,
    ModuleContext,
    all_rules,
    analyze_paths,
    run,
)

__all__ = ["Finding", "ModuleContext", "Baseline", "all_rules",
           "analyze_paths", "run"]
