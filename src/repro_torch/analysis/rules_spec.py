"""Spec/constant-sync rules: docs/protocol.md is normative — keep it
honest against the code's wire constants and typed-error taxonomy.

These generalize the ad-hoc checks that lived in tests/test_docs.py:
instead of a hand-maintained list of asserts, the rules harvest the
constants and error classes from the analyzed modules' ASTs and check
the spec quotes each one.  Adding a wire magic or a typed error without
documenting it — or drifting a value in the spec — fails the analyzer
with the same rule ids CI reports.
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.engine import Finding, ModuleContext, ProjectRule

# module-level integer constants the spec must quote, and how the spec is
# expected to render them (any one acceptable form suffices)
_CONSTANT_FORMS = {
    "MAGIC": lambda v: [f"0x{v:08X}"],
    "GW_MAGIC": lambda v: [f"0x{v:08X}"],
    "GW_BATCH_MAGIC": lambda v: [f"0x{v:08X}"],
    "GW_SCAT_MAGIC": lambda v: [f"0x{v:08X}"],
    "LANES": lambda v: [f"LANES = {v}"],
    "MAC_PRIME": lambda v: [f"0x{v:08X}", f"0x{v:08x}"],
    "MAC_INIT": lambda v: [f"0x{v:08X}", f"0x{v:08x}"],
    "PROC_MAGIC": lambda v: [f"0x{v:08X}"],
    "PROC_CTRL_WORDS": lambda v: [f"PROC_CTRL_WORDS = {v}"],
    "PROC_SLOT_WORDS": lambda v: [f"PROC_SLOT_WORDS = {v}"],
    # replica-fleet control plane (§8): membership states + router fan-out
    "REPLICA_ACTIVE": lambda v: [f"REPLICA_ACTIVE = {v}"],
    "REPLICA_DRAINING": lambda v: [f"REPLICA_DRAINING = {v}"],
    "REPLICA_QUIESCED": lambda v: [f"REPLICA_QUIESCED = {v}"],
    "REPLICA_DEAD": lambda v: [f"REPLICA_DEAD = {v}"],
    "FLEET_CHOICES": lambda v: [f"FLEET_CHOICES = {v}"],
    # self-healing / overload control plane (§9)
    "DEADLINE_LANE": lambda v: [f"DEADLINE_LANE = {v}"],
    "DEADLINE_US_MAX": lambda v: [f"0x{v:08X}"],
    "HEDGE_RESERVOIR": lambda v: [f"HEDGE_RESERVOIR = {v}"],
    "REKEY_LIMIT": lambda v: [f"REKEY_LIMIT = {v}"],
    # multi-tenant QoS control plane (§10): priority lane + fair queuing
    "PRIORITY_LANE": lambda v: [f"PRIORITY_LANE = {v}"],
    "PRIO_NORMAL": lambda v: [f"PRIO_NORMAL = {v}"],
    "PRIO_HIGH": lambda v: [f"PRIO_HIGH = {v}"],
    "PRIO_BULK": lambda v: [f"PRIO_BULK = {v}"],
    "WFQ_QUANTUM": lambda v: [f"WFQ_QUANTUM = {v}"],
}

_ERROR_ROOT = "TransportError"
# chaos-fabric signals are BaseExceptions invisible to clients (§7) — the
# taxonomy documents what a *client* can observe
_TAXONOMY_EXEMPT = {"TransportError", "HandlerCrash", "DropResponse"}


def _spec(root: Optional[Path]) -> Optional[Tuple[Path, str]]:
    if root is None:
        return None
    p = root / "docs" / "protocol.md"
    if not p.is_file():
        return None
    return p, p.read_text()


def _module_constants(ctx: ModuleContext) -> Dict[str, Tuple[int, int]]:
    """Top-level ``NAME = <int literal>`` assignments → {name: (value,
    lineno)}."""
    out: Dict[str, Tuple[int, int]] = {}
    for node in ctx.tree.body:
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and isinstance(node.value, ast.Constant) \
                and isinstance(node.value.value, int):
            out[node.targets[0].id] = (node.value.value, node.lineno)
    return out


class SpecConstantSyncRule(ProjectRule):
    """MPK201: a wire/MAC constant the code defines is absent from (or
    drifted in) docs/protocol.md.

    The spec is what a second implementation would be written against; a
    magic number it misquotes is a protocol fork waiting to ship."""

    id = "MPK201"
    severity = "error"
    hint = "update docs/protocol.md (or the constant) so they agree"

    def check_project(self, modules: List[ModuleContext],
                      root) -> List[Finding]:
        spec = _spec(root)
        if spec is None:
            return []
        _, text = spec
        out: List[Finding] = []
        seen: set = set()
        for ctx in modules:
            for name, (value, lineno) in _module_constants(ctx).items():
                forms = _CONSTANT_FORMS.get(name)
                if forms is None or name in seen:
                    continue
                seen.add(name)
                accepted = forms(value)
                if not any(a in text for a in accepted):
                    out.append(self.finding(
                        ctx, lineno,
                        f"constant {name} = {accepted[0]} is not quoted by "
                        f"docs/protocol.md — the normative spec drifted"))
        return out


class SpecTaxonomySyncRule(ProjectRule):
    """MPK202: a typed error class (``TransportError`` subclass) missing
    from the docs/protocol.md taxonomy table.

    §7 promises that everything a client can observe is one of the
    documented typed errors; an undocumented subclass breaks every
    caller's exhaustive handling."""

    id = "MPK202"
    severity = "error"
    hint = "add the error to the docs/protocol.md §7 taxonomy table"

    def check_project(self, modules: List[ModuleContext],
                      root) -> List[Finding]:
        spec = _spec(root)
        if spec is None:
            return []
        _, text = spec
        # transitive TransportError subclasses across the analyzed modules
        typed = {_ERROR_ROOT}
        classes: List[Tuple[ModuleContext, ast.ClassDef]] = []
        for ctx in modules:
            for node in ast.walk(ctx.tree):
                if isinstance(node, ast.ClassDef):
                    classes.append((ctx, node))
        grew = True
        while grew:
            grew = False
            for _, cls in classes:
                if cls.name in typed:
                    continue
                for base in cls.bases:
                    if isinstance(base, ast.Name) and base.id in typed:
                        typed.add(cls.name)
                        grew = True
        out: List[Finding] = []
        for ctx, cls in classes:
            if cls.name not in typed or cls.name in _TAXONOMY_EXEMPT:
                continue
            if f"`{cls.name}`" not in text:
                out.append(self.finding(
                    ctx, cls.lineno,
                    f"typed error {cls.name} is missing from the "
                    f"docs/protocol.md taxonomy"))
        return out
