"""Rule engine: findings, suppressions, baseline, file walking, reporting.

A *rule* is a small class with an ``id`` (``MPK001``...), a ``severity``
(``error`` | ``warning``) and a ``hint`` (how to fix).  File rules
implement ``check_module(ctx)`` and run once per analyzed module; project
rules implement ``check_project(modules, root)`` and run once per
analysis root (they see every module at once — the lock-order graph and
the docs/protocol.md cross-checks live there).

Findings can be silenced two ways:

* inline — ``# mpklint: disable=MPK001 reason=single-writer by design``
  on the offending line or on the line directly above it.  The reason is
  mandatory; a bare ``disable=`` is itself reported (``MPK000``).
* baseline — a committed JSON file of grandfathered findings keyed by
  (rule, path, stripped source line), so line-number drift does not
  resurrect them.  The analyzer exits nonzero on any NEW finding.
"""
from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

SUPPRESS_RE = re.compile(
    r"#\s*mpklint:\s*disable=(?P<ids>[A-Z0-9,\s]+?)"
    r"(?:\s+reason=(?P<reason>.+?))?\s*$")

SEVERITIES = ("error", "warning")


@dataclass
class Finding:
    rule: str
    severity: str
    path: str
    line: int
    message: str
    hint: str = ""
    context: str = ""          # stripped source line — the baseline key part
    suppressed: bool = False
    baselined: bool = False

    def key(self) -> Tuple[str, str, str]:
        return (self.rule, self.path, self.context)

    def to_dict(self) -> dict:
        return {"rule": self.rule, "severity": self.severity,
                "path": self.path, "line": self.line,
                "message": self.message, "hint": self.hint,
                "context": self.context, "suppressed": self.suppressed,
                "baselined": self.baselined}

    def render(self) -> str:
        tag = ""
        if self.suppressed:
            tag = " [suppressed]"
        elif self.baselined:
            tag = " [baselined]"
        hint = f"  (fix: {self.hint})" if self.hint else ""
        return (f"{self.path}:{self.line}: {self.rule} {self.severity}: "
                f"{self.message}{hint}{tag}")


@dataclass
class _Suppression:
    ids: Tuple[str, ...]
    reason: str
    line: int


class ModuleContext:
    """One parsed module: source, lines, AST (with parent links), path."""

    def __init__(self, path: Path, source: str, rel: str):
        self.path = path
        self.rel = rel                       # posix path used in findings
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=str(path))
        add_parents(self.tree)
        self.suppressions = _scan_suppressions(self.lines)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1].strip()
        return ""

    def suppressed(self, rule_id: str, lineno: int) -> Optional[_Suppression]:
        """A finding at ``lineno`` is silenced by a reasoned disable on the
        same line or on the line directly above."""
        for ln in (lineno, lineno - 1):
            sup = self.suppressions.get(ln)
            if sup is not None and rule_id in sup.ids and sup.reason:
                return sup
        return None


def add_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child.parent = node  # type: ignore[attr-defined]


def ancestors(node: ast.AST) -> Iterable[ast.AST]:
    cur = getattr(node, "parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "parent", None)


def expr_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse covers all real exprs
        return ""


_LOCK_TOKEN = re.compile(r"(lock|cond|mutex|slk|sem)", re.IGNORECASE)


def is_lock_expr(node: ast.AST) -> bool:
    """Heuristic: a ``with`` context whose dotted text names a lock-like
    object (``self._lock``, ``ring.cv``, ``self._glock``, ``done_lock``,
    ``self._cond``...).  ``cv`` must match as a whole token so ``recv``
    does not."""
    text = expr_text(node)
    tokens = re.split(r"[^A-Za-z0-9_]+", text)
    for tok in tokens:
        if not tok:
            continue
        if tok in ("cv", "cond", "slk", "slock", "glock"):
            return True
        if _LOCK_TOKEN.search(tok):
            return True
    return False


def enclosing_lock_withs(node: ast.AST) -> List[ast.withitem]:
    """Every lock-like ``with`` item an ancestor of ``node`` holds."""
    held = []
    for anc in ancestors(node):
        if isinstance(anc, (ast.With, ast.AsyncWith)):
            for item in anc.items:
                if is_lock_expr(item.context_expr):
                    held.append(item)
    return held


def _scan_suppressions(lines: Sequence[str]) -> Dict[int, _Suppression]:
    out: Dict[int, _Suppression] = {}
    for i, line in enumerate(lines, start=1):
        m = SUPPRESS_RE.search(line)
        if not m:
            continue
        ids = tuple(x.strip() for x in m.group("ids").split(",") if x.strip())
        reason = (m.group("reason") or "").strip()
        out[i] = _Suppression(ids=ids, reason=reason, line=i)
    return out


class Rule:
    """Base for per-module rules."""

    id = "MPK000"
    severity = "error"
    hint = ""

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        raise NotImplementedError

    def finding(self, ctx: ModuleContext, lineno: int, message: str,
                hint: Optional[str] = None) -> Finding:
        return Finding(rule=self.id, severity=self.severity, path=ctx.rel,
                       line=lineno, message=message,
                       hint=self.hint if hint is None else hint,
                       context=ctx.line_text(lineno))


class ProjectRule(Rule):
    """Base for whole-project rules (cross-module / docs cross-checks)."""

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        return []

    def check_project(self, modules: List[ModuleContext],
                      root: Optional[Path]) -> List[Finding]:
        raise NotImplementedError


class BadSuppressionRule(Rule):
    """MPK000: a ``# mpklint: disable=`` comment without a reason.

    A suppression is a claim that the invariant holds for a reason the
    analyzer cannot see — an unreasoned one is indistinguishable from
    silencing a real bug, so the reason is mandatory and reasonless
    disables never suppress anything."""

    id = "MPK000"
    severity = "error"
    hint = "append reason=<why this is safe> to the disable comment"

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out = []
        for sup in ctx.suppressions.values():
            if not sup.reason:
                out.append(self.finding(
                    ctx, sup.line,
                    "mpklint suppression without a reason= clause "
                    f"(ids: {', '.join(sup.ids)})"))
        return out


class Baseline:
    """Committed grandfathered findings: (rule, path, context) triples."""

    def __init__(self, entries: Iterable[Tuple[str, str, str]] = ()):
        self.entries = set(entries)

    @classmethod
    def load(cls, path: Path) -> "Baseline":
        data = json.loads(path.read_text())
        return cls((e["rule"], e["path"], e.get("context", ""))
                   for e in data.get("findings", []))

    def contains(self, finding: Finding) -> bool:
        return finding.key() in self.entries

    @staticmethod
    def dump(findings: Iterable[Finding]) -> str:
        uniq = sorted({f.key() for f in findings})
        return json.dumps(
            {"version": 1,
             "findings": [{"rule": r, "path": p, "context": c}
                          for r, p, c in uniq]},
            indent=2) + "\n"


def all_rules() -> List[Rule]:
    from repro_torch.analysis.rules_concurrency import (BlockingUnderLockRule,
                                                  CrossThreadCounterRule,
                                                  LockOrderCycleRule)
    from repro_torch.analysis.rules_protocol import (FreshConstantWaitRule,
                                               SwallowedErrorRule,
                                               SwallowedShedRule,
                                               TimeTimeDeadlineRule,
                                               TimeoutNotForwardedRule,
                                               UnverifiedPayloadRule,
                                               ViewEscapeRule)
    from repro_torch.analysis.rules_spec import (SpecConstantSyncRule,
                                           SpecTaxonomySyncRule)
    return [
        BadSuppressionRule(),
        CrossThreadCounterRule(),
        BlockingUnderLockRule(),
        LockOrderCycleRule(),
        UnverifiedPayloadRule(),
        ViewEscapeRule(),
        TimeTimeDeadlineRule(),
        TimeoutNotForwardedRule(),
        FreshConstantWaitRule(),
        SwallowedErrorRule(),
        SwallowedShedRule(),
        SpecConstantSyncRule(),
        SpecTaxonomySyncRule(),
    ]


def iter_py_files(paths: Sequence[Path]) -> List[Path]:
    files: List[Path] = []
    for p in paths:
        if p.is_dir():
            files.extend(sorted(p.rglob("*.py")))
        elif p.suffix == ".py":
            files.append(p)
    seen = set()
    uniq = []
    for f in files:
        r = f.resolve()
        if r not in seen:
            seen.add(r)
            uniq.append(f)
    return uniq


def find_project_root(paths: Sequence[Path]) -> Optional[Path]:
    """Nearest ancestor of the analyzed paths holding docs/protocol.md —
    the normative spec the spec-sync rules check against."""
    for p in paths:
        cur = p.resolve()
        if cur.is_file():
            cur = cur.parent
        while True:
            if (cur / "docs" / "protocol.md").is_file():
                return cur
            if cur.parent == cur:
                break
            cur = cur.parent
    return None


def _rel(path: Path, root: Optional[Path]) -> str:
    r = path.resolve()
    for base in (root, Path.cwd()):
        if base is not None:
            try:
                return r.relative_to(base.resolve()).as_posix()
            except ValueError:
                continue
    return r.as_posix()


@dataclass
class Report:
    findings: List[Finding] = field(default_factory=list)
    parse_errors: List[str] = field(default_factory=list)

    @property
    def new(self) -> List[Finding]:
        return [f for f in self.findings
                if not f.suppressed and not f.baselined]

    def counts(self) -> dict:
        return {"total": len(self.findings),
                "new": len(self.new),
                "suppressed": sum(f.suppressed for f in self.findings),
                "baselined": sum(f.baselined for f in self.findings)}

    def to_dict(self) -> dict:
        return {"findings": [f.to_dict() for f in self.findings],
                "parse_errors": self.parse_errors,
                "counts": self.counts()}


def analyze_paths(paths: Sequence[Path],
                  baseline: Optional[Baseline] = None,
                  rules: Optional[Sequence[Rule]] = None,
                  root: Optional[Path] = None) -> Report:
    rules = list(rules) if rules is not None else all_rules()
    root = root or find_project_root(paths)
    report = Report()

    modules: List[ModuleContext] = []
    for f in iter_py_files(paths):
        try:
            source = f.read_text()
            modules.append(ModuleContext(f, source, _rel(f, root)))
        except (SyntaxError, UnicodeDecodeError, OSError) as e:
            report.parse_errors.append(f"{f}: {type(e).__name__}: {e}")

    raw: List[Finding] = []
    for rule in rules:
        if isinstance(rule, ProjectRule):
            raw.extend(rule.check_project(modules, root))
        else:
            for ctx in modules:
                raw.extend(rule.check_module(ctx))

    by_rel = {m.rel: m for m in modules}
    for f in sorted(raw, key=lambda x: (x.path, x.line, x.rule)):
        ctx = by_rel.get(f.path)
        if ctx is not None and f.rule != "MPK000" \
                and ctx.suppressed(f.rule, f.line):
            f.suppressed = True
        elif baseline is not None and baseline.contains(f):
            f.baselined = True
        report.findings.append(f)
    return report


def run(argv: Optional[Sequence[str]] = None) -> int:
    """CLI entry point.  Exit 0 = clean, 1 = new findings, 2 = bad usage
    or unparseable input."""
    import argparse

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="mpklint: concurrency & protocol-invariant analyzer "
                    "for the MPKLink data plane (docs/analysis.md)")
    ap.add_argument("paths", nargs="*", default=["src/repro_torch"],
                    help="files or directories to analyze "
                         "(default: src/repro_torch)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable report on stdout")
    ap.add_argument("--baseline", default=None,
                    help="JSON baseline of grandfathered findings "
                         "(e.g. analysis/baseline.json)")
    ap.add_argument("--write-baseline", default=None, metavar="PATH",
                    help="write current findings as a new baseline and exit")
    args = ap.parse_args(argv)

    paths = [Path(p) for p in args.paths]
    missing = [str(p) for p in paths if not p.exists()]
    if missing:
        print(f"mpklint: no such path(s): {', '.join(missing)}")
        return 2

    baseline = None
    if args.baseline:
        bp = Path(args.baseline)
        if not bp.is_file():
            print(f"mpklint: baseline not found: {bp}")
            return 2
        baseline = Baseline.load(bp)

    report = analyze_paths(paths, baseline=baseline)

    if args.write_baseline:
        keep = [f for f in report.findings if not f.suppressed]
        Path(args.write_baseline).write_text(Baseline.dump(keep))
        print(f"mpklint: baseline written to {args.write_baseline} "
              f"({len(keep)} findings)")
        return 0

    if args.json:
        print(json.dumps(report.to_dict(), indent=2))
    else:
        for f in report.findings:
            print(f.render())
        for e in report.parse_errors:
            print(f"parse error: {e}")
        c = report.counts()
        print(f"mpklint: {c['new']} new finding(s), "
              f"{c['suppressed']} suppressed, {c['baselined']} baselined "
              f"in {len(paths)} path(s)")
    if report.parse_errors:
        return 2
    return 1 if report.new else 0
