"""Protocol-discipline rules: verify-before-use, view lifetime, clock
discipline, timeout plumbing, and swallowed typed errors.

docs/protocol.md is normative: every payload read is preceded by a MAC
verify, arena-slot views carry a finalizer guard so recycling can never
alias live data, deadlines are computed on the monotonic clock, and a
caller's ``timeout=`` reaches every blocking callee.  These rules encode
the spec clauses the type system cannot.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.engine import (Finding, ModuleContext, Rule, ancestors,
                                   expr_text)

_VERIFY_NAMES = re.compile(r"(verify|parse_frame|check_meta|precheck)")
_DEADLINE_ID = re.compile(r"(deadline|timeout|remaining|expir|budget|"
                          r"elapsed)", re.IGNORECASE)


def _func_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


def _enclosing_function(node: ast.AST) -> Optional[ast.FunctionDef]:
    for anc in ancestors(node):
        if isinstance(anc, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return anc
    return None


def _functions(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


class UnverifiedPayloadRule(Rule):
    """MPK101: frame payload rows read before any ``verify*`` call
    dominates the read.

    A name bound from a receive-side source (a ``recv``-ish call or a
    ``.resp_frame``/``.frame`` slot attribute) whose payload rows
    (``frame[1:...]``) are indexed in a function with no earlier
    ``verify*``/``parse_frame`` call is a read of unauthenticated bytes —
    the §2 guard must dominate every payload use.  The module that
    *defines* ``verify_view`` (framing) is the trusted implementation and
    is exempt."""

    id = "MPK101"
    severity = "error"
    hint = "call framing.verify_view/parse_frame before touching payload rows"

    _SOURCE_CALL = re.compile(r"(recv|read_frame|raw_frame)")
    _SOURCE_ATTR = re.compile(r"(^frame$|_frame$|^resp_frame$)")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        # trusted implementation module: it defines the verifier itself
        for fn in _functions(ctx.tree):
            if fn.name in ("verify_view", "verify_batch", "parse_frame"):
                return []
        out: List[Finding] = []
        for fn in _functions(ctx.tree):
            out.extend(self._check_fn(ctx, fn))
        return out

    def _check_fn(self, ctx: ModuleContext, fn) -> List[Finding]:
        tainted: Set[str] = set()
        verified_at: List[int] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and \
                    _VERIFY_NAMES.search(_func_name(node)):
                verified_at.append(node.lineno)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name):
                src = node.value
                if isinstance(src, ast.Call) and \
                        self._SOURCE_CALL.search(_func_name(src)):
                    tainted.add(node.targets[0].id)
                elif isinstance(src, ast.Attribute) and \
                        self._SOURCE_ATTR.search(src.attr):
                    tainted.add(node.targets[0].id)
        if not tainted:
            return []
        out: List[Finding] = []
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Subscript)
                    and isinstance(node.value, ast.Name)
                    and node.value.id in tainted
                    and isinstance(node.slice, ast.Slice)):
                continue
            lower = node.slice.lower
            if not (isinstance(lower, ast.Constant) and lower.value == 1):
                continue            # payload rows start at row 1
            if any(v <= node.lineno for v in verified_at):
                continue
            out.append(self.finding(
                ctx, node.lineno,
                f"payload rows of '{node.value.id}' read before any "
                f"verify* call dominates them in {fn.name}()"))
        return out


class ViewEscapeRule(Rule):
    """MPK102: an arena/slot ``verify_view`` result stored on ``self`` or
    returned without the finalizer-guard idiom.

    Ring ``poll()`` views alias recyclable arena storage; §4.3 requires
    ``arena.release_on_collect(view, buf)`` (or an owned ``.copy()``)
    before the view escapes, else a recycled slot aliases data the caller
    still holds.  Lockstep region views (``self._region_*``) have the
    until-next-exchange contract and are exempt."""

    id = "MPK102"
    severity = "error"
    hint = ("register arena.release_on_collect(view, buf) before the view "
            "escapes, or hand out an owned .copy()")

    _EXEMPT_ARG = re.compile(r"region")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for fn in _functions(ctx.tree):
            out.extend(self._check_fn(ctx, fn))
        return out

    def _check_fn(self, ctx: ModuleContext, fn) -> List[Finding]:
        guarded_fn = False
        views: Dict[str, int] = {}
        copied: Set[str] = set()
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _func_name(node)
                if name in ("release_on_collect", "finalize"):
                    guarded_fn = True
                elif name == "copy" and \
                        isinstance(node.func, ast.Attribute) and \
                        isinstance(node.func.value, ast.Name):
                    copied.add(node.func.value.id)
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Name) \
                    and self._is_arena_view(node.value):
                views[node.targets[0].id] = node.lineno
        if guarded_fn:
            return []
        out: List[Finding] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and node.value is not None:
                if isinstance(node.value, ast.Name) and \
                        node.value.id in views and \
                        node.value.id not in copied:
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"arena-slot view '{node.value.id}' returned from "
                        f"{fn.name}() without a finalizer guard"))
                elif self._is_arena_view(node.value):
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"arena-slot verify_view result returned from "
                        f"{fn.name}() without a finalizer guard"))
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.targets[0], ast.Attribute) \
                    and isinstance(node.targets[0].value, ast.Name) \
                    and node.targets[0].value.id == "self":
                val = node.value
                stored = (isinstance(val, ast.Name) and val.id in views
                          and val.id not in copied) \
                    or self._is_arena_view(val)
                if stored:
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"arena-slot verify_view result stored on "
                        f"self.{node.targets[0].attr} in {fn.name}() — "
                        f"outlives the slot with no finalizer guard"))
        return out

    def _is_arena_view(self, node: ast.AST) -> bool:
        if not (isinstance(node, ast.Call)
                and _func_name(node) == "verify_view" and node.args):
            return False
        return not self._EXEMPT_ARG.search(expr_text(node.args[0]))


class TimeTimeDeadlineRule(Rule):
    """MPK103: ``time.time()`` in a deadline/timeout/elapsed computation.

    Wall-clock time jumps under NTP slew; §4.4 requires every deadline on
    the monotonic clock.  Flagged when the call participates in
    arithmetic (an elapsed/deadline computation) or the enclosing
    function handles deadline-ish identifiers.  Bare timestamping
    (``{"ts": time.time()}``) is legitimate and not flagged."""

    id = "MPK103"
    severity = "error"
    hint = "use time.monotonic() (or time.perf_counter() for measurement)"

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "time"
                    and isinstance(node.func.value, ast.Name)
                    and node.func.value.id == "time"):
                continue
            in_arith = any(isinstance(a, (ast.BinOp, ast.Compare, ast.AugAssign))
                           for a in ancestors(node))
            fn = _enclosing_function(node)
            deadline_ctx = False
            if fn is not None and not in_arith:
                for sub in ast.walk(fn):
                    if isinstance(sub, ast.Name) and \
                            _DEADLINE_ID.search(sub.id):
                        deadline_ctx = True
                        break
                    if isinstance(sub, ast.arg) and \
                            _DEADLINE_ID.search(sub.arg):
                        deadline_ctx = True
                        break
            if not (in_arith or deadline_ctx):
                continue
            where = f" in {fn.name}()" if fn is not None else ""
            out.append(self.finding(
                ctx, node.lineno,
                f"time.time() used in a deadline/elapsed computation"
                f"{where} — wall clock is not monotonic"))
        return out


_BLOCKING_FWD = ("wait", "wait_for", "poll", "request", "request_into",
                 "acquire", "join", "get", "recv", "call", "call_batch")


class TimeoutNotForwardedRule(Rule):
    """MPK104: a ``timeout`` parameter accepted but never read while the
    body makes blocking calls.

    A dead timeout parameter silently promises a bound the function does
    not honor — §4.4 requires a per-call timeout tighter than the
    transport deadline to be honored by every blocking callee."""

    id = "MPK104"
    severity = "warning"
    hint = ("forward the timeout (or a deadline derived from it) to the "
            "blocking callees")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for fn in _functions(ctx.tree):
            params = [a.arg for a in
                      list(fn.args.args) + list(fn.args.kwonlyargs)
                      if a.arg == "timeout" or a.arg.endswith("_timeout")]
            if not params:
                continue
            used = {n.id for n in ast.walk(fn)
                    if isinstance(n, ast.Name)
                    and isinstance(n.ctx, ast.Load)}
            dead = [p for p in params if p not in used]
            if not dead:
                continue
            blocking = [n for n in ast.walk(fn)
                        if isinstance(n, ast.Call)
                        and isinstance(n.func, ast.Attribute)
                        and n.func.attr in _BLOCKING_FWD]
            if not blocking:
                continue
            out.append(self.finding(
                ctx, fn.lineno,
                f"{fn.name}() accepts '{dead[0]}' but never uses it while "
                f"calling blocking operations "
                f"(line {blocking[0].lineno}: "
                f"{expr_text(blocking[0].func)})"))
        return out


class FreshConstantWaitRule(Rule):
    """MPK106: a deadline-accepting function computes a blocking wait
    from a fresh constant.

    docs/protocol.md §9: once a caller's budget is propagated, every hop
    computes its waits against the REMAINING budget — a handler or
    dispatch path that accepts a deadline/timeout parameter but passes a
    pure numeric literal as a blocking call's timeout re-introduces the
    fixed slack the deadline word was built to remove (the old
    ``+ 30.0`` coalescer bound). A wait expression that references any
    deadline-ish name (``min(remaining, bound)``, ``deadline - now``) is
    clean; a constant-only expression inside a function that was handed a
    budget is the bug."""

    id = "MPK106"
    severity = "warning"
    hint = ("derive the wait from the propagated deadline/remaining "
            "budget (e.g. min(remaining, bound)), not a fresh constant")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for fn in _functions(ctx.tree):
            params = [a.arg for a in (list(fn.args.args)
                                      + list(fn.args.kwonlyargs))
                      if _DEADLINE_ID.search(a.arg)]
            if not params:
                continue            # no budget handed in — out of scope
            for node in ast.walk(fn):
                if node is not fn and isinstance(
                        node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                if not (isinstance(node, ast.Call)
                        and _func_name(node) in _BLOCKING_FWD):
                    continue
                wait = next((kw.value for kw in node.keywords
                             if kw.arg == "timeout"), None)
                if wait is None and _func_name(node) in ("wait", "acquire") \
                        and len(node.args) == 1:
                    wait = node.args[0]
                if wait is None or not self._constant_only(wait):
                    continue
                out.append(self.finding(
                    ctx, node.lineno,
                    f"{fn.name}() accepts '{params[0]}' but "
                    f"{expr_text(node.func)} waits on the fresh constant "
                    f"{expr_text(wait)} instead of the remaining budget"))
        return out

    def _constant_only(self, node: ast.AST) -> bool:
        """True when the expression is built purely from numeric literals
        (constants, arithmetic over constants) — any Name/Attribute
        reference means the budget (or some state) participates."""
        if isinstance(node, ast.Constant):
            return isinstance(node.value, (int, float)) \
                and not isinstance(node.value, bool)
        if isinstance(node, ast.BinOp):
            return self._constant_only(node.left) \
                and self._constant_only(node.right)
        if isinstance(node, ast.UnaryOp):
            return self._constant_only(node.operand)
        return False


class SwallowedErrorRule(Rule):
    """MPK105: a ``pass``-only broad exception handler.

    ``except Exception: pass`` eats the typed error taxonomy (§7) — a
    ``FrameError`` security event or a ``ServiceCrashed`` disappears
    instead of reaching the caller.  Genuinely best-effort teardown paths
    carry an inline suppression naming the invariant that makes them
    safe."""

    id = "MPK105"
    severity = "warning"
    hint = ("narrow the except, re-raise, or suppress with the reason the "
            "swallow is safe")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            broad = node.type is None or (
                isinstance(node.type, ast.Name)
                and node.type.id in ("Exception", "BaseException"))
            if not broad:
                continue
            body_inert = all(
                isinstance(s, ast.Pass)
                or (isinstance(s, ast.Expr)
                    and isinstance(s.value, ast.Constant))
                for s in node.body)
            if not body_inert:
                continue
            what = "bare except" if node.type is None \
                else f"except {node.type.id}"
            out.append(self.finding(
                ctx, node.lineno,
                f"{what}: pass swallows every typed error on this path"))
        return out


_SHED_TYPES = {"TransportError", "ServiceUnavailable", "Overloaded",
               "RateLimited"}
_ADMISSION_FN = re.compile(r"(admit|dispatch|submit|call|invoke|acquire|"
                           r"route)", re.IGNORECASE)


class SwallowedShedRule(Rule):
    """MPK107: an admission-path handler eats a typed shed signal.

    docs/protocol.md §7/§10: ``RateLimited`` and ``Overloaded`` carry a
    ``retry_after`` hint the caller's backoff depends on, and counting a
    shed requires observing it.  An admission-path function (admit/
    dispatch/submit/call/invoke/acquire/route) that catches one of the
    shed types and neither re-raises nor touches the bound exception
    silently converts back-pressure into success — the client retries at
    full rate and the noisy-neighbor gate loses its signal.  Handlers
    that log, map, or wrap the error (any reference to the bound name)
    or re-raise are clean."""

    id = "MPK107"
    severity = "warning"
    hint = ("re-raise the shed (or map it via its bound name) so "
            "RateLimited/Overloaded back-pressure reaches the caller")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.ExceptHandler):
                continue
            caught = self._shed_names(node.type)
            if not caught:
                continue
            fn = _enclosing_function(node)
            if fn is None or not _ADMISSION_FN.search(fn.name):
                continue
            if any(isinstance(n, ast.Raise)
                   for s in node.body for n in ast.walk(s)):
                continue
            if node.name and any(
                    isinstance(n, ast.Name) and n.id == node.name
                    for s in node.body for n in ast.walk(s)):
                continue            # error is logged/mapped/wrapped
            out.append(self.finding(
                ctx, node.lineno,
                f"{fn.name}() catches {'/'.join(sorted(caught))} without "
                f"re-raising or mapping it — the shed signal dies here"))
        return out

    def _shed_names(self, type_node: Optional[ast.AST]) -> Set[str]:
        """Shed-taxonomy class names named by the except clause."""
        names: Set[str] = set()
        if type_node is None:
            return names
        nodes = type_node.elts if isinstance(type_node, ast.Tuple) \
            else [type_node]
        for n in nodes:
            if isinstance(n, ast.Name) and n.id in _SHED_TYPES:
                names.add(n.id)
            elif isinstance(n, ast.Attribute) and n.attr in _SHED_TYPES:
                names.add(n.attr)
        return names
