"""Concurrency rules: the FrameStats/CA bug class, locked blocking calls,
and the module-wide lock-acquisition-order graph.

These generalize races once fixed by hand: an unguarded
``self.x += 1`` touched by both a service thread and a client thread
drops counts under interleaving; a blocking wait made while holding an
unrelated lock serializes the data plane (or deadlocks it); two code
paths taking the same pair of locks in opposite orders deadlock under
exactly the load the benchmarks apply.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.engine import (Finding, ModuleContext, ProjectRule, Rule,
                                   enclosing_lock_withs, expr_text,
                                   is_lock_expr)


_OP_TEXT = {ast.Add: "+", ast.Sub: "-", ast.Mult: "*", ast.Div: "/",
            ast.FloorDiv: "//", ast.Mod: "%", ast.BitOr: "|",
            ast.BitAnd: "&", ast.BitXor: "^", ast.LShift: "<<",
            ast.RShift: ">>"}


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _class_methods(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _thread_targets(cls: ast.ClassDef) -> Set[str]:
    """Methods handed to ``threading.Thread(target=self.X)`` (or Timer)
    anywhere in the class — the service-thread entry points."""
    targets: Set[str] = set()
    for node in ast.walk(cls):
        if not isinstance(node, ast.Call):
            continue
        fname = node.func.attr if isinstance(node.func, ast.Attribute) \
            else node.func.id if isinstance(node.func, ast.Name) else ""
        if fname not in ("Thread", "Timer"):
            continue
        for kw in node.keywords:
            if kw.arg == "target":
                attr = _self_attr(kw.value)
                if attr:
                    targets.add(attr)
    return targets


def _reachable(entries: Set[str], edges: Dict[str, Set[str]]) -> Set[str]:
    seen: Set[str] = set()
    stack = [e for e in entries if e in edges]
    while stack:
        m = stack.pop()
        if m in seen:
            continue
        seen.add(m)
        stack.extend(edges[m] - seen)
    return seen


def _is_thread_sharded(cls: ast.ClassDef) -> bool:
    """Classes that index state by thread identity (``threading.local`` /
    ``get_ident`` / ``current_thread``) are cross-thread by construction —
    every plain ``self.x`` on them is shared even with no ``Thread()`` in
    sight (the FrameStats shape)."""
    for node in ast.walk(cls):
        if isinstance(node, ast.Attribute) and \
                node.attr in ("local", "get_ident", "current_thread"):
            return True
        if isinstance(node, ast.Name) and \
                node.id in ("get_ident", "current_thread"):
            return True
    return False


class CrossThreadCounterRule(ProjectRule):
    """MPK001: read-modify-write (``self.x += ...``) on an attribute that
    two thread entry points reach, with no enclosing lock.

    Thread entry points are methods handed to ``threading.Thread(target=
    self.X)`` — resolved through base classes, since ``Session`` starts
    the thread that runs each subclass's ``_serve_loop`` — plus the
    class's public API (callable from client threads).  Plain flag
    assignments are deliberately NOT flagged: the doorbell protocol
    publishes booleans lock-free by design; only augmented assignments
    lose updates."""

    id = "MPK001"
    severity = "error"
    hint = ("guard the += with the owning lock, or shard the counter "
            "per thread like framing.FrameStats")

    def check_project(self, modules: List[ModuleContext],
                      root) -> List[Finding]:
        # class table across every analyzed module (name collisions: last
        # definition wins — good enough for one project's core modules)
        table: Dict[str, Tuple[ModuleContext, ast.ClassDef]] = {}
        for ctx in modules:
            for cls in ast.walk(ctx.tree):
                if isinstance(cls, ast.ClassDef):
                    table[cls.name] = (ctx, cls)

        out: List[Finding] = []
        seen_sites: Set[Tuple[str, int]] = set()
        for name in table:
            out.extend(self._check_class(name, table, seen_sites))
        return out

    def _mro(self, name: str, table) -> List[str]:
        """Derived-first chain of known classes (single inheritance walk —
        multiple bases are all visited, derived definitions win)."""
        chain, queue, seen = [], [name], set()
        while queue:
            n = queue.pop(0)
            if n in seen or n not in table:
                continue
            seen.add(n)
            chain.append(n)
            _, cls = table[n]
            for base in cls.bases:
                if isinstance(base, ast.Name):
                    queue.append(base.id)
        return chain

    def _check_class(self, name: str, table,
                     seen_sites: Set[Tuple[str, int]]) -> List[Finding]:
        chain = self._mro(name, table)
        # effective method set: most-derived definition of each name
        methods: Dict[str, Tuple[ModuleContext, str, ast.FunctionDef]] = {}
        targets: Set[str] = set()
        sharded = False
        for cname in chain:
            ctx, cls = table[cname]
            for mname, fn in _class_methods(cls).items():
                methods.setdefault(mname, (ctx, cname, fn))
            targets |= _thread_targets(cls)
            sharded = sharded or _is_thread_sharded(cls)
        if not methods or (not targets and not sharded):
            return []

        edges: Dict[str, Set[str]] = {m: set() for m in methods}
        for mname, (_, _, fn) in methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call):
                    callee = _self_attr(node.func)
                    if callee in methods:
                        edges[mname].add(callee)

        service_set = _reachable(targets, edges)
        public = {m for m in methods if not m.startswith("_")}
        client_set = _reachable(public, edges)

        # every write site per attribute: (method, ctx, node, guarded, aug)
        writes: Dict[str, List[Tuple[str, ModuleContext, ast.AST,
                                     bool, bool]]] = {}
        for mname, (ctx, cname, fn) in methods.items():
            if mname == "__init__":       # single-threaded construction
                continue
            for node in ast.walk(fn):
                if isinstance(node, ast.AugAssign):
                    attr, aug = _self_attr(node.target), True
                elif isinstance(node, ast.Assign) and len(node.targets) == 1:
                    attr, aug = _self_attr(node.targets[0]), False
                else:
                    continue
                if attr is None:
                    continue
                guarded = bool(enclosing_lock_withs(node))
                writes.setdefault(attr, []).append(
                    (mname, ctx, node, guarded, aug))

        out: List[Finding] = []
        for attr, sites in writes.items():
            for mname, ctx, node, guarded, aug in sites:
                if not aug or guarded:
                    continue
                site_key = (ctx.rel, node.lineno)
                if site_key in seen_sites:
                    continue
                cross = sharded or (
                    mname in service_set and mname in client_set)
                if not cross:
                    for oname, _, _, _, _ in sites:
                        if oname == mname:
                            continue
                        if (mname in service_set and oname in client_set) \
                                or (mname in client_set
                                    and oname in service_set):
                            cross = True
                            break
                if cross:
                    seen_sites.add(site_key)
                    why = ("class shards state per thread"
                           if sharded and mname not in service_set
                           else "reached from both a Thread target and "
                                "the public API")
                    out.append(self.finding(
                        ctx, node.lineno,
                        f"unguarded 'self.{attr} "
                        f"{_OP_TEXT.get(type(node.op), '?')}= ...' "
                        f"in {name}.{mname} "
                        f"is a cross-thread read-modify-write ({why}); "
                        f"concurrent writers drop updates"))
        return out


_BLOCKING_ATTRS = ("sleep", "recv", "wait", "wait_for", "request",
                   "request_into", "poll")


class BlockingUnderLockRule(Rule):
    """MPK002: a blocking call (``sleep``/``recv``/``Event.wait``/ring
    ``poll``/``request``) made while holding a lock.

    Waiting on the *held* condition itself (``with cv: cv.wait()``) is the
    sanctioned park idiom and is not flagged — the wait releases that
    lock.  Anything else holds the lock for the full wait: every other
    thread needing it stalls for up to the timeout, and if the wakeup
    depends on that lock the wait never returns."""

    id = "MPK002"
    severity = "error"
    hint = ("move the blocking call outside the 'with', or park on the "
            "held condition itself")

    def check_module(self, ctx: ModuleContext) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name, recv = self._call_name(node)
            if name not in _BLOCKING_ATTRS:
                continue
            if name == "wait" and recv is None:
                continue            # bare wait() — not a method call
            held = enclosing_lock_withs(node)
            if not held:
                continue
            if name in ("wait", "wait_for") and recv is not None:
                held_texts = {expr_text(i.context_expr) for i in held}
                if expr_text(recv) in held_texts:
                    continue        # condition-wait idiom: releases the lock
            locks = ", ".join(sorted(expr_text(i.context_expr)
                                     for i in held))
            out.append(self.finding(
                ctx, node.lineno,
                f"blocking call '{expr_text(node.func)}(...)' while "
                f"holding lock(s) {locks}"))
        return out

    @staticmethod
    def _call_name(node: ast.Call):
        if isinstance(node.func, ast.Attribute):
            return node.func.attr, node.func.value
        if isinstance(node.func, ast.Name):
            return node.func.id, None
        return "", None


class LockOrderCycleRule(ProjectRule):
    """MPK003: cycle in the project-wide lock-acquisition-order graph.

    Every nested ``with lockA: ... with lockB:`` adds the edge A -> B
    (lock names are canonicalized as ``ClassName.attr`` for ``self.X``).
    One level of intra-class call expansion is applied: a self-method
    called while holding a lock contributes the locks it takes at its own
    top level.  A cycle means two threads can each hold one lock of a
    pair while waiting for the other — the classic data-plane deadlock."""

    id = "MPK003"
    severity = "error"
    hint = "pick one global acquisition order for the cycle's locks"

    def check_project(self, modules: List[ModuleContext],
                      root) -> List[Finding]:
        # edges: (src, dst) -> (ctx, lineno) of one witness acquisition
        edges: Dict[Tuple[str, str], Tuple[ModuleContext, int]] = {}
        # locks acquired at a method's own top level, for call expansion
        method_locks: Dict[str, List[str]] = {}
        calls_under_lock: List[Tuple[str, str, ModuleContext, int]] = []

        for ctx in modules:
            for cls in ast.walk(ctx.tree):
                if not isinstance(cls, ast.ClassDef):
                    continue
                for fn in _class_methods(cls).values():
                    self._walk_fn(ctx, cls.name, fn, edges, method_locks,
                                  calls_under_lock)

        for held, callee, ctx, lineno in calls_under_lock:
            for inner in method_locks.get(callee, []):
                if inner != held:
                    edges.setdefault((held, inner), (ctx, lineno))

        return self._find_cycles(edges)

    def _walk_fn(self, ctx, cls_name, fn, edges, method_locks,
                 calls_under_lock):
        qual = f"{cls_name}.{fn.name}"
        acquired: List[str] = []

        def canon(expr) -> str:
            text = expr_text(expr)
            if text.startswith("self."):
                return f"{cls_name}.{text[5:]}"
            return text

        def visit(node, held: Tuple[str, ...]):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                new_held = list(held)
                for item in node.items:
                    if is_lock_expr(item.context_expr):
                        name = canon(item.context_expr)
                        if not held:
                            acquired.append(name)
                        for h in new_held:
                            if h != name:
                                edges.setdefault((h, name),
                                                 (ctx, node.lineno))
                        new_held.append(name)
                for child in node.body:
                    visit(child, tuple(new_held))
                return
            if isinstance(node, ast.Call) and held:
                callee = _self_attr(node.func)
                if callee:
                    for h in held:
                        calls_under_lock.append(
                            (h, f"{cls_name}.{callee}", ctx, node.lineno))
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for stmt in fn.body:
            visit(stmt, ())
        method_locks[qual] = acquired

    def _find_cycles(self, edges) -> List[Finding]:
        graph: Dict[str, Set[str]] = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        out: List[Finding] = []
        reported: Set[frozenset] = set()
        color: Dict[str, int] = {n: 0 for n in graph}
        stack: List[str] = []

        def witness(cycle: List[str]):
            for a, b in zip(cycle, cycle[1:]):
                if (a, b) in edges:
                    return edges[(a, b)]
            return next(iter(edges.values()))

        def dfs(n: str):
            color[n] = 1
            stack.append(n)
            for m in sorted(graph[n]):
                if color[m] == 1:
                    cycle = stack[stack.index(m):] + [m]
                    key = frozenset(cycle)
                    if key not in reported:
                        reported.add(key)
                        ctx, lineno = witness(cycle)
                        out.append(self.finding(
                            ctx, lineno,
                            "lock acquisition-order cycle: "
                            + " -> ".join(cycle)))
                elif color[m] == 0:
                    dfs(m)
            stack.pop()
            color[n] = 2

        for n in sorted(graph):
            if color[n] == 0:
                dfs(n)
        return out
