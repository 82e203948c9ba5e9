"""Lock checkers: per-class guarded-attribute discipline and the
cross-class lock-acquisition-order graph.

**lock-discipline** — for every class that owns a ``threading.Lock /
RLock / Condition``, the set of ``self._*`` attributes ever touched
under ``with self.<lock>:`` is that class's *guarded set*; any access to
a guarded attribute outside the lock (in any method except
``__init__``, which runs before the object is shared) is a finding.
Escape hatch ``# graftlint: unguarded-ok`` for single-writer or
torn-read-tolerant sites.

**lock-order** — an edge ``A → B`` means "some method of A may acquire
B's lock while holding A's own lock". Lock acquisition is tracked
*transitively across classes*: every (class, method) gets a fixpoint
set of lock **sinks** — the classes whose locks the call may end up
acquiring through any chain of typed calls (``FleetRouter._bind_locked
→ replica.submit → FCFSScheduler.submit`` sinks to ``FCFSScheduler``
even though ``EngineReplica`` owns no lock). Cycles in the edge graph
are the static shadow of an ABBA deadlock and gate the run, as does
re-acquiring a non-reentrant own lock (nested ``with self._lock`` or
calling one of the class's own locking methods under it). Receivers are
typed with :class:`~chainermn_torch.analysis.astutil.TypeWorld`
(constructor / factory / list-element inference); untypeable receivers
create no edge. Escape hatch ``# graftlint: lock-order-ok``.

:func:`static_lock_graph` exposes the same edge set as data — the
runtime sanitizer (:mod:`chainermn_torch.analysis.sanitizer`) and the
``--runtime-report`` CLI mode assert every *observed* edge is in it.
"""

from __future__ import annotations

import ast
from typing import Iterator

from chainermn_torch.analysis import astutil
from chainermn_torch.analysis.core import Checker, Finding, Project


# container/collection methods that mutate their receiver — a call to
# one of these under the lock marks the receiver attr as lock-protected
MUTATORS = {
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "pop", "popitem", "popleft", "push", "remove", "reverse",
    "rotate", "setdefault", "sort", "update",
}


class LockDisciplineChecker(Checker):
    rule = "lock-discipline"
    suppress_token = "unguarded-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        for module in project.modules:
            for cm in astutil.iter_classes(module):
                if not cm.lock_attrs:
                    continue
                yield from self._check_class(module, cm)

    def _excluded(self, cm: astutil.ClassModel) -> set:
        # locks guard data, not other synchronizers or bound methods
        return cm.lock_attrs | cm.event_attrs | set(cm.methods)

    @staticmethod
    def _root_self_attr(expr: ast.AST):
        """Underlying ``self._x`` of ``self._x[k]...`` chains."""
        while isinstance(expr, ast.Subscript):
            expr = expr.value
        return astutil.is_self_attr(expr)

    def _accesses(self, cm: astutil.ClassModel):
        """(attr, mutates, under_lock, method, node) records for every
        ``self._*`` access outside ``__init__``. Methods named
        ``*_locked`` are the repo's called-with-lock-held convention and
        count as under the lock throughout."""
        excluded = self._excluded(cm)
        for name, meth in cm.methods.items():
            if name == "__init__":
                continue
            assumed = name.endswith("_locked")
            for sub in ast.walk(meth):
                attr = mutates = None
                if isinstance(sub, ast.Attribute):
                    attr = astutil.is_self_attr(sub)
                    mutates = isinstance(sub.ctx, (ast.Store, ast.Del))
                elif isinstance(sub, ast.Subscript) \
                        and isinstance(sub.ctx, (ast.Store, ast.Del)):
                    attr = self._root_self_attr(sub)
                    mutates = True
                elif isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr in MUTATORS:
                    attr = self._root_self_attr(sub.func.value)
                    mutates = True
                if attr is None or not attr.startswith("_") \
                        or attr in excluded:
                    continue
                under = assumed or cm.under_own_lock(sub)
                yield attr, mutates, under, name, sub

    def _check_class(self, module, cm: astutil.ClassModel
                     ) -> Iterator[Finding]:
        records = list(self._accesses(cm))
        mutated_under = {a for a, mut, under, _m, _n in records
                         if mut and under}
        read_under = {a for a, mut, under, _m, _n in records if under}
        mutated_anywhere = {a for a, mut, _u, _m, _n in records if mut}
        # guarded = mutated while holding the lock, or read under the
        # lock AND mutated somewhere after construction (a never-
        # reassigned reference to a thread-safe object is not shared
        # mutable state, even if it is touched inside critical sections)
        guarded = mutated_under | (read_under & mutated_anywhere)
        if not guarded:
            return
        seen: set = set()
        for attr, _mut, under, name, sub in records:
            if attr not in guarded or under:
                continue
            key = (cm.name, attr, name)
            if key in seen:
                continue
            seen.add(key)
            yield self.finding(
                module, sub,
                f"{cm.name}.{attr} is guarded by "
                f"{'/'.join(sorted(cm.lock_attrs))} elsewhere but "
                f"accessed without it in {name}()",
                symbol=f"{cm.name}.{attr}@{name}")


class LockOrderChecker(Checker):
    rule = "lock-order"
    suppress_token = "lock-order-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        yield from self._run(project, {})

    def _run(self, project: Project, edges: dict) -> Iterator[Finding]:
        """Full pass; ``edges[(A, B)] = (module, node, caller, callee)``
        is filled as a side effect (:func:`static_lock_graph` reads it
        back without caring about the findings)."""
        models: list = []
        per_module: dict = {}
        for module in project.modules:
            cms = astutil.iter_classes(module)
            per_module[module.modname] = cms
            models.extend(cms)
        world = astutil.TypeWorld(models)
        for module in project.modules:
            world.learn_factories(module)
        for cm in models:
            world.learn_attr_types(cm)
        sinks = self._lock_sinks(models, world)

        for module in project.modules:
            for cm in per_module[module.modname]:
                if not cm.lock_attrs:
                    continue
                yield from self._scan_class(module, cm, world, sinks,
                                            edges)

        yield from self._cycles(edges)

    # -- transitive lock sinks ------------------------------------------- #

    def _lock_sinks(self, models: list, world: astutil.TypeWorld) -> dict:
        """``(class name, method name) → frozenset of class names``
        whose locks the method may acquire — directly or through any
        chain of typed intra-/cross-class calls, to fixpoint."""
        canon = [cm for cm in models
                 if world.classes.get(cm.name) is cm]
        callees: dict = {}
        sinks: dict = {}
        for cm in canon:
            for name, meth in cm.methods.items():
                key = (cm.name, name)
                callees[key] = self._method_callees(cm, world, meth)
                sinks[key] = (frozenset({cm.name})
                              if cm.method_locks_directly(meth)
                              else frozenset())
        changed = True
        while changed:
            changed = False
            for key, calls in callees.items():
                cur = sinks[key]
                acc = set(cur)
                for c in calls:
                    acc |= sinks.get(c, frozenset())
                if acc != cur:
                    sinks[key] = frozenset(acc)
                    changed = True
        return sinks

    @staticmethod
    def _method_callees(cm, world, meth) -> list:
        locals_ = world.local_types(cm, meth)
        out: list = []
        for sub in ast.walk(meth):
            if not isinstance(sub, ast.Call) \
                    or not isinstance(sub.func, ast.Attribute):
                continue
            if astutil.is_self_attr(sub.func) is not None:
                out.append((cm.name, sub.func.attr))
                continue
            cls_name = world.receiver_class(cm, locals_, sub.func.value)
            if cls_name:
                out.append((cls_name, sub.func.attr))
        return out

    # -- per-class scan -------------------------------------------------- #

    def _scan_class(self, module, cm: astutil.ClassModel,
                    world: astutil.TypeWorld, sinks: dict, edges: dict
                    ) -> Iterator[Finding]:
        for name, meth in cm.methods.items():
            locals_ = world.local_types(cm, meth)
            for sub in ast.walk(meth):
                if not cm.under_own_lock(sub):
                    continue
                found = self._finding_at(module, cm, world, locals_,
                                         sinks, name, sub, edges)
                if found is not None:
                    yield found

    def _finding_at(self, module, cm, world, locals_, sinks, meth_name,
                    sub, edges):
        # nested re-acquire of a non-reentrant own lock
        if isinstance(sub, (ast.With, ast.AsyncWith)):
            for item in sub.items:
                attr = astutil.is_self_attr(item.context_expr)
                if (attr in cm.lock_attrs and attr not in cm.reentrant
                        and self._outer_holds(cm, sub, attr)):
                    return self.finding(
                        module, sub,
                        f"{cm.name}.{meth_name} re-enters non-reentrant "
                        f"lock {attr} already held by an enclosing with",
                        symbol=f"{cm.name}.{meth_name}:self-reacquire")
            return None

        callee_cls, callee = self._typed_callee(cm, world, locals_, sub)
        if callee_cls is None:
            return None
        if callee_cls is cm and callee in cm.locking_methods \
                and not cm.reentrant:
            return self.finding(
                module, sub,
                f"{cm.name}.{meth_name} calls own locking method "
                f"{callee}() while already holding the (non-reentrant)"
                f" lock — use an _unlocked variant",
                symbol=f"{cm.name}.{meth_name}->{callee}")
        for sink in sorted(sinks.get((callee_cls.name, callee), ())):
            if sink == cm.name:
                continue
            edges.setdefault((cm.name, sink),
                             (module, sub, f"{cm.name}.{meth_name}",
                              f"{callee_cls.name}.{callee}"))
        return None

    def _typed_callee(self, cm, world, locals_, sub):
        """(ClassModel, method/property name) when ``sub`` invokes a
        method or property of a typed receiver, else (None, None)."""
        if isinstance(sub, ast.Call) and isinstance(sub.func,
                                                    ast.Attribute):
            recv, meth = sub.func.value, sub.func.attr
            if astutil.is_self_attr(sub.func) is not None:
                return cm, meth
            cls_name = world.receiver_class(cm, locals_, recv)
            target = world.classes.get(cls_name) if cls_name else None
            if target is not None:
                return target, meth
        elif isinstance(sub, ast.Attribute) and getattr(
                getattr(sub, "graft_parent", None), "func", None) is not sub:
            # @property access (receiver.prop) — skip when the
            # attribute is itself the callee of a Call (handled above)
            cls_name = world.receiver_class(cm, locals_, sub.value)
            target = world.classes.get(cls_name) if cls_name else None
            if target is not None and sub.attr in target.properties:
                return target, sub.attr
        return None, None

    def _outer_holds(self, cm, node, lock_attr: str) -> bool:
        cur = getattr(node, "graft_parent", None)
        while cur is not None and not isinstance(cur, ast.ClassDef):
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    if astutil.is_self_attr(item.context_expr) == lock_attr:
                        return True
            cur = getattr(cur, "graft_parent", None)
        return False

    # -- graph ----------------------------------------------------------- #

    def _cycles(self, edges: dict) -> Iterator[Finding]:
        graph: dict = {}
        for (a, b) in edges:
            graph.setdefault(a, set()).add(b)

        emitted: set = set()

        def dfs(start, node, path):
            for nxt in sorted(graph.get(node, ())):
                if nxt == start:
                    yield path + [nxt]
                elif nxt not in path:
                    yield from dfs(start, nxt, path + [nxt])

        for start in sorted(graph):
            for cyc in dfs(start, start, [start]):
                key = frozenset(cyc)
                if key in emitted:
                    continue
                emitted.add(key)
                module, node, caller, callee = edges[(cyc[0], cyc[1])]
                chain = " -> ".join(cyc)
                yield self.finding(
                    module, node,
                    f"lock-acquisition cycle {chain} (ABBA deadlock "
                    f"hazard); representative edge {caller} -> {callee} "
                    f"under {cyc[0]}'s lock",
                    symbol=f"cycle:{'->'.join(sorted(key))}")


def static_lock_graph(project: Project) -> set:
    """The static lock-order edge set as ``{(holder_class,
    acquired_class)}`` — the reference graph the runtime sanitizer's
    *observed* edges must be a subset of (``--runtime-report``)."""
    edges: dict = {}
    for _ in LockOrderChecker()._run(project, edges):
        pass
    return set(edges)


__all__ = ["LockDisciplineChecker", "LockOrderChecker",
           "static_lock_graph"]
