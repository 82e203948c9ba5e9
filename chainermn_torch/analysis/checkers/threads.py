"""Thread-lifecycle checker.

Every ``threading.Thread`` the system spawns must have a defined end of
life: either it is a daemon (the interpreter may exit under it — only
acceptable for pure-observer loops) or some lifecycle method joins it.
A non-daemon thread that nobody joins turns ``close()`` into a hang and
test teardown into a leak; a *daemon* thread that touches shared state
during interpreter shutdown dies mid-mutation.

A ``Thread(...)`` construction site is compliant when any of:

- the constructor call carries ``daemon=True``;
- the bound name (``self._thread`` / local ``t``) gets a
  ``.daemon = True`` assignment before ``.start()``;
- the bound name is ``.join()``-ed somewhere in the same class (or
  module, for module-level threads) inside a *lifecycle-named*
  function — one matching ``stop/close/shutdown/join/exit/terminate/
  finish/drain/__del__/__exit__`` — so the teardown path provably
  reaps it.

An unbound ``Thread(...).start()`` can never be joined and is always
flagged. Escape hatch: ``# graftlint: thread-ok`` with a comment
explaining who reaps the thread.
"""

from __future__ import annotations

import ast
import re
from typing import Iterator, Optional

from chainermn_torch.analysis import astutil
from chainermn_torch.analysis.core import Checker, Finding, Project

LIFECYCLE_RE = re.compile(
    r"(stop|close|shutdown|join|exit|terminate|finish|drain|"
    r"__del__|__exit__)", re.IGNORECASE)


def _is_thread_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    dotted = astutil.call_name(node.func)
    return bool(dotted) and dotted.rsplit(".", 1)[-1] == "Thread"


def _daemon_kw(call: ast.Call) -> bool:
    for kw in call.keywords:
        if kw.arg == "daemon" and isinstance(kw.value, ast.Constant) \
                and kw.value.value is True:
            return True
    return False


def _bound_name(call: ast.Call) -> Optional[str]:
    """``self._t = Thread(...)`` → ``"._t"``; ``t = Thread(...)`` →
    ``"t"``; unbound → None."""
    parent = getattr(call, "graft_parent", None)
    if isinstance(parent, ast.Assign):
        for tgt in parent.targets:
            attr = astutil.is_self_attr(tgt)
            if attr is not None:
                return f".{attr}"
            if isinstance(tgt, ast.Name):
                return tgt.id
    return None


def _name_matches(expr: ast.AST, bound: str) -> bool:
    if bound.startswith("."):
        return astutil.is_self_attr(expr) == bound[1:]
    return isinstance(expr, ast.Name) and expr.id == bound


class ThreadLifecycleChecker(Checker):
    rule = "thread-lifecycle"
    suppress_token = "thread-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        for module in project.modules:
            for call in ast.walk(module.tree):
                if not _is_thread_call(call):
                    continue
                finding = self._check_site(module, call)
                if finding is not None:
                    yield finding

    def _check_site(self, module, call: ast.Call) -> Optional[Finding]:
        if _daemon_kw(call):
            return None
        bound = _bound_name(call)
        func = astutil.enclosing_function(call)
        where = astutil.func_qualname(func) if func is not None \
            else module.modname
        if bound is None:
            return self.finding(
                module, call,
                f"unbound Thread(...) in {where} — it can never be "
                f"joined; bind it and reap it on the stop/close path, "
                f"or pass daemon=True",
                symbol=f"{where}:Thread")
        # scope to search for .daemon = True and lifecycle joins: the
        # enclosing class for self-attrs, else the whole module
        scope: ast.AST = module.tree
        if bound.startswith("."):
            cls = astutil.enclosing_class(call)
            if cls is not None:
                scope = cls
        if self._daemon_assigned(scope, bound):
            return None
        if self._joined_in_lifecycle(scope, bound):
            return None
        return self.finding(
            module, call,
            f"Thread bound to {bound} in {where} is neither daemon nor "
            f"joined on a lifecycle path (stop/close/shutdown/...) — "
            f"teardown will leak or hang on it",
            symbol=f"{where}:Thread:{bound}")

    @staticmethod
    def _daemon_assigned(scope: ast.AST, bound: str) -> bool:
        for sub in ast.walk(scope):
            if not isinstance(sub, ast.Assign):
                continue
            if not (isinstance(sub.value, ast.Constant)
                    and sub.value.value is True):
                continue
            for tgt in sub.targets:
                if isinstance(tgt, ast.Attribute) and tgt.attr == "daemon" \
                        and _name_matches(tgt.value, bound):
                    return True
        return False

    @staticmethod
    def _joined_in_lifecycle(scope: ast.AST, bound: str) -> bool:
        for sub in ast.walk(scope):
            if not isinstance(sub, ast.Call):
                continue
            func = sub.func
            if not (isinstance(func, ast.Attribute)
                    and func.attr == "join"
                    and _name_matches(func.value, bound)):
                continue
            enc = astutil.enclosing_function(sub)
            if enc is not None and LIFECYCLE_RE.search(enc.name):
                return True
        return False


__all__ = ["LIFECYCLE_RE", "ThreadLifecycleChecker"]
