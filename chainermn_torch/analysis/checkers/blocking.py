"""Blocking-under-lock checker.

Holding a hot lock across blocking work — device fetches, file/socket
I/O, ``time.sleep``, thread ``join``, blocking ``queue.Queue``
get/put — stalls *every* thread contending on it: the scheduler's
submit path, the router's bind path, the metric scrape. The static
lock-order checker proves ordering; this one proves the critical
sections stay non-blocking.

A statement is "under the lock" when it sits lexically inside ``with
self.<lock>:`` for any of the class's lock attributes, or anywhere in a
``*_locked``-named method (the repo's called-with-lock-held
convention), or inside ``with <MODULE_LOCK>:`` for a module-level lock
global. Flagged inside such regions (errors):

- ``time.sleep`` / bare ``sleep``;
- file I/O and filesystem metadata: ``open``, ``os.replace/rename/
  remove/unlink/fsync/makedirs``, ``shutil.*``;
- the port's device syncs: ``torch.cuda.synchronize``, ``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()`` and ``Event``/``Stream``
  ``.synchronize()``, and even the sanctioned ``dataflow.device_fetch``
  — a counted sync point is still a sync;
- ``.join()`` (thread/process) — string-literal separators
  (``", ".join``) are skipped;
- ``.wait()`` — except on the class's own ``Condition`` lock attrs
  (``cv.wait()`` *releases* the lock; that is the sanctioned pattern);
- socket ops (``recv/send/sendall/accept/connect``);
- blocking ``get()``/``put()`` on attributes assigned a
  ``queue.Queue`` family constructor (``get_nowait``/``put_nowait``
  stay legal; plain dict ``.get`` is untouched because only
  queue-typed attributes count).

Escape hatch: ``# graftlint: blocking-ok`` for sections where the
blocking is the point and the exposure is documented (the checkpoint
writer's atomic publish under its I/O lock).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chainermn_torch.analysis import astutil
from chainermn_torch.analysis.core import Checker, Finding, Project

# dotted call names that block regardless of receiver
BLOCKING_CALLS = {
    "time.sleep", "sleep",
    "open", "os.replace", "os.rename", "os.remove", "os.unlink",
    "os.fsync", "os.makedirs",
    "shutil.rmtree", "shutil.copy", "shutil.copyfile", "shutil.move",
    "subprocess.run", "subprocess.check_call", "subprocess.check_output",
    "torch.cuda.synchronize",
    "device_fetch", "dataflow.device_fetch",
}

# receiver.method() calls that block on any receiver
BLOCKING_METHODS = {
    "join", "wait",
    "recv", "send", "sendall", "accept", "connect",
    # the port's device syncs (the reference's ``block_until_ready``)
    "item", "cpu", "tolist", "numpy", "synchronize",
}

QUEUE_FACTORIES = {"Queue", "SimpleQueue", "LifoQueue", "PriorityQueue"}
QUEUE_BLOCKING = {"get", "put"}


def _queue_attrs(cm: astutil.ClassModel) -> set:
    """Self-attrs assigned a queue.Queue-family constructor."""
    out: set = set()
    for meth in cm.methods.values():
        for sub in ast.walk(meth):
            if not isinstance(sub, ast.Assign):
                continue
            if not isinstance(sub.value, ast.Call):
                continue
            leaf = astutil.call_name(sub.value.func).rsplit(".", 1)[-1]
            if leaf not in QUEUE_FACTORIES:
                continue
            for tgt in sub.targets:
                attr = astutil.is_self_attr(tgt)
                if attr is not None:
                    out.add(attr)
    return out


def _module_locks(module) -> set:
    """Module-level globals assigned a lock factory."""
    out: set = set()
    for node in module.tree.body:
        if isinstance(node, ast.Assign) \
                and astutil._threading_factory(node.value,
                                               astutil.LOCK_FACTORIES):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


class BlockingUnderLockChecker(Checker):
    rule = "blocking-under-lock"
    suppress_token = "blocking-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        for module in project.modules:
            yield from self._check_classes(module)
            yield from self._check_module_locks(module)

    # -- class locks ------------------------------------------------------ #

    def _check_classes(self, module) -> Iterator[Finding]:
        for cm in astutil.iter_classes(module):
            if not cm.lock_attrs:
                continue
            queues = _queue_attrs(cm)
            expanded: set = set()
            for name, meth in cm.methods.items():
                assumed = name.endswith("_locked")
                local_defs = {sub.name: sub for sub in ast.walk(meth)
                              if isinstance(sub, ast.FunctionDef)
                              and sub is not meth}
                for sub in ast.walk(meth):
                    if not isinstance(sub, ast.Call):
                        continue
                    if not assumed and not cm.under_own_lock(sub):
                        continue
                    found = self._blocking_call(
                        module, sub, holder=cm.name,
                        where=f"{cm.name}.{name}", cm=cm, queues=queues)
                    if found is not None:
                        yield found
                        continue
                    yield from self._expand_callee(
                        module, cm, queues, name, sub, local_defs,
                        expanded)

    def _expand_callee(self, module, cm, queues, caller: str,
                       call: ast.Call, local_defs: dict,
                       expanded: set) -> Iterator[Finding]:
        """One level of indirection: a helper defined in the method
        (``def write(): ...`` then ``write()`` under the lock) or an
        intra-class ``self._m()`` call still runs with the lock held —
        flag blocking calls inside the callee body too. Callees that
        take the class lock themselves are skipped (their own bodies
        are already scanned as lock-held regions)."""
        callee_def = None
        where = None
        if isinstance(call.func, ast.Name) and call.func.id in local_defs:
            callee_def = local_defs[call.func.id]
            where = f"{cm.name}.{caller}.{call.func.id}"
        else:
            attr = astutil.is_self_attr(call.func)
            if attr in cm.methods \
                    and not cm.method_locks_directly(cm.methods[attr]):
                callee_def = cm.methods[attr]
                where = f"{cm.name}.{attr}"
        if callee_def is None or id(callee_def) in expanded:
            return
        expanded.add(id(callee_def))
        for inner in ast.walk(callee_def):
            if not isinstance(inner, ast.Call):
                continue
            found = self._blocking_call(module, inner, holder=cm.name,
                                        where=where, cm=cm, queues=queues)
            if found is not None:
                yield found

    # -- module-level locks ------------------------------------------------ #

    def _check_module_locks(self, module) -> Iterator[Finding]:
        locks = _module_locks(module)
        if not locks:
            return
        for node in ast.walk(module.tree):
            if not isinstance(node, (ast.With, ast.AsyncWith)):
                continue
            held = [item.context_expr.id for item in node.items
                    if isinstance(item.context_expr, ast.Name)
                    and item.context_expr.id in locks]
            if not held:
                continue
            func = astutil.enclosing_function(node)
            where = astutil.func_qualname(func) if func is not None \
                else module.modname
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Call):
                    continue
                found = self._blocking_call(module, sub, holder=held[0],
                                            where=where)
                if found is not None:
                    yield found

    # -- one call site ----------------------------------------------------- #

    def _blocking_call(self, module, call: ast.Call, *, holder: str,
                       where: str, cm: Optional[astutil.ClassModel] = None,
                       queues: set = frozenset()) -> Optional[Finding]:
        dotted = astutil.call_name(call.func)
        if dotted in BLOCKING_CALLS:
            return self.finding(
                module, call,
                f"{dotted}() while holding {holder}'s lock in {where} — "
                f"blocking work under a lock stalls every contending "
                f"thread; move it outside the critical section",
                symbol=f"{where}:{dotted}")
        if not isinstance(call.func, ast.Attribute):
            return None
        meth = call.func.attr
        recv = call.func.value
        if meth in BLOCKING_METHODS:
            # ", ".join(parts) — a string separator, not a thread
            if isinstance(recv, ast.Constant):
                return None
            # cv.wait() on an own Condition releases the lock: sanctioned
            if cm is not None and meth == "wait" \
                    and astutil.is_self_attr(recv) in cm.lock_attrs:
                return None
            return self.finding(
                module, call,
                f".{meth}() while holding {holder}'s lock in {where} — "
                f"blocking work under a lock stalls every contending "
                f"thread; move it outside the critical section",
                symbol=f"{where}:.{meth}")
        if meth in QUEUE_BLOCKING and cm is not None:
            attr = astutil.is_self_attr(recv)
            if attr in queues and not self._nonblocking_kw(call):
                return self.finding(
                    module, call,
                    f"blocking queue .{meth}() on self.{attr} while "
                    f"holding {holder}'s lock in {where} — use the "
                    f"_nowait variant or move it outside the critical "
                    f"section",
                    symbol=f"{where}:queue.{meth}")
        return None

    @staticmethod
    def _nonblocking_kw(call: ast.Call) -> bool:
        for kw in call.keywords:
            if kw.arg == "block" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return True
        return False


__all__ = ["BLOCKING_CALLS", "BLOCKING_METHODS",
           "BlockingUnderLockChecker"]
