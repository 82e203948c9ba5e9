"""Host-sync-in-hot-path checker, retargeted to the port's syncs.

Every host synchronization inside the per-token / per-step loops —
``torch.cuda.synchronize()``, ``.item()``, ``.cpu()``, ``.tolist()``,
``.numpy()``, ``Event``/``Stream`` ``.synchronize()``, and
``float()/int()/np.asarray`` on a device tensor — stalls the host until
the card drains its queue, which is a measurable TPOT/step-time hit
wherever the loop is launch-bound. This checker taints names assigned
from calls that return device tensors — the engine's step programs
(``self._programs...``, ``self._decode_round``, ``self._spec_verify``),
model calls (``self.model(...)``, ``self._model(...)``), and the
reference's ``self._*fn`` / ``self._*fns[...]`` naming convention — and
flags sync operations on tainted values inside the *hot set*:

- built-in hot bodies: ``ServingEngine.decode_step`` /
  ``decode_steps`` / ``spec_decode_step`` / ``admit_batch``,
  ``EngineReplica._loop``, ``ResilientTrainer.fit``,
  ``paged_update_cache_and_attend`` and ``paged_attend``;
- any function whose ``def`` line carries ``# graftlint: hot``.

``torch.cuda.synchronize`` and ``.synchronize()`` block on any receiver
and are flagged whatever their argument. The sanctioned route is
``chainermn_torch.dataflow.device_fetch`` — it has one documented sync
point, counts ``loss_fetch_total``, and its results are clean (assigning
from it untaints). Escape hatch: ``# graftlint: hot-sync-ok`` for syncs
that are the *point* of the line (e.g. a deliberate flush before a
timing fence).
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chainermn_torch.analysis import astutil
from chainermn_torch.analysis.core import HOT_MARK, Checker, Finding, Project

# (path suffix, qualname) pairs always treated as hot-loop bodies
HOT_FUNCTIONS = (
    ("serving/engine.py", "ServingEngine.decode_step"),
    # the multi-token rounds: the decode window and the speculative
    # draft+verify round run once per WINDOW, but a stray sync there
    # still serializes every round — same rule as decode_step
    ("serving/engine.py", "ServingEngine.decode_steps"),
    ("serving/engine.py", "ServingEngine.spec_decode_step"),
    ("serving/engine.py", "ServingEngine.admit_batch"),
    ("fleet/replica.py", "EngineReplica._loop"),
    ("resilience/trainer.py", "ResilientTrainer.fit"),
    # the paged-decode read side: run per decode step on every paged
    # path, inside captured CUDA graphs — a host sync here would
    # serialize each token of every slot (and fail the capture)
    ("parallel/sequence.py", "paged_update_cache_and_attend"),
    ("parallel/paged_kernel.py", "paged_attend"),
)

# syncs that exist only to block on the device: flagged on any argument
ALWAYS_SYNC = {"torch.cuda.synchronize"}
ALWAYS_SYNC_METHODS = {"synchronize"}
# host coercions: flagged only when the argument is a tainted device value
COERCIONS = {"np.asarray", "np.array", "numpy.asarray", "numpy.array",
             "float", "int", "bool"}
SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}

# self-attributes whose calls return device tensors: the engine's step
# programs and model calls (the reference's ``_*fn`` convention is
# COMPILED_ATTR_RE, kept as well)
DEVICE_CALL_ATTRS = {"_programs", "_decode_round", "_spec_verify",
                     "model", "_model"}

FETCH_NAMES = {"device_fetch", "dataflow.device_fetch"}


def _is_hot(module, func: ast.AST) -> bool:
    qual = astutil.func_qualname(func)
    for suffix, hot_qual in HOT_FUNCTIONS:
        if qual == hot_qual and module.path.endswith(suffix):
            return True
    return HOT_MARK in module.line_tokens(func.lineno)


class HostSyncChecker(Checker):
    rule = "host-sync"
    suppress_token = "hot-sync-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        for module in project.modules:
            for node in ast.walk(module.tree):
                if isinstance(node, (ast.FunctionDef,
                                     ast.AsyncFunctionDef)) \
                        and _is_hot(module, node):
                    yield from self._check_hot(module, node)

    # -- one hot body ---------------------------------------------------- #

    def _check_hot(self, module, func: ast.AST) -> Iterator[Finding]:
        qual = astutil.func_qualname(func)
        tainted: set = set()
        yield from self._walk_stmts(module, qual, func.body, tainted)

    def _walk_stmts(self, module, qual, stmts, tainted
                    ) -> Iterator[Finding]:
        for stmt in stmts:
            # check uses against the taint state *before* this statement's
            # bindings take effect (x = np.asarray(x) must flag)
            yield from self._check_exprs(module, qual, stmt, tainted)
            self._apply_bindings(stmt, tainted)
            for body in self._nested_bodies(stmt):
                yield from self._walk_stmts(module, qual, body, tainted)

    @staticmethod
    def _nested_bodies(stmt) -> list:
        out = []
        for attr in ("body", "orelse", "finalbody"):
            blk = getattr(stmt, attr, None)
            if blk and isinstance(blk[0], ast.stmt):
                out.append(blk)
        for handler in getattr(stmt, "handlers", []) or []:
            out.append(handler.body)
        return out

    # -- taint ----------------------------------------------------------- #

    def _value_tainted(self, expr, tainted) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in tainted
        if isinstance(expr, (ast.Subscript, ast.Attribute, ast.Starred)):
            return self._value_tainted(expr.value, tainted)
        if isinstance(expr, ast.Call):
            return self._is_compiled_call(expr)
        if isinstance(expr, (ast.Tuple, ast.List)):
            return any(self._value_tainted(e, tainted) for e in expr.elts)
        return False

    @staticmethod
    def _is_compiled_call(call: ast.Call) -> bool:
        """A call of a step program or a model: ``self._fn(x)``,
        ``self._fns[k](x)``, ``self._programs[k].run(x)``,
        ``self._decode_round(n)``, ``self.model(x)``."""
        func = call.func
        while isinstance(func, (ast.Subscript, ast.Attribute, ast.Call)):
            attr = astutil.is_self_attr(func)
            if attr is not None:
                return (attr in DEVICE_CALL_ATTRS
                        or astutil.COMPILED_ATTR_RE.match(attr) is not None)
            func = func.func if isinstance(func, ast.Call) else func.value
        return False

    def _apply_bindings(self, stmt, tainted) -> None:
        if not isinstance(stmt, ast.Assign):
            return
        value = stmt.value
        is_fetch = (isinstance(value, ast.Call)
                    and astutil.call_name(value.func) in FETCH_NAMES)
        taints = (not is_fetch) and self._value_tainted(value, tainted)
        for tgt in stmt.targets:
            names = [n.id for n in ast.walk(tgt) if isinstance(n, ast.Name)]
            for n in names:
                if taints:
                    tainted.add(n)
                else:
                    tainted.discard(n)

    # -- sync detection --------------------------------------------------- #

    def _check_exprs(self, module, qual, stmt, tainted
                     ) -> Iterator[Finding]:
        nested = set()
        for body in self._nested_bodies(stmt):
            for s in body:
                nested.update(id(n) for n in ast.walk(s))
        for sub in ast.walk(stmt):
            if id(sub) in nested or not isinstance(sub, ast.Call):
                continue
            found = self._sync_call(module, qual, sub, tainted)
            if found is not None:
                yield found

    def _sync_call(self, module, qual, call: ast.Call, tainted
                   ) -> Optional[Finding]:
        dotted = astutil.call_name(call.func)
        if dotted in FETCH_NAMES:
            return None
        if dotted in ALWAYS_SYNC:
            return self.finding(
                module, call,
                f"{dotted}() inside hot body {qual} — route through "
                f"dataflow.device_fetch (one counted sync point)",
                symbol=f"{qual}:{dotted}")
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in ALWAYS_SYNC_METHODS:
            return self.finding(
                module, call,
                f".{call.func.attr}() inside hot body {qual} blocks the "
                f"host on the card — route through dataflow.device_fetch",
                symbol=f"{qual}:.{call.func.attr}")
        if dotted in COERCIONS and call.args \
                and self._value_tainted(call.args[0], tainted):
            return self.finding(
                module, call,
                f"{dotted}() on a compiled-program result inside hot "
                f"body {qual} forces a host sync — use "
                f"dataflow.device_fetch",
                symbol=f"{qual}:{dotted}")
        if isinstance(call.func, ast.Attribute) \
                and call.func.attr in SYNC_METHODS \
                and self._value_tainted(call.func.value, tainted):
            return self.finding(
                module, call,
                f".{call.func.attr}() on a compiled-program result inside "
                f"hot body {qual} forces a host sync — use "
                f"dataflow.device_fetch",
                symbol=f"{qual}:.{call.func.attr}")
        return None


__all__ = ["DEVICE_CALL_ATTRS", "HOT_FUNCTIONS", "HostSyncChecker"]
