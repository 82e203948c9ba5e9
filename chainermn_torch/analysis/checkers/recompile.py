"""Recompile-hazard checker, retargeted to the port's hazards — the
static complement to ``RecompileGuard``.

The port's fixed programs are captured CUDA graphs
(``serving/_programs.py``); a compiled callable would come from
``torch.compile``. ``RecompileGuard`` counts builds at runtime; this
checker flags the call-site *shapes* that cause them, before anything
runs (the reference's ``jax.jit`` hazards, retargeted):

- **compile-in-loop** — ``torch.compile(...)`` (or ``torch.jit.script``
  / ``torch.jit.trace``) evaluated inside a ``for``/``while`` body or a
  hot-loop function: every evaluation makes a fresh callable with an
  empty cache. Cache-guarded one-time builds (``if fn is None:`` at
  function scope) are fine and not flagged.
- **compile-then-call** — ``torch.compile(f)(x)`` in one expression:
  the compiled artifact is dropped on the floor, so every execution
  recompiles.
- **capture-hazard** — inside a CUDA-graph capture body (a ``with
  torch.cuda.graph(...)`` block, ``StepProgram._capture`` /
  ``_capture_locked`` in ``serving/_programs.py``, or a function whose
  ``def`` line carries ``# graftlint: capture``): a host sync
  (``torch.cuda.synchronize``, ``.item()``, ``.cpu()``, ``.tolist()``,
  ``.numpy()``, ``.synchronize()``) fails the capture or freezes one
  step's value into the graph, and a Python branch on a tensor value
  (an ``if``/``while`` test that reduces a tensor: ``.any()``,
  ``.all()``, ``.item()``, ``bool``/``int``/``float`` of a call, or a
  ``torch.*`` call) records one side only, so every replay takes the
  branch the capture took.

Escape hatch: ``# graftlint: recompile-ok``.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chainermn_torch.analysis import astutil
from chainermn_torch.analysis.checkers.hotpath import _is_hot
from chainermn_torch.analysis.core import Checker, Finding, Project

COMPILE_NAMES = {"torch.compile", "torch.jit.script", "torch.jit.trace"}

# comment marker that adds a function to the capture-body set
CAPTURE_MARK = "capture"
# (path suffix, qualname) pairs always treated as CUDA-graph capture bodies
CAPTURE_FUNCTIONS = (
    ("serving/_programs.py", "StepProgram._capture"),
    ("serving/_programs.py", "StepProgram._capture_locked"),
)
GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph"}
CAPTURE_SYNC_CALLS = {"torch.cuda.synchronize"}
CAPTURE_SYNC_METHODS = {"item", "cpu", "tolist", "numpy", "synchronize"}
# calls in a branch test that read a tensor's value on the host
TENSOR_REDUCERS = {"any", "all", "item"}
HOST_COERCIONS = {"bool", "int", "float"}


def _is_compile_call(node: ast.AST) -> bool:
    return (isinstance(node, ast.Call)
            and astutil.call_name(node.func) in COMPILE_NAMES)


def _is_capture_fn(module, func: ast.AST) -> bool:
    qual = astutil.func_qualname(func)
    for suffix, cap_qual in CAPTURE_FUNCTIONS:
        if qual == cap_qual and module.path.endswith(suffix):
            return True
    return CAPTURE_MARK in module.line_tokens(func.lineno)


def _is_graph_with(node: ast.AST) -> bool:
    if not isinstance(node, (ast.With, ast.AsyncWith)):
        return False
    return any(isinstance(item.context_expr, ast.Call)
               and astutil.call_name(item.context_expr.func)
               in GRAPH_CONTEXTS for item in node.items)


class RecompileChecker(Checker):
    rule = "recompile-hazard"
    suppress_token = "recompile-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        for module in project.modules:
            yield from self._check_module(module)

    def _check_module(self, module) -> Iterator[Finding]:
        capture_regions: list = []
        for node in ast.walk(module.tree):
            if _is_compile_call(node):
                yield from self._compile_site(module, node)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and _is_capture_fn(module, node):
                capture_regions.append(
                    (astutil.func_qualname(node), node.body))
            if _is_graph_with(node):
                fn = astutil.enclosing_function(node)
                capture_regions.append(
                    (astutil.func_qualname(fn) if fn else "<module>",
                     node.body))
        yield from self._capture_hazards(module, capture_regions)

    # -- compile evaluation sites ----------------------------------------- #

    def _compile_site(self, module, node: ast.Call) -> Iterator[Finding]:
        name = astutil.call_name(node.func)
        where = self._loop_context(module, node)
        qual_fn = astutil.enclosing_function(node)
        qual = astutil.func_qualname(qual_fn) if qual_fn else "<module>"
        if where is not None:
            yield self.finding(
                module, node,
                f"{name} evaluated inside a {where} in {qual} — every "
                f"evaluation is a fresh callable with an empty cache; "
                f"hoist it or cache the compiled fn",
                symbol=f"{qual}:compile-in-loop")
        elif qual_fn is not None and _is_hot(module, qual_fn):
            yield self.finding(
                module, node,
                f"{name} evaluated inside hot body {qual} — hoist to "
                f"setup/warmup",
                symbol=f"{qual}:compile-in-hot")
        parent = getattr(node, "graft_parent", None)
        if isinstance(parent, ast.Call) and parent.func is node:
            yield self.finding(
                module, node,
                f"{name}(f)(...) called in one expression in {qual} — "
                f"the compiled callable is discarded, so every execution "
                f"recompiles; bind it once",
                symbol=f"{qual}:compile-then-call")

    @staticmethod
    def _loop_context(module, node: ast.AST) -> Optional[str]:
        cur = getattr(node, "graft_parent", None)
        while cur is not None and not isinstance(
                cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            if isinstance(cur, (ast.For, ast.AsyncFor)):
                return "for loop"
            if isinstance(cur, ast.While):
                return "while loop"
            cur = getattr(cur, "graft_parent", None)
        return None

    # -- CUDA-graph capture bodies ----------------------------------------- #

    def _capture_hazards(self, module, regions: list) -> Iterator[Finding]:
        seen: set = set()
        for qual, body in regions:
            for stmt in body:
                for sub in ast.walk(stmt):
                    if id(sub) in seen:
                        continue
                    seen.add(id(sub))
                    found = self._capture_node(module, qual, sub)
                    if found is not None:
                        yield found

    def _capture_node(self, module, qual, sub) -> Optional[Finding]:
        if isinstance(sub, ast.Call):
            dotted = astutil.call_name(sub.func)
            meth = sub.func.attr if isinstance(sub.func, ast.Attribute) \
                else None
            if dotted in CAPTURE_SYNC_CALLS or (
                    meth in CAPTURE_SYNC_METHODS
                    and dotted not in CAPTURE_SYNC_CALLS):
                what = dotted if dotted in CAPTURE_SYNC_CALLS \
                    else f".{meth}"
                return self.finding(
                    module, sub,
                    f"{what}() inside CUDA-graph capture body {qual} — a "
                    f"host sync fails the capture or freezes one step's "
                    f"value into every replay",
                    symbol=f"{qual}:capture-sync:{what}")
            return None
        if isinstance(sub, (ast.If, ast.While, ast.IfExp)) \
                and self._reads_tensor(sub.test):
            return self.finding(
                module, sub,
                f"Python branch on a tensor value inside CUDA-graph "
                f"capture body {qual} — the graph records the side the "
                f"capture took, and every replay takes it; use "
                f"torch.where",
                symbol=f"{qual}:capture-branch")
        return None

    @staticmethod
    def _reads_tensor(test: ast.AST) -> bool:
        for n in ast.walk(test):
            if not isinstance(n, ast.Call):
                continue
            dotted = astutil.call_name(n.func)
            if dotted.startswith("torch."):
                return True
            if isinstance(n.func, ast.Attribute) \
                    and n.func.attr in TENSOR_REDUCERS:
                return True
            if dotted in HOST_COERCIONS and n.args \
                    and isinstance(n.args[0], ast.Call):
                return True
        return False


__all__ = ["CAPTURE_FUNCTIONS", "RecompileChecker"]
