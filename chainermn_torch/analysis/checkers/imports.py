"""Import-hygiene checker: the static module-level import graph.

``tests/test_torch_import_hygiene.py`` proves in a subprocess that the
port's monitor / fleet / deploy import without torch, extensions, or
the serving stack; this checker proves the same property over *every*
module, without running anything, and names the offending chain.

Only module-level imports count — an import inside a function body is
the sanctioned lazy pattern. Importing ``a.b.c`` executes every ancestor
package ``__init__`` on the way down, so edges are added for ``a.b`` as
well (the bare top-level ``chainermn_torch`` package is excluded,
mirroring the hygiene test's parent-package stub). ``if TYPE_CHECKING:``
blocks are ignored.

Rules enforced (prefix-matched, transitively over analyzed modules):

- ``chainermn_torch.monitor`` must not reach ``chainermn_torch.extensions``;
- ``chainermn_torch.fleet`` / ``chainermn_torch.deploy`` must not reach
  ``chainermn_torch.extensions``, ``chainermn_torch.serving``, or
  ``torch`` (the reference's rule forbids ``jax`` there; ``torch`` is
  its counterpart);
- ``chainermn_torch.analysis`` must not reach *any* ``chainermn_torch.*``
  outside itself, nor ``torch`` / ``numpy`` — the analyzer never imports
  what it analyzes.

Escape hatch: ``# graftlint: import-ok`` on the import line.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

from chainermn_torch.analysis.core import Checker, Finding, Project

TOP_PACKAGE = "chainermn_torch"


def _prefixed(name: str, prefix: str) -> bool:
    return name == prefix or name.startswith(prefix + ".")


class Rule:
    def __init__(self, source: str, forbidden: tuple,
                 allowed: tuple = ()) -> None:
        self.source = source
        self.forbidden = forbidden
        self.allowed = allowed

    def violates(self, name: str) -> Optional[str]:
        for ok in self.allowed:
            if _prefixed(name, ok):
                return None
        for bad in self.forbidden:
            if _prefixed(name, bad):
                return bad
        return None


RULES = (
    Rule("chainermn_torch.monitor",
         forbidden=("chainermn_torch.extensions",)),
    Rule("chainermn_torch.fleet",
         forbidden=("chainermn_torch.extensions", "chainermn_torch.serving",
                    "torch")),
    Rule("chainermn_torch.deploy",
         forbidden=("chainermn_torch.extensions", "chainermn_torch.serving",
                    "torch")),
    Rule("chainermn_torch.analysis",
         forbidden=("chainermn_torch", "torch", "numpy"),
         allowed=("chainermn_torch.analysis",)),
)


def eager_imports(module) -> list:
    """(dotted name, import node) pairs for module-level imports,
    ancestors included, function bodies and TYPE_CHECKING blocks not."""
    out: list = []

    is_package = module.path.endswith("__init__.py")
    pkg_parts = module.modname.split(".")
    if not is_package:
        pkg_parts = pkg_parts[:-1]

    def add(name: str, node) -> None:
        parts = name.split(".")
        for i in range(1, len(parts) + 1):
            anc = ".".join(parts[:i])
            if anc != TOP_PACKAGE:
                out.append((anc, node))

    def visit(stmts) -> None:
        for stmt in stmts:
            if isinstance(stmt, ast.Import):
                for alias in stmt.names:
                    add(alias.name, stmt)
            elif isinstance(stmt, ast.ImportFrom):
                if stmt.level:
                    base_parts = pkg_parts[:len(pkg_parts)
                                           - (stmt.level - 1)]
                    base = ".".join(base_parts)
                    name = f"{base}.{stmt.module}" if stmt.module else base
                else:
                    name = stmt.module or ""
                if name:
                    add(name, stmt)
                    # `from pkg import sub` may bind a submodule: add the
                    # candidate only when it is an analyzed module
                    for alias in stmt.names:
                        out.append((f"{name}.{alias.name}", stmt))
            elif isinstance(stmt, (ast.If,)):
                tests = " ".join(n.id for n in ast.walk(stmt.test)
                                 if isinstance(n, ast.Name))
                if "TYPE_CHECKING" not in tests:
                    visit(stmt.body)
                    visit(stmt.orelse)
            elif isinstance(stmt, ast.Try):
                visit(stmt.body)
                visit(stmt.orelse)
                visit(stmt.finalbody)
                for h in stmt.handlers:
                    visit(h.body)
            elif isinstance(stmt, ast.ClassDef):
                visit(stmt.body)
    visit(module.tree.body)
    return out


class ImportHygieneChecker(Checker):
    rule = "import-hygiene"
    suppress_token = "import-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        eager: dict = {m.modname: eager_imports(m)
                       for m in project.modules}
        for rule in RULES:
            for module in project.modules_under(rule.source):
                yield from self._check_module(project, eager, rule,
                                              module)

    def _check_module(self, project: Project, eager: dict, rule: Rule,
                      module) -> Iterator[Finding]:
        seen: set = set()
        reported: set = set()
        # queue entries: (name, origin import node, chain string)
        queue = [(name, node, module.modname)
                 for name, node in eager.get(module.modname, ())]
        while queue:
            name, node, chain = queue.pop(0)
            if name in seen:
                continue
            seen.add(name)
            bad = rule.violates(name)
            if bad is not None:
                key = (module.modname, bad)
                if key in reported:
                    continue
                reported.add(key)
                via = f"{chain} -> {name}"
                yield self.finding(
                    module, node,
                    f"{module.modname} eagerly reaches {name} "
                    f"({via}) — forbidden by the {rule.source} "
                    f"lazy-import rule; move the import into the "
                    f"function that needs it",
                    symbol=f"{module.modname}->{bad}")
                continue
            nxt = eager.get(name)
            if nxt is not None and name != module.modname:
                for sub_name, _sub_node in nxt:
                    if sub_name not in seen:
                        queue.append((sub_name, node, f"{chain} -> {name}"))
        return


__all__ = ["RULES", "ImportHygieneChecker", "eager_imports"]
