"""Cut-point & metric/event consistency checker.

Fault cut-points (``resilience.faults.inject``/``torn_fraction``) and
monitor metric/event names are *stringly-typed protocols*: a typo'd
point silently never fires, a renamed metric silently forks the time
series, and the README table rots. This checker pins all three surfaces
to two AST-parsed catalogs (never imported — the analyzer stays
stdlib-only):

- ``chainermn_torch/resilience/cutpoints.py`` — UPPERCASE string
  constants (one per cut-point), ``DYNAMIC_PREFIXES`` for families like
  ``comm.<op>``, and helper functions (``comm_point``) that build
  dynamic points;
- ``chainermn_torch/monitor/catalog.py`` — ``METRIC_NAMES`` and
  ``EVENT_KINDS`` frozensets.

Rules (errors unless noted):

- an ``inject(...)``/``torn_fraction(...)``/``point=`` argument that is
  a bare string literal (migrate to the catalog constant);
- a resolved point value absent from the catalog, and catalog constants
  no call-site uses (drift, both directions);
- catalog values violating the naming conventions (``seg.seg`` lowercase
  cut-points; ``^[a-z][a-z0-9_]*$`` metrics/events; counters end
  ``_total``; a name ends ``_seconds`` iff it is a histogram with
  ``unit="s"``);
- metric/event emission with a literal name not in the catalog, and
  catalog names never emitted;
- every cut-point must appear quoted in some port test file
  (``tests/test_torch_*.py``; warning for metrics/events) and in the
  README's port section. The reference's own tests and README sit in
  the same tree and pin the same names, so they are left out of both
  scans: they would hide a pin the port lacks.

Escape hatch: ``# graftlint: name-ok``.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Iterator

from chainermn_torch.analysis import astutil
from chainermn_torch.analysis.core import Checker, Finding, Project

CUTPOINTS_MOD = "chainermn_torch.resilience.cutpoints"
CATALOG_MOD = "chainermn_torch.monitor.catalog"
FAULTS_MOD = "chainermn_torch.resilience.faults"
REGISTRY_MOD = "chainermn_torch.monitor.registry"

CUT_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z][a-z0-9_]*)+$")
NAME_RE = re.compile(r"^[a-z][a-z0-9_]*$")

INJECT_FUNCS = {"inject", "torn_fraction", "_inject"}
METRIC_FUNCS = {"counter", "gauge", "histogram"}

# the port's pins: test files whose basename starts with this prefix, and
# the README section whose heading names the port's package
TESTS_PREFIX = "test_torch_"
README_SECTION = "(`chainermn_torch`)"


def readme_port_section(readme: str) -> str:
    """The README's port section: from the ``#`` heading that names the
    port's package to the next heading of the same or a higher level
    (``#`` lines inside fenced code blocks are not headings)."""
    out: list = []
    level = 0
    fenced = False
    for line in readme.splitlines():
        if line.startswith("```"):
            fenced = not fenced
        depth = (len(line) - len(line.lstrip("#"))
                 if line.startswith("#") and not fenced else 0)
        if level and depth and depth <= level:
            break
        if not level and depth and README_SECTION in line:
            level = depth
        if level:
            out.append(line)
    return "\n".join(out)


def _str_nodes(expr: ast.AST) -> list:
    """String constant nodes inside a set/tuple/list/frozenset(...)
    literal."""
    if isinstance(expr, ast.Call) and astutil.call_name(expr.func) in (
            "frozenset", "set", "tuple"):
        return _str_nodes(expr.args[0]) if expr.args else []
    if isinstance(expr, (ast.Set, ast.Tuple, ast.List)):
        return [e for e in expr.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return []


def _str_elts(expr: ast.AST) -> list:
    """String constants inside a set/tuple/list/frozenset(...) literal."""
    return [e.value for e in _str_nodes(expr)]


class _Catalogs:
    def __init__(self) -> None:
        self.cutpoints: dict = {}        # CONST name -> value
        self.cut_nodes: dict = {}        # CONST name -> assign node
        self.dynamic_prefixes: list = []
        self.helpers: set = set()        # cutpoints module function names
        self.metric_names: set = set()
        self.event_kinds: set = set()
        self.name_nodes: dict = {}       # catalog name -> its Constant
        self.cutpoints_mod = None
        self.catalog_mod = None

    def load(self, project: Project) -> None:
        cp = project.module(CUTPOINTS_MOD)
        if cp is not None:
            self.cutpoints_mod = cp
            for node in cp.tree.body:
                if isinstance(node, ast.FunctionDef):
                    self.helpers.add(node.name)
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    if tgt.id == "DYNAMIC_PREFIXES":
                        self.dynamic_prefixes = _str_elts(node.value)
                    elif tgt.id.isupper() and isinstance(node.value,
                                                         ast.Constant) \
                            and isinstance(node.value.value, str):
                        self.cutpoints[tgt.id] = node.value.value
                        self.cut_nodes[tgt.id] = node
        cat = project.module(CATALOG_MOD)
        if cat is not None:
            self.catalog_mod = cat
            for node in cat.tree.body:
                if not isinstance(node, ast.Assign):
                    continue
                for tgt in node.targets:
                    if not isinstance(tgt, ast.Name):
                        continue
                    if tgt.id == "METRIC_NAMES":
                        self.metric_names = set(_str_elts(node.value))
                    elif tgt.id == "EVENT_KINDS":
                        self.event_kinds = set(_str_elts(node.value))
                    else:
                        continue
                    for e in _str_nodes(node.value):
                        self.name_nodes.setdefault(e.value, e)

    def point_known(self, value: str) -> bool:
        return value in self.cutpoints.values() or any(
            value.startswith(p) for p in self.dynamic_prefixes)


class ConsistencyChecker(Checker):
    rule = "consistency"
    suppress_token = "name-ok"

    def check(self, project: Project) -> Iterator[Finding]:
        cats = _Catalogs()
        cats.load(project)
        yield from self._missing_catalogs(project, cats)

        used_points: set = set()
        used_metrics: set = set()
        used_events: set = set()
        for module in project.modules:
            if module.modname == CUTPOINTS_MOD:
                continue
            yield from self._scan_module(module, cats, used_points,
                                         used_metrics, used_events)
        yield from self._catalog_side(project, cats, used_points,
                                      used_metrics, used_events)

    # -- presence --------------------------------------------------------- #

    def _missing_catalogs(self, project: Project, cats: _Catalogs
                          ) -> Iterator[Finding]:
        if project.module(FAULTS_MOD) is not None \
                and cats.cutpoints_mod is None:
            yield self.finding(
                project.module(FAULTS_MOD), None,
                f"fault injection exists but {CUTPOINTS_MOD} (the "
                f"cut-point catalog) is missing",
                symbol="missing:cutpoints")
        if project.module(REGISTRY_MOD) is not None \
                and cats.catalog_mod is None:
            yield self.finding(
                project.module(REGISTRY_MOD), None,
                f"metrics registry exists but {CATALOG_MOD} (the "
                f"metric/event catalog) is missing",
                symbol="missing:catalog")

    # -- per-module scan --------------------------------------------------- #

    def _scan_module(self, module, cats, used_points, used_metrics,
                     used_events) -> Iterator[Finding]:
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield from self._point_defaults(module, node, cats,
                                                used_points)
            if not isinstance(node, ast.Call):
                continue
            dotted = astutil.call_name(node.func)
            leaf = dotted.rsplit(".", 1)[-1] if dotted else ""
            if leaf in INJECT_FUNCS and module.modname != FAULTS_MOD:
                expr = node.args[0] if node.args else next(
                    (kw.value for kw in node.keywords
                     if kw.arg == "point"), None)
                if expr is not None:
                    yield from self._point_expr(module, node, expr, cats,
                                                used_points)
            elif any(kw.arg == "point" for kw in node.keywords):
                expr = next(kw.value for kw in node.keywords
                            if kw.arg == "point")
                yield from self._point_expr(module, node, expr, cats,
                                            used_points)
            # receiver methods match on the attribute name so that
            # get_registry().counter(...) / get_event_log().emit(...)
            # (dynamic receivers call_name cannot resolve) still count
            meth = node.func.attr if isinstance(node.func,
                                                ast.Attribute) else leaf
            if meth in METRIC_FUNCS and isinstance(node.func,
                                                   ast.Attribute) \
                    and module.modname != REGISTRY_MOD:
                yield from self._metric_site(module, node, meth, cats,
                                             used_metrics)
            if meth == "emit" and isinstance(node.func, ast.Attribute) \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant) \
                    and isinstance(node.args[0].value, str) \
                    and module.modname != "chainermn_torch.monitor.events":
                yield from self._event_site(module, node, cats,
                                            used_events)

    # -- cut-points -------------------------------------------------------- #

    def _point_defaults(self, module, func, cats, used_points
                        ) -> Iterator[Finding]:
        args = func.args
        pos = args.args + args.kwonlyargs
        defaults = ([None] * (len(args.args) - len(args.defaults))
                    + list(args.defaults) + list(args.kw_defaults))
        for a, d in zip(pos, defaults):
            if a.arg != "point" or d is None:
                continue
            yield from self._point_expr(module, d, d, cats, used_points,
                                        context=f"default of "
                                        f"{astutil.func_qualname(func)}")

    def _point_expr(self, module, node, expr, cats, used_points,
                    context: str = "") -> Iterator[Finding]:
        value, kind = self._resolve_point(module, expr, cats)
        where = f" ({context})" if context else ""
        if kind == "literal":
            used_points.add(value)
            if cats.cutpoints_mod is not None:
                yield self.finding(
                    module, node,
                    f"bare cut-point literal {value!r}{where} — use the "
                    f"constant from resilience/cutpoints.py",
                    symbol=f"literal:{module.modname}:{value}")
            return
        if kind == "const":
            used_points.add(value)
            if not cats.point_known(value):
                yield self.finding(
                    module, node,
                    f"cut-point {value!r}{where} is not in the "
                    f"cutpoints catalog",
                    symbol=f"unknown:{module.modname}:{value}")
        elif kind == "helper":
            used_points.update(cats.dynamic_prefixes)
        elif kind == "unknown-const":
            yield self.finding(
                module, node,
                f"cut-point constant {value} is not defined in "
                f"resilience/cutpoints.py",
                symbol=f"unknown-const:{module.modname}:{value}")
        # kind None: unresolvable expression — no claim

    def _resolve_point(self, module, expr, cats,
                       depth: int = 0) -> tuple:
        """(value, kind) where kind ∈ {literal, const, helper,
        unknown-const, None}."""
        if depth > 4:
            return None, None
        if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
            return expr.value, "literal"
        if isinstance(expr, ast.Attribute) and expr.attr.isupper():
            if expr.attr in cats.cutpoints:
                return cats.cutpoints[expr.attr], "const"
            return expr.attr, "unknown-const"
        if isinstance(expr, ast.Name) and expr.id.isupper():
            if expr.id in cats.cutpoints:
                return cats.cutpoints[expr.id], "const"
            return expr.id, "unknown-const"
        if isinstance(expr, ast.Call):
            leaf = astutil.call_name(expr.func).rsplit(".", 1)[-1]
            if leaf in cats.helpers:
                return leaf, "helper"
            return None, None
        if isinstance(expr, ast.IfExp):
            v, k = self._resolve_point(module, expr.body, cats, depth + 1)
            if k is not None:
                return v, k
            return self._resolve_point(module, expr.orelse, cats,
                                       depth + 1)
        if isinstance(expr, ast.Name):
            func = astutil.enclosing_function(expr)
            if func is not None:
                for sub in ast.walk(func):
                    if isinstance(sub, ast.Assign) \
                            and len(sub.targets) == 1 \
                            and isinstance(sub.targets[0], ast.Name) \
                            and sub.targets[0].id == expr.id:
                        return self._resolve_point(module, sub.value,
                                                   cats, depth + 1)
        return None, None

    # -- metrics / events -------------------------------------------------- #

    def _metric_site(self, module, node, kind, cats, used_metrics
                     ) -> Iterator[Finding]:
        if not node.args or not isinstance(node.args[0], ast.Constant) \
                or not isinstance(node.args[0].value, str):
            return
        name = node.args[0].value
        used_metrics.add(name)
        sym = f"metric:{module.modname}:{name}"
        if not NAME_RE.match(name):
            yield self.finding(
                module, node,
                f"metric name {name!r} violates ^[a-z][a-z0-9_]*$",
                symbol=sym)
        if cats.catalog_mod is not None and name not in cats.metric_names:
            yield self.finding(
                module, node,
                f"metric {name!r} is not in monitor/catalog.py "
                f"METRIC_NAMES",
                symbol=sym)
        if kind == "counter" and not name.endswith("_total"):
            yield self.finding(
                module, node,
                f"counter {name!r} must end in _total",
                symbol=sym)
        unit = next((kw.value.value for kw in node.keywords
                     if kw.arg == "unit"
                     and isinstance(kw.value, ast.Constant)), "")
        is_secs_hist = kind == "histogram" and unit == "s"
        if name.endswith("_seconds") != is_secs_hist:
            why = ("ends in _seconds but is not a histogram with "
                   "unit='s'" if name.endswith("_seconds")
                   else "is a histogram with unit='s' but does not end "
                   "in _seconds")
            yield self.finding(module, node,
                               f"metric {name!r} {why}", symbol=sym)

    def _event_site(self, module, node, cats, used_events
                    ) -> Iterator[Finding]:
        kind = node.args[0].value
        used_events.add(kind)
        sym = f"event:{module.modname}:{kind}"
        if not NAME_RE.match(kind):
            yield self.finding(
                module, node,
                f"event kind {kind!r} violates ^[a-z][a-z0-9_]*$",
                symbol=sym)
        if cats.catalog_mod is not None and kind not in cats.event_kinds:
            yield self.finding(
                module, node,
                f"event kind {kind!r} is not in monitor/catalog.py "
                f"EVENT_KINDS",
                symbol=sym)

    # -- catalog-side rules ------------------------------------------------ #

    def _catalog_side(self, project, cats, used_points, used_metrics,
                      used_events) -> Iterator[Finding]:
        tests_text = "\n".join(
            text for p, text in project.root_files("tests")
            if os.path.basename(p).startswith(TESTS_PREFIX))
        readme = readme_port_section(
            project.read_root_file("README.md") or "")

        def referenced(value: str, text: str) -> bool:
            return f'"{value}"' in text or f"'{value}'" in text

        cp_mod = cats.cutpoints_mod
        if cp_mod is not None:
            for const, value in sorted(cats.cutpoints.items()):
                node = cats.cut_nodes[const]
                sym = f"cutpoint:{const}"
                if not CUT_RE.match(value):
                    yield self.finding(
                        cp_mod, node,
                        f"cut-point {value!r} violates the "
                        f"subsystem.site naming convention", symbol=sym)
                if value not in used_points:
                    yield self.finding(
                        cp_mod, node,
                        f"catalog cut-point {const} = {value!r} is not "
                        f"used by any inject()/torn_fraction() site",
                        symbol=sym)
                if tests_text and not referenced(value, tests_text):
                    yield self.finding(
                        cp_mod, node,
                        f"cut-point {value!r} is not referenced by any "
                        f"port test (tests/{TESTS_PREFIX}*.py)",
                        symbol=sym)
                if readme and value not in readme:
                    yield self.finding(
                        cp_mod, node,
                        f"cut-point {value!r} is missing from the README's "
                        f"port section", symbol=sym)

        cat_mod = cats.catalog_mod

        def entry(name: str):
            """Where a catalog-side finding about ``name`` points: the
            module (line 1, as the reference reports it), or the entry's
            own line when that line carries this rule's escape — so a
            name the port keeps for parity but never produces can be
            waived on its own line, not the whole catalog's."""
            node = cats.name_nodes.get(name)
            if node is not None and self.suppress_token in \
                    cat_mod.line_tokens(node.lineno):
                return node
            return None

        if cat_mod is not None:
            for name in sorted(cats.metric_names):
                sym = f"metric:{name}"
                if name not in used_metrics:
                    yield self.finding(
                        cat_mod, entry(name),
                        f"catalog metric {name!r} is never created by "
                        f"any counter()/gauge()/histogram() site",
                        symbol=sym)
                elif tests_text and not referenced(name, tests_text):
                    yield self.finding(
                        cat_mod, entry(name),
                        f"metric {name!r} is not referenced by any test",
                        symbol=sym, severity="warning")
            for kind in sorted(cats.event_kinds):
                sym = f"event:{kind}"
                if kind not in used_events:
                    yield self.finding(
                        cat_mod, entry(kind),
                        f"catalog event kind {kind!r} is never emitted "
                        f"with a literal kind", symbol=sym)
                elif tests_text and not referenced(kind, tests_text):
                    yield self.finding(
                        cat_mod, entry(kind),
                        f"event kind {kind!r} is not referenced by any "
                        f"test", symbol=sym, severity="warning")


__all__ = ["ConsistencyChecker"]
