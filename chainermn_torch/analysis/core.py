"""graftlint's shared visitor framework.

One :class:`Project` holds every parsed module (path, dotted name, AST
with parent links, raw source lines); checkers are small classes with a
``rule`` id, a ``suppress_token`` (the escape-hatch comment), and a
``check(project)`` generator of :class:`Finding`. The driver
(:func:`run_analysis`) parses each file once, runs every checker, then
applies the two suppression layers:

- **inline escapes** — ``# graftlint: <token>`` on the finding's line (or
  the line directly above, for long statements) waives that one finding;
  tokens are per-rule (``unguarded-ok``, ``lock-order-ok``,
  ``hot-sync-ok``, ``recompile-ok``, ``import-ok``, ``name-ok``);
- **baseline file** — a JSON list of finding *fingerprints* (stable
  hashes of rule + path + symbol, independent of line numbers) accepted
  at some point in the past. The merged tree keeps an empty baseline; the
  mechanism exists so a future sweep that lands a new checker can ratchet
  instead of big-banging.

Everything here is stdlib-only (``ast``, ``json``, ``hashlib``) — the
analyzer never imports the code it analyzes, so it runs identically on a
torch-less host and inside the tier-1 suite.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Iterable, Iterator, Optional

_SUPPRESS_RE = re.compile(r"#\s*graftlint:\s*([\w,\- ]+)")

# comment marker that adds a function to the host-sync hot set without
# editing the checker's built-in list (also what fixtures use)
HOT_MARK = "hot"


@dataclass
class Finding:
    """One rule violation at ``path:line``.

    ``symbol`` is the stable anchor (``Class.attr@method``,
    ``module->forbidden`` ...) the fingerprint hashes — findings survive
    unrelated edits shifting line numbers. ``severity`` is ``"error"``
    (gates the exit code) or ``"warning"`` (reported, never gates).
    """

    rule: str
    path: str
    line: int
    message: str
    symbol: str = ""
    severity: str = "error"
    col: int = 0

    @property
    def fingerprint(self) -> str:
        basis = f"{self.rule}|{self.path}|{self.symbol or self.message}"
        return hashlib.sha1(basis.encode()).hexdigest()[:16]

    def render(self) -> str:
        sev = "" if self.severity == "error" else f" [{self.severity}]"
        return f"{self.path}:{self.line}: {self.rule}{sev}: {self.message}"

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "path": self.path, "line": self.line,
            "col": self.col, "severity": self.severity,
            "message": self.message, "symbol": self.symbol,
            "fingerprint": self.fingerprint,
        }


class Module:
    """One parsed source file: AST (with ``.graft_parent`` links), dotted
    module name, and raw lines (for escape-comment lookup)."""

    def __init__(self, abspath: str, relpath: str, modname: str,
                 source: str) -> None:
        self.abspath = abspath
        self.path = relpath
        self.modname = modname
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=relpath)
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                child.graft_parent = parent  # type: ignore[attr-defined]

    def line_tokens(self, lineno: int) -> set:
        """graftlint escape tokens on ``lineno`` or the line above it."""
        out: set = set()
        for ln in (lineno, lineno - 1):
            if 1 <= ln <= len(self.lines):
                m = _SUPPRESS_RE.search(self.lines[ln - 1])
                if m:
                    out.update(t.strip() for t in m.group(1).split(",")
                               if t.strip())
        return out


class Project:
    """Every module under the analyzed roots, plus the repo root (the
    directory holding the top-level package) so checkers can reach
    sibling surfaces: ``tests/`` for the referenced-by-a-test rule,
    ``README.md`` for doc drift."""

    def __init__(self, modules: list, root: Optional[str] = None) -> None:
        self.modules = modules
        self.root = root
        self._by_name = {m.modname: m for m in modules}

    def module(self, modname: str) -> Optional[Module]:
        return self._by_name.get(modname)

    def modules_under(self, prefix: str) -> list:
        return [m for m in self.modules
                if m.modname == prefix
                or m.modname.startswith(prefix + ".")]

    def read_root_file(self, *relparts: str) -> Optional[str]:
        if self.root is None:
            return None
        p = os.path.join(self.root, *relparts)
        try:
            with open(p, encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None

    def root_files(self, reldir: str, suffix: str = ".py") -> list:
        """(relpath, text) pairs under ``root/reldir`` — the tests scan."""
        if self.root is None:
            return []
        base = os.path.join(self.root, reldir)
        out = []
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if not fn.endswith(suffix):
                    continue
                p = os.path.join(dirpath, fn)
                try:
                    with open(p, encoding="utf-8") as f:
                        out.append((os.path.relpath(p, self.root),
                                    f.read()))
                except OSError:
                    continue
        return out


class Checker:
    """Base class: subclasses set ``rule``/``suppress_token`` and
    implement ``check(project) -> iterator of Finding``."""

    rule = "base"
    suppress_token = "ok"

    def check(self, project: Project) -> Iterator[Finding]:  # pragma: no cover
        raise NotImplementedError

    def finding(self, module: Module, node, message: str, symbol: str = "",
                severity: str = "error") -> Finding:
        return Finding(rule=self.rule, path=module.path,
                       line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0),
                       message=message, symbol=symbol, severity=severity)


@dataclass
class AnalysisResult:
    findings: list = field(default_factory=list)      # active (not waived)
    suppressed: list = field(default_factory=list)    # inline-escaped
    baselined: list = field(default_factory=list)     # in the baseline file
    parse_errors: list = field(default_factory=list)  # Finding objects

    @property
    def errors(self) -> list:
        return [f for f in self.findings if f.severity == "error"]

    @property
    def warnings(self) -> list:
        return [f for f in self.findings if f.severity == "warning"]

    def counts_by_rule(self) -> dict:
        out: dict = {}
        for f in self.findings:
            out[f.rule] = out.get(f.rule, 0) + 1
        return out

    def to_json(self) -> dict:
        return {
            "findings": [f.to_json() for f in self.findings],
            "counts": {
                "active": len(self.findings),
                "errors": len(self.errors),
                "warnings": len(self.warnings),
                "suppressed": len(self.suppressed),
                "baselined": len(self.baselined),
                "parse_errors": len(self.parse_errors),
                "by_rule": self.counts_by_rule(),
            },
        }


def _iter_py_files(paths: Iterable[str]) -> Iterator[str]:
    for p in paths:
        if os.path.isfile(p):
            if p.endswith(".py"):
                yield p
        else:
            for dirpath, dirnames, filenames in os.walk(p):
                dirnames[:] = sorted(d for d in dirnames
                                     if d != "__pycache__"
                                     and not d.startswith("."))
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        yield os.path.join(dirpath, fn)


def _split_root(abspath: str) -> tuple:
    """(repo_root, relpath, modname) for one file, anchored at the
    outermost directory that is a package (has ``__init__.py``) — for
    this tree that is ``chainermn_torch``, making ``root`` the repo dir."""
    d = os.path.dirname(abspath)
    pkg_dirs = []
    while os.path.isfile(os.path.join(d, "__init__.py")):
        pkg_dirs.append(os.path.basename(d))
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    root = d
    relpath = os.path.relpath(abspath, root)
    parts = list(reversed(pkg_dirs))
    base = os.path.splitext(os.path.basename(abspath))[0]
    if base != "__init__":
        parts.append(base)
    modname = ".".join(parts) if parts else base
    return root, relpath, modname


def load_project(paths: Iterable[str]) -> tuple:
    """Parse every ``.py`` under ``paths`` → (Project, parse_error
    Findings)."""
    modules: list = []
    errors: list = []
    root: Optional[str] = None
    for abspath in _iter_py_files(paths):
        abspath = os.path.abspath(abspath)
        file_root, relpath, modname = _split_root(abspath)
        if root is None:
            root = file_root
        try:
            with open(abspath, encoding="utf-8") as f:
                source = f.read()
            modules.append(Module(abspath, relpath, modname, source))
        except (OSError, SyntaxError, ValueError) as e:
            errors.append(Finding(
                rule="parse-error", path=relpath, line=1,
                message=f"{type(e).__name__}: {e}", symbol=relpath))
    return Project(modules, root=root), errors


def load_baseline(path: Optional[str]) -> set:
    if not path or not os.path.isfile(path):
        return set()
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if isinstance(data, dict):
        data = data.get("fingerprints", [])
    return set(data)


def write_baseline(path: str, result: AnalysisResult) -> None:
    fps = sorted({f.fingerprint for f in result.findings}
                 | {f.fingerprint for f in result.baselined})
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"fingerprints": fps}, f, indent=2)
        f.write("\n")


def run_analysis(paths: Iterable[str], checkers: Iterable[Checker],
                 baseline: Optional[set] = None) -> AnalysisResult:
    """Parse, run every checker, apply inline escapes + baseline."""
    project, parse_errors = load_project(paths)
    return run_on_project(project, checkers, baseline=baseline,
                          parse_errors=parse_errors)


def run_on_project(project: Project, checkers: Iterable[Checker],
                   baseline: Optional[set] = None,
                   parse_errors: Optional[list] = None) -> AnalysisResult:
    baseline = baseline or set()
    result = AnalysisResult(parse_errors=list(parse_errors or []))
    by_path = {m.path: m for m in project.modules}
    for checker in checkers:
        for f in checker.check(project):
            mod = by_path.get(f.path)
            tokens = mod.line_tokens(f.line) if mod is not None else set()
            if checker.suppress_token in tokens or "all-ok" in tokens:
                result.suppressed.append(f)
            elif f.fingerprint in baseline:
                result.baselined.append(f)
            else:
                result.findings.append(f)
    result.findings.sort(key=lambda f: (f.path, f.line, f.rule))
    # parse errors always gate — a file the analyzer cannot read is a
    # file whose invariants nobody is checking
    result.findings.extend(result.parse_errors)
    return result


def analyze_source(source: str, checker: Checker, *,
                   path: str = "snippet.py",
                   modname: str = "snippet",
                   extra_modules: Optional[dict] = None,
                   root: Optional[str] = None) -> list:
    """Fixture-test entry point: run ONE checker over literal source
    (plus optional ``{modname: source}`` companions), inline escapes
    applied, no baseline. Returns the active findings."""
    modules = [Module(path, path, modname, source)]
    for name, src in (extra_modules or {}).items():
        modules.append(Module(name, name.replace(".", "/") + ".py",
                              name, src))
    project = Project(modules, root=root)
    return run_on_project(project, [checker]).findings


__all__ = [
    "AnalysisResult",
    "Checker",
    "Finding",
    "HOT_MARK",
    "Module",
    "Project",
    "analyze_source",
    "load_baseline",
    "load_project",
    "run_analysis",
    "run_on_project",
    "write_baseline",
]
