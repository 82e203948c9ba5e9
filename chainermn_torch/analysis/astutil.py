"""Shared AST machinery for the graftlint checkers.

The two lock checkers (and, to a lesser degree, the hot-path checker)
need the same structural facts about a class: which attributes hold
``threading`` primitives, which statements execute under ``with
self._lock``, which methods acquire the lock (directly or through
intra-class calls), and — for the cross-class acquisition-order graph —
what *type* an expression like ``self._events`` or ``self.replicas[i]``
evaluates to. This module computes those facts once per class into a
:class:`ClassModel`; inference is deliberately under-approximate (an
expression whose type cannot be pinned creates no edge and no finding)
because a linter that cries wolf gets deleted.
"""

from __future__ import annotations

import ast
import re
from typing import Optional

# make_lock / make_rlock are analysis.sanitizer's instrumented
# constructors — production code swapping threading.Lock() for them must
# keep full static lock coverage, so they count as lock factories here
LOCK_FACTORIES = {"Lock", "RLock", "Condition", "make_lock", "make_rlock"}
EVENT_FACTORIES = {"Event", "Semaphore", "BoundedSemaphore", "Barrier"}

# compiled-program attribute naming convention (ServingEngine._decode_fn,
# _prefill_fns, _insert_fn, ...): results of calling these are device
# values until fetched
COMPILED_ATTR_RE = re.compile(r"^_\w*fns?$")


def call_name(node: ast.AST) -> str:
    """Dotted name of a call target / attribute chain, '' if dynamic."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


def is_self_attr(node: ast.AST) -> Optional[str]:
    """``self.X`` → ``"X"``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _threading_factory(call: ast.AST, names: set) -> bool:
    if not isinstance(call, ast.Call):
        return False
    dotted = call_name(call.func)
    if not dotted:
        return False
    leaf = dotted.rsplit(".", 1)[-1]
    return leaf in names


class ClassModel:
    """Structural facts about one class definition."""

    def __init__(self, module, node: ast.ClassDef) -> None:
        self.module = module
        self.node = node
        self.name = node.name
        self.methods: dict = {}
        self.properties: set = set()
        self.lock_attrs: set = set()
        self.event_attrs: set = set()
        self.reentrant: set = set()   # lock attrs built with RLock()
        self.attr_types: dict = {}    # attr -> (classname, is_list)
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.methods[item.name] = item
                for dec in item.decorator_list:
                    if (isinstance(dec, ast.Name)
                            and dec.id in ("property", "cached_property")):
                        self.properties.add(item.name)
        for meth in self.methods.values():
            for sub in ast.walk(meth):
                if not isinstance(sub, ast.Assign):
                    continue
                for tgt in sub.targets:
                    attr = is_self_attr(tgt)
                    if attr is None:
                        continue
                    if _threading_factory(sub.value, LOCK_FACTORIES):
                        self.lock_attrs.add(attr)
                        factory = call_name(sub.value.func)
                        if factory.endswith("RLock") \
                                or factory.endswith("make_rlock"):
                            self.reentrant.add(attr)
                    elif _threading_factory(sub.value, EVENT_FACTORIES):
                        self.event_attrs.add(attr)
        self._locking_methods: Optional[set] = None

    # -- lock scope ------------------------------------------------------ #

    def is_own_lock_expr(self, expr: ast.AST) -> bool:
        attr = is_self_attr(expr)
        return attr is not None and attr in self.lock_attrs

    def under_own_lock(self, node: ast.AST) -> bool:
        """True when ``node`` sits inside ``with self.<lock>:`` (any of
        the class's locks), following parent links up to the method."""
        cur = getattr(node, "graft_parent", None)
        while cur is not None and not isinstance(cur, ast.ClassDef):
            if isinstance(cur, (ast.With, ast.AsyncWith)):
                for item in cur.items:
                    if self.is_own_lock_expr(item.context_expr):
                        return True
            cur = getattr(cur, "graft_parent", None)
        return False

    def method_locks_directly(self, meth: ast.AST) -> bool:
        for sub in ast.walk(meth):
            if isinstance(sub, (ast.With, ast.AsyncWith)):
                for item in sub.items:
                    if self.is_own_lock_expr(item.context_expr):
                        return True
            # explicit self._lock.acquire() counts too
            if isinstance(sub, ast.Call):
                func = sub.func
                if (isinstance(func, ast.Attribute)
                        and func.attr == "acquire"
                        and self.is_own_lock_expr(func.value)):
                    return True
        return False

    @property
    def locking_methods(self) -> set:
        """Methods that acquire an own lock — directly, or transitively
        through an intra-class ``self._m()`` call chain."""
        if self._locking_methods is not None:
            return self._locking_methods
        locking = {name for name, meth in self.methods.items()
                   if self.method_locks_directly(meth)}
        changed = True
        while changed:
            changed = False
            for name, meth in self.methods.items():
                if name in locking:
                    continue
                for sub in ast.walk(meth):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = is_self_attr(sub.func)
                    if callee in locking:
                        locking.add(name)
                        changed = True
                        break
        self._locking_methods = locking
        return locking

    @property
    def locking_properties(self) -> set:
        return {p for p in self.properties if p in self.locking_methods}


def iter_classes(module) -> list:
    """Top-level :class:`ClassModel` list for one module."""
    return [ClassModel(module, node) for node in module.tree.body
            if isinstance(node, ast.ClassDef)]


def enclosing_function(node: ast.AST) -> Optional[ast.AST]:
    cur = getattr(node, "graft_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return cur
        cur = getattr(cur, "graft_parent", None)
    return None


def enclosing_class(node: ast.AST) -> Optional[ast.ClassDef]:
    cur = getattr(node, "graft_parent", None)
    while cur is not None:
        if isinstance(cur, ast.ClassDef):
            return cur
        cur = getattr(cur, "graft_parent", None)
    return None


def func_qualname(func: ast.AST) -> str:
    cls = enclosing_class(func)
    return f"{cls.name}.{func.name}" if cls is not None else func.name


# ---------------------------------------------------------------------- #
# project-wide type inference (the lock-order graph's legs)               #
# ---------------------------------------------------------------------- #


class TypeWorld:
    """Name → class resolution across the project.

    Three layers, each deliberately shallow:

    - every top-level class in every analyzed module, by simple name;
    - *factory* functions — module-level defs whose return expression is
      ``KnownClass(...)`` or a module global assigned ``KnownClass(...)``
      (this resolves ``get_event_log()`` → ``EventLog`` without
      importing anything);
    - per-class attribute types from ``__init__`` assignment shapes:
      ``self.x = C(...)``, ``self.x = factory()``, ``self.x = a or
      C(...)``, and ``self.x = [C(...) ...]`` (list / comprehension →
      element type).
    """

    def __init__(self, class_models: list) -> None:
        self.classes: dict = {}
        for cm in class_models:
            self.classes.setdefault(cm.name, cm)
        self.factories: dict = {}

    def learn_factories(self, module) -> None:
        globals_types: dict = {}
        for node in module.tree.body:
            if isinstance(node, ast.Assign) and isinstance(node.value,
                                                           ast.Call):
                cls = self._class_of_call(node.value)
                if cls is not None:
                    for tgt in node.targets:
                        if isinstance(tgt, ast.Name):
                            globals_types[tgt.id] = cls
        for node in module.tree.body:
            if not isinstance(node, ast.FunctionDef):
                continue
            for sub in ast.walk(node):
                if not isinstance(sub, ast.Return) or sub.value is None:
                    continue
                cls = self._class_of_call(sub.value)
                if cls is None and isinstance(sub.value, ast.Name):
                    cls = globals_types.get(sub.value.id)
                if cls is not None:
                    self.factories[node.name] = cls
                    break

    def _class_of_call(self, expr: ast.AST) -> Optional[str]:
        if not isinstance(expr, ast.Call):
            return None
        dotted = call_name(expr.func)
        leaf = dotted.rsplit(".", 1)[-1] if dotted else ""
        if leaf in self.classes:
            return leaf
        if leaf in self.factories:
            return self.factories[leaf]
        return None

    def infer_value(self, expr: ast.AST) -> Optional[tuple]:
        """``(classname, is_list)`` for an rvalue expression, or None."""
        cls = self._class_of_call(expr)
        if cls is not None:
            return (cls, False)
        if isinstance(expr, ast.BoolOp):
            for v in expr.values:
                got = self.infer_value(v)
                if got is not None:
                    return got
        if isinstance(expr, ast.ListComp):
            got = self._class_of_call(expr.elt)
            if got is not None:
                return (got, True)
        if isinstance(expr, ast.List) and expr.elts:
            got = self._class_of_call(expr.elts[0])
            if got is not None:
                return (got, True)
        return None

    def learn_attr_types(self, cm: ClassModel) -> None:
        init = cm.methods.get("__init__")
        if init is None:
            return
        for sub in ast.walk(init):
            if not isinstance(sub, ast.Assign):
                continue
            for tgt in sub.targets:
                attr = is_self_attr(tgt)
                if attr is None or attr in cm.attr_types:
                    continue
                got = self.infer_value(sub.value)
                if got is not None:
                    cm.attr_types[attr] = got

    # -- expression typing inside one method ----------------------------- #

    def local_types(self, cm: ClassModel, meth: ast.AST) -> dict:
        """name → (classname, is_list) for simple local bindings."""
        out: dict = {}
        for sub in ast.walk(meth):
            if isinstance(sub, ast.Assign) and len(sub.targets) == 1 \
                    and isinstance(sub.targets[0], ast.Name):
                got = (self.infer_value(sub.value)
                       or self._type_of_ref(cm, out, sub.value))
                if got is not None:
                    out[sub.targets[0].id] = got
            elif isinstance(sub, ast.For) and isinstance(sub.target,
                                                         ast.Name):
                got = self._type_of_ref(cm, out, sub.iter)
                if got is not None and got[1]:
                    out[sub.target.id] = (got[0], False)
        return out

    def _type_of_ref(self, cm: ClassModel, locals_: dict,
                     expr: ast.AST) -> Optional[tuple]:
        attr = is_self_attr(expr)
        if attr is not None:
            return cm.attr_types.get(attr)
        if isinstance(expr, ast.Name):
            return locals_.get(expr.id)
        if isinstance(expr, ast.Subscript):
            base = self._type_of_ref(cm, locals_, expr.value)
            if base is not None and base[1]:
                return (base[0], False)
        return None

    def receiver_class(self, cm: ClassModel, locals_: dict,
                       expr: ast.AST) -> Optional[str]:
        """Class of the receiver in ``receiver.method(...)``."""
        got = self._type_of_ref(cm, locals_, expr)
        if got is not None and not got[1]:
            return got[0]
        # direct factory call receiver: get_event_log().emit(...)
        cls = self._class_of_call(expr)
        if cls is not None:
            return cls
        return None


__all__ = [
    "COMPILED_ATTR_RE",
    "ClassModel",
    "TypeWorld",
    "call_name",
    "enclosing_class",
    "enclosing_function",
    "func_qualname",
    "is_self_attr",
    "iter_classes",
]
