"""Runtime concurrency sanitizer (the port's copy of
``chainermn_tpu/analysis/sanitizer.py``; stdlib only).

- :func:`make_lock` / :func:`make_rlock`: plain ``threading`` locks while
  the sanitizer is off (the default); while it is on (:func:`enable`, or
  the ``CHAINERMN_TORCH_SANITIZER`` environment variable) instrumented
  :class:`SanLock` / :class:`SanRLock`, which keep a per-thread stack of
  held locks and record every observed order edge ``held -> acquired``.
  A cycle (an ABBA deadlock waiting to happen), a nested acquisition
  under a leaf lock, or (with a static graph given) an edge outside that
  graph raises :class:`LockOrderViolation` before the thread blocks.
- :func:`guarded`: a container proxy whose mutators demand the owning
  lock, else :class:`GuardViolation`; reads stay free.
- :func:`mutation_guard`: the single-writer check for lock-free classes.
- :func:`fuzz` and :func:`sync_point`: a seeded interleaving fuzzer that
  sleeps at named points, deterministic per thread name.
- :func:`hold_stats` / :func:`contention_counts`: lock hold times and
  contended acquisitions (the ``lock_hold_seconds`` histogram and the
  ``lock_contended`` event, written lazily through the monitor).

:func:`dump_artifact` writes the observed graph only to a path given to
it or named by ``CHAINERMN_TORCH_SANITIZER_ARTIFACT``; nothing in the
port writes one by default. ``python -m chainermn_torch.analysis
--runtime-report FILE chainermn_torch/`` then asserts that every
observed edge is in the static lock-order graph
(:func:`chainermn_torch.analysis.checkers.locks.static_lock_graph`).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import traceback
from typing import Iterable, Optional

ENV_FLAG = "CHAINERMN_TORCH_SANITIZER"
ARTIFACT_ENV = "CHAINERMN_TORCH_SANITIZER_ARTIFACT"


class _Violation(RuntimeError):
    """A violation is recorded when it is raised, so that one raised in a
    thread whose supervisor catches it (a fleet replica's) still counts
    (:func:`violations`)."""

    def __init__(self, *args) -> None:
        super().__init__(*args)
        # list.append is atomic; no lock (a violation may be raised with
        # the graph lock held)
        _S.violations.append(f"{type(self).__name__}: {args[0]}"
                             if args else type(self).__name__)


class LockOrderViolation(_Violation):
    """Observed lock acquisition that can deadlock (cycle) or that the
    static lock-order graph did not predict."""


class GuardViolation(_Violation):
    """Guarded state mutated without its lock / by a second thread."""


# --------------------------------------------------------------------- #
# global state                                                           #
# --------------------------------------------------------------------- #


class _State:
    def __init__(self) -> None:
        self.depth = 0                 # enable() nesting count
        self.telemetry = True
        self.static_edges: Optional[set] = None   # {(clsA, clsB)}
        self.graph_lock = threading.Lock()        # plain: internal only
        # (held_name, acquired_name) -> {"count", "stack", "leaf"}
        self.edges: dict = {}
        self.succ: dict = {}           # non-leaf adjacency for cycles
        self.hold: dict = {}           # name -> [count, total_s, max_s]
        self.contended: dict = {}      # name -> count
        self.hist_cache: dict = {}     # name -> monitor Histogram
        self.fuzz: Optional["_Fuzz"] = None
        self.violations: list = []     # messages, in the order raised


_S = _State()
_TLS = threading.local()


def _held() -> list:
    got = getattr(_TLS, "held", None)
    if got is None:
        got = _TLS.held = []
    return got


def enabled() -> bool:
    return _S.depth > 0


def enable(*, static_graph: Optional[Iterable] = None,
           telemetry: bool = True) -> None:
    """Turn the sanitizer on (nestable). ``static_graph`` is a set of
    ``(holder_class, acquired_class)`` pairs — when given, an observed
    non-leaf cross-class edge outside it raises immediately."""
    _S.depth += 1
    _S.telemetry = telemetry
    if static_graph is not None:
        _S.static_edges = {tuple(e) for e in static_graph}


def disable() -> None:
    if _S.depth > 0:
        _S.depth -= 1
    if _S.depth == 0:
        _S.fuzz = None


def reset() -> None:
    """Forget the observed graph, stats, and static graph (not the
    enable depth) — test isolation."""
    with _S.graph_lock:
        _S.edges.clear()
        _S.succ.clear()
        _S.hold.clear()
        _S.contended.clear()
        _S.hist_cache.clear()
        _S.violations.clear()
    _S.static_edges = None


if os.environ.get(ENV_FLAG, "") not in ("", "0"):
    enable()


def _cls(name: str) -> str:
    return name.split(".", 1)[0]


def _stack(skip: int = 2) -> str:
    return "".join(traceback.format_stack(limit=24)[:-skip])


# --------------------------------------------------------------------- #
# telemetry (lazy monitor imports, recursion-guarded)                    #
# --------------------------------------------------------------------- #


def _record_hold(name: str, dt: float) -> None:
    with _S.graph_lock:
        slot = _S.hold.setdefault(name, [0, 0.0, 0.0])
        slot[0] += 1
        slot[1] += dt
        if dt > slot[2]:
            slot[2] = dt
    if not _S.telemetry or getattr(_TLS, "in_telemetry", False):
        return
    _TLS.in_telemetry = True
    try:
        # cache the instrument per lock name: the registry get-or-create
        # (its own lock + label-tuple build) is too hot for every release
        hist = _S.hist_cache.get(name)
        if hist is None:
            from chainermn_torch.monitor import get_registry
            hist = get_registry().histogram(
                "lock_hold_seconds", {"lock": name}, unit="s")
            _S.hist_cache[name] = hist
        hist.observe(dt)
    except Exception:
        pass
    finally:
        _TLS.in_telemetry = False


def _record_contended(name: str, waited_s: float) -> None:
    with _S.graph_lock:
        _S.contended[name] = _S.contended.get(name, 0) + 1
    if not _S.telemetry or getattr(_TLS, "in_telemetry", False):
        return
    _TLS.in_telemetry = True
    try:
        from chainermn_torch.monitor import get_event_log
        get_event_log().emit("lock_contended", lock=name,
                             waited_s=round(waited_s, 6))
    except Exception:
        pass
    finally:
        _TLS.in_telemetry = False


def violations() -> list:
    """Every violation raised since the last :func:`reset`, in order
    (each message starts with its class name)."""
    return list(_S.violations)


def hold_stats() -> dict:
    """name -> {count, total_s, max_s} for every sanitized lock."""
    with _S.graph_lock:
        return {name: {"count": c, "total_s": t, "max_s": m}
                for name, (c, t, m) in sorted(_S.hold.items())}


def contention_counts() -> dict:
    with _S.graph_lock:
        return dict(sorted(_S.contended.items()))


# --------------------------------------------------------------------- #
# the observed lock-order graph                                          #
# --------------------------------------------------------------------- #


def _reachable(src: str, dst: str) -> Optional[str]:
    """First hop of a path ``src ->* dst`` in the observed non-leaf
    graph (call with graph_lock held), or None."""
    stack_, seen = [(src, None)], set()
    while stack_:
        node, first = stack_.pop()
        if node == dst and first is not None:
            return first
        if node in seen:
            continue
        seen.add(node)
        for nxt in _S.succ.get(node, ()):
            stack_.append((nxt, first if first is not None else nxt))
    return None


def _note_edge(held_name: str, held_leaf: bool, acq_name: str,
               acq_leaf: bool) -> None:
    """Record (and police) the edge held -> acquired. Raises before the
    caller blocks on the inner lock, so a would-be deadlock surfaces as
    a stack-carrying exception instead of a hang."""
    if held_leaf:
        raise LockOrderViolation(
            f"acquiring {acq_name} while LEAF lock {held_name} is held — "
            f"leaf locks must be terminal (no nested acquisition)\n"
            f"--- acquisition stack ---\n{_stack(3)}")
    key = (held_name, acq_name)
    leaf_edge = acq_leaf
    with _S.graph_lock:
        known = _S.edges.get(key)
        if known is not None:
            known["count"] += 1
            return
        if not leaf_edge:
            hop = _reachable(acq_name, held_name)
            if hop is not None:
                other = _S.edges.get((acq_name, hop), {})
                raise LockOrderViolation(
                    f"lock-order cycle: acquiring {acq_name} while "
                    f"holding {held_name}, but {acq_name} -> "
                    f"{hop} ->* {held_name} was already observed "
                    f"(ABBA deadlock)\n"
                    f"--- this acquisition ({held_name} -> {acq_name}) "
                    f"---\n{_stack(3)}"
                    f"--- prior acquisition ({acq_name} -> {hop}) ---\n"
                    f"{other.get('stack') or '<no stack recorded>'}")
            a_cls, b_cls = _cls(held_name), _cls(acq_name)
            if (_S.static_edges is not None and a_cls != b_cls
                    and (a_cls, b_cls) not in _S.static_edges):
                raise LockOrderViolation(
                    f"observed lock-order edge {held_name} -> {acq_name} "
                    f"({a_cls} -> {b_cls}) is absent from the static "
                    f"lock-order graph — either a latent hazard or a "
                    f"receiver the static checker cannot type; extend "
                    f"the graph or restructure the call\n"
                    f"--- acquisition stack ---\n{_stack(3)}")
        _S.edges[key] = {"count": 1, "stack": _stack(3),
                         "leaf": leaf_edge}
        if not leaf_edge:
            _S.succ.setdefault(held_name, set()).add(acq_name)


def observed_edges(*, leaf: bool = True) -> dict:
    """(held, acquired) -> count. ``leaf=False`` drops edges into leaf
    locks (terminal by construction, excluded from the static check)."""
    with _S.graph_lock:
        return {k: v["count"] for k, v in _S.edges.items()
                if leaf or not v["leaf"]}


def observed_class_edges(*, leaf: bool = False) -> set:
    """Observed edges collapsed to ``(holder_class, acquired_class)``,
    self-edges dropped — the granularity of the static graph."""
    out = set()
    for (a, b) in observed_edges(leaf=leaf):
        ca, cb = _cls(a), _cls(b)
        if ca != cb:
            out.add((ca, cb))
    return out


# --------------------------------------------------------------------- #
# instrumented locks                                                     #
# --------------------------------------------------------------------- #


class _Held:
    __slots__ = ("lock", "name", "leaf", "depth", "t0")

    def __init__(self, lock, name, leaf, t0) -> None:
        self.lock, self.name, self.leaf = lock, name, leaf
        self.depth, self.t0 = 1, t0


class SanLock:
    """Instrumented non-reentrant lock. API-compatible with
    ``threading.Lock`` (acquire/release/locked/context manager)."""

    _reentrant = False

    def __init__(self, name: str, *, leaf: bool = False) -> None:
        self._name = name
        self._leaf = leaf
        self._inner = self._make_inner()

    @staticmethod
    def _make_inner():
        return threading.Lock()

    @property
    def name(self) -> str:
        return self._name

    def held_by_me(self) -> bool:
        return any(h.lock is self for h in _held())

    def locked(self) -> bool:
        return self._inner.locked()

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        # telemetry-context acquisitions (the registry lock taken while
        # recording another lock's hold time) are invisible: no edges,
        # no held-stack entry — release() tolerates the missing entry
        if not enabled() or getattr(_TLS, "in_telemetry", False):
            return self._inner.acquire(blocking, timeout)
        held = _held()
        for h in held:
            if h.lock is self:
                if self._reentrant:
                    got = self._inner.acquire(blocking, timeout)
                    if got:
                        h.depth += 1
                    return got
                raise LockOrderViolation(
                    f"{self._name}: non-reentrant lock re-acquired by "
                    f"the holding thread (self-deadlock; the outer "
                    f"acquisition is in this stack)\n"
                    f"--- acquisition stack ---\n{_stack()}")
        sync_point(f"lock:{self._name}")
        for h in held:
            if h.name != self._name:
                _note_edge(h.name, h.leaf, self._name, self._leaf)
        got = self._inner.acquire(False)
        if not got:
            if not blocking:
                return False
            t0 = time.perf_counter()
            got = self._inner.acquire(True, timeout)
            if not got:
                return False
            _record_contended(self._name, time.perf_counter() - t0)
        held.append(_Held(self, self._name, self._leaf,
                          time.perf_counter()))
        return True

    def release(self) -> None:
        held = _held()
        entry = None
        for h in reversed(held):
            if h.lock is self:
                entry = h
                break
        dt = None
        if entry is not None:
            entry.depth -= 1
            if entry.depth == 0:
                held.remove(entry)
                if enabled() and not self._leaf:
                    dt = time.perf_counter() - entry.t0
        # physical release FIRST: hold telemetry re-enters the registry,
        # and recording while still holding the registry's own lock
        # would self-deadlock
        self._inner.release()
        if dt is not None:
            _record_hold(self._name, dt)

    def __enter__(self) -> "SanLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:
        kind = "SanRLock" if self._reentrant else "SanLock"
        return f"<{kind} {self._name} leaf={self._leaf}>"


class SanRLock(SanLock):
    """Instrumented reentrant lock (``threading.RLock`` semantics)."""

    _reentrant = True

    @staticmethod
    def _make_inner():
        return threading.RLock()


def make_lock(name: str, *, leaf: bool = False):
    """A lock for ``name`` (``"OwnerClass._attr"``): plain
    ``threading.Lock`` when the sanitizer is off, :class:`SanLock` when
    on. ``leaf=True`` marks terminal locks (metric instruments) that
    must never be held across another acquisition."""
    if not enabled():
        return threading.Lock()
    return SanLock(name, leaf=leaf)


def make_rlock(name: str):
    if not enabled():
        return threading.RLock()
    return SanRLock(name)


# --------------------------------------------------------------------- #
# guarded state                                                          #
# --------------------------------------------------------------------- #

_MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "pop", "popitem", "popleft", "remove", "reverse",
    "rotate", "setdefault", "sort", "update",
})


class _GuardedProxy:
    """Container proxy: mutators demand the owning lock be held by the
    calling thread; reads pass through untouched."""

    __slots__ = ("_obj", "_lock", "_name")

    def __init__(self, obj, lock, name) -> None:
        object.__setattr__(self, "_obj", obj)
        object.__setattr__(self, "_lock", lock)
        object.__setattr__(self, "_name", name)

    def _check(self) -> None:
        if not enabled():
            return
        lock = self._lock
        if lock is None or not isinstance(lock, SanLock):
            return
        if lock.held_by_me():
            return
        raise GuardViolation(
            f"{self._name} mutated without holding {lock.name} — the "
            f"lock-discipline invariant, enforced at runtime\n"
            f"--- mutation stack ---\n{_stack()}")

    def __getattr__(self, attr):
        got = getattr(self._obj, attr)
        if attr in _MUTATORS:
            def checked(*a, _fn=got, **kw):
                self._check()
                sync_point(f"guarded:{self._name}")
                return _fn(*a, **kw)
            return checked
        return got

    def __setitem__(self, key, value) -> None:
        self._check()
        sync_point(f"guarded:{self._name}")
        self._obj[key] = value

    def __delitem__(self, key) -> None:
        self._check()
        del self._obj[key]

    def __getitem__(self, key):
        return self._obj[key]

    def __contains__(self, key) -> bool:
        return key in self._obj

    def __iter__(self):
        return iter(self._obj)

    def __len__(self) -> int:
        return len(self._obj)

    def __bool__(self) -> bool:
        return bool(self._obj)

    def __eq__(self, other) -> bool:
        return self._obj == other

    def __ne__(self, other) -> bool:
        return self._obj != other

    def __repr__(self) -> str:
        return f"<guarded {self._name} {self._obj!r}>"


def guarded(obj, *, lock=None, name: str):
    """Wrap a container so mutations require ``lock`` held by the
    calling thread. Off: returns ``obj`` unchanged (zero cost)."""
    if not enabled():
        return obj
    return _GuardedProxy(obj, lock, name)


class _NoopGuard:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_NOOP = _NoopGuard()


class MutationGuard:
    """Single-writer contract for lock-free classes (``BlockPool``):
    two threads observed inside a mutation window simultaneously raise
    :class:`GuardViolation`. The window doubles as a fuzzer sync point,
    so the interleaving fuzzer can stretch it deterministically."""

    __slots__ = ("_name", "_owner", "_depth")

    def __init__(self, name: str) -> None:
        self._name = name
        self._owner = None
        self._depth = 0

    def __enter__(self) -> "MutationGuard":
        if not enabled():
            return self
        me = threading.current_thread()
        cur = self._owner
        if cur is not None and cur is not me:
            raise GuardViolation(
                f"{self._name}: concurrent mutation — {me.name} entered "
                f"a mutator while {cur.name} is still inside one; this "
                f"class is single-writer by design (no lock)\n"
                f"--- second writer's stack ---\n{_stack()}")
        self._owner = me
        self._depth += 1
        sync_point(f"mutate:{self._name}")
        return self

    def __exit__(self, *exc) -> None:
        if self._depth > 0:
            self._depth -= 1
            if self._depth == 0:
                self._owner = None


def mutation_guard(name: str):
    """A :class:`MutationGuard` when the sanitizer is on, a shared
    no-op context manager when off."""
    if not enabled():
        return _NOOP
    return MutationGuard(name)


# --------------------------------------------------------------------- #
# seeded interleaving fuzzer                                             #
# --------------------------------------------------------------------- #


class _Fuzz:
    def __init__(self, seed, p, sleep_s, points) -> None:
        self.seed = seed
        self.p = p
        self.sleep_s = sleep_s
        self.points = tuple(points) if points else None
        self._tls = threading.local()

    def maybe_yield(self, tag: str) -> None:
        if self.points is not None \
                and not any(tag.startswith(p) for p in self.points):
            return
        rng = getattr(self._tls, "rng", None)
        if rng is None:
            ident = threading.current_thread().name
            rng = self._tls.rng = random.Random(f"{self.seed}:{ident}")
        if rng.random() < self.p:
            time.sleep(self.sleep_s)


class _FuzzCtx:
    def __init__(self, fz) -> None:
        self._fz = fz

    def __enter__(self):
        _S.fuzz = self._fz
        return self._fz

    def __exit__(self, *exc) -> None:
        _S.fuzz = None


def fuzz(seed, *, p: float = 0.5, sleep_s: float = 0.0005,
         points: Optional[Iterable] = None):
    """Context manager arming the interleaving fuzzer: at every sync
    point, each thread draws from its own ``Random(f"{seed}:{thread
    name}")`` stream and yields with probability ``p`` for ``sleep_s``
    — deterministic per thread regardless of scheduling. ``points``
    restricts to tags with the given prefixes (``"lock:"``,
    ``"guarded:"``, ``"mutate:"``, or explicit :func:`sync_point`
    tags)."""
    return _FuzzCtx(_Fuzz(seed, p, sleep_s, points))


def sync_point(tag: str) -> None:
    """A named interleaving point: no-op unless :func:`fuzz` is armed.
    Production call sites cost one global read when the sanitizer is
    enabled and nothing measurable when it is not."""
    fz = _S.fuzz
    if fz is not None:
        fz.maybe_yield(tag)


# --------------------------------------------------------------------- #
# artifacts (the --runtime-report input)                                 #
# --------------------------------------------------------------------- #


def dump_artifact(path: Optional[str] = None) -> Optional[str]:
    """Write (merge-union) the observed graph as JSON. Default path:
    ``$CHAINERMN_TORCH_SANITIZER_ARTIFACT``; returns the path written, or
    None when no path is configured."""
    path = path or os.environ.get(ARTIFACT_ENV) or None
    if not path:
        return None
    with _S.graph_lock:
        leaf = sorted(k for k, v in _S.edges.items() if v["leaf"])
        nonleaf = sorted(k for k, v in _S.edges.items()
                         if not v["leaf"])
    try:
        with open(path, encoding="utf-8") as f:
            prior = json.load(f)
        nonleaf = sorted({tuple(e) for e in prior.get("edges", ())}
                         | set(nonleaf))
        leaf = sorted({tuple(e) for e in prior.get("leaf_edges", ())}
                      | set(leaf))
    except (OSError, ValueError):
        pass
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"version": 1,
                   "edges": [list(e) for e in nonleaf],
                   "leaf_edges": [list(e) for e in leaf]}, f, indent=2)
        f.write("\n")
    return path


def load_artifact(path: str) -> dict:
    """Read a :func:`dump_artifact` file → {"edges": [(a, b)...],
    "leaf_edges": [(a, b)...]} as tuples."""
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    return {"edges": [tuple(e) for e in data.get("edges", ())],
            "leaf_edges": [tuple(e) for e in data.get("leaf_edges", ())]}


def artifact_class_edges(artifact: dict) -> set:
    """Non-leaf artifact edges collapsed to class pairs (self-edges
    dropped) — comparable against the static graph."""
    out = set()
    for (a, b) in artifact["edges"]:
        ca, cb = _cls(a), _cls(b)
        if ca != cb:
            out.add((ca, cb))
    return out


__all__ = [
    "ARTIFACT_ENV",
    "ENV_FLAG",
    "GuardViolation",
    "LockOrderViolation",
    "MutationGuard",
    "SanLock",
    "SanRLock",
    "artifact_class_edges",
    "contention_counts",
    "disable",
    "dump_artifact",
    "enable",
    "enabled",
    "fuzz",
    "guarded",
    "hold_stats",
    "load_artifact",
    "make_lock",
    "make_rlock",
    "mutation_guard",
    "observed_class_edges",
    "observed_edges",
    "reset",
    "sync_point",
    "violations",
]
