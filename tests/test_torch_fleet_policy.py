"""The fleet's host policy in the port against the JAX package's: the
same seeded inputs and event sequences, with an injected clock where
time matters, must give the reference's decisions. ``RoutingPolicy``
(route, migration targets, the edge gate), ``FleetTrie`` (note, lookup,
forget, drop, node eviction), ``SharePayloadCache`` (longest match, pins,
LRU), ``RetryBudget`` and ``TenantBreaker``, and the runtime sanitizer's
lock-order, guard and single-writer checks (ports of
``tests/fleet_tests/test_routing.py``, ``test_overload.py``,
``test_share.py``'s units and ``tests/analysis_tests``' sanitizer
cases). Host logic only: no engine, no device."""

import threading
import time

import numpy as np
import pytest
from _torch_isolation import fresh_telemetry

from chainermn_tpu.analysis import sanitizer as jax_sanitizer
from chainermn_tpu.fleet import overload as jax_overload
from chainermn_tpu.fleet import routing as jax_routing
from chainermn_tpu.fleet import share as jax_share
from chainermn_torch.analysis import sanitizer
from chainermn_torch.fleet import overload, routing, share

SEEDS = range(6)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    """Fresh registries for both packages: the JAX share cache and
    breaker report counts from the process-wide registry, which other
    test files in this worker write too."""
    fresh_telemetry(monkeypatch)


def _snaps(mod, rng):
    n = int(rng.integers(1, 6))
    return [mod.ReplicaSnapshot(
        replica_id=i, healthy=bool(rng.random() > 0.15),
        queue_depth=int(rng.integers(0, 4)),
        active_slots=int(rng.integers(0, 5)), n_slots=int(rng.choice([2, 4])),
        ttft_ewma_s=float(rng.choice([0.0, 0.1, 0.5])),
        kv_free_frac=float(rng.choice([0.0, 0.5, 1.0])),
        health=int(rng.choice([0, 0, 1, 2])),
        admission_weight=float(rng.choice([1.0, 1.0, 0.5])))
        for i in range(n)]


def _decision(d):
    return None if d is None else (d.replica_id, d.affinity_hit,
                                   d.affinity_blocks, d.reason)


@pytest.mark.parametrize("seed", SEEDS)
def test_routing_policy_decides_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(40):
        kw = dict(affinity=bool(rng.random() > 0.2),
                  max_imbalance=float(rng.choice([0.0, 0.5, 1.0])),
                  min_affinity_blocks=int(rng.integers(1, 3)))
        state = rng.bit_generator.state
        ours = _snaps(routing, rng)
        rng.bit_generator.state = state
        theirs = _snaps(jax_routing, rng)
        aff = (int(rng.integers(0, len(ours))) if rng.random() > 0.3
               else None)
        blocks = int(rng.integers(0, 4))
        got = routing.RoutingPolicy(**kw)
        want = jax_routing.RoutingPolicy(**kw)
        assert _decision(got.route(ours, aff, blocks)) == _decision(
            want.route(theirs, aff, blocks))
        assert [s.replica_id for s in got.migration_targets(ours)] == [
            s.replica_id for s in want.migration_targets(theirs)]
        bound = int(rng.integers(1, 8))
        assert got.overloaded(ours, bound) == want.overloaded(theirs, bound)


def _trie_ops(rng, n):
    ops = []
    for _ in range(n):
        toks = [int(t) for t in rng.integers(1, 4, int(rng.integers(1, 9)))]
        kind = rng.choice(["note", "note", "lookup", "forget", "drop"])
        ops.append((str(kind), toks, int(rng.integers(0, 3))))
    return ops


@pytest.mark.parametrize("seed", SEEDS)
def test_fleet_trie_tracks_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    ours, theirs = routing.FleetTrie(2, max_nodes=12), \
        jax_routing.FleetTrie(2, max_nodes=12)
    for kind, toks, rid in _trie_ops(rng, 80):
        if kind == "note":
            got, want = ours.note(toks, rid), theirs.note(toks, rid)
        elif kind == "lookup":
            got, want = ours.lookup(toks), theirs.lookup(toks)
        elif kind == "forget":
            got, want = ours.forget(toks, rid), theirs.forget(toks, rid)
        else:
            got, want = ours.drop_replica(rid), theirs.drop_replica(rid)
        assert got == want, (kind, toks, rid)
        assert ours.n_nodes == theirs.n_nodes


def _payload(tokens):
    return {"tokens": np.asarray(tokens, np.int32),
            "n_blocks": max(1, len(tokens) // 2), "block_size": 2,
            "kv_quant": "none", "n_layers": 1, "layers": [],
            "t_start": 0.0}


@pytest.mark.parametrize("seed", SEEDS)
def test_share_cache_serves_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    ours = share.SharePayloadCache(max_entries=3)
    theirs = jax_share.SharePayloadCache(max_entries=3)
    held = []
    for _ in range(60):
        toks = [int(t) for t in rng.integers(1, 3, int(rng.integers(2, 7)))]
        kind = rng.choice(["put", "match", "match", "release"])
        if kind == "put":
            held.append((ours.put(_payload(toks)),
                         theirs.put(_payload(toks))))
        elif kind == "match":
            got, want = ours.match(toks), theirs.match(toks)
            assert (got is None) == (want is None)
            if got is not None:
                assert got.tokens == want.tokens and got.pins == want.pins
                held.append((got, want))
        elif held:
            got, want = held.pop(int(rng.integers(0, len(held))))
            imported = bool(rng.random() > 0.5)
            ours.release(got, imported=imported)
            theirs.release(want, imported=imported)
        assert ours.to_json() == theirs.to_json()
        assert len(ours) == len(theirs)


@pytest.mark.parametrize("seed", SEEDS)
def test_retry_budget_allows_as_the_reference(seed):
    rng = np.random.default_rng(seed)
    kw = dict(rate_per_s=float(rng.choice([0.5, 1.0, 4.0])),
              burst=float(rng.choice([1.0, 2.0, 5.0])))
    ours, theirs = overload.RetryBudget(**kw), jax_overload.RetryBudget(**kw)
    now = 0.0
    for _ in range(60):
        now += float(rng.choice([0.0, 0.1, 0.7]))
        tenant = str(rng.choice(["a", "b"]))
        assert ours.allow(tenant, now=now) == theirs.allow(tenant, now=now)
    assert ours.to_json() == theirs.to_json()


@pytest.mark.parametrize("seed", SEEDS)
def test_tenant_breaker_trips_as_the_reference(seed, monkeypatch):
    rng = np.random.default_rng(seed)
    kw = dict(window_s=float(rng.choice([2.0, 5.0])),
              shed_threshold=float(rng.choice([0.3, 0.5])),
              min_samples=int(rng.integers(2, 5)),
              open_s=float(rng.choice([1.0, 2.0])))
    ours = overload.TenantBreaker(**kw)
    theirs = jax_overload.TenantBreaker(**kw)
    now = 0.0
    for _ in range(80):
        now += float(rng.choice([0.0, 0.25, 1.0]))
        tenant = str(rng.choice(["a", "b", "c"]))
        kind = rng.choice(["shed", "ok", "open?", "after", "force", "noisy"])
        if kind == "shed":
            ours.record_shed(tenant, now=now)
            theirs.record_shed(tenant, now=now)
        elif kind == "ok":
            ours.record_ok(tenant, now=now)
            theirs.record_ok(tenant, now=now)
        elif kind == "open?":
            assert ours.is_open(tenant, now=now) == theirs.is_open(
                tenant, now=now)
        elif kind == "after":
            assert ours.retry_after(tenant, now=now) == theirs.retry_after(
                tenant, now=now)
        elif kind == "force" and rng.random() > 0.7:
            ours.force_open(tenant, now=now)
            theirs.force_open(tenant, now=now)
        elif kind == "noisy":
            ours.note_noisy(tenant)
            theirs.note_noisy(tenant)
    # to_json reports each open breaker's time left against the clock it
    # reads then: one clock reading for both, or two readings straddling
    # a millisecond round apart
    clock = time.monotonic()
    monkeypatch.setattr(time, "monotonic", lambda: clock)
    assert ours.to_json() == theirs.to_json()


# --------------------------------------------------------------------- #
# the runtime sanitizer                                                  #
# --------------------------------------------------------------------- #


@pytest.fixture
def sanitized():
    """Both sanitizers on for one test, their graphs forgotten before and
    after (a suite run earlier in this worker may have left edges)."""
    for mod in (sanitizer, jax_sanitizer):
        mod.reset()
        mod.enable()
    yield
    for mod in (sanitizer, jax_sanitizer):
        mod.reset()
        mod.disable()


def _abba(mod):
    """Acquire A then B, then B then A: the second order closes a cycle.
    Returns the exception the second order raised (None when none)."""
    a = mod.make_lock("Alpha._lock")
    b = mod.make_lock("Beta._lock")
    with a:
        with b:
            pass
    try:
        with b:
            with a:
                pass
    except mod.LockOrderViolation as e:
        return e
    return None


def test_sanitizer_raises_on_a_lock_order_cycle(sanitized):
    """An ABBA order raises ``LockOrderViolation`` before the thread
    blocks, as the reference's does, and both record the same edges."""
    ours, theirs = _abba(sanitizer), _abba(jax_sanitizer)
    assert ours is not None and theirs is not None
    assert "ABBA" in str(ours) and "ABBA" in str(theirs)
    assert sanitizer.observed_edges() == jax_sanitizer.observed_edges()


def test_sanitizer_leaf_lock_must_be_terminal(sanitized):
    for mod in (sanitizer, jax_sanitizer):
        leaf = mod.make_lock("Leaf._lock", leaf=True)
        other = mod.make_lock("Other._lock")
        with pytest.raises(mod.LockOrderViolation, match="LEAF"):
            with leaf:
                with other:
                    pass


def test_sanitizer_guard_and_single_writer(sanitized):
    """A guarded container mutated without its lock raises
    ``GuardViolation``; two threads inside one mutation window raise."""
    lock = sanitizer.make_lock("Owner._lock")
    box = sanitizer.guarded([], lock=lock, name="Owner._items")
    with pytest.raises(sanitizer.GuardViolation):
        box.append(1)
    with lock:
        box.append(1)
    assert list(box) == [1]
    guard = sanitizer.mutation_guard("Pool.mutate")
    inside, release = threading.Event(), threading.Event()

    def writer():
        with guard:
            inside.set()
            release.wait(5)

    t = threading.Thread(target=writer, daemon=True)
    t.start()
    assert inside.wait(5)
    try:
        with pytest.raises(sanitizer.GuardViolation):
            with guard:
                pass
    finally:
        release.set()
        t.join(5)
    assert not t.is_alive()


def test_sanitizer_off_builds_plain_locks():
    assert not sanitizer.enabled()
    assert type(sanitizer.make_lock("X._lock")) is type(threading.Lock())
    box = []
    assert sanitizer.guarded(box, lock=None, name="X._box") is box
