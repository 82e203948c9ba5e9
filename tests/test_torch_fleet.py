"""The serving fleet on the port, held to JAX ``generate()`` token for
token on the same flax weights (ports of ``tests/fleet_tests/
test_fleet.py``, ``test_disagg.py``, ``test_share.py`` and
``test_rebalance.py``, less the controller-driven rebalance): replicas
behind one router serve interleaved traffic as solo ``generate()`` does;
killing a replica loses no accepted request; the edge sheds and routes
deterministically; the report pools the replicas' series; the
disaggregated tiers migrate every request's KV after its prefill (1P+1D
and 1P+2D); a prefix held by one replica is shared into another; a live
decode moves mid-stream; chaos at ``fleet.migrate``, ``fleet.share`` and
``fleet.rebalance`` decays to doing the work in place; and no surviving
replica rebuilds a step program. Every replica's engine runs on weights
of its own. Every wait has a timeout and every router is closed."""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_torch.fleet import FleetRouter, ReplicaState, RoutingPolicy
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.resilience import FaultInjector
from chainermn_torch.resilience.cutpoints import (
    FLEET_MIGRATE,
    FLEET_REBALANCE,
    FLEET_SHARE,
)
from chainermn_torch.serving import QueueFullError, RequestState, ServingEngine

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG1 = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=1, max_len=48)
CFG2 = dict(CFG1, n_layers=2)
PAGED = dict(n_slots=2, prefill_buckets=(4, 8, 16), prefill_batch=2,
             paged=True, kv_block_size=2, kv_blocks=64, cache_len=48)
PROMPT = np.asarray([1, 4, 2, 7, 3, 5, 6, 2, 9, 4, 1, 3], np.int32)
N_NEW = 6
WAIT = 60


def _jax(cfg):
    lm = JaxLM(**cfg, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params, params_from_flax(jax.device_get(params))


@pytest.fixture(scope="module")
def w1():
    return _jax(CFG1)


@pytest.fixture(scope="module")
def w2():
    return _jax(CFG2)


_SOLO: dict = {}


def solo(weights, prompt, n):
    """JAX ``generate()``'s greedy tokens after ``prompt`` (memoised: the
    same request is asked for by several tests)."""
    lm, params, _ = weights
    key = (id(weights), tuple(int(t) for t in prompt), n)
    if key not in _SOLO:
        out = np.asarray(jax_generate(lm, params,
                                      jnp.asarray([prompt], jnp.int32), n)[0])
        _SOLO[key] = [int(t) for t in out[len(prompt):]]
    return _SOLO[key]


def _model(weights, cfg):
    model = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(weights[2])
    return model


def dense_engine(weights, prefix=True):
    """``test_fleet.py``'s engine: dense, prefill_len 6, cache_len 32,
    with an 8-block prefix store of 2-token blocks."""
    kw = dict(prefix_cache_blocks=8, prefix_block_size=2) if prefix else {}
    return ServingEngine(_model(weights, CFG1), n_slots=2, prefill_len=6,
                         cache_len=32, paged=False, device="cpu", **kw)


def paged_engine(weights):
    return ServingEngine(_model(weights, CFG2), device="cpu", **PAGED)


def _counter(name):
    return sum(v for k, v in get_registry().snapshot()["counters"].items()
               if k.startswith(name))


def _no_recompiles(router):
    for r in router.replicas:
        if r.state is not ReplicaState.QUARANTINED:
            assert r.engine.recompiles == {}, (r.replica_id,
                                               r.engine.recompiles)
            assert set(r.engine.compile_counts_detailed().values()) == {1}


@pytest.fixture
def fleet():
    """Build routers through ``fleet(...)``; every one is closed after
    the test, whatever it did."""
    made = []

    def build(engines, **kw):
        router = FleetRouter(engines, **kw)
        made.append(router)
        if kw.get("autostart", True):
            assert router.wait_ready(WAIT)
        return router

    yield build
    for router in made:
        router.close(timeout=10)


# --------------------------------------------------------------------- #
# a symmetric fleet (test_fleet.py)                                      #
# --------------------------------------------------------------------- #


def test_two_replicas_interleaved_parity(w1, fleet):
    """Mixed prefix-heavy traffic through 2 replicas equals solo
    ``generate()`` request by request, both replicas take traffic, the
    affinity trie hits, and the streaming and blocking surfaces behave."""
    prompts = [[1, 2, 3], [4, 5], [1, 2, 3, 4], [6, 7, 8],
               [1, 2], [9, 10, 11], [1, 2, 3, 4, 5], [12, 13]]
    router = fleet([dense_engine(w1) for _ in range(2)])
    frs = [router.submit(np.array(p, np.int32), 5) for p in prompts]
    for fr, p in zip(frs, prompts):
        assert fr.wait(timeout=WAIT)
        assert fr.state is RequestState.DONE
        assert fr.tokens == solo(w1, p, 5)
    served = [r.metrics.requests_completed for r in router.replicas]
    assert all(s > 0 for s in served), served
    rep = router.fleet_report()
    assert rep["capacity"] == 2
    assert rep["affinity"]["enabled"] and rep["affinity"]["hits"] > 0
    toks = []
    fr = router.submit(np.array([1, 2, 3], np.int32), 5,
                       stream_cb=toks.append)
    got = list(fr.stream())
    assert got == toks == fr.tokens and len(got) == 5
    out = router.generate(np.array([4, 5], np.int32), 4, timeout=WAIT)
    assert [int(t) for t in out[2:]] == solo(w1, [4, 5], 4)
    _no_recompiles(router)


def test_kill_replica_mid_stream_loses_nothing(w1, fleet):
    """Kill the replica owning a mid-stream decode: its queued and
    in-flight work replays on the survivor with the same stream (each
    token delivered once), nothing is lost, the survivor rebuilds
    nothing; with both dead, a submission fails loudly."""
    router = fleet([dense_engine(w1, prefix=False) for _ in range(2)],
                   max_restarts=2)
    streams = {i: [] for i in range(6)}
    frs = [router.submit(np.array([1 + i, 2 + i], np.int32), 16,
                         stream_cb=streams[i].append) for i in range(6)]
    deadline = time.perf_counter() + WAIT
    victim = None
    while time.perf_counter() < deadline and victim is None:
        victim = next((fr for fr in frs if fr.replica_id == 0
                       and fr.tokens and not fr.finished), None)
        if victim is None:
            time.sleep(0.002)
    router.kill_replica(0)
    for i, fr in enumerate(frs):
        assert fr.wait(timeout=WAIT)
        assert fr.state is RequestState.DONE
        assert fr.tokens == solo(w1, [1 + i, 2 + i], 16)
        assert streams[i] == fr.tokens
    assert router.replicas[0].state is ReplicaState.QUARANTINED
    assert router.capacity == 1
    if victim is not None:
        assert router.fleet_report()["reroutes_total"] >= 1
    _no_recompiles(router)
    out = router.generate(np.array([9, 9], np.int32), 3, timeout=WAIT)
    assert [int(t) for t in out[2:]] == solo(w1, [9, 9], 3)
    router.kill_replica(1)
    deadline = time.perf_counter() + WAIT
    while router.capacity and time.perf_counter() < deadline:
        time.sleep(0.005)
    assert router.capacity == 0
    with pytest.raises(RuntimeError, match="no replica"):
        router.submit(np.array([1, 2], np.int32), 2)


def test_affinity_routing_and_edge_shed_deterministic(w1, fleet):
    """On a paused fleet the placements are exact: the lowest id first,
    a shared-prefix follower sticks (affinity), an unrelated prompt goes
    least-loaded, and the global ``max_queue`` sheds the overflow."""
    router = fleet([dense_engine(w1) for _ in range(2)], max_queue=3,
                   autostart=False)
    a = router.submit(np.array([1, 2, 3, 4, 5], np.int32), 2)
    assert a.replica_id == 0 and not a.affinity_hit
    b = router.submit(np.array([1, 2, 3, 4, 6], np.int32), 2)
    assert b.replica_id == 0 and b.affinity_hit
    c = router.submit(np.array([9, 8, 7], np.int32), 2)
    assert c.replica_id == 1 and not c.affinity_hit
    rep = router.fleet_report()
    assert (rep["affinity"]["hits"], rep["affinity"]["misses"]) == (1, 2)
    with pytest.raises(QueueFullError):
        router.submit(np.array([5, 6], np.int32), 2)
    assert router.fleet_report()["shed_total"] == 1
    router.start()
    assert router.wait_ready(WAIT)
    for fr in (a, b, c):
        assert fr.wait(timeout=WAIT) and fr.state is RequestState.DONE


def test_no_affinity_disables_trie_routing(w1, fleet):
    router = fleet([dense_engine(w1) for _ in range(2)], affinity=False,
                   autostart=False)
    a = router.submit(np.array([1, 2, 3, 4], np.int32), 2)
    b = router.submit(np.array([1, 2, 3, 4], np.int32), 2)
    assert a.replica_id == 0
    assert b.replica_id == 1 and not b.affinity_hit


def test_fleet_report_pools_percentiles(w1, fleet):
    """The pooled block merges both replicas' reservoirs and counters."""
    router = fleet([dense_engine(w1, prefix=False) for _ in range(2)])
    frs = [router.submit(np.array([1 + i, 2], np.int32), 3)
           for i in range(6)]
    for fr in frs:
        assert fr.wait(timeout=WAIT)
    rep = router.fleet_report()
    pooled = rep["pooled"]
    assert pooled["ranks"] == 2
    ttft = pooled["histograms"]["serving_ttft_seconds"]
    assert ttft["count"] == 6
    assert ttft["p99_s"] >= ttft["p50_s"] > 0
    assert pooled["counters"]["serving_requests_completed_total"] == 6
    assert {v["state"] for v in rep["replicas"].values()} == {"healthy"}
    assert rep["costs"] is None and rep["health"] is None


def test_retire_replica_reroutes_queued_work(w1, fleet):
    """``test_control.py:241``: queued work on a retiring replica moves to
    its peer, and the retired replica stays down."""
    router = fleet([dense_engine(w1, prefix=False) for _ in range(2)],
                   autostart=False)
    frs = [router.submit(np.array([1 + i], np.int32), 2) for i in range(4)]
    assert {fr.replica_id for fr in frs} == {0, 1}
    out = router.retire_replica(0, timeout=5.0)
    assert out["state"] == "retired" and out["drained"] >= 1
    assert not out["forced"]
    assert all(fr.replica_id == 1 for fr in frs)
    router.start()
    assert router.wait_ready(WAIT)
    for i, fr in enumerate(frs):
        assert fr.wait(timeout=WAIT) and fr.state is RequestState.DONE
        assert fr.tokens == solo(w1, [1 + i], 2)
    assert router.capacity == 1
    assert router.replicas[0].state is ReplicaState.RETIRED
    with pytest.raises(RuntimeError, match="cannot retire"):
        router.retire_replica(0)


def test_unported_router_pieces_name_the_roadmap(w1, fleet, tmp_path):
    """Every router piece is ported: ``spawn_replica(checkpoint=)`` from a
    checkpoint with no snapshot raises the reference's error
    (``tests/test_torch_tp_serving.py`` and ``chip_smoke.py``'s
    ``reshard`` spawn from a real one), and without ``engine=`` it needs
    all three restore arguments; ``publish``, ``attach_health`` and
    ``attach_controller`` work (``tests/test_torch_control.py``): a
    publish of the wrong keys fails its commit and is reported."""
    from chainermn_torch.extensions import ShardedCheckpointer

    router = fleet([dense_engine(w1, prefix=False)], autostart=False)
    with pytest.raises(RuntimeError, match="no snapshot"):
        router.spawn_replica(checkpoint=ShardedCheckpointer(
            str(tmp_path / "empty")), engine_factory=lambda p: p,
            params_template={})
    with pytest.raises(ValueError, match="engine= or all of"):
        router.spawn_replica(checkpoint=object())
    router.attach_health(None)
    router.attach_controller(None)
    out = router.publish({}, timeout=1.0)
    assert not out["ok"]
    assert out["replicas"]["0"]["error"].startswith("PublishError")
    assert router.replicas[0].engine.weight_version == 0


# --------------------------------------------------------------------- #
# disaggregated tiers (test_disagg.py)                                   #
# --------------------------------------------------------------------- #


def test_tier_kwargs_validated():
    with pytest.raises(ValueError, match="together"):
        FleetRouter([None, None], prefill_replicas=1)
    with pytest.raises(ValueError, match="at least one"):
        FleetRouter([None, None], prefill_replicas=0, decode_replicas=2)
    with pytest.raises(ValueError, match="cover the fleet"):
        FleetRouter([None, None, None], prefill_replicas=1,
                    decode_replicas=1)


@pytest.mark.parametrize("p,d", [(1, 1), (1, 2)])
def test_tiers_migrate_to_parity(w2, fleet, p, d):
    """1P+1D and 1P+2D with chunked prefill: concurrent requests stream
    ``generate()``'s tokens, the decode tier decodes them (migrations
    counted), and no replica rebuilds a program."""
    router = fleet([paged_engine(w2) for _ in range(p + d)],
                   prefill_replicas=p, decode_replicas=d,
                   chunk_tokens_per_step=3 if d == 1 else 2)
    before = _counter("kv_migrations_total")
    frs = [router.submit(PROMPT, N_NEW, seed=i) for i in range(2 * d)]
    for fr in frs:
        assert fr.wait(WAIT)
        assert fr.tokens == solo(w2, PROMPT, N_NEW)
    rep = router.fleet_report()
    assert rep["tiers"] == {"prefill": list(range(p)),
                            "decode": list(range(p, p + d))}
    assert _counter("kv_migrations_total") > before
    assert router.replicas[0].engine.active_slots == 0
    _no_recompiles(router)


def test_migrate_chaos_decodes_in_place(w2, fleet):
    """Every ``fleet.migrate`` attempt faults: the prefill replica keeps
    the request and decodes it itself, with the same tokens."""
    inj = FaultInjector()
    inj.arm(FLEET_MIGRATE, times=100)
    with inj:
        router = fleet([paged_engine(w2) for _ in range(2)],
                       prefill_replicas=1, decode_replicas=1,
                       chunk_tokens_per_step=3)
        before = _counter("kv_migrations_total")
        out = router.generate(PROMPT, N_NEW, timeout=WAIT)
        assert [int(t) for t in out[len(PROMPT):]] == solo(w2, PROMPT,
                                                           N_NEW)
        assert inj.fired_log, "the migrate cut-point never fired"
        assert _counter("kv_migrations_total") == before
    _no_recompiles(router)


def test_kill_decode_replica_mid_flight(w2, fleet):
    """The decode tier dies while a migrated request is queued, importing
    or decoding there: the router replays it, to parity."""
    router = fleet([paged_engine(w2) for _ in range(2)],
                   prefill_replicas=1, decode_replicas=1,
                   chunk_tokens_per_step=2)
    fr = router.submit(PROMPT, N_NEW)
    router.kill_replica(1)
    assert fr.wait(WAIT)
    assert fr.tokens == solo(w2, PROMPT, N_NEW)
    _no_recompiles(router)


# --------------------------------------------------------------------- #
# prefix sharing (test_share.py)                                         #
# --------------------------------------------------------------------- #


def _sharing_fleet(fleet, w2):
    """Sharing on, and a zero-tolerance imbalance: any load on the holder
    rejects affinity (the share trigger)."""
    return fleet([paged_engine(w2) for _ in range(2)], share_prefixes=True,
                 prefix_share_min_blocks=2,
                 policy=RoutingPolicy(max_imbalance=0.0))


def test_share_turns_affinity_miss_into_prefix_hit(w2, fleet):
    router = _sharing_fleet(fleet, w2)
    assert router.share_prefixes
    ref = solo(w2, PROMPT, N_NEW)
    out0 = router.generate(PROMPT, N_NEW, timeout=WAIT)
    assert [int(t) for t in out0[len(PROMPT):]] == ref
    router.set_admission_weight(0, 0.5)
    before = _counter("kv_shares_total")
    fr = router.submit(PROMPT, N_NEW)
    assert fr.wait(WAIT)
    assert fr.replica_id == 1
    assert fr.tokens == ref
    assert _counter("kv_shares_total") == before + 1
    rep = router.fleet_report()["kv_reuse"]
    assert rep["share_enabled"] and rep["shares"] == 1
    cache = rep["payload_cache"]
    assert (cache["entries"], cache["imports"], cache["pinned"]) == (1, 1, 0)
    # the destination admitted against the adopted blocks: 5 blocks, 10
    # tokens cached, only the 2-token suffix prefilled
    admits = [e for e in get_event_log().tail()
              if e["kind"] == "slot_admit" and e.get("req") == fr._inner.id
              and "cached" in e]
    assert admits and admits[-1]["cached"] == 10
    _no_recompiles(router)


def test_share_chaos_decays_to_plain_prefill(w2, fleet):
    inj = FaultInjector()
    inj.arm(FLEET_SHARE, times=100)
    with inj:
        router = _sharing_fleet(fleet, w2)
        ref = solo(w2, PROMPT, N_NEW)
        router.generate(PROMPT, N_NEW, timeout=WAIT)
        router.set_admission_weight(0, 0.5)
        before = _counter("kv_shares_total")
        fr = router.submit(PROMPT, N_NEW)
        assert fr.wait(WAIT)
        assert fr.tokens == ref
        assert inj.fired_log, "the share cut-point never fired"
        assert _counter("kv_shares_total") == before
        assert router.fleet_report()["kv_reuse"]["shares"] == 0


def test_sharing_needs_the_paged_store(w1, fleet):
    router = fleet([dense_engine(w1) for _ in range(2)],
                   share_prefixes=True, autostart=False)
    assert router.affinity and not router.share_prefixes


# --------------------------------------------------------------------- #
# mid-decode rebalancing (test_rebalance.py)                             #
# --------------------------------------------------------------------- #

N_LONG = 20             # long enough to be decoding when the move lands


def _throttle(delay_s=0.015):
    """A consumer slow enough to keep the request mid-decode while the
    rebalance handshake runs."""
    def cb(tok):
        time.sleep(delay_s)
    return cb


def _first_token(fr):
    deadline = time.perf_counter() + WAIT
    while time.perf_counter() < deadline:
        if fr.tokens or fr.finished:
            return
        time.sleep(0.002)
    raise AssertionError("the request never produced a token")


def test_mid_decode_rebalance_token_exact(w2, fleet):
    router = fleet([paged_engine(w2) for _ in range(2)])
    before = _counter("kv_rebalances_total")
    fr = router.submit(PROMPT, N_LONG, stream_cb=_throttle())
    assert fr.replica_id == 0
    _first_token(fr)
    ticket = router.rebalance_decode(0, 1)
    assert ticket is not None
    assert ticket.wait(30) is True
    assert fr.wait(WAIT)
    assert fr.tokens == solo(w2, PROMPT, N_LONG)
    assert fr.replica_id == 1
    assert _counter("kv_rebalances_total") == before + 1
    evs = [e for e in get_event_log().tail()
           if e["kind"] == "rebalance" and e.get("req") == fr.id]
    assert evs and (evs[-1]["src"], evs[-1]["dest"]) == (0, 1)
    assert router.fleet_report()["kv_reuse"]["rebalances"] == 1
    _no_recompiles(router)


def test_rebalance_chaos_victim_decodes_in_place(w2, fleet):
    inj = FaultInjector()
    inj.arm(FLEET_REBALANCE, times=100)
    with inj:
        router = fleet([paged_engine(w2) for _ in range(2)])
        before = _counter("kv_rebalances_total")
        fr = router.submit(PROMPT, N_LONG, stream_cb=_throttle())
        _first_token(fr)
        ticket = router.rebalance_decode(0, 1)
        assert ticket is not None
        assert not ticket.wait(30)
        assert fr.wait(WAIT)
        assert fr.tokens == solo(w2, PROMPT, N_LONG)
        assert fr.replica_id == 0
        assert inj.fired_log, "the rebalance cut-point never fired"
        assert _counter("kv_rebalances_total") == before
