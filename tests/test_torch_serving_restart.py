"""The scheduler's degradation boundary on the port's engine, on the CPU:
an engine failure errors the in-flight work with ``EngineFailed`` and
warm-restarts the engine in place (the same programs, nothing rebuilt),
admission faults stay with their group or are retried, and what is
served after a restart equals JAX ``generate()`` on the same flax
weights. Ports of ``tests/resilience_tests/test_serving_degradation.py``,
``test_paged_kv.py:253``, ``test_prefix_cache.py:222`` and
``test_chunked_prefill.py:137``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_event_log, get_registry
from chainermn_torch.resilience import FaultInjector, InjectedFault, RetryPolicy
from chainermn_torch.resilience.cutpoints import (
    SERVING_CHUNK_PREFILL,
    SERVING_DECODE,
    SERVING_PREFILL_BATCH,
    SERVING_PREFIX_COPY,
    SERVING_SPEC_VERIFY,
)
from chainermn_torch.serving import (
    EngineFailed,
    EngineStateError,
    FCFSScheduler,
    RequestState,
    ServingEngine,
    SpeculativeConfig,
)

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=1, max_len=48)
CFG2 = dict(CFG, n_layers=2)          # test_paged_kv / prefix / chunked
PREFIX = [1, 2, 3, 4, 5, 6]


def _jax(cfg):
    lm = JaxLM(**cfg, compute_dtype=jnp.float32)
    return lm, lm.init(jax.random.PRNGKey(0),
                       jnp.asarray([[1, 2, 3]], jnp.int32))


@pytest.fixture(scope="module")
def weights():
    return _jax(CFG)


@pytest.fixture(scope="module")
def weights2():
    return _jax(CFG2)


def _port(cfg, params):
    model = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _solo(lm, params, prompt, n):
    out = jax_generate(lm, params, jnp.asarray(prompt, jnp.int32)[None], n)
    return [int(t) for t in np.asarray(out[0])]


def _out(req):
    return [int(t) for t in req.output]


def make(weights, n_slots=2, engine_kw=None, **kw):
    """The reference's ``make``: prefill_len 6, cache_len 32."""
    _, params = weights
    engine = ServingEngine(_port(CFG, params), n_slots=n_slots,
                           prefill_len=6, cache_len=32, device="cpu",
                           **(engine_kw or {}))
    return engine, FCFSScheduler(engine, **kw)


def test_engine_raise_errors_in_flight_and_restarts(weights):
    """``test_serving_degradation.py:125``: both requests in flight when
    decode raised end ERRORED with ``EngineFailed`` (the fault its
    cause), the engine warm-restarts once with the same programs, and a
    request after the restart streams JAX ``generate()``'s tokens."""
    lm, params = weights
    engine, sched = make(weights)
    r0 = sched.submit(np.array([7, 8]), 2)
    sched.run_until_idle()
    assert r0.state is RequestState.DONE
    before = engine.compile_counts()
    detailed = engine.compile_counts_detailed()
    restarts0 = get_registry().counter(
        "serving_engine_restarts_total", {"engine": "serving"}).value
    inj = FaultInjector()
    inj.arm(SERVING_DECODE, kind="raise", after=1, times=1)
    with inj:
        r1 = sched.submit(np.array([1, 2]), 6)
        r2 = sched.submit(np.array([3, 4]), 6)
        sched.run_until_idle()
        for r in (r1, r2):
            assert r.state is RequestState.ERRORED
            with pytest.raises(EngineFailed) as ei:
                r.wait(timeout=1)
            assert isinstance(ei.value.__cause__, InjectedFault)
        assert sched.engine_restarts == 1
        assert engine.free_slots == {0, 1}
        r3 = sched.submit(np.array([5, 6]), 4)
        sched.run_until_idle()
    assert r3.state is RequestState.DONE
    assert engine.compile_counts() == before
    assert engine.compile_counts_detailed() == detailed
    assert engine.recompiles == {}
    assert _out(r3) == _solo(lm, params, [5, 6], 4)
    m = sched.metrics.report()
    assert m["requests_errored"] == 2 and m["engine_restarts"] == 1
    assert get_registry().counter(
        "serving_engine_restarts_total",
        {"engine": "serving"}).value == restarts0 + 1
    kinds = [e["kind"] for e in get_event_log().tail(200)]
    assert "engine_error" in kinds and "engine_restart" in kinds


def test_spec_verify_raise_errors_in_flight_and_restarts(weights):
    """``test_serving_degradation.py:160``: a raise inside
    ``serving.spec_verify`` is an engine failure too; the restart resets
    the drafter with the slots, and speculative traffic afterwards equals
    ``generate()`` with no program rebuilt."""
    lm, params = weights
    engine, sched = make(weights, engine_kw=dict(
        paged=True, kv_block_size=2, speculative=SpeculativeConfig(k=2)))
    engine.warmup()
    before = engine.compile_counts_detailed()
    inj = FaultInjector()
    inj.arm(SERVING_SPEC_VERIFY, kind="raise", after=1, times=1)
    with inj:
        r1 = sched.submit(np.array([1, 2]), 6)
        r2 = sched.submit(np.array([3, 4]), 6)
        sched.run_until_idle()
        for r in (r1, r2):
            assert r.state is RequestState.ERRORED
            assert isinstance(r.error, EngineFailed)
            assert isinstance(r.error.__cause__, InjectedFault)
        assert sched.engine_restarts == 1
        assert engine.free_slots == {0, 1}
        r3 = sched.submit(np.array([5, 6]), 4)
        sched.run_until_idle()
    assert r3.state is RequestState.DONE
    assert engine.compile_counts_detailed() == before
    assert engine.recompiles == {}
    assert _out(r3) == _solo(lm, params, [5, 6], 4)


def test_prefill_raise_errors_admitting_request(weights):
    """``test_serving_degradation.py:195`` on the port's admission
    cut-point: the admitting request errors, the queue is still served,
    and no restart is burned (the stores are written in place)."""
    engine, sched = make(weights, n_slots=1)
    inj = FaultInjector()
    inj.arm(SERVING_PREFILL_BATCH, kind="raise", times=1)
    with inj:
        r1 = sched.submit(np.array([1, 2]), 3)
        r2 = sched.submit(np.array([3, 4]), 3)
        sched.run_until_idle()
    assert r1.state is RequestState.ERRORED
    assert isinstance(r1.error, EngineFailed)
    assert r2.state is RequestState.DONE
    assert sched.engine_restarts == 0


@pytest.mark.parametrize("point", [SERVING_PREFILL_BATCH,
                                   SERVING_PREFIX_COPY])
def test_prefill_retry_absorbs_transient(weights, point):
    """``test_serving_degradation.py:208`` and ``:431``: with a
    ``RetryPolicy`` around admission, one transient fault at the prefill
    (or the prefix fetch before it) never errors a request."""
    lm, params = weights
    engine = ServingEngine(_port(CFG, params), n_slots=3,
                           prefill_buckets=(4, 6), prefill_batch=2,
                           prefix_cache_blocks=8, prefix_block_size=2,
                           cache_len=32, paged=False, device="cpu")
    sched = FCFSScheduler(engine, retry=RetryPolicy(3, base_delay_s=0.001,
                                                    jitter=0))
    if point == SERVING_PREFIX_COPY:      # seed the trie: the next one hits
        sched.submit(np.array([1, 2, 3, 4, 5]), 2)
        sched.run_until_idle()
    inj = FaultInjector()
    inj.arm(point, kind="raise", times=1)
    with inj:
        r1 = sched.submit(np.array([1, 2, 3, 4, 6]), 3)
        r2 = sched.submit(np.array([3, 4]), 3)
        sched.run_until_idle()
    assert inj.fired_log
    assert r1.state is RequestState.DONE and r2.state is RequestState.DONE
    assert _out(r1) == _solo(lm, params, [1, 2, 3, 4, 6], 3)
    assert sched.engine_restarts == 0
    assert sched.metrics.report()["requests_errored"] == 0


def test_restart_disabled_reraises(weights):
    """``test_serving_degradation.py:224``."""
    engine, sched = make(weights, n_slots=1, restart_on_error=False)
    inj = FaultInjector()
    inj.arm(SERVING_DECODE, kind="raise", times=1)
    with inj:
        r = sched.submit(np.array([1, 2]), 4)
        with pytest.raises(InjectedFault):
            sched.run_until_idle()
    assert r.state is RequestState.ERRORED
    assert sched.engine_restarts == 0


def test_restart_budget_exhausted_reraises(weights):
    """``test_serving_degradation.py:236``: a fault at every decode burns
    the one restart allowed, then re-raises."""
    engine, sched = make(weights, n_slots=1, max_restarts=1)
    inj = FaultInjector()
    inj.arm(SERVING_DECODE, kind="raise", times=None)
    with inj:
        sched.submit(np.array([1, 2]), 4)
        sched.submit(np.array([3, 4]), 4)
        with pytest.raises(InjectedFault):
            sched.run_until_idle()
    assert sched.engine_restarts == 1


def test_engine_state_error_in_admission_restarts(weights):
    """An admission that raises ``EngineStateError`` (the engine cannot
    vouch for its state) is an engine failure: the decoding request and
    the admitting one both error, and the engine restarts."""
    lm, params = weights
    engine, sched = make(weights)
    inflight = sched.submit(np.array([9, 10]), 8)
    sched.step()
    assert inflight.slot >= 0
    inj = FaultInjector()
    inj.arm(SERVING_PREFILL_BATCH, kind="raise", times=1,
            exc=EngineStateError("store lost"))
    with inj:
        victim = sched.submit(np.array([1, 2]), 3)
        sched.step()
    for r in (inflight, victim):
        assert r.state is RequestState.ERRORED
        assert isinstance(r.error, EngineFailed)
    assert sched.engine_restarts == 1
    redo = sched.submit(np.array([9, 10]), 8)
    sched.run_until_idle()
    assert _out(redo) == _solo(lm, params, [9, 10], 8)


def test_fail_inflight_and_drain_queued(weights):
    """The supervisor surface: ``fail_inflight`` errors the in-flight
    work without restarting, ``drain_queued`` hands back the QUEUED
    requests, and the engine still serves once restarted by its owner."""
    lm, params = weights
    engine, sched = make(weights, n_slots=1)
    busy = sched.submit(np.array([1, 2]), 6)
    waiting = sched.submit(np.array([3, 4]), 2)
    sched.step()
    sched.fail_inflight(RuntimeError("replica lost"))
    assert busy.state is RequestState.ERRORED
    assert isinstance(busy.error, EngineFailed)
    assert sched.engine_restarts == 0
    assert sched.drain_queued() == [waiting]
    assert waiting.state is RequestState.QUEUED and not sched.has_work
    engine.restart()
    again = sched.submit(np.array([3, 4]), 2)
    sched.run_until_idle()
    assert _out(again) == _solo(lm, params, [3, 4], 2)


def test_restart_resets_tables_pool_and_trie_together(weights2):
    """``test_paged_kv.py:253``: the restart drops the slot tables,
    resets the pool and clears the trie with the zeroed store, so nothing
    pins or serves dead KV; the same programs afterwards."""
    lm, params = weights2
    engine = ServingEngine(_port(CFG2, params), n_slots=2,
                           prefill_buckets=(6,), paged=True,
                           kv_block_size=2, cache_len=24, device="cpu")
    engine.warmup()
    counts = engine.compile_counts_detailed()
    sched = FCFSScheduler(engine)
    seed = sched.submit(np.array(PREFIX), 4)
    sched.run_until_idle()
    assert seed.finished and engine._pool.used_blocks > 0
    inj = FaultInjector(seed=0)
    inj.arm(SERVING_DECODE, kind="raise", times=1)
    with inj:
        victim = sched.submit(np.array([2, 3, 4]), 6)
        sched.run_until_idle()
    assert victim.state is RequestState.ERRORED
    assert sched.engine_restarts == 1
    assert engine._pool.used_blocks == 0
    assert (engine._tables == 0).all()
    assert engine.prefix_cache.match(np.array(PREFIX)) is None
    assert all(not t.any() for layer in engine._store
               for t in layer.values())
    redo = sched.submit(np.array([2, 3, 4]), 6)
    sched.run_until_idle()
    assert _out(redo) == _solo(lm, params, [2, 3, 4], 6)
    assert engine.compile_counts_detailed() == counts


def test_restart_rebuilds_trie_with_store(weights2):
    """``test_prefix_cache.py:222`` (dense engine, prefix store): the
    restart clears the trie together with the zeroed store and caches, a
    same-prefix request afterwards misses and still equals
    ``generate()``, and no program is rebuilt."""
    lm, params = weights2
    engine = ServingEngine(_port(CFG2, params), n_slots=2,
                           prefill_buckets=(4, 8), prefill_batch=2,
                           prefix_cache_blocks=16, prefix_block_size=2,
                           cache_len=32, paged=False, device="cpu")
    engine.warmup()
    counts = engine.compile_counts_detailed()
    sched = FCFSScheduler(engine)
    seed = sched.submit(np.array(PREFIX + [7]), 4)
    sched.run_until_idle()
    assert seed.finished and engine.prefix_cache.used_blocks > 0
    inj = FaultInjector(seed=0)
    inj.arm(SERVING_DECODE, kind="raise", times=1)
    with inj:
        victim = sched.submit(np.array(PREFIX + [8]), 6)
        sched.run_until_idle()
    assert victim.state is RequestState.ERRORED
    assert sched.engine_restarts == 1
    assert engine.prefix_cache.used_blocks == 0
    assert engine.prefix_cache.match(np.array(PREFIX + [8])) is None
    redo = sched.submit(np.array(PREFIX + [8]), 6)
    sched.run_until_idle()
    assert _out(redo) == _solo(lm, params, PREFIX + [8], 6)
    assert engine.compile_counts_detailed() == counts


def test_chunk_chaos_errors_the_victim_without_leaking_slots(weights2):
    """``test_chunked_prefill.py:137``: a fault at
    ``serving.chunk_prefill`` mid-request errors the victim with
    ``EngineFailed`` and leaks no slot, and the next request decodes to
    ``generate()`` with no program rebuilt. (The port contains a chunk
    fault to its request, as it does an admission fault: its stores are
    written in place, so no restart is needed.)"""
    lm, params = weights2
    engine = ServingEngine(_port(CFG2, params), n_slots=2,
                           prefill_buckets=(4, 8, 16), prefill_batch=2,
                           paged=True, kv_block_size=2, kv_blocks=64,
                           cache_len=48, device="cpu")
    engine.warmup()
    counts = engine.compile_counts_detailed()
    s = FCFSScheduler(engine, chunk_tokens_per_step=2,
                      restart_on_error=True)
    victim_prompt = np.asarray([2, 7, 1, 8, 2, 8, 1, 8, 2, 8, 4, 5],
                               np.int32)
    inj = FaultInjector()
    inj.arm(SERVING_CHUNK_PREFILL, times=1, after=1)
    with inj:
        r = s.submit(victim_prompt, 6)
        for _ in range(400):
            s.step()
            if r.finished:
                break
    assert r.state is RequestState.ERRORED
    assert isinstance(r.error, EngineFailed)
    assert inj.fired_log, "chunk cut-point never fired"
    assert len(engine.free_slots) == engine.n_slots
    prompt = [1, 4, 2, 7, 3, 5, 6, 2, 9, 4, 1, 3]
    r2 = s.submit(np.array(prompt), 6)
    s.run_until_idle()
    assert _out(r2) == _solo(lm, params, prompt, 6)
    assert engine.recompiles == {}
    assert engine.compile_counts_detailed() == counts
