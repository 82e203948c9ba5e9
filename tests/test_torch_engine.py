"""The port's paged serving engine + FCFS scheduler against the JAX paged
engine and JAX ``generate()`` on the same flax weights (converted by
``params_from_flax``), greedy, f32, on the CPU.

Prompts and engine settings follow
``tests/serving_tests/test_paged_kernel_engine.py``. The JAX engines are
built at most twice in this file (the f32 and int8 paged engines) and run
without ``warmup()``, which would compile programs these requests never
use.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM, init_kv_caches
from chainermn_torch.serving import (
    FCFSScheduler,
    ServingClient,
    ServingEngine,
)

torch.set_float32_matmul_precision("highest")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores that timing-sensitive tests share
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
PROMPTS = [np.array([3, 5, 2]), np.array([1, 2, 3, 4, 6]), np.array([7, 1])]
ENGINE = dict(n_slots=3, prefill_buckets=(4, 8), prefill_batch=2,
              paged=True, kv_block_size=2, cache_len=32)
N_NEW = 6


@pytest.fixture(scope="module")
def weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params


def _port_model(params):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _jax_serve(lm, params, prompts, n_new, **kw):
    engine = JaxEngine(lm, params, **dict(ENGINE, **kw))
    sched = JaxScheduler(engine)
    reqs = [sched.submit(p, n_new) for p in prompts]
    sched.run_until_idle()
    return [list(map(int, r.output)) for r in reqs]


def _serve(model, prompts, n_new, **kw):
    engine = ServingEngine(model, device="cpu", **dict(ENGINE, **kw))
    engine.warmup()
    sched = FCFSScheduler(engine)
    reqs = [sched.submit(p, n_new) for p in prompts]
    sched.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    _assert_pool_whole(engine)
    return [list(map(int, r.output)) for r in reqs], engine, sched


def _assert_pool_whole(engine):
    """After every request retired, all blocks are free or held only by
    the prefix trie (evictable), nothing is reserved, no slot is busy."""
    pool = engine._pool
    assert engine.active_slots == 0
    assert engine.free_slots == set(range(engine.n_slots))
    assert int(engine._slot_reserved.sum()) == 0
    assert pool.free_blocks + engine.prefix_cache.evictable_blocks() \
        == pool.capacity
    assert engine.kv_blocks_admittable() == pool.capacity


@pytest.fixture(scope="module")
def references(weights):
    lm, params = weights
    solo = [list(map(int, np.asarray(jax_generate(
        lm, params, jnp.asarray(p, jnp.int32)[None], N_NEW)[0])))
        for p in PROMPTS]
    return {"solo": solo,
            "engine": _jax_serve(lm, params, PROMPTS, N_NEW)}


@pytest.mark.parametrize("paged_kernel", [False, True],
                         ids=["plain_read", "kernel_read"])
def test_streams_match_jax_engine_and_generate(weights, references,
                                               paged_kernel):
    """On CPU tensors the kernel wrapper runs its plain version, so both
    read paths must give the JAX streams."""
    _, params = weights
    got, engine, _ = _serve(_port_model(params), PROMPTS, N_NEW,
                            paged_kernel=paged_kernel)
    assert references["engine"] == references["solo"]
    assert got == references["engine"]
    assert engine.paged_kernel is paged_kernel


def test_shared_prefix_hits_and_matches_generate(weights):
    """Prompts sharing a 4-token prefix: later admissions reference the
    cached blocks (hits, no recompute of the prefix) and still decode
    exactly the solo ``generate()`` streams."""
    lm, params = weights
    shared = [3, 5, 2, 9]
    prompts = [np.array(shared + tail) for tail in ([1], [4, 4], [8, 2, 7])]
    model = _port_model(params)
    engine = ServingEngine(model, device="cpu", **ENGINE)
    sched = FCFSScheduler(engine)
    first = sched.submit(prompts[0], N_NEW)
    sched.step()                          # admit the donor alone first
    reqs = [first] + [sched.submit(p, N_NEW) for p in prompts[1:]]
    sched.run_until_idle()
    assert engine.prefix_cache.hits >= 2
    for p, r in zip(prompts, reqs):
        want = np.asarray(jax_generate(lm, params,
                                       jnp.asarray(p, jnp.int32)[None],
                                       N_NEW)[0])
        np.testing.assert_array_equal(r.output, want)
    _assert_pool_whole(engine)


def test_int8_store_matches_jax_int8_engine(weights):
    lm, params = weights
    want = _jax_serve(lm, params, PROMPTS, N_NEW, kv_quant="int8")
    got, _, _ = _serve(_port_model(params), PROMPTS, N_NEW,
                       kv_quant="int8")
    assert got == want


def test_small_pool_defers_admission(weights, references):
    """A pool too small for all three requests' worst-case growth:
    block-budget admission keeps the head queued until retirements return
    blocks; every stream still equals its solo ``generate()``."""
    _, params = weights
    got, _, sched = _serve(_port_model(params), PROMPTS, N_NEW,
                           kv_blocks=10, prefill_batch=1)
    assert got == references["solo"]
    assert sched.metrics.report()["requests_completed"] == len(PROMPTS)


def test_dry_pool_preempts_newest_and_replays(weights, references):
    """Drive the preemption branch: with the free list emptied under the
    scheduler (the trie's blocks are still held by live slots, so nothing
    is evictable), the slot that needs a block preempts the newest
    request, which later replays to the same tokens."""
    _, params = weights
    engine = ServingEngine(_port_model(params), device="cpu",
                           **dict(ENGINE, kv_blocks=12))
    sched = FCFSScheduler(engine)
    reqs = [sched.submit(p, N_NEW) for p in PROMPTS]
    sched.step()
    sched.step()
    victim = max((r for r in reqs if r.slot >= 0), key=lambda r: r.id)
    stolen = []
    while engine._pool.free_blocks:       # starve the pool
        stolen.append(engine._pool.alloc())
    for _ in range(2 * N_NEW):
        if any(engine.slot_needs_block(s) for s in sched._by_slot):
            break
        sched.step()
    sched._ensure_decode_blocks()
    assert sched.metrics.report()["kv_preemptions"] >= 1
    assert victim.state.value == "queued" and victim.tokens == []
    for block in stolen:
        engine._pool.decref(block)
    sched.run_until_idle()
    assert [list(map(int, r.output)) for r in reqs] == references["solo"]
    _assert_pool_whole(engine)


def test_client_thread_serves_and_closes(weights, references):
    _, params = weights
    engine = ServingEngine(_port_model(params), device="cpu", **ENGINE)
    with ServingClient(engine) as client:
        out = client.generate(PROMPTS[0], N_NEW, timeout=60)
        streamed = []
        req = client.submit(PROMPTS[1], N_NEW, stream_cb=streamed.append)
        assert req.wait(60)
    assert list(out) == references["solo"][0]
    assert list(req.output) == references["solo"][1]
    assert streamed == list(req.output[len(PROMPTS[1]):])
    assert not client._thread.is_alive()


def test_engine_rejects_what_is_not_ported(weights):
    """The dense engine (``paged=False``) is ported and builds; requests
    the engine cannot hold are still refused; a tensor-parallel model
    decodes only with its tensor axis bound (its KV cache holds a rank's
    local heads), and the engine refuses it without ``comm=``
    (``tests/test_torch_tp_serving.py`` serves it on two ranks)."""
    _, params = weights
    model = _port_model(params)
    dense = ServingEngine(model, device="cpu", **dict(ENGINE, paged=False))
    assert not dense.paged and dense.caches is not None
    engine = ServingEngine(model, device="cpu", **ENGINE)
    with pytest.raises(ValueError, match="prefill_len"):
        engine.validate_request(9, 1)
    with pytest.raises(ValueError, match="cache_len"):
        engine.validate_request(8, 25)
    tp = TransformerLM(**CFG, tensor_axis="tp", compute_dtype=torch.float32,
                       device="cpu")
    with pytest.raises(ValueError, match="not bound"):
        tp(torch.zeros((1, 2), dtype=torch.long), 0,
           kv_caches=init_kv_caches(tp, 1, 8))
    with pytest.raises(ValueError, match="tensor-parallel serving needs "
                                         "comm="):
        ServingEngine(tp, device="cpu", **ENGINE)


def test_sampled_streams_follow_the_request_seed(weights):
    """temperature > 0: each slot draws from its own generator seeded by
    its request, so a stream depends on its seed only — not on which
    requests share the batch."""
    _, params = weights
    model = _port_model(params)

    def serve(seeds, prompts):
        engine = ServingEngine(model, device="cpu", temperature=0.9,
                               top_k=8, **ENGINE)
        sched = FCFSScheduler(engine)
        reqs = [sched.submit(p, 8, seed=s) for p, s in zip(prompts, seeds)]
        sched.run_until_idle()
        return [list(map(int, r.output)) for r in reqs]

    together = serve([11, 12, 13], PROMPTS)
    alone = serve([12], PROMPTS[1:2])
    assert together[1] == alone[0]
    assert serve([11, 12, 13], PROMPTS) == together
    assert all(0 <= t < CFG["vocab_size"] for row in together for t in row)
