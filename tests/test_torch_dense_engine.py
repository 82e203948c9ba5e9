"""The port's dense KV cache, dense serving engine, legacy prefix store,
cacheless ``generate`` and sampler masks against the JAX package on the
same flax weights (converted by ``params_from_flax``), f32, on the CPU.

The JAX engines run without ``warmup()`` (it would compile programs these
requests never use); greedy streams must match exactly, attention outputs
within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.models import init_kv_caches as jax_init_kv_caches
from chainermn_tpu.models.transformer import _sampler as jax_sampler
from chainermn_tpu.parallel import sequence as jseq
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM, generate, init_kv_caches
from chainermn_torch.models.transformer import filter_logits
from chainermn_torch.parallel import sequence as tseq
from chainermn_torch.serving import FCFSScheduler, ServingEngine

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
PROMPTS = [np.array([3, 5, 2]), np.array([1, 2, 3, 4, 6]), np.array([7, 1]),
           np.array([9, 9, 4, 1, 2, 8, 3])]
DENSE = dict(n_slots=3, prefill_buckets=(4, 8), prefill_batch=2,
             cache_len=32)
N_NEW = 6


@pytest.fixture(scope="module")
def weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params


def _port_model(params, **kw):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                          **kw)
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _solo(lm, params, prompt, n):
    return [int(t) for t in np.asarray(jax_generate(
        lm, params, jnp.asarray(prompt, jnp.int32)[None], n)[0])]


def _jax_serve(lm, params, prompts, n_new, **kw):
    engine = JaxEngine(lm, params, **dict(DENSE, **kw))
    sched = JaxScheduler(engine)
    reqs = [sched.submit(p, n_new) for p in prompts]
    sched.run_until_idle()
    return [list(map(int, r.output)) for r in reqs], engine


def _serve(model, prompts, n_new, **kw):
    engine = ServingEngine(model, device="cpu", paged=False,
                           **dict(DENSE, **kw))
    sched = FCFSScheduler(engine)
    reqs = [sched.submit(p, n_new) for p in prompts]
    sched.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    assert engine.active_slots == 0
    assert engine.free_slots == set(range(engine.n_slots))
    return [list(map(int, r.output)) for r in reqs], engine


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_kv_caches_shapes_and_dtypes(dtype):
    jlm = JaxLM(**CFG, compute_dtype=getattr(jnp, dtype))
    want = jax_init_kv_caches(jlm, 3, 20)
    model = TransformerLM(**CFG, compute_dtype=getattr(torch, dtype),
                          device="cpu")
    got = init_kv_caches(model, 3, 20)
    assert len(got) == len(want) == CFG["n_layers"]
    for g, w in zip(got, want):
        assert set(g) == set(w) == {"k", "v"}
        for kk in ("k", "v"):
            assert tuple(g[kk].shape) == w[kk].shape == (3, 20, 4, 4)
            assert str(g[kk].dtype).split(".")[-1] == str(w[kk].dtype)
            assert not g[kk].any()


# per-row bases, the last two running past the 9-row buffer: the
# reference's dynamic_update_slice clamps those writes to Tc - S
@pytest.mark.parametrize("pos", [2, 7, [0, 3, 5], [1, 6, 8]],
                         ids=["scalar", "scalar_clamped", "per_row",
                              "per_row_clamped"])
def test_dense_update_matches_jax(pos):
    rng = np.random.default_rng(11)
    b, s, h, d, tc = 3, 3, 2, 8, 9
    bufs = {kk: rng.standard_normal((b, tc, h, d)).astype(np.float32)
            for kk in ("k", "v")}
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32)
               for _ in range(3))
    jpos = jnp.asarray(pos, jnp.int32) if isinstance(pos, list) else pos
    want, want_c = jseq.update_cache_and_attend(
        {kk: jnp.asarray(a) for kk, a in bufs.items()}, jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v), jpos)
    cache = {kk: torch.from_numpy(a.copy()) for kk, a in bufs.items()}
    tpos = torch.tensor(pos) if isinstance(pos, list) else pos
    got = tseq.dense_update_cache_and_attend(
        cache, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        tpos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for kk in ("k", "v"):
        np.testing.assert_array_equal(cache[kk].numpy(),
                                      np.asarray(want_c[kk]))


def test_dense_engine_streams_match_jax_engine_and_generate(weights):
    lm, params = weights
    want, _ = _jax_serve(lm, params, PROMPTS, N_NEW)
    got, engine = _serve(_port_model(params), PROMPTS, N_NEW)
    assert want == [_solo(lm, params, p, N_NEW) for p in PROMPTS]
    assert got == want
    assert engine.kv_stats() == {} and not engine.prefix_enabled


def test_legacy_prefix_store_hits_with_parity(weights):
    """Prompts sharing a 4-token prefix through the dense engine's prefix
    store (private pool, block copies): the port hits where the JAX
    engine hits, caches the same blocks, and both decode the solo
    ``generate()`` streams."""
    lm, params = weights
    shared = [3, 5, 2, 9]
    prompts = [np.array(shared + tail)
               for tail in ([1], [4, 4], [8, 2, 7], [6])]
    kw = dict(prefix_cache_blocks=8, prefix_block_size=2)

    def run(engine, sched_cls):
        sched = sched_cls(engine)
        first = sched.submit(prompts[0], N_NEW)
        sched.step()                      # the donor admits alone first
        reqs = [first] + [sched.submit(p, N_NEW) for p in prompts[1:]]
        sched.run_until_idle()
        return [list(map(int, r.output)) for r in reqs]

    jeng = JaxEngine(lm, params, **DENSE, **kw)
    want = run(jeng, JaxScheduler)
    peng = ServingEngine(_port_model(params), device="cpu", paged=False,
                         **DENSE, **kw)
    got = run(peng, FCFSScheduler)
    assert got == want == [_solo(lm, params, p, N_NEW) for p in prompts]
    jst, pst = jeng.prefix_stats(), peng.prefix_stats()
    assert pst["hits"] >= 3
    for key in ("hits", "misses", "inserted_blocks", "used_blocks"):
        assert pst[key] == jst[key], key
    # the store holds the donor's KV: the first cached block equals the
    # rows its prefill wrote (slot 0, rows 0..1) in every layer
    node = next(iter(peng.prefix_cache._root.children.values()))
    for st, c in zip(peng._store, peng.caches):
        torch.testing.assert_close(st["k"][node.block], c["k"][0, 0:2])


def test_prefix_insert_gate_and_abort(weights):
    """``prefix_min_insert_blocks`` skips prompts adding too few new
    blocks, and an insert whose copy fails gives its blocks back."""
    from chainermn_torch.resilience import FaultInjector
    from chainermn_torch.resilience.cutpoints import SERVING_PREFIX_COPY

    _, params = weights
    engine = ServingEngine(_port_model(params), device="cpu", paged=False,
                           prefix_cache_blocks=8, prefix_block_size=2,
                           prefix_min_insert_blocks=3, **DENSE)
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3, 4, 5]), 2)       # 2 full blocks < 3
    sched.run_until_idle()
    assert engine.prefix_cache.inserted_blocks == 0
    inj = FaultInjector()
    inj.arm(SERVING_PREFIX_COPY, times=1)
    with inj:
        sched.submit(np.array([1, 2, 3, 4, 5, 6, 7]), 2)
        sched.run_until_idle()
    assert inj.fired_log
    assert engine.prefix_cache.inserted_blocks == 0
    assert engine.prefix_cache.pool.free_blocks == 8


@pytest.mark.parametrize("eos_id", [None, 5])
def test_cacheless_generate_matches_jax(weights, eos_id):
    lm, params = weights
    prompt = np.array([[3, 5, 2, 7], [1, 2, 3, 4]])
    want = np.asarray(jax_generate(lm, params, jnp.asarray(prompt), 9,
                                   use_cache=False, eos_id=eos_id))
    model = _port_model(params, attention="flash")
    got = generate(model, prompt, 9, use_cache=False, eos_id=eos_id)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        generate(model, prompt, 9, eos_id=eos_id).numpy(), want)


# (temperature, top_k, top_p)
SAMPLERS = [(0.7, 3, 1.0), (1.0, 0, 0.6), (1.3, 5, 0.8), (0.5, 1, 1.0)]


@pytest.mark.parametrize("temperature,top_k,top_p", SAMPLERS,
                         ids=["top_k3", "top_p0.6", "k5_p0.8", "top_k1"])
def test_sampler_masks_match_jax(temperature, top_k, top_p):
    """On fixed logits, every token JAX's ``_sampler`` draws lies inside
    the port's ``filter_logits`` support, every token of that support is
    drawn, and the draw frequencies follow the port's filtered softmax."""
    rng = np.random.default_rng(4)
    lg = (rng.standard_normal((3, 12)) * 2).astype(np.float32)
    lg[1, 4] = lg[1, 7]                        # a tie at the top-k edge
    sample = jax_sampler(temperature, top_k, top_p)
    keys = jax.random.split(jax.random.PRNGKey(0), 6000)
    draws = np.asarray(jax.vmap(lambda key: sample(jnp.asarray(lg),
                                                   key)[0])(keys))
    filt = filter_logits(torch.from_numpy(lg), temperature, top_k, top_p)
    probs = torch.softmax(filt, dim=-1).numpy()
    for row in range(lg.shape[0]):
        counts = np.bincount(draws[:, row], minlength=lg.shape[1])
        support = np.isfinite(filt[row].numpy())
        assert not counts[~support].any()
        assert (counts[support & (probs[row] > 0.01)] > 0).all()
        np.testing.assert_allclose(counts / len(keys), probs[row],
                                   atol=0.03)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_watchdog_and_cut_points_wrap_the_device_calls(weights, paged):
    """``watchdog=`` arms a window around every prefill and decode call
    (report-only here), and an injected ``serving.decode`` fault errors
    the in-flight requests and, with ``restart_on_error=False``, re-raises
    from the step (the default warm-restarts instead:
    ``test_torch_serving_restart.py``)."""
    from chainermn_torch.extensions.profiling import Watchdog
    from chainermn_torch.monitor import get_event_log
    from chainermn_torch.resilience import FaultInjector
    from chainermn_torch.resilience.cutpoints import SERVING_DECODE
    from chainermn_torch.serving import EngineFailed

    _, params = weights
    kw = dict(DENSE, kv_block_size=2) if paged else DENSE
    engine = ServingEngine(_port_model(params), device="cpu", paged=paged,
                           watchdog=Watchdog(timeout=60, on_timeout="warn"),
                           **kw)
    sched = FCFSScheduler(engine, restart_on_error=False)
    log = get_event_log()
    # the ring is bounded and shared with every earlier test in this
    # process: mark the start by sequence number, not by length
    before = log.tail(1)
    i0 = before[0]["i"] if before else -1
    req = sched.submit(PROMPTS[0], 3)
    sched.run_until_idle()
    labels = {e.get("label") for e in log.tail()
              if e["i"] > i0 and e["kind"] == "watchdog_arm"}
    assert {"serving prefill", "serving decode_step"} <= labels
    assert req.state.value == "done"
    inj = FaultInjector()
    inj.arm(SERVING_DECODE, times=1)
    with inj:
        doomed = sched.submit(PROMPTS[1], 4)
        with pytest.raises(Exception):
            sched.run_until_idle()
    assert isinstance(doomed.error, EngineFailed)
    assert engine.free_slots == set(range(engine.n_slots))
