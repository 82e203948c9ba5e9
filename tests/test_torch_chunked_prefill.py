"""Chunked prefill against the JAX package on the same flax weights, f32,
on the CPU (mirrors ``tests/serving_tests/test_chunked_prefill.py``):
a long prompt prefills ``chunk_tokens_per_step`` tokens a scheduler step,
interleaved with decode rounds, and still decodes the unchunked stream.

One module engine each side is shared by the tests, as in the reference:
each test drains its requests, and the trie persists on purpose (the
prefix-hit case). The JAX engine runs without ``warmup()``.
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
from chainermn_torch.models import TransformerLM
from chainermn_torch.serving import FCFSScheduler, RequestState, ServingEngine

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
ENGINE = dict(n_slots=2, prefill_buckets=(4, 8, 16), prefill_batch=2,
              paged=True, kv_block_size=2, kv_blocks=64, cache_len=48)
PROMPT = np.asarray([1, 4, 2, 7, 3, 5, 6, 2, 9, 4, 1, 3], np.int32)
N_NEW = 6


@pytest.fixture(scope="module")
def weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params


@pytest.fixture(scope="module")
def engine(weights):
    _, params = weights
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    eng = ServingEngine(model, device="cpu", **ENGINE)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def jax_engine(weights):
    lm, params = weights
    return JaxEngine(lm, params, **ENGINE)


@pytest.fixture(scope="module")
def ref_tail(weights):
    lm, params = weights
    solo = np.asarray(jax_generate(lm, params, jnp.asarray(PROMPT)[None],
                                   N_NEW)[0])
    return [int(t) for t in solo[len(PROMPT):]]


def drive(sched, reqs, steps=400):
    for _ in range(steps):
        sched.step()
        if all(r.finished for r in reqs):
            return
    raise AssertionError([(r.state, r.error) for r in reqs])


def _pool_whole(engine):
    pool = engine._pool
    assert engine.active_slots == 0 and not engine._chunking
    assert engine.free_slots == set(range(engine.n_slots))
    assert int(engine._slot_reserved.sum()) == 0
    assert pool.free_blocks + engine.prefix_cache.evictable_blocks() \
        == pool.capacity


def test_unchunked_baseline_parity(engine, ref_tail):
    s = FCFSScheduler(engine)
    r = s.submit(PROMPT, N_NEW)
    drive(s, [r])
    assert r.tokens == ref_tail
    _pool_whole(engine)


def _solo_tail(weights, prompt, n):
    lm, params = weights
    out = np.asarray(jax_generate(lm, params, jnp.asarray(prompt)[None],
                                  n)[0])
    return [int(t) for t in out[len(prompt):]]


@pytest.mark.parametrize("chunk_tokens", [1, 3, 4, 5])
def test_chunked_parity(engine, jax_engine, weights, chunk_tokens):
    """chunk 1 (every token its own step), 3 (odd, straddling the 2-token
    blocks), 4 (block-aligned), 5: the same tokens as solo ``generate()``
    and the JAX chunked scheduler, one prefill call a chunk. Each size
    gets a prompt the trie has not seen, so every chunk really runs."""
    prompt = np.concatenate([[10 + chunk_tokens], PROMPT[1:]]).astype(
        np.int32)
    plan = engine.plan_admission(prompt, max_new=N_NEW)
    chunks = engine.plan_chunks(plan, chunk_tokens)
    engine.cancel_plan(plan)
    assert plan.start == 0 and len(chunks) == -(-len(prompt)
                                                // chunk_tokens)
    s = FCFSScheduler(engine, chunk_tokens_per_step=chunk_tokens)
    r = s.submit(prompt, N_NEW)
    chunks0 = engine._c_chunks.value
    drive(s, [r])
    js = JaxScheduler(jax_engine, chunk_tokens_per_step=chunk_tokens)
    jr = js.submit(prompt, N_NEW)
    drive(js, [jr])
    assert r.tokens == jr.tokens == _solo_tail(weights, prompt, N_NEW)
    assert engine._c_chunks.value - chunks0 == len(chunks)
    _pool_whole(engine)


def test_prefix_hit_mid_chunk(engine, weights):
    """A prompt sharing PROMPT's first three blocks (cached by the
    baseline run) plus a fresh tail: the plan starts past 0 and the
    chunks cover only the uncached tail."""
    prompt = np.concatenate([PROMPT[:6],
                             [8, 6, 4, 2, 9, 7, 5, 3, 1, 16]]).astype(
        np.int32)
    plan = engine.plan_admission(prompt, max_new=N_NEW)
    start = plan.start
    engine.cancel_plan(plan)
    assert start > 0, "expected a prefix hit from the earlier runs"
    s = FCFSScheduler(engine, chunk_tokens_per_step=3)
    r = s.submit(prompt, N_NEW)
    s.step()
    st = engine.chunk_state(r.slot)
    assert st is not None and st.start == start and st.chunks[0][0] == start
    drive(s, [r])
    assert r.tokens == _solo_tail(weights, prompt, N_NEW)
    _pool_whole(engine)


def test_chunked_interleaves_with_short_request(engine, ref_tail, weights):
    """A short request (one chunk's worth, so admitted unchunked) decodes
    while the long one is still chunking; both streams are solo
    ``generate()``'s."""
    lm, params = weights
    short = np.array([2, 3])
    want_short = [int(t) for t in np.asarray(jax_generate(
        lm, params, jnp.asarray(short)[None], 8)[0])[2:]]
    fresh = np.asarray([5, 1, 6, 2, 7, 3, 8, 4, 9, 5, 1, 6], np.int32)
    want_long = [int(t) for t in np.asarray(jax_generate(
        lm, params, jnp.asarray(fresh)[None], N_NEW)[0])[len(fresh):]]
    s = FCFSScheduler(engine, chunk_tokens_per_step=2)
    rl = s.submit(fresh, N_NEW)
    rs = s.submit(short, 8)
    overlap = False
    for _ in range(400):
        s.step()
        overlap |= (rl.state is RequestState.PREFILLING
                    and len(rs.tokens) > 1)
        if rl.finished and rs.finished:
            break
    assert overlap, "the short request never decoded during the chunks"
    assert rl.tokens == want_long
    assert rs.tokens == want_short
    _pool_whole(engine)


def test_cancel_mid_chunk_releases_slot(engine, ref_tail):
    fresh = np.asarray([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8], np.int32)
    s = FCFSScheduler(engine, chunk_tokens_per_step=1)
    r = s.submit(fresh, N_NEW)
    s.step()                                   # admits + first chunk only
    assert r.state is RequestState.PREFILLING
    s.cancel(r)
    for _ in range(10):                        # released on the driving
        s.step()                               # thread
    assert r.state is RequestState.CANCELLED
    _pool_whole(engine)
    r2 = s.submit(PROMPT, N_NEW)
    drive(s, [r2])
    assert r2.tokens == ref_tail
