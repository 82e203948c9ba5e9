"""Speculative decoding, decode windows and the verify window's paged
read against the JAX package on the same flax weights, f32, on the CPU
(mirrors ``tests/serving_tests/test_speculative.py`` but its
tensor-parallel case).

Greedy streams must equal the JAX speculative engine's, the port's
non-speculative engine's and solo ``generate()``; with the same drafts the
accept accounting must equal the JAX engine's too. Sampled streams are
held inside the port: a decode window must draw what the per-token steps
draw. The JAX engines run without ``warmup()``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.parallel import sequence as jseq
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_tpu.serving import SpeculativeConfig as JaxSpec
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_event_log
from chainermn_torch.parallel import sequence as tseq
from chainermn_torch.parallel.paged_kernel import paged_attend
from chainermn_torch.serving import (
    FCFSScheduler,
    ServingEngine,
    SpeculativeConfig,
)
from chainermn_torch.serving.prefix_cache import PrefixCacheIndex
from chainermn_torch.serving.speculative import NgramDrafter

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
DRAFT_CFG = dict(vocab_size=17, d_model=8, n_heads=2, n_layers=1,
                 max_len=48)
ENGINE = dict(n_slots=3, prefill_buckets=(4, 8), prefill_batch=2,
              kv_block_size=2, cache_len=32)
JOBS = [(np.array([1, 2, 3]), 6), (np.array([4, 5, 6, 7, 8]), 4),
        (np.array([9, 10]), 7), (np.array([11, 12, 13, 14]), 5),
        (np.array([2, 4, 6, 8, 10, 12, 14, 16]), 3), (np.array([5]), 8)]


def _init(cfg, seed):
    lm = JaxLM(**cfg, compute_dtype=jnp.float32)
    return lm, lm.init(jax.random.PRNGKey(seed),
                       jnp.asarray([[1, 2, 3]], jnp.int32))


@pytest.fixture(scope="module")
def weights():
    return _init(CFG, 0)


@pytest.fixture(scope="module")
def draft_weights():
    return _init(DRAFT_CFG, 1)


def _port(params, cfg=CFG):
    model = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


@pytest.fixture(scope="module")
def solo(weights):
    lm, params = weights
    cache = {}

    def get(prompt, n):
        key = (tuple(int(t) for t in prompt), n)
        if key not in cache:
            cache[key] = [int(t) for t in np.asarray(jax_generate(
                lm, params, jnp.asarray(prompt, jnp.int32)[None], n)[0])]
        return cache[key]

    return get


def _engine(model, spec=None, **kw):
    return ServingEngine(model, device="cpu", speculative=spec,
                         **dict(ENGINE, **kw))


def _run(engine, jobs, sched_cls=FCFSScheduler, **sched_kw):
    sched = sched_cls(engine, **sched_kw)
    reqs = [sched.submit(p, n) for p, n in jobs]
    sched.run_until_idle()
    assert all(r.finished for r in reqs)
    return [list(map(int, r.output)) for r in reqs], sched


def _pool_whole(engine):
    pool = engine._pool
    return (engine.active_slots == 0
            and int(engine._slot_reserved.sum()) == 0
            and pool.free_blocks + engine.prefix_cache.evictable_blocks()
            == pool.capacity)


def test_speculative_config_validation(weights):
    _, params = weights
    model = _port(params)
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeConfig(k=0).validate()
    with pytest.raises(ValueError, match="drafter must be"):
        SpeculativeConfig(drafter="oracle").validate()
    with pytest.raises(ValueError, match="draft_model"):
        SpeculativeConfig(drafter="draft").validate()
    with pytest.raises(ValueError, match="ngram_min"):
        SpeculativeConfig(ngram_min=3, ngram_max=2).validate()
    spec = SpeculativeConfig(k=2)
    base = dict(n_slots=1, prefill_len=4, device="cpu")
    with pytest.raises(ValueError, match="paged"):
        ServingEngine(model, paged=False, speculative=spec, **base)
    with pytest.raises(ValueError, match="greedy-only"):
        ServingEngine(model, speculative=spec, temperature=0.7, **base)
    with pytest.raises(ValueError, match="mutually"):
        ServingEngine(model, speculative=spec, decode_window=3, **base)
    with pytest.raises(ValueError, match="decode_window"):
        ServingEngine(model, paged=False, decode_window=0, **base)


def test_ngram_lookup_prefers_longest_and_most_recent():
    class _Eng:
        n_slots = 1
    d = NgramDrafter(SpeculativeConfig(k=4, ngram_max=3), _Eng())
    assert d._lookup([2, 3, 9, 9, 2, 3, 7, 2, 3], 2) == [7, 2]
    assert d._lookup([3, 7, 2, 5, 7, 2, 3, 7, 2], 1) == [5]
    assert d._lookup([1, 2, 3], 2) == []


def test_trie_ngram_continuation_reads_without_pinning():
    trie = PrefixCacheIndex(16, 2)
    trie.insert_shared(np.array([1, 2, 3, 4, 5, 6]), [1, 2, 3])
    hits0, miss0 = trie.hits, trie.misses
    assert trie.ngram_continuation([1, 2, 3], 2) == [4, 5]
    assert trie.ngram_continuation([1, 2], 3) == [3, 4, 5]
    assert trie.ngram_continuation([7, 8], 2) is None
    assert (trie.hits, trie.misses) == (hits0, miss0)
    assert trie.evictable_blocks() == 3


@pytest.fixture(scope="module")
def jax_ngram(weights):
    """The JAX speculative engine's streams and accept accounting on
    JOBS (k = 3, staggered by the scheduler's one prefill a step)."""
    lm, params = weights
    engine = JaxEngine(lm, params, paged=True, speculative=JaxSpec(k=3),
                       **ENGINE)
    streams, _ = _run(engine, JOBS, JaxScheduler)
    return streams, engine.spec_stats()


@pytest.mark.parametrize("paged_kernel", [False, True],
                         ids=["plain_read", "kernel_read"])
def test_spec_ngram_staggered_ragged_parity(weights, solo, jax_ngram,
                                            paged_kernel):
    """Ragged prompts, staggered admissions, slots retired and reused:
    the n-gram speculative stream equals the JAX speculative engine's,
    the port's plain engine's and solo ``generate()``; the drafts (and so
    the accept counts) equal the JAX engine's; the scheduler's metrics
    equal the engine's counters; the pool comes back whole."""
    _, params = weights
    model = _port(params)
    want, jstats = jax_ngram
    engine = _engine(model, SpeculativeConfig(k=3),
                     paged_kernel=paged_kernel)
    got, sched = _run(engine, JOBS)
    plain, _ = _run(_engine(model), JOBS)
    assert got == want == plain == [solo(p, n) for p, n in JOBS]
    stats = engine.spec_stats()
    for key in ("spec_tokens_proposed", "spec_tokens_accepted"):
        assert stats[key] == jstats[key], key
    assert stats["spec_tokens_proposed"] > 0
    m = sched.metrics.report()
    assert m["spec_tokens_proposed"] == stats["spec_tokens_proposed"]
    assert m["spec_tokens_accepted"] == stats["spec_tokens_accepted"]
    assert 0.0 <= m["spec_accept_rate"] <= 1.0
    assert "spec_accept_length_mean" in m
    assert _pool_whole(engine)


def test_spec_draft_model_parity(weights, draft_weights, solo):
    """The draft-model drafter on converted weights: the same streams as
    solo ``generate()`` and the same drafts (accept counts) as the JAX
    draft-model engine on the same draft weights."""
    lm, params = weights
    dlm, dparams = draft_weights
    jeng = JaxEngine(lm, params, paged=True, **ENGINE,
                     speculative=JaxSpec(k=3, drafter="draft",
                                         draft_model=dlm,
                                         draft_params=dparams))
    want, _ = _run(jeng, JOBS, JaxScheduler)
    spec = SpeculativeConfig(k=3, drafter="draft",
                             draft_model=_port(dparams, DRAFT_CFG))
    engine = _engine(_port(params), spec)
    got, _ = _run(engine, JOBS)
    assert got == want == [solo(p, n) for p, n in JOBS]
    js, ps = jeng.spec_stats(), engine.spec_stats()
    for key in ("spec_tokens_proposed", "spec_tokens_accepted"):
        assert ps[key] == js[key], key
    assert _pool_whole(engine)


class _ScriptedDrafter:
    """Proposes each request's own solo continuation (the oracle: every
    draft accepted) or that continuation shifted by one (every draft
    rejected)."""

    def __init__(self, engine, refs, wrong=False):
        self.engine = engine
        self.wrong = wrong
        self.refs = {tuple(r[:lp]): r for r, lp in refs}
        self._seq, self._done = {}, {}

    def on_admit(self, slot, prompt, first_token):
        ref = self.refs[tuple(int(t) for t in prompt)]
        assert first_token == ref[len(prompt)]
        self._seq[slot] = ref[len(prompt):]
        self._done[slot] = 1

    def on_commit(self, slot, tokens):
        self._done[slot] += len(tokens)

    def on_release(self, slot):
        self._seq.pop(slot, None)
        self._done.pop(slot, None)

    def reset(self):
        self._seq.clear()
        self._done.clear()

    def propose(self, k):
        out = np.zeros((self.engine.n_slots, k), np.int32)
        for slot, seq in self._seq.items():
            nxt = seq[self._done[slot]:self._done[slot] + k]
            nxt = nxt + [0] * (k - len(nxt))
            if self.wrong:
                nxt = [(t + 1) % CFG["vocab_size"] for t in nxt]
            out[slot, :] = nxt
        return out


def _scripted_engine(params, solo, jobs, wrong, **kw):
    engine = _engine(_port(params), SpeculativeConfig(k=3), **kw)
    engine._drafter = _ScriptedDrafter(
        engine, [(solo(p, n), len(p)) for p, n in jobs], wrong=wrong)
    return engine


@pytest.mark.parametrize("wrong", [False, True],
                         ids=["oracle_accepts_all", "wrong_accepts_none"])
def test_scripted_drafters_accept_all_or_none(weights, solo, wrong):
    """A perfect drafter commits k + 1 tokens a window (accept rate 1.0);
    an always-wrong one commits one (accept rate 0.0). Both give the
    exact greedy stream. max_new = 9 = two windows of k + 1 plus one."""
    _, params = weights
    jobs = [(np.array([1, 2, 3]), 9), (np.array([4, 5, 6, 7]), 9)]
    engine = _scripted_engine(params, solo, jobs, wrong)
    got, _ = _run(engine, jobs)
    assert got == [solo(p, n) for p, n in jobs]
    st = engine.spec_stats()
    assert st["spec_tokens_proposed"] > 0
    assert st["spec_tokens_accepted"] == (0 if wrong
                                          else st["spec_tokens_proposed"])
    assert _pool_whole(engine)


def test_eos_inside_verify_window_retires_and_discards_tail(weights, solo):
    _, params = weights
    prompt = np.array([1, 2, 3])
    gen = solo(prompt, 8)[len(prompt):]
    eos = gen[1]
    engine = _scripted_engine(params, solo, [(prompt, 8)], wrong=False)
    sched = FCFSScheduler(engine, eos_id=eos)
    req = sched.submit(prompt, 8)
    sched.run_until_idle()
    assert req.tokens == gen[:gen.index(eos) + 1]
    assert engine.active_slots == 0 and _pool_whole(engine)


def test_rejected_rows_roll_back_and_shared_prefix_survives(weights, solo):
    """An always-wrong drafter makes every window append blocks for its
    drafts and roll the unused ones back; the trie-shared prefix blocks
    stay valid, so a follower admitted after the rollbacks hits them and
    still decodes the solo stream."""
    _, params = weights
    shared = [1, 2, 3, 4, 5, 6]
    jobs = [(np.array(shared + [7]), 8), (np.array(shared + [9]), 8)]
    follower = (np.array(shared + [8]), 6)
    engine = _scripted_engine(params, solo, jobs + [follower], wrong=True)
    log = get_event_log()
    before = sum(e["kind"] == "spec_rollback" for e in log.tail(4096))
    got, sched = _run(engine, jobs)
    assert got == [solo(p, n) for p, n in jobs]
    after = sum(e["kind"] == "spec_rollback" for e in log.tail(4096))
    assert after > before
    assert int(engine._slot_reserved.sum()) == 0
    hits0 = engine.prefix_cache.hits
    req = sched.submit(*follower)
    sched.run_until_idle()
    assert list(map(int, req.output)) == solo(*follower)
    assert engine.prefix_cache.hits > hits0
    assert _pool_whole(engine)


def test_spec_headroom_reserved_and_returned(weights):
    _, params = weights
    model = _port(params)
    plain = _engine(model)
    spec = _engine(model, SpeculativeConfig(k=3))
    assert spec._spec_headroom == 2          # ceil(3 / 2)
    assert (spec.blocks_needed(5, 4)
            == plain.blocks_needed(5, 4) + spec._spec_headroom)
    sched = FCFSScheduler(spec)
    req = sched.submit(np.array([1, 2, 3]), 4)
    sched.step()
    assert req.slot >= 0
    assert int(spec._slot_reserved[req.slot]) >= spec._spec_headroom
    sched.run_until_idle()
    assert spec.kv_stats()["blocks_reserved"] == 0


def test_spec_int8_matches_jax_int8_and_plain_int8(weights):
    """int8 stores: the speculative stream equals the JAX speculative
    int8 engine's and the port's non-speculative int8 engine's (both read
    the same quantized rows)."""
    lm, params = weights
    jobs = JOBS[:4]
    jeng = JaxEngine(lm, params, paged=True, kv_quant="int8",
                     speculative=JaxSpec(k=3), **ENGINE)
    want, _ = _run(jeng, jobs, JaxScheduler)
    model = _port(params)
    got, _ = _run(_engine(model, SpeculativeConfig(k=3), kv_quant="int8",
                          paged_kernel=True), jobs)
    plain, _ = _run(_engine(model, kv_quant="int8"), jobs)
    assert got == want == plain


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_window_greedy_parity(weights, solo, paged):
    """decode_window=4 commits four tokens a call; the stream equals solo
    ``generate()`` and the JAX window engine's."""
    lm, params = weights
    kw = dict(ENGINE) if paged else {
        k: v for k, v in ENGINE.items() if k != "kv_block_size"}
    jeng = JaxEngine(lm, params, paged=paged, decode_window=4, **kw)
    want, _ = _run(jeng, JOBS, JaxScheduler)
    engine = ServingEngine(_port(params), device="cpu", paged=paged,
                           decode_window=4, **kw)
    got, _ = _run(engine, JOBS)
    assert got == want == [solo(p, n) for p, n in JOBS]
    if paged:
        assert _pool_whole(engine)


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_decode_window_sampled_stream_equals_per_token(weights, paged):
    """temperature 0.8, top_k 5: each window step draws from the slot's
    own generator exactly as a per-token step would, so the window
    stream equals the per-token stream for the same seeds."""
    _, params = weights
    model = _port(params)
    kw = dict(ENGINE) if paged else {
        k: v for k, v in ENGINE.items() if k != "kv_block_size"}

    def serve(window):
        engine = ServingEngine(model, device="cpu", paged=paged,
                               decode_window=window, temperature=0.8,
                               top_k=5, **kw)
        sched = FCFSScheduler(engine)
        reqs = [sched.submit(p, n + 3, seed=40 + i)
                for i, (p, n) in enumerate(JOBS)]
        sched.run_until_idle()
        return [r.tokens for r in reqs]

    per_token = serve(1)
    assert serve(4) == per_token
    assert serve(3) == per_token


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
def test_verify_window_at_cache_len_reads_inside_the_table(quant):
    """A k + 1 = 5 window of a slot whose last valid row is the last row
    of ``cache_len`` (valid = 2): its lengths run past the table's width,
    the rows past valid go to the scratch block, and the rows that matter
    (j < valid) equal the JAX path's — through the plain version and the
    kernel wrapper's CPU route, with the table cut to its width."""
    rng = np.random.default_rng(9)
    b, s, h, d, bs, n_max = 3, 5, 2, 8, 4, 4
    cache_len = bs * n_max - 1                 # 15: a ragged last block
    n_blocks = 1 + b * n_max
    table = (1 + np.arange(b * n_max, dtype=np.int32)).reshape(b, n_max)
    pos = np.array([cache_len - 2, 3, 0], np.int32)
    valid = np.array([2, 5, 0], np.int32)
    rows = {kk: rng.standard_normal((b, s, h, d)).astype(np.float32)
            for kk in ("q", "k", "v")}
    if quant:
        store = {kk: rng.integers(-127, 128, (n_blocks, bs, h, d),
                                  dtype=np.int8) for kk in ("k", "v")}
        store.update({kk: rng.random((n_blocks, bs, h)).astype(np.float32)
                      for kk in ("k_scale", "v_scale")})
    else:
        store = {kk: rng.standard_normal((n_blocks, bs, h, d))
                 .astype(np.float32) for kk in ("k", "v")}
    want, want_store = jseq.paged_update_cache_and_attend(
        dict({kk: jnp.asarray(a) for kk, a in store.items()},
             table=jnp.asarray(table), valid=jnp.asarray(valid)),
        *(jnp.asarray(rows[kk]) for kk in ("q", "k", "v")),
        jnp.asarray(pos))
    for use_kernel in (False, True):
        cache = {kk: torch.from_numpy(a.copy()) for kk, a in store.items()}
        got = tseq.paged_update_cache_and_attend(
            dict(cache, table=torch.from_numpy(table),
                 valid=torch.from_numpy(valid), max_blocks=n_max,
                 use_kernel=use_kernel),
            *(torch.from_numpy(rows[kk]) for kk in ("q", "k", "v")),
            torch.from_numpy(pos))
        tol = 1e-4 if quant else 1e-5
        for row in range(b):
            j = int(valid[row]) if row < 2 else s
            np.testing.assert_allclose(got[row, :j].numpy(),
                                       np.asarray(want)[row, :j],
                                       atol=tol, rtol=tol)
        for kk in store:
            np.testing.assert_array_equal(
                cache[kk][1:].numpy(), np.asarray(want_store[kk])[1:])
    # the wrapper's own lengths: the slot's run past n_max * bs
    lengths = torch.from_numpy(pos.astype(np.int64) + s)
    assert int(lengths[0]) > n_max * bs
    if not quant:
        cache = {kk: torch.from_numpy(a) for kk, a in store.items()}
        q = torch.from_numpy(rows["q"])
        out = paged_attend(q, cache["k"], cache["v"],
                           torch.from_numpy(table), lengths)
        assert torch.isfinite(out).all()
