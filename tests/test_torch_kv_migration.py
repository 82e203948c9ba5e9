"""KV block migration on the port's engine, held to the JAX package on the
CPU (the port of ``tests/serving_tests/test_kv_migration.py``): a
prefilled slot's blocks leave one engine as a host payload through its
``kv_gather_{w}`` program and land in another through ``kv_scatter_{w}``,
and the decode continues token for token as JAX ``generate()`` does on
the same flax weights. The exported rows match the JAX engine's within
1e-5, and a payload the JAX engine exported continues in the port's
engine through ``interop.kv_payload_from_jax``.

Also pinned: ``alloc_blocks_atomic`` and the share-import refcounts,
``can_import``'s static-versus-transient split, the pool-exhaustion
rollback, the fused transfer against the per-block one bit for bit, the
scheduler's handover of the same ``Request`` (and its fallback to
decoding in place), speculative and windowed destinations, int8 rows
with chunked prefill and as a shared prefix, and the migration programs:
one build each at the reference's widths, the store's addresses
unchanged across an import.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_torch.interop import kv_payload_from_jax, params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_registry
from chainermn_torch.serving import (
    BlockPool,
    FCFSScheduler,
    ServingEngine,
    SpeculativeConfig,
)
from chainermn_torch.serving.prefix_cache import PrefixCacheIndex

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

PROMPT = np.asarray([1, 4, 2, 7, 3, 5, 6, 2, 9, 4, 1, 3], np.int32)
RNG = jax.random.PRNGKey(7)
N_NEW = 6
CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
ENGINE = dict(n_slots=2, prefill_buckets=(4, 8, 16), prefill_batch=2,
              paged=True, kv_block_size=2, kv_blocks=64, cache_len=48)
ROW_TOL = 1e-5


@pytest.fixture(scope="module")
def jax_weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    return lm, lm.init(jax.random.PRNGKey(0),
                       jnp.asarray([[1, 2, 3]], jnp.int32))


@pytest.fixture(scope="module")
def state(jax_weights):
    return params_from_flax(jax.device_get(jax_weights[1]))


def build(state, **kw):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(state)
    eng = ServingEngine(model, device="cpu", capture=False,
                        **dict(ENGINE, **kw))
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def engines(state):
    return build(state), build(state)


@pytest.fixture(scope="module")
def jax_engine(jax_weights):
    lm, params = jax_weights
    eng = JaxEngine(lm, params, **ENGINE)
    eng.warmup()
    return eng


@pytest.fixture(scope="module")
def ref_tail(jax_weights):
    lm, params = jax_weights
    solo = np.asarray(jax_generate(lm, params, jnp.asarray(PROMPT)[None],
                                   N_NEW, rng=RNG)[0])
    return [int(t) for t in solo[len(PROMPT):]]


def pump(eng):
    for s in range(eng.n_slots):
        while eng.slot_needs_block(s):
            assert eng.append_block(s)
    return eng.decode_round()


def _prefill_on(eng):
    (slot, first), = eng.admit_batch([eng.plan_admission(PROMPT,
                                                         max_new=N_NEW)])
    return slot, first


def _decode(eng, slot, first):
    toks = [first]
    while len(toks) < N_NEW:
        toks.extend(pump(eng)[slot])
    return toks[:N_NEW]


def _drain_pool(eng):
    """Every allocatable block, free and trie-evictable alike."""
    held = []
    while True:
        got = eng.prefix_cache.alloc_blocks_atomic(1)
        if got is None:
            return held
        held.extend(got)


def _counter(name):
    return sum(v for k, v in get_registry().snapshot()["counters"].items()
               if k.startswith(name))


# --------------------------------------------------------------------- #
# the host pool                                                          #
# --------------------------------------------------------------------- #


def test_alloc_blocks_atomic_success_and_rollback():
    pool = BlockPool(6, reserve_scratch=True)            # 5 allocatable
    idx = PrefixCacheIndex(2, pool=pool)
    got = idx.alloc_blocks_atomic(3)
    assert got is not None and len(got) == 3
    assert pool.free_blocks == 2
    assert idx.alloc_blocks_atomic(3) is None           # nothing sticks
    assert pool.free_blocks == 2
    for b in got:
        pool.decref(b)
    assert pool.free_blocks == pool.capacity


def test_share_import_refcounts(engines):
    """The share-import case of ``insert_shared``: each adopted block
    settles at refcount 1, held by the trie, and a block whose position
    was cached meanwhile goes straight back to the free list."""
    src, dst = engines
    slot, _ = _prefill_on(src)
    src.release(slot)
    payload = src.export_prefix_kv(PROMPT, min_blocks=2)
    assert payload["n_blocks"] == 5              # (12 - 1) // 2 blocks
    dst.restart()                                # an empty trie and pool
    # two of the five blocks are cached on the destination already
    (s2, _), = dst.admit_batch([dst.plan_admission(PROMPT[:4], max_new=1)])
    dst.release(s2)
    free0 = dst._pool.free_blocks
    assert dst.import_prefix_kv(payload) == 3
    assert dst._pool.free_blocks == free0 - 3      # the 2 duplicates freed
    match = dst.prefix_cache.match(PROMPT)
    try:
        assert len(match.block_ids) == 5
        assert all(dst._pool.refs(b) == 1 for b in match.block_ids)
    finally:
        dst.prefix_cache.release(match)
    assert dst.import_prefix_kv(payload) == 0      # resident: nothing to do


# --------------------------------------------------------------------- #
# engine-level export and import                                         #
# --------------------------------------------------------------------- #


def test_export_import_parity(engines, jax_engine, ref_tail):
    """The port's exported rows equal the JAX engine's for the same
    prompt within 1e-5, and the imported request decodes JAX
    ``generate()``'s tokens on the destination."""
    src, dst = engines
    slot_a, first = _prefill_on(src)
    payload = src.export_slot_kv(slot_a)
    plan = jax_engine.plan_admission(PROMPT, rng=RNG, max_new=N_NEW)
    (slot_j, _), = jax_engine.admit_batch([plan])
    want = jax_engine.export_slot_kv(slot_j)
    jax_engine.release(slot_j)
    assert payload["n_blocks"] == want["n_blocks"] >= 1
    assert (payload["pos"], payload["token"]) == (want["pos"], want["token"])
    for lp, lw in zip(payload["layers"], want["layers"]):
        assert set(lp) == set(lw)
        for kk in lp:
            np.testing.assert_allclose(lp[kk].numpy(), np.asarray(lw[kk]),
                                       rtol=ROW_TOL, atol=ROW_TOL)
    assert dst.can_import(payload, max_new=N_NEW)
    ptrs = [t.data_ptr() for layer in dst._store for t in layer.values()]
    slot_b = dst.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW)
    assert ptrs == [t.data_ptr() for layer in dst._store
                    for t in layer.values()]
    src.release(slot_a)
    assert _decode(dst, slot_b, first) == ref_tail
    assert src.recompiles == {} and dst.recompiles == {}
    dst.release(slot_b)


def test_jax_exported_payload_continues_in_the_port(engines, jax_engine,
                                                    ref_tail):
    """A payload the JAX engine exported, taken through
    ``kv_payload_from_jax``, lands in the port's engine and the request
    continues token for token."""
    _, dst = engines
    plan = jax_engine.plan_admission(PROMPT, rng=RNG, max_new=N_NEW)
    (slot_j, first), = jax_engine.admit_batch([plan])
    payload = kv_payload_from_jax(jax_engine.export_slot_kv(slot_j))
    jax_engine.release(slot_j)
    assert payload["key"] is None
    assert payload["layers"][0]["k"].dtype == torch.float32
    slot = dst.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW)
    assert _decode(dst, slot, first) == ref_tail
    dst.release(slot)


def test_migration_metrics_counted(engines):
    src, dst = engines
    migs0 = _counter("kv_migrations_total")
    blocks0 = _counter("kv_migrated_blocks_total")
    slot_a, _ = _prefill_on(src)
    payload = src.export_slot_kv(slot_a)
    src.release(slot_a)
    dst.release(dst.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW))
    assert _counter("kv_migrations_total") == migs0 + 1
    assert _counter("kv_migrated_blocks_total") \
        == blocks0 + payload["n_blocks"]
    hist = get_registry().snapshot()["histograms"]
    assert any(k.startswith("migration_seconds") and v["count"] >= 1
               for k, v in hist.items())


def test_can_import_static_vs_transient(engines):
    src, dst = engines
    slot_a, _ = _prefill_on(src)
    payload = src.export_slot_kv(slot_a)
    src.release(slot_a)
    broken = dict(payload, block_size=payload["block_size"] * 2)
    assert not dst.can_import(broken, max_new=1)
    assert not dst.can_import(broken, max_new=1, static_only=True)
    too_far = dict(payload, pos=dst.cache_len)
    assert not dst.can_import(too_far, max_new=1, static_only=True)
    held = _drain_pool(dst)
    try:
        assert not dst.can_import(payload, max_new=N_NEW)
        assert dst.can_import(payload, max_new=N_NEW, static_only=True)
    finally:
        for b in held:
            dst._pool.decref(b)
    assert dst.can_import(payload, max_new=N_NEW)


def test_import_pool_exhaustion_rolls_back(engines, ref_tail):
    """An import that cannot get its blocks raises and leaves the
    destination as it was; the same payload lands once blocks free."""
    src, dst = engines
    slot_a, first = _prefill_on(src)
    payload = src.export_slot_kv(slot_a)
    src.release(slot_a)
    held = _drain_pool(dst)
    free_before = dst._pool.free_blocks
    slots_before = set(dst.free_slots)
    with pytest.raises(RuntimeError, match="exhausted"):
        dst.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW)
    assert dst._pool.free_blocks == free_before
    assert set(dst.free_slots) == slots_before
    for b in held:
        dst._pool.decref(b)
    slot_b = dst.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW)
    assert _decode(dst, slot_b, first) == ref_tail
    dst.release(slot_b)


def test_fused_vs_per_block_bit_equality(engines):
    """The fused gather reads exactly what one width-1 gather a block
    reads, and rows written through the per-block scatter come back
    unchanged through the fused gather."""
    src, dst = engines
    slot_a, _ = _prefill_on(src)
    fused = src.export_slot_kv(slot_a, fused=True)
    ref = src.export_slot_kv(slot_a, fused=False)
    assert fused["n_blocks"] == ref["n_blocks"] >= 2
    for lf, lr in zip(fused["layers"], ref["layers"]):
        for kk in lf:
            assert torch.equal(lf[kk], lr[kk])
    slot_b = dst.import_slot_kv(ref, prompt=PROMPT, max_new=N_NEW,
                                fused=False)
    back = dst.export_slot_kv(slot_b, fused=True)
    assert (back["pos"], back["token"]) == (fused["pos"], fused["token"])
    for lf, lb in zip(fused["layers"], back["layers"]):
        for kk in lf:
            assert torch.equal(lf[kk], lb[kk])
    src.release(slot_a)
    dst.release(slot_b)
    assert src.recompiles == {} and dst.recompiles == {}


def test_migration_programs_built_once_at_the_reference_widths(
        engines, jax_engine):
    """``kv_gather_{w}``/``kv_scatter_{w}`` at the JAX engine's widths,
    each built once by ``warmup()`` and never again after the imports
    above; ``migration_supported`` follows the paged store."""
    src, dst = engines
    want = {k for k in jax_engine.compile_counts_detailed()
            if k.startswith("kv_")}
    for eng in (src, dst):
        got = eng.compile_counts_detailed()
        assert {k for k in got if k.startswith("kv_")} == want
        assert set(got.values()) == {1}
        assert eng.recompiles == {}
        assert eng.migration_supported
    assert set(jax_engine.compile_counts_detailed()) == set(
        src.compile_counts_detailed())


def test_dense_engine_does_not_migrate(state):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(state)
    eng = ServingEngine(model, n_slots=2, prefill_len=8, cache_len=32,
                        paged=False, device="cpu")
    assert not eng.migration_supported
    assert not any(k.startswith("kv_")
                   for k in eng.compile_counts_detailed())
    with pytest.raises(RuntimeError, match="paged=True"):
        eng.export_slot_kv(0)
    assert eng.export_prefix_kv(PROMPT) is None


@pytest.mark.parametrize("dest", ["speculative", "window"])
def test_multi_token_destination_continues_exactly(engines, state, ref_tail,
                                                   dest):
    """A speculative (n-gram, k = 2) or windowed (2 tokens a call)
    destination reserves its headroom in ``can_import`` and, given the
    prompt, primes its drafter: the migrated request streams JAX
    ``generate()``'s tokens."""
    src, _ = engines
    kw = (dict(speculative=SpeculativeConfig(k=2)) if dest == "speculative"
          else dict(decode_window=2))
    dst = build(state, **kw)
    slot_a, first = _prefill_on(src)
    payload = src.export_slot_kv(slot_a)
    src.release(slot_a)
    assert dst.can_import(payload, max_new=N_NEW)
    slot_b = dst.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW)
    assert _decode(dst, slot_b, first) == ref_tail
    assert dst.recompiles == {}


# --------------------------------------------------------------------- #
# the scheduler's handover                                               #
# --------------------------------------------------------------------- #


@pytest.mark.parametrize("chunk_tokens", [None, 3])
def test_scheduler_handover_same_request_object(engines, ref_tail,
                                                chunk_tokens):
    src, dst = engines
    sa = FCFSScheduler(src, chunk_tokens_per_step=chunk_tokens)
    sb = FCFSScheduler(dst)
    migrations = []

    def migrate(req, payload):
        sb.enqueue_migrated(req, payload)
        migrations.append(req.id)
        return True

    sa.migrate_cb = migrate
    r = sa.submit(PROMPT, N_NEW)
    for _ in range(400):
        sa.step()
        sb.step()
        if r.finished:
            break
    assert r.finished and r.tokens == ref_tail, (r.state, r.error)
    assert migrations == [r.id]
    assert len(src.free_slots) == src.n_slots
    assert not sa.has_work and not sb.has_work
    assert src.recompiles == {} and dst.recompiles == {}


@pytest.mark.parametrize("failure", ["false", "raise"])
def test_migrate_failure_decodes_in_place(engines, ref_tail, failure):
    src, _ = engines
    sa = FCFSScheduler(src, chunk_tokens_per_step=3)
    if failure == "false":
        sa.migrate_cb = lambda req, payload: False
    else:
        def boom(req, payload):
            raise RuntimeError("chaos")
        sa.migrate_cb = boom
    r = sa.submit(PROMPT, N_NEW)
    for _ in range(400):
        sa.step()
        if r.finished:
            break
    assert r.finished and r.tokens == ref_tail, (r.state, r.error)
    assert len(src.free_slots) == src.n_slots


def test_sampled_stream_continues_after_migration(state):
    """The payload carries the slot's generator state: a sampled request
    migrated after its prefill streams what it streams unmigrated."""
    kw = dict(temperature=0.9, top_k=8)
    solo, a, b = (build(state, **kw) for _ in range(3))
    s0 = FCFSScheduler(solo)
    want = s0.submit(PROMPT, N_NEW, seed=5)
    s0.run_until_idle()
    sa, sb = FCFSScheduler(a), FCFSScheduler(b)
    sa.migrate_cb = lambda req, payload: sb.enqueue_migrated(req, payload)
    r = sa.submit(PROMPT, N_NEW, seed=5)
    for _ in range(400):
        sa.step()
        sb.step()
        if r.finished:
            break
    assert r.tokens == want.tokens
    assert len(a.free_slots) == a.n_slots


# --------------------------------------------------------------------- #
# int8 rows                                                              #
# --------------------------------------------------------------------- #


def test_int8_chunked_and_migration_parity(state):
    """int8 rows and their scales migrate as stored: the int8 engine's
    stream chunked equals it unchunked equals it after a migration."""
    eng_u = build(state, kv_quant="int8")
    slot, first = _prefill_on(eng_u)
    toks_u = _decode(eng_u, slot, first)
    eng_u.release(slot)
    sc = FCFSScheduler(eng_u, chunk_tokens_per_step=3)
    r = sc.submit(PROMPT, N_NEW)
    sc.run_until_idle()
    assert r.finished and r.tokens == toks_u, (r.state, r.tokens, toks_u)
    eng_b = build(state, kv_quant="int8")
    slot_a, first_a = _prefill_on(eng_u)
    payload = eng_u.export_slot_kv(slot_a)
    assert payload["kv_quant"] == "int8"
    assert payload["layers"][0]["k"].dtype == torch.int8
    assert payload["layers"][0]["k_scale"].dtype == torch.float32
    slot_b = eng_b.import_slot_kv(payload, prompt=PROMPT, max_new=N_NEW)
    eng_u.release(slot_a)
    back = eng_b.export_slot_kv(slot_b)
    for lp, lb in zip(payload["layers"], back["layers"]):
        for kk in lp:
            assert torch.equal(lp[kk], lb[kk])      # bit for bit
    assert _decode(eng_b, slot_b, first_a) == toks_u
    for e in (eng_u, eng_b):
        assert e.recompiles == {}


def test_int8_shared_prefix_parity(state):
    """An int8 prefix payload adopted by a peer makes the peer's stream
    equal the holder's."""
    eng_a = build(state, kv_quant="int8")
    eng_b = build(state, kv_quant="int8")
    sa = FCFSScheduler(eng_a)
    ra = sa.submit(PROMPT, N_NEW)
    sa.run_until_idle()
    assert ra.finished and len(ra.tokens) == N_NEW
    payload = eng_a.export_prefix_kv(PROMPT, min_blocks=2)
    assert payload is not None and payload["kv_quant"] == "int8"
    covered = np.asarray(payload["tokens"], np.int32)
    assert len(covered) == 10            # (len - 1) // block_size blocks
    assert eng_b.can_import_prefix(payload)
    assert eng_b.import_prefix_kv(payload) == payload["n_blocks"]
    assert eng_b.prefix_cache.missing_blocks(covered) == 0
    sb = FCFSScheduler(eng_b)
    rb = sb.submit(PROMPT, N_NEW)
    sb.run_until_idle()
    assert rb.finished and rb.tokens == ra.tokens
    assert eng_a.recompiles == {} and eng_b.recompiles == {}
