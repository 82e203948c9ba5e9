"""The write side of the port's paged KV path and its dense attention
helpers, against ``chainermn_tpu.parallel.sequence`` on the CPU.

Writes are copies, so an f32 store must come out bit-equal; int8 rows
must be bit-equal too (same IEEE division, both round half to even) and
the f32 scales within 1e-7. Attention outputs: f32 atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.parallel import sequence as jseq
from chainermn_torch.parallel import sequence as tseq

torch.set_float32_matmul_precision("highest")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores that timing-sensitive tests share
torch.set_num_threads(1)

B, S, H, D, BS, N_BLOCKS, N_MAX = 3, 4, 2, 8, 4, 14, 4


def _case(seed, quant):
    rng = np.random.default_rng(seed)
    store = {kk: rng.standard_normal((N_BLOCKS, BS, H, D)).astype(np.float32)
             for kk in ("k", "v")}
    if quant:
        store = {kk: rng.integers(-127, 128, (N_BLOCKS, BS, H, D),
                                  dtype=np.int8) for kk in ("k", "v")}
        store.update({kk: rng.random((N_BLOCKS, BS, H)).astype(np.float32)
                      for kk in ("k_scale", "v_scale")})
    table = rng.permutation(np.arange(1, N_BLOCKS))[:B * N_MAX]
    table = table.reshape(B, N_MAX).astype(np.int32)
    rows = {kk: (rng.standard_normal((B, S, H, D)) * 3).astype(np.float32)
            for kk in ("q", "k", "v")}
    # a row whose max |x| is 127 gets scale 1.0, so x.5 values sit exactly
    # on a rounding tie: both sides must round half to even
    rows["k"][0, 0, 0] = np.array([127, 2.5, -3.5, 0.5, -0.5, 1.5, 0, 7],
                                  np.float32)
    return store, table, rows


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("with_valid", [False, True])
def test_scatter_and_valid_redirect_match_jax(quant, with_valid):
    """S rows per batch row land at ``table[b, p // bs], p % bs`` for
    positions from per-row bases; with ``valid``, rows past each count go
    to the scratch block 0 instead."""
    store, table, rows = _case(0, quant)
    pos = np.array([0, 5, N_MAX * BS - S], np.int32)
    jcache = {kk: jnp.asarray(a) for kk, a in store.items()}
    jcache["table"] = jnp.asarray(table)
    tcache = {kk: torch.from_numpy(a.copy()) for kk, a in store.items()}
    tcache["table"] = torch.from_numpy(table)
    if with_valid:
        valid = np.array([S, 1, 2], np.int32)
        jcache["valid"] = jnp.asarray(valid)
        tcache["valid"] = torch.from_numpy(valid)
    want, jnew = jseq.paged_update_cache_and_attend(
        jcache, *(jnp.asarray(rows[kk]) for kk in ("q", "k", "v")),
        jnp.asarray(pos))
    got = tseq.paged_update_cache_and_attend(
        tcache, *(torch.from_numpy(rows[kk]) for kk in ("q", "k", "v")),
        torch.from_numpy(pos))
    # block 0 is scratch: redirected rows collide there in no set order
    for kk in ("k", "v"):
        np.testing.assert_array_equal(tcache[kk].numpy()[1:],
                                      np.asarray(jnew[kk])[1:])
    if quant:
        for kk in ("k_scale", "v_scale"):
            np.testing.assert_allclose(tcache[kk].numpy()[1:],
                                       np.asarray(jnew[kk])[1:], rtol=0,
                                       atol=1e-7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_scalar_position_scatter_matches_jax():
    """A scalar ``pos_offset`` writes every row at the same base."""
    store, table, rows = _case(1, False)
    jcache = dict({kk: jnp.asarray(a) for kk, a in store.items()},
                  table=jnp.asarray(table))
    tcache = dict({kk: torch.from_numpy(a.copy()) for kk, a in store.items()},
                  table=torch.from_numpy(table))
    want, jnew = jseq.paged_update_cache_and_attend(
        jcache, *(jnp.asarray(rows[kk]) for kk in ("q", "k", "v")), 3)
    got = tseq.paged_update_cache_and_attend(
        tcache, *(torch.from_numpy(rows[kk]) for kk in ("q", "k", "v")), 3)
    np.testing.assert_array_equal(tcache["k"].numpy(), np.asarray(jnew["k"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_update_cache_and_attend_needs_a_table():
    """Only a cache carrying a ``'table'`` takes the paged path; one
    without is the dense per-slot buffer, written in place at the row's
    position and equal to the JAX dense branch."""
    _, _, rows = _case(2, False)
    rng = np.random.default_rng(5)
    bufs = {kk: rng.standard_normal((B, 9, H, D)).astype(np.float32)
            for kk in ("k", "v")}
    q, k, v = (rows[kk] for kk in ("q", "k", "v"))
    want, want_c = jseq.update_cache_and_attend(
        {kk: jnp.asarray(a) for kk, a in bufs.items()},
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2)
    cache = {kk: torch.from_numpy(a.copy()) for kk, a in bufs.items()}
    got = tseq.update_cache_and_attend(
        cache, *(torch.from_numpy(rows[kk]) for kk in ("q", "k", "v")), 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    for kk in ("k", "v"):
        np.testing.assert_array_equal(cache[kk].numpy(),
                                      np.asarray(want_c[kk]))


@pytest.mark.parametrize("per_row", [False, True])
def test_cached_attention_matches_jax(per_row):
    rng = np.random.default_rng(3)
    q = rng.standard_normal((B, 2, H, D)).astype(np.float32)
    kv = rng.standard_normal((2, B, 9, H, D)).astype(np.float32)
    pos = np.array([0, 3, 7], np.int32) if per_row else 4
    want = jseq.cached_attention(jnp.asarray(q), jnp.asarray(kv[0]),
                                 jnp.asarray(kv[1]),
                                 jnp.asarray(pos) if per_row else pos)
    got = tseq.cached_attention(torch.from_numpy(q), torch.from_numpy(kv[0]),
                                torch.from_numpy(kv[1]),
                                torch.from_numpy(pos) if per_row else pos)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_full_attention_matches_jax(causal):
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 6, H, D)).astype(np.float32)
               for _ in range(3))
    want = jseq.full_attention(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal)
    got = tseq.full_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
