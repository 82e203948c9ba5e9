"""The port's paged-decode wrapper (``chainermn_torch.parallel.
paged_kernel``) against the JAX package's Pallas kernel and its XLA
paged path, on the CPU.

On CPU tensors ``paged_attend`` runs its plain PyTorch version (gather
the table span, then the position-masked cached attention); the JAX side
runs the Pallas kernel in interpret mode, as the JAX package's own tests
do. Inputs come from numpy with a fixed seed. Tolerance: f32 atol 1e-5
(the two sides sum in different orders: online softmax vs one softmax).
Head dims the kernel masks inside (8, 32, 96) and windows of more than
the 8 queries a launch takes are held to the JAX kernel too, and the
wrapper's chunking (``chunk_queries``) to one plain call over the whole
window. The CUDA kernel itself is held against the same plain version on
the card by ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.parallel import paged_kernel as jpk
from chainermn_tpu.parallel import sequence as jseq
from chainermn_torch.parallel import paged_kernel as tpk
from chainermn_torch.parallel import sequence as tseq

torch.set_float32_matmul_precision("highest")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores that timing-sensitive tests share
torch.set_num_threads(1)

B, H, D, BS, N_MAX = 3, 2, 8, 4, 5
ATOL = 1e-5


def _q8(x):
    sc = np.maximum(np.abs(x).max(-1) / 127.0, 1e-8).astype(np.float32)
    return (np.clip(np.round(x / sc[..., None]), -127, 127).astype(np.int8),
            sc)


def _inputs(s_len, lengths, *, quant, seed=0, d=D):
    """A store of random rows, every row's table pointing at its own
    random blocks, junk in the scratch block and junk ids in each table's
    tail past the row's length (the position mask must hide them)."""
    rng = np.random.default_rng(seed)
    n_blocks = 1 + B * N_MAX + 3
    k = rng.standard_normal((n_blocks, BS, H, d)).astype(np.float32)
    v = rng.standard_normal((n_blocks, BS, H, d)).astype(np.float32)
    ids = rng.permutation(np.arange(1, n_blocks))
    table = ids[:B * N_MAX].reshape(B, N_MAX).astype(np.int32)
    for i, n in enumerate(lengths):
        live = -(-n // BS)
        table[i, live:] = rng.integers(0, n_blocks, N_MAX - live)
    q = rng.standard_normal((B, s_len, H, d)).astype(np.float32)
    out = dict(q=q, k=k, v=v, table=table,
               lengths=np.asarray(lengths, np.int32), ks=None, vs=None)
    if quant:
        out["k"], out["ks"] = _q8(k)
        out["v"], out["vs"] = _q8(v)
    return out


def _jax(x, **kw):
    opt = lambda a: None if a is None else jnp.asarray(a)
    return np.asarray(jpk.paged_attend(
        jnp.asarray(x["q"]), jnp.asarray(x["k"]), jnp.asarray(x["v"]),
        jnp.asarray(x["table"]), jnp.asarray(x["lengths"]),
        k_scale=opt(x["ks"]), v_scale=opt(x["vs"]), interpret=True, **kw))


def _torch(fn, x, **kw):
    opt = lambda a: None if a is None else torch.from_numpy(a)
    return fn(torch.from_numpy(x["q"]), torch.from_numpy(x["k"]),
              torch.from_numpy(x["v"]), torch.from_numpy(x["table"]),
              torch.from_numpy(x["lengths"]), k_scale=opt(x["ks"]),
              v_scale=opt(x["vs"]), **kw).numpy()


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("s_len", [1, 3, 8])
def test_paged_attend_matches_jax_kernel(s_len, quant):
    """Ragged lengths: the youngest possible row (= S), one exactly at a
    block edge, and one filling the table."""
    x = _inputs(s_len, [s_len, 2 * BS, N_MAX * BS], quant=quant)
    want = _jax(x)
    got = _torch(tpk.paged_attend, x)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=ATOL)
    before = tpk.paged_attend.launches
    np.testing.assert_array_equal(_torch(tpk.paged_attend_reference, x), got)
    assert tpk.paged_attend.launches == before   # CPU: no kernel launch


def test_max_blocks_cap_matches_jax():
    """A table-span cap at the batch's live block count changes nothing;
    the same cap on both sides agrees."""
    lengths = [3, 7, 9]
    x = _inputs(1, lengths, quant=False, seed=1)
    cap = -(-max(lengths) // BS)
    got = _torch(tpk.paged_attend, x, max_blocks=cap)
    np.testing.assert_allclose(got, _jax(x, max_blocks=cap), atol=ATOL,
                               rtol=ATOL)
    np.testing.assert_allclose(got, _torch(tpk.paged_attend, x), atol=ATOL,
                               rtol=ATOL)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("s_len", [1, 3, 8])
def test_update_and_attend_matches_jax_paged_path(s_len, quant):
    """Write S rows at each row's own position through the table, then
    attend: the port (in place) against the JAX XLA paged path (which
    returns the new store), output and store."""
    lengths = [s_len + 2, 2 * BS, N_MAX * BS - 1]
    x = _inputs(s_len, lengths, quant=quant, seed=2)
    rng = np.random.default_rng(3)
    new_k = rng.standard_normal((B, s_len, H, D)).astype(np.float32)
    new_v = rng.standard_normal((B, s_len, H, D)).astype(np.float32)
    pos = (x["lengths"] - s_len).astype(np.int32)
    jcache = {"k": jnp.asarray(x["k"]), "v": jnp.asarray(x["v"]),
              "table": jnp.asarray(x["table"])}
    tcache = {"k": torch.from_numpy(x["k"].copy()),
              "v": torch.from_numpy(x["v"].copy()),
              "table": torch.from_numpy(x["table"])}
    if quant:
        jcache.update(k_scale=jnp.asarray(x["ks"]),
                      v_scale=jnp.asarray(x["vs"]))
        tcache.update(k_scale=torch.from_numpy(x["ks"].copy()),
                      v_scale=torch.from_numpy(x["vs"].copy()))
    want, jnew = jseq.paged_update_cache_and_attend(
        jcache, jnp.asarray(x["q"]), jnp.asarray(new_k), jnp.asarray(new_v),
        jnp.asarray(pos))
    got = tseq.paged_update_cache_and_attend(
        tcache, torch.from_numpy(x["q"]), torch.from_numpy(new_k),
        torch.from_numpy(new_v), torch.from_numpy(pos))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=ATOL)
    for kk in jnew:
        np.testing.assert_array_equal(tcache[kk].numpy(),
                                      np.asarray(jnew[kk]))
    kernel_read = tseq.paged_update_cache_and_attend(
        dict(tcache, use_kernel=True), torch.from_numpy(x["q"]),
        torch.from_numpy(new_k), torch.from_numpy(new_v),
        torch.from_numpy(pos))
    np.testing.assert_array_equal(kernel_read.numpy(), got.numpy())


@pytest.mark.parametrize("batch,heads", [(1, 1), (4, 4), (16, 16),
                                         (64, 32)])
@pytest.mark.parametrize("bs", [1, 4, 16])
def test_split_plan_covers_the_span_once_on_block_edges(batch, heads, bs):
    """Every key position of the table span lies in exactly one split,
    every split starts on a block edge inside the span, and the choice
    follows batch * heads: more rows and heads, fewer splits."""
    for n_j in (1, 2, 3, 7, 8, 40, 128, 129, 5000):
        n_split, split_keys = tpk.split_plan(batch, heads, n_j, bs)
        span = n_j * bs
        assert n_split >= 1 and split_keys % bs == 0
        assert split_keys // bs <= tpk._SPLIT_MAX_BLOCKS
        starts = [i * split_keys for i in range(n_split)]
        assert all(s < span for s in starts)
        seen = np.zeros(span, np.int64)
        for s in starts:
            seen[s:min(s + split_keys, span)] += 1
        assert (seen == 1).all(), (n_j, n_split, split_keys)
        if n_j <= tpk._SPLIT_MAX_BLOCKS:
            assert n_split <= -(-span // tpk._SPLIT_MIN_KEYS)
            assert batch * heads * (n_split - 1) < tpk._SPLIT_CTAS


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_bytes_read_model_matches_jax(kv_quant):
    kw = dict(block_size=16, max_blocks=128, n_heads=16, head_dim=64,
              n_layers=12, kv_quant=kv_quant)
    lengths = [1, 16, 17, 300, 2048, 0]
    assert tpk.bytes_read_model(lengths, **kw) == \
        jpk.bytes_read_model(lengths, **kw)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("d,s_len", [(8, 1), (32, 4), (96, 8), (32, 12),
                                     (8, 12)])
def test_paged_attend_matches_jax_at_any_head_dim_and_window(d, s_len,
                                                             quant):
    """Head dims the kernel masks inside (8, 32, 96) and query windows
    past the kernel's 8 a launch (S = 12), against the Pallas kernel."""
    x = _inputs(s_len, [13, 17, 20], quant=quant, seed=2, d=d)
    np.testing.assert_allclose(_torch(tpk.paged_attend, x), _jax(x),
                               atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant", [False, True], ids=["f32", "int8"])
@pytest.mark.parametrize("s_len", [9, 12, 17])
def test_chunk_queries_is_exact(s_len, quant):
    """The wrapper-side chunking, run over the plain version: chunks of 8
    queries with each row's length cut to the chunk's last query equal
    one call over the whole window, rows shorter than the window
    included (their early queries see no key)."""
    x = _inputs(s_len, [s_len, 14, 20], quant=quant, seed=3)
    want = _torch(tpk.paged_attend_reference, x)
    got = _torch(lambda *a, **kw: tpk.chunk_queries(
        tpk.paged_attend_reference, *a, **kw), x)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)
