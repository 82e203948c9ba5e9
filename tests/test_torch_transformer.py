"""The port's TransformerLM against the flax TransformerLM on the same
weights (converted by ``chainermn_torch.interop.params_from_flax``).

Tolerances: f32 logits atol 1e-4 (sums in another order through two
layers). bf16 logits atol 5e-2, about three bf16 ulps (2**-6 each) of
the largest logits (|x| < 4): both sides round to bf16 at matmul outputs
and residual adds, but not at the same points (XLA keeps f32 inside its
fusions; torch fuses the bias into the matmul epilogue and computes GELU
in f32 internally), so the bf16 logits land up to a few ulps apart.
Greedy tokens must be equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import transformer as jtr
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM, generate
from chainermn_torch.models import transformer as ttr

torch.set_float32_matmul_precision("highest")
# tiny shapes: one intra-op thread, so parallel test workers do not
# oversubscribe the cores that timing-sensitive tests share
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=32, n_heads=4, n_layers=2, max_len=64)
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def flax_params():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0), jnp.zeros((1, 4), jnp.int32))
    return jax.device_get(params)


def _pair(params, dtype):
    jdt, tdt = DTYPES[dtype]
    jlm = JaxLM(**CFG, compute_dtype=jdt)
    tlm = TransformerLM(**CFG, compute_dtype=tdt, device="cpu")
    tlm.load_state_dict(params_from_flax(params))
    return jlm, tlm


def _tokens(b, t, seed=0):
    return np.random.default_rng(seed).integers(
        0, CFG["vocab_size"], (b, t)).astype(np.int32)


@pytest.mark.parametrize("dtype,atol", [("f32", 1e-4), ("bf16", 5e-2)])
def test_logits_match_flax(flax_params, dtype, atol):
    jlm, tlm = _pair(flax_params, dtype)
    toks = _tokens(2, 11)
    want = np.asarray(jax.jit(jlm.apply)(flax_params, jnp.asarray(toks)))
    got = tlm(torch.from_numpy(toks).long()).detach().numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_cast_weights_keeps_logits(flax_params):
    """Storing the matmul weights in the compute dtype changes nothing:
    the forward casts them to it anyway."""
    _, tlm = _pair(flax_params, "bf16")
    toks = torch.from_numpy(_tokens(2, 7)).long()
    with torch.no_grad():
        before = tlm(toks)
        after = tlm.cast_weights_()(toks)
    assert tlm.lm_head.weight.dtype == torch.bfloat16
    assert tlm.ln_f.weight.dtype == torch.float32
    torch.testing.assert_close(after, before, rtol=0, atol=0)


@pytest.mark.parametrize("kv_quant", ["none", "int8"])
def test_paged_prefill_then_decode_logits_match_flax(flax_params, kv_quant):
    """Prefill 6 tokens through per-row tables, then decode one token at
    per-row positions: the logits of both calls match the flax model over
    the same paged store layout."""
    jlm, tlm = _pair(flax_params, "f32")
    b, t0, bs, n_max = 2, 6, 4, 3
    n_blocks = 1 + b * n_max
    table = (1 + np.arange(b * n_max, dtype=np.int32)).reshape(b, n_max)
    toks = _tokens(b, t0 + 1, seed=1)
    jst = jtr.init_paged_kv_caches(jlm, n_blocks, bs, quant=kv_quant)
    tst = ttr.init_paged_kv_caches(tlm, n_blocks, bs, quant=kv_quant)
    jc = [dict(layer, table=jnp.asarray(table)) for layer in jst]
    tc = [dict(layer, table=torch.from_numpy(table)) for layer in tst]
    apply = jax.jit(jlm.apply)
    want0, jst = apply(flax_params, jnp.asarray(toks[:, :t0]), 0,
                       kv_caches=jc)
    with torch.no_grad():
        got0 = tlm(torch.from_numpy(toks[:, :t0]).long(), 0, kv_caches=tc)
    np.testing.assert_allclose(got0.numpy(), np.asarray(want0), atol=1e-4)
    jc = [dict(layer, table=jnp.asarray(table)) for layer in jst]
    pos = np.full((b, 1), t0, np.int32)
    want1, _ = apply(flax_params, jnp.asarray(toks[:, t0:]),
                     jnp.asarray(pos), kv_caches=jc)
    with torch.no_grad():
        got1 = tlm(torch.from_numpy(toks[:, t0:]).long(),
                   torch.from_numpy(pos), kv_caches=tc)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), atol=1e-4)


def test_greedy_generate_matches_flax(flax_params):
    jlm, tlm = _pair(flax_params, "f32")
    prompt = _tokens(2, 5, seed=2)
    want = np.asarray(jtr.generate(jlm, flax_params, jnp.asarray(prompt), 9))
    got = generate(tlm, prompt, 9).numpy()
    np.testing.assert_array_equal(got, want)


def test_greedy_generate_eos_pads_like_flax(flax_params):
    jlm, tlm = _pair(flax_params, "f32")
    prompt = _tokens(2, 4, seed=3)
    first = generate(tlm, prompt, 6).numpy()
    eos = int(first[0, 6])           # the second generated token of row 0
    want = np.asarray(jtr.generate(jlm, flax_params, jnp.asarray(prompt), 6,
                                   eos_id=eos))
    np.testing.assert_array_equal(generate(tlm, prompt, 6, eos_id=eos)
                                  .numpy(), want)


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.7), (6, 0.5)])
def test_sampler_masks_match_flax(monkeypatch, top_k, top_p):
    """The reference sampler's masked logits (captured where it hands them
    to ``jax.random.categorical``) equal the port's ``filter_logits`` on
    the same fixed logits."""
    lg = np.random.default_rng(4).standard_normal((3, 17)).astype(np.float32)
    seen = {}

    def capture(key, logits, axis=-1):
        seen["lg"] = np.asarray(logits)
        return jnp.argmax(logits, axis=axis)

    monkeypatch.setattr(jax.random, "categorical", capture)
    jtr._sampler(0.8, top_k, top_p)(jnp.asarray(lg), jax.random.PRNGKey(0))
    got = ttr.filter_logits(torch.from_numpy(lg), 0.8, top_k, top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(seen["lg"]))
    finite = ~np.isinf(got)
    np.testing.assert_allclose(got[finite], seen["lg"][finite], rtol=1e-6)


def test_sampled_tokens_stay_inside_the_mask():
    """Sampling with per-row generators draws only unmasked tokens and is
    reproducible from the seed."""
    lg = torch.from_numpy(
        np.random.default_rng(5).standard_normal((4, 17)).astype(np.float32))
    sample = ttr._sampler(1.0, top_k=3)

    def draw():
        gens = [torch.Generator().manual_seed(i) for i in range(4)]
        return torch.stack([sample(lg, gens) for _ in range(20)])

    toks = draw()
    allowed = torch.topk(lg, 3, dim=-1).indices
    assert all(int(t) in allowed[i] for i in range(4) for t in toks[:, i])
    torch.testing.assert_close(draw(), toks)
