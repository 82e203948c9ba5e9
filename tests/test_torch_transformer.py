"""The port's TransformerLM against the flax TransformerLM on the same
weights (converted by ``chainermn_torch.interop.params_from_flax``).

Tolerances: f32 logits atol 1e-4 (sums in another order through two
layers). bf16 logits atol 5e-2, about three bf16 ulps (2**-6 each) of
the largest logits (|x| < 4): both sides round to bf16 at matmul outputs
and residual adds, but not at the same points (XLA keeps f32 inside its
fusions; torch fuses the bias into the matmul epilogue and computes GELU
in f32 internally), so the bf16 logits land up to a few ulps apart.
Greedy tokens must be equal.

The D = 256 LM (``d_model 512, n_heads 2``: the head width of the
reference's ``TransformerLM(d_model=1024, n_heads=4)``) and the D = 512
LM (``d_model 512, n_heads 1``: that of ``TransformerLM(d_model=1024,
n_heads=2)``) are held to flax at f32: logits atol 1e-4; one
``attention='flash'`` train step's loss atol 1e-5 (a mean over 32
tokens) and every gradient atol 1e-5 (the flax flash LM's Pallas kernels
in interpret mode against the port's flash wrappers, both summing over
8-key blocks or all keys at once); the paged engine's greedy streams
equal the JAX paged engine's. The small LM at ``compute_dtype=float16``
(a float16 paged store) streams the JAX float16 engine's greedy tokens.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import optax

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import transformer as jtr
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine
from chainermn_torch import create_communicator, create_multi_node_optimizer
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM, generate
from chainermn_torch.models import transformer as ttr
from chainermn_torch.serving import FCFSScheduler, ServingEngine
from chainermn_torch.training import lm_train_step

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


# ------------------------------------------------------------------ #
# Head dims 256 and 512                                               #
# ------------------------------------------------------------------ #

D256 = dict(vocab_size=256, d_model=512, n_heads=2, n_layers=2, max_len=64)
D512 = dict(D256, n_heads=1)
WIDE_LMS = {256: D256, 512: D512}


def _wide_params(cfg, seed):
    lm = JaxLM(**cfg, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(seed), jnp.zeros((1, 4), jnp.int32))
    return jax.device_get(params)


@pytest.fixture(scope="module")
def d256_params():
    return _wide_params(D256, 5)


@pytest.fixture(scope="module")
def d512_params():
    return _wide_params(D512, 8)


def _wide_port(cfg, params, **kw):
    model = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu",
                          **kw)
    model.load_state_dict(params_from_flax(params))
    return model


def _wide_tokens(b, t, seed):
    return np.random.default_rng(seed).integers(
        1, D256["vocab_size"], (b, t)).astype(np.int32)


def _check_logits(cfg, params, seed):
    toks = _wide_tokens(2, 13, seed=seed)
    want = np.asarray(jax.jit(JaxLM(**cfg, compute_dtype=jnp.float32)
                              .apply)(params, jnp.asarray(toks)))
    with torch.no_grad():
        got = _wide_port(cfg, params)(torch.from_numpy(toks).long()).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


def _check_flash_train_step(cfg, params, seed):
    """One ``lm_train_step`` of the flash LM (SGD at lr 1, so the step
    moves each parameter by exactly its gradient) against the flax flash
    LM's loss and ``jax.grad`` on the same tokens."""
    toks = _wide_tokens(2, 16, seed=seed)
    tgts = np.roll(toks, -1, axis=1)
    jlm = JaxLM(**cfg, attention="flash", compute_dtype=jnp.float32)

    def loss_fn(params):
        logits = jlm.apply(params, jnp.asarray(toks))
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.astype(jnp.float32), jnp.asarray(tgts)).mean()

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_fn))(params)
    want = params_from_flax(jax.device_get(jgrads))

    model = _wide_port(cfg, params, attention="flash")
    before = {n: w.detach().clone() for n, w in model.named_parameters()}
    comm = create_communicator("pure_nccl", device="cpu")
    try:
        opt = create_multi_node_optimizer(
            torch.optim.SGD(model.parameters(), lr=1.0), comm)
        loss, _ = lm_train_step(model, opt, comm)(toks, tgts)
    finally:
        comm.finalize()
    np.testing.assert_allclose(float(loss), float(jloss), atol=1e-5, rtol=0)
    for name, w in model.named_parameters():
        np.testing.assert_allclose((before[name] - w.detach()).numpy(),
                                   want[name].numpy(), atol=1e-5, rtol=0,
                                   err_msg=name)


PAGED_KW = dict(n_slots=2, prefill_buckets=(8, 16), prefill_batch=2,
                paged=True, kv_block_size=4, cache_len=32, paged_kernel=True)
PROMPTS = [np.array([3, 5, 2, 9]), np.array([1, 2, 3, 4, 6, 7, 8]),
           np.array([7, 11])]


def _jax_streams(jlm, params, n_new=6):
    jsched = JaxScheduler(JaxEngine(jlm, params, **PAGED_KW))
    jreqs = [jsched.submit(p, n_new) for p in PROMPTS]
    jsched.run_until_idle()
    return [list(map(int, r.output)) for r in jreqs]


def _port_streams(model, n_new=6):
    """The greedy streams of the port's paged engine, and the engine."""
    engine = ServingEngine(model, device="cpu", **PAGED_KW)
    sched = FCFSScheduler(engine)
    reqs = [sched.submit(p, n_new) for p in PROMPTS]
    sched.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    return [list(map(int, r.output)) for r in reqs], engine


def _check_paged_streams(cfg, params):
    """The port's paged engine, reading through ``paged_attend``, against
    the JAX paged engine on its Pallas kernel: the same greedy tokens."""
    want = _jax_streams(JaxLM(**cfg, compute_dtype=jnp.float32), params)
    model = _wide_port(cfg, params)
    assert model.d_model // model.n_heads == cfg["d_model"] // cfg["n_heads"]
    assert _port_streams(model)[0] == want


def test_d256_logits_match_flax(d256_params):
    assert D256["d_model"] // D256["n_heads"] == 256
    _check_logits(D256, d256_params, seed=6)


def test_d256_flash_train_step_matches_flax(d256_params):
    _check_flash_train_step(D256, d256_params, seed=7)


def test_d256_paged_engine_streams_match_jax_engine(d256_params):
    _check_paged_streams(D256, d256_params)


def test_d512_logits_match_flax(d512_params):
    """One head of 512: the head width of the reference's
    ``TransformerLM(d_model=1024, n_heads=2)``."""
    assert D512["d_model"] // D512["n_heads"] == 512
    _check_logits(D512, d512_params, seed=9)


def test_d512_flash_train_step_matches_flax(d512_params):
    _check_flash_train_step(D512, d512_params, seed=10)


def test_d512_paged_engine_streams_match_jax_engine(d512_params):
    _check_paged_streams(D512, d512_params)


def test_float16_paged_engine_streams_match_jax_engine(flax_params):
    """The small LM at ``compute_dtype=float16``: its paged store is
    float16 (the model's compute dtype), read through ``paged_attend``
    with float16 queries, against the JAX paged engine at
    ``compute_dtype=jnp.float16`` on its Pallas kernel; the same greedy
    tokens."""
    want = _jax_streams(JaxLM(**CFG, compute_dtype=jnp.float16),
                        flax_params)
    model = TransformerLM(**CFG, compute_dtype=torch.float16, device="cpu")
    model.load_state_dict(params_from_flax(flax_params))
    got, engine = _port_streams(model)
    assert all(layer["k"].dtype == torch.float16 for layer in engine._store)
    assert got == want
