"""The serving engine's fixed step programs on the CPU, against the JAX
engine on the same flax weights (converted by ``params_from_flax``).

The reference engine owns one compiled program per prefill bucket plus
the decode step (and the decode window, the verify window, the prefix
insert and the drafter's two where the engine has them), and its
``RecompileGuard`` pins that no request ever adds one. The port's
programs are :class:`~chainermn_torch.serving._programs.StepProgram` s
(captured CUDA graphs on a card, the same bodies run eagerly here): the
counts, the keys of ``compile_counts_detailed()`` and the greedy streams
must be the JAX engine's, after ``warmup()`` and after ragged traffic.
Prompts and engine settings follow ``tests/serving_tests/``.
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
from chainermn_tpu.serving.speculative import \
    SpeculativeConfig as JaxSpecConfig
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import EventLog, MetricsRegistry, RecompileGuard
from chainermn_torch.serving import (
    FCFSScheduler,
    ServingEngine,
    SpeculativeConfig,
)
from chainermn_torch.serving._programs import ProgramSet

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
DRAFT = dict(vocab_size=17, d_model=8, n_heads=2, n_layers=1, max_len=48)
BASE = dict(n_slots=3, prefill_buckets=(4, 8), prefill_batch=2,
            cache_len=32)
KINDS = {
    "paged": dict(paged=True, kv_block_size=2),
    "window": dict(paged=True, kv_block_size=2, decode_window=3),
    "spec_ngram": dict(paged=True, kv_block_size=2, speculative="ngram"),
    "spec_draft": dict(paged=True, kv_block_size=2, speculative="draft"),
    "dense_prefix": dict(paged=False, prefix_cache_blocks=16,
                         prefix_block_size=2),
}
# test_speculative.py's staggered ragged jobs, then a second wave
JOBS = [(np.array([1, 2, 3]), 6), (np.array([4, 5, 6, 7, 8]), 4),
        (np.array([9, 10]), 7), (np.array([11, 12, 13, 14]), 5),
        (np.array([2, 4, 6, 8, 10, 12, 14, 16]), 3), (np.array([5]), 8)]
WAVE2 = [(np.array([4, 5]), 6), (np.array([6, 7, 8, 9, 10, 11]), 3),
         (np.array([12]), 9), (np.array([1, 2, 3, 4, 5, 6, 7]), 2)]


@pytest.fixture(scope="module")
def weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    dlm = JaxLM(**DRAFT, compute_dtype=jnp.float32)
    dparams = dlm.init(jax.random.PRNGKey(1),
                       jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params, dlm, dparams


def _port(cfg, params):
    model = TransformerLM(**cfg, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _solo(lm, params, prompt, n):
    out = jax_generate(lm, params, jnp.asarray(prompt, jnp.int32)[None], n)
    return [int(t) for t in np.asarray(out[0])]


def _engines(kind, weights, **extra):
    """The JAX engine and the port's engine of one kind, same settings."""
    lm, params, dlm, dparams = weights
    kw = dict(BASE, **KINDS[kind], **extra)
    spec = kw.pop("speculative", None)
    jkw, tkw = dict(kw), dict(kw)
    if spec == "ngram":
        jkw["speculative"] = JaxSpecConfig(k=3)
        tkw["speculative"] = SpeculativeConfig(k=3)
    elif spec == "draft":
        jkw["speculative"] = JaxSpecConfig(k=3, drafter="draft",
                                           draft_model=dlm,
                                           draft_params=dparams)
        tkw["speculative"] = SpeculativeConfig(
            k=3, drafter="draft", draft_model=_port(DRAFT, dparams))
    return (JaxEngine(lm, params, **jkw),
            ServingEngine(_port(CFG, params), device="cpu", **tkw))


def _run(engine, scheduler_cls, jobs):
    sched = scheduler_cls(engine)
    reqs = [sched.submit(p, n) for p, n in jobs]
    sched.run_until_idle()
    assert all(r.finished and r.error is None for r in reqs)
    return [[int(t) for t in r.output] for r in reqs]


def _reference_keys(counts):
    return {k for k in counts
            if not k.startswith(("kv_gather_", "kv_scatter_"))}


@pytest.mark.parametrize("kind", list(KINDS))
def test_compile_counts_match_jax_through_warmup_and_traffic(weights, kind):
    """After ``warmup()`` the port's ``compile_counts()`` is the JAX
    engine's, ``compile_counts_detailed()`` has the reference's keys (its
    KV-migration programs aside) each at 1, and two waves of ragged
    requests (staggered, slots reused, blocks appended) serve the JAX
    engine's streams while no count moves and ``recompiles`` stays
    empty."""
    jeng, teng = _engines(kind, weights)
    jeng.warmup()
    teng.warmup()
    counts = teng.compile_counts_detailed()
    assert teng.compile_counts() == jeng.compile_counts() == {
        "prefill": len(BASE["prefill_buckets"]), "decode": 1}
    assert set(counts) == _reference_keys(jeng.compile_counts_detailed())
    assert set(counts.values()) == {1}, counts
    for jobs in (JOBS, WAVE2):
        assert _run(teng, FCFSScheduler, jobs) == _run(jeng, JaxScheduler,
                                                       jobs)
        assert teng.compile_counts() == jeng.compile_counts()
        assert teng.compile_counts_detailed() == counts
        assert teng.recompiles == {} == jeng.recompiles
    assert teng.active_slots == 0
    assert not teng.capture and not teng.migration_supported


def test_zero_recompiles_after_warmup(weights):
    """``test_engine.py:88``: the first request builds exactly one prefill
    and one decode program (no ``warmup()``), as the JAX engine compiles
    them, and a second wave of ragged lengths and budgets adds none."""
    lm, params, _, _ = weights
    counts = {}
    for name, eng, sched_cls in (
            ("jax", JaxEngine(lm, params, n_slots=2, prefill_len=8,
                              cache_len=32), JaxScheduler),
            ("port", ServingEngine(_port(CFG, params), n_slots=2,
                                   prefill_len=8, cache_len=32,
                                   device="cpu"), FCFSScheduler)):
        assert _run(eng, sched_cls, [(np.array([1, 2, 3]), 4)]) == [
            _solo(lm, params, [1, 2, 3], 4)]
        first = eng.compile_counts()
        out = _run(eng, sched_cls, [(np.array(p), n) for p, n in
                                    [([4, 5], 6), ([6, 7, 8, 9, 10, 11], 3),
                                     ([12], 9)]])
        assert out == [_solo(lm, params, p, n) for p, n in
                       [([4, 5], 6), ([6, 7, 8, 9, 10, 11], 3), ([12], 9)]]
        assert eng.compile_counts() == first == {"prefill": 1, "decode": 1}
        counts[name] = first
    assert counts["port"] == counts["jax"]


def test_paged_staggered_ragged_matches_solo_and_never_recompiles(weights):
    """``test_paged_kv.py:108``: more requests than slots, admitted at
    staggered times, slots reused and block tables appended mid-decode;
    each stream is its solo ``generate()``, and the programs' counts are
    pinned across every append (table contents change, shapes never)."""
    lm, params, _, _ = weights
    engine = ServingEngine(_port(CFG, params), device="cpu",
                           **BASE, paged=True, kv_block_size=2)
    engine.warmup()
    counts = engine.compile_counts_detailed()
    assert set(counts.values()) == {1}, counts
    appends0 = engine._c_appends.value
    sched = FCFSScheduler(engine)
    prompts = [p for p, _ in JOBS]
    n_new = [n for _, n in JOBS]
    reqs = []
    for p, n in zip(prompts, n_new):       # one arrival a step
        reqs.append(sched.submit(p, n))
        sched.step()
    sched.run_until_idle()
    for p, n, r in zip(prompts, n_new, reqs):
        assert [int(t) for t in r.output] == _solo(lm, params, p, n)
    assert engine._c_appends.value > appends0       # lazy appends ran
    assert engine.compile_counts_detailed() == counts
    assert engine.recompiles == {}
    assert engine.kv_stats()["blocks_reserved"] == 0


@pytest.mark.parametrize("kind,extra", [
    ("spec_ngram", {}),                                  # test_speculative
    ("paged", {"paged_kernel": True}),           # test_paged_kernel_engine
    ("dense_prefix", {}),                              # test_prefix_cache
], ids=["spec_ngram", "paged_kernel", "dense_prefix"])
def test_the_reference_zero_recompile_cases(weights, kind, extra):
    """The zero-recompile cases of ``test_speculative.py:166``,
    ``test_paged_kernel_engine.py:54`` and ``test_prefix_cache.py:171``:
    mixed ragged prompts (prefix hits and inserts on the dense store,
    every accept length on the verify window, the kernel-read decode)
    each equal solo ``generate()``, with no count growing."""
    lm, params, _, _ = weights
    _, engine = _engines(kind, weights, **extra)
    engine.warmup()
    before = engine.compile_counts_detailed()
    jobs = JOBS
    if kind == "dense_prefix":
        pre = [1, 2, 3, 4, 5, 6]
        jobs = [(np.array(p), n) for p, n in
                [(pre + [11], 4), (list(range(1, 9)), 3),
                 ([12, 13, 14, 15, 16, 1, 2], 5), ([3], 6), (pre + [9], 2)]]
    got = _run(engine, FCFSScheduler, jobs)
    assert got == [_solo(lm, params, p, n) for p, n in jobs]
    assert engine.compile_counts_detailed() == before
    assert engine.recompiles == {}
    if kind == "dense_prefix":
        assert engine.prefix_stats()["hits"] >= 1
        assert engine.compile_counts() == {"prefill": 2, "decode": 1}
    if kind == "spec_ngram":
        assert engine.spec_stats()["spec_tokens_proposed"] > 0


def test_sampled_window_replays_the_one_step_program(weights):
    """``temperature > 0``: the programs stop at the logits and the draws
    run outside them, so a decode window is the one-step program replayed
    ``n`` times; its streams equal the per-token engine's for the same
    seeds, and ``decode_window`` is that program (one build)."""
    _, params, _, _ = weights
    streams = {}
    for window in (1, 3):
        engine = ServingEngine(_port(CFG, params), device="cpu", **BASE,
                               paged=True, kv_block_size=2,
                               decode_window=window, temperature=0.8,
                               top_k=5)
        engine.warmup()
        sched = FCFSScheduler(engine)
        reqs = [sched.submit(p, n, seed=100 + i)
                for i, (p, n) in enumerate(JOBS)]
        sched.run_until_idle()
        streams[window] = [[int(t) for t in r.output] for r in reqs]
        counts = engine.compile_counts_detailed()
        assert set(counts.values()) == {1}
        if window > 1:
            assert engine._window_prog is engine._decode_prog
            assert counts["decode_window"] == 1
    assert streams[1] == streams[3]


def test_engine_capture_option():
    """``capture=True`` needs a card; the CPU runs the programs eagerly
    (``capture=None`` picks that), over the same static buffers."""
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu",
                          seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        ServingEngine(model, device="cpu", capture=True, **BASE)
    with pytest.raises(ValueError, match="CUDA"):
        ProgramSet(torch.device("cpu"), capture=True)
    engine = ServingEngine(model, device="cpu", capture=False, **BASE)
    assert engine.capture is False
    prog = engine._decode_prog
    assert prog._cache_size() == 0
    engine.warmup()
    ptrs = {k: t.data_ptr() for k, t in prog.inputs.items()}
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3]), 5)
    sched.run_until_idle()
    assert prog._cache_size() == 1
    assert {k: t.data_ptr() for k, t in prog.inputs.items()} == ptrs
    assert all(t.is_inference() for t in prog.inputs.values())


def test_step_program_copies_in_and_counts_one_build():
    """A program's static inputs take each call's operands in place; its
    count is 0 before the first call and 1 after any number of calls."""
    ps = ProgramSet(torch.device("cpu"), capture=False)
    prog = ps.program("double", lambda ins: ins["x"] * 2,
                      {"x": ((3,), torch.int64)})
    assert prog._cache_size() == 0
    assert prog.run(x=np.array([1, 2, 3], np.int32)).tolist() == [2, 4, 6]
    assert prog.run(x=torch.tensor([4, 5, 6])).tolist() == [8, 10, 12]
    assert prog._cache_size() == 1


class _Jitted:
    """A stand-in with a jit-style executable cache: a new shape builds a
    new executable."""

    def __init__(self):
        self.shapes = set()

    def __call__(self, x):
        self.shapes.add(np.shape(x))
        return x

    def _cache_size(self):
        return len(self.shapes)


def test_recompile_guard_catches_shape_driven_recompile():
    """``test_monitor.py:195``: 0 -> 1 is the warmup build, a cache hit
    adds nothing, a new shape is one recompile (counted, logged)."""
    reg, log = MetricsRegistry(), EventLog()
    f = _Jitted()
    guard = RecompileGuard(registry=reg, events=log)
    guard.watch("f", f)
    f(np.zeros(2))
    assert guard.check() == {}
    f(np.zeros(2))
    assert guard.check() == {}
    f(np.zeros(3))
    assert guard.check() == {"f": 1}
    assert guard.recompiles == {"f": 1}
    assert guard.counts() == {"f": 2}
    assert reg.counter("recompiles_total", {"fn": "f"}).value == 1
    kinds = [e["kind"] for e in log.tail()]
    assert "compile" in kinds and "recompile" in kinds
    with pytest.raises(AssertionError):
        guard.assert_no_recompiles()


def test_recompile_guard_raise_mode():
    """``test_monitor.py:215``: ``on_recompile='raise'`` raises at the
    check that sees growth past the first build; a bad mode is refused."""
    f = _Jitted()
    guard = RecompileGuard(registry=MetricsRegistry(), events=EventLog(),
                           on_recompile="raise")
    f(np.zeros(2))
    guard.watch("f", f)
    f(np.zeros(4))
    with pytest.raises(RuntimeError, match="recompiled"):
        guard.check()
    with pytest.raises(ValueError):
        RecompileGuard(on_recompile="explode")
