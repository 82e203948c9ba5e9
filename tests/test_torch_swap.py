"""In-place weight swaps on the port's engine, on the CPU: new weights
enter a live engine through ``swap_params`` behind the scheduler's fence
(``request_swap``) with no program rebuilt and no request dropped.
Requests decoding when the swap is asked for finish on the old weights,
requests admitted after it run on the new ones, each stamped with its
version, and both sides equal JAX ``generate()`` on the matching flax
weights. A rejected swap changes no parameter, and neither a swap nor a
restart moves any tensor the programs read. Ports of
``tests/deploy_tests/test_publish.py`` (``WeightPublisher`` itself is
ROADMAP item 12).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_registry
from chainermn_torch.serving import (
    EngineFailed,
    EngineStateError,
    FCFSScheduler,
    ServingEngine,
    SwapTicket,
)

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
ENGINE = dict(n_slots=2, prefill_len=6, cache_len=32)


@pytest.fixture(scope="module")
def weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    bumped = jax.tree_util.tree_map(lambda leaf: leaf * 1.001, params)
    return lm, params, bumped


def _state(params):
    return {k: v.clone() for k, v in
            params_from_flax(jax.device_get(params)).items()}


def _engine(params, **kw):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(_state(params))
    return ServingEngine(model, device="cpu", **dict(ENGINE, **kw))


def _solo(lm, params, prompt, n):
    out = jax_generate(lm, params, jnp.asarray(prompt, jnp.int32)[None], n)
    return [int(t) for t in np.asarray(out[0])]


def _ptrs(engine):
    """Addresses of every tensor the programs read or write."""
    out = {f"param:{k}": p.data_ptr()
           for k, p in engine.model.state_dict().items()}
    for i, layer in enumerate(engine._store or ()):
        out.update({f"store{i}:{k}": t.data_ptr() for k, t in layer.items()})
    for i, layer in enumerate(engine.caches or ()):
        out.update({f"cache{i}:{k}": t.data_ptr() for k, t in layer.items()})
    progs = list(engine._prefill_progs.values()) + [engine._decode_prog]
    for prog in progs:
        out.update({f"{prog.name}:{k}": t.data_ptr()
                    for k, t in prog.inputs.items()})
    return out


def test_offline_swap_without_scheduler(weights):
    """``test_publish.py:68``: on an idle engine the swap applies at once,
    bumping the version, its gauge and ``occupancy()``; a mismatched
    state is refused before any parameter moves."""
    lm, params, bumped = weights
    engine = _engine(params)
    assert engine.weight_version == 0
    gauge = get_registry().gauge("serving_weight_version",
                                 {"engine": "serving"})
    assert engine.swap_params(_state(bumped)) == 1
    assert engine.weight_version == 1 and gauge.value == 1
    assert engine.occupancy()["weight_version"] == 1
    with pytest.raises(EngineStateError, match="keys differ"):
        engine.swap_params({})
    assert engine.weight_version == 1
    assert engine.swap_params(_state(params), version=7) == 7
    sched = FCFSScheduler(engine)
    r = sched.submit(np.array([1, 2, 3]), 5)
    sched.run_until_idle()
    assert [int(t) for t in r.output] == _solo(lm, params, [1, 2, 3], 5)


def test_swap_mid_stream_is_token_exact(weights):
    """``test_publish.py:80``: requests in flight when the swap is asked
    for drain on the OLD weights, the request queued behind the fence and
    the one after it run on the NEW weights, each stamped with its
    version; no program is rebuilt and no tensor the programs read
    moves."""
    lm, params, bumped = weights
    engine = _engine(params)
    sched = FCFSScheduler(engine)
    warm = sched.submit(np.array([1, 2, 3]), 3)
    sched.run_until_idle()
    assert warm.finished
    counts = engine.compile_counts_detailed()
    ptrs = _ptrs(engine)
    pre = [sched.submit(np.array([1, 2, 3]), 8),
           sched.submit(np.array([4, 5]), 8)]
    for _ in range(3):
        sched.step()
    assert engine.active_slots == 2
    new_state = _state(bumped)
    ticket = sched.request_swap(lambda: engine.swap_params(new_state))
    assert isinstance(ticket, SwapTicket)
    fenced = sched.submit(np.array([6, 7, 8]), 5)
    while not ticket.done:
        sched.step()
        if not ticket.done:     # nothing admitted while the fence is up
            assert fenced.slot < 0
    assert ticket.wait(0) and ticket.result == 1
    assert ticket.fence_s is not None and ticket.fence_s >= 0
    post = sched.submit(np.array([9, 10]), 5)
    sched.run_until_idle()
    for r, prompt in zip(pre, ([1, 2, 3], [4, 5])):
        assert r.finished and r.weight_version == 0
        assert [int(t) for t in r.output] == _solo(lm, params, prompt, 8)
    for r, prompt, n in ((fenced, [6, 7, 8], 5), (post, [9, 10], 5)):
        assert r.finished and r.weight_version == 1
        assert [int(t) for t in r.output] == _solo(lm, bumped, prompt, n)
    assert engine.compile_counts_detailed() == counts
    assert engine.recompiles == {}
    assert _ptrs(engine) == ptrs


def test_failed_swap_never_leaves_prior_version(weights):
    """``test_publish.py:122``: a swap with one wrong shape surfaces on
    its ticket as ``EngineStateError`` naming the entry; every parameter
    is bit-identical afterwards, in-flight work finishes on the old
    weights, and a good swap still lands."""
    lm, params, bumped = weights
    engine = _engine(params)
    sched = FCFSScheduler(engine)
    r = sched.submit(np.array([1, 2, 3]), 6)
    sched.step()
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    bad = _state(bumped)
    bad["lm_head.bias"] = torch.zeros(3)
    ticket = sched.request_swap(lambda: engine.swap_params(bad))
    while not ticket.done:
        sched.step()
    assert isinstance(ticket.error, EngineStateError)
    assert "lm_head.bias" in str(ticket.error)
    with pytest.raises(EngineStateError):
        ticket.wait(0)
    assert engine.weight_version == 0
    after = engine.model.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    # a wrong dtype is refused the same way, before anything is written
    cast = _state(bumped)
    cast["embed.weight"] = cast["embed.weight"].double()
    with pytest.raises(EngineStateError, match="embed.weight"):
        engine.swap_params(cast)
    assert all(torch.equal(before[k], after[k]) for k in before)
    sched.run_until_idle()
    assert r.finished and r.weight_version == 0
    assert [int(t) for t in r.output] == _solo(lm, params, [1, 2, 3], 6)
    good = _state(bumped)
    ticket = sched.request_swap(lambda: engine.swap_params(good))
    while not ticket.done:
        sched.step()
    assert ticket.wait(0) and engine.weight_version == 1


def test_single_pending_swap_enforced(weights):
    """``test_publish.py:155``: one swap may be pending at a time."""
    _, params, bumped = weights
    engine = _engine(params, n_slots=1)
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3]), 4)
    sched.step()                  # the slot is busy: the fence stays up
    state = _state(bumped)
    t1 = sched.request_swap(lambda: engine.swap_params(state))
    with pytest.raises(RuntimeError, match="already pending"):
        sched.request_swap(lambda: engine.swap_params(state))
    while not t1.done:
        sched.step()
    assert t1.wait(0) and engine.weight_version == 1


def test_engine_death_fails_the_fenced_ticket(weights):
    """``test_publish.py:171``: ``fail_inflight`` during a fence fails
    the pending ticket, so its waiter hears ``EngineFailed``."""
    _, params, bumped = weights
    engine = _engine(params, n_slots=1)
    sched = FCFSScheduler(engine)
    req = sched.submit(np.array([1, 2, 3]), 6)
    sched.step()
    state = _state(bumped)
    ticket = sched.request_swap(lambda: engine.swap_params(state))
    sched.fail_inflight(RuntimeError("device lost"))
    assert ticket.done and isinstance(ticket.error, EngineFailed)
    with pytest.raises(EngineFailed):
        ticket.wait(0)
    assert isinstance(req.error, EngineFailed)
    assert engine.weight_version == 0


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_restart_and_swap_keep_every_address(weights, paged):
    """``restart()`` zeroes in place and ``swap_params`` copies in place:
    no store, cache, parameter or static program input is reallocated,
    so captured graphs stay valid; the engine serves the new weights
    afterwards."""
    lm, params, bumped = weights
    kw = dict(paged=True, kv_block_size=2) if paged else dict(
        paged=False, prefix_cache_blocks=8, prefix_block_size=2)
    engine = _engine(params, **kw)
    engine.warmup()
    ptrs = _ptrs(engine)
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3, 4, 5]), 4)
    sched.run_until_idle()
    engine.restart()
    assert _ptrs(engine) == ptrs
    engine.swap_params(_state(bumped))
    assert _ptrs(engine) == ptrs
    r = sched.submit(np.array([1, 2, 3, 4, 5]), 4)
    sched.run_until_idle()
    assert [int(t) for t in r.output] == _solo(lm, bumped,
                                               [1, 2, 3, 4, 5], 4)
    assert engine.recompiles == {}


@pytest.mark.parametrize("paged", [True, False], ids=["paged", "dense"])
def test_swap_drops_prefixes_cached_on_old_weights(weights, paged):
    """A prompt cached under the old weights is not a hit after a swap:
    its KV came from those weights. The same prompt afterwards prefills
    anew and equals ``generate()`` on the new weights."""
    lm, params, bumped = weights
    kw = dict(paged=True, kv_block_size=2) if paged else dict(
        paged=False, prefix_cache_blocks=8, prefix_block_size=2)
    engine = _engine(params, **kw)
    sched = FCFSScheduler(engine)
    prompt = np.array([1, 2, 3, 4, 5])
    sched.submit(prompt, 3)
    sched.run_until_idle()
    assert engine.prefix_cache.match(prompt) is not None
    ticket = sched.request_swap(lambda: engine.swap_params(_state(bumped)))
    r = sched.submit(prompt, 4)
    sched.run_until_idle()
    assert ticket.done and ticket.error is None
    assert r.weight_version == 1
    assert [int(t) for t in r.output] == _solo(lm, bumped, list(prompt), 4)
