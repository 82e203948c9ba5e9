"""Weighted-fair admission, the brownout ladder, deadlines and
class-ordered preemption in the port (mirrors
``tests/serving_tests/test_fairness.py`` without its two fuzzed soaks).

The policy units drive :class:`FairAdmission` and :class:`BrownoutPolicy`
with deterministic clocks. The scheduler tests run the port's engines on
flax weights converted by ``params_from_flax`` (f32, CPU), and every
token stream they check is solo JAX ``generate()``'s.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_event_log
from chainermn_torch.resilience.cutpoints import SERVING_ADMIT_FAIR
from chainermn_torch.resilience.faults import FaultInjector
from chainermn_torch.serving import (
    BROWNOUT_LEVELS,
    BrownoutPolicy,
    DeadlineExceededError,
    FairAdmission,
    FCFSScheduler,
    QueueFullError,
    Request,
    RequestState,
    ServingEngine,
    request_cost,
)

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)


def _req(i, tenant="default", priority="interactive", plen=4, max_new=4):
    r = Request(prompt=np.arange(1, plen + 1, dtype=np.int32),
                max_new_tokens=max_new, tenant=tenant, priority=priority)
    r.id = i
    return r


# --------------------------------------------------------------------- #
# FairAdmission units                                                    #
# --------------------------------------------------------------------- #

def test_drr_alternates_equal_weight_tenants():
    fa = FairAdmission()
    queue = [_req(i, tenant="a") for i in range(4)] + \
            [_req(4 + i, tenant="b") for i in range(4)]
    served = []
    while queue:
        pick = fa.select(queue)
        served.append(pick.tenant)
        queue.remove(pick)
    assert served[:6].count("a") == 3 and served[:6].count("b") == 3
    assert all(served[i] != served[i + 1] for i in range(5))


def test_drr_weighted_service_rates():
    fa = FairAdmission(tenant_weights={"heavy": 3.0, "light": 1.0},
                       quantum_tokens=4.0)
    queue = [_req(i, tenant=("heavy" if i % 2 else "light"))
             for i in range(32)]
    first_16 = []
    while len(first_16) < 16:
        pick = fa.select(queue)
        first_16.append(pick.tenant)
        queue.remove(pick)
    assert first_16.count("heavy") >= 2 * first_16.count("light")
    assert first_16.count("light") >= 2


def test_share_feedback_shrinks_effective_weight():
    fa = FairAdmission(tenant_weights={"hog": 2.0, "quiet": 1.0})
    assert fa.effective_weight("hog") == pytest.approx(2.0)
    fa.set_shares({"hog": 9.0, "quiet": 1.0})
    assert fa.tenant_share("hog") == pytest.approx(0.9)
    assert fa.effective_weight("hog") == pytest.approx(2.0 * 0.1)
    assert fa.effective_weight("quiet") == pytest.approx(1.0 * 0.9)
    fa.set_shares({"hog": 1.0})
    assert fa.effective_weight("hog") == pytest.approx(2.0 * 0.05)


def test_strict_class_order_and_pause_batch():
    fa = FairAdmission()
    batch_first = [_req(0, tenant="a", priority="batch"),
                   _req(1, tenant="b", priority="interactive")]
    assert fa.select(batch_first).id == 1
    only_batch = [_req(0, tenant="a", priority="batch")]
    assert fa.select(only_batch).id == 0
    assert fa.select(only_batch, allow_batch=False) is None
    assert fa.select([]) is None


def test_lowest_weight_tenant_is_deterministic():
    fa = FairAdmission(tenant_weights={"a": 2.0, "b": 0.5, "c": 0.5})
    assert fa.lowest_weight_tenant(["a", "b", "c"]) == "b"
    assert fa.lowest_weight_tenant([]) is None
    fa.set_shares({"a": 1.0})
    assert fa.lowest_weight_tenant(["a", "b"]) == "a"


def test_request_cost_is_prompt_plus_budget():
    assert request_cost(_req(0, plen=5, max_new=7)) == 12.0


# --------------------------------------------------------------------- #
# BrownoutPolicy units                                                   #
# --------------------------------------------------------------------- #

def test_brownout_ladder_levels_and_properties():
    bo = BrownoutPolicy(queue_high=None, max_new_cap=3)
    assert bo.level == 0 and not bo.pause_batch
    for lvl in (1, 2, 3, 4):
        assert bo.step_up("test", now=float(lvl))
        assert bo.level == lvl
    assert not bo.step_up("test", now=5.0)
    assert bo.saturated
    assert bo.pause_batch and bo.force_single_token
    assert bo.effective_max_new_cap == 3 and bo.shed_lowest
    assert bo.relieve(now=6.0) == 4
    assert bo.level == 0 and bo.effective_max_new_cap is None
    assert not bo.step_down("test", now=7.0)
    steps = [e for e in get_event_log().tail(64)
             if e["kind"] == "brownout_step"]
    assert len(steps) >= 8
    assert steps[-1]["level"] == 0 and steps[-1]["direction"] == "down"
    assert steps[-1]["reason"] == "capacity_arrived"
    assert all(e["action"] in BROWNOUT_LEVELS for e in steps)


def test_brownout_max_level_clamps_shed():
    bo = BrownoutPolicy(queue_high=None, max_level=2)
    bo.step_up("a", now=0.0)
    bo.step_up("b", now=1.0)
    assert bo.saturated and not bo.step_up("c", now=2.0)
    assert bo.level == 2 and not bo.shed_lowest
    with pytest.raises(ValueError, match="max_level"):
        BrownoutPolicy(max_level=0)
    with pytest.raises(ValueError, match="max_level"):
        BrownoutPolicy(max_level=9)


def test_brownout_auto_observe_hysteresis():
    bo = BrownoutPolicy(queue_high=4.0, up_after_s=1.0,
                        down_after_s=2.0, cooldown_s=1.0)
    bo.auto_observe(9, now=0.0)
    assert bo.level == 0
    bo.auto_observe(9, now=1.1)
    assert bo.level == 1
    bo.auto_observe(9, now=1.5)
    assert bo.level == 1
    bo.auto_observe(9, now=2.7)
    assert bo.level == 2
    bo.auto_observe(0, now=3.0)
    assert bo.level == 2
    bo.auto_observe(0, now=5.1)
    assert bo.level == 1
    bo.auto_observe(9, now=5.2)
    bo.auto_observe(0, now=5.3)
    assert bo.level == 1
    bo.auto_observe(0, now=7.4)
    assert bo.level == 0


def test_controller_owned_policy_ignores_auto_observe():
    bo = BrownoutPolicy(queue_high=None)
    bo.auto_observe(10_000, now=0.0)
    bo.auto_observe(10_000, now=99.0)
    assert bo.level == 0
    j = bo.to_json()
    assert j["level"] == 0 and j["action"] == "healthy"


# --------------------------------------------------------------------- #
# scheduler integration (dense engine)                                   #
# --------------------------------------------------------------------- #

def _converted(max_len):
    lm = JaxLM(vocab_size=17, d_model=16, n_heads=4, n_layers=1,
               max_len=max_len, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    model = TransformerLM(vocab_size=17, d_model=16, n_heads=4, n_layers=1,
                          max_len=max_len, compute_dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return lm, params, model


@pytest.fixture(scope="module")
def dense_model():
    return _converted(32)[2]


def make(model, n_slots=2, **kw):
    engine = ServingEngine(model, n_slots=n_slots, prefill_len=6,
                           cache_len=24, paged=False, device="cpu")
    return engine, FCFSScheduler(engine, **kw)


def test_submit_rejects_unknown_priority(dense_model):
    _, sched = make(dense_model)
    with pytest.raises(ValueError, match="priority"):
        sched.submit(np.array([1, 2]), 2, priority="best_effort")
    assert not sched.has_work


def test_interactive_admits_before_older_batch(dense_model):
    _, sched = make(dense_model, n_slots=1, fair=True)
    order = []
    b = sched.submit(np.array([1]), 2, priority="batch", tenant="bulk",
                     stream_cb=lambda t: order.append("batch"))
    i1 = sched.submit(np.array([2]), 2, priority="interactive",
                      stream_cb=lambda t: order.append("inter"))
    i2 = sched.submit(np.array([3]), 2, priority="interactive",
                      stream_cb=lambda t: order.append("inter"))
    sched.run_until_idle()
    assert order == ["inter"] * 4 + ["batch"] * 2
    assert all(r.state is RequestState.DONE for r in (b, i1, i2))


def test_fair_admission_interleaves_burst_and_quiet(dense_model):
    _, sched = make(dense_model, n_slots=1, fair=True)
    admitted = []
    for i in range(4):
        sched.submit(np.array([1 + i]), 1, tenant="burst",
                     stream_cb=lambda t: admitted.append("burst"))
    sched.submit(np.array([9]), 1, tenant="quiet",
                 stream_cb=lambda t: admitted.append("quiet"))
    sched.run_until_idle()
    assert "quiet" in admitted[:3]


def test_queue_full_carries_retry_after_hint(dense_model):
    _, sched = make(dense_model, max_queue=1)
    sched.submit(np.array([1]), 2)
    with pytest.raises(QueueFullError) as exc:
        sched.submit(np.array([2]), 2)
    assert exc.value.retry_after_s is not None
    assert exc.value.retry_after_s >= 0.05


def test_decode_deadline_retires_at_step_boundary(dense_model):
    """A DECODING request past its deadline is shed at the next step
    boundary with its slot freed; a QUEUED one past its deadline too."""
    engine, sched = make(dense_model, n_slots=1)
    victim = sched.submit(np.array([1, 2]), 16, deadline_s=0.15)
    waiter = sched.submit(np.array([3, 4]), 2)
    queued = sched.submit(np.array([5, 6]), 2, deadline_s=0.15)
    sched.step()
    assert victim.state is RequestState.DECODE
    time.sleep(0.2)
    sched.step()
    assert victim.state is RequestState.ERRORED
    assert isinstance(victim.error, DeadlineExceededError)
    assert victim.error.retry_after_s is not None
    assert "decoded token" in str(victim.error)
    with pytest.raises(DeadlineExceededError):
        victim.wait(timeout=1)
    assert isinstance(queued.error, DeadlineExceededError)
    sched.run_until_idle()
    assert waiter.state is RequestState.DONE
    sheds = [e for e in get_event_log().tail(64)
             if e["kind"] == "shed" and e.get("req") == victim.id]
    assert sheds and sheds[-1]["where"] == "decode"
    assert sched.metrics.report()["requests_shed"] >= 2
    assert engine.free_slots == {0}


def test_brownout_l4_sheds_lowest_weight_tenant_queued_work(dense_model):
    bo = BrownoutPolicy(queue_high=None, down_after_s=0.5)
    _, sched = make(dense_model, n_slots=1, brownout=bo,
                    tenant_weights={"gold": 2.0, "cheap": 0.5})
    inflight = sched.submit(np.array([1]), 4, tenant="gold")
    sched.step()
    assert inflight.state is RequestState.DECODE
    shed_a = sched.submit(np.array([2]), 2, tenant="cheap")
    shed_b = sched.submit(np.array([3]), 2, tenant="cheap")
    kept = sched.submit(np.array([4]), 2, tenant="gold")
    for _ in range(4):
        bo.step_up("test")
    assert bo.shed_lowest
    sched.step()
    for r in (shed_a, shed_b):
        assert r.state is RequestState.ERRORED
        assert isinstance(r.error, QueueFullError)
        assert r.error.retry_after_s >= bo.down_after_s
    assert inflight.state in (RequestState.DECODE, RequestState.DONE)
    bo.relieve()
    sched.run_until_idle()
    assert kept.state is RequestState.DONE
    assert inflight.state is RequestState.DONE
    ev = [e for e in get_event_log().tail(64)
          if e["kind"] == "shed" and e.get("where") == "brownout"]
    assert len(ev) >= 2 and all(e["tenant"] == "cheap" for e in ev[-2:])


def test_admit_fair_chaos_cell_errors_only_picked_request(dense_model):
    _, sched = make(dense_model, n_slots=2, fair=True)
    inj = FaultInjector(seed=0).install()
    try:
        inj.arm(SERVING_ADMIT_FAIR, kind="raise", times=1)
        doomed = sched.submit(np.array([1, 2]), 3, tenant="a")
        healthy = sched.submit(np.array([3, 4]), 3, tenant="b")
        sched.run_until_idle()
    finally:
        inj.uninstall()
    assert doomed.state is RequestState.ERRORED
    with pytest.raises(Exception, match="admission failed"):
        doomed.wait(timeout=1)
    assert healthy.state is RequestState.DONE
    assert len(healthy.tokens) == 3


# --------------------------------------------------------------------- #
# paged rig: brownout L2/L3 and class-ordered preemption                 #
# --------------------------------------------------------------------- #

PROMPTS = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [10, 11]]
MAX_NEW = 6


@pytest.fixture(scope="module")
def paged_rig():
    """A paged engine with ``decode_window=4`` (wider than the 2-token
    blocks: the multi-append path) and each prompt's solo JAX
    ``generate()`` stream."""
    lm, params, model = _converted(64)
    engine = ServingEngine(model, n_slots=2, prefill_len=6, paged=True,
                           kv_blocks=64, kv_block_size=2, decode_window=4,
                           cache_len=48, device="cpu")
    engine.warmup()
    cache = {}

    def solo(prompt, n):
        key = (tuple(prompt), n)
        if key not in cache:
            out = np.asarray(jax_generate(
                lm, params, jnp.asarray(prompt, jnp.int32)[None], n)[0])
            cache[key] = [int(t) for t in out[len(prompt):]]
        return cache[key]

    return engine, solo


def test_windowed_rig_matches_solo(paged_rig):
    engine, solo = paged_rig
    sched = FCFSScheduler(engine)
    reqs = [sched.submit(np.asarray(p, np.int32), MAX_NEW) for p in PROMPTS]
    sched.run_until_idle()
    assert [r.tokens for r in reqs] == [solo(p, MAX_NEW) for p in PROMPTS]


def test_brownout_l2_single_token_parity(paged_rig):
    """L2 runs the single-token step instead of the window: the same
    streams, one token a round."""
    engine, solo = paged_rig
    bo = BrownoutPolicy(queue_high=None)
    bo.step_up("test")
    bo.step_up("test")
    assert bo.force_single_token
    sched = FCFSScheduler(engine, brownout=bo)
    reqs = [sched.submit(np.asarray(p, np.int32), MAX_NEW,
                         priority="interactive") for p in PROMPTS]
    sched.step()
    sched.step()
    # first token, then one a round (a window would have given 1 + 4)
    assert max(len(r.tokens) for r in reqs) == 3
    sched.run_until_idle()
    assert [r.tokens for r in reqs] == [solo(p, MAX_NEW) for p in PROMPTS]


def test_brownout_l3_cap_yields_prefix_of_full_stream(paged_rig):
    engine, solo = paged_rig
    bo = BrownoutPolicy(queue_high=None, max_new_cap=2)
    for _ in range(3):
        bo.step_up("test")
    assert bo.effective_max_new_cap == 2
    sched = FCFSScheduler(engine, brownout=bo)
    reqs = [sched.submit(np.asarray(p, np.int32), MAX_NEW)
            for p in PROMPTS]
    sched.run_until_idle()
    for r, p in zip(reqs, PROMPTS):
        assert r.state is RequestState.DONE
        assert r.tokens == solo(p, MAX_NEW)[:2]


def test_preempt_key_orders_batch_then_overshare_then_recency(paged_rig):
    engine, _ = paged_rig
    fa = FairAdmission()
    fa.set_shares({"hog": 3.0, "quiet": 1.0})
    sched = FCFSScheduler(engine, fair=fa)
    inter_old = _req(1, tenant="quiet", priority="interactive")
    inter_hog = _req(2, tenant="hog", priority="interactive")
    batch_old = _req(3, tenant="quiet", priority="batch")
    batch_new = _req(4, tenant="quiet", priority="batch")
    pool = [inter_old, inter_hog, batch_old, batch_new]
    assert max(pool, key=sched._preempt_key) is batch_new
    assert max([inter_old, inter_hog], key=sched._preempt_key) is inter_hog
    assert max([inter_old, _req(9, tenant="quiet")],
               key=sched._preempt_key).id == 9


def test_class_preemption_replays_batch_to_identical_tokens(paged_rig):
    """With an interactive and a (older) batch request decoding, the
    batch one is the victim; its replay reproduces its solo stream."""
    engine, solo = paged_rig
    long_new = 12
    sched = FCFSScheduler(engine, fair=True)
    batch = sched.submit(np.asarray(PROMPTS[1], np.int32), long_new,
                         priority="batch", tenant="bulk")
    sched.step()
    inter = sched.submit(np.asarray(PROMPTS[0], np.int32), long_new,
                         priority="interactive", tenant="quiet")
    sched.step()
    by_slot = dict(sched._by_slot)
    assert batch.slot in by_slot and inter.slot in by_slot
    victim = max(by_slot.values(), key=sched._preempt_key)
    assert victim is batch
    sched._preempt(victim, reason="kv_pool_dry")
    assert batch.state is RequestState.QUEUED and batch.tokens == []
    sched.run_until_idle()
    assert batch.state is RequestState.DONE
    assert inter.state is RequestState.DONE
    assert batch.tokens == solo(PROMPTS[1], long_new)
    assert inter.tokens == solo(PROMPTS[0], long_new)
    assert sched.metrics._c_class_preempt["batch"].value == 1
    assert sched.metrics._c_class_preempt["interactive"].value == 0
