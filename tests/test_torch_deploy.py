"""The port's deploy layer against the JAX package's: ``VersionLog`` and
``WeightPublisher`` (ports of ``tests/deploy_tests/test_versions.py`` and
``test_publish.py``). The same record sequences give the same logs and
rollback targets; an offline publish, a token-exact swap in the middle of
live decoding, a failed swap, the single pending swap, an engine dying
with a swap fenced and a blocking publish on the driving thread behave as
the reference's, and every stream equals JAX ``generate()`` on the flax
weights of its version (greedy, float32, exact tokens)."""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_isolation import fresh_telemetry

from chainermn_tpu.deploy import PublishError as JPublishError
from chainermn_tpu.deploy import VersionLog as JVersionLog
from chainermn_tpu.deploy import WeightPublisher as JPublisher
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.models import generate as jax_generate
from chainermn_tpu.serving import ServingEngine as JEngine
from chainermn_torch.deploy import (
    PublishError,
    VersionLog,
    WeightPublisher,
    WeightVersion,
)
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.resilience import FaultInjector
from chainermn_torch.resilience.cutpoints import DEPLOY_PUBLISH
from chainermn_torch.serving import (
    EngineFailed,
    EngineStateError,
    FCFSScheduler,
    ServingEngine,
)

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
ENGINE = dict(n_slots=2, prefill_len=6, cache_len=32)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


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
    return ServingEngine(model, paged=False, device="cpu",
                         **dict(ENGINE, **kw))


_SOLO: dict = {}


def _solo(lm, params, prompt, n):
    key = (id(params), tuple(prompt), n)
    if key not in _SOLO:
        out = jax_generate(lm, params, jnp.asarray(prompt, jnp.int32)[None],
                           n)
        _SOLO[key] = [int(t) for t in np.asarray(out[0])]
    return _SOLO[key]


# --------------------------------------------------------------------- #
# the version log                                                        #
# --------------------------------------------------------------------- #


def _log_run(log_cls, seed):
    rng = np.random.default_rng(seed)
    log = log_cls()
    out = []
    version = 0
    for _ in range(60):
        kind = rng.choice(["bump", "same", "back", "read"])
        if kind == "bump":
            version += 1
        elif kind == "back" and version:
            version -= int(rng.integers(1, version + 1))
        if kind != "read":
            step = int(rng.integers(0, 100)) if rng.random() > 0.5 else None
            log.record(version, source=str(rng.choice(
                ["publish", "canary", "rollback", "restore"])), step=step)
        t = log.rollback_target()
        out.append(((log.current.version, log.current.source,
                     log.current.step), len(log),
                    None if t is None else (t.version, t.source, t.step)))
    out.append([(e.version, e.source, e.step) for e in log.history()])
    return out


@pytest.mark.parametrize("seed", range(3))
def test_version_log_records_as_the_reference(seed):
    assert _log_run(VersionLog, seed) == _log_run(JVersionLog, seed)


def test_version_log_reference_cases():
    log = VersionLog()
    assert (len(log), log.current.version, log.current.source,
            log.current.step) == (1, 0, "init", None)
    assert log.rollback_target() is None
    h = log.history()
    log.record(1, source="canary")
    assert len(h) == 1 and len(log.history()) == 2
    log.record(1, source="publish")
    assert (log.rollback_target().version,
            log.rollback_target().source) == (0, "init")
    log.record(2, source="canary")
    assert (log.rollback_target().version,
            log.rollback_target().source) == (1, "publish")
    times = [v.wall_time for v in log.history()]
    assert times == sorted(times)
    with pytest.raises(AttributeError):
        WeightVersion(3, "publish").version = 4


def test_version_log_concurrent_records_all_land():
    log = VersionLog()

    def worker(base):
        for i in range(25):
            log.record(base * 25 + i, source="publish")

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(log) == 1 + 8 * 25


# --------------------------------------------------------------------- #
# the publisher                                                          #
# --------------------------------------------------------------------- #


def test_offline_publish_as_the_reference(weights):
    """``scheduler=None``: the swap applies at once on an idle engine,
    bumping the version, ``occupancy()`` and the log; a structure
    mismatch fails in the commit with the engine untouched."""
    lm, params, bumped = weights

    def run(engine, publisher_cls, log_cls, new, bad, err_cls):
        log = log_cls()
        pub = publisher_cls(engine, log=log)
        out = [engine.weight_version, pub.publish(new, step=123),
               engine.weight_version,
               engine.occupancy()["weight_version"],
               (log.current.version, log.current.source, log.current.step)]
        with pytest.raises(err_cls):
            pub.publish(bad)
        out.append(engine.weight_version)
        return out

    got = run(_engine(params), WeightPublisher, VersionLog, _state(bumped),
              {}, PublishError)
    want = run(JEngine(lm, params, **ENGINE), JPublisher, JVersionLog,
               bumped, {"params": {}}, JPublishError)
    assert got == want == [0, 1, 1, 1, (1, "publish", 123), 1]


def test_swap_mid_stream_is_token_exact(weights):
    """Requests decoding when the publish lands finish on the old
    weights, the fenced and later ones run on the new weights, each
    stamped with its version; no program is rebuilt."""
    lm, params, bumped = weights
    engine = _engine(params)
    sched = FCFSScheduler(engine)
    pub = WeightPublisher(engine, sched)
    warm = sched.submit(np.array([1, 2, 3]), 3)
    sched.run_until_idle()
    assert warm.finished
    counts = dict(engine.compile_counts_detailed())
    pre = [sched.submit(np.array([1, 2, 3]), 8),
           sched.submit(np.array([4, 5]), 8)]
    for _ in range(3):
        sched.step()
    assert engine.active_slots == 2
    handle = pub.publish_async(_state(bumped), step=7)
    fenced = sched.submit(np.array([6, 7, 8]), 5)
    while not handle.done:
        sched.step()
    assert handle.wait(0) == 1
    assert handle.fence_s is not None and handle.commit_s >= 0
    post = sched.submit(np.array([9, 10]), 5)
    sched.run_until_idle()
    for r, prompt in zip(pre, ([1, 2, 3], [4, 5])):
        assert r.finished and r.weight_version == 0
        assert [int(t) for t in r.output] == _solo(lm, params, prompt, 8)
    for r, prompt in ((fenced, [6, 7, 8]), (post, [9, 10])):
        assert r.finished and r.weight_version == 1
        assert [int(t) for t in r.output] == _solo(lm, bumped, prompt, 5)
    assert dict(engine.compile_counts_detailed()) == counts
    assert engine.recompiles == {}
    assert pub.log.current.step == 7


def test_commit_casts_to_the_stored_dtype_and_snapshots(weights):
    """The commit copies into the dtypes the engine stores (float64 in,
    float32 stored) and is a snapshot: writes to the caller's tensors
    after the commit never reach the engine."""
    lm, params, bumped = weights
    engine = _engine(params)
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3]), 6)
    sched.step()
    new = {k: v.double() for k, v in _state(bumped).items()}
    handle = WeightPublisher(engine, sched).publish_async(new)
    for v in new.values():
        v.zero_()
    while not handle.done:
        sched.step()
    assert handle.wait(0) == 1
    for k, v in engine.model.state_dict().items():
        assert v.dtype == torch.float32
        assert torch.equal(v, _state(bumped)[k]), k
    r = sched.submit(np.array([6, 7, 8]), 5)
    sched.run_until_idle()
    assert [int(t) for t in r.output] == _solo(lm, bumped, [6, 7, 8], 5)


def test_failed_swap_never_leaves_prior_version(weights):
    """A bad publish (one tensor of the wrong shape) surfaces on the
    handle as the engine's check; in-flight work finishes on the old
    weights and a good publish after it still lands."""
    lm, params, bumped = weights
    engine = _engine(params)
    sched = FCFSScheduler(engine)
    pub = WeightPublisher(engine, sched)
    r = sched.submit(np.array([1, 2, 3]), 6)
    sched.step()
    bad = _state(params)
    name = next(k for k, v in bad.items() if v.ndim == 1)
    bad[name] = torch.zeros(3)
    handle = pub.publish_async(bad)
    while not handle.done:
        sched.step()
    assert isinstance(handle.error, EngineStateError)
    with pytest.raises(PublishError):
        handle.wait(0)
    assert engine.weight_version == 0
    sched.run_until_idle()
    assert r.finished and r.weight_version == 0
    assert [int(t) for t in r.output] == _solo(lm, params, [1, 2, 3], 6)
    good = pub.publish_async(_state(bumped))
    while not good.done:
        sched.step()
    assert good.wait(0) == 1 and engine.weight_version == 1


def test_commit_fault_leaves_the_engine_untouched(weights):
    """An injected ``deploy.publish`` fault fails the commit before any
    fence is asked for."""
    _, params, bumped = weights
    engine = _engine(params)
    sched = FCFSScheduler(engine)
    inj = FaultInjector(seed=0)
    inj.arm(DEPLOY_PUBLISH, kind="raise", times=1)
    with inj, pytest.raises(PublishError, match="during commit"):
        WeightPublisher(engine, sched).publish_async(_state(bumped))
    assert not sched.has_work and engine.weight_version == 0
    assert [p for p, _ in inj.fired_log] == [DEPLOY_PUBLISH]


def test_single_pending_swap_enforced(weights):
    _, params, bumped = weights
    engine = _engine(params, n_slots=1)
    sched = FCFSScheduler(engine)
    sched.submit(np.array([1, 2, 3]), 4)
    sched.step()
    pub = WeightPublisher(engine, sched)
    h1 = pub.publish_async(_state(bumped))
    with pytest.raises(RuntimeError, match="already pending"):
        pub.publish_async(_state(params))
    while not h1.done:
        sched.step()
    assert h1.wait(0) == 1


def test_engine_death_fails_the_fenced_ticket(weights):
    """``fail_inflight`` during a fence fails the pending ticket: a
    blocked publisher hears ``EngineFailed`` instead of hanging."""
    _, params, bumped = weights
    engine = _engine(params, n_slots=1)
    sched = FCFSScheduler(engine)
    pub = WeightPublisher(engine, sched)
    sched.submit(np.array([1, 2, 3]), 6)
    sched.step()
    handle = pub.publish_async(_state(bumped))
    assert not handle.done
    waiter_err = []

    def waiter():
        try:
            handle.wait(30)
        except PublishError as e:
            waiter_err.append(e)

    t = threading.Thread(target=waiter)
    t.start()
    sched.fail_inflight(RuntimeError("replica died"))
    t.join(30)
    assert not t.is_alive()
    assert waiter_err and isinstance(waiter_err[0].__cause__, EngineFailed)
    assert engine.weight_version == 0


def test_blocking_publish_on_driving_thread_times_out(weights):
    """A blocking publish from the thread that steps the scheduler can
    never drain its own fence: it times out with advice, the ticket stays
    pending, and stepping afterwards lands the swap."""
    _, params, bumped = weights
    engine = _engine(params, n_slots=1)
    sched = FCFSScheduler(engine)
    pub = WeightPublisher(engine, sched)
    sched.submit(np.array([1, 2, 3]), 4)
    sched.step()
    with pytest.raises(PublishError, match="still fenced"):
        pub.publish(_state(bumped), timeout=0.2)
    while sched.has_work:
        sched.step()
    assert engine.weight_version == 1
