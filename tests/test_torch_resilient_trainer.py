"""The port's step-level recovery (``chainermn_torch/resilience/trainer.py``)
on its checkpointer: the cases of ``tests/resilience_tests/test_trainer.py``
(crash-resume bit for bit, cross-launch resume, the restore budget, retry
of transient checkpoint I/O, torn and half-written snapshots, the
once-per-episode dump, async saves, a prefetched iterator), the
failure-episode trace and recovery metrics, and one parity case: a tiny
LM with the JAX LM's weights through JAX ``resilient_fit`` and the
port's, with the same injected fault."""

import io
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_isolation import fresh_telemetry

import chainermn_tpu
from chainermn_torch import (
    SerialIterator,
    create_communicator,
    create_multi_node_checkpointer,
    create_multi_node_optimizer,
)
from chainermn_torch.dataflow import DevicePrefetcher
from chainermn_torch.extensions.checkpoint import to_tensors
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.monitor import get_event_log, get_registry, get_tracer
from chainermn_torch.resilience import (
    FaultInjector,
    InjectedFault,
    ResilientTrainer,
    RetryPolicy,
    resilient_fit,
)
from chainermn_torch.training import lm_train_step
from chainermn_tpu import resilience as jax_resilience
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.training import jit_lm_train_step

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def comm():
    c = create_communicator("naive", device="cpu")
    yield c
    c.finalize()


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


def _dataset():
    return [float(i) for i in range(20)]


def _iterator():
    return SerialIterator(_dataset(), batch_size=3, shuffle=True, seed=5)


def _step(state, batch):
    """Deterministic step over a state that includes a generator's state:
    the key must round-trip through the snapshot for a bit-exact resume
    (a snapshot holds it as a numpy array)."""
    gen = torch.Generator()
    gen.set_state(torch.as_tensor(state["key"], dtype=torch.uint8))
    noise = float(torch.rand((), generator=gen))
    w = state["w"] * 0.9 + float(np.mean(batch)) + 0.01 * noise
    return {"w": w, "key": gen.get_state()}


def _init_state():
    return {"w": 0.0, "key": torch.Generator().manual_seed(42).get_state()}


def _run(tmp_path, comm, n_steps, *, name, injector=None, save_every=4,
         **fit_kw):
    ckpt = create_multi_node_checkpointer(name, comm, path=str(tmp_path))
    traj: list[tuple[int, float]] = []

    def on_step(i, state):
        traj.append((i, state["w"]))

    if injector is not None:
        with injector:
            state, report = resilient_fit(
                _step, _init_state(), _iterator(), n_steps, ckpt,
                save_every=save_every, on_step=on_step, **fit_kw)
    else:
        state, report = resilient_fit(
            _step, _init_state(), _iterator(), n_steps, ckpt,
            save_every=save_every, on_step=on_step, **fit_kw)
    return state, report, traj


def _final(traj):
    """Each step's last value; a replayed step must repeat its first."""
    final = {}
    for i, w in traj:
        if i in final:
            assert w == final[i], f"replay of step {i} diverged"
        final[i] = w
    return final


def _same_key(a, b):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_crash_resume_bit_exact(tmp_path, comm):
    ref_state, ref_report, ref_traj = _run(
        tmp_path / "ref", comm, 12, name="ref")
    assert ref_report["failures"] == 0 and ref_report["restores"] == 0
    inj = FaultInjector()
    inj.arm("trainer.step", kind="raise", after=7, times=1)  # fails at i=7
    state, report, traj = _run(tmp_path / "crash", comm, 12, name="crash",
                               injector=inj)
    assert report["failures"] == 1 and report["restores"] == 1
    assert report["mttr_s"] and report["mttr_s"][0] > 0
    assert _final(traj) == dict(ref_traj)
    assert state["w"] == ref_state["w"]
    _same_key(state["key"], ref_state["key"])


def test_cross_launch_resume(tmp_path, comm):
    ref_state, _, ref_traj = _run(tmp_path / "r", comm, 10, name="x")
    _run(tmp_path / "s", comm, 6, name="y")           # the first launch
    state, report, traj = _run(tmp_path / "s", comm, 10, name="y")
    assert report["resumed_from"] == 6
    assert [i for i, _ in traj] == [6, 7, 8, 9]
    assert dict(traj) == {i: w for i, w in ref_traj if i >= 6}
    assert state["w"] == ref_state["w"]


def test_restore_budget_exhausted_reraises(tmp_path, comm):
    c = get_registry().counter("trainer_failures_total")
    before = c.value
    inj = FaultInjector()
    inj.arm("trainer.step", kind="raise", times=None)  # every step fails
    with pytest.raises(InjectedFault):
        _run(tmp_path, comm, 8, name="doomed", injector=inj,
             max_restores=2, dump_on_failure=False)
    # the first failure, one a restore attempt, and the one that gives up
    assert c.value == before + 3
    evs = [e["kind"] for e in get_event_log().tail(100)]
    assert "trainer_giving_up" in evs


def test_transient_checkpoint_io_absorbed_by_retry(tmp_path, comm):
    inj = FaultInjector()
    inj.arm("checkpoint.save", kind="raise", after=1, times=1)
    state, report, _ = _run(
        tmp_path, comm, 8, name="t", injector=inj,
        retry=RetryPolicy(3, base_delay_s=0.001, jitter=0))
    assert report["failures"] == 0 and report["restores"] == 0
    assert inj.fired_log == [("checkpoint.save", "raise")]


def test_kill_mid_write_resume_succeeds(tmp_path, comm):
    ckpt = create_multi_node_checkpointer("k", comm, path=str(tmp_path))
    ckpt.save({"w": 1.0}, 1)
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=1)
    with inj:
        with pytest.raises(InjectedFault):
            ckpt.save({"w": 2.0}, 2)
    assert os.path.exists(ckpt.filename(2) + ".tmp")   # torn tmp left
    assert not os.path.exists(ckpt.filename(2))        # rename never ran
    ckpt2 = create_multi_node_checkpointer("k", comm, path=str(tmp_path))
    assert not os.path.exists(ckpt.filename(2) + ".tmp")  # startup sweep
    state, it = ckpt2.maybe_load()
    assert it == 1 and state["w"] == 1.0


def test_mid_write_crash_absorbed_by_retry(tmp_path, comm):
    ckpt = create_multi_node_checkpointer(
        "kr", comm, path=str(tmp_path),
        retry=RetryPolicy(3, base_delay_s=0.001, jitter=0))
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="raise", times=1)
    with inj:
        ckpt.save({"w": 2.0}, 2)                       # 2nd attempt lands
    state, it = ckpt.maybe_load()
    assert it == 2 and state["w"] == 2.0


def test_torn_write_detected_and_skipped_back(tmp_path, comm):
    c = get_registry().counter("checkpoint_corrupt_total", {"name": "torn"})
    before = c.value
    ckpt = create_multi_node_checkpointer("torn", comm, path=str(tmp_path))
    ckpt.save({"w": 1.0}, 1)
    ckpt.save({"w": 2.0}, 2)
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="torn_write", frac=0.5, times=1)
    with inj:
        ckpt.save({"w": 3.0}, 3)                       # silently truncated
    assert os.path.exists(ckpt.filename(3))            # the rename DID run
    state, it = ckpt.maybe_load()
    assert it == 2 and state["w"] == 2.0               # skipped back
    assert c.value == before + 1
    evs = [e for e in get_event_log().tail(100)
           if e["kind"] == "checkpoint_corrupt"]
    assert evs and evs[-1]["iteration"] == 3


def test_legacy_footerless_snapshot_still_loads(tmp_path, comm):
    ckpt = create_multi_node_checkpointer("leg", comm, path=str(tmp_path))
    with open(ckpt.filename(5), "wb") as f:            # a footerless file
        pickle.dump({"world_size": 1, "state": {"w": 5.0}}, f, protocol=4)
    state, it = ckpt.maybe_load()
    assert it == 5 and state["w"] == 5.0


def test_resilient_fit_survives_torn_write_then_crash(tmp_path, comm):
    """Iteration 8's snapshot is torn and the next step crashes: recovery
    lands on iteration 4 (the newest intact snapshot) and the run still
    ends bit for bit on the reference."""
    ref_state, _, _ = _run(tmp_path / "ref", comm, 12, name="ref")
    inj = FaultInjector()
    inj.arm("checkpoint.write", kind="torn_write", frac=0.6, times=1,
            after=2)                                   # 3rd write = iter 8
    inj.arm("trainer.step", kind="raise", after=9, times=1)   # fails at i=9
    state, report, _ = _run(tmp_path / "t", comm, 12, name="t",
                            injector=inj)
    assert report["failures"] == 1 and report["restores"] == 1
    assert state["w"] == ref_state["w"]
    evs = [e for e in get_event_log().tail(200) if e["kind"] ==
           "trainer_restore"]
    assert evs and evs[-1]["iteration"] == 4           # skipped past torn 8


def test_one_failure_one_dump():
    log = get_event_log()
    log.reset_dump_guard()
    log.emit("something")
    sink = io.StringIO()
    assert log.dump(file=sink, once="failure") > 0
    assert log.dump(file=sink, once="failure") == 0    # suppressed
    out = sink.getvalue()
    assert out.count("flight recorder: last") == 1
    assert "already dumped for 'failure'" in out      # the port's line
    log.reset_dump_guard()                             # episode over
    assert log.dump(file=sink, once="failure") > 0     # next failure dumps


def test_unguarded_dump_unaffected():
    log = get_event_log()
    log.emit("x")
    sink = io.StringIO()
    assert log.dump(file=sink) > 0
    assert log.dump(file=sink) > 0                     # no once key: always


def test_async_save_crash_resume_bit_exact(tmp_path, comm):
    ref_state, _, ref_traj = _run(tmp_path / "ref", comm, 12, name="aref")
    inj = FaultInjector()
    inj.arm("trainer.step", kind="raise", after=7, times=1)
    state, report, traj = _run(tmp_path / "async", comm, 12, name="async",
                               injector=inj, async_save=True)
    assert report["failures"] == 1 and report["restores"] == 1
    assert _final(traj) == dict(ref_traj)
    assert state["w"] == ref_state["w"]
    _same_key(state["key"], ref_state["key"])


def test_async_save_cross_launch_resume(tmp_path, comm):
    ref_state, _, ref_traj = _run(tmp_path / "r", comm, 10, name="ax")
    _run(tmp_path / "s", comm, 6, name="ay", async_save=True)
    state, report, traj = _run(tmp_path / "s", comm, 10, name="ay",
                               async_save=True)
    assert report["resumed_from"] == 6
    assert dict(traj) == {i: w for i, w in ref_traj if i >= 6}
    assert state["w"] == ref_state["w"]


def test_async_save_requires_capable_checkpointer():
    class NoAsync:
        pass

    with pytest.raises(TypeError, match="save_async"):
        ResilientTrainer(_step, NoAsync(), async_save=True)


def test_prefetched_iterator_crash_resume_bit_exact(tmp_path, comm):
    """A ``DevicePrefetcher``-wrapped iterator: the snapshot's iterator
    state excludes prefetched batches not yet stepped, so a crash-resume
    with async saves replays the same batches and trajectory."""
    ref_state, _, ref_traj = _run(tmp_path / "ref", comm, 12, name="pref")
    ckpt = create_multi_node_checkpointer("pf", comm,
                                          path=str(tmp_path / "pf"))
    pre = DevicePrefetcher(_iterator(), depth=3, device="cpu",
                           name="trainer_pf")
    traj = []
    inj = FaultInjector()
    inj.arm("trainer.step", kind="raise", after=7, times=1)
    with inj:
        state, report = resilient_fit(
            lambda s, b: _step(s, [float(v) for v in b]), _init_state(),
            pre, 12, ckpt, save_every=4, async_save=True,
            on_step=lambda i, s: traj.append((i, s["w"])))
    pre.close()
    assert report["failures"] == 1 and report["restores"] == 1
    assert _final(traj) == dict(ref_traj)
    assert state["w"] == ref_state["w"]


def test_failure_episode_trace_and_metrics(tmp_path, comm):
    """The failure episode is one error-marked ``failure_episode`` trace
    whose root is the MTTR interval (children ``flight_dump`` and
    ``restore``); the failed step's trace is error-marked; the counters
    and the MTTR histogram count the episode; saving steps carry a
    ``checkpoint_enqueue`` span."""
    inj = FaultInjector()
    inj.arm("trainer.step", kind="raise", after=5, times=1)
    _, report, _ = _run(tmp_path, comm, 8, name="ep", injector=inj)
    tracer = get_tracer()
    [ep] = tracer.finished(kind="resilience")
    assert ep.error == "InjectedFault"
    assert [s.name for s in ep.spans] == ["failure_episode", "flight_dump",
                                          "restore"]
    assert ep.root.labels["recovered_step"] == 4   # restored at 4, replayed
    assert ep.root.labels["mttr_s"] == round(report["mttr_s"][0], 6)
    steps = tracer.finished(kind="train")
    assert [t.root.labels["step"] for t in steps if t.error] == [5]
    saving = [t.root.labels["step"] for t in steps
              if any(s.name == "checkpoint_enqueue" for s in t.spans)]
    assert saving == [3, 7]               # the snapshots of iterations 4, 8
    reg = get_registry()
    assert reg.counter("trainer_failures_total").value == 1
    assert reg.counter("trainer_restores_total").value == 1
    assert reg.histogram("trainer_mttr_seconds").count == 1


# --------------------------------------------------------------------- #
# the parity case: a tiny LM, JAX weights carried across                 #
# --------------------------------------------------------------------- #

LM_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, max_len=64)
LR, EPS, N_STEPS, SAVE_EVERY, FAULT_AT = 1e-3, 1e-5, 6, 2, 3


def _lm_data():
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, 64, (8, 16)).astype(np.int32)
    return tokens, np.roll(tokens, -1, axis=1)


def _jax_lm_run(path, inject):
    tokens, targets = _lm_data()
    jlm = JaxLM(**LM_CFG, attention="full", compute_dtype=jnp.float32)
    jcomm = chainermn_tpu.create_communicator("tpu",
                                              devices=jax.devices()[:1])
    params = jcomm.bcast_data(jlm.init(jax.random.PRNGKey(3),
                                       jnp.asarray(tokens[:1])))
    start = jax.device_get(params)
    jopt = chainermn_tpu.create_multi_node_optimizer(
        optax.adam(LR, eps=EPS), jcomm)
    opt_state = jax.device_put(jopt.init(params), jcomm.named_sharding())
    step = jit_lm_train_step(jlm, jopt, jcomm, monitored=False)

    def step_fn(state, sel):
        sel = np.asarray(sel)
        p, o, loss, _ = step(state["params"], state["opt_state"],
                             jnp.asarray(tokens[sel]),
                             jnp.asarray(targets[sel]))
        return {"params": p, "opt_state": o, "loss": float(loss)}

    def restore_hook(state):
        return {"params": jax.device_put(state["params"],
                                         jcomm.named_sharding()),
                "opt_state": jax.device_put(state["opt_state"],
                                            jcomm.named_sharding()),
                "loss": state["loss"]}

    losses = {}
    ckpt = chainermn_tpu.create_multi_node_checkpointer("lm", jcomm,
                                                        path=str(path))
    it = chainermn_tpu.SerialIterator(list(range(8)), batch_size=2,
                                      shuffle=True, seed=1)
    inj = jax_resilience.FaultInjector()
    if inject:
        inj.arm("trainer.step", kind="raise", after=FAULT_AT, times=1)
    with inj:
        _, report = jax_resilience.resilient_fit(
            step_fn, {"params": params, "opt_state": opt_state,
                      "loss": None},
            it, N_STEPS, ckpt, save_every=SAVE_EVERY,
            restore_hook=restore_hook, dump_on_failure=False,
            on_step=lambda i, s: losses.__setitem__(i, s["loss"]))
    return start, [losses[i] for i in range(N_STEPS)], report


def _torch_lm_run(start, comm, path, inject, async_save):
    tokens, targets = _lm_data()
    model = TransformerLM(**LM_CFG, compute_dtype=torch.float32,
                          device="cpu")
    model.load_state_dict(params_from_flax(start))
    opt = create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=LR, eps=EPS), comm)
    step = lm_train_step(model, opt, comm)

    def live(loss):
        return {"model": model.state_dict(),
                "optimizer": opt.state_dict(), "loss": loss}

    def step_fn(state, sel):
        sel = np.asarray(sel)
        loss, _ = step(tokens[sel], targets[sel])
        return live(loss)

    def restore_hook(state):
        model.load_state_dict(to_tensors(state["model"]))
        opt.load_state_dict(to_tensors(state["optimizer"]))
        return live(state["loss"])

    losses = {}
    ckpt = create_multi_node_checkpointer("lm", comm, path=str(path))
    it = SerialIterator(list(range(8)), batch_size=2, shuffle=True, seed=1)
    inj = FaultInjector()
    if inject:
        inj.arm("trainer.step", kind="raise", after=FAULT_AT, times=1)
    with inj:
        _, report = resilient_fit(
            step_fn, live(None), it, N_STEPS, ckpt, save_every=SAVE_EVERY,
            restore_hook=restore_hook, dump_on_failure=False,
            async_save=async_save,
            on_step=lambda i, s: losses.__setitem__(i, float(s["loss"])))
    return [losses[i] for i in range(N_STEPS)], report


def test_lm_resilient_fit_matches_the_reference(tmp_path, comm):
    """The same injected fault at step 3 on both packages: the same
    recovery report; the losses agree at 1e-5; and the port's
    crash-resumed run (async saves) equals its own uninterrupted run
    exactly."""
    start, want, jreport = _jax_lm_run(tmp_path / "jax", inject=True)
    got, report = _torch_lm_run(start, comm, tmp_path / "torch", True,
                                async_save=True)
    keys = ("failures", "restores", "resumed_from")
    assert [report[k] for k in keys] == [jreport[k] for k in keys] \
        == [1, 1, 0]
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    whole, clean = _torch_lm_run(start, comm, tmp_path / "whole", False,
                                 async_save=False)
    assert clean["failures"] == 0
    assert got == whole
