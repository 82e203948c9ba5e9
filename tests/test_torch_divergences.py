"""Divergences of the port from the JAX package that the port's graftlint
found, each held here against the reference (ROADMAP.md Queue C, closed
in PR 17):

- seconds histograms made without ``unit="s"`` (the prefetcher's, the
  checkpointer's and the ImageNet twin's), so their snapshots lacked the
  ``*_s`` keys;
- the ``chunk_tokens`` histogram the engine never made;
- the ``admission_error`` event a failed admission never emitted;
- ``ServingEngine.prefill`` and its ``serving.prefill`` cut-point;
- the ``comm.allgather_obj`` and ``dataloader.assemble`` cut-points that
  nothing injected.

The missing methods are held by ``test_torch_public_members.py``, the
lazy imports by ``test_torch_import_hygiene.py`` and the escapes by
``test_torch_analysis.py``'s tree check.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_isolation import fresh_telemetry
from chainermn_torch import monitor as torch_monitor
from chainermn_torch.interop import params_from_flax
from chainermn_torch.models import TransformerLM
from chainermn_torch.resilience import FaultInjector, InjectedFault
from chainermn_torch.resilience.cutpoints import (
    COMM_ALLGATHER_OBJ,
    DATALOADER_ASSEMBLE,
    SERVING_PREFILL,
    SERVING_PREFILL_BATCH,
)
from chainermn_torch.serving import FCFSScheduler, RequestState, ServingEngine
from chainermn_tpu.models import TransformerLM as JaxLM
from chainermn_tpu.monitor import _state as jax_state
from chainermn_tpu.serving import FCFSScheduler as JaxScheduler
from chainermn_tpu.serving import ServingEngine as JaxEngine

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

CFG = dict(vocab_size=17, d_model=16, n_heads=4, n_layers=2, max_len=48)
ENGINE = dict(n_slots=2, prefill_buckets=(4, 8), prefill_batch=2,
              paged=True, kv_block_size=2, kv_blocks=48, cache_len=32)


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


@pytest.fixture(scope="module")
def weights():
    lm = JaxLM(**CFG, compute_dtype=jnp.float32)
    params = lm.init(jax.random.PRNGKey(0),
                     jnp.asarray([[1, 2, 3]], jnp.int32))
    return lm, params


def _port_model(params):
    model = TransformerLM(**CFG, compute_dtype=torch.float32, device="cpu")
    model.load_state_dict(params_from_flax(jax.device_get(params)))
    return model


def _hist_keys(snapshot, name):
    return {k: sorted(v) for k, v in snapshot["histograms"].items()
            if k.startswith(name)}


# -- 1. seconds histograms carry unit="s" -------------------------------- #


def test_prefetcher_seconds_histograms_match_the_reference():
    from chainermn_torch.dataflow import DevicePrefetcher
    from chainermn_tpu.dataflow import DevicePrefetcher as JaxPrefetcher

    def slow_source():
        # slower than the consumer: every batch is a stall, on both sides
        for _ in range(3):
            time.sleep(0.05)
            yield np.ones((2, 3), np.float32), np.zeros(2, np.int32)

    for _ in JaxPrefetcher(slow_source(), depth=2):
        pass
    for _ in DevicePrefetcher(slow_source(), depth=2, device="cpu"):
        pass
    want = jax_state.get_registry().snapshot()
    got = torch_monitor.get_registry().snapshot()
    for name in ("prefetch_h2d_seconds", "prefetch_stall_seconds"):
        assert _hist_keys(got, name) == _hist_keys(want, name), name
    # the consumer waited on every batch: a seconds-valued report
    assert "p50_s" in got["histograms"]['prefetch_stall_seconds{name="prefetch"}']


def test_checkpointer_seconds_histograms_match_the_reference(tmp_path):
    import chainermn_tpu
    from chainermn_torch import create_communicator
    from chainermn_torch.extensions import create_multi_node_checkpointer

    state = {"w": np.arange(4, dtype=np.float32), "iteration": 1}
    comm = create_communicator("naive", device="cpu")
    try:
        cp = create_multi_node_checkpointer("u", comm,
                                            path=str(tmp_path / "p"))
        cp.save(state, 1)
        cp.save_async(state, 2)
        cp.wait_async()
        cp.maybe_load(state)
    finally:
        comm.finalize()
    jcp = chainermn_tpu.create_multi_node_checkpointer(
        "u", chainermn_tpu.create_communicator("naive"),
        path=str(tmp_path / "j"))
    jcp.save(state, 1)
    jcp.save_async(state, 2)
    jcp.wait_async()
    jcp.maybe_load(state)
    want = jax_state.get_registry().snapshot()
    got = torch_monitor.get_registry().snapshot()
    for name in ("checkpoint_save_seconds", "checkpoint_load_seconds",
                 "checkpoint_async_save_seconds"):
        assert _hist_keys(got, name) == _hist_keys(want, name), name
        assert _hist_keys(got, name), name


def test_imagenet_twin_reads_the_prefetchers_histogram():
    """The twin looks the prefetcher's histogram up by name and unit: it
    is the prefetcher's own instrument, seconds-valued."""
    from chainermn_torch.dataflow import DevicePrefetcher

    pf = DevicePrefetcher(iter([np.ones(2, np.float32)]), device="cpu",
                          name="imagenet")
    h = torch_monitor.get_registry().histogram(
        "prefetch_h2d_seconds", {"name": "imagenet"}, unit="s")
    assert h is pf._h_h2d and h.unit == "s"


# -- 2/3/4. the engine and the scheduler --------------------------------- #


def test_chunk_tokens_histogram_observes_each_chunk(weights):
    lm, params = weights
    prompt = np.asarray([1, 4, 2, 7, 3, 5, 6, 2, 9, 4], np.int32)

    cfg = dict(ENGINE, prefill_buckets=(4, 8, 16), kv_blocks=64,
               cache_len=48)
    jeng = JaxEngine(lm, params, **cfg)
    jsched = JaxScheduler(jeng, chunk_tokens_per_step=4)
    jsched.submit(prompt, 3)
    jsched.run_until_idle()
    eng = ServingEngine(_port_model(params), device="cpu", **cfg)
    sched = FCFSScheduler(eng, chunk_tokens_per_step=4)
    sched.submit(prompt, 3)
    sched.run_until_idle()

    want = jax_state.get_registry().snapshot()["histograms"]
    got = torch_monitor.get_registry().snapshot()["histograms"]
    key = 'chunk_tokens{engine="serving"}'
    assert key in want and key in got
    assert got[key] == want[key]
    assert got[key]["count"] == 3      # chunks of 4, 4 and 2 tokens


def test_failed_admission_emits_admission_error(weights):
    from chainermn_tpu.resilience import FaultInjector as JaxInjector

    lm, params = weights
    runs = {}
    for side, eng, inj in (
            ("jax", JaxEngine(lm, params, **ENGINE), JaxInjector()),
            ("port", ServingEngine(_port_model(params), device="cpu",
                                   **ENGINE), FaultInjector())):
        sched = (JaxScheduler if side == "jax" else FCFSScheduler)(eng)
        inj.arm(SERVING_PREFILL_BATCH, kind="raise", times=1)
        with inj:
            bad = sched.submit(np.array([1, 2, 3]), 2)
            good = sched.submit(np.array([4, 5, 6, 7, 1]), 2)
            sched.run_until_idle()
        runs[side] = (bad, good)

    def admission_errors(events):
        return [e for e in events.tail() if e["kind"] == "admission_error"]

    want = admission_errors(jax_state.get_event_log())
    got = admission_errors(torch_monitor.get_event_log())
    assert len(want) == len(got) == 1
    for k in ("error", "group"):
        assert got[0][k] == want[0][k], k
    (jbad, jgood), (bad, good) = runs["jax"], runs["port"]
    assert bad.state is RequestState.ERRORED and jbad.error is not None
    assert good.state is RequestState.DONE
    assert list(map(int, good.output)) == list(map(int, jgood.output))


def test_engine_prefill_admits_one_prompt_like_the_reference(weights):
    lm, params = weights
    prompt = np.asarray([3, 5, 2, 7, 1], np.int32)
    jeng = JaxEngine(lm, params, **ENGINE)
    want = jeng.prefill(prompt, jax.random.PRNGKey(0))
    eng = ServingEngine(_port_model(params), device="cpu", **ENGINE)
    got = eng.prefill(prompt, 0)
    assert (int(got[0]), int(got[1])) == (int(want[0]), int(want[1]))
    assert eng.active_slots == 1
    # its own cut-point, not admit_batch's
    inj = FaultInjector()
    inj.arm(SERVING_PREFILL, kind="raise", times=1)
    with inj:
        with pytest.raises(InjectedFault):
            eng.prefill(prompt, 0)
    assert inj.fired_log == [(SERVING_PREFILL, "raise")]
    assert eng.active_slots == 1        # the failed admission rolled back
    inj = FaultInjector()
    inj.arm(SERVING_PREFILL, kind="raise", times=1)
    with inj:
        eng.admit_batch([eng.plan_admission(prompt, 0)])
    assert inj.fired_log == []


# -- 5. the two cut-points nothing injected ------------------------------ #


def test_allgather_obj_injects_its_cut_point():
    from chainermn_torch import create_communicator

    comm = create_communicator("naive", device="cpu")
    try:
        inj = FaultInjector()
        inj.arm(COMM_ALLGATHER_OBJ, kind="raise", times=1)
        with inj:
            with pytest.raises(InjectedFault):
                comm.allgather_obj(1)
            assert comm.allgather_obj(2) == [2]
        assert inj.fired_log == [(COMM_ALLGATHER_OBJ, "raise")]
    finally:
        comm.finalize()


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("prefetch", [True, False])
def test_native_loader_injects_dataloader_assemble(native, prefetch):
    """The second batch's assembly raises; the consumer sees it (the
    reference's prefetching loader leaves its consumer waiting forever
    on a producer that died: a reference fault, not copied)."""
    from chainermn_torch.native.dataloader import NativeBatchLoader

    x = np.arange(8 * 4 * 4 * 3, dtype=np.uint8).reshape(8, 4, 4, 3)
    y = np.arange(8, dtype=np.int32)
    loader = NativeBatchLoader(x, y, 2, shuffle=False, repeat=False,
                               prefetch=prefetch)
    loader._native = native and loader._native
    inj = FaultInjector()
    inj.arm(DATALOADER_ASSEMBLE, kind="raise", after=1, times=1)
    seen = []
    with inj:
        with pytest.raises((InjectedFault, RuntimeError)) as err:
            for batch in loader:
                seen.append(batch)
    assert inj.fired_log == [(DATALOADER_ASSEMBLE, "raise")]
    assert len(seen) == 1
    assert isinstance(err.value, InjectedFault) \
        or isinstance(err.value.__cause__, InjectedFault)
