"""The extensions (``chainermn_torch.extensions``) against the JAX
package's on the same samples: ``AllreducePersistent`` and
``ObservationAggregator`` on 2 gloo ranks (started once), ``StepTimer``,
``latency_report`` and ``Watchdog`` in process, and the ``trace``
helper over ``torch.profiler``."""

import io
import json
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chainermn_tpu
from chainermn_tpu.extensions import profiling as jprof
from chainermn_torch.extensions import profiling as tprof
from chainermn_torch.testing import ROOT, run_ranks

N_RANKS = 2

_WORKER = """
import numpy as np
import torch
from torch import nn
from chainermn_torch import (AllreducePersistent, ObservationAggregator,
                             create_communicator)
from chainermn_torch.links import BatchNorm

spec = torch.load(ARGS[0], weights_only=False)
comm = create_communicator("naive", device="cpu")
r = comm.rank
out = {}

model = nn.Sequential(nn.Linear(4, 4), BatchNorm(4, device="cpu"),
                      nn.BatchNorm1d(4))
with torch.no_grad():
    model[1].running_mean.copy_(torch.from_numpy(spec["mean"][r]))
    model[1].running_var.copy_(torch.from_numpy(spec["var"][r]))
    model[2].num_batches_tracked.fill_(3 + r)
    weight = model[0].weight.clone()
assert AllreducePersistent(comm)(model) is model
out["mean"] = model[1].running_mean
out["var"] = model[1].running_var
out["tracked"] = int(model[2].num_batches_tracked)
out["params_kept"] = bool(torch.equal(model[0].weight, weight))
try:
    AllreducePersistent(comm)({"batch_stats": {}})
except TypeError as e:
    out["non_module"] = str(e)

obs = spec["observations"][r]
obs = dict(obs, loss=torch.tensor(obs["loss"]))
out["aggregated"] = ObservationAggregator(comm)(obs)
out["gathered"] = comm.allgather_obj(spec["observations"][r])
save(out)
comm.finalize()
"""


@pytest.fixture(scope="module")
def spec(n_devices):
    rs = np.random.RandomState(0)
    return {"mean": rs.randn(N_RANKS, 4).astype(np.float32),
            "var": rs.rand(N_RANKS, 4).astype(np.float32) + 0.5,
            "observations": [
                {"loss": float(rs.rand()), "acc": np.float32(rs.rand()),
                 "hist": rs.rand(3), "tag": f"rank{r}"}
                for r in range(N_RANKS)]}


@pytest.fixture(scope="module")
def ranks(spec, tmp_path_factory):
    path = tmp_path_factory.mktemp("ext") / "spec.pt"
    torch.save(spec, path)
    return run_ranks(_WORKER, N_RANKS, args=[str(path)], timeout=120)


@pytest.fixture(scope="module")
def jcomm():
    return chainermn_tpu.create_communicator("naive")


def test_allreduce_persistent_matches_jax(spec, ranks, jcomm, n_devices):
    # the JAX package takes rank-major state over its devices: device d
    # holds rank d % 2's statistics, so its mean is the 2 ranks' mean
    rows = [d % N_RANKS for d in range(n_devices)]
    variables = {"params": {"w": jnp.ones((n_devices, 2))},
                 "batch_stats": {"bn": {"mean": spec["mean"][rows],
                                        "var": spec["var"][rows]}}}
    synced = chainermn_tpu.AllreducePersistent(jcomm)(variables)
    for out in ranks:
        for k in ("mean", "var"):
            np.testing.assert_allclose(
                out[k].numpy(), np.asarray(synced["batch_stats"]["bn"][k])[0],
                rtol=1e-6, atol=1e-6)
        assert out["params_kept"]
    # an integer buffer is a counter, not a statistic
    assert [out["tracked"] for out in ranks] == [3, 4]
    assert "torch.nn.Module" in ranks[0]["non_module"]


class _Gathered:
    """A communicator whose object gather returns what the port's ranks
    gathered: the JAX aggregator then reduces the same samples."""

    def __init__(self, gathered):
        self._gathered = gathered

    def allgather_obj(self, obj):
        return self._gathered


def test_observation_aggregator_matches_jax(ranks):
    want = chainermn_tpu.ObservationAggregator(
        _Gathered(ranks[0]["gathered"]))({})
    for out in ranks:
        got = out["aggregated"]
        assert list(got) == list(want)
        for k in ("loss", "acc"):
            assert got[k] == pytest.approx(want[k], rel=1e-6)
        np.testing.assert_allclose(got["hist"], want["hist"], rtol=1e-6)
        assert got["tag"] == want["tag"] == "rank0"   # rank 0's, as is


SAMPLES = [0.013, 0.011, 0.021, 0.0105, 0.5, 0.012, 0.0111]


def test_latency_report_matches_jax():
    assert tprof.latency_report(SAMPLES, "x") == \
        jprof.latency_report(SAMPLES, "x")
    assert tprof.latency_report([], "x") == {} == jprof.latency_report([], "x")


@pytest.mark.parametrize("use", ["context", "tick"])
def test_step_timer_matches_jax(use, monkeypatch):
    def report(mod):
        clock = iter(np.cumsum([0.0] + SAMPLES * 2).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        t = mod.StepTimer(warmup=2, items_per_step=100)
        for _ in range(len(SAMPLES)):
            if use == "context":
                with t:
                    pass
            else:
                t.tick()
        return t.report()

    assert report(tprof) == report(jprof)


@pytest.mark.parametrize("mod", [tprof, jprof], ids=["torch", "jax"])
def test_watchdog_warn_rearms_and_names_the_step(mod):
    sink = io.StringIO()
    dog = mod.Watchdog(timeout=0.15, on_timeout="warn", _sink=sink)
    with dog.step("hung collective", step=7):
        time.sleep(0.5)
    out = sink.getvalue()
    assert dog.fired and out.count("exceeded 0.15s") >= 2
    assert "hung collective step=7" in out
    quiet = mod.Watchdog(timeout=5.0, on_timeout="warn", _sink=io.StringIO())
    for _ in range(3):
        with quiet.step():
            pass
    assert not quiet.fired
    with pytest.raises(ValueError):
        mod.Watchdog(timeout=1, on_timeout="explode")


def test_watchdog_abort_exits_43_with_the_flight_recorder():
    code = ("import sys, time\n"
            f"sys.path.insert(0, {str(ROOT)!r})\n"
            "from chainermn_torch.extensions import Watchdog\n"
            "with Watchdog(timeout=0.2).step('stuck'):\n"
            "    time.sleep(30)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 43
    assert "exceeded 0.2s (stuck)" in r.stderr
    assert "watchdog_fire" in r.stderr and "flight recorder" in r.stderr


def test_trace_writes_a_chrome_trace(tmp_path):
    with tprof.trace(str(tmp_path)) as prof:
        torch.ones(8).sum()
    assert prof.key_averages()
    with open(tmp_path / "trace.json") as f:
        assert "traceEvents" in json.load(f)
