"""The port's windowed loss fetch and asynchronous loop
(``chainermn_torch/dataflow/dispatch.py::LossWindow``,
``chainermn_torch/training.py::fit``) against the JAX package's: the same
pushes give the same fetch events, losses, ``on_fetch`` order, counters
and errors; ``fit`` over a tiny seeded step with the JAX step's weights
gives the same losses (float32, rtol 1e-6), ``ceil(21/8) = 3`` loss
fetches and the same span tree a step, with and without the device
prefetcher (``device="cpu"`` here)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_isolation import fresh_telemetry

from chainermn_torch.dataflow import LossWindow as TorchWindow
from chainermn_torch.monitor import get_registry as torch_registry
from chainermn_torch.monitor import get_tracer as torch_tracer
from chainermn_torch.training import fit as torch_fit
from chainermn_tpu.dataflow import LossWindow as JaxWindow
from chainermn_tpu.monitor import get_registry as jax_registry
from chainermn_tpu.monitor import get_tracer as jax_tracer
from chainermn_tpu.training import fit as jax_fit

torch.set_float32_matmul_precision("highest")

N_STEPS, FETCH_EVERY, LR = 21, 8, 0.05


@pytest.fixture(autouse=True)
def _isolated(monkeypatch):
    fresh_telemetry(monkeypatch)


def _values(seed=0, n=10):
    return np.random.RandomState(seed).randn(n).astype(np.float32)


def _window_run(window_cls, as_array, registry, window, values, name):
    seen = []
    w = window_cls(window, name=name,
                   on_fetch=lambda i, v: seen.append((i, v)))
    pushes, inflight, fetched = [], [], []
    for i, v in enumerate(values):
        pushes.append(w.push(i, as_array(v)))
        inflight.append(w.inflight)
        fetched.append(w.losses)
    drained = w.drain()
    labels = {"loop": name}
    return {"pushes": pushes, "inflight": inflight, "fetched": fetched,
            "drained": drained, "on_fetch": seen,
            "fetches": registry.counter("loss_fetch_total", labels).value,
            "fetch_samples": registry.histogram("loss_fetch_seconds",
                                                labels).count,
            "lag": registry.histogram("dispatch_lag_steps", labels).samples,
            "inflight_gauge": registry.gauge("dispatch_inflight",
                                             labels).value}


@pytest.mark.parametrize("window", [1, 3, 4, 10, 16])
def test_loss_window_matches_the_reference(window):
    values = _values(window)
    got = _window_run(TorchWindow, torch.tensor, torch_registry(), window,
                      values, "w")
    want = _window_run(JaxWindow, jnp.asarray, jax_registry(), window,
                       values, "w")
    assert got == want
    assert got["drained"] == [float(v) for v in values]
    assert got["fetches"] == -(-len(values) // window)


def test_loss_window_mixed_inputs_and_errors():
    """Host floats, numpy scalars and tensors of two dtypes in one window
    fetch together; a window below 1 raises the reference's error."""
    mixed = [1.5, np.float32(2.25), torch.tensor(3.0),
             torch.tensor(4.0, dtype=torch.bfloat16)]
    w = TorchWindow(4, name="mixed")
    assert [w.push(i, v) for i, v in enumerate(mixed)] == [False] * 3 + [True]
    assert w.drain() == [1.5, 2.25, 3.0, 4.0]
    for cls in (TorchWindow, JaxWindow):
        with pytest.raises(ValueError, match="window must be >= 1, got 0"):
            cls(0)


# --------------------------------------------------------------------- #
# fit                                                                    #
# --------------------------------------------------------------------- #

def _weights():
    rng = np.random.RandomState(1)
    return {"w1": (0.5 * rng.randn(4, 8)).astype(np.float32),
            "w2": (0.5 * rng.randn(8, 1)).astype(np.float32)}


def _batches(n=N_STEPS):
    rng = np.random.RandomState(2)
    return [(rng.randn(6, 4).astype(np.float32),
             rng.randn(6, 1).astype(np.float32)) for _ in range(n)]


def _jax_step():
    def loss_fn(p, x, y):
        h = jnp.tanh(x @ p["w1"])
        return jnp.mean((h @ p["w2"] - y) ** 2)

    @jax.jit
    def step(params, opt_state, x, y):
        loss, g = jax.value_and_grad(loss_fn)(params, x, y)
        params = jax.tree_util.tree_map(lambda p, d: p - LR * d, params, g)
        return params, opt_state, loss

    return step


def _torch_step():
    params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
              for k, v in _weights().items()}
    opt = torch.optim.SGD(params.values(), lr=LR)

    def step(x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        opt.zero_grad()
        h = torch.tanh(x @ params["w1"])
        loss = ((h @ params["w2"] - y) ** 2).mean()
        loss.backward()
        opt.step()
        return loss.detach(), {}      # lm_train_step's arity: stats dropped

    return step, params


def _trees(tracer) -> list:
    """Each retained train step's span tree, without the timing-dependent
    ``prefetch_stall`` spans."""
    out = []
    for t in tracer.finished(kind="train"):
        keep = [s for s in t.spans if s.name != "prefetch_stall"]
        out.append([(s.name, s.parent_id, dict(s.labels)) for s in keep])
    return out


@pytest.mark.parametrize("prefetch_depth", [0, 2])
def test_fit_matches_the_reference(prefetch_depth):
    seen = []
    step, params = _torch_step()
    got = torch_fit(step, iter(_batches()), N_STEPS,
                    fetch_every=FETCH_EVERY, prefetch_depth=prefetch_depth,
                    device="cpu", on_loss=lambda i, v: seen.append(i))
    params_j, _, want = jax_fit(
        _jax_step(), {k: jnp.asarray(v) for k, v in _weights().items()},
        None, iter(_batches()), N_STEPS, fetch_every=FETCH_EVERY,
        prefetch_depth=prefetch_depth)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    for k, v in params.items():
        np.testing.assert_allclose(v.detach().numpy(), params_j[k],
                                   rtol=1e-5, atol=1e-6)
    assert seen == list(range(N_STEPS))
    labels = {"loop": "fit"}
    assert torch_registry().counter("loss_fetch_total", labels).value == 3
    assert jax_registry().counter("loss_fetch_total", labels).value == 3
    trees = _trees(torch_tracer())
    assert trees == _trees(jax_tracer())
    assert len(trees) == N_STEPS
    fetching = [i for i, t in enumerate(trees)
                if any(name == "loss_fetch" for name, _, _ in t)]
    # two full windows; the closing drain runs after the last step's trace
    assert fetching == [7, 15]
    assert all([name for name, _, _ in t][:3] == [
        "train_step", "prefetch_wait", "dispatch"] for t in trees)
