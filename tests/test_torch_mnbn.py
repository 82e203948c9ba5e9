"""Multi-node BatchNorm of the port on 2 gloo ranks against the JAX
package on a 2-device CPU mesh: the functional form (outputs, global
statistics, gradients with respect to x, gamma and beta, on [N, C] and
[N, C, H, W] inputs), the module (running statistics, the
``use_running_average`` switch at construction and at call time) and
``create_mnbn_model`` on a ResNet against the flax ResNet built with the
multi-node norm, plus the reference fault the port does not copy.

The 2 ranks start once per module and run every case; the tests
parametrize over the results.

Tolerances: float32 outputs, statistics and running statistics to atol
1e-5; gradients to atol 1e-5 (the reference's ``test_batch_normalization``
uses rtol 1e-3 and atol 1e-5 for the same comparison against global BN);
ResNet logits and running statistics to atol 1e-5.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import chainermn_tpu
from chainermn_tpu.links.batch_normalization import (
    MultiNodeBatchNormalization as JaxMNBN,
    multi_node_batch_normalization as jax_mnbn,
)
from chainermn_tpu.models import ResNet as JaxResNet
from chainermn_torch.interop import resnet_params_from_flax
from chainermn_torch.links import (
    BatchNorm,
    MultiNodeBatchNormalization,
    create_mnbn_model,
)
from chainermn_torch.testing import run_ranks

torch.set_float32_matmul_precision("highest")
torch.set_num_threads(1)

N = 2
TOL = 1e-5
CFG = dict(stage_sizes=[1, 1], width=4, num_classes=10)
# case -> per-rank NHWC (or [B, C]) shape
FUNCTIONAL = {"2d": (4, 6), "4d": (3, 5, 4, 6)}
# [100, 100.001] on rank 0, [100, 100] on rank 1: sqmean - mean**2 rounds
# to -9.8e-4 in float32, below -eps
FAULT = np.array([[100.0, 100.001], [100.0, 100.0]], np.float32)[..., None]

_WORKER = """
import torch
from chainermn_torch import create_communicator
from chainermn_torch.links import (
    BatchNorm, MultiNodeBatchNormalization, create_mnbn_model,
    multi_node_batch_normalization)
from chainermn_torch.models import ResNet

torch.set_float32_matmul_precision("highest")
spec = torch.load(ARGS[0], weights_only=False)
comm = create_communicator("naive", device="cpu")
out = {"functional": {}}
for name, case in spec["functional"].items():
    x = case["x"][RANK].clone().requires_grad_()
    g, b = (case[k].clone().requires_grad_() for k in ("gamma", "beta"))
    y, mean, var = multi_node_batch_normalization(x, g, b, comm)
    (y * case["w"][RANK]).sum().backward()
    out["functional"][name] = {"y": y.detach(), "mean": mean.detach(),
                               "var": var.detach(), "gx": x.grad,
                               "gg": g.grad, "gb": b.grad}

x = spec["functional"]["4d"]["x"][RANK]
bn = MultiNodeBatchNormalization(x.shape[1], comm, device="cpu")
train_y = bn(x)
out["module"] = {"y": train_y.detach(), "mean": bn.running_mean.clone(),
                 "var": bn.running_var.clone(),
                 "eval_call": bn(x, use_running_average=True).detach()}
bn.eval()
out["module"]["eval_mode"] = bn(x).detach()
fixed = MultiNodeBatchNormalization(x.shape[1], comm, device="cpu",
                                    use_running_average=True)
out["module"]["ctor"] = fixed(x).detach()
out["module"]["ctor_call"] = fixed(x, use_running_average=False).detach()

model = ResNet(**spec["cfg"], compute_dtype=torch.float32, device="cpu")
model.load_state_dict(spec["resnet_state"])
mn = create_mnbn_model(model, comm)
out["kinds"] = sorted({type(m).__name__ for m in mn.modules()
                       if isinstance(m, BatchNorm)})
out["original_kinds"] = sorted({type(m).__name__ for m in model.modules()
                                if isinstance(m, BatchNorm)})
out["logits"] = mn(spec["images"][RANK]).detach()
out["state"] = {k: v.clone() for k, v in mn.state_dict().items()}

y, _, var = multi_node_batch_normalization(spec["fault"][RANK], None, None,
                                           comm)
out["fault"] = (y, var)
comm.finalize()
save(out)
"""


def _mesh_comm():
    return chainermn_tpu.create_communicator("naive",
                                             devices=jax.devices()[:N])


def _nchw(a):
    """[ranks, B, H, W, C] -> [ranks, B, C, H, W]; [ranks, B, C] as is."""
    return np.moveaxis(a, -1, 2) if a.ndim == 5 else a


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    rng = np.random.default_rng(0)
    functional = {}
    for name, shape in FUNCTIONAL.items():
        x = (rng.standard_normal((N,) + shape) * 2 + 1).astype(np.float32)
        functional[name] = {
            "x": x, "w": rng.standard_normal((N,) + shape).astype(np.float32),
            "gamma": (rng.random(shape[-1]) + 0.5).astype(np.float32),
            "beta": rng.standard_normal(shape[-1]).astype(np.float32)}
    images = rng.standard_normal((N, 2, 32, 32, 3)).astype(np.float32)
    comm = _mesh_comm()
    # create_mnbn_model keeps the plain BatchNorm's eps 1e-5
    norm = functools.partial(JaxMNBN, communicator=comm, epsilon=1e-5)
    jmodel = JaxResNet(**CFG, compute_dtype=jnp.float32, norm=norm)
    variables = jax.device_get(jax.jit(
        functools.partial(jmodel.init, train=True))(
        jax.random.PRNGKey(1), jnp.asarray(images[0])))
    t = torch.from_numpy
    spec = {"cfg": CFG, "resnet_state": resnet_params_from_flax(variables),
            "images": t(_nchw(images)), "fault": t(FAULT),
            "functional": {n: {"x": t(_nchw(c["x"])), "w": t(_nchw(c["w"])),
                               "gamma": t(c["gamma"]), "beta": t(c["beta"])}
                           for n, c in functional.items()}}
    path = tmp_path_factory.mktemp("mnbn") / "spec.pt"
    torch.save(spec, path)
    got = run_ranks(_WORKER, N, args=[path], timeout=120)
    return {"functional": functional, "images": images, "model": jmodel,
            "variables": variables, "comm": comm, "got": got}


@pytest.mark.parametrize("name", list(FUNCTIONAL))
def test_functional_matches_the_reference(setup, name):
    """Values, global statistics and gradients of ``sum_r <w_r, y_r>``:
    the port's per-rank gamma/beta gradients sum to the reference's
    (shard_map sums a replicated input's gradient over ranks)."""
    c, comm = setup["functional"][name], setup["comm"]
    ax = comm.axis_name

    def run(x, gamma, beta):
        def body(xl, g, b):
            y, mean, var = jax_mnbn(xl, g, b, comm)
            return y, mean[None], var[None]
        return comm.shard_map(body, in_specs=(P(ax), P(), P()),
                              out_specs=(P(ax), P(ax), P(ax)))(
            x, gamma, beta)

    args = tuple(jnp.asarray(c[k]) for k in ("x", "gamma", "beta"))
    y, mean, var = jax.jit(run)(*args)
    grads = jax.jit(jax.grad(lambda *a: jnp.sum(run(*a)[0] * c["w"]),
                             argnums=(0, 1, 2)))(*args)
    for r, res in enumerate(setup["got"]):
        got = res["functional"][name]
        np.testing.assert_allclose(got["y"].numpy(), _nchw(np.asarray(y))[r],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got["mean"].numpy(), np.asarray(mean)[r],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got["var"].numpy(), np.asarray(var)[r],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(got["gx"].numpy(),
                                   _nchw(np.asarray(grads[0]))[r],
                                   atol=TOL, rtol=0)
    for k, g in (("gg", grads[1]), ("gb", grads[2])):
        total = sum(res["functional"][name][k] for res in setup["got"])
        np.testing.assert_allclose(total.numpy(), np.asarray(g), atol=TOL,
                                   rtol=0)


def test_module_matches_the_reference(setup):
    """One train-mode call: output and running statistics (momentum 0.9
    toward the global moments); then the running-average paths."""
    comm, x = setup["comm"], setup["functional"]["4d"]["x"]
    mnbn = JaxMNBN(communicator=comm)
    variables = mnbn.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))

    def body(v, xl):
        y, upd = mnbn.apply(v, xl[0], mutable=["batch_stats"])
        return y[None], upd["batch_stats"]

    y, stats = jax.jit(comm.shard_map(
        body, in_specs=(P(), P(comm.axis_name)),
        out_specs=(P(comm.axis_name), P())))(variables, jnp.asarray(x))
    ra = {"params": variables["params"], "batch_stats": stats}
    for r, res in enumerate(setup["got"]):
        mod = res["module"]
        np.testing.assert_allclose(mod["y"].numpy(), _nchw(np.asarray(y))[r],
                                   atol=TOL, rtol=0)
        np.testing.assert_allclose(mod["mean"].numpy(),
                                   np.asarray(stats["mean"]), atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(mod["var"].numpy(),
                                   np.asarray(stats["var"]), atol=TOL,
                                   rtol=0)
        want = np.moveaxis(np.asarray(mnbn.apply(
            ra, jnp.asarray(x[r]), use_running_average=True)), -1, 1)
        for key in ("eval_call", "eval_mode"):
            np.testing.assert_allclose(mod[key].numpy(), want, atol=TOL,
                                       rtol=0, err_msg=key)
        init = np.moveaxis(np.asarray(mnbn.apply(
            variables, jnp.asarray(x[r]), use_running_average=True)), -1, 1)
        np.testing.assert_allclose(mod["ctor"].numpy(), init, atol=TOL,
                                   rtol=0)
        np.testing.assert_allclose(mod["ctor_call"].numpy(), mod["y"].numpy(),
                                   atol=TOL, rtol=0)


def test_create_mnbn_model_matches_the_multi_node_resnet(setup):
    """``create_mnbn_model`` over the port's plain-BN ResNet against the
    flax ResNet built with the multi-node norm at the plain norm's eps,
    from the same weights:
    train-mode logits and every running statistic after one call."""
    comm, model = setup["comm"], setup["model"]
    ax = comm.axis_name

    def body(v, xl):
        logits, upd = model.apply(v, xl[0], train=True,
                                  mutable=["batch_stats"])
        return logits[None], upd["batch_stats"]

    logits, stats = jax.jit(comm.shard_map(
        body, in_specs=(P(), P(ax)), out_specs=(P(ax), P())))(
        setup["variables"], jnp.asarray(setup["images"]))
    want = resnet_params_from_flax(jax.device_get(
        {"params": setup["variables"]["params"], "batch_stats": stats}))
    for r, res in enumerate(setup["got"]):
        assert res["kinds"] == ["MultiNodeBatchNormalization"]
        assert res["original_kinds"] == ["BatchNorm"]
        np.testing.assert_allclose(res["logits"].numpy(),
                                   np.asarray(logits)[r], atol=TOL, rtol=0)
        for key, ref in want.items():
            np.testing.assert_allclose(res["state"][key].numpy(),
                                       ref.numpy(), atol=TOL, rtol=0,
                                       err_msg=key)


def test_negative_variance_is_clipped_not_copied(setup):
    """Reference fault, not copied: the reference's ``sqmean - mean**2``
    rounds to -9.8e-4 here and its output is NaN; the port clips the
    variance at 0 as flax does and stays finite."""
    comm = setup["comm"]
    y = jax.jit(comm.shard_map(
        lambda xl: jax_mnbn(xl, jnp.ones(1), jnp.zeros(1), comm)[0],
        in_specs=P(comm.axis_name), out_specs=P(comm.axis_name)))(
        jnp.asarray(FAULT))
    assert np.isnan(np.asarray(y)).all()
    for res in setup["got"]:
        y, var = res["fault"]
        assert torch.isfinite(y).all() and (var == 0).all()


class _Net(torch.nn.Module):
    def __init__(self, norm):
        super().__init__()
        self.body = torch.nn.Sequential(torch.nn.Linear(3, 4), norm)


def test_create_mnbn_model_keeps_hyperparameters_and_refuses():
    bn = BatchNorm(4, momentum=0.95, eps=1e-3, use_bias=False,
                   use_running_average=True, device="cpu")
    bn.running_mean.fill_(0.5)
    net = _Net(bn)
    mn = create_mnbn_model(net, communicator="comm")
    new = mn.body[1]
    assert isinstance(new, MultiNodeBatchNormalization)
    assert (new.momentum, new.eps, new.use_running_average) == (0.95, 1e-3,
                                                                True)
    assert new.bias is None and new.communicator == "comm"
    assert torch.equal(new.running_mean, bn.running_mean)
    assert net.body[1] is bn                      # the original stays
    for norm, match in ((BatchNorm(4, axis=2, device="cpu"), "axis"),
                        (torch.nn.SyncBatchNorm(4), "double-reduce"),
                        (torch.nn.BatchNorm1d(4), "torch BatchNorm1d")):
        with pytest.raises(ValueError, match=match):
            create_mnbn_model(_Net(norm), communicator="comm")
