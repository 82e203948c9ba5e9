#!/usr/bin/env python
"""Channel-parallel convolution — tensor parallelism from differentiable
collectives, on the port.

The twin of ``examples/parallel_convolution/train_parallel_conv.py``: the
same CIFAR-shaped CNN, flags, defaults, synthetic data and printed lines.
Its conv layers' output channels are split across the ranks and stitched
with the port's differentiable ``alltoall``/``allgather``
(:mod:`chainermn_torch.functions`), whose backwards are the transposed
collectives:

- the batch enters **batch-sharded** (each rank holds ``N/n`` images);
- an ``alltoall`` re-shards the activations batch -> channel, so the
  parallel section sees the full batch with ``C/n`` channels a rank;
- each parallel conv holds only its ``F/n`` out-channel slice of the
  kernel; the full input is assembled per layer with an ``allgather``,
  whose backward (a reduce-scatter sum) routes every rank's cotangents
  back to the owning channel shard;
- a closing ``alltoall`` returns to batch-sharded for the replicated head
  and the per-shard loss.

Gradients: each rank back-propagates its local mean loss over ``n``, so
the channel-sharded kernels get the global mean loss's gradient through
the collective transposes; the replicated parameters (``conv1``, the
head) hold only the local shard's contribution, and their gradients are
summed over the ranks explicitly.

Layout: NCHW activations and OIHW kernels (the reference is NHWC/HWIO;
:func:`chainermn_torch.interop.parallel_conv_params_from_jax` carries its
weights across). The head reads the features in the reference's NHWC
flatten order. Weights are He-normal from ``--seed``.

One process runs one rank. Run two ranks on the CPU::

    for r in 0 1; do RANK=$r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 \\
      MASTER_PORT=29513 python -m \\
      chainermn_torch.examples.parallel_convolution.train_parallel_conv \\
      --device cpu --check & done; wait

Several ranks on one card start a gloo default group before ``main``
(NCCL refuses two ranks on one device); the communicator joins it, and
every collective stages through the host.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_torch
from chainermn_torch.communicators.process_group_communicator import (
    HOST_STAGED,
)
from chainermn_torch.interop import images_from_nhwc

CH1, CH2, CH3 = 32, 64, 64
SHARDED = ("pconv2", "pconv3")
REPLICATED = ("conv1", "head")


def _he_normal(shape, fan_in: int, gen) -> torch.Tensor:
    """``jax.nn.initializers.he_normal()``: a normal truncated at two
    standard deviations, scaled to variance ``2 / fan_in``."""
    x = torch.randn(shape, generator=gen)
    while True:
        bad = x.abs() > 2.0
        if not bad.any():
            break
        x[bad] = torch.randn(int(bad.sum()), generator=gen)
    return x * (2.0 / fan_in) ** 0.5 / 0.87962566103423978


def init_params(image_size: int, classes: int, seed: int = 0) -> dict:
    """Full (unsharded) parameters on the CPU, as the port's ``state_dict``
    layout: OIHW conv weights, ``head.weight`` ``[classes, feat]``."""
    gen = torch.Generator().manual_seed(seed)
    feat = (image_size // 4) * (image_size // 4) * CH3
    out = {}
    for name, cin, cout in (("conv1", 3, CH1), ("pconv2", CH1, CH2),
                            ("pconv3", CH2, CH3)):
        out[f"{name}.weight"] = _he_normal((cout, cin, 3, 3), 9 * cin, gen)
        out[f"{name}.bias"] = torch.zeros(cout)
    out["head.weight"] = _he_normal((classes, feat), feat, gen)
    out["head.bias"] = torch.zeros(classes)
    return out


def shard_params(full: dict, rank: int, n: int, device=None) -> dict:
    """This rank's parameters, leaves that require grad: the ``pconv``
    kernels and biases sliced on the out-channel axis, the rest whole."""
    out = {}
    for key, value in full.items():
        if key.split(".")[0] in SHARDED:
            step = value.shape[0] // n
            value = value[rank * step:(rank + 1) * step]
        out[key] = value.detach().clone().to(device).requires_grad_(True)
    return out


def _conv(x, params, name):
    return F.conv2d(x, params[f"{name}.weight"], params[f"{name}.bias"],
                    padding=1)


def _pool(x):
    return F.avg_pool2d(x, 2)


def _head(h, params):
    # the reference flattens NHWC: features in (H, W, C) order
    h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
    return F.linear(h, params["head.weight"], params["head.bias"])


def serial_forward(params: dict, x) -> torch.Tensor:
    """One-device semantics, which the parallel program must reproduce
    with the same weights (``x`` NCHW)."""
    h = _pool(F.relu(_conv(x, params, "conv1")))
    h = F.relu(_conv(h, params, "pconv2"))
    h = _pool(F.relu(_conv(h, params, "pconv3")))
    return _head(h, params)


def _batch_to_channel(h, comm):
    """``[N/n, C, H, W]`` batch-sharded -> ``[N, C/n, H, W]``
    channel-sharded."""
    n = comm.size
    nl, c, hh, ww = h.shape
    h = h.reshape(nl, n, c // n, hh, ww).transpose(0, 1).contiguous()
    h = chainermn_torch.functions.alltoall(h, comm)   # leading axis: peers
    return h.reshape(n * nl, c // n, hh, ww)


def _channel_to_batch(h, comm):
    """``[N, C/n, H, W]`` channel-sharded -> ``[N/n, C, H, W]``
    batch-sharded."""
    n = comm.size
    nn_, cl, hh, ww = h.shape
    h = h.reshape(n, nn_ // n, cl, hh, ww)
    h = chainermn_torch.functions.alltoall(h, comm)   # [n(source), ...]
    return h.transpose(0, 1).reshape(nn_ // n, n * cl, hh, ww)


def _gather_channels(h, comm):
    """Every rank's ``C/n`` channels, in rank order: ``[N, C, H, W]``."""
    full = chainermn_torch.functions.allgather(h, comm)   # [n, N, C/n, ...]
    return full.transpose(0, 1).reshape(h.shape[0], -1, *h.shape[2:])


def parallel_forward(params: dict, x, comm) -> torch.Tensor:
    """A rank's program: ``params`` are its local parameters (the pconv
    slices), ``x`` its batch shard; returns its shard's logits."""
    h = _pool(F.relu(_conv(x, params, "conv1")))   # replicated weights
    h = _batch_to_channel(h, comm)                  # full batch, C/n
    h = F.relu(_conv(_gather_channels(h, comm), params, "pconv2"))
    h = F.relu(_conv(_gather_channels(h, comm), params, "pconv3"))
    h = _channel_to_batch(_pool(h), comm)           # back to batch shards
    return _head(h, params)


def loss_and_grads(params: dict, images, labels, comm) -> torch.Tensor:
    """The global mean loss's gradient in every leaf's ``.grad``: the
    sharded leaves' through the collective transposes, the replicated
    leaves' summed over the ranks. Returns the local mean loss."""
    for p in params.values():
        p.grad = None
    logits = parallel_forward(params, images, comm)
    local = F.cross_entropy(logits.float(), labels)
    (local / comm.size).backward()
    for key, p in params.items():
        if key.split(".")[0] in REPLICATED:
            p.grad = comm.allreduce(p.grad, "sum")
    return local.detach()


def make_train_step(params: dict, comm, lr: float = 5e-2):
    """``step(images, labels) -> loss``: the mean loss over every rank's
    shard, after one SGD update of this rank's parameters."""
    optimizer = torch.optim.SGD(list(params.values()), lr=lr)

    def step(images, labels):
        local = loss_and_grads(params, images, labels, comm)
        optimizer.step()
        return comm.allreduce(local, "mean")

    return step


def synthetic_cifar(n: int, image_size: int, classes: int, seed: int = 0):
    """The reference's synthetic CIFAR draw for draw (NHWC float32 in
    [0, 1], int32 labels)."""
    rng = np.random.RandomState(seed)
    templates = rng.rand(classes, image_size, image_size, 3).astype(
        np.float32)
    y = rng.randint(0, classes, size=n).astype(np.int32)
    x = templates[y] + 0.25 * rng.randn(n, image_size, image_size,
                                        3).astype(np.float32)
    return np.clip(x, 0.0, 1.0), y


@contextlib.contextmanager
def _full_precision():
    """Float32 convolutions and matmuls (no TF32) for the parity check."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = saved


def parity_error(full: dict, params: dict, x_nhwc, comm) -> float:
    """The parallel forward of this rank's rows of ``x_nhwc`` (the global
    batch) against the serial forward of the full parameters: the
    largest absolute error over this rank's logits, and raises unless
    they agree at rtol = atol = 2e-4."""
    dev = comm.device
    nl = len(x_nhwc) // comm.size
    mine = slice(comm.rank * nl, (comm.rank + 1) * nl)
    with torch.no_grad(), _full_precision():
        want = serial_forward({k: v.to(dev) for k, v in full.items()},
                              images_from_nhwc(x_nhwc, dev))[mine]
        got = parallel_forward(params, images_from_nhwc(x_nhwc[mine], dev),
                               comm)
    err = float((got - want).abs().max())
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                               rtol=2e-4, atol=2e-4)
    return err


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN port example: channel-parallel convolution")
    parser.add_argument("--batchsize", "-b", type=int, default=64)
    parser.add_argument("--epoch", "-e", type=int, default=5)
    parser.add_argument("--image-size", type=int, default=32)
    parser.add_argument("--classes", type=int, default=10)
    parser.add_argument("--n-train", type=int, default=2048)
    parser.add_argument("--check", action="store_true",
                        help="assert parallel forward == serial forward "
                             "with the same weights before training")
    parser.add_argument("--seed", type=int, default=0,
                        help="seed of the He-normal weights")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current "
                             "CUDA card; 'cpu' runs over gloo)")
    return parser


def main(argv=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``);
    returns a summary: the epoch losses, the step times, the parity
    check's error and the bytes and seconds staged through the host."""
    args = _parser().parse_args(argv)
    chainermn_torch.add_global_except_hook()
    comm = chainermn_torch.create_communicator("tpu", device=args.device)
    try:
        return _run(args, comm)
    finally:
        comm.finalize()


def _run(args, comm) -> dict:
    n = comm.size
    for ch in (CH1, CH2, CH3):
        if ch % n:
            raise SystemExit(f"channel counts {CH1}/{CH2}/{CH3} must divide "
                             f"the device count ({n})")
    if args.batchsize % n:
        raise SystemExit(f"--batchsize {args.batchsize} must divide over "
                         f"the {n} ranks")
    x, y = synthetic_cifar(args.n_train, args.image_size, args.classes)
    if args.batchsize > len(x):
        raise SystemExit(
            f"global batch {args.batchsize} exceeds the {len(x)}-sample "
            "dataset: every batch would be a ragged tail and zero "
            "training steps would run")
    full = init_params(args.image_size, args.classes, args.seed)
    params = shard_params(full, comm.rank, n, comm.device)
    out = {"ranks": n, "device": str(comm.device)}
    if args.check:
        out["parity_max_abs_err"] = parity_error(
            full, params, x[:args.batchsize], comm)
        if comm.rank == 0:
            print(f"parity check OK: parallel({n} ranks) == serial "
                  "forward", flush=True)

    step = make_train_step(params, comm)
    nl = args.batchsize // n
    mine = slice(comm.rank * nl, (comm.rank + 1) * nl)
    steps_per_epoch = max(1, args.n_train // args.batchsize)
    staged0 = dict(HOST_STAGED)
    t0 = time.time()
    first = last = None
    epoch_losses, step_s = [], []
    for epoch in range(1, args.epoch + 1):
        perm = np.random.RandomState(epoch).permutation(args.n_train)
        losses = []
        for it in range(steps_per_epoch):
            idx = perm[it * args.batchsize:(it + 1) * args.batchsize]
            if len(idx) < args.batchsize:
                continue
            idx = idx[mine]
            t_step = time.perf_counter()
            loss = step(images_from_nhwc(x[idx], comm.device),
                        torch.as_tensor(y[idx], device=comm.device).long())
            losses.append(float(loss))     # closes the step on the device
            step_s.append(time.perf_counter() - t_step)
        mean_loss = float(np.mean(losses))
        first = first if first is not None else mean_loss
        last = mean_loss
        epoch_losses.append(mean_loss)
        if comm.rank == 0:
            print(f"epoch {epoch:3d}  train/loss {mean_loss:.4f}",
                  flush=True)
    wall = time.time() - t0
    if comm.rank == 0:
        print(f"done in {wall:.1f}s  (ranks={n}, loss {first:.3f} -> "
              f"{last:.3f})", flush=True)
    return dict(out, epoch_losses=epoch_losses, steps=len(step_s),
                step_ms=[s * 1e3 for s in step_s], wall_s=wall,
                staged_bytes=HOST_STAGED["bytes"] - staged0["bytes"],
                staged_s=HOST_STAGED["seconds"] - staged0["seconds"])


if __name__ == "__main__":
    main()
