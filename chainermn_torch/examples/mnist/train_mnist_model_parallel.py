#!/usr/bin/env python
"""MNIST model-parallel training — the MLP split across two ranks, on the
port.

The twin of ``examples/mnist/train_mnist_model_parallel.py``: the same
flags, defaults and printed lines. Every rank declares the same
:class:`~chainermn_torch.MultiNodeChainList`: ``MLPHalf0`` on rank 0
sends its hidden activations to ``MLPHalf1`` on rank 1 over the
differentiable ``send``/``recv``, each rank holds and updates only its own
stage (one Adam a stage), and the backward transfer carries the
activations' gradient back. Rank 1 computes the loss; rank 0 calls
``backward()`` on the delegate its forward returns. Evaluation runs the
chain on both ranks. Ranks past 1 take no part in the chain.

``--fused`` replicates both stages on every rank (broadcast from their
owners) and runs the whole chain on each, with no transfer.

Run two ranks (``--device cpu`` for gloo on the CPU)::

    for r in 0 1; do RANK=$r WORLD_SIZE=2 MASTER_ADDR=127.0.0.1 \\
      MASTER_PORT=29512 python -m \\
      chainermn_torch.examples.mnist.train_mnist_model_parallel & done; wait

Two ranks on one card start a gloo default group before ``main``
(NCCL refuses two ranks on one device); the communicator joins it.
"""

from __future__ import annotations

import argparse
import time

import torch
import torch.nn.functional as F
from torch import nn

import chainermn_torch
from chainermn_torch.examples.mnist.train_mnist import (
    ArrayDataset,
    collate,
    load_mnist,
)
from chainermn_torch.functions.point_to_point import STATS, TransferStats
from chainermn_torch.models.resnet import _lecun_normal_


def _dense_stack(sizes, seed: int) -> nn.ModuleList:
    """flax ``Dense`` layers (lecun-normal kernels, zero biases) on the
    CPU, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    fcs = nn.ModuleList(nn.Linear(i, o) for i, o in zip(sizes, sizes[1:]))
    with torch.no_grad():
        for fc in fcs:
            _lecun_normal_(fc.weight, fc.in_features, gen)
            fc.bias.zero_()
    return fcs


class MLPHalf0(nn.Module):
    """Stage 0: input -> hidden (runs on rank 0)."""

    def __init__(self, n_units: int, n_in: int = 784, seed: int = 0) -> None:
        super().__init__()
        self.fcs = _dense_stack([n_in, n_units, n_units], seed)

    def forward(self, x):
        x = x.reshape(x.shape[0], -1)
        x = torch.relu(self.fcs[0](x))
        return torch.relu(self.fcs[1](x))


class MLPHalf1(nn.Module):
    """Stage 1: hidden -> logits (runs on rank 1)."""

    def __init__(self, n_units: int, n_out: int = 10, seed: int = 1) -> None:
        super().__init__()
        self.fcs = _dense_stack([n_units, n_units, n_out], seed)

    def forward(self, h):
        return self.fcs[1](torch.relu(self.fcs[0](h)))


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN-torch example: MNIST model-parallel")
    parser.add_argument("--batchsize", "-b", type=int, default=100)
    parser.add_argument("--epoch", "-e", type=int, default=10)
    parser.add_argument("--unit", "-u", type=int, default=500)
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--n-train", type=int, default=8000)
    parser.add_argument("--n-test", type=int, default=1000)
    parser.add_argument(
        "--fused", action="store_true",
        help="every rank runs the whole chain on its own replica of both "
             "stages, with no transfer")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current CUDA "
                             "card; 'cpu' runs over gloo)")
    return parser


def main(argv=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``).
    Returns this rank's summary: the per-step losses (on a rank that
    computes the loss), each epoch's last loss and validation accuracy,
    the training seconds (evaluations excluded), the point-to-point
    transfers this rank ran, and the devices of its parameters."""
    args = _parser().parse_args(argv)

    chainermn_torch.add_global_except_hook()
    comm = chainermn_torch.create_communicator("naive", device=args.device)
    if comm.size < 2:
        raise SystemExit("model-parallel example needs >= 2 ranks")
    device = comm.device
    r0, r1 = 0, 1   # the two stage-owning ranks (the reference's MPI 0/1)

    model = chainermn_torch.MultiNodeChainList(comm)
    model.add_link(MLPHalf0(args.unit), rank=r0, rank_in=None, rank_out=r1)
    model.add_link(MLPHalf1(args.unit), rank=r1, rank_in=r0, rank_out=None)
    if args.fused:
        model.replicate()
    computes_loss = args.fused or comm.rank == r1

    (x_train, y_train), (x_test, y_test) = load_mnist(
        args.data, args.n_train, args.n_test)
    train = ArrayDataset(x_train, y_train)
    test = ArrayDataset(x_test, y_test)
    # every rank draws the same batches: each stage needs the step's batch
    it = chainermn_torch.SerialIterator(train, args.batchsize, shuffle=True,
                                        seed=1)
    # one optimizer per stage, as in the reference
    optimizer = chainermn_torch.create_component_wise_optimizer(
        lambda ps: torch.optim.Adam(ps, lr=1e-3), model)

    def train_step(images, labels):
        optimizer.zero_grad()
        out = model(torch.as_tensor(images), fused=args.fused)
        loss = None
        if computes_loss:
            loss = F.cross_entropy(
                out, torch.as_tensor(labels, device=device).long())
            loss.backward()
        elif out is not None:
            out.backward()   # the delegate of this rank's last transfer
        optimizer.step()
        return loss

    @torch.no_grad()
    def evaluate() -> dict:
        correct = n = 0
        for batch in chainermn_torch.SerialIterator(
                test, args.batchsize, repeat=False, shuffle=False):
            images, labels = collate(batch)
            logits = model(torch.as_tensor(images), fused=args.fused)
            if computes_loss:
                pred = logits.argmax(-1).cpu().numpy()
                correct += int((pred == labels).sum())
            n += len(labels)
        # the accuracy lives where stage 1 runs
        acc = comm.bcast_obj(correct / max(n, 1), root=r1)
        return {"validation/main/accuracy": acc}

    STATS.reset()
    eval_transfers = TransferStats()   # subtracted: training's alone count
    losses, epochs = [], []
    steps = 0
    train_s = 0.0
    t0 = t_epoch = time.time()
    loss = None
    while it.epoch < args.epoch:
        images, labels = collate(next(it))
        loss = train_step(images, labels)
        steps += 1
        if loss is not None:
            losses.append(loss.detach())
        if it.is_new_epoch:
            last = comm.bcast_obj(None if loss is None else float(loss),
                                  root=r1)
            train_s += time.time() - t_epoch
            before = STATS.as_dict()
            metrics = evaluate()
            for k, v in STATS.as_dict().items():
                setattr(eval_transfers, k,
                        getattr(eval_transfers, k) + v - before[k])
            epochs.append({"epoch": it.epoch, "loss": last, **metrics})
            if comm.rank == 0:
                print(f"epoch {it.epoch:3d}  train/loss {last:.4f}  "
                      f"val/acc {metrics['validation/main/accuracy']:.4f}",
                      flush=True)
            t_epoch = time.time()
    if comm.rank == 0:
        print(f"done in {time.time() - t0:.1f}s  (stage devices: "
              f"{[str(device)] * 2}, ranks {[r0, r1]})", flush=True)
    summary = {
        "rank": comm.rank, "losses": [float(x) for x in losses],
        "epochs": epochs, "train_seconds": train_s, "steps": steps,
        "transfers": {k: v - getattr(eval_transfers, k)
                      for k, v in STATS.as_dict().items()},
        "param_devices": sorted({p.device.type for p in model.parameters()}),
        "n_params": sum(p.numel() for p in model.parameters())}
    comm.finalize()
    return summary


if __name__ == "__main__":
    main()
