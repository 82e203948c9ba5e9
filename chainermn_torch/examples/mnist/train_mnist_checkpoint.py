#!/usr/bin/env python
"""MNIST data-parallel training with fault-tolerant checkpoint/resume, on
the port.

The twin of ``examples/mnist/train_mnist_checkpoint.py``: the same flags,
defaults and printed lines. The checkpointer snapshots the model, the
optimizer state and the iterator's state (its shuffle RNG, the only RNG
the loop draws from) every ``--frequency`` iterations; rerunning the
same command resumes from the newest snapshot every rank still has, and
the resumed run goes on as the uninterrupted one would have, bit for
bit.

Try it: run with ``--stop-at 12`` (a simulated crash after iteration 12),
then run again without it and watch training resume from iteration 10::

    python -m chainermn_torch.examples.mnist.train_mnist_checkpoint --stop-at 12
    python -m chainermn_torch.examples.mnist.train_mnist_checkpoint
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

import chainermn_torch
from chainermn_torch.datasets import equal_shards
from chainermn_torch.examples.mnist.train_mnist import (
    ArrayDataset,
    collate,
    load_mnist,
)
from chainermn_torch.extensions.checkpoint import to_tensors
from chainermn_torch.models import MLP
from chainermn_torch.training import train_step
from chainermn_torch.utils import ensure_batch_fits


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN-torch example: MNIST with checkpointing")
    parser.add_argument("--batchsize", "-b", type=int, default=100)
    parser.add_argument("--epoch", "-e", type=int, default=5)
    parser.add_argument("--unit", "-u", type=int, default=200)
    parser.add_argument("--communicator", type=str, default="tpu")
    parser.add_argument("--out", type=str, default=os.path.join(
        tempfile.gettempdir(), "chainermn_torch_ckpt"))
    parser.add_argument("--frequency", type=int, default=5,
                        help="snapshot every N iterations")
    parser.add_argument("--stop-at", type=int, default=None,
                        help="simulate a crash after N iterations")
    parser.add_argument("--data", type=str, default=None)
    parser.add_argument("--n-train", type=int, default=4000)
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current CUDA "
                             "card; 'cpu' runs over gloo)")
    return parser


def main(argv=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``);
    ``--stop-at`` ends it with ``SystemExit(1)``. Returns the iteration
    it resumed from (0 for a fresh start), the final iteration, the loss
    of every snapshot iteration and the checkpointer's stats."""
    args = _parser().parse_args(argv)

    chainermn_torch.add_global_except_hook()
    comm = chainermn_torch.create_communicator(args.communicator,
                                               device=args.device)

    (x_train, y_train), _ = load_mnist(args.data, args.n_train, 1)
    train = equal_shards(chainermn_torch.scatter_dataset(
        ArrayDataset(x_train, y_train), comm, shuffle=True, seed=0), comm)
    ensure_batch_fits(train, args.batchsize)
    it = chainermn_torch.SerialIterator(train, args.batchsize, shuffle=True,
                                        seed=1)

    model = MLP(n_units=args.unit, device=comm.device, seed=0)
    comm.bcast_data(model)
    optimizer = chainermn_torch.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)
    step = train_step(model, optimizer, comm)

    checkpointer = chainermn_torch.create_multi_node_checkpointer(
        name="mnist_example", comm=comm, path=args.out)

    def snapshot() -> dict:
        return {"model": model.state_dict(),
                "optimizer": optimizer.state_dict(),
                "iterator": it.state_dict()}

    state, iteration = checkpointer.maybe_load(snapshot())
    resumed_from = iteration
    if iteration > 0:
        model.load_state_dict(to_tensors(state["model"]))
        optimizer.load_state_dict(to_tensors(state["optimizer"]))
        it.load_state_dict(state["iterator"])
        if comm.rank == 0:
            print(f"resumed from iteration {iteration}", flush=True)
    elif comm.rank == 0:
        print("fresh start (no common snapshot)", flush=True)

    losses = {}
    while it.epoch < args.epoch:
        images, labels = collate(next(it))
        if len(labels) < args.batchsize:
            continue
        loss = step(torch.as_tensor(images), torch.as_tensor(labels))
        iteration += 1
        if iteration % args.frequency == 0:
            checkpointer.save(snapshot(), iteration)
            losses[iteration] = float(loss)
            if comm.rank == 0:
                print(f"iter {iteration:4d}  loss {losses[iteration]:.4f}  "
                      "[snapshot]", flush=True)
        if args.stop_at is not None and iteration >= args.stop_at:
            if comm.rank == 0:
                print(f"simulated crash at iteration {iteration}", flush=True)
            raise SystemExit(1)
    stats = checkpointer.get_stats()
    if comm.rank == 0:
        print(f"finished at iteration {iteration}; "
              f"checkpoint stats: {stats}", flush=True)
    comm.finalize()
    return {"resumed_from": resumed_from, "iteration": iteration,
            "snapshot_losses": losses, "checkpoint_stats": stats}


if __name__ == "__main__":
    main()
