#!/usr/bin/env python
"""MNIST data-parallel training — ChainerMN's minimum end-to-end slice, on
the port.

The twin of ``examples/mnist/train_mnist.py``: the same flags with the
same meanings and defaults, the same printed lines, and the same pieces —
``scatter_dataset``, ``SerialIterator``, the MLP, the multi-node
optimizer over Adam(1e-3) and the multi-node evaluator. One process runs
one rank (the reference runs one process over all its chips), so
``--batchsize`` is per rank, each rank iterates its own shard (shards
padded to equal length, as ChainerMN's ``force_equal_length``), and
``--communicator tpu`` (the default) is the port's ``pure_nccl``.
``--device cpu`` runs a rank on the CPU over gloo; the default is the
current CUDA card.

MNIST itself needs a download; without ``--data mnist.npz`` the
reference's seeded synthetic stand-in is used (each class a fixed random
template, samples template + noise), bit for bit the same arrays.

Run one rank on the card::

    python -m chainermn_torch.examples.mnist.train_mnist

Several ranks: one process each, with ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

import chainermn_torch
from chainermn_torch.datasets import equal_shards
from chainermn_torch.models import MLP
from chainermn_torch.training import train_step
from chainermn_torch.utils import ensure_batch_fits


def load_mnist(path: str | None, n_train: int, n_test: int, seed: int = 0):
    """``mnist.npz`` (keras layout: x_train/y_train/x_test/y_test) or a
    synthetic, learnable stand-in: each class has a fixed random template,
    samples are template + noise."""
    if path:
        with np.load(path) as z:
            return (
                (z["x_train"][:n_train].astype(np.float32) / 255.0,
                 z["y_train"][:n_train].astype(np.int32)),
                (z["x_test"][:n_test].astype(np.float32) / 255.0,
                 z["y_test"][:n_test].astype(np.int32)),
            )
    rng = np.random.RandomState(seed)
    templates = rng.rand(10, 28, 28).astype(np.float32)

    def draw(n):
        y = rng.randint(0, 10, size=n).astype(np.int32)
        x = templates[y] + 0.3 * rng.randn(n, 28, 28).astype(np.float32)
        return np.clip(x, 0.0, 1.0), y

    return draw(n_train), draw(n_test)


class ArrayDataset:
    """(x, y) record view over parallel arrays (chainer's TupleDataset
    shape)."""

    def __init__(self, x: np.ndarray, y: np.ndarray) -> None:
        if len(x) != len(y):
            raise ValueError(f"{len(x)} inputs for {len(y)} labels")
        self.x, self.y = x, y

    def __len__(self) -> int:
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def collate(batch) -> tuple[np.ndarray, np.ndarray]:
    xs, ys = zip(*batch)
    return np.stack(xs), np.asarray(ys, np.int32)


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN-torch example: MNIST")
    parser.add_argument("--batchsize", "-b", type=int, default=100,
                        help="per-rank batch size (reference default)")
    parser.add_argument("--epoch", "-e", type=int, default=20)
    parser.add_argument("--unit", "-u", type=int, default=1000)
    parser.add_argument("--communicator", type=str, default="tpu",
                        help="naive | flat | tpu | pure_nccl | hierarchical "
                             "| two_dimensional | single_node")
    parser.add_argument("--data", type=str, default=None,
                        help="path to mnist.npz (keras layout); synthetic "
                             "if absent")
    parser.add_argument("--n-train", type=int, default=10000)
    parser.add_argument("--n-test", type=int, default=2000)
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current CUDA "
                             "card; 'cpu' runs over gloo)")
    return parser


def main(argv=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``).
    Returns a summary: the steps, the first step's loss, each epoch's last
    loss and validation metrics, and the seconds spent training (the loop
    without the evaluations, closed by each epoch's loss fetch)."""
    args = _parser().parse_args(argv)

    chainermn_torch.add_global_except_hook()
    comm = chainermn_torch.create_communicator(args.communicator,
                                               device=args.device)
    device = comm.device
    if comm.rank == 0:
        print(f"communicator: {args.communicator}  size: {comm.size} "
              f"(intra {comm.intra_size} x inter {comm.inter_size})",
              flush=True)

    (x_train, y_train), (x_test, y_test) = load_mnist(
        args.data, args.n_train, args.n_test)
    train = equal_shards(chainermn_torch.scatter_dataset(
        ArrayDataset(x_train, y_train), comm, shuffle=True, seed=0), comm)
    test = chainermn_torch.scatter_dataset(ArrayDataset(x_test, y_test), comm)

    model = MLP(n_units=args.unit, device=device, seed=0)
    comm.bcast_data(model)
    global_batch = args.batchsize * comm.size
    ensure_batch_fits(train, args.batchsize)
    it = chainermn_torch.SerialIterator(train, args.batchsize, shuffle=True,
                                        seed=1)
    optimizer = chainermn_torch.create_multi_node_optimizer(
        torch.optim.Adam(model.parameters(), lr=1e-3), comm)
    step = train_step(model, optimizer, comm)

    @torch.no_grad()
    def evaluate() -> dict:
        tot_loss = tot_acc = 0.0
        n = 0
        for batch in chainermn_torch.SerialIterator(
                test, args.batchsize, repeat=False, shuffle=False):
            images, labels = collate(batch)
            labels_t = torch.as_tensor(labels, device=device).long()
            logits = model(torch.as_tensor(images, device=device))
            tot_loss += float(F.cross_entropy(logits, labels_t,
                                              reduction="sum"))
            tot_acc += float((logits.argmax(-1) == labels_t).sum())
            n += len(labels)
        n = max(n, 1)
        return {"validation/main/loss": tot_loss / n,
                "validation/main/accuracy": tot_acc / n}

    evaluator = chainermn_torch.create_multi_node_evaluator(evaluate, comm)

    steps_per_epoch = max(1, len(train) // args.batchsize)
    epochs = []
    first_loss = None
    steps = 0
    train_s = 0.0
    t0 = t_epoch = time.time()
    loss = torch.zeros((), device=device)
    while it.epoch < args.epoch:
        images, labels = collate(next(it))
        if len(labels) == args.batchsize:  # ragged tail: skip (as the reference)
            loss = step(torch.as_tensor(images), torch.as_tensor(labels))
            steps += 1
            if first_loss is None:
                first_loss = float(loss)
        if it.is_new_epoch:
            last = float(loss)
            train_s += time.time() - t_epoch
            metrics = evaluator.evaluate()
            epochs.append({"epoch": it.epoch, "loss": last, **metrics})
            if comm.rank == 0:
                print(f"epoch {it.epoch:3d}  train/loss {last:.4f}  "
                      f"val/loss {metrics['validation/main/loss']:.4f}  "
                      f"val/acc {metrics['validation/main/accuracy']:.4f}  "
                      f"({(time.time() - t0) / it.epoch:.2f}s/epoch, "
                      f"{steps_per_epoch} steps)", flush=True)
            t_epoch = time.time()
    if comm.rank == 0:
        print(f"done in {time.time() - t0:.1f}s", flush=True)
    summary = {"steps": steps, "global_batch": global_batch,
               "first_loss": first_loss, "epochs": epochs,
               "train_seconds": train_s}
    comm.finalize()
    return summary


if __name__ == "__main__":
    main()
