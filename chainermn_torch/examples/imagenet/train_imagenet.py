#!/usr/bin/env python
"""ImageNet training — ChainerMN's benchmark workload, on the port.

The port's twin of ``examples/imagenet/train_imagenet.py``: the same
flags with the same meanings and defaults, the same printed lines under
the same conditions, and the same pieces — ``scatter_dataset``, the
``SerialIterator`` or the native C++ loader, the ``DevicePrefetcher``,
the multi-node optimizer (or the FSDP layout), multi-node BatchNorm, the
warmup-cosine LR with label smoothing and held-out top-1 through the
multi-node evaluator (``--recipe``), and the global except hook.

One process runs one rank on one GPU (the reference runs one process
over all its chips), so:

- ``--batchsize`` is per rank and each rank iterates its own
  ``scatter_dataset`` shard; the shards are made equal in length by
  repeating a shard's first records (ChainerMN's ``force_equal_length``)
  so every rank takes the same number of steps and evaluations;
- ``--communicator tpu`` (the default) is the port's ``pure_nccl``;
  ``--dtype`` is the gradient all-reduce's wire dtype;
- ``--device cpu`` runs a rank on the CPU over gloo (for tests); the
  default is the current CUDA card, and with none this raises.

Images are NCHW ``channels_last`` views of the NHWC batches the loaders
assemble (:func:`~chainermn_torch.interop.images_from_nhwc`, no copy);
the model casts them to its compute dtype (bf16) on the device.
``--train-dir`` (JPEG directories) is not ported yet: it raises. The
``done:`` line's images/s counts the training loop alone (the
reference's also spans the closing evaluation).

Data: ``--train-npz`` with arrays ``x`` (N, H, W, 3 uint8) and ``y``
(N,), or synthetic ImageNet-shaped data (default).

Run one rank on the card (throughput mode)::

    python -m chainermn_torch.examples.imagenet.train_imagenet \\
        --arch resnet50 --batchsize 256 --iterations 50 --dtype bfloat16

Several ranks: one process each, with ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT`` set (``LOCAL_WORLD_SIZE`` for the
two-level strategies).
"""

from __future__ import annotations

import argparse
import functools
import time

import numpy as np
import torch

import chainermn_torch
from chainermn_torch import models
from chainermn_torch.datasets import SubDataset, equal_shards
from chainermn_torch.interop import images_from_nhwc
from chainermn_torch.training import train_step
from chainermn_torch.utils import ensure_batch_fits


def _alex_spatial(size: int) -> int:
    """AlexNet's side after its last VALID 3x3/2 pool, for its first
    dense layer: an 11x11/4 SAME convolution, then three such pools."""
    s = -(-size // 4)
    for _ in range(3):
        s = (s - 3) // 2 + 1
    return s


# name -> factory(num_classes, image_size, **kw); kw: compute dtype,
# device, seed and (the ResNets) the norm factory
ARCHS = {
    "resnet18": lambda n, size, **kw: models.ResNet18(num_classes=n, **kw),
    "resnet34": lambda n, size, **kw: models.ResNet34(num_classes=n, **kw),
    "resnet50": lambda n, size, **kw: models.ResNet50(num_classes=n, **kw),
    "resnet101": lambda n, size, **kw: models.ResNet101(num_classes=n, **kw),
    "resnet152": lambda n, size, **kw: models.ResNet152(num_classes=n, **kw),
    "alex": lambda n, size, **kw: models.AlexNet(
        num_classes=n, spatial=_alex_spatial(size), **kw),
    "googlenet": lambda n, size, **kw: models.GoogLeNet(num_classes=n, **kw),
    "vgg16": lambda n, size, **kw: models.VGG16(
        num_classes=n, spatial=size // 32, **kw),
}
_WIRE = {"float32": None, "bfloat16": torch.bfloat16,
         "float16": torch.float16}


class SyntheticImageNet:
    """ImageNet-shaped synthetic records (uint8 images, int labels)."""

    def __init__(self, n: int, size: int = 224, classes: int = 1000,
                 seed: int = 0):
        self._rng = np.random.RandomState(seed)
        self.n, self.size, self.classes = n, size, classes
        # small pool of random images, resampled by index (cheap, no 150GB)
        self._pool = self._rng.randint(0, 256, (64, size, size, 3), np.uint8)
        self._labels = self._rng.randint(0, classes, n).astype(np.int32)

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        return self._pool[i % len(self._pool)], self._labels[i]


class NpzImageNet:
    def __init__(self, path: str):
        z = np.load(path)
        self.x, self.y = z["x"], z["y"].astype(np.int32)

    def __len__(self):
        return len(self.x)

    def __getitem__(self, i):
        return self.x[i], self.y[i]


def collate(batch, dtype):
    from chainermn_torch.native.dataloader import IMAGENET_MEAN, IMAGENET_STD

    xs, ys = zip(*batch)
    x = np.stack(xs).astype(np.float32) / 255.0
    # per-channel ImageNet normalization; constants shared with
    # NativeBatchLoader so both input paths normalize identically
    x = (x - np.array(IMAGENET_MEAN)) / np.array(IMAGENET_STD)
    return x.astype(dtype), np.asarray(ys, np.int32)


def record_source(ds):
    """(base_u8, rows, labels) view of a dataset for zero-copy native
    loading: ``rows[i]`` is sample i's row in ``base_u8``
    (SyntheticImageNet aliases its small pool; SubDataset shards compose
    indices)."""
    if isinstance(ds, SubDataset):
        base, rows, labels = record_source(ds._dataset)
        idx = np.asarray(ds.indices)
        return base, rows[idx], labels[idx]
    if isinstance(ds, SyntheticImageNet):
        rows = np.arange(len(ds), dtype=np.int64) % len(ds._pool)
        return ds._pool, rows, ds._labels
    if isinstance(ds, NpzImageNet):
        return ds.x, np.arange(len(ds), dtype=np.int64), ds.y
    raise TypeError(
        f"--native-loader supports the synthetic/npz datasets, got "
        f"{type(ds).__name__}")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="ChainerMN-torch example: ImageNet")
    parser.add_argument("--arch", "-a", default="resnet50",
                        choices=sorted(ARCHS))
    parser.add_argument("--batchsize", "-B", type=int, default=32,
                        help="per-rank batch size (reference default 32)")
    parser.add_argument("--epoch", "-E", type=int, default=1)
    parser.add_argument("--iterations", type=int, default=None,
                        help="stop after N iterations (throughput mode)")
    parser.add_argument("--communicator", default="tpu",
                        help="'tpu' is the port's 'pure_nccl'")
    parser.add_argument("--dtype", default="bfloat16",
                        choices=["float32", "bfloat16", "float16"],
                        help="allreduce wire dtype (reference "
                             "allreduce_grad_dtype)")
    parser.add_argument("--double-buffering", action="store_true",
                        help="1-step-stale overlapped gradient averaging")
    parser.add_argument("--mnbn", action="store_true",
                        help="multi-node BatchNorm (cross-rank statistics)")
    parser.add_argument("--train-npz", default=None)
    parser.add_argument("--train-dir", default=None,
                        help="directory of JPEGs in class subfolders (not "
                             "ported yet)")
    parser.add_argument("--n-synthetic", type=int, default=100000)
    parser.add_argument("--image-size", type=int, default=224)
    parser.add_argument("--classes", type=int, default=1000)
    parser.add_argument("--lr", type=float, default=0.1,
                        help="base LR; under --recipe this is the per-256 "
                             "base of the linear scaling rule")
    parser.add_argument(
        "--recipe", action="store_true",
        help="the 15-minute-run training recipe (arXiv:1711.04325): "
             "LR = lr x global_batch/256 with linear warmup then cosine "
             "decay, label smoothing 0.1, per-epoch top-1 eval on a "
             "held-out shard via the multi-node evaluator")
    parser.add_argument("--warmup-epochs", type=float, default=None,
                        help="LR warmup span (recipe default: 5)")
    parser.add_argument("--label-smoothing", type=float, default=None,
                        help="(recipe default: 0.1)")
    parser.add_argument("--val-frac", type=float, default=None,
                        help="held-out fraction for top-1 eval "
                             "(recipe default: 0.02)")
    parser.add_argument("--native-loader",
                        action=argparse.BooleanOptionalAction, default=None,
                        help="C++ batch assembly (gather + fused uint8->f32 "
                             "normalize, GIL-free threads) with one-batch "
                             "prefetch. Defaults ON under --recipe, where a "
                             "failed extension build degrades (all ranks "
                             "together) to numpy; an EXPLICIT "
                             "--native-loader fails hard instead")
    parser.add_argument("--device-prefetch", type=int, default=0,
                        help="wrap the pre-normalized input stream (native "
                             "C++ loader) in a dataflow.DevicePrefetcher: a "
                             "producer thread copies N batches ahead onto "
                             "the device, so H2D overlaps the step (0: feed "
                             "synchronously)")
    parser.add_argument("--fsdp", action="store_true",
                        help="ZeRO-3 layout: params/grads/moments sharded "
                             "over the ranks (parallel.fsdp); BN statistics "
                             "become global-batch (sync-BN)")
    parser.add_argument("--device", default=None,
                        help="this rank's device (default: the current CUDA "
                             "card; 'cpu' runs over gloo)")
    return parser


def main(argv=None, *, step_callback=None) -> dict:
    """Run the example with ``argv`` (``sys.argv[1:]`` when ``None``).
    ``step_callback(iteration, loss)``, when given, runs after every
    training step (``loss`` a device tensor). Returns a summary: the
    iteration count, the loop's images/s (first iteration excluded), the
    losses, the last top-1, the input pipeline and the prefetcher's H2D
    seconds per batch."""
    args = _parser().parse_args(argv)

    if args.fsdp and (args.mnbn or args.double_buffering):
        # FSDP's BatchNorm is already global-batch, and double buffering
        # configures the explicit gradient collective FSDP does not use
        raise SystemExit("--fsdp is incompatible with --mnbn/--double-buffering")
    if args.train_dir:
        raise SystemExit(
            "--train-dir needs the JPEG loader (chainermn_tpu/native/jpeg.py"
            "), which is not ported yet (ROADMAP.md, Queue A: host pieces)")

    if args.recipe:
        if args.warmup_epochs is None:
            args.warmup_epochs = 5.0
        if args.label_smoothing is None:
            args.label_smoothing = 0.1
        if args.val_frac is None:
            args.val_frac = 0.02
    # None = unspecified: the recipe defaults the native loader ON; an
    # explicit True keeps hard errors, an explicit False forces numpy
    native_explicit = args.native_loader is True
    if args.native_loader is None:
        args.native_loader = bool(args.recipe)
    args.warmup_epochs = args.warmup_epochs or 0.0
    args.label_smoothing = args.label_smoothing or 0.0
    args.val_frac = args.val_frac or 0.0

    chainermn_torch.add_global_except_hook()
    # FSDP has no explicit gradient collective to put a wire dtype on
    comm = chainermn_torch.create_communicator(
        args.communicator, device=args.device,
        allreduce_grad_dtype=None if args.fsdp else _WIRE[args.dtype])
    device = comm.device
    if comm.rank == 0:
        wire = "n/a (fsdp: FSDP reduces in the gradient dtype)" \
            if args.fsdp else args.dtype
        print(f"arch={args.arch} communicator={args.communicator} "
              f"wire-dtype={wire} double_buffering={args.double_buffering} "
              f"devices={comm.size}", flush=True)

    dataset = (NpzImageNet(args.train_npz) if args.train_npz
               else SyntheticImageNet(args.n_synthetic, args.image_size,
                                      args.classes))
    val = None
    if args.val_frac:
        # hold out the tail (a split every rank agrees on before scattering)
        n_val = max(1, int(len(dataset) * args.val_frac))
        val = SubDataset(dataset, range(len(dataset) - n_val, len(dataset)))
        dataset = SubDataset(dataset, range(len(dataset) - n_val))
    train = equal_shards(chainermn_torch.scatter_dataset(
        dataset, comm, shuffle=True, seed=0), comm)
    val_shard = (chainermn_torch.scatter_dataset(val, comm, shuffle=False)
                 if val is not None else None)

    kw = dict(device=device, seed=0)
    if args.mnbn and args.arch.startswith("resnet"):
        # the ResNets take a norm factory: multi-node BN with the
        # baseline BN hyperparameters, so --mnbn changes only the
        # statistics
        kw["norm"] = functools.partial(
            chainermn_torch.MultiNodeBatchNormalization, communicator=comm,
            momentum=0.9, eps=1e-5, dtype=torch.bfloat16)
    model = ARCHS[args.arch](args.classes, args.image_size, **kw)
    if args.mnbn and "norm" not in kw:
        model = chainermn_torch.create_mnbn_model(model, comm)
    comm.bcast_data(model)

    global_batch = args.batchsize * comm.size
    ensure_batch_fits(train, args.batchsize)
    batches = None
    if args.native_loader:
        try:
            from chainermn_torch.native.dataloader import NativeBatchLoader

            # zero-copy view of the shard: the C++ path gathers rows from
            # the base array, fuses the normalize, prefetches a batch ahead
            base, rows, ys = record_source(train)
            native_it = NativeBatchLoader(base, ys, args.batchsize,
                                          rows=rows, shuffle=True, seed=1)
            if not native_it._native:
                raise RuntimeError("the C++ library did not build")
        except Exception as e:  # toolchain/build failure on THIS rank
            print(f"[rank {comm.rank}] native loader unavailable "
                  f"({type(e).__name__}: {e})", flush=True)
            native_it = None
        # every rank must take the same input path (the step cadence is
        # collective): agree first, also on the explicit-flag failure path
        args.native_loader = comm.allreduce_obj(native_it is not None,
                                                lambda a, b: a and b)
        if native_explicit and not args.native_loader:
            raise SystemExit(
                "--native-loader was explicitly requested but the native "
                "extension is unavailable on at least one rank (see the "
                "per-rank diagnostics above); an explicit opt-in must not "
                "silently measure the numpy path")
        if args.native_loader:
            it = native_it
            batches = iter(it)
    if not args.native_loader:
        it = chainermn_torch.SerialIterator(train, args.batchsize,
                                            shuffle=True, seed=1)
    pre_normalized = args.native_loader
    if comm.rank == 0:
        print(f"input pipeline: "
              f"{'native C++ prefetch' if args.native_loader else 'numpy'}",
              flush=True)

    steps_per_epoch = max(1, (len(train) * comm.size) // global_batch)
    schedule = None
    if args.warmup_epochs:
        # linear scaling rule + warmup (arXiv:1711.04325); the
        # x global_batch/256 multiplier applies only under --recipe
        scaled_lr = (args.lr * global_batch / 256.0 if args.recipe
                     else args.lr)
        schedule = chainermn_torch.warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=scaled_lr,
            warmup_steps=max(1, int(args.warmup_epochs * steps_per_epoch)),
            decay_steps=max(2, args.epoch * steps_per_epoch))
    lr = 1.0 if schedule is not None else args.lr
    if args.fsdp:
        from chainermn_torch.parallel.fsdp import fsdp_shard, fsdp_train_step

        # no multi-node wrapper: FSDP averages the gradients
        model = fsdp_shard(model, comm)
        sgd = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
        optimizer = sgd
        step = fsdp_train_step(model, sgd, comm, train_kwargs={"train": True},
                               label_smoothing=args.label_smoothing)
    else:
        sgd = torch.optim.SGD(model.parameters(), lr=lr, momentum=0.9)
        optimizer = chainermn_torch.create_multi_node_optimizer(
            sgd, comm, double_buffering=args.double_buffering)
        step = train_step(model, optimizer, comm,
                          train_kwargs={"train": True},
                          label_smoothing=args.label_smoothing)
    scheduler = (torch.optim.lr_scheduler.LambdaLR(sgd, schedule)
                 if schedule is not None else None)

    # (an FSDP shard's numel is its whole parameter's)
    n_params = sum(p.numel() for p in model.parameters())
    if comm.rank == 0:
        print(f"{n_params / 1e6:.1f}M params, global batch {global_batch}",
              flush=True)

    def to_device(images, labels):
        images = images_from_nhwc(torch.as_tensor(images)).to(device)
        return images, torch.as_tensor(labels).to(device)

    evaluate = None
    if val_shard is not None:
        # FSDP's forward gathers weights, a collective: every rank runs
        # as many eval forwards as the rank with the most batches
        n_eval = -(-len(val_shard) // args.batchsize)
        if args.fsdp:
            n_eval = comm.allreduce_obj(n_eval, max)

        @torch.no_grad()
        def _local_eval():
            # top-1 over this rank's held-out shard; the multi-node
            # evaluator averages the dicts across ranks
            correct = n = 0
            batches_val = iter(chainermn_torch.SerialIterator(
                val_shard, args.batchsize, repeat=False, shuffle=False))
            for _ in range(n_eval):
                batch = next(batches_val, None)
                if batch is None:    # FSDP: a forward for the others' sake
                    x = np.zeros((1, args.image_size, args.image_size, 3),
                                 np.float32)
                    model(to_device(x, [0])[0], train=False)
                    continue
                x, y = collate(batch, np.float32)
                pred = model(to_device(x, y)[0], train=False).argmax(-1)
                correct += int((pred.cpu().numpy() == y).sum())
                n += len(y)
            return {"validation/main/accuracy": correct / max(n, 1)}

        evaluate = chainermn_torch.create_multi_node_evaluator(_local_eval,
                                                               comm)

    h2d = None
    if args.device_prefetch:
        if not pre_normalized:
            raise SystemExit(
                "--device-prefetch wraps the pre-normalized input stream "
                "(native C++ loader); the numpy SerialIterator path collates "
                "inside the loop — use --native-loader")
        from chainermn_torch.dataflow import DevicePrefetcher
        from chainermn_torch.monitor import get_registry

        h2d = get_registry().histogram("prefetch_h2d_seconds",
                                       {"name": "imagenet"})
        h2d_seen = len(h2d.samples)
        # epoch/is_new_epoch on the wrapper track DELIVERED batches
        batches = it = DevicePrefetcher(it, depth=args.device_prefetch,
                                        device=device, name="imagenet")
        if comm.rank == 0:
            print(f"device prefetch: depth {args.device_prefetch} "
                  "(H2D on a producer thread)", flush=True)

    iteration = 0
    t0 = time.time()
    imgs = 0
    losses = []
    top1 = None
    model.train()
    while it.epoch < args.epoch:
        if pre_normalized:
            images, labels = next(batches)  # pre-normalized, never ragged
        else:
            images, labels = collate(next(it), np.float32)
        if len(labels) == args.batchsize:  # ragged tails skip the step
            loss = step(*to_device(images, labels))
            if scheduler is not None:
                scheduler.step()
            losses.append(loss)
            iteration += 1
            imgs += global_batch
            if iteration == 1:
                first = float(loss)
                t0, imgs = time.time(), 0  # exclude the first step
                if comm.rank == 0:
                    print(f"compiled; first loss {first:.3f}", flush=True)
            elif iteration % 20 == 0 and comm.rank == 0:
                dt = time.time() - t0
                print(f"iter {iteration:5d}  loss {float(loss):.3f}  "
                      f"{imgs / dt:.1f} img/s ({imgs / dt / comm.size:.1f}"
                      f"/rank)", flush=True)
            if step_callback is not None:
                step_callback(iteration, loss)
        if it.is_new_epoch and evaluate is not None:
            top1 = evaluate()["validation/main/accuracy"]
            model.train()
            if comm.rank == 0:
                print(f"epoch {it.epoch:3d}  top-1 {top1:.4f}", flush=True)
        if args.iterations and iteration >= args.iterations:
            break
    finite = bool(torch.stack(losses).isfinite().all()) if losses else True
    dt = time.time() - t0
    if args.device_prefetch:
        it.close()  # stop + join the producer thread
    if evaluate is not None and not it.is_new_epoch:
        # exited mid-epoch (--iterations): still report a final top-1
        top1 = evaluate()["validation/main/accuracy"]
        if comm.rank == 0:
            print(f"final top-1 {top1:.4f}", flush=True)
    if comm.rank == 0 and imgs:
        print(f"done: {iteration} iterations, {imgs / dt:.1f} img/s "
              f"({imgs / dt / comm.size:.2f} img/s/rank)", flush=True)
    h2d_s = None
    if h2d is not None:
        seen = h2d.samples[h2d_seen:]
        h2d_s = sum(seen) / len(seen) if seen else None
    summary = {"iterations": iteration,
               "images_per_sec": imgs / dt if imgs else None,
               "losses": [float(x) for x in losses], "losses_finite": finite,
               "top1": top1, "native_loader": bool(args.native_loader),
               "h2d_seconds_per_batch": h2d_s, "params": n_params,
               "global_batch": global_batch}
    comm.finalize()
    return summary


if __name__ == "__main__":
    main()
