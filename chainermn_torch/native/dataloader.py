"""Prefetching native batch loader (ctypes over ``dataloader.cc``): the
port of ``chainermn_tpu/native/dataloader.py``, host code copied as it
is, ``dataloader.cc`` unchanged.

ChainerMN's ImageNet example feeds its data through Chainer's
MultiprocessIterator (worker processes doing decode and batch assembly).
This loader does the same work as:

- **batch assembly in C++** (``dl_gather_f32``): gather the sampled
  records from a contiguous uint8 array and fuse the uint8 -> float32
  ``(x/255 - mean) / std`` normalization, multithreaded, with the GIL
  released for the whole call;
- **prefetch** on a Python producer thread (``prefetch_depth`` batches
  ahead, default 2): while the training step runs, the next batches are
  being assembled. Abandoning iteration early stops and joins the
  producer. Compose with :class:`chainermn_torch.dataflow.DevicePrefetcher`
  to move the host-to-device copy off the critical path too.

Falls back to a numpy implementation of the same arithmetic when the g++
build fails (``native_available()`` says which path runs), as the
reference does. The reference's fault-injection cut point in
``_assemble`` is not ported (the port has no ``resilience`` package).
"""

from __future__ import annotations

import ctypes
import os
import queue
import threading
from typing import Optional, Sequence

import numpy as np

_lib = None
_lib_error: Optional[str] = None

# The ImageNet per-channel normalization the reference's example applies via
# a mean image; shared so every input path normalizes identically.
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def _load():
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(f"dataloader library unavailable: {_lib_error}")
    try:
        from chainermn_torch.native._build import build_and_load

        lib = build_and_load("dataloader.cc", "dataloader")
    except Exception as e:
        _lib_error = f"{type(e).__name__}: {e}"
        raise RuntimeError(f"dataloader library unavailable: {_lib_error}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.dl_gather_f32.argtypes = [u8p, ctypes.c_uint64, ctypes.c_uint64,
                                  i64p, ctypes.c_uint64, f32p, f32p, f32p,
                                  ctypes.c_int]
    lib.dl_gather_u8.argtypes = [u8p, ctypes.c_uint64, i64p,
                                 ctypes.c_uint64, u8p, ctypes.c_int]
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


class NativeBatchLoader:
    """Iterate normalized float32 batches over ``(images_u8, labels)``.

    ``images_u8``: contiguous ``[N, ...]`` uint8 array whose trailing axis is
    channels (NHWC); ``labels``: per-SAMPLE ints. ``rows`` (optional) maps
    each sample to its row in ``images_u8`` — samples may alias base rows
    (e.g. a small synthetic pool) or be a shard's subset, with no copy of
    the base array. Yields ``(batch_f32 [B, ...], labels [B])`` forever
    (``repeat=True``) or for one epoch. Shuffles with a per-epoch seeded
    permutation — every process of an SPMD launch constructs the same
    order, matching the synchronized-iterator posture of the host
    framework.
    """

    def __init__(
        self,
        images_u8: np.ndarray,
        labels: Sequence[int],
        batch_size: int,
        *,
        rows: Optional[Sequence[int]] = None,
        mean: Sequence[float] = IMAGENET_MEAN,
        std: Sequence[float] = IMAGENET_STD,
        shuffle: bool = True,
        repeat: bool = True,
        seed: int = 0,
        n_threads: Optional[int] = None,
        prefetch: bool = True,
        prefetch_depth: int = 2,
    ) -> None:
        self._x = np.ascontiguousarray(images_u8)
        if self._x.dtype != np.uint8:
            raise TypeError(f"images must be uint8, got {self._x.dtype}")
        self._y = np.asarray(labels, np.int32)
        self._rows = (np.arange(len(self._x), dtype=np.int64) if rows is None
                      else np.asarray(rows, np.int64))
        if len(self._rows) != len(self._y):
            raise ValueError(f"{len(self._rows)} rows vs {len(self._y)} labels")
        if len(self._rows) and (self._rows.min() < 0
                                or self._rows.max() >= len(self._x)):
            raise ValueError(
                f"rows reference [{self._rows.min()}, {self._rows.max()}] "
                f"outside the base array's {len(self._x)} rows"
            )
        if batch_size > len(self._rows):
            raise ValueError(
                f"batch_size {batch_size} > dataset size {len(self._rows)}"
            )
        self._batch = batch_size
        self._channels = int(self._x.shape[-1])
        self._rec_elems = int(np.prod(self._x.shape[1:]))
        self._mean = np.asarray(mean, np.float32)
        self._stdinv = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
        if len(self._mean) != self._channels or len(self._stdinv) != self._channels:
            raise ValueError(
                f"{len(self._mean)} mean / {len(self._stdinv)} std values "
                f"for {self._channels} channels"
            )
        self._shuffle = shuffle
        self._repeat = repeat
        self._seed = seed
        self._n_threads = n_threads or min(8, os.cpu_count() or 1)
        self._native = native_available()
        self._prefetch = prefetch
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        self._prefetch_depth = int(prefetch_depth)
        self._producers: list[threading.Thread] = []
        self.epoch = 0
        self.is_new_epoch = False

    # -- batch assembly ------------------------------------------------- #

    def _assemble(self, row_idx: np.ndarray) -> np.ndarray:
        """Gather base rows -> normalized float32 images."""
        out = np.empty((len(row_idx),) + self._x.shape[1:], np.float32)
        if self._native:
            lib = _load()
            idx64 = np.ascontiguousarray(row_idx, np.int64)
            lib.dl_gather_f32(
                self._x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                self._rec_elems, self._channels,
                idx64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                len(idx64),
                self._mean.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._stdinv.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                self._n_threads,
            )
        else:  # pure-python fallback: same math
            gathered = self._x[row_idx].astype(np.float32) / 255.0
            out[:] = (gathered - self._mean) * self._stdinv
        return out

    # -- iteration with one-batch-ahead prefetch ------------------------ #

    def _index_batches(self):
        n = len(self._rows)
        epoch = 0
        while True:
            order = (np.random.RandomState(self._seed + epoch).permutation(n)
                     if self._shuffle else np.arange(n))
            n_full = n // self._batch
            for i in range(n_full):
                last = i == n_full - 1
                sel = order[i * self._batch:(i + 1) * self._batch]
                yield sel, last
            epoch += 1
            if not self._repeat:
                return

    def __iter__(self):
        if not self._prefetch:
            for sel, last in self._index_batches():
                self.is_new_epoch = last
                if last:
                    self.epoch += 1
                yield self._assemble_sel(sel)
            return
        # per-iterator state: multiple live iterators (or a closed earlier
        # one) must not stop each other's producer
        q: queue.Queue = queue.Queue(maxsize=self._prefetch_depth)
        stop = threading.Event()

        def offer(item) -> bool:
            # a bounded put that close() can always interrupt — a producer
            # parked in a plain q.put() would outlive abandoned iteration
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.05)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            for sel, last in self._index_batches():
                if stop.is_set():
                    return
                if not offer((self._assemble_sel(sel), last)):
                    return
            offer(None)

        worker = threading.Thread(target=producer, daemon=True)
        self._producers = [t for t in self._producers if t.is_alive()]
        self._producers.append(worker)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                batch, last = item
                self.is_new_epoch = last
                if last:
                    self.epoch += 1
                yield batch
        finally:
            # abandoned-early or exhausted: stop, drain (unblocks a full-
            # queue put), and JOIN — no daemon-thread leak per epoch
            stop.set()
            while True:
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
            worker.join(timeout=5.0)

    def _assemble_sel(self, sel: np.ndarray):
        """Sample positions -> (normalized images, labels)."""
        return self._assemble(self._rows[sel]), self._y[sel]

    def __len__(self) -> int:
        return len(self._rows) // self._batch


__all__ = ["NativeBatchLoader", "native_available",
           "IMAGENET_MEAN", "IMAGENET_STD"]


def _bench(batch=128, size=224, n=20) -> None:
    """`python -m chainermn_torch.native.dataloader`: native vs numpy batch
    assembly on an ImageNet-shaped batch."""
    import time

    rng = np.random.RandomState(0)
    x = rng.randint(0, 256, (max(512, batch), size, size, 3), np.uint8)
    y = rng.randint(0, 1000, len(x)).astype(np.int32)
    if not native_available():
        print(f"WARNING: native library unavailable ({_lib_error}); "
              "both rows below are the numpy fallback")
    for native in (True, False):
        loader = NativeBatchLoader(x, y, batch, prefetch=False, shuffle=True)
        loader._native = native and native_available()
        it = iter(loader)
        next(it)  # warm (build/load the library)
        t0 = time.perf_counter()
        for _ in range(n):
            next(it)
        ms = (time.perf_counter() - t0) / n * 1e3
        label = "native" if loader._native else "numpy "
        print(f"{label}: {ms:6.1f} ms/batch "
              f"({batch * size * size * 3 / ms / 1e6:.2f} GB/s)")


if __name__ == "__main__":
    _bench()
