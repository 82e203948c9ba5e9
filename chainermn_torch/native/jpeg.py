"""JPEG directory input pipeline (ctypes over ``jpeg_loader.cc``): the
port of ``chainermn_tpu/native/jpeg.py``, host code copied as it is,
with its own copy of ``jpeg_loader.cc``.

ChainerMN's ImageNet example decodes JPEGs in MultiprocessIterator
worker processes. This module does the same work as:

- **decode + resize + normalize in C++** (``dl_decode_jpegs``): libjpeg
  with DCT scaling (decode work drops ~4x per halving), bilinear resize
  (half-pixel centers), fused ``(x/255 - mean) / std`` — multithreaded,
  GIL released for the whole batch;
- **prefetch depth >= 2** on a producer thread: file reads + decodes for
  the next batches overlap the training step;
- **the PIL path** when libjpeg or ``g++`` is missing: PIL decodes
  (itself libjpeg-based, with ``draft`` mirroring the DCT prescale), then
  a numpy bilinear that mirrors the C++ formula exactly; the images of a
  batch are spread over the same thread count as the C++ decoder's (the
  reference's PIL path is serial; the arrays are the same).

Which path runs is never silent: ``decoder="native"`` demands the C++
decoder (raises when it does not build), ``decoder="pil"`` takes PIL,
and the default takes the C++ decoder when it builds and otherwise says
on stderr, once, that PIL decodes. ``DECODED`` counts the images each
path decoded.

``JpegDirectoryLoader`` reads an ImageFolder-style tree
(``root/<class_name>/*.jpg``, classes sorted lexicographically) and
yields float32 NHWC batches.
"""

from __future__ import annotations

import ctypes
import os
import queue
import sys
import threading
from typing import Optional, Sequence

import numpy as np

from chainermn_torch.native.dataloader import IMAGENET_MEAN, IMAGENET_STD

_lib = None
_lib_error: Optional[str] = None
_warned_pil = False

_EXTS = (".jpg", ".jpeg", ".JPG", ".JPEG")
DECODERS = ("native", "pil")
# images decoded by each path since the process started
DECODED = {"native": 0, "pil": 0}


def _load():
    global _lib, _lib_error
    if _lib is not None:
        return _lib
    if _lib_error is not None:
        raise RuntimeError(f"jpeg library unavailable: {_lib_error}")
    try:
        from chainermn_torch.native._build import build_and_load

        lib = build_and_load("jpeg_loader.cc", "jpeg_loader",
                             extra_flags=("-ljpeg",))
    except Exception as e:
        _lib_error = f"{type(e).__name__}: {e}"
        raise RuntimeError(f"jpeg library unavailable: {_lib_error}")
    u8p = ctypes.POINTER(ctypes.c_uint8)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.dl_decode_jpegs.argtypes = [u8p, u64p, u64p, ctypes.c_uint64,
                                    ctypes.c_uint64, ctypes.c_uint64,
                                    f32p, f32p, f32p, ctypes.c_int]
    lib.dl_decode_jpegs.restype = ctypes.c_int
    _lib = lib
    return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def resolve_decoder(decoder: Optional[str] = None) -> str:
    """The path that will decode: ``"native"`` or ``"pil"``. ``None``
    takes the C++ decoder when it builds and otherwise says once, on
    stderr, that PIL decodes; ``"native"`` raises when it does not
    build."""
    global _warned_pil
    if decoder not in (None,) + DECODERS:
        raise ValueError(f"decoder must be one of {DECODERS} or None, "
                         f"got {decoder!r}")
    if decoder == "pil":
        return "pil"
    if native_available():
        return "native"
    if decoder == "native":
        raise RuntimeError(f"decoder='native' but the C++ JPEG decoder "
                           f"does not build: {_lib_error}")
    if not _warned_pil:
        _warned_pil = True
        print(f"chainermn_torch.native.jpeg: the C++ decoder does not "
              f"build ({_lib_error}); PIL decodes", file=sys.stderr)
    return "pil"


def _resize_normalize_np(img_u8: np.ndarray, oh: int, ow: int,
                         mean: np.ndarray, stdinv: np.ndarray) -> np.ndarray:
    """Numpy mirror of jpeg_loader.cc's resize_normalize (bilinear,
    half-pixel centers, clamped edges)."""
    sh, sw = img_u8.shape[:2]
    fy = np.clip((np.arange(oh) + 0.5) * (sh / oh) - 0.5, 0, sh - 1)
    fx = np.clip((np.arange(ow) + 0.5) * (sw / ow) - 0.5, 0, sw - 1)
    y0 = fy.astype(np.int64)
    x0 = fx.astype(np.int64)
    y1 = np.minimum(y0 + 1, sh - 1)
    x1 = np.minimum(x0 + 1, sw - 1)
    wy = (fy - y0).astype(np.float32)[:, None, None]
    wx = (fx - x0).astype(np.float32)[None, :, None]
    img = img_u8.astype(np.float32)
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    v = (top * (1 - wy) + bot * wy) / 255.0
    return (v - mean) * stdinv


def decode_jpeg_batch(blobs: Sequence[bytes], image_size: int,
                      *, mean=IMAGENET_MEAN, std=IMAGENET_STD,
                      n_threads: Optional[int] = None,
                      force_fallback: bool = False,
                      decoder: Optional[str] = None):
    """Decode a batch of JPEG byte strings to a normalized float32 array
    ``[B, image_size, image_size, 3]``. Returns ``(batch, n_failed)``;
    failed decodes are zero rows (training shrugs off a corrupt file
    instead of crashing an epoch in). ``force_fallback=True`` is
    ``decoder="pil"`` (the reference's spelling)."""
    path = resolve_decoder("pil" if force_fallback else decoder)
    meanf = np.asarray(mean, np.float32)
    stdinvf = (1.0 / np.asarray(std, np.float32)).astype(np.float32)
    n = len(blobs)
    out = np.empty((n, image_size, image_size, 3), np.float32)
    DECODED[path] += n
    if path == "native":
        blob = np.frombuffer(b"".join(blobs), np.uint8)
        sizes = np.asarray([len(b) for b in blobs], np.uint64)
        offsets = np.zeros(n, np.uint64)
        np.cumsum(sizes[:-1], out=offsets[1:])
        lib = _load()
        nfail = lib.dl_decode_jpegs(
            blob.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            n, image_size, image_size,
            meanf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            stdinvf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            n_threads or min(8, os.cpu_count() or 1),
        )
        return out, int(nfail)
    # PIL: decode (PIL is libjpeg-based; draft applies the same DCT
    # prescale the native path uses), then the mirrored numpy resize, on
    # ``n_threads`` threads (PIL's decoder releases the GIL); the
    # reference decodes these serially, to the same arrays
    import io
    from concurrent.futures import ThreadPoolExecutor

    from PIL import Image

    def one(i: int) -> int:
        try:
            img = Image.open(io.BytesIO(blobs[i]))
            img.draft("RGB", (image_size, image_size))
            arr = np.asarray(img.convert("RGB"), np.uint8)
            out[i] = _resize_normalize_np(arr, image_size, image_size,
                                          meanf, stdinvf)
            return 0
        except Exception:
            out[i] = 0.0
            return 1

    threads = min(n, n_threads or min(8, os.cpu_count() or 1))
    if threads <= 1:
        return out, sum(map(one, range(n)))
    with ThreadPoolExecutor(threads) as ex:
        return out, sum(ex.map(one, range(n)))


def scan_image_directory(root: str):
    """ImageFolder-style scan: ``root/<class>/*.jpg`` -> (paths, labels,
    class_names), classes sorted lexicographically (the torchvision and
    reference-example convention)."""
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    if not classes:
        raise ValueError(f"no class subdirectories under {root!r}")
    paths, labels = [], []
    for ci, cname in enumerate(classes):
        cdir = os.path.join(root, cname)
        for f in sorted(os.listdir(cdir)):
            if f.endswith(_EXTS):
                paths.append(os.path.join(cdir, f))
                labels.append(ci)
    if not paths:
        raise ValueError(f"no JPEG files under {root!r}")
    return paths, np.asarray(labels, np.int32), classes


class JpegDirectoryLoader:
    """Iterate normalized float32 batches from a directory of JPEGs.

    ``rank``/``size`` shard the FILE LIST (each rank owns
    ``paths[rank::size]``) for data-parallel launches; the per-epoch
    shuffle is seeded identically everywhere so shards stay disjoint.
    A producer thread keeps ``prefetch_depth`` decoded batches ahead of
    the training loop (file read + native decode both release the GIL).
    Yields ``(images [B, S, S, 3] float32, labels [B] int32)``.
    ``decoder`` picks the path (module docstring); ``self.decoder`` is
    the one that runs.
    """

    def __init__(self, root: str, batch_size: int, *, image_size: int = 224,
                 mean=IMAGENET_MEAN, std=IMAGENET_STD, shuffle: bool = True,
                 repeat: bool = True, seed: int = 0, rank: int = 0,
                 size: int = 1, n_threads: Optional[int] = None,
                 prefetch_depth: int = 2, decoder: Optional[str] = None):
        paths, labels, self.class_names = scan_image_directory(root)
        self._paths = paths[rank::size]
        self._labels = labels[rank::size]
        if batch_size > len(self._paths):
            raise ValueError(
                f"batch_size {batch_size} > shard size {len(self._paths)} "
                f"(rank {rank}/{size}, {len(paths)} files total)"
            )
        self.decoder = resolve_decoder(decoder)
        self._batch = batch_size
        self._size = image_size
        self._mean, self._std = mean, std
        self._shuffle, self._repeat, self._seed = shuffle, repeat, seed
        self._n_threads = n_threads
        self._depth = max(1, prefetch_depth)
        self.epoch = 0
        self.is_new_epoch = False
        self.failed_decodes = 0

    def _index_batches(self):
        n = len(self._paths)
        epoch = 0
        while True:
            order = (np.random.RandomState(self._seed + epoch).permutation(n)
                     if self._shuffle else np.arange(n))
            n_full = n // self._batch
            for i in range(n_full):
                yield order[i * self._batch:(i + 1) * self._batch], \
                    i == n_full - 1
            epoch += 1
            if not self._repeat:
                return

    def _make_batch(self, sel: np.ndarray):
        blobs = []
        for j in sel:
            with open(self._paths[j], "rb") as f:
                blobs.append(f.read())
        imgs, nfail = decode_jpeg_batch(
            blobs, self._size, mean=self._mean, std=self._std,
            n_threads=self._n_threads, decoder=self.decoder)
        self.failed_decodes += nfail
        return imgs, self._labels[sel]

    def __iter__(self):
        q: queue.Queue = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def producer():
            # any failure must reach the consumer: a dead producer with no
            # sentinel would hang the training loop on q.get() forever
            # (and strand every other rank in its next collective)
            try:
                for sel, last in self._index_batches():
                    if stop.is_set():
                        return
                    q.put((self._make_batch(sel), last))
                q.put(None)
            except BaseException as e:  # noqa: BLE001
                q.put(e)

        worker = threading.Thread(target=producer, daemon=True)
        worker.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise RuntimeError(
                        "JpegDirectoryLoader producer failed") from item
                batch, last = item
                self.is_new_epoch = last
                if last:
                    self.epoch += 1
                yield batch
        finally:
            stop.set()
            try:  # unblock a producer waiting on a full queue
                q.get_nowait()
            except queue.Empty:
                pass

    def __len__(self) -> int:
        return len(self._paths) // self._batch


__all__ = ["DECODED", "JpegDirectoryLoader", "decode_jpeg_batch",
           "native_available", "resolve_decoder", "scan_image_directory"]


def _bench(n_imgs=64, src=256, tgt=224, n=5) -> None:
    """``python -m chainermn_torch.native.jpeg``: native libjpeg vs PIL
    decode+resize+normalize on a JPEG batch."""
    import io
    import time

    from PIL import Image

    rs = np.random.RandomState(0)
    blobs = []
    for _ in range(n_imgs):
        arr = (np.kron(rs.rand(src // 8, src // 8, 3),
                       np.ones((8, 8, 1)))[:src, :src] * 255).astype(np.uint8)
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, "JPEG", quality=90)
        blobs.append(buf.getvalue())
    for decoder in DECODERS:
        if decoder == "native" and not native_available():
            print(f"native: unavailable ({_lib_error})")
            continue
        decode_jpeg_batch(blobs[:2], tgt, decoder=decoder)  # warm
        t0 = time.perf_counter()
        for _ in range(n):
            _, nfail = decode_jpeg_batch(blobs, tgt, decoder=decoder)
            assert nfail == 0
        ms = (time.perf_counter() - t0) / n * 1e3
        print(f"{decoder:6s}: {ms:6.1f} ms/batch of {n_imgs} "
              f"({n_imgs / ms * 1e3:.0f} img/s)")


if __name__ == "__main__":
    _bench()
