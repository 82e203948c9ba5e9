"""The port's native batch loader (``chainermn_torch.native.dataloader``)
against the JAX package's, on the CPU: both build the same
``dataloader.cc`` with ``g++`` and, from the same records and seed, give
the same batches — images bit for bit, labels, epochs — with prefetch on
and off, over a shard that aliases a small pool (the ImageNet twin's
synthetic data); the numpy path of a failed build gives the C++ path's
numbers to float32 rounding; the library lands in the git-ignored
``build/``, named by the source's hash.
"""

import numpy as np
import pytest

from chainermn_tpu.native import dataloader as ref
from chainermn_torch._build import BUILD_DIR
from chainermn_torch.native import _build
from chainermn_torch.native import dataloader as port


def _records(seed=0, n=40, size=8):
    rng = np.random.RandomState(seed)
    pool = rng.randint(0, 256, (6, size, size, 3), np.uint8)
    rows = rng.randint(0, len(pool), n).astype(np.int64)
    labels = rng.randint(0, 10, n).astype(np.int32)
    return pool, rows, labels


def _batches(mod, prefetch, n_batches=12, **kw):
    pool, rows, labels = _records()
    loader = mod.NativeBatchLoader(pool, labels, 8, rows=rows, seed=3,
                                   prefetch=prefetch, **kw)
    out = []
    for x, y in loader:
        out.append((x, y, loader.epoch, loader.is_new_epoch))
        if len(out) == n_batches:
            break
    return out


@pytest.mark.parametrize("prefetch", [True, False])
def test_batches_match_the_reference(prefetch):
    assert port.native_available() and ref.native_available()
    got, want = _batches(port, prefetch), _batches(ref, prefetch)
    for (gx, gy, ge, gn), (wx, wy, we, wn) in zip(got, want):
        assert gx.dtype == np.float32 and gx.shape == (8, 8, 8, 3)
        np.testing.assert_array_equal(gx, wx)
        np.testing.assert_array_equal(gy, wy)
        assert (ge, gn) == (we, wn)
    assert [e for *_, e, new in got if new] == [1, 2]


def test_numpy_path_matches_the_native_path():
    pool, rows, labels = _records(seed=1)
    loaders = [port.NativeBatchLoader(pool, labels, 8, rows=rows, seed=5,
                                      prefetch=False) for _ in range(2)]
    loaders[1]._native = False
    for (x, y), (xn, yn) in zip(loaders[0], loaders[1]):
        np.testing.assert_allclose(x, xn, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(y, yn)
        break


def test_library_is_built_into_build_named_by_the_source_hash():
    assert port.native_available()
    path = _build.library_path("dataloader.cc", "dataloader")
    assert path.parent == BUILD_DIR and path.exists()
    assert path.name.startswith("_dataloader_py")


def test_constants_and_validation_match_the_reference():
    assert port.IMAGENET_MEAN == ref.IMAGENET_MEAN
    assert port.IMAGENET_STD == ref.IMAGENET_STD
    pool, rows, labels = _records()
    with pytest.raises(ValueError, match="batch_size"):
        port.NativeBatchLoader(pool, labels, 1000, rows=rows)
    with pytest.raises(TypeError, match="uint8"):
        port.NativeBatchLoader(pool.astype(np.float32), labels, 8, rows=rows)
