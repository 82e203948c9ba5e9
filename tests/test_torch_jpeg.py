"""The port's JPEG input pipeline (``chainermn_torch.native.jpeg``): the
twins of ``tests/native_tests/test_jpeg.py``, plus parity with the JAX
package's module on the same bytes, and the ImageNet trainer twin's
``--train-dir`` run.

The JPEG bytes are written by PIL from seeded numpy arrays. Both
packages build their own copy of ``jpeg_loader.cc`` with ``g++
-ljpeg``; on the same bytes the two must give *equal* arrays, through
the C++ decoder and through the PIL path alike.
"""

import io
import os

import numpy as np
import pytest

from chainermn_torch.native import jpeg

PIL = pytest.importorskip("PIL.Image")


def _save_jpeg(arr_u8, path=None, quality=95):
    img = PIL.fromarray(arr_u8)
    buf = io.BytesIO()
    img.save(buf, "JPEG", quality=quality)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as f:
            f.write(data)
    return data


def _rand_img(rs, h, w):
    # smooth content: JPEG quantization error on pure noise is huge;
    # low-frequency images keep decode differences in the last bit or two
    base = rs.rand(h // 8 + 1, w // 8 + 1, 3)
    img = np.kron(base, np.ones((8, 8, 1)))[:h, :w]
    return (img * 255).astype(np.uint8)


def test_native_decoder_builds_here():
    """``g++``, ``jpeglib.h`` and ``libjpeg`` are part of the test
    toolchain: the C++ decoder must build, so the parity tests below run
    it (they would otherwise pass on the PIL path alone)."""
    assert jpeg.native_available(), jpeg._lib_error
    assert jpeg.resolve_decoder() == "native"
    assert jpeg.resolve_decoder("pil") == "pil"
    with pytest.raises(ValueError):
        jpeg.resolve_decoder("turbo")


def test_decode_parity_native_vs_pil():
    """Same bytes, target size == stored size (no resample): the native
    libjpeg decode matches PIL's (also libjpeg) up to IDCT rounding."""
    rs = np.random.RandomState(0)
    size = 64
    blobs = [_save_jpeg(_rand_img(rs, size, size)) for _ in range(4)]
    got, nfail = jpeg.decode_jpeg_batch(blobs, size, decoder="native")
    ref, nfail_ref = jpeg.decode_jpeg_batch(blobs, size, force_fallback=True)
    assert nfail == nfail_ref == 0
    assert got.shape == ref.shape == (4, size, size, 3)
    # tolerance in NORMALIZED units: 2/255 pixel disagreement x 1/std(~4.4)
    assert float(np.abs(got - ref).max()) < 2.5 / 255.0 / 0.224, (
        np.abs(got - ref).max())


def test_resize_matches_native():
    """2x-size source: both paths DCT-prescale then bilinear-resize with
    the same half-pixel formula — parity pins the numpy mirror to the
    C++ implementation."""
    rs = np.random.RandomState(1)
    blobs = [_save_jpeg(_rand_img(rs, 128, 128))]
    got, _ = jpeg.decode_jpeg_batch(blobs, 64, decoder="native")
    ref, _ = jpeg.decode_jpeg_batch(blobs, 64, decoder="pil")
    assert float(np.abs(got - ref).mean()) < 0.05, np.abs(got - ref).mean()


def test_non_square_and_grayscale():
    rs = np.random.RandomState(2)
    rect = _save_jpeg(_rand_img(rs, 96, 48))
    gray_img = PIL.fromarray(_rand_img(rs, 64, 64)[..., 0], mode="L")
    buf = io.BytesIO()
    gray_img.save(buf, "JPEG")
    for decoder in jpeg.DECODERS:
        out, nfail = jpeg.decode_jpeg_batch([rect, buf.getvalue()], 32,
                                            decoder=decoder)
        assert out.shape == (2, 32, 32, 3) and nfail == 0
        assert np.isfinite(out).all()


def test_corrupt_file_is_zeroed_not_fatal():
    rs = np.random.RandomState(3)
    good = _save_jpeg(_rand_img(rs, 32, 32))
    for decoder in jpeg.DECODERS:
        out, nfail = jpeg.decode_jpeg_batch(
            [good, b"not a jpeg at all", good[:40]], 32, decoder=decoder)
        assert nfail == 2
        assert np.abs(out[0]).max() > 0
        np.testing.assert_array_equal(out[1], 0.0)
        np.testing.assert_array_equal(out[2], 0.0)


def test_decoded_counts_each_path():
    rs = np.random.RandomState(5)
    blobs = [_save_jpeg(_rand_img(rs, 16, 16)) for _ in range(3)]
    before = dict(jpeg.DECODED)
    jpeg.decode_jpeg_batch(blobs, 16, decoder="native")
    jpeg.decode_jpeg_batch(blobs[:1], 16, decoder="pil")
    assert jpeg.DECODED["native"] - before["native"] == 3
    assert jpeg.DECODED["pil"] - before["pil"] == 1


@pytest.mark.parametrize("decoder", ["native", "pil"])
@pytest.mark.parametrize("src,tgt", [(64, 64), (128, 64), (96, 40)])
def test_equal_to_the_jax_package_on_the_same_bytes(decoder, src, tgt):
    from chainermn_tpu.native import jpeg as ref_jpeg

    rs = np.random.RandomState(src + tgt)
    blobs = [_save_jpeg(_rand_img(rs, src, src + 8), quality=90)
             for _ in range(3)] + [b"broken"]
    if decoder == "native":
        assert ref_jpeg.native_available()
    want, want_fail = ref_jpeg.decode_jpeg_batch(
        blobs, tgt, force_fallback=decoder == "pil")
    got, got_fail = jpeg.decode_jpeg_batch(blobs, tgt, decoder=decoder)
    assert got_fail == want_fail == 1
    np.testing.assert_array_equal(got, want)


@pytest.fixture()
def jpeg_tree(tmp_path):
    rs = np.random.RandomState(4)
    for cname in ("cat", "dog"):
        d = tmp_path / cname
        d.mkdir()
        for i in range(6):
            _save_jpeg(_rand_img(rs, 48, 48), str(d / f"{i}.jpg"))
    return str(tmp_path)


def test_directory_loader(jpeg_tree):
    it = jpeg.JpegDirectoryLoader(jpeg_tree, 4, image_size=32, seed=0,
                                  repeat=False)
    assert it.class_names == ["cat", "dog"]
    assert it.decoder == "native"
    assert len(it) == 3  # 12 files / batch 4
    batches = list(it)
    assert len(batches) == 3 and it.epoch == 1
    for x, y in batches:
        assert x.shape == (4, 32, 32, 3) and x.dtype == np.float32
        assert set(np.asarray(y)) <= {0, 1}
    assert it.failed_decodes == 0
    all_y = np.concatenate([y for _, y in batches])
    assert set(all_y) == {0, 1}


def test_directory_loader_shards_disjoint(jpeg_tree):
    a = jpeg.JpegDirectoryLoader(jpeg_tree, 2, image_size=16, rank=0, size=2)
    b = jpeg.JpegDirectoryLoader(jpeg_tree, 2, image_size=16, rank=1, size=2)
    assert not (set(a._paths) & set(b._paths))
    assert len(a._paths) + len(b._paths) == 12


def test_directory_loader_rejects_empty(tmp_path):
    with pytest.raises(ValueError, match="class subdirectories"):
        jpeg.scan_image_directory(str(tmp_path))
    (tmp_path / "empty_class").mkdir()
    with pytest.raises(ValueError, match="JPEG files"):
        jpeg.scan_image_directory(str(tmp_path))


def test_producer_failure_reaches_consumer(jpeg_tree):
    it = jpeg.JpegDirectoryLoader(jpeg_tree, 4, image_size=16, repeat=False)
    for p in it._paths:
        os.remove(p)
    with pytest.raises(RuntimeError, match="producer failed"):
        for _ in it:
            pass


@pytest.mark.parametrize("rank,size", [(0, 1), (0, 2), (1, 2)])
@pytest.mark.parametrize("decoder", ["native", "pil"])
def test_loader_yields_the_jax_packages_batches(jpeg_tree, rank, size,
                                                decoder):
    """Same tree, seed, rank and size: the same batches and labels, in
    the same order, over two epochs."""
    from chainermn_tpu.native import jpeg as ref_jpeg

    kw = dict(image_size=24, seed=3, rank=rank, size=size)
    ref = ref_jpeg.JpegDirectoryLoader(jpeg_tree, 2, **kw)
    port = jpeg.JpegDirectoryLoader(jpeg_tree, 2, decoder=decoder, **kw)
    assert port.class_names == ref.class_names
    assert port._paths == ref._paths
    n = 2 * len(ref)
    got = [b for _, b in zip(range(n), port)]
    if decoder == "pil":
        want = [b for _, b in zip(range(n), _ref_pil_batches(ref))]
    else:
        want = [b for _, b in zip(range(n), ref)]
    assert len(got) == len(want) == n
    for (gx, gy), (wx, wy) in zip(got, want):
        np.testing.assert_array_equal(gy, wy)
        np.testing.assert_array_equal(gx, wx)


def _ref_pil_batches(ref):
    """The reference loader's batch order, decoded through its PIL path
    (its loader takes the C++ decoder whenever it builds)."""
    from chainermn_tpu.native import jpeg as ref_jpeg

    for sel, _last in ref._index_batches():
        blobs = []
        for j in sel:
            with open(ref._paths[j], "rb") as f:
                blobs.append(f.read())
        imgs, _ = ref_jpeg.decode_jpeg_batch(blobs, ref._size,
                                             force_fallback=True)
        yield imgs, ref._labels[sel]


def test_train_imagenet_from_a_jpeg_directory(tmp_path, capsys):
    """The reference's ``test_train_imagenet_jpeg_directory``
    (``tests/examples_tests/test_examples.py``) on the twin, in process
    on the CPU: resnet18, batch 2, 2 iterations, 32², 2 classes x 8
    seeded 48x48 JPEGs."""
    from chainermn_torch.examples.imagenet import train_imagenet

    rs = np.random.RandomState(0)
    for cname in ("class_a", "class_b"):
        d = tmp_path / cname
        d.mkdir()
        for i in range(8):
            arr = (np.kron(rs.rand(6, 6, 3), np.ones((8, 8, 1)))[:48, :48]
                   * 255).astype(np.uint8)
            PIL.fromarray(arr).save(str(d / f"{i}.jpg"), "JPEG")
    summary = train_imagenet.main(
        ["--arch", "resnet18", "--batchsize", "2", "--iterations", "2",
         "--image-size", "32", "--train-dir", str(tmp_path),
         "--device", "cpu"])
    out = capsys.readouterr().out
    assert "input pipeline: JPEG directory" in out
    assert "done: 2 iterations" in out
    assert summary["jpeg_decoder"] == "native"
    assert summary["classes"] == 2 and summary["failed_decodes"] == 0
    assert summary["losses_finite"] and len(summary["losses"]) == 2
    with pytest.raises(SystemExit, match="exclusive"):
        train_imagenet.main(["--train-dir", str(tmp_path), "--train-npz",
                             "x.npz", "--device", "cpu"])
