"""The port's native tar indexer (`utils/native.py`, built from
`native/genref_loader.cpp` with g++ into `.build/host/`) against Python's
`tarfile` and the JAX package's binding: USTAR, PAX and GNU shards with long
names, odd member sizes and directories. An undersized member cap makes
`tar_index` return None, and `iter_tar_samples` then reads the shard with
`tarfile` and counts the fallback. A failed host build raises. Counterpart of
tests/test_native_loader.py. About 3 s."""

import io
import tarfile

import numpy as np
import pytest

from reflectionflow_tpu.utils import native as jnative
from reflectionflow_tpu_torch.search.artifacts import encode_png
from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import native


@pytest.fixture(scope="module", autouse=True)
def lib():
    return native.get_lib()


def _write_tar(path, fmt, members):
    with tarfile.open(path, "w", format=fmt) as tf:
        for name, data in members:
            info = tarfile.TarInfo(name)
            if data is None:
                info.type = tarfile.DIRTYPE
                tf.addfile(info)
            else:
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


def _python_index(path):
    with tarfile.open(path) as tf:
        return {m.name: tf.extractfile(m).read() for m in tf if m.isfile()}


@pytest.mark.parametrize("fmt", [tarfile.USTAR_FORMAT, tarfile.PAX_FORMAT, tarfile.GNU_FORMAT],
                         ids=["ustar", "pax", "gnu"])
def test_index_matches_tarfile_and_jax(tmp_path, fmt):
    rng = np.random.default_rng(0)
    long_name = "nested/" + "x" * (80 if fmt == tarfile.USTAR_FORMAT else 140) + ".reflection.txt"
    members = [
        ("00000.prompt.txt", b"a red cube"),
        ("00000.good_image.jpg", rng.integers(0, 256, 1234, dtype=np.uint8).tobytes()),
        ("00000.bad_image.jpg", rng.integers(0, 256, 511, dtype=np.uint8).tobytes()),
        ("nested/dir", None),
        (long_name, b"make it redder"),
        ("00001.subset.txt", b"general"),
        ("empty.txt", b""),
    ]
    path = str(tmp_path / "shard.tar")
    _write_tar(path, fmt, members)
    names, offsets, sizes = native.tar_index(path)
    assert dict(zip(names, native.tar_read_batch(path, offsets, sizes))) == _python_index(path)
    j_names, j_offsets, j_sizes = jnative.tar_index(path)
    assert names == j_names
    np.testing.assert_array_equal(offsets, j_offsets)
    np.testing.assert_array_equal(sizes, j_sizes)


def test_capacity_returns_none_and_missing_file_raises(tmp_path):
    path = str(tmp_path / "tiny.tar")
    _write_tar(path, tarfile.USTAR_FORMAT, [(f"{i}.txt", b"x" * i) for i in range(8)])
    assert native.tar_index(path, max_members=2) is None
    names, offsets, sizes = native.tar_index(path, max_members=8)
    assert len(names) == 8
    assert [len(b) for b in native.tar_read_batch(path, offsets, sizes)] == list(range(8))
    assert native.tar_read_batch(path, offsets[:0], sizes[:0]) == []
    with pytest.raises(OSError):
        native.tar_index(str(tmp_path / "missing.tar"), max_members=8)


def test_iter_tar_samples_falls_back_to_tarfile_and_counts(tmp_path, monkeypatch):
    path = str(tmp_path / "genref.tar")
    tdata.write_synthetic_shard(path, n=4, size=8)
    native_samples = list(tdata.iter_tar_samples(path))
    before = native.fallbacks
    full = native.tar_index
    monkeypatch.setattr(native, "tar_index", lambda p: full(p, max_members=2))
    fallback_samples = list(tdata.iter_tar_samples(path))
    assert native.fallbacks == before + 1
    assert len(native_samples) == len(fallback_samples) == 4
    for a, b in zip(native_samples, fallback_samples):
        np.testing.assert_array_equal(a.good, b.good)
        np.testing.assert_array_equal(a.bad, b.bad)
        assert (a.prompt, a.reflection, a.subset) == (b.prompt, b.reflection, b.subset)


def test_corrupt_sample_is_skipped_and_unsupported_raises(tmp_path):
    """A sample whose image does not decode is skipped, as in the JAX
    package; an arithmetic-coded JPEG (a baseline file with its SOF0 marker
    made SOF9), which the port once refused, now decodes to PIL's pixels;
    a GIF, a TIFF and an ICO, which the port once refused, now decode to
    PIL's pixels too; a format the port does not read yet (AVIF) raises
    ValueError naming it, so its sample is skipped."""
    path = str(tmp_path / "mixed.tar")
    png = encode_png(np.zeros((4, 4, 3), np.uint8))
    bad_jpeg = b"\xff\xd8\xff\xdb\x00\x03"  # a DQT segment cut short
    _write_tar(path, tarfile.PAX_FORMAT, [
        ("000000.good_image.jpg", bad_jpeg), ("000000.bad_image.png", png),
        ("000001.good_image.png", png), ("000001.bad_image.png", png), ("000001.prompt.txt", b"p"),
    ])
    assert [s.prompt for s in tdata.iter_tar_samples(path)] == ["p"]
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="JPEG")
    arith = buf.getvalue().replace(b"\xff\xc0", b"\xff\xc9", 1)
    _write_tar(path, tarfile.PAX_FORMAT, [("000000.good_image.jpg", arith),
                                          ("000000.bad_image.png", png)])
    (sample,) = tdata.iter_tar_samples(path)
    np.testing.assert_array_equal(sample.good, np.asarray(Image.open(io.BytesIO(arith)).convert("RGB")))
    buf = io.BytesIO()
    Image.fromarray(np.arange(192, dtype=np.uint8).reshape(8, 8, 3)).save(buf, format="GIF")
    _write_tar(path, tarfile.PAX_FORMAT, [("000000.good_image.jpg", buf.getvalue()),
                                          ("000000.bad_image.png", png)])
    (sample,) = tdata.iter_tar_samples(path)
    np.testing.assert_array_equal(sample.good, np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    buf = io.BytesIO()
    Image.fromarray(np.arange(192, dtype=np.uint8).reshape(8, 8, 3)).save(buf, format="TIFF", compression="tiff_lzw")
    _write_tar(path, tarfile.PAX_FORMAT, [("000000.good_image.jpg", buf.getvalue()),
                                          ("000000.bad_image.png", png)])
    (sample,) = tdata.iter_tar_samples(path)
    np.testing.assert_array_equal(sample.good, np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    buf = io.BytesIO()
    Image.fromarray(np.arange(192, dtype=np.uint8).reshape(8, 8, 3)).save(buf, format="ICO", sizes=[(8, 8)])
    np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()),
                                  np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB")))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(buf, format="AVIF")
    with pytest.raises(ValueError, match="AVIF images are not read by the port yet"):
        tdata.decode_image(buf.getvalue())
    _write_tar(path, tarfile.PAX_FORMAT, [("000000.good_image.jpg", buf.getvalue()),
                                          ("000000.bad_image.png", png)])
    assert list(tdata.iter_tar_samples(path)) == []


def test_host_build_raises_without_compiler_or_on_error(tmp_path, monkeypatch):
    """The g++ route never falls back: no compiler, or a source that does not
    compile, raises."""
    from reflectionflow_tpu_torch.ops import kernel_build

    monkeypatch.setattr(kernel_build, "HOST_BUILD_ROOT", tmp_path / "build")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setenv("CXX", str(tmp_path / "no_such_compiler"))
    with pytest.raises(RuntimeError, match="no C\\+\\+ compiler"):
        kernel_build.build_host_all([bad])
    monkeypatch.delenv("CXX")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed for"):
        kernel_build.build_host_all([bad])
    assert not kernel_build.host_library_path(bad).exists()
