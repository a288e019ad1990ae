"""The port's Zstandard decoder (`utils/image_io.py::zstd_decompress`, C++ in
`csrc/host/zstd.cpp`) against the `zstandard` module's libzstd, and
ZSTD-compressed TIFFs (50000) against Pillow 12.1 over libtiff 4.7: levels 1
to 22 (raw, RLE and compressed blocks; raw, RLE, Huffman and treeless
literals in one and four streams; every sequence table mode), window logs up
to 27 (28 refused by both), frames with and without checksum and content
size, several frames and skippable frames in one buffer, a frame naming a
dictionary (refused by both), frames cut anywhere or with any byte flipped
(both raise, or both give the same bytes); PIL-written ZSTD TIFFs in every
mode PIL saves and hand-written ones with predictors 2 and 3, tiles, planes
and BigTIFF. About 15 s."""

import io
import os
import struct
import warnings

import numpy as np
import pytest
import torch
from PIL import Image

from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

zstandard = pytest.importorskip("zstandard")
torch.set_num_threads(1)

from test_torch_tiff import RGB, RNG, _check, _decodes, _samples, fx  # noqa: E402

DATA_RNG = np.random.default_rng(26)


def _ref(data: bytes) -> bytes:
    """libzstd's reading of every frame in turn (skippable ones skipped); a
    frame cut short raises."""
    out, rest = b"", data
    while rest:
        d = zstandard.ZstdDecompressor().decompressobj()
        out += d.decompress(rest)
        if not d.eof:
            raise zstandard.ZstdError("incomplete frame")
        rest = d.unused_data
    return out


def _same(data: bytes, what: str = "") -> None:
    """The port gives libzstd's bytes, or both raise."""
    try:
        want = _ref(data)
    except zstandard.ZstdError:
        with pytest.raises(ValueError):
            image_io.zstd_decompress(data)
        return
    assert image_io.zstd_decompress(data) == want, what


def _payloads() -> list:
    """Noise, few symbols, text-like words, a random walk; empty, short and long."""
    n = 70000
    words = [bytes(DATA_RNG.integers(97, 123, int(DATA_RNG.integers(2, 9))).astype(np.uint8)) for _ in range(300)]
    return [b"", b"a", DATA_RNG.integers(0, 256, n).astype(np.uint8).tobytes(),
            (DATA_RNG.integers(0, 6, n) * 7).astype(np.uint8).tobytes(),
            b" ".join(words[int(i)] for i in DATA_RNG.integers(0, 300, n // 5)),
            np.cumsum(DATA_RNG.integers(-3, 4, n)).astype(np.uint8).tobytes(), bytes(300000)]


PAYLOADS = _payloads()


@pytest.mark.parametrize("level", [1, 3, 9, 19, 22, -5])
def test_levels_match_libzstd(level):
    for i, p in enumerate(PAYLOADS):
        for checksum in (False, True):
            c = zstandard.ZstdCompressor(level=level, write_checksum=checksum).compress(p)
            assert image_io.zstd_decompress(c) == p, f"payload {i} checksum={checksum}"


@pytest.mark.parametrize("checksum,content_size", [(False, False), (False, True), (True, False), (True, True)])
def test_checksum_and_content_size(checksum, content_size):
    for p in PAYLOADS:
        c = zstandard.ZstdCompressor(level=3, write_checksum=checksum, write_content_size=content_size).compress(p)
        assert bool(c[4] & 4) == checksum
        assert image_io.zstd_decompress(c) == p


@pytest.mark.parametrize("window_log", [10, 14, 17, 20, 24, 27, 28])
def test_window_logs(window_log):
    """A streamed frame keeps its window descriptor; past 2^27 + 1 bytes
    libzstd refuses the frame by default, and so does the port."""
    params = zstandard.ZstdCompressionParameters.from_level(3, window_log=window_log)
    obj = zstandard.ZstdCompressor(compression_params=params).compressobj()
    c = obj.compress(PAYLOADS[4]) + obj.flush()
    assert (c[5] >> 3) + 10 == window_log  # no single segment: the window descriptor byte
    _same(c, str(window_log))
    if window_log > 27:
        with pytest.raises(ValueError, match="window"):
            image_io.zstd_decompress(c)


def test_several_frames_and_skippable_frames():
    a = zstandard.ZstdCompressor(level=1).compress(PAYLOADS[4][:5000])
    b = zstandard.ZstdCompressor(level=19, write_checksum=True).compress(PAYLOADS[3][:7000])
    skip = struct.pack("<II", 0x184D2A53, 5) + b"hello"
    for data in (a + b, skip + a, a + skip + b + skip, skip, a + a + a, a + struct.pack("<II", 0x184D2A50, 0)):
        _same(data)
        assert image_io.zstd_decompress(data) == _ref(data)
    for data in (a + b[:-1], a + skip[:-1], a + b"\x28\xb5", skip[:6]):
        with pytest.raises(ValueError):
            image_io.zstd_decompress(data)


def test_dictionary_frame_refused():
    """A frame whose header names a dictionary: libzstd without it refuses
    the frame, and so does the port."""
    samples = [bytes(PAYLOADS[4][i:i + 500]) for i in range(0, 60000, 500)]
    d = zstandard.train_dictionary(2048, samples)
    c = zstandard.ZstdCompressor(dict_data=d).compress(PAYLOADS[4][:3000])
    assert c[4] & 3  # a dictionary ID in the header
    with pytest.raises(zstandard.ZstdError):
        _ref(c)
    with pytest.raises(ValueError, match="dictionary"):
        image_io.zstd_decompress(c)


@pytest.mark.parametrize("kind", ["words_l1", "walk_l19_checksum", "few_l3_multi"])
def test_cut_and_flipped_frames(kind):
    """Every cut, and every byte set to 0, 0xFF or with its low or high bit
    flipped: both raise, or both give the same bytes."""
    if kind == "words_l1":
        c = zstandard.ZstdCompressor(level=1).compress(PAYLOADS[4][:2500])
    elif kind == "walk_l19_checksum":
        c = zstandard.ZstdCompressor(level=19, write_checksum=True, write_content_size=False).compress(
            PAYLOADS[5][:2000])
    else:
        a = zstandard.ZstdCompressor(level=3).compress(PAYLOADS[3][:1500])
        c = a + struct.pack("<II", 0x184D2A51, 2) + b"xy" + a
    for cut in range(len(c)):
        _same(c[:cut], f"cut at {cut}")
    for k in range(len(c)):
        for v in {0, 0xFF, c[k] ^ 1, c[k] ^ 0x80}:
            bad = bytearray(c)
            bad[k] = v
            _same(bytes(bad), f"byte {k} = {v}")


def test_random_damage_matches_libzstd():
    """Large frames (four-stream literals on libzstd's fast loops, long
    matches, repeat offsets) with one to five random bytes changed."""
    rng = np.random.default_rng(27)
    for i, p in enumerate(PAYLOADS[2:6]):
        c = zstandard.ZstdCompressor(level=(1, 9, 19, 3)[i], write_checksum=bool(i & 1)).compress(p[:40000])
        for _ in range(40):
            bad = bytearray(c)
            for at in rng.integers(0, len(c), int(rng.integers(1, 6))):
                bad[int(at)] = int(rng.integers(0, 256))
            _same(bytes(bad))


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "RGBA", "CMYK", "I;16", "I", "F", "LA", "PA", "I;16B", "1"])
def test_pil_written_zstd_tiffs_match_pil(mode):
    if mode in ("I;16", "I;16B"):
        img = Image.frombytes(mode, (37, 23), RNG.integers(0, 600, (23, 37)).astype(
            "<u2" if mode == "I;16" else ">u2").tobytes())
    elif mode == "PA":
        img = Image.fromarray(RGB).convert("P").convert("PA")
    else:
        img = Image.fromarray(RGB).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="TIFF", compression="tiff_zstd")
    got = _decodes(buf.getvalue(), mode)
    np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), got)


def test_hand_written_zstd_tiffs_match_pil():
    """Predictors 2 (8, 16 and 32 bits) and 3, both byte orders, tiles,
    planes, BigTIFF, strips of several frames' worth, a frame longer than
    its strip, and strips cut or made of another frame."""
    for order in "<>":
        for bits, photo, s in ((8, 2, 3), (16, 1, 1), (32, 1, 1)):
            a = _samples(bits, 1, 23, 37, s)
            _check(fx.write_tiff(a, photo, bits=bits, compression=50000, predictor=2, order=order, rows_per_strip=6),
                   f"{order} pred 2 {bits}")
        f = _samples(32, 3, 23, 37, 1)
        _check(fx.write_tiff(f, 1, bits=32, sample_format=3, compression=50000, predictor=3, order=order), "pred 3")
    _decodes(fx.write_tiff(_samples(16, 1, 23, 37, 3), 2, bits=16, compression=50000, predictor=2), "pred 2 RGB 16")
    _decodes(fx.write_tiff(RGB, 2, compression=50000, tile=(16, 16)), "tiles")
    _decodes(fx.write_tiff(RGB, 2, compression=50000, planar=2, rows_per_strip=5), "planes")
    _decodes(fx.write_tiff(RGB, 2, compression=50000, bigtiff=True, tile=(32, 16)), "bigtiff")
    _decodes(fx.write_tiff(RGB, 6, compression=50000, subsampling=(2, 2), rows_per_strip=8), "ycbcr 2x2")
    for level in (1, 19):
        _decodes(fx.write_tiff(RGB, 2, compression=50000, zstd_level=level, rows_per_strip=3), f"level {level}")
    _decodes(fx.write_tiff(RGB, 2, compression=50000), "one strip")
    longer = fx.write_tiff(RGB[:, :36], 2, compression=50000, tags={256: (3, [30])})  # more data than the strip
    _check(longer, "frame longer than the strip")
    shorter = fx.write_tiff(RGB[:20], 2, compression=50000, tags={257: (3, [23])})
    _check(shorter, "frame shorter than the strip")


def test_zstd_tiff_cut_and_flipped():
    data = fx.write_tiff(RNG.integers(0, 256, (5, 7, 3)), 2, compression=50000, predictor=2, rows_per_strip=3)
    for cut in range(len(data)):
        _check(data[:cut], f"cut at {cut}")
    for k in range(len(data)):
        for v in (0, 0xFF):
            bad = bytearray(data)
            bad[k] = v
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                _check(bytes(bad), f"byte {k} = {v}")


def test_zstd_decompress_counts_its_calls():
    before = image_io.calls["zstd_decompress"]
    image_io.zstd_decompress(zstandard.ZstdCompressor().compress(b"x" * 100))
    assert image_io.calls["zstd_decompress"] == before + 1
    assert os.path.basename(image_io.ZSTD_SOURCE) in {os.path.basename(s) for s in image_io.SOURCES}
