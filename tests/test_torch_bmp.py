"""The port's BMP decoder (`utils/image_io.py::decode_bmp`, C++ in
`csrc/host/bmp.cpp`) against Pillow 12.1's BmpImagePlugin and
`convert("RGB")`, bit for bit, on files written by `make_fixtures.write_bmp`
(Pillow writes only raw 1 / L / P / RGB): every header (core, INFO, V2-V5,
OS/2 v2), 1/4/8-bit palettes (full, short, Pillow's grey ramps), 16 bits
(5-5-5, 5-6-5), 24 and 32 bits, each BITFIELDS layout, bottom-up and
top-down rows, RLE8 and RLE4 (including runs past the row, absolute runs
that wrap, rows without end-of-line and Pillow's delta). Where Pillow
refuses a file the port raises ValueError too. Truncated files raise
ValueError; flipped bytes raise ValueError or decode, never crash. About
3 s."""

import importlib.util
import io
import os

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg",
                                        "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)

SIZES = [(1, 1), (3, 2), (17, 9), (33, 17)]  # (W, H)
HEADERS = [12, 40, 52, 56, 64, 108, 124]


def _pil(data: bytes):
    try:
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _check(data: bytes, what: str):
    """The port's decode equals PIL's, or both raise."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            image_io.decode_bmp(data)
        return
    np.testing.assert_array_equal(image_io.decode_bmp(data), want, err_msg=what)
    np.testing.assert_array_equal(tdata.decode_image(data), want, err_msg=what)


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("header", HEADERS)
def test_palette_bmp_matches_pil(header, bits):
    """Full and short palettes (indices past a short palette are black), the
    header's colour count, Pillow's grey ramps, bottom-up and top-down."""
    rng = np.random.default_rng(header * 10 + bits)
    for w, h in SIZES:
        for ncol in sorted({1 << bits, max(1, (1 << bits) - 3)}):
            pal = rng.integers(0, 256, (ncol, 3))
            idx = rng.integers(0, 1 << bits, (h, w))
            for top_down in ((False, True) if header != 12 else (False,)):
                _check(fixtures.write_bmp(idx, bits, header, palette=pal, colors=0 if ncol == 1 << bits else ncol,
                                          top_down=top_down), f"{w}x{h} {ncol} colours top_down={top_down}")
        n = 1 << bits
        ramp = np.array([[0, 0, 0], [255, 255, 255]]) if n == 2 else np.repeat(np.arange(n)[:, None], 3, 1)
        _check(fixtures.write_bmp(rng.integers(0, n, (h, w)), bits, header, palette=ramp), f"{w}x{h} grey")


@pytest.mark.parametrize("bits", [16, 24, 32])
@pytest.mark.parametrize("header", HEADERS)
def test_rgb_bmp_matches_pil(header, bits):
    rng = np.random.default_rng(header + bits)
    for w, h in SIZES:
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        for top_down in ((False, True) if header != 12 else (False,)):
            _check(fixtures.write_bmp(rgb, bits, header, top_down=top_down), f"{w}x{h} top_down={top_down}")


MASKS = [(16, (0xF800, 0x7E0, 0x1F)), (16, (0x7C00, 0x3E0, 0x1F)), (16, (0x7E0, 0xF800, 0x1F)),
         (24, (0xFF0000, 0xFF00, 0xFF)), (24, (0xFF, 0xFF00, 0xFF0000)),
         (32, (0xFF0000, 0xFF00, 0xFF, 0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0)),
         (32, (0xFF000000, 0xFF00, 0xFF, 0)), (32, (0xFF000000, 0xFF0000, 0xFF00, 0xFF)),
         (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)), (32, (0xFF0000, 0xFF00, 0xFF, 0xFF000000)),
         (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)), (32, (0, 0, 0, 0)), (32, (0xFF, 0xFF00, 0xFF0000, 0))]


@pytest.mark.parametrize("bits,masks", MASKS, ids=[f"b{b}_" + "_".join(f"{m:x}" for m in ms) for b, ms in MASKS])
def test_bitfields_bmp_matches_pil(bits, masks):
    """The layouts Pillow accepts decode as it reads them; the others are
    refused as Pillow refuses them."""
    rng = np.random.default_rng(bits)
    for header in (40, 52, 56, 108, 124):
        rgb = rng.integers(0, 256, (9, 17, 3), dtype=np.uint8)
        _check(fixtures.write_bmp(rgb, bits, header, "bitfields", masks=masks), f"header {header}")


@pytest.mark.parametrize("top_down", [False, True], ids=["bottom_up", "top_down"])
@pytest.mark.parametrize("wild", [False, True], ids=["plain", "wild"])
@pytest.mark.parametrize("compression,bits", [("rle8", 8), ("rle4", 4)])
def test_rle_bmp_matches_pil(compression, bits, wild, top_down):
    rng = np.random.default_rng(bits + 2 * wild + 4 * top_down)
    for w, h in SIZES:
        for k in range(6):
            pal = np.repeat(np.arange(1 << bits)[:, None], 3, 1) if k == 5 else rng.integers(0, 256, (1 << bits, 3))
            idx = rng.integers(0, 1 << bits, (h, w)) if k % 2 else np.repeat(rng.integers(0, 1 << bits, (h, 1)), w, 1)
            _check(fixtures.write_bmp(idx, bits, 40, compression, palette=pal, rng=np.random.default_rng(k + w),
                                      wild=wild, top_down=top_down), f"{w}x{h} case {k}")


def _patched(data: bytes, at: int, value: bytes) -> bytes:
    return data[:at] + value + data[at + len(value):]


def test_refused_as_pil_refuses():
    """Pillow refuses these; the port raises ValueError "as PIL refuses it"."""
    base = fixtures.write_bmp(np.zeros((4, 5, 3), np.uint8), 24)
    pal = fixtures.write_bmp(np.zeros((4, 5), np.uint8), 8, palette=np.zeros((256, 3)))
    cases = {"bits 2": _patched(base, 28, b"\x02\x00"), "JPEG compression": _patched(base, 30, b"\x04\x00"),
             "PNG compression": _patched(base, 30, b"\x05\x00"), "header of 20 bytes": _patched(base, 14, b"\x14"),
             "300 colours": _patched(pal, 46, (300).to_bytes(4, "little"))}
    for what, data in cases.items():
        assert isinstance(_pil(data), Exception), what
        with pytest.raises(ValueError, match="as PIL refuses it"):
            image_io.decode_bmp(data)


def test_truncated_bmp_raises():
    for data in (fixtures.write_bmp(np.zeros((9, 17, 3), np.uint8) + 7, 24),
                 fixtures.write_bmp(np.arange(153).reshape(9, 17) % 16, 4, palette=np.zeros((16, 3)))):
        for frac in (0.0, 0.1, 0.3, 0.5, 0.9):
            with pytest.raises(ValueError):
                image_io.decode_bmp(data[:int(frac * len(data))])
        for cut in range(len(data) - 8, len(data)):  # the last row's padding is not needed, as in PIL
            _check(data[:cut], f"cut at {cut}")


def test_corrupt_bmp_never_crashes():
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 256, (9, 17))
    for data in (fixtures.write_bmp(idx, 8, 40, "rle8", palette=rng.integers(0, 256, (256, 3)), rng=rng),
                 fixtures.write_bmp(rng.integers(0, 256, (9, 17, 3), dtype=np.uint8), 32, 124, "bitfields",
                                    masks=(0xFF, 0xFF00, 0xFF0000, 0xFF000000))):
        for _ in range(200):
            bad = bytearray(data)
            for p in rng.integers(0, len(bad), 2):
                bad[p] = int(rng.integers(0, 256))
            try:
                out = image_io.decode_bmp(bytes(bad))
            except ValueError:
                continue
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
