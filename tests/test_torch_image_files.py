"""The image files the JAX package reads and writes through PIL, in the port:
`utils/image_io.py::encode_jpeg` (C++ in `csrc/host/image_io.cpp`) is PIL's
default `save(format="JPEG")` byte for byte, so `write_synthetic_shard`'s
tar is the JAX package's byte for byte; `decode_jpeg` gives PIL's
`Image.open(...).convert("RGB")` pixels for progressive files (4:4:4, 4:2:2,
4:2:0, grey, CMYK, odd sizes, restart intervals, optimized tables), for CMYK
with and without an Adobe marker and for YCCK; a progressive file whose
scans stop early equals PIL or, where libjpeg would smooth across blocks,
raises `NotImplementedError`; `train/data.py::decode_png` gives PIL's
pixels for every PNG colour type and bit depth, with PLTE and tRNS, plain
and Adam7-interlaced. About 4 s."""

import importlib.util
import io
import os
import struct

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu.train import data as jdata
from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg",
                                        "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)

SIZES = [(1, 1), (16, 16), (17, 9), (32, 32), (33, 65), (100, 37), (129, 77), (257, 129)]  # (W, H)


def _pil(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _save(img: Image.Image, **opts) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="JPEG", **opts)
    return buf.getvalue()


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_encode_jpeg_is_pil_default_save(size):
    w, h = size
    rng = np.random.default_rng(w * 1000 + h)
    for arr in (fixtures.procedural(w, h, w + h), rng.integers(0, 256, (h, w, 3), dtype=np.uint8),
                np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)):
        assert image_io.encode_jpeg(arr) == _save(Image.fromarray(arr))


@pytest.mark.parametrize("kw", [{}, {"n": 3, "size": 40, "seed": 5}, {"n": 2, "size": 17}],
                         ids=["default", "40px", "17px"])
def test_synthetic_shard_is_jax_bytes(tmp_path, kw):
    jdata.write_synthetic_shard(str(tmp_path / "jax.tar"), **kw)
    tdata.write_synthetic_shard(str(tmp_path / "torch.tar"), **kw)
    assert (tmp_path / "torch.tar").read_bytes() == (tmp_path / "jax.tar").read_bytes()


PROGRESSIVE = {
    "444": {"subsampling": 0}, "422": {"subsampling": 1}, "420": {"subsampling": 2},
    "grey": {"mode": "L"}, "cmyk": {"mode": "CMYK"}, "420_q95": {"quality": 95},
    "rst_blocks3": {"restart_marker_blocks": 3}, "rst_rows1_444": {"restart_marker_rows": 1, "subsampling": 0},
    "optimized": {"optimize": True}, "optimized_444": {"optimize": True, "subsampling": 0},
}


@pytest.mark.parametrize("name", sorted(PROGRESSIVE))
def test_progressive_matches_pil(name):
    opts = dict(PROGRESSIVE[name])
    mode = opts.pop("mode", "RGB")
    for w, h in ((1, 1), (17, 9), (33, 65), (67, 45)):
        data = _save(Image.fromarray(fixtures.procedural(w, h, w * h)).convert(mode), progressive=True, **opts)
        np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=f"{w}x{h}")


@pytest.mark.parametrize("mode", ["RGB", "L"])
def test_cut_scan_scripts_match_pil_or_raise(mode):
    """A progressive file cut after each of its scans: PIL's pixels where no
    coefficient of the first 9 is left unrefined, else NotImplementedError
    (libjpeg's block smoothing, ROADMAP queue 1). libjpeg's own script
    refines coefficient 1 in its last scan, so every cut raises here."""
    data = _save(Image.fromarray(fixtures.procedural(40, 24, 3)).convert(mode), progressive=True)
    scans = data.count(b"\xff\xda")
    for n in range(1, scans + 1):
        cut = fixtures.cut_scans(data, n) if n < scans else data
        if n < scans:
            with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
                image_io.decode_jpeg(cut)
            assert _pil(cut).shape == (24, 40, 3)  # PIL decodes it, smoothing
        else:
            np.testing.assert_array_equal(image_io.decode_jpeg(cut), _pil(cut))


@pytest.mark.parametrize("adobe", [0, 1, 2, 3, None], ids=["cmyk", "t1_ycck", "ycck", "t3_ycck", "no_marker"])
@pytest.mark.parametrize("opts", [{}, {"subsampling": 2}, {"progressive": True},
                                  {"progressive": True, "subsampling": 2}], ids=["seq", "seq_420", "prog", "prog_420"])
def test_cmyk_and_ycck_match_pil(adobe, opts):
    """PIL writes CMYK with an Adobe marker (transform 0); transforms 1-3
    (libjpeg reads anything but 0 as YCCK) and the marker removed (straight
    CMYK) are patched in. PIL reads every CMYK as "CMYK;I" and converts it."""
    for w, h in ((17, 9), (41, 23)):
        data = _save(Image.fromarray(fixtures.procedural(w, h, 7)).convert("CMYK"), **opts)
        if adobe != 0:
            data = fixtures.set_adobe(data, adobe)
        np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=f"{w}x{h}")


PNG_KINDS = [(c, d) for c, depths in ((0, (1, 2, 4, 8, 16)), (2, (8, 16)), (3, (1, 2, 4, 8)), (4, (8, 16)),
                                      (6, (8, 16))) for d in depths]


@pytest.mark.parametrize("color,depth", PNG_KINDS, ids=[f"c{c}_d{d}" for c, d in PNG_KINDS])
def test_png_kinds_match_pil(color, depth):
    """Plain and Adam7 (every pass empty or not: sizes 1x1 to 33x17), with and
    without tRNS where the kind allows it; palette indices past a short PLTE."""
    for i, (interlace, trns) in enumerate(((False, False), (True, False), (False, True), (True, True))):
        if trns and color in (4, 6):
            continue
        for w, h in ((1, 1), (3, 2), (9, 7), (33, 17)):
            seed = 1000 * color + 100 * depth + 10 * i + w
            rng = np.random.default_rng(seed)
            channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
            palette = rng.integers(0, 256, (int(rng.integers(1, min(1 << depth, 256) + 1)), 3)) \
                if color == 3 else None
            samples = rng.integers(0, 1 << depth, (h, w, channels)).astype(np.uint16 if depth == 16 else np.uint8)
            if color == 0 and depth == 16:  # both sides of PIL's clip at 255
                samples[::2] %= 256
            t = None
            if trns:
                t = {0: lambda: struct.pack(">H", int(samples[0, 0, 0])),
                     2: lambda: struct.pack(">HHH", *map(int, samples[0, 0])),
                     3: lambda: bytes(len(palette) * [128])}[color]()
            data = fixtures.write_png(samples, color, depth, palette, t, interlace, seed)
            np.testing.assert_array_equal(tdata.decode_png(data), _pil(data),
                                          err_msg=f"{w}x{h} interlace={interlace} trns={trns}")
