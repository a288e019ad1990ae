"""The image files the JAX package reads and writes through PIL, in the port:
`utils/image_io.py::encode_jpeg` (C++ in `csrc/host/image_io.cpp`) is PIL's
default `save(format="JPEG")` byte for byte, so `write_synthetic_shard`'s
tar is the JAX package's byte for byte; `decode_jpeg` gives PIL's
`Image.open(...).convert("RGB")` pixels for progressive files (4:4:4, 4:2:2,
4:2:0, grey, CMYK, odd sizes, restart intervals, optimized tables), for CMYK
with and without an Adobe marker and for YCCK; a progressive file cut after
any of its scans equals PIL, libjpeg-turbo's block smoothing included;
arithmetic-coded files (SOF9, SOF10, with restarts and DAC conditioning)
and lossless files (SOF3: predictors 1-7, point transforms, restarts,
interleaved and subsampled) written by `make_fixtures.py`'s encoders equal
PIL's decode; what PIL refuses (arithmetic-coded lossless frames, lossless
YCbCr, fractional sampling, height 0, restarts that are not whole MCU rows)
raises ValueError, and a DNL segment is skipped as PIL skips it;
`train/data.py::decode_png` gives PIL's pixels for every PNG colour type
and bit depth, with PLTE and tRNS, plain and Adam7-interlaced. About 15 s."""

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


def _pil_or_error(data: bytes):
    try:
        return _pil(data)
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


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
    """A progressive file cut after each of its scans equals PIL's decode:
    every cut but the last leaves some of AC coefficients 1-9 unrefined, so
    libjpeg-turbo smooths across blocks (its 5x5 DC neighbourhood; after the
    DC scan alone it interpolates the DC too). Sizes of 1 and 2 blocks and
    uneven last block rows take the narrow-picture and edge paths."""
    for w, h in ((40, 24), (9, 33), (16, 16), (17, 9), (24, 20), (1, 1)):
        for sub in ((0, 2) if mode == "RGB" else (0,)):
            data = _save(Image.fromarray(fixtures.procedural(w, h, 3 + w)).convert(mode), progressive=True,
                         subsampling=sub)
            scans = data.count(b"\xff\xda")
            for n in range(1, scans + 1):
                cut = fixtures.cut_scans(data, n) if n < scans else data
                np.testing.assert_array_equal(image_io.decode_jpeg(cut), _pil(cut), err_msg=f"{w}x{h} cut {n}")


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


ARITH = [{}, {"progressive": True}, {"restart": 3}, {"progressive": True, "restart": 2},
         {"dac": {"L": 1, "U": 3, "K": 2}}, {"progressive": True, "dac": {"L": 0, "U": 0, "K": 63}, "quality": 30},
         {"sampling": ((1, 1), (1, 1), (1, 1)), "quality": 95}, {"sampling": ((2, 1), (1, 1), (1, 1))},
         {"progressive": True, "sampling": ((1, 2), (1, 1), (1, 1)), "restart": 1}]


@pytest.mark.parametrize("opts", ARITH, ids=[f"arith{i}" for i in range(len(ARITH))])
def test_arithmetic_matches_pil(opts):
    """SOF9 / SOF10 from `write_arith_jpeg` (jcarith.c's QM coder): PIL's
    pixels, grey and colour, odd sizes."""
    for w, h in ((1, 1), (17, 9), (40, 24), (33, 65)):
        rgb = fixtures.procedural(w, h, w * h + 1)
        for img in ((rgb, rgb[..., 1]) if "sampling" not in opts else (rgb,)):
            data = fixtures.write_arith_jpeg(img, **opts)
            np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=f"{w}x{h} {img.ndim}")


LOSSLESS = [(p, pt) for p in range(1, 8) for pt in (0, 2)]


@pytest.mark.parametrize("predictor,pt", LOSSLESS, ids=[f"p{p}_pt{pt}" for p, pt in LOSSLESS])
def test_lossless_matches_pil(predictor, pt):
    """SOF3 from `write_lossless_jpeg`: one scan a component and one
    interleaved scan, with and without restarts, grey and RGB."""
    for w, h in ((1, 1), (17, 9), (40, 24)):
        rgb = fixtures.procedural(w, h, w + h + predictor)
        for opts in ({}, {"restart_rows": 2}, {"interleaved": True}, {"interleaved": True, "restart_rows": 1}):
            data = fixtures.write_lossless_jpeg(rgb, predictor, pt, marker="none", **opts)
            np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=f"{w}x{h} {opts}")
        data = fixtures.write_lossless_jpeg(rgb[..., 0], predictor, pt)
        np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=f"{w}x{h} grey")


@pytest.mark.parametrize("interleaved", [False, True], ids=["per_component", "interleaved"])
def test_lossless_subsampled_matches_pil(interleaved):
    """4:2:0 lossless: libjpeg upsamples by box replication (no fancy
    upsampling at DCT size 1)."""
    for w, h in ((2, 2), (18, 10), (40, 24)):
        rgb = fixtures.procedural(w, h, w)
        planes = [rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]]
        for rst in ((0, 1) if interleaved else (0,)):
            data = fixtures.write_lossless_jpeg(planes, 3, 0, marker="none", sampling=[(2, 2), (1, 1), (1, 1)],
                                                interleaved=interleaved, restart_rows=rst)
            np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=f"{w}x{h}")


def _refusals():
    """Files PIL 12.1 refuses, and a DNL segment it skips."""
    rgb = fixtures.procedural(40, 24, 3)
    lossless = fixtures.write_lossless_jpeg(rgb, 1, 0, marker="none")
    dct = _save(Image.fromarray(rgb), subsampling=0)
    sof, sos = dct.index(b"\xff\xc0"), dct.index(b"\xff\xda")
    at = lossless.index(b"\xff\xc3")
    dri = fixtures.write_lossless_jpeg(rgb, 1, 0, marker="none", restart_rows=2)
    i = dri.index(b"\xff\xdd")
    return {
        "arithmetic lossless (SOF11)": lossless[:at + 1] + b"\xcb" + lossless[at + 2:],
        "lossless YCbCr (JFIF)": fixtures.write_lossless_jpeg(rgb, 1, 0, marker="jfif"),
        "lossless YCbCr (Adobe 1)": fixtures.write_lossless_jpeg(rgb, 1, 0, marker="adobe1"),
        "lossless restart of 60 samples": dri[:i + 4] + struct.pack(">H", 60) + dri[i + 6:],
        "fractional sampling": dct[:sof + 11] + b"\x21" + dct[sof + 12:sof + 14] + b"\x31" + dct[sof + 15:],
        "height 0": dct[:sof + 5] + b"\x00\x00" + dct[sof + 7:],
    }, {"DNL before the scan": dct[:sos] + b"\xff\xdc\x00\x04\x00\x18" + dct[sos:],
        "DNL after the scan": dct[:-2] + b"\xff\xdc\x00\x04\x00\x18" + dct[-2:]}, dct


def test_refusals_and_dnl_are_pils():
    """What PIL refuses, the port raises ValueError for ("as PIL refuses
    it"); a DNL segment, which libjpeg skips, changes nothing."""
    refused, dnl, plain = _refusals()
    for what, data in refused.items():
        assert isinstance(_pil_or_error(data), Exception), what
        with pytest.raises(ValueError, match="as PIL refuses it"):
            image_io.decode_jpeg(data)
    for what, data in dnl.items():
        np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data), err_msg=what)
        np.testing.assert_array_equal(image_io.decode_jpeg(data), image_io.decode_jpeg(plain), err_msg=what)


@pytest.mark.parametrize("kind", ["arithmetic", "lossless"])
def test_truncated_and_corrupt_coded_jpeg(kind):
    """Truncated files raise ValueError; flipped bytes raise ValueError or
    decode to the frame's size (libjpeg decodes arithmetic data it cannot
    read as zeros), never crash."""
    rgb = fixtures.procedural(33, 17, 5)
    data = (fixtures.write_arith_jpeg(rgb, progressive=True, restart=2) if kind == "arithmetic"
            else fixtures.write_lossless_jpeg(rgb, 4, 0, marker="none", restart_rows=2))
    for frac in (0.0, 0.1, 0.3, 0.5, 0.8, 0.95):
        with pytest.raises(ValueError):
            image_io.decode_jpeg(data[:int(frac * len(data))])
    rng = np.random.default_rng(1)
    for _ in range(200):
        bad = bytearray(data)
        for p in rng.integers(2, len(bad), 2):
            bad[p] = int(rng.integers(0, 256))
        try:
            out = image_io.decode_jpeg(bytes(bad))
        except ValueError:
            continue
        assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
