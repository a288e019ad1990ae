"""The port's TIFF decoder (`utils/image_io.py::decode_tiff`, C++ in
`csrc/host/tiff.cpp`) against Pillow 12.1's TiffImagePlugin over libtiff 4.7
and `convert("RGB")`, bit for bit, on files PIL writes (every mode it saves,
every compression it writes) and on files written by
`make_fixtures.write_tiff` (PIL writes neither tiles, planes, BigTIFF, FillOrder
2, predictors, YCbCr JPEG with JPEGTables nor Group 3 2D): every OPEN_INFO key,
ragged tiles, planar data, both byte orders, every Orientation, YCbCr through
libjpeg and through TIFFRGBAImage, associated alpha, 16-bit colour maps,
predictors 2 and 3, old-style LZW, CCITT RLE / Group 3 / Group 4, the data cut
or flipped anywhere. Where PIL raises the port raises ValueError. ZSTD is
held to PIL in `test_torch_zstd.py`; CCITT RLEW, ThunderScan and old-style
JPEG in `test_torch_tiff_codecs.py`. About 20 s."""

import importlib.util
import io
import os
import struct
import warnings

import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg",
                                        "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

RNG = np.random.default_rng(24)
RGB = RNG.integers(0, 256, (23, 37, 3)).astype(np.uint8)
SMOOTH = fx.procedural(37, 23, 24)
PIL_COMPRESSIONS = ["raw", "packbits", "tiff_lzw", "tiff_adobe_deflate", "tiff_deflate", "jpeg", "lzma"]
CODECS = [1, 32773, 5, 8, 34925]  # none, PackBits, LZW, Deflate, LZMA


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _check(data: bytes, what: str = ""):
    """The port's decode equals PIL's, or both raise."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            image_io.decode_tiff(data)
        return want
    got = image_io.decode_tiff(data)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)
    return got


def _decodes(data: bytes, what: str = "") -> np.ndarray:
    """As _check, and PIL must open the file."""
    got = _check(data, what)
    assert isinstance(got, np.ndarray), f"{what}: PIL raises {got!r}"
    return got


def _samples(bits: int, fmt: int, h: int, w: int, s: int) -> np.ndarray:
    if fmt == 3:
        v = RNG.uniform(-40, 300, (h, w, s)).astype(np.float32)
        v[0, :3, 0] = [np.inf, -np.inf, 254.9]
        return v
    if fmt == 2:
        lo, hi = -(1 << (bits - 1)), 1 << (bits - 1)
        return RNG.integers(max(lo, -400), min(hi, 400), (h, w, s)).astype(np.int64)
    top = 1 << bits
    v = RNG.integers(0, top, (h, w, s)).astype(np.int64)
    if bits > 8:  # values near 0..255 too, which convert("RGB") keeps
        v[: h // 2] = RNG.integers(0, 300, (h // 2, w, s))
    return v


def _open_info_cases():
    seen = []
    for (prefix, photo, fmt, fill, bps, extra), (mode, rawmode) in TiffImagePlugin.OPEN_INFO.items():
        seen.append((prefix, photo, fmt, fill, bps, extra, mode, rawmode))
    return seen


@pytest.mark.parametrize("compression", PIL_COMPRESSIONS)
def test_pil_written_tiffs_match_pil(compression):
    modes = ["RGB", "L", "P", "RGBA", "CMYK", "I;16", "I", "F", "LA", "PA", "I;16B", "1"]
    if compression == "jpeg":
        modes = ["RGB", "L", "CMYK"]
    for mode in modes:
        if mode in ("I;16", "I;16B"):
            img = Image.frombytes(mode, (37, 23), RNG.integers(0, 600, (23, 37)).astype(
                "<u2" if mode == "I;16" else ">u2").tobytes())
        elif mode == "PA":
            img = Image.fromarray(RGB).convert("P").convert("PA")
        else:
            img = Image.fromarray(RGB).convert(mode)
        buf = io.BytesIO()
        img.save(buf, format="TIFF", compression=compression)
        got = _decodes(buf.getvalue(), f"{mode} {compression}")
        np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), got)


@pytest.mark.parametrize("compression", ["group3", "group4", "tiff_ccitt"])
def test_pil_written_fax_matches_pil(compression):
    for w, h in ((1, 1), (37, 23), (130, 9)):
        img = Image.fromarray(RNG.random((h, w)) < 0.3)
        buf = io.BytesIO()
        img.save(buf, format="TIFF", compression=compression)
        _decodes(buf.getvalue(), f"{w}x{h}")


@pytest.mark.parametrize("codec", [1, 5])
def test_every_open_info_key(codec):
    """Each of Pillow's 120 keys, in its byte order(s), uncompressed (Pillow's
    unpackers) and LZW (libtiff's native order, FillOrder 2 undone)."""
    n = 0
    for prefix, photo, fmt, fill, bps, extra, mode, rawmode in _open_info_cases():
        fmt_v = fmt[0]
        s = len(bps)
        a = _samples(bps[0], fmt_v, 9, 13, s)
        cmap = RNG.integers(0, 65536, (1 << bps[0], 3)) if photo == 3 else None
        data = fx.write_tiff(a, photo, bits=bps[0], compression=codec, order="<" if prefix == b"II" else ">",
                             fillorder=fill, extra_samples=extra, sample_format=fmt_v, colormap=cmap, rows_per_strip=4)
        _check(data, f"{prefix} {photo} {fmt} {fill} {bps} {extra} -> {mode} {rawmode}")
        n += 1
    assert n >= 110


@pytest.mark.parametrize("codec", CODECS + [7])
def test_tiles_with_ragged_edges(codec):
    for tile in ((16, 16), (32, 16), (16, 48), (48, 32)):
        if codec == 7:
            _decodes(fx.write_tiff(SMOOTH, 6, compression=7, tile=tile, subsampling=(2, 2)), f"jpeg {tile}")
            continue
        _decodes(fx.write_tiff(RGB, 2, compression=codec, tile=tile), f"rgb {tile}")
        grey = RNG.integers(0, 2, (23, 37, 1))
        _check(fx.write_tiff(grey, 1, bits=1, compression=codec, tile=tile), f"1-bit {tile}")


@pytest.mark.parametrize("codec", CODECS)
def test_planar_configuration_2(codec):
    cases = [(RGB, 2, 8, ()), (RNG.integers(0, 65536, (23, 37, 3)), 2, 16, ()),
             (RNG.integers(0, 256, (23, 37, 4)), 2, 8, (2,)), (RNG.integers(0, 256, (23, 37, 4)), 2, 8, (1,)),
             (RNG.integers(0, 65536, (23, 37, 4)), 2, 16, (1,)), (RNG.integers(0, 256, (23, 37, 4)), 5, 8, ()),
             (RNG.integers(0, 256, (23, 37, 4)), 2, 8, (0,)), (RNG.integers(0, 256, (23, 37, 2)), 1, 8, (2,)),
             (RNG.integers(0, 256, (23, 37, 5)), 5, 8, (0,))]
    for a, photo, bits, extra in cases:
        for rps in (23, 5):
            _check(fx.write_tiff(a, photo, bits=bits, compression=codec, planar=2, extra_samples=extra,
                                 rows_per_strip=rps), f"{photo} {bits} {extra} rps={rps}")
    _check(fx.write_tiff(RGB, 2, compression=codec, planar=2, tile=(16, 16)), "tiles")


def test_bigtiff_and_byte_orders():
    for codec in CODECS:
        for order in "<>":
            for big in (False, True):
                data = fx.write_tiff(RNG.integers(0, 65536, (23, 37, 3)), 2, bits=16, compression=codec, order=order,
                                     bigtiff=big, rows_per_strip=6, tile=(16, 16) if big else None)
                got = _check(data, f"{order} big={big}")
                if not (big and order == ">"):  # PIL reads MM BigTIFF as a classic file, and fails
                    assert isinstance(got, np.ndarray)
    for magic in (b"MM*\x00", b"II\x00*"):  # the swapped magics PIL accepts
        data = bytearray(fx.write_tiff(RGB, 2, order="<" if magic[:2] == b"II" else ">"))
        data[:4] = magic
        got = _check(bytes(data), repr(magic))
        if isinstance(got, np.ndarray):
            np.testing.assert_array_equal(tdata.decode_image(bytes(data)), got)
        else:
            with pytest.raises(ValueError):
                tdata.decode_image(bytes(data))


@pytest.mark.parametrize("codec", CODECS)
def test_fillorder_2(codec):
    for photo, bits, s in ((0, 1, 1), (1, 1, 1), (1, 2, 1), (1, 4, 1), (1, 8, 1), (3, 4, 1), (3, 8, 1), (2, 8, 3),
                           (1, 16, 1)):
        a = _samples(bits, 1, 23, 37, s)
        cmap = RNG.integers(0, 65536, (1 << bits, 3)) if photo == 3 else None
        _check(fx.write_tiff(a, photo, bits=bits, compression=codec, fillorder=2, colormap=cmap, rows_per_strip=7),
               f"{photo} {bits}")


@pytest.mark.parametrize("orientation", range(1, 9))
def test_every_orientation(orientation):
    """PIL applies the Orientation tag on load (exif_transpose), on both of its
    decode paths; with the tag absent an XMP tiff:Orientation applies."""
    for codec in CODECS:
        got = _decodes(fx.write_tiff(RGB, 2, compression=codec, orientation=orientation, rows_per_strip=5))
        assert got.shape[:2] == ((37, 23) if orientation >= 5 else (23, 37))
    _decodes(fx.write_tiff(SMOOTH, 6, compression=7, subsampling=(2, 2), rows_per_strip=16, orientation=orientation))
    _decodes(fx.write_tiff(RGB, 6, compression=8, subsampling=(2, 1), rows_per_strip=8, orientation=orientation))
    _check(fx.write_tiff(RGB[..., :1], 0, bits=1, compression=4, orientation=orientation))
    for xmp in (f'<x tiff:Orientation="{orientation}"/>'.encode(), f"<tiff:Orientation>{orientation}<".encode()):
        _decodes(fx.write_tiff(RGB, 2, tags={700: (1, list(xmp))}), repr(xmp))
    _decodes(fx.write_tiff(RGB, 2, orientation=1, tags={700: (1, list(b'tiff:Orientation="6"'))}), "tag over XMP")


def test_ycbcr_jpeg_with_tables_and_ycbcr_subsampling():
    """JPEG (7) under YCbCr: JPEGTables then each strip or tile on its own,
    YCbCr -> RGB by libjpeg; under RGB, grey and CMYK the raw components. YCbCr
    with another compression goes through TIFFRGBAImage (every subsampling it
    reads, YCbCrCoefficients, ReferenceBlackWhite); uncompressed YCbCr through
    Pillow's RGBX unpacker."""
    for ss in ((1, 1), (2, 1), (2, 2)):
        for rps in (16, 23, 48):
            _decodes(fx.write_tiff(SMOOTH, 6, compression=7, subsampling=ss, rows_per_strip=rps), f"{ss} {rps}")
        _decodes(fx.write_tiff(SMOOTH, 6, compression=7, subsampling=ss, tile=(16, 32)), f"{ss} tiles")
    _decodes(fx.write_tiff(SMOOTH, 2, compression=7, rows_per_strip=8), "rgb")
    _decodes(fx.write_tiff(SMOOTH[..., :1], 1, compression=7, rows_per_strip=8), "grey")
    _decodes(fx.write_tiff(RNG.integers(0, 256, (23, 37, 4)).astype(np.uint8), 5, compression=7), "cmyk")
    _check(fx.write_tiff(SMOOTH, 6, compression=7, subsampling=(2, 2), rows_per_strip=16,
                         tags={530: (3, [1, 1])}), "sampling that disagrees with the tag")
    ycc = RNG.integers(0, 256, (23, 37, 3))
    for ss in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1), (2, 4)):
        for codec in CODECS:
            _check(fx.write_tiff(ycc, 6, compression=codec, subsampling=ss, rows_per_strip=8), f"ycc {ss} {codec}")
    for tags in ({529: (5, [(2990, 10000), (5870, 10000), (1140, 10000)])},
                 {529: (5, [(2126, 10000), (7152, 10000), (722, 10000)])},
                 {532: (5, [(16, 1), (235, 1), (128, 1), (240, 1), (128, 1), (240, 1)])},
                 {532: (5, [(0, 1), (255, 1), (128, 1), (255, 1), (128, 1), (255, 1)])}):
        _decodes(fx.write_tiff(ycc, 6, compression=8, subsampling=(2, 2), rows_per_strip=8, tags=tags), repr(tags))


def test_ycbcr_tiles_and_planes_through_tiffrgbaimage():
    """TIFFRGBAImage's other YCbCr readers: tiles of every subsampling (the
    rightmost tile clipped, where libtiff's 4x4 put function skips hidden
    units of 10 bytes), planes at 1x1 (strips, tiles, JPEG-compressed planes)
    and planes at another sampling (refused by libtiff)."""
    ycc = RNG.integers(0, 256, (23, 37, 3))
    for ss in ((1, 1), (2, 1), (2, 2), (4, 2), (4, 4), (1, 2), (4, 1)):
        for codec in (8, 5):
            for tile in ((16, 16), (32, 16)):
                _decodes(fx.write_tiff(ycc, 6, compression=codec, subsampling=ss, tile=tile), f"{ss} {codec} {tile}")
    for codec in (32773, 8, 5):
        _decodes(fx.write_tiff(ycc, 6, compression=codec, subsampling=(1, 1), planar=2, rows_per_strip=8), "strips")
        _decodes(fx.write_tiff(ycc, 6, compression=codec, subsampling=(1, 1), planar=2, tile=(16, 16)), "tiles")
        _check(fx.write_tiff(ycc, 6, compression=codec, subsampling=(1, 1), planar=2, tags={530: (3, [2, 2])}), "2x2")
    _decodes(fx.write_tiff(SMOOTH, 6, compression=7, subsampling=(1, 1), planar=2, rows_per_strip=8), "jpeg strips")
    _decodes(fx.write_tiff(SMOOTH, 6, compression=7, subsampling=(1, 1), planar=2, tile=(16, 16)), "jpeg tiles")


def test_extra_samples_and_associated_alpha():
    for bits in (8, 16):
        a = RNG.integers(0, 1 << bits, (23, 37, 4))
        a[0, :4, 3] = [0, 1, (1 << bits) - 1, 128 << (bits - 8)]
        for extra in ((), (0,), (1,), (2,), (999,)):
            for codec in (1, 5):
                _check(fx.write_tiff(a, 2, bits=bits, compression=codec, extra_samples=extra), f"{bits} {extra}")
    for extra in ((1, 0), (2, 0), (0, 0), (1, 0, 0)):
        a = RNG.integers(0, 256, (23, 37, 3 + len(extra)))
        _check(fx.write_tiff(a, 2, extra_samples=extra), repr(extra))


def test_colormaps():
    """P;1 / 2 / 4 / 8 and PA with 16-bit ColorMap entries (their high bytes),
    a short map (zero past it), a map of more than 256 entries (refused)."""
    for bits in (1, 2, 4, 8):
        idx = RNG.integers(0, 1 << bits, (23, 37, 1))
        cmap = RNG.integers(0, 65536, (1 << bits, 3))
        for codec in (1, 32773, 8):
            _decodes(fx.write_tiff(idx, 3, bits=bits, compression=codec, colormap=cmap), f"P;{bits}")
    pa = np.concatenate([RNG.integers(0, 256, (23, 37, 1)), RNG.integers(0, 256, (23, 37, 1))], 2)
    _decodes(fx.write_tiff(pa, 3, extra_samples=(2,), colormap=RNG.integers(0, 65536, (256, 3))), "PA")
    idx = RNG.integers(0, 256, (23, 37, 1))
    for n in (4, 100, 300):
        _check(fx.write_tiff(idx, 3, colormap=RNG.integers(0, 65536, (n, 3))), f"map of {n}")
    _check(fx.write_tiff(idx, 3, colormap=None), "no map")


@pytest.mark.parametrize("codec", [5, 8, 34925, 32773])
def test_predictors(codec):
    """Horizontal differencing at 8, 16 and 32 bits and the floating-point
    predictor (byte planes) in both byte orders; PackBits ignores the tag."""
    for order in "<>":
        for bits, photo, s in ((8, 2, 3), (8, 1, 1), (16, 1, 1), (16, 2, 3), (32, 1, 1)):
            a = _samples(bits, 1, 23, 37, s)
            _check(fx.write_tiff(a, photo, bits=bits, compression=codec, predictor=2, order=order, rows_per_strip=6),
                   f"{order} pred 2 {bits}")
        _check(fx.write_tiff(RGB, 2, compression=codec, predictor=2, planar=2), "planar")
        f = _samples(32, 3, 23, 37, 1)
        _check(fx.write_tiff(f, 1, bits=32, sample_format=3, compression=codec, predictor=3, order=order), "pred 3")
    _check(fx.write_tiff(RGB, 2, compression=codec, tags={317: (3, [4])}), "predictor 4")
    _check(fx.write_tiff(RGB, 2, compression=codec, predictor=2, tags={317: (3, [3])}), "predictor 3 on integers")


def test_old_style_lzw_and_long_streams():
    for data in (RGB, fx.procedural(300, 200, 7)):
        for old in (False, True):
            for pred in (1, 2):
                _decodes(fx.write_tiff(data, 2, compression=5, old_lzw=old, predictor=pred, rows_per_strip=64),
                         f"old={old} pred={pred}")


@pytest.mark.parametrize("kind,t4", [(2, 0), (3, 0), (3, 1), (3, 4), (3, 5), (4, 0)])
def test_ccitt(kind, t4):
    """CCITT RLE, Group 3 1D / 2D (every other row 2D, or three in four) with
    and without fill bits, Group 4; either photometric, FillOrder 2, strips."""
    for w, h in ((37, 23), (200, 5), (1, 3)):
        bw = (RNG.random((h, w)) < 0.4).astype(np.uint8)
        bw[0] = 0
        if h > 2:
            bw[2] = 1
        for photo in (0, 1):
            for fill in (1, 2):
                _decodes(fx.write_tiff(bw, photo, bits=1, compression=kind, t4options=t4, fillorder=fill,
                                       rows_per_strip=h if h < 9 else 9), f"{w}x{h} {photo} {fill}")
    long_runs = np.zeros((4, 3000), np.uint8)
    long_runs[1, 100:2900] = 1
    long_runs[2, 1900:] = 1
    _decodes(fx.write_tiff(long_runs, 0, bits=1, compression=kind, t4options=t4), "makeup and extended codes")


def _cut_and_flip(data: bytes, flip_end: int, values=(0, 0xFF), exempt=()):
    for cut in range(len(data)):
        _check(data[:cut], f"cut at {cut}")
    for k in range(flip_end):
        if k in exempt:
            continue
        for v in values:
            bad = bytearray(data)
            bad[k] = v
            _check(bytes(bad), f"byte {k} = {v}")


def _value_bytes(data: bytes, tag: int) -> range:
    """The bytes of a little-endian classic file's inline value of `tag`."""
    return range(_entry_at(data, tag) + 8, _entry_at(data, tag) + 12)


@pytest.mark.parametrize("kind", ["raw", "tiles", "p4_fillorder", "packbits", "lzw", "deflate", "rle", "jpeg", "g3"])
def test_cut_and_flipped_bytes_decode_as_pil_or_raise(kind):
    """Cut anywhere; flipped anywhere in uncompressed files (Pillow's own
    path), in LZW, Deflate, CCITT RLE and PackBits ones (libtiff's own
    reading of the directory too; its codecs' damaged data) and in a YCbCr
    JPEG one (JPEGTables that end early or whose quantizers and Huffman
    values make coefficients extreme; a strip as libjpeg reads damaged
    data); in the header alone of a Group 3 one. Not flipped, as libtiff
    leaves rows or columns of Pillow's buffer unwritten there (not
    reproducible): the JPEG one's ImageWidth value (a width past the JPEG
    frame), a Group 3 strip that ends early."""
    img = RGB[:5, :7]
    data = {"raw": lambda: fx.write_tiff(img, 2, rows_per_strip=2, ifd_first=True),
            "tiles": lambda: fx.write_tiff(img, 2, tile=(16, 16), bigtiff=True),
            "p4_fillorder": lambda: fx.write_tiff(RNG.integers(0, 16, (5, 7)), 3, bits=4, fillorder=2,
                                                  colormap=RNG.integers(0, 65536, (16, 3))),
            "packbits": lambda: fx.write_tiff(img, 2, compression=32773, rows_per_strip=2),
            "lzw": lambda: fx.write_tiff(img, 2, compression=5, predictor=2),
            "deflate": lambda: fx.write_tiff(img, 2, compression=8, order=">"),
            "rle": lambda: fx.write_tiff((RNG.random((5, 20)) < 0.5).astype(np.uint8), 0, bits=1, compression=2),
            "jpeg": lambda: fx.write_tiff(SMOOTH[:16, :16], 6, compression=7, subsampling=(2, 2)),
            "g3": lambda: fx.write_tiff((RNG.random((5, 20)) < 0.5).astype(np.uint8), 0, bits=1, compression=3,
                                        t4options=1)}[kind]()
    exempt = _value_bytes(data, 256) if kind == "jpeg" else ()
    _cut_and_flip(data, 8 if kind == "g3" else len(data), exempt=exempt)


def test_pillow_and_libtiff_reading_one_directory_apart():
    """Pillow keeps a repeated tag's last entry and libtiff its first; libtiff
    reads strip arrays to the strip count (from where the whole array sits),
    refuses IFD-typed arrays, out-of-range SHORT values, per-sample fields
    that differ by sample or miscount, and makes channels past the colours
    unspecified extra samples; it leaves recoverable fields at their
    defaults. Compressed files decode by libtiff's values through Pillow's
    rawmode (a YCbCr image as libtiff sees it, unpacked as the grey image
    Pillow sees), or fail where TiffDecode.c checks the two."""
    grey = RNG.integers(0, 256, (23, 37, 3))
    ycc = RNG.integers(0, 256, (23, 37, 3))
    one = fx.write_tiff(RGB, 2, compression=5)  # one strip
    cases = [
        fx.write_tiff(grey, 1, compression=5, append=[(277, 3, [1])]),
        fx.write_tiff(ycc, 6, compression=5, subsampling=(1, 1), append=[(262, 3, [1]), (277, 3, [1])]),
        fx.write_tiff(RGB, 2, compression=8, append=[(256, 3, [36])]),
        fx.write_tiff(RGB, 2, compression=5, append=[(259, 3, [1])]),
        fx.write_tiff(RGB, 2, compression=5, rows_per_strip=5, append=[(317, 3, [2])]),
        _retype(one, 279, 13), _retype(one, 273, 9), _recount(one, 279, 100), _recount(one, 273, 7),
        fx.write_tiff(RGB, 2, compression=5, predictor=2, tags={317: (4, [70002])}),
        _retag(fx.write_tiff(RGB, 2, compression=5, rows_per_strip=4), 278, 341),  # an SMaxSampleValue libtiff refuses
        fx.write_tiff(RNG.integers(0, 65536, (23, 37, 4)), 2, bits=16, compression=8, planar=2),  # alpha unspecified
        fx.write_tiff(RGB, 2, compression=8, tags={339: (3, [1, 3, 1])}),
    ]
    for i, data in enumerate(cases):
        _check(data, f"case {i}")


def _entry_at(data: bytes, tag: int) -> int:
    ifd = struct.unpack("<I", data[4:8])[0]
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == tag:
            return at
    raise KeyError(tag)


def _retype(data: bytes, tag: int, typ: int) -> bytes:
    out = bytearray(data)
    out[_entry_at(data, tag) + 2:_entry_at(data, tag) + 4] = struct.pack("<H", typ)
    return bytes(out)


def _recount(data: bytes, tag: int, count: int) -> bytes:
    out = bytearray(data)
    out[_entry_at(data, tag) + 4:_entry_at(data, tag) + 8] = struct.pack("<I", count)
    return bytes(out)


def _retag(data: bytes, tag: int, new: int) -> bytes:
    """A classic little-endian file with the IFD entry of `tag` renumbered."""
    ifd = struct.unpack("<I", data[4:8])[0]
    out = bytearray(data)
    for i in range(struct.unpack("<H", data[ifd:ifd + 2])[0]):
        at = ifd + 2 + 12 * i
        if struct.unpack("<H", data[at:at + 2])[0] == tag:
            out[at:at + 2] = struct.pack("<H", new)
    return bytes(out)


def test_refusals_as_pil_refuses():
    """Compressions PIL does not map or this libtiff lacks (WebP), keys outside
    OPEN_INFO, missing or empty dimensions, sizes past PIL's bomb limit, more
    samples than PIL decodes, no data offsets."""
    for data in (fx.write_tiff(RGB, 2, tags={259: (3, [12345])}), fx.write_tiff(RGB, 2, tags={259: (3, [50001])}),
                 fx.write_tiff(RGB, 2, tags={259: (3, [34676])}),
                 fx.write_tiff(RNG.integers(0, 256, (23, 37, 4)), 2, extra_samples=(5,)),
                 fx.write_tiff(RNG.integers(0, 256, (23, 37, 2)), 2),
                 fx.write_tiff(RGB, 2, tags={256: None}), fx.write_tiff(RGB, 2, tags={257: (3, [0])}),
                 fx.write_tiff(RGB, 2, tags={256: (4, [60000]), 257: (4, [60000])}),
                 _retag(fx.write_tiff(RGB, 2), 273, 40000), _retag(fx.write_tiff(RGB, 2, compression=5), 273, 40000),
                 fx.write_tiff(RGB, 2, tags={277: (3, [7])}),
                 fx.write_tiff(RGB, 2, tags={0xBC01: (4, [1])}), fx.write_tiff(RGB, 2, tags={256: (5, [(37, 1)])}),
                 fx.write_tiff(RGB, 2, tags={258: (3, [8, 8])}), b"II*\x00\x08\x00\x00\x00\x00\x00"):
        assert isinstance(_pil(data), Exception)
        with pytest.raises(ValueError):
            tdata.decode_image(data)


def test_lab_through_littlecms_as_pil():
    """PIL converts LAB to RGB through littleCMS's 16-bit CLUT of its float
    LAB -> sRGB pipeline: every L with a and b in steps of 4 (the port is
    held to all 2^24 inputs when this file is written), planes (Pillow's A /
    B unpackers flip the sign bit; libtiff's planes do not) and LZW."""
    g = np.stack(np.meshgrid(np.arange(256), np.arange(0, 256, 4), np.arange(0, 256, 4), indexing="ij"), -1)
    _decodes(fx.write_tiff(g.reshape(1024, 1024, 3), 8, rows_per_strip=128), "L x a x b")
    a = RNG.integers(0, 256, (23, 37, 3))
    for codec in (1, 5):
        _decodes(fx.write_tiff(a, 8, compression=codec, planar=2), f"planar {codec}")
        _decodes(fx.write_tiff(a, 8, compression=codec, tile=(16, 16)), f"tiles {codec}")


def test_decode_image_dispatches_every_signature():
    before = image_io.calls["decode_tiff"]
    for order in "<>":
        for big in (False, True):
            data = fx.write_tiff(RGB, 2, order=order, bigtiff=big)
            assert data[:4] in (b"II*\x00", b"MM\x00*", b"II+\x00", b"MM\x00+")
            if big and order == ">":  # PIL reads it as a classic file: no dimensions
                with pytest.raises(ValueError, match="TIFF without its dimensions"):
                    tdata.decode_image(data)
                continue
            np.testing.assert_array_equal(tdata.decode_image(data), RGB)
    assert image_io.calls["decode_tiff"] == before + 3
    head = struct.pack("<2sHI", b"II", 42, 8)
    with pytest.raises(ValueError, match="TIFF"):
        tdata.decode_image(head)
    # JPEG 2000 (JP2 and J2K), ICO, CUR and the PPM family, by their signatures as PIL tells them
    counts = dict(image_io.calls)
    for no_jp2 in (False, True):
        buf = io.BytesIO()
        Image.fromarray(RGB).save(buf, format="JPEG2000", no_jp2=no_jp2)
        np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), RGB)
    buf = io.BytesIO()
    Image.fromarray(RGB).save(buf, format="ICO", sizes=[(16, 16)], bitmap_format="bmp")
    ico = buf.getvalue()
    np.testing.assert_array_equal(tdata.decode_image(ico), _pil(ico))
    np.testing.assert_array_equal(tdata.decode_image(b"\x00\x00\x02\x00" + ico[4:]), _pil(ico))
    for magic in (b"P6", b"PyRGBA"):
        data = magic + b" 37 23 255\n" + (RGB if magic == b"P6" else np.dstack([RGB, RGB[..., :1]])).tobytes()
        np.testing.assert_array_equal(tdata.decode_image(data), RGB)
    for kind, n in (("decode_jpeg2000", 2), ("decode_dib", 2), ("decode_ppm", 2)):
        assert image_io.calls[kind] == counts.get(kind, 0) + n, kind
    for data in (b"P7\nWIDTH 1\n", b"PF 1 1 -1\n" + bytes(12)):
        with pytest.raises(ValueError, match="as PIL refuses it"):
            tdata.decode_image(data)


def test_chip_smoke_tiff_writer_is_read_back_by_pil():
    """`chip_smoke.py` writes phase 5e's uncompressed, PackBits, Deflate and
    LZMA timing files on the card's machine, which has no PIL: PIL reads each
    back to its pixels, rows in strips of 64 and a last strip cut short."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    rgb = RNG.integers(0, 256, (130, 77, 3)).astype(np.uint8)
    for compression in (1, 32773, 8, 34925):
        data = cs.write_tiff_rgb(rgb, compression)
        np.testing.assert_array_equal(_decodes(data, str(compression)), rgb)
