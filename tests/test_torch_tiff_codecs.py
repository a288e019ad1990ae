"""TIFF's last compressions in the port's decoder (`csrc/host/tiff.cpp`)
against Pillow 12.1 over libtiff 4.7, bit for bit, or both raising: CCITT
RLEW (32771: RLE rows aligned to 2 bytes, as libtiff aligns its byte pointer
in the file), ThunderScan (32809: 4-bit runs, 2- and 3-bit deltas and raw
pixels; other depths refused) and old-style JPEG (6: the JPEG stream libtiff's
tif_ojpeg.c rebuilds from JPEGInterchangeFormat, from the segments that open
the first strip, or from the JPEGQTables / DCTables / ACTables tags around
the strips, restart markers between strips, TIFFRGBAImage's YCbCr), each with
its file cut anywhere and every byte set to 0 and to 0xFF. Files written by
`make_fixtures.write_tiff` / `write_ojpeg` (PIL writes none of these). Not
flipped, as libtiff leaves rows of Pillow's buffer unwritten there (not
reproducible): RLEW's Compression value (one flip makes it Group 3, whose
strip then ends early). About 20 s."""

import struct

import numpy as np
import pytest
import torch

from reflectionflow_tpu_torch.train import data as tdata

torch.set_num_threads(1)

from test_torch_tiff import RNG, _check, _cut_and_flip, _decodes, _entry_at, _value_bytes, fx  # noqa: E402

SMOOTH = fx.procedural(37, 23, 25)


def _bilevel(h, w):
    bw = (RNG.random((h, w)) < 0.4).astype(np.uint8)
    bw[0] = 0
    return bw


@pytest.mark.parametrize("photometric,fillorder", [(0, 1), (1, 1), (0, 2), (1, 2)])
def test_ccitt_rlew(photometric, fillorder):
    """Rows aligned to a 2-byte boundary of the strip; a strip at an odd file
    offset, where libtiff's pointer alignment skips other bytes."""
    for w, h in ((37, 23), (200, 5), (1, 3), (16, 4)):
        data = fx.write_tiff(_bilevel(h, w), photometric, bits=1, compression=32771, fillorder=fillorder,
                             rows_per_strip=h if h < 9 else 9)
        (_check if w == 1 else _decodes)(data, f"{w}x{h}")  # 1 x 3: libtiff fails it under FillOrder 2
    data = fx.write_tiff(_bilevel(9, 37), photometric, bits=1, compression=32771, fillorder=fillorder)
    odd = data[:8] + b"\0" + data[8:]  # every offset past the header one byte later
    ifd = struct.unpack("<I", data[4:8])[0] + 1
    odd = bytearray(odd)
    odd[4:8] = struct.pack("<I", ifd)
    at = _entry_at(bytes(odd), 273)
    odd[at + 8:at + 12] = struct.pack("<I", 9)
    _check(bytes(odd), "odd strip offset")


def test_ccitt_rlew_long_runs_and_decode_image():
    long_runs = np.zeros((4, 3000), np.uint8)
    long_runs[1, 100:2900] = 1
    long_runs[2, 1900:] = 1
    data = fx.write_tiff(long_runs, 0, bits=1, compression=32771)
    np.testing.assert_array_equal(tdata.decode_image(data), _decodes(data, "makeup and extended codes"))


@pytest.mark.parametrize("photometric", [0, 1, 3])
def test_thunderscan(photometric):
    """4-bit grey (either photometric) and palette pixels, strips, every
    code kind (runs, 2-bit and 3-bit deltas with their skip codes, raw)."""
    for w, h, rps in ((37, 23, 7), (9, 5, 5), (1, 3, 1), (64, 16, 16)):
        smooth = (fx.procedural(w, h, w + h)[..., 1].astype(np.int64) >> 4)
        px = np.where(RNG.random((h, w)) < 0.2, RNG.integers(0, 16, (h, w)), smooth)[..., None]
        cmap = RNG.integers(0, 65536, (16, 3)) if photometric == 3 else None
        _decodes(fx.write_tiff(px, photometric, bits=4, compression=32809, colormap=cmap, rows_per_strip=rps,
                               thunder_seed=w), f"{w}x{h}")


def test_thunderscan_refused_past_4_bits_and_damaged_runs():
    """libtiff decodes ThunderScan at 4 bits only; rows that decode to too
    few or too many pixels fail there, and here."""
    _check(fx.write_tiff(RNG.integers(0, 256, (5, 9, 1)), 1, bits=8, compression=32809), "8 bits")
    data = fx.write_tiff(RNG.integers(0, 16, (5, 9, 1)), 1, bits=4, compression=32809, rows_per_strip=5)
    for extra in (b"\x3f", b"\xc3\xc3", b""):
        ifd = struct.unpack("<I", data[4:8])[0]
        _check(data[:ifd] + extra + data[ifd:], repr(extra))


OJPEG = [(source, ss, rps) for source in ("tags", "header", "whole", "strip") for ss in ((1, 1), (2, 1), (2, 2))
         for rps in (None, 16) if not (source == "whole" and rps)]  # "whole": one strip holds the whole JPEG


@pytest.mark.parametrize("source,subsampling,rows_per_strip", OJPEG,
                         ids=[f"{s}-{h}x{v}-{r or 'one'}" for s, (h, v), r in OJPEG])
def test_old_style_jpeg(source, subsampling, rows_per_strip):
    """The JPEG's tables and frame from JPEGInterchangeFormat (its segments,
    or the whole JPEG), from the first strip, or from the tables' tags; one
    strip or strips of 16 rows (a restart interval each); libtiff's YCbCr
    data units through TIFFRGBAImage."""
    data = fx.write_ojpeg(SMOOTH, subsampling, rows_per_strip, source)
    got = _decodes(data, source)
    np.testing.assert_array_equal(tdata.decode_image(data), got)
    assert np.abs(got.astype(int) - SMOOTH).max() < 40  # the image, through JPEG's loss


def test_old_style_jpeg_restart_intervals_and_photometric():
    """A restart interval of one MCU row in one strip (JPEGRestartInterval, or
    the JPEG's DRI), photometric RGB (libtiff reads YCbCr), a taller image
    of odd width, another quality."""
    for source in ("tags", "header", "strip"):
        _decodes(fx.write_ojpeg(SMOOTH, (2, 1), None, source, restart_rows=1), f"{source} restarts")
    for ss in ((1, 1), (2, 2)):
        _decodes(fx.write_ojpeg(SMOOTH, ss, 16, "tags", photometric=2), f"rgb {ss}")
    tall = fx.procedural(29, 70, 8)
    _decodes(fx.write_ojpeg(tall, (2, 2), 32, "header", quality=90), "tall")
    _decodes(fx.write_ojpeg(tall, (2, 1), 16, "strip", quality=30), "tall 2x1")


def test_old_style_jpeg_tables_and_strips_damaged():
    """Missing or shared tables, a strip past the file or without byte
    counts, the JPEG frame's size against the image: PIL's pixels or both
    raise (a strip whose raw read fails is left zero, the strips after it
    fail)."""
    base = dict(subsampling=(2, 2), rows_per_strip=16, source="tags")
    for tags in ({519: None}, {520: None}, {521: (4, [0])}, {519: (4, [0, 0, 0, 0])}, {279: None},
                 {273: (4, [8, 10 ** 6])}, {515: (3, [1])}, {530: (3, [1, 1])}, {530: None}, {277: None},
                 {262: (3, [1])}, {258: None}, {256: (3, [30])}, {257: (3, [40])}):
        _check(fx.write_ojpeg(SMOOTH, tags=tags, **base), repr(tags))
    for tags in ({513: (4, [10 ** 6])}, {514: (4, [0])}, {514: (4, [20])}, {273: None, 279: None}):
        _check(fx.write_ojpeg(SMOOTH, (2, 2), None, "header", tags=tags), repr(tags))


@pytest.mark.parametrize("kind", ["rlew", "thunder", "ojpeg_tags", "ojpeg_header", "ojpeg_strip", "ojpeg_whole",
                                  "ojpeg_restarts"])
def test_cut_and_flipped_bytes_decode_as_pil_or_raise(kind):
    if kind == "rlew":
        data = fx.write_tiff(_bilevel(5, 20), 0, bits=1, compression=32771)
    elif kind == "thunder":
        data = fx.write_tiff(RNG.integers(0, 16, (5, 9, 1)), 1, bits=4, compression=32809, rows_per_strip=3)
    elif kind == "ojpeg_restarts":
        data = fx.write_ojpeg(SMOOTH[:16, :16], (2, 1), None, "tags", restart_rows=1)
    else:
        source = kind.split("_")[1]
        data = fx.write_ojpeg(SMOOTH[:32, :16], (2, 2), None if source == "whole" else 16, source)
    _cut_and_flip(data, len(data), exempt=_value_bytes(data, 259) if kind == "rlew" else ())
