"""The port's GIF decoder (`utils/image_io.py::decode_gif`, C++ in
`csrc/host/gif.cpp`) against Pillow 12.1's GifImagePlugin and
`convert("RGB")`, bit for bit, on files PIL writes and on files written by
`make_fixtures.write_gif` (PIL writes one clear code, 8-bit codes at most):
interlaced rows at every height, local, global, short and grey-ramp tables,
every minimum code size, a full code table with and without a clear, clear
and end codes mid-stream, offset and oversized sub-frames on index 0 or the
GCE's transparency index, extensions and stray bytes between blocks, sub-block
sizes, the data cut or flipped anywhere. Where Pillow refuses a file the port
raises ValueError. About 10 s."""

import importlib.util
import io
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg",
                                        "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

RNG = np.random.default_rng(0)
PAL = RNG.integers(0, 256, (16, 3))
PAL256 = RNG.integers(0, 256, (256, 3))
RAMP = np.repeat(np.arange(16)[:, None], 3, 1)
IDX = RNG.integers(0, 16, (5, 7))


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")  # P with transparency -> RGB
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _check(data: bytes, what: str):
    """The port's decode equals PIL's, or both raise."""
    want = _pil(data)
    if isinstance(want, Exception):
        with pytest.raises(ValueError):
            image_io.decode_gif(data)
        return
    got = image_io.decode_gif(data)
    assert got.shape == want.shape, what
    np.testing.assert_array_equal(got, want, err_msg=what)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("mode", ["RGB", "L", "P"])
def test_pil_written_gifs_match_pil(mode, interlace):
    for w, h in ((1, 1), (7, 5), (33, 17), (100, 64)):
        img = Image.fromarray(RNG.integers(0, 256, (h, w, 3), dtype=np.uint8)).convert(mode)
        buf = io.BytesIO()
        img.save(buf, format="GIF", interlace=interlace)
        _check(buf.getvalue(), f"{mode} {w}x{h}")
        np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), _pil(buf.getvalue()))


def test_animated_gif_gives_its_first_frame():
    frames = [Image.fromarray(RNG.integers(0, 256, (20, 30, 3), dtype=np.uint8)) for _ in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="GIF", save_all=True, append_images=frames[1:], duration=50, loop=0)
    _check(buf.getvalue(), "animation")


def test_interlaced_rows_at_every_height():
    for h in range(1, 20):
        _check(fx.write_gif((5, h), [fx.gif_image(RNG.integers(0, 16, (h, 5)), interlace=True)], palette=PAL),
               f"h={h}")


@pytest.mark.parametrize("bits", list(range(14)))
def test_every_minimum_code_size(bits):
    """0-12 as Pillow decodes them (0 and 1 never widen their codes; above 8
    the literals are kept modulo 256), 13 refused."""
    lim = max(1, min(1 << bits, 256))
    for literal in (True, False) if bits > 1 else (True,):
        idx = RNG.integers(0, lim, (9, 11))
        _check(fx.write_gif((11, 9), [fx.gif_image(idx, bits=bits, lzw={"literal": literal})], palette=PAL256),
               f"literal={literal}")


@pytest.mark.parametrize("lzw", [{"full": "clear"}, {"full": "keep"}, {"clear_every": 37}, {"clear_first": False},
                                 {"end": False}])
def test_code_table_kinds(lzw):
    """A table that fills (reset by a clear, or kept at 12 bits with no new
    entries), clear codes mid-stream, no leading clear, no end code."""
    _check(fx.write_gif((300, 300), [fx.gif_image(RNG.integers(0, 256, (300, 300)), lzw=lzw)], palette=PAL256),
           "random")
    low = (RNG.random((200, 200)) < 0.9).astype(int)
    _check(fx.write_gif((200, 200), [fx.gif_image(low, lzw=lzw)], palette=PAL), "low entropy")


def test_offset_and_oversized_frames_with_transparency():
    """A frame inside the screen, at its corner, past it (the image grows);
    outside it the transparency index when a GCE sets one, else index 0."""
    for x, y, fw, fh in ((2, 1, 3, 2), (0, 0, 7, 5), (5, 4, 4, 3), (10, 10, 2, 2)):
        sub = RNG.integers(0, 16, (fh, fw))
        for t in (None, 3, 200):
            for pal in (PAL, None):
                _check(fx.write_gif((7, 5), [fx.gif_gce(transparency=t), fx.gif_image(sub, x=x, y=y)], palette=pal),
                       f"{x},{y} {fw}x{fh} t={t}")


def test_colour_tables():
    """Local over global, short tables (indices past them black), grey ramps
    (grey levels, or the global table under a ramp local one), no table."""
    for glob in (None, PAL, RAMP, PAL[:4], RAMP[:2]):
        for local in (None, PAL, RAMP, PAL[:2], PAL256):
            idx = RNG.integers(0, 256 if local is not None and len(local) == 256 else 16, (5, 7))
            _check(fx.write_gif((7, 5), [fx.gif_image(idx, palette=local)], palette=glob),
                   f"global {None if glob is None else len(glob)} local {None if local is None else len(local)}")


@pytest.mark.parametrize("raw", [
    b"!\xf9\x02\x01\x00\x00", b"!\xf9\x03\x01\x00\x00\x00", b"!\xf9\x03\x00\x00\x00\x00", b"!\xf9\x00",
    b"!\xff\x00", b"!\xff\x0bNETSCAPE2.0\x00", b"\x00\x07xyz", b"!", b"!\xfe\x00",
    fx.gif_gce(3) + fx.gif_gce(None), fx.gif_gce(3) + fx.gif_gce(7),
    fx.gif_extension(0xFE, b"hello", b"world") + fx.gif_extension(0xFF, b"NETSCAPE2.0", b"\x01\x00\x00")
    + fx.gif_extension(0x01, bytes(12), b"text") + fx.gif_extension(0x77, b"abc"),
])
def test_extensions_and_stray_bytes(raw):
    """Skipped extensions (an empty first sub-block makes Pillow skip past
    its terminator), short GCEs, a GCE without transparency after one with,
    stray bytes between blocks."""
    _check(fx.write_gif((7, 5), [raw, fx.gif_image(IDX)], palette=PAL), repr(raw))


def test_cut_and_flipped_bytes_decode_as_pil_or_raise():
    data = fx.write_gif((7, 5), [fx.gif_gce(2), fx.gif_extension(0xFE, b"x"), fx.gif_image(IDX, palette=PAL)],
                        palette=PAL)
    for cut in range(len(data)):
        _check(data[:cut], f"cut at {cut}")
    data = fx.write_gif((7, 5), [fx.gif_image(IDX, lzw={"end": False})], palette=PAL)
    for k in range(len(data)):
        for v in (0, 1, 0x2C, 0x3B, 0xFF):
            bad = bytearray(data)
            bad[k] = v
            _check(bytes(bad), f"byte {k} = {v}")


def test_codes_inserted_mid_stream():
    """An end code before the last pixel (a truncated file when the data was
    read to its end), a clear code, a code past the table (refused)."""
    codes = fx.lzw_codes(IDX.reshape(-1), 4, literal=True)
    for at in range(1, len(codes)):
        w = codes[at][1]
        for code in (17, 16, 31):
            _check(fx.write_gif((7, 5), [fx.gif_image(IDX, codes=codes[:at] + [(code, w)] + codes[at:])],
                                palette=PAL), f"code {code} at {at}")


def test_early_end_code_across_reads():
    """Pillow feeds the decoder 65536 bytes a read: after an end code it goes
    on when a later read still brings data, and raises when none does."""
    big = RNG.integers(0, 256, (400, 400))
    codes = fx.lzw_codes(big.reshape(-1), 8)
    for at in (100, 40000, len(codes) - 50):
        _check(fx.write_gif((400, 400), [fx.gif_image(big, codes=codes[:at] + [(257, codes[at][1])] + codes[at:])],
                            palette=PAL256), f"end code at {at}")
    for block in (1, 7, 255):
        _check(fx.write_gif((400, 400), [fx.gif_image(big, block=block)], palette=PAL256), f"sub-blocks of {block}")


def test_empty_frames_and_sizes():
    """Extents (0, y0, 0, y1) are the whole image to Pillow; other empty
    frames are refused; screens past twice PIL's MAX_IMAGE_PIXELS too."""
    for w, h, x, y in ((0, 3, 0, 0), (3, 0, 0, 0), (0, 0, 0, 0), (0, 3, 0, 2), (0, 4, 0, 3), (0, 3, 1, 0),
                       (2, 0, 1, 1)):
        for sw, sh in ((7, 5), (0, 0), (7, 0)):
            for n_pix in (0, 3, 35, 49, 200):
                data = bytearray(fx.write_gif((sw, sh), [fx.gif_image(RNG.integers(0, 16, (1, max(n_pix, 1))),
                                                                      bits=4)], palette=PAL))
                data[62:70] = bytes([x, 0, y, 0, w, 0, h, 0])
                _check(bytes(data), f"{w}x{h} at {x},{y} on {sw}x{sh}, {n_pix} pixels")
    _check(fx.write_gif((0, 0), [fx.gif_image(IDX)], palette=PAL), "empty screen")
    _check(fx.write_gif((65535, 65535), [fx.gif_image(IDX)], palette=PAL), "huge screen")
    _check(fx.write_gif((7, 5), [fx.gif_image(IDX, x=65000, y=65000)], palette=PAL), "frame far past the screen")
    for data in (b"GIF87a" + bytes(64), b"GIF89a", b"GIF89a\x07\x00\x05\x00", fx.write_gif((7, 5), [], palette=PAL)):
        _check(data, repr(data[:16]))


def test_decode_image_reads_both_versions():
    for version in (b"GIF87a", b"GIF89a"):
        data = fx.write_gif((7, 5), [fx.gif_image(IDX)], palette=PAL, version=version)
        np.testing.assert_array_equal(tdata.decode_image(data), PAL[IDX].astype(np.uint8))
    before = image_io.calls["decode_gif"]
    tdata.decode_image(data)
    assert image_io.calls["decode_gif"] == before + 1
