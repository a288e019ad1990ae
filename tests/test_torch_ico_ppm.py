"""The port's ICO / CUR reader (`train/data.py::decode_ico`, `decode_cur`,
with `utils/image_io.py::decode_dib` in `csrc/host/bmp.cpp`) and its PPM
family decoder (`image_io.decode_ppm`, `csrc/host/ppm.cpp`) against Pillow
12.1's IcoImagePlugin, CurImagePlugin and PpmImagePlugin and
`convert("RGB")`, bit for bit.

Cases: the committed fixtures; PIL's ICO writer over modes and sizes, PNG and
DIB entries (the largest entry, the lower colour depth of two of one size,
the AND mask and 32-bit alpha that must be there), CUR directories; every
PPM header PIL opens (P1-P6 plain and raw, Pf both byte orders, P0CMYK, PyP,
PyRGBA, PyCMYK; comments, a comment inside a token, Python's int() tokens,
maxval below 255, 255, past 255 and 65535); damaged files, every cut and one
byte XOR-ed with 0x01, 0x80, 0xFF or 0x20 at every offset, where the port
decodes PIL's pixels or raises ValueError where PIL raises (a PNG entry's
bytes past the directory are `decode_png`'s, held to PIL in
`test_torch_image_files.py`, and are not swept here). P7 (PAM) and PF raise
"... as PIL refuses it". A GenRef shard with JPEG 2000, ICO and PPM members
reads to the same samples in the JAX package and the port. About 10 s on one
core."""

import importlib.util
import io
import json
import os
import struct
import tarfile
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu.train import data as jdata
from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
_spec = importlib.util.spec_from_file_location("torch_jpeg_fixtures", os.path.join(HERE, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

with open(os.path.join(HERE, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(n for n, e in MANIFEST.items() if e["kind"] in ("ico", "cur", "ppm"))
RNG = np.random.default_rng(27)
RGBA = RNG.integers(0, 256, (48, 48, 4)).astype(np.uint8)


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _same(data: bytes) -> bool:
    """The port gives PIL's pixels, or both raise (the port ValueError, or a
    PNG entry's zlib / struct error, which the GenRef reader skips alike)."""
    want = _pil(data)
    try:
        got = tdata.decode_image(data)
    except (ValueError, zlib.error, struct.error):
        return isinstance(want, Exception)
    return not isinstance(want, Exception) and want.shape == got.shape and bool((want == got).all())


def _ico(mode: str, sizes, fmt: str, rgba=RGBA) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(rgba, "RGBA").convert(mode).save(buf, format="ICO", sizes=sizes, bitmap_format=fmt)
    return buf.getvalue()


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_is_pils_decode(name):
    with open(os.path.join(HERE, name), "rb") as f:
        data = f.read()
    entry = MANIFEST[name]
    assert fx.hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    assert fx.sha(tdata.decode_image(data)) == entry["decode_sha256"] == fx.sha(_pil(data))


@pytest.mark.parametrize("fmt", ["png", "bmp"])
@pytest.mark.parametrize("mode", ["RGBA", "RGB", "P", "L", "1"])
def test_ico_and_cur_as_pil(mode, fmt):
    data = _ico(mode, [(16, 16), (48, 48), (32, 32)], fmt)
    assert _same(data) and not isinstance(_pil(data), Exception)
    cur = bytearray(data)
    cur[2] = 2  # a CUR directory: PIL reads only a DIB there
    assert _same(bytes(cur))
    assert isinstance(_pil(bytes(cur)), Exception) == (fmt == "png")


def test_ico_picks_pils_entry():
    """Of two entries of one size PIL loads the lower colour depth, whatever
    their order; the largest size wins over both."""
    a, b = _ico("RGBA", [(32, 32)], "bmp"), _ico("P", [(32, 32)], "bmp")
    big = _ico("P", [(40, 40)], "bmp")
    for first, second in ((a, b), (b, a), (a, big)):
        e1, e2 = bytearray(first[6:22]), bytearray(second[6:22])
        struct.pack_into("<I", e1, 12, 38)
        struct.pack_into("<I", e2, 12, 38 + len(first) - 22)
        data = first[:4] + struct.pack("<H", 2) + bytes(e1) + bytes(e2) + first[22:] + second[22:]
        want = _pil(data)
        assert not isinstance(want, Exception)
        np.testing.assert_array_equal(tdata.decode_image(data), want)


def _plain(magic: bytes, w: int, h: int, values, maxval=None, sep=b" ") -> bytes:
    head = magic + b"\n# comment\n%d %d\n" % (w, h) + (b"%d\n" % maxval if maxval else b"")
    return head + sep.join(b"%d" % v for v in values)


@pytest.mark.parametrize("maxval", [1, 7, 100, 255, 256, 1000, 65535])
def test_ppm_every_magic_and_maxval(maxval):
    v = RNG.integers(0, maxval + 1, 9 * 7 * 4)
    samples = lambda n: bytes(v[:n].astype(np.uint8)) if maxval < 256 else v[:n].astype(">u2").tobytes()  # noqa: E731
    cases = [_plain(b"P3", 9, 7, v[:189], maxval), _plain(b"P2", 9, 7, v[:63], maxval, b"\n"),
             b"P6 9 7 %d\n" % maxval + samples(189), b"P5 9 7 %d\n" % maxval + samples(63)]
    for magic, bands in ((b"P0CMYK", 4), (b"PyCMYK", 4), (b"PyRGBA", 4), (b"PyP", 1)):
        cases.append(magic + b" 9 7 %d\n" % maxval + samples(63 * bands))
    for data in cases:
        assert not isinstance(_pil(data), Exception), data[:12]
        assert _same(data), data[:12]


def test_ppm_pil_writer_bitonal_float_and_header_quirks():
    img = RNG.integers(0, 256, (7, 9, 3)).astype(np.uint8)
    for im in (Image.fromarray(img), Image.fromarray(img).convert("L"), Image.fromarray(img).convert("1"),
               Image.fromarray(img[..., 0].astype(np.uint16) * 200),
               Image.fromarray(img[..., 0].astype(np.float32) * 1.3 - 20)):
        buf = io.BytesIO()
        im.save(buf, format="PPM")
        assert _same(buf.getvalue())
    floats = np.array([0, 1.5, 300, -2, 254.9, 7.7, np.nan, np.inf, -np.inf, 0.999], np.float32)
    cases = [_plain(b"P1", 9, 7, RNG.integers(0, 2, 63), sep=b""), b"P1 3 2\n1 0#x\n1\n0 1 1",
             b"P4 11 3\n" + bytes(RNG.integers(0, 256, 6).astype(np.uint8)),
             b"Pf 5 2 1.5\n" + floats.astype(">f4").tobytes(), b"Pf 5 2 -0.5e1\n" + floats.astype("<f4").tobytes(),
             b"P5 +9 1_0 2_5_5\n" + bytes(90),  # Python's int() tokens
             b"P2 2 1 100#x\n 50 1#c\n00",  # a comment inside a token joins its halves
             b"P5#c\n3#d\n 1 255\n\x01\x02\x03", b"P6 2 1 255 " + bytes(6),
             b"P5 2 1 0\n\x00\x00", b"P5 0 1 255\n", b"P2 2 1 5\n1 6", b"P2 2 1 5\n1 -1", b"P3 1 1 255\n1 2",
             b"P1 2 2\n1 2 0 1", b"Pf 1 1 0.0\n" + bytes(4), b"Pf 1 1 nan\n" + bytes(4), b"P5 12345678901 1 255\n"]
    for data in cases:
        assert _same(data), data[:24]


def test_pam_and_colour_pfm_are_refused_as_pil_refuses_them():
    for data in (b"P7\nWIDTH 2\nHEIGHT 1\nDEPTH 3\nMAXVAL 255\nTUPLTYPE RGB\nENDHDR\n" + bytes(6),
                 b"PF\n1 1\n-1.0\n" + bytes(12)):
        assert isinstance(_pil(data), Exception)
        with pytest.raises(ValueError, match="as PIL refuses it"):
            tdata.decode_image(data)


SWEPT = {
    "ico_1bit": lambda: _ico("1", [(16, 16), (8, 8)], "bmp"),
    "ico_p": lambda: _ico("P", [(8, 8), (16, 16)], "bmp", RGBA[:16, :16]),
    "ico_rgba32": lambda: _ico("RGBA", [(8, 8)], "bmp"),
    "ico_png_directory": lambda: _ico("RGB", [(8, 8), (16, 16)], "png"),
    "cur": lambda: b"\x00\x00\x02\x00" + _ico("P", [(8, 8), (16, 16)], "bmp", RGBA[:16, :16])[4:],
    "p3": lambda: b"P3\n# c\n4 3\n1000\n" + b" ".join(b"%d" % v for v in RNG.integers(0, 1001, 36)),
    "p2": lambda: b"P2 4 3 17\n" + b"\n".join(b"%d" % v for v in RNG.integers(0, 18, 12)),
    "p1": lambda: b"P1 5 3\n" + b"".join(b"%d" % v for v in RNG.integers(0, 2, 15)),
    "p6": lambda: b"P6 4 3 255\n" + bytes(RNG.integers(0, 256, 36).astype(np.uint8)),
    "p5_16": lambda: b"P5 4 3 4000\n" + RNG.integers(0, 4001, 12).astype(">u2").tobytes(),
    "p4": lambda: b"P4 11 3\n" + bytes(RNG.integers(0, 256, 6).astype(np.uint8)),
    "pf": lambda: b"Pf 3 2 -1\n" + RNG.normal(100, 90, 6).astype("<f4").tobytes(),
}


@pytest.mark.parametrize("name", sorted(SWEPT))
def test_damaged_bytes_match_pil(name):
    data = SWEPT[name]()
    span = len(data) if name != "ico_png_directory" else 6 + 16 * 2  # a PNG entry's body is decode_png's
    bad = [f"cut {n}" for n in range(1, span) if not _same(data[:n])]
    for pos in range(span):
        for x in (0x01, 0x80, 0xFF, 0x20):
            flipped = bytearray(data)
            flipped[pos] ^= x
            if not _same(bytes(flipped)):
                bad.append(f"xor {pos} {x:#x}")
    assert not bad, bad[:20]


def test_genref_members_of_jp2_ico_and_ppm_match_jax(tmp_path):
    """A GenRef tar whose image members hold JPEG 2000 (JP2 and J2K), ICO,
    CUR and PPM bytes under the .jpg / .png names: both packages' readers
    decode them by content, to the same samples; a P7 member is skipped by
    both."""
    with open(os.path.join(HERE, "j2k_pil_97_layers_67x45.jp2"), "rb") as f:
        jp2 = f.read()
    with open(os.path.join(HERE, "j2k_opj_sub420_41x27.j2k"), "rb") as f:
        j2k = f.read()
    ppm = b"P6 9 7 1000\n" + RNG.integers(0, 1001, 189).astype(">u2").tobytes()
    cur = b"\x00\x00\x02\x00" + _ico("P", [(16, 16)], "bmp")[4:]
    pairs = [(jp2, _ico("RGBA", [(32, 32)], "bmp")), (ppm, j2k), (_ico("RGB", [(24, 24)], "png"), cur),
             (jp2, b"P7\nWIDTH 1\n")]
    path = tmp_path / "shard.tar"
    with tarfile.open(path, "w") as tar:
        for i, (good, bad) in enumerate(pairs):
            files = {"good_image.jpg": good, "bad_image.png": bad, "prompt.txt": f"prompt {i}".encode(),
                     "reflection.txt": b"make it sharper", "subset.txt": b"general"}
            for field, data in files.items():
                info = tarfile.TarInfo(f"{i:04d}.{field}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    before = dict(image_io.calls)
    want, got = list(jdata.iter_tar_samples(str(path))), list(tdata.iter_tar_samples(str(path)))
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.good, a.good)
        np.testing.assert_array_equal(b.bad, a.bad)
        assert (b.prompt, b.reflection, b.subset) == (a.prompt, a.reflection, a.subset)
    for kind in ("decode_jpeg2000", "decode_ppm", "decode_dib"):
        assert image_io.calls[kind] > before.get(kind, 0), kind
