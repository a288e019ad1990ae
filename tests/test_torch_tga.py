"""The port's TGA reader (`utils/image_io.py::decode_tga`, `csrc/host/tga.cpp`)
and its format identification (`utils/image_identify.py::identify`, which
`train/data.py::decode_image` dispatches on) against Pillow 12.1's
TgaImagePlugin, `convert("RGB")` and `Image.open(...).format`, bit for bit.

Cases: the committed TGA fixtures; PIL's TGA writer over every mode, RLE on
and off, both orientations (PIL cannot read its own 1-bit RLE files: both
raise); a seeded sweep of hand-built files over the header's fields (image
types, depths, colour-map types, starts, lengths and depths, orientation
and flip bits, ID fields, run and literal packets, bodies cut short);
`identify` on every fixture of `tests/data/torch_jpeg/` and on a seeded
sweep of 18-byte headers over the TGA fields with random, zero and
text-like bodies, where both say None when `Image.open` raises; files the
plugins PIL tries before TGA open, pass on or refuse (PCX, GBR, FLI, MPEG,
ICO, CUR, AVIF, IM, IMT, IPTC, PCD, SPIDER); damaged files, every cut and
one byte XOR-ed with 0x01, 0x80, 0xFF or 0x20 at every offset, where the
port decodes PIL's pixels or raises ValueError where PIL raises. About 25 s
on one core."""

import importlib.util
import io
import json
import os
import struct
import warnings

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io
from reflectionflow_tpu_torch.utils.image_identify import identify

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
_spec = importlib.util.spec_from_file_location("torch_jpeg_fixtures", os.path.join(HERE, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

with open(os.path.join(HERE, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(n for n, e in MANIFEST.items() if e["kind"] == "tga")
IMAGE_FILES = sorted(n for n in os.listdir(HERE) if not n.endswith((".py", ".json", ".npz")))
RNG = np.random.default_rng(11)


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _pil_format(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Image.open(io.BytesIO(data)).format
    except Exception:  # noqa: BLE001 - Image.open raising: no format
        return None


def _same(data: bytes, want=None) -> bool:
    """The port gives PIL's pixels, or both raise (the port ValueError)."""
    want = _pil(data) if want is None else want
    try:
        got = tdata.decode_image(data)
    except ValueError:
        return isinstance(want, Exception)
    return not isinstance(want, Exception) and want.shape == got.shape and bool((want == got).all())


def _head(id_len=0, cmap_type=0, image_type=2, start=0, length=0, map_depth=0, w=4, h=3, depth=24, flags=0,
          origin=(0, 0)):
    return struct.pack("<BBBHHBHHHHBB", id_len, cmap_type, image_type, start, length, map_depth, *origin, w, h, depth,
                       flags)


def _save(img: Image.Image, **kw) -> bytes:
    buf = io.BytesIO()
    img.save(buf, format="TGA", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_is_pils_decode(name):
    with open(os.path.join(HERE, name), "rb") as f:
        data = f.read()
    entry = MANIFEST[name]
    assert fx.hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    assert identify(data) == "TGA"
    assert fx.sha(tdata.decode_image(data)) == entry["decode_sha256"] == fx.sha(_pil(data))


@pytest.mark.parametrize("mode", ["1", "L", "LA", "P", "RGB", "RGBA"])
def test_pil_writer_every_mode_rle_and_orientation(mode):
    for w, h in ((1, 1), (7, 5), (130, 3), (33, 17)):
        rgba = RNG.integers(0, 256, (h, w, 4)).astype(np.uint8)
        rgba[:, : w // 2] = rgba[:, :1]  # runs for the RLE packets, some past 128 pixels
        img = Image.fromarray(rgba, "RGBA")
        img = img.quantize(64) if mode == "P" else img.convert(mode)
        for rle in (False, True):
            for orientation in (-1, 1):
                data = _save(img, rle=rle, orientation=orientation)
                assert identify(data) == "TGA"
                assert isinstance(_pil(data), Exception) == (mode == "1" and rle)  # 0 bytes a pixel
                assert _same(data), (w, h, rle, orientation)


def test_header_fields_sweep_as_pil():
    """Hand-built files over every header field: what PIL decodes, the port
    decodes to the same pixels; what PIL refuses (a colour map on a 1, RGB or
    RGBA image, a 32-bit map, more than 256 entries, type 1 without a map, a
    run past its row, a short body), the port refuses."""
    rng = np.random.default_rng(12)
    for _ in range(6000):
        image_type = int(rng.choice([1, 2, 3, 9, 10, 11]))
        depth = int(rng.choice([1, 8, 16, 24, 32]))
        cmap_type, map_depth = int(rng.integers(0, 2)), int(rng.choice([16, 24, 32]))
        length, start = int(rng.integers(0, 20)), int(rng.choice([0, 0, 1, 5, 250]))
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        flags = int(rng.choice([0, 0x10, 0x20, 0x30])) | int(rng.integers(0, 16))
        id_len = int(rng.choice([0, 0, 3]))
        head = _head(id_len, cmap_type, image_type, start, length, map_depth, w, h, depth, flags)
        pre = bytes(rng.integers(0, 256, id_len + (length * map_depth // 8 if cmap_type else 0)).astype(np.uint8))
        if image_type & 8 and rng.random() < 0.8:  # run and literal packets
            px, body, n = depth // 8, b"", 0
            while n < w * h + 3:
                k = int(rng.integers(1, 6))
                if rng.random() < 0.5:
                    body += bytes([0x80 | (k - 1)]) + bytes(rng.integers(0, 256, px).astype(np.uint8))
                else:
                    body += bytes([k - 1]) + bytes(rng.integers(0, 256, px * k).astype(np.uint8))
                n += k
        else:
            body = bytes(rng.integers(0, 256, w * h * 4).astype(np.uint8))
        data = head + pre + body
        if rng.random() < 0.2:
            data = data[:int(rng.integers(18, len(data) + 1))]
        assert _same(data), head.hex()


def test_colour_maps_starts_depths_and_indices_past_the_map():
    idx = bytes([0, 1, 2, 3, 4, 255])
    for map_depth, entry in ((16, 2), (24, 3)):
        for start in (0, 1, 3):
            for length in (0, 2, 4):
                pal = bytes(RNG.integers(0, 256, entry * length).astype(np.uint8))
                for image_type, depth in ((1, 8), (9, 8), (3, 8), (3, 16)):
                    body = idx if image_type != 9 else bytes([0x05]) + idx
                    body = body if depth == 8 else bytes(b for i in idx for b in (i, 200))
                    data = _head(0, 1, image_type, start, length, map_depth, 6, 1, depth) + pal + body
                    want = _pil(data)
                    assert not isinstance(want, Exception), (map_depth, start, length, image_type)
                    assert _same(data, want)
    for image_type, depth in ((2, 24), (3, 1), (1, 8)):  # a map PIL cannot put on the mode, or a 32-bit one
        data = _head(0, 1, image_type, 0, 2, 32 if image_type == 1 else 24, 2, 1, depth) + bytes(8) + bytes(8)
        assert isinstance(_pil(data), Exception) and _same(data)


def test_identify_every_fixture_as_pil():
    """Every image file of tests/data/torch_jpeg/: `identify` names PIL's
    format."""
    for name in IMAGE_FILES:
        with open(os.path.join(HERE, name), "rb") as f:
            data = f.read()
        assert identify(data) == _pil_format(data), name


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_identify_tga_header_sweep_as_pil(seed):
    """Seeded 18-byte headers over the TGA fields (values TGA takes, values
    other plugins' signatures use, and random bytes), with random, zero and
    text-like bodies: `identify` equals `Image.open(...).format`, None where
    it raises; `decode_image` gives PIL's pixels or raises where PIL does."""
    rng = np.random.default_rng(100 + seed)
    formats = set()
    for t in range(4000):
        def pick(choices, hi):
            return int(rng.choice(choices)) if rng.random() < 0.7 else int(rng.integers(0, hi))
        head = _head(pick([0, 0, 10, 13, 26, 28, 32, 42, 65], 256), pick([0, 1], 256),
                     pick([1, 2, 3, 9, 10, 11, 0], 256), pick([0, 1, 2, 0x1100, 0xb3, 0xc800], 65536),
                     pick([0, 2, 16, 256, 0xaf, 0xaf11], 65536), pick([16, 24, 32, 15, 1, 2], 256),
                     pick([1, 2, 5, 0], 65536), pick([1, 3, 7, 0], 65536), pick([1, 8, 16, 24, 32, 15], 256),
                     int(rng.integers(0, 256)), (pick([0, 5], 65536), pick([0, 3], 65536)))
        body = (bytes(rng.integers(0, 256, int(rng.integers(0, 200))).astype(np.uint8)) if t % 3 == 0 else
                bytes(int(rng.integers(0, 300))) if t % 3 == 1 else
                b"\n" * 3 + bytes(rng.integers(0, 256, 50).astype(np.uint8)))
        data = head + body
        want = _pil_format(data)
        formats.add(want)
        assert identify(data) == want, (head.hex(), len(body))
        if want == "TGA" and t % 5 == 0:
            assert _same(data), head.hex()
    assert "TGA" in formats and None in formats


def _plugin_cases():
    """Files on which a plugin PIL tries before TGA decides: it opens them,
    passes them on (to TGA, or to nothing) or ends the open."""
    tga = _head(0, 0, 3, 0, 0, 0, 4, 3, 8) + bytes(range(12))
    cases = {
        "pcx_passes_to_tga": _head(10, 0, 3, 0, 0, 0, 4, 3, 8) + bytes(12),  # bad PCX box: TGA
        "pcx_refuses": _head(10, 0, 3, 0, 0, 0, 4, 3, 8, origin=(5, 5)) + bytes(100),  # a box, but no PCX mode
        "pcx_opens": bytes([10, 0, 3, 1]) + struct.pack("<4H", 0, 0, 3, 2) + bytes(53) + bytes([1]) + bytes(70),
        "ico_empty_to_tga": b"\0\0\1\0\0\0" + bytes(6) + struct.pack("<HH", 4, 3) + bytes([8, 0]) + bytes(12),
        "ico_offset_past_end_to_tga": b"\0\0\1\0\1\0" + bytes([4, 4, 0, 0, 1, 0, 8, 0])
                                      + struct.pack("<II", 0x80028, 9999) + bytes(40),
        "cur_no_entries": b"\0\0\2\0\0\0" + bytes(6) + struct.pack("<HH", 4, 3) + bytes([24, 0]) + bytes(36),
        "mpeg": b"\0\0\1\xb3" + bytes([0x01, 0x00, 0x20]) + bytes(20),
        "mpeg_no_size_to_tga": _head(0, 0, 1, 0xb3, 0, 0, 4, 3, 8) + bytes(12),
        "gbr": struct.pack(">5I", 28, 2, 3, 2, 1) + b"GIMP" + struct.pack(">I", 10) + bytes(6),
        "fli": struct.pack("<IHHHH", 0, 0xAF12, 1, 3, 2) + bytes(116) + struct.pack("<IH", 16, 0xF1FA) + bytes(10),
        "avif_ftyp_in_a_tga_header": _head(0, 0, 2, 0, 0, 0, 2, 1, 24)[:4] + b"ftypavif" + _head(w=2, h=1)[12:]
                                     + bytes(6),
        "im": b"Image type: L image\r\nImage size (x*y): 3*2\r\n\x1a" + bytes(6),
        "im_bad_size": b"Image size (x*y): a*b\n\x1a",
        "imt": b"width 3\nheight 2\npixel n8\n\x0c" + bytes(6),
        "imt_bad_width": b"width x\n\x0c",
        "iptc_bad_length": bytes([0x1C, 1, 2, 200, 0]) + tga[5:],
        "iptc_passes_to_tga": _head(0x1C, 1, 3, 0, 0, 24, 4, 3, 8) + bytes(12),
        "pcd": bytes(2048) + b"PCD_" + bytes(1600),
        "spider": struct.pack(">27f", *([0, 3, 0, 0, 1] + [0] * 6 + [4, 1] + [0] * 8 + [4, 4] + [0] * 4)) + bytes(64),
        "tga": tga,
    }
    return cases


@pytest.mark.parametrize("case", sorted(_plugin_cases()))
def test_plugins_before_tga_decide_as_in_pil(case):
    data = _plugin_cases()[case]
    want = _pil_format(data)
    assert identify(data) == want, case
    if want in (None, "TGA", "ICO", "CUR"):
        assert _same(data), case
    else:  # a format the port does not read: named, with its queue entry
        with pytest.raises(ValueError, match=f"{want} images are not read by the port yet"):
            tdata.decode_image(data)


SWEPT = {
    "tga_rle_rgba": lambda: _save(Image.fromarray(np.repeat(RNG.integers(0, 256, (3, 2, 4)), 3, 1).astype(np.uint8),
                                                  "RGBA"), rle=True),
    "tga_p_topdown": lambda: _save(Image.fromarray(RNG.integers(0, 256, (3, 5, 3)).astype(np.uint8)).quantize(6),
                                   orientation=1),
    "tga_la_rle": lambda: _save(Image.fromarray(RNG.integers(0, 256, (3, 4, 3)).astype(np.uint8)).convert("LA"),
                                rle=True),
    "tga_cmap16_start3_rle": lambda: open(os.path.join(HERE, "tga_cmap16_start3_rle_19x13.tga"), "rb").read(),
}


@pytest.mark.parametrize("name", sorted(SWEPT))
def test_damaged_bytes_match_pil(name):
    data = SWEPT[name]()
    bad = [f"cut {n}" for n in range(1, len(data)) if not _same(data[:n])]
    for pos in range(len(data)):
        for x in (0x01, 0x80, 0xFF, 0x20):
            flipped = bytearray(data)
            flipped[pos] ^= x
            if not _same(bytes(flipped)):
                bad.append(f"xor {pos} {x:#x}")
    assert not bad, bad[:20]


def test_decode_tga_refuses_what_is_no_tga():
    for data in (b"", _head()[:17], _head(cmap_type=2), _head(image_type=4), _head(depth=15), _head(w=0),
                 _head(cmap_type=1, map_depth=15) + bytes(40)):
        assert isinstance(_pil(data), Exception)
        with pytest.raises(ValueError):
            image_io.decode_tga(data)
