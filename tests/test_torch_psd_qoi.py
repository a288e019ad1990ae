"""The port's PSD reader (`utils/image_io.py::decode_psd`, `csrc/host/psd.cpp`)
and QOI reader (`decode_qoi`, `csrc/host/qoi.cpp`) against Pillow 12.1's
PsdImagePlugin and QoiImagePlugin and `convert("RGB")`, bit for bit.

Cases: the committed PSD and QOI fixtures; hand-written PSD files (PIL
writes none) in every PsdImagePlugin.MODES entry, raw and PackBits, with and
without image resources and a layer section, extra channels, a 4-channel
RGB (RGBA), LAB (its a / b planes sign-flipped as Pillow's band unpackers
store them) and CMYK; what PIL refuses (16 and 32 bits, ZIP compression,
too few channels, version 2) refused alike; PIL's QOI writer over RGB and
RGBA images, and hand-made QOI streams where Pillow's QoiDecoder differs
from the specification's (index slots never written, the unhashed start
pixel, runs past the end, other channel bytes, no end marker, data cut
short); damaged files, every cut and one byte XOR-ed with 0x01, 0x80, 0xFF
or 0x20 at every offset, where the port decodes PIL's pixels or raises
ValueError where PIL raises; a GenRef shard with TGA, PSD, QOI and DDS
members read alike by the JAX package and the port. About 10 s on one
core."""

import importlib.util
import io
import json
import os
import struct
import tarfile
import warnings

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
FIXTURES = sorted(n for n, e in MANIFEST.items() if e["kind"] in ("psd", "qoi"))
RNG = np.random.default_rng(13)
# (colour mode, bits) -> the channels PIL needs
PSD_MODES = {(0, 1): 1, (0, 8): 1, (1, 8): 1, (2, 8): 1, (3, 8): 3, (4, 8): 4, (7, 8): 1, (8, 8): 1, (9, 8): 3}


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _same(data: bytes, want=None) -> bool:
    """The port gives PIL's pixels, or both raise (the port ValueError)."""
    want = _pil(data) if want is None else want
    try:
        got = tdata.decode_image(data)
    except ValueError:
        return isinstance(want, Exception)
    return not isinstance(want, Exception) and want.shape == got.shape and bool((want == got).all())


def _planes(mode, bits: int, channels: int, w: int, h: int, rng, flat: bool = False):
    row = (w + 7) // 8 if bits == 1 else w
    planes = [rng.integers(0, 256, (h, row)).astype(np.uint8) for _ in range(channels)]
    if flat:  # runs for PackBits
        planes = [np.repeat(p[:, :1], row, 1) if i % 2 else p // 64 * 64 for i, p in enumerate(planes)]
    return planes


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_is_pils_decode(name):
    with open(os.path.join(HERE, name), "rb") as f:
        data = f.read()
    entry = MANIFEST[name]
    assert fx.hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    assert fx.sha(tdata.decode_image(data)) == entry["decode_sha256"] == fx.sha(_pil(data))


@pytest.mark.parametrize("mode", sorted(PSD_MODES), ids=lambda m: f"mode{m[0]}_{m[1]}bit")
def test_psd_every_mode_raw_and_packbits(mode):
    rng = np.random.default_rng(mode[0] * 10 + mode[1])
    for w, h in ((1, 1), (9, 4), (19, 13), (300, 2)):
        for extra in (0, 1, 2):
            planes = _planes(mode, mode[1], PSD_MODES[mode] + extra, w, h, rng, flat=extra == 1)
            palette = bytes(rng.integers(0, 256, 768).astype(np.uint8)) if mode[0] == 2 and extra != 2 else b""
            for compression in (0, 1):
                data = fx.write_psd(planes, (w, h), mode[0], mode[1], compression, palette, sections=extra != 0)
                want = _pil(data)
                # with extra channels PIL reads a byte-count table of only the channels it needs, so
                # its PackBits planes start too early: garbage, or data that ends too soon
                assert not isinstance(want, Exception) or (extra and compression), (w, h, extra, compression)
                assert _same(data, want), (w, h, extra, compression)


def test_psd_refusals_and_odd_sections():
    rng = np.random.default_rng(14)
    planes = _planes((3, 8), 8, 3, 5, 4, rng)
    base = fx.write_psd(planes, (5, 4), 3, 8, 0)
    cases = [fx.write_psd(planes, (5, 4), 3, 16, 0), fx.write_psd(planes, (5, 4), 3, 32, 0),  # no MODES key
             fx.write_psd(planes[:2], (5, 4), 3, 8, 0),  # too few channels
             base[:4] + b"\0\2" + base[6:]]  # version 2 (PSB)
    for compression in (2, 3):  # ZIP: no tile
        data = bytearray(fx.write_psd(planes, (5, 4), 3, 8, 0))
        data[26 + 12:26 + 14] = struct.pack(">H", compression)
        cases.append(bytes(data))
    for data in cases:
        assert isinstance(_pil(data), Exception)
        assert _same(data)
    # a resource entry that runs past its section, and a section of one odd-length entry
    head, body = base[:26], base[26 + 12:]
    for res in (b"8BIM" + struct.pack(">HB", 1, 0) + b"\0" + struct.pack(">I", 3) + b"abc\0",
                b"8BIM" + struct.pack(">HB", 1, 1) + b"x" + struct.pack(">I", 2) + b"ab"):
        for declared in (len(res), len(res) - 3, 1):
            data = head + struct.pack(">I", 0) + struct.pack(">I", declared) + res + struct.pack(">I", 0) + body
            assert _same(data), (res, declared)


def _qoi_head(w: int, h: int, channels: int = 3, colorspace: int = 0) -> bytes:
    return b"qoif" + struct.pack(">IIBB", w, h, channels, colorspace)


@pytest.mark.parametrize("mode", ["RGB", "RGBA"])
def test_qoi_pil_writer(mode):
    for w, h in ((1, 1), (5, 3), (64, 9), (37, 23)):
        rgba = RNG.integers(0, 256, (h, w, 4)).astype(np.uint8)
        rgba[:, : w // 2] = rgba[:, :1] // 32 * 32  # runs and repeated colours for the run and index ops
        rgba[1::2, :, 3] = 255
        buf = io.BytesIO()
        Image.fromarray(rgba, "RGBA").convert(mode).save(buf, format="QOI")
        assert _same(buf.getvalue())


def test_qoi_streams_where_pillow_differs_from_the_spec():
    cases = [
        _qoi_head(3, 1) + bytes([0x05, 0x3F, 0x00]),  # index slots never written: (0, 0, 0, 0)
        _qoi_head(2, 1) + bytes([0x35, 0x35]),  # index 53: the start pixel (0, 0, 0, 255) is not hashed
        _qoi_head(2, 2) + bytes([0xFE, 1, 2, 3, 0xFD]),  # a run of 62 past the image's end
        _qoi_head(2, 1, channels=7) + bytes([0xFF, 1, 2, 3, 4, 0x40]),  # other channel bytes: RGBA
        _qoi_head(2, 1, colorspace=9) + bytes([0x7F, 0xA5, 0x12]),  # diff, then luma; no end marker
        _qoi_head(3, 1) + bytes([0xFF, 9, 8, 7, 6, 0x00, 0x35]),  # an RGBA pixel, then index lookups
        _qoi_head(3, 1) + bytes([0xFE, 1, 2]),  # cut inside an op
        _qoi_head(3, 1) + bytes([0x80]),  # cut after a luma's first byte
        _qoi_head(3, 1) + bytes([0xC0]),  # the data ends before the image
        _qoi_head(0, 5), _qoi_head(3, 1)[:12],
    ]
    for data in cases:
        assert _same(data), data.hex()


SWEPT = {
    "psd_rgb_packbits": lambda: fx.write_psd(_planes((3, 8), 8, 4, 5, 3, np.random.default_rng(1), flat=True),
                                             (5, 3), 3, 8, 1, sections=True),
    "psd_cmyk_raw": lambda: fx.write_psd(_planes((4, 8), 8, 4, 4, 2, np.random.default_rng(2)), (4, 2), 4, 8, 0),
    "psd_p_bitmap": lambda: fx.write_psd(_planes((2, 8), 8, 1, 3, 2, np.random.default_rng(3)), (3, 2), 2, 8, 1,
                                         bytes(np.random.default_rng(3).integers(0, 256, 768).astype(np.uint8))),
    "qoi_rgba": lambda: open(os.path.join(HERE, "qoi_pil_rgba_37x23.qoi"), "rb").read()[:300],
    "qoi_rgb_small": lambda: _qoi_head(4, 3) + bytes([0xFE, 9, 8, 7, 0x41, 0x82, 0x67, 0xC2, 0x2A, 0xFF, 1, 2, 3, 4,
                                                      0x07, 0xC1]),
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


def test_genref_members_of_tga_psd_qoi_and_dds_match_jax(tmp_path):
    """A GenRef tar whose image members hold TGA, PSD, QOI and DDS bytes under
    the .jpg / .png names: both packages' readers decode them by content, to
    the same samples; a 16-bit PSD member is skipped by both."""
    def fixture(name):
        with open(os.path.join(HERE, name), "rb") as f:
            return f.read()

    psd16 = fx.write_psd(_planes((3, 8), 8, 3, 4, 4, np.random.default_rng(4)), (4, 4), 3, 16, 0)
    pairs = [(fixture("tga_pil_rgb_rle_19x13.tga"), fixture("psd_lab_rle_19x13.psd")),
             (fixture("qoi_pil_rgba_37x23.qoi"), fixture("dds_blocks_bc7_37x23.dds")),
             (fixture("dds_pil_dxt1_37x23.dds"), fixture("tga_cmap16_19x13.tga")),
             (fixture("psd_cmyk_raw_19x13.psd"), psd16)]
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
    for kind in ("decode_tga", "decode_psd", "decode_qoi", "decode_dds"):
        assert image_io.calls[kind] > before.get(kind, 0), kind
