"""The port's DDS reader (`utils/image_io.py::decode_dds`, `csrc/host/dds.cpp`
over `bcn_tables.h`) against Pillow 12.1's DdsImagePlugin, its BcnDecode.c
and `convert("RGB")`, bit for bit.

Cases: the committed DDS fixtures; the BC7 partition and anchor tables
derived again from PIL (`tests/data/torch_jpeg/make_bcn_tables.py`) against
the committed header; blocks numpy draws for every BCn kind (DXT1/3/5, BC1-5
in DX10 headers, BC4U / ATI1, BC5U / ATI2, BC5S and BC5_SNORM, BC6H UF16 and
SF16 in each of its 14 modes, thinned so that their halves stay in range
too, BC7 in each of its 8 modes) at sizes that are not a multiple of 4;
PIL's DDS writer over its modes and BCn encoders; uncompressed files over
the bit-mask decoder (any masks and bit counts, data cut short), L, LA, P8
and DX10 R8G8B8A8; what DdsImageFile._open refuses (a header size, a FourCC,
a DXGI format, luminance bits, no pixel-format flag) refused alike; phase
5e's 1024x768 BC7 timing file, made again from its seed, to the hashes in
`generated.json`; damaged files, every cut and one byte XOR-ed with 0x01,
0x80, 0xFF or 0x20 at every offset, where the port decodes PIL's pixels or
raises ValueError where PIL raises (BCn, L, LA, P8 and R8G8B8A8 files; not
a bit-mask file, whose flipped size bytes ask PIL's pure-Python
DdsRgbDecoder for millions of pixels, minutes each). About 10 s on one
core."""

import hashlib
import importlib.util
import io
import json
import os
import warnings

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")


def _load(name: str, path: str):
    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


fx = _load("torch_jpeg_fixtures", "make_fixtures.py")
tables = _load("torch_jpeg_bcn_tables", "make_bcn_tables.py")
with open(os.path.join(HERE, "manifest.json")) as f:
    MANIFEST = json.load(f)
FIXTURES = sorted(n for n, e in MANIFEST.items() if e["kind"] == "dds")
# name -> (FourCC, DXGI format, block bytes)
BCN = {"DXT1": (b"DXT1", None, 8), "DXT3": (b"DXT3", None, 16), "DXT5": (b"DXT5", None, 16),
       "BC4U": (b"BC4U", None, 8), "ATI1": (b"ATI1", None, 8), "BC5U": (b"BC5U", None, 16),
       "ATI2": (b"ATI2", None, 16), "BC5S": (b"BC5S", None, 16), "BC1": (b"DX10", 71, 8),
       "BC2": (b"DX10", 74, 16), "BC3": (b"DX10", 77, 16), "BC4": (b"DX10", 80, 8), "BC5": (b"DX10", 83, 16),
       "BC5_SNORM": (b"DX10", 84, 16), "BC6H_UF16": (b"DX10", 95, 16), "BC6H_SF16": (b"DX10", 96, 16),
       "BC7": (b"DX10", 98, 16)}
# BC6H's 14 mode codes (its first 2 or 5 bits) in BcnDecode.c's order, and 4 reserved ones
BC6_MODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27, 31)


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


def _bcn(name: str, size, blocks: np.ndarray) -> bytes:
    fourcc, dxgi, _ = BCN[name]
    return fx.write_dds(size, 0x4, fourcc, dxgi=dxgi, body=blocks.tobytes())


@pytest.mark.parametrize("name", FIXTURES)
def test_fixture_is_pils_decode(name):
    with open(os.path.join(HERE, name), "rb") as f:
        data = f.read()
    entry = MANIFEST[name]
    assert fx.hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    assert fx.sha(tdata.decode_image(data)) == entry["decode_sha256"] == fx.sha(_pil(data))


def test_bcn_tables_header_is_pils():
    with open(tables.HEADER) as f:
        assert f.read() == tables.derive()


@pytest.mark.parametrize("name", sorted(BCN))
def test_random_blocks_as_pil(name):
    """Each kind's blocks at 1x1 to 37x23: one file of every size, decoded
    whole, so that every block is held to PIL's."""
    _, _, block = BCN[name]
    rng = np.random.default_rng(sum(name.encode()))
    for w, h in ((1, 1), (3, 5), (4, 4), (37, 23), (64, 16)):
        n = ((w + 3) // 4) * ((h + 3) // 4)
        for thin in (False, True):
            blocks = rng.integers(0, 256, (n, block)).astype(np.uint8)
            if thin:  # small values: BC6H endpoints in range, BC1-BC5 ramps near their ends
                blocks &= rng.integers(0, 256, (n, block)).astype(np.uint8) & rng.integers(0, 256, (n, block)).astype(
                    np.uint8)
            if name.startswith("BC6H"):
                codes = np.asarray(BC6_MODES)[rng.integers(0, len(BC6_MODES), n)]
                blocks[:, 0] = np.where(codes < 2, (blocks[:, 0] & 0xFC) | codes, (blocks[:, 0] & 0xE0) | codes)
            if name == "BC7":
                blocks = fx.bc_blocks(n, 16, int(rng.integers(0, 2**31)), "bc7", thin)
            data = _bcn(name, (w, h), blocks)
            want = _pil(data)
            assert not isinstance(want, Exception), (name, w, h)
            assert _same(data, want), (name, w, h, thin)


@pytest.mark.parametrize("signed", [False, True], ids=["UF16", "SF16"])
def test_bc6h_every_mode(signed):
    """Many blocks of each BC6H mode in one file each, full range and thinned."""
    rng = np.random.default_rng(60 + signed)
    for code in BC6_MODES:
        for thin in range(3):
            blocks = rng.integers(0, 256, (64, 16)).astype(np.uint8)
            for _ in range(thin):
                blocks &= rng.integers(0, 256, (64, 16)).astype(np.uint8)
            blocks[:, 0] = (blocks[:, 0] & 0xFC) | code if code < 2 else (blocks[:, 0] & 0xE0) | code
            data = _bcn("BC6H_SF16" if signed else "BC6H_UF16", (64, 16), blocks)
            assert _same(data), (code, thin)


def test_bc7_every_mode_and_the_blocks_without_one():
    rng = np.random.default_rng(70)
    for mode in range(8):
        blocks = rng.integers(0, 256, (128, 16)).astype(np.uint8)
        blocks[:, 0] = (blocks[:, 0] & np.uint8(0xFF & ~((2 << mode) - 1))) | np.uint8(1 << mode)
        assert _same(_bcn("BC7", (64, 32), blocks)), mode
    blocks = rng.integers(0, 256, (4, 16)).astype(np.uint8)
    blocks[:, 0] = 0  # no mode bit
    assert _same(_bcn("BC7", (8, 8), blocks))


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA"])
def test_pil_writer(mode):
    rng = np.random.default_rng(80)
    rgba = rng.integers(0, 256, (13, 22, 4)).astype(np.uint8)
    img = Image.fromarray(rgba, "RGBA").convert(mode)
    formats = [None] + (["DXT1", "DXT3", "DXT5", "BC2", "BC3"] if mode == "RGBA" else
                        ["DXT1", "BC5"] if mode == "RGB" else [])
    for pixel_format in formats:
        buf = io.BytesIO()
        img.save(buf, format="DDS", **({"pixel_format": pixel_format} if pixel_format else {}))
        assert _same(buf.getvalue()), pixel_format


def test_uncompressed_masks_luminance_palette_and_rgba8():
    rng = np.random.default_rng(90)
    masks = [0, 0xFF, 0xFF00, 0xFF0000, 0xFF000000, 0x7C00, 0x3E0, 0x1F, 0xF800, 0x7E0, 0b101, 0xF0F0, 0x80000000]
    for t in range(300):
        w, h = int(rng.integers(1, 9)), int(rng.integers(1, 6))
        body = bytes(rng.integers(0, 256, int(rng.integers(0, w * h * 6))).astype(np.uint8))
        kind = t % 4
        if kind == 0:  # DdsRgbDecoder: any masks, bit counts that are not a byte multiple, data cut short
            pick = [int(rng.choice(masks)) if rng.random() < 0.8 else int(rng.integers(0, 2**32)) for _ in range(4)]
            data = fx.write_dds((w, h), 0x40 | int(rng.integers(0, 2)), bitcount=int(rng.choice([0, 8, 12, 16, 24, 32,
                                                                                                 40])),
                                masks=pick, body=body)
        elif kind == 1:
            data = fx.write_dds((w, h), 0x20000 | int(rng.integers(0, 2)), bitcount=int(rng.choice([8, 16, 24])),
                                body=body)
        elif kind == 2:
            data = fx.write_dds((w, h), 0x20, bitcount=8, body=bytes(rng.integers(0, 256, 1024).astype(np.uint8))
                                + body)
        else:
            data = fx.write_dds((w, h), 0x4, b"DX10", dxgi=int(rng.choice([27, 28, 29])), body=body)
        assert _same(data), (t, kind)


def test_refusals_as_pil():
    rgba8 = fx.write_dds((2, 2), 0x4, b"DX10", dxgi=28, body=bytes(16))
    cases = [rgba8[:4] + b"\x7d\0\0\0" + rgba8[8:],  # header size 124 only
             rgba8[:100],  # a header cut short
             fx.write_dds((2, 2), 0x4, b"DXT2", body=bytes(16)), fx.write_dds((2, 2), 0x4, b"DXT4", body=bytes(16)),
             fx.write_dds((2, 2), 0x4, b"DX10", dxgi=72, body=bytes(16)),  # BC1_UNORM_SRGB
             fx.write_dds((2, 2), 0x4, b"DX10", dxgi=2, body=bytes(64)),
             fx.write_dds((2, 2), 0x20000, bitcount=24, body=bytes(12)),
             fx.write_dds((2, 2), 0x2, body=bytes(16)),  # no flag PIL reads
             fx.write_dds((0, 2), 0x4, b"DXT1", body=bytes(8)), b"DDS ", b"DDS \x7c\0"]
    for data in cases:
        assert isinstance(_pil(data), Exception), data[:12]
        assert _same(data)
    with pytest.raises(ValueError, match="as PIL refuses it"):
        image_io.decode_dds(fx.write_dds((2, 2), 0x4, b"DXT2", body=bytes(16)))


def test_phase_5e_timing_file_is_pils():
    with open(os.path.join(HERE, "generated.json")) as f:
        entry = json.load(f)[fx.DDS_TIMING[0]]
    data = fx.dds_timing_file()
    assert hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    assert fx.sha(image_io.decode_dds(data)) == entry["decode_sha256"] == fx.sha(_pil(data))


SWEPT = {
    "dxt1_5x3": lambda: _bcn("DXT1", (5, 3), np.random.default_rng(1).integers(0, 256, (2, 8)).astype(np.uint8)),
    "bc7_4x4": lambda: _bcn("BC7", (4, 4), fx.bc_blocks(1, 16, 2, "bc7")),
    "bc6h_sf16_4x4": lambda: _bcn("BC6H_SF16", (4, 4), np.random.default_rng(3).integers(0, 256, (1, 16)).astype(
        np.uint8)),
    "bc5s_4x4": lambda: _bcn("BC5S", (4, 4), np.random.default_rng(4).integers(0, 256, (1, 16)).astype(np.uint8)),
    "l_3x2": lambda: fx.write_dds((3, 2), 0x20000, bitcount=8, body=bytes(range(6))),
    "la_2x2": lambda: fx.write_dds((2, 2), 0x20001, bitcount=16, body=bytes(range(8))),
    "rgba8_dx10_2x2": lambda: fx.write_dds((2, 2), 0x4, b"DX10", dxgi=28, body=bytes(range(16))),
    "p8_2x2": lambda: fx.write_dds((2, 2), 0x20, bitcount=8, body=bytes(range(256)) * 4 + bytes([1, 2, 3, 4])),
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
