"""The port's JPEG 2000 decoder (`utils/image_io.py::decode_jpeg2000`, C++ in
`csrc/host/jpeg2000.cpp`) against Pillow 12.1 reading through OpenJPEG 2.5.4
and `convert("RGB")`, bit for bit.

Cases: the committed fixtures (PIL-written JP2 and J2K files; files from
OpenJPEG's own encoder with every code-block style, SOP / EPH, POC, RGN,
tile-parts and TLM, packet headers moved into PPM or PPT, sub-sampled
components, sYCC, CMYK, a palette, bpcc, an ICC colour box), PIL's writer over
its options (modes L, LA, RGB, RGBA and I;16, reversible and irreversible,
`mct`, tiles and offsets, precincts, code-blocks, the five progressions,
quality layers in rates and dB, resolutions, PLT, signed), OpenJPEG's encoder
over the code-block styles with truncated rate layers, and damaged files:
every cut and single flipped bytes (three patterns at every offset) of small
files, where the port decodes PIL's pixels or raises ValueError where PIL
raises, with no offset class exempt. HTJ2K and the other features no fixture
covers raise citing ROADMAP queue 1 entry 8b. About 35 s on one core."""

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

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
_spec = importlib.util.spec_from_file_location("torch_jpeg_fixtures", os.path.join(HERE, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)

with open(os.path.join(HERE, "manifest.json")) as f:
    MANIFEST = json.load(f)
J2K_FIXTURES = sorted(n for n, e in MANIFEST.items() if e["kind"] == "jpeg2000")
RGB = fx.procedural(37, 23, 26)

# PIL's JPEG 2000 writer over its options: (mode, size, save options)
PIL_CASES = [
    ("RGB", (67, 45), {}), ("L", (33, 17), {}), ("LA", (33, 17), {}), ("RGBA", (33, 17), {}),
    ("I;16", (33, 17), {}), ("RGB", (67, 45), {"irreversible": True}), ("RGB", (67, 45), {"mct": 0}),
    ("RGB", (67, 45), {"irreversible": True, "quality_layers": [40, 20, 10], "quality_mode": "rates"}),
    ("L", (67, 45), {"irreversible": True, "quality_layers": [30, 35], "quality_mode": "dB"}),
    ("RGB", (67, 45), {"tile_size": (32, 32)}),
    ("RGB", (67, 45), {"tile_size": (20, 16), "tile_offset": (5, 7), "offset": (9, 11)}),
    ("RGB", (67, 45), {"progression": "RPCL", "precinct_size": (32, 32), "codeblock_size": (16, 16)}),
    ("RGB", (67, 45), {"progression": "PCRL", "quality_layers": [20, 5], "quality_mode": "rates"}),
    ("RGB", (67, 45), {"progression": "CPRL", "irreversible": True}),
    ("RGB", (67, 45), {"progression": "RLCP", "quality_layers": [30, 10], "quality_mode": "rates"}),
    ("RGB", (67, 45), {"num_resolutions": 1}), ("RGB", (67, 45), {"num_resolutions": 2, "plt": True}),
    ("L", (33, 17), {"signed": True}), ("RGB", (1, 1), {}), ("L", (5, 300), {"irreversible": True}),
]

# OpenJPEG's encoder over the code-block styles: (mode bits, irreversible, rates)
STYLE_CASES = [(m, irr, rates) for m in (1, 2, 4, 8, 16, 32, 1 | 4, 1 | 2 | 8 | 16 | 32, 63)
               for irr, rates in ((False, ()), (True, (30, 10, 5)))]

# small files swept for damage: every cut, 3 bit patterns at every byte
SWEPT = ["j2k_pil_l_signed_33x17.j2k", "j2k_pil_97_layers_67x45.jp2", "j2k_opj_all_styles_roi_poc_41x27.j2k",
         "j2k_opj_palette_41x27.jp2", "j2k_opj_rgn_97_41x27.j2k", "j2k_opj_ppm_41x27.j2k",
         "j2k_opj_sub420_41x27.j2k", "j2k_opj_ppt_tiles_41x27.j2k", "j2k_opj_sycc420_40x26.jp2"]


def _pil(data: bytes):
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
    except Exception as e:  # noqa: BLE001 - what PIL raises is the truth
        return e


def _port(data: bytes):
    try:
        return image_io.decode_jpeg2000(data)
    except ValueError as e:
        return e


def _same(data: bytes) -> bool:
    """The port gives PIL's pixels, or both raise (the port ValueError)."""
    want, got = _pil(data), _port(data)
    if isinstance(want, Exception) or isinstance(got, Exception):
        return isinstance(want, Exception) and isinstance(got, Exception)
    return want.shape == got.shape and bool((want == got).all())


def _read(name: str) -> bytes:
    with open(os.path.join(HERE, name), "rb") as f:
        return f.read()


@pytest.mark.parametrize("name", J2K_FIXTURES)
def test_fixture_is_pils_decode(name):
    data = _read(name)
    entry = MANIFEST[name]
    assert fx.hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    got = tdata.decode_image(data)
    assert list(got.shape[1::-1]) == entry["size"] or entry["writer"] == "opj"
    assert fx.sha(got) == entry["decode_sha256"] == fx.sha(_pil(data))


@pytest.mark.parametrize("no_jp2", [False, True])
@pytest.mark.parametrize("case", range(len(PIL_CASES)))
def test_pil_writer_options(case, no_jp2):
    mode, (w, h), opts = PIL_CASES[case]
    rgb = fx.procedural(w, h, 700 + case)
    img = Image.fromarray(rgb[..., 0].astype(np.uint16) * 257) if mode == "I;16" else Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="JPEG2000", no_jp2=no_jp2, **opts)
    want = _pil(buf.getvalue())
    assert not isinstance(want, Exception)
    np.testing.assert_array_equal(image_io.decode_jpeg2000(buf.getvalue()), want)


@pytest.mark.parametrize("mode,irreversible,rates", STYLE_CASES)
def test_openjpeg_code_block_styles(mode, irreversible, rates):
    """Every code-block style, alone and together, reversible and with
    truncated 9/7 rate layers (the MQ decoder past a segment's end, the
    mid-point reconstruction of partly decoded coefficients)."""
    a = RGB.astype(np.int64)
    data = fx.opj_encode([a[..., i] for i in range(3)], mode=mode, irreversible=irreversible, rates=rates, mct=1,
                         cblk=(16, 8))
    want = _pil(data)
    assert not isinstance(want, Exception)
    np.testing.assert_array_equal(image_io.decode_jpeg2000(data), want)


@pytest.mark.parametrize("name", SWEPT)
def test_damaged_bytes_match_pil(name):
    """Cut anywhere, or one byte XOR-ed with 0x01, 0x80 or 0xFF at every
    offset (markers, box and segment lengths, packet headers, code-block
    data): the port decodes PIL's pixels or raises where PIL raises."""
    data = _read(name)
    bad = [f"cut {n}" for n in range(1, len(data)) if not _same(data[:n])]
    for pos in range(len(data)):
        for x in (0x01, 0x80, 0xFF):
            flipped = bytearray(data)
            flipped[pos] ^= x
            if not _same(bytes(flipped)):
                bad.append(f"xor {pos} {x:#x}")
    assert not bad, bad[:20]


def _cod_style(cs: bytes, bits: int) -> bytes:
    """The codestream with COD's code-block style byte OR-ed with `bits`."""
    at = cs.index(b"\xff\x52")
    return cs[:at + 12] + bytes([cs[at + 12] | bits]) + cs[at + 13:]


def test_htj2k_and_unfixtured_features_cite_queue_8b():
    buf = io.BytesIO()
    Image.fromarray(RGB).save(buf, format="JPEG2000", no_jp2=True)
    cs = buf.getvalue()
    with pytest.raises(ValueError, match="ROADMAP queue 1 entry 8b"):  # HT code-blocks (COD style bit 6)
        image_io.decode_jpeg2000(_cod_style(cs, 0x40))
    siz_end = 4 + struct.unpack(">H", cs[4:6])[0]
    cap = b"\xff\x50" + struct.pack(">HI", 8, 1 << 14) + b"\x00\x00"  # CAP: Part 15
    with pytest.raises(ValueError, match="ROADMAP queue 1 entry 8b"):
        image_io.decode_jpeg2000(cs[:siz_end] + cap + cs[siz_end:])
    mixed = _cod_style(cs, 0xC0)  # HT mixed code-blocks: OpenJPEG refuses them
    assert isinstance(_pil(mixed), Exception)
    with pytest.raises(ValueError, match="as PIL refuses it"):
        image_io.decode_jpeg2000(mixed)


def test_decode_image_dispatches_jp2_and_j2k():
    before = image_io.calls["decode_jpeg2000"]
    for no_jp2 in (False, True):
        buf = io.BytesIO()
        Image.fromarray(RGB).save(buf, format="JPEG2000", no_jp2=no_jp2)
        np.testing.assert_array_equal(tdata.decode_image(buf.getvalue()), RGB)  # lossless
    assert image_io.calls["decode_jpeg2000"] == before + 2
