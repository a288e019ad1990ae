"""The port's JPEG decoder (`utils/image_io.py::decode_jpeg`, C++ in
`csrc/host/image_io.cpp`) against PIL's `Image.open(...).convert("RGB")`,
bit for bit: chroma subsampling 4:4:4 / 4:2:2 / 4:2:0 and grey, qualities 50
to 100, optimized Huffman tables, restart intervals, sizes from 1x1 to
257x129 (edge MCUs, odd sizes). 12-bit and hierarchical files are refused
as PIL refuses them; arithmetic-coded and lossless files raise
`NotImplementedError` naming ROADMAP queue 1; truncated and corrupt files
raise `ValueError` and never crash. The committed fixtures of
`tests/data/torch_jpeg/` (JPEG of every kind the port reads, PNG of every
kind, and pixel arrays for the JPEG writer) decode, resize and encode to
their manifest's PIL hashes, and PIL itself gives those hashes from the
committed bytes. Progressive, CMYK and YCCK files and every PNG kind are
swept against PIL in `test_torch_image_files.py`. About 6 s."""

import hashlib
import io
import json
import os

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.train.data import decode_image
from reflectionflow_tpu_torch.utils import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SIZES = [(1, 1), (17, 9), (33, 65), (257, 129)]  # (W, H)


@pytest.fixture(scope="module", autouse=True)
def lib():
    return image_io.get_lib()


def _image(w, h, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    img = np.stack([128 + 90 * np.sin(xx / 7.0 + c) * np.cos(yy / 11.0 - c) for c in range(3)], -1)
    return np.clip(img + rng.normal(0, 12, img.shape), 0, 255).astype(np.uint8)


def _encode(img, **opts):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="JPEG", **opts)
    return buf.getvalue()


def _pil(data):
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def _sha(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_decode_matches_pil(subsampling, quality, size):
    data = _encode(_image(*size, seed=quality), quality=quality, subsampling=subsampling)
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("size", SIZES, ids=[f"{w}x{h}" for w, h in SIZES])
def test_grey_decodes_to_rgb_as_pil(size):
    data = _encode(_image(*size)[..., 1], quality=85)
    got = image_io.decode_jpeg(data)
    assert got.shape == (size[1], size[0], 3)
    np.testing.assert_array_equal(got, _pil(data))


@pytest.mark.parametrize("subsampling", [0, 1, 2], ids=["444", "422", "420"])
def test_optimized_huffman_tables(subsampling):
    data = _encode(_image(67, 45, seed=3), quality=90, subsampling=subsampling, optimize=True)
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


@pytest.mark.parametrize("opts", [{"restart_marker_blocks": 1}, {"restart_marker_blocks": 3},
                                  {"restart_marker_blocks": 7, "subsampling": 0},
                                  {"restart_marker_rows": 1}], ids=["blocks1", "blocks3", "blocks7_444", "rows1"])
def test_restart_intervals(opts):
    data = _encode(_image(129, 77, seed=4), quality=80, **opts)
    assert b"\xff\xdd" in data  # a DRI segment
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


def _frame_kind(kind: str) -> bytes:
    """A baseline PIL file made into another frame kind: precision 12 in its
    SOF0, or its SOF0 marker made SOF5 (hierarchical), SOF9 (arithmetic) or
    SOF3 (lossless, with the SOS's predictor 1 and Se 0)."""
    data = _encode(_image(32, 24))
    sof, sos = data.index(b"\xff\xc0"), data.index(b"\xff\xda")
    if kind == "12bit":
        return data[:sof + 4] + bytes([12]) + data[sof + 5:]
    marker = {"hierarchical": 0xC5, "arithmetic": 0xC9, "lossless": 0xC3}[kind]
    data = data[:sof + 1] + bytes([marker]) + data[sof + 2:]
    if kind == "lossless":
        at = sos + 4 + 1 + 2 * 3  # Ss, Se, AhAl after the three component selectors
        data = data[:at] + bytes([1, 0, 0]) + data[at + 3:]
    return data


# What PIL 12.1 (libjpeg-turbo 3.1) does with each: 12-bit files it
# cannot open, hierarchical ones libjpeg refuses, arithmetic-coded ones it
# decodes, and this lossless stream (Huffman data of a DCT file) it rejects.
_PIL_ON = {"12bit": "UnidentifiedImageError", "hierarchical": "OSError", "arithmetic": "decodes",
           "lossless": "OSError"}


@pytest.mark.parametrize("kind", sorted(_PIL_ON))
def test_unsupported_frames_raise(kind):
    data = _frame_kind(kind)
    try:
        Image.open(io.BytesIO(data)).convert("RGB")
        pil = "decodes"
    except Exception as e:  # noqa: BLE001 - recording what PIL raises
        pil = type(e).__name__
    assert pil == _PIL_ON[kind]
    match = "ROADMAP queue 1" if kind in ("arithmetic", "lossless") else "as PIL refuses it"
    with pytest.raises(NotImplementedError, match=match):
        image_io.decode_jpeg(data)


_VALID = _encode(_image(65, 33, seed=5), quality=75, restart_marker_blocks=2)


@pytest.mark.parametrize("frac", [0.0, 0.05, 0.1, 0.2, 0.35, 0.5, 0.65, 0.8, 0.95, 0.999])
def test_truncated_file_raises_value_error(frac):
    cut = int(frac * (len(_VALID) - 1))
    with pytest.raises(ValueError):
        image_io.decode_jpeg(_VALID[:cut])


def test_corrupt_bytes_raise_or_decode_never_crash():
    """Flipped bytes anywhere: ValueError, NotImplementedError or an image of
    the frame's size, never a crash or a read past the buffer."""
    rng = np.random.default_rng(0)
    for _ in range(300):
        data = bytearray(_VALID)
        for p in rng.integers(0, len(data), 3):
            data[p] = int(rng.integers(0, 256))
        try:
            out = image_io.decode_jpeg(bytes(data))
        except (ValueError, NotImplementedError):
            continue
        assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 3
    for data in (b"", b"\xff\xd8", b"\xff\xd8\xff", b"\xff\xd8\xff\xc0\x00\x02", b"not a jpeg"):
        with pytest.raises(ValueError):
            image_io.decode_jpeg(data)


def _chain(img, chain, resize):
    for step in chain.split(","):
        img = resize(img, tuple(int(v) for v in step.split("x")))
    return img


def _encode_pixels(entry):
    arr = np.load(os.path.join(FIXTURES, "encode_pixels.npz"))[entry["pixels"]]
    assert _sha(arr) == entry["pixels_sha256"]
    return arr


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_decodes_to_manifest(name):
    entry = MANIFEST[name]
    if entry["kind"] == "encode":
        got = image_io.encode_jpeg(_encode_pixels(entry))
        assert hashlib.sha256(got).hexdigest() == entry["jpeg_sha256"]
        return
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == entry["file_sha256"]
    if "raises" in entry:
        with pytest.raises(NotImplementedError, match="ROADMAP queue 1"):
            image_io.decode_jpeg(data)
        return
    img = decode_image(data)
    assert img.shape == (entry["size"][1], entry["size"][0], 3)
    assert _sha(img) == entry["decode_sha256"]
    for chain, want in entry.get("resize_sha256", {}).items():
        assert _sha(_chain(img, chain, image_io.resize_bicubic)) == want, chain


@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_manifest_is_pil(name):
    """PIL decodes and resizes the committed bytes to the manifest's hashes,
    and saves the committed pixel arrays to the writer's."""
    entry = MANIFEST[name]
    if entry["kind"] == "encode":
        buf = io.BytesIO()
        Image.fromarray(_encode_pixels(entry)).save(buf, format="JPEG")
        assert hashlib.sha256(buf.getvalue()).hexdigest() == entry["jpeg_sha256"]
        return
    with open(os.path.join(FIXTURES, name), "rb") as f:
        data = f.read()
    img = Image.open(io.BytesIO(data)).convert("RGB")
    if "raises" in entry:  # a cut progressive file: PIL decodes it, smoothing across blocks
        assert Image.open(io.BytesIO(data)).info.get("progressive")
        assert _sha(np.asarray(img)) == entry["pil_decode_sha256"]
        return
    assert _sha(np.asarray(img)) == entry["decode_sha256"]
    for chain, want in entry.get("resize_sha256", {}).items():
        assert _sha(np.asarray(_chain(img, chain, lambda im, s: im.resize(s)))) == want, chain
