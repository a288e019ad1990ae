"""The port's JPEG decoder (`utils/image_io.py::decode_jpeg`, C++ in
`csrc/host/image_io.cpp`) against PIL's `Image.open(...).convert("RGB")`,
bit for bit: chroma subsampling 4:4:4 / 4:2:2 / 4:2:0 and grey, qualities 50
to 100, optimized Huffman tables, restart intervals, sizes from 1x1 to
257x129 (edge MCUs, odd sizes). A file whose SOF marker is patched to
another frame kind decodes as PIL decodes it or raises where PIL raises
(12-bit, hierarchical and YCbCr-lossless files are refused with ValueError,
as PIL refuses them); truncated and corrupt files raise `ValueError` and
never crash. Files whose inverse DCT leaves the 16-bit / 8-bit range (every
quantizer set to q, baseline and progressive, 4:4:4 and 4:2:0; a Huffman
value flipped in a TIFF's JPEGTables) decode as PIL's libjpeg-turbo SIMD
IDCT computes them, on its SSE2 route as on its default one. The committed
fixtures of `tests/data/torch_jpeg/` (JPEG of
every kind the port reads, PNG, WebP and BMP of every kind, and pixel
arrays for the JPEG writer) decode, resize and encode to their manifest's
PIL hashes, and PIL itself gives those hashes from the committed bytes.
Progressive, CMYK, YCCK, arithmetic-coded and lossless files and every PNG
kind are swept against PIL in `test_torch_image_files.py`, WebP in
`test_torch_webp.py`, BMP in `test_torch_bmp.py`. About 8 s."""

import hashlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu_torch.train.data import decode_image
from reflectionflow_tpu_torch.utils import image_io

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)
SIZES = [(1, 1), (17, 9), (33, 65), (257, 129)]  # (W, H)
_spec = importlib.util.spec_from_file_location("torch_jpeg_fixtures", os.path.join(FIXTURES, "make_fixtures.py"))
fx = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fx)


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
# cannot open, hierarchical ones libjpeg refuses, this arithmetic-coded
# stream (Huffman data read by the QM decoder) it decodes, and this lossless
# stream (a JFIF file, so YCbCr, which libjpeg does not convert in lossless
# mode) it rejects.
_PIL_ON = {"12bit": "UnidentifiedImageError", "hierarchical": "OSError", "arithmetic": "decodes",
           "lossless": "OSError"}


@pytest.mark.parametrize("kind", sorted(_PIL_ON))
def test_unsupported_frames_raise(kind):
    """The port does what PIL does: PIL's pixels where it decodes, else
    ValueError "as PIL refuses it"."""
    data = _frame_kind(kind)
    try:
        want = _pil(data)
        pil = "decodes"
    except Exception as e:  # noqa: BLE001 - recording what PIL raises
        pil = type(e).__name__
    assert pil == _PIL_ON[kind]
    if pil == "decodes":
        np.testing.assert_array_equal(image_io.decode_jpeg(data), want)
    else:
        with pytest.raises(ValueError, match="as PIL refuses it"):
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


def _extreme(q: int, progressive: bool, subsampling: int) -> bytes:
    noise = np.random.default_rng(q).integers(0, 256, (64, 64, 3)).astype(np.uint8)
    return fx.set_dqt(_encode(noise, quality=100, progressive=progressive, subsampling=subsampling), q)


EXTREME = [(q, p, ss) for q in (8, 16, 32, 128, 255) for p in (False, True) for ss in (0, 2)]


@pytest.mark.parametrize("q,progressive,subsampling", EXTREME,
                         ids=[f"q{q}-{'prog' if p else 'base'}-{'444' if ss == 0 else '420'}" for q, p, ss in EXTREME])
def test_extreme_quantizers_decode_as_simd_idct(q, progressive, subsampling):
    """Noise at quality 100 with every quantizer made q: from q = 8 the
    dequantized coefficients overflow libjpeg-turbo's 16-bit IDCT lanes, and
    PIL's pixels are those of its SIMD arithmetic (jidctint-sse2.asm /
    -avx2.asm), which the port copies."""
    data = _extreme(q, progressive, subsampling)
    np.testing.assert_array_equal(image_io.decode_jpeg(data), _pil(data))


def test_huffman_value_flip_in_jpegtables_decodes_as_pil():
    """An AC Huffman value of a TIFF's JPEGTables made a wider size category:
    the strip's coefficients turn extreme (and the rest of the data is read
    as libjpeg reads damaged data); the port's pixels equal PIL's for each of
    the table's first 16 values (its shortest codes)."""
    tiff = bytearray(fx.write_tiff(fx.procedural(32, 16, 9), 6, compression=7, subsampling=(2, 2), quality=100))
    dht = tiff.index(b"\xff\xc4\x00\xb5\x10")  # the luma AC table: 16 counts, then 162 values
    changed = 0
    for k in range(dht + 5 + 16, dht + 5 + 16 + 16):
        bad = bytearray(tiff)
        bad[k] = (bad[k] & 0xF0) | 0x0A  # size 10: coefficients to +-1023 before the quantizers
        want = np.asarray(Image.open(io.BytesIO(bytes(bad))).convert("RGB"))
        got = image_io.decode_tiff(bytes(bad))
        np.testing.assert_array_equal(got, want, err_msg=f"value at {k}")
        changed += bool((got != np.asarray(Image.open(io.BytesIO(bytes(tiff))).convert("RGB"))).any())
    assert changed >= 8


def test_simd_reference_is_the_same_on_the_sse2_route():
    """PIL decodes the extreme files alike under JSIMD_FORCESSE2=1 (libjpeg-
    turbo's SSE2 IDCT) and on its default route (AVX2 where the CPU has it),
    so the reference does not hang on the test machine's vector unit."""
    names = [f"{q}-{p}-{ss}" for q, p, ss in EXTREME[::3]]
    code = ("import hashlib, io, sys, numpy as np; from PIL import Image\n"
            "sys.path.insert(0, sys.argv[1]); from test_torch_jpeg import _extreme, EXTREME\n"
            "for q, p, ss in EXTREME[::3]:\n"
            "    d = _extreme(q, p, ss)\n"
            "    print(hashlib.sha256(np.asarray(Image.open(io.BytesIO(d)).convert('RGB')).tobytes()).hexdigest())\n")
    env = dict(os.environ, JSIMD_FORCESSE2="1")
    out = subprocess.run([sys.executable, "-c", code, os.path.dirname(os.path.abspath(__file__))], env=env,
                         capture_output=True, text=True, check=True).stdout.split()
    assert len(out) == len(names)
    for (q, p, ss), sse2 in zip(EXTREME[::3], out):
        assert _sha(_pil(_extreme(q, p, ss))) == sse2, f"q={q} progressive={p} subsampling={ss}"


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
    img = decode_image(data)
    assert img.shape == (entry["size"][1], entry["size"][0], 3)
    assert _sha(img) == entry["decode_sha256"]
    if entry["kind"] == "webp":
        assert _sha(image_io.decode_webp(data)) == entry["rgba_sha256"]
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
    assert _sha(np.asarray(img)) == entry["decode_sha256"]
    if entry["kind"] == "webp":
        assert _sha(np.asarray(Image.open(io.BytesIO(data)).convert("RGBA"))) == entry["rgba_sha256"]
    for chain, want in entry.get("resize_sha256", {}).items():
        assert _sha(np.asarray(_chain(img, chain, lambda im, s: im.resize(s)))) == want, chain
