"""The port's WebP decoder (`utils/image_io.py::decode_webp`, C++ in
`csrc/host/webp.cpp`) and `train/data.py::decode_image`'s dispatch by
content, against PIL 12.1 (libwebp 1.6) and the JAX package.

Every case decodes to PIL's pixels bit for bit: lossy files at qualities
5-100 and methods 0-6 (segments, loop filters, 4x4 and 16x16 intra modes,
odd sizes that crop the macroblocks), lossless files at methods 0-6
(predictor, cross-colour, subtract-green and colour-indexing transforms with
pixel bundling, the colour cache, LZ77), alpha (raw or lossless ALPH under
its filters, compared as RGBA) and the first frame of an animation. The
JAX package's `load_image`, frame-directory reader and GenRef reader return
what the port's return on BMP and WebP files. Truncated files raise
ValueError; flipped bytes raise ValueError or decode, and never crash.
About 6 s."""

import importlib.util
import io
import os
import tarfile

import numpy as np
import pytest
from PIL import Image

from reflectionflow_tpu.models.qwen_vl import video as jvideo
from reflectionflow_tpu.search import artifacts as jartifacts
from reflectionflow_tpu.train import data as jdata
from reflectionflow_tpu_torch.models.qwen_vl import video as tvideo
from reflectionflow_tpu_torch.search import artifacts as tartifacts
from reflectionflow_tpu_torch.train import data as tdata
from reflectionflow_tpu_torch.utils import image_io

_spec = importlib.util.spec_from_file_location(
    "torch_jpeg_fixtures", os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "torch_jpeg",
                                        "make_fixtures.py"))
fixtures = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fixtures)

SIZES = [(1, 1), (2, 3), (17, 9), (50, 31), (33, 65), (129, 77)]  # (W, H)


@pytest.fixture(scope="module", autouse=True)
def lib():
    return image_io.get_lib()


def _save(arr: np.ndarray, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="WEBP", **opts)
    return buf.getvalue()


def _image(w, h, seed, alpha=False):
    rgb = fixtures.procedural(w, h, seed)
    if seed % 3 == 0:  # some sharp random content (large coefficients, 4x4 modes)
        rgb[::3] = np.random.default_rng(seed).integers(0, 256, rgb[::3].shape, dtype=np.uint8)
    if not alpha:
        return rgb
    a = fixtures.procedural(w, h, seed + 1)[..., :1]
    a[: h // 3] = 255
    return np.concatenate([rgb, a], axis=-1)


def _check(data: bytes, rgba: bool = False):
    img = Image.open(io.BytesIO(data))
    want = np.asarray(img.convert("RGBA" if rgba else "RGB"))
    if rgba:
        np.testing.assert_array_equal(image_io.decode_webp(data), want)
    else:
        np.testing.assert_array_equal(tdata.decode_image(data), want)


LOSSY = [(q, m) for q in (5, 30, 75, 100) for m in (0, 4, 6)]


@pytest.mark.parametrize("quality,method", LOSSY, ids=[f"q{q}_m{m}" for q, m in LOSSY])
def test_lossy_matches_pil(quality, method):
    for w, h in SIZES:
        _check(_save(_image(w, h, w * h + quality + method), quality=quality, method=method))


@pytest.mark.parametrize("method", [0, 2, 4, 6])
def test_lossless_matches_pil(method):
    for w, h in SIZES:
        _check(_save(_image(w, h, w + h + method), lossless=True, method=method))


@pytest.mark.parametrize("colours", [2, 3, 4, 5, 16, 17, 200, 256])
def test_lossless_palette_matches_pil(colours):
    """<= 16 colours bundle 8, 4 or 2 indices a pixel; more are indexed one
    a pixel."""
    for w, h in SIZES[1:]:
        img = Image.fromarray(_image(w, h, colours + w)).quantize(colors=colours).convert("RGB")
        _check(_save(np.asarray(img), lossless=True, method=colours % 7))


@pytest.mark.parametrize("opts", [{"quality": 70, "alpha_quality": 30}, {"quality": 50, "alpha_quality": 100},
                                  {"lossless": True}, {"lossless": True, "exact": True}],
                         ids=["lossy_a30", "lossy_a100", "lossless", "lossless_exact"])
def test_alpha_matches_pil(opts):
    """ALPH (raw or VP8L, filtered) beside VP8, or VP8L's own alpha: RGBA as
    PIL opens it, and RGB as `convert("RGB")` drops the alpha."""
    for w, h in SIZES:
        data = _save(_image(w, h, 7 * w + h, alpha=True), **opts)
        _check(data, rgba=True)
        _check(data)


@pytest.mark.parametrize("lossless", [False, True], ids=["lossy", "lossless"])
def test_animation_first_frame_matches_pil(lossless):
    frames = [Image.fromarray(_image(40, 30, s, alpha=s == 1)) for s in range(3)]
    buf = io.BytesIO()
    frames[0].save(buf, format="WEBP", save_all=True, append_images=frames[1:], duration=80, lossless=lossless)
    _check(buf.getvalue())
    _check(buf.getvalue(), rgba=True)


@pytest.fixture(scope="module")
def samples():
    """A lossy, a lossless and an alpha file."""
    return [_save(_image(50, 31, 1), quality=60), _save(_image(50, 31, 2), lossless=True),
            _save(_image(50, 31, 3, alpha=True), quality=60, alpha_quality=40)]


def test_truncated_webp_raises(samples):
    for data in samples:
        for frac in (0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 0.99):
            with pytest.raises(ValueError):
                image_io.decode_webp(data[:int(frac * len(data))])


def test_corrupt_webp_never_crashes(samples):
    """Flipped bytes: ValueError or an image of the canvas's size, never a
    crash or a read past the buffer."""
    rng = np.random.default_rng(0)
    for data in samples:
        for _ in range(150):
            bad = bytearray(data)
            for p in rng.integers(12, len(bad), 2):
                bad[p] = int(rng.integers(0, 256))
            try:
                out = image_io.decode_webp(bytes(bad))
            except ValueError:
                continue
            assert out.dtype == np.uint8 and out.ndim == 3 and out.shape[2] == 4


@pytest.mark.parametrize("head,name", [(b"GIF89a", "GIF"), (b"II*\x00", "TIFF"), (b"\x00\x00\x01\x00", "ICO"),
                                       (b"8BPS", "PSD"), (b"\x00\x00\x00\x1cftypavif", "AVIF"), (b"P6\n", "PPM")])
def test_other_formats_raise_naming_them(head, name):
    if name == "GIF":  # read since GIF support: a header with no image in it raises as PIL refuses it
        with pytest.raises(Exception):
            Image.open(io.BytesIO(head + bytes(64))).load()
        with pytest.raises(ValueError, match="image not found"):
            tdata.decode_image(head + bytes(64))
        return
    if name == "TIFF":  # read since TIFF support: a header naming no IFD raises as PIL refuses it
        with pytest.raises(Exception):
            Image.open(io.BytesIO(head + bytes(64))).load()
        with pytest.raises(ValueError, match="no image in the TIFF file"):
            tdata.decode_image(head + bytes(64))
        return
    if name in ("ICO", "PPM", "PSD"):  # read since ICO, PPM and PSD support: no entries, NUL tokens, version 0
        with pytest.raises(Exception):
            Image.open(io.BytesIO(head + bytes(64))).load()
        # PIL passes an ICO with no entries and a PSD of version 0 on to its other plugins, which open neither
        with pytest.raises(ValueError, match={"PPM": "Token too long", "ICO": "not an image file PIL opens",
                                              "PSD": "not a PSD file"}[name]):
            tdata.decode_image(head + bytes(64))
        return
    with pytest.raises(ValueError, match=f"{name} images are not read by the port yet"):
        tdata.decode_image(head + bytes(64))


def test_unknown_bytes_raise():
    for data in (b"", b"\x00", b"not an image at all", bytes(100)):
        with pytest.raises(ValueError):
            tdata.decode_image(data)


def _frames(tmp_path):
    """A frame directory of WebP (lossless and lossy) and BMP frames."""
    d = tmp_path / "frames"
    d.mkdir()
    for t in range(4):
        arr = fixtures.clip_frame(t, 48)
        name = d / f"f{t:02d}.{'webp' if t % 2 == 0 else 'bmp'}"
        name.write_bytes(_save(arr, lossless=True) if t == 0 else _save(arr, quality=80) if t == 2
                         else fixtures.write_bmp(arr, 24))
    return d


def test_load_image_matches_jax(tmp_path):
    d = _frames(tmp_path)
    for path in sorted(d.iterdir()) + [d]:  # each frame, then the directory as a clip
        np.testing.assert_array_equal(tartifacts.load_image(str(path)), jartifacts.load_image(str(path)))


def test_frame_directory_matches_jax(tmp_path):
    d = _frames(tmp_path)
    got = tvideo._read_decoded(str(d))
    np.testing.assert_array_equal(got, jvideo._read_decoded(str(d)))
    assert got.shape == (4, 48, 48, 3)
    np.testing.assert_array_equal(got[0], fixtures.clip_frame(0, 48))  # lossless WebP
    np.testing.assert_array_equal(got[1], fixtures.clip_frame(1, 48))  # BMP


def test_genref_member_of_webp_bytes_matches_jax(tmp_path):
    """A GenRef tar whose `good_image.jpg` members hold WebP bytes and whose
    `bad_image.png` members hold BMP bytes: both packages' readers decode
    them by content, to the same samples."""
    path = tmp_path / "shard.tar"
    with tarfile.open(path, "w") as tar:
        for i in range(3):
            files = {"good_image.jpg": _save(_image(40, 24, i), quality=70),
                     "bad_image.png": fixtures.write_bmp(_image(24, 16, 10 + i), 24),
                     "prompt.txt": f"prompt {i}".encode(), "reflection.txt": b"make it sharper",
                     "subset.txt": b"general"}
            for field, data in files.items():
                info = tarfile.TarInfo(f"{i:04d}.{field}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
    want, got = list(jdata.iter_tar_samples(str(path))), list(tdata.iter_tar_samples(str(path)))
    assert len(want) == len(got) == 3
    for a, b in zip(want, got):
        np.testing.assert_array_equal(b.good, a.good)
        np.testing.assert_array_equal(b.bad, a.bad)
        assert (b.prompt, b.reflection, b.subset) == (a.prompt, a.reflection, a.subset)
