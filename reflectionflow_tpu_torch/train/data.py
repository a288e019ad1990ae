"""GenRef streaming data pipeline (tar shards of keyed sample files).

Counterpart of `reflectionflow_tpu/train/data.py`, with the same semantics
and the same numpy PCG64 seeds, so that subset choices, crops and drops
match the JAX package's run draw for draw:
  * a sample is the group of files `{key}.good_image.{png,jpg}`,
    `{key}.bad_image.*`, `{key}.reflection.txt`, `{key}.prompt.txt`,
    `{key}.subset.txt` in one shard, indexed by the native C++ reader
    (`utils/native.py`) and read in one batched call per sample; a shard the
    indexer cannot take (return code -2 or -3) is read with Python's
    `tarfile`, as in the JAX package, and counted in `native.fallbacks`;
  * subset streams (general/length/rule/editing) mixed with stage-scheduled
    ratios (`StageSchedule`); each stream loops over the shards forever;
  * paired augmentation: bad resized to good, shorter-edge resize to
    target_size, the same random crop for both, bad resized to
    condition_size;
  * drops: text -> empty prompt, image -> black condition (not for
    "editing"), reflection (or one shorter than 5 characters) -> the
    description falls back to the prompt; description =
    "{prompt} [Reflexion] {reflection}".

The port's machine has no PIL: images are decoded by the port's own readers,
told apart as PIL tells them, by its plugin order (`decode_image` over
`utils/image_identify.py::identify`: JPEG of every kind libjpeg-turbo reads,
BMP, WebP, GIF, TIFF, JPEG 2000 (JP2 and J2K, as PIL reads them through
OpenJPEG 2.5.4), the PPM family, TGA (which has no signature), PSD's merged
image, QOI and DDS through `utils/image_io.py`, bit-exact to PIL's decode;
`decode_png`: every PNG colour type and bit depth, interlaced or not, as PIL
converts it to RGB; `decode_ico` / `decode_cur`: the entry Pillow loads, a
PNG or a DIB) and resized by its C++ copy of PIL's bicubic `Image.resize`,
bit for bit. A sample whose image is corrupt, or of a format the port does
not read yet (AVIF, ICNS, ...: ROADMAP queue 1), raises ValueError and is
skipped, as the JAX package skips what PIL cannot open.
`write_synthetic_shard` writes the JAX package's shard byte for byte: its
JPEG bytes are PIL's default save (`image_io.encode_jpeg`).
"""

from __future__ import annotations

import io
import math
import os
import struct
import tarfile
import zlib
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from ..utils import native
from ..utils.image_identify import identify
from ..utils.image_io import (decode_bmp, decode_dds, decode_dib, decode_gif, decode_jpeg, decode_jpeg2000,
                               decode_ppm, decode_psd, decode_qoi, decode_tga, decode_tiff, decode_webp, encode_jpeg,
                               png_unfilter)
from ..utils.image_io import resize_bicubic as resize

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3  # PIL's Image.MAX_IMAGE_PIXELS
# color type -> (channels, the bit depths the PNG spec allows)
_PNG_KINDS = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)), 3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)),
              6: (4, (8, 16))}
# Adam7 passes: (x0, y0, dx, dy)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _to_float(img: np.ndarray) -> np.ndarray:
    return img.astype(np.float32) / 127.5 - 1.0


def _png_samples(rows: np.ndarray, w: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered scanlines (h, stride) -> (h, w, channels) samples, uint16
    at depth 16, else uint8 at their own depth (sub-byte samples packed
    from the high bits)."""
    h = rows.shape[0]
    if depth == 16:
        return rows[:, : 2 * w * channels].view(">u2").astype(np.uint16).reshape(h, w, channels)
    if depth == 8:
        return rows[:, : w * channels].reshape(h, w, channels)
    per_byte = 8 // depth
    shifts = (8 - depth * (1 + np.arange(per_byte))).astype(np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w, None]


def _png_to_rgb(samples: np.ndarray, color: int, depth: int, palette: np.ndarray | None) -> np.ndarray:
    """PIL's `convert("RGB")` of the mode PIL opens a PNG kind in: 16-bit
    colour and alpha samples keep their high byte ("RGB;16B", "LA;16B"), a
    16-bit grey ("I;16") clips to 255, sub-byte grey scales to 0..255 ("1",
    "L;2", "L;4"), a palette index reads PLTE (entries past it are black, as
    PIL reads them), and alpha and tRNS are dropped."""
    if color == 3:
        lut = np.zeros((256, 3), np.uint8)
        lut[: len(palette)] = palette[:256]
        return lut[samples[..., 0]]
    if depth == 16:
        samples = np.minimum(samples, 255).astype(np.uint8) if color == 0 else (samples >> 8).astype(np.uint8)
    elif depth < 8:
        samples = (samples * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if color in (0, 4):
        return np.repeat(samples[..., :1], 3, axis=2)
    return np.ascontiguousarray(samples[..., :3])


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's `Image.open(...).convert("RGB")`
    gives them: colour types 0, 2, 3, 4 and 6 at every bit depth the PNG spec
    allows, with PLTE and tRNS, plain or Adam7-interlaced."""
    if not data.startswith(_PNG_MAGIC):
        raise ValueError("not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            palette = np.frombuffer(body[: len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, color, _, _, interlace = header
    if w * h > 2 * _MAX_IMAGE_PIXELS:
        raise ValueError(f"a {w}x{h} PNG is past twice MAX_IMAGE_PIXELS, as PIL refuses it")
    if color not in _PNG_KINDS or depth not in _PNG_KINDS[color][1] or interlace > 1:
        raise ValueError(f"PNG with bit depth {depth}, color type {color}, interlace {interlace}")
    if color == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = _PNG_KINDS[color][0]
    bits = depth * channels
    bpp = max(1, bits // 8)
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    dtype = np.uint16 if depth == 16 else np.uint8
    img = np.zeros((h, w, channels), dtype)
    off = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue
        stride = -(-pw * bits // 8)
        rows = png_unfilter(raw[off:off + ph * (stride + 1)], ph, stride, bpp)
        off += ph * (stride + 1)
        img[y0::dy, x0::dx] = _png_samples(rows, pw, depth, channels)
    return _png_to_rgb(img, color, depth, palette)


# The formats PIL opens that the port does not read yet, by `identify`'s
# name: their ROADMAP queue 1 entries.
_QUEUED = {"AVIF": 7, "ICNS": 15, "PCX": 16, "DCX": 16, "SGI": 17, "SUN": 17, "MSP": 17, "XBM": 17, "XPM": 17,
           "BLP": 17, "FLI": 17}


def _ico_entries(data: bytes) -> list[bytes]:
    """The 16-byte directory entries of an ICO or CUR file; a short one raises
    as Pillow's reads do."""
    if len(data) < 6:
        raise ValueError("truncated ICO / CUR header")
    (count,) = struct.unpack_from("<H", data, 4)
    entries = [data[6 + 16 * i: 22 + 16 * i] for i in range(count)]
    if not entries or len(entries[-1]) < 16:
        raise ValueError("truncated or empty ICO / CUR directory")
    return entries


def decode_ico(data: bytes) -> np.ndarray:
    """ICO bytes -> (H, W, 3) uint8 RGB of the entry Pillow's IcoImagePlugin
    loads (the largest; of those, the lowest colour depth; of equals, the
    first in the directory), as `convert("RGB")` gives it: a PNG entry through
    `decode_png`, a DIB through `image_io.decode_dib` (half its height; the
    AND mask, or the alpha bytes of a 32-bit entry, must be there, else PIL
    raises, and `convert("RGB")` drops them)."""
    entries = []
    for s in _ico_entries(data):
        w, h, colors = s[0] or 256, s[1] or 256, s[2]
        _, bpp, size, offset = struct.unpack_from("<HHII", s, 4)
        depth = bpp or (colors != 0 and math.ceil(math.log(colors, 2))) or 256
        entries.append((w * h, depth, bpp, size, offset))
    entries.sort(key=lambda e: e[1])
    entries.sort(key=lambda e: e[0], reverse=True)
    _, _, bpp, size, offset = entries[0]
    if data[offset:offset + 8] == _PNG_MAGIC:
        return decode_png(data[offset:])
    rgb, pixels_at = decode_dib(data, offset)
    h, w = rgb.shape[:2]
    if bpp == 32:  # the alpha bytes of the BGRA rows
        if len(data[pixels_at:pixels_at + w * h * 4][3::4]) < w * h:
            raise ValueError("not enough image data for the ICO alpha")
    else:  # the AND mask's rows, padded to 32 bits; the raw decoder needs no padding after the last
        stride = (w + (32 - w % 32) % 32) // 8
        total = stride * h
        mask_at = offset + size - total
        if mask_at < 0 or len(data[mask_at:mask_at + total]) < (h - 1) * stride + (w + 7) // 8:
            raise ValueError("not enough image data for the ICO mask")
    return rgb


def decode_cur(data: bytes) -> np.ndarray:
    """CUR bytes -> (H, W, 3) uint8 RGB, as Pillow's CurImagePlugin reads it:
    the first entry, or a later one wider and taller than it (the directory's
    bytes, 0 as 0), a DIB of half its height."""
    best = b""
    for s in _ico_entries(data):
        if not best or (s[0] > best[0] and s[1] > best[1]):
            best = s
    return decode_dib(data, struct.unpack_from("<I", best, 12)[0])[0]


def _webp_rgb(data: bytes) -> np.ndarray:
    return np.ascontiguousarray(decode_webp(data)[..., :3])


# `identify`'s format -> the port's reader
_READERS = {"JPEG": decode_jpeg, "PNG": decode_png, "BMP": decode_bmp, "GIF": decode_gif, "TIFF": decode_tiff,
            "WEBP": _webp_rgb, "JPEG2000": decode_jpeg2000, "ICO": decode_ico, "CUR": decode_cur, "PPM": decode_ppm,
            "TGA": decode_tga, "PSD": decode_psd, "QOI": decode_qoi, "DDS": decode_dds}


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> (H, W, 3) uint8 RGB, as PIL's
    `Image.open(...).convert("RGB")` gives them. The format is the one PIL
    opens the bytes as (`utils/image_identify.py::identify`, PIL's plugin
    order): JPEG, PNG, BMP, WebP, GIF (the first frame of these two), TIFF
    (its first image, classic or BigTIFF, uncompressed or PackBits, LZW,
    Deflate, LZMA, ZSTD, JPEG, old-style JPEG, ThunderScan or CCITT RLE /
    RLEW / Group 3 / Group 4, transposed by its Orientation), JPEG 2000 (a
    JP2 file or a J2K codestream), ICO, CUR, the PPM family (P1-P6, Pf and
    Pillow's P0CMYK, PyP, PyRGBA, PyCMYK), TGA (told apart by its header
    alone), PSD's merged image, QOI and DDS (BC1-BC7 and the uncompressed
    kinds); what PIL refuses raises ValueError "... as PIL refuses it", P7
    (PAM) and PF among them. A format PIL opens that the port does not read
    yet raises ValueError naming it and its ROADMAP queue 1 entry; bytes PIL
    opens as nothing raise ValueError too."""
    fmt = identify(data)
    reader = _READERS.get(fmt)
    if reader is not None:
        return reader(data)
    if data[:2] in (b"P7", b"PF"):  # PAM and colour PFM: decode_ppm raises as PIL refuses them
        return decode_ppm(data)
    if fmt is None:
        raise ValueError(f"not an image file PIL opens (starts {data[:12]!r})")
    raise ValueError(f"{fmt} images are not read by the port yet (ROADMAP queue 1 entry {_QUEUED.get(fmt, 18)})")


@dataclass
class Sample:
    good: np.ndarray  # (H, W, 3) uint8
    bad: np.ndarray
    prompt: str
    reflection: str
    subset: str


_FIELD_SUFFIXES = (
    "good_image.jpg", "good_image.png", "bad_image.jpg", "bad_image.png",
    "reflection.txt", "prompt.txt", "subset.txt",
)


def _split_key(base: str) -> tuple[str, str] | None:
    for suffix in _FIELD_SUFFIXES:
        if base.endswith("." + suffix):
            return base[: -(len(suffix) + 1)], suffix
    return None


def iter_tar_samples(shard_path: str) -> Iterator[Sample]:
    """Stream grouped samples out of one GenRef tar shard: the native indexer
    and batched reads, or Python's `tarfile` where the indexer returns -2/-3."""
    idx = native.tar_index(shard_path)
    if idx is not None:
        yield from _iter_tar_samples_native(shard_path, idx)
        return
    native.fallbacks += 1
    yield from _iter_tar_samples_py(shard_path)


def _iter_tar_samples_native(shard_path: str, idx) -> Iterator[Sample]:
    """Members grouped by key in order of first appearance, one batched read
    per sample."""
    names, offsets, sizes = idx
    groups: dict[str, dict[str, int]] = {}
    for i, name in enumerate(names):
        ks = _split_key(name.split("/")[-1])
        if ks is not None:
            groups.setdefault(ks[0], {})[ks[1]] = i
    for members in groups.values():
        idxs = list(members.values())
        parts = dict(zip(members, native.tar_read_batch(shard_path, offsets[idxs], sizes[idxs])))
        sample = _assemble(parts)
        if sample is not None:
            yield sample


def _iter_tar_samples_py(shard_path: str) -> Iterator[Sample]:
    """Consecutive members that share a key form a sample."""
    with tarfile.open(shard_path, "r") as tar:
        current_key, parts = None, {}
        for member in tar:
            if not member.isfile():
                continue
            ks = _split_key(member.name.split("/")[-1])
            if ks is None:
                continue
            key, suffix = ks
            if current_key is not None and key != current_key and parts:
                sample = _assemble(parts)
                if sample is not None:
                    yield sample
                parts = {}
            current_key = key
            parts[suffix] = tar.extractfile(member).read()
        if parts:
            sample = _assemble(parts)
            if sample is not None:
                yield sample


def _assemble(parts: dict[str, bytes]) -> Sample | None:
    good_b = parts.get("good_image.jpg") or parts.get("good_image.png")
    bad_b = parts.get("bad_image.jpg") or parts.get("bad_image.png")
    if good_b is None or bad_b is None:
        return None
    try:
        good, bad = decode_image(good_b), decode_image(bad_b)
    except (ValueError, zlib.error, struct.error):  # corrupt, refused or not yet read (ROADMAP
        return None  # queue 1) -> skip
    return Sample(
        good=good,
        bad=bad,
        prompt=parts.get("prompt.txt", b"").decode("utf-8", "ignore").strip(),
        reflection=parts.get("reflection.txt", b"").decode("utf-8", "ignore").strip(),
        subset=parts.get("subset.txt", b"general").decode("utf-8", "ignore").strip() or "general",
    )


def _paired_crop(good: np.ndarray, bad: np.ndarray, target: int, rng: np.random.Generator):
    """Resize bad to good's size, shorter-edge resize both to `target`, apply
    the same random crop; returns (good_t, bad_t), each (target, target, 3)."""
    h, w = good.shape[:2]
    bad = resize(bad, (w, h))
    scale = target / min(w, h)
    nw, nh = max(target, round(w * scale)), max(target, round(h * scale))
    g, b = resize(good, (nw, nh)), resize(bad, (nw, nh))
    x0 = int(rng.integers(0, nw - target + 1))
    y0 = int(rng.integers(0, nh - target + 1))
    return g[y0:y0 + target, x0:x0 + target], b[y0:y0 + target, x0:x0 + target]


# GenRef's subset mix at its two training stages (the train CLI's default)
GENREF_SPLIT_RATIOS = {"general": [0.1, 0.3], "length": [0.1, 0.3], "rule": [0.1, 0.4], "editing": [0.7, 0.0]}


@dataclass
class StageSchedule:
    """Linear interpolation of subset mix ratios over training stages.

    split_ratios: {subset: [ratio_stage0, ratio_stage1, ...]};
    training_stages: [step0, step1, ...] boundaries."""

    split_ratios: dict[str, list[float]]
    training_stages: list[int]

    def ratios_at(self, step: int) -> dict[str, float]:
        stages = self.training_stages
        if not stages or len(stages) == 1:
            return {k: v[0] for k, v in self.split_ratios.items()}
        if step <= stages[0]:
            frac, lo = 0.0, 0
        elif step >= stages[-1]:
            frac, lo = 1.0, len(stages) - 2
        else:
            lo = max(i for i in range(len(stages) - 1) if stages[i] <= step)
            span = stages[lo + 1] - stages[lo]
            frac = (step - stages[lo]) / max(span, 1)
        out = {}
        for k, vals in self.split_ratios.items():
            v0 = vals[min(lo, len(vals) - 1)]
            v1 = vals[min(lo + 1, len(vals) - 1)]
            out[k] = v0 + (v1 - v0) * frac
        total = sum(out.values())
        return {k: v / max(total, 1e-9) for k, v in out.items()}


@dataclass
class GenRefDataset:
    shards: list[str]
    batch_size: int = 8
    target_size: int = 512
    condition_size: int = 512
    drop_text_prob: float = 0.1
    drop_image_prob: float = 0.1
    drop_reflection_prob: float = 0.2
    schedule: StageSchedule | None = None
    seed: int = 0
    host_index: int = 0
    host_count: int = 1
    step: int = 0

    def set_step(self, step: int) -> None:
        self.step = step

    def _host_shards(self) -> list[str]:
        return [s for i, s in enumerate(self.shards) if i % self.host_count == self.host_index]

    def _subset_iter(self, subset: str) -> Iterator[Sample]:
        """Infinite stream of one subset, re-opening the shards forever."""
        shards = self._host_shards()
        epoch = 0
        while True:
            rng = np.random.Generator(np.random.PCG64(
                [self.seed, zlib.crc32(subset.encode()) & 0xFFFF, epoch]))
            for si in rng.permutation(len(shards)):
                for sample in iter_tar_samples(shards[si]):
                    if sample.subset == subset:
                        yield sample
            epoch += 1

    def __iter__(self) -> Iterator[dict]:
        subsets = list(self.schedule.split_ratios.keys()) if self.schedule else ["general"]
        iters = {s: self._subset_iter(s) for s in subsets}
        rng = np.random.Generator(np.random.PCG64([self.seed, self.host_index]))
        while True:
            ratios = self.schedule.ratios_at(self.step) if self.schedule else {"general": 1.0}
            names = list(ratios.keys())
            probs = np.asarray([ratios[n] for n in names])
            probs = probs / probs.sum()
            batch = []
            for _ in range(self.batch_size):
                subset = names[int(rng.choice(len(names), p=probs))]
                batch.append(self._transform(next(iters[subset]), rng))
            yield self._collate(batch)

    def _transform(self, s: Sample, rng: np.random.Generator) -> dict:
        good_t, bad_t = _paired_crop(s.good, s.bad, self.target_size, rng)
        if self.condition_size != self.target_size:
            bad_t = resize(bad_t, (self.condition_size, self.condition_size))
        prompt, reflection = s.prompt, s.reflection
        if rng.random() < self.drop_text_prob:
            prompt = ""
        if rng.random() < self.drop_image_prob and s.subset != "editing":
            bad_t = np.zeros_like(bad_t)  # black condition (pixel 0 -> -1.0)
        if rng.random() < self.drop_reflection_prob or len(reflection) < 5:
            description = prompt
        else:
            description = f"{prompt} [Reflexion] {reflection}"
        return {
            "image": _to_float(good_t),
            "condition": _to_float(bad_t),
            "original_prompt": prompt,
            "description": description,
            "subset": s.subset,
        }

    @staticmethod
    def _collate(rows: list[dict]) -> dict:
        return {
            "image": np.stack([r["image"] for r in rows]),
            "condition": np.stack([r["condition"] for r in rows]),
            "original_prompt": [r["original_prompt"] for r in rows],
            "description": [r["description"] for r in rows],
            "subset": [r["subset"] for r in rows],
            "condition_type": ["cot"] * len(rows),
        }


def write_synthetic_shard(path: str, n: int = 8, size: int = 32, seed: int = 0,
                          subsets=("general", "editing")) -> None:
    """A small GenRef-format shard of random images, byte for byte the JAX
    package's: the same draws, JPEG bytes equal to PIL's default save
    (`utils/image_io.py::encode_jpeg`), the same members in the same order."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    rng = np.random.default_rng(seed)
    with tarfile.open(path, "w") as tar:
        for i in range(n):
            key = f"{i:06d}"
            files = {
                "good_image.jpg": encode_jpeg(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)),
                "bad_image.jpg": encode_jpeg(rng.integers(0, 255, (size, size, 3), dtype=np.uint8)),
                "prompt.txt": f"prompt {i}".encode(),
                "reflection.txt": f"make object {i} sharper and correctly colored".encode(),
                "subset.txt": subsets[i % len(subsets)].encode(),
            }
            for name, data in files.items():
                info = tarfile.TarInfo(f"{key}.{name}")
                info.size = len(data)
                tar.addfile(info, io.BytesIO(data))
