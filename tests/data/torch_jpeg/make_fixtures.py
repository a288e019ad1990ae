"""Writes the image fixtures of this directory and their manifest with PIL.

    python tests/data/torch_jpeg/make_fixtures.py

Each image is a seeded smooth procedural RGB image with mild noise. Three
kinds of entry:
  * "jpeg": a file PIL wrote (sequential, progressive, grey, CMYK; YCCK and
    marker-less CMYK by patching PIL's Adobe segment; one progressive file
    cut after its fifth scan), with its encode settings, the sha256 of PIL's
    decode (`Image.open(...).convert("RGB")`, (H, W, 3) uint8 bytes) and of
    PIL's bicubic `Image.resize` chains that the GenRef data path runs on it
    (a chain "1024x1024,512x512" resizes to 1024x1024, then that to
    512x512), or the exception the port raises where PIL's libjpeg would
    smooth across blocks;
  * "png": a file of every PNG colour type and bit depth (PLTE, tRNS, Adam7)
    written by `write_png` below, with the sha256 of PIL's decode;
  * "encode": a committed pixel array (`encode_pixels.npz`) with the sha256
    of PIL's default `save(format="JPEG")` of it.
`tests/test_torch_jpeg.py` checks the committed bytes against the manifest
with PIL and the port against it; `chip_smoke.py` phase 5e holds the port's
decoders, JPEG writer and resize to it on the card's machine.
"""

import hashlib
import io
import json
import os
import struct
import zlib

import numpy as np
from PIL import Image

HERE = os.path.dirname(os.path.abspath(__file__))

# name, (W, H), seed, save options, resize chains
FIXTURES = [
    ("good_a_1024_q75_420.jpg", (1024, 1024), 1, {"quality": 75, "subsampling": 2}, ["512x512"]),
    ("good_b_1024_q75_420.jpg", (1024, 1024), 2, {"quality": 75, "subsampling": 2}, ["512x512"]),
    ("bad_1024x768_q75_420.jpg", (1024, 768), 3, {"quality": 75, "subsampling": 2},
     ["1024x1024", "1024x1024,512x512", "683x512"]),
    ("good_c_1024_q90_444_rst.jpg", (1024, 1024), 4,
     {"quality": 90, "subsampling": 0, "restart_marker_blocks": 7}, ["512x512"]),
    ("grey_33x17_q85.jpg", (33, 17), 5, {"quality": 85, "mode": "L"}, ["16x16"]),
    ("odd_17x9_q75_422.jpg", (17, 9), 6, {"quality": 75, "subsampling": 1}, ["8x8", "40x21"]),
    ("odd_67x45_q95_420_opt.jpg", (67, 45), 7, {"quality": 95, "subsampling": 2, "optimize": True},
     ["32x32"]),
    ("odd_50x31_q60_420_rst.jpg", (50, 31), 8,
     {"quality": 60, "subsampling": 2, "restart_marker_blocks": 2}, ["25x16"]),
    ("progressive_32x32.jpg", (32, 32), 9, {"quality": 75, "progressive": True}, []),
    ("progressive_444_67x45_q90.jpg", (67, 45), 10, {"quality": 90, "progressive": True, "subsampling": 0},
     ["32x32"]),
    ("progressive_422_50x31_rst.jpg", (50, 31), 11,
     {"quality": 75, "progressive": True, "subsampling": 1, "restart_marker_blocks": 2}, []),
    ("progressive_420_33x65_opt.jpg", (33, 65), 12, {"quality": 80, "progressive": True, "optimize": True}, []),
    ("progressive_grey_33x17.jpg", (33, 17), 13, {"quality": 85, "progressive": True, "mode": "L"}, []),
    ("progressive_cmyk_40x24.jpg", (40, 24), 14, {"quality": 75, "progressive": True, "mode": "CMYK"}, []),
    ("progressive_cut5_40x24.jpg", (40, 24), 15, {"quality": 75, "progressive": True, "cut_scans": 5}, []),
    ("cmyk_40x24_q85.jpg", (40, 24), 16, {"quality": 85, "mode": "CMYK"}, []),
    ("cmyk_no_adobe_40x24.jpg", (40, 24), 17, {"quality": 75, "mode": "CMYK", "adobe": None}, []),
    ("ycck_40x24.jpg", (40, 24), 18, {"quality": 75, "mode": "CMYK", "adobe": 2}, []),
    ("ycck_420_prog_41x23.jpg", (41, 23), 19,
     {"quality": 75, "mode": "CMYK", "progressive": True, "subsampling": 2, "adobe": 2}, []),
]
# name, colour type, bit depth, interlaced, with tRNS; 19x13 pixels each
PNGS = [(f"png_c{c}_d{d}{'_adam7' if i else ''}{'_trns' if t else ''}.png", c, d, i, t) for c, d, i, t in [
    (0, 1, False, False), (0, 2, False, False), (0, 4, True, False), (0, 8, False, True), (0, 16, False, False),
    (0, 16, True, True), (2, 8, True, False), (2, 8, False, True), (2, 16, False, True), (2, 16, True, False),
    (3, 1, False, False), (3, 2, True, False), (3, 4, False, True), (3, 8, True, True), (4, 8, False, False),
    (4, 16, True, False), (6, 8, True, False), (6, 16, False, False)]]
ENCODE_SIZES = [(32, 32), (1, 1), (17, 9), (33, 65), (16, 48), (100, 37)]  # (W, H)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def procedural(w: int, h: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.004, 0.03, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    img = np.stack([128 + 70 * np.sin(xx * f[c, 0] + ph[c, 0]) * np.cos(yy * f[c, 1] + ph[c, 1])
                    + 40 * np.sin((xx + yy) * f[c, 0] * 0.5) for c in range(3)], axis=-1)
    img += rng.normal(0.0, 6.0, img.shape)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _segments(data: bytes):
    """(offset, marker, length) of each marker segment up to the first SOS."""
    out, i = [], 2
    while i < len(data):
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        out.append((i, m, n))
        if m == 0xDA:
            break
        i += 2 + n
    return out


def set_adobe(data: bytes, transform) -> bytes:
    """PIL's CMYK file with its Adobe APP14 transform byte set, or the
    segment removed (transform None)."""
    for i, m, n in _segments(data):
        if m == 0xEE:
            if transform is None:
                return data[:i] + data[i + 2 + n:]
            return data[:i + 15] + bytes([transform]) + data[i + 16:]
    raise ValueError("no Adobe segment")


def cut_scans(data: bytes, n: int) -> bytes:
    """A progressive file cut before its (n+1)-th scan, EOI appended."""
    at, pos = -1, 0
    for _ in range(n + 1):
        at = data.index(b"\xff\xda", pos)
        pos = at + 2
    return data[:at] + b"\xff\xd9"


def _chunk(tag: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """(h, w, c) samples -> (h, stride) scanline bytes at `depth` (sub-byte
    samples packed from the high bits)."""
    h, w, c = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * c).view(np.uint8).reshape(h, -1)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * c)
    per = 8 // depth
    flat = samples.reshape(h, w * c).astype(np.uint8)
    flat = np.pad(flat, ((0, 0), (0, (-flat.shape[1]) % per))).reshape(h, -1, per)
    out = np.zeros(flat.shape[:2], np.uint8)
    for i in range(per):
        out |= flat[:, :, i] << (8 - depth * (i + 1))
    return out


def _filter(rows: np.ndarray, bpp: int, rng) -> bytes:
    """Each scanline under a random PNG filter type (None, Sub, Up, Average, Paeth)."""
    out, prev = [], np.zeros(rows.shape[1], np.int32)
    for row in rows.astype(np.int32):
        ft = int(rng.integers(0, 5))
        a = np.concatenate([np.zeros(bpp, np.int32), row])[: len(row)]
        c = np.concatenate([np.zeros(bpp, np.int32), prev])[: len(row)]
        b = prev
        if ft == 4:
            p = a + b - c
            pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
            pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        else:
            pred = (0, a, b, (a + b) >> 1)[ft]
        out.append(bytes([ft]) + ((row - pred) & 0xFF).astype(np.uint8).tobytes())
        prev = row
    return b"".join(out)


def write_png(samples: np.ndarray, color: int, depth: int, palette=None, trns: bytes | None = None,
              interlace: bool = False, seed: int = 0) -> bytes:
    """(h, w, channels) samples at `depth` -> PNG bytes: random filters,
    Adam7 when `interlace`, PLTE / tRNS when given, several IDAT chunks."""
    h, w, c = samples.shape
    rng = np.random.default_rng(seed)
    bpp = max(1, depth * c // 8)
    raw = b""
    for x0, y0, dx, dy in (ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            raw += _filter(_pack(sub, depth), bpp, rng)
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, int(interlace)))
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    if trns is not None:
        out += _chunk(b"tRNS", trns)
    z = zlib.compress(raw, 9)
    for i in range(0, len(z), 97):
        out += _chunk(b"IDAT", z[i:i + 97])
    return out + _chunk(b"IEND", b"")


def png_fixture(color: int, depth: int, interlace: bool, trns: bool, seed: int) -> bytes:
    """A 19x13 PNG of the kind: a palette shorter than 2^depth (PIL reads
    the indices past it as black) and, with `trns`, a tRNS chunk."""
    rng = np.random.default_rng(seed)
    channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
    palette = None
    if color == 3:
        n = max(1, (1 << depth) - 1)
        palette = rng.integers(0, 256, (n, 3))
        samples = rng.integers(0, 1 << depth, (13, 19, 1))
    else:
        samples = rng.integers(0, 1 << depth, (13, 19, channels))
        if color == 0 and depth == 16:  # both sides of PIL's clip at 255
            samples[::2] %= 256
    samples = samples.astype(np.uint16 if depth == 16 else np.uint8)
    t = None
    if trns:
        t = {0: lambda: struct.pack(">H", int(samples[0, 0, 0])),
             2: lambda: struct.pack(">HHH", *map(int, samples[0, 0])),
             3: lambda: bytes(rng.integers(0, 256, len(palette)).astype(np.uint8))}[color]()
    return write_png(samples, color, depth, palette, t, interlace, seed)


def resize_chain(img: Image.Image, chain: str) -> np.ndarray:
    for step in chain.split(","):
        img = img.resize(tuple(int(v) for v in step.split("x")))
    return np.asarray(img)


def pil_decode_sha(data: bytes) -> str:
    return sha(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def main() -> None:
    manifest = {}
    for name, (w, h), seed, opts, chains in FIXTURES:
        opts = dict(opts)
        mode = opts.pop("mode", "RGB")
        adobe = opts.pop("adobe", 0)
        cut = opts.pop("cut_scans", None)
        img = Image.fromarray(procedural(w, h, seed)).convert(mode)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        if mode == "CMYK" and adobe != 0:
            data = set_adobe(data, adobe)
        if cut is not None:
            data = cut_scans(data, cut)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        save = dict(opts, **({"adobe": adobe} if mode == "CMYK" else {}),
                    **({"cut_scans": cut} if cut is not None else {}))
        entry = {"kind": "jpeg", "size": [w, h], "mode": mode, "seed": seed, "save": save,
                 "file_sha256": hashlib.sha256(data).hexdigest()}
        dec = Image.open(io.BytesIO(data)).convert("RGB")
        entry["pil_decode_sha256"] = sha(np.asarray(dec))
        if cut is not None:  # libjpeg smooths across blocks here; the port refuses
            entry["raises"] = "NotImplementedError"
        else:
            entry["decode_sha256"] = entry.pop("pil_decode_sha256")
            entry["resize_sha256"] = {c: sha(resize_chain(dec, c)) for c in chains}
        manifest[name] = entry
    for i, (name, color, depth, interlace, trns) in enumerate(PNGS):
        data = png_fixture(color, depth, interlace, trns, 100 + i)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = {"kind": "png", "size": [19, 13], "color_type": color, "bit_depth": depth,
                          "interlace": interlace, "trns": trns, "file_sha256": hashlib.sha256(data).hexdigest(),
                          "decode_sha256": pil_decode_sha(data)}
    pixels = {f"{w}x{h}": procedural(w, h, 200 + i) for i, (w, h) in enumerate(ENCODE_SIZES)}
    np.savez(os.path.join(HERE, "encode_pixels.npz"), **pixels)
    for key, arr in pixels.items():
        buf = io.BytesIO()
        Image.fromarray(arr).save(buf, format="JPEG")
        manifest[f"encode_{key}"] = {"kind": "encode", "pixels": key, "pixels_sha256": sha(arr),
                                     "jpeg_sha256": hashlib.sha256(buf.getvalue()).hexdigest()}
    with open(os.path.join(HERE, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    main()
