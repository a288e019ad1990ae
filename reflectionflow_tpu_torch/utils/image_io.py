"""Host image codecs of the data path: JPEG decoding and writing, PIL's bicubic
resize and the PNG unfilter, in C++ (`csrc/host/image_io.cpp`, built with g++
by `ops/kernel_build.py::build_host_all`, bound with ctypes), beside their
plain numpy versions.

  * `decode_jpeg`: sequential and progressive Huffman JPEG at 8 bits, grey,
    YCbCr, RGB, CMYK and YCCK, bit-exact to PIL's
    `Image.open(...).convert("RGB")` (libjpeg-turbo's default decode:
    accurate integer IDCT, fancy upsampling, fixed-point YCbCr -> RGB, YCCK
    -> CMYK, then PIL's inverted CMYK and its CMYK -> RGB). It has no plain
    version: PIL is its reference in the tests. A progressive file that
    leaves any of AC coefficients 1-9 unrefined (where libjpeg smooths
    across blocks), arithmetic-coded and lossless files raise
    `NotImplementedError` naming ROADMAP queue 1; 12-bit and hierarchical
    files are refused as PIL refuses them; corrupt or truncated data raises
    `ValueError`.
  * `encode_jpeg`: PIL's default `save(format="JPEG")` of an RGB image,
    byte for byte (quality 75, 4:2:0, libjpeg-turbo's encode path). It has
    no plain version either: PIL's bytes are its reference.
  * `resize_bicubic`: PIL's `Image.resize(size)` with its default bicubic
    filter, bit for bit; `resize_ref` is its numpy int64 version.
  * `png_unfilter`: the PNG scanline filters undone; `png_unfilter_ref` is its
    numpy version.

`calls` counts the C++ calls by function, so that a caller can show that a
run went through them. The library is built on first use; a missing compiler
or a failed build raises, and nothing falls back.
"""

from __future__ import annotations

import ctypes
from collections import Counter
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "host" / "image_io.cpp"
_OK, _UNSUPPORTED, _NEED_BUFFER = 0, -2, 1  # rf_* return codes; any other is corrupt input
_PRECISION_BITS = 32 - 8 - 2

calls: Counter = Counter()
_lib = None


def get_lib() -> ctypes.CDLL:
    """The loaded C++ library (built on first use)."""
    global _lib
    if _lib is None:
        from ..ops.kernel_build import load_host

        lib = load_host(SOURCE)
        u8p, i32p = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int32)
        lib.rf_jpeg_decode.restype = ctypes.c_int
        lib.rf_jpeg_decode.argtypes = [ctypes.c_char_p, ctypes.c_int64, u8p, ctypes.c_int64, i32p,
                                       ctypes.c_char_p, ctypes.c_int64]
        lib.rf_resize_bicubic.restype = ctypes.c_int
        lib.rf_resize_bicubic.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, u8p,
                                          ctypes.c_int32, ctypes.c_int32]
        lib.rf_jpeg_encode.restype = ctypes.c_int
        lib.rf_jpeg_encode.argtypes = [u8p, ctypes.c_int32, ctypes.c_int32, u8p, ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int64)]
        lib.rf_png_unfilter.restype = ctypes.c_int
        lib.rf_png_unfilter.argtypes = [u8p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int32, u8p]
        _lib = lib
    return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, as PIL decodes them."""
    lib = get_lib()
    data = bytes(data)
    dims = (ctypes.c_int32 * 2)()
    err = ctypes.create_string_buffer(256)
    rc = lib.rf_jpeg_decode(data, len(data), None, 0, dims, err, len(err))
    if rc == _NEED_BUFFER:
        out = np.empty((dims[0], dims[1], 3), np.uint8)
        calls["decode_jpeg"] += 1
        rc = lib.rf_jpeg_decode(data, len(data), _u8p(out), out.nbytes, dims, err, len(err))
    if rc == _OK:
        return out
    msg = err.value.decode("utf-8", "replace")
    if rc == _UNSUPPORTED:
        raise NotImplementedError(msg)
    raise ValueError(f"corrupt JPEG: {msg}")


def encode_jpeg(rgb: np.ndarray) -> bytes:
    """(H, W, 3) uint8 RGB -> the bytes of PIL's default
    `Image.fromarray(rgb).save(buf, format="JPEG")` (quality 75, 4:2:0)."""
    rgb = np.ascontiguousarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise TypeError(f"encode_jpeg takes (H, W, 3) uint8 images, got {rgb.dtype} {rgb.shape}")
    h, w = rgb.shape[:2]
    blocks = ((h + 15) // 16) * ((w + 15) // 16) * 6
    out = np.empty(1024 + 512 * blocks, np.uint8)  # no block codes to more than 512 bytes
    n = ctypes.c_int64()
    calls["encode_jpeg"] += 1
    rc = get_lib().rf_jpeg_encode(_u8p(rgb), h, w, _u8p(out), out.nbytes, ctypes.byref(n))
    if rc != _OK:
        raise ValueError(f"JPEG encode of a {rgb.shape} image failed")
    return out[: n.value].tobytes()


def _check_image(img: np.ndarray, size) -> tuple[np.ndarray, int, int]:
    img = np.asarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise TypeError(f"resize takes (H, W[, C]) uint8 images, got {img.dtype} {img.shape}")
    w, h = (int(s) for s in size)
    if w < 1 or h < 1 or min(img.shape[:2]) < 1:
        raise ValueError(f"resize of a {img.shape} image to {size}")
    return img, w, h


def resize_bicubic(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) uint8 -> (size[1], size[0][, C]) uint8: PIL's
    `Image.resize(size)` (bicubic, width pass then height pass, each only when
    that size changes; an identity resize is a copy)."""
    img, w, h = _check_image(img, size)
    src = np.ascontiguousarray(img)
    c = 1 if src.ndim == 2 else src.shape[2]
    out = np.empty((h, w) + src.shape[2:], np.uint8)
    calls["resize_bicubic"] += 1
    rc = get_lib().rf_resize_bicubic(_u8p(src), src.shape[0], src.shape[1], c, _u8p(out), h, w)
    if rc != _OK:
        raise ValueError(f"resize of a {img.shape} image to {size} failed")
    return out


def _coeffs_ref(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray]:
    """Pillow's `precompute_coeffs` + `normalize_coeffs_8bpc` for the bicubic
    filter: (xmin (out,), integer coefficients (out, ksize)), zero past each
    output's window."""
    scale = float(np.float32(in_size)) / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum(np.trunc(center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum(np.trunc(center + support + 0.5).astype(np.int64), in_size) - xmin
    taps = np.arange(ksize)
    x = np.abs((taps[None, :] + xmin[:, None] - center[:, None] + 0.5) * (1.0 / filterscale))
    a = -0.5
    w = np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                 np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = _ordered_sum(w)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.where(w < 0, np.trunc(-0.5 + w * (1 << _PRECISION_BITS)),
                 np.trunc(0.5 + w * (1 << _PRECISION_BITS))).astype(np.int64)
    return xmin, k


def _ordered_sum(w: np.ndarray) -> np.ndarray:
    """Row sums added left to right (Pillow's `ww += w`), not pairwise."""
    ww = np.zeros((w.shape[0], 1))
    for j in range(w.shape[1]):
        ww[:, 0] += w[:, j]
    return ww


def _pass_ref(x: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One fixed-point bicubic pass of (H, W, C) int64 over `axis`."""
    xmin, k = _coeffs_ref(x.shape[axis], out_size)
    acc = np.full(x.shape[:axis] + (out_size,) + x.shape[axis + 1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    last = x.shape[axis] - 1
    for j in range(k.shape[1]):
        idx = np.minimum(xmin + j, last)
        taps = np.take(x, idx, axis=axis)
        kj = k[:, j].reshape((-1,) + (1,) * (x.ndim - axis - 1))
        acc += taps * kj
    return np.clip(acc >> _PRECISION_BITS, 0, 255)


def resize_ref(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """The plain numpy int64 version of `resize_bicubic`, bit for bit."""
    img, w, h = _check_image(img, size)
    x = img.reshape(img.shape[:2] + (-1,)).astype(np.int64)
    if x.shape[1] != w:
        x = _pass_ref(x, w, 1)
    if x.shape[0] != h:
        x = _pass_ref(x, h, 0)
    return x.astype(np.uint8).reshape((h, w) + img.shape[2:])


def png_unfilter(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Filtered PNG scanlines (h rows of a filter byte + stride bytes) ->
    (h, stride) uint8."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    out = np.empty((h, stride), np.uint8)
    calls["png_unfilter"] += 1
    if get_lib().rf_png_unfilter(_u8p(raw), h, stride, bpp, _u8p(out)) != _OK:
        raise ValueError("bad PNG filter type")
    return out


def png_unfilter_ref(raw: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """The plain numpy version of `png_unfilter` (None, Sub, Up vectorized per
    row; Average and Paeth sequential along the row)."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    rows = np.asarray(raw, np.uint8).reshape(h, stride + 1)
    for y in range(h):
        ftype, line = rows[y, 0], rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:  # Up
            cur = (line + prev) & 0xFF
        elif ftype in (3, 4):  # Average, Paeth: sequential along the row
            cur = line.copy()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (cur[x] + pred) & 0xFF
        else:
            raise ValueError(f"bad PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out
