"""Host image codecs of the data path: JPEG, BMP (and an ICO / CUR entry's
DIB), WebP, GIF, TIFF, JPEG 2000, PPM, TGA, PSD, QOI and DDS decoding,
Zstandard decompression, JPEG writing, PIL's bicubic resize and the PNG
unfilter, in C++ (`csrc/host/image_io.cpp`, `bmp.cpp`, `webp.cpp`,
`gif.cpp`, `tiff.cpp`, `zstd.cpp`, `jpeg2000.cpp`, `ppm.cpp`, `tga.cpp`,
`psd.cpp`, `qoi.cpp`, `dds.cpp`, over `status.h`, `codec_common.h` and
`bcn_tables.h`, built with g++ by `ops/kernel_build.py::build_host_all`,
bound with ctypes), beside their plain numpy versions.

  * `decode_jpeg`: every JPEG PIL's libjpeg-turbo 3.1 decodes at 8 bits,
    bit-exact to PIL's `Image.open(...).convert("RGB")`: sequential and
    progressive, Huffman or arithmetic-coded, and lossless frames; grey,
    YCbCr, RGB, CMYK and YCCK (libjpeg-turbo's default decode: the accurate
    integer IDCT in the 16-bit arithmetic of its x86-64 SIMD routines
    (jidctint-sse2.asm, whose AVX2 twin computes the same), so that
    coefficients past the 16-bit range give PIL's pixels there, block
    smoothing of progressive files whose scans leave AC coefficients 1-9
    unrefined, fancy upsampling, fixed-point YCbCr -> RGB, YCCK -> CMYK,
    then PIL's inverted CMYK and its CMYK -> RGB). On arm64 libjpeg-turbo
    runs a NEON IDCT, which is not copied: there PIL's pixels can differ
    from these where coefficients leave the 16-bit range.
  * `decode_bmp`: BMP as Pillow's BmpImagePlugin reads it (every header,
    palettes, 16/24/32 bits with their BITFIELDS layouts, RLE8 / RLE4);
    `decode_dib`: the DIB of an ICO or CUR entry, as its DibImageFile reads
    it there (half its height; `train/data.py` reads the directories).
  * `decode_jpeg2000`: a JP2 file or a J2K codestream as Pillow reads it
    through OpenJPEG 2.5.4 (every progression, POC, precincts, layers,
    every code-block style, ROI, PPM / PPT, SOP / EPH, tiles and
    tile-parts; the reversible 5/3 and the fp32 9/7 as OpenJPEG computes
    them) and its unpackers convert it (sub-sampled components, sYCC, CMYK,
    palettes, precisions and signs). HTJ2K and the features no fixture
    covers raise ValueError citing ROADMAP queue 1 entry 8b.
  * `decode_ppm`: the PPM family as Pillow's PpmImagePlugin reads it (P1-P6
    plain and raw at any maxval, Pf, P0CMYK, PyP, PyRGBA, PyCMYK).
  * `decode_tga`: TGA as Pillow's TgaImagePlugin reads it (types 1-3 and
    their RLE forms, colour maps from any first entry, 15-bit pixels, both
    orientations and the horizontal flip); TGA has no signature, and
    `utils/image_identify.py` tells it apart as PIL's plugin order does.
  * `decode_psd`: PSD's merged image (PsdImagePlugin's MODES, raw or
    PackBits, LAB through the littleCMS copy, CMYK through cmyk2rgb).
  * `decode_qoi`: QOI as Pillow's Python QoiDecoder reads it.
  * `decode_dds`: a DDS file's first surface as DdsImagePlugin reads it
    (bit masks, L, LA, P8, R8G8B8A8, BC1-BC7 as BcnDecode.c decodes them).
  * `decode_webp`: the first frame of a WebP file as libwebp's
    WebPAnimDecoder gives it to PIL (VP8 lossy with libwebp's fancy
    upsampling and fixed-point YUV -> RGB, VP8L lossless, ALPH), RGBA.
  * `decode_gif`: the first frame of a GIF file as Pillow's GifImagePlugin
    and `convert("RGB")` give it (its LZW decoder with every code size,
    clear and end codes, a full table; interlaced rows; local, global and
    short tables, grey without one; a frame smaller than the screen or
    reaching past it, on index 0 or the GCE's transparency index).
  * `decode_tiff`: the first image of a TIFF file as Pillow's
    TiffImagePlugin over libtiff and `convert("RGB")` give it, transposed
    by its Orientation: classic and BigTIFF, every OPEN_INFO layout, strips
    and tiles, planes; uncompressed data through Pillow's own unpackers, and
    PackBits, LZW (old-style codes too), Deflate and LZMA (inflated by
    Python's zlib and lzma), ZSTD (`zstd.cpp`), JPEG (JPEGTables, each strip
    through `image_io.cpp`'s decoder), old-style JPEG (the stream libtiff's
    tif_ojpeg.c rebuilds, decoded to raw components), ThunderScan, CCITT RLE
    / RLEW / Group 3 / Group 4, predictors 2 and 3 as libtiff decodes them;
    YCbCr through TIFFRGBAImage; LAB through a copy of PIL's littleCMS
    transform. The decoders have no plain version: PIL is their reference
    in the tests. What PIL refuses raises `ValueError` "... as PIL refuses
    it", and so do corrupt or truncated data.
  * `zstd_decompress`: every frame of Zstandard data (RFC 8878) as libzstd
    decodes it without a dictionary; the `zstandard` module is its
    reference in the tests.
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

_HOST = Path(__file__).resolve().parents[1] / "csrc" / "host"
SOURCE = _HOST / "image_io.cpp"
BMP_SOURCE, WEBP_SOURCE, GIF_SOURCE = _HOST / "bmp.cpp", _HOST / "webp.cpp", _HOST / "gif.cpp"
TIFF_SOURCE, ZSTD_SOURCE = _HOST / "tiff.cpp", _HOST / "zstd.cpp"
JPEG2000_SOURCE, PPM_SOURCE = _HOST / "jpeg2000.cpp", _HOST / "ppm.cpp"
TGA_SOURCE, PSD_SOURCE, QOI_SOURCE, DDS_SOURCE = _HOST / "tga.cpp", _HOST / "psd.cpp", _HOST / "qoi.cpp", _HOST / "dds.cpp"
# every host codec library, built together
SOURCES = (SOURCE, BMP_SOURCE, WEBP_SOURCE, GIF_SOURCE, TIFF_SOURCE, ZSTD_SOURCE, JPEG2000_SOURCE, PPM_SOURCE,
           TGA_SOURCE, PSD_SOURCE, QOI_SOURCE, DDS_SOURCE)
_OK, _REFUSED, _NEED_BUFFER = 0, -3, 1  # rf_* return codes; any other is corrupt input
_PRECISION_BITS = 32 - 8 - 2

calls: Counter = Counter()
_lib = None
_decoders: dict = {}


def get_lib() -> ctypes.CDLL:
    """The loaded C++ library (built on first use)."""
    global _lib
    if _lib is None:
        from ..ops.kernel_build import load_host

        lib = load_host(SOURCE)
        u8p = ctypes.POINTER(ctypes.c_uint8)
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


def _decoder(source: Path, name: str, extra_types=()):
    """The C function `name` of the host library built from `source`: (data,
    n, out, cap, dims, err, err_cap, *extra) -> return code."""
    fn = _decoders.get(name)
    if fn is None:
        from ..ops.kernel_build import load_host

        fn = getattr(load_host(source), name)
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                       ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int64, *extra_types]
        _decoders[name] = fn
    return fn


def _decode(source: Path, kind: str, data: bytes, channels: int, extra=(), extra_types=(),
            dims=None) -> np.ndarray:
    """Runs rf_<kind>_decode twice (size, then pixels) -> (H, W, channels)
    uint8; refused or corrupt data raises ValueError. `dims` receives what the
    function writes there ((H, W) and any more)."""
    fn = _decoder(source, f"rf_{kind}_decode", extra_types)
    data = bytes(data)
    dims = (ctypes.c_int32 * 2)() if dims is None else dims
    err = ctypes.create_string_buffer(256)
    rc = fn(data, len(data), None, 0, dims, err, len(err), *extra)
    if rc == _NEED_BUFFER:
        out = np.empty((dims[0], dims[1], channels), np.uint8)
        calls[f"decode_{kind}"] += 1
        rc = fn(data, len(data), _u8p(out), out.nbytes, dims, err, len(err), *extra)
    if rc == _OK:
        return out
    msg = err.value.decode("utf-8", "replace")
    raise ValueError(msg if rc == _REFUSED else f"corrupt {kind.upper()}: {msg}")


def decode_jpeg(data: bytes) -> np.ndarray:
    """JPEG bytes -> (H, W, 3) uint8 RGB, as PIL decodes them."""
    return _decode(SOURCE, "jpeg", data, 3)


def decode_bmp(data: bytes) -> np.ndarray:
    """BMP bytes -> (H, W, 3) uint8 RGB, as PIL decodes them."""
    return _decode(BMP_SOURCE, "bmp", data, 3)


def decode_gif(data: bytes) -> np.ndarray:
    """GIF bytes -> the (H, W, 3) uint8 RGB of its first frame, as PIL decodes
    them."""
    return _decode(GIF_SOURCE, "gif", data, 3)


def decode_dib(data: bytes, at: int) -> tuple[np.ndarray, int]:
    """The DIB of an ICO or CUR entry at byte `at` of `data` -> ((H / 2, W, 3)
    uint8 RGB, where its pixel data starts): Pillow's DibImageFile there, the
    AND mask's half left out."""
    dims = (ctypes.c_int32 * 3)()
    rgb = _decode(BMP_SOURCE, "dib", data, 3, (int(at),), (ctypes.c_int64,), dims)
    return rgb, dims[2]


def decode_jpeg2000(data: bytes) -> np.ndarray:
    """JPEG 2000 bytes (a JP2 file or a raw J2K codestream) -> (H, W, 3)
    uint8 RGB, as PIL decodes them through OpenJPEG 2.5.4."""
    return _decode(JPEG2000_SOURCE, "jpeg2000", data, 3)


def decode_ppm(data: bytes) -> np.ndarray:
    """Netpbm bytes (P1-P6, Pf and Pillow's P0CMYK, PyP, PyRGBA, PyCMYK) ->
    (H, W, 3) uint8 RGB, as PIL decodes them; P7 and PF raise ValueError, as
    PIL refuses them."""
    return _decode(PPM_SOURCE, "ppm", data, 3)


def decode_tga(data: bytes) -> np.ndarray:
    """TGA bytes -> (H, W, 3) uint8 RGB, as PIL decodes them (types 1, 2, 3
    and their RLE forms; `train/data.py::identify` tells a TGA file apart,
    which has no signature)."""
    return _decode(TGA_SOURCE, "tga", data, 3)


def decode_psd(data: bytes) -> np.ndarray:
    """PSD bytes -> the (H, W, 3) uint8 RGB of the merged image, as PIL
    decodes it (8-bit modes and bitmaps, raw or PackBits)."""
    return _decode(PSD_SOURCE, "psd", data, 3)


def decode_qoi(data: bytes) -> np.ndarray:
    """QOI bytes -> (H, W, 3) uint8 RGB, as PIL's QoiDecoder decodes them."""
    return _decode(QOI_SOURCE, "qoi", data, 3)


def decode_dds(data: bytes) -> np.ndarray:
    """DDS bytes -> the (H, W, 3) uint8 RGB of the first surface, as PIL
    decodes it (uncompressed masks, L, LA, P8, BC1-BC7)."""
    return _decode(DDS_SOURCE, "dds", data, 3)


# rf_tiff_decode's inflate: (kind 8 zlib / 34925 xz, src, n, dst, cap) -> bytes written (at most cap), or
# -1 - the bytes written before a data error
_INFLATE_FN = ctypes.CFUNCTYPE(ctypes.c_int64, ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                               ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64)


def decode_tiff(data: bytes) -> np.ndarray:
    """TIFF bytes -> the (H, W, 3) uint8 RGB of its first image, as PIL's
    `Image.open(...).convert("RGB")` gives them (after the Orientation
    transpose PIL applies on load). Deflate and LZMA data are inflated by
    Python's zlib and lzma, as libtiff inflates them; ZSTD data by
    `zstd.cpp`; JPEG and old-style JPEG data by `image_io.cpp`'s decoder.
    What PIL refuses raises ValueError."""
    import lzma
    import zlib

    failed: list = []

    def inflate(kind, src, n, dst, cap):
        def stream():
            return zlib.decompressobj() if kind == 8 else lzma.LZMADecompressor(lzma.FORMAT_XZ)

        raw = ctypes.string_at(src, n)
        try:
            try:
                out = stream().decompress(raw, cap)
            except (zlib.error, lzma.LZMAError, EOFError):
                # what libtiff's codec wrote before the fault: the data fed a byte at a time
                d, out = stream(), b""
                try:
                    for i in range(n):
                        out += d.decompress(raw[i:i + 1], cap - len(out))
                        if len(out) >= cap:
                            break
                except (zlib.error, lzma.LZMAError, EOFError):
                    pass
                ctypes.memmove(dst, out, len(out))
                return -1 - len(out)
        except BaseException as e:  # noqa: BLE001 - cannot cross the C frames: raised again after the call
            failed.append(e)
            return -1
        ctypes.memmove(dst, out, len(out))
        return len(out)

    jpeg = ctypes.cast(get_lib().rf_jpeg_tiff_decode, ctypes.c_void_p)
    zstd = ctypes.cast(_zstd_lib().rf_zstd_tiff_decode, ctypes.c_void_p)
    ojpeg = ctypes.cast(get_lib().rf_jpeg_ojpeg_decode, ctypes.c_void_p)
    cb = _INFLATE_FN(inflate)  # held for the calls
    try:
        return _decode(TIFF_SOURCE, "tiff", data, 3, (cb, jpeg, zstd, ojpeg),
                       (_INFLATE_FN, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p))
    except ValueError:
        if failed:  # the callback's own error, not the data's
            raise failed[0] from None
        raise


def _zstd_lib() -> ctypes.CDLL:
    from ..ops.kernel_build import load_host

    lib = load_host(ZSTD_SOURCE)
    lib.rf_zstd_decompress.restype = ctypes.c_int
    lib.rf_zstd_decompress.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_void_p),
                                       ctypes.POINTER(ctypes.c_int64), ctypes.c_char_p, ctypes.c_int64]
    lib.rf_zstd_free.restype = None
    lib.rf_zstd_free.argtypes = [ctypes.c_void_p]
    return lib


def zstd_decompress(data: bytes) -> bytes:
    """Zstandard data (every frame of it, skippable frames skipped) -> its
    content, as libzstd decodes it; damaged or truncated data, a frame that
    needs a dictionary and a window past 2^27 + 1 bytes raise ValueError."""
    data = bytes(data)
    lib = _zstd_lib()
    out, n = ctypes.c_void_p(), ctypes.c_int64()
    err = ctypes.create_string_buffer(256)
    calls["zstd_decompress"] += 1
    if lib.rf_zstd_decompress(data, len(data), ctypes.byref(out), ctypes.byref(n), err, len(err)) != _OK:
        raise ValueError(f"corrupt ZSTD: {err.value.decode('utf-8', 'replace')}")
    try:
        return ctypes.string_at(out, n.value) if n.value else b""
    finally:
        lib.rf_zstd_free(out)


def decode_webp(data: bytes) -> np.ndarray:
    """WebP bytes -> the (H, W, 4) uint8 RGBA that PIL opens (the first frame
    of an animation, on its transparent black canvas); PIL's
    `convert("RGB")` drops the alpha."""
    return _decode(WEBP_SOURCE, "webp", data, 4)


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
