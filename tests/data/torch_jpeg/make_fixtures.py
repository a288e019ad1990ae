"""Writes the image fixtures of this directory and their manifest with PIL.

    python tests/data/torch_jpeg/make_fixtures.py

Each image is a seeded smooth procedural RGB image with mild noise (the
1024x768 lossless timing files without the noise). Kinds of entry:
  * "jpeg": a file PIL wrote (sequential, progressive, grey, CMYK; YCCK and
    marker-less CMYK by patching PIL's Adobe segment; progressive files cut
    after some scans, which libjpeg smooths across blocks), or one written by
    the arithmetic (SOF9, SOF10) and lossless (SOF3) encoders below, or one
    whose quantizers were all set to 64 after PIL's save (`set_dqt`), with its
    encode settings, the sha256 of PIL's decode (`Image.open(...)
    .convert("RGB")`, (H, W, 3) uint8 bytes) and of PIL's bicubic
    `Image.resize` chains that the GenRef data path runs on it (a chain
    "1024x1024,512x512" resizes to 1024x1024, then that to 512x512);
  * "png": a file of every PNG colour type and bit depth (PLTE, tRNS, Adam7)
    written by `write_png` below, with the sha256 of PIL's decode;
  * "webp": a file PIL wrote (lossy at several qualities and methods,
    lossless at methods 0-6 with few or many colours, lossy and lossless
    alpha, a 2-frame animation; four lossless 448 px frames of `clip_frame`)
    with the sha256 of PIL's RGB decode and of its RGBA;
  * "bmp": a file of every header, depth, palette, bitfields and RLE kind,
    written by `write_bmp` below (PIL writes only raw 1 / L / P / RGB),
    with the sha256 of PIL's decode;
  * "gif": a file PIL wrote, or one written by `write_gif` below (local and
    short tables, interlaced rows, an offset sub-frame with a transparency
    index and extensions, code sizes 2 and 5, clear codes mid-stream, a full
    code table), with the sha256 of PIL's decode;
  * "tiff": a file PIL wrote or one written by `write_tiff` or
    `write_ojpeg` below (tiles, planes, BigTIFF, big-endian 16-bit, YCbCr
    JPEG with JPEGTables and Orientation 6, subsampled YCbCr, Group 3 2D with
    FillOrder 2, a 4-bit ColorMap, associated alpha, predictors 2 and 3,
    old-style LZW, LAB planes and a LAB grid through PIL's littleCMS
    transform, ZSTD, CCITT RLEW, ThunderScan, old-style JPEG; four 1024x768
    timing files), with the sha256 of PIL's decode;
  * "jpeg2000": a file PIL wrote over its save options, or one OpenJPEG's
    own encoder wrote (`opj_encode`, PIL's bundled libopenjp2 through
    ctypes: code-block styles, SOP / EPH, POC, RGN, tile-parts, sub-sampled
    and 4-component images, precisions), rewritten by `to_packed` (PPM /
    PPT) or `add_tlm`, or wrapped by `jp2_file` (sYCC, CMYK, a palette,
    bpcc, cdef, res, xml, an ICC colour box); two 1024x768 timing files;
  * "ico" / "cur": PIL's ICO save (PNG and DIB entries), a directory over two
    DIBs of one size, a CUR from PIL's DIB ICO (`ico_fixture`);
  * "ppm": PIL's PPM save and `ppm_fixture`'s raw and plain files of every
    magic PIL opens and every maxval kind;
  * "encode": a committed pixel array (`encode_pixels.npz`) with the sha256
    of PIL's default `save(format="JPEG")` of it.
`tests/test_torch_jpeg.py` checks the committed bytes against the manifest
with PIL and the port against it; `chip_smoke.py` phase 5e holds the port's
decoders, JPEG writer and resize to it on the card's machine, and phase 10
reads the clip frames.
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
    ("progressive_cut1_dc_33x17.jpg", (33, 17), 20, {"quality": 75, "progressive": True, "cut_scans": 1}, []),
    ("progressive_cut3_grey_50x31.jpg", (50, 31), 21,
     {"quality": 80, "progressive": True, "mode": "L", "cut_scans": 3}, []),
    ("progressive_cut5_1024x768.jpg", (1024, 768), 22, {"quality": 75, "progressive": True, "cut_scans": 5},
     ["1024x1024"]),
    ("cmyk_40x24_q85.jpg", (40, 24), 16, {"quality": 85, "mode": "CMYK"}, []),
    ("cmyk_no_adobe_40x24.jpg", (40, 24), 17, {"quality": 75, "mode": "CMYK", "adobe": None}, []),
    ("ycck_40x24.jpg", (40, 24), 18, {"quality": 75, "mode": "CMYK", "adobe": 2}, []),
    ("ycck_420_prog_41x23.jpg", (41, 23), 19,
     {"quality": 75, "mode": "CMYK", "progressive": True, "subsampling": 2, "adobe": 2}, []),
    # every quantizer made 64 after the save: coefficients past libjpeg-turbo's 16-bit IDCT lanes
    ("extreme_dqt64_420_64x48.jpg", (64, 48), 23, {"quality": 100, "subsampling": 2, "dqt": 64}, ["32x24"]),
]
# name, colour type, bit depth, interlaced, with tRNS; 19x13 pixels each
PNGS = [(f"png_c{c}_d{d}{'_adam7' if i else ''}{'_trns' if t else ''}.png", c, d, i, t) for c, d, i, t in [
    (0, 1, False, False), (0, 2, False, False), (0, 4, True, False), (0, 8, False, True), (0, 16, False, False),
    (0, 16, True, True), (2, 8, True, False), (2, 8, False, True), (2, 16, False, True), (2, 16, True, False),
    (3, 1, False, False), (3, 2, True, False), (3, 4, False, True), (3, 8, True, True), (4, 8, False, False),
    (4, 16, True, False), (6, 8, True, False), (6, 16, False, False)]]
ENCODE_SIZES = [(32, 32), (1, 1), (17, 9), (33, 65), (16, 48), (100, 37)]  # (W, H)
# arithmetic-coded and lossless JPEG: name, (W, H), seed, `write_arith_jpeg` /
# `write_lossless_jpeg` options (lossless: "smooth" drops the noise)
ARITH = [
    ("arith_seq_420_40x24.jpg", (40, 24), 400, {}),
    ("arith_seq_444_rst3_17x9.jpg", (17, 9), 401, {"sampling": ((1, 1), (1, 1), (1, 1)), "restart": 3}),
    ("arith_seq_422_dac_50x31.jpg", (50, 31), 402,
     {"sampling": ((2, 1), (1, 1), (1, 1)), "dac": {"L": 1, "U": 3, "K": 2}, "quality": 90}),
    ("arith_prog_420_67x45.jpg", (67, 45), 403, {"progressive": True}),
    ("arith_prog_420_rst2_dac_33x65.jpg", (33, 65), 404,
     {"progressive": True, "restart": 2, "dac": {"L": 0, "U": 0, "K": 63}, "quality": 60}),
    ("arith_prog_grey_33x17.jpg", (33, 17), 405, {"progressive": True, "grey": True}),
    ("arith_prog_420_1024x768.jpg", (1024, 768), 406, {"progressive": True}),
]
LOSSLESS = [(f"lossless_p{p}_pt{pt}_{w}x{h}.jpg", (w, h), 410 + p, {"predictor": p, "pt": pt})
            for p, pt, (w, h) in [(1, 0, (40, 24)), (2, 2, (17, 9)), (3, 0, (33, 17)), (4, 0, (40, 24)),
                                  (5, 2, (40, 24)), (6, 0, (23, 31)), (7, 2, (40, 24))]] + [
    ("lossless_p4_rst3_40x24.jpg", (40, 24), 420, {"predictor": 4, "restart_rows": 3}),
    ("lossless_p6_interleaved_rst2_40x24.jpg", (40, 24), 421,
     {"predictor": 6, "pt": 1, "interleaved": True, "restart_rows": 2}),
    ("lossless_p5_adobe0_33x17.jpg", (33, 17), 422, {"predictor": 5, "marker": "adobe0"}),
    ("lossless_p1_420_interleaved_40x24.jpg", (40, 24), 424, {"predictor": 1, "subsample": True}),
    ("lossless_p7_rst32_1024x768.jpg", (1024, 768), 425, {"predictor": 7, "restart_rows": 32, "smooth": True}),
]
# WebP: name, (W, H), seed, PIL save options, and "colours" (quantized to that
# many), "alpha" (an alpha channel), "frames" (an animation), "smooth"
WEBPS = [
    ("webp_lossy_1x1_q75.webp", (1, 1), 300, {"quality": 75}),
    ("webp_lossy_17x9_q30_m0.webp", (17, 9), 301, {"quality": 30, "method": 0}),
    ("webp_lossy_17x9_q90_m6.webp", (17, 9), 302, {"quality": 90, "method": 6}),
    ("webp_lossy_50x31_q10_m4.webp", (50, 31), 303, {"quality": 10}),
    ("webp_lossy_50x31_q100_m6.webp", (50, 31), 304, {"quality": 100, "method": 6}),
    ("webp_lossy_1024x768_q75.webp", (1024, 768), 305, {"quality": 75}),
    ("webp_lossless_50x31_m0.webp", (50, 31), 306, {"lossless": True, "method": 0}),
    ("webp_lossless_50x31_m6.webp", (50, 31), 307, {"lossless": True, "method": 6}),
    ("webp_lossless_33x17_3colours.webp", (33, 17), 308, {"lossless": True, "colours": 3}),
    ("webp_lossless_33x17_16colours.webp", (33, 17), 309, {"lossless": True, "colours": 16}),
    ("webp_lossless_40x24_200colours.webp", (40, 24), 310, {"lossless": True, "colours": 200}),
    ("webp_lossless_1024x768_m4.webp", (1024, 768), 311, {"lossless": True, "smooth": True}),
    ("webp_alpha_lossy_40x24_a50.webp", (40, 24), 312, {"quality": 70, "alpha_quality": 50, "alpha": True}),
    ("webp_alpha_lossless_40x24.webp", (40, 24), 313, {"lossless": True, "alpha": True}),
    ("webp_anim_2frames_40x30.webp", (40, 30), 314, {"quality": 80, "frames": 2}),
]
CLIP_FRAMES, CLIP_PX = 8, 448  # chip_smoke.py phase 10's frame directory: even frames WebP here, odd ones BMP
# BMP: name, bits, header size, compression, options ("palette": colours,
# "grey": Pillow's grey ramp, "colors": the header's count, "masks", "top_down",
# "wild": RLE only Pillow's reading defines); 37x23 pixels each
BMPS = [
    ("bmp_core_24.bmp", 24, 12, "raw", {}),
    ("bmp_core_8_pal.bmp", 8, 12, "raw", {"palette": 256}),
    ("bmp_info_1_pal.bmp", 1, 40, "raw", {"palette": 2}),
    ("bmp_info_4_pal_short.bmp", 4, 40, "raw", {"palette": 11, "colors": 11}),
    ("bmp_info_8_pal_short.bmp", 8, 40, "raw", {"palette": 100, "colors": 100}),
    ("bmp_info_8_grey.bmp", 8, 40, "raw", {"grey": True}),
    ("bmp_info_16_555.bmp", 16, 40, "raw", {}),
    ("bmp_info_16_565_bitfields.bmp", 16, 40, "bitfields", {"masks": (0xF800, 0x7E0, 0x1F)}),
    ("bmp_info_24_topdown.bmp", 24, 40, "raw", {"top_down": True}),
    ("bmp_info_32_bgrx.bmp", 32, 40, "raw", {}),
    ("bmp_v2_32_bitfields_xbgr.bmp", 32, 52, "bitfields", {"masks": (0xFF000000, 0xFF0000, 0xFF00)}),
    ("bmp_v3_32_bitfields_rgba.bmp", 32, 56, "bitfields", {"masks": (0xFF, 0xFF00, 0xFF0000, 0xFF000000)}),
    ("bmp_v4_16_555_bitfields.bmp", 16, 108, "bitfields", {"masks": (0x7C00, 0x3E0, 0x1F)}),
    ("bmp_v5_24.bmp", 24, 124, "raw", {}),
    ("bmp_v5_32_bitfields_bgra.bmp", 32, 124, "bitfields", {"masks": (0xFF0000, 0xFF00, 0xFF, 0xFF000000)}),
    ("bmp_rle8.bmp", 8, 40, "rle8", {"palette": 256}),
    ("bmp_rle8_wild.bmp", 8, 40, "rle8", {"palette": 256, "wild": True}),
    ("bmp_rle4.bmp", 4, 40, "rle4", {"palette": 16}),
    ("bmp_rle4_wild_topdown.bmp", 4, 40, "rle4", {"palette": 16, "wild": True, "top_down": True}),
]
# GIF: name, (W, H), seed, kind ("pil": PIL's save of the image in `mode`; else
# `gif_fixture`'s hand-written kinds), options
GIFS = [
    ("gif_pil_rgb_37x23.gif", (37, 23), 600, "pil", {"mode": "RGB"}),
    ("gif_pil_grey_37x23.gif", (37, 23), 601, "pil", {"mode": "L"}),
    ("gif_pil_interlaced_37x23.gif", (37, 23), 602, "pil", {"mode": "RGB", "interlace": True}),
    ("gif_interlaced_local_short_37x23.gif", (37, 23), 603, "local", {"interlace": True, "colors": 8}),
    ("gif_offset_trns_ext_37x23.gif", (37, 23), 604, "offset", {"transparency": 3}),
    ("gif_codesize2_37x23.gif", (37, 23), 605, "local", {"colors": 4, "global": False}),
    ("gif_codesize5_clears_37x23.gif", (37, 23), 606, "local", {"colors": 32, "lzw": {"clear_every": 50}}),
    ("gif_full_table_120x90.gif", (120, 90), 607, "local", {"colors": 256, "lzw": {"full": "keep"}}),
    ("gif_pil_1024x768.gif", (1024, 768), 608, "pil", {"mode": "RGB", "smooth": True}),
]
# TIFF: name, (W, H), seed, kind ("pil": PIL's save in `mode` with `compression`;
# "ojpeg": `write_ojpeg` of the procedural image; else `write_tiff` of it with
# the options), options. The 1024x768 files are chip_smoke.py phase 5e's
# timing files that it cannot write itself (LZW with predictor 2, JPEG YCbCr
# 4:2:0 with JPEGTables, ZSTD with predictor 2, old-style JPEG 4:2:0 with
# its tables in tags), from a smooth image.
TIFFS = [
    ("tiff_pil_rgb_lzw_37x23.tif", (37, 23), 700, "pil", {"mode": "RGB", "compression": "tiff_lzw"}),
    ("tiff_pil_1_group4_37x23.tif", (37, 23), 701, "pil", {"mode": "1", "compression": "group4"}),
    ("tiff_pil_cmyk_jpeg_37x23.tif", (37, 23), 702, "pil", {"mode": "CMYK", "compression": "jpeg"}),
    ("tiff_tiles_planar_deflate_37x23.tif", (37, 23), 703, "write",
     {"compression": 8, "tile": (16, 16), "planar": 2}),
    ("tiff_bigtiff_tiles_lzma_37x23.tif", (37, 23), 704, "write",
     {"compression": 34925, "tile": (32, 16), "bigtiff": True}),
    ("tiff_mm_rgb16_packbits_37x23.tif", (37, 23), 705, "write",
     {"compression": 32773, "order": ">", "bits": 16, "rows_per_strip": 5}),
    ("tiff_ycbcr_jpeg_420_orient6_37x23.tif", (23, 37), 706, "write",
     {"photometric": 6, "compression": 7, "subsampling": (2, 2), "rows_per_strip": 16, "orientation": 6}),
    ("tiff_ycbcr_21_lzw_37x23.tif", (37, 23), 707, "write",
     {"photometric": 6, "compression": 5, "subsampling": (2, 1), "rows_per_strip": 8, "ycbcr": True}),
    ("tiff_g3_2d_fillorder2_37x23.tif", (37, 23), 708, "write",
     {"photometric": 0, "bits": 1, "compression": 3, "t4options": 5, "fillorder": 2}),
    ("tiff_p4_colormap_37x23.tif", (37, 23), 709, "write", {"photometric": 3, "bits": 4, "palette": 16}),
    ("tiff_rgba_assoc_pred2_37x23.tif", (37, 23), 710, "write",
     {"compression": 8, "predictor": 2, "extra_samples": (1,), "alpha": True}),
    ("tiff_f32_pred3_mm_37x23.tif", (37, 23), 711, "write",
     {"photometric": 1, "bits": 32, "sample_format": 3, "compression": 5, "predictor": 3, "order": ">"}),
    ("tiff_old_lzw_orient3_37x23.tif", (37, 23), 712, "write", {"compression": 5, "old_lzw": True, "orientation": 3}),
    ("tiff_lab_planar_lzw_37x23.tif", (37, 23), 714, "write", {"photometric": 8, "compression": 5, "planar": 2}),
    ("tiff_lab_grid_1024x1024.tif", (1024, 1024), 715, "write",
     {"photometric": 8, "compression": 8, "predictor": 2, "rows_per_strip": 64, "lab_grid": True}),
    ("tiff_lzw_pred2_1024x768.tif", (1024, 768), 713, "write",
     {"compression": 5, "predictor": 2, "rows_per_strip": 64, "smooth": True}),
    ("tiff_jpeg_ycbcr_420_1024x768.tif", (1024, 768), 713, "write",
     {"photometric": 6, "compression": 7, "subsampling": (2, 2), "rows_per_strip": 16, "smooth": True}),
    ("tiff_pil_rgb_zstd_37x23.tif", (37, 23), 716, "pil", {"mode": "RGB", "compression": "tiff_zstd"}),
    ("tiff_zstd_pred2_tiles_37x23.tif", (37, 23), 717, "write",
     {"compression": 50000, "predictor": 2, "tile": (16, 16), "zstd_level": 19}),
    ("tiff_rlew_fillorder2_37x23.tif", (37, 23), 718, "write",
     {"photometric": 0, "bits": 1, "compression": 32771, "fillorder": 2, "rows_per_strip": 9}),
    ("tiff_thunderscan_37x23.tif", (37, 23), 719, "write",
     {"photometric": 1, "bits": 4, "compression": 32809, "rows_per_strip": 8}),
    ("tiff_ojpeg_tags_420_37x23.tif", (37, 23), 720, "ojpeg", {"subsampling": (2, 2), "rows_per_strip": 16}),
    ("tiff_ojpeg_jif_422_37x23.tif", (37, 23), 721, "ojpeg", {"subsampling": (2, 1), "source": "header"}),
    ("tiff_zstd_1024x768.tif", (1024, 768), 713, "write",
     {"compression": 50000, "predictor": 2, "rows_per_strip": 64, "smooth": True}),
    ("tiff_ojpeg_420_1024x768.tif", (1024, 768), 713, "ojpeg", {"subsampling": (2, 2), "rows_per_strip": 64,
                                                                 "smooth": True}),
]
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def procedural(w: int, h: int, seed: int, noise: float = 6.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    f = rng.uniform(0.004, 0.03, (3, 2))
    ph = rng.uniform(0, 2 * np.pi, (3, 2))
    img = np.stack([128 + 70 * np.sin(xx * f[c, 0] + ph[c, 0]) * np.cos(yy * f[c, 1] + ph[c, 1])
                    + 40 * np.sin((xx + yy) * f[c, 0] * 0.5) for c in range(3)], axis=-1)
    img += rng.normal(0.0, noise, img.shape)
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


def set_dqt(data: bytes, q: int) -> bytes:
    """Every quantizer of every DQT table set to q (8-bit tables)."""
    d, i = bytearray(data), 2
    while i < len(d):
        m, n = d[i + 1], (d[i + 2] << 8) | d[i + 3]
        if m == 0xDA:
            break
        if m == 0xDB:
            for j in range(i + 4, i + 2 + n, 65):
                d[j + 1:j + 65] = bytes([q]) * 64
        i += 2 + n
    return bytes(d)


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


def _bmp_header(hsize: int, w: int, h: int, bits: int, compression: int, size: int, colors: int,
                masks) -> bytes:
    """A BMP info header of `hsize` bytes (12: core; 40, 52, 56, 64, 108, 124:
    INFO and its successors, three masks inside at 52 bytes, four from 56)."""
    if hsize == 12:
        return struct.pack("<IHHHH", 12, w, h, 1, bits)
    head = struct.pack("<IiiHHIIiiII", hsize, w, h, 1, bits, compression, size, 2835, 2835, colors, 0)
    if hsize >= 52:
        nmasks = 3 if hsize == 52 else 4
        head += struct.pack(f"<{nmasks}I", *(list(masks or ()) + [0] * 4)[:nmasks])
    return head + bytes(hsize - len(head))


def _bmp_rows(samples: np.ndarray, bits: int) -> bytes:
    """(h, w) indices or (h, w, k) byte groups -> rows padded to 4 bytes, in
    file order (the caller flips for bottom-up)."""
    h = samples.shape[0]
    if bits < 8:
        rows = _pack(samples.reshape(h, -1, 1), bits)
    else:
        rows = samples.reshape(h, -1).astype(np.uint8)
    pad = (-rows.shape[1]) % 4
    return np.pad(rows, ((0, 0), (0, pad))).tobytes()


def bmp_rle(indices: np.ndarray, rle4: bool, rng, wild: bool = False) -> bytes:
    """RLE8 / RLE4 data of (h, w) indices in file (bottom-up) order: encoded
    and absolute runs (odd lengths padded to 16 bits), end-of-line, a delta
    over zero pixels now and then, end of bitmap. `wild` adds what only
    Pillow's reading defines: runs past the row's end, absolute runs that
    wrap into the next row, rows without end-of-line."""
    out = bytearray()
    h, w = indices.shape
    for y in range(h):
        row = [int(v) for v in indices[y]]
        x = 0
        while x < w:
            n = int(rng.integers(1, 12))
            if wild and rng.random() < 0.1:
                n += w  # a run past the row's end
            if rng.random() < 0.5 or n < 3:  # encoded run
                n = min(n, 255)
                v = (row[x] << 4) | row[min(x + 1, w - 1)] if rle4 else row[x]
                out += bytes([n, v])
                x += n
            else:  # absolute run
                n = min(n, w - x if not wild else n, 255)
                if n < 3:
                    out += bytes([1, (row[x] << 4) if rle4 else row[x]])
                    x += 1
                    continue
                vals = (row + [0] * 300)[x:x + n]
                if rle4:
                    vals = vals + [0] * (n % 2)
                    body = bytes((vals[i] << 4) | vals[i + 1] for i in range(0, n, 2))
                else:
                    body = bytes(vals)
                out += bytes([0, n]) + body + bytes(len(body) % 2)
                x += n
        if not (wild and rng.random() < 0.3):
            out += b"\x00\x00"  # end of line
        if y + 1 < h and rng.random() < 0.1:  # delta: Pillow reads two bytes, then (right, up)
            out += b"\x00\x02\x00\x00" + bytes([int(rng.integers(0, 3)), 0])
    return bytes(out + b"\x00\x01")


def write_bmp(pixels: np.ndarray, bits: int, hsize: int = 40, compression: str = "raw", palette=None,
              colors: int = 0, masks=None, top_down: bool = False, rng=None, wild: bool = False) -> bytes:
    """A BMP file. `pixels`: (h, w) palette indices for bits <= 8, else
    (h, w, 3) RGB; `palette`: (n, 3) RGB; `compression`: "raw", "rle8",
    "rle4" or "bitfields" with `masks` (r, g, b[, a]); `colors`: the header's
    colour count (0: 2^bits)."""
    h, w = pixels.shape[:2]
    comp = {"raw": 0, "rle8": 1, "rle4": 2, "bitfields": 3}[compression]
    if bits <= 8:
        data = pixels.astype(np.uint8)
    elif bits == 16:
        r, g, b = (pixels[..., i].astype(np.uint32) for i in range(3))
        if masks is not None and tuple(masks[:3]) == (0xF800, 0x7E0, 0x1F):
            v = ((r >> 3) << 11) | ((g >> 2) << 5) | (b >> 3)
        else:
            v = ((r >> 3) << 10) | ((g >> 3) << 5) | (b >> 3)
        data = v.astype("<u2").view(np.uint8).reshape(h, w, 2)
    elif bits == 24:
        data = pixels[..., ::-1]
    else:
        m = list(masks or (0xFF0000, 0xFF00, 0xFF, 0))
        m += [0] * (4 - len(m))
        v = np.zeros((h, w), np.uint32)
        alpha = np.full((h, w), 0x5A, np.uint32)
        for chan, mask in zip((pixels[..., 0], pixels[..., 1], pixels[..., 2], alpha), m):
            if mask:
                v |= chan.astype(np.uint32) << ((mask & -mask).bit_length() - 1)
        data = v.astype("<u4").view(np.uint8).reshape(h, w, 4)
    rows = data if top_down else data[::-1]
    if compression in ("rle8", "rle4"):
        body = bmp_rle(np.asarray(rows), compression == "rle4", rng or np.random.default_rng(0), wild)
    else:
        body = _bmp_rows(np.asarray(rows), bits)
    pal = b""
    if palette is not None:
        pad = 3 if hsize == 12 else 4
        pal = b"".join(bytes([int(c[2]), int(c[1]), int(c[0])]) + bytes(pad - 3) for c in palette)
    extra = struct.pack("<III", *masks[:3]) if comp == 3 and hsize == 40 else b""
    head = _bmp_header(hsize, w, -h if top_down else h, bits, comp, len(body), colors, masks)
    off = 14 + len(head) + len(extra) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + head + extra + pal + body


# ------------------------------------------------------------------ GIF ----
#
# PIL writes GIF with its own LZW encoder (one clear code, 8 bits at most);
# `write_gif` writes what PIL does not: every code size, local and short
# tables, interlaced rows, sub-frames, extensions, clear codes mid-stream, a
# full code table, missing end codes, codes past the table and cut data.

INTERLACE_PASSES = ((0, 8), (4, 8), (2, 4), (1, 2))  # (first row, step)


def lzw_codes(indices, bits: int, clear_first: bool = True, end: bool = True, clear_every: int = 0,
              full: str = "clear", literal: bool = False) -> list:
    """GIF LZW codes of a flat index sequence as (code, width) pairs, each
    width the one Pillow's decoder reads it with (its table grows by one entry
    a code after the first of a run, and the width with it when the entry
    fills the code space; for bits <= 1 it never grows). `clear_every`: a
    clear code after that many codes; `full`: "clear" resets a full table
    (4096 codes), "keep" goes on with 12-bit codes and no new entries;
    `literal`: no string codes, one code a pixel."""
    clear, eoi = 1 << bits, (1 << bits) + 1
    out = []
    state = {}

    def reset():
        state.update(table={(v,): v for v in range(clear)}, next=clear + 2, dec_next=clear + 2, cs=bits + 1,
                     n=0)

    def emit(code):
        out.append((code, state["cs"]))
        if state["n"] > 0 and state["dec_next"] < 4096:  # Pillow's decoder adds an entry
            if state["dec_next"] == (1 << state["cs"]) - 1 and state["cs"] < 12:
                state["cs"] += 1
            state["dec_next"] += 1
        state["n"] += 1

    reset()
    if clear_first:
        out.append((clear, state["cs"]))
    w = ()
    for v in (int(x) for x in indices):
        wc = w + (v,)
        if not literal and wc in state["table"]:
            w = wc
            continue
        if w:
            emit(state["table"][w])
            if state["next"] < 4096:
                state["table"][wc] = state["next"]
                state["next"] += 1
            if (clear_every and state["n"] >= clear_every) or (state["next"] >= 4096 and full == "clear"):
                out.append((clear, state["cs"]))
                reset()
        w = (v,)
    if w:
        emit(state["table"][w])
    if end:
        out.append((eoi, state["cs"]))
    return out


def pack_codes(codes) -> bytes:
    """(code, width) pairs -> bytes, least significant bit first."""
    acc = nbits = 0
    out = bytearray()
    for code, width in codes:
        acc |= (code & ((1 << width) - 1)) << nbits
        nbits += width
        while nbits >= 8:
            out.append(acc & 0xFF)
            acc >>= 8
            nbits -= 8
    if nbits:
        out.append(acc & 0xFF)
    return bytes(out)


def sub_blocks(data: bytes, size: int = 255, terminator: bool = True) -> bytes:
    """Data as GIF sub-blocks of `size` bytes (the last shorter), then a zero
    block."""
    out = b"".join(bytes([len(data[i:i + size])]) + data[i:i + size] for i in range(0, len(data), size))
    return out + (b"\x00" if terminator else b"")


def gif_palette(colors) -> bytes:
    return np.asarray(colors, np.uint8).reshape(-1).tobytes()


def gif_image(indices, x: int = 0, y: int = 0, palette=None, interlace: bool = False, bits: int = 0,
              block: int = 255, lzw: dict | None = None, codes=None) -> bytes:
    """An image descriptor, its local table (`palette`: 2^k colours) and its
    LZW data of (h, w) `indices`. `bits`: the minimum code size (default:
    enough for the largest index, at least 2); `codes`: (code, width) pairs
    written as they are."""
    idx = np.asarray(indices)
    h, w = idx.shape
    flags = 0
    pal = b""
    if palette is not None:
        n = len(palette)
        k = max(1, (n - 1).bit_length())
        flags |= 0x80 | (k - 1)
        pal = gif_palette(palette)
    if interlace:
        flags |= 0x40
        idx = np.concatenate([idx[a::s] for a, s in INTERLACE_PASSES])
    bits = bits or max(2, int(idx.max(initial=0)).bit_length())
    if codes is None:
        codes = lzw_codes(idx.reshape(-1), bits, **(lzw or {}))
    return (b"," + struct.pack("<HHHHB", x, y, w, h, flags) + pal + bytes([bits])
            + sub_blocks(pack_codes(codes), block))


def gif_gce(transparency=None, disposal: int = 0, delay: int = 0) -> bytes:
    flags = (disposal << 2) | (transparency is not None)
    return b"!\xf9\x04" + struct.pack("<BHB", flags, delay, transparency or 0) + b"\x00"


def gif_extension(label: int, *blocks: bytes) -> bytes:
    return b"!" + bytes([label]) + b"".join(bytes([len(b)]) + b for b in blocks) + b"\x00"


def write_gif(size, blocks, palette=None, background: int = 0, version: bytes = b"GIF89a",
              trailer: bool = True) -> bytes:
    """A GIF file: the logical screen (W, H), its global table (`palette`:
    2^k colours, or None), then `blocks` (bytes from `gif_image`, `gif_gce`,
    `gif_extension`) and the trailer."""
    w, h = size
    flags = 0
    pal = b""
    if palette is not None:
        k = max(1, (len(palette) - 1).bit_length())
        flags = 0x80 | 0x70 | (k - 1)
        pal = gif_palette(palette)
    return (version + struct.pack("<HHBBB", w, h, flags, background, 0) + pal + b"".join(blocks)
            + (b";" if trailer else b""))


# ------------------------------------------- JPEG kinds PIL cannot write ----
#
# PIL writes only Huffman-coded DCT JPEG. The arithmetic-coded and lossless
# fixtures come from the small encoders below; PIL's decode of each file is
# its truth.

# T.81 Table D.2 (Qe, Next_Index_MPS, Switch_MPS, Next_Index_LPS), packed as
# libjpeg's jaricom.c packs it: (Qe << 16) | (NMPS << 8) | (SWITCH << 7) | NLPS.
ARITAB = [
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171,
]
STD_LUM_Q = [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55, 14, 13, 16, 24, 40, 57, 69, 56, 14, 17,
             22, 29, 51, 87, 80, 62, 18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92, 49, 64, 78,
             87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99]
STD_CHR_Q = [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4 + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38
ZIGZAG = [0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5, 12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7,
          14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46,
          53, 60, 61, 54, 47, 55, 62, 63]
# T.81 Annex K.3 table K.3: the luminance DC code lengths (categories 0-11).
DC_BITS = [0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0]


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


_JFIF = _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def _adobe(transform: int) -> bytes:
    return _segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00" + bytes([transform]))


class ArithEncoder:
    """T.81 Annex D's QM coder as libjpeg's jcarith.c runs it (arith_encode,
    finish_pass), with its statistics bins."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self) -> None:
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, b: int) -> None:
        self.out.append(b)

    def _flush_zeros(self) -> None:
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: bytearray, i: int, val: int) -> None:
        sv = st[i]
        qe = ARITAB[sv & 0x7F]
        nl, nm, qe = qe & 0xFF, (qe >> 8) & 0xFF, qe >> 16
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self) -> None:
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)


def _quant_table(base, quality: int) -> list:
    """libjpeg's jpeg_quality_scaling of a base table (natural order)."""
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [min(255, max(1, (q * scale + 50) // 100)) for q in base]


def dct_components(rgb: np.ndarray, sampling, quality: int = 75):
    """(H, W, 3) RGB (or (H, W) grey) -> [(h, v, quant (64, natural), coef
    (bh, bw, 64) int, natural order)], the MCU grid's blocks with the image
    edge-replicated: JFIF YCbCr, box-averaged chroma, a float DCT rounded to
    the quantizer. Any close encoding does: PIL's decode of the file is the
    truth."""
    planes = [rgb.astype(np.float64)] if rgb.ndim == 2 else None
    if planes is None:
        r, g, b = (rgb[..., i].astype(np.float64) for i in range(3))
        planes = [0.299 * r + 0.587 * g + 0.114 * b, -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                  0.5 * r - 0.418688 * g - 0.081312 * b + 128]
    h_img, w_img = planes[0].shape
    maxh, maxv = max(s[0] for s in sampling), max(s[1] for s in sampling)
    mcux, mcuy = -(-w_img // (8 * maxh)), -(-h_img // (8 * maxv))
    full = [np.pad(p, ((0, mcuy * 8 * maxv - h_img), (0, mcux * 8 * maxh - w_img)), mode="edge") for p in planes]
    k = np.arange(8)
    cos = np.cos((2 * k[:, None] + 1) * k[None, :] * np.pi / 16)
    cu = np.where(k == 0, 1 / np.sqrt(2), 1.0)
    out = []
    for ci, (p, (h, v)) in enumerate(zip(full, sampling)):
        fy, fx = maxv // v, maxh // h
        p = p.reshape(p.shape[0] // fy, fy, p.shape[1] // fx, fx).mean(axis=(1, 3)) - 128
        q = np.array(_quant_table(STD_LUM_Q if ci == 0 else STD_CHR_Q, quality), np.float64)
        bh, bw = p.shape[0] // 8, p.shape[1] // 8
        blocks = p.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
        dct = 0.25 * np.einsum("ij,...jk,kl->...il", (cos * cu[None, :]).T, blocks, cos * cu[None, :])
        coef = np.rint(dct / q.reshape(8, 8)).astype(np.int64).reshape(bh, bw, 64)
        out.append((h, v, q.astype(np.int64), coef))
    return out, w_img, h_img


PROGRESSIVE_SCRIPT = [  # libjpeg's jpeg_simple_progression for YCbCr: (components, Ss, Se, Ah, Al)
    ((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2),
    ((0,), 1, 63, 2, 1), ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0)]


def _arith_scan(comps, w_img, h_img, sel, ss, se, ah, al, restart, dac, enc: ArithEncoder) -> None:
    """One arithmetic-coded scan (jcarith.c encode_mcu / _DC_first /
    _DC_refine / _AC_first / _AC_refine) of the components `sel`."""
    maxh, maxv = max(c[0] for c in comps), max(c[1] for c in comps)
    progressive = ah or al or se < 63
    dc_stats = {i: bytearray(64) for i in range(4)}
    ac_stats = {i: bytearray(256) for i in range(4)}
    fixed = bytearray([113])
    last_dc, dc_ctx = [0] * len(sel), [0] * len(sel)
    dc_l, dc_u, ac_k = dac.get("L", 0), dac.get("U", 1), dac.get("K", 5)

    def code_dc(i, tbl, m):
        st = dc_stats[tbl]
        s0 = dc_ctx[i]
        v = m - last_dc[i]
        if v == 0:
            enc.encode(st, s0, 0)
            dc_ctx[i] = 0
            return
        last_dc[i] = m
        enc.encode(st, s0, 1)
        if v > 0:
            enc.encode(st, s0 + 1, 0)
            at, dc_ctx[i] = s0 + 2, 4
        else:
            v = -v
            enc.encode(st, s0 + 1, 1)
            at, dc_ctx[i] = s0 + 3, 8
        m = 0
        v -= 1
        if v:
            enc.encode(st, at, 1)
            m, v2, at = 1, v, 20
            v2 >>= 1
            while v2:
                enc.encode(st, at, 1)
                m <<= 1
                at += 1
                v2 >>= 1
        enc.encode(st, at, 0)
        if m < (1 << dc_l) >> 1:
            dc_ctx[i] = 0
        elif m > (1 << dc_u) >> 1:
            dc_ctx[i] += 8
        at += 14
        m >>= 1
        while m:
            enc.encode(st, at, 1 if m & v else 0)
            m >>= 1

    def mag(st, at, k, v):  # Figures F.8 / F.9 after the sign
        m = 0
        v -= 1
        if v:
            enc.encode(st, at, 1)
            m, v2 = 1, v >> 1
            if v2:
                enc.encode(st, at, 1)
                m <<= 1
                at = 189 if k <= ac_k else 217
                v2 >>= 1
                while v2:
                    enc.encode(st, at, 1)
                    m <<= 1
                    at += 1
                    v2 >>= 1
        enc.encode(st, at, 0)
        at += 14
        m >>= 1
        while m:
            enc.encode(st, at, 1 if m & v else 0)
            m >>= 1

    def shifted(x, a):  # |x| >> a with its sign
        return (x >> a) if x >= 0 else -((-x) >> a)

    def code_ac(st, blk):
        ke = se
        while ke > 0 and shifted(blk[ZIGZAG[ke]], al) == 0:
            ke -= 1
        k = max(ss, 1)
        while k <= ke:
            at = 3 * (k - 1)
            enc.encode(st, at, 0)
            while shifted(blk[ZIGZAG[k]], al) == 0:
                enc.encode(st, at + 1, 0)
                at += 3
                k += 1
            v = shifted(blk[ZIGZAG[k]], al)
            enc.encode(st, at + 1, 1)
            enc.encode(fixed, 0, 0 if v > 0 else 1)
            mag(st, at + 2, k, abs(v))
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def code_ac_refine(st, blk):
        ke = se
        while ke > 0 and abs(blk[ZIGZAG[ke]]) >> al == 0:
            ke -= 1
        kex = ke
        while kex > 0 and abs(blk[ZIGZAG[kex]]) >> ah == 0:
            kex -= 1
        k = ss
        while k <= ke:
            at = 3 * (k - 1)
            if k > kex:
                enc.encode(st, at, 0)
            while True:
                x = blk[ZIGZAG[k]]
                v = abs(x) >> al
                if v:
                    if v >> 1:
                        enc.encode(st, at + 2, v & 1)
                    else:
                        enc.encode(st, at + 1, 1)
                        enc.encode(fixed, 0, 0 if x > 0 else 1)
                    break
                enc.encode(st, at + 1, 0)
                at += 3
                k += 1
            k += 1
        if k <= se:
            enc.encode(st, 3 * (k - 1), 1)

    def dc_value(x):
        return x >> al  # arithmetic shift, as libjpeg's IRIGHT_SHIFT

    if len(sel) == 1:
        h, v, _, coef = comps[sel[0]]
        dw = -(-w_img * h // maxh)
        dh = -(-h_img * v // maxv)
        units = [[(0, (by, bx))] for by in range(-(-dh // 8)) for bx in range(-(-dw // 8))]
    else:
        mcux, mcuy = -(-w_img // (8 * maxh)), -(-h_img // (8 * maxv))
        units = [[(i, (my * comps[ci][1] + y, mx * comps[ci][0] + x)) for i, ci in enumerate(sel)
                  for y in range(comps[ci][1]) for x in range(comps[ci][0])]
                 for my in range(mcuy) for mx in range(mcux)]
    rst = 0
    for n, unit in enumerate(units):
        if restart and n and n % restart == 0:
            enc.finish()
            enc.out += bytes([0xFF, 0xD0 + rst])
            rst = (rst + 1) & 7
            enc.reset()
            for i, ci in enumerate(sel):
                if not progressive or (ss == 0 and ah == 0):
                    dc_stats[ci if ci < 1 else 1][:] = bytes(64)
                    last_dc[i] = dc_ctx[i] = 0
                if not progressive or se:
                    ac_stats[ci if ci < 1 else 1][:] = bytes(256)
        for i, (by, bx) in unit:
            ci = sel[i]
            tbl = 0 if ci == 0 else 1
            blk = comps[ci][3][by, bx]
            if not progressive:
                code_dc(i, tbl, int(blk[0]))
                code_ac(ac_stats[tbl], [int(x) for x in blk])
            elif ss == 0 and ah == 0:
                code_dc(i, tbl, dc_value(int(blk[0])))
            elif ss == 0:
                enc.encode(fixed, 0, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                code_ac(ac_stats[tbl], [int(x) for x in blk])
            else:
                code_ac_refine(ac_stats[tbl], [int(x) for x in blk])
    enc.finish()


def write_arith_jpeg(rgb: np.ndarray, sampling=((2, 2), (1, 1), (1, 1)), quality: int = 75,
                     progressive: bool = False, restart: int = 0, dac=None) -> bytes:
    """An arithmetic-coded JPEG (SOF9, or SOF10 with libjpeg's progressive
    script) of an RGB or grey image, JFIF, with a DRI segment for `restart`
    MCUs and a DAC segment for `dac` = {"L": .., "U": .., "K": ..} (the
    conditioning of every table, T.81 defaults 0, 1, 5 where left out)."""
    grey = rgb.ndim == 2
    sampling = ((1, 1),) if grey else tuple(sampling)
    comps, w_img, h_img = dct_components(rgb, sampling, quality)
    dac = dict(dac or {})
    out = b"\xff\xd8" + _JFIF
    for t in range(1 if grey else 2):
        out += _segment(0xDB, bytes([t]) + bytes(int(comps[t][2][z]) for z in ZIGZAG))
    sof = struct.pack(">BHHB", 8, h_img, w_img, len(comps))
    for ci, (h, v, _, _) in enumerate(comps):
        sof += bytes([ci + 1, (h << 4) | v, 0 if ci == 0 else 1])
    out += _segment(0xCA if progressive else 0xC9, sof)
    if dac:
        body = b""
        for t in range(1 if grey else 2):
            body += bytes([t, (dac.get("U", 1) << 4) | dac.get("L", 0), 0x10 | t, dac.get("K", 5)])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if not progressive:
        script = [(tuple(range(len(comps))), 0, 63, 0, 0)]
    elif grey:
        script = [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                  ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)]
    else:
        script = PROGRESSIVE_SCRIPT
    for sel, ss, se, ah, al in script:
        sos = bytes([len(sel)]) + b"".join(bytes([ci + 1, 0 if ci == 0 else 0x11]) for ci in sel)
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        enc = ArithEncoder()
        _arith_scan(comps, w_img, h_img, sel, ss, se, ah, al, restart, dac, enc)
        out += bytes(enc.out)
    return out + b"\xff\xd9"


def _huffman_codes(bits):
    """Canonical codes of a DHT bits list (lengths 1..16): [(code, length)]."""
    out, code = [], 0
    for length in range(1, 17):
        for _ in range(bits[length - 1]):
            out.append((code, length))
            code += 1
        code <<= 1
    return out


def write_lossless_jpeg(img: np.ndarray, predictor: int, pt: int = 0, restart_rows: int = 0,
                        marker: str = "jfif", sampling=None, interleaved: bool = False, ids=None) -> bytes:
    """A lossless JPEG (SOF3, T.81 Annex H) of (H, W[, C]) uint8 samples at
    8-bit precision: predictor 1-7, point transform `pt`, restart every
    `restart_rows` MCU rows, one scan a component (or one interleaved scan),
    the luminance DC Huffman table for every difference. `marker`: "jfif",
    "adobe0" / "adobe1" (transform) or "none"; `img` may be a list of
    planes, each at its resolution under `sampling` ((h, v) a component,
    1x1 by default)."""
    if isinstance(img, (list, tuple)):
        planes = list(img)
    else:
        planes = [img] if img.ndim == 2 else [img[..., i] for i in range(img.shape[2])]
    sampling = sampling or [(1, 1)] * len(planes)
    maxh, maxv = max(s[0] for s in sampling), max(s[1] for s in sampling)
    h_img, w_img = planes[0].shape[0] * maxv // sampling[0][1], planes[0].shape[1] * maxh // sampling[0][0]
    codes = _huffman_codes(DC_BITS)
    out = b"\xff\xd8" + {"jfif": _JFIF, "adobe0": _adobe(0), "adobe1": _adobe(1), "none": b""}[marker]
    ids = ids or list(range(1, len(planes) + 1))
    sof = struct.pack(">BHHB", 8, h_img, w_img, len(planes))
    for ci, (h, v) in enumerate(sampling):
        sof += bytes([ids[ci], (h << 4) | v, 0])
    out += _segment(0xC3, sof)
    out += _segment(0xC4, bytes([0]) + bytes(DC_BITS) + bytes(range(12)))
    mcux = -(-w_img // maxh) if interleaved else None
    if restart_rows:
        per_row = mcux if interleaved else None
        if not interleaved:  # one scan a component: a component's MCU is one sample
            per_row = planes[0].shape[1]
            if len({p.shape[1] for p in planes}) > 1:
                raise ValueError("restart rows need components of one width")
        out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
    scans = [list(range(len(planes)))] if interleaved else [[ci] for ci in range(len(planes))]
    for sel in scans:
        out += _segment(0xDA, bytes([len(sel)]) + b"".join(bytes([ids[ci], 0]) for ci in sel)
                        + bytes([predictor, 0, pt]))
        # the differences, per component, at each sample of its plane
        diffs = {}
        for ci in sel:
            x = planes[ci].astype(np.int64) >> pt
            hh, ww = x.shape
            rows_per_restart = restart_rows * (sampling[ci][1] if interleaved else 1) if restart_rows else hh
            d = np.zeros_like(x)
            for y in range(hh):
                first = y % rows_per_restart == 0
                for xx in range(ww):
                    if first:
                        px = (1 << (8 - pt - 1)) if xx == 0 else x[y, xx - 1]
                    elif xx == 0:
                        px = x[y - 1, 0]
                    else:
                        ra, rb, rc = int(x[y, xx - 1]), int(x[y - 1, xx]), int(x[y - 1, xx - 1])
                        px = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
                              6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[predictor]
                    d[y, xx] = (int(x[y, xx]) - px) & 0xFFFF
            diffs[ci] = d
        bits = []

        def put(value, n):
            bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))

        def code(diff):
            diff = diff - 65536 if diff >= 32768 else diff
            s = abs(diff).bit_length()
            c, n = codes[s]
            put(c, n)
            if 0 < s < 16:
                put(diff if diff > 0 else diff + (1 << s) - 1, s)

        segments = []
        if interleaved:
            mcuy = -(-h_img // maxv)
            for my in range(mcuy):
                if restart_rows and my and my % restart_rows == 0:
                    segments.append(bits)
                    bits = []
                for mx in range(mcux):
                    for ci in sel:
                        h, v = sampling[ci]
                        pd = diffs[ci]
                        for y in range(v):
                            for x in range(h):
                                yy, xx = my * v + y, mx * h + x
                                code(int(pd[yy, xx]) if yy < pd.shape[0] and xx < pd.shape[1] else 0)
        else:
            pd = diffs[sel[0]]
            for y in range(pd.shape[0]):
                if restart_rows and y and y % restart_rows == 0:
                    segments.append(bits)
                    bits = []
                for x in range(pd.shape[1]):
                    code(int(pd[y, x]))
        segments.append(bits)
        for i, seg in enumerate(segments):
            if i:
                out += bytes([0xFF, 0xD0 + (i - 1) % 8])
            seg = seg + [1] * (-len(seg) % 8)
            data = bytearray()
            for j in range(0, len(seg), 8):
                b = int("".join(map(str, seg[j:j + 8])), 2)
                data.append(b)
                if b == 0xFF:
                    data.append(0)
            out += bytes(data)
    return out + b"\xff\xd9"


# ------------------------------------------------------------------- TIFF ----
#
# `write_tiff` writes what PIL's TIFF writer cannot: tiles, planes, BigTIFF,
# either byte order, FillOrder 2, any Orientation, YCbCr (subsampled, and
# JPEG-compressed with shared JPEGTables), predictors 2 and 3, old-style LZW
# codes, CCITT RLE / Group 3 (1D and 2D) / Group 4, and every OPEN_INFO layout.

TIFF_TYPES = {1: "B", 2: "s", 3: "H", 4: "I", 5: "II", 7: "s", 8: "h", 9: "i", 10: "ii", 11: "f", 12: "d", 16: "Q"}


def packbits_encode(data: bytes) -> bytes:
    """PackBits: runs of 3+ equal bytes as (1 - n, b), the rest literally."""
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        j = i
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        if j - i >= 3:
            out += bytes([(257 - (j - i)) & 0xFF, data[i]])
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def tiff_lzw_encode(data: bytes, old: bool = False) -> bytes:
    """TIFF LZW: a leading clear, codes MSB-first growing one code early
    (libtiff's LZWDecode), or with `old` the pre-6.0 LSB-first codes growing at
    the table's size (LZWDecodeCompat); a clear before the table fills; EOI."""
    codes, width = [], 9
    table, nxt, dec_free, first = {}, 258, 258, True

    def emit(code):
        nonlocal width, dec_free, first
        codes.append((code, width))
        if code == 256:
            width, dec_free, first = 9, 258, True
            return
        if not first:
            dec_free += 1
            if dec_free > (1 << width) - (1 if old else 2):
                width = min(width + 1, 12)
        first = False

    emit(256)
    w = b""
    for c in data:
        wc = w + bytes([c])
        if len(wc) == 1 or wc in table:
            w = wc
            continue
        emit(table[w] if len(w) > 1 else w[0])
        table[wc] = nxt
        nxt += 1
        w = bytes([c])
        if nxt >= 4093:
            emit(256)
            table, nxt = {}, 258
    if w:
        emit(table[w] if len(w) > 1 else w[0])
    emit(257)
    acc, nacc, out = 0, 0, bytearray()
    for code, wd in codes:
        if old:
            acc |= code << nacc
            nacc += wd
            while nacc >= 8:
                out.append(acc & 0xFF)
                acc >>= 8
                nacc -= 8
        else:
            acc = (acc << wd) | code
            nacc += wd
            while nacc >= 8:
                out.append((acc >> (nacc - 8)) & 0xFF)
                nacc -= 8
                acc &= (1 << nacc) - 1
    if nacc:
        out.append((acc << (8 - nacc)) & 0xFF if not old else acc & 0xFF)
    return bytes(out)


FAX_WHITE = [(0x35, 8), (0x7, 6), (0x7, 4), (0x8, 4), (0xB, 4), (0xC, 4), (0xE, 4), (0xF, 4), (0x13, 5), (0x14, 5),
             (0x7, 5), (0x8, 5), (0x8, 6), (0x3, 6), (0x34, 6), (0x35, 6), (0x2A, 6), (0x2B, 6), (0x27, 7), (0xC, 7),
             (0x8, 7), (0x17, 7), (0x3, 7), (0x4, 7), (0x28, 7), (0x2B, 7), (0x13, 7), (0x24, 7), (0x18, 7), (0x2, 8),
             (0x3, 8), (0x1A, 8), (0x1B, 8), (0x12, 8), (0x13, 8), (0x14, 8), (0x15, 8), (0x16, 8), (0x17, 8),
             (0x28, 8), (0x29, 8), (0x2A, 8), (0x2B, 8), (0x2C, 8), (0x2D, 8), (0x4, 8), (0x5, 8), (0xA, 8), (0xB, 8),
             (0x52, 8), (0x53, 8), (0x54, 8), (0x55, 8), (0x24, 8), (0x25, 8), (0x58, 8), (0x59, 8), (0x5A, 8),
             (0x5B, 8), (0x4A, 8), (0x4B, 8), (0x32, 8), (0x33, 8), (0x34, 8)]
FAX_WHITE_MAKEUP = [(0x1B, 5), (0x12, 5), (0x17, 6), (0x37, 7), (0x36, 8), (0x37, 8), (0x64, 8), (0x65, 8), (0x68, 8),
                    (0x67, 8), (0xCC, 9), (0xCD, 9), (0xD2, 9), (0xD3, 9), (0xD4, 9), (0xD5, 9), (0xD6, 9), (0xD7, 9),
                    (0xD8, 9), (0xD9, 9), (0xDA, 9), (0xDB, 9), (0x98, 9), (0x99, 9), (0x9A, 9), (0x18, 6), (0x9B, 9)]
FAX_BLACK = [(0x37, 10), (0x2, 3), (0x3, 2), (0x2, 2), (0x3, 3), (0x3, 4), (0x2, 4), (0x3, 5), (0x5, 6), (0x4, 6),
             (0x4, 7), (0x5, 7), (0x7, 7), (0x4, 8), (0x7, 8), (0x18, 9), (0x17, 10), (0x18, 10), (0x8, 10),
             (0x67, 11), (0x68, 11), (0x6C, 11), (0x37, 11), (0x28, 11), (0x17, 11), (0x18, 11), (0xCA, 12),
             (0xCB, 12), (0xCC, 12), (0xCD, 12), (0x68, 12), (0x69, 12), (0x6A, 12), (0x6B, 12), (0xD2, 12),
             (0xD3, 12), (0xD4, 12), (0xD5, 12), (0xD6, 12), (0xD7, 12), (0x6C, 12), (0x6D, 12), (0xDA, 12),
             (0xDB, 12), (0x54, 12), (0x55, 12), (0x56, 12), (0x57, 12), (0x64, 12), (0x65, 12), (0x52, 12),
             (0x53, 12), (0x24, 12), (0x37, 12), (0x38, 12), (0x27, 12), (0x28, 12), (0x58, 12), (0x59, 12),
             (0x2B, 12), (0x2C, 12), (0x5A, 12), (0x66, 12), (0x67, 12)]
FAX_BLACK_MAKEUP = [(0xF, 10), (0xC8, 12), (0xC9, 12), (0x5B, 12), (0x33, 12), (0x34, 12), (0x35, 12), (0x6C, 13),
                    (0x6D, 13), (0x4A, 13), (0x4B, 13), (0x4C, 13), (0x4D, 13), (0x72, 13), (0x73, 13), (0x74, 13),
                    (0x75, 13), (0x76, 13), (0x77, 13), (0x52, 13), (0x53, 13), (0x54, 13), (0x55, 13), (0x5A, 13),
                    (0x5B, 13), (0x64, 13), (0x65, 13)]
FAX_EXTENDED = [(0x8, 11), (0xC, 11), (0xD, 11), (0x12, 12), (0x13, 12), (0x14, 12), (0x15, 12), (0x16, 12),
                (0x17, 12), (0x1C, 12), (0x1D, 12), (0x1E, 12), (0x1F, 12)]  # 1792 .. 2560, both colours
FAX_VERTICAL = {0: (1, 1), 1: (3, 3), 2: (3, 6), 3: (3, 7), -1: (2, 3), -2: (2, 6), -3: (2, 7)}


class _Bits:
    def __init__(self):
        self.bits = []

    def put(self, code: int, n: int) -> None:
        self.bits += [(code >> (n - 1 - i)) & 1 for i in range(n)]

    def align(self) -> None:
        self.bits += [0] * (-len(self.bits) % 8)

    def tobytes(self) -> bytes:
        self.align()
        return np.packbits(np.array(self.bits, np.uint8)).tobytes() if self.bits else b""


def _fax_run(b: _Bits, run: int, black: bool) -> None:
    term, makeup = (FAX_BLACK, FAX_BLACK_MAKEUP) if black else (FAX_WHITE, FAX_WHITE_MAKEUP)
    while run >= 2624:
        b.put(*FAX_EXTENDED[-1])
        run -= 2560
    if run >= 1792:
        b.put(*FAX_EXTENDED[(run - 1792) // 64])
        run %= 64
    elif run >= 64:
        b.put(*makeup[run // 64 - 1])
        run %= 64
    b.put(*term[run])


def _changes(row) -> list:
    """Changing elements of a row of 0 (white) / 1 (black) pixels."""
    row = np.concatenate([[0], np.asarray(row, np.int64)])
    return list(np.nonzero(np.diff(row))[0])


def _fax_row_1d(b: _Bits, row) -> None:
    x, black = 0, False
    for c in _changes(row) + [len(row)]:
        _fax_run(b, c - x, black)
        x, black = c, not black


def _fax_row_2d(b: _Bits, row, ref) -> None:
    w = len(row)
    cur, rch = _changes(row), _changes(ref)
    a0, color = -1, 0
    while a0 < w:
        a1 = next((c for c in cur if c > a0), w)
        b1 = next((c for i, c in enumerate(rch) if c > a0 and i % 2 == color), w)
        b2 = next((c for c in rch if c > b1), w)
        if b2 < a1:
            b.put(0x1, 4)
            a0 = b2
        elif abs(a1 - b1) <= 3:
            b.put(*FAX_VERTICAL[a1 - b1])
            a0, color = a1, 1 - color
        else:
            a2 = next((c for c in cur if c > a1), w)
            b.put(0x1, 3)
            _fax_run(b, a1 - max(a0, 0), bool(color))
            _fax_run(b, a2 - a1, not color)
            a0 = a2


def fax_encode(bits: np.ndarray, kind: int, t4options: int = 0, k: int = 2) -> bytes:
    """(H, W) 0/1 pixels (1 black) as CCITT RLE (kind 2, byte-aligned rows),
    CCITT RLEW (32771, rows aligned to 2 bytes of the strip), Group 3 (3: an
    EOL before each row, then with T4Options bit 0 a tag bit and every k-th
    row 1D, the rest 2D; bit 2 byte-aligns the EOLs) or Group 4 (4)."""
    b = _Bits()
    ref = np.zeros(bits.shape[1], np.uint8)
    for y, row in enumerate(bits):
        if kind in (2, 32771):
            _fax_row_1d(b, row)
            b.align()
            if kind == 32771 and len(b.bits) % 16:
                b.bits += [0] * 8
        elif kind == 3:
            if t4options & 4:
                b.bits += [0] * ((4 - len(b.bits)) % 8)
            b.put(1, 12)
            twod = bool(t4options & 1) and y % k != 0
            if t4options & 1:
                b.put(0 if twod else 1, 1)
            _fax_row_2d(b, row, ref) if twod else _fax_row_1d(b, row)
        else:
            _fax_row_2d(b, row, ref)
        ref = row
    if kind == 4:
        b.put(1, 12)
        b.put(1, 12)
    return b.tobytes()


def _pack_rows(a: np.ndarray, bits: int, order: str, fmt: int) -> bytes:
    """(rows, W, S) samples -> packed rows (each padded to a byte)."""
    h = a.shape[0]
    flat = a.reshape(h, -1)
    if bits < 8:
        per = flat.astype(np.uint8)
        out = []
        for r in per:
            bitsarr = np.unpackbits(r[:, None], axis=1)[:, 8 - bits:].reshape(-1)
            out.append(np.packbits(bitsarr).tobytes())
        return b"".join(out)
    if bits == 12:
        out = []
        for r in flat.astype(np.uint16):
            r = np.concatenate([r, [0]]) if len(r) % 2 else r
            a0, a1 = r[0::2], r[1::2]
            out.append(np.stack([a0 >> 4, ((a0 & 15) << 4) | (a1 >> 8), a1 & 255], 1).astype(np.uint8).tobytes())
        return b"".join(out)
    kind = {1: "u", 2: "i", 3: "f"}[fmt]
    return flat.astype(f"{order}{kind}{bits // 8}").tobytes()


def _predict(seg: np.ndarray, bits: int, predictor: int, stride: int, order: str) -> bytes:
    """Rows of a segment differenced as libtiff's predictor 2 / 3 encoders do."""
    h = seg.shape[0]
    if predictor == 2:
        flat = seg.reshape(h, -1).astype(np.int64)
        d = flat.copy()
        d[:, stride:] = flat[:, stride:] - flat[:, :-stride]
        return (d & ((1 << bits) - 1)).astype(f"{order}u{bits // 8}").tobytes()
    rows = []
    nb = bits // 8
    for r in seg.reshape(h, -1):
        raw = np.frombuffer(r.astype(f"<f{nb}").tobytes(), np.uint8).reshape(-1, nb)
        planes = raw[:, ::-1].T.reshape(-1).astype(np.int64)  # most significant byte plane first
        d = planes.copy()
        d[stride:] = planes[stride:] - planes[:-stride]
        rows.append((d & 255).astype(np.uint8).tobytes())
    return b"".join(rows)


def _jpeg_split(data: bytes):
    """A JPEG file -> (tables-only stream, abbreviated stream without tables or APPn)."""
    tables, rest, i = [b"\xff\xd8"], [b"\xff\xd8"], 2
    while i < len(data):
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        seg = data[i:i + 2 + n]
        if m == 0xDA:
            rest.append(data[i:])
            break
        if m in (0xDB, 0xC4):
            tables.append(seg)
        elif not 0xE0 <= m <= 0xEF:
            rest.append(seg)
        i += 2 + n
    return b"".join(tables) + b"\xff\xd9", b"".join(rest)


def _jpeg_segment(seg: np.ndarray, photometric: int, quality: int, subsampling):
    mode = "L" if seg.shape[2] == 1 else {2: "RGB", 5: "CMYK", 6: "RGB"}[photometric]
    img = Image.fromarray(seg[..., 0] if mode == "L" else seg, mode)
    buf = io.BytesIO()
    opts = {"quality": quality}
    if photometric == 6:
        opts["subsampling"] = {(1, 1): 0, (2, 1): 1, (2, 2): 2}[subsampling]
    elif photometric == 2:
        opts.update(keep_rgb=True, subsampling=0)
    img.save(buf, format="JPEG", **opts)
    return _jpeg_split(buf.getvalue())


def _ycbcr_units(seg: np.ndarray, hs: int, vs: int) -> bytes:
    """(rows, W, 3) YCbCr samples -> TIFF's subsampled data units: hs x vs
    luma samples then the block's mean Cb and Cr, edge samples repeated."""
    h, w = seg.shape[:2]
    ph, pw = -h % vs, -w % hs
    p = np.pad(seg, ((0, ph), (0, pw), (0, 0)), mode="edge").astype(np.int64)
    H, W = p.shape[:2]
    y = p[..., 0].reshape(H // vs, vs, W // hs, hs).transpose(0, 2, 1, 3).reshape(H // vs, W // hs, hs * vs)
    c = p[..., 1:].reshape(H // vs, vs, W // hs, hs, 2).mean(axis=(1, 3)).round().astype(np.int64)
    return np.concatenate([y, c], axis=2).astype(np.uint8).tobytes()


def thunder_encode(rows: np.ndarray, rng) -> bytes:
    """(H, W) 4-bit pixels as ThunderScan rows (tif_thunder.c's codes: 0x00 | n
    repeats the last pixel n times, 0x40 three 2-bit deltas (code 2 skips),
    0x80 two 3-bit deltas (code 4 skips), 0xC0 | v a raw pixel; each row
    starts from pixel 0), the codes picked at random where several fit."""
    d2 = {0: 0, 1: 1, -1: 3}
    d3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    out = bytearray()
    for row in np.asarray(rows, np.int64):
        last, x, w = 0, 0, len(row)
        while x < w:
            choice = int(rng.integers(0, 4))
            run = 0
            while x + run < w and run < 63 and row[x + run] == last:
                run += 1
            if run and choice != 3:
                out.append(run)
                x += run
                continue
            delta = [int((row[x + i] - p) % 16) for i, p in enumerate([last] + list(row[x:x + 2])) if x + i < w]
            delta = [v - 16 if v > 8 else v for v in delta]
            if choice == 1 and all(v in d2 for v in delta[:3]):
                codes = [d2[v] for v in delta[:3]] + [2] * (3 - len(delta[:3]))
                out.append(0x40 | codes[0] << 4 | codes[1] << 2 | codes[2])
                x += len(delta[:3])
                last = int(row[x - 1])
            elif choice == 2 and all(v in d3 for v in delta[:2]):
                codes = [d3[v] for v in delta[:2]] + [4] * (2 - len(delta[:2]))
                out.append(0x80 | codes[0] << 3 | codes[1])
                x += len(delta[:2])
                last = int(row[x - 1])
            else:
                out.append(0xC0 | int(row[x]))
                last = int(row[x])
                x += 1
    return bytes(out)


def _jpeg_segments(data: bytes):
    """A JPEG file -> ([(marker, segment bytes)] up to and with SOS, the entropy-coded data after it)."""
    segs, i = [], 2
    while True:
        m, n = data[i + 1], (data[i + 2] << 8) | data[i + 3]
        segs.append((m, data[i:i + 2 + n]))
        i += 2 + n
        if m == 0xDA:
            return segs, data[i:]


def _split_restarts(scan: bytes) -> list:
    """Entropy-coded data -> its restart intervals (the RSTn markers and EOI dropped)."""
    pieces, start, i = [], 0, 0
    while i + 1 < len(scan):
        if scan[i] == 0xFF and (0xD0 <= scan[i + 1] <= 0xD7 or scan[i + 1] == 0xD9):
            pieces.append(scan[start:i])
            start = i = i + 2
            continue
        i += 1
    return pieces


def write_ojpeg(rgb, subsampling=(2, 2), rows_per_strip=None, source: str = "tags", photometric: int = 6,
                quality: int = 75, restart_rows: int = 0, tags=None) -> bytes:
    """(H, W, 3) RGB pixels -> an old-style JPEG TIFF (compression 6; PIL
    writes none) as libtiff's tif_ojpeg.c reads it: PIL's JPEG of the image
    (`subsampling` (1, 1), (2, 1) or (2, 2); a restart interval of each strip's
    MCUs, or of `restart_rows` MCU rows for one strip) cut into its restart
    intervals, one a strip, the markers dropped (libtiff puts them back). The
    tables come from `source`: "tags" (JPEGProc 1, JPEGQTables / DCTables /
    ACTables offsets to 64 quantizers and to counts and values, one a component,
    the chroma ones shared; JPEGRestartInterval with `restart_rows`), "header"
    (JPEGInterchangeFormat / Length over the JPEG's segments up to SOS),
    "whole" (over the whole JPEG, its one strip the scan inside it) or "strip"
    (no tag: the segments up to SOS open the first strip)."""
    rgb = np.asarray(rgb, np.uint8)
    h, w = rgb.shape[:2]
    hs, vs = subsampling
    rps = rows_per_strip or h
    opts = {"quality": quality, "subsampling": {(1, 1): 0, (2, 1): 1, (2, 2): 2}[subsampling]}
    if rps < h:
        opts["restart_marker_rows"] = rps // (8 * vs)
    elif restart_rows:
        opts["restart_marker_rows"] = restart_rows
    buf = io.BytesIO()
    Image.fromarray(rgb).save(buf, format="JPEG", **opts)
    jpeg = buf.getvalue()
    segs, scan = _jpeg_segments(jpeg)
    pieces = _split_restarts(scan)
    if rps < h and len(pieces) != -(-h // rps):
        raise ValueError(f"{len(pieces)} restart intervals for {-(-h // rps)} strips")
    strips = pieces if rps < h else [scan]
    blobs, entries = [], {256: (3, [w]), 257: (3, [h]), 258: (3, [8, 8, 8]), 259: (3, [6]), 262: (3, [photometric]),
                          277: (3, [3]), 278: (3, [rps]), 530: (3, [hs, vs])}
    head = b"".join(seg for m, seg in segs if m not in (0xE0,))
    if source == "tags":
        q = {seg[4] & 15: seg[5:69] for m, seg in segs if m == 0xDB}
        dht = {}
        for m, seg in segs:
            if m == 0xC4:
                dht[seg[4]] = seg[5:]
        for tid, vals in list(q.items()):
            q[tid] = len(blobs)
            blobs.append(vals)
        for key in list(dht):
            dht[key], val = len(blobs), dht[key]
            blobs.append(val)
        entries[512] = (3, [1])
        entries[519] = (4, [("blob", q[0]), ("blob", q[1]), ("blob", q[1])])
        entries[520] = (4, [("blob", dht[0x00]), ("blob", dht[0x01]), ("blob", dht[0x01])])
        entries[521] = (4, [("blob", dht[0x10]), ("blob", dht[0x11]), ("blob", dht[0x11])])
        if restart_rows and rps >= h:
            entries[515] = (3, [restart_rows * -(-w // (8 * hs))])
    elif source == "header":
        entries[513] = (4, [("blob", len(blobs))])
        entries[514] = (4, [len(head)])
        blobs.append(head)
    elif source == "whole":
        entries[513] = (4, [("blob", len(blobs))])
        entries[514] = (4, [len(jpeg)])
        blobs.append(jpeg)
        strips = []
        entries[273] = (4, [("blob", 0, len(jpeg) - len(scan))])
        entries[279] = (4, [len(scan)])
    elif source == "strip":
        strips = [head + strips[0]] + strips[1:]
    if strips:
        entries[273] = (4, [("blob", len(blobs) + i) for i in range(len(strips))])
        entries[279] = (4, [len(x) for x in strips])
        blobs += strips
    for k, v in (tags or {}).items():
        if v is None:
            entries.pop(k, None)
        else:
            entries[k] = v
    return _tiff_blobs(entries, blobs)


def _tiff_blobs(entries, blobs) -> bytes:
    """A little-endian classic TIFF: the header, the `blobs` in order, then
    one IFD of `entries` ({tag: (type, values)}; a value ("blob", i[, delta])
    is blob i's offset (+ delta)) with its long values after it."""
    offs, pos = [], 8
    for b in blobs:
        offs.append(pos)
        pos += len(b) + (len(b) & 1)
    ifd_at = pos

    def value(v):
        return offs[v[1]] + (v[2] if len(v) > 2 else 0) if isinstance(v, tuple) and v[0] == "blob" else v

    items = sorted((tag, typ, [value(v) for v in vals]) for tag, (typ, vals) in entries.items())
    extra_at = ifd_at + 2 + 12 * len(items) + 4
    ifd, extra = struct.pack("<H", len(items)), b""
    for tag, typ, vals in items:
        p = bytes(vals) if typ in (2, 7) else struct.pack("<" + TIFF_TYPES[typ][0] * len(vals), *vals)
        count = len(p) if typ in (2, 7) else len(vals)
        if len(p) <= 4:
            ifd += struct.pack("<HHI", tag, typ, count) + p.ljust(4, b"\0")
        else:
            ifd += struct.pack("<HHI", tag, typ, count) + struct.pack("<I", extra_at + len(extra))
            extra += p + b"\0" * (len(p) & 1)
    body = b"".join(b + b"\0" * (len(b) & 1) for b in blobs)
    return b"II*\x00" + struct.pack("<I", ifd_at) + body + ifd + b"\0" * 4 + extra


def write_tiff(samples, photometric: int, bits: int = 8, compression: int = 1, order: str = "<",
               bigtiff: bool = False, rows_per_strip=None, tile=None, planar: int = 1, fillorder: int = 1,
               predictor: int = 1, extra_samples=(), sample_format: int = 1, colormap=None, orientation=None,
               subsampling=None, t4options: int = 0, old_lzw: bool = False, quality: int = 75, tags=None,
               ifd_first: bool = False, append=(), zstd_level: int = 3, thunder_seed: int = 0) -> bytes:
    """(H, W, S) samples (uint / int / float by `sample_format`; 0/1 pixels,
    1 black, for CCITT; 4-bit values for ThunderScan; RGB pixels for JPEG
    under photometric 6, YCbCr samples otherwise) -> a TIFF file. `tags`
    {tag: (type, values)} add or replace entries (values None drops one);
    `append` [(tag, type, values)] go after them, out of order or repeated.
    ZSTD (50000) is written by the `zstandard` module at `zstd_level`,
    ThunderScan (32809) by `thunder_encode` (libtiff has no encoder: its
    "ThunderScan scanline encoding is not implemented"); PIL's
    `save(compression="tiff_raw_16")` is not used for CCITT RLEW (32771),
    as it killed the interpreter with SIGSEGV where this file was written."""
    thunder_rng = np.random.default_rng(thunder_seed)
    a = np.asarray(samples)
    if a.ndim == 2:
        a = a[..., None]
    h, w, spp = a.shape
    jpeg = compression == 7
    ycc_units = photometric == 6 and subsampling not in (None, (1, 1)) and not jpeg
    if tile:
        tw, th = tile
    else:
        tw, th = w, rows_per_strip or h
    planes = [a[..., s:s + 1] for s in range(spp)] if planar == 2 else [a]
    chunks, tables = [], None
    for plane in planes:
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw) if tile else [0]:
                seg = plane[y0:y0 + th, x0:x0 + tw]
                if tile:  # full tiles, padded past the image's edges
                    seg = np.pad(seg, ((0, th - seg.shape[0]), (0, tw - seg.shape[1]), (0, 0)), mode="edge")
                if jpeg:
                    tables, data = _jpeg_segment(seg.astype(np.uint8), photometric, quality, subsampling or (1, 1))
                elif compression in (2, 3, 4, 32771):
                    data = fax_encode(seg[..., 0], compression, t4options)
                elif compression == 32809:
                    data = thunder_encode(seg[..., 0], thunder_rng)
                else:
                    if ycc_units:
                        raw = _ycbcr_units(seg, *subsampling)
                    elif predictor != 1:
                        raw = _predict(seg, bits, predictor, seg.shape[2], order)
                    else:
                        raw = _pack_rows(seg, bits, order, sample_format)
                    if compression == 1:
                        data = raw
                    elif compression == 32773:
                        data = packbits_encode(raw)
                    elif compression == 5:
                        data = tiff_lzw_encode(raw, old_lzw)
                    elif compression in (8, 32946):
                        data = zlib.compress(raw)
                    elif compression == 34925:
                        import lzma
                        data = lzma.compress(raw, format=lzma.FORMAT_XZ)
                    elif compression == 50000:
                        import zstandard
                        data = zstandard.ZstdCompressor(level=zstd_level).compress(raw)
                    else:
                        raise ValueError(f"no encoder for compression {compression}")
                if fillorder == 2 and not jpeg:
                    data = bytes(BITREV[b] for b in data)
                chunks.append(data)
    long_t = 16 if bigtiff else 4
    entries = {256: (3 if w < 65536 else 4, [w]), 257: (3 if h < 65536 else 4, [h]),
               258: (3, [bits] * spp), 259: (3, [compression]),
               262: (3, [photometric]), 277: (3, [spp]), 284: (3, [planar])}
    if fillorder != 1:
        entries[266] = (3, [fillorder])
    if predictor != 1:
        entries[317] = (3, [predictor])
    if extra_samples:
        entries[338] = (3, list(extra_samples))
    if sample_format != 1:
        entries[339] = (3, [sample_format] * spp)
    if colormap is not None:
        entries[320] = (3, list(np.asarray(colormap, np.int64).T.reshape(-1)))
    if orientation is not None:
        entries[274] = (3, [orientation])
    if subsampling is not None:
        entries[530] = (3, list(subsampling))
    if t4options:
        entries[292] = (4, [t4options])
    if tables is not None:
        entries[347] = (7, tables)
    if tile:
        entries[322], entries[323] = (3, [tw]), (3, [th])
    else:
        entries[278] = (3 if th < 65536 else 4, [th])
    for k, v in (tags or {}).items():
        if v is None:
            entries.pop(k, None)
        else:
            entries[k] = v
    off_tag, cnt_tag = (324, 325) if tile else (273, 279)
    return _tiff_file(entries, chunks, off_tag, cnt_tag, order, bigtiff, long_t, ifd_first, append)


BITREV = bytes(int(f"{i:08b}"[::-1], 2) for i in range(256))


def _tiff_file(entries, chunks, off_tag, cnt_tag, order, bigtiff, long_t, ifd_first, append=()) -> bytes:
    """Header, strip / tile data and one IFD (after the data, or right after
    the header) of the entries in tag order, then the `append` ones (tag,
    type, values) as they come (duplicates included), every value too long
    for its entry after the IFD."""
    pre = (b"II" if order == "<" else b"MM")
    head = pre + struct.pack(order + "HHHQ", 43, 8, 0, 0) if bigtiff else pre + struct.pack(order + "HI", 42, 0)
    entries = dict(entries)
    entries[off_tag] = (long_t, [0] * len(chunks))
    entries[cnt_tag] = (long_t, [len(c) for c in chunks])
    listed = [(tag, *entries[tag]) for tag in sorted(entries)] + [tuple(e) for e in append]
    ent_size, cnt_size, inline = (20, 8, 8) if bigtiff else (12, 2, 4)
    ifd_len = cnt_size + len(listed) * ent_size + inline

    def payload(typ, vals):
        if typ in (2, 7):
            return bytes(vals)
        fmt = TIFF_TYPES[typ]
        flat = [x for v in vals for x in (v if isinstance(v, tuple) else (v,))]
        return struct.pack(order + fmt[0] * len(flat), *flat)

    ifd_at = len(head) if ifd_first else len(head) + sum(len(c) for c in chunks)
    out_of_line, pos = [], ifd_at + ifd_len  # out-of-line values after the IFD
    for tag, typ, vals in listed:
        size = len(payload(typ, vals))
        out_of_line.append(pos if size > inline else None)
        pos += size + (size & 1) if size > inline else 0
    data_start = pos if ifd_first else len(head)
    chunk_offs = [int(o) for o in np.cumsum([data_start] + [len(c) for c in chunks[:-1]])] if chunks else []
    listed = [(tag, typ, chunk_offs if tag == off_tag and vals == [0] * len(chunks) else vals)
              for tag, typ, vals in listed]
    ifd = bytearray(struct.pack(order + ("Q" if bigtiff else "H"), len(listed)))
    extra = bytearray()
    for (tag, typ, vals), at in zip(listed, out_of_line):
        p = payload(typ, vals)
        count = len(p) if typ in (2, 7) else len(vals)
        ifd += struct.pack(order + ("HHQ" if bigtiff else "HHI"), tag, typ, count)
        if at is not None:
            ifd += struct.pack(order + ("Q" if bigtiff else "I"), at)
            extra += p + b"\0" * (len(p) & 1)
        else:
            ifd += p + b"\0" * (inline - len(p))
    ifd += b"\0" * inline  # no next IFD
    head = bytearray(head)
    if bigtiff:
        head[8:16] = struct.pack(order + "Q", ifd_at)
    else:
        head[4:8] = struct.pack(order + "I", ifd_at)
    if ifd_first:
        return bytes(head) + bytes(ifd) + bytes(extra) + b"".join(chunks)
    return bytes(head) + b"".join(chunks) + bytes(ifd) + bytes(extra)


def clip_frame(t: int, px: int = CLIP_PX) -> np.ndarray:
    """Frame t of chip_smoke.py phase 10's synthetic clip, (px, px, 3) uint8
    integer patterns (chip_smoke.py holds the same function)."""
    y, x = np.mgrid[0:px, 0:px]
    return np.stack([(x + 2 * y + 16 * t) & 255, (4 * ((x >> 3) ^ (y >> 3)) + 8 * t) & 255,
                     (3 * x - y + 32 * t) & 255], axis=-1).astype(np.uint8)


def webp_fixture(size, seed: int, opts: dict) -> bytes:
    """PIL's WebP save of a procedural image under `opts` (see WEBPS)."""
    opts = dict(opts)
    colours, alpha, frames = opts.pop("colours", 0), opts.pop("alpha", False), opts.pop("frames", 0)
    w, h = size
    arr = procedural(w, h, seed, 0.0 if opts.pop("smooth", False) else 6.0)
    img = Image.fromarray(arr)
    if colours:
        img = img.quantize(colors=colours).convert("RGB")
    if alpha:
        a = procedural(w, h, seed + 1)[..., 0]
        a[: h // 3] = 255
        a[h // 3: h // 2] = 0
        img = Image.fromarray(np.concatenate([np.asarray(img), a[..., None]], axis=-1))
    buf = io.BytesIO()
    if frames:
        more = [Image.fromarray(procedural(w, h, seed + 1 + i)) for i in range(frames - 1)]
        img.save(buf, format="WEBP", save_all=True, append_images=more, duration=100, **opts)
    else:
        img.save(buf, format="WEBP", **opts)
    return buf.getvalue()


def bmp_fixture(bits: int, hsize: int, compression: str, opts: dict, seed: int) -> bytes:
    """A 37x23 BMP of the kind (see BMPS): a procedural image, quantized by
    PIL to the palette for 1-8 bits."""
    opts = dict(opts)
    rgb = procedural(37, 23, seed)
    palette, pixels = None, rgb
    if bits <= 8:
        n = opts.pop("palette", 0)
        if opts.pop("grey", False):
            palette = np.repeat(np.arange(256)[:, None], 3, axis=1)[: 1 << bits]
            pixels = np.asarray(Image.fromarray(rgb).convert("L")) >> (8 - bits)
        else:
            q = Image.fromarray(rgb).quantize(colors=n)
            palette = np.asarray(q.getpalette()[: 3 * n]).reshape(-1, 3)
            pixels = np.asarray(q)
    return write_bmp(pixels, bits, hsize, compression, palette, rng=np.random.default_rng(seed), **opts)


def gif_fixture(size, seed: int, kind: str, opts: dict) -> bytes:
    """A GIF of a procedural image (see GIFS): PIL's save ("pil"), or the
    image quantized by PIL to `colors` and written by `write_gif` with a
    local table after a global one ("local"), or as a sub-frame offset inside
    the screen after a GCE with a transparency index and comment,
    application and plain-text extensions ("offset")."""
    opts = dict(opts)
    w, h = size
    rgb = procedural(w, h, seed, 0.0 if opts.pop("smooth", False) else 6.0)
    if kind == "pil":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert(opts.pop("mode")).save(buf, format="GIF", **opts)
        return buf.getvalue()
    rng = np.random.default_rng(seed)
    n = opts.pop("colors", 16)
    q = Image.fromarray(rgb).quantize(colors=n)
    palette = np.asarray(q.getpalette()[: 3 * n]).reshape(-1, 3)
    glob = rng.integers(0, 256, (256, 3)) if opts.pop("global", True) else None
    if kind == "local":
        return write_gif(size, [gif_image(np.asarray(q), palette=palette, **opts)], palette=glob)
    sub = np.asarray(q)[2: h - 5, 3: w - 7]
    return write_gif(size, [gif_extension(0xFE, b"a comment", b"in two blocks"),
                            gif_extension(0xFF, b"NETSCAPE2.0", b"\x01\x00\x00"),
                            gif_gce(transparency=opts.pop("transparency")),
                            gif_extension(0x01, bytes(12), b"plain text"),
                            gif_image(sub, x=3, y=2)], palette=palette)


def tiff_fixture(size, seed: int, kind: str, opts: dict) -> bytes:
    """A TIFF of a procedural image (see TIFFS): PIL's save, or `write_tiff`
    of its RGB samples, YCbCr samples ("ycbcr"), grey levels reduced to
    `bits` (one bit: dithered black, 1), palette indices of a quantized
    image ("palette"), premultiplied RGBA ("alpha") or float grey."""
    opts = dict(opts)
    w, h = size
    rgb = procedural(w, h, seed, 0.0 if opts.pop("smooth", False) else 6.0)
    if kind == "pil":
        buf = io.BytesIO()
        Image.fromarray(rgb).convert(opts.pop("mode")).save(buf, format="TIFF", **opts)
        return buf.getvalue()
    if kind == "ojpeg":
        return write_ojpeg(rgb, **opts)
    photometric, bits = opts.pop("photometric", 2), opts.get("bits", 8)
    samples = rgb
    if opts.pop("lab_grid", False):  # every L, a and b in steps of 4: PIL's littleCMS transform sampled
        g = np.meshgrid(np.arange(256), np.arange(0, 256, 4), np.arange(0, 256, 4), indexing="ij")
        samples = np.stack(g, -1).reshape(h, w, 3)
    elif opts.pop("ycbcr", False):
        samples = np.asarray(Image.fromarray(rgb).convert("YCbCr"))
    elif photometric == 3:
        n = opts.pop("palette")
        q = Image.fromarray(rgb).quantize(colors=n)
        cmap = np.asarray(q.getpalette()[: 3 * n]).reshape(-1, 3) * 257
        return write_tiff(np.asarray(q), 3, colormap=cmap, **opts)
    elif photometric in (0, 1):
        grey = np.asarray(Image.fromarray(rgb).convert("L")).astype(np.float64)
        if opts.get("sample_format") == 3:
            samples = (grey * 1.25 - 20).astype(np.float32)
        elif bits == 1:
            samples = (np.asarray(Image.fromarray(grey.astype(np.uint8)).convert("1")) == 0).astype(np.uint8)
        else:
            samples = grey.astype(np.int64) >> (8 - bits) if bits < 8 else grey.astype(np.int64) * 257
    elif bits == 16:
        samples = rgb.astype(np.int64) * 257
    if opts.pop("alpha", False):
        a = np.linspace(0, 255, w * h).reshape(h, w).astype(np.int64)
        samples = np.concatenate([rgb.astype(np.int64) * a[..., None] // 255, a[..., None]], axis=2)
    return write_tiff(samples, photometric, **opts)


def coded_jpeg(size, seed: int, opts: dict, lossless: bool) -> bytes:
    """An arithmetic-coded or lossless JPEG of a procedural image (see ARITH,
    LOSSLESS)."""
    opts = dict(opts)
    w, h = size
    rgb = procedural(w, h, seed, 0.0 if opts.pop("smooth", False) else 6.0)
    if opts.pop("grey", False):
        rgb = np.asarray(Image.fromarray(rgb).convert("L"))
    if not lossless:
        return write_arith_jpeg(rgb, **opts)
    predictor, pt = opts.pop("predictor"), opts.pop("pt", 0)
    if opts.pop("subsample", False):  # 4:2:0 planes of the RGB samples, one interleaved scan
        return write_lossless_jpeg([rgb[..., 0], rgb[::2, ::2, 1], rgb[::2, ::2, 2]], predictor, pt, marker="none",
                                   sampling=[(2, 2), (1, 1), (1, 1)], interleaved=True, **opts)
    return write_lossless_jpeg(rgb, predictor, pt, marker=opts.pop("marker", "none"), **opts)


# ------------------------------------------------------------- JPEG 2000 ----
# name, (W, H), seed, writer, options. "pil": PIL's save (mode, save options);
# "opj": OpenJPEG 2.5.4's own encoder, the one PIL bundles, driven through
# ctypes (`opj_encode`) for what PIL's save does not expose (code-block
# styles, SOP / EPH, POC, RGN, tile-parts, sub-sampled components, precision),
# then `to_ppm` / `to_ppt` / `add_tlm` rewrite the codestream and `jp2_file`
# wraps it in JP2 boxes (sYCC, CMYK, a palette, bpcc, cdef, res, xml, an ICC
# colr); "smooth" images have no noise (the 1024x768 timing files).
J2K_POCS = [(1, 0, 0, 1, 3, 3, "RLCP"), (1, 0, 0, 2, 3, 3, "CPRL")]
J2KS = [
    ("j2k_pil_rgb_67x45.jp2", (67, 45), 600, "pil", {}),
    ("j2k_pil_l_signed_33x17.j2k", (33, 17), 601, "pil", {"mode": "L", "signed": True, "no_jp2": True}),
    ("j2k_pil_la_33x17.jp2", (33, 17), 602, "pil", {"mode": "LA"}),
    ("j2k_pil_rgba_tiles_offset_67x45.jp2", (67, 45), 603, "pil",
     {"mode": "RGBA", "tile_size": (32, 32), "tile_offset": (5, 7), "offset": (9, 11)}),
    ("j2k_pil_i16_33x17.jp2", (33, 17), 604, "pil", {"mode": "I;16"}),
    ("j2k_pil_97_layers_67x45.jp2", (67, 45), 605, "pil",
     {"irreversible": True, "quality_layers": [40, 20, 10], "quality_mode": "rates"}),
    ("j2k_pil_97_db_rpcl_67x45.j2k", (67, 45), 606, "pil",
     {"irreversible": True, "quality_layers": [30, 38], "quality_mode": "dB", "progression": "RPCL",
      "precinct_size": (32, 32), "codeblock_size": (16, 16), "no_jp2": True}),
    ("j2k_pil_cprl_nomct_res2_plt_67x45.jp2", (67, 45), 607, "pil",
     {"progression": "CPRL", "mct": 0, "num_resolutions": 2, "plt": True}),
    ("j2k_pil_pcrl_rlcp_layers_67x45.j2k", (67, 45), 608, "pil",
     {"progression": "PCRL", "quality_layers": [30, 10], "quality_mode": "rates", "no_jp2": True}),
    ("j2k_lossless_1024x768.jp2", (1024, 768), 609, "pil", {"smooth": True}),
    ("j2k_97_layers_1024x768.jp2", (1024, 768), 610, "pil",
     {"smooth": True, "irreversible": True, "quality_layers": [80, 40, 20], "quality_mode": "rates"}),
    ("j2k_opj_bypass_termall_41x27.j2k", (41, 27), 620, "opj", {"mode": 1 | 4, "cblk": (8, 8), "rates": (8, 3)}),
    ("j2k_opj_reset_vsc_segsym_97_41x27.j2k", (41, 27), 621, "opj",
     {"mode": 2 | 8 | 32, "irreversible": True, "rates": (8, 3), "cblk": (8, 8)}),
    ("j2k_opj_all_styles_roi_poc_41x27.j2k", (41, 27), 622, "opj",
     {"mode": 63, "irreversible": True, "rates": (8, 3), "cblk": (8, 8), "roi": (0, 5), "pocs": J2K_POCS}),
    ("j2k_opj_pterm_lazy_layers_41x27.j2k", (41, 27), 623, "opj", {"mode": 1 | 16, "rates": (10, 4, 2)}),
    ("j2k_opj_sop_eph_41x27.j2k", (41, 27), 624, "opj", {"csty": 6, "rates": (8, 3)}),
    ("j2k_opj_poc_tiles_67x45.j2k", (67, 45), 625, "opj",
     {"tile": (32, 32), "rates": (20, 8), "numres": 4,
      "pocs": [(1, 0, 0, 1, 4, 3, "LRCP"), (1, 0, 0, 2, 4, 2, "PCRL"), (2, 1, 1, 2, 4, 3, "RPCL")]}),
    ("j2k_opj_rgn_97_41x27.j2k", (41, 27), 626, "opj", {"roi": (1, 12), "irreversible": True, "rates": (10,)}),
    ("j2k_opj_tileparts_tlm_41x27.j2k", (41, 27), 627, "opj",
     {"tile": (16, 16), "tp_flag": "R", "prog": "RPCL", "rates": (4, 2), "numres": 3, "tlm": True}),
    ("j2k_opj_ppm_41x27.j2k", (41, 27), 628, "opj",
     {"csty": 6, "rates": (8, 3), "cblk": (8, 8), "packed": "ppm", "chunk": 50}),
    ("j2k_opj_ppt_tiles_41x27.j2k", (41, 27), 629, "opj",
     {"csty": 6, "rates": (8, 3), "tile": (16, 16), "packed": "ppt", "keep_markers": True, "chunk": 19}),
    ("j2k_opj_sycc420_40x26.jp2", (40, 26), 630, "opj", {"ycc": True, "sub": (2, 2), "colr": 18}),
    ("j2k_opj_sub420_41x27.j2k", (41, 27), 631, "opj", {"ycc": True, "sub": (2, 2)}),
    ("j2k_opj_srgb_sub422_40x27.jp2", (40, 27), 632, "opj", {"sub": (2, 1), "colr": 16}),
    ("j2k_opj_cmyk_41x27.jp2", (41, 27), 633, "opj", {"cmyk": True, "colr": 12}),
    ("j2k_opj_palette_41x27.jp2", (41, 27), 634, "opj", {"palette": 14, "colr": 16}),
    ("j2k_opj_prec_bpcc_41x27.jp2", (41, 27), 635, "opj", {"prec": (6, 8, 12), "colr": 16}),
    ("j2k_opj_boxes_icc_41x27.jp2", (41, 27), 636, "opj", {"boxes": True}),
    ("j2k_opj_grey4_41x27.j2k", (41, 27), 637, "opj", {"grey_prec": 4}),
]


def _opj():
    """PIL's bundled libopenjp2 (2.5.4) with the encoder's structs, its
    parameters' layout checked against opj_set_default_encoder_parameters."""
    import ctypes
    import glob

    from ctypes import POINTER, c_char, c_char_p, c_float, c_int, c_int32, c_uint16, c_uint32, c_void_p

    import PIL

    class Poc(ctypes.Structure):
        _fields_ = [(n, c_uint32) for n in ("resno0", "compno0", "layno1", "resno1", "compno1", "layno0",
                                            "precno0", "precno1")] + [
            ("prg1", c_int), ("prg", c_int), ("progorder", c_char * 5), ("tile", c_uint32),
            ("tx0", c_int32), ("tx1", c_int32), ("ty0", c_int32), ("ty1", c_int32)] + [
            (n, c_uint32) for n in ("layS", "resS", "compS", "prcS", "layE", "resE", "compE", "prcE", "txS", "txE",
                                    "tyS", "tyE", "dx", "dy", "lay_t", "res_t", "comp_t", "prc_t", "tx0_t", "ty0_t")]

    class CParams(ctypes.Structure):  # opj_cparameters_t, then room for fields this layout may lack
        _fields_ = [("tile_size_on", c_int), ("cp_tx0", c_int), ("cp_ty0", c_int), ("cp_tdx", c_int),
                    ("cp_tdy", c_int), ("cp_disto_alloc", c_int), ("cp_fixed_alloc", c_int),
                    ("cp_fixed_quality", c_int), ("cp_matrice", c_void_p), ("cp_comment", c_char_p), ("csty", c_int),
                    ("prog_order", c_int), ("POC", Poc * 32), ("numpocs", c_uint32), ("tcp_numlayers", c_int),
                    ("tcp_rates", c_float * 100), ("tcp_distoratio", c_float * 100), ("numresolution", c_int),
                    ("cblockw_init", c_int), ("cblockh_init", c_int), ("mode", c_int), ("irreversible", c_int),
                    ("roi_compno", c_int), ("roi_shift", c_int), ("res_spec", c_int), ("prcw_init", c_int * 33),
                    ("prch_init", c_int * 33), ("infile", c_char * 4096), ("outfile", c_char * 4096),
                    ("index_on", c_int), ("index", c_char * 4096), ("image_offset_x0", c_int),
                    ("image_offset_y0", c_int), ("subsampling_dx", c_int), ("subsampling_dy", c_int),
                    ("decod_format", c_int), ("cod_format", c_int), ("jpwl", c_int * 134), ("cp_cinema", c_int),
                    ("max_comp_size", c_int), ("cp_rsiz", c_int), ("tp_on", c_char), ("tp_flag", c_char),
                    ("tcp_mct", c_char), ("jpip_on", c_int), ("mct_data", c_void_p), ("max_cs_size", c_int),
                    ("rsiz", c_uint16), ("_room", ctypes.c_uint8 * 65536)]

    class CmptParm(ctypes.Structure):
        _fields_ = [(n, c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]

    class ImageComp(ctypes.Structure):
        _fields_ = [(n, c_uint32) for n in ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd",
                                            "resno_decoded", "factor")] + [("data", POINTER(c_int32)),
                                                                          ("alpha", c_uint16)]

    class OpjImage(ctypes.Structure):
        _fields_ = [(n, c_uint32) for n in ("x0", "y0", "x1", "y1", "numcomps")] + [
            ("color_space", c_int), ("comps", POINTER(ImageComp)), ("icc_profile_buf", c_void_p),
            ("icc_profile_len", c_uint32)]

    lib = ctypes.CDLL(glob.glob(os.path.join(os.path.dirname(PIL.__file__), "..", "pillow.libs",
                                             "libopenjp2-*.so*"))[0])
    lib.opj_image_create.restype = POINTER(OpjImage)
    lib.opj_create_compress.restype = c_void_p
    lib.opj_stream_create_default_file_stream.restype = c_void_p
    lib.opj_setup_encoder.argtypes = [c_void_p, POINTER(CParams), POINTER(OpjImage)]
    lib.opj_start_compress.argtypes = [c_void_p, POINTER(OpjImage), c_void_p]
    lib.opj_encode.argtypes = lib.opj_end_compress.argtypes = [c_void_p, c_void_p]
    lib.opj_stream_destroy.argtypes = lib.opj_destroy_codec.argtypes = [c_void_p]
    lib.opj_image_destroy.argtypes = [POINTER(OpjImage)]
    p = CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    assert (p.numresolution, p.cblockw_init, p.cblockh_init, p.roi_compno, p.subsampling_dx, p.subsampling_dy,
            p.decod_format, p.cod_format) == (6, 64, 64, -1, 1, 1, -1, -1), "opj_cparameters_t layout"
    return lib, CParams, CmptParm


_PROG = {"LRCP": 0, "RLCP": 1, "RPCL": 2, "PCRL": 3, "CPRL": 4}


def opj_encode(planes, sub=None, prec=8, irreversible=False, numres=3, cblk=(64, 64), mode=0, csty=0, prog="LRCP",
               pocs=(), roi=None, tile=None, rates=(), mct=None, tp_flag=None) -> bytes:
    """A J2K codestream of `planes` (one 2-D int array a component, each at its
    sub-sampled size; `sub` = (dx, dy) a component) from OpenJPEG's encoder:
    code-block style bits `mode` (1 bypass, 2 reset, 4 terminate each pass, 8
    vertically causal, 16 predictable termination, 32 segmentation symbols),
    Scod `csty` (2 SOP, 4 EPH), POCs (tile from 1, resno0, compno0, layno1,
    resno1, compno1, order), ROI (component, shift), tiles, tile-parts by
    `tp_flag` ("R", "L" or "C"), layer rates."""
    import ctypes
    import tempfile

    lib, CParams, CmptParm = _opj()
    n = len(planes)
    sub = sub or [(1, 1)] * n
    parms = (CmptParm * n)()
    for i, plane in enumerate(planes):
        parms[i].dx, parms[i].dy = sub[i]
        parms[i].h, parms[i].w = plane.shape
        parms[i].prec = parms[i].bpp = prec[i] if isinstance(prec, (list, tuple)) else prec
    img = lib.opj_image_create(n, parms, 1)  # OPJ_CLRSPC_SRGB
    im = img.contents
    im.x1, im.y1 = planes[0].shape[1] * sub[0][0], planes[0].shape[0] * sub[0][1]
    for i, plane in enumerate(planes):
        flat = np.ascontiguousarray(plane, np.int32).ravel()
        ctypes.memmove(im.comps[i].data, flat.ctypes.data, flat.nbytes)
    p = CParams()
    lib.opj_set_default_encoder_parameters(ctypes.byref(p))
    p.irreversible, p.numresolution, p.mode, p.csty, p.prog_order = int(irreversible), numres, mode, csty, _PROG[prog]
    p.cblockw_init, p.cblockh_init = cblk
    p.tcp_numlayers, p.cp_disto_alloc = max(1, len(rates)), 1
    for i, r in enumerate(rates or (0,)):
        p.tcp_rates[i] = r
    if tile:
        p.tile_size_on = 1
        p.cp_tdx, p.cp_tdy = tile
    for i, (t, r0, c0, l1, r1, c1, order) in enumerate(pocs):
        q = p.POC[i]
        q.tile, q.resno0, q.compno0, q.layno1, q.resno1, q.compno1 = t, r0, c0, l1, r1, c1
        q.prg1, q.progorder = _PROG[order], order.encode()
    p.numpocs = len(pocs)
    if roi:
        p.roi_compno, p.roi_shift = roi
    if mct is not None:
        p.tcp_mct = bytes([mct])
    if tp_flag:
        p.tp_on, p.tp_flag = b"\x01", tp_flag.encode()
    codec = lib.opj_create_compress(0)  # OPJ_CODEC_J2K
    assert lib.opj_setup_encoder(codec, ctypes.byref(p), img), "opj_setup_encoder"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "out.j2k")
        stream = lib.opj_stream_create_default_file_stream(path.encode(), 0)
        ok = lib.opj_start_compress(codec, img, stream) and lib.opj_encode(codec, stream) and \
            lib.opj_end_compress(codec, stream)
        lib.opj_stream_destroy(stream)
        lib.opj_destroy_codec(codec)
        lib.opj_image_destroy(img)
        assert ok, "OpenJPEG failed to encode"
        with open(path, "rb") as f:
            return f.read()


def j2k_split(cs: bytes):
    """A codestream -> ([main header segments], [(tile-part header segments,
    body)]); a segment is (marker, its bytes)."""
    def segments(pos, stop):
        segs = []
        while struct.unpack(">H", cs[pos:pos + 2])[0] != stop:
            length = struct.unpack(">H", cs[pos + 2:pos + 4])[0]
            segs.append((struct.unpack(">H", cs[pos:pos + 2])[0], cs[pos:pos + 2 + length]))
            pos += 2 + length
        return segs, pos

    main, pos = segments(2, 0xFF90)
    parts = []
    while cs[pos:pos + 2] == b"\xff\x90":
        start, psot = pos, struct.unpack(">I", cs[pos + 6:pos + 10])[0]
        segs, pos = segments(pos, 0xFF93)
        end = start + psot if psot else len(cs) - 2
        parts.append((segs, cs[pos + 2:end]))
        pos = end
    return main, parts


def j2k_join(main, parts) -> bytes:
    """`j2k_split`'s pieces -> a codestream, each Psot set again."""
    out = bytearray(b"\xff\x4f" + b"".join(s for _, s in main))
    for segs, body in parts:
        head = bytearray(b"".join(s for _, s in segs))
        struct.pack_into(">I", head, 6, len(head) + 2 + len(body))
        out += bytes(head) + b"\xff\x93" + body
    return bytes(out + b"\xff\xd9")


def _packets(body: bytes):
    """A tile-part body written with SOP and EPH -> [(SOP, header with its
    EPH, data)] (no 0xFF91 or 0xFF92 can occur inside a header or data)."""
    out, pos = [], 0
    while pos < len(body):
        eph = body.index(b"\xff\x92", pos + 6) + 2
        nxt = body.find(b"\xff\x91", eph)
        nxt = len(body) if nxt < 0 else nxt
        out.append((body[pos:pos + 6], body[pos + 6:eph], body[eph:nxt]))
        pos = nxt
    return out


def to_packed(cs: bytes, where: str, keep_markers: bool = False, chunk: int = 60000) -> bytes:
    """Moves the packet headers of a codestream written with SOP and EPH into
    PPM markers of the main header (each tile-part's headers after its Nppm)
    or PPT markers of each tile-part (Zppt counting on across a tile's
    parts), `chunk` bytes a marker; without `keep_markers` SOP and EPH go and
    Scod forgets them."""
    main, parts = j2k_split(cs)
    packed, new, zppt = b"", [], {}
    for segs, body in parts:
        pk = _packets(body)
        heads = b"".join(h if keep_markers else h[:-2] for _, h, _ in pk)
        data = b"".join((s if keep_markers else b"") + d for s, _, d in pk)
        if where == "ppt":
            tile = struct.unpack(">H", segs[0][1][4:6])[0]
            for i in range(0, max(len(heads), 1), chunk):
                z = zppt.get(tile, 0)
                zppt[tile] = z + 1
                c = heads[i:i + chunk]
                segs = segs + [(0xFF61, b"\xff\x61" + struct.pack(">HB", len(c) + 3, z) + c)]
        else:
            packed += struct.pack(">I", len(heads)) + heads
        new.append((segs, data))
    if not keep_markers:
        main = [(m, s[:4] + bytes([s[4] & ~6]) + s[5:]) if m == 0xFF52 else (m, s) for m, s in main]
    if where == "ppm":
        main = main + [(0xFF60, b"\xff\x60" + struct.pack(">HB", len(packed[i:i + chunk]) + 3, z) + packed[i:i + chunk])
                       for z, i in enumerate(range(0, len(packed), chunk))]
    return j2k_join(main, new)


def add_tlm(cs: bytes) -> bytes:
    """A TLM marker (16-bit tile indices, 32-bit lengths) of every tile-part."""
    main, parts = j2k_split(cs)
    body = b"".join(struct.pack(">HI", struct.unpack(">H", segs[0][1][4:6])[0],
                                len(b"".join(s for _, s in segs)) + 2 + len(data)) for segs, data in parts)
    return j2k_join(main + [(0xFF55, b"\xff\x55" + struct.pack(">HBB", len(body) + 4, 0, 0x60) + body)], parts)


def jp2_box(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", 8 + len(body)) + kind + body


def jp2_file(cs: bytes, w: int, h: int, nc: int, bpc: int = 7, colr=None, icc=None, pclr=None, cmap=None,
             cdef=None, bpcc=None, extra=(), before=()) -> bytes:
    """A JP2 file around codestream `cs`: signature, ftyp, then jp2h (ihdr,
    bpcc, colr by enumeration or ICC, pclr (entries, depths), cmap, cdef,
    `extra` boxes), boxes `before` it, and jp2c."""
    head = jp2_box(b"ihdr", struct.pack(">IIHBBBB", h, w, nc, bpc, 7, 0, 0))
    if bpcc is not None:
        head += jp2_box(b"bpcc", bytes(bpcc))
    if colr is not None:
        head += jp2_box(b"colr", struct.pack(">BBBI", 1, 0, 0, colr))
    if icc is not None:
        head += jp2_box(b"colr", struct.pack(">BBB", 2, 0, 0) + icc)
    if pclr is not None:
        entries, depths = pclr
        head += jp2_box(b"pclr", struct.pack(">HB", len(entries), len(depths)) + bytes(d - 1 for d in depths)
                        + b"".join(bytes(e) for e in entries))
    if cmap is not None:
        head += jp2_box(b"cmap", b"".join(struct.pack(">HBB", *c) for c in cmap))
    if cdef is not None:
        head += jp2_box(b"cdef", struct.pack(">H", len(cdef)) + b"".join(struct.pack(">HHH", *c) for c in cdef))
    head += b"".join(extra)
    return (jp2_box(b"jP  ", b"\r\n\x87\n") + jp2_box(b"ftyp", b"jp2 \x00\x00\x00\x00jp2 ") + b"".join(before)
            + jp2_box(b"jp2h", head) + jp2_box(b"jp2c", cs))


def j2k_fixture(size, seed: int, writer: str, opts: dict) -> bytes:
    """A JPEG 2000 file of a procedural image (see J2KS)."""
    opts = dict(opts)
    w, h = size
    rgb = procedural(w, h, seed, 0.0 if opts.pop("smooth", False) else 6.0)
    if writer == "pil":
        buf = io.BytesIO()
        mode = opts.pop("mode", "RGB")
        img = (Image.fromarray(rgb[..., 0].astype(np.uint16) * 257) if mode == "I;16"
               else Image.fromarray(rgb).convert(mode))
        img.save(buf, format="JPEG2000", **opts)
        return buf.getvalue()
    a = rgb.astype(np.int64)
    planes = [a[..., i] for i in range(3)]
    colr = opts.pop("colr", None)
    if opts.pop("ycc", False):
        a = np.asarray(Image.fromarray(rgb).convert("YCbCr")).astype(np.int64)
        planes = [a[..., i] for i in range(3)]
    if "sub" in opts:
        dx, dy = opts.pop("sub")
        hh, ww = (h // dy) * dy, (w // dx) * dx if colr else w
        if colr is None:  # odd sizes: the chroma planes' last column and row are ceil-sized
            planes = [planes[0], planes[1][::dy, ::dx], planes[2][::dy, ::dx]]
        else:
            planes = [planes[0][:hh, :ww], planes[1][:hh:dy, :ww:dx], planes[2][:hh:dy, :ww:dx]]
            w, h = ww, hh
        cs = opj_encode(planes, sub=[(1, 1), (dx, dy), (dx, dy)], **opts)
        return cs if colr is None else jp2_file(cs, w, h, 3, colr=colr)
    if opts.pop("cmyk", False):
        c = np.asarray(Image.fromarray(rgb).convert("CMYK")).astype(np.int64)
        return jp2_file(opj_encode([c[..., i] for i in range(4)], **opts), w, h, 4, colr=colr)
    n = opts.pop("palette", 0)
    if n:
        yy, xx = np.mgrid[0:h, 0:w]
        idx = (xx // 5 + yy // 4) % n
        pal = [((i * 18) % 256, (255 - i * 18) % 256, (i * 77) % 256) for i in range(n)]
        pal[7] = pal[3]  # a repeated colour: Pillow's ImagePalette.getcolor merges it
        return jp2_file(opj_encode([idx], **opts), w, h, 1, colr=colr, pclr=(pal, [8, 8, 8]),
                        cmap=[(0, 1, k) for k in range(3)])
    prec = opts.pop("prec", None)
    if prec:
        planes = [p >> (8 - b) if b < 8 else p << (b - 8) for p, b in zip(planes, prec)]
        return jp2_file(opj_encode(planes, prec=list(prec), **opts), w, h, 3, bpc=255, bpcc=[b - 1 for b in prec],
                        colr=colr)
    if opts.pop("boxes", False):
        cs = opj_encode(planes, mct=1, **opts)
        res = jp2_box(b"res ", jp2_box(b"resc", struct.pack(">HHHHbb", 3, 1, 3, 1, 2, 2)))
        return jp2_file(cs, w, h, 3, icc=bytes(range(40)), cdef=[(0, 0, 1), (1, 0, 2), (2, 0, 3)], extra=[res],
                        before=[jp2_box(b"xml ", b"<image kind='fixture'/>")])
    grey = opts.pop("grey_prec", 0)
    if grey:
        return opj_encode([planes[0] >> (8 - grey)], prec=grey, **opts)
    packed, keep, chunk = opts.pop("packed", None), opts.pop("keep_markers", False), opts.pop("chunk", 60000)
    tlm = opts.pop("tlm", False)
    cs = opj_encode(planes, mct=1, **opts)
    if packed:
        cs = to_packed(cs, packed, keep, chunk)
    return add_tlm(cs) if tlm else cs


# ----------------------------------------------------------- ICO and CUR ----
# name, seed, writer, options: "pil" (PIL's ICO save: sizes, bitmap_format,
# mode), "tie" (one directory over two 32x32 DIBs of different depths, the
# 32-bit one first: PIL loads the lower depth), "cur" (PIL's DIB ICO with
# the CUR type, a later entry wider and taller than the first).
ICOS = [
    ("ico_png_sizes_48.ico", 640, "pil", {"sizes": [(16, 16), (48, 48), (32, 32)]}),
    ("ico_bmp_p_sizes_48.ico", 641, "pil", {"sizes": [(16, 16), (48, 48)], "bitmap_format": "bmp", "mode": "P"}),
    ("ico_bmp_1bit_32.ico", 642, "pil", {"sizes": [(32, 32)], "bitmap_format": "bmp", "mode": "1"}),
    ("ico_bmp_rgba_256.ico", 643, "pil", {"sizes": [(32, 32), (256, 256)], "bitmap_format": "bmp", "mode": "RGBA"}),
    ("ico_tie_depth_32.ico", 644, "tie", {}),
    ("cur_bmp_p_48.cur", 645, "cur", {}),
]


def ico_fixture(seed: int, writer: str, opts: dict) -> bytes:
    opts = dict(opts)
    rgba = np.concatenate([procedural(256, 256, seed), procedural(256, 256, seed + 1)[..., :1]], axis=-1)
    img = Image.fromarray(rgba, "RGBA")

    def save(im, **kw):
        buf = io.BytesIO()
        im.save(buf, format="ICO", **kw)
        return buf.getvalue()

    if writer == "pil":
        return save(img.convert(opts.pop("mode", "RGBA")), **opts)
    if writer == "tie":
        a = save(img, sizes=[(32, 32)], bitmap_format="bmp")
        b = save(img.convert("P"), sizes=[(32, 32)], bitmap_format="bmp")
        da, db = a[22:], b[22:]  # the DIBs after each one-entry directory
        ea, eb = bytearray(a[6:22]), bytearray(b[6:22])
        struct.pack_into("<I", ea, 12, 6 + 32)
        struct.pack_into("<I", eb, 12, 6 + 32 + len(da))
        return a[:4] + struct.pack("<H", 2) + bytes(ea) + bytes(eb) + da + db
    data = bytearray(save(img.convert("P"), sizes=[(16, 16), (48, 48), (32, 32)], bitmap_format="bmp"))
    data[2] = 2
    return bytes(data)


# -------------------------------------------------------------- PPM family ----
# name, (W, H), seed, kind, options: "pil" (PIL's save of the mode), "raw"
# (header + samples at `maxval`, one byte below 256, else two big-endian;
# Pillow's own magics too), "plain" (P1-P3 text: comments, one inside a
# token, P1 digits without separators), "pfm" (big-endian floats, scale 2.5).
PPMS = [
    ("ppm_p6_pil_9x7.ppm", (9, 7), 650, "pil", {"mode": "RGB"}),
    ("ppm_p5_pil_9x7.pgm", (9, 7), 651, "pil", {"mode": "L"}),
    ("ppm_p5_pil_i16_9x7.pgm", (9, 7), 652, "pil", {"mode": "I;16"}),
    ("ppm_p4_pil_11x7.pbm", (11, 7), 653, "pil", {"mode": "1"}),
    ("ppm_pf_pil_9x7.pfm", (9, 7), 654, "pil", {"mode": "F"}),
    ("ppm_pf_bigendian_9x7.pfm", (9, 7), 655, "pfm", {}),
    ("ppm_p6_maxval31_9x7.ppm", (9, 7), 656, "raw", {"magic": b"P6", "maxval": 31}),
    ("ppm_p5_maxval1000_9x7.pgm", (9, 7), 657, "raw", {"magic": b"P5", "maxval": 1000}),
    ("ppm_p6_maxval4095_9x7.ppm", (9, 7), 658, "raw", {"magic": b"P6", "maxval": 4095}),
    ("ppm_p0cmyk_9x7.ppm", (9, 7), 659, "raw", {"magic": b"P0CMYK", "maxval": 255}),
    ("ppm_pycmyk_maxval200_9x7.ppm", (9, 7), 660, "raw", {"magic": b"PyCMYK", "maxval": 200}),
    ("ppm_pyrgba_9x7.ppm", (9, 7), 661, "raw", {"magic": b"PyRGBA", "maxval": 255}),
    ("ppm_pyp_9x7.ppm", (9, 7), 662, "raw", {"magic": b"PyP", "maxval": 255}),
    ("ppm_p1_plain_9x7.pbm", (9, 7), 663, "plain", {"magic": b"P1"}),
    ("ppm_p2_plain_maxval1000_9x7.pgm", (9, 7), 664, "plain", {"magic": b"P2", "maxval": 1000}),
    ("ppm_p3_plain_maxval100_9x7.ppm", (9, 7), 665, "plain", {"magic": b"P3", "maxval": 100}),
]


def ppm_fixture(size, seed: int, kind: str, opts: dict) -> bytes:
    w, h = size
    rgb = procedural(w, h, seed)
    rng = np.random.default_rng(seed)
    if kind == "pil":
        mode = opts["mode"]
        img = (Image.fromarray(rgb[..., 0].astype(np.uint16) * 250) if mode == "I;16" else
               Image.fromarray(rgb[..., 0].astype(np.float32) * 1.3 - 20.5) if mode == "F" else
               Image.fromarray(rgb).convert(mode))
        buf = io.BytesIO()
        img.save(buf, format="PPM")
        return buf.getvalue()
    if kind == "pfm":
        return b"Pf\n%d %d\n2.5\n" % (w, h) + (rgb[::-1, :, 1].astype(">f4") * 1.1 - 3.7).tobytes()
    magic, maxval = opts["magic"], opts.get("maxval", 1)
    bands = {b"P1": 1, b"P2": 1, b"P3": 3, b"P5": 1, b"P6": 3, b"PyP": 1}.get(magic, 4)
    v = rng.integers(0, maxval + 1, (h, w, bands))
    if kind == "raw":
        body = v.astype(np.uint8).tobytes() if maxval < 256 else v.astype(">u2").tobytes()
        return magic + b" %d %d %d\n" % (w, h, maxval) + body
    head = magic + b"\n# a comment\n%d %d\n" % (w, h) + (b"" if magic == b"P1" else b"%d # max\n" % maxval)
    if magic == b"P1":  # digits without separators, then a comment, then spaced digits
        flat = "".join(str(int(x)) for x in v.ravel())
        return head + flat[:20].encode() + b"#c\n" + " ".join(flat[20:]).encode()
    toks = [b"%d" % x for x in v.ravel()]
    toks[5] = toks[5][:1] + b"#split\n" + toks[5][1:]  # a comment inside a token joins its halves
    return head + b"\n".join(b" ".join(toks[i:i + 7]) for i in range(0, len(toks), 7))


# ------------------------------------------------------------------ TGA ----
# name, (W, H), seed, writer, options: "pil" (PIL's save of the mode, RLE on
# or off, orientation 1 for top-down; not 1-bit RLE, which PIL refuses), "edit" (PIL's save, then the header's
# flags, or a colour map start / depth rewritten), "rle_rows" (a hand-written
# RLE file whose literal packets run on across rows).
TGAS = ([(f"tga_pil_{m.lower()}{'_rle' if rle else ''}{'_topdown' if o > 0 else ''}_19x13.tga", (19, 13),
          700 + 4 * i + 2 * rle + (o > 0), "pil", {"mode": m, "rle": rle, "orientation": o})
         for i, m in enumerate(("1", "L", "LA", "P", "RGB", "RGBA")) for rle in (False, True) for o in (-1, 1)
         if not (m == "1" and rle)]  # PIL cannot read its own 1-bit RLE files back (0 bytes a pixel)
        + [("tga_flip_h_rgb_19x13.tga", (19, 13), 730, "edit", {"mode": "RGB", "flags": 0x10}),
           ("tga_flip_hv_rgba_rle_19x13.tga", (19, 13), 731, "edit", {"mode": "RGBA", "rle": True, "flags": 0x38}),
           ("tga_cmap_start5_24_19x13.tga", (19, 13), 732, "edit", {"mode": "P", "map_start": 5}),
           ("tga_cmap16_19x13.tga", (19, 13), 733, "edit", {"mode": "P", "map_depth": 16}),
           ("tga_cmap16_start3_rle_19x13.tga", (19, 13), 734, "edit", {"mode": "P", "map_depth": 16,
                                                                          "map_start": 3, "rle": True}),
           ("tga_rgb15_19x13.tga", (19, 13), 735, "edit", {"mode": "RGB", "depth": 16}),
           ("tga_l_cmap_id_19x13.tga", (19, 13), 736, "edit", {"mode": "L", "grey_map": True, "id": b"port"}),
           ("tga_rle_rows_rgb_19x13.tga", (19, 13), 737, "rle_rows", {})])


def _tga_pil(rgb: np.ndarray, mode: str, **save) -> bytes:
    img = Image.fromarray(rgb)
    img = img.quantize(200) if mode == "P" else img.convert(mode if mode != "LA" and mode != "RGBA" else "RGBA")
    if mode == "LA":
        img = img.convert("LA")
    buf = io.BytesIO()
    img.save(buf, format="TGA", **save)
    return buf.getvalue()


def tga_fixture(size, seed: int, writer: str, opts: dict) -> bytes:
    w, h = size
    rgb = procedural(w, h, seed)
    if writer == "pil":
        return _tga_pil(rgb, opts["mode"], rle=opts["rle"], orientation=opts["orientation"])
    if writer == "rle_rows":  # 24-bit RLE: literals of 5 pixels, runs of 3, crossing rows
        px = rgb[::-1, :, ::-1].reshape(-1, 3)  # bottom-up BGR
        out, i = bytearray(), 0
        while i < len(px):
            n = min(5, len(px) - i)
            if n == 3 or (i // 8) % 2:  # a run of 3 equal pixels (the first repeated), within a row
                n = min(3, len(px) - i, w - (i % w))
                out += bytes([0x80 | (n - 1)]) + px[i].tobytes()
            else:
                out += bytes([n - 1]) + px[i:i + n].tobytes()
            i += n
        return struct.pack("<BBBHHBHHHHBB", 0, 0, 10, 0, 0, 0, 0, 0, w, h, 24, 0) + bytes(out)
    data = bytearray(_tga_pil(rgb, opts["mode"], rle=opts.get("rle", False)))
    if "flags" in opts:
        data[17] = opts["flags"]
    if opts.get("depth") == 16:  # 5-5-5 truecolor: rewrite the pixels
        v = (rgb[::-1].astype(np.uint16) >> 3)
        words = (v[..., 0] << 10 | v[..., 1] << 5 | v[..., 2] | 0x8000).astype("<u2")
        return bytes(data[:16]) + bytes([16, 0]) + words.tobytes()
    if opts.get("grey_map"):  # an L image with a 24-bit colour map (PIL turns it into P) and an ID field
        ident = opts["id"]
        pal = bytes(np.arange(256 * 3, dtype=np.uint32).astype(np.uint8)[::-1])
        head = struct.pack("<BBBHHBHHHHBB", len(ident), 1, 3, 0, 256, 24, 0, 0, w, h, 8, 0)
        return head + ident + pal + bytes(data[18:18 + w * h])
    if "map_start" in opts or "map_depth" in opts:  # PIL writes a 24-bit map from index 0
        count = struct.unpack_from("<H", data, 5)[0]
        pal = np.frombuffer(bytes(data[18:18 + 3 * count]), np.uint8).reshape(-1, 3)  # BGR
        start = opts.get("map_start", 0)
        pal = pal[:max(count - start, 0)]
        body = bytes(data[18 + 3 * count:])
        if opts.get("map_depth") == 16:
            v = pal.astype(np.uint16) >> 3
            entries = (v[:, 2] << 10 | v[:, 1] << 5 | v[:, 0]).astype("<u2").tobytes()
        else:
            entries = pal.tobytes()
        head = bytearray(data[:18])
        struct.pack_into("<HHB", head, 3, start, len(pal), opts.get("map_depth", 24))
        return bytes(head) + entries + body
    return bytes(data)


# ------------------------------------------------------------------ PSD ----
# name, (W, H), seed, (colour mode, bits, channels), compression (0 raw, 1
# PackBits), options: "palette" (768 bytes of colour-mode data), "sections"
# (image resources and a layer section to skip).
PSDS = [(f"psd_{tag}_{'rle' if comp else 'raw'}_19x13.psd", (19, 13), 760 + 2 * i + comp, mode, comp,
         {"palette": tag == "indexed", "sections": bool(comp) or i % 2 == 0})
        for i, (tag, mode) in enumerate((("bitmap", (0, 1, 1)), ("grey", (1, 8, 1)), ("grey_mode0", (0, 8, 1)),
                                         ("indexed", (2, 8, 1)), ("indexed_nopal", (2, 8, 1)), ("rgb", (3, 8, 3)),
                                         ("rgba", (3, 8, 4)), ("rgb_5ch", (3, 8, 5)), ("cmyk", (4, 8, 4)),
                                         ("multichannel", (7, 8, 1)), ("duotone", (8, 8, 1)), ("lab", (9, 8, 3))))
        for comp in (0, 1)]


def write_psd(planes, size, mode: int, bits: int, compression: int, palette: bytes = b"",
              sections: bool = False) -> bytes:
    """A PSD of `planes` ((H, row bytes) uint8 each): header, colour-mode
    data, image resources and a layer section (when `sections`), then the
    merged image raw or PackBits (`packbits_encode` rows, their byte counts
    first)."""
    w, h = size
    res = lay = b""
    if sections:
        res = b"8BIM" + struct.pack(">HB", 1005, 3) + b"abc" + struct.pack(">I", 5) + b"12345\0"
        res += b"8BIM" + struct.pack(">HB", 1039, 0) + b"\0" + struct.pack(">I", 4) + b"ICC!"
        lay = struct.pack(">I", 12) + bytes(12) + b"layer data"
    out = b"8BPS" + struct.pack(">H6xHIIHH", 1, len(planes), h, w, bits, mode)
    out += struct.pack(">I", len(palette)) + palette + struct.pack(">I", len(res)) + res
    out += struct.pack(">I", len(lay)) + lay
    if compression == 0:
        return out + struct.pack(">H", 0) + b"".join(p.tobytes() for p in planes)
    rows = [packbits_encode(p[y].tobytes()) for p in planes for y in range(p.shape[0])]
    return out + struct.pack(">H", 1) + b"".join(struct.pack(">H", len(r)) for r in rows) + b"".join(rows)


def psd_fixture(size, seed: int, mode, compression: int, opts: dict) -> bytes:
    w, h = size
    rgb = procedural(w, h, seed)
    psd_mode, bits, channels = mode
    rng = np.random.default_rng(seed)
    if bits == 1:
        planes = [np.packbits(rgb[..., 0] > 128, axis=1)]
    else:
        bands = [rgb[..., 0], rgb[..., 1], rgb[..., 2], (rgb[..., 0] // 2 + 60).astype(np.uint8),
                 rng.integers(0, 256, (h, w)).astype(np.uint8)]
        planes = [np.ascontiguousarray(b) for b in bands[:channels]]
        if psd_mode == 2:
            planes = [(rgb[..., 0] // 4 + rgb[..., 1] // 8).astype(np.uint8)]
    palette = bytes(rng.integers(0, 256, 768).astype(np.uint8)) if opts["palette"] else b""
    return write_psd(planes, size, psd_mode, bits, compression, palette, opts["sections"])


# ------------------------------------------------------------------ QOI ----
QOIS = [("qoi_pil_rgb_37x23.qoi", (37, 23), 780, "RGB"), ("qoi_pil_rgba_37x23.qoi", (37, 23), 781, "RGBA")]


def qoi_fixture(size, seed: int, mode: str) -> bytes:
    w, h = size
    rgb = procedural(w, h, seed, noise=0.0)
    rgb[:, : w // 3] = rgb[:, :1] // 16 * 16  # flat runs and repeats for the run and index ops
    alpha = (np.arange(w)[None, :] * 7 % 256 + np.zeros((h, 1))).astype(np.uint8)
    img = Image.fromarray(np.dstack([rgb, alpha]), "RGBA").convert(mode)
    buf = io.BytesIO()
    img.save(buf, format="QOI")
    return buf.getvalue()


# ------------------------------------------------------------------ DDS ----
# name, (W, H), seed, writer, options: "pil" (PIL's save, `pixel_format` for
# its BCn encoder), "blocks" (blocks that numpy draws: `fourcc` or `dxgi`
# names the format, `thin` clears most bits so BC6H's halves stay in range,
# `mips` appends a smaller surface), "raw" (an uncompressed kind PIL does not
# write: an 8-bit palette, 5-6-5 bit masks, DX10 R8G8B8A8).
DDSS = [
    ("dds_pil_dxt1_37x23.dds", (37, 23), 800, "pil", {"mode": "RGBA", "pixel_format": "DXT1"}),
    ("dds_pil_dxt3_37x23.dds", (37, 23), 801, "pil", {"mode": "RGBA", "pixel_format": "DXT3"}),
    ("dds_pil_dxt5_37x23.dds", (37, 23), 802, "pil", {"mode": "RGBA", "pixel_format": "DXT5"}),
    ("dds_pil_bc2_37x23.dds", (37, 23), 803, "pil", {"mode": "RGBA", "pixel_format": "BC2"}),
    ("dds_pil_bc3_37x23.dds", (37, 23), 804, "pil", {"mode": "RGBA", "pixel_format": "BC3"}),
    ("dds_pil_bc5_37x23.dds", (37, 23), 805, "pil", {"mode": "RGB", "pixel_format": "BC5"}),
    ("dds_pil_rgb_37x23.dds", (37, 23), 806, "pil", {"mode": "RGB"}),
    ("dds_pil_rgba_37x23.dds", (37, 23), 807, "pil", {"mode": "RGBA"}),
    ("dds_pil_l_37x23.dds", (37, 23), 808, "pil", {"mode": "L"}),
    ("dds_pil_la_37x23.dds", (37, 23), 809, "pil", {"mode": "LA"}),
    ("dds_blocks_bc4u_37x23.dds", (37, 23), 810, "blocks", {"fourcc": b"BC4U"}),
    ("dds_blocks_ati2_37x23.dds", (37, 23), 811, "blocks", {"fourcc": b"ATI2"}),
    ("dds_blocks_bc5s_37x23.dds", (37, 23), 812, "blocks", {"fourcc": b"BC5S"}),
    ("dds_blocks_bc6h_uf16_37x23.dds", (37, 23), 813, "blocks", {"dxgi": 95, "thin": True}),
    ("dds_blocks_bc6h_sf16_37x23.dds", (37, 23), 814, "blocks", {"dxgi": 96, "thin": True}),
    ("dds_blocks_bc7_37x23.dds", (37, 23), 815, "blocks", {"dxgi": 98}),
    ("dds_blocks_bc7_srgb_mips_32x16.dds", (32, 16), 816, "blocks", {"dxgi": 99, "mips": True}),
    ("dds_raw_p8_19x13.dds", (19, 13), 817, "raw", {"kind": "p8"}),
    ("dds_raw_rgb565_19x13.dds", (19, 13), 818, "raw", {"kind": "rgb565"}),
    ("dds_raw_dx10_rgba8_19x13.dds", (19, 13), 819, "raw", {"kind": "rgba8"}),
]
# phase 5e's BC7 timing file: not committed; its PIL decode hash is in generated.json
DDS_TIMING = ("dds_bc7_1024x768", (1024, 768), 820)


def write_dds(size, pfflags: int, fourcc: bytes = b"\0\0\0\0", bitcount: int = 0, masks=(0, 0, 0, 0),
              dxgi: int | None = None, body: bytes = b"", caps2: int = 0) -> bytes:
    """A DDS file: the 124-byte header (DX10's extension when `dxgi` is
    given), then `body`."""
    w, h = size
    head = struct.pack("<4s7I44x", b"DDS ", 124, 0x1007, h, w, 0, 0, 0)
    pf = struct.pack("<2I4s5I", 32, pfflags, fourcc, bitcount, *masks)
    caps = struct.pack("<4I4x", 0x1000, caps2, 0, 0)
    ext = struct.pack("<5I", dxgi, 3, 0, 1, 0) if dxgi is not None else b""
    return head + pf + caps + ext + body


def bc_blocks(n: int, block: int, seed: int, kind: str = "", thin: bool = False) -> np.ndarray:
    """(n, block) uint8 random blocks: BC7's eight modes drawn evenly; `thin`
    keeps one bit in eight (BC6H endpoints that stay in range)."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 256, (n, block)).astype(np.uint8)
    if thin:
        b &= rng.integers(0, 256, (n, block)).astype(np.uint8) & rng.integers(0, 256, (n, block)).astype(np.uint8)
        b[:, 0] = rng.integers(0, 256, n).astype(np.uint8)  # every mode
    if kind == "bc7":
        m = rng.integers(0, 8, n)
        b[:, 0] = (b[:, 0] & ~((2 << m) - 1).astype(np.uint8)) | (1 << m).astype(np.uint8)
    return b


def dds_fixture(size, seed: int, writer: str, opts: dict) -> bytes:
    w, h = size
    rgb = procedural(w, h, seed)
    if writer == "pil":
        alpha = (rgb[..., 0] // 3 + 100).astype(np.uint8)
        img = Image.fromarray(np.dstack([rgb, alpha]), "RGBA").convert(opts["mode"])
        buf = io.BytesIO()
        img.save(buf, format="DDS", **{k: v for k, v in opts.items() if k == "pixel_format"})
        return buf.getvalue()
    if writer == "blocks":
        nb = ((w + 3) // 4) * ((h + 3) // 4)
        fourcc = opts.get("fourcc", b"DX10")
        block = 8 if fourcc in (b"BC4U", b"ATI1") else 16
        kind = "bc7" if opts.get("dxgi") in (97, 98, 99) else ""
        body = bc_blocks(nb, block, seed, kind, opts.get("thin", False)).tobytes()
        if opts.get("mips"):  # the next level, which PIL does not read
            body += bc_blocks(((w // 2 + 3) // 4) * ((h // 2 + 3) // 4), block, seed + 1, kind).tobytes()
        return write_dds(size, 0x4, fourcc, dxgi=opts.get("dxgi"), body=body)
    rng = np.random.default_rng(seed)
    if opts["kind"] == "p8":
        pal = rng.integers(0, 256, 1024).astype(np.uint8).tobytes()
        return write_dds(size, 0x20, bitcount=8, body=pal + (rgb[..., 0] // 2).tobytes())
    if opts["kind"] == "rgb565":
        v = rgb.astype(np.uint16)
        words = ((v[..., 0] >> 3) << 11 | (v[..., 1] >> 2) << 5 | (v[..., 2] >> 3)).astype("<u2")
        return write_dds(size, 0x40, bitcount=16, masks=(0xF800, 0x7E0, 0x1F, 0), body=words.tobytes())
    rgba = np.dstack([rgb, rgb[..., :1]])
    return write_dds(size, 0x4, b"DX10", dxgi=28, body=rgba.tobytes())


def dds_timing_file() -> bytes:
    """Phase 5e's 1024x768 BC7 DDS: blocks numpy draws from a fixed seed."""
    _, (w, h), seed = DDS_TIMING
    return write_dds((w, h), 0x4, b"DX10", dxgi=98, body=bc_blocks((w // 4) * (h // 4), 16, seed, "bc7").tobytes())


def resize_chain(img: Image.Image, chain: str) -> np.ndarray:
    for step in chain.split(","):
        img = img.resize(tuple(int(v) for v in step.split("x")))
    return np.asarray(img)


def pil_decode_sha(data: bytes) -> str:
    return sha(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")))


def write(name: str, data: bytes) -> None:
    with open(os.path.join(HERE, name), "wb") as f:
        f.write(data)


def webp_entry(data: bytes, size, **extra) -> dict:
    img = Image.open(io.BytesIO(data))
    return dict({"kind": "webp", "size": size, "file_sha256": hashlib.sha256(data).hexdigest(),
                 "decode_sha256": sha(np.asarray(img.convert("RGB"))),
                 "rgba_sha256": sha(np.asarray(img.convert("RGBA")))}, **extra)


def main() -> None:
    manifest = {}
    for name, (w, h), seed, opts, chains in FIXTURES:
        opts = dict(opts)
        mode = opts.pop("mode", "RGB")
        adobe = opts.pop("adobe", 0)
        cut = opts.pop("cut_scans", None)
        dqt = opts.pop("dqt", None)
        img = Image.fromarray(procedural(w, h, seed)).convert(mode)
        buf = io.BytesIO()
        img.save(buf, format="JPEG", **opts)
        data = buf.getvalue()
        if dqt is not None:
            data = set_dqt(data, dqt)
        if mode == "CMYK" and adobe != 0:
            data = set_adobe(data, adobe)
        if cut is not None:
            data = cut_scans(data, cut)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        save = dict(opts, **({"adobe": adobe} if mode == "CMYK" else {}),
                    **({"cut_scans": cut} if cut is not None else {}), **({"dqt": dqt} if dqt is not None else {}))
        entry = {"kind": "jpeg", "size": [w, h], "mode": mode, "seed": seed, "save": save,
                 "file_sha256": hashlib.sha256(data).hexdigest()}
        dec = Image.open(io.BytesIO(data)).convert("RGB")
        entry["decode_sha256"] = sha(np.asarray(dec))
        entry["resize_sha256"] = {c: sha(resize_chain(dec, c)) for c in chains}
        manifest[name] = entry
    for table, coding in ((ARITH, "arithmetic"), (LOSSLESS, "lossless")):
        for name, (w, h), seed, opts in table:
            data = coded_jpeg((w, h), seed, opts, coding == "lossless")
            write(name, data)
            manifest[name] = {"kind": "jpeg", "coding": coding, "size": [w, h], "seed": seed, "save": opts,
                              "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data),
                              "resize_sha256": {}}
    for name, (w, h), seed, opts in WEBPS:
        data = webp_fixture((w, h), seed, opts)
        write(name, data)
        manifest[name] = webp_entry(data, [w, h], seed=seed, save=opts)
    for t in range(0, CLIP_FRAMES, 2):
        buf = io.BytesIO()
        Image.fromarray(clip_frame(t)).save(buf, format="WEBP", lossless=True)
        name = f"clip_{CLIP_PX}_t{t}.webp"
        write(name, buf.getvalue())
        manifest[name] = webp_entry(buf.getvalue(), [CLIP_PX, CLIP_PX], clip_frame=t, save={"lossless": True})
        assert manifest[name]["decode_sha256"] == sha(clip_frame(t))
    for i, (name, bits, hsize, compression, opts) in enumerate(BMPS):
        data = bmp_fixture(bits, hsize, compression, opts, 500 + i)
        write(name, data)
        manifest[name] = {"kind": "bmp", "size": [37, 23], "bits": bits, "header": hsize,
                          "compression": compression, "file_sha256": hashlib.sha256(data).hexdigest(),
                          "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, kind, opts in GIFS:
        data = gif_fixture((w, h), seed, kind, opts)
        write(name, data)
        manifest[name] = {"kind": "gif", "size": [w, h], "seed": seed, "writer": kind, "save": opts,
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, kind, opts in TIFFS:
        data = tiff_fixture((w, h) if "orientation" not in opts or opts["orientation"] < 5 else (h, w), seed, kind, opts)
        write(name, data)
        manifest[name] = {"kind": "tiff", "size": [w, h], "seed": seed, "writer": kind,
                          "save": {k: list(v) if isinstance(v, tuple) else v for k, v in opts.items()},
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for i, (name, color, depth, interlace, trns) in enumerate(PNGS):
        data = png_fixture(color, depth, interlace, trns, 100 + i)
        with open(os.path.join(HERE, name), "wb") as f:
            f.write(data)
        manifest[name] = {"kind": "png", "size": [19, 13], "color_type": color, "bit_depth": depth,
                          "interlace": interlace, "trns": trns, "file_sha256": hashlib.sha256(data).hexdigest(),
                          "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, writer, opts in J2KS:
        data = j2k_fixture((w, h), seed, writer, opts)
        write(name, data)
        manifest[name] = {"kind": "jpeg2000", "size": [w, h], "seed": seed, "writer": writer,
                          "save": {k: v if isinstance(v, (int, float, str, bool, type(None))) else repr(v)
                                   for k, v in opts.items()},
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for name, seed, writer, opts in ICOS:
        data = ico_fixture(seed, writer, opts)
        write(name, data)
        w, h = Image.open(io.BytesIO(data)).size
        manifest[name] = {"kind": "cur" if name.endswith(".cur") else "ico", "size": [w, h], "seed": seed,
                          "writer": writer,
                          "save": {k: repr(v) if isinstance(v, list) else v for k, v in opts.items()},
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, kind, opts in PPMS:
        data = ppm_fixture((w, h), seed, kind, opts)
        write(name, data)
        manifest[name] = {"kind": "ppm", "size": [w, h], "seed": seed, "writer": kind,
                          "save": {k: v.decode() if isinstance(v, bytes) else v for k, v in opts.items()},
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, writer, opts in TGAS:
        data = tga_fixture((w, h), seed, writer, opts)
        write(name, data)
        manifest[name] = {"kind": "tga", "size": [w, h], "seed": seed, "writer": writer,
                          "save": {k: v.decode() if isinstance(v, bytes) else v for k, v in opts.items()},
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, mode, comp, opts in PSDS:
        data = psd_fixture((w, h), seed, mode, comp, opts)
        write(name, data)
        manifest[name] = {"kind": "psd", "size": [w, h], "seed": seed, "mode": list(mode), "compression": comp,
                          "save": opts, "file_sha256": hashlib.sha256(data).hexdigest(),
                          "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, mode in QOIS:
        data = qoi_fixture((w, h), seed, mode)
        write(name, data)
        manifest[name] = {"kind": "qoi", "size": [w, h], "seed": seed, "mode": mode,
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    for name, (w, h), seed, writer, opts in DDSS:
        data = dds_fixture((w, h), seed, writer, opts)
        write(name, data)
        manifest[name] = {"kind": "dds", "size": [w, h], "seed": seed, "writer": writer,
                          "save": {k: v.decode() if isinstance(v, bytes) else v for k, v in opts.items()},
                          "file_sha256": hashlib.sha256(data).hexdigest(), "decode_sha256": pil_decode_sha(data)}
    timing = dds_timing_file()
    with open(os.path.join(HERE, "generated.json"), "w") as f:
        json.dump({DDS_TIMING[0]: {"size": list(DDS_TIMING[1]), "seed": DDS_TIMING[2],
                                   "file_sha256": hashlib.sha256(timing).hexdigest(),
                                   "decode_sha256": pil_decode_sha(timing)}}, f, indent=1, sort_keys=True)
        f.write("\n")
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
