// TIFF decoding of the first image of a file, as Pillow 12.1's
// TiffImagePlugin opens it (over libtiff 4.7 for compressed data) and
// `convert("RGB")` converts it, behind a plain C interface bound with ctypes
// in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * the header (classic II / MM, BigTIFF, and the two swapped magics PIL
//     accepts) and the first IFD as ImageFileDirectory_v2 reads it: the
//     types it knows (an entry of another type is skipped, BigTIFF's SLONG8
//     and IFD8 among them), values past the entry read from their offset, an
//     entry or value cut short ending the walk with the tags read so far,
//     one value taken for the tags Pillow defines with one, tuples for the
//     others, bytes for BYTE and UNDEFINED;
//   * `_setup`: the defaults, the old-JPEG photometric, SampleFormat
//     collapsed, BitsPerSample trimmed or repeated to SamplesPerPixel, the
//     OPEN_INFO key (every one of its 120 keys; another is refused as PIL
//     refuses it) and the ColorMap as the palette (high bytes);
//   * uncompressed data: ImageFile's tile list (strips or tiles, the stride
//     of edge tiles, one tile covering the image read from the last offset,
//     planar layers by the rawmode's letters, tiles sorted by offset and
//     consecutive duplicates dropped), read from each offset to the end of
//     the file by Pillow's raw decoder and unpackers (Unpack.c);
//   * compressed data as libtiff hands it to TiffDecode.c, by libtiff's own
//     reading of the directory (its first entry of a repeated tag, its types,
//     counts, defaults and fatal fields; its size checked against Pillow's):
//     strips or tiles, FillOrder 2 reversed, PackBits, LZW (with the old
//     LSB-first codes libtiff detects), Deflate and LZMA (inflated through the
//     caller's `inflate`, Python's zlib and lzma), JPEG (decoded through the
//     caller's `jpeg`, image_io.cpp's decoder as libjpeg runs under
//     tif_jpeg.c: JPEGTables, then each strip or tile on its own, YCbCr
//     converted to RGB, every other photometric as raw components), ZSTD
//     (the caller's `zstd`, zstd.cpp, as tif_zstd.c streams a strip), CCITT
//     RLE, RLEW (rows word-aligned), Group 3 (1D and 2D) and Group 4
//     (tif_fax3.c's state machine), ThunderScan (tif_thunder.c), old-style
//     JPEG (tif_ojpeg.c's rebuilt stream, decoded to raw components by the
//     caller's `ojpeg`, image_io.cpp), predictors 2 and 3, planes by
//     TiffDecode.c's per-band unpackers, and YCbCr that is not JPEG in one
//     plane through TIFFRGBAImage (strips, tiles and 1x1 planes;
//     tif_getimage.c, tif_color.c), then Pillow's rawmode (native order);
//   * `convert("RGB")` of each mode (Convert.c; LAB through a copy of
//     ImageCms's littleCMS transform, LabToRgb below), then
//     ImageOps.exif_transpose's Orientation (2-8; the XMP tiff:Orientation
//     when the tag is absent), and Pillow's decompression-bomb limit on the
//     stored size.
//
// Old-style JPEG in tiles or planes, or in a sampling libjpeg upsamples
// itself, returns RF_REFUSED ("... is not read by the port"). What PIL refuses
// returns RF_REFUSED ("... as PIL refuses it"); corrupt or truncated data
// returns RF_CORRUPT. Every read is bounded by the buffer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <map>
#include <string>
#include <vector>

#include "codec_common.h"
#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS

// The caller's codecs: inflate(kind 8 zlib / 34925 xz, src, n, dst, cap) ->
// bytes written (at most cap) or -1 on a decoding error; jpeg(...) -> 0 or an
// error (image_io.cpp rf_jpeg_tiff_decode).
typedef int64_t (*InflateFn)(int32_t kind, const uint8_t* src, int64_t n, uint8_t* dst, int64_t cap);
// ojpeg(stream, n, premature, out, cap, dims, err, err_cap): image_io.cpp rf_jpeg_ojpeg_decode.
typedef int (*OjpegFn)(const uint8_t* data, int64_t n, int32_t premature, uint8_t* out, int64_t cap, int32_t* dims,
                       char* err, int64_t err_cap);
// zstd(src, n, dst, occ) -> 1 when the strip fills occ bytes (zstd.cpp rf_zstd_tiff_decode).
typedef int (*ZstdFn)(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ);
typedef int (*JpegFn)(const uint8_t* tables, int64_t tn, const uint8_t* data, int64_t n, int32_t ycc_to_rgb,
                      int32_t hs, int32_t vs, int32_t nc, int32_t seg_w, int32_t seg_h, int32_t allow_taller,
                      uint8_t* out, int64_t out_stride, char* err, int64_t err_cap);

uint8_t kBitRev[256];
struct BitRevInit {
  BitRevInit() {
    for (int i = 0; i < 256; ++i) {
      int r = 0;
      for (int b = 0; b < 8; ++b)
        if (i & (1 << b)) r |= 0x80 >> b;
      kBitRev[i] = static_cast<uint8_t>(r);
    }
  }
} bitrev_init;

// ------------------------------------------------------------ tag values ----

// A decoded tag value as Pillow holds it: a number, a tuple of numbers, bytes
// (BYTE), or something no key or size matches (a string, undefined bytes).
struct Value {
  enum Kind { NUM, TUPLE, BYTES, OTHER } kind = OTHER;
  std::vector<double> v;      // the numbers (a rational with denominator 0 is NaN)
  std::vector<bool> integer;  // isinstance(x, int)
  std::vector<uint8_t> raw;   // BYTES data

  size_t size() const { return kind == NUM ? 1 : v.size(); }
  bool is_int(size_t i = 0) const {
    return (kind == NUM || kind == TUPLE || kind == BYTES) && i < v.size() && integer[i];
  }
};

Value num(double x, bool integer = true) {
  Value r;
  r.kind = Value::NUM;
  r.v = {x};
  r.integer = {integer};
  return r;
}

Value tuple(std::initializer_list<double> xs) {
  Value r;
  r.kind = Value::TUPLE;
  r.v = xs;
  r.integer.assign(xs.size(), true);
  return r;
}

// Python's == between two values as the key lookups compare them.
bool same(const Value& a, const Value& b) {
  if (a.kind == Value::OTHER || b.kind == Value::OTHER) return false;
  if ((a.kind == Value::BYTES) != (b.kind == Value::BYTES)) return false;
  if ((a.kind == Value::NUM) != (b.kind == Value::NUM)) return false;
  if (a.kind == Value::BYTES) return a.raw == b.raw;
  if (a.v.size() != b.v.size()) return false;
  for (size_t i = 0; i < a.v.size(); ++i)
    if (!(a.v[i] == b.v[i])) return false;
  return true;
}

bool is(const Value& a, double x) { return a.kind == Value::NUM && a.v[0] == x; }

// Tags Pillow defines with one value (TiffTags.TAGS_V2 length 1) among those
// read here, and those defined with a tuple; other tags hold one value when
// they have one.
bool single_valued(int tag) {
  switch (tag) {
    case 256: case 257: case 259: case 262: case 266: case 274: case 277: case 278: case 284:
    case 317: case 322: case 323: case 292: case 293: case 347:
      return true;
    default:
      return false;
  }
}
bool tuple_valued(int tag) {
  switch (tag) {
    case 258: case 273: case 279: case 320: case 324: case 325: case 338: case 339: case 530: case 529:
    case 532: case 700:
      return true;
    default:
      return false;
  }
}

// ------------------------------------------------------------------ modes ----

enum Mode { M1, ML, MP, MLA, MPA, MI16, MI16B, MI, MF, MRGB, MRGBA, MCMYK, MLAB };

int pixel_size(Mode m) {
  switch (m) {
    case M1: case ML: case MP: return 1;
    case MI16: case MI16B: return 2;
    default: return 4;
  }
}

Mode mode_of(const std::string& s) {
  static const std::map<std::string, Mode> k = {
      {"1", M1}, {"L", ML}, {"P", MP}, {"LA", MLA}, {"PA", MPA}, {"I;16", MI16}, {"I;16B", MI16B},
      {"I", MI}, {"F", MF}, {"RGB", MRGB}, {"RGBA", MRGBA}, {"CMYK", MCMYK}, {"LAB", MLAB}};
  return k.at(s);
}

// One OPEN_INFO key: (prefix, photometric, SampleFormat, FillOrder,
// BitsPerSample, ExtraSamples) -> (mode, rawmode). prefix 0 = both byte
// orders, 'I' or 'M' one.
struct OpenInfo {
  char prefix;
  int photo;
  std::vector<int> sample_format;
  int fillorder;
  std::vector<int> bps, extra;
  const char* mode;
  const char* rawmode;
};

const std::vector<OpenInfo>& open_info() {
  static const std::vector<OpenInfo> t = {
      {0, 0, {1}, 1, {1}, {}, "1", "1;I"},
      {0, 0, {1}, 2, {1}, {}, "1", "1;IR"},
      {0, 1, {1}, 1, {1}, {}, "1", "1"},
      {0, 1, {1}, 2, {1}, {}, "1", "1;R"},
      {0, 0, {1}, 1, {2}, {}, "L", "L;2I"},
      {0, 0, {1}, 2, {2}, {}, "L", "L;2IR"},
      {0, 1, {1}, 1, {2}, {}, "L", "L;2"},
      {0, 1, {1}, 2, {2}, {}, "L", "L;2R"},
      {0, 0, {1}, 1, {4}, {}, "L", "L;4I"},
      {0, 0, {1}, 2, {4}, {}, "L", "L;4IR"},
      {0, 1, {1}, 1, {4}, {}, "L", "L;4"},
      {0, 1, {1}, 2, {4}, {}, "L", "L;4R"},
      {0, 0, {1}, 1, {8}, {}, "L", "L;I"},
      {0, 0, {1}, 2, {8}, {}, "L", "L;IR"},
      {0, 1, {1}, 1, {8}, {}, "L", "L"},
      {0, 1, {2}, 1, {8}, {}, "L", "L"},
      {0, 1, {1}, 2, {8}, {}, "L", "L;R"},
      {'I', 1, {1}, 1, {12}, {}, "I;16", "I;12"},
      {'I', 0, {1}, 1, {16}, {}, "I;16", "I;16"},
      {'I', 1, {1}, 1, {16}, {}, "I;16", "I;16"},
      {'M', 1, {1}, 1, {16}, {}, "I;16B", "I;16B"},
      {'I', 1, {1}, 2, {16}, {}, "I;16", "I;16R"},
      {'I', 1, {2}, 1, {16}, {}, "I", "I;16S"},
      {'M', 1, {2}, 1, {16}, {}, "I", "I;16BS"},
      {'I', 0, {3}, 1, {32}, {}, "F", "F;32F"},
      {'M', 0, {3}, 1, {32}, {}, "F", "F;32BF"},
      {'I', 1, {1}, 1, {32}, {}, "I", "I;32N"},
      {'I', 1, {2}, 1, {32}, {}, "I", "I;32S"},
      {'M', 1, {2}, 1, {32}, {}, "I", "I;32BS"},
      {'I', 1, {3}, 1, {32}, {}, "F", "F;32F"},
      {'M', 1, {3}, 1, {32}, {}, "F", "F;32BF"},
      {0, 1, {1}, 1, {8, 8}, {2}, "LA", "LA"},
      {0, 2, {1}, 1, {8, 8, 8}, {}, "RGB", "RGB"},
      {0, 2, {1}, 2, {8, 8, 8}, {}, "RGB", "RGB;R"},
      {0, 2, {1}, 1, {8, 8, 8, 8}, {}, "RGBA", "RGBA"},
      {0, 2, {1}, 1, {8, 8, 8, 8}, {0}, "RGB", "RGBX"},
      {0, 2, {1}, 1, {8, 8, 8, 8, 8}, {0, 0}, "RGB", "RGBXX"},
      {0, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {0, 0, 0}, "RGB", "RGBXXX"},
      {0, 2, {1}, 1, {8, 8, 8, 8}, {1}, "RGBA", "RGBa"},
      {0, 2, {1}, 1, {8, 8, 8, 8, 8}, {1, 0}, "RGBA", "RGBaX"},
      {0, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {1, 0, 0}, "RGBA", "RGBaXX"},
      {0, 2, {1}, 1, {8, 8, 8, 8}, {2}, "RGBA", "RGBA"},
      {0, 2, {1}, 1, {8, 8, 8, 8, 8}, {2, 0}, "RGBA", "RGBAX"},
      {0, 2, {1}, 1, {8, 8, 8, 8, 8, 8}, {2, 0, 0}, "RGBA", "RGBAXX"},
      {0, 2, {1}, 1, {8, 8, 8, 8}, {999}, "RGBA", "RGBA"},
      {'I', 2, {1}, 1, {16, 16, 16}, {}, "RGB", "RGB;16L"},
      {'M', 2, {1}, 1, {16, 16, 16}, {}, "RGB", "RGB;16B"},
      {'I', 2, {1}, 1, {16, 16, 16, 16}, {}, "RGBA", "RGBA;16L"},
      {'M', 2, {1}, 1, {16, 16, 16, 16}, {}, "RGBA", "RGBA;16B"},
      {'I', 2, {1}, 1, {16, 16, 16, 16}, {0}, "RGB", "RGBX;16L"},
      {'M', 2, {1}, 1, {16, 16, 16, 16}, {0}, "RGB", "RGBX;16B"},
      {'I', 2, {1}, 1, {16, 16, 16, 16}, {1}, "RGBA", "RGBa;16L"},
      {'M', 2, {1}, 1, {16, 16, 16, 16}, {1}, "RGBA", "RGBa;16B"},
      {'I', 2, {1}, 1, {16, 16, 16, 16}, {2}, "RGBA", "RGBA;16L"},
      {'M', 2, {1}, 1, {16, 16, 16, 16}, {2}, "RGBA", "RGBA;16B"},
      {0, 3, {1}, 1, {1}, {}, "P", "P;1"},
      {0, 3, {1}, 2, {1}, {}, "P", "P;1R"},
      {0, 3, {1}, 1, {2}, {}, "P", "P;2"},
      {0, 3, {1}, 2, {2}, {}, "P", "P;2R"},
      {0, 3, {1}, 1, {4}, {}, "P", "P;4"},
      {0, 3, {1}, 2, {4}, {}, "P", "P;4R"},
      {0, 3, {1}, 1, {8}, {}, "P", "P"},
      {0, 3, {1}, 1, {8, 8}, {0}, "P", "PX"},
      {0, 3, {1}, 1, {8, 8}, {2}, "PA", "PA"},
      {0, 3, {1}, 2, {8}, {}, "P", "P;R"},
      {0, 5, {1}, 1, {8, 8, 8, 8}, {}, "CMYK", "CMYK"},
      {0, 5, {1}, 1, {8, 8, 8, 8, 8}, {0}, "CMYK", "CMYKX"},
      {0, 5, {1}, 1, {8, 8, 8, 8, 8, 8}, {0, 0}, "CMYK", "CMYKXX"},
      {'I', 5, {1}, 1, {16, 16, 16, 16}, {}, "CMYK", "CMYK;16L"},
      {'M', 5, {1}, 1, {16, 16, 16, 16}, {}, "CMYK", "CMYK;16B"},
      {0, 6, {1}, 1, {8}, {}, "L", "L"},
      {0, 6, {1}, 1, {8, 8, 8}, {}, "RGB", "RGBX"},
      {0, 8, {1}, 1, {8, 8, 8}, {}, "LAB", "LAB"},
  };
  return t;
}

Value as_tuple(const std::vector<int>& xs) {
  Value r;
  r.kind = Value::TUPLE;
  for (int x : xs) {
    r.v.push_back(x);
    r.integer.push_back(true);
  }
  return r;
}

const OpenInfo* find_open_info(char prefix, const Value& photo, const Value& sample_format, const Value& fillorder,
                               const Value& bps, const Value& extra) {
  for (const auto& e : open_info()) {
    if (e.prefix && e.prefix != prefix) continue;
    if (same(photo, num(e.photo)) && same(sample_format, as_tuple(e.sample_format)) &&
        same(fillorder, num(e.fillorder)) && same(bps, as_tuple(e.bps)) && same(extra, as_tuple(e.extra)))
      return &e;
  }
  return nullptr;
}

// ------------------------------------------------------------- unpackers ----
//
// Pillow's Unpack.c for each (mode, rawmode) the TIFF plugin asks for; the
// image memory is Pillow's: one byte a pixel for 1 / L / P, two for I;16(B),
// four otherwise (RGB with a padding byte, LA / PA with the band in byte 0
// and the alpha in byte 3, I and F native).

typedef void (*UnpackFn)(uint8_t* out, const uint8_t* in, int pixels);

struct Unpacker {
  int bits = 0;
  UnpackFn fn = nullptr;
};

inline uint32_t le16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t be16(const uint8_t* p) { return (p[0] << 8) | p[1]; }
inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }
inline uint32_t be32(const uint8_t* p) { return (uint32_t(p[0]) << 24) | (p[1] << 16) | (p[2] << 8) | p[3]; }
inline void put32(uint8_t* o, uint32_t v) { memcpy(o, &v, 4); }

template <int BITS, bool INV, bool REV, bool SCALE>
void unpack_bits(uint8_t* out, const uint8_t* in, int pixels) {
  constexpr int per = 8 / BITS, mask = (1 << BITS) - 1;
  constexpr int scale = BITS == 1 ? 255 : (BITS == 2 ? 0x55 : 0x11);
  for (int i = 0; i < pixels;) {
    uint8_t b = REV ? kBitRev[*in++] : *in++;
    for (int k = 0; k < per && i < pixels; ++k, ++i) {
      int v = (b >> (8 - BITS)) & mask;
      b = static_cast<uint8_t>(b << BITS);
      int o = SCALE ? v * scale : v;
      out[i] = static_cast<uint8_t>(INV ? (SCALE ? 255 - o : o) : o);
    }
  }
}

void copy1(uint8_t* out, const uint8_t* in, int n) { memcpy(out, in, static_cast<size_t>(n)); }
void unpack_li(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i) out[i] = static_cast<uint8_t>(~in[i]);
}
void unpack_lr(uint8_t* out, const uint8_t* in, int n) { for (int i = 0; i < n; ++i) out[i] = kBitRev[in[i]]; }
void unpack_px(uint8_t* out, const uint8_t* in, int n) { for (int i = 0; i < n; ++i) out[i] = in[2 * i]; }
void unpack_la(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i, in += 2, out += 4) {
    out[0] = out[1] = out[2] = in[0];
    out[3] = in[1];
  }
}
void unpack_i16(uint8_t* out, const uint8_t* in, int n) { memcpy(out, in, 2 * static_cast<size_t>(n)); }
void unpack_i16_swap(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i) {
    out[2 * i] = in[2 * i + 1];
    out[2 * i + 1] = in[2 * i];
  }
}
void unpack_i16r(uint8_t* out, const uint8_t* in, int n) { for (int i = 0; i < 2 * n; ++i) out[i] = kBitRev[in[i]]; }
void unpack_i12(uint8_t* out, const uint8_t* in, int n) {
  int i = 0;
  for (; i < n - 1; i += 2, in += 3) {
    uint16_t a = static_cast<uint16_t>((in[0] << 4) + (in[1] >> 4));
    uint16_t b = static_cast<uint16_t>(((in[1] & 0x0F) << 8) + in[2]);
    memcpy(out + 2 * i, &a, 2);
    memcpy(out + 2 * i + 2, &b, 2);
  }
  if (i == n - 1) {
    uint16_t a = static_cast<uint16_t>((in[0] << 4) + (in[1] >> 4));
    memcpy(out + 2 * i, &a, 2);
  }
}
void unpack_i32(uint8_t* out, const uint8_t* in, int n) { memcpy(out, in, 4 * static_cast<size_t>(n)); }
void unpack_i32_swap(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i) put32(out + 4 * i, be32(in + 4 * i));
}
void unpack_i16s(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i) put32(out + 4 * i, static_cast<uint32_t>(static_cast<int16_t>(le16(in + 2 * i))));
}
void unpack_i16bs(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i) put32(out + 4 * i, static_cast<uint32_t>(static_cast<int16_t>(be16(in + 2 * i))));
}
template <int STEP, int O0, int O1, int O2, bool REV>
void unpack_rgb(uint8_t* out, const uint8_t* in, int n) {  // 3 bytes at O0..O2 of each STEP-byte pixel
  for (int i = 0; i < n; ++i, in += STEP, out += 4) {
    out[0] = REV ? kBitRev[in[O0]] : in[O0];
    out[1] = REV ? kBitRev[in[O1]] : in[O1];
    out[2] = REV ? kBitRev[in[O2]] : in[O2];
    out[3] = 255;
  }
}
template <int STEP, int O0, int O1, int O2, int O3>
void unpack_4(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i, in += STEP, out += 4) {
    out[0] = in[O0];
    out[1] = in[O1];
    out[2] = in[O2];
    out[3] = in[O3];
  }
}
inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); }
void unpremultiply(uint8_t* p) {  // Unpack.c unpackRGBa on one pixel
  const int a = p[3];
  if (!a) {
    p[0] = p[1] = p[2] = 0;
  } else if (a != 255) {
    for (int k = 0; k < 3; ++k) p[k] = clip8(p[k] * 255 / a);
  }
}
template <int STEP, int O0, int O1, int O2, int O3>
void unpack_rgba_pre(uint8_t* out, const uint8_t* in, int n) {
  unpack_4<STEP, O0, O1, O2, O3>(out, in, n);
  for (int i = 0; i < n; ++i) unpremultiply(out + 4 * i);
}
template <int BAND, bool XOR>
void unpack_band(uint8_t* out, const uint8_t* in, int n) {
  for (int i = 0; i < n; ++i) out[4 * i + BAND] = static_cast<uint8_t>(XOR ? in[i] ^ 128 : in[i]);
}
template <int BAND>
void unpack_band16n(uint8_t* out, const uint8_t* in, int n) {  // TiffDecode.c's "R;16N" .. "A;16N"
  for (int i = 0; i < n; ++i) out[4 * i + BAND] = in[2 * i + 1];
}

Unpacker find_unpacker(Mode m, const std::string& r) {
  auto u = [](int bits, UnpackFn fn) { return Unpacker{bits, fn}; };
  switch (m) {
    case M1:
      if (r == "1") return u(1, unpack_bits<1, false, false, true>);
      if (r == "1;I") return u(1, unpack_bits<1, true, false, true>);
      if (r == "1;R") return u(1, unpack_bits<1, false, true, true>);
      if (r == "1;IR") return u(1, unpack_bits<1, true, true, true>);
      break;
    case ML:
      if (r == "L") return u(8, copy1);
      if (r == "L;I") return u(8, unpack_li);
      if (r == "L;R") return u(8, unpack_lr);
      if (r == "L;2") return u(2, unpack_bits<2, false, false, true>);
      if (r == "L;2I") return u(2, unpack_bits<2, true, false, true>);
      if (r == "L;2R") return u(2, unpack_bits<2, false, true, true>);
      if (r == "L;2IR") return u(2, unpack_bits<2, true, true, true>);
      if (r == "L;4") return u(4, unpack_bits<4, false, false, true>);
      if (r == "L;4I") return u(4, unpack_bits<4, true, false, true>);
      if (r == "L;4R") return u(4, unpack_bits<4, false, true, true>);
      if (r == "L;4IR") return u(4, unpack_bits<4, true, true, true>);
      break;
    case MP:
      if (r == "P") return u(8, copy1);
      if (r == "P;R") return u(8, unpack_lr);
      if (r == "P;1") return u(1, unpack_bits<1, false, false, false>);
      if (r == "P;2") return u(2, unpack_bits<2, false, false, false>);
      if (r == "P;4") return u(4, unpack_bits<4, false, false, false>);
      if (r == "PX") return u(16, unpack_px);
      break;
    case MLA:
      if (r == "LA") return u(16, unpack_la);
      break;
    case MPA:
      if (r == "PA") return u(16, unpack_la);
      break;
    case MI16:
      if (r == "I;16" || r == "I;16N") return u(16, unpack_i16);
      if (r == "I;16R") return u(16, unpack_i16r);
      if (r == "I;12") return u(12, unpack_i12);
      break;
    case MI16B:
      if (r == "I;16B") return u(16, unpack_i16);
      if (r == "I;16N") return u(16, unpack_i16_swap);
      break;
    case MI:
      if (r == "I" || r == "I;32N" || r == "I;32S") return u(32, unpack_i32);
      if (r == "I;32BS") return u(32, unpack_i32_swap);
      if (r == "I;16S") return u(16, unpack_i16s);
      if (r == "I;16BS") return u(16, unpack_i16bs);
      break;
    case MF:
      if (r == "F" || r == "F;32F") return u(32, unpack_i32);
      if (r == "F;32BF") return u(32, unpack_i32_swap);
      break;
    case MRGB:
      if (r == "RGB") return u(24, unpack_rgb<3, 0, 1, 2, false>);
      if (r == "RGB;R") return u(24, unpack_rgb<3, 0, 1, 2, true>);
      if (r == "RGBX") return u(32, unpack_4<4, 0, 1, 2, 3>);
      if (r == "RGBXX") return u(40, unpack_4<5, 0, 1, 2, 3>);
      if (r == "RGBXXX") return u(48, unpack_4<6, 0, 1, 2, 3>);
      if (r == "RGB;16L" || r == "RGB;16N") return u(48, unpack_rgb<6, 1, 3, 5, false>);
      if (r == "RGB;16B") return u(48, unpack_rgb<6, 0, 2, 4, false>);
      if (r == "RGBX;16L" || r == "RGBX;16N") return u(64, unpack_4<8, 1, 3, 5, 7>);
      if (r == "RGBX;16B") return u(64, unpack_4<8, 0, 2, 4, 6>);
      if (r == "R") return u(8, unpack_band<0, false>);
      if (r == "G") return u(8, unpack_band<1, false>);
      if (r == "B") return u(8, unpack_band<2, false>);
      break;
    case MRGBA:
      if (r == "RGBA") return u(32, unpack_4<4, 0, 1, 2, 3>);
      if (r == "RGBAX") return u(40, unpack_4<5, 0, 1, 2, 3>);
      if (r == "RGBAXX") return u(48, unpack_4<6, 0, 1, 2, 3>);
      if (r == "RGBa") return u(32, unpack_rgba_pre<4, 0, 1, 2, 3>);
      if (r == "RGBaX") return u(40, unpack_rgba_pre<5, 0, 1, 2, 3>);
      if (r == "RGBaXX") return u(48, unpack_rgba_pre<6, 0, 1, 2, 3>);
      if (r == "RGBA;16L" || r == "RGBA;16N") return u(64, unpack_4<8, 1, 3, 5, 7>);
      if (r == "RGBA;16B") return u(64, unpack_4<8, 0, 2, 4, 6>);
      if (r == "RGBa;16L" || r == "RGBa;16N") return u(64, unpack_rgba_pre<8, 1, 3, 5, 7>);
      if (r == "RGBa;16B") return u(64, unpack_rgba_pre<8, 0, 2, 4, 6>);
      if (r == "R") return u(8, unpack_band<0, false>);
      if (r == "G") return u(8, unpack_band<1, false>);
      if (r == "B") return u(8, unpack_band<2, false>);
      if (r == "A") return u(8, unpack_band<3, false>);
      break;
    case MCMYK:
      if (r == "CMYK") return u(32, unpack_4<4, 0, 1, 2, 3>);
      if (r == "CMYKX") return u(40, unpack_4<5, 0, 1, 2, 3>);
      if (r == "CMYKXX") return u(48, unpack_4<6, 0, 1, 2, 3>);
      if (r == "CMYK;16L" || r == "CMYK;16N") return u(64, unpack_4<8, 1, 3, 5, 7>);
      if (r == "CMYK;16B") return u(64, unpack_4<8, 0, 2, 4, 6>);
      if (r == "C") return u(8, unpack_band<0, false>);
      if (r == "M") return u(8, unpack_band<1, false>);
      if (r == "Y") return u(8, unpack_band<2, false>);
      if (r == "K") return u(8, unpack_band<3, false>);
      break;
    case MLAB:
      if (r == "LAB") return u(24, unpack_rgb<3, 0, 1, 2, false>);
      if (r == "L") return u(8, unpack_band<0, false>);
      if (r == "A") return u(8, unpack_band<1, true>);
      if (r == "B") return u(8, unpack_band<2, true>);
      break;
  }
  return Unpacker{};
}

// TiffDecode.c _pickUnpackers for planes: each plane's 8 bits (or the high
// byte of 16) into its band's byte; LAB's a and b planes with the sign bit
// flipped, as Pillow's LAB band unpackers do.
UnpackFn plane_unpacker(int plane, bool sixteen, bool lab) {
  static const UnpackFn b8[4] = {unpack_band<0, false>, unpack_band<1, false>, unpack_band<2, false>,
                                 unpack_band<3, false>};
  static const UnpackFn lab8[3] = {unpack_band<0, false>, unpack_band<1, true>, unpack_band<2, true>};
  if (lab && !sixteen) return lab8[plane];
  static const UnpackFn b16[4] = {unpack_band16n<0>, unpack_band16n<1>, unpack_band16n<2>, unpack_band16n<3>};
  return sixteen ? b16[plane] : b8[plane];
}

// ----------------------------------------------------------------- codecs ----

// tif_lzw.c LZWDecode (MSB-first codes, the width growing one code early) and
// LZWDecodeCompat (LSB-first, growing at the table's size).
struct LzwEntry {
  int next = -1;  // the prefix entry, -1 none
  uint16_t length = 0;
  uint8_t value = 0, firstchar = 0;
};

bool lzw(const uint8_t* bp, size_t cc, uint8_t* op, size_t occ, bool compat) {
  constexpr int kClear = 256, kEoi = 257, kFirst = 258, kBitsMin = 9, kBitsMax = 12, kSize = 4096 + 1024;
  std::vector<LzwEntry> tab(kSize);
  for (int i = 0; i < 256; ++i) {
    tab[i].length = 1;
    tab[i].value = tab[i].firstchar = static_cast<uint8_t>(i);
  }
  int nbits = kBitsMin;
  int nbitsmask = (1 << nbits) - 1;
  auto maxcode = [&](int mask) { return compat ? mask : mask - 1; };
  int maxcodep = maxcode(nbitsmask);
  int free_ent = kFirst;
  int oldcode = -1;  // &dec_codetab[-1]
  uint64_t bitsleft = static_cast<uint64_t>(cc) * 8;
  uint64_t acc = 0;
  int accbits = 0;
  size_t pos = 0;
  auto next_code = [&]() -> int {
    if (bitsleft < static_cast<uint64_t>(nbits)) return kEoi;  // "not terminated with EOI code"
    while (accbits < nbits) {
      uint64_t b = pos < cc ? bp[pos] : 0;
      ++pos;
      if (compat)
        acc |= b << accbits;
      else
        acc = (acc << 8) | b;
      accbits += 8;
    }
    int code;
    if (compat) {
      code = static_cast<int>(acc & static_cast<uint64_t>(nbitsmask));
      acc >>= nbits;
    } else {
      code = static_cast<int>((acc >> (accbits - nbits)) & static_cast<uint64_t>(nbitsmask));
    }
    accbits -= nbits;
    if (!compat) acc &= (uint64_t(1) << accbits) - 1;
    bitsleft -= static_cast<uint64_t>(nbits);
    return code;
  };
  while (occ > 0) {
    int code = next_code();
    if (code == kEoi) break;
    if (code == kClear) {
      do {
        free_ent = kFirst;
        for (int i = kFirst; i < kSize; ++i) tab[i] = LzwEntry{};
        nbits = kBitsMin;
        nbitsmask = (1 << nbits) - 1;
        maxcodep = maxcode(nbitsmask);
        code = next_code();
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kClear) return false;  // "Corrupted LZW table"
      *op++ = static_cast<uint8_t>(code);
      occ--;
      oldcode = code;
      continue;
    }
    if (free_ent < 0 || free_ent >= 4096) return false;
    if (oldcode < 0 || oldcode >= 4096) return false;
    LzwEntry& fe = tab[free_ent];
    fe.next = oldcode;
    fe.firstchar = tab[oldcode].firstchar;
    fe.length = static_cast<uint16_t>(tab[oldcode].length + 1);
    fe.value = code < free_ent ? tab[code].firstchar : fe.firstchar;
    if (++free_ent > maxcodep) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      nbitsmask = (1 << nbits) - 1;
      maxcodep = maxcode(nbitsmask);
      if (!compat && free_ent >= 4096) free_ent = -1;
    }
    oldcode = code;
    if (compat && code < 256) {
      *op++ = static_cast<uint8_t>(code);
      occ--;
      continue;
    }
    const LzwEntry& ce = tab[code];
    if (ce.length == 0) return false;  // "Wrong length of decoded string"
    size_t len = ce.length;
    if (len > occ) {  // the string's head that fits; the rest is past the strip
      int c = code;
      for (size_t k = len; k > occ; --k) c = tab[c].next;
      for (size_t k = occ; k > 0; --k) {
        op[k - 1] = tab[c].value;
        c = tab[c].next;
      }
      op += occ;
      occ = 0;
      break;
    }
    int c = code;
    for (size_t k = len; k > 0; --k) {
      if (c < 0) return false;
      op[k - 1] = tab[c].value;
      c = tab[c].next;
    }
    op += len;
    occ -= len;
  }
  return occ == 0;
}

// ---------------------------------------------------------------- CCITT ----
//
// tif_fax3.c / tif_fax3.h as libtiff 4.7 runs them, macro for macro, so that
// damaged data decodes as it does there: the bit accumulator filled LSB-first
// through the fill order's bit map and padded with zeros at the end of the
// strip, mkg3states' lookup tables (7-bit 2D modes, 12-bit white, 13-bit
// black runs; an EOL is 11 zero bits in a run table and 7 in the mode
// table), SYNC_EOL, EXPAND1D / EXPAND2D with CHECK_b1 and CLEANUP_RUNS, an
// unexpected code ending the row, and the decoders' returns: CCITT RLE and
// Group 3 fail at a premature end of the data, Group 4 fails there only
// before its first row. _TIFFFax3fillruns clears white runs and sets black
// ones (a 1 bit is black), leaving bits past the width as they were.

struct FaxCode {
  uint16_t code;
  uint8_t len;
  int16_t run;  // -1: EOL
};

const FaxCode kWhite[] = {
    {0x35, 8, 0}, {0x7, 6, 1}, {0x7, 4, 2}, {0x8, 4, 3}, {0xB, 4, 4}, {0xC, 4, 5}, {0xE, 4, 6}, {0xF, 4, 7},
    {0x13, 5, 8}, {0x14, 5, 9}, {0x7, 5, 10}, {0x8, 5, 11}, {0x8, 6, 12}, {0x3, 6, 13}, {0x34, 6, 14},
    {0x35, 6, 15}, {0x2A, 6, 16}, {0x2B, 6, 17}, {0x27, 7, 18}, {0xC, 7, 19}, {0x8, 7, 20}, {0x17, 7, 21},
    {0x3, 7, 22}, {0x4, 7, 23}, {0x28, 7, 24}, {0x2B, 7, 25}, {0x13, 7, 26}, {0x24, 7, 27}, {0x18, 7, 28},
    {0x2, 8, 29}, {0x3, 8, 30}, {0x1A, 8, 31}, {0x1B, 8, 32}, {0x12, 8, 33}, {0x13, 8, 34}, {0x14, 8, 35},
    {0x15, 8, 36}, {0x16, 8, 37}, {0x17, 8, 38}, {0x28, 8, 39}, {0x29, 8, 40}, {0x2A, 8, 41}, {0x2B, 8, 42},
    {0x2C, 8, 43}, {0x2D, 8, 44}, {0x4, 8, 45}, {0x5, 8, 46}, {0xA, 8, 47}, {0xB, 8, 48}, {0x52, 8, 49},
    {0x53, 8, 50}, {0x54, 8, 51}, {0x55, 8, 52}, {0x24, 8, 53}, {0x25, 8, 54}, {0x58, 8, 55}, {0x59, 8, 56},
    {0x5A, 8, 57}, {0x5B, 8, 58}, {0x4A, 8, 59}, {0x4B, 8, 60}, {0x32, 8, 61}, {0x33, 8, 62}, {0x34, 8, 63},
    {0x1B, 5, 64}, {0x12, 5, 128}, {0x17, 6, 192}, {0x37, 7, 256}, {0x36, 8, 320}, {0x37, 8, 384},
    {0x64, 8, 448}, {0x65, 8, 512}, {0x68, 8, 576}, {0x67, 8, 640}, {0xCC, 9, 704}, {0xCD, 9, 768},
    {0xD2, 9, 832}, {0xD3, 9, 896}, {0xD4, 9, 960}, {0xD5, 9, 1024}, {0xD6, 9, 1088}, {0xD7, 9, 1152},
    {0xD8, 9, 1216}, {0xD9, 9, 1280}, {0xDA, 9, 1344}, {0xDB, 9, 1408}, {0x98, 9, 1472}, {0x99, 9, 1536},
    {0x9A, 9, 1600}, {0x18, 6, 1664}, {0x9B, 9, 1728},
};
const FaxCode kBlack[] = {
    {0x37, 10, 0}, {0x2, 3, 1}, {0x3, 2, 2}, {0x2, 2, 3}, {0x3, 3, 4}, {0x3, 4, 5}, {0x2, 4, 6}, {0x3, 5, 7},
    {0x5, 6, 8}, {0x4, 6, 9}, {0x4, 7, 10}, {0x5, 7, 11}, {0x7, 7, 12}, {0x4, 8, 13}, {0x7, 8, 14},
    {0x18, 9, 15}, {0x17, 10, 16}, {0x18, 10, 17}, {0x8, 10, 18}, {0x67, 11, 19}, {0x68, 11, 20},
    {0x6C, 11, 21}, {0x37, 11, 22}, {0x28, 11, 23}, {0x17, 11, 24}, {0x18, 11, 25}, {0xCA, 12, 26},
    {0xCB, 12, 27}, {0xCC, 12, 28}, {0xCD, 12, 29}, {0x68, 12, 30}, {0x69, 12, 31}, {0x6A, 12, 32},
    {0x6B, 12, 33}, {0xD2, 12, 34}, {0xD3, 12, 35}, {0xD4, 12, 36}, {0xD5, 12, 37}, {0xD6, 12, 38},
    {0xD7, 12, 39}, {0x6C, 12, 40}, {0x6D, 12, 41}, {0xDA, 12, 42}, {0xDB, 12, 43}, {0x54, 12, 44},
    {0x55, 12, 45}, {0x56, 12, 46}, {0x57, 12, 47}, {0x64, 12, 48}, {0x65, 12, 49}, {0x52, 12, 50},
    {0x53, 12, 51}, {0x24, 12, 52}, {0x37, 12, 53}, {0x38, 12, 54}, {0x27, 12, 55}, {0x28, 12, 56},
    {0x58, 12, 57}, {0x59, 12, 58}, {0x2B, 12, 59}, {0x2C, 12, 60}, {0x5A, 12, 61}, {0x66, 12, 62},
    {0x67, 12, 63}, {0xF, 10, 64}, {0xC8, 12, 128}, {0xC9, 12, 192}, {0x5B, 12, 256}, {0x33, 12, 320},
    {0x34, 12, 384}, {0x35, 12, 448}, {0x6C, 13, 512}, {0x6D, 13, 576}, {0x4A, 13, 640}, {0x4B, 13, 704},
    {0x4C, 13, 768}, {0x4D, 13, 832}, {0x72, 13, 896}, {0x73, 13, 960}, {0x74, 13, 1024}, {0x75, 13, 1088},
    {0x76, 13, 1152}, {0x77, 13, 1216}, {0x52, 13, 1280}, {0x53, 13, 1344}, {0x54, 13, 1408},
    {0x55, 13, 1472}, {0x5A, 13, 1536}, {0x5B, 13, 1600}, {0x64, 13, 1664}, {0x65, 13, 1728},
};
const FaxCode kExtended[] = {
    {0x8, 11, 1792}, {0xC, 11, 1856}, {0xD, 11, 1920}, {0x12, 12, 1984}, {0x13, 12, 2048}, {0x14, 12, 2112},
    {0x15, 12, 2176}, {0x16, 12, 2240}, {0x17, 12, 2304}, {0x1C, 12, 2368}, {0x1D, 12, 2432},
    {0x1E, 12, 2496}, {0x1F, 12, 2560},
};

enum FaxState : uint8_t { S_Null, S_Pass, S_Horiz, S_V0, S_VR, S_VL, S_Ext, S_TermW, S_TermB, S_MakeUpW, S_MakeUpB,
                         S_MakeUp, S_EOL };

struct FaxEnt {
  uint8_t state = S_Null, width = 0;
  uint32_t param = 0;
};

// mkg3states: each code's LSB-first pattern fills every index it prefixes.
struct FaxTables {
  FaxEnt main[128], white[4096], black[8192];

  static void fill(FaxEnt* t, int size, uint32_t code, int width, FaxState state, uint32_t param) {
    uint32_t r = 0;
    for (int b = 0; b < width; ++b)
      if ((code >> b) & 1) r |= 1u << (width - 1 - b);
    for (uint32_t i = r; i < (1u << size); i += 1u << width) t[i] = FaxEnt{state, static_cast<uint8_t>(width), param};
  }

  FaxTables() {
    fill(main, 7, 0x1, 4, S_Pass, 0);
    fill(main, 7, 0x1, 3, S_Horiz, 0);
    fill(main, 7, 0x1, 1, S_V0, 0);
    fill(main, 7, 0x3, 3, S_VR, 1);
    fill(main, 7, 0x3, 6, S_VR, 2);
    fill(main, 7, 0x3, 7, S_VR, 3);
    fill(main, 7, 0x2, 3, S_VL, 1);
    fill(main, 7, 0x2, 6, S_VL, 2);
    fill(main, 7, 0x2, 7, S_VL, 3);
    fill(main, 7, 0x1, 7, S_Ext, 0);
    fill(main, 7, 0x0, 7, S_EOL, 0);
    for (const FaxCode& c : kWhite)
      fill(white, 12, c.code, c.len, c.run < 64 ? S_TermW : S_MakeUpW, static_cast<uint32_t>(c.run));
    for (const FaxCode& c : kBlack)
      fill(black, 13, c.code, c.len, c.run < 64 ? S_TermB : S_MakeUpB, static_cast<uint32_t>(c.run));
    for (const FaxCode& c : kExtended) {
      fill(white, 12, c.code, c.len, S_MakeUp, static_cast<uint32_t>(c.run));
      fill(black, 13, c.code, c.len, S_MakeUp, static_cast<uint32_t>(c.run));
    }
    fill(white, 12, 0x0, 11, S_EOL, 0);
    fill(black, 13, 0x0, 11, S_EOL, 0);
  }
};

class Fax {
 public:
  // kind: 2 (RLE), 32771 (RLE with rows word-aligned), 3 (Group 3, 2D rows
  // when T4Options bit 0), 4 (Group 4). `odd`: the strip starts at an odd
  // file offset (RLEW aligns its byte pointer in the file as libtiff maps it).
  Fax(int kind, uint32_t t4, uint32_t width, bool lsb_first, bool odd = false)
      : kind_(kind == 32771 ? 2 : kind), word_(kind == 32771), odd_(odd), twod_(kind == 4 || (kind == 3 && (t4 & 1))),
        lastx_(static_cast<int64_t>(width)) {
    nruns_ = (static_cast<size_t>(width) + 1 + 31) / 32 * 32;
    if (twod_) nruns_ *= 2;
    runs_.assign(2 * nruns_ + 2, 0);
    for (int i = 0; i < 256; ++i) bitmap_[i] = lsb_first ? static_cast<uint8_t>(i) : kBitRev[i];
  }

  // One strip: libtiff's return (> 0 decoded, else failed); rows written as they decode.
  int decode(const uint8_t* data, size_t n, uint8_t* buf, size_t occ, size_t rowbytes) {
    static const FaxTables T;
    if (rowbytes == 0 || occ % rowbytes) return -1;
    cp_ = data;
    ep_ = data + n;
    acc_ = 0;
    avail_ = 0;
    eolcnt_ = 0;
    cur_ = 0;
    ref_ = nruns_;
    runs_[ref_] = static_cast<uint32_t>(lastx_);
    runs_[ref_ + 1] = 0;
    int line = 0;
    while (occ > 0) {
      a0_ = 0;
      runlength_ = 0;
      pa_ = cur_;
      int r;  // 0 row done, 1 end of data, -1 overflow
      if (kind_ == 2) {
        r = expand1d(T);
        if (r < 0) return -1;
        fill(buf);
        if (r == 1) return -1;
        if (!word_) {  // FAXMODE_BYTEALIGN
          clr(avail_ - (avail_ & ~7));
        } else {  // FAXMODE_WORDALIGN: the accumulator to 16 bits, then the pointer to a 2-byte boundary
          clr(avail_ - (avail_ & ~15));
          if (avail_ == 0 && ((cp_ - data) & 1) != (odd_ ? 1 : 0)) ++cp_;
        }
      } else if (kind_ == 3) {
        r = sync_eol() ? 0 : 1;
        int is1d = 1;
        if (r == 0 && twod_) {
          if (!need8(1)) {
            r = 1;
          } else {
            is1d = static_cast<int>(get(1));
            clr(1);
          }
        }
        if (r == 1) {  // EOF before the row's codes: CLEANUP_RUNS, fill, fail
          if (!cleanup()) return -1;
          fill(buf);
          return -1;
        }
        pb_ = ref_;
        b1_ = static_cast<int64_t>(runs_[pb_++]);
        r = (twod_ && !is1d) ? expand2d(T) : expand1d(T);
        if (r < 0) return -1;
        fill(buf);
        if (r == 1) return -1;
        if (twod_) {
          if (pa_ < cur_ + nruns_ && !setvalue(0)) return -1;  // imaginary change for the reference line
          std::swap(cur_, ref_);
        }
      } else {
        pb_ = ref_;
        b1_ = static_cast<int64_t>(runs_[pb_++]);
        r = expand2d(T);
        if (r < 0) return -1;
        if (r == 1 || eolcnt_) {  // EOFG4: the EOFB's 13 bits, then done
          if (need16(13)) clr(13);
          fill(buf);
          return line != 0 ? 1 : -1;
        }
        fill(buf);
        if (!setvalue(0)) return -1;
        std::swap(cur_, ref_);
      }
      buf += rowbytes;
      occ -= rowbytes;
      ++line;
    }
    return 1;
  }

 private:
  int kind_;
  bool word_, odd_;
  bool twod_;
  int64_t lastx_;
  size_t nruns_;
  std::vector<uint32_t> runs_;  // curruns and refruns, nruns_ each
  uint8_t bitmap_[256];
  const uint8_t *cp_ = nullptr, *ep_ = nullptr;
  uint32_t acc_ = 0;
  int avail_ = 0, eolcnt_ = 0;
  size_t cur_ = 0, ref_ = 0, pa_ = 0, pb_ = 0;
  int64_t a0_ = 0, runlength_ = 0, b1_ = 0;

  bool need8(int n) {
    if (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) return false;
        avail_ = n;  // pad with zeros
      } else {
        acc_ |= static_cast<uint32_t>(bitmap_[*cp_++]) << avail_;
        avail_ += 8;
      }
    }
    return true;
  }
  bool need16(int n) {
    if (avail_ < n) {
      if (cp_ >= ep_) {
        if (avail_ == 0) return false;
        avail_ = n;
      } else {
        acc_ |= static_cast<uint32_t>(bitmap_[*cp_++]) << avail_;
        if ((avail_ += 8) < n) {
          if (cp_ >= ep_) {
            avail_ = n;
          } else {
            acc_ |= static_cast<uint32_t>(bitmap_[*cp_++]) << avail_;
            avail_ += 8;
          }
        }
      }
    }
    return true;
  }
  uint32_t get(int n) const { return acc_ & ((1u << n) - 1); }
  void clr(int n) {
    avail_ -= n;
    acc_ >>= n;
  }

  bool setvalue(int64_t x) {
    if (pa_ >= cur_ + nruns_) return false;  // "Buffer overflow"
    runs_[pa_++] = static_cast<uint32_t>(runlength_ + x);
    a0_ += x;
    runlength_ = 0;
    return true;
  }

  bool cleanup() {  // CLEANUP_RUNS
    if (runlength_ && !setvalue(0)) return false;
    if (a0_ != lastx_) {
      while (a0_ > lastx_ && pa_ > cur_) a0_ -= static_cast<int64_t>(runs_[--pa_]);
      if (a0_ < lastx_) {
        if (a0_ < 0) a0_ = 0;
        if (((pa_ - cur_) & 1) && !setvalue(0)) return false;
        if (!setvalue(lastx_ - a0_)) return false;
      } else if (a0_ > lastx_) {
        if (!setvalue(lastx_) || !setvalue(0)) return false;
      }
    }
    return true;
  }

  bool sync_eol() {  // SYNC_EOL
    if (eolcnt_ == 0) {
      for (;;) {
        if (!need16(11)) return false;
        if (get(11) == 0) break;
        clr(1);
      }
    }
    for (;;) {
      if (!need8(8)) return false;
      if (get(8)) break;
      clr(8);
    }
    while (get(1) == 0) clr(1);
    clr(1);
    eolcnt_ = 0;
    return true;
  }

  const FaxEnt& lookup16(const FaxEnt* tab, int wid, bool& eof) {
    if (!need16(wid)) {
      eof = true;
      static const FaxEnt none;
      return none;
    }
    const FaxEnt& e = tab[get(wid)];
    clr(e.width);
    return e;
  }

  // One run of makeup codes and a terminating code: 0 done, 1 EOL, 2 bad code, 3 end of data, -1 overflow.
  int run(const FaxTables& T, bool black) {
    for (;;) {
      bool eof = false;
      const FaxEnt& e = lookup16(black ? T.black : T.white, black ? 13 : 12, eof);
      if (eof) return 3;
      switch (e.state) {
        case S_EOL:
          return 1;
        case S_TermW: case S_TermB:
          if ((e.state == S_TermB) != black) return 2;
          return setvalue(e.param) ? 0 : -1;
        case S_MakeUpW: case S_MakeUpB: case S_MakeUp:
          if ((e.state == S_MakeUpW && black) || (e.state == S_MakeUpB && !black)) return 2;
          a0_ += e.param;
          runlength_ += e.param;
          break;
        default:
          return 2;
      }
    }
  }

  int expand1d(const FaxTables& T) {  // EXPAND1D
    for (;;) {
      int r = run(T, false);
      if (r == 1) eolcnt_ = 1;
      if (r == 3) return cleanup() ? 1 : -1;
      if (r < 0) return -1;
      if (r != 0 || a0_ >= lastx_) break;
      r = run(T, true);
      if (r == 1) eolcnt_ = 1;
      if (r == 3) return cleanup() ? 1 : -1;
      if (r < 0) return -1;
      if (r != 0 || a0_ >= lastx_) break;
      if (runs_[pa_ - 1] == 0 && runs_[pa_ - 2] == 0) pa_ -= 2;
    }
    return cleanup() ? 0 : -1;
  }

  bool check_b1() {  // CHECK_b1
    if (pa_ != cur_)
      while (b1_ <= a0_ && b1_ < lastx_) {
        if (pb_ + 1 >= ref_ + nruns_) return false;
        b1_ += static_cast<int64_t>(runs_[pb_]) + static_cast<int64_t>(runs_[pb_ + 1]);
        pb_ += 2;
      }
    return true;
  }

  int expand2d(const FaxTables& T) {  // EXPAND2D
    auto eof = [&]() { return cleanup() ? 1 : -1; };
    while (a0_ < lastx_) {
      if (pa_ >= cur_ + nruns_) return -1;
      if (!need8(7)) return eof();
      const FaxEnt& e = T.main[get(7)];
      clr(e.width);
      switch (e.state) {
        case S_Pass:
          if (!check_b1()) return -1;
          if (pb_ + 1 >= ref_ + nruns_) return -1;
          b1_ += static_cast<int64_t>(runs_[pb_++]);
          runlength_ += b1_ - a0_;
          a0_ = b1_;
          b1_ += static_cast<int64_t>(runs_[pb_++]);
          break;
        case S_Horiz: {
          const bool black_first = (pa_ - cur_) & 1;
          int r = run(T, black_first);
          if (r == 3) return eof();
          if (r < 0) return -1;
          if (r != 0) return cleanup() ? 0 : -1;  // a bad code (an EOL counts as one here)
          r = run(T, !black_first);
          if (r == 3) return eof();
          if (r < 0) return -1;
          if (r != 0) return cleanup() ? 0 : -1;
          if (!check_b1()) return -1;
          break;
        }
        case S_V0: case S_VR:
          if (!check_b1()) return -1;
          if (!setvalue(b1_ - a0_ + (e.state == S_VR ? static_cast<int64_t>(e.param) : 0))) return -1;
          if (pb_ >= ref_ + nruns_) return -1;
          b1_ += static_cast<int64_t>(runs_[pb_++]);
          break;
        case S_VL:
          if (!check_b1()) return -1;
          if (b1_ < a0_ + static_cast<int64_t>(e.param)) return cleanup() ? 0 : -1;  // unexpected("VL")
          if (!setvalue(b1_ - a0_ - static_cast<int64_t>(e.param))) return -1;
          b1_ -= static_cast<int64_t>(runs_[--pb_]);
          break;
        case S_Ext:
          runs_[pa_++] = static_cast<uint32_t>(lastx_ - a0_);
          return cleanup() ? 0 : -1;
        case S_EOL:
          runs_[pa_++] = static_cast<uint32_t>(lastx_ - a0_);
          if (!need8(4)) return eof();
          clr(4);
          eolcnt_ = 1;
          return cleanup() ? 0 : -1;
        default:
          return cleanup() ? 0 : -1;  // unexpected("MainTable")
      }
    }
    if (runlength_) {
      if (runlength_ + a0_ < lastx_) {  // expect a final V0
        if (!need8(1)) return eof();
        if (!get(1)) return cleanup() ? 0 : -1;
        clr(1);
      }
      if (!setvalue(0)) return -1;
    }
    return cleanup() ? 0 : -1;
  }

  // _TIFFFax3fillruns over the runs [cur_, pa_), which it may clip in place.
  void fill(uint8_t* buf) {
    static const uint8_t kMasks[] = {0x00, 0x80, 0xc0, 0xe0, 0xf0, 0xf8, 0xfc, 0xfe, 0xff};
    size_t erun = pa_;
    if ((erun - cur_) & 1) runs_[erun++] = 0;
    int64_t x = 0;
    for (size_t i = cur_; i < erun; i += 2) {
      for (int color = 0; color < 2; ++color) {
        uint32_t& rr = runs_[i + color];
        int64_t r = rr;
        if (x + r > lastx_ || r > lastx_) {
          rr = static_cast<uint32_t>(lastx_ - x);
          r = static_cast<int64_t>(rr);
        }
        if (!r) continue;
        uint8_t* p = buf + (x >> 3);
        const int bx = static_cast<int>(x & 7);
        if (r > 8 - bx) {
          if (bx) {
            if (color) *p++ |= static_cast<uint8_t>(0xff >> bx);
            else *p++ &= static_cast<uint8_t>(0xff << (8 - bx));
            r -= 8 - bx;
          }
          for (int64_t k = r >> 3; k > 0; --k) *p++ = color ? 0xff : 0x00;
          if (r & 7) {
            if (color) *p |= static_cast<uint8_t>((0xff00 >> (r & 7)) & 0xff);
            else *p &= static_cast<uint8_t>(0xff >> (r & 7));
          }
        } else {
          if (color) p[0] |= static_cast<uint8_t>(kMasks[r] >> bx);
          else p[0] &= static_cast<uint8_t>(~(kMasks[r] >> bx));
        }
        x += static_cast<int64_t>(rr);
      }
    }
  }
};

// --------------------------------------------------------------- the file ----

struct Tag {
  int type = 0;
  std::vector<uint8_t> data;
  Value value;
};

class Tiff {
 public:
  Tiff(const uint8_t* d, size_t n, InflateFn inflate, JpegFn jpeg, ZstdFn zstd, OjpegFn ojpeg)
      : d_(d), n_(n), inflate_(inflate), jpeg_(jpeg), zstd_(zstd), ojpeg_(ojpeg) {
    header();
    setup();
  }

  // The size after the Orientation transpose.
  int64_t out_height() const { return swap_ ? xsize_ : ysize_; }
  int64_t out_width() const { return swap_ ? ysize_ : xsize_; }

  void decode(uint8_t* out) {
    ps_ = pixel_size(mode_);
    img_.assign(static_cast<size_t>(xsize_) * static_cast<size_t>(ysize_) * ps_, 0);
    palette();
    if (libtiff_)
      load_libtiff();
    else
      load_raw();
    std::vector<uint8_t> rgb(static_cast<size_t>(xsize_) * static_cast<size_t>(ysize_) * 3);
    to_rgb(rgb.data());
    transpose(rgb.data(), out);
  }

 private:
  const uint8_t* d_;
  size_t n_;
  InflateFn inflate_;
  JpegFn jpeg_;
  ZstdFn zstd_;
  OjpegFn ojpeg_;
  bool le_ = true, big_ = false;
  char prefix_ = 'I';
  uint64_t ifd_ = 0;
  std::map<int, Tag> tags_;
  Mode mode_ = ML;
  std::string rawmode_;
  int compression_ = 1, planar_ = 1, photo_ = 0, fillorder_ = 1, orientation_ = 1;
  int64_t xsize_ = 0, ysize_ = 0;
  bool swap_ = false, libtiff_ = false;
  std::vector<int> bps_;
  int bps_count_ = 1;
  int ps_ = 1;
  std::vector<uint8_t> img_;
  std::vector<uint8_t> pal_;  // 256 x RGB

  // ------------------------------------------------------------ reading ----

  uint64_t uint(const uint8_t* p, int bytes) const {
    uint64_t v = 0;
    for (int i = 0; i < bytes; ++i) v |= static_cast<uint64_t>(p[le_ ? i : bytes - 1 - i]) << (8 * i);
    return v;
  }

  void header() {
    if (n_ < 8) corrupt("not a TIFF file (no header)");
    const uint8_t* h = d_;
    static const char* kPrefixes[] = {"MM\x00\x2a", "II\x2a\x00", "MM\x2a\x00", "II\x00\x2a", "MM\x00\x2b",
                                      "II\x2b\x00"};
    bool ok = false;
    for (const char* p : kPrefixes) ok = ok || memcmp(h, p, 4) == 0;
    if (!ok) corrupt("not a TIFF file");
    le_ = h[0] == 'I';
    prefix_ = static_cast<char>(h[0]);
    big_ = h[2] == 43;
    if (big_) {
      if (n_ < 16) corrupt("TIFF header cut short");
      ifd_ = uint(h + 8, 8);
    } else {
      ifd_ = uint(h + 4, 4);
    }
    if (ifd_ == 0) corrupt("no image in the TIFF file");
    if (ifd_ >= (uint64_t(1) << 63)) corrupt("TIFF IFD offset past 2^63");
    read_ifd();
  }

  static int unit_size(int type) {
    switch (type) {
      case 1: case 2: case 6: case 7: return 1;
      case 3: case 8: return 2;
      case 4: case 9: case 11: case 13: return 4;
      case 5: case 10: case 12: case 16: return 8;
      default: return 0;  // not a type Pillow reads: the entry is skipped
    }
  }

  // ImageFileDirectory_v2.load: a read cut short ends the walk.
  void read_ifd() {
    size_t p = static_cast<size_t>(ifd_);
    const size_t cnt_bytes = big_ ? 8 : 2, entry = big_ ? 20 : 12;
    if (ifd_ > n_ || n_ - p < cnt_bytes) return;
    const uint64_t count = uint(d_ + p, static_cast<int>(cnt_bytes));
    p += cnt_bytes;
    for (uint64_t i = 0; i < count; ++i) {
      if (n_ - p < entry) return;
      const int tag = static_cast<int>(uint(d_ + p, 2)), type = static_cast<int>(uint(d_ + p + 2, 2));
      const uint64_t cnt = uint(d_ + p + 4, big_ ? 8 : 4);
      const uint8_t* inl = d_ + p + (big_ ? 12 : 8);
      p += entry;
      const int unit = unit_size(type);
      if (!unit) continue;
      const unsigned __int128 size = static_cast<unsigned __int128>(cnt) * static_cast<unsigned>(unit);
      Tag t;
      t.type = type;
      if (size > (big_ ? 8u : 4u)) {
        const uint64_t off = uint(inl, big_ ? 8 : 4);
        if (off > n_ || size > n_ - off) return;  // _safe_read cut short: OSError ends the walk
        t.data.assign(d_ + off, d_ + off + static_cast<size_t>(size));
      } else {
        t.data.assign(inl, inl + static_cast<size_t>(size));
      }
      if (t.data.empty()) continue;
      t.value = decode_value(tag, type, t.data);
      tags_[tag] = std::move(t);
    }
  }

  Value decode_value(int tag, int type, const std::vector<uint8_t>& data) const {
    Value r;
    if (type == 1) {  // BYTE: bytes
      r.kind = Value::BYTES;
      r.raw = data;
      for (uint8_t b : data) {
        r.v.push_back(b);
        r.integer.push_back(true);
      }
      return r;
    }
    if (type == 2 || type == 7) return r;  // ASCII, UNDEFINED: nothing a key or size matches
    const int unit = unit_size(type);
    const size_t n = data.size() / static_cast<size_t>(unit);
    for (size_t i = 0; i < n; ++i) {
      const uint8_t* p = data.data() + i * unit;
      double x = 0;
      bool integer = true;
      switch (type) {
        case 3: x = static_cast<double>(uint(p, 2)); break;
        case 4: case 13: x = static_cast<double>(uint(p, 4)); break;
        case 16: x = static_cast<double>(uint(p, 8)); break;
        case 6: x = static_cast<int8_t>(p[0]); break;
        case 8: x = static_cast<int16_t>(uint(p, 2)); break;
        case 9: x = static_cast<int32_t>(uint(p, 4)); break;
        case 11: {
          uint32_t b = static_cast<uint32_t>(uint(p, 4));
          float f;
          memcpy(&f, &b, 4);
          x = f;
          integer = false;
          break;
        }
        case 12: {
          uint64_t b = uint(p, 8);
          memcpy(&x, &b, 8);
          integer = false;
          break;
        }
        case 5: case 10: {
          double a = type == 5 ? static_cast<double>(uint(p, 4)) : static_cast<int32_t>(uint(p, 4));
          double b = type == 5 ? static_cast<double>(uint(p + 4, 4)) : static_cast<int32_t>(uint(p + 4, 4));
          x = b == 0 ? NAN : a / b;
          integer = false;
          break;
        }
      }
      r.v.push_back(x);
      r.integer.push_back(integer);
    }
    if (single_valued(tag) || (!tuple_valued(tag) && r.v.size() == 1)) {
      r.kind = Value::NUM;
      r.v.resize(1);
      r.integer.resize(1);
    } else {
      r.kind = Value::TUPLE;
    }
    return r;
  }

  bool has(int tag) const { return tags_.count(tag) != 0; }
  Value get(int tag, const Value& dflt) const {
    auto it = tags_.find(tag);
    return it == tags_.end() ? dflt : it->second.value;
  }
  // An int the way Pillow uses it (range, seek, slicing): other kinds fail.
  static int64_t as_int(const Value& v, const char* what, size_t i = 0) {
    if (!v.is_int(i)) refused(std::string("TIFF ") + what + " that is not an integer");
    return static_cast<int64_t>(v.v[i]);
  }

  // -------------------------------------------------------------- _setup ----

  void setup() {
    if (has(0xBC01)) refused("Windows Media Photo in TIFF");
    const Value comp = get(259, num(1));
    static const int kKnown[] = {1, 2, 3, 4, 5, 6, 7, 8, 32771, 32773, 32809, 32946, 34676, 34677, 34925, 50000, 50001};
    int c = -1;
    for (int k : kKnown)
      if (is(comp, k)) c = k;
    if (c < 0) refused("TIFF compression outside Pillow's COMPRESSION_INFO");
    compression_ = c;
    const Value planar = get(284, num(1));
    Value photo = get(262, num(0));
    if (compression_ == 6) photo = num(6);
    const Value fillorder = get(266, num(1));
    if (!has(256) || !has(257)) refused("TIFF without its dimensions");
    const Value w = get(256, num(0)), h = get(257, num(0));
    if (!w.is_int() || !h.is_int() || w.kind != Value::NUM || h.kind != Value::NUM)
      refused("TIFF with invalid dimensions");
    if (w.v[0] > static_cast<double>(kMaxPixels) || h.v[0] > static_cast<double>(kMaxPixels))
      refused("TIFF image past twice PIL's MAX_IMAGE_PIXELS");  // (or empty: either way PIL raises)
    xsize_ = static_cast<int64_t>(w.v[0]);
    ysize_ = static_cast<int64_t>(h.v[0]);
    Value sample_format = get(339, tuple({1}));
    if (sample_format.size() > 1 && sample_format.kind != Value::OTHER) {
      double mx = *std::max_element(sample_format.v.begin(), sample_format.v.end());
      double mn = *std::min_element(sample_format.v.begin(), sample_format.v.end());
      if (mx == 1 && mn == 1) sample_format = tuple({1});
    }
    Value bps = get(258, tuple({1}));
    const Value extra = get(338, Value{Value::TUPLE, {}, {}, {}});
    int bps_count = (is(photo, 2) || is(photo, 6) || is(photo, 8)) ? 3 : (is(photo, 5) ? 4 : 1);
    if (extra.kind == Value::OTHER) refused("TIFF ExtraSamples of a kind Pillow cannot count");
    bps_count += static_cast<int>(extra.size());
    const Value spp_v = get(277, num(compression_ == 6 && (is(photo, 2) || is(photo, 6)) ? 3 : 1));
    if (spp_v.kind != Value::NUM) refused("TIFF SamplesPerPixel that is not a number");
    if (spp_v.v[0] > 6) refused("TIFF with more samples per pixel than can be decoded");
    if (bps.kind == Value::OTHER) refused("TIFF BitsPerSample of a kind Pillow cannot count");
    const size_t actual = bps.size();
    if (spp_v.v[0] < static_cast<double>(actual)) {
      const int64_t spp = as_int(spp_v, "SamplesPerPixel");
      bps.v.resize(static_cast<size_t>(std::max<int64_t>(spp, 0)));
      bps.integer.resize(bps.v.size());
      if (bps.kind == Value::BYTES) bps.raw.resize(bps.v.size());
    } else if (spp_v.v[0] > static_cast<double>(actual) && actual == 1) {
      const int64_t spp = as_int(spp_v, "SamplesPerPixel");
      bps.v.assign(static_cast<size_t>(spp), bps.v[0]);
      bps.integer.assign(static_cast<size_t>(spp), bps.integer[0]);
      if (bps.kind == Value::BYTES) bps.raw.assign(static_cast<size_t>(spp), bps.raw[0]);
    }
    if (static_cast<double>(bps.size()) != spp_v.v[0]) refused("TIFF of an unknown data organization");
    const OpenInfo* oi = find_open_info(prefix_, photo, sample_format, fillorder, bps, extra);
    if (!oi) refused("TIFF of an unknown pixel mode");
    mode_ = mode_of(oi->mode);
    rawmode_ = oi->rawmode;
    photo_ = oi->photo;
    fillorder_ = oi->fillorder;
    planar_ = is(planar, 2) ? 2 : (is(planar, 1) ? 1 : 0);
    bps_ = oi->bps;
    bps_count_ = bps_count;
    for (int o = 2; o <= 8; ++o)
      if (is(exif_orientation(), o)) orientation_ = o;
    swap_ = orientation_ >= 5;
    libtiff_ = compression_ != 1;
    if (libtiff_) {
      if (fillorder_ == 2) {  // libtiff undoes the fill order: the fillorder 1 key
        const OpenInfo* f1 = find_open_info(prefix_, photo, sample_format, num(1), bps, extra);
        if (!f1) refused("TIFF of an unknown pixel mode");
        mode_ = mode_of(f1->mode);
        rawmode_ = f1->rawmode;
      }
      if (photo_ == 6 && compression_ == 7 && planar_ == 1)
        rawmode_ = "RGB";
      else if (rawmode_ == "I;16")
        rawmode_ = "I;16N";
      else if (rawmode_.size() > 4 && (rawmode_.compare(rawmode_.size() - 4, 4, ";16B") == 0 ||
                                        rawmode_.compare(rawmode_.size() - 4, 4, ";16L") == 0))
        rawmode_ = rawmode_.substr(0, rawmode_.size() - 1) + "N";
    } else if (!has(273) && !has(324)) {
      refused("TIFF of an unknown data organization");
    }
    if (mode_ == MP || mode_ == MPA) {
      if (!has(320)) refused("palette TIFF without a ColorMap");
    }
    if (xsize_ <= 0 || ysize_ <= 0) refused("TIFF of an empty size");
    // load_prepare's decompression-bomb check, before the caller sizes its buffer
    if (static_cast<uint64_t>(xsize_) * static_cast<uint64_t>(ysize_) > kMaxPixels)
      refused("TIFF image of " + std::to_string(static_cast<uint64_t>(xsize_) * static_cast<uint64_t>(ysize_)) +
              " pixels, past twice PIL's MAX_IMAGE_PIXELS");
  }

  // Image.getexif()'s Orientation: the tag, else an XMP tiff:Orientation.
  Value exif_orientation() const {
    if (has(274)) return get(274, Value{});
    auto it = tags_.find(700);
    if (it == tags_.end()) return Value{};
    if (it->second.type == 2) refused("TIFF with an ASCII XMP packet searched for an orientation");
    const std::vector<uint8_t>& x = it->second.data;
    if (it->second.type != 1 && it->second.type != 7) return Value{};
    static const char kKey[] = "tiff:Orientation";
    const size_t k = sizeof(kKey) - 1;
    for (size_t i = 0; i + k + 2 <= x.size(); ++i) {
      if (memcmp(x.data() + i, kKey, k) != 0) continue;
      size_t j = i + k;
      if (x[j] == '>' && x[j + 1] >= '0' && x[j + 1] <= '9') return num(x[j + 1] - '0');
      if (j + 2 < x.size() && x[j] == '=' && x[j + 1] == '"' && x[j + 2] >= '0' && x[j + 2] <= '9')
        return num(x[j + 2] - '0');
    }
    return Value{};
  }

  // The ColorMap as Pillow's palette: each 16-bit entry's high byte, the
  // three planes of len / 3 entries (RGB;L), zero past them.
  void palette() {
    pal_.assign(256 * 3, 0);
    if (mode_ != MP && mode_ != MPA) return;
    const Value& cm = tags_.at(320).value;
    std::vector<uint8_t> b;
    for (size_t i = 0; i < cm.v.size(); ++i) {
      if (!cm.is_int(i)) refused("TIFF ColorMap that is not integers");
      int64_t x = static_cast<int64_t>(cm.v[i]);
      b.push_back(static_cast<uint8_t>((x >= 0 ? x / 256 : -((-x + 255) / 256)) & 255));
    }
    const size_t entries = b.size() / 3;
    if (entries > 256) refused("TIFF ColorMap of more than 256 entries (an invalid palette size)");
    for (size_t i = 0; i < entries; ++i)
      for (int c = 0; c < 3; ++c) pal_[3 * i + c] = b[i + c * entries];
  }

  // ----------------------------------------------- Pillow's raw tile path ----

  struct RawTile {
    int64_t x0, y0, x1, y1;
    uint64_t offset;
    std::string rawmode;
    int64_t stride;
  };

  void load_raw() {
    std::vector<double> offsets;
    int64_t w, h;
    const bool strips = has(273);
    const Value& offv = tags_.at(strips ? 273 : 324).value;
    if (offv.kind == Value::OTHER) refused("TIFF offsets of a kind Pillow cannot seek to");
    for (size_t i = 0; i < offv.v.size(); ++i) {
      if (!offv.is_int(i)) refused("TIFF offset that is not an integer");
      offsets.push_back(offv.v[i]);
    }
    if (offv.kind == Value::NUM) offsets.resize(1);
    if (strips) {
      const Value hv = get(278, num(static_cast<double>(ysize_)));
      if (hv.kind != Value::NUM || !hv.is_int()) refused("TIFF RowsPerStrip that is not an integer");
      h = static_cast<int64_t>(hv.v[0]);
      w = xsize_;
    } else {
      const Value tw = get(322, Value{}), th = get(323, Value{});
      if (tw.kind != Value::NUM || th.kind != Value::NUM || !tw.is_int() || !th.is_int())
        refused("TIFF with invalid tile dimensions");
      w = static_cast<int64_t>(tw.v[0]);
      h = static_cast<int64_t>(th.v[0]);
    }
    if (w == xsize_ && h == ysize_ && planar_ != 2 && !offsets.empty()) offsets = {offsets.back()};
    double bits_sum = 0;
    for (int b : bps_) bits_sum += b;
    std::vector<RawTile> tiles;
    int64_t x = 0, y = 0;
    size_t layer = 0;
    for (double off : offsets) {
      double stride = x + w > xsize_ ? static_cast<double>(w) * bits_sum / 8 : 0;
      std::string rm = rawmode_;
      if (planar_ == 2) {
        if (layer >= rawmode_.size()) refused("TIFF with more planes than its rawmode has letters");
        rm = rawmode_.substr(layer, 1);
        stride /= bps_count_;
      }
      tiles.push_back({x, y, std::min(x + w, xsize_), std::min(y + h, ysize_), static_cast<uint64_t>(off), rm,
                       static_cast<int64_t>(stride)});
      x += w;
      if (x >= xsize_) {
        x = 0;
        y += h;
        if (y >= ysize_) {
          y = 0;
          ++layer;
        }
      }
    }
    std::stable_sort(tiles.begin(), tiles.end(),
                     [](const RawTile& a, const RawTile& b) { return a.offset < b.offset; });
    std::vector<RawTile> kept;
    for (size_t i = 0; i < tiles.size(); ++i) {
      const RawTile& t = tiles[i];
      if (i + 1 < tiles.size()) {
        const RawTile& u = tiles[i + 1];
        if (t.x0 == u.x0 && t.y0 == u.y0 && t.x1 == u.x1 && t.y1 == u.y1 && t.rawmode == u.rawmode &&
            t.stride == u.stride)
          continue;
      }
      kept.push_back(t);
    }
    for (const RawTile& t : kept) raw_tile(t);
  }

  void raw_tile(const RawTile& t) {
    Unpacker u = find_unpacker(mode_, t.rawmode);
    if (!u.fn) refused("TIFF rawmode " + t.rawmode + " for this image mode");
    int64_t x0 = t.x0, y0 = t.y0, xs = t.x1 - t.x0, ys = t.y1 - t.y0;
    if (t.x0 == 0 && t.x1 == 0) {  // Pillow's setimage: extents (0, y0, 0, y1) are the whole image
      x0 = y0 = 0;
      xs = xsize_;
      ys = ysize_;
    }
    if (xs <= 0 || ys <= 0 || x0 < 0 || y0 < 0 || x0 + xs > xsize_ || y0 + ys > ysize_)
      refused("TIFF tile that extends outside the image");
    const int64_t bytes = (xs * u.bits + 7) / 8;
    int64_t skip = 0;
    if (t.stride) {
      skip = t.stride - bytes;
      if (skip < 0) refused("TIFF tile whose stride is shorter than its rows");
    }
    uint64_t p = t.offset;
    for (int64_t r = 0; r < ys; ++r) {
      if (r > 0) p += static_cast<uint64_t>(skip);
      if (p > n_ || static_cast<uint64_t>(bytes) > n_ - p)
        corrupt("image file is truncated (TIFF strip or tile cut short)");
      u.fn(img_.data() + (static_cast<size_t>(y0 + r) * xsize_ + x0) * ps_, d_ + p, static_cast<int>(xs));
      p += static_cast<uint64_t>(bytes);
    }
  }

  // ------------------------------------------------- the libtiff path ----

  // libtiff's own reading of the header and the first directory
  // (tif_dirread.c TIFFReadDirectory), where it parts from Pillow's: the
  // swapped magics and a BigTIFF offset size other than 8 refused, a
  // directory of more than 4096 entries or reaching past the file refused,
  // entries of an unknown type dropped, the fields read first (ImageWidth /
  // Length, tile size, PlanarConfiguration, RowsPerStrip, SamplesPerPixel,
  // Compression) and the strip arrays fatal when their type or count is
  // wrong, ImageLength / Width and the offsets required, missing offsets and
  // byte counts zero, and byte counts estimated (EstimateStripByteCounts)
  // when absent from a file of one strip or tile (of one a plane), or zero
  // for the one strip.
  // What the libtiff path decodes by: libtiff's own values, which a
  // directory with duplicate tags, cut entries or odd types can set apart
  // from Pillow's.
  struct LibtiffDir {
    uint64_t width = 0, length = 0, bps = 1, spp = 1, comp = 1, photometric = 1, planar = 1, rps = 0xFFFFFFFFu,
             tw = 0, tl = 0, fillorder = 1, predictor = 1, t4 = 0, sampleformat = 1;
    bool tiled = false;
    std::vector<uint64_t> offs, counts, extra, sub;
    std::vector<double> luma, rbw;
    std::vector<uint8_t> tables;
    // old-style JPEG (tif_ojpeg.c's fields): JPEGInterchangeFormat / Length,
    // JPEGRestartInterval, JPEGQTables / DCTables / ACTables offsets (unset
    // past 3 values), whether YCbCrSubsampling was read
    uint64_t jif = 0, jif_len = 0, restart = 0;
    bool has_restart = false, has_sub = false, has_counts = true;
    std::vector<uint64_t> qt, dct, act;
  } lt_;

  void libtiff_dir() {
    if (!big_ && uint(d_ + 2, 2) != 42) corrupt("not a TIFF file to libtiff (bad version number)");
    if (big_ && (uint(d_ + 4, 2) != 8 || uint(d_ + 6, 2) != 0)) corrupt("unsupported BigTIFF offset size");
    const size_t cnt_bytes = big_ ? 8 : 2, entry = big_ ? 20 : 12, inline_bytes = big_ ? 8 : 4;
    if (ifd_ > n_ || n_ - ifd_ < cnt_bytes) corrupt("can not read TIFF directory count");
    const uint64_t count = uint(d_ + ifd_, static_cast<int>(cnt_bytes));
    if (count > 4096) corrupt("sanity check on TIFF directory count failed");
    if (count * entry > n_ - ifd_ - cnt_bytes) corrupt("can not read TIFF directory");
    struct Entry {
      int tag, type;
      uint64_t count;
      const uint8_t* inl;
    };
    std::map<int, Entry> es;
    for (uint64_t i = 0; i < count; ++i) {
      const uint8_t* p = d_ + ifd_ + cnt_bytes + i * entry;
      Entry e{static_cast<int>(uint(p, 2)), static_cast<int>(uint(p + 2, 2)), uint(p + 4, big_ ? 8 : 4),
              p + (big_ ? 12 : 8)};
      if (e.type < 1 || e.type > 18 || e.type == 14 || e.type == 15) {  // unknown type
        static const int kFirstPass[] = {256, 257, 258, 259, 273, 277, 278, 279, 284, 322, 323, 324, 325, 338};
        for (int t : kFirstPass)
          if (t == e.tag) corrupt("TIFF field " + std::to_string(t) + " of an unknown type (libtiff)");
        continue;
      }
      if (!es.count(e.tag)) es[e.tag] = e;
    }
    static const int kWidth[19] = {0, 1, 1, 2, 4, 8, 1, 1, 2, 4, 8, 4, 8, 4, 0, 0, 8, 8, 8};
    // An entry's integer values (its first `limit`, as TIFFReadDirEntryArrayWithLimit
    // reads them, from where the whole entry's size puts them), or false when
    // libtiff cannot read them as integers (IFD types included).
    auto values = [&](const Entry& e, std::vector<uint64_t>& out, uint64_t limit = ~uint64_t(0)) -> bool {
      static const bool kInt[19] = {false, true, false, true, true, false, true, false, true, true, false, false,
                                    false, false, false, false, true, true, false};
      if (!kInt[e.type]) return false;
      const int w = kWidth[e.type];
      const uint64_t count = std::min(e.count, limit);
      const unsigned __int128 size = static_cast<unsigned __int128>(count) * static_cast<unsigned>(w);
      const uint8_t* src = e.inl;
      if (static_cast<unsigned __int128>(e.count) * static_cast<unsigned>(w) > inline_bytes) {
        const uint64_t off = uint(e.inl, static_cast<int>(inline_bytes));
        if (off > n_ || size > n_ - off) return false;
        src = d_ + off;
      }
      out.clear();
      for (uint64_t i = 0; i < count; ++i) {
        uint64_t v = uint(src + i * w, w);
        const bool sign = e.type == 6 || e.type == 8 || e.type == 9 || e.type == 17;
        if (sign && (v >> (8 * w - 1)) & 1) return false;  // a negative value
        out.push_back(v);
      }
      return true;
    };
    // One value (absent: true, v unchanged), in the range of the field's SHORT or LONG.
    auto scalar = [&](int tag, uint64_t& v) -> bool {
      auto it = es.find(tag);
      if (it == es.end()) return true;
      std::vector<uint64_t> x;
      if (it->second.count != 1 || !values(it->second, x)) return false;
      const bool is_long = tag == 256 || tag == 257 || tag == 278 || tag == 322 || tag == 323 || tag == 292;
      if (x[0] > (is_long ? 0xFFFFFFFFull : 0xFFFFull)) return false;
      v = x[0];
      return true;
    };
    LibtiffDir& L = lt_;
    for (auto [tag, v] : {std::pair<int, uint64_t*>{256, &L.width}, {257, &L.length}, {322, &L.tw}, {323, &L.tl},
                          {284, &L.planar}, {278, &L.rps}, {277, &L.spp}, {259, &L.comp}})
      if (!scalar(tag, *v)) corrupt("TIFF field " + std::to_string(tag) + " libtiff cannot read");
    if (!es.count(256) && !es.count(257)) corrupt("TIFF directory missing ImageLength (libtiff)");
    // TiffDecode.c: libtiff's size must be Pillow's
    if (L.width != static_cast<uint64_t>(xsize_) || L.length != static_cast<uint64_t>(ysize_))
      corrupt("libtiff reads another image size than Pillow");
    const uint64_t width = L.width, length = L.length, tw = L.tw, tl = L.tl, planar = L.planar, rps = L.rps,
                   spp = L.spp;
    // the per-sample SHORT fields: one value, or one a sample all equal; else the directory fails
    for (int tag : {258, 280, 281, 339, 32996}) {
      auto it = es.find(tag);
      if (it == es.end()) continue;
      std::vector<uint64_t> b;
      if (!values(it->second, b) || b.empty() || (b.size() != 1 && b.size() < spp) || b[0] > 0xFFFF)
        corrupt("TIFF field " + std::to_string(tag) + " libtiff cannot read");
      for (size_t i = 1; i < b.size() && i < spp; ++i)
        if (b[i] != b[0]) corrupt("different values per sample for TIFF field " + std::to_string(tag) + " (libtiff)");
      if (tag == 258) L.bps = b[0];
      if (tag == 339) {
        if (b[0] < 1 || b[0] > 6) corrupt("bad SampleFormat value (libtiff)");
        L.sampleformat = b[0];
      }
    }
    for (int tag : {340, 341}) {  // SMin/SMaxSampleValue: one double a sample
      auto it = es.find(tag);
      if (it == es.end()) continue;
      const int t = it->second.type;
      const uint64_t size = it->second.count * static_cast<uint64_t>(kWidth[t]);
      const uint64_t off = uint(it->second.inl, static_cast<int>(inline_bytes));
      if (it->second.count != spp || t == 2 || t == 7 || t == 13 || t == 18 ||
          (size > inline_bytes && (off > n_ || size > n_ - off)))
        corrupt("TIFF field " + std::to_string(tag) + " libtiff cannot read");
    }
    if (L.bps == 0) corrupt("cannot handle zero strip size (libtiff)");
    if (planar != 1 && planar != 2) corrupt("bad PlanarConfiguration value (libtiff)");
    if (rps == 0 || spp == 0) corrupt("bad RowsPerStrip or SamplesPerPixel value (libtiff)");
    // the fields read later (TIFFFetchNormalTag with recovery: one that libtiff cannot read keeps its default)
    bool photo_set = false;
    for (auto [tag, v] : {std::pair<int, uint64_t*>{262, &L.photometric}, {266, &L.fillorder}, {317, &L.predictor},
                          {292, &L.t4}}) {
      const bool ok = scalar(tag, *v);
      if (tag == 262) photo_set = ok && es.count(262);
    }
    if (!es.count(262)) L.photometric = spp >= 3 ? 2 : 1;  // "Photometric tag is missing": not YCbCr either way
    if (L.comp == 6) {  // TIFFReadDirectory's old-style JPEG hacks
      if (!photo_set || L.photometric == 2) L.photometric = 6;
      if (!es.count(258)) L.bps = 8;
      if (!es.count(277) && (L.photometric == 6 || L.photometric <= 1)) L.spp = L.photometric == 6 ? 3 : 1;
      auto one = [&](int tag, uint64_t& v, uint64_t limit) {
        auto it = es.find(tag);
        std::vector<uint64_t> x;
        if (it == es.end() || it->second.count != 1 || !values(it->second, x) || x[0] > limit) return false;
        v = x[0];
        return true;
      };
      one(513, L.jif, ~uint64_t(0));
      one(514, L.jif_len, ~uint64_t(0));
      L.has_restart = one(515, L.restart, 0xFFFF);
      for (auto [tag, v] : {std::pair<int, std::vector<uint64_t>*>{519, &L.qt}, {520, &L.dct}, {521, &L.act}}) {
        auto it = es.find(tag);
        if (it == es.end() || it->second.count > 3 || !values(it->second, *v)) v->clear();
      }
    }
    {
      auto it = es.find(530);
      if (it != es.end() && !values(it->second, L.sub)) L.sub.clear();
      L.has_sub = L.comp == 6 && it != es.end() && L.sub.size() >= 2;
    }
    {  // ExtraSamples (read first, fatally; setExtraSamples), then every non-colour channel one
      auto it = es.find(338);
      if (it != es.end()) {
        if (!values(it->second, L.extra) || L.extra.size() > spp) corrupt("bad ExtraSamples (libtiff)");
        for (uint64_t& v : L.extra) {
          if (v > 2 && v != 999) corrupt("bad ExtraSamples value (libtiff)");
          if (v == 999) v = 2;
        }
      }
      const uint64_t p = L.photometric;
      // _TIFFGetMaxColorChannels
      const uint64_t colour = p <= 1 || p == 3 ? 1
                              : (p == 2 || p == 6 || p == 8 || p == 9 || p == 10 || p == 32845) ? 3
                              : (p == 5 || p == 4) ? 4
                                                   : 0;
      if (colour && spp > colour + L.extra.size()) L.extra.resize(static_cast<size_t>(spp - colour), 0);
    }
    auto reals = [&](int tag, std::vector<double>& out) {  // rational, float or integer values
      auto it = es.find(tag);
      if (it == es.end()) return;
      const Entry& e = it->second;
      const int w = kWidth[e.type];
      const unsigned __int128 size = static_cast<unsigned __int128>(e.count) * static_cast<unsigned>(w);
      const uint8_t* src = e.inl;
      if (size > inline_bytes) {
        const uint64_t off = uint(e.inl, static_cast<int>(inline_bytes));
        if (off > n_ || size > n_ - off) return;
        src = d_ + off;
      }
      for (uint64_t i = 0; i < e.count; ++i) {
        const uint8_t* q = src + i * w;
        double x;
        if (e.type == 5 || e.type == 10) {
          const double a = e.type == 5 ? static_cast<double>(uint(q, 4)) : static_cast<int32_t>(uint(q, 4));
          const double b = e.type == 5 ? static_cast<double>(uint(q + 4, 4)) : static_cast<int32_t>(uint(q + 4, 4));
          x = b == 0 ? 0 : a / b;
        } else if (e.type == 11) {
          const uint32_t bits = static_cast<uint32_t>(uint(q, 4));
          float f;
          memcpy(&f, &bits, 4);
          x = f;
        } else if (e.type == 12) {
          const uint64_t bits = uint(q, 8);
          memcpy(&x, &bits, 8);
        } else {
          x = static_cast<double>(uint(q, w));
        }
        out.push_back(x);
      }
    };
    reals(529, L.luma);
    reals(532, L.rbw);
    {
      auto it = es.find(347);
      if (it != es.end() && kWidth[it->second.type] == 1) {
        const Entry& e = it->second;
        const uint8_t* src = e.inl;
        if (e.count > inline_bytes) {
          const uint64_t off = uint(e.inl, static_cast<int>(inline_bytes));
          src = off <= n_ && e.count <= n_ - off ? d_ + off : nullptr;
        }
        if (src) L.tables.assign(src, src + e.count);
      }
    }
    L.tiled = es.count(322) || es.count(323);
    uint64_t nstrips;
    if (L.tiled) {
      if (tw == 0 || tl == 0) corrupt("TIFF tile size 0 (libtiff)");
      nstrips = ((width + tw - 1) / tw) * ((length + tl - 1) / tl);
    } else {
      nstrips = rps == 0xFFFFFFFFu ? 1 : (length + rps - 1) / rps;
    }
    if (planar == 2) nstrips *= spp;
    if (nstrips == 0) corrupt("cannot handle zero number of strips (libtiff)");
    const int off_tag = es.count(324) ? 324 : 273, cnt_tag = es.count(325) ? 325 : 279;
    const bool no_offsets = !es.count(273) && !es.count(324);
    // the old-style JPEG hack: one strip needs no offsets (tif_ojpeg.c reads JPEGInterchangeFormat)
    if (no_offsets && !(L.comp == 6 && !L.tiled && nstrips == 1))
      corrupt("TIFF directory missing StripOffsets (libtiff)");
    auto strip_array = [&](int tag, std::vector<uint64_t>& out) {  // TIFFFetchStripThing: nstrips read, zeros past
      if (!values(es.at(tag), out, nstrips)) corrupt("TIFF strip array libtiff cannot read");
      out.resize(static_cast<size_t>(nstrips), 0);
    };
    if (no_offsets)
      L.offs.assign(1, 0);
    else
      strip_array(off_tag, L.offs);
    if (L.comp == 6) {  // "no further messing with strip/tile offsets/bytecounts in OJPEG TIFFs"
      L.has_counts = es.count(cnt_tag) != 0;
      if (L.has_counts) strip_array(cnt_tag, L.counts);
      L.counts.resize(static_cast<size_t>(nstrips), 0);
      return;
    }
    if (!es.count(cnt_tag) && ((planar == 1 && nstrips > 1) || (planar == 2 && nstrips != spp)))
      corrupt("TIFF directory missing StripByteCounts (libtiff)");
    if (es.count(cnt_tag)) strip_array(cnt_tag, L.counts);
    if (!es.count(cnt_tag) || (nstrips == 1 && !L.tiled && L.offs[0] != 0 && L.counts[0] == 0)) {  // estimated
      uint64_t space = big_ ? 16 + 8 + count * 20 + 8 : 8 + 2 + count * 12 + 4;
      for (uint64_t i = 0; i < count; ++i) {
        const uint8_t* p = d_ + ifd_ + cnt_bytes + i * entry;
        const int type = static_cast<int>(uint(p + 2, 2));
        const int w = type >= 1 && type <= 18 ? kWidth[type] : 0;
        if (!w) corrupt("cannot determine size of unknown tag type (libtiff)");
        const uint64_t size = uint(p + 4, big_ ? 8 : 4) * static_cast<uint64_t>(w);
        if (size > inline_bytes) space += size;
      }
      space = n_ < space ? n_ : n_ - space;
      if (planar == 2) space /= spp;
      L.counts.assign(static_cast<size_t>(nstrips), space);
      const uint64_t last = L.offs.back();
      if (last + space > n_) L.counts.back() = last >= n_ ? 0 : n_ - last;
    }
  }

  // Raw bytes of strip or tile `i`, bit-reversed under FillOrder 2 (not
  // JPEG's; the fax decoders, CCITT RLEW's too, read the fill order themselves).
  std::vector<uint8_t> chunk(size_t i) const {
    const uint64_t off = i < lt_.offs.size() ? lt_.offs[i] : 0, cnt = i < lt_.counts.size() ? lt_.counts[i] : 0;
    if (cnt == 0) corrupt("invalid TIFF strip byte count 0");
    if (off > n_ || cnt > n_ - off) corrupt("read error on a TIFF strip past the end of the file");
    std::vector<uint8_t> r(d_ + off, d_ + off + cnt);
    if (lt_.fillorder == 2 && lt_.comp != 7 && lt_.comp != 6 && lt_.comp != 32771 && (lt_.comp > 4 || lt_.comp == 1))
      for (auto& b : r) b = kBitRev[b];
    return r;
  }

  // One strip or tile of `occ` decoded bytes (rows of `rowsize`), predictor undone.
  // One strip or tile through its codec: true when all `occ` bytes were
  // decoded; on a data error what was decoded stays in op (libtiff's codecs
  // write as they go; PackBits zeroes the rest).
  bool decode_codec(const std::vector<uint8_t>& raw, uint8_t* op, size_t occ, size_t rowsize, int width,
                    uint64_t offset) {
    bool ok = false;
    switch (lt_.comp) {
      case 1:  // tif_dumpmode.c DumpModeDecode
        ok = raw.size() >= occ;
        memcpy(op, raw.data(), std::min(raw.size(), occ));
        break;
      case 32773:
        ok = packbits(raw.data(), raw.size(), op, occ);
        break;
      case 5: {
        const bool compat = raw.size() >= 2 && raw[0] == 0 && (raw[1] & 1);
        if (lzw_compat_ < 0) lzw_compat_ = compat ? 1 : 0;
        ok = lzw(raw.data(), raw.size(), op, occ, lzw_compat_ == 1);
        break;
      }
      case 8: case 32946: case 34925: {
        if (!inflate_) corrupt("no inflate for Deflate / LZMA data");
        const int64_t got = inflate_(lt_.comp == 34925 ? 34925 : 8, raw.data(), static_cast<int64_t>(raw.size()), op,
                                     static_cast<int64_t>(occ));  // -1 - bytes written on a data error
        // tif_zip.c fails at a data error; tif_lzma.c stops there and fails only when the output is short
        ok = got == static_cast<int64_t>(occ) || (lt_.comp == 34925 && got == -1 - static_cast<int64_t>(occ));
        break;
      }
      case 2: case 3: case 4: case 32771: {
        if (lt_.bps != 1) break;  // Fax3SetupState: bits/sample must be 1
        Fax fax(static_cast<int>(lt_.comp), static_cast<uint32_t>(lt_.t4), static_cast<uint32_t>(width),
                lt_.fillorder == 2, offset & 1);
        ok = fax.decode(raw.data(), raw.size(), op, occ, rowsize) > 0;
        break;
      }
      case 50000:
        if (!zstd_) corrupt("no ZSTD decoder for ZSTD-compressed TIFF");
        ok = zstd_(raw.data(), static_cast<int64_t>(raw.size()), op, static_cast<int64_t>(occ)) == 1;
        break;
      case 32809:
        ok = thunder(raw.data(), raw.size(), op, occ);
        break;
      default:
        refused("TIFF compression " + std::to_string(lt_.comp) + " that this libtiff cannot decode");
    }
    return ok;
  }
  void decode_chunk(const std::vector<uint8_t>& raw, uint8_t* op, size_t occ, size_t rowsize, int width, size_t idx) {
    if (!decode_codec(raw, op, occ, rowsize, width, lt_.offs[idx])) corrupt("TIFF strip or tile cut short or corrupt");
  }
  // tif_thunder.c ThunderDecodeRow: rows of the image's scanline size, each
  // of ImageWidth 4-bit pixels (runs, 2- and 3-bit deltas, raw values); a
  // row that decodes to another count fails (the rest of it zeroed).
  bool thunder(const uint8_t* bp, size_t cc, uint8_t* buf, size_t occ) const {
    if (lt_.bps != 4) return false;  // ThunderSetupDecode
    const size_t scanline = static_cast<size_t>((static_cast<uint64_t>(xsize_) * lt_.spp * 4 + 7) / 8);
    if (scanline == 0 || occ % scanline) return false;
    static const int kDelta2[4] = {0, 1, 0, -1}, kDelta3[8] = {0, 1, 2, 3, 0, -3, -2, -1};
    const int64_t maxpixels = xsize_;
    for (uint8_t* row = buf; occ > 0; occ -= scanline, row += scanline) {
      uint8_t* op = row;
      unsigned lastpixel = 0;
      int64_t npixels = 0;
      auto setpixel = [&](unsigned v) {
        lastpixel = v & 0xf;
        if (npixels < maxpixels) {
          if (npixels++ & 1)
            *op++ |= static_cast<uint8_t>(lastpixel);
          else
            op[0] = static_cast<uint8_t>(lastpixel << 4);
        }
      };
      auto step = [&](int d) { setpixel(static_cast<unsigned>(static_cast<int>(lastpixel) + d)); };
      while (cc > 0 && npixels < maxpixels) {
        int n = *bp++;
        --cc;
        int delta;
        switch (n & 0xc0) {
          case 0x00:  // a run of the last pixel
            if (npixels & 1) {
              op[0] |= static_cast<uint8_t>(lastpixel);
              lastpixel = *op++;
              ++npixels;
              --n;
            } else {
              lastpixel |= lastpixel << 4;
            }
            npixels += n;
            if (npixels <= maxpixels)
              for (; n > 0; n -= 2) *op++ = static_cast<uint8_t>(lastpixel);
            if (n == -1) *--op &= 0xf0;
            lastpixel &= 0xf;
            break;
          case 0x40:  // three 2-bit deltas
            if ((delta = (n >> 4) & 3) != 2) step(kDelta2[delta]);
            if ((delta = (n >> 2) & 3) != 2) step(kDelta2[delta]);
            if ((delta = n & 3) != 2) step(kDelta2[delta]);
            break;
          case 0x80:  // two 3-bit deltas
            if ((delta = (n >> 3) & 7) != 4) step(kDelta3[delta]);
            if ((delta = n & 7) != 4) step(kDelta3[delta]);
            break;
          default:  // a raw pixel
            setpixel(static_cast<unsigned>(n));
            break;
        }
      }
      if (npixels != maxpixels) {
        uint8_t* end = row + (maxpixels + 1) / 2;
        if (op < end) memset(op, 0, static_cast<size_t>(end - op));
        return false;
      }
    }
    return true;
  }

  bool predicts() const {
    return lt_.predictor != 1 &&
           (lt_.comp == 5 || lt_.comp == 8 || lt_.comp == 32946 || lt_.comp == 34925 || lt_.comp == 50000);
  }
  int lzw_compat_ = -1;

  // tif_predict.c: horizontal differencing (2) and floating point (3), per row.
  void predictor(uint8_t* op, size_t occ, size_t rowsize, int stride) {
    if (!predicts()) return;
    const uint64_t pred = lt_.predictor;
    const int bps = static_cast<int>(lt_.bps);
    if (pred == 2) {
      if (bps != 8 && bps != 16 && bps != 32 && bps != 64) corrupt("horizontal differencing with these samples");
      const size_t bytes = static_cast<size_t>(bps / 8);
      if (rowsize % (bytes * stride)) corrupt("predictor row size");
      for (size_t r = 0; r < occ / rowsize; ++r) {
        uint8_t* row = op + r * rowsize;
        const size_t wc = rowsize / bytes;
        for (size_t i = stride; i < wc; ++i) {
          if (bytes == 1) {
            row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
          } else if (bytes == 2) {
            uint16_t a, b;
            memcpy(&a, row + 2 * i, 2);
            memcpy(&b, row + 2 * (i - stride), 2);
            a = static_cast<uint16_t>(a + b);
            memcpy(row + 2 * i, &a, 2);
          } else if (bytes == 4) {
            uint32_t a, b;
            memcpy(&a, row + 4 * i, 4);
            memcpy(&b, row + 4 * (i - stride), 4);
            a += b;
            memcpy(row + 4 * i, &a, 4);
          } else {
            uint64_t a, b;
            memcpy(&a, row + 8 * i, 8);
            memcpy(&b, row + 8 * (i - stride), 8);
            a += b;
            memcpy(row + 8 * i, &a, 8);
          }
        }
      }
    } else if (pred == 3) {
      if (lt_.sampleformat != 3) corrupt("floating point predictor on integer samples");
      if (bps != 16 && bps != 24 && bps != 32 && bps != 64) corrupt("floating point predictor with these samples");
      const size_t bytes = static_cast<size_t>(bps / 8);
      if (rowsize % (bytes * stride)) corrupt("predictor row size");
      std::vector<uint8_t> tmp(rowsize);
      const size_t wc = rowsize / bytes;
      for (size_t r = 0; r < occ / rowsize; ++r) {
        uint8_t* row = op + r * rowsize;
        for (size_t i = stride; i < rowsize; ++i) row[i] = static_cast<uint8_t>(row[i] + row[i - stride]);
        memcpy(tmp.data(), row, rowsize);
        for (size_t c = 0; c < wc; ++c)
          for (size_t b = 0; b < bytes; ++b) row[bytes * c + b] = tmp[(bytes - b - 1) * wc + c];
      }
    } else {
      corrupt("TIFF Predictor " + std::to_string(pred) + " not supported");
    }
  }

  // Samples as libtiff hands them back: native (little-endian) order.
  void to_native(uint8_t* p, size_t n) const {
    if (le_ || lt_.comp == 7) return;
    const uint64_t bps = lt_.bps;
    if (predicts() && lt_.predictor == 3) return;  // the floating-point predictor writes native order
    if (bps == 16)
      for (size_t i = 0; i + 1 < n; i += 2) std::swap(p[i], p[i + 1]);
    else if (bps == 32)
      for (size_t i = 0; i + 3 < n; i += 4) {
        std::swap(p[i], p[i + 3]);
        std::swap(p[i + 1], p[i + 2]);
      }
    else if (bps == 64)
      for (size_t i = 0; i + 7 < n; i += 8)
        for (int k = 0; k < 4; ++k) std::swap(p[i + k], p[i + 7 - k]);
  }

  void load_libtiff() {
    libtiff_dir();
    // TiffDecode.c: libtiff's YCbCr goes through TIFFRGBAImage unless it is JPEG in one plane
    if (lt_.photometric == 6 && !(lt_.comp == 7 && lt_.planar == 1)) {
      load_rgba();
      return;
    }
    const int bps = static_cast<int>(lt_.bps);
    const int bands = pixel_size(mode_) < 4 || mode_ == MI || mode_ == MF ? 1
                      : (mode_ == MLA || mode_ == MPA)                    ? 2
                      : (mode_ == MRGB || mode_ == MLAB)                  ? 3
                                                                          : 4;
    const int planes = (lt_.planar == 2 && bands > 1) ? bands : 1;
    if (planes > 1 && bps != 8 && bps != 16) corrupt("TIFF planes of other than 8 or 16 bits");
    Unpacker u = find_unpacker(mode_, rawmode_);
    if (!u.fn) refused("TIFF rawmode " + rawmode_ + " for this image mode");
    const bool tiled = lt_.tiled;
    const size_t samples = lt_.planar == 2 ? 1 : static_cast<size_t>(lt_.spp);
    const int ycc = lt_.photometric == 6 && lt_.comp == 7 && lt_.planar == 1;  // JPEGCOLORMODE_RGB: upsampled rows
    auto rowsize_of = [&](uint64_t width) -> size_t {
      if (ycc) return static_cast<size_t>(width) * 3;
      return static_cast<size_t>((width * samples * lt_.bps + 7) / 8);
    };
    const uint64_t unpack_row = (static_cast<uint64_t>(xsize_) * u.bits / planes + 7) / 8;
    if (tiled) {
      const uint64_t tw = lt_.tw, tl = lt_.tl;
      if (tw > 0x7FFFFFFF || tl > 0x7FFFFFFF) corrupt("TIFF tile size");
      const size_t rowsize = rowsize_of(tw);
      if (rowsize != (tw * u.bits / planes + 7) / 8) corrupt("TIFF tile rows of another size than the unpacker's");
      const size_t across = static_cast<size_t>((static_cast<uint64_t>(xsize_) + tw - 1) / tw);
      const size_t down = static_cast<size_t>((static_cast<uint64_t>(ysize_) + tl - 1) / tl);
      std::vector<uint8_t> buf(rowsize * tl);
      for (size_t ty = 0; ty < down; ++ty)
        for (int plane = 0; plane < planes; ++plane) {
          UnpackFn fn = planes > 1 ? plane_unpacker(plane, bps == 16, mode_ == MLAB) : u.fn;
          for (size_t tx = 0; tx < across; ++tx) {
            const size_t idx = (static_cast<size_t>(plane) * down + ty) * across + tx;
            read_chunk(idx, buf.data(), buf.size(), rowsize, static_cast<int>(tw), static_cast<int>(tl), false);
            const int64_t x = static_cast<int64_t>(tx * tw), y = static_cast<int64_t>(ty * tl);
            const int64_t cw = std::min<int64_t>(static_cast<int64_t>(tw), xsize_ - x);
            const int64_t cl = std::min<int64_t>(static_cast<int64_t>(tl), ysize_ - y);
            for (int64_t r = 0; r < cl; ++r)
              fn(img_.data() + (static_cast<size_t>(y + r) * xsize_ + x) * ps_, buf.data() + r * rowsize,
                 static_cast<int>(cw));
          }
        }
      return;
    }
    const uint64_t rps = lt_.rps == 0xFFFFFFFFu ? static_cast<uint64_t>(ysize_) : lt_.rps;
    const size_t rowsize = rowsize_of(static_cast<uint64_t>(xsize_));
    if (rowsize != unpack_row) corrupt("TIFF rows of another size than the unpacker's");
    const size_t per_plane = static_cast<size_t>((static_cast<uint64_t>(ysize_) + rps - 1) / rps);
    const uint64_t rows_cap = std::min<uint64_t>(rps, static_cast<uint64_t>(ysize_));
    std::vector<uint8_t> buf(rowsize * rows_cap);
    for (int64_t y = 0; y < ysize_; y += static_cast<int64_t>(rps))
      for (int plane = 0; plane < planes; ++plane) {
        UnpackFn fn = planes > 1 ? plane_unpacker(plane, bps == 16, mode_ == MLAB) : u.fn;
        const size_t idx = static_cast<size_t>(y / static_cast<int64_t>(rps)) + static_cast<size_t>(plane) * per_plane;
        const int64_t rows = std::min<int64_t>(static_cast<int64_t>(rps), ysize_ - y);
        read_chunk(idx, buf.data(), rowsize * static_cast<size_t>(rows), rowsize, static_cast<int>(xsize_),
                   static_cast<int>(rows), y + rows == ysize_);
        for (int64_t r = 0; r < rows; ++r)
          fn(img_.data() + static_cast<size_t>(y + r) * xsize_ * ps_, buf.data() + r * rowsize,
             static_cast<int>(xsize_));
      }
    if (planes > 3 && mode_ == MRGBA && !lt_.extra.empty() && (lt_.extra[0] == 0 || lt_.extra[0] == 1))
      for (size_t i = 0; i < static_cast<size_t>(xsize_ * ysize_); ++i) unpremultiply(img_.data() + 4 * i);
  }

  // One strip or tile through its codec into `buf` (occ bytes, rows of `rowsize`).
  void read_chunk(size_t idx, uint8_t* buf, size_t occ, size_t rowsize, int width, int rows, bool last) {
    const std::vector<uint8_t> raw = chunk(idx);
    if (lt_.comp == 7) {
      jpeg_chunk(raw, buf, rowsize, width, rows, last);
      return;
    }
    const int stride = lt_.planar == 2 ? 1 : static_cast<int>(lt_.spp);
    decode_chunk(raw, buf, occ, rowsize, width, idx);
    to_native(buf, occ);
    predictor(buf, occ, rowsize, stride);
  }

  void jpeg_chunk(const std::vector<uint8_t>& raw, uint8_t* buf, size_t rowsize, int width, int rows, bool last) {
    if (!jpeg_) corrupt("no JPEG decoder for JPEG-compressed TIFF");
    if (lt_.bps != 8) corrupt("improper JPEG data precision in TIFF");
    const std::vector<uint8_t>& tables = lt_.tables;
    const bool ycc = lt_.photometric == 6 && lt_.planar == 1;
    int hs = 1, vs = 1;
    if (lt_.photometric == 6) {
      hs = lt_.sub.size() >= 1 ? static_cast<int>(lt_.sub[0]) : 2;
      vs = lt_.sub.size() >= 2 ? static_cast<int>(lt_.sub[1]) : 2;
    }
    const int nc = lt_.planar == 1 ? static_cast<int>(lt_.spp) : 1;
    char err[256] = {0};
    const int rc = jpeg_(tables.data(), static_cast<int64_t>(tables.size()), raw.data(),
                         static_cast<int64_t>(raw.size()), ycc ? 1 : 0, hs, vs, nc, width, rows, last ? 1 : 0, buf,
                         static_cast<int64_t>(rowsize), err, sizeof(err));
    if (rc != 0) corrupt(std::string("JPEG in TIFF: ") + err);
  }

  // One strip or tile for TIFFRGBAImage (tif_getimage.c runs it with
  // stoponerr 0): false, and the segment zeroed (TIFFReadEncodedTile), when
  // its data is not in the file; a decoding fault keeps what was decoded up
  // to it (no predictor; a JPEG fault zeroes it).
  bool rgba_segment(size_t idx, uint8_t* op, size_t occ, size_t rowsize, int width, int rows, bool last) {
    if (lt_.comp == 6) {  // TIFF_NOREADRAW: tif_ojpeg.c reads the file itself
      oj_segment(idx, op, occ);
      return true;
    }
    std::vector<uint8_t> raw;
    try {
      raw = chunk(idx);
    } catch (const Fail&) {
      memset(op, 0, occ);
      return false;
    }
    if (lt_.comp == 7) {
      try {
        jpeg_chunk(raw, op, rowsize, width, rows, last);
      } catch (const Fail&) {
        memset(op, 0, occ);
      }
    } else if (decode_codec(raw, op, occ, rowsize, width, lt_.offs[idx]) && occ % rowsize == 0) {
      predictor(op, occ, rowsize, lt_.planar == 2 ? 1 : 3);
    }
    return true;
  }

  // ------------------------------------------------- old-style JPEG ----
  //
  // tif_ojpeg.c as libtiff 4.7 runs it under TIFFRGBAImage: the JPEG stream
  // it rebuilds (SOI, the tables, DRI, SOF, SOS, then the scan's data with a
  // restart marker between strips, EOI) from JPEGInterchangeFormat's
  // segments, or from those that open the first strip, or from the
  // JPEGQTables / DCTables / ACTables tags around the strips; the sampling
  // read back from the JPEG's frame (OJPEGSubsamplingCorrect); each strip's
  // data units written from libjpeg's raw component rows (OJPEGDecodeRaw).

  // The bytes tif_ojpeg.c reads in turn (OJPEGReadBufferFill):
  // JPEGInterchangeFormat's, then each strip's (a strip past the file
  // skipped, a byte count of 0 read to the end of the file).
  struct OjRegion {
    uint64_t pos, len;
    int64_t strip;  // -1: JPEGInterchangeFormat
  };
  struct OjCursor {
    const std::vector<OjRegion>* r;
    const uint8_t* d;
    size_t i = 0;
    uint64_t at = 0;
    bool peek(uint8_t& v) {
      while (i < r->size() && at >= (*r)[i].len) {
        ++i;
        at = 0;
      }
      if (i >= r->size()) return false;
      v = d[(*r)[i].pos + at];
      return true;
    }
    bool byte(uint8_t& v) {
      if (!peek(v)) return false;
      ++at;
      return true;
    }
    bool word(uint16_t& v) {
      uint8_t a, b;
      if (!byte(a) || !byte(b)) return false;
      v = static_cast<uint16_t>((a << 8) | b);
      return true;
    }
    void skip(uint64_t k) {  // OJPEGReadSkip: as far as the data goes
      uint8_t v;
      for (; k > 0 && peek(v); --k) ++at;
    }
  };

  std::vector<OjRegion> oj_regions() const {
    std::vector<OjRegion> r;
    const uint64_t size = n_;
    uint64_t jif = lt_.jif, jlen = lt_.jif_len;
    if (jif != 0) {
      if (jif >= size) {
        jif = 0;
      } else if (jlen == 0 || jif > UINT64_MAX - jlen || jif + jlen > size) {
        jlen = size - jif;
      }
    }
    if (jif != 0) r.push_back({jif, jlen, -1});
    if (!lt_.has_counts) return r;  // TIFFGetStrileByteCountWithErr fails: so does the first strip's read
    for (size_t k = 0; k < lt_.offs.size(); ++k) {
      uint64_t pos = lt_.offs[k], cnt = k < lt_.counts.size() ? lt_.counts[k] : 0;
      if (pos == 0 || pos >= size) continue;
      if (cnt == 0 || pos > UINT64_MAX - cnt || pos + cnt > size) cnt = size - pos;
      r.push_back({pos, cnt, static_cast<int64_t>(k)});
    }
    return r;
  }

  struct Oj {
    int hs = 2, vs = 2;  // the sampling TIFFRGBAImage reads by
    int fatal_strip = -1;  // the strip whose raw read fails (left zero)
    int64_t units_w = 0, unit_rows = 0;
    std::vector<uint8_t> units;  // every unit row of the image
  } oj_;

  // OJPEGSubsamplingCorrect: the sampling of the JPEG's first frame
  // component (silently kept as it was when the frame cannot be read), 1 x 1
  // when it is not 1, 2 or 4 each way or another component is not 1 x 1.
  bool oj_sampling(int& hs, int& vs) const {
    hs = lt_.has_sub ? static_cast<int>(lt_.sub[0] & 0xFF) : 2;
    vs = lt_.has_sub ? static_cast<int>(lt_.sub[1] & 0xFF) : 2;
    if (lt_.spp != 3 || (lt_.photometric != 6 && lt_.photometric != 10)) {
      hs = vs = 1;
      return false;
    }
    const std::vector<OjRegion> regions = oj_regions();
    OjCursor c{&regions, d_};
    bool force = false;
    for (;;) {
      uint8_t m;
      if (!c.peek(m) || m != 255) break;
      c.byte(m);
      do {
        if (!c.byte(m)) goto done;
      } while (m == 255);
      if (m == 0xD8) continue;
      if (m == 0xFE || (m >= 0xE0 && m <= 0xEF) || m == 0xDD || m == 0xDB || m == 0xC4) {
        uint16_t n;
        if (!c.word(n)) goto done;
        if (m == 0xDD) {
          if (n != 4) goto done;
          c.skip(2);
        } else {
          if (n < 2 || (n == 2 && m != 0xFE && (m < 0xE0 || m > 0xEF))) goto done;
          c.skip(n - 2u);
        }
        continue;
      }
      if (m == 0xC0 || m == 0xC1 || m == 0xC3) {  // OJPEGReadHeaderInfoSecStreamSof
        uint16_t len;
        uint8_t o;
        if (!c.word(len) || len < 11 || (len - 8) % 3) goto done;
        const int n = (len - 8) / 3;
        if (!c.byte(o) || o != 8) goto done;
        c.skip(4);
        if (!c.byte(o) || o != n) goto done;
        for (int q = 0; q < n; ++q) {
          if (!c.byte(o) || !c.byte(o)) goto done;
          if (q == 0) {
            hs = o >> 4;
            vs = o & 15;
            if ((hs != 1 && hs != 2 && hs != 4) || (vs != 1 && vs != 2 && vs != 4)) force = true;
          } else if (o != 17) {
            force = true;
          }
          if (!c.byte(o)) goto done;
        }
      }
      break;  // a frame, a scan or another marker ends the search
    }
  done:
    if (force) hs = vs = 1;
    return force;
  }

  // OJPEGReadHeaderInfo / OJPEGReadHeaderInfoSec / OJPEGWriteStream: the
  // stream libjpeg reads.
  std::vector<uint8_t> oj_stream(int hs, int vs, bool& premature) const {
    const uint64_t W = lt_.width, H = lt_.length;
    const uint64_t rps = lt_.rps == 0xFFFFFFFFu ? H : lt_.rps;
    int restart = lt_.has_restart ? static_cast<int>(lt_.restart) : 0;
    if (rps < H) {
      if ((hs != 1 && hs != 2 && hs != 4) || (vs != 1 && vs != 2 && vs != 4))
        corrupt("old-style JPEG: invalid subsampling values");
      if (rps % static_cast<uint64_t>(vs * 8)) corrupt("old-style JPEG: strips not a multiple of the MCU height");
      restart = static_cast<int>(static_cast<uint16_t>(((W + hs * 8 - 1) / (hs * 8)) * (rps / (vs * 8))));
    }
    const std::vector<OjRegion> regions = oj_regions();
    OjCursor c{&regions, d_};
    std::vector<std::vector<uint8_t>> qt(4), dct(4), act(4);
    bool sof = false, sos = false;
    int sof_marker = 0xC0;
    uint16_t sof_x = 0, sof_y = 0;
    uint8_t sof_c[3] = {0, 0, 0}, sof_hv[3] = {0, 0, 0}, sof_tq[3] = {0, 0, 0}, sos_cs[3] = {0, 0, 0},
            sos_tda[3] = {0, 0, 0};
    auto fail = [](const char* what) { corrupt(std::string("old-style JPEG: ") + what); };
    auto need = [&](bool ok) {
      if (!ok) fail("JPEG data cut short");
    };
    for (;;) {
      uint8_t m;
      need(c.peek(m));
      if (m != 255) break;
      c.byte(m);
      do need(c.byte(m)); while (m == 255);
      if (m == 0xD8) continue;
      if (m == 0xFE || (m >= 0xE0 && m <= 0xEF)) {
        uint16_t n;
        need(c.word(n));
        if (n < 2) fail("corrupt JPEG data");
        if (n > 2) c.skip(n - 2u);
      } else if (m == 0xDD) {
        uint16_t n, v;
        need(c.word(n));
        if (n != 4) fail("corrupt DRI marker");
        need(c.word(v));
        restart = v;
      } else if (m == 0xDB) {  // each table kept whole (8-bit, 65 bytes)
        uint16_t n;
        need(c.word(n));
        if (n <= 2) fail("corrupt DQT marker");
        n -= 2;
        do {
          if (n < 65) fail("corrupt DQT marker");
          std::vector<uint8_t> t = {0xFF, 0xDB, 0, 67};
          for (int i = 0; i < 65; ++i) {
            uint8_t b;
            need(c.byte(b));
            t.push_back(b);
          }
          if ((t[4] & 15) > 3) fail("corrupt DQT marker");
          qt[t[4] & 15] = t;
          n -= 65;
        } while (n > 0);
      } else if (m == 0xC4) {  // the segment kept whole under its first table's class and id
        uint16_t n;
        need(c.word(n));
        if (n <= 2) fail("corrupt DHT marker");
        std::vector<uint8_t> t = {0xFF, 0xC4, static_cast<uint8_t>(n >> 8), static_cast<uint8_t>(n & 255)};
        for (int i = 0; i < n - 2; ++i) {
          uint8_t b;
          need(c.byte(b));
          t.push_back(b);
        }
        const uint8_t o = t[4];
        if ((o & 240) == 0) {
          if (o > 3) fail("corrupt DHT marker");
          dct[o] = t;
        } else {
          if ((o & 240) != 16 || (o & 15) > 3) fail("corrupt DHT marker");
          act[o & 15] = t;
        }
      } else if (m == 0xC0 || m == 0xC1 || m == 0xC3) {  // OJPEGReadHeaderInfoSecStreamSof
        if (sof) fail("corrupt JPEG data");
        sof_marker = m;
        uint16_t len, p;
        uint8_t o;
        need(c.word(len));
        if (len < 11 || (len - 8) % 3) fail("corrupt SOF marker");
        const int n = (len - 8) / 3;
        if (n != 3) fail("JPEG data of an unexpected number of samples");
        need(c.byte(o));
        if (o != 8) fail("JPEG data of an unexpected number of bits a sample");
        need(c.word(p));
        if (p < H && p < H) fail("JPEG data of an unexpected height");
        sof_y = p;
        need(c.word(p));
        if (p < W) fail("JPEG data of an unexpected width");
        if (p > W) fail("JPEG data wider than the image");
        sof_x = p;
        need(c.byte(o));
        if (o != n) fail("corrupt SOF marker");
        for (int q = 0; q < n; ++q) {
          need(c.byte(sof_c[q]));
          need(c.byte(sof_hv[q]));
          if (sof_hv[q] != (q == 0 ? ((hs << 4) | vs) : 17)) fail("JPEG data of unexpected sampling");
          need(c.byte(sof_tq[q]));
        }
        sof = true;
      } else if (m == 0xDA) {  // OJPEGReadHeaderInfoSecStreamSos
        if (!sof) fail("corrupt SOS marker");
        uint16_t len;
        uint8_t n;
        need(c.word(len));
        if (len != 12) fail("corrupt SOS marker");
        need(c.byte(n));
        if (n != 3) fail("corrupt SOS marker");
        for (int o = 0; o < 3; ++o) {
          need(c.byte(sos_cs[o]));
          need(c.byte(sos_tda[o]));
        }
        c.skip(3);
        sos = true;
        break;
      } else {
        fail("unknown marker type in the JPEG data");
      }
    }
    if (!sof) {  // the tables from the tags, the frame from the image
      auto table_at = [](const std::vector<uint64_t>& offs, int k) {
        return k < static_cast<int>(offs.size()) ? offs[static_cast<size_t>(k)] : 0;
      };
      auto read_at = [&](uint64_t off, size_t k, std::vector<uint8_t>& out) {
        if (off > n_ || k > n_ - off) return false;
        out.insert(out.end(), d_ + off, d_ + off + k);
        return true;
      };
      const std::vector<uint64_t>* lists[3] = {&lt_.qt, &lt_.dct, &lt_.act};
      for (int kind = 0; kind < 3; ++kind) {
        if (table_at(*lists[kind], 0) == 0) fail("missing JPEG tables");
        for (int m = 0; m < 3; ++m) {
          const uint64_t off = table_at(*lists[kind], m);
          if (off != 0 && (m == 0 || off != table_at(*lists[kind], m - 1))) {
            for (int k = 0; k < m - 1; ++k)
              if (off == table_at(*lists[kind], k)) fail("corrupt JPEG tables tag value");
            if (kind == 0) {
              std::vector<uint8_t> t = {0xFF, 0xDB, 0, 67, static_cast<uint8_t>(m)};
              if (!read_at(off, 64, t)) fail("JPEG quantization table past the file");
              qt[m] = t;
              sof_tq[m] = static_cast<uint8_t>(m);
            } else {
              std::vector<uint8_t> counts;
              if (!read_at(off, 16, counts)) fail("JPEG Huffman table past the file");
              uint32_t q = 0;
              for (uint8_t b : counts) q += b;
              std::vector<uint8_t> t = {0xFF, 0xC4, static_cast<uint8_t>((19 + q) >> 8),
                                        static_cast<uint8_t>((19 + q) & 255),
                                        static_cast<uint8_t>(kind == 1 ? m : 16 | m)};
              t.insert(t.end(), counts.begin(), counts.end());
              if (!read_at(off + 16, q, t)) fail("JPEG Huffman table past the file");
              (kind == 1 ? dct : act)[m] = t;
              if (kind == 1)
                sos_tda[m] = static_cast<uint8_t>(m << 4);
              else
                sos_tda[m] = static_cast<uint8_t>(sos_tda[m] | m);
            }
          } else if (m > 0) {
            if (kind == 0) sof_tq[m] = sof_tq[m - 1];
            else sos_tda[m] = sos_tda[m - 1];
          }
        }
      }
      sof_marker = 0xC0;
      for (int o = 0; o < 3; ++o) sof_c[o] = static_cast<uint8_t>(o);
      sof_hv[0] = static_cast<uint8_t>((hs << 4) | vs);
      sof_hv[1] = sof_hv[2] = 17;
      sof_x = static_cast<uint16_t>(W);
      sof_y = static_cast<uint16_t>(H);
      for (int o = 1; o < 3; ++o) sos_cs[o] = static_cast<uint8_t>(o);
    }
    std::vector<uint8_t> out = {0xFF, 0xD8};
    for (const auto& t : qt) out.insert(out.end(), t.begin(), t.end());
    for (const auto& t : dct) out.insert(out.end(), t.begin(), t.end());
    for (const auto& t : act) out.insert(out.end(), t.begin(), t.end());
    if (restart)
      out.insert(out.end(),
                 {0xFF, 0xDD, 0, 4, static_cast<uint8_t>(restart >> 8), static_cast<uint8_t>(restart & 255)});
    out.insert(out.end(), {0xFF, static_cast<uint8_t>(sof_marker), 0, 17, 8, static_cast<uint8_t>(sof_y >> 8),
                           static_cast<uint8_t>(sof_y & 255), static_cast<uint8_t>(sof_x >> 8),
                           static_cast<uint8_t>(sof_x & 255), 3});
    for (int o = 0; o < 3; ++o) out.insert(out.end(), {sof_c[o], sof_hv[o], sof_tq[o]});
    out.insert(out.end(), {0xFF, 0xDA, 0, 12, 3});
    for (int o = 0; o < 3; ++o) out.insert(out.end(), {sos_cs[o], sos_tda[o]});
    out.insert(out.end(), {0, 63, 0});
    // the scan's data: the rest of the region the header ended in, then the
    // later ones, a restart marker after each strip but the last, then EOI
    // (EOIs on) once the last strip was read; when that strip is not read
    // (past the file, or its byte counts missing), libtiff's source fails there
    int rst = 0;
    const int64_t last = static_cast<int64_t>(lt_.offs.size()) - 1;
    if (!sos) {
      c.i = 0;
      c.at = 0;
    }
    premature = true;  // EOI only after the last strip's data
    for (size_t i = c.i; i < regions.size(); ++i) {
      const OjRegion& r = regions[i];
      const uint64_t from = i == c.i ? c.at : 0;
      if (from < r.len) out.insert(out.end(), d_ + r.pos + from, d_ + r.pos + r.len);
      if (r.strip >= 0 && r.strip < last) {
        out.push_back(0xFF);
        out.push_back(static_cast<uint8_t>(0xD0 + rst));
        rst = (rst + 1) & 7;
      }
      premature = r.strip != last;
    }
    if (!premature)
      for (int i = 0; i < 4; ++i) out.insert(out.end(), {0xFF, 0xD9});
    return out;
  }

  // The image's data units (OJPEGDecodeRaw over every strip): libjpeg's
  // raw rows of the rebuilt stream, checked as OJPEGWriteHeaderInfo checks
  // them, hs x vs luma samples then Cb and Cr a unit.
  void oj_prepare() {
    if (!ojpeg_) corrupt("no JPEG decoder for old-style JPEG");
    if (lt_.tiled || lt_.planar != 1)
      throw Fail{RF_REFUSED, "old-style JPEG in tiles or planes is not read by the port"};
    int hs, vs;
    if (oj_sampling(hs, vs))
      throw Fail{RF_REFUSED, "old-style JPEG in a sampling libjpeg upsamples itself is not read by the port"};
    oj_.hs = hs;
    oj_.vs = vs;
    bool premature = false;
    const std::vector<uint8_t> stream = oj_stream(hs, vs, premature);
    int32_t dims[3 + 4 * 4 + 1];
    char err[256] = {0};
    int rc = ojpeg_(stream.data(), static_cast<int64_t>(stream.size()), premature, nullptr, 0, dims, err, sizeof(err));
    if (rc != RF_NEED_BUFFER) corrupt(std::string("old-style JPEG: ") + err);
    const int nc = dims[2];
    if (nc != 3) corrupt("old-style JPEG of other than 3 components");
    if (static_cast<uint64_t>(dims[0]) != lt_.width) corrupt("old-style JPEG: libjpeg's width is not the strip's");
    int max_h = 1, max_v = 1;
    size_t total = 0;
    for (int i = 0; i < nc; ++i) {
      max_h = std::max(max_h, dims[3 + 4 * i]);
      max_v = std::max(max_v, dims[4 + 4 * i]);
      total += static_cast<size_t>(dims[5 + 4 * i]) * static_cast<size_t>(dims[6 + 4 * i]);
    }
    if (max_h != hs || max_v != vs) corrupt("old-style JPEG: libjpeg's sampling is not the TIFF's");
    std::vector<uint8_t> planes(total);
    rc = ojpeg_(stream.data(), static_cast<int64_t>(stream.size()), premature, planes.data(),
                static_cast<int64_t>(total), dims, err, sizeof(err));
    if (rc != RF_OK) corrupt(std::string("old-style JPEG: ") + err);
    const int fatal_mcu_row = dims[3 + 4 * nc];
    const uint8_t* y = planes.data();
    const size_t yw = static_cast<size_t>(dims[5]);
    const uint8_t* cb = y + yw * static_cast<size_t>(dims[6]);
    const size_t cw = static_cast<size_t>(dims[9]);
    const uint8_t* cr = cb + cw * static_cast<size_t>(dims[10]);
    const int64_t W = xsize_, H = ysize_;
    oj_.units_w = (W + hs - 1) / hs;
    oj_.unit_rows = (H + vs - 1) / vs;
    const size_t unit = static_cast<size_t>(hs * vs + 2);
    if (oj_.units_w * hs > dims[5] || oj_.unit_rows * vs > dims[6] || oj_.units_w > dims[9] || oj_.unit_rows > dims[10])
      corrupt("old-style JPEG smaller than the image");
    oj_.units.assign(static_cast<size_t>(oj_.units_w * oj_.unit_rows) * unit, 0);
    // a fatal error leaves the whole strip whose raw read meets it zero (as
    // PIL's decodes show), and the strips after it fail
    int64_t rows_ok = oj_.unit_rows;
    if (fatal_mcu_row >= 0) {
      const uint64_t rps = lt_.rps == 0xFFFFFFFFu ? static_cast<uint64_t>(H) : lt_.rps;
      const int64_t lines = static_cast<int64_t>((std::min<uint64_t>(rps, static_cast<uint64_t>(H)) + vs - 1) / vs);
      oj_.fatal_strip = static_cast<int>(static_cast<int64_t>(fatal_mcu_row) * 8 / lines);
      rows_ok = std::min<int64_t>(rows_ok, oj_.fatal_strip * lines);
    }
    for (int64_t u = 0; u < rows_ok; ++u) {
      uint8_t* p = oj_.units.data() + static_cast<size_t>(u * oj_.units_w) * unit;
      for (int64_t q = 0; q < oj_.units_w; ++q) {
        for (int sy = 0; sy < vs; ++sy)
          for (int sx = 0; sx < hs; ++sx)
            *p++ = y[static_cast<size_t>(u * vs + sy) * yw + static_cast<size_t>(q * hs + sx)];
        *p++ = cb[static_cast<size_t>(u) * cw + static_cast<size_t>(q)];
        *p++ = cr[static_cast<size_t>(u) * cw + static_cast<size_t>(q)];
      }
    }
  }

  // One strip's units from the image's; a strip after the one whose raw read
  // failed fails too (libtiff retries libjpeg there and meets the error again).
  void oj_segment(size_t idx, uint8_t* op, size_t occ) const {
    if (oj_.fatal_strip >= 0 && static_cast<int>(idx) > oj_.fatal_strip)
      corrupt("old-style JPEG: a restart marker out of place");
    const uint64_t rps = lt_.rps == 0xFFFFFFFFu ? static_cast<uint64_t>(ysize_) : lt_.rps;
    const size_t row = static_cast<size_t>(oj_.units_w) * static_cast<size_t>(oj_.hs * oj_.vs + 2);
    const size_t first = static_cast<size_t>(idx) * static_cast<size_t>((rps + oj_.vs - 1) / oj_.vs);
    const size_t from = first * row;
    if (from >= oj_.units.size()) return;
    memcpy(op, oj_.units.data() + from, std::min(occ, oj_.units.size() - from));
  }

  // TiffDecode.c _decodeAsRGBA: YCbCr read by TIFFRGBAImage (top-left
  // first, whatever the Orientation), one TIFFRGBAImageGet call per
  // RowsPerStrip (or TileLength) rows: gtStripContig / gtTileContig with
  // the putcontig8bitYCbCr*tile functions (hs x vs luma samples then Cb and
  // Cr a data unit; 4x4, 4x2, 4x1, 2x2, 2x1, 1x2, 1x1), gtStripSeparate /
  // gtTileSeparate with putseparate8bitYCbCr11tile (1x1 only). Each call
  // allocates its zeroed buffer at its first segment whose data is in the
  // file (none: the read fails) and keeps it for the call's later segments.
  void load_rgba() {
    if (lt_.bps != 8 || lt_.spp != 3) corrupt("TIFFRGBAImage cannot handle this YCbCr format");
    const std::vector<uint64_t>& sub = lt_.sub;
    if (lt_.comp == 6) oj_prepare();
    const int hs = lt_.comp == 6 ? oj_.hs : (sub.size() >= 1 ? static_cast<int>(sub[0] & 0xFFFF) : 2);
    const int vs = lt_.comp == 6 ? oj_.vs : (sub.size() >= 2 ? static_cast<int>(sub[1] & 0xFFFF) : 2);
    const int code = (hs << 4) | vs;
    const bool separate = lt_.planar == 2;
    if (separate ? code != 0x11
                 : (code != 0x44 && code != 0x42 && code != 0x41 && code != 0x22 && code != 0x21 && code != 0x12 &&
                    code != 0x11))
      corrupt("TIFFRGBAImage cannot handle this YCbCr subsampling");
    const YccTables ycc = ycc_tables();
    const int64_t W = xsize_, H = ysize_;
    const int uh = separate ? 1 : hs, uv = separate ? 1 : vs;  // the data unit
    const size_t block = separate ? 1 : static_cast<size_t>(hs * vs + 2);
    // TIFFRGBAImage's RGBA rows, which TiffDecode.c hands to the rawmode's unpacker
    // (RGBX for Pillow's YCbCr keys; another mode's reads them as its bytes)
    Unpacker u = find_unpacker(mode_, rawmode_);
    if (!u.fn) refused("TIFF rawmode " + rawmode_ + " for this image mode");
    std::vector<uint8_t> rgba(static_cast<size_t>(W * H) * 4 + static_cast<size_t>(W) * 8, 0);
    auto put = [&](const uint8_t* y, const uint8_t* cb, const uint8_t* cr, int64_t x, int64_t row) {
      uint8_t* o = rgba.data() + (static_cast<size_t>(row) * W + x) * 4;
      ycc.convert(*y, *cb, *cr, o);
      o[3] = 255;
    };

    // The data units of a segment `sw` pixels wide at image (x0, y0), `cols` x
    // `rows` of them shown. After a row of units the put functions skip the
    // hidden ones by (hidden pixels / uh) units of their own size, except
    // putcontig8bitYCbCr44tile, which skips 10-byte units (4x2's).
    auto put_segment = [&](const uint8_t* data, size_t plane, int64_t sw, int64_t x0, int64_t y0, int64_t cols,
                           int64_t rows) {
      const int64_t nbx = (cols + uh - 1) / uh;
      const size_t skip_unit = code == 0x44 ? 10 : block;
      size_t rowbase = 0;
      for (int64_t by = 0; by * uv < rows; ++by) {
        for (int64_t bx = 0; bx < nbx; ++bx) {
          for (int j = 0; j < uv; ++j)
            for (int i = 0; i < uh; ++i) {
              const int64_t px = bx * uh + i, py = by * uv + j;
              if (px >= cols || py >= rows) continue;
              if (separate) {
                const uint8_t* p = data + static_cast<size_t>(py * sw + px);
                put(p, p + plane, p + 2 * plane, x0 + px, y0 + py);
              } else {
                const uint8_t* b = data + rowbase + static_cast<size_t>(bx) * block;
                put(b + j * uh + i, b + uh * uv, b + uh * uv + 1, x0 + px, y0 + py);
              }
            }
        }
        rowbase += static_cast<size_t>(nbx) * block + static_cast<size_t>((sw - cols) / uh) * skip_unit;
      }
    };
    if (!lt_.tiled) {
      const uint64_t rps = lt_.rps == 0xFFFFFFFFu ? static_cast<uint64_t>(H) : lt_.rps;
      const int64_t bw = (W + uh - 1) / uh;
      const size_t blockrow = static_cast<size_t>(bw) * block;  // a row of data units
      const size_t scanline = blockrow / static_cast<size_t>(uv);
      const size_t per_plane = static_cast<size_t>((static_cast<uint64_t>(H) + rps - 1) / rps);
      const size_t strip_max =
          blockrow * static_cast<size_t>((std::min<int64_t>(static_cast<int64_t>(rps), H) + uv - 1) / uv);
      for (int64_t y = 0; y < H; y += static_cast<int64_t>(rps)) {
        const int64_t rows = std::min<int64_t>(static_cast<int64_t>(rps), H - y);
        const size_t occ = static_cast<size_t>((rows + uv - 1) / uv) * blockrow;
        const size_t strip = static_cast<size_t>(y / static_cast<int64_t>(rps));
        const bool last = y + rows == H;
        std::vector<uint8_t> data((separate ? 3 : 1) * strip_max, 0);
        if (!rgba_segment(strip, data.data(), occ, scanline, static_cast<int>(W), static_cast<int>(rows), last))
          corrupt("TIFF strip past the end of the file (TIFFRGBAImage)");
        if (separate)
          for (size_t plane = 1; plane < 3; ++plane)
            rgba_segment(strip + plane * per_plane, data.data() + plane * strip_max, occ, scanline, static_cast<int>(W),
                         static_cast<int>(rows), last);
        put_segment(data.data(), strip_max, W, 0, y, W, rows);
      }
      unpack_rows(u, rgba);
      return;
    }
    const int64_t tw = static_cast<int64_t>(lt_.tw), tl = static_cast<int64_t>(lt_.tl);
    const int64_t across = (W + tw - 1) / tw, down = (H + tl - 1) / tl;
    const size_t tile = static_cast<size_t>((tw + uh - 1) / uh) * static_cast<size_t>((tl + uv - 1) / uv) * block;
    const size_t scanline = static_cast<size_t>((tw + uh - 1) / uh) * block / static_cast<size_t>(uv);
    for (int64_t ty = 0; ty < down; ++ty) {
      std::vector<uint8_t> data;
      const int64_t rows = std::min<int64_t>(tl, H - ty * tl);
      for (int64_t tx = 0; tx < across; ++tx) {
        const size_t idx = static_cast<size_t>(ty * across + tx);
        const bool first = data.empty();
        if (first) data.assign((separate ? 3 : 1) * tile, 0);
        if (!rgba_segment(idx, data.data(), tile, scanline, static_cast<int>(tw), static_cast<int>(tl), false) && first)
          corrupt("TIFF tile past the end of the file (TIFFRGBAImage)");
        if (separate)
          for (size_t plane = 1; plane < 3; ++plane)
            rgba_segment(idx + plane * static_cast<size_t>(across * down), data.data() + plane * tile, tile, scanline,
                         static_cast<int>(tw), static_cast<int>(tl), false);
        put_segment(data.data(), tile, tw, tx * tw, ty * tl, std::min<int64_t>(tw, W - tx * tw), rows);
      }
    }
    unpack_rows(u, rgba);
  }

  void unpack_rows(const Unpacker& u, const std::vector<uint8_t>& rgba) {
    for (int64_t r = 0; r < ysize_; ++r)
      u.fn(img_.data() + static_cast<size_t>(r) * xsize_ * ps_, rgba.data() + static_cast<size_t>(r) * xsize_ * 4,
           static_cast<int>(xsize_));
  }

  // tif_color.c TIFFYCbCrToRGBInit / TIFFYCbCrtoRGB.
  struct YccTables {
    int32_t cr_r[256], cb_b[256], cr_g[256], cb_g[256], y[256];
    void convert(int Y, int Cb, int Cr, uint8_t* o) const {
      auto clamp = [](int32_t v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
      o[0] = clamp(y[Y] + cr_r[Cr]);
      o[1] = clamp(y[Y] + static_cast<int32_t>((cb_g[Cb] + cr_g[Cr]) >> 16));
      o[2] = clamp(y[Y] + cb_b[Cb]);
    }
  };

  YccTables ycc_tables() const {
    // libtiff's values as floats; a tag of too few values keeps the default
    std::vector<float> luma = {0.299f, 0.587f, 0.114f}, rbw = {0.0f, 255.0f, 128.0f, 255.0f, 128.0f, 255.0f};
    if (lt_.luma.size() >= 3)
      for (int i = 0; i < 3; ++i) luma[static_cast<size_t>(i)] = static_cast<float>(lt_.luma[static_cast<size_t>(i)]);
    if (lt_.rbw.size() >= 6)
      for (int i = 0; i < 6; ++i) rbw[static_cast<size_t>(i)] = static_cast<float>(lt_.rbw[static_cast<size_t>(i)]);
    if (std::isnan(luma[0]) || std::isnan(luma[1]) || std::fabs(luma[1]) < 1e-5 || std::isnan(luma[2]))
      corrupt("invalid YCbCrCoefficients");
    for (float f : rbw)
      if (!(f > static_cast<float>(-0x7FFFFFFF + 128) && f < static_cast<float>(0x7FFFFFFF)))
        corrupt("invalid ReferenceBlackWhite");
    auto fix = [](float x) { return static_cast<int32_t>(static_cast<double>(x * 65536.0f) + 0.5); };
    auto clampf = [](float f, float lo, float hi) { return f < lo ? lo : (f > hi ? hi : f); };
    const float f1 = 2 - 2 * luma[0];
    const int32_t D1 = fix(clampf(f1, 0.0f, 2.0f));
    const float f2 = luma[0] * f1 / luma[1];
    const int32_t D2 = -fix(clampf(f2, 0.0f, 2.0f));
    const float f3 = 2 - 2 * luma[2];
    const int32_t D3 = fix(clampf(f3, 0.0f, 2.0f));
    const float f4 = luma[2] * f3 / luma[1];
    const int32_t D4 = -fix(clampf(f4, 0.0f, 2.0f));
    auto code2v = [](int c, float rb, float rw, float cr) {
      const float d = (rw - rb) != 0 ? (rw - rb) : 1;
      return (static_cast<float>(c - static_cast<int32_t>(rb)) * cr) / d;
    };
    YccTables t;
    for (int i = 0, x = -128; i < 256; ++i, ++x) {
      const int32_t Cr =
          static_cast<int32_t>(clampf(code2v(x, rbw[4] - 128.0f, rbw[5] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      const int32_t Cb =
          static_cast<int32_t>(clampf(code2v(x, rbw[2] - 128.0f, rbw[3] - 128.0f, 127), -128.0f * 32, 128.0f * 32));
      t.cr_r[i] = static_cast<int32_t>((static_cast<int64_t>(D1) * Cr + (1 << 15)) >> 16);
      t.cb_b[i] = static_cast<int32_t>((static_cast<int64_t>(D3) * Cb + (1 << 15)) >> 16);
      t.cr_g[i] = D2 * Cr;
      t.cb_g[i] = D4 * Cb + (1 << 15);
      t.y[i] = static_cast<int32_t>(clampf(code2v(x + 128, rbw[0], rbw[1], 255), -128.0f * 32, 128.0f * 32));
    }
    return t;
  }

  // ------------------------------------------------ convert("RGB") ----

  void to_rgb(uint8_t* out) const {
    const LabToRgb* lab = mode_ == MLAB ? &LabToRgb::get() : nullptr;
    const size_t n = static_cast<size_t>(xsize_) * static_cast<size_t>(ysize_);
    const uint8_t* s = img_.data();
    for (size_t i = 0; i < n; ++i) {
      uint8_t* o = out + 3 * i;
      switch (mode_) {
        case M1: case ML:
          o[0] = o[1] = o[2] = s[i];
          break;
        case MLA:
          o[0] = o[1] = o[2] = s[4 * i];
          break;
        case MP:
          memcpy(o, pal_.data() + 3 * s[i], 3);
          break;
        case MPA:
          memcpy(o, pal_.data() + 3 * s[4 * i], 3);
          break;
        case MI16:
          o[0] = o[1] = o[2] = s[2 * i + 1] == 0 ? s[2 * i] : 255;
          break;
        case MI16B:
          o[0] = o[1] = o[2] = s[2 * i] == 0 ? s[2 * i + 1] : 255;
          break;
        case MI: {
          int32_t v;
          memcpy(&v, s + 4 * i, 4);
          o[0] = o[1] = o[2] = static_cast<uint8_t>(v <= 0 ? 0 : (v >= 255 ? 255 : v));
          break;
        }
        case MF: {
          float v;
          memcpy(&v, s + 4 * i, 4);
          // Convert.c f2l: clipped, truncated (NaN, which no comparison holds, as 0)
          o[0] = o[1] = o[2] =
              v <= 0.0f ? 0 : (v >= 255.0f ? 255 : (v != v ? 0 : static_cast<uint8_t>(static_cast<int>(v))));
          break;
        }
        case MRGB: case MRGBA:
          memcpy(o, s + 4 * i, 3);
          break;
        case MCMYK:
          cmyk_to_rgb(s[4 * i], s[4 * i + 1], s[4 * i + 2], s[4 * i + 3], o);
          break;
        case MLAB:
          lab->convert(s + 4 * i, o);
          break;
      }
    }
  }

  // ImageOps.exif_transpose.
  void transpose(const uint8_t* in, uint8_t* out) const {
    const int64_t W = xsize_, H = ysize_, OW = out_width();
    for (int64_t y = 0; y < H; ++y)
      for (int64_t x = 0; x < W; ++x) {
        int64_t ox = x, oy = y;
        switch (orientation_) {
          case 2: ox = W - 1 - x; break;
          case 3: ox = W - 1 - x; oy = H - 1 - y; break;
          case 4: oy = H - 1 - y; break;
          case 5: ox = y; oy = x; break;
          case 6: ox = H - 1 - y; oy = x; break;
          case 7: ox = H - 1 - y; oy = W - 1 - x; break;
          case 8: ox = y; oy = W - 1 - x; break;
          default: break;
        }
        memcpy(out + 3 * static_cast<size_t>(oy * OW + ox), in + 3 * static_cast<size_t>(y * W + x), 3);
      }
  }
};

}  // namespace

extern "C" {

// Decodes the first image of `data` into `out` ((H, W, 3) uint8 RGB,
// capacity `cap` bytes). With `out` null or too small it stops after the IFD
// and returns RF_NEED_BUFFER with the size in dims = (H, W). Returns RF_OK,
// RF_CORRUPT or RF_REFUSED (with a message in `err`).
int rf_tiff_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                   int64_t err_cap, InflateFn inflate, JpegFn jpeg, ZstdFn zstd, OjpegFn ojpeg) {
  try {
    Tiff tiff(data, static_cast<size_t>(n), inflate, jpeg, zstd, ojpeg);
    dims[0] = static_cast<int32_t>(tiff.out_height());
    dims[1] = static_cast<int32_t>(tiff.out_width());
    if (!out || cap < tiff.out_height() * tiff.out_width() * 3) return RF_NEED_BUFFER;
    tiff.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("TIFF decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
