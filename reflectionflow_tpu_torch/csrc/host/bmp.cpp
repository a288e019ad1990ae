// BMP decoding, as Pillow 12.1's BmpImagePlugin reads a file and
// `convert("RGB")` converts it, behind a plain C interface bound with ctypes
// in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * headers: core (12 bytes), INFO (40), V2-V5 (52, 56, 108, 124) and the
//     OS/2 v2 size (64);
//   * 1, 4 and 8 bits with a palette (BGR in a core header, BGRX after the
//     others; the colour count from the header, else 2^bits; indices past the
//     palette are black), and Pillow's grey palettes: a palette equal to the
//     ramp 0..n-1 (n = 2: black, white) makes the image "L" (or "1"), whose
//     samples are then read as bytes (or bits) whatever the depth;
//   * 16 bits (5-5-5, and 5-6-5 through BITFIELDS), 24 bits, 32 bits (BGRX,
//     and the BITFIELDS masks Pillow accepts), rows bottom-up or top-down;
//   * RLE8 and RLE4 as Pillow's BmpRleDecoder runs them: runs clipped at the
//     row's end, absolute runs that wrap, end-of-line padding, end of bitmap,
//     its delta that reads four bytes and uses the last two, and the 16-bit
//     alignment by file offset.
//
// `rf_dib_decode` reads the DIB of an ICO or CUR entry (no file header,
// half the height; Pillow's DibImageFile as its IcoImagePlugin and
// CurImagePlugin use it).
//
// What Pillow refuses (JPEG or PNG compression, other masks or depths, more
// than 256 colours) returns RF_REFUSED; corrupt or truncated data returns
// RF_CORRUPT. Every read is bounded by the buffer.

#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "status.h"

namespace {

inline uint32_t u16(const uint8_t* p) { return p[0] | (p[1] << 8); }
inline uint32_t u32(const uint8_t* p) { return u16(p) | (u16(p + 2) << 16); }

// Pillow's raw modes of a BMP: how one row's bytes become RGB.
enum Raw { P1, P4, P8, BIT1, GREY8, BGR15, BGR16, BGR24, QUAD };

class Bmp {
 public:
  // A BMP file, or (dib_at set) the DIB of an ICO / CUR entry at dib_at:
  // no file header, the data right after the header and palette, and half
  // the height the header gives (the rest is the AND mask).
  Bmp(const uint8_t* d, size_t n, const size_t* dib_at = nullptr) : d_(d), n_(n) {
    size_t offset = 0, at = 14;
    if (dib_at) {
      at = *dib_at;
      if (at > n || n - at < 4) corrupt("truncated DIB header");
    } else {
      if (n < 18 || d[0] != 'B' || d[1] != 'M') corrupt("not a BMP file");
      offset = u32(d + 10);
    }
    const uint32_t hsize = u32(d + at);
    if (hsize != 12 && hsize != 40 && hsize != 52 && hsize != 56 && hsize != 64 && hsize != 108 && hsize != 124)
      refused("BMP header of " + std::to_string(hsize) + " bytes");
    if (n - at < static_cast<size_t>(hsize)) corrupt("truncated BMP header");
    const uint8_t* h = d + at + 4;  // the header without its size
    size_t pos = at + hsize;
    int bits, palette_pad;
    uint32_t compression = 0, colors = 0;
    uint32_t masks[4] = {0, 0, 0, 0};
    if (hsize == 12) {
      w_ = u16(h);
      h_ = u16(h + 2);
      bits = static_cast<int>(u16(h + 6));
      palette_pad = 3;
    } else {
      const bool flip = h[7] == 0xFF;
      w_ = u32(h);
      h_ = flip ? (uint64_t(1) << 32) - u32(h + 4) : u32(h + 4);
      top_down_ = flip;
      bits = static_cast<int>(u16(h + 10));
      compression = u32(h + 12);
      colors = u32(h + 28);
      palette_pad = 4;
      if (compression == 3) {
        const int nmasks = hsize >= 56 ? 4 : 3;
        const uint8_t* m = h + 36;
        if (hsize == 40) {  // the three masks follow the header
          if (n < pos + 12) corrupt("truncated BMP masks");
          m = d + pos;
          pos += 12;
        }
        for (int i = 0; i < nmasks; ++i) masks[i] = u32(m + 4 * i);
      }
    }
    if (colors == 0) colors = bits < 32 ? 1u << bits : 0;
    if (!dib_at && offset == 14 + hsize && bits <= 8) offset += 4 * static_cast<size_t>(colors);
    if (bits != 1 && bits != 4 && bits != 8 && bits != 16 && bits != 24 && bits != 32)
      refused("BMP of " + std::to_string(bits) + " bits a pixel");
    if (w_ == 0 || h_ == 0 || w_ * h_ > (uint64_t(1) << 31)) corrupt("BMP of size 0 or too large");
    if (dib_at) {
      h_ /= 2;
      if (h_ == 0) corrupt("an icon DIB of height 1");
    }
    bool palette = bits <= 8;
    if (compression == 3) {  // BITFIELDS: the layouts Pillow accepts
      const uint32_t r = masks[0], g = masks[1], b = masks[2], a = masks[3];
      auto is = [&](uint32_t R, uint32_t G, uint32_t B, uint32_t A) { return r == R && g == G && b == B && a == A; };
      raw_ = QUAD;
      if (bits == 32 && is(0xFF0000, 0xFF00, 0xFF, 0)) set_quad(2, 1, 0);
      else if (bits == 32 && is(0xFF000000, 0xFF0000, 0xFF00, 0)) set_quad(3, 2, 1);
      else if (bits == 32 && is(0xFF000000, 0xFF00, 0xFF, 0)) set_quad(3, 1, 0);
      else if (bits == 32 && is(0xFF000000, 0xFF0000, 0xFF00, 0xFF)) set_quad(3, 2, 1);
      else if (bits == 32 && is(0xFF, 0xFF00, 0xFF0000, 0xFF000000)) set_quad(0, 1, 2);
      else if (bits == 32 && is(0xFF0000, 0xFF00, 0xFF, 0xFF000000)) set_quad(2, 1, 0);
      else if (bits == 32 && is(0xFF000000, 0xFF00, 0xFF, 0xFF0000)) set_quad(3, 1, 0);
      else if (bits == 32 && is(0, 0, 0, 0)) set_quad(2, 1, 0);
      else if (bits == 24 && r == 0xFF0000 && g == 0xFF00 && b == 0xFF) raw_ = BGR24;
      else if (bits == 16 && r == 0xF800 && g == 0x7E0 && b == 0x1F) raw_ = BGR16;
      else if (bits == 16 && r == 0x7C00 && g == 0x3E0 && b == 0x1F) raw_ = BGR15;
      else refused("this BMP bitfields layout");
    } else if (compression == 1 || compression == 2) {
      rle_ = true;
      rle4_ = compression == 2;
    } else if (compression != 0) {
      refused("BMP compression " + std::to_string(compression));
    }
    if (compression != 3)  // raw and RLE: Pillow's BIT2MODE (32 bits: BGRX)
      raw_ = bits == 1 ? P1 : bits == 4 ? P4 : bits == 8 ? P8 : bits == 16 ? BGR15 : bits == 24 ? BGR24 : QUAD;
    mode_ = palette ? 'P' : 'R';
    if (palette) {
      if (colors == 0 || colors > 65536) refused("a BMP palette of " + std::to_string(colors) + " colours");
      const size_t want = static_cast<size_t>(palette_pad) * colors;
      const size_t have = pos < n ? (n - pos < want ? n - pos : want) : 0;
      const uint8_t* p = d + pos;
      bool grey = true;
      for (uint32_t i = 0; i < colors; ++i) {
        const uint32_t v = colors == 2 ? (i ? 255 : 0) : i;
        const size_t at = static_cast<size_t>(i) * palette_pad;
        if (at + 3 > have || p[at] != v || p[at + 1] != v || p[at + 2] != v) grey = false;
      }
      pos += have;
      if (grey) {
        mode_ = colors == 2 ? '1' : 'L';
        raw_ = colors == 2 ? BIT1 : GREY8;
      } else {
        if (colors > 256) refused("a BMP palette of " + std::to_string(colors) + " colours");
        memset(lut_, 0, sizeof(lut_));  // past the palette: black
        for (size_t i = 0; i < colors && static_cast<size_t>(i + 1) * palette_pad <= have; ++i)
          for (int c = 0; c < 3; ++c) lut_[i][c] = p[i * palette_pad + 2 - c];
      }
    }
    offset_ = offset ? offset : pos;
    const int row_bits = raw_ == P1 || raw_ == BIT1 ? 1 : raw_ == P4 ? 4 : raw_ == P8 || raw_ == GREY8 ? 8
                         : raw_ == BGR24 ? 24 : raw_ == QUAD ? 32 : 16;
    stride_ = ((w_ * static_cast<uint64_t>(bits) + 31) >> 3) & ~uint64_t(3);
    row_bytes_ = (w_ * static_cast<uint64_t>(row_bits) + 7) / 8;
    if (rle_ && mode_ == '1') refused("an RLE BMP with a black and white palette");
  }

  int width() const { return static_cast<int>(w_); }
  size_t data_offset() const { return offset_; }
  int height() const { return static_cast<int>(h_); }

  void decode(uint8_t* out) const {
    if (rle_) {
      decode_rle(out);
      return;
    }
    if (row_bytes_ > stride_) refused("a BMP whose rows are shorter than its grey samples");
    if (offset_ > n_ || (h_ - 1) * stride_ + row_bytes_ > n_ - offset_) corrupt("truncated BMP pixel data");
    for (uint64_t r = 0; r < h_; ++r) {
      const uint8_t* in = d_ + offset_ + r * stride_;
      const uint64_t y = top_down_ ? r : h_ - 1 - r;
      uint8_t* o = out + y * w_ * 3;
      for (uint64_t x = 0; x < w_; ++x, o += 3) pixel(in, x, o);
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  uint64_t w_ = 0, h_ = 0, stride_ = 0, row_bytes_ = 0;
  size_t offset_ = 0;
  bool top_down_ = false, rle_ = false, rle4_ = false;
  char mode_ = 'R';
  Raw raw_ = P8;
  int ri_ = 2, gi_ = 1, bi_ = 0;  // byte of R, G, B in a 32-bit pixel
  uint8_t lut_[256][3];

  void set_quad(int r, int g, int b) {
    ri_ = r;
    gi_ = g;
    bi_ = b;
  }

  void index(int v, uint8_t* o) const {
    if (mode_ == 'P') {
      memcpy(o, lut_[v], 3);
    } else {
      const uint8_t g = static_cast<uint8_t>(mode_ == '1' ? (v ? 255 : 0) : v);
      o[0] = o[1] = o[2] = g;
    }
  }

  void pixel(const uint8_t* in, uint64_t x, uint8_t* o) const {
    switch (raw_) {
      case P1:
      case BIT1:
        index((in[x >> 3] >> (7 - (x & 7))) & 1, o);
        break;
      case P4:
        index((in[x >> 1] >> ((x & 1) ? 0 : 4)) & 15, o);
        break;
      case P8:
      case GREY8:
        index(in[x], o);
        break;
      case BGR15:
      case BGR16: {
        const uint32_t p = u16(in + 2 * x);
        o[2] = static_cast<uint8_t>((p & 31) * 255 / 31);
        if (raw_ == BGR15) {
          o[1] = static_cast<uint8_t>(((p >> 5) & 31) * 255 / 31);
          o[0] = static_cast<uint8_t>(((p >> 10) & 31) * 255 / 31);
        } else {
          o[1] = static_cast<uint8_t>(((p >> 5) & 63) * 255 / 63);
          o[0] = static_cast<uint8_t>(((p >> 11) & 31) * 255 / 31);
        }
        break;
      }
      case BGR24:
        o[0] = in[3 * x + 2];
        o[1] = in[3 * x + 1];
        o[2] = in[3 * x];
        break;
      case QUAD:
        o[0] = in[4 * x + ri_];
        o[1] = in[4 * x + gi_];
        o[2] = in[4 * x + bi_];
        break;
    }
  }

  // BmpImagePlugin.BmpRleDecoder.decode, then set_as_raw.
  void decode_rle(uint8_t* out) const {
    const uint64_t total = w_ * h_;
    std::vector<uint8_t> data;
    data.reserve(static_cast<size_t>(total));
    size_t p = offset_ > n_ ? n_ : offset_;
    uint64_t x = 0;
    while (data.size() < total) {
      if (p >= n_ || n_ - p < 2) break;  // (the 16-bit alignment may step past the end)
      int count = d_[p], byte = d_[p + 1];
      p += 2;
      if (count) {  // encoded
        uint64_t run = static_cast<uint64_t>(count);
        if (x + run > w_) run = x < w_ ? w_ - x : 0;
        for (uint64_t i = 0; i < run; ++i)
          data.push_back(static_cast<uint8_t>(rle4_ ? ((i & 1) ? byte & 15 : byte >> 4) : byte));
        x += run;
      } else if (byte == 0) {  // end of line
        while (data.size() % w_) data.push_back(0);
        x = 0;
      } else if (byte == 1) {  // end of bitmap
        break;
      } else if (byte == 2) {  // delta: Pillow reads two bytes, then uses the next two
        if (n_ - p < 2) break;
        p += 2;
        if (n_ - p < 2) corrupt("truncated BMP RLE delta");
        const uint64_t right = d_[p], up = d_[p + 1];
        p += 2;
        data.resize(data.size() + static_cast<size_t>(right + up * w_), 0);
        x = data.size() % w_;
      } else {  // absolute
        const size_t want = rle4_ ? byte / 2 : byte;
        const size_t got = n_ - p < want ? n_ - p : want;
        for (size_t i = 0; i < got; ++i) {
          if (rle4_) {
            data.push_back(static_cast<uint8_t>(d_[p + i] >> 4));
            data.push_back(static_cast<uint8_t>(d_[p + i] & 15));
          } else {
            data.push_back(d_[p + i]);
          }
        }
        p += got;
        if (got < want) break;
        x += static_cast<uint64_t>(byte);
        if (p % 2) ++p;
      }
    }
    if (data.size() < total) corrupt("not enough BMP RLE image data");
    for (uint64_t r = 0; r < h_; ++r) {
      const uint64_t y = top_down_ ? r : h_ - 1 - r;
      for (uint64_t c = 0; c < w_; ++c) index(data[r * w_ + c], out + (y * w_ + c) * 3);
    }
  }
};

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 3) uint8 RGB, capacity `cap` bytes). With
// `out` null or too small it stops after the headers and returns
// RF_NEED_BUFFER with the size in dims = (H, W). Returns RF_OK, RF_CORRUPT or
// RF_REFUSED (with a message in `err`).
int rf_bmp_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Bmp bmp(data, static_cast<size_t>(n));
    dims[0] = bmp.height();
    dims[1] = bmp.width();
    if (!out || cap < static_cast<int64_t>(bmp.height()) * bmp.width() * 3) return RF_NEED_BUFFER;
    bmp.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("BMP decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

// The DIB of an ICO or CUR entry at byte `at` of `data`, as Pillow's
// DibImageFile reads it there with half its height; otherwise as
// rf_bmp_decode, with dims = (H, W, offset of the pixel data).
int rf_dib_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap, int64_t at) {
  try {
    const size_t dib_at = static_cast<size_t>(at);
    Bmp bmp(data, static_cast<size_t>(n), &dib_at);
    dims[0] = bmp.height();
    dims[1] = bmp.width();
    dims[2] = static_cast<int32_t>(bmp.data_offset());
    if (!out || cap < static_cast<int64_t>(bmp.height()) * bmp.width() * 3) return RF_NEED_BUFFER;
    bmp.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("DIB decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
