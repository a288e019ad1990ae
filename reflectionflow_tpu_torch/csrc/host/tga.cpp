// TGA (Targa), as Pillow 12.1's TgaImagePlugin reads it and
// `convert("RGB")` converts it, behind a plain C interface bound with ctypes
// in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * the 18-byte header and TgaImageFile._open's checks (colour map type 0
//     or 1, a positive size, depth 1 / 8 / 16 / 24 / 32, image types 1, 2,
//     3 and their RLE forms 9, 10, 11, a map depth of 16 / 24 / 32), the ID
//     field skipped;
//   * the colour map as ImagePalette.raw builds it: 2, 3 or 4 zero bytes
//     for each entry before the first-entry index, then the entries read
//     ("BGRA;15Z", "BGR"; "BGRA" is a raw mode PIL's RGB palette refuses),
//     at most 256 entries, black past the end; a map on an L or LA image
//     turns it into P or PA, on a 1, RGB or RGBA image PIL refuses it;
//   * the pixels by MODES' raw mode (type 1 with no map reads "P" into L,
//     which PIL refuses), through the raw decoder or TgaRleDecode.c (a
//     literal packet may run on into the next row, a run packet may not),
//     rows bottom-up unless the orientation has 0x20, then the horizontal
//     flip of 0x10 (`load_end`);
//   * then `convert("RGB")`: 1 and L grey, LA's L, P / PA through the map,
//     RGBA without its alpha, "BGRA;15Z" as Unpack.c scales 5 bits
//     (v * 255 / 31).
//
// What PIL refuses, and data that ends early ("image file is truncated"),
// returns RF_REFUSED or RF_CORRUPT. Every read is bounded by the buffer.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS

enum Mode { M1, ML, MLA, MP, MRGB, MRGBA };
enum Raw { R1, RL, RLA, RP, R15, RBGR, RBGRA, RNONE };

inline int u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// Unpack.c's BGRA;15Z: B, G, R five bits each scaled by 255 / 31.
inline void bgr15(const uint8_t* p, uint8_t* rgb) {
  const int v = u16(p);
  rgb[0] = static_cast<uint8_t>(((v >> 10) & 31) * 255 / 31);
  rgb[1] = static_cast<uint8_t>(((v >> 5) & 31) * 255 / 31);
  rgb[2] = static_cast<uint8_t>((v & 31) * 255 / 31);
}

class Tga {
 public:
  Tga(const uint8_t* d, size_t n) : d_(d), n_(n) {
    if (n_ < 18) corrupt("a TGA header needs 18 bytes");
    const int id_len = d_[0], cmap_type = d_[1], type = d_[2], depth = d_[16], flags = d_[17];
    w_ = u16(d_ + 12), h_ = u16(d_ + 14);
    if (cmap_type > 1 || w_ <= 0 || h_ <= 0 ||
        !(depth == 1 || depth == 8 || depth == 16 || depth == 24 || depth == 32))
      corrupt("not a TGA file");
    if (type == 3 || type == 11) {
      mode_ = depth == 1 ? M1 : depth == 16 ? MLA : ML;
    } else if (type == 1 || type == 9) {
      mode_ = cmap_type ? MP : ML;
    } else if (type == 2 || type == 10) {
      mode_ = depth == 24 ? MRGB : MRGBA;
    } else {
      corrupt("unknown TGA mode");
    }
    rle_ = (type & 8) != 0;
    bottom_up_ = !(flags & 0x20);
    flip_ = (flags & 0x10) != 0;
    if (uint64_t(w_) * uint64_t(h_) > kMaxPixels) refused("a TGA image past twice MAX_IMAGE_PIXELS");
    size_t pos = 18 + static_cast<size_t>(id_len);
    if (pos > n_) pos = n_;
    if (cmap_type) {
      const int start = u16(d_ + 3), size = u16(d_ + 5), map_depth = d_[7];
      if (map_depth != 16 && map_depth != 24 && map_depth != 32) corrupt("unknown TGA map depth");
      map_bytes_ = map_depth / 8;
      const size_t got = std::min(static_cast<size_t>(size) * map_bytes_, n_ - pos);
      map_.assign(static_cast<size_t>(start) * map_bytes_, 0);
      map_.insert(map_.end(), d_ + pos, d_ + pos + got);
      pos += got;
    }
    pos_ = pos;
    raw_ = raw_mode(type & 7, depth);
    depth_ = depth;
  }

  int64_t height() const { return h_; }
  int64_t width() const { return w_; }

  void decode(uint8_t* out) {
    if (raw_ == RNONE) corrupt("cannot load this image (no TGA raw mode for this type and depth)");
    if (raw_ == RP && mode_ == ML) refused("a colour-mapped TGA without a colour map (unknown raw mode)");
    uint8_t pal[256 * 3] = {0};
    const bool mapped = d_[1] != 0;  // P, or an L / LA image the map turns into P / PA
    if (d_[1]) {  // the colour map, realized on load
      if (mode_ == M1 || mode_ == MRGB || mode_ == MRGBA) refused("a colour map on a TGA of this mode");
      if (map_bytes_ == 4) refused("a 32-bit TGA colour map (raw mode BGRA for an RGB palette)");
      const size_t entries = map_.size() / map_bytes_;
      if (entries > 256) refused("a TGA colour map of more than 256 entries");
      for (size_t i = 0; i < entries; ++i) {
        const uint8_t* e = map_.data() + i * map_bytes_;
        if (map_bytes_ == 2) {
          bgr15(e, pal + 3 * i);
        } else {
          pal[3 * i] = e[2], pal[3 * i + 1] = e[1], pal[3 * i + 2] = e[0];
        }
      }
    }
    const int bits = raw_bits();
    const size_t stride = (static_cast<size_t>(w_) * bits + 7) / 8;
    std::vector<uint8_t> rows(stride * static_cast<size_t>(h_));
    if (rle_) {
      rle(rows.data(), stride);
    } else {
      if (n_ - pos_ < rows.size()) corrupt("image file is truncated");
      memcpy(rows.data(), d_ + pos_, rows.size());
    }
    const int64_t W = w_, H = h_;
    for (int64_t r = 0; r < H; ++r) {
      // rows are stored in file order; the image row they fill
      const int64_t y = bottom_up_ ? H - 1 - r : r;
      const uint8_t* s = rows.data() + static_cast<size_t>(r) * stride;
      uint8_t* o = out + static_cast<size_t>(y) * W * 3;
      for (int64_t x = 0; x < W; ++x) {
        uint8_t* q = o + 3 * (flip_ ? W - 1 - x : x);
        switch (raw_) {
          case R1:
            q[0] = q[1] = q[2] = ((s[x >> 3] >> (7 - (x & 7))) & 1) ? 255 : 0;
            break;
          case RL: case RP:
            if (mapped) memcpy(q, pal + 3 * s[x], 3);
            else q[0] = q[1] = q[2] = s[x];
            break;
          case RLA:
            if (mapped) memcpy(q, pal + 3 * s[2 * x], 3);
            else q[0] = q[1] = q[2] = s[2 * x];
            break;
          case R15:
            bgr15(s + 2 * x, q);
            break;
          case RBGR:
            q[0] = s[3 * x + 2], q[1] = s[3 * x + 1], q[2] = s[3 * x];
            break;
          default:  // RBGRA
            q[0] = s[4 * x + 2], q[1] = s[4 * x + 1], q[2] = s[4 * x];
        }
      }
    }
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0, map_bytes_ = 0;
  int64_t w_ = 0, h_ = 0;
  int depth_ = 0;
  Mode mode_ = ML;
  Raw raw_ = RNONE;
  bool rle_ = false, bottom_up_ = true, flip_ = false;
  std::vector<uint8_t> map_;

  static Raw raw_mode(int type, int depth) {  // TgaImagePlugin.MODES
    if (type == 1 && depth == 8) return RP;
    if (type == 3 && depth == 1) return R1;
    if (type == 3 && depth == 8) return RL;
    if (type == 3 && depth == 16) return RLA;
    if (type == 2 && depth == 16) return R15;
    if (type == 2 && depth == 24) return RBGR;
    if (type == 2 && depth == 32) return RBGRA;
    return RNONE;
  }

  int raw_bits() const {
    switch (raw_) {
      case R1: return 1;
      case RL: case RP: return 8;
      case RLA: case R15: return 16;
      case RBGR: return 24;
      default: return 32;
    }
  }

  // TgaRleDecode.c: packets of a count byte (high bit: a run of one pixel
  // repeated, else a literal), `depth / 8` bytes a pixel, filling rows of
  // `stride` bytes in file order. A run that reaches past its row is an
  // overrun; a literal's excess goes on into the next rows.
  void rle(uint8_t* rows, size_t stride) {
    const size_t px = static_cast<size_t>(depth_) / 8;  // 0 at depth 1: no packet fills anything
    const size_t total_rows = static_cast<size_t>(h_);
    size_t at = pos_, x = 0, y = 0;
    while (true) {
      if (at >= n_) corrupt("image file is truncated");
      const uint8_t c = d_[at];
      size_t len = px * ((c & 0x7f) + 1);
      if (c & 0x80) {
        if (n_ - at < 1 + px) corrupt("image file is truncated");
        if (x + len > stride) corrupt("buffer overrun when reading image file");
        for (size_t i = 0; i < len; i += px) memcpy(rows + y * stride + x + i, d_ + at + 1, px);
        at += 1 + px;
        x += len;
        if (x >= stride) {
          x = 0;
          if (++y >= total_rows) return;
        }
      } else {
        if (n_ - at < 1 + len) corrupt("image file is truncated");
        const uint8_t* src = d_ + at + 1;
        at += 1 + len;
        while (len > 0) {
          const size_t k = std::min(len, stride - x);
          memcpy(rows + y * stride + x, src, k);
          src += k, len -= k, x += k;
          if (x >= stride) {
            x = 0;
            if (++y >= total_rows) return;
          }
        }
      }
    }
  }
};

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 3) uint8 RGB, capacity `cap` bytes). With
// `out` null or too small it stops after the header and returns
// RF_NEED_BUFFER with the size in dims = (H, W).
int rf_tga_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Tga tga(data, static_cast<size_t>(n));
    dims[0] = static_cast<int32_t>(tga.height());
    dims[1] = static_cast<int32_t>(tga.width());
    if (!out || cap < tga.height() * tga.width() * 3) return RF_NEED_BUFFER;
    tga.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("TGA decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
