// The merged image of a Photoshop (PSD) file, as Pillow 12.1's
// PsdImagePlugin reads it and `convert("RGB")` converts it, behind a plain C
// interface bound with ctypes in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * the 26-byte header (signature, version 1) and PsdImagePlugin.MODES:
//     bitmap 1, grey, duotone and multichannel L, indexed P, RGB (RGBA with
//     exactly 4 channels), CMYK and LAB at 8 bits; fewer channels than the
//     mode needs is refused, as are 16 and 32 bits (no MODES key);
//   * the colour-mode data, a palette ("RGB;L", planar) only for P with
//     exactly 768 bytes; the image resources walked entry by entry as
//     PsdImageFile._open walks them (a last entry may run past the section);
//     the layer and mask section skipped by its length;
//   * `_maketile`: raw planes of W * H bytes, or PackBits rows whose byte
//     counts (one table of `channels` * H entries) place each plane, each
//     plane through Pillow's PackbitsDecode.c (`pil_packbits`); CMYK planes
//     inverted (";I"); ZIP compression makes no tile, which PIL refuses;
//   * then `convert("RGB")`: CMYK by Convert.c's cmyk2rgb, LAB (a's and
//     b's planes with the sign bit flipped, as Pillow's LAB band unpackers
//     store them) by ImageCms's transform (`LabToRgb`), P through the
//     palette (black without one), RGBA without its alpha.
//
// What PIL refuses returns RF_REFUSED; data that ends early returns
// RF_CORRUPT. Every read is bounded by the buffer.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "codec_common.h"
#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS

enum Mode { M1, ML, MP, MRGB, MRGBA, MCMYK, MLAB };

inline uint32_t be16(const uint8_t* p) { return uint32_t(p[0]) << 8 | p[1]; }
inline uint32_t be32(const uint8_t* p) { return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3]; }

class Psd {
 public:
  Psd(const uint8_t* d, size_t n) : d_(d), n_(n) {
    if (n_ < 26 || memcmp(d_, "8BPS", 4) != 0 || be16(d_ + 4) != 1) corrupt("not a PSD file");
    const uint32_t bits = be16(d_ + 22), psd_channels = be16(d_ + 12), psd_mode = be16(d_ + 24);
    int channels = 0;
    if (bits == 8 && (psd_mode == 0 || psd_mode == 1 || psd_mode == 7 || psd_mode == 8)) {
      mode_ = ML, channels = 1;
    } else if (bits == 1 && psd_mode == 0) {
      mode_ = M1, channels = 1;
    } else if (bits == 8 && psd_mode == 2) {
      mode_ = MP, channels = 1;
    } else if (bits == 8 && psd_mode == 3) {
      mode_ = MRGB, channels = 3;
    } else if (bits == 8 && psd_mode == 4) {
      mode_ = MCMYK, channels = 4;
    } else if (bits == 8 && psd_mode == 9) {
      mode_ = MLAB, channels = 3;
    } else {
      refused("a PSD of colour mode " + std::to_string(psd_mode) + " at " + std::to_string(bits) +
              " bits (no PsdImagePlugin.MODES entry)");
    }
    if (static_cast<uint32_t>(channels) > psd_channels) refused("a PSD with not enough channels");
    if (mode_ == MRGB && psd_channels == 4) mode_ = MRGBA, channels = 4;
    channels_ = channels;
    h_ = be32(d_ + 14), w_ = be32(d_ + 18);
    if (w_ == 0 || h_ == 0) corrupt("a PSD of no pixels");
    if (uint64_t(w_) * h_ > kMaxPixels) refused("a PSD image past twice MAX_IMAGE_PIXELS");
    pos_ = 26;
    // colour mode data
    const uint32_t cm = u32();
    if (cm) {
      const size_t got = take(cm);
      if (mode_ == MP && cm == 768 && got == 768) palette_.assign(d_ + pos_ - got, d_ + pos_);
    }
    // image resources, walked as PsdImageFile._open walks them
    const uint32_t rs = u32();
    if (rs) {
      const size_t end = pos_ + rs;
      while (pos_ < end) {
        take(4);  // signature
        need(2, "a PSD image resource id");
        take(2);
        need(1, "a PSD image resource name");
        const size_t name = take(d_[pos_++]);
        if (!(name & 1)) take(1);  // padding
        if (take(u32()) & 1) take(1);
      }
    }
    // layer and mask information, skipped by its length
    const uint32_t ls = u32();
    if (ls) {
      const size_t end = pos_ + ls;
      u32();
      pos_ = end;
    }
    // _maketile
    need(2, "the PSD image data's compression");
    compression_ = be16(d_ + pos_);
    pos_ += 2;
  }

  int64_t height() const { return h_; }
  int64_t width() const { return w_; }

  void decode(uint8_t* out) {
    const size_t W = w_, H = h_, plane = W * H;
    const size_t row = mode_ == M1 ? (W + 7) / 8 : W;
    std::vector<uint8_t> planes(static_cast<size_t>(channels_) * row * H);
    const size_t at = pos_;
    if (compression_ == 0) {
      for (int c = 0; c < channels_; ++c) {
        const size_t off = at + c * plane;  // the planes sit W * H bytes apart, whatever the mode
        if (off > n_ || n_ - off < row * H) corrupt("image file is truncated");
        memcpy(planes.data() + c * row * H, d_ + off, row * H);
      }
    } else if (compression_ == 1) {
      const size_t table = static_cast<size_t>(channels_) * H * 2;
      if (n_ - at < table) corrupt("a PSD PackBits byte-count table cut short");
      size_t off = at + table;
      for (int c = 0; c < channels_; ++c) {
        if (off > n_ || pil_packbits(d_ + off, n_ - off, planes.data() + c * row * H, row, H) < 0)
          corrupt("image file is truncated");
        for (size_t y = 0; y < H; ++y) off += be16(d_ + at + 2 * (c * H + y));
      }
    } else {
      refused("a PSD of compression " + std::to_string(compression_) + " (cannot load this image)");
    }
    const LabToRgb* lab = mode_ == MLAB ? &LabToRgb::get() : nullptr;
    for (size_t y = 0; y < H; ++y) {
      for (size_t x = 0; x < W; ++x) {
        const size_t i = y * W + x;
        uint8_t* o = out + 3 * i;
        auto band = [&](int c) { return planes[c * row * H + y * row + x]; };
        switch (mode_) {
          case M1:
            o[0] = o[1] = o[2] = ((planes[y * row + (x >> 3)] >> (7 - (x & 7))) & 1) ? 255 : 0;
            break;
          case ML:
            o[0] = o[1] = o[2] = band(0);
            break;
          case MP:  // "RGB;L": the 256 reds, then the greens, then the blues
            for (int c = 0; c < 3; ++c) o[c] = palette_.empty() ? 0 : palette_[c * 256 + band(0)];
            break;
          case MRGB: case MRGBA:
            o[0] = band(0), o[1] = band(1), o[2] = band(2);
            break;
          case MCMYK:
            cmyk_to_rgb(255 - band(0), 255 - band(1), 255 - band(2), 255 - band(3), o);
            break;
          case MLAB: {
            // Unpack.c's LAB band unpackers flip a's and b's sign bit, as TIFF's do
            const uint8_t px[3] = {band(0), static_cast<uint8_t>(band(1) ^ 128), static_cast<uint8_t>(band(2) ^ 128)};
            lab->convert(px, o);
            break;
          }
        }
      }
    }
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint32_t w_ = 0, h_ = 0, compression_ = 0;
  int channels_ = 0;
  Mode mode_ = ML;
  std::vector<uint8_t> palette_;

  void need(size_t k, const char* what) {
    if (pos_ > n_ || n_ - pos_ < k) corrupt(std::string(what) + " cut short");
  }
  uint32_t u32() {
    need(4, "a PSD section length");
    pos_ += 4;
    return be32(d_ + pos_ - 4);
  }
  // fp.read(k): what is there of it (the position moves by what was read)
  size_t take(size_t k) {
    const size_t got = pos_ >= n_ ? 0 : std::min(k, n_ - pos_);
    pos_ += got;
    return got;
  }
};

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 3) uint8 RGB, capacity `cap` bytes). With
// `out` null or too small it stops after the header and returns
// RF_NEED_BUFFER with the size in dims = (H, W).
int rf_psd_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Psd psd(data, static_cast<size_t>(n));
    dims[0] = static_cast<int32_t>(psd.height());
    dims[1] = static_cast<int32_t>(psd.width());
    if (!out || cap < psd.height() * psd.width() * 3) return RF_NEED_BUFFER;
    psd.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("PSD decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
