// QOI ("Quite OK Image"), as Pillow 12.1's QoiImagePlugin and its Python
// QoiDecoder read it and `convert("RGB")` converts it, behind a plain C
// interface bound with ctypes in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`. Where QoiDecoder and the QOI
// specification's decoder differ, this follows QoiDecoder:
//
//   * an index slot never written reads (0, 0, 0, 0);
//   * the starting pixel (0, 0, 0, 255) is not in the index;
//   * a run may go past the image's end (the excess is dropped);
//   * a channels byte other than 3 gives RGBA, and the colourspace byte and
//     the end marker are not read;
//   * a read past the end of the data raises.
//
// RGBA drops its alpha in `convert("RGB")`. Data that ends early returns
// RF_CORRUPT. Every read is bounded by the buffer.

#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS

inline uint32_t be32(const uint8_t* p) { return uint32_t(p[0]) << 24 | uint32_t(p[1]) << 16 | uint32_t(p[2]) << 8 | p[3]; }

class Qoi {
 public:
  Qoi(const uint8_t* d, size_t n) : d_(d), n_(n) {
    if (n_ < 13 || memcmp(d_, "qoif", 4) != 0) corrupt("not a QOI file");
    w_ = be32(d_ + 4), h_ = be32(d_ + 8);
    if (w_ == 0 || h_ == 0) corrupt("a QOI image of no pixels");
    if (uint64_t(w_) * h_ > kMaxPixels) refused("a QOI image past twice MAX_IMAGE_PIXELS");
  }

  int64_t height() const { return h_; }
  int64_t width() const { return w_; }

  void decode(uint8_t* out) {
    uint8_t seen[64][4] = {};  // never written: (0, 0, 0, 0)
    uint8_t prev[4] = {0, 0, 0, 255};
    const uint64_t total = uint64_t(w_) * h_;
    uint64_t done = 0;
    size_t at = 14;
    auto byte = [&]() -> uint8_t {
      if (at >= n_) corrupt("QOI data cut short");
      return d_[at++];
    };
    auto put = [&](const uint8_t* px) {
      if (done < total) memcpy(out + 3 * done, px, 3);
      ++done;
    };
    while (done < total) {
      const uint8_t b = byte();
      uint8_t v[4];
      if (b == 0xfe) {  // QOI_OP_RGB
        if (n_ - at < 3) corrupt("QOI data cut short");
        memcpy(v, d_ + at, 3);
        at += 3;
        v[3] = prev[3];
      } else if (b == 0xff) {  // QOI_OP_RGBA
        if (n_ - at < 4) corrupt("QOI data cut short");
        memcpy(v, d_ + at, 4);
        at += 4;
      } else if ((b >> 6) == 0) {  // QOI_OP_INDEX
        memcpy(v, seen[b & 63], 4);
      } else if ((b >> 6) == 1) {  // QOI_OP_DIFF
        v[0] = static_cast<uint8_t>(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = static_cast<uint8_t>(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = static_cast<uint8_t>(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if ((b >> 6) == 2) {  // QOI_OP_LUMA
        const uint8_t b2 = byte();
        const int dg = (b & 63) - 32, dr = ((b2 >> 4) & 15) - 8, db = (b2 & 15) - 8;
        v[0] = static_cast<uint8_t>(prev[0] + dg + dr);
        v[1] = static_cast<uint8_t>(prev[1] + dg);
        v[2] = static_cast<uint8_t>(prev[2] + dg + db);
        v[3] = prev[3];
      } else {  // QOI_OP_RUN: the previous pixel again, the index untouched
        for (int k = (b & 63) + 1; k > 0; --k) put(prev);
        continue;
      }
      memcpy(prev, v, 4);
      memcpy(seen[(v[0] * 3 + v[1] * 5 + v[2] * 7 + v[3] * 11) % 64], v, 4);
      put(v);
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  uint32_t w_ = 0, h_ = 0;
};

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 3) uint8 RGB, capacity `cap` bytes). With
// `out` null or too small it stops after the header and returns
// RF_NEED_BUFFER with the size in dims = (H, W).
int rf_qoi_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Qoi qoi(data, static_cast<size_t>(n));
    dims[0] = static_cast<int32_t>(qoi.height());
    dims[1] = static_cast<int32_t>(qoi.width());
    if (!out || cap < qoi.height() * qoi.width() * 3) return RF_NEED_BUFFER;
    qoi.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("QOI decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
