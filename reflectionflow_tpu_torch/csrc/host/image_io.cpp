// Host image codecs of the GenRef data path, behind a plain C interface
// (bound with ctypes in `utils/image_io.py`, built with g++ by
// `ops/kernel_build.py::build_host`):
//
//   * rf_jpeg_decode: baseline / extended sequential Huffman JPEG at 8 bits,
//     1 (grey) or 3 (YCbCr, or RGB per the Adobe marker / component ids)
//     components, any integral sampling, restart intervals, several scans.
//     It reproduces libjpeg(-turbo)'s default decode, which PIL runs:
//     the accurate integer IDCT (jidctint.c, CONST_BITS 13, PASS1_BITS 2, the
//     masked range limit around CENTERJSAMPLE), fancy upsampling (jdsample.c
//     h2v1 / h2v2 / h1v2 triangle filters over edge-replicated planes, box
//     replication when the chroma is at most 2 samples wide) and the
//     fixed-point YCbCr -> RGB tables (jdcolor.c, SCALEBITS 16).
//     Progressive, arithmetic, lossless, hierarchical and 12-bit frames and
//     4-component images return RF_UNSUPPORTED; corrupt or truncated data and
//     missing tables return RF_CORRUPT. Every read is bounded by the buffer.
//   * rf_resize_bicubic: Pillow's 8-bit ImagingResample with the bicubic
//     filter (a = -0.5, support 2 * max(scale, 1), coefficients normalized in
//     double and rounded to 22 fractional bits, width pass then height pass,
//     each only when that size changes).
//   * rf_png_unfilter: undoes PNG scanline filters (None, Sub, Up, Average,
//     Paeth).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

namespace {

constexpr int RF_OK = 0;
constexpr int RF_CORRUPT = -1;
constexpr int RF_UNSUPPORTED = -2;
constexpr int RF_NEED_BUFFER = 1;

struct Fail {
  int code;
  std::string msg;
};

[[noreturn]] void corrupt(const std::string& msg) { throw Fail{RF_CORRUPT, msg}; }
[[noreturn]] void unsupported(const std::string& msg) {
  throw Fail{RF_UNSUPPORTED, msg + " is not supported yet (ROADMAP queue 1)"};
}

void write_err(const std::string& msg, char* err, int64_t cap) {
  if (!err || cap <= 0) return;
  size_t n = msg.size() < static_cast<size_t>(cap - 1) ? msg.size() : static_cast<size_t>(cap - 1);
  memcpy(err, msg.data(), n);
  err[n] = 0;
}

// ---------------------------------------------------------------- JPEG ----

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  uint8_t vals[256] = {0};
  int32_t maxcode[18] = {0};
  int32_t valoffset[18] = {0};
  uint16_t look[1 << kLookBits] = {0};  // (length << 8) | symbol; length 0: slow path

  // jdhuff.c jpeg_make_d_derived_tbl
  void build(const uint8_t* bits, const uint8_t* values, int nvals, bool dc) {
    uint8_t huffsize[257];
    uint32_t huffcode[257];
    int p = 0;
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[p++] = static_cast<uint8_t>(l);
    huffsize[p] = 0;
    uint32_t code = 0;
    int si = huffsize[0];
    p = 0;
    while (huffsize[p]) {
      while (huffsize[p] == si) huffcode[p++] = code++;
      if (code >= (1u << si)) corrupt("bad Huffman table");
      code <<= 1;
      ++si;
    }
    p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoffset[l] = p - static_cast<int32_t>(huffcode[p]);
        p += bits[l];
        maxcode[l] = static_cast<int32_t>(huffcode[p - 1]);
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7FFFFFFF;
    memset(vals, 0, sizeof(vals));
    memcpy(vals, values, static_cast<size_t>(nvals));
    memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= kLookBits; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = static_cast<int>(huffcode[p]) << (kLookBits - l);
        for (int ctr = 1 << (kLookBits - l); ctr > 0; --ctr)
          look[lookbits++] = static_cast<uint16_t>((l << 8) | vals[p]);
      }
    }
    if (dc)
      for (int i = 0; i < nvals; ++i)
        if (values[i] > 15) corrupt("bad DC Huffman table");
    present = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int bw = 0, bh = 0;      // blocks allocated (the MCU grid)
  int wblocks = 0, hblocks = 0;  // blocks holding samples
  int dw = 0, dh = 0;      // downsampled size
  bool latched = false, scanned = false;
  int32_t quant[64] = {0};  // natural order
  std::vector<int16_t> coef;  // (bh * bw) blocks of 64, natural order
  std::vector<uint8_t> plane;  // (hblocks * 8) x (wblocks * 8) samples
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t end, size_t pos) : d_(d), end_(end), pos_(pos) {}

  size_t pos() const { return pos_; }
  void set_pos(size_t p) { pos_ = p; buf_ = 0; cnt_ = 0; fake_ = 0; marker_ = false; eod_ = false; }
  // True once bits past the data (or past a marker) were consumed.
  bool overran() const { return cnt_ < fake_; }

  inline void fill() {
    while (cnt_ <= 56) {
      uint64_t b = 0;
      if (marker_ || eod_) {
        fake_ += 8;
      } else if (pos_ >= end_) {
        eod_ = true;
        fake_ += 8;
      } else {
        uint8_t c = d_[pos_];
        if (c == 0xFF) {
          if (pos_ + 1 >= end_) {
            eod_ = true;
            fake_ += 8;
          } else if (d_[pos_ + 1] == 0x00) {
            b = 0xFF;
            pos_ += 2;
          } else {
            marker_ = true;  // leave pos_ on the marker
            fake_ += 8;
          }
        } else {
          b = c;
          ++pos_;
        }
      }
      buf_ |= b << (56 - cnt_);
      cnt_ += 8;
    }
  }

  inline int peek(int n) { fill(); return static_cast<int>(buf_ >> (64 - n)); }
  inline void skip(int n) { buf_ <<= n; cnt_ -= n; }
  inline int bits(int n) {
    if (n == 0) return 0;
    int v = peek(n);
    skip(n);
    return v;
  }

  inline int decode(const Huffman& t) {
    int look = peek(kLookBits);
    int e = t.look[look];
    if (e >> 8) {
      skip(e >> 8);
      return e & 0xFF;
    }
    int code = peek(16);
    for (int l = kLookBits + 1; l <= 16; ++l) {
      int c = code >> (16 - l);
      if (c <= t.maxcode[l]) {
        skip(l);
        int idx = c + t.valoffset[l];
        if (idx < 0 || idx > 255) corrupt("bad Huffman code");
        return t.vals[idx];
      }
    }
    corrupt("bad Huffman code");
  }

 private:
  const uint8_t* d_;
  size_t end_, pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0, fake_ = 0;
  bool marker_ = false, eod_ = false;
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x + (-1 << s) + 1 : x; }

// jidctint.c jpeg_idct_islow with the masked post-IDCT range limit.
inline uint8_t range_limit(int64_t x) {
  int idx = static_cast<int>(x & 1023);
  if (idx < 128) return static_cast<uint8_t>(idx + 128);
  if (idx < 512) return 255;
  if (idx < 896) return 0;
  return static_cast<uint8_t>(idx - 896);
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* ip = in + c;
    const int32_t* qp = q + c;
    int* wp = ws + c;
    if (ip[8] == 0 && ip[16] == 0 && ip[24] == 0 && ip[32] == 0 && ip[40] == 0 && ip[48] == 0 &&
        ip[56] == 0) {
      int dc = static_cast<int>(static_cast<int64_t>(ip[0]) * qp[0] * (1 << P1));
      for (int r = 0; r < 8; ++r) wp[r * 8] = dc;
      continue;
    }
    int64_t z2 = static_cast<int64_t>(ip[16]) * qp[16], z3 = static_cast<int64_t>(ip[48]) * qp[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    z2 = static_cast<int64_t>(ip[0]) * qp[0];
    z3 = static_cast<int64_t>(ip[32]) * qp[32];
    int64_t tmp0 = (z2 + z3) * (1 << CB), tmp1 = (z2 - z3) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = static_cast<int64_t>(ip[56]) * qp[56];
    tmp1 = static_cast<int64_t>(ip[40]) * qp[40];
    tmp2 = static_cast<int64_t>(ip[24]) * qp[24];
    tmp3 = static_cast<int64_t>(ip[8]) * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
    z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
    z3 += z5; z4 += z5;
    tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
    constexpr int S = CB - P1;
    constexpr int64_t R = int64_t(1) << (S - 1);
    wp[0] = static_cast<int>((tmp10 + tmp3 + R) >> S);
    wp[56] = static_cast<int>((tmp10 - tmp3 + R) >> S);
    wp[8] = static_cast<int>((tmp11 + tmp2 + R) >> S);
    wp[48] = static_cast<int>((tmp11 - tmp2 + R) >> S);
    wp[16] = static_cast<int>((tmp12 + tmp1 + R) >> S);
    wp[40] = static_cast<int>((tmp12 - tmp1 + R) >> S);
    wp[24] = static_cast<int>((tmp13 + tmp0 + R) >> S);
    wp[32] = static_cast<int>((tmp13 - tmp0 + R) >> S);
  }
  for (int r = 0; r < 8; ++r) {
    const int* wp = ws + r * 8;
    uint8_t* op = out + r * stride;
    if (wp[1] == 0 && wp[2] == 0 && wp[3] == 0 && wp[4] == 0 && wp[5] == 0 && wp[6] == 0 &&
        wp[7] == 0) {
      uint8_t dc = range_limit((static_cast<int64_t>(wp[0]) + (1 << (P1 + 2))) >> (P1 + 3));
      for (int c = 0; c < 8; ++c) op[c] = dc;
      continue;
    }
    int64_t z2 = wp[2], z3 = wp[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847, tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = (static_cast<int64_t>(wp[0]) + wp[4]) * (1 << CB);
    int64_t tmp1 = (static_cast<int64_t>(wp[0]) - wp[4]) * (1 << CB);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7]; tmp1 = wp[5]; tmp2 = wp[3]; tmp3 = wp[1];
    z1 = tmp0 + tmp3; z2 = tmp1 + tmp2; z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298; tmp1 *= F2053; tmp2 *= F3072; tmp3 *= F1501;
    z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
    z3 += z5; z4 += z5;
    tmp0 += z1 + z3; tmp1 += z2 + z4; tmp2 += z2 + z3; tmp3 += z1 + z4;
    constexpr int S = CB + P1 + 3;
    constexpr int64_t R = int64_t(1) << (S - 1);
    op[0] = range_limit((tmp10 + tmp3 + R) >> S);
    op[7] = range_limit((tmp10 - tmp3 + R) >> S);
    op[1] = range_limit((tmp11 + tmp2 + R) >> S);
    op[6] = range_limit((tmp11 - tmp2 + R) >> S);
    op[2] = range_limit((tmp12 + tmp1 + R) >> S);
    op[5] = range_limit((tmp12 - tmp1 + R) >> S);
    op[3] = range_limit((tmp13 + tmp0 + R) >> S);
    op[4] = range_limit((tmp13 - tmp0 + R) >> S);
  }
}

// jdsample.c: a downsampled plane (dw x dh, row stride `ps`) -> its
// (ceil to W) x H upsampled plane `out` for expansion (eh, ev).
void upsample(const uint8_t* in, int dw, int dh, int ps, int eh, int ev, uint8_t* out, int W,
              int H) {
  std::vector<uint8_t> row(static_cast<size_t>(dw) * eh + 2);
  auto src = [&](int r) { return in + static_cast<size_t>(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * ps; };
  if (eh == 2 && ev == 2 && dw > 2) {  // h2v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int r = y >> 1;
      const uint8_t* i0 = src(r);
      const uint8_t* i1 = src((y & 1) ? r + 1 : r - 1);
      uint8_t* o = row.data();
      int this_s = i0[0] * 3 + i1[0], next_s = i0[1] * 3 + i1[1], last_s;
      *o++ = static_cast<uint8_t>((this_s * 4 + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
      last_s = this_s;
      this_s = next_s;
      for (int c = 2; c < dw; ++c) {
        next_s = i0[c] * 3 + i1[c];
        *o++ = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
        *o++ = static_cast<uint8_t>((this_s * 3 + next_s + 7) >> 4);
        last_s = this_s;
        this_s = next_s;
      }
      *o++ = static_cast<uint8_t>((this_s * 3 + last_s + 8) >> 4);
      *o++ = static_cast<uint8_t>((this_s * 4 + 7) >> 4);
      memcpy(out + static_cast<size_t>(y) * W, row.data(), static_cast<size_t>(W));
    }
  } else if (eh == 2 && ev == 1 && dw > 2) {  // h2v1_fancy_upsample
    for (int y = 0; y < H; ++y) {
      const uint8_t* ip = src(y);
      uint8_t* o = row.data();
      int v = ip[0];
      *o++ = static_cast<uint8_t>(v);
      *o++ = static_cast<uint8_t>((v * 3 + ip[1] + 2) >> 2);
      for (int c = 1; c < dw - 1; ++c) {
        v = ip[c] * 3;
        *o++ = static_cast<uint8_t>((v + ip[c - 1] + 1) >> 2);
        *o++ = static_cast<uint8_t>((v + ip[c + 1] + 2) >> 2);
      }
      v = ip[dw - 1];
      *o++ = static_cast<uint8_t>((v * 3 + ip[dw - 2] + 1) >> 2);
      *o++ = static_cast<uint8_t>(v);
      memcpy(out + static_cast<size_t>(y) * W, row.data(), static_cast<size_t>(W));
    }
  } else if (eh == 1 && ev == 2) {  // h1v2_fancy_upsample
    for (int y = 0; y < H; ++y) {
      int r = y >> 1;
      const uint8_t* i0 = src(r);
      const uint8_t* i1 = src((y & 1) ? r + 1 : r - 1);
      int bias = (y & 1) ? 2 : 1;
      uint8_t* o = out + static_cast<size_t>(y) * W;
      for (int c = 0; c < W; ++c) o[c] = static_cast<uint8_t>((i0[c] * 3 + i1[c] + bias) >> 2);
    }
  } else {  // box replication (h2v1_upsample, h2v2_upsample, int_upsample, fullsize)
    for (int y = 0; y < H; ++y) {
      const uint8_t* ip = src(y / ev);
      uint8_t* o = out + static_cast<size_t>(y) * W;
      for (int c = 0; c < W; ++c) o[c] = ip[c / eh];
    }
  }
}

class Decoder {
 public:
  Decoder(const uint8_t* d, size_t n) : d_(d), n_(n) {}

  // Parses up to the frame header; returns (H, W).
  void header() {
    if (n_ < 2 || d_[0] != 0xFF || d_[1] != 0xD8) corrupt("not a JPEG file (no SOI)");
    pos_ = 2;
    while (!have_frame_) {
      int m = next_marker();
      segment(m);
    }
  }

  void decode(uint8_t* out) {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        continue;
      }
      segment(m);
    }
    for (auto& c : comps_)
      if (!c.scanned) corrupt("a component has no scan");
    finish(out);
  }

  int width() const { return W_; }
  int height() const { return H_; }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int W_ = 0, H_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool have_frame_ = false, jfif_ = false, adobe_ = false;
  int adobe_transform_ = -1;
  bool qt_present_[4] = {false, false, false, false};
  int32_t qt_[4][64];
  Huffman dc_[4], ac_[4];
  std::vector<Component> comps_;

  int byte() {
    if (pos_ >= n_) corrupt("unexpected end of JPEG data");
    return d_[pos_++];
  }
  int word() {
    int hi = byte();
    return (hi << 8) | byte();
  }

  int next_marker() {
    if (byte() != 0xFF) corrupt("expected a JPEG marker");
    int m;
    do m = byte(); while (m == 0xFF);
    if (m == 0) corrupt("expected a JPEG marker");
    return m;
  }

  // Reads one marker segment (length word included); returns its end.
  size_t segment_end() {
    int len = word();
    if (len < 2 || pos_ + static_cast<size_t>(len - 2) > n_) corrupt("bad JPEG segment length");
    return pos_ + static_cast<size_t>(len - 2);
  }

  void segment(int m) {
    if (m == 0xD8) corrupt("SOI inside the image");
    if (m == 0xD9 || m == 0xDA) corrupt("scan or EOI before the frame");
    if (m >= 0xD0 && m <= 0xD7) corrupt("restart marker outside a scan");
    if (m == 0x01) return;  // TEM: no payload
    size_t end = segment_end();
    switch (m) {
      case 0xC0:
      case 0xC1:
        frame(end);
        break;
      case 0xC2:
      case 0xC6:
      case 0xCA:
      case 0xCE:
        unsupported("progressive JPEG");
      case 0xC3:
      case 0xC7:
      case 0xCB:
      case 0xCF:
        unsupported("lossless JPEG");
      case 0xC5:
        unsupported("hierarchical JPEG");
      case 0xC9:
      case 0xCD:
      case 0xCC:
        unsupported("arithmetic-coded JPEG");
      case 0xC4:
        dht(end);
        break;
      case 0xDB:
        dqt(end);
        break;
      case 0xDD:
        if (end - pos_ < 2) corrupt("bad DRI segment");
        restart_ = word();
        break;
      case 0xDC:
        unsupported("a DNL marker");
      case 0xE0:
        if (end - pos_ >= 14 && memcmp(d_ + pos_, "JFIF\0", 5) == 0) jfif_ = true;
        break;
      case 0xEE:
        if (end - pos_ >= 12 && memcmp(d_ + pos_, "Adobe", 5) == 0) {
          adobe_ = true;
          adobe_transform_ = d_[pos_ + 11];
        }
        break;
      default:
        break;  // other APPn, COM, JPGn: skipped
    }
    if (pos_ > end) corrupt("JPEG segment overrun");
    pos_ = end;
  }

  void frame(size_t end) {
    if (have_frame_) corrupt("two frames in one JPEG");
    if (end - pos_ < 6) corrupt("bad SOF segment");
    int precision = byte();
    H_ = word();
    W_ = word();
    int nc = byte();
    if (precision != 8) unsupported(std::to_string(precision) + "-bit JPEG");
    if (nc == 4) unsupported("4-component (CMYK/YCCK) JPEG");
    if (nc != 1 && nc != 3) unsupported(std::to_string(nc) + "-component JPEG");
    if (H_ == 0) unsupported("a JPEG whose height is given by DNL");
    if (W_ == 0) corrupt("JPEG of width 0");
    if (end - pos_ < static_cast<size_t>(3 * nc)) corrupt("bad SOF segment");
    comps_.resize(static_cast<size_t>(nc));
    for (auto& c : comps_) {
      c.id = byte();
      int hv = byte();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = byte();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3) corrupt("bad JPEG component");
      max_h_ = c.h > max_h_ ? c.h : max_h_;
      max_v_ = c.v > max_v_ ? c.v : max_v_;
    }
    mcux_ = (W_ + 8 * max_h_ - 1) / (8 * max_h_);
    mcuy_ = (H_ + 8 * max_v_ - 1) / (8 * max_v_);
    for (auto& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) unsupported("fractional JPEG sampling");
      c.dw = static_cast<int>((static_cast<int64_t>(W_) * c.h + max_h_ - 1) / max_h_);
      c.dh = static_cast<int>((static_cast<int64_t>(H_) * c.v + max_v_ - 1) / max_v_);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      c.coef.assign(static_cast<size_t>(c.bw) * c.bh * 64, 0);
    }
    have_frame_ = true;
  }

  void dht(size_t end) {
    while (pos_ < end) {
      int tc_th = byte();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) corrupt("bad DHT table id");
      uint8_t bits[17] = {0};
      int total = 0;
      if (end - pos_ < 16) corrupt("bad DHT segment");
      for (int l = 1; l <= 16; ++l) total += bits[l] = static_cast<uint8_t>(byte());
      if (total > 256 || end - pos_ < static_cast<size_t>(total)) corrupt("bad DHT segment");
      (tc ? ac_ : dc_)[th].build(bits, d_ + pos_, total, tc == 0);
      pos_ += static_cast<size_t>(total);
    }
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (pq > 1 || tq > 3) corrupt("bad DQT table id");
      if (end - pos_ < static_cast<size_t>(pq ? 128 : 64)) corrupt("bad DQT segment");
      for (int i = 0; i < 64; ++i) qt_[tq][kZigzag[i]] = pq ? word() : byte();
      qt_present_[tq] = true;
    }
  }

  void scan() {
    if (!have_frame_) corrupt("scan before the frame");
    size_t end = segment_end();
    if (end - pos_ < 1) corrupt("bad SOS segment");
    int ns = byte();
    if (ns < 1 || ns > 4 || end - pos_ != static_cast<size_t>(2 * ns + 3)) corrupt("bad SOS segment");
    std::vector<Component*> sc;
    for (int i = 0; i < ns; ++i) {
      int id = byte(), t = byte();
      Component* found = nullptr;
      for (auto& c : comps_)
        if (c.id == id) found = &c;
      if (!found) corrupt("SOS names no frame component");
      for (auto* s : sc)
        if (s == found) corrupt("SOS names a component twice");
      found->td = t >> 4;
      found->ta = t & 15;
      if (found->td > 3 || found->ta > 3) corrupt("bad SOS table id");
      sc.push_back(found);
    }
    int ss = byte(), se = byte(), ahal = byte();
    if (ss != 0 || se != 63 || ahal != 0) corrupt("bad sequential scan parameters");
    int blocks_in_mcu = 0;
    for (auto* c : sc) {
      if (!dc_[c->td].present || !ac_[c->ta].present) corrupt("missing Huffman table");
      if (!c->latched) {  // jdinput.c latch_quant_tables
        if (!qt_present_[c->tq]) corrupt("missing quantization table");
        memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      c->scanned = true;
      blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
    }
    if (blocks_in_mcu > 10) corrupt("too many blocks in a JPEG MCU");

    BitReader br(d_, n_, pos_);
    int pred[4] = {0, 0, 0, 0};
    int mx = ns == 1 ? sc[0]->wblocks : mcux_, my = ns == 1 ? sc[0]->hblocks : mcuy_;
    int64_t total = static_cast<int64_t>(mx) * my;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_ && m > 0 && m % restart_ == 0) {
        size_t p = br.pos();
        if (p + 1 >= n_ || d_[p] != 0xFF) corrupt("missing JPEG restart marker");
        while (p < n_ && d_[p] == 0xFF) ++p;
        if (p >= n_ || d_[p] != 0xD0 + next_rst) corrupt("missing JPEG restart marker");
        next_rst = (next_rst + 1) & 7;
        br.set_pos(p + 1);
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
      }
      int mxi = static_cast<int>(m % mx), myi = static_cast<int>(m / mx);
      for (int ci = 0; ci < ns; ++ci) {
        Component* c = sc[ci];
        int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bwn; ++bx) {
            int row = ns == 1 ? myi : myi * c->v + by, col = ns == 1 ? mxi : mxi * c->h + bx;
            int16_t* blk = c->coef.data() + (static_cast<size_t>(row) * c->bw + col) * 64;
            block(br, *c, pred[ci], blk);
          }
      }
      if (br.overran()) corrupt("truncated JPEG data");
    }
    // The scan's entropy data ends at the next marker.
    size_t p = br.pos();
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 && !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7)))
      ++p;
    if (p + 1 >= n_) corrupt("truncated JPEG data (no EOI)");
    pos_ = p;
  }

  inline void block(BitReader& br, const Component& c, int& pred, int16_t* blk) {
    int s = br.decode(dc_[c.td]);
    int diff = s ? extend(br.bits(s), s) : 0;
    pred += diff;
    blk[0] = static_cast<int16_t>(pred);
    const Huffman& ac = ac_[c.ta];
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) corrupt("bad JPEG coefficient index");
        blk[kZigzag[k]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        k += 15;
      }
    }
  }

  void finish(uint8_t* out) {
    std::vector<std::vector<uint8_t>> full(comps_.size());
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      Component& c = comps_[ci];
      int ps = c.wblocks * 8;
      c.plane.assign(static_cast<size_t>(ps) * c.hblocks * 8, 0);
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx)
          idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                     c.plane.data() + static_cast<size_t>(by) * 8 * ps + bx * 8, ps);
      std::vector<int16_t>().swap(c.coef);
      int eh = max_h_ / c.h, ev = max_v_ / c.v;
      if (eh == 1 && ev == 1) continue;
      full[ci].resize(static_cast<size_t>(W_) * H_);
      upsample(c.plane.data(), c.dw, c.dh, ps, eh, ev, full[ci].data(), W_, H_);
    }
    auto plane_row = [&](size_t ci, int y) -> const uint8_t* {
      if (!full[ci].empty()) return full[ci].data() + static_cast<size_t>(y) * W_;
      return comps_[ci].plane.data() + static_cast<size_t>(y) * comps_[ci].wblocks * 8;
    };
    if (comps_.size() == 1) {
      for (int y = 0; y < H_; ++y) {
        const uint8_t* g = plane_row(0, y);
        uint8_t* o = out + static_cast<size_t>(y) * W_ * 3;
        for (int x = 0; x < W_; ++x) o[3 * x] = o[3 * x + 1] = o[3 * x + 2] = g[x];
      }
      return;
    }
    bool rgb;  // jdapimin.c default_decompress_parms
    if (jfif_)
      rgb = false;
    else if (adobe_)
      rgb = adobe_transform_ == 0;
    else
      rgb = comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66;
    if (rgb) {
      for (int y = 0; y < H_; ++y) {
        const uint8_t *r = plane_row(0, y), *g = plane_row(1, y), *b = plane_row(2, y);
        uint8_t* o = out + static_cast<size_t>(y) * W_ * 3;
        for (int x = 0; x < W_; ++x) {
          o[3 * x] = r[x];
          o[3 * x + 1] = g[x];
          o[3 * x + 2] = b[x];
        }
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table / ycc_rgb_convert
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double v) { return static_cast<int64_t>(v * (1 << SB) + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) { return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (int y = 0; y < H_; ++y) {
      const uint8_t *py = plane_row(0, y), *pb = plane_row(1, y), *pr = plane_row(2, y);
      uint8_t* o = out + static_cast<size_t>(y) * W_ * 3;
      for (int x = 0; x < W_; ++x) {
        int yy = py[x], cb = pb[x], cr = pr[x];
        o[3 * x] = clamp(yy + cr_r[cr]);
        o[3 * x + 1] = clamp(yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
        o[3 * x + 2] = clamp(yy + cb_b[cb]);
      }
    }
  }
};

// -------------------------------------------------------------- resize ----

constexpr int kPrecisionBits = 32 - 8 - 2;

double bicubic(double x) {
  constexpr double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Resample.c precompute_coeffs + normalize_coeffs_8bpc.
int coeffs(int in_size, int out_size, std::vector<int>& bounds, std::vector<int32_t>& kk) {
  double scale = static_cast<double>(static_cast<float>(in_size)) / out_size;
  double filterscale = scale < 1.0 ? 1.0 : scale;
  double support = 2.0 * filterscale;
  int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(static_cast<size_t>(ksize));
  for (int xx = 0; xx < out_size; ++xx) {
    double center = (xx + 0.5) * scale;
    double ww = 0.0, ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    for (int x = 0; x < xmax; ++x) {
      double w = bicubic((x + xmin - center + 0.5) * ss);
      k[x] = w;
      ww += w;
    }
    for (int x = 0; x < xmax; ++x)
      if (ww != 0.0) k[x] /= ww;
    for (int x = 0; x < xmax; ++x) {
      double v = k[x];
      kk[static_cast<size_t>(xx) * ksize + x] =
          v < 0 ? static_cast<int32_t>(-0.5 + v * (1 << kPrecisionBits))
                : static_cast<int32_t>(0.5 + v * (1 << kPrecisionBits));
    }
    bounds[2 * xx] = xmin;
    bounds[2 * xx + 1] = xmax;
  }
  return ksize;
}

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

void resample_h(const uint8_t* in, int h, int w, int c, uint8_t* out, int ow) {
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  int ksize = coeffs(w, ow, bounds, kk);
  for (int y = 0; y < h; ++y) {
    const uint8_t* ip = in + static_cast<size_t>(y) * w * c;
    uint8_t* op = out + static_cast<size_t>(y) * ow * c;
    for (int xx = 0; xx < ow; ++xx) {
      int xmin = bounds[2 * xx], xmax = bounds[2 * xx + 1];
      const int32_t* k = kk.data() + static_cast<size_t>(xx) * ksize;
      for (int ch = 0; ch < c; ++ch) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < xmax; ++x) ss += ip[(x + xmin) * c + ch] * k[x];
        op[xx * c + ch] = clip8(ss);
      }
    }
  }
}

void resample_v(const uint8_t* in, int h, int w, int c, uint8_t* out, int oh) {
  std::vector<int> bounds;
  std::vector<int32_t> kk;
  int ksize = coeffs(h, oh, bounds, kk);
  size_t row = static_cast<size_t>(w) * c;
  std::vector<int32_t> acc(row);
  for (int yy = 0; yy < oh; ++yy) {
    int ymin = bounds[2 * yy], ymax = bounds[2 * yy + 1];
    const int32_t* k = kk.data() + static_cast<size_t>(yy) * ksize;
    for (size_t i = 0; i < row; ++i) acc[i] = 1 << (kPrecisionBits - 1);
    for (int y = 0; y < ymax; ++y) {
      const uint8_t* ip = in + static_cast<size_t>(y + ymin) * row;
      int32_t ky = k[y];
      for (size_t i = 0; i < row; ++i) acc[i] += ip[i] * ky;
    }
    uint8_t* op = out + static_cast<size_t>(yy) * row;
    for (size_t i = 0; i < row; ++i) op[i] = clip8(acc[i]);
  }
}

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 3) uint8, capacity `cap` bytes). With
// `out` null or too small it stops after the frame header and returns
// RF_NEED_BUFFER with the size in dims = (H, W). Returns RF_OK, RF_CORRUPT or
// RF_UNSUPPORTED (with a message in `err`).
int rf_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims,
                   char* err, int64_t err_cap) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.header();
    dims[0] = dec.height();
    dims[1] = dec.width();
    if (!out || cap < static_cast<int64_t>(dec.height()) * dec.width() * 3) return RF_NEED_BUFFER;
    dec.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("JPEG decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

// (h, w, c) uint8 -> (oh, ow, c) uint8, Pillow's bicubic Image.resize.
int rf_resize_bicubic(const uint8_t* in, int32_t h, int32_t w, int32_t c, uint8_t* out, int32_t oh,
                      int32_t ow) {
  if (h < 1 || w < 1 || c < 1 || oh < 1 || ow < 1) return RF_CORRUPT;
  try {
    size_t row = static_cast<size_t>(c);
    if (w == ow && h == oh) {
      memcpy(out, in, static_cast<size_t>(h) * w * row);
    } else if (h == oh) {
      resample_h(in, h, w, c, out, ow);
    } else if (w == ow) {
      resample_v(in, h, w, c, out, oh);
    } else {
      std::vector<uint8_t> tmp(static_cast<size_t>(h) * ow * row);
      resample_h(in, h, w, c, tmp.data(), ow);
      resample_v(tmp.data(), h, ow, c, out, oh);
    }
    return RF_OK;
  } catch (const std::exception&) {
    return RF_CORRUPT;
  }
}

// PNG filtered scanlines (h rows of 1 filter byte + stride bytes) -> (h, stride).
// Returns RF_OK, or RF_CORRUPT for an unknown filter type.
int rf_png_unfilter(const uint8_t* raw, int64_t h, int64_t stride, int32_t bpp, uint8_t* out) {
  for (int64_t y = 0; y < h; ++y) {
    const uint8_t* line = raw + y * (stride + 1);
    int ft = line[0];
    ++line;
    uint8_t* cur = out + y * stride;
    const uint8_t* prev = y ? cur - stride : nullptr;
    switch (ft) {
      case 0:
        memcpy(cur, line, static_cast<size_t>(stride));
        break;
      case 1:
        for (int64_t x = 0; x < stride; ++x)
          cur[x] = static_cast<uint8_t>(line[x] + (x >= bpp ? cur[x - bpp] : 0));
        break;
      case 2:
        for (int64_t x = 0; x < stride; ++x) cur[x] = static_cast<uint8_t>(line[x] + (prev ? prev[x] : 0));
        break;
      case 3:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = prev ? prev[x] : 0;
          cur[x] = static_cast<uint8_t>(line[x] + ((a + b) >> 1));
        }
        break;
      case 4:
        for (int64_t x = 0; x < stride; ++x) {
          int a = x >= bpp ? cur[x - bpp] : 0, b = prev ? prev[x] : 0;
          int c = (x >= bpp && prev) ? prev[x - bpp] : 0;
          int p = a + b - c, pa = p > a ? p - a : a - p, pb = p > b ? p - b : b - p,
              pc = p > c ? p - c : c - p;
          int pred = (pa <= pb && pa <= pc) ? a : (pb <= pc ? b : c);
          cur[x] = static_cast<uint8_t>(line[x] + pred);
        }
        break;
      default:
        return RF_CORRUPT;
    }
  }
  return RF_OK;
}

}  // extern "C"
