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
// What PIL cannot open either: refused for good, not queued.
[[noreturn]] void refused(const std::string& msg) {
  throw Fail{RF_UNSUPPORTED, msg + " is refused, as PIL refuses it"};
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
    if (would_smooth())
      unsupported("a progressive JPEG whose scans leave AC coefficients 1-9 unrefined (libjpeg's "
                  "block smoothing)");
    finish(out);
  }

  int width() const { return W_; }
  int height() const { return H_; }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int W_ = 0, H_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool have_frame_ = false, jfif_ = false, adobe_ = false, progressive_ = false;
  int eobrun_ = 0;
  int coef_bits_[4][64];  // jdphuff.c: the Al of each coefficient's last scan, -1 before any
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
        frame(end, false);
        break;
      case 0xC2:
        frame(end, true);
        break;
      case 0xC3:
        unsupported("lossless JPEG");
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        refused("hierarchical (differential) JPEG");
      case 0xC9:
      case 0xCA:
      case 0xCC:
        unsupported("arithmetic-coded JPEG");
      case 0xCB:
        unsupported("arithmetic-coded lossless JPEG");
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

  void frame(size_t end, bool progressive) {
    if (have_frame_) corrupt("two frames in one JPEG");
    if (end - pos_ < 6) corrupt("bad SOF segment");
    progressive_ = progressive;
    int precision = byte();
    H_ = word();
    W_ = word();
    int nc = byte();
    if (precision != 8) refused(std::to_string(precision) + "-bit JPEG");
    if (nc != 1 && nc != 3 && nc != 4) refused(std::to_string(nc) + "-component JPEG");
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
    for (auto& row : coef_bits_)
      for (int& b : row) b = -1;
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
    int ah = ahal >> 4, al = ahal & 15;
    if (!progressive_) {
      if (ss != 0 || se != 63 || ahal != 0) corrupt("bad sequential scan parameters");
    } else {  // jdphuff.c start_pass_phuff_decoder
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13 || bad) corrupt("bad progressive scan parameters");
      for (auto* c : sc) {
        int* cb = coef_bits_[c - comps_.data()];
        for (int k = ss; k <= se; ++k) cb[k] = al;
      }
    }
    int blocks_in_mcu = 0;
    for (auto* c : sc) {
      bool needs_dc = !progressive_ || (ss == 0 && ah == 0), needs_ac = !progressive_ || ss != 0;
      if ((needs_dc && !dc_[c->td].present) || (needs_ac && !ac_[c->ta].present))
        corrupt("missing Huffman table");
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
    eobrun_ = 0;
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
        eobrun_ = 0;
      }
      int mxi = static_cast<int>(m % mx), myi = static_cast<int>(m / mx);
      for (int ci = 0; ci < ns; ++ci) {
        Component* c = sc[ci];
        int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
        for (int by = 0; by < bh; ++by)
          for (int bx = 0; bx < bwn; ++bx) {
            int row = ns == 1 ? myi : myi * c->v + by, col = ns == 1 ? mxi : mxi * c->h + bx;
            int16_t* blk = c->coef.data() + (static_cast<size_t>(row) * c->bw + col) * 64;
            if (!progressive_)
              block(br, *c, pred[ci], blk);
            else if (ss == 0)
              ah == 0 ? dc_first(br, *c, pred[ci], blk, al) : dc_refine(br, blk, al);
            else
              ah == 0 ? ac_first(br, *c, blk, ss, se, al) : ac_refine(br, *c, blk, ss, se, al);
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

  // jdphuff.c decode_mcu_DC_first / _DC_refine / _AC_first / _AC_refine, one block each.
  inline void dc_first(BitReader& br, const Component& c, int& pred, int16_t* blk, int al) {
    int s = br.decode(dc_[c.td]);
    pred += s ? extend(br.bits(s), s) : 0;
    blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(pred) << al));
  }

  inline void dc_refine(BitReader& br, int16_t* blk, int al) {
    if (br.bits(1)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
  }

  inline void ac_first(BitReader& br, const Component& c, int16_t* blk, int ss, int se, int al) {
    if (eobrun_ > 0) {
      --eobrun_;
      return;
    }
    const Huffman& ac = ac_[c.ta];
    for (int k = ss; k <= se; ++k) {
      int rs = br.decode(ac);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) corrupt("bad JPEG coefficient index");
        int v = extend(br.bits(s), s);
        blk[kZigzag[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
      } else if (r == 15) {
        k += 15;
      } else {
        eobrun_ = 1 << r;
        if (r) eobrun_ += br.bits(r);
        --eobrun_;
        break;
      }
    }
  }

  inline void ac_refine(BitReader& br, const Component& c, int16_t* blk, int ss, int se, int al) {
    const int p1 = 1 << al, m1 = -(1 << al);
    const Huffman& ac = ac_[c.ta];
    int k = ss;
    auto correct = [&](int16_t& coef) {
      if (br.bits(1) && (coef & p1) == 0) coef = static_cast<int16_t>(coef + (coef >= 0 ? p1 : m1));
    };
    if (eobrun_ == 0) {
      for (; k <= se; ++k) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.bits(1) ? p1 : m1;  // a new coefficient's size is always 1
        } else if (r != 15) {
          eobrun_ = 1 << r;
          if (r) eobrun_ += br.bits(r);
          break;
        }
        do {
          int16_t& coef = blk[kZigzag[k]];
          if (coef != 0) {
            correct(coef);
          } else if (--r < 0) {
            break;
          }
          ++k;
        } while (k <= se);
        if (s) blk[kZigzag[k]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun_ > 0) {
      for (; k <= se; ++k) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef != 0) correct(coef);
      }
      --eobrun_;
    }
  }

  // jdcoefct.c smoothing_ok: libjpeg smooths across blocks (decompress_smooth_data)
  // when a progressive file leaves any of the first 9 AC coefficients of a
  // component unrefined, its DC is known and the 10 quantizers are nonzero.
  bool would_smooth() const {
    if (!progressive_) return false;
    static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      for (int p : kPos)
        if (comps_[ci].quant[p] == 0) return false;
      if (coef_bits_[ci][0] < 0) return false;
      for (int k = 1; k < 10; ++k)
        if (coef_bits_[ci][k] != 0) useful = true;
    }
    return useful;
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
    // jdcolor.c build_ycc_rgb_table (the YCCK -> CMYK conversion shares it)
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
    if (comps_.size() == 4) {
      // jdapimin.c: an Adobe transform other than 0 means YCCK (jdcolor.c
      // ycck_cmyk_convert), else straight CMYK. PIL reads the CMYK as "CMYK;I"
      // (every channel inverted, Adobe's polarity) and converts it to RGB by
      // Convert.c cmyk2rgb: nk = 255 - k, out = nk - nk * c / 255 (MULDIV255).
      const bool ycck = adobe_ && adobe_transform_ != 0;
      auto muldiv255 = [](int a, int b) { int t = a * b + 128; return ((t >> 8) + t) >> 8; };
      for (int y = 0; y < H_; ++y) {
        const uint8_t *p0 = plane_row(0, y), *p1 = plane_row(1, y), *p2 = plane_row(2, y), *p3 = plane_row(3, y);
        uint8_t* o = out + static_cast<size_t>(y) * W_ * 3;
        for (int x = 0; x < W_; ++x) {
          int cmy[3] = {p0[x], p1[x], p2[x]};
          if (ycck) {
            int yy = p0[x], cb = p1[x], cr = p2[x];
            cmy[0] = clamp(255 - (yy + cr_r[cr]));
            cmy[1] = clamp(255 - (yy + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB)));
            cmy[2] = clamp(255 - (yy + cb_b[cb]));
          }
          int nk = p3[x];  // 255 - (255 - K)
          for (int k = 0; k < 3; ++k) o[3 * x + k] = clamp(nk - muldiv255(255 - cmy[k], nk));
        }
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
    // jdcolor.c ycc_rgb_convert
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

// ------------------------------------------------------------ JPEG writer ----
//
// PIL's default `Image.save(buf, format="JPEG")` of an RGB image, byte for
// byte: libjpeg(-turbo) with quality 75 and 4:2:0 sampling, in the marker
// order PIL writes (SOI, APP0 JFIF 1.01 without density units, the two DQT
// segments, SOF0, the four standard DHT segments, one interleaved SOS, EOI).
// The encode path is libjpeg's: jccolor.c's fixed-point RGB -> YCbCr (SCALEBITS
// 16, Cb/Cr rounded with ONE_HALF - 1), jcprepct.c's edge replication (the
// last row repeated to the row group and to the iMCU height, the last column
// to the blocks' width), jcsample.c's h2v2 box average with the bias
// alternating 1, 2 along the row, jfdctint.c's islow forward DCT on samples
// less 128, jcdctmgr.c's quantization (round half away from zero by the
// divisor quant * 8), jccoefct.c's dummy blocks past the image (AC 0, DC of
// the previous block of the MCU) and jchuff.c's standard tables (Annex K.3),
// 0xFF byte stuffing and the final pad with 1 bits.

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChrQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99, 24, 26, 56, 99, 99, 99,
    99, 99, 47, 66, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChrBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 125};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61, 0x07, 0x22,
    0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33,
    0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x34,
    0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55,
    0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76,
    0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96,
    0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5,
    0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4,
    0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1,
    0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChrBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 119};
const uint8_t kAcChrVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61, 0x71, 0x13,
    0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62,
    0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26, 0x27, 0x28, 0x29,
    0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54,
    0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94,
    0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3,
    0xb4, 0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2,
    0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea,
    0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jchuff.c jpeg_make_c_derived_tbl
struct HuffEnc {
  uint32_t code[256] = {0};
  uint8_t size[256] = {0};
  HuffEnc(const uint8_t* bits, const uint8_t* vals) {
    int p = 0;
    uint32_t c = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++p) {
        code[vals[p]] = c++;
        size[vals[p]] = static_cast<uint8_t>(l);
      }
      c <<= 1;
    }
  }
};

class BitWriter {
 public:
  explicit BitWriter(std::vector<uint8_t>& out) : out_(out) {}
  void put(uint32_t code, int size) {
    acc_ = (acc_ << size) | (code & ((1u << size) - 1));
    n_ += size;
    while (n_ >= 8) {
      uint8_t b = static_cast<uint8_t>(acc_ >> (n_ - 8));
      out_.push_back(b);
      if (b == 0xFF) out_.push_back(0);
      n_ -= 8;
    }
    acc_ &= (uint64_t(1) << n_) - 1;
  }
  void flush() {  // jchuff.c flush_bits: pad the last byte with 1 bits
    if (n_) put((1u << (8 - n_)) - 1, 8 - n_);
  }

 private:
  std::vector<uint8_t>& out_;
  uint64_t acc_ = 0;
  int n_ = 0;
};

// jfdctint.c jpeg_fdct_islow + jcdctmgr.c quantize on one 8x8 block of
// samples (row stride `stride`) -> quantized coefficients, natural order.
void fdct_quantize(const uint8_t* in, int stride, const int32_t* divisors, int16_t* out) {
  constexpr int CB = 13, P1 = 2;
  constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                    F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                    F2562 = 20995, F3072 = 25172;
  auto descale = [](int64_t x, int n) { return (x + (int64_t(1) << (n - 1))) >> n; };
  int64_t d[64];
  for (int r = 0; r < 8; ++r)
    for (int c = 0; c < 8; ++c) d[r * 8 + c] = static_cast<int64_t>(in[r * stride + c]) - 128;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass ? 8 : 1, next = pass ? 1 : 8;
    for (int i = 0; i < 8; ++i) {
      int64_t* p = d + i * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      const int s = pass ? CB + P1 : CB - P1;
      if (pass) {
        p[0] = descale(tmp10 + tmp11, P1);
        p[4 * step] = descale(tmp10 - tmp11, P1);
      } else {
        p[0] = (tmp10 + tmp11) * (1 << P1);
        p[4 * step] = (tmp10 - tmp11) * (1 << P1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, s);
      p[6 * step] = descale(z1 + tmp12 * -F1847, s);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298; tmp5 *= F2053; tmp6 *= F3072; tmp7 *= F1501;
      z1 *= -F0899; z2 *= -F2562; z3 *= -F1961; z4 *= -F0390;
      z3 += z5; z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, s);
      p[5 * step] = descale(tmp5 + z2 + z4, s);
      p[3 * step] = descale(tmp6 + z2 + z3, s);
      p[step] = descale(tmp7 + z1 + z4, s);
    }
  }
  for (int i = 0; i < 64; ++i) {
    int64_t q = divisors[i], t = d[i];
    out[i] = static_cast<int16_t>(t < 0 ? -((-t + (q >> 1)) / q) : (t + (q >> 1)) / q);
  }
}

void encode_block(BitWriter& bw, const int16_t* blk, int& last_dc, const HuffEnc& dc, const HuffEnc& ac) {
  auto nbits_of = [](int v) { int n = 0; while (v) { ++n; v >>= 1; } return n; };
  int t = blk[0] - last_dc, t2 = t;
  last_dc = blk[0];
  if (t < 0) { t = -t; --t2; }
  int nb = nbits_of(t);
  bw.put(dc.code[nb], dc.size[nb]);
  if (nb) bw.put(static_cast<uint32_t>(t2), nb);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    t = blk[kZigzag[k]];
    if (t == 0) { ++run; continue; }
    while (run > 15) { bw.put(ac.code[0xF0], ac.size[0xF0]); run -= 16; }
    t2 = t;
    if (t < 0) { t = -t; --t2; }
    nb = nbits_of(t);
    int sym = (run << 4) + nb;
    bw.put(ac.code[sym], ac.size[sym]);
    bw.put(static_cast<uint32_t>(t2), nb);
    run = 0;
  }
  if (run) bw.put(ac.code[0], ac.size[0]);
}

void put_marker(std::vector<uint8_t>& o, int m, const std::vector<uint8_t>& body) {
  o.push_back(0xFF);
  o.push_back(static_cast<uint8_t>(m));
  size_t len = body.size() + 2;
  o.push_back(static_cast<uint8_t>(len >> 8));
  o.push_back(static_cast<uint8_t>(len & 0xFF));
  o.insert(o.end(), body.begin(), body.end());
}

std::vector<uint8_t> encode_jpeg(const uint8_t* rgb, int H, int W) {
  constexpr int SB = 16;
  constexpr int64_t HALF = int64_t(1) << (SB - 1), CBCR_OFF = int64_t(128) << SB;
  auto fix = [](double v) { return static_cast<int64_t>(v * (1 << SB) + 0.5); };
  // jccolor.c rgb_ycc_convert on the whole image
  std::vector<uint8_t> ycc(static_cast<size_t>(H) * W * 3);
  for (size_t i = 0; i < static_cast<size_t>(H) * W; ++i) {
    int64_t r = rgb[3 * i], g = rgb[3 * i + 1], b = rgb[3 * i + 2];
    ycc[3 * i] = static_cast<uint8_t>((fix(0.29900) * r + fix(0.58700) * g + fix(0.11400) * b + HALF) >> SB);
    ycc[3 * i + 1] = static_cast<uint8_t>(
        (-fix(0.16874) * r - fix(0.33126) * g + fix(0.50000) * b + CBCR_OFF + HALF - 1) >> SB);
    ycc[3 * i + 2] = static_cast<uint8_t>(
        (fix(0.50000) * r - fix(0.41869) * g - fix(0.08131) * b + CBCR_OFF + HALF - 1) >> SB);
  }
  const int mcux = (W + 15) / 16, mcuy = (H + 15) / 16;
  const int ywb = (W + 7) / 8, yhb = (H + 7) / 8;  // Y blocks holding samples
  auto px = [&](int r, int c, int ch) {
    r = r < H ? r : H - 1;
    c = c < W ? c : W - 1;
    return ycc[(static_cast<size_t>(r) * W + c) * 3 + ch];
  };
  // Y: the last column repeated to ywb * 8, the last row to the iMCU height
  const int yw = ywb * 8, yh = mcuy * 16;
  std::vector<uint8_t> yp(static_cast<size_t>(yw) * yh);
  for (int r = 0; r < yh; ++r)
    for (int c = 0; c < yw; ++c) yp[static_cast<size_t>(r) * yw + c] = px(r, c, 0);
  // Cb, Cr: h2v2 over the rows padded to a pair and the columns to 2 * mcux * 8,
  // then the last chroma row repeated to the iMCU height
  const int cw = mcux * 8, ch = mcuy * 8, crows = (H + 1) / 2;
  std::vector<uint8_t> cp[2] = {std::vector<uint8_t>(static_cast<size_t>(cw) * ch),
                                std::vector<uint8_t>(static_cast<size_t>(cw) * ch)};
  for (int k = 0; k < 2; ++k)
    for (int r = 0; r < ch; ++r) {
      int rr = r < crows ? r : crows - 1;
      int bias = 1;
      for (int c = 0; c < cw; ++c) {
        int s = px(2 * rr, 2 * c, k + 1) + px(2 * rr, 2 * c + 1, k + 1) + px(2 * rr + 1, 2 * c, k + 1) +
                px(2 * rr + 1, 2 * c + 1, k + 1);
        cp[k][static_cast<size_t>(r) * cw + c] = static_cast<uint8_t>((s + bias) >> 2);
        bias ^= 3;
      }
    }
  // jcparam.c jpeg_set_quality(75): scale factor 50, baseline-clamped
  int32_t qtab[2][64], div[2][64];
  for (int i = 0; i < 64; ++i) {
    const uint8_t* std_tab[2] = {kStdLumQ, kStdChrQ};
    for (int t = 0; t < 2; ++t) {
      int32_t q = (std_tab[t][i] * 50 + 50) / 100;
      q = q < 1 ? 1 : (q > 255 ? 255 : q);
      qtab[t][i] = q;
      div[t][i] = q << 3;
    }
  }
  std::vector<uint8_t> o = {0xFF, 0xD8};
  put_marker(o, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < 2; ++t) {
    std::vector<uint8_t> body = {static_cast<uint8_t>(t)};
    for (int i = 0; i < 64; ++i) body.push_back(static_cast<uint8_t>(qtab[t][kZigzag[i]]));
    put_marker(o, 0xDB, body);
  }
  put_marker(o, 0xC0, {8, static_cast<uint8_t>(H >> 8), static_cast<uint8_t>(H), static_cast<uint8_t>(W >> 8),
                       static_cast<uint8_t>(W), 3, 1, 0x22, 0, 2, 0x11, 1, 3, 0x11, 1});
  const uint8_t* tables[4][2] = {{kDcLumBits, kDcVals}, {kAcLumBits, kAcLumVals},
                                 {kDcChrBits, kDcVals}, {kAcChrBits, kAcChrVals}};
  const uint8_t ids[4] = {0x00, 0x10, 0x01, 0x11};
  for (int t = 0; t < 4; ++t) {
    std::vector<uint8_t> body = {ids[t]};
    int n = 0;
    for (int l = 0; l < 16; ++l) {
      body.push_back(tables[t][0][l]);
      n += tables[t][0][l];
    }
    body.insert(body.end(), tables[t][1], tables[t][1] + n);
    put_marker(o, 0xC4, body);
  }
  put_marker(o, 0xDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});
  const HuffEnc dc_l(kDcLumBits, kDcVals), ac_l(kAcLumBits, kAcLumVals), dc_c(kDcChrBits, kDcVals),
      ac_c(kAcChrBits, kAcChrVals);
  BitWriter bw(o);
  int last_dc[3] = {0, 0, 0};
  int16_t mcu[6][64];
  for (int my = 0; my < mcuy; ++my)
    for (int mx = 0; mx < mcux; ++mx) {
      int blkn = 0;
      for (int by = 0; by < 2; ++by)
        for (int bx = 0; bx < 2; ++bx, ++blkn) {
          int row = my * 2 + by, col = mx * 2 + bx;
          if (row < yhb && col < ywb) {
            fdct_quantize(yp.data() + static_cast<size_t>(row) * 8 * yw + col * 8, yw, div[0], mcu[blkn]);
          } else {  // jccoefct.c dummy block: AC 0, the previous block's DC
            memset(mcu[blkn], 0, sizeof(mcu[blkn]));
            mcu[blkn][0] = mcu[blkn - 1][0];
          }
        }
      for (int k = 0; k < 2; ++k, ++blkn)
        fdct_quantize(cp[k].data() + static_cast<size_t>(my) * 8 * cw + mx * 8, cw, div[1], mcu[blkn]);
      for (int b = 0; b < 4; ++b) encode_block(bw, mcu[b], last_dc[0], dc_l, ac_l);
      encode_block(bw, mcu[4], last_dc[1], dc_c, ac_c);
      encode_block(bw, mcu[5], last_dc[2], dc_c, ac_c);
    }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

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

// (h, w, 3) uint8 RGB -> PIL's default JPEG save of it in `out` (capacity
// `cap` bytes); the length goes to *n. Returns RF_OK, RF_NEED_BUFFER when
// `out` is null or too small (*n is then the length), or RF_CORRUPT for an
// image outside 1..65535 pixels a side.
int rf_jpeg_encode(const uint8_t* rgb, int32_t h, int32_t w, uint8_t* out, int64_t cap, int64_t* n) {
  if (h < 1 || w < 1 || h > 65535 || w > 65535) return RF_CORRUPT;
  try {
    std::vector<uint8_t> data = encode_jpeg(rgb, h, w);
    *n = static_cast<int64_t>(data.size());
    if (!out || cap < *n) return RF_NEED_BUFFER;
    memcpy(out, data.data(), data.size());
    return RF_OK;
  } catch (const std::exception&) {
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
