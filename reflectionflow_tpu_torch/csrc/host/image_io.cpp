// Host image codecs of the GenRef data path, behind a plain C interface
// (bound with ctypes in `utils/image_io.py`, built with g++ by
// `ops/kernel_build.py::build_host`):
//
//   * rf_jpeg_decode: every JPEG that PIL's libjpeg-turbo 3.1 decodes at 8
//     bits, as it decodes it: sequential and progressive DCT frames, Huffman
//     or arithmetic-coded (jdarith.c, with DAC conditioning), and lossless
//     frames (SOF3: predictors 1-7, point transform, restarts; jdlossls.c);
//     1 (grey), 3 (YCbCr, or RGB per the Adobe marker / component ids) or 4
//     (CMYK, YCCK) components, any integral sampling, restart intervals,
//     several scans. The DCT path is the accurate integer IDCT in the 16-bit
//     arithmetic of libjpeg-turbo's x86-64 SIMD routines (jidctint-sse2.asm;
//     the AVX2 one computes the same), which PIL runs, so that coefficients
//     past the 16-bit range decode as there; libjpeg-turbo's block smoothing of progressive files
//     whose scans leave AC coefficients 1-9 unrefined (jdcoefct.c
//     decompress_smooth_data), fancy upsampling (jdsample.c h2v1 / h2v2 /
//     h1v2 triangle filters over edge-replicated planes, box replication
//     when the chroma is at most 2 samples wide, and always for lossless
//     frames) and the fixed-point YCbCr -> RGB tables (jdcolor.c, SCALEBITS
//     16). What PIL refuses (12-bit and hierarchical frames, arithmetic-coded
//     lossless frames, fractional sampling, height 0, colour conversion of a
//     lossless frame) returns RF_REFUSED; corrupt or truncated data and
//     missing tables return RF_CORRUPT. Every read is bounded by the buffer.
//   * rf_jpeg_tiff_decode: one strip or tile of a JPEG-compressed TIFF as
//     libtiff's tif_jpeg.c has libjpeg decode it (JPEGTables then the
//     abbreviated strip, libtiff's colour space and checks, libjpeg's reading
//     of damaged data; `Decoder::lenient`), for `tiff.cpp`.
//   * rf_jpeg_ojpeg_decode: the stream tif_ojpeg.c rebuilds for an old-style
//     JPEG TIFF, decoded to raw components as libjpeg gives them there, for
//     `tiff.cpp`.
//   * rf_resize_bicubic: Pillow's 8-bit ImagingResample with the bicubic
//     filter (a = -0.5, support 2 * max(scale, 1), coefficients normalized in
//     double and rounded to 22 fractional bits, width pass then height pass,
//     each only when that size changes).
//   * rf_png_unfilter: undoes PNG scanline filters (None, Sub, Up, Average,
//     Paeth).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "codec_common.h"
#include "status.h"

namespace {

// ---------------------------------------------------------------- JPEG ----

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,  12, 19, 26, 33,
    40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28, 35, 42, 49, 56, 57, 50, 43, 36,
    29, 22, 15, 23, 30, 37, 44, 51, 58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54,
    47, 55, 62, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

constexpr int kLookBits = 9;

struct Huffman {
  bool present = false;
  int max_sym = 0;  // checked per scan: 15 for a DCT DC table, 16 for a lossless one
  uint8_t vals[256] = {0};
  int32_t maxcode[18] = {0};
  int32_t valoffset[18] = {0};
  uint16_t look[1 << kLookBits] = {0};  // (length << 8) | symbol; length 0: slow path

  // jdhuff.c jpeg_make_d_derived_tbl
  void build(const uint8_t* bits, const uint8_t* values, int nvals) {
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
    max_sym = 0;
    for (int i = 0; i < nvals; ++i) max_sym = values[i] > max_sym ? values[i] : max_sym;
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
  // lossless: the differences ((bh * bw) samples, the MCU grid), the scan's
  // predictor and point transform, and the rows undifferenced as a first row
  std::vector<int32_t> diff;
  int psv = 0, pt = 0;
  std::vector<uint8_t> first_row;
  std::vector<uint8_t> plane;  // (hblocks * 8) x (wblocks * 8) samples
};

class BitReader {
 public:
  BitReader(const uint8_t* d, size_t end, size_t pos, bool lenient = false)
      : d_(d), end_(end), pos_(pos), lenient_(lenient) {}

  size_t pos() const { return pos_; }
  void set_pos(size_t p) { pos_ = p; buf_ = 0; cnt_ = 0; fake_ = 0; marker_ = false; eod_ = false; }
  // True once bits past the data (or past a marker) were consumed.
  bool overran() const { return cnt_ < fake_; }
  bool at_end() const { return eod_; }  // the bits faked are past the data's end, not a marker

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
        size_t q = pos_ + 1;
        if (c == 0xFF && lenient_)  // jdhuff.c jpeg_fill_bit_buffer: fill bytes FF FF ... before a 00 or a marker
          while (q < end_ && d_[q] == 0xFF) ++q;
        if (c == 0xFF) {
          if (q >= end_) {
            eod_ = true;
            fake_ += 8;
          } else if (d_[q] == 0x00) {
            b = 0xFF;
            pos_ = q + 1;
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
    if (!lenient_) corrupt("bad Huffman code");
    fill();  // jdhuff.c jpeg_huff_decode: 17 bits read, a zero faked
    skip(17);
    return 0;
  }
  bool lenient() const { return lenient_; }

 private:
  const uint8_t* d_;
  size_t end_, pos_;
  uint64_t buf_ = 0;
  int cnt_ = 0, fake_ = 0;
  bool marker_ = false, eod_ = false;
  bool lenient_ = false;
};

inline int extend(int x, int s) { return x < (1 << (s - 1)) ? x - (1 << s) + 1 : x; }

// T.81 Table D.2, packed as libjpeg's jaricom.c packs it:
// (Qe << 16) | (Next_Index_MPS << 8) | (Switch_MPS << 7) | Next_Index_LPS.
const uint32_t kAriTab[114] = {
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
};

// jdarith.c arith_decode: the QM decoder with libjpeg's C register layout. A
// marker met in the data is left unread and zeros are decoded from then on.
class ArithDecoder {
 public:
  ArithDecoder(const uint8_t* d, size_t n, size_t pos) : d_(d), n_(n), pos_(pos) {}

  void reset() {
    c_ = 0;
    a_ = 0;
    ct_ = -16;
  }
  size_t pos() const { return pos_; }
  int unread_marker() const { return marker_; }
  size_t marker_pos() const { return marker_pos_; }
  void take_marker(size_t after) {
    marker_ = 0;
    pos_ = after;
  }
  bool overran() const { return overran_; }

  int decode(uint8_t* st) {
    while (a_ < 0x8000) {
      if (--ct_ < 0) {
        int data = 0;
        if (!marker_) {
          data = byte();
          if (data == 0xFF) {
            const size_t at = pos_ - 1;
            do data = byte(); while (data == 0xFF && !overran_);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker_ = data;
              marker_pos_ = at;
              data = 0;
            }
          }
        }
        c_ = (c_ << 8) | data;
        if ((ct_ += 8) < 0)
          if (++ct_ == 0) a_ = 0x8000;
      }
      a_ <<= 1;
    }
    int sv = *st;
    int64_t qe = kAriTab[sv & 0x7F];
    const int nl = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    const int nm = static_cast<int>(qe & 0xFF);
    qe >>= 8;
    int64_t temp = a_ - qe;
    a_ = temp;
    temp <<= ct_;
    if (c_ >= temp) {
      c_ -= temp;
      if (a_ < qe) {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      } else {
        a_ = qe;
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a_ < 0x8000) {
      if (a_ < qe) {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = static_cast<uint8_t>((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  int64_t c_ = 0, a_ = 0;
  int ct_ = -16, marker_ = 0;
  size_t marker_pos_ = 0;
  bool overran_ = false;

  int byte() {
    if (pos_ >= n_) {
      overran_ = true;
      return 0;
    }
    return d_[pos_++];
  }
};

// libjpeg-turbo 3.1's SIMD accurate integer IDCT (jidctint-sse2.asm; the AVX2
// routine computes the same), which PIL runs on every x86-64 machine: the
// arithmetic of jidctint.c (CONST_BITS 13, PASS1_BITS 2) in 16-bit lanes.
// Dequantization is pmullw (the product's low 16 bits), the even and odd
// sums in0 +/- in4, in3 + in7 and in1 + in5 are paddw / psubw (16-bit, they
// wrap), the products pmaddwd pairs (exact in 32 bits), the other sums paddd
// (32-bit, they wrap); each pass descales and saturates to 16 bits
// (packssdw), and pass 2 saturates to 8 bits (packsswb) before adding 128.
// A block whose rows 1-7 are all zero takes pass 1's shortcut: DC << 2 in 16
// bits (psllw). Pass 2 has no shortcut. For coefficients whose IDCT stays in
// range this equals jidctint.c.
inline int16_t wrap16(int32_t x) { return static_cast<int16_t>(static_cast<uint16_t>(static_cast<uint32_t>(x))); }
inline int32_t add32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}
inline int32_t sub32(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}
inline int16_t sat16(int32_t x) { return static_cast<int16_t>(x < -32768 ? -32768 : (x > 32767 ? 32767 : x)); }

// One 8-point pass over 8 lanes: x[k * 8 + l] is input k of lane l, o[k * 8
// + l] its output k, descaled by `shift` and saturated to 16 bits.
inline void idct_lanes(const int16_t* x, int shift, int16_t* o) {
  constexpr int32_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373, F1175 = 9633,
                    F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;
  const int32_t r = 1 << (shift - 1);
  for (int l = 0; l < 8; ++l) {
    const int32_t in0 = x[l], in1 = x[8 + l], in2 = x[16 + l], in3 = x[24 + l], in4 = x[32 + l], in5 = x[40 + l],
                  in6 = x[48 + l], in7 = x[56 + l];
    // even part
    const int32_t tmp3 = add32(in2 * (F0541 + F0765), in6 * F0541);
    const int32_t tmp2 = add32(in2 * F0541, in6 * (F0541 - F1847));
    const int32_t tmp0 = static_cast<int32_t>(static_cast<uint32_t>(wrap16(in0 + in4)) << 13);
    const int32_t tmp1 = static_cast<int32_t>(static_cast<uint32_t>(wrap16(in0 - in4)) << 13);
    const int32_t tmp10 = add32(tmp0, tmp3), tmp13 = sub32(tmp0, tmp3), tmp11 = add32(tmp1, tmp2),
                  tmp12 = sub32(tmp1, tmp2);
    // odd part
    const int32_t z3 = wrap16(in3 + in7), z4 = wrap16(in1 + in5);
    const int32_t z3m = add32(z3 * (F1175 - F1961), z4 * F1175);
    const int32_t z4m = add32(z3 * F1175, z4 * (F1175 - F0390));
    const int32_t o0 = add32(add32(in7 * (F0298 - F0899), in1 * -F0899), z3m);
    const int32_t o3 = add32(add32(in7 * -F0899, in1 * (F1501 - F0899)), z4m);
    const int32_t o1 = add32(add32(in5 * (F2053 - F2562), in3 * -F2562), z4m);
    const int32_t o2 = add32(add32(in5 * -F2562, in3 * (F3072 - F2562)), z3m);
    o[l] = sat16(add32(add32(tmp10, o3), r) >> shift);
    o[56 + l] = sat16(add32(sub32(tmp10, o3), r) >> shift);
    o[8 + l] = sat16(add32(add32(tmp11, o2), r) >> shift);
    o[48 + l] = sat16(add32(sub32(tmp11, o2), r) >> shift);
    o[16 + l] = sat16(add32(add32(tmp12, o1), r) >> shift);
    o[40 + l] = sat16(add32(sub32(tmp12, o1), r) >> shift);
    o[24 + l] = sat16(add32(add32(tmp13, o0), r) >> shift);
    o[32 + l] = sat16(add32(sub32(tmp13, o0), r) >> shift);
  }
}

void idct_islow(const int16_t* in, const int32_t* q, uint8_t* out, int stride) {
  constexpr int CB = 13, P1 = 2;
  int16_t dq[64], ws[64], wt[64], res[64];
  for (int i = 0; i < 64; ++i)
    dq[i] = wrap16(static_cast<int32_t>(static_cast<uint32_t>(in[i]) * static_cast<uint32_t>(q[i])));
  int16_t ac = 0;
  for (int i = 8; i < 64; ++i) ac |= in[i];
  if (!ac) {
    for (int c = 0; c < 8; ++c) {
      const int16_t dc = wrap16(static_cast<int32_t>(static_cast<uint32_t>(dq[c]) << P1));
      for (int r = 0; r < 8; ++r) wt[c * 8 + r] = dc;
    }
  } else {
    idct_lanes(dq, CB - P1, ws);
    for (int r = 0; r < 8; ++r)
      for (int c = 0; c < 8; ++c) wt[c * 8 + r] = ws[r * 8 + c];
  }
  idct_lanes(wt, CB + P1 + 3, res);  // lanes are the rows: res[c * 8 + r]
  for (int r = 0; r < 8; ++r) {
    uint8_t* op = out + r * stride;
    for (int c = 0; c < 8; ++c) {
      const int v = res[c * 8 + r];
      op[c] = static_cast<uint8_t>((v < -128 ? -128 : (v > 127 ? 127 : v)) + 128);
    }
  }
}

// jdsample.c: a downsampled plane (dw x dh, row stride `ps`) -> its
// (ceil to W) x H upsampled plane `out` for expansion (eh, ev).
void upsample(const uint8_t* in, int dw, int dh, int ps, int eh, int ev, uint8_t* out, int W,
              int H, bool fancy) {
  std::vector<uint8_t> row(static_cast<size_t>(dw) * eh + 2);
  auto src = [&](int r) { return in + static_cast<size_t>(r < 0 ? 0 : (r >= dh ? dh - 1 : r)) * ps; };
  // (Lossless frames: libjpeg's DCT size 1 turns fancy upsampling off.)
  if (fancy && eh == 2 && ev == 2 && dw > 2) {  // h2v2_fancy_upsample
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
  } else if (fancy && eh == 2 && ev == 1 && dw > 2) {  // h2v1_fancy_upsample
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
  } else if (fancy && eh == 1 && ev == 2) {  // h1v2_fancy_upsample
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

void std_huffman(bool ac, int slot, Huffman& h);

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
        // tif_jpeg.c ignores what jpeg_finish_decompress meets once every row is out
        if (lenient_ && !progressive_ && !arith_ && !lossless_ && all_scanned()) break;
        continue;
      }
      segment(m);
    }
    for (auto& c : comps_)
      if (!c.scanned) corrupt("a component has no scan");
    finish(out, would_smooth());
  }

  int width() const { return W_; }
  int height() const { return H_; }
  int components() const { return static_cast<int>(comps_.size()); }
  bool all_scanned() const {
    for (const auto& c : comps_)
      if (!c.scanned) return false;
    return true;
  }
  const Component& component(int i) const { return comps_[static_cast<size_t>(i)]; }
  // libtiff's choice of colour space (tif_jpeg.c JPEGPreDecode) in place of
  // libjpeg's guess: 1 converts YCbCr to RGB whatever the markers say, 0
  // returns the components as they are (one byte each, interleaved).
  void force_colour(int f) { force_ = f; }
  // tif_ojpeg.c's session: restart intervals read as libjpeg reads them in
  // damaged data (the bits left in the interval discarded, the bytes before
  // the next marker skipped), and a marker there other than the expected
  // restart marker fatal (OJPEGLibjpegJpegSourceMgrResyncToRestart): the
  // decoding stops before the MCU row it falls in (`fatal_row`).
  // `premature`: the stream stops without EOI (tif_ojpeg.c's source ran
  // out), and reading past it is fatal too.
  void ojpeg(bool on, bool premature = false) {
    ojpeg_ = on;
    premature_ = premature;
  }
  int fatal_row() const { return fatal_row_; }
  // The scans up to EOI, then each component's IDCT output (`plane`,
  // wblocks * 8 x hblocks * 8 samples) with no upsampling or colour
  // conversion: libjpeg's raw_data_out.
  void decode_raw() {
    for (;;) {
      int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) {
        scan();
        if (all_scanned()) break;
        continue;
      }
      segment(m);
    }
    for (auto& c : comps_) {
      if (!c.scanned) corrupt("a component has no scan");
      const int ps = c.wblocks * 8;
      c.plane.assign(static_cast<size_t>(ps) * c.hblocks * 8, 0);
      for (int by = 0; by < c.hblocks; ++by)
        for (int bx = 0; bx < c.wblocks; ++bx)
          idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                     c.plane.data() + static_cast<size_t>(by) * 8 * ps + bx * 8, ps);
    }
  }
  // libjpeg's reading of damaged sequential Huffman data as tif_jpeg.c runs
  // it (the whole strip, a fake EOI past it, errors after the last row
  // ignored): entropy data that runs out or meets a marker ends the scan's
  // decoding (the MCU in progress read on with zero bits, the rest left
  // zero), a bad Huffman code reads 17 bits as a zero, a coefficient past 63
  // lands on 63, sequential scan parameters other than 0-63 are a warning,
  // restart and TEM markers between scans are skipped, the end of the data
  // is an EOI, bytes before a marker are skipped, reserved markers are
  // errors, Huffman slots 0 and 1 that no DHT defines hold the standard
  // tables, and nothing after a scan that completes the image is read.
  void lenient(bool on) { lenient_ = on; }
  // tif_jpeg.c JPEGSetupDecode: the JPEGTables stream read on its own
  // (jpeg_read_header(FALSE)) before the strip's: SOI, then segments up to
  // EOI, whose tables stay; a scan there makes the stream bogus, a frame is
  // read (get_sof's checks) and forgotten with it (jpeg_abort). Tables that
  // end early go on as tif_jpeg.c's source manager has libjpeg read them:
  // std_fill_input_buffer supplies a fake EOI (FF D9) each time the data runs
  // out, and std_skip_input_data, asked to skip past the data, lands on a
  // fresh one (`skip_to`).
  void load_tables(const uint8_t* t, size_t n) {
    const uint8_t* d = d_;
    const size_t nn = n_;
    try {
      parse_tables(t, n, nullptr);  // tables that end with their EOI need no fake ones
    } catch (const Fail&) {
      std::vector<uint8_t> padded(t, t + n);
      padded.reserve(n + 2 * 32770);
      for (int i = 0; i < 32770; ++i) {  // past any segment length
        padded.push_back(0xFF);
        padded.push_back(0xD9);
      }
      try {
        parse_tables(padded.data(), padded.size(), &n);
      } catch (const Fail&) {
        d_ = d;
        n_ = nn;
        tables_end_ = 0;
        throw;
      }
    }
    d_ = d;
    n_ = nn;
    pos_ = 0;
    tables_end_ = 0;
  }

 private:
  // One pass of load_tables over t[0..n) (with `real`, the JPEGTables' own
  // length, the rest being fake EOIs).
  void parse_tables(const uint8_t* t, size_t n, const size_t* real) {
    d_ = t;
    n_ = n;
    tables_end_ = real ? *real : 0;
    pos_ = 0;
    if (byte() != 0xFF || byte() != 0xD8) corrupt("bogus JPEGTables");
    bool saw_sof = false;
    for (;;) {
      const int m = next_marker();
      if (m == 0xD9) break;
      if (m == 0xDA) corrupt("bogus JPEGTables");
      if (m == 0xC0 || m == 0xC1 || m == 0xC2 || m == 0xC3 || m == 0xC9 || m == 0xCA) {  // get_sof
        if (saw_sof) corrupt("two frames in the JPEGTables");
        saw_sof = true;
        const int len = word();
        byte();
        const int h = word(), w = word(), nc = byte();
        if (h <= 0 || w <= 0 || nc <= 0) corrupt("empty JPEG image in the JPEGTables");
        if (len - 8 != nc * 3) corrupt("bad SOF length in the JPEGTables");
        if (n_ - pos_ < static_cast<size_t>(3 * nc)) corrupt("JPEGTables cut short");
        pos_ += static_cast<size_t>(3 * nc);
        continue;
      }
      segment(m);
    }
  }

  const uint8_t* d_;
  size_t n_, pos_ = 0;
  int W_ = 0, H_ = 0, max_h_ = 1, max_v_ = 1, mcux_ = 0, mcuy_ = 0;
  int restart_ = 0;
  bool have_frame_ = false, jfif_ = false, adobe_ = false, progressive_ = false, arith_ = false, lossless_ = false;
  // DAC conditioning (T.81 defaults): DC L and U, AC Kx, by table
  int dc_l_[4] = {0, 0, 0, 0}, dc_u_[4] = {1, 1, 1, 1}, ac_k_[4] = {5, 5, 5, 5};
  int eobrun_ = 0;
  int coef_bits_[4][64];  // jdphuff.c: the Al of each coefficient's last scan, -1 before any
  int adobe_transform_ = -1;
  int force_ = -1;
  bool lenient_ = false, ojpeg_ = false, premature_ = false;
  int fatal_row_ = -1;
  size_t tables_end_ = 0;  // load_tables: where the JPEGTables' own bytes end and the fake EOIs begin
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
    if (lenient_) {  // jdmarker.c next_marker: bytes before a marker, and FF 00, discarded; the end an EOI
      for (;;) {
        int c;
        do {
          if (pos_ >= n_) return 0xD9;
          c = byte();
        } while (c != 0xFF);
        do {
          if (pos_ >= n_) return 0xD9;
          c = byte();
        } while (c == 0xFF);
        if (c != 0) return c;
      }
    }
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
    if (m >= 0xD0 && m <= 0xD7) {
      if (lenient_) return;  // jdmarker.c: a restart marker outside a scan is traced only
      corrupt("restart marker outside a scan");
    }
    if (m == 0x01) return;  // TEM: no payload
    // jdmarker.c read_markers: RESn, JPG, DHP, EXP and JPGn stop libjpeg
    if (lenient_ && ((m >= 0x02 && m <= 0xBF) || m == 0xC8 || m == 0xDE || m == 0xDF || (m >= 0xF0 && m <= 0xFD)))
      corrupt("unsupported JPEG marker");
    size_t end = segment_end();
    switch (m) {
      case 0xC0:
      case 0xC1:
        frame(end, false, false, false);
        break;
      case 0xC2:
        frame(end, true, false, false);
        break;
      case 0xC3:
        frame(end, false, false, true);
        break;
      case 0xC9:
        frame(end, false, true, false);
        break;
      case 0xCA:
        frame(end, true, true, false);
        break;
      case 0xCB:
        refused("arithmetic-coded lossless JPEG is refused");
      case 0xCC:
        dac(end);
        break;
      case 0xC5:
      case 0xC6:
      case 0xC7:
      case 0xCD:
      case 0xCE:
      case 0xCF:
        refused("hierarchical (differential) JPEG is refused");
      case 0xC4:
        dht(end);
        break;
      case 0xDB:
        dqt(end);
        break;
      case 0xDD:
        if (end - pos_ != 2) corrupt("bad DRI segment");
        restart_ = word();
        break;
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
        break;  // DNL (as libjpeg skips it), other APPn, COM, JPGn: skipped
    }
    if (pos_ > end) corrupt("JPEG segment overrun");
    if (m == 0xE0 || m == 0xEE) pos_ += std::min<size_t>(end - pos_, 14);  // get_interesting_appn reads these
    skip_to(end);
  }

  // The rest of a segment skipped. Past the JPEGTables' end,
  // std_skip_input_data fills the buffer with one fake EOI instead.
  void skip_to(size_t end) {
    if (!tables_end_ || end <= tables_end_ || pos_ == end) {
      pos_ = end;
    } else if (pos_ < tables_end_) {
      pos_ = tables_end_;
    } else {
      pos_ += (pos_ - tables_end_) & 1;
    }
  }

  void frame(size_t end, bool progressive, bool arith, bool lossless) {
    if (have_frame_) corrupt("two frames in one JPEG");
    if (end - pos_ < 6) corrupt("bad SOF segment");
    progressive_ = progressive;
    arith_ = arith;
    lossless_ = lossless;
    int precision = byte();
    H_ = word();
    W_ = word();
    int nc = byte();
    if (precision != 8) refused(std::to_string(precision) + "-bit JPEG is refused");
    if (nc != 1 && nc != 3 && nc != 4) refused(std::to_string(nc) + "-component JPEG is refused");
    if (H_ == 0) refused("a JPEG of height 0 (its height given by DNL) is refused");
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
    const int unit = lossless ? 1 : 8;  // a lossless "block" is one sample
    mcux_ = (W_ + unit * max_h_ - 1) / (unit * max_h_);
    mcuy_ = (H_ + unit * max_v_ - 1) / (unit * max_v_);
    for (auto& row : coef_bits_)
      for (int& b : row) b = -1;
    for (auto& c : comps_) {
      if (max_h_ % c.h || max_v_ % c.v) refused("fractional JPEG sampling is refused");
      c.dw = static_cast<int>((static_cast<int64_t>(W_) * c.h + max_h_ - 1) / max_h_);
      c.dh = static_cast<int>((static_cast<int64_t>(H_) * c.v + max_v_ - 1) / max_v_);
      c.wblocks = (c.dw + 7) / 8;
      c.hblocks = (c.dh + 7) / 8;
      c.bw = mcux_ * c.h;
      c.bh = mcuy_ * c.v;
      if (lossless)
        c.diff.assign(static_cast<size_t>(c.bw) * c.bh, 0);
      else
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
      (tc ? ac_ : dc_)[th].build(bits, d_ + pos_, total);
      pos_ += static_cast<size_t>(total);
    }
  }

  void dqt(size_t end) {
    while (pos_ < end) {
      int pq_tq = byte();
      int pq = pq_tq >> 4, tq = pq_tq & 15;  // get_dqt: any nonzero precision is 16-bit
      if (tq > 3) corrupt("bad DQT table id");
      if (end - pos_ < static_cast<size_t>(pq ? 128 : 64)) corrupt("bad DQT segment");
      for (int i = 0; i < 64; ++i) qt_[tq][kZigzag[i]] = pq ? word() : byte();
      qt_present_[tq] = true;
    }
  }

  void dac(size_t end) {  // jdmarker.c get_dac
    if ((end - pos_) % 2) corrupt("bad DAC segment");
    while (pos_ < end) {
      int index = byte(), val = byte();
      if (index >= 32) corrupt("bad DAC table index");
      if (index >= 16) {
        if (index - 16 < 4) ac_k_[index - 16] = val;
      } else if (index < 4) {
        dc_l_[index] = val & 15;
        dc_u_[index] = val >> 4;
        if (dc_l_[index] > dc_u_[index]) corrupt("bad DAC value");
      }
    }
  }

  // jdapimin.c default_decompress_parms: a 3-component frame is RGB or
  // YCbCr by its markers and component ids (lossless frames without markers
  // are RGB).
  bool rgb_frame() const {
    if (jfif_) return false;
    if (adobe_) return adobe_transform_ == 0;
    return lossless_ || (comps_[0].id == 82 && comps_[1].id == 71 && comps_[2].id == 66);
  }

  void scan() {
    if (!have_frame_) corrupt("scan before the frame");
    // jdcolor.c: libjpeg converts no colour in lossless mode (YCbCr or YCCK),
    // and refuses before the first scan's data
    if (lossless_ && force_ != 0 &&
        (force_ == 1 || (comps_.size() == 3 && !rgb_frame()) || (comps_.size() == 4 && adobe_ && adobe_transform_)))
      refused("a lossless JPEG in YCbCr or YCCK (libjpeg converts no colour in lossless mode) is refused");
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
    if (lossless_) {  // jdlossls.c start_input_pass: the predictor, and Pt below the precision
      if (ss < 1 || ss > 7 || se != 0 || ah != 0 || al >= 8) corrupt("bad lossless scan parameters");
    } else if (!progressive_) {  // jdhuff.c: only a warning to libjpeg, which decodes a full sequential scan
      if ((ss != 0 || se != 63 || ahal != 0) && !lenient_) corrupt("bad sequential scan parameters");
    } else {  // jdphuff.c start_pass_phuff_decoder
      bool bad = ss == 0 ? se != 0 : (ss > se || se > 63 || ns != 1);
      if ((ah != 0 && al != ah - 1) || al > 13 || bad) corrupt("bad progressive scan parameters");
      for (auto* c : sc) {
        int* cb = coef_bits_[c - comps_.data()];
        for (int k = ss; k <= se; ++k) cb[k] = al;
      }
    }
    if (lenient_ && !arith_ && !lossless_)  // jdhuff.c jinit_huff_decoder: std_huff_tables for slots never defined
      for (int t = 0; t < 2; ++t) {
        if (!dc_[t].present) std_huffman(false, t, dc_[t]);
        if (!ac_[t].present) std_huffman(true, t, ac_[t]);
      }
    int blocks_in_mcu = 0;
    for (auto* c : sc) {
      bool needs_dc = !progressive_ || (ss == 0 && ah == 0), needs_ac = !lossless_ && (!progressive_ || ss != 0);
      if (!arith_) {
        if ((needs_dc && !dc_[c->td].present) || (needs_ac && !ac_[c->ta].present))
          corrupt("missing Huffman table");
        if (needs_dc && dc_[c->td].max_sym > (lossless_ ? 16 : 15)) corrupt("bad DC Huffman table");
      }
      if (!lossless_ && !c->latched) {  // jdinput.c latch_quant_tables
        if (!qt_present_[c->tq]) corrupt("missing quantization table");
        memcpy(c->quant, qt_[c->tq], sizeof(c->quant));
        c->latched = true;
      }
      c->scanned = true;
      blocks_in_mcu += ns == 1 ? 1 : c->h * c->v;
    }
    if (blocks_in_mcu > 10) corrupt("too many blocks in a JPEG MCU");
    if (arith_)
      arith_scan(sc, ss, se, ah, al);
    else if (lossless_)
      lossless_scan(sc, ss, al);
    else
      huffman_scan(sc, ss, se, ah, al);
  }

  // The scan's entropy data ends at the next marker (not a restart marker).
  void end_scan(size_t p) {
    while (p + 1 < n_ && !(d_[p] == 0xFF && d_[p + 1] != 0x00 && !(lenient_ && d_[p + 1] == 0xFF) &&
                           !(d_[p + 1] >= 0xD0 && d_[p + 1] <= 0xD7)))
      ++p;
    if (p + 1 >= n_) {
      if (!lenient_) corrupt("truncated JPEG data (no EOI)");
      p = n_;
    }
    pos_ = p;
  }

  // jdmarker.c read_restart_marker after a Huffman interval: the marker right
  // after the interval's bits.
  static size_t huffman_restart(const uint8_t* d, size_t n, size_t p, int& next_rst) {
    if (p + 1 >= n || d[p] != 0xFF) corrupt("missing JPEG restart marker");
    while (p < n && d[p] == 0xFF) ++p;
    if (p >= n || d[p] != 0xD0 + next_rst) corrupt("missing JPEG restart marker");
    next_rst = (next_rst + 1) & 7;
    return p + 1;
  }

  void huffman_scan(const std::vector<Component*>& sc, int ss, int se, int ah, int al) {
    const int ns = static_cast<int>(sc.size());
    const bool lenient = lenient_ && !progressive_ && (!restart_ || ojpeg_);
    bool insufficient = false;
    BitReader br(d_, n_, pos_, lenient);
    int pred[4] = {0, 0, 0, 0};
    eobrun_ = 0;
    int mx = ns == 1 ? sc[0]->wblocks : mcux_, my = ns == 1 ? sc[0]->hblocks : mcuy_;
    int64_t total = static_cast<int64_t>(mx) * my;
    int next_rst = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_ && m > 0 && m % restart_ == 0) {
        if (ojpeg_) {  // jdhuff.c process_restart, jdmarker.c read_restart_marker / next_marker
          size_t p = br.pos();
          for (;;) {
            while (p < n_ && d_[p] != 0xFF) ++p;
            while (p < n_ && d_[p] == 0xFF) ++p;
            if (p >= n_ || d_[p] != 0) break;
            ++p;
          }
          if (p >= n_ || d_[p] != 0xD0 + next_rst) {
            fatal_row_ = static_cast<int>(m / mx);
            break;
          }
          next_rst = (next_rst + 1) & 7;
          br.set_pos(p + 1);
          insufficient = false;
        } else {
          br.set_pos(huffman_restart(d_, n_, br.pos(), next_rst));
        }
        pred[0] = pred[1] = pred[2] = pred[3] = 0;
        eobrun_ = 0;
      }
      int mxi = static_cast<int>(m % mx), myi = static_cast<int>(m / mx);
      if (insufficient) continue;
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
      if (br.overran()) {
        if (!lenient) corrupt("truncated JPEG data");
        if (ojpeg_ && premature_ && br.at_end()) {  // OJPEGLibjpegJpegSourceMgrFillInputBuffer fails
          fatal_row_ = myi;
          break;
        }
        insufficient = true;
      }
    }
    end_scan(br.pos());
  }

  // jdarith.c: the scan's MCUs (decode_mcu, decode_mcu_DC_first / _DC_refine /
  // _AC_first / _AC_refine), statistics reset at each restart, and libjpeg's
  // "bad code" state (nothing more is decoded until the next restart).
  void arith_scan(const std::vector<Component*>& sc, int ss, int se, int ah, int al) {
    const int ns = static_cast<int>(sc.size());
    ArithDecoder ad(d_, n_, pos_);
    uint8_t dc_stats[4][64], ac_stats[4][256];
    uint8_t fixed = 113;  // the fixed 0.5 estimate
    int last_dc[4] = {0, 0, 0, 0}, dc_ctx[4] = {0, 0, 0, 0};
    auto reset = [&]() {
      for (int i = 0; i < ns; ++i) {
        if (!progressive_ || (ss == 0 && ah == 0)) {
          memset(dc_stats[sc[i]->td], 0, 64);
          last_dc[i] = dc_ctx[i] = 0;
        }
        if (!progressive_ || ss) memset(ac_stats[sc[i]->ta], 0, 256);
      }
      ad.reset();
    };
    reset();
    int mx = ns == 1 ? sc[0]->wblocks : mcux_, my = ns == 1 ? sc[0]->hblocks : mcuy_;
    int64_t total = static_cast<int64_t>(mx) * my, to_go = restart_;
    int next_rst = 0;
    bool dead = false;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_) {
        if (to_go == 0) {  // jdarith.c process_restart
          int marker;
          size_t after;
          if (ad.unread_marker()) {
            marker = ad.unread_marker();
            after = ad.pos();
          } else {  // jdmarker.c next_marker: skip to the next marker
            size_t p = ad.pos();
            for (;;) {
              while (p < n_ && d_[p] != 0xFF) ++p;
              while (p < n_ && d_[p] == 0xFF) ++p;
              if (p >= n_) corrupt("missing JPEG restart marker");
              if (d_[p] != 0) break;
              ++p;
            }
            marker = d_[p];
            after = p + 1;
          }
          if (marker != 0xD0 + next_rst) corrupt("missing JPEG restart marker");
          next_rst = (next_rst + 1) & 7;
          ad.take_marker(after);
          reset();
          dead = false;
          to_go = restart_;
        }
        --to_go;
      }
      int mxi = static_cast<int>(m % mx), myi = static_cast<int>(m / mx);
      for (int ci = 0; ci < ns && !dead; ++ci) {
        Component* c = sc[ci];
        int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
        for (int by = 0; by < bh && !dead; ++by)
          for (int bx = 0; bx < bwn && !dead; ++bx) {
            int row = ns == 1 ? myi : myi * c->v + by, col = ns == 1 ? mxi : mxi * c->h + bx;
            int16_t* blk = c->coef.data() + (static_cast<size_t>(row) * c->bw + col) * 64;
            if (!progressive_ || (ss == 0 && ah == 0)) {
              int v = arith_dc(ad, dc_stats[c->td], dc_ctx[ci], c->td, dead);
              if (dead) break;
              if (!progressive_) {
                last_dc[ci] = (last_dc[ci] + v) & 0xFFFF;
                blk[0] = static_cast<int16_t>(last_dc[ci]);
                dead = !arith_ac(ad, ac_stats[c->ta], c->ta, blk, 1, 63, 0, &fixed);
              } else {
                last_dc[ci] += v;
                blk[0] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(last_dc[ci]) << al));
              }
            } else if (ss == 0) {
              if (ad.decode(&fixed)) blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
            } else if (ah == 0) {
              dead = !arith_ac(ad, ac_stats[c->ta], c->ta, blk, ss, se, al, &fixed);
            } else {
              dead = !arith_ac_refine(ad, ac_stats[c->ta], blk, ss, se, al, &fixed);
            }
          }
      }
      if (ad.overran()) corrupt("truncated JPEG data");
    }
    end_scan(ad.unread_marker() ? ad.marker_pos() : ad.pos());
  }

  // Figures F.19-F.24: a DC difference; `bad` on a magnitude overflow.
  int arith_dc(ArithDecoder& ad, uint8_t* stats, int& ctx, int tbl, bool& bad) {
    uint8_t* st = stats + ctx;
    if (ad.decode(st) == 0) {
      ctx = 0;
      return 0;
    }
    const int sign = ad.decode(st + 1);
    st += 2 + sign;
    int m = ad.decode(st);
    if (m != 0) {
      st = stats + 20;
      while (ad.decode(st)) {
        if ((m <<= 1) == 0x8000) {
          bad = true;
          return 0;
        }
        st += 1;
      }
    }
    if (m < ((1 << dc_l_[tbl]) >> 1))
      ctx = 0;
    else if (m > ((1 << dc_u_[tbl]) >> 1))
      ctx = 12 + sign * 4;
    else
      ctx = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ad.decode(st)) v |= m;
    v += 1;
    return sign ? -v : v;
  }

  // Figure F.20 over k0..se at point transform al; false on a bad code.
  bool arith_ac(ArithDecoder& ad, uint8_t* stats, int tbl, int16_t* blk, int k0, int se, int al, uint8_t* fixed) {
    for (int k = k0; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (ad.decode(st)) break;  // EOB
      while (ad.decode(st + 1) == 0) {
        st += 3;
        if (++k > se) return false;
      }
      const int sign = ad.decode(fixed);
      st += 2;
      int m = ad.decode(st);
      if (m != 0 && ad.decode(st)) {
        m <<= 1;
        st = stats + (k <= ac_k_[tbl] ? 189 : 217);
        while (ad.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
      int v = m;
      st += 14;
      while (m >>= 1)
        if (ad.decode(st)) v |= m;
      v += 1;
      if (sign) v = -v;
      blk[kZigzag[k]] = static_cast<int16_t>(static_cast<int>(static_cast<unsigned>(v) << al));
    }
    return true;
  }

  // Figure G.10's decoder side (decode_mcu_AC_refine); false on a bad code.
  bool arith_ac_refine(ArithDecoder& ad, uint8_t* stats, int16_t* blk, int ss, int se, int al, uint8_t* fixed) {
    const int p1 = 1 << al, m1 = -p1;
    int kex = se;
    for (; kex > 0; --kex)
      if (blk[kZigzag[kex]]) break;
    for (int k = ss; k <= se; ++k) {
      uint8_t* st = stats + 3 * (k - 1);
      if (k > kex && ad.decode(st)) break;  // EOB
      for (;;) {
        int16_t& coef = blk[kZigzag[k]];
        if (coef) {
          if (ad.decode(st + 2)) coef = static_cast<int16_t>(coef + (coef < 0 ? m1 : p1));
          break;
        }
        if (ad.decode(st + 1)) {
          coef = static_cast<int16_t>(ad.decode(fixed) ? m1 : p1);
          break;
        }
        st += 3;
        if (++k > se) return false;
      }
    }
    return true;
  }

  // jdlhuff.c decode_mcus + jddiffct.c's restart handling: the differences
  // of a lossless scan, row by row of MCUs. Undifferencing waits for
  // finish(); each component row that libjpeg undifferences as a scan's or
  // restart interval's first row (the first row of an iMCU row in which the
  // scan started or a restart came) is marked.
  void lossless_scan(const std::vector<Component*>& sc, int psv, int pt) {
    const int ns = static_cast<int>(sc.size());
    for (auto* c : sc) {
      c->psv = psv;
      c->pt = pt;
      c->first_row.assign(static_cast<size_t>(c->dh), 0);
    }
    const int per_row = ns > 1 ? mcux_ : sc[0]->dw, rows = ns > 1 ? mcuy_ : sc[0]->dh;
    const int rows_per_imcu = ns > 1 ? 1 : sc[0]->v;
    if (restart_ % per_row) refused("a lossless JPEG whose restart interval is not whole MCU rows is refused");
    const int restart_rows = restart_ / per_row;
    BitReader br(d_, n_, pos_);
    int to_go = restart_rows, next_rst = 0;
    for (int r = 0; r < rows; ++r) {
      bool start = r == 0;
      if (restart_) {
        if (to_go == 0) {
          br.set_pos(huffman_restart(d_, n_, br.pos(), next_rst));
          to_go = restart_rows;
          start = true;
        }
        --to_go;
      }
      if (start)
        for (auto* c : sc) {
          const int first = r / rows_per_imcu * (ns > 1 ? c->v : rows_per_imcu);
          if (first < c->dh) c->first_row[first] = 1;
        }
      for (int mx = 0; mx < per_row; ++mx)
        for (auto* c : sc) {
          const int bh = ns == 1 ? 1 : c->v, bwn = ns == 1 ? 1 : c->h;
          for (int by = 0; by < bh; ++by)
            for (int bx = 0; bx < bwn; ++bx) {
              const int row = ns == 1 ? r : r * c->v + by, col = ns == 1 ? mx : mx * c->h + bx;
              int s = br.decode(dc_[c->td]);
              if (s) s = s == 16 ? 32768 : extend(br.bits(s), s);
              c->diff[static_cast<size_t>(row) * c->bw + col] = s;
            }
        }
      if (br.overran()) corrupt("truncated JPEG data");
    }
    end_scan(br.pos());
  }

  // jdpred.c undifferencing and jdlossls.c's scaler: a lossless component's
  // (dh, dw) samples into its plane.
  void undifference(Component& c, int ps) {
    std::vector<int> prev(static_cast<size_t>(c.dw)), cur(static_cast<size_t>(c.dw));
    for (int r = 0; r < c.dh; ++r) {
      const int32_t* d = c.diff.data() + static_cast<size_t>(r) * c.bw;
      if (c.first_row[r]) {
        int ra = (d[0] + (1 << (8 - c.pt - 1))) & 0xFFFF;
        cur[0] = ra;
        for (int x = 1; x < c.dw; ++x) cur[x] = ra = (d[x] + ra) & 0xFFFF;
      } else {
        int rb = prev[0], ra = (d[0] + rb) & 0xFFFF, rc;
        cur[0] = ra;
        for (int x = 1; x < c.dw; ++x) {
          rc = rb;
          rb = prev[x];
          int px;
          switch (c.psv) {
            case 1: px = ra; break;
            case 2: px = rb; break;
            case 3: px = rc; break;
            case 4: px = ra + rb - rc; break;
            case 5: px = ra + ((rb - rc) >> 1); break;
            case 6: px = rb + ((ra - rc) >> 1); break;
            default: px = (ra + rb) >> 1; break;
          }
          cur[x] = ra = (d[x] + px) & 0xFFFF;
        }
      }
      uint8_t* o = c.plane.data() + static_cast<size_t>(r) * ps;
      for (int x = 0; x < c.dw; ++x) o[x] = static_cast<uint8_t>(cur[x] << c.pt);
      prev.swap(cur);
    }
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
        if (k > 63 && !br.lenient()) corrupt("bad JPEG coefficient index");
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

  // jdcoefct.c decompress_smooth_data (libjpeg-turbo 2.1+): each block's
  // unknown coefficients among the first 9 AC ones estimated from the 5x5 DC
  // neighbourhood (and, when no AC data came at all, the DC interpolated),
  // under the coef_bits latch; then the IDCT. The neighbourhood follows
  // libjpeg's row bounds per iMCU row and its sliding DC registers.
  void idct_smoothed(Component& c, const int* cb, uint8_t* plane, int ps) {
    const bool change_dc = cb[1] == -1 && cb[2] == -1 && cb[3] == -1 && cb[4] == -1 && cb[5] == -1 &&
                           cb[6] == -1 && cb[7] == -1 && cb[8] == -1 && cb[9] == -1;
    const int64_t Q00 = c.quant[0], Q01 = c.quant[1], Q10 = c.quant[8], Q20 = c.quant[16], Q11 = c.quant[9],
                  Q02 = c.quant[2], Q03 = c.quant[3], Q12 = c.quant[10], Q21 = c.quant[17], Q30 = c.quant[24];
    auto estimate = [](int64_t num, int64_t q, int al) {
      int pred;
      if (num >= 0) {
        pred = static_cast<int>(((q << 7) + num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
      } else {
        pred = static_cast<int>(((q << 7) - num) / (q << 8));
        if (al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
        pred = -pred;
      }
      return static_cast<int16_t>(pred);
    };
    const int last_col = c.wblocks - 1;
    for (int r = 0; r < mcuy_; ++r) {
      int block_rows = c.v;
      if (r == mcuy_ - 1) {
        block_rows = c.hblocks % c.v;
        if (block_rows == 0) block_rows = c.v;
      }
      const int image_block_rows = block_rows * mcuy_;
      for (int br = 0; br < block_rows; ++br) {
        const int ibr = r * block_rows + br, row = r * c.v + br;
        if (row >= c.hblocks) continue;
        auto blk = [&](int rr, int col) { return c.coef.data() + (static_cast<size_t>(rr) * c.bw + col) * 64; };
        const int prev = ibr > 0 ? row - 1 : row;
        const int prev2 = ibr > 1 ? row - 2 : prev;
        const int next = ibr < image_block_rows - 1 ? row + 1 : row;
        const int next2 = ibr < image_block_rows - 2 ? row + 2 : next;
        const int rows[5] = {prev2, prev, row, next, next2};
        int DC[26];
        for (int k = 0; k < 5; ++k)
          for (int j = 1; j <= 5; ++j) DC[5 * k + j] = blk(rows[k], 0)[0];
        for (int col = 0; col <= last_col; ++col) {
          int16_t ws[64];
          memcpy(ws, blk(row, col), sizeof(ws));
          if (col == 0 && col < last_col)
            for (int k = 0; k < 5; ++k) DC[5 * k + 4] = DC[5 * k + 5] = blk(rows[k], 1)[0];
          if (col + 1 < last_col)
            for (int k = 0; k < 5; ++k) DC[5 * k + 5] = blk(rows[k], col + 2)[0];
          const int DC01 = DC[1], DC02 = DC[2], DC03 = DC[3], DC04 = DC[4], DC05 = DC[5], DC06 = DC[6],
                    DC07 = DC[7], DC08 = DC[8], DC09 = DC[9], DC10 = DC[10], DC11 = DC[11], DC12 = DC[12],
                    DC13 = DC[13], DC14 = DC[14], DC15 = DC[15], DC16 = DC[16], DC17 = DC[17], DC18 = DC[18],
                    DC19 = DC[19], DC20 = DC[20], DC21 = DC[21], DC22 = DC[22], DC23 = DC[23], DC24 = DC[24],
                    DC25 = DC[25];
          int al;
          if ((al = cb[1]) != 0 && ws[1] == 0)
            ws[1] = estimate(Q00 * (change_dc ? (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 +
                                                 3 * DC10 - 3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 -
                                                 3 * DC16 + 13 * DC17 - 13 * DC19 + 3 * DC20 - DC21 - DC22 +
                                                 DC24 + DC25)
                                              : (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)),
                             Q01, al);
          if ((al = cb[2]) != 0 && ws[8] == 0)
            ws[8] = estimate(Q00 * (change_dc ? (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
                                                 38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 -
                                                 13 * DC19 + DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25)
                                              : (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)),
                             Q10, al);
          if ((al = cb[3]) != 0 && ws[16] == 0)
            ws[16] = estimate(Q00 * (change_dc ? (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 -
                                                  5 * DC14 + 2 * DC17 + 7 * DC18 + 2 * DC19 + DC23)
                                               : (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)),
                              Q20, al);
          if ((al = cb[4]) != 0 && ws[9] == 0)
            ws[9] = estimate(Q00 * (change_dc ? (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 -
                                                 DC25)
                                              : (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 -
                                                 DC24 + DC04 - DC06 + 10 * DC07 - 10 * DC09)),
                             Q11, al);
          if ((al = cb[5]) != 0 && ws[2] == 0)
            ws[2] = estimate(Q00 * (change_dc ? (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 +
                                                 7 * DC14 + DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19)
                                              : (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)),
                             Q02, al);
          if (change_dc) {
            if ((al = cb[6]) != 0 && ws[3] == 0)
              ws[3] = estimate(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19), Q03, al);
            if ((al = cb[7]) != 0 && ws[10] == 0)
              ws[10] = estimate(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19), Q12, al);
            if ((al = cb[8]) != 0 && ws[17] == 0)
              ws[17] = estimate(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19), Q21, al);
            if ((al = cb[9]) != 0 && ws[24] == 0)
              ws[24] = estimate(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19), Q30, al);
            ws[0] = estimate(Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 - 6 * DC06 + 6 * DC07 +
                                    42 * DC08 + 6 * DC09 - 6 * DC10 - 8 * DC11 + 42 * DC12 + 152 * DC13 +
                                    42 * DC14 - 8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                    6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 - 2 * DC25),
                             Q00, 0);
          }
          idct_islow(ws, c.quant, plane + static_cast<size_t>(row) * 8 * ps + col * 8, ps);
          for (int k = 0; k < 5; ++k)
            for (int j = 1; j < 5; ++j) DC[5 * k + j] = DC[5 * k + j + 1];
        }
      }
    }
  }

  void finish(uint8_t* out, bool smooth) {
    std::vector<std::vector<uint8_t>> full(comps_.size());
    for (size_t ci = 0; ci < comps_.size(); ++ci) {
      Component& c = comps_[ci];
      int ps = c.wblocks * 8;
      c.plane.assign(static_cast<size_t>(ps) * c.hblocks * 8, 0);
      if (lossless_)
        undifference(c, ps);
      else if (smooth)
        idct_smoothed(c, coef_bits_[ci], c.plane.data(), ps);
      else
        for (int by = 0; by < c.hblocks; ++by)
          for (int bx = 0; bx < c.wblocks; ++bx)
            idct_islow(c.coef.data() + (static_cast<size_t>(by) * c.bw + bx) * 64, c.quant,
                       c.plane.data() + static_cast<size_t>(by) * 8 * ps + bx * 8, ps);
      std::vector<int16_t>().swap(c.coef);
      std::vector<int32_t>().swap(c.diff);
      int eh = max_h_ / c.h, ev = max_v_ / c.v;
      if (eh == 1 && ev == 1) continue;
      full[ci].resize(static_cast<size_t>(W_) * H_);
      upsample(c.plane.data(), c.dw, c.dh, ps, eh, ev, full[ci].data(), W_, H_, !lossless_);
    }
    auto plane_row = [&](size_t ci, int y) -> const uint8_t* {
      if (!full[ci].empty()) return full[ci].data() + static_cast<size_t>(y) * W_;
      return comps_[ci].plane.data() + static_cast<size_t>(y) * comps_[ci].wblocks * 8;
    };
    if (force_ == 0) {
      const size_t nc = comps_.size();
      for (int y = 0; y < H_; ++y) {
        uint8_t* o = out + static_cast<size_t>(y) * W_ * nc;
        for (size_t ci = 0; ci < nc; ++ci) {
          const uint8_t* p = plane_row(ci, y);
          for (int x = 0; x < W_; ++x) o[nc * x + ci] = p[x];
        }
      }
      return;
    }
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
      // Convert.c cmyk2rgb (`cmyk_to_rgb`).
      const bool ycck = adobe_ && adobe_transform_ != 0;
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
          cmyk_to_rgb(255 - cmy[0], 255 - cmy[1], 255 - cmy[2], 255 - p3[x], o + 3 * x);
        }
      }
      return;
    }
    if (force_ != 1 && rgb_frame()) {
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

// jstdhuff.c std_huff_tables: the standard table of a slot (0 luminance, 1 chrominance).
void std_huffman(bool ac, int slot, Huffman& h) {
  const uint8_t* b = ac ? (slot ? kAcChrBits : kAcLumBits) : (slot ? kDcChrBits : kDcLumBits);
  const uint8_t* v = ac ? (slot ? kAcChrVals : kAcLumVals) : kDcVals;
  uint8_t bits[17] = {0};
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l] = b[l - 1];
  h.build(bits, v, total);
}

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
// RF_REFUSED (with a message in `err`).
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

// One strip or tile of a JPEG-compressed TIFF as libtiff's tif_jpeg.c reads
// it: the JPEGTables stream's tables (`tables`, may be empty), then `data` as
// an abbreviated stream decoded on its own, with libtiff's checks (the
// component count `nc`, component 0 sampled (hs, vs) and the others 1 x 1, 8
// bits, a frame no larger than the segment, except a last strip that is only
// taller) and its colour space: YCbCr -> RGB when `ycc_to_rgb`, else the raw
// components. Writes seg_h rows of seg_w pixels (3 or nc bytes each) at
// `out_stride` bytes a row. Returns RF_OK or RF_CORRUPT / RF_REFUSED with a
// message in `err`.
int rf_jpeg_tiff_decode(const uint8_t* tables, int64_t tn, const uint8_t* data, int64_t n, int32_t ycc_to_rgb,
                        int32_t hs, int32_t vs, int32_t nc, int32_t seg_w, int32_t seg_h, int32_t allow_taller,
                        uint8_t* out, int64_t out_stride, char* err, int64_t err_cap) {
  try {
    if (n < 2 || data[0] != 0xFF || data[1] != 0xD8) corrupt("not a JPEG stream (no SOI)");
    Decoder dec(data, static_cast<size_t>(n));
    dec.lenient(true);
    if (tn > 0) dec.load_tables(tables, static_cast<size_t>(tn));
    dec.header();
    if (dec.components() != nc) corrupt("improper JPEG component count");
    if (dec.component(0).h != hs || dec.component(0).v != vs) corrupt("improper JPEG sampling factors");
    for (int i = 1; i < dec.components(); ++i)
      if (dec.component(i).h != 1 || dec.component(i).v != 1) corrupt("improper JPEG sampling factors");
    const int W = dec.width(), H = dec.height();
    const bool taller = W == seg_w && H > seg_h && allow_taller;
    if (!taller && (W > seg_w || H > seg_h)) corrupt("JPEG strip/tile size exceeds expected dimensions");
    if (W < seg_w || H < seg_h) corrupt("JPEG strip/tile smaller than the TIFF segment");
    const int ch = ycc_to_rgb ? 3 : nc;
    if (ycc_to_rgb && nc != 3) corrupt("YCbCr JPEG in TIFF without three components");
    dec.force_colour(ycc_to_rgb ? 1 : 0);
    std::vector<uint8_t> img(static_cast<size_t>(W) * H * ch);
    dec.decode(img.data());
    for (int y = 0; y < seg_h; ++y)
      memcpy(out + y * out_stride, img.data() + static_cast<size_t>(y) * W * ch, static_cast<size_t>(seg_w) * ch);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("JPEG decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

// The JPEG stream tif_ojpeg.c builds for an old-style JPEG TIFF (`tiff.cpp`),
// decoded as libjpeg decodes it there: the frame and tables checked as
// jpeg_read_header and jpeg_start_decompress check them, then the
// components' IDCT output as jpeg_read_raw_data gives it (no upsampling or
// colour conversion), damaged data read as `Decoder::ojpeg` reads it (with
// `premature`, the stream stops where libtiff's source failed). dims
// gets (W, H, components, then h, v, plane width and height of each, then
// the MCU row of a fatal restart marker or -1); `out` the planes one after
// the other. With `out` null or too small it stops after the frame and
// returns RF_NEED_BUFFER. Returns RF_OK, or RF_CORRUPT / RF_REFUSED with a
// message in `err`.
int rf_jpeg_ojpeg_decode(const uint8_t* data, int64_t n, int32_t premature, uint8_t* out, int64_t cap, int32_t* dims,
                         char* err, int64_t err_cap) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.lenient(true);
    dec.ojpeg(true, premature != 0);
    dec.header();
    const int nc = dec.components();
    dims[0] = dec.width();
    dims[1] = dec.height();
    dims[2] = nc;
    int64_t need = 0;
    for (int i = 0; i < nc; ++i) {
      const Component& c = dec.component(i);
      dims[3 + 4 * i] = c.h;
      dims[4 + 4 * i] = c.v;
      dims[5 + 4 * i] = c.wblocks * 8;
      dims[6 + 4 * i] = c.hblocks * 8;
      need += static_cast<int64_t>(c.wblocks) * 8 * c.hblocks * 8;
    }
    dims[3 + 4 * nc] = -1;
    if (!out || cap < need) return RF_NEED_BUFFER;
    dec.decode_raw();
    uint8_t* o = out;
    for (int i = 0; i < nc; ++i) {
      const Component& c = dec.component(i);
      memcpy(o, c.plane.data(), c.plane.size());
      o += c.plane.size();
    }
    dims[3 + 4 * nc] = dec.fatal_row();
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
