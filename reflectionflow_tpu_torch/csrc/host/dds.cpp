// DDS (DirectDraw Surface), the first surface, as Pillow 12.1's
// DdsImagePlugin reads it and `convert("RGB")` converts it, behind a plain C
// interface bound with ctypes in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * DdsImageFile._open's header (124 bytes, its pixel format flags tried
//     in its order: RGB, luminance, 8-bit palette, FourCC), the DX10
//     extension, and each of its raises (an unknown FourCC, DXGI format or
//     flag set, a luminance bit count it does not take) as RF_REFUSED;
//   * uncompressed RGB / RGBA with any bit masks through DdsRgbDecoder (a
//     pixel of bitcount / 8 bytes, zero past the data's end; each masked
//     value v over the mask's width m as int(v / m * 255)); L, LA, P8 with
//     its 1024-byte RGBA palette and DX10's R8G8B8A8 through the raw decoder;
//   * BC1 / DXT1 (its three-colour blocks with transparent black), BC2 /
//     DXT3, BC3 / DXT5, BC4 (BC4U, ATI1), BC5 unsigned (BC5U, ATI2) and
//     signed (BC5S), BC6H UF16 and SF16 and BC7 as BcnDecode.c decodes
//     them: its integer rounding, BC5's blue left 0 (128 in BC5S), BC6H's
//     endpoints as 16-bit words (SF16's delta sums not sign-extended), its
//     half floats truncated to 8 bits, BC7's eight modes with p-bits, rotation and index
//     selection; the partition and anchor tables are PIL's, derived from its
//     decodes into `bcn_tables.h`; blocks past a size that is not a
//     multiple of 4 are cut;
//   * mipmaps and the other faces of a cube map are not read, as PIL reads
//     only the first surface.
//
// What PIL refuses returns RF_REFUSED; data that ends early returns
// RF_CORRUPT. Every read is bounded by the buffer.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "bcn_tables.h"
#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS

inline uint32_t le32(const uint8_t* p) { return uint32_t(p[0]) | uint32_t(p[1]) << 8 | uint32_t(p[2]) << 16 | uint32_t(p[3]) << 24; }
constexpr uint32_t fourcc(const char* s) {
  return uint32_t(uint8_t(s[0])) | uint32_t(uint8_t(s[1])) << 8 | uint32_t(uint8_t(s[2])) << 16 |
         uint32_t(uint8_t(s[3])) << 24;
}

struct Rgba {
  uint8_t r, g, b, a;
};

// ------------------------------------------------------------ BC1 - BC5 ----

Rgba decode_565(int x) {
  int r = (x & 0xf800) >> 8, g = (x & 0x7e0) >> 3, b = (x & 0x1f) << 3;
  r |= r >> 5, g |= g >> 6, b |= b >> 5;
  return Rgba{uint8_t(r), uint8_t(g), uint8_t(b), 255};
}

// A BC1 colour block; BC2 and BC3 always take its four-colour form.
void bc1_color(Rgba* col, const uint8_t* s, bool four) {
  const int c0 = s[0] | s[1] << 8, c1 = s[2] | s[3] << 8;
  const uint32_t lut = le32(s + 4);
  Rgba p[4] = {decode_565(c0), decode_565(c1), {}, {}};
  const int r0 = p[0].r, g0 = p[0].g, b0 = p[0].b, r1 = p[1].r, g1 = p[1].g, b1 = p[1].b;
  if (c0 > c1 || four) {
    p[2] = Rgba{uint8_t((2 * r0 + r1) / 3), uint8_t((2 * g0 + g1) / 3), uint8_t((2 * b0 + b1) / 3), 255};
    p[3] = Rgba{uint8_t((r0 + 2 * r1) / 3), uint8_t((g0 + 2 * g1) / 3), uint8_t((b0 + 2 * b1) / 3), 255};
  } else {
    p[2] = Rgba{uint8_t((r0 + r1) / 2), uint8_t((g0 + g1) / 2), uint8_t((b0 + b1) / 2), 255};
    p[3] = Rgba{0, 0, 0, 0};
  }
  for (int n = 0; n < 16; ++n) col[n] = p[(lut >> (2 * n)) & 3];
}

// The 8-byte alpha block of BC3 (and each channel of BC4 / BC5): its 6- and
// 8-value ramps; signed endpoints (BC5S) are read as int8 + 128.
void bc3_alpha(uint8_t* dst, int stride, const uint8_t* s, bool sign) {
  const int a0 = sign ? static_cast<int8_t>(s[0]) + 128 : s[0];
  const int a1 = sign ? static_cast<int8_t>(s[1]) + 128 : s[1];
  uint8_t a[8] = {uint8_t(a0), uint8_t(a1)};
  if (a0 > a1) {
    for (int k = 1; k <= 6; ++k) a[k + 1] = uint8_t(((7 - k) * a0 + k * a1) / 7);
  } else {
    for (int k = 1; k <= 4; ++k) a[k + 1] = uint8_t(((5 - k) * a0 + k * a1) / 5);
    a[6] = 0, a[7] = 255;
  }
  const uint32_t lut1 = s[2] | s[3] << 8 | s[4] << 16, lut2 = s[5] | s[6] << 8 | s[7] << 16;
  for (int n = 0; n < 8; ++n) dst[stride * n] = a[(lut1 >> (3 * n)) & 7];
  for (int n = 0; n < 8; ++n) dst[stride * (8 + n)] = a[(lut2 >> (3 * n)) & 7];
}

// ------------------------------------------------------------------- BC7 ----

inline int get_bit(const uint8_t* s, int bit) { return (s[bit >> 3] >> (bit & 7)) & 1; }

inline int get_bits(const uint8_t* s, int bit, int count) {
  if (!count) return 0;
  const int by = bit >> 3;
  bit &= 7;
  if (bit + count <= 8) return (s[by] >> bit) & ((1 << count) - 1);
  return ((s[by] | s[by + 1] << 8) >> bit) & ((1 << count) - 1);
}

struct Bc7Mode {
  int ns, pb, rb, isb, cb, ab, epb, spb, ib, ib2;
};
constexpr Bc7Mode kBc7Modes[8] = {
    {3, 4, 0, 0, 4, 0, 1, 0, 3, 0}, {2, 6, 0, 0, 6, 0, 0, 1, 3, 0}, {3, 6, 0, 0, 5, 0, 0, 0, 2, 0},
    {2, 6, 0, 0, 7, 0, 1, 0, 2, 0}, {1, 0, 2, 1, 5, 6, 0, 0, 2, 3}, {1, 0, 2, 0, 7, 8, 0, 0, 2, 2},
    {1, 0, 0, 0, 7, 7, 1, 0, 4, 0}, {2, 6, 0, 0, 5, 5, 1, 0, 2, 0}};
constexpr int kW2[4] = {0, 21, 43, 64};
constexpr int kW3[8] = {0, 9, 18, 27, 37, 46, 55, 64};
constexpr int kW4[16] = {0, 4, 9, 13, 17, 21, 26, 30, 34, 38, 43, 47, 51, 55, 60, 64};
inline const int* weights(int n) { return n == 2 ? kW2 : n == 3 ? kW3 : kW4; }

inline int subset_of(int ns, int partition, int n) {
  if (ns == 2) return (kPartition2[partition] >> n) & 1;
  if (ns == 3) return (kPartition3[partition] >> (2 * n)) & 3;
  return 0;
}

inline uint8_t expand(int v, int bits) {
  v = (v << (8 - bits)) & 0xff;
  return uint8_t(v | (v >> bits));
}

inline void bc7_lerp(Rgba* d, const Rgba* e, int s0, int s1) {
  const int t0 = 64 - s0, t1 = 64 - s1;
  d->r = uint8_t((t0 * e[0].r + s0 * e[1].r + 32) >> 6);
  d->g = uint8_t((t0 * e[0].g + s0 * e[1].g + 32) >> 6);
  d->b = uint8_t((t0 * e[0].b + s0 * e[1].b + 32) >> 6);
  d->a = uint8_t((t1 * e[0].a + s1 * e[1].a + 32) >> 6);
}

void bc7_block(Rgba* col, const uint8_t* s) {
  if (!s[0]) {  // no mode bit set
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 255};
    return;
  }
  int bit = 0;
  while (!(s[0] & (1 << bit))) ++bit;
  const Bc7Mode& m = kBc7Modes[bit];
  ++bit;
  auto load = [&](int n) {
    const int v = get_bits(s, bit, n);
    bit += n;
    return v;
  };
  int cb = m.cb, ab = m.ab;
  const int* cw = weights(m.ib);
  const int* aw = weights(ab && m.ib2 ? m.ib2 : m.ib);
  const int partition = load(m.pb), rotation = load(m.rb), index_sel = load(m.isb);
  const int numep = m.ns * 2;
  int ep[6][4];
  for (int c = 0; c < 3; ++c)
    for (int i = 0; i < numep; ++i) ep[i][c] = load(cb);
  for (int i = 0; i < numep; ++i) ep[i][3] = ab ? load(ab) : 255;
  if (m.epb) {  // a p-bit per endpoint
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; ++i) {
      const int p = load(1);
      for (int c = 0; c < (ab ? 4 : 3); ++c) ep[i][c] = (ep[i][c] << 1) | p;
    }
  }
  if (m.spb) {  // a p-bit per subset
    ++cb;
    if (ab) ++ab;
    for (int i = 0; i < numep; i += 2) {
      const int p = load(1);
      for (int j = 0; j < 2; ++j)
        for (int c = 0; c < (ab ? 4 : 3); ++c) ep[i + j][c] = (ep[i + j][c] << 1) | p;
    }
  }
  Rgba e[6];
  for (int i = 0; i < numep; ++i) {
    e[i].r = expand(ep[i][0], cb), e[i].g = expand(ep[i][1], cb), e[i].b = expand(ep[i][2], cb);
    e[i].a = ab ? expand(ep[i][3], ab) : uint8_t(ep[i][3]);
  }
  int cibit = bit, aibit = cibit + 16 * m.ib - m.ns;
  for (int i = 0; i < 16; ++i) {
    const int sub = subset_of(m.ns, partition, i);
    int ib = m.ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition]) ||
        (m.ns == 3 && ((sub == 1 && i == kAnchor3a[partition]) || (sub == 2 && i == kAnchor3b[partition]))))
      --ib;
    const int i0 = get_bits(s, cibit, ib);
    cibit += ib;
    if (ab && m.ib2) {
      const int ib2 = i == 0 ? m.ib2 - 1 : m.ib2;
      const int i1 = get_bits(s, aibit, ib2);
      aibit += ib2;
      if (index_sel) bc7_lerp(&col[i], &e[2 * sub], aw[i1], cw[i0]);
      else bc7_lerp(&col[i], &e[2 * sub], cw[i0], aw[i1]);
    } else {
      bc7_lerp(&col[i], &e[2 * sub], cw[i0], cw[i0]);
    }
    if (rotation == 1) std::swap(col[i].r, col[i].a);
    if (rotation == 2) std::swap(col[i].g, col[i].a);
    if (rotation == 3) std::swap(col[i].b, col[i].a);
  }
}

// ------------------------------------------------------------------ BC6H ----

struct Bc6Mode {
  int ns, tr, pb, epb, rb, gb, bb;
  const char* layout;  // the endpoint bits in stream order: "<rgb><0-3>:<first>[-<last>]"
};
// The 14 modes in BcnDecode.c's order (the D3D modes 1-14): the mode bits
// 00, 01, then 00010 ... 11110 (two regions), 00011 ... 01111 (one).
constexpr Bc6Mode kBc6Modes[14] = {
    {2, 1, 5, 10, 5, 5, 5, "g2:4 b2:4 b3:4 r0:0-9 g0:0-9 b0:0-9 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 "
                           "b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3"},
    {2, 1, 5, 7, 6, 6, 6, "g2:5 g3:4 g3:5 r0:0-6 b3:0 b3:1 b2:4 g0:0-6 b2:5 b3:2 g2:4 b0:0-6 b3:3 b3:5 b3:4 r1:0-5 "
                          "g2:0-3 g1:0-5 g3:0-3 b1:0-5 b2:0-3 r2:0-5 r3:0-5"},
    {2, 1, 5, 11, 5, 4, 4, "r0:0-9 g0:0-9 b0:0-9 r1:0-4 r0:10 g2:0-3 g1:0-3 g0:10 b3:0 g3:0-3 b1:0-3 b0:10 b3:1 "
                           "b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3"},
    {2, 1, 5, 11, 4, 5, 4, "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:10 g3:4 g2:0-3 g1:0-4 g0:10 g3:0-3 b1:0-3 b0:10 b3:1 "
                           "b2:0-3 r2:0-3 b3:0 b3:2 r3:0-3 g2:4 b3:3"},
    {2, 1, 5, 11, 4, 4, 5, "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:10 b2:4 g2:0-3 g1:0-3 g0:10 b3:0 g3:0-3 b1:0-4 b0:10 "
                           "b2:0-3 r2:0-3 b3:1 b3:2 r3:0-3 b3:4 b3:3"},
    {2, 1, 5, 9, 5, 5, 5, "r0:0-8 b2:4 g0:0-8 g2:4 b0:0-8 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 g3:0-3 b1:0-4 b3:1 "
                          "b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3"},
    {2, 1, 5, 8, 6, 5, 5, "r0:0-7 g3:4 b2:4 g0:0-7 b3:2 g2:4 b0:0-7 b3:3 b3:4 r1:0-5 g2:0-3 g1:0-4 b3:0 g3:0-3 "
                          "b1:0-4 b3:1 b2:0-3 r2:0-5 r3:0-5"},
    {2, 1, 5, 8, 5, 6, 5, "r0:0-7 b3:0 b2:4 g0:0-7 g2:5 g2:4 b0:0-7 g3:5 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-5 g3:0-3 "
                          "b1:0-4 b3:1 b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3"},
    {2, 1, 5, 8, 5, 5, 6, "r0:0-7 b3:1 b2:4 g0:0-7 b2:5 g2:4 b0:0-7 b3:5 b3:4 r1:0-4 g3:4 g2:0-3 g1:0-4 b3:0 "
                          "g3:0-3 b1:0-5 b2:0-3 r2:0-4 b3:2 r3:0-4 b3:3"},
    {2, 0, 5, 6, 6, 6, 6, "r0:0-5 g3:4 b3:0 b3:1 b2:4 g0:0-5 g2:5 b2:5 b3:2 g2:4 b0:0-5 g3:5 b3:3 b3:5 b3:4 r1:0-5 "
                          "g2:0-3 g1:0-5 g3:0-3 b1:0-5 b2:0-3 r2:0-5 r3:0-5"},
    {1, 0, 0, 10, 10, 10, 10, "r0:0-9 g0:0-9 b0:0-9 r1:0-9 g1:0-9 b1:0-9"},
    {1, 1, 0, 11, 9, 9, 9, "r0:0-9 g0:0-9 b0:0-9 r1:0-8 r0:10 g1:0-8 g0:10 b1:0-8 b0:10"},
    {1, 1, 0, 12, 8, 8, 8, "r0:0-9 g0:0-9 b0:0-9 r1:0-7 r0:11-10 g1:0-7 g0:11-10 b1:0-7 b0:11-10"},
    {1, 1, 0, 16, 4, 4, 4, "r0:0-9 g0:0-9 b0:0-9 r1:0-3 r0:15-10 g1:0-3 g0:15-10 b1:0-3 b0:15-10"}};

// Each mode's layout as (endpoint value, bit) per stream bit; values are
// r0 g0 b0 r1 g1 b1 r2 ... b3 (0-11).
struct Bc6Packing {
  uint8_t value[14][75], bit[14][75];
  int count[14];
  Bc6Packing() {
    for (int m = 0; m < 14; ++m) {
      int n = 0;
      for (const char* p = kBc6Modes[m].layout; *p;) {
        if (*p == ' ') {
          ++p;
          continue;
        }
        const int v = (p[1] - '0') * 3 + (p[0] == 'r' ? 0 : p[0] == 'g' ? 1 : 2);
        p += 3;
        int first = 0, last;
        while (*p >= '0' && *p <= '9') first = first * 10 + (*p++ - '0');
        last = first;
        if (*p == '-') {
          ++p;
          last = 0;
          while (*p >= '0' && *p <= '9') last = last * 10 + (*p++ - '0');
        }
        for (int b = first;; b += first <= last ? 1 : -1) {
          value[m][n] = uint8_t(v), bit[m][n] = uint8_t(b), ++n;
          if (b == last) break;
        }
      }
      count[m] = n;
    }
  }
};

inline int sign_extend(int v, int bits) { return (v & (1 << (bits - 1))) ? v - (1 << bits) : v; }

int bc6_unquantize(int v, int bits, bool sign) {
  if (!sign) {
    if (bits >= 15) return v;
    if (!v) return 0;
    if (v == (1 << bits) - 1) return 0xffff;
    return ((v << 16) + 0x8000) >> bits;
  }
  v = static_cast<int16_t>(v & 0xffff);  // the endpoints are 16-bit words, read back signed
  if (bits >= 16) return v;
  int x = v < 0 ? -v : v;
  if (x) x = x >= (1 << (bits - 1)) - 1 ? 0x7fff : ((x << 15) + 0x4000) >> (bits - 1);
  return v < 0 ? -x : x;
}

float half_to_float(uint16_t h) {  // BcnDecode.c's (rygorous's) conversion
  union {
    uint32_t u;
    float f;
  } o, m;
  m.u = 0x77800000;
  o.u = (h & 0x7fffu) << 13;
  o.f *= m.f;
  m.u = 0x47800000;
  if (o.f >= m.f) o.u |= 255u << 23;
  o.u |= (h & 0x8000u) << 16;
  return o.f;
}

uint8_t bc6_channel(int v, bool sign) {
  float f;
  if (sign) {
    f = v < 0 ? half_to_float(uint16_t(0x8000 | ((-v) * 31 / 32))) : half_to_float(uint16_t(v * 31 / 32));
  } else {
    f = half_to_float(uint16_t(v * 31 / 64));
  }
  if (f < 0.0f) return 0;
  if (f > 1.0f) return 255;
  return uint8_t(f * 255.0f);
}

void bc6_block(Rgba* col, const uint8_t* s, bool sign) {
  static const Bc6Packing packing;
  int mode = s[0] & 0x1f, bit = 5, ib = 3;
  if ((mode & 3) < 2) {
    mode &= 3;
    bit = 2;
  } else if ((mode & 3) == 2) {
    mode = 2 + (mode >> 2);
  } else {
    mode = 10 + (mode >> 2);
    ib = 4;
  }
  if (mode >= 14) {  // a reserved mode: black
    for (int i = 0; i < 16; ++i) col[i] = Rgba{0, 0, 0, 0};
    return;
  }
  const Bc6Mode& m = kBc6Modes[mode];
  int ep[12] = {0};
  for (int i = 0; i < packing.count[mode]; ++i)
    ep[packing.value[mode][i]] |= get_bit(s, bit + i) << packing.bit[mode][i];
  bit += packing.count[mode];
  const int partition = get_bits(s, bit, m.pb);
  bit += m.pb;
  const int numep = m.ns == 2 ? 12 : 6, mask = (1 << m.epb) - 1;
  if (sign)
    for (int c = 0; c < 3; ++c) ep[c] = sign_extend(ep[c], m.epb);
  if (sign || m.tr) {
    const int db[3] = {m.rb, m.gb, m.bb};
    for (int i = 3; i < numep; ++i) ep[i] = sign_extend(ep[i], db[i % 3]);
  }
  if (m.tr)  // the sums are not sign-extended again: in SF16 they read as non-negative words
    for (int i = 3; i < numep; ++i) ep[i] = (ep[i] + ep[i % 3]) & mask;
  int u[12];
  for (int i = 0; i < numep; ++i) u[i] = bc6_unquantize(ep[i], m.epb, sign);
  const int* cw = weights(ib);
  for (int i = 0; i < 16; ++i) {
    const int sub = m.ns == 2 ? (kPartition2[partition] >> i) & 1 : 0;
    int n = ib;
    if (i == 0 || (m.ns == 2 && i == kAnchor2[partition])) --n;
    const int w = cw[get_bits(s, bit, n)];
    bit += n;
    const int* e0 = u + 6 * sub;
    const int* e1 = e0 + 3;
    col[i] = Rgba{bc6_channel((e0[0] * (64 - w) + e1[0] * w) >> 6, sign),
                  bc6_channel((e0[1] * (64 - w) + e1[1] * w) >> 6, sign),
                  bc6_channel((e0[2] * (64 - w) + e1[2] * w) >> 6, sign), 0};
  }
}

// ------------------------------------------------------------------ file ----

enum Kind { KRGB, KL, KLA, KP, KRGBA8, KBC };

class Dds {
 public:
  Dds(const uint8_t* d, size_t n) : d_(d), n_(n) {
    if (n_ < 8 || memcmp(d_, "DDS ", 4) != 0) corrupt("not a DDS file");
    if (le32(d_ + 4) != 124) refused("a DDS header size of " + std::to_string(le32(d_ + 4)));
    if (n_ < 128) refused("an incomplete DDS header");
    const uint8_t* h = d_ + 8;
    h_ = le32(h + 4), w_ = le32(h + 8);
    const uint32_t pfflags = le32(h + 72), fcc = le32(h + 76);
    bitcount_ = le32(h + 80);
    pos_ = 128;
    if (pfflags & 0x40) {  // DDPF.RGB
      kind_ = KRGB;
      nmasks_ = (pfflags & 0x1) ? 4 : 3;
      for (int i = 0; i < nmasks_; ++i) masks_[i] = le32(h + 84 + 4 * i);
    } else if (pfflags & 0x20000) {  // DDPF.LUMINANCE
      if (bitcount_ == 8) kind_ = KL;
      else if (bitcount_ == 16 && (pfflags & 0x1)) kind_ = KLA;
      else refused("a DDS luminance bit count of " + std::to_string(bitcount_));
    } else if (pfflags & 0x20) {  // DDPF.PALETTEINDEXED8
      kind_ = KP;
      const size_t got = std::min<size_t>(1024, n_ - pos_);
      palette_.assign(d_ + pos_, d_ + pos_ + got);
      pos_ += got;
    } else if (pfflags & 0x4) {  // DDPF.FOURCC
      kind_ = KBC;
      if (fcc == fourcc("DXT1")) {
        bc_ = 1;
      } else if (fcc == fourcc("DXT3")) {
        bc_ = 2;
      } else if (fcc == fourcc("DXT5")) {
        bc_ = 3;
      } else if (fcc == fourcc("BC4U") || fcc == fourcc("ATI1")) {
        bc_ = 4;
      } else if (fcc == fourcc("BC5S")) {
        bc_ = 5, signed_ = true;
      } else if (fcc == fourcc("BC5U") || fcc == fourcc("ATI2")) {
        bc_ = 5;
      } else if (fcc == fourcc("DX10")) {
        if (n_ - pos_ < 4) corrupt("a DDS DX10 header cut short");
        const uint32_t dxgi = le32(d_ + pos_);
        pos_ = std::min(pos_ + 20, n_);
        if (dxgi == 70 || dxgi == 71) bc_ = 1;
        else if (dxgi == 73 || dxgi == 74) bc_ = 2;
        else if (dxgi == 76 || dxgi == 77) bc_ = 3;
        else if (dxgi == 79 || dxgi == 80) bc_ = 4;
        else if (dxgi == 82 || dxgi == 83) bc_ = 5;
        else if (dxgi == 84) bc_ = 5, signed_ = true;
        else if (dxgi == 95) bc_ = 6;
        else if (dxgi == 96) bc_ = 6, signed_ = true;
        else if (dxgi == 97 || dxgi == 98 || dxgi == 99) bc_ = 7;
        else if (dxgi == 27 || dxgi == 28 || dxgi == 29) kind_ = KRGBA8;
        else refused("the DXGI format " + std::to_string(dxgi) + " (unimplemented)");
      } else {
        refused("the DDS pixel format " + std::to_string(fcc) + " (unimplemented)");
      }
    } else {
      refused("the DDS pixel format flags " + std::to_string(pfflags) + " (unknown)");
    }
    if (w_ == 0 || h_ == 0) corrupt("a DDS image of no pixels");
    if (uint64_t(w_) * h_ > kMaxPixels) refused("a DDS image past twice MAX_IMAGE_PIXELS");
  }

  int64_t height() const { return h_; }
  int64_t width() const { return w_; }

  void decode(uint8_t* out) {
    const size_t W = w_, H = h_, npx = W * H, avail = n_ - pos_;
    const uint8_t* s = d_ + pos_;
    switch (kind_) {
      case KRGB: {
        int shift[4], total[4];
        for (int i = 0; i < nmasks_; ++i) {  // DdsRgbDecoder: the mask's trailing zeros and its width
          shift[i] = masks_[i] ? __builtin_ctz(masks_[i]) : 0;
          total[i] = static_cast<int>(masks_[i] >> shift[i]);
        }
        const size_t bytes = bitcount_ / 8;
        size_t at = 0;
        for (size_t i = 0; i < npx; ++i) {
          const size_t got = at >= avail ? 0 : std::min(bytes, avail - at);
          uint32_t v = 0;
          for (size_t k = 0; k < std::min<size_t>(got, 4); ++k) v |= uint32_t(s[at + k]) << (8 * k);
          at += got;
          for (int c = 0; c < 3; ++c) {
            const uint32_t x = (v & masks_[c]) >> shift[c];
            out[3 * i + c] = total[c] ? static_cast<uint8_t>(
                                            static_cast<int>(static_cast<double>(x) / uint32_t(total[c]) * 255.0))
                                      : 0;
          }
        }
        return;
      }
      case KL: case KLA: case KRGBA8: {
        const size_t ps = kind_ == KL ? 1 : kind_ == KLA ? 2 : 4;
        if (avail < npx * ps) corrupt("image file is truncated");
        for (size_t i = 0; i < npx; ++i) {
          const uint8_t* p = s + ps * i;
          if (ps == 4) out[3 * i] = p[0], out[3 * i + 1] = p[1], out[3 * i + 2] = p[2];
          else out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = p[0];
        }
        return;
      }
      case KP: {
        if (avail < npx) corrupt("image file is truncated");
        for (size_t i = 0; i < npx; ++i) {
          const size_t e = 4 * static_cast<size_t>(s[i]);
          for (int c = 0; c < 3; ++c) out[3 * i + c] = e + c < palette_.size() ? palette_[e + c] : 0;
        }
        return;
      }
      case KBC:
        bcn(s, avail, out);
        return;
    }
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  uint32_t w_ = 0, h_ = 0, bitcount_ = 0, masks_[4] = {0, 0, 0, 0};
  int nmasks_ = 0, bc_ = 0;
  bool signed_ = false;
  Kind kind_ = KRGB;
  std::vector<uint8_t> palette_;

  // BcnDecode.c: blocks in rows of ceil(W / 4), each cut to the image.
  void bcn(const uint8_t* s, size_t avail, uint8_t* out) const {
    const size_t bw = (w_ + 3) / 4, bh = (h_ + 3) / 4;
    const size_t bsize = bc_ == 1 || bc_ == 4 ? 8 : 16;
    if (avail / bsize < bw * bh) corrupt("image file is truncated");
    Rgba col[16];
    uint8_t lum[16];
    for (size_t by = 0; by < bh; ++by) {
      for (size_t bx = 0; bx < bw; ++bx) {
        const uint8_t* b = s + (by * bw + bx) * bsize;
        memset(col, 0, sizeof col);
        switch (bc_) {
          case 1: bc1_color(col, b, false); break;
          case 2:
            bc1_color(col, b + 8, true);
            for (int n = 0; n < 16; ++n) {
              const int a = (b[n >> 1] >> (4 * (n & 1))) & 0xf;
              col[n].a = uint8_t(a << 4 | a);
            }
            break;
          case 3:
            bc1_color(col, b + 8, true);
            bc3_alpha(&col[0].a, 4, b, false);
            break;
          case 4: bc3_alpha(lum, 1, b, false); break;
          case 5:
            bc3_alpha(&col[0].r, 4, b, signed_);
            bc3_alpha(&col[0].g, 4, b + 8, signed_);
            if (signed_)
              for (Rgba& c : col) c.b = 128;  // BC5S leaves blue at signed zero, BC5 at 0
            break;
          case 6: bc6_block(col, b, signed_); break;
          default: bc7_block(col, b);
        }
        for (int j = 0; j < 4; ++j) {
          const size_t y = by * 4 + j;
          if (y >= h_) break;
          for (int i = 0; i < 4; ++i) {
            const size_t x = bx * 4 + i;
            if (x >= w_) break;
            uint8_t* o = out + 3 * (y * w_ + x);
            if (bc_ == 4) o[0] = o[1] = o[2] = lum[4 * j + i];
            else o[0] = col[4 * j + i].r, o[1] = col[4 * j + i].g, o[2] = col[4 * j + i].b;
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
int rf_dds_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Dds dds(data, static_cast<size_t>(n));
    dims[0] = static_cast<int32_t>(dds.height());
    dims[1] = static_cast<int32_t>(dds.width());
    if (!out || cap < dds.height() * dds.width() * 3) return RF_NEED_BUFFER;
    dds.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("DDS decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
