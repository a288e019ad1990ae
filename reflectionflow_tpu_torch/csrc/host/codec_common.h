// Helpers shared by the host codecs of this directory (hashed, like
// `status.h`, into every library's build key by
// `ops/kernel_build.py::build_host_all`):
//
//   * `packbits`: libtiff's PackBitsDecode over a whole strip (TIFF), and
//     `PilPackbits`: Pillow's own PackbitsDecode.c, which fills one row at a
//     time and drops what a packet holds past the row's end (PSD);
//   * `LabToRgb`: ImageCms's littleCMS LAB -> sRGB transform (TIFF, PSD);
//   * `cmyk_to_rgb`: Convert.c's cmyk2rgb (JPEG, JPEG 2000, TIFF, PPM, PSD).

#pragma once

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

bool packbits(const uint8_t* bp, size_t cc, uint8_t* op, size_t occ) {  // tif_packbits.c PackBitsDecode
  while (cc > 0 && occ > 0) {
    long n = static_cast<int8_t>(*bp++);
    cc--;
    if (n < 0) {
      if (n == -128) continue;
      n = -n + 1;
      if (occ < static_cast<size_t>(n)) n = static_cast<long>(occ);
      if (cc == 0) break;
      occ -= static_cast<size_t>(n);
      uint8_t b = *bp++;
      cc--;
      while (n-- > 0) *op++ = b;
    } else {
      if (occ < static_cast<size_t>(n + 1)) n = static_cast<long>(occ) - 1;
      if (cc < static_cast<size_t>(n + 1)) break;
      ++n;
      memcpy(op, bp, static_cast<size_t>(n));
      op += n;
      occ -= static_cast<size_t>(n);
      bp += n;
      cc -= static_cast<size_t>(n);
    }
  }
  if (occ > 0) memset(op, 0, occ);
  return occ == 0;
}

// Pillow's PackbitsDecode.c over `n` bytes: fills `rows` rows of
// `row_bytes` each into `out`, a row at a time; a run or a literal that
// reaches past a row's end fills the row and the rest of it is dropped, the
// next packet starting the next row. Returns the bytes it consumed, or -1
// when the data ends before the last row (Pillow waits for more, and
// ImageFile.load raises "image file is truncated").
inline int64_t pil_packbits(const uint8_t* p, size_t n, uint8_t* out, size_t row_bytes, size_t rows) {
  size_t at = 0, x = 0, y = 0;
  if (rows == 0 || row_bytes == 0) return 0;
  while (true) {
    if (at >= n) return -1;
    const uint8_t c = p[at];
    if (c & 0x80) {
      if (c == 0x80) {  // no-op
        ++at;
        continue;
      }
      if (n - at < 2) return -1;
      for (int k = 257 - c; k > 0 && x < row_bytes; --k) out[y * row_bytes + x++] = p[at + 1];
      at += 2;
    } else {
      const size_t len = static_cast<size_t>(c) + 2;
      if (n - at < len) return -1;
      for (size_t i = 1; i < len && x < row_bytes; ++i) out[y * row_bytes + x++] = p[at + i];
      at += len;
    }
    if (x >= row_bytes) {
      x = 0;
      if (++y >= rows) return static_cast<int64_t>(at);
    }
  }
}

// Convert.c cmyk2rgb: nk = 255 - k, each of r, g, b = nk - MULDIV255(c, nk).
inline void cmyk_to_rgb(int c, int m, int y, int k, uint8_t* rgb) {
  const int nk = 255 - k, cmy[3] = {c, m, y};
  for (int i = 0; i < 3; ++i) {
    const int t = cmy[i] * nk + 128;
    const int v = nk - (((t >> 8) + t) >> 8);
    rgb[i] = static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
  }
}

// ------------------------------------------------------------ LAB -> RGB ----
//
// ImageCms's LAB -> sRGB transform, as littleCMS 2.17 builds it for Pillow
// (cmsCreateLab2Profile -> cmsCreate_sRGBProfile, perceptual, 8-bit LabV2 with
// a padding byte in, RGBA 8 out): the pipeline (Lab -> XYZ over D50, the
// inverse of the sRGB colorants adapted to D50 by Bradford, the inverse sRGB
// curve) evaluated in float at the nodes of a 33^3 16-bit CLUT
// (OptimizeByResampling, XFormSampler16), then per pixel the CLUT's 16-bit
// tetrahedral interpolation (TetrahedralInterp16) of byte * 257 and the
// 16 -> 8 bit rounding. Pillow's LAB bytes hold a and b signed, so the
// unroller's bytes are a ^ 128 and b ^ 128. Held to PIL on all 2^24 inputs.

class LabToRgb {
 public:
  static constexpr int N = 33;

  static const LabToRgb& get() {  // built on first use
    static const LabToRgb table;
    return table;
  }

  LabToRgb() : clut_(3 * N * N * N) {
    typedef double M3[3][3];
    auto inv = [](const M3& a, M3& b) {
      const double c0 = a[1][1] * a[2][2] - a[1][2] * a[2][1];
      const double c1 = -a[1][0] * a[2][2] + a[1][2] * a[2][0];
      const double c2 = a[1][0] * a[2][1] - a[1][1] * a[2][0];
      const double det = a[0][0] * c0 + a[0][1] * c1 + a[0][2] * c2;
      b[0][0] = c0 / det;
      b[0][1] = (a[0][2] * a[2][1] - a[0][1] * a[2][2]) / det;
      b[0][2] = (a[0][1] * a[1][2] - a[0][2] * a[1][1]) / det;
      b[1][0] = c1 / det;
      b[1][1] = (a[0][0] * a[2][2] - a[0][2] * a[2][0]) / det;
      b[1][2] = (a[0][2] * a[1][0] - a[0][0] * a[1][2]) / det;
      b[2][0] = c2 / det;
      b[2][1] = (a[0][1] * a[2][0] - a[0][0] * a[2][1]) / det;
      b[2][2] = (a[0][0] * a[1][1] - a[0][1] * a[1][0]) / det;
    };
    auto mul = [](const M3& a, const M3& b, M3& r) {
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) r[i][j] = a[i][0] * b[0][j] + a[i][1] * b[1][j] + a[i][2] * b[2][j];
    };
    auto ev = [](const M3& a, const double* v, double* r) {
      for (int i = 0; i < 3; ++i) r[i] = a[i][0] * v[0] + a[i][1] * v[1] + a[i][2] * v[2];
    };
    // cmsCreate_sRGBProfile: _cmsBuildRGB2XYZtransferMatrix, adapted to D50
    const double xn = 0.3127, yn = 0.3290, xr = 0.64, yr = 0.33, xg = 0.30, yg = 0.60, xb = 0.15, yb = 0.06;
    const M3 prim = {{xr, xg, xb}, {yr, yg, yb}, {1 - xr - yr, 1 - xg - yg, 1 - xb - yb}};
    M3 pinv, m, br_inv, cone, t1, conv, rgb2xyz;
    inv(prim, pinv);
    const double white[3] = {xn / yn, 1.0, (1.0 - xn - yn) / yn};
    double coef[3];
    ev(pinv, white, coef);
    const M3 mc = {{coef[0] * xr, coef[1] * xg, coef[2] * xb}, {coef[0] * yr, coef[1] * yg, coef[2] * yb},
                   {coef[0] * (1.0 - xr - yr), coef[1] * (1.0 - xg - yg), coef[2] * (1.0 - xb - yb)}};
    const double dn[3] = {(xn / yn) * 1.0, 1.0, ((1 - xn - yn) / yn) * 1.0};
    const M3 br = {{0.8951, 0.2664, -0.1614}, {-0.7502, 1.7135, 0.0367}, {0.0389, -0.0685, 1.0296}};
    inv(br, br_inv);
    double cs[3], cd[3];
    ev(br, dn, cs);
    ev(br, kD50, cd);
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) cone[i][j] = i == j ? cd[i] / cs[i] : 0.0;
    mul(cone, br, t1);
    mul(br_inv, t1, conv);
    mul(conv, mc, rgb2xyz);
    inv(rgb2xyz, m);  // BuildRGBOutputMatrixShaper: the inverse, scaled for the 1.15 XYZ encoding
    for (auto& row : m)
      for (double& x : row) x *= kMaxXYZ;
    // the CLUT's nodes (x slowest, z fastest), each through the float pipeline
    for (int i = 0; i < N; ++i)
      for (int j = 0; j < N; ++j)
        for (int k = 0; k < N; ++k) {
          const float in[3] = {node(i), node(j), node(k)};
          const double L = static_cast<double>(in[0]) * 100.0, a = static_cast<double>(in[1]) * 255.0 - 128.0,
                       b = static_cast<double>(in[2]) * 255.0 - 128.0;
          const double y = (L + 16.0) / 116.0, x = y + 0.002 * a, z = y - 0.005 * b;
          const float xyz[3] = {static_cast<float>(f1(x) * kD50[0] / kMaxXYZ),
                                static_cast<float>(f1(y) * kD50[1] / kMaxXYZ),
                                static_cast<float>(f1(z) * kD50[2] / kMaxXYZ)};
          for (int c = 0; c < 3; ++c) {
            double t = 0;
            for (int q = 0; q < 3; ++q) t += static_cast<double>(xyz[q]) * m[c][q];
            clut_[static_cast<size_t>(((i * N + j) * N + k) * 3 + c)] =
                saturate_word(curve(static_cast<float>(t)) * 65535.0);
          }
        }
  }

  // Pillow's LAB pixel (L, a, b bytes) -> RGB.
  void convert(const uint8_t* lab, uint8_t* rgb) const {
    const int in[3] = {lab[0] * 257, (lab[1] ^ 128) * 257, (lab[2] ^ 128) * 257};
    int fx[3], r[3], step[3];
    static const int opta[3] = {3 * N * N, 3 * N, 3};
    size_t base = 0;
    for (int c = 0; c < 3; ++c) {
      const int v = in[c] * (N - 1);
      fx[c] = v + (v + 0x7FFF) / 0xFFFF;  // _cmsToFixedDomain
      r[c] = fx[c] & 0xFFFF;
      base += static_cast<size_t>(opta[c]) * static_cast<size_t>(fx[c] >> 16);
      step[c] = in[c] == 0xFFFF ? 0 : opta[c];
    }
    int X1 = step[0], Y1 = step[1], Z1 = step[2];
    const int rx = r[0], ry = r[1], rz = r[2];
    int order;  // TetrahedralInterp16's six cases
    if (rx >= ry) {
      order = ry >= rz ? 0 : (rz >= rx ? 1 : 2);
    } else {
      order = rx >= rz ? 3 : (ry >= rz ? 4 : 5);
    }
    switch (order) {
      case 0: Y1 += X1; Z1 += Y1; break;
      case 1: X1 += Z1; Y1 += X1; break;
      case 2: Z1 += X1; Y1 += Z1; break;
      case 3: X1 += Y1; Z1 += X1; break;
      case 4: Z1 += Y1; X1 += Z1; break;
      default: Y1 += Z1; X1 += Y1; break;
    }
    for (int c = 0; c < 3; ++c) {
      const int64_t* t = clut_.data() + base + c;
      int64_t c0 = t[0], c1 = t[X1], c2 = t[Y1], c3 = t[Z1];
      switch (order) {
        case 0: c3 -= c2; c2 -= c1; c1 -= c0; break;
        case 1: c2 -= c1; c1 -= c3; c3 -= c0; break;
        case 2: c2 -= c3; c3 -= c1; c1 -= c0; break;
        case 3: c3 -= c1; c1 -= c2; c2 -= c0; break;
        case 4: c1 -= c3; c3 -= c2; c2 -= c0; break;
        default: c1 -= c2; c2 -= c3; c3 -= c0; break;
      }
      const int64_t rest = c1 * rx + c2 * ry + c3 * rz + 0x8001;
      const uint64_t o16 = static_cast<uint16_t>(c0 + ((rest + (rest >> 16)) >> 16));
      rgb[c] = static_cast<uint8_t>(((o16 * 65281u + 8388608u) >> 24) & 0xFF);  // FROM_16_TO_8
    }
  }

 private:
  static constexpr double kMaxXYZ = 1.0 + 32767.0 / 32768.0;
  static constexpr double kD50[3] = {0.9642, 1.0, 0.8249};
  std::vector<int64_t> clut_;

  static float node(int i) {  // _cmsQuantizeVal, then XFormSampler16's In / 65535
    const int q = saturate_word(static_cast<double>(i) * 65535.0 / (N - 1));
    return static_cast<float>(q / 65535.0);
  }
  static double f1(double t) { return t <= 24.0 / 116.0 ? (108.0 / 841.0) * (t - 16.0 / 116.0) : t * t * t; }
  // The inverse of the sRGB parametric curve (type -4), in double, as float.
  static float curve(float v) {
    const double g = 2.4, a = 1. / 1.055, b = 0.055 / 1.055, c = 1. / 12.92, d = 0.04045;
    const double r = v, e = a * d + b, disc = e < 0 ? 0 : std::pow(e, g);
    return static_cast<float>(r >= disc ? (std::pow(r, 1.0 / g) - b) / a : r / c);
  }
  // _cmsQuickSaturateWord, with _cmsQuickFloor's magic-number floor.
  static int saturate_word(double d) {
    d += 0.5;
    if (d <= 0) return 0;
    if (d >= 65535.0) return 0xFFFF;
    double t = (d - 32767.0) + 68719476736.0 * 1.5;
    int64_t bits;
    memcpy(&bits, &t, 8);
    return static_cast<int>(static_cast<int32_t>(bits & 0xFFFFFFFF) >> 16) + 32767;
  }
};

}  // namespace
