// The PPM family, as Pillow 12.1's PpmImagePlugin reads it and
// `convert("RGB")` converts it, behind a plain C interface bound with ctypes
// in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * the header: a magic of at most six bytes up to whitespace (P1-P6,
//     Pf, and Pillow's own P0CMYK, PyP, PyRGBA and PyCMYK), then tokens of
//     at most ten bytes, `#` comments running to CR or LF (inside a token
//     too, which then goes on), numbers as Python's int() takes them (a
//     sign, underscores between digits), Pf's scale as float() takes it;
//   * raw data through Pillow's raw decoder: P4 as "1;I", P5 and P6 at
//     maxval 255, P5 at 65535 as "I;16B", Pf as little- or big-endian
//     floats by the scale's sign, rows bottom-up, and the Py* modes;
//   * other maxvals through its PpmDecoder (one byte a sample below 256,
//     else two, big-endian; round(v / maxval * out) with Python's
//     half-even rounding, out 65535 for P5 past 255, else 255);
//   * P1-P3 through its PpmPlainDecoder: 1 MiB blocks, comments cut out
//     (joining what is around them, across blocks too), tokens split at
//     block ends, P1's digits with or without whitespace;
//   * then I clipped to 0-255, F truncated and clipped, CMYK through
//     Convert.c's cmyk2rgb, RGBA without alpha, PyP (a palette image
//     without a palette) black.
//
// What PIL refuses (P7 / PAM, PF, any other magic, a bad token, a value past
// maxval, too little data) returns RF_REFUSED or RF_CORRUPT. Every read is
// bounded by the buffer.

#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "codec_common.h"
#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS
constexpr size_t kSafeBlock = 1024 * 1024;                              // ImageFile.SAFEBLOCK

inline bool is_space(uint8_t c) { return c == 0x20 || (c >= 0x09 && c <= 0x0d); }
inline bool is_digit(uint8_t c) { return c >= '0' && c <= '9'; }

// Python's int() of an ASCII token: [+-] digits, single underscores between
// digits. False if it would raise.
bool py_int(const std::string& t, int64_t* v) {
  size_t i = 0;
  bool neg = false;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) neg = t[i++] == '-';
  if (i >= t.size() || !is_digit(t[i])) return false;
  int64_t r = 0;
  for (; i < t.size(); ++i) {
    if (t[i] == '_') {
      if (i + 1 >= t.size() || !is_digit(t[i + 1])) return false;
      continue;
    }
    if (!is_digit(t[i])) return false;
    r = r * 10 + (t[i] - '0');
  }
  *v = neg ? -r : r;
  return true;
}

// Python's float() of an ASCII token, as far as the sign and finiteness go.
bool py_float(const std::string& t, double* v) {
  std::string s;
  size_t i = 0;
  if (i < t.size() && (t[i] == '+' || t[i] == '-')) s += t[i++];
  std::string rest = t.substr(i), low;
  for (char c : rest) low += static_cast<char>(c >= 'A' && c <= 'Z' ? c + 32 : c);
  if (low == "inf" || low == "infinity" || low == "nan") {
    *v = low == "nan" ? NAN : (s == "-" ? -INFINITY : INFINITY);
    return true;
  }
  int digits = 0;
  bool dot = false, exp = false;
  for (size_t k = 0; k < rest.size(); ++k) {
    char c = rest[k];
    if (c == '_') {
      if (k == 0 || k + 1 >= rest.size() || !is_digit(rest[k - 1]) || !is_digit(rest[k + 1])) return false;
      continue;
    }
    if (is_digit(c)) {
      if (!exp) ++digits;
    } else if (c == '.' && !dot && !exp) {
      dot = true;
    } else if ((c == 'e' || c == 'E') && !exp && digits) {
      exp = true;
      if (k + 1 < rest.size() && (rest[k + 1] == '+' || rest[k + 1] == '-')) s += c, c = rest[++k];
      if (k + 1 >= rest.size() || !is_digit(rest[k + 1])) return false;
    } else {
      return false;
    }
    s += c;
  }
  if (!digits) return false;
  *v = strtod(s.c_str(), nullptr);
  return true;
}

enum Mode { M1, ML, MI, MRGB, MCMYK, MP, MRGBA, MF };

class Ppm {
 public:
  Ppm(const uint8_t* d, size_t n) : d_(d), n_(n) {
    std::string magic;
    for (int i = 0; i < 6; ++i) {
      if (pos_ >= n_) break;
      uint8_t c = d_[pos_++];
      if (is_space(c)) break;
      magic += static_cast<char>(c);
    }
    if (magic == "P1" || magic == "P4") {
      mode_ = M1;
    } else if (magic == "P2" || magic == "P5") {
      mode_ = ML;
    } else if (magic == "P3" || magic == "P6") {
      mode_ = MRGB;
    } else if (magic == "P0CMYK" || magic == "PyCMYK") {
      mode_ = MCMYK;
    } else if (magic == "Pf") {
      mode_ = MF;
    } else if (magic == "PyP") {
      mode_ = MP;
    } else if (magic == "PyRGBA") {
      mode_ = MRGBA;
    } else if (magic.size() >= 2 && magic[1] == '7') {
      refused("a PAM (P7) file");
    } else if (magic.size() >= 2 && magic[1] == 'F') {
      refused("a colour PFM (PF) file");
    } else {
      refused("a Netpbm file of magic '" + magic + "'");
    }
    plain_ = magic == "P1" || magic == "P2" || magic == "P3";
    int64_t w = number(), h = number();
    if (w <= 0 || h <= 0) corrupt("PPM of size 0 or negative");
    if (uint64_t(w) * uint64_t(h) > kMaxPixels) refused("a PPM image past twice MAX_IMAGE_PIXELS");
    w_ = static_cast<uint32_t>(w), h_ = static_cast<uint32_t>(h);
    if (mode_ == MF) {
      double scale;
      if (!py_float(token(), &scale)) corrupt("bad PFM scale");
      if (scale == 0.0 || !std::isfinite(scale)) corrupt("scale must be finite and non-zero");
      little_ = scale < 0;
    } else if (mode_ != M1) {
      maxval_ = number();
      if (!(0 < maxval_ && maxval_ < 65536)) corrupt("maxval must be greater than 0 and less than 65536");
      if (maxval_ > 255 && mode_ == ML) mode_ = MI;
    }
  }

  uint32_t width() const { return w_; }
  uint32_t height() const { return h_; }

  void decode(uint8_t* out) {
    const size_t npx = size_t(w_) * h_;
    if (mode_ == M1) {
      std::vector<uint8_t> v(npx);
      if (plain_) {
        bitonal(v);
      } else {
        const size_t stride = (size_t(w_) + 7) / 8;
        need(stride * h_);
        for (size_t y = 0; y < h_; ++y)
          for (size_t x = 0; x < w_; ++x) v[y * w_ + x] = (d_[pos_ + y * stride + x / 8] >> (7 - x % 8)) & 1 ? 0 : 255;
      }
      for (size_t i = 0; i < npx; ++i) out[3 * i] = out[3 * i + 1] = out[3 * i + 2] = v[i];
      return;
    }
    if (mode_ == MF) {
      need(npx * 4);
      for (size_t y = 0; y < h_; ++y)
        for (size_t x = 0; x < w_; ++x) {
          const uint8_t* p = d_ + pos_ + ((h_ - 1 - y) * size_t(w_) + x) * 4;
          uint32_t bits = little_ ? (p[0] | p[1] << 8 | p[2] << 16 | uint32_t(p[3]) << 24)
                                  : (uint32_t(p[0]) << 24 | p[1] << 16 | p[2] << 8 | p[3]);
          float f;
          memcpy(&f, &bits, 4);
          // Convert.c f2l: clip, else truncate (NaN: x86's 0x80000000, low byte 0)
          uint8_t v = f <= 0.0f ? 0 : f >= 255.0f ? 255 : std::isnan(f) ? 0 : static_cast<uint8_t>(static_cast<int>(f));
          uint8_t* o = out + 3 * (y * w_ + x);
          o[0] = o[1] = o[2] = v;
        }
      return;
    }
    const int bands = mode_ == MRGB ? 3 : (mode_ == MCMYK || mode_ == MRGBA) ? 4 : 1;
    const int64_t out_max = mode_ == MI ? 65535 : 255;
    std::vector<int64_t> s(npx * bands);  // the samples as Pillow stores them
    if (plain_) {
      blocks(s);
    } else if (maxval_ == 255 || (maxval_ == 65535 && mode_ == MI)) {  // the raw decoder
      const int bytes = maxval_ == 255 ? 1 : 2;
      need(s.size() * bytes);
      for (size_t i = 0; i < s.size(); ++i)
        s[i] = bytes == 1 ? d_[pos_ + i] : (d_[pos_ + 2 * i] << 8 | d_[pos_ + 2 * i + 1]);
    } else {  // PpmDecoder
      const int in_bytes = maxval_ < 256 ? 1 : 2;
      const size_t group = size_t(in_bytes) * bands, groups = (n_ - pos_) / group;
      if (groups < npx) corrupt("not enough image data");
      for (size_t i = 0; i < s.size(); ++i) {
        const uint8_t* p = d_ + pos_ + i * in_bytes;
        int64_t v = in_bytes == 1 ? p[0] : (p[0] << 8 | p[1]);
        s[i] = std::min<int64_t>(out_max, scale(v, out_max));
      }
    }
    for (size_t i = 0; i < npx; ++i) {
      uint8_t* o = out + 3 * i;
      const int64_t* p = s.data() + i * bands;
      switch (mode_) {
        case ML:
          o[0] = o[1] = o[2] = static_cast<uint8_t>(p[0]);
          break;
        case MI:
          o[0] = o[1] = o[2] = static_cast<uint8_t>(p[0] > 255 ? 255 : p[0]);
          break;
        case MP:
          o[0] = o[1] = o[2] = 0;
          break;
        case MCMYK:
          cmyk_to_rgb(p[0], p[1], p[2], p[3], o);
          break;
        default:  // RGB, RGBA
          o[0] = static_cast<uint8_t>(p[0]), o[1] = static_cast<uint8_t>(p[1]), o[2] = static_cast<uint8_t>(p[2]);
      }
    }
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  Mode mode_ = ML;
  bool plain_ = false, little_ = false, comment_spans_ = false;
  uint32_t w_ = 0, h_ = 0;
  int64_t maxval_ = 255;
  size_t block_pos_ = 0;  // the plain decoders' read position

  void need(size_t bytes) const {
    if (n_ - pos_ < bytes) corrupt("image file is truncated");
  }

  // round(v / maxval * out) as Python computes it
  int64_t scale(int64_t v, int64_t out) const {
    const double x = static_cast<double>(v) / static_cast<double>(maxval_) * static_cast<double>(out);
    return static_cast<int64_t>(std::nearbyint(x));
  }

  // PpmImageFile._read_token
  std::string token() {
    std::string t;
    while (t.size() <= 10) {
      if (pos_ >= n_) break;
      uint8_t c = d_[pos_++];
      if (is_space(c)) {
        if (t.empty()) continue;
        break;
      }
      if (c == '#') {
        while (pos_ < n_) {
          uint8_t e = d_[pos_++];
          if (e == '\r' || e == '\n') break;
        }
        continue;
      }
      t += static_cast<char>(c);
    }
    if (t.empty()) corrupt("Reached EOF while reading header");
    if (t.size() > 10) corrupt("Token too long in file header");
    return t;
  }
  int64_t number() {
    int64_t v;
    if (!py_int(token(), &v)) corrupt("invalid literal for int() in the PPM header");
    return v;
  }

  std::string read_block() {
    if (block_pos_ == 0) block_pos_ = pos_;
    size_t k = std::min(kSafeBlock, n_ - block_pos_);
    std::string b(reinterpret_cast<const char*>(d_ + block_pos_), k);
    block_pos_ += k;
    return b;
  }
  static long find_comment_end(const std::string& b, size_t start) {
    size_t fa = b.find('\n', start), fb = b.find('\r', start);
    long a = fa == std::string::npos ? -1 : static_cast<long>(fa);
    long c = fb == std::string::npos ? -1 : static_cast<long>(fb);
    return a * c > 0 ? std::min(a, c) : std::max(a, c);
  }
  std::string ignore_comments(std::string b) {
    if (comment_spans_) {
      while (!b.empty()) {
        long e = find_comment_end(b, 0);
        if (e != -1) {
          b = b.substr(e + 1);
          break;
        }
        b = read_block();
      }
    }
    comment_spans_ = false;
    for (;;) {
      size_t s = b.find('#');
      if (s == std::string::npos) break;
      long e = find_comment_end(b, s);
      if (e != -1) {
        b = b.substr(0, s) + b.substr(e + 1);
      } else {
        b = b.substr(0, s);
        comment_spans_ = true;
        break;
      }
    }
    return b;
  }
  static std::vector<std::string> split(const std::string& b) {
    std::vector<std::string> out;
    size_t i = 0;
    while (i < b.size()) {
      while (i < b.size() && is_space(b[i])) ++i;
      size_t j = i;
      while (j < b.size() && !is_space(b[j])) ++j;
      if (j > i) out.push_back(b.substr(i, j - i));
      i = j;
    }
    return out;
  }

  // PpmPlainDecoder._decode_bitonal
  void bitonal(std::vector<uint8_t>& v) {
    std::string data;
    const size_t total = v.size();
    while (data.size() != total) {
      std::string b = read_block();
      if (b.empty()) break;
      b = ignore_comments(b);
      std::string tokens;
      for (const auto& t : split(b)) tokens += t;
      for (char c : tokens)
        if (c != '0' && c != '1') corrupt("Invalid token for this mode");
      data += tokens;
      if (data.size() > total) data.resize(total);
    }
    if (data.size() < total) corrupt("not enough image data");
    for (size_t i = 0; i < total; ++i) v[i] = data[i] == '0' ? 255 : 0;
  }

  // PpmPlainDecoder._decode_blocks
  void blocks(std::vector<int64_t>& s) {
    const int64_t out_max = mode_ == MI ? 65535 : 255;
    size_t have = 0;
    std::string half;
    bool done = false;
    while (have != s.size() && !done) {
      std::string b = read_block();
      if (b.empty()) {
        if (half.empty()) break;
        b = " ";
      }
      b = ignore_comments(b);
      if (!half.empty()) {
        b = half + b;
        half.clear();
      }
      std::vector<std::string> tokens = split(b);
      if (!b.empty() && !is_space(b.back())) {
        half = tokens.back();
        tokens.pop_back();
        if (half.size() > 10) corrupt("Token too long found in data");
      }
      for (const auto& t : tokens) {
        if (t.size() > 10) corrupt("Token too long found in data");
        int64_t v;
        if (!py_int(t, &v)) corrupt("invalid literal for int() in PPM data");
        if (v < 0) corrupt("Channel value is negative");
        if (v > maxval_) corrupt("Channel value too large for this mode");
        s[have++] = scale(v, out_max);
        if (have == s.size()) {
          done = true;
          break;
        }
      }
    }
    if (have < s.size()) corrupt("not enough image data");
  }
};

}  // namespace

extern "C" {

// Decodes `data` into `out` ((H, W, 3) uint8 RGB, capacity `cap` bytes). With
// `out` null or too small it stops after the header and returns
// RF_NEED_BUFFER with the size in dims = (H, W).
int rf_ppm_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Ppm ppm(data, static_cast<size_t>(n));
    dims[0] = static_cast<int32_t>(ppm.height());
    dims[1] = static_cast<int32_t>(ppm.width());
    if (!out || cap < static_cast<int64_t>(ppm.height()) * ppm.width() * 3) return RF_NEED_BUFFER;
    ppm.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("PPM decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
