// GIF decoding of the first frame, as Pillow 12.1's GifImagePlugin opens a
// file and `convert("RGB")` converts it, behind a plain C interface bound
// with ctypes in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`:
//
//   * the header, the global colour table, then blocks until the first image
//     descriptor: extensions (the graphic control extension's transparency
//     index, which stays set once a GCE sets it; comment, application,
//     plain-text and unknown ones skipped by their sub-blocks, with Pillow's
//     reading of an extension whose first sub-block is empty, which goes on
//     skipping sub-blocks past that terminator) and stray bytes, skipped one
//     at a time;
//   * the image is the logical screen, grown to hold a frame that reaches
//     past it; outside the frame it holds the transparency index when a GCE
//     sets one, else index 0 (`convert("RGB")` ignores transparency); a
//     frame at x 0 of width 0 is the whole image (Pillow's setimage takes
//     extents with x0 = x1 = 0 so);
//   * the colours: the local table unless it is the grey ramp (entry i =
//     (i, i, i)), else the global table unless it is the ramp, else grey
//     (index = level); indices past a table are black;
//   * Pillow's LZW decoder (GifDecode.c): minimum code sizes 0-12, clear and
//     end codes, the first code after a clear taken as it is, a code equal to
//     the next free entry (KwKwK), a table of 4096 entries that stops growing
//     when full, literals of more than 8 bits kept modulo 256, interlaced
//     rows in its four passes; it stops at the frame's last pixel, so a
//     missing end code is no fault;
//   * the data as Pillow's ImageFile feeds it: reads of 65536 bytes from the
//     image data, the decoder taking whole sub-blocks only. An end code
//     before the last pixel, or data that runs out, is a truncated file
//     unless a later read still brings data, after which decoding goes on.
//
// What Pillow refuses (a code past the table, a first code past the clear
// code, a minimum code size above 12, another empty frame, an image of more than
// twice PIL's MAX_IMAGE_PIXELS) returns RF_REFUSED; truncated or malformed
// data returns RF_CORRUPT. Every read is bounded by the buffer.

#include <cstdint>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS
constexpr size_t kReadBlock = 65536;  // ImageFile.decodermaxblock
constexpr int kTable = 4096;          // GIFTABLE
constexpr int kMaxBits = 12;          // GIFBITS

inline uint32_t u16(const uint8_t* p) { return p[0] | (p[1] << 8); }

// A colour table is "needed" unless it is the grey ramp (GifImagePlugin's
// _is_palette_needed).
bool is_ramp(const uint8_t* p, size_t n_entries) {
  for (size_t i = 0; i < n_entries; ++i)
    if (p[3 * i] != i || p[3 * i + 1] != i || p[3 * i + 2] != i) return false;
  return true;
}

class Gif {
 public:
  Gif(const uint8_t* d, size_t n) : d_(d), n_(n) {
    if (n < 13 || memcmp(d, "GIF8", 4) != 0 || (d[4] != '7' && d[4] != '9') || d[5] != 'a')
      corrupt("not a GIF file");
    w_ = u16(d + 6);
    h_ = u16(d + 8);
    size_t p = 13;
    if (d[10] & 0x80) {
      const size_t entries = size_t(1) << ((d[10] & 7) + 1);
      if (n - p < 3 * entries) corrupt("truncated GIF colour table");
      if (!is_ramp(d + p, entries)) {
        palette_ = d + p;
        palette_entries_ = entries;
      }
      p += 3 * entries;
    }
    check_size();
    // blocks up to the first image descriptor (GifImageFile._seek(0))
    for (;;) {
      if (p >= n_ || d_[p] == ';') corrupt("image not found in GIF file");
      const uint8_t b = d_[p++];
      if (b == '!') {
        p = extension(p);
      } else if (b == ',') {
        if (n_ - p < 9) corrupt("truncated GIF image descriptor");
        const uint64_t x0 = u16(d_ + p), y0 = u16(d_ + p + 2);
        fw_ = u16(d_ + p + 4);
        fh_ = u16(d_ + p + 6);
        x0_ = x0;
        y0_ = y0;
        if (x0 + fw_ > w_ || y0 + fh_ > h_) {
          w_ = x0 + fw_ > w_ ? x0 + fw_ : w_;
          h_ = y0 + fh_ > h_ ? y0 + fh_ : h_;
          check_size();
        }
        const uint8_t flags = d_[p + 8];
        interlace_ = (flags & 0x40) != 0;
        p += 9;
        if (flags & 0x80) {
          const size_t entries = size_t(1) << ((flags & 7) + 1);
          if (n_ - p < 3 * entries) corrupt("truncated GIF local colour table");
          if (!is_ramp(d_ + p, entries)) {
            palette_ = d_ + p;
            palette_entries_ = entries;
          }
          p += 3 * entries;
        }
        if (p >= n_) corrupt("truncated GIF image data");
        bits_ = d_[p++];
        data_ = p;
        break;
      }
      // any other byte is skipped
    }
    if (x0_ == 0 && fw_ == 0) {  // Pillow's setimage reads extents (0, y0, 0, y1) as the whole image
      fw_ = w_;
      fh_ = h_;
      y0_ = 0;
    }
    if (fw_ == 0 || fh_ == 0) refused("empty GIF frame");
    if (bits_ > kMaxBits) refused("GIF LZW minimum code size " + std::to_string(bits_));
  }

  uint64_t width() const { return w_; }
  uint64_t height() const { return h_; }

  void decode(uint8_t* out) {
    const int fill = transparency_ >= 0 ? transparency_ : 0;
    canvas_.assign(static_cast<size_t>(w_ * h_), static_cast<uint8_t>(fill));
    lzw();
    for (uint64_t i = 0; i < w_ * h_; ++i) {
      const uint8_t v = canvas_[i];
      uint8_t* o = out + 3 * i;
      if (!palette_) {
        o[0] = o[1] = o[2] = v;
      } else if (v < palette_entries_) {
        memcpy(o, palette_ + 3 * v, 3);
      } else {
        o[0] = o[1] = o[2] = 0;
      }
    }
  }

 private:
  const uint8_t* d_;
  size_t n_;
  uint64_t w_ = 0, h_ = 0, x0_ = 0, y0_ = 0, fw_ = 0, fh_ = 0;
  const uint8_t* palette_ = nullptr;
  size_t palette_entries_ = 0;
  int transparency_ = -1;
  bool interlace_ = false;
  int bits_ = 0;
  size_t data_ = 0;
  std::vector<uint8_t> canvas_;

  void check_size() const {
    if (w_ * h_ > kMaxPixels)
      refused("GIF image of " + std::to_string(w_ * h_) + " pixels, past twice PIL's MAX_IMAGE_PIXELS");
  }

  // GifImageFile.data(): a sub-block's length, or -1 at its zero length or
  // the end of the file; `p` moves past what was read (a short read at the
  // end of the file is all there is).
  long sub_block(size_t& p) const {
    if (p >= n_ || d_[p] == 0) {
      if (p < n_) ++p;
      return -1;
    }
    const size_t len = d_[p++];
    const size_t got = n_ - p < len ? n_ - p : len;
    p += got;
    return static_cast<long>(got);
  }

  size_t extension(size_t p) {
    if (p >= n_) corrupt("truncated GIF extension");
    const uint8_t label = d_[p++];
    const size_t start = p < n_ ? p + 1 : p;
    const long first = sub_block(p);
    if (label == 0xF9 && first >= 0) {  // graphic control extension
      if (first < 3) corrupt("short GIF graphic control extension");
      const uint8_t flags = d_[start];
      if (flags & 1) {
        if (first < 4) corrupt("short GIF graphic control extension");
        transparency_ = d_[start + 3];
      }
    } else if (label == 0xFE) {  // comment: read to its terminator
      for (long len = first; len > 0;) len = sub_block(p);
      return p;
    } else if (label == 0xFF && first >= 0) {  // application: NETSCAPE2.0 reads one more sub-block
      if (first >= 11 && memcmp(d_ + start, "NETSCAPE2.0", 11) == 0) sub_block(p);
    }
    while (sub_block(p) > 0) {
    }
    return p;
  }

  // Pillow's GifDecode.c over the image data, fed as ImageFile feeds it.
  void lzw() {
    const size_t total = n_ - data_;  // the bytes ImageFile's reads can bring
    size_t avail = total < kReadBlock ? total : kReadBlock;
    size_t pos = 0;  // into the image data
    uint8_t data[kTable], buffer[kTable];
    uint16_t link[kTable];
    int next = 0, codesize = 0, codemask = 0, bufferindex = kTable, lastcode = 0;
    uint8_t lastdata = 0;
    const int clear = 1 << bits_, end = clear + 1;
    int state = 1;
    uint32_t bitbuffer = 0;
    int bitcount = 0;
    int blocksize = 0;
    uint64_t x = 0, y = 0, step = interlace_ ? 8 : 1;
    int interlace = interlace_ ? 1 : 0;
    const uint8_t* src = d_ + data_;
    // the decoder returned without finishing: ImageFile reads again, and a
    // read that brings nothing is a truncated file
    auto more = [&](const char* what) {
      if (avail == total) corrupt(std::string("image file is truncated (") + what + ")");
      avail = total - avail < kReadBlock ? total : avail + kReadBlock;
    };
    auto put = [&](uint8_t v) -> bool {  // one pixel; true at the frame's end
      canvas_[static_cast<size_t>((y0_ + y) * w_ + x0_ + x)] = v;
      if (++x < fw_) return false;
      x = 0;
      y += step;
      while (y >= fh_) {
        switch (interlace) {
          case 1:
            y = 4;
            interlace = 2;
            break;
          case 2:
            step = 4;
            y = 2;
            interlace = 3;
            break;
          case 3:
            step = 2;
            y = 1;
            interlace = 0;
            break;
          default:
            return true;
        }
      }
      return false;
    };
    for (;;) {
      if (state == 1) {
        next = clear + 2;
        codesize = bits_ + 1;
        codemask = (1 << codesize) - 1;
        bufferindex = kTable;
        state = 2;
      }
      const uint8_t* p;
      int len;
      if (bufferindex < kTable) {
        len = kTable - bufferindex;
        p = buffer + bufferindex;
        bufferindex = kTable;
      } else {
        while (bitcount < codesize) {
          if (blocksize > 0) {
            bitbuffer |= static_cast<uint32_t>(src[pos++]) << bitcount;
            bitcount += 8;
            --blocksize;
          } else {  // a new sub-block, taken only when all of it is there
            if (pos >= avail || avail - pos < static_cast<size_t>(src[pos]) + 1) {
              more("data cut short");
              continue;
            }
            blocksize = src[pos++];
          }
        }
        int c = static_cast<int>(bitbuffer & static_cast<uint32_t>(codemask));
        bitbuffer >>= codesize;
        bitcount -= codesize;
        if (c == clear) {
          if (state != 2) state = 1;
          continue;
        }
        if (c == end) {
          more("end code before the frame's last pixel");
          continue;
        }
        len = 1;
        p = &lastdata;
        if (state == 2) {
          if (c > clear) refused("broken GIF data stream (first code past the clear code)");
          lastdata = static_cast<uint8_t>(c);
          lastcode = c;
          state = 3;
        } else {
          const int thiscode = c;
          if (c > next) refused("broken GIF data stream (a code past the table)");
          if (c == next) {
            if (bufferindex <= 0) refused("broken GIF data stream");
            buffer[--bufferindex] = lastdata;
            c = lastcode;
          }
          while (c >= clear) {
            if (bufferindex <= 0 || c >= kTable) refused("broken GIF data stream");
            buffer[--bufferindex] = data[c];
            c = link[c];
          }
          lastdata = static_cast<uint8_t>(c);
          if (next < kTable) {
            data[next] = static_cast<uint8_t>(c);
            link[next] = static_cast<uint16_t>(lastcode);
            if (next == codemask && codesize < kMaxBits) {
              ++codesize;
              codemask = (1 << codesize) - 1;
            }
            ++next;
          }
          lastcode = thiscode;
        }
      }
      for (int i = 0; i < len; ++i)
        if (put(p[i])) return;
    }
  }
};

}  // namespace

extern "C" {

// Decodes the first frame of `data` into `out` ((H, W, 3) uint8 RGB,
// capacity `cap` bytes). With `out` null or too small it stops after the
// blocks before the image data and returns RF_NEED_BUFFER with the size in
// dims = (H, W). Returns RF_OK, RF_CORRUPT or RF_REFUSED (with a message in
// `err`).
int rf_gif_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                  int64_t err_cap) {
  try {
    Gif gif(data, static_cast<size_t>(n));
    dims[0] = static_cast<int32_t>(gif.height());
    dims[1] = static_cast<int32_t>(gif.width());
    if (!out || cap < static_cast<int64_t>(gif.height() * gif.width() * 3)) return RF_NEED_BUFFER;
    gif.decode(out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("GIF decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
