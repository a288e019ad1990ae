// Zstandard decoding (RFC 8878) behind a plain C interface, bound with
// ctypes in `utils/image_io.py` and built with g++ by
// `ops/kernel_build.py::build_host_all`; the ZSTD compression (50000) of
// TIFF strips and tiles in `tiff.cpp` calls it through a function pointer.
//
//   * frames: the header (window descriptor, dictionary ID, content size,
//     single segment, checksum flag; the reserved bit refused), raw, RLE
//     and compressed blocks of at most min(window, 128 KiB), the content
//     size and the XXH64 content checksum checked; skippable frames skipped;
//     several frames in one buffer;
//   * literals: raw, RLE, Huffman-coded (a tree of FSE-coded or direct 4-bit
//     weights) and treeless (the frame's previous tree), in 1 or 4 streams;
//   * sequences: literal length, offset and match length codes by the
//     predefined, RLE, FSE-coded and repeat distributions, the three repeat
//     offsets.
// It checks what libzstd 1.5 checks as it decodes (every bitstream consumed
// exactly, table descriptions in range, offsets inside the frame's output,
// block and content sizes), so that damaged data fails as it fails there.
// Like libzstd without a dictionary and with its default window limit, it
// refuses a frame that names a dictionary or whose window is past 2^27 + 1
// bytes (ZSTD_WINDOWLOG_LIMIT_DEFAULT). Every read is bounded by the buffer.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <string>
#include <vector>

#include "status.h"

namespace {

constexpr size_t kBlockMax = 128 * 1024;
constexpr uint64_t kWindowLimit = (uint64_t(1) << 27) + 1;

inline uint32_t le32(const uint8_t* p) { return p[0] | (p[1] << 8) | (p[2] << 16) | (uint32_t(p[3]) << 24); }
inline uint64_t le64(const uint8_t* p) { return le32(p) | (static_cast<uint64_t>(le32(p + 4)) << 32); }
inline int highbit(uint32_t v) { return 31 - __builtin_clz(v); }

// ------------------------------------------------------------------ XXH64 ----

struct Xxh64 {
  static constexpr uint64_t P1 = 11400714785074694791ull, P2 = 14029467366897019727ull,
                            P3 = 1609587929392839161ull, P4 = 9650029242287828579ull, P5 = 2870177450012600261ull;
  static uint64_t rotl(uint64_t x, int r) { return (x << r) | (x >> (64 - r)); }
  static uint64_t round(uint64_t acc, uint64_t in) { return rotl(acc + in * P2, 31) * P1; }
  static uint64_t merge(uint64_t acc, uint64_t v) { return (acc ^ round(0, v)) * P1 + P4; }

  static uint64_t digest(const uint8_t* p, size_t n) {
    const uint8_t* end = p + n;
    uint64_t h;
    if (n >= 32) {
      uint64_t v1 = P1 + P2, v2 = P2, v3 = 0, v4 = 0 - P1;
      while (end - p >= 32) {
        v1 = round(v1, le64(p));
        v2 = round(v2, le64(p + 8));
        v3 = round(v3, le64(p + 16));
        v4 = round(v4, le64(p + 24));
        p += 32;
      }
      h = rotl(v1, 1) + rotl(v2, 7) + rotl(v3, 12) + rotl(v4, 18);
      h = merge(merge(merge(merge(h, v1), v2), v3), v4);
    } else {
      h = P5;
    }
    h += n;
    while (end - p >= 8) {
      h = rotl(h ^ round(0, le64(p)), 27) * P1 + P4;
      p += 8;
    }
    if (end - p >= 4) {
      h = rotl(h ^ (static_cast<uint64_t>(le32(p)) * P1), 23) * P2 + P3;
      p += 4;
    }
    while (p < end) h = rotl(h ^ (*p++ * P5), 11) * P1;
    h ^= h >> 33;
    h *= P2;
    h ^= h >> 29;
    h *= P3;
    h ^= h >> 32;
    return h;
  }
};

// ------------------------------------------------------------ bitstreams ----

// A backward bitstream (FSE and Huffman): read from the end of [p, p + n),
// past the top set bit of the last byte; bits before the start read as zero.
class BackBits {
 public:
  BackBits(const uint8_t* p, size_t n) : p_(p), n_(n) {
    if (n == 0) corrupt("empty ZSTD bitstream");
    if (p[n - 1] == 0) corrupt("ZSTD bitstream without its end mark");
    left_ = static_cast<int64_t>(n) * 8 - (8 - highbit(p[n - 1]));
  }
  // Over [p, p + n) from bit `left` down, without the end mark's checks (the
  // fast 4-stream decoders).
  BackBits(const uint8_t* p, size_t n, int64_t left) : p_(p), n_(n), left_(left) {}
  // `bits` (at most 32) bits below the read position, highest first, not
  // consumed. Past the start, libzstd's lookups shift its 64-bit container
  // by the bits consumed modulo 64: they wrap around to its first 8 bytes.
  uint32_t peek(int bits) const {
    if (bits == 0) return 0;
    const int64_t at = left_ > 0 ? left_ : 64 - ((-left_) & 63);
    const int64_t q = at - bits;
    const uint64_t mask = (uint64_t(1) << bits) - 1;
    if (q >= 0) return static_cast<uint32_t>((load(static_cast<size_t>(q >> 3)) >> (q & 7)) & mask);
    return static_cast<uint32_t>((load(0) << (-q)) & mask);
  }
  uint32_t read(int bits) {
    const uint32_t v = peek(bits);
    left_ -= bits;
    return v;
  }
  void skip(int bits) { left_ -= bits; }
  int64_t left() const { return left_; }  // bits not yet read; negative when read past the start

 private:
  const uint8_t* p_;
  size_t n_;
  int64_t left_;
  uint64_t load(size_t at) const {  // 8 bytes from `at`, zeros past the end
    uint64_t v = 0;
    if (at + 8 <= n_) {
      memcpy(&v, p_ + at, 8);
      return v;
    }
    for (size_t i = at; i < n_; ++i) v |= static_cast<uint64_t>(p_[i]) << (8 * (i - at));
    return v;
  }
};

// ------------------------------------------------------------------- FSE ----

struct FseCell {
  uint16_t symbol;
  uint8_t bits;
  uint16_t base;
};

struct FseTable {
  int log = 0;
  std::vector<FseCell> cells;
};

// FSE_readNCount: a table description at p (n bytes) -> its normalized
// counts; returns the bytes it takes.
size_t read_ncount(const uint8_t* p, size_t n, int max_symbol, int max_log, std::vector<int>& norm, int& log) {
  auto bit = [&](uint64_t i) -> uint32_t { return (i >> 3) < n ? (p[i >> 3] >> (i & 7)) & 1 : 0; };
  uint64_t pos = 0;
  auto read = [&](int bits) {
    uint32_t v = 0;
    for (int b = 0; b < bits; ++b) v |= bit(pos + b) << b;
    return v;
  };
  if (n == 0) corrupt("ZSTD table description cut short");
  log = static_cast<int>(read(4)) + 5;
  pos = 4;
  if (log > max_log) corrupt("ZSTD table accuracy past its limit");
  int remaining = (1 << log) + 1, threshold = 1 << log, nbits = log + 1;
  norm.assign(static_cast<size_t>(max_symbol) + 1, 0);
  int sym = 0;
  bool previous0 = false;
  for (;;) {
    if (previous0) {
      for (;;) {
        const uint32_t rep = read(2);
        pos += 2;
        sym += static_cast<int>(rep);
        if (rep != 3) break;
      }
      if (sym >= max_symbol + 1) break;
    }
    const uint32_t look = read(nbits);
    const int max = (2 * threshold - 1) - remaining;
    int count;
    if (static_cast<int>(look & (threshold - 1)) < max) {
      count = static_cast<int>(look & (threshold - 1));
      pos += static_cast<uint64_t>(nbits - 1);
    } else {
      count = static_cast<int>(look & (2 * threshold - 1));
      if (count >= threshold) count -= max;
      pos += static_cast<uint64_t>(nbits);
    }
    --count;
    remaining -= count < 0 ? -count : count;
    norm[static_cast<size_t>(sym++)] = count;
    previous0 = count == 0;
    if (remaining < threshold) {
      if (remaining <= 1) break;
      nbits = highbit(static_cast<uint32_t>(remaining)) + 1;
      threshold = 1 << (nbits - 1);
    }
    if (sym >= max_symbol + 1) break;
  }
  if (remaining != 1) corrupt("ZSTD table description does not sum up");
  if (sym > max_symbol + 1) corrupt("ZSTD table description past its last symbol");
  const size_t bytes = static_cast<size_t>((pos + 7) / 8);
  if (bytes > n) corrupt("ZSTD table description cut short");
  norm.resize(static_cast<size_t>(sym));
  return bytes;
}

// FSE_buildDTable / ZSTD_buildFSETable: cells carry the symbol, the bits to
// read and the next state's base.
FseTable build_fse(const std::vector<int>& norm, int log) {
  const int size = 1 << log;
  FseTable t;
  t.log = log;
  t.cells.assign(static_cast<size_t>(size), FseCell{0, 0, 0});
  std::vector<int> next(norm.size());
  int high = size - 1;
  for (size_t s = 0; s < norm.size(); ++s) {
    if (norm[s] == -1) {
      t.cells[static_cast<size_t>(high--)].symbol = static_cast<uint16_t>(s);
      next[s] = 1;
    } else {
      next[s] = norm[s];
    }
  }
  const int step = (size >> 1) + (size >> 3) + 3, mask = size - 1;
  int pos = 0;
  for (size_t s = 0; s < norm.size(); ++s)
    for (int i = 0; i < norm[s]; ++i) {
      t.cells[static_cast<size_t>(pos)].symbol = static_cast<uint16_t>(s);
      do pos = (pos + step) & mask; while (pos > high);
    }
  if (pos != 0) corrupt("bad ZSTD table distribution");
  for (int i = 0; i < size; ++i) {
    FseCell& c = t.cells[static_cast<size_t>(i)];
    const int ns = next[c.symbol]++;
    c.bits = static_cast<uint8_t>(log - highbit(static_cast<uint32_t>(ns)));
    c.base = static_cast<uint16_t>((ns << c.bits) - size);
  }
  return t;
}

FseTable rle_fse(int symbol) {
  FseTable t;
  t.log = 0;
  t.cells.assign(1, FseCell{static_cast<uint16_t>(symbol), 0, 0});
  return t;
}

struct FseState {
  const FseTable* t = nullptr;
  uint32_t state = 0;
  void init(const FseTable& table, BackBits& b) {
    t = &table;
    state = b.read(table.log);
  }
  int symbol() const { return t->cells[state].symbol; }
  void update(BackBits& b) {
    const FseCell& c = t->cells[state];
    state = c.base + b.read(c.bits);
  }
};

// --------------------------------------------------------------- Huffman ----

struct HufTable {
  int log = 0;
  std::vector<uint8_t> symbol, bits;  // by the top `log` bits of the stream
  // HUF_readDTableX2: decoded two symbols a lookup of `target` bits (11, or
  // 12 for a 12-bit tree) where the second code fits; 0: HUF_readDTableX1
  int target = 0;
};

// HUF_selectDecoder: libzstd decodes 4-stream literals with a new tree by the
// double-symbol table (X2) when its cost model, by literals and their
// compressed size, favours it.
bool select_x2(size_t dst, size_t csrc) {
  static const uint32_t kTime[16][2][2] = {
      {{0, 0}, {1, 1}},         {{0, 0}, {1, 1}},         {{150, 216}, {381, 119}},  {{170, 205}, {514, 112}},
      {{177, 199}, {539, 110}}, {{197, 194}, {644, 107}}, {{221, 192}, {735, 107}},  {{256, 189}, {881, 106}},
      {{359, 188}, {1167, 109}}, {{582, 187}, {1570, 114}}, {{688, 187}, {1712, 122}}, {{825, 186}, {1965, 136}},
      {{976, 185}, {2131, 150}}, {{1180, 186}, {2070, 175}}, {{1377, 185}, {1731, 202}}, {{1412, 185}, {1695, 202}}};
  const uint32_t q = csrc >= dst ? 15 : static_cast<uint32_t>(csrc * 16 / dst);
  const uint32_t d256 = static_cast<uint32_t>(dst >> 8);
  const uint32_t t0 = kTime[q][0][0] + kTime[q][0][1] * d256;
  uint32_t t1 = kTime[q][1][0] + kTime[q][1][1] * d256;
  t1 += t1 >> 5;
  return t1 < t0;
}

// HUF_readStats + HUF_readDTableX1: the tree description at p (n bytes
// left in the literals) -> the table; returns the bytes it takes.
size_t read_huffman(const uint8_t* p, size_t n, HufTable& t) {
  if (n == 0) corrupt("ZSTD Huffman tree cut short");
  std::vector<uint8_t> w;
  const int head = p[0];
  size_t used;
  if (head >= 128) {  // direct: 4 bits a weight
    const int count = head - 127;
    used = 1 + static_cast<size_t>((count + 1) / 2);
    if (used > n) corrupt("ZSTD Huffman tree cut short");
    for (int i = 0; i < count; ++i) w.push_back(static_cast<uint8_t>(i & 1 ? p[1 + i / 2] & 15 : p[1 + i / 2] >> 4));
  } else {  // FSE-coded, two interleaved states
    used = 1 + static_cast<size_t>(head);
    if (used > n) corrupt("ZSTD Huffman tree cut short");
    std::vector<int> norm;
    int log;
    const size_t hdr = read_ncount(p + 1, static_cast<size_t>(head), 255, 6, norm, log);
    const FseTable ft = build_fse(norm, log);
    BackBits b(p + 1 + hdr, static_cast<size_t>(head) - hdr);
    FseState s1, s2;
    s1.init(ft, b);
    s2.init(ft, b);
    for (;;) {
      if (w.size() > 253) corrupt("ZSTD Huffman tree of too many weights");
      w.push_back(static_cast<uint8_t>(s1.symbol()));
      s1.update(b);
      if (b.left() < 0) {
        w.push_back(static_cast<uint8_t>(s2.symbol()));
        break;
      }
      if (w.size() > 253) corrupt("ZSTD Huffman tree of too many weights");
      w.push_back(static_cast<uint8_t>(s2.symbol()));
      s2.update(b);
      if (b.left() < 0) {
        w.push_back(static_cast<uint8_t>(s1.symbol()));
        break;
      }
    }
  }
  uint32_t total = 0;
  int rank1 = 0;
  for (uint8_t x : w) {
    if (x > 12) corrupt("ZSTD Huffman weight past 12");
    total += (1u << x) >> 1;
  }
  if (total == 0) corrupt("ZSTD Huffman tree of no weights");
  const int log = highbit(total) + 1;
  if (log > 12) corrupt("ZSTD Huffman tree deeper than 12 bits");
  const uint32_t rest = (1u << log) - total;
  if (rest != (1u << highbit(rest))) corrupt("ZSTD Huffman tree that is not complete");
  w.push_back(static_cast<uint8_t>(highbit(rest) + 1));
  for (uint8_t x : w) rank1 += x == 1;
  if (rank1 < 2 || (rank1 & 1)) corrupt("ZSTD Huffman tree with an odd count of weight 1");
  // codes: longest first, by symbol within a length
  t.log = log;
  t.target = 0;
  t.symbol.assign(size_t(1) << log, 0);
  t.bits.assign(size_t(1) << log, 0);
  int rank_count[14] = {0};
  for (uint8_t x : w)
    if (x) ++rank_count[log + 1 - x];
  uint32_t start[14] = {0};
  uint32_t at = 0;
  for (int b = log; b >= 1; --b) {
    start[b] = at;
    at += static_cast<uint32_t>(rank_count[b]) << (log - b);
  }
  for (size_t s = 0; s < w.size(); ++s) {
    if (!w[s]) continue;
    const int b = log + 1 - w[s];
    const uint32_t len = 1u << (log - b);
    for (uint32_t i = 0; i < len; ++i) {
      t.symbol[start[b] + i] = static_cast<uint8_t>(s);
      t.bits[start[b] + i] = static_cast<uint8_t>(b);
    }
    start[b] += len;
  }
  return used;
}

// One lookup of the X2 table: its `target`-bit window read once, the first
// code from its top, the second (l2 > 0) when it fits in the rest.
struct HufPair {
  uint8_t s1, s2;
  int l1, l2;
};

HufPair pair(const HufTable& t, const BackBits& b) {
  const uint32_t w = b.peek(t.target), wmask = (1u << t.target) - 1;
  const uint32_t v1 = w >> (t.target - t.log);
  HufPair e{t.symbol[v1], 0, t.bits[v1], 0};
  const uint32_t v2 = ((w << e.l1) & wmask) >> (t.target - t.log);
  if (t.bits[v2] <= t.target - e.l1) {
    e.s2 = t.symbol[v2];
    e.l2 = t.bits[v2];
  }
  return e;
}

// HUF_decompress1X: `count` symbols from one stream, which must be consumed
// exactly. The X2 table decodes one or two symbols a lookup; its last
// symbol, alone in the output, skips the bits of the pair its lookup holds,
// clamped at the stream's start (HUF_decodeLastSymbolX2), and when the
// stream was consumed before it, the lookup wraps around libzstd's 64-bit
// container and reads the stream's first 8 bytes.
void huffman_stream(const HufTable& t, const uint8_t* p, size_t n, uint8_t* out, size_t count) {
  BackBits b(p, n);
  if (!t.target) {
    for (size_t i = 0; i < count; ++i) {
      const uint32_t v = b.peek(t.log);
      out[i] = t.symbol[v];
      b.skip(t.bits[v]);
    }
  } else {
    size_t i = 0;
    while (i + 2 <= count) {
      const HufPair e = pair(t, b);
      out[i++] = e.s1;
      if (e.l2) out[i++] = e.s2;
      b.skip(e.l1 + e.l2);
    }
    if (i < count) {
      const int64_t left = b.left();
      const HufPair e = pair(t, b);
      out[i] = e.s1;
      if (!e.l2)
        b.skip(e.l1);
      else if (left > 0)
        b.skip(static_cast<int>(std::min<int64_t>(e.l1 + e.l2, left)));
    }
  }
  if (b.left() != 0) corrupt("ZSTD Huffman stream not consumed exactly");
}

// HUF_decompress4X: four streams of (n + 3) / 4 symbols (the last the rest)
// after a jump table of their sizes. libzstd's fast loops take a tree of at
// most 11 bits when every stream holds 8 bytes and the last one a symbol
// (HUF_DecompressFastArgs_init): 5 lookups a stream between reloads, in
// rounds bounded by the first stream's input and each stream's output, left
// when a stream's input pointer crosses the one before. They read each
// stream on into the bytes before it, check neither its end mark nor its
// exact consumption, and fail only when a stream's input pointer ended more
// than 8 bytes before its start (HUF_initRemainingDStream).
void huffman_four(const HufTable& t, const uint8_t* lp, size_t ln, uint8_t* out, size_t lsize) {
  if (ln < 10) corrupt("ZSTD 4-stream literals cut short");
  const size_t len[3] = {static_cast<size_t>(lp[0] | (lp[1] << 8)), static_cast<size_t>(lp[2] | (lp[3] << 8)),
                         static_cast<size_t>(lp[4] | (lp[5] << 8))};
  if (len[0] + len[1] + len[2] > ln - 6) corrupt("ZSTD 4-stream jump table past the literals");
  const size_t l4 = ln - 6 - len[0] - len[1] - len[2];
  const size_t seg = (lsize + 3) / 4;
  const size_t start[4] = {6, 6 + len[0], 6 + len[0] + len[1], 6 + len[0] + len[1] + len[2]};
  const size_t size[4] = {len[0], len[1], len[2], l4};
  size_t end[4];
  for (int s = 0; s < 4; ++s) end[s] = std::min(seg * (s + 1), lsize);
  const bool fast = t.log <= 11 && size[0] >= 8 && size[1] >= 8 && size[2] >= 8 && size[3] >= 8 && 3 * seg < lsize;
  if (!fast) {
    for (int s = 0; s < 4; ++s) huffman_stream(t, lp + start[s], size[s], out + seg * s, end[s] - seg * s);
    return;
  }
  std::vector<BackBits> b;
  int64_t ip[4];
  size_t op[4];
  for (int s = 0; s < 4; ++s) {
    const size_t e = start[s] + size[s];
    const uint8_t last = lp[e - 1];
    b.emplace_back(lp, ln, static_cast<int64_t>(8 * e) - (last ? 8 - highbit(last) : 0));
    ip[s] = static_cast<int64_t>(e) - 8;
    op[s] = seg * s;
  }
  auto lookup = [&](int s) {  // one table lookup: one symbol, or two where the second fits
    BackBits& r = b[static_cast<size_t>(s)];
    if (t.target) {
      const HufPair e = pair(t, r);
      out[op[s]++] = e.s1;
      if (e.l2) out[op[s]++] = e.s2;
      r.skip(e.l1 + e.l2);
    } else {
      const uint32_t v = r.peek(t.log);
      out[op[s]++] = t.symbol[v];
      r.skip(t.bits[v]);
    }
  };
  for (;;) {
    size_t iters = static_cast<size_t>(ip[0]) / 7;
    if (!t.target) {
      iters = std::min(iters, (lsize - op[3]) / 5);
    } else {
      for (int s = 0; s < 4; ++s) iters = std::min(iters, (end[s] - op[s]) / 10);
    }
    if (iters == 0) break;
    if (ip[1] < ip[0] || ip[2] < ip[1] || ip[3] < ip[2]) break;
    const size_t olimit = op[3] + iters * 5;
    do {
      for (int k = 0; k < 5; ++k)
        for (int s = 0; s < 4; ++s) lookup(s);
      for (int s = 0; s < 4; ++s) ip[s] -= (8 * ip[s] + 64 - b[static_cast<size_t>(s)].left()) >> 3;
    } while (op[3] < olimit);
  }
  for (int s = 0; s < 4; ++s) {
    if (op[s] > end[s] || ip[s] < static_cast<int64_t>(start[s]) - 8) corrupt("ZSTD 4-stream literals overrun");
    BackBits& r = b[static_cast<size_t>(s)];
    while (op[s] + (t.target ? 2 : 1) <= end[s]) lookup(s);
    if (op[s] < end[s]) out[op[s]++] = t.target ? pair(t, r).s1 : t.symbol[r.peek(t.log)];
  }
}

// ------------------------------------------------------------- sequences ----

const int kLLBase[36] = {0,  1,  2,   3,   4,   5,   6,   7,    8,    9,     10,    11,
                         12, 13, 14,  15,  16,  18,  20,  22,   24,   28,    32,    40,
                         48, 64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384, 32768, 65536};
const int kLLBits[36] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1,  1,  1,  1,  2,  2,  3,  3,
                         4, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const int kMLBase[53] = {3,  4,  5,  6,  7,  8,  9,  10, 11, 12,  13,  14,  15,  16,   17,   18,   19,   20,
                         21, 22, 23, 24, 25, 26, 27, 28, 29, 30,  31,  32,  33,  34,   35,   37,   39,   41,
                         43, 47, 51, 59, 67, 83, 99, 131, 259, 515, 1027, 2051, 4099, 8195, 16387, 32771, 65539};
const int kMLBits[53] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                         0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16};
const std::vector<int> kLLDefault = {4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2,
                                     2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1};
const std::vector<int> kMLDefault = {1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1};
const std::vector<int> kOFDefault = {1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1,
                                     1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1};

// ----------------------------------------------------------------- frames ----

class Decoder {
 public:
  Decoder(const uint8_t* src, size_t n) : d_(src), n_(n) {}

  // Every frame of the buffer (ZSTD_decompress): content appended to `out`.
  void all(std::vector<uint8_t>& out) {
    while (pos_ < n_) frame(out, SIZE_MAX);
  }

  // The first frame as libtiff's ZSTDDecode streams it into `occ` bytes: a
  // frame whose content size is known, fits and is whole decodes at once;
  // another decodes block by block until the output is full (the block after
  // an exact fill is still read). False when an error comes first or the
  // output stays short.
  bool tiff(std::vector<uint8_t>& out, size_t occ) {
    try {
      frame(out, occ);
    } catch (const Fail& f) {
      if (!f.short_input) return false;
    }
    return out.size() >= occ;
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_ = 0;
  HufTable huf_;
  bool have_huf_ = false;
  FseTable ll_, of_, ml_;
  bool have_ll_ = false, have_of_ = false, have_ml_ = false;
  uint64_t rep_[3] = {1, 4, 8};

  const uint8_t* need(size_t k) {
    if (n_ - pos_ < k) throw Fail{RF_CORRUPT, "ZSTD data cut short", true};
    const uint8_t* p = d_ + pos_;
    pos_ += k;
    return p;
  }

  void frame(std::vector<uint8_t>& out, size_t fill) {
    const uint32_t magic = le32(need(4));
    if ((magic & 0xFFFFFFF0u) == 0x184D2A50u) {  // skippable
      const uint32_t size = le32(need(4));
      need(size);
      return;
    }
    if (magic != 0xFD2FB528u) corrupt("not a ZSTD frame (unknown magic)");
    const uint8_t fhd = *need(1);
    const int fcs_flag = fhd >> 6, did_flag = fhd & 3;
    const bool single = fhd & 0x20, checksum = fhd & 4;
    if (fhd & 8) corrupt("ZSTD frame header with its reserved bit set");
    uint64_t window = 0;
    if (!single) {
      const uint8_t wd = *need(1);
      const int wlog = 10 + (wd >> 3);
      if (wlog > 31) corrupt("ZSTD window past 2^31");
      const uint64_t base = uint64_t(1) << wlog;
      window = base + (base / 8) * (wd & 7);
    }
    static const int kDid[4] = {0, 1, 2, 4};
    uint64_t dict = 0;
    const uint8_t* dp = need(static_cast<size_t>(kDid[did_flag]));
    for (int i = 0; i < kDid[did_flag]; ++i) dict |= static_cast<uint64_t>(dp[i]) << (8 * i);
    static const int kFcs[4] = {0, 2, 4, 8};
    const int fcs_bytes = fcs_flag == 0 ? (single ? 1 : 0) : kFcs[fcs_flag];
    uint64_t content = UINT64_MAX;
    if (fcs_bytes) {
      const uint8_t* fp = need(static_cast<size_t>(fcs_bytes));
      content = 0;
      for (int i = 0; i < fcs_bytes; ++i) content |= static_cast<uint64_t>(fp[i]) << (8 * i);
      if (fcs_bytes == 2) content += 256;
    }
    if (single) window = content;
    if (dict) corrupt("ZSTD frame that needs a dictionary, which is refused as libzstd refuses it without one");
    if (window > kWindowLimit) corrupt("ZSTD frame window past 2^27 + 1 bytes, which libzstd refuses by default");
    const size_t block_max = static_cast<size_t>(window < kBlockMax ? window : kBlockMax);
    // per frame: no tables, the first repeat offsets
    have_huf_ = have_ll_ = have_of_ = have_ml_ = false;
    rep_[0] = 1;
    rep_[1] = 4;
    rep_[2] = 8;
    const size_t start = out.size();
    // tiff(): ZSTD_decompressStream's single-pass shortcut
    const bool whole = fill != SIZE_MAX && content != UINT64_MAX && content <= fill && frame_fits(checksum);
    for (;;) {
      const uint8_t* bh = need(3);
      const uint32_t h = bh[0] | (bh[1] << 8) | (bh[2] << 16);
      const bool last = h & 1;
      const int type = (h >> 1) & 3;
      const size_t size = h >> 3;
      if (type == 3) corrupt("ZSTD block of the reserved type");
      if ((type == 1 ? 1 : size) > block_max) corrupt("ZSTD block past the block size limit");
      const size_t before = out.size();
      if (type == 0) {
        const uint8_t* p = need(size);
        out.insert(out.end(), p, p + size);
      } else if (type == 1) {
        const uint8_t v = *need(1);
        out.insert(out.end(), size, v);
      } else {
        const uint8_t* p = need(size);
        compressed_block(p, size, out, start, block_max);
      }
      if (out.size() - before > block_max) corrupt("ZSTD block decoded past the block size limit");
      // tiff(): a flush that cannot complete stops the stream (after an
      // exact fill the next block is still decoded)
      if (fill != SIZE_MAX && !whole && out.size() - start > fill) return;
      if (last) break;
    }
    if (content != UINT64_MAX && out.size() - start != content) corrupt("ZSTD frame content size mismatch");
    if (checksum) {
      const uint32_t want = le32(need(4));
      if (static_cast<uint32_t>(Xxh64::digest(out.data() + start, out.size() - start)) != want)
        corrupt("ZSTD content checksum mismatch");
    }
  }

  // ZSTD_findFrameCompressedSize: whether the rest of the frame (blocks and
  // checksum) lies in the buffer.
  bool frame_fits(bool checksum) const {
    size_t p = pos_;
    for (;;) {
      if (n_ - p < 3) return false;
      const uint32_t h = d_[p] | (d_[p + 1] << 8) | (d_[p + 2] << 16);
      const int type = (h >> 1) & 3;
      const size_t size = type == 1 ? 1 : (h >> 3);
      if (type == 3) return false;
      p += 3;
      if (n_ - p < size) return false;
      p += size;
      if (h & 1) break;
    }
    return !checksum || n_ - p >= 4;
  }

  void compressed_block(const uint8_t* p, size_t n, std::vector<uint8_t>& out, size_t start, size_t block_max) {
    if (n < 3) corrupt("ZSTD compressed block too small");
    // literals
    std::vector<uint8_t> lit;
    const int ltype = p[0] & 3, sf = (p[0] >> 2) & 3;
    size_t at;
    if (ltype <= 1) {
      size_t lsize;
      if (sf == 0 || sf == 2) {
        lsize = p[0] >> 3;
        at = 1;
      } else if (sf == 1) {
        lsize = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4);
        at = 2;
      } else {
        lsize = (p[0] >> 4) + (static_cast<size_t>(p[1]) << 4) + (static_cast<size_t>(p[2]) << 12);
        at = 3;
      }
      if (lsize > block_max) corrupt("ZSTD literals past the block size limit");
      if (ltype == 0) {
        if (at + lsize > n) corrupt("ZSTD raw literals cut short");
        lit.assign(p + at, p + at + lsize);
        at += lsize;
      } else {
        if (at + 1 > n) corrupt("ZSTD RLE literals cut short");
        lit.assign(lsize, p[at]);
        at += 1;
      }
    } else {
      if (n < 5) corrupt("ZSTD compressed literals header cut short");
      size_t lsize, csize;
      bool four = sf != 0;
      if (sf <= 1) {
        const uint32_t v = p[0] | (p[1] << 8) | (p[2] << 16);
        lsize = (v >> 4) & 0x3FF;
        csize = (v >> 14) & 0x3FF;
        at = 3;
      } else if (sf == 2) {
        const uint32_t v = le32(p);
        lsize = (v >> 4) & 0x3FFF;
        csize = v >> 18;
        at = 4;
      } else {
        const uint32_t v = le32(p);
        lsize = (v >> 4) & 0x3FFFF;
        csize = (v >> 22) + (static_cast<size_t>(p[4]) << 10);
        at = 5;
      }
      if (lsize > block_max) corrupt("ZSTD literals past the block size limit");
      if (at + csize > n) corrupt("ZSTD compressed literals cut short");
      if (four && lsize < 6) corrupt("ZSTD literals too few for 4 streams");
      const uint8_t* lp = p + at;
      size_t ln = csize;
      if (ltype == 2) {
        const size_t tree = read_huffman(lp, ln, huf_);
        if (four && select_x2(lsize, csize)) huf_.target = huf_.log <= 11 ? 11 : 12;
        have_huf_ = true;
        lp += tree;
        ln -= tree;
      } else if (!have_huf_) {
        corrupt("ZSTD treeless literals before any Huffman tree");
      }
      lit.resize(lsize);
      if (!four)
        huffman_stream(huf_, lp, ln, lit.data(), lsize);
      else
        huffman_four(huf_, lp, ln, lit.data(), lsize);
      at += csize;
    }
    // sequences
    if (at >= n) corrupt("ZSTD sequences section missing");
    size_t nseq = p[at++];
    if (nseq >= 128) {
      if (nseq < 255) {
        if (at >= n) corrupt("ZSTD sequence count cut short");
        nseq = ((nseq - 128) << 8) + p[at++];
      } else {
        if (at + 2 > n) corrupt("ZSTD sequence count cut short");
        nseq = p[at] + (static_cast<size_t>(p[at + 1]) << 8) + 0x7F00;
        at += 2;
      }
    }
    const size_t out0 = out.size();
    if (nseq == 0) {
      if (at != n) corrupt("ZSTD block with data after no sequences");
      out.insert(out.end(), lit.begin(), lit.end());
      return;
    }
    if (at >= n) corrupt("ZSTD sequence modes cut short");
    const uint8_t modes = p[at++];
    if (modes & 3) corrupt("ZSTD sequence modes with reserved bits set");
    auto table = [&](int mode, FseTable& t, bool& have, int max_symbol, int max_log, const std::vector<int>& dflt,
                     int dflt_log) {
      switch (mode) {
        case 0:
          t = build_fse(dflt, dflt_log);
          break;
        case 1:
          if (at >= n) corrupt("ZSTD RLE sequence table cut short");
          if (p[at] > max_symbol) corrupt("ZSTD RLE sequence code out of range");
          t = rle_fse(p[at++]);
          break;
        case 2: {
          std::vector<int> norm;
          int log;
          at += read_ncount(p + at, n - at, max_symbol, max_log, norm, log);
          t = build_fse(norm, log);
          break;
        }
        default:
          if (!have) corrupt("ZSTD repeated sequence table before any");
      }
      have = true;
    };
    table(modes >> 6, ll_, have_ll_, 35, 9, kLLDefault, 6);
    table((modes >> 4) & 3, of_, have_of_, 31, 8, kOFDefault, 5);
    table((modes >> 2) & 3, ml_, have_ml_, 52, 9, kMLDefault, 6);
    BackBits b(p + at, n - at);
    FseState sll, sof, sml;
    sll.init(ll_, b);
    sof.init(of_, b);
    sml.init(ml_, b);
    size_t lp = 0;
    for (size_t i = 0; i < nseq; ++i) {
      const int llc = sll.symbol(), ofc = sof.symbol(), mlc = sml.symbol();
      uint64_t offset;
      const uint64_t ofv = (uint64_t(1) << ofc) + b.read(ofc);
      const size_t ml = static_cast<size_t>(kMLBase[mlc]) + b.read(kMLBits[mlc]);
      const size_t ll = static_cast<size_t>(kLLBase[llc]) + b.read(kLLBits[llc]);
      if (ofv > 3) {
        offset = ofv - 3;
        rep_[2] = rep_[1];
        rep_[1] = rep_[0];
        rep_[0] = offset;
      } else {
        const uint64_t idx = ofv - 1 + (ll == 0 ? 1 : 0);  // 0..3
        if (idx == 0) {
          offset = rep_[0];
        } else {
          offset = idx == 3 ? rep_[0] - 1 : rep_[idx];
          if (offset == 0) corrupt("ZSTD repeat offset of 0");
          if (idx != 1) rep_[2] = rep_[1];
          rep_[1] = rep_[0];
          rep_[0] = offset;
        }
      }
      if (i + 1 < nseq) {
        sll.update(b);
        sml.update(b);
        sof.update(b);
      }
      if (ll > lit.size() - lp) corrupt("ZSTD sequence past its literals");
      out.insert(out.end(), lit.begin() + static_cast<ptrdiff_t>(lp), lit.begin() + static_cast<ptrdiff_t>(lp + ll));
      lp += ll;
      if (offset > out.size() - start) corrupt("ZSTD match offset before the frame's start");
      if (out.size() - out0 + ml > block_max) corrupt("ZSTD block decoded past the block size limit");
      size_t from = out.size() - static_cast<size_t>(offset);
      for (size_t k = 0; k < ml; ++k) out.push_back(out[from + k]);
    }
    if (b.left() != 0) corrupt("ZSTD sequence bitstream not consumed exactly");
    out.insert(out.end(), lit.begin() + static_cast<ptrdiff_t>(lp), lit.end());
  }
};

}  // namespace

extern "C" {

// Every frame of src[0..n) -> a malloc'd buffer of *out_n bytes (free it with
// rf_zstd_free; null with *out_n 0 for an empty result). Returns RF_OK, or
// RF_CORRUPT with a message in `err`.
int rf_zstd_decompress(const uint8_t* src, int64_t n, uint8_t** out, int64_t* out_n, char* err, int64_t err_cap) {
  *out = nullptr;
  *out_n = 0;
  try {
    std::vector<uint8_t> buf;
    Decoder(src, static_cast<size_t>(n)).all(buf);
    if (!buf.empty()) {
      *out = static_cast<uint8_t*>(malloc(buf.size()));
      if (!*out) corrupt("out of memory");
      memcpy(*out, buf.data(), buf.size());
      *out_n = static_cast<int64_t>(buf.size());
    }
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return RF_CORRUPT;
  } catch (const std::exception& e) {
    write_err(std::string("ZSTD decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

void rf_zstd_free(uint8_t* p) { free(p); }

// One TIFF strip or tile as libtiff 4.7's ZSTDDecode decodes it into `occ`
// bytes at dst: 1 when it fills them, else 0 (what was decoded stays, the
// rest zeroed).
int rf_zstd_tiff_decode(const uint8_t* src, int64_t n, uint8_t* dst, int64_t occ) {
  try {
    std::vector<uint8_t> buf;
    Decoder dec(src, static_cast<size_t>(n));
    const bool ok = dec.tiff(buf, static_cast<size_t>(occ));
    const size_t k = buf.size() < static_cast<size_t>(occ) ? buf.size() : static_cast<size_t>(occ);
    if (k) memcpy(dst, buf.data(), k);
    memset(dst + k, 0, static_cast<size_t>(occ) - k);
    return ok ? 1 : 0;
  } catch (const std::exception&) {
    memset(dst, 0, static_cast<size_t>(occ));
    return 0;
  }
}

}  // extern "C"
