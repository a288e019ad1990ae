// JPEG 2000 decoding, as Pillow 12.1 reads a JP2 file or a raw J2K
// codestream through OpenJPEG 2.5.4 and `convert("RGB")` converts it,
// behind a plain C interface bound with ctypes in `utils/image_io.py` and
// built with g++ by `ops/kernel_build.py::build_host_all`:
//
//   * the JP2 boxes as Pillow's Jpeg2KImagePlugin reads them for the size and
//     mode (ihdr, colr, pclr; a palette as `ImagePalette.getcolor` builds it,
//     duplicates merged) and as OpenJPEG's jp2.c checks them (signature,
//     ftyp, jp2h with ihdr, colr, bpcc, pclr, cmap and cdef, then jp2c).
//     Pillow decodes tile by tile (opj_read_tile_header / opj_decode_tile_data),
//     where OpenJPEG applies no palette, channel definition or colour
//     conversion: the palette is Pillow's own, after decoding;
//   * the codestream as j2k.c reads it: the main header (SIZ, COD, COC, QCD,
//     QCC, RGN, POC, PPM, TLM, PLM, CRG, COM, unknown markers skipped two
//     bytes at a time), tile-part headers (SOT, COD, COC, QCD, QCC, RGN, POC,
//     PPT, PLT, COM), tile-parts and tiles in the order j2k.c decodes them,
//     its strict checks of lengths and of where the stream ends;
//   * packets as t2.c and pi.c read them: the five progression orders and POC
//     changes (pi.c's iterators, include table and all), precincts, tag trees,
//     SOP and EPH, headers packed in PPM or PPT, every code-block style's
//     segments; a segment reaching past the tile's data fails, as in strict
//     mode (Pillow's);
//   * code-blocks as t1.c and mqc.c decode them: the MQ decoder with the two
//     0xFF bytes OpenJPEG puts after each segment, the raw (bypass) decoder,
//     the three passes with their contexts, every code-block style (bypass,
//     reset, terminate each pass, vertically causal, predictable termination,
//     segmentation symbols), coefficients kept with OpenJPEG's extra half bit,
//     ROI shift-down; then the reversible `v / 2` or the irreversible fp32
//     `v * (0.5f * stepsize)`, the step size from tcd.c (`log2_gain` 0 for
//     every irreversible band, which its 9/7 inverse compensates with
//     two_invK = 1.625732422);
//   * the inverse DWT of dwt.c: 5/3 in integers (a lone odd sample halved by
//     C division), 9/7 in fp32 in its lifting order (scale, then delta,
//     gamma, beta, alpha, each `a + (b + c) * k` and at the edge
//     `a + b * (k + k)`), horizontal then vertical at each level, the parity
//     of each level's origin; the inverse RCT and the fp32 ICT (1.402f,
//     0.34413f, 0.71414f, 1.772f), the DC level shift (lrintf on the fp32
//     path) and the clamp to the component's precision;
//   * Pillow's Jpeg2KDecode.c unpackers, tile by tile, by (mode, colour space,
//     components, sub-sampling) -- its own plane sizes `(w / dx) * (h / dy)`
//     and sample `x / dx` for sub-sampled components, its shift and rounding
//     offset for precisions other than 8 and signed components, its sYCC
//     through ImagingConvertYCbCr2RGB -- then `convert("RGB")` from L, LA,
//     I;16, RGB, RGBA, CMYK, P or PA.
//
// The fp32 arithmetic is written as OpenJPEG's scalar code writes it (its SSE
// routines compute each element by the same formula). The host flags have no
// -march, so g++ cannot contract a multiply and an add into an FMA on
// baseline x86-64; keep it so.
//
// What Pillow or OpenJPEG refuses (no unpacker for the mode, HT mixed
// code-blocks, more than 4 components, more than twice PIL's
// MAX_IMAGE_PIXELS) returns RF_REFUSED ", as PIL refuses it"; corrupt
// or truncated data returns RF_CORRUPT; a JPEG 2000 feature that no fixture
// covers (HTJ2K code-blocks, the CAP / CPF markers, Part 2 multi-component
// transforms, CIELab colour) returns RF_REFUSED citing ROADMAP queue 1 entry
// 8b. Every read is bounded by the buffer.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <exception>
#include <map>
#include <string>
#include <vector>

#include "codec_common.h"
#include "status.h"

namespace {

constexpr uint64_t kMaxPixels = 2ull * (1024ull * 1024 * 1024 / 4 / 3);  // 2 x PIL's MAX_IMAGE_PIXELS

[[noreturn]] void queued(const std::string& what) {
  throw Fail{RF_REFUSED, what + " is not read by the port yet (ROADMAP queue 1 entry 8b)"};
}

inline uint32_t be16(const uint8_t* p) { return (uint32_t(p[0]) << 8) | p[1]; }
inline uint32_t be32(const uint8_t* p) { return (be16(p) << 16) | be16(p + 2); }

inline int32_t ceildiv(int64_t a, int64_t b) { return static_cast<int32_t>((a + b - 1) / b); }
inline int32_t ceildivpow2(int32_t a, uint32_t b) {
  return static_cast<int32_t>((int64_t(a) + (int64_t(1) << b) - 1) >> b);
}
inline int32_t floordivpow2(int32_t a, uint32_t b) { return a >> b; }
inline uint32_t uceildiv(uint32_t a, uint32_t b) { return b ? static_cast<uint32_t>((uint64_t(a) + b - 1) / b) : 0; }

// OPJ_PROG_ORDER; -1 is OPJ_PROG_UNKNOWN
enum Prog { LRCP = 0, RLCP = 1, RPCL = 2, PCRL = 3, CPRL = 4 };

// ------------------------------------------------------------ JP2 boxes ----

// OPJ_COLOR_SPACE as Pillow sees it
enum ColorSpace {
  CS_UNKNOWN = -1, CS_UNSPECIFIED = 0, CS_SRGB = 1, CS_GRAY = 2, CS_SYCC = 3, CS_EYCC = 4, CS_CMYK = 5
};

// Pillow's modes of a JPEG 2000 image
enum Mode { M_L, M_I16, M_LA, M_RGB, M_RGBA, M_CMYK, M_P, M_PA };

struct Header {
  bool jp2 = false;
  size_t cs_start = 0;  // where the codestream begins
  Mode mode = M_L;
  int width = 0, height = 0;
  ColorSpace color_space = CS_UNSPECIFIED;
  uint32_t ihdr_w = 0, ihdr_h = 0;
  std::vector<uint8_t> palette;  // RGB triples in Pillow's order (P, PA)
};

// The palette Pillow builds from the pclr entries: `ImagePalette.getcolor`
// of each ("RGBA" with 4 columns, else "RGB"; n = len(mode)), which skips a
// colour seen before and writes a new one over the n bytes at index
// len(palette) // n, then the bytes read back as n-byte entries. Returns the
// RGB of each palette index.
std::vector<uint8_t> pillow_palette(const std::vector<std::vector<uint32_t>>& entries, int npc) {
  const size_t n = npc == 4 ? 4 : 3;
  std::vector<std::vector<uint32_t>> seen;
  std::vector<uint8_t> pal;
  for (const auto& c : entries) {
    if (std::find(seen.begin(), seen.end(), c) != seen.end()) continue;
    seen.push_back(c);
    size_t index = pal.size() / n;
    if (index >= 256) refused("a JPEG 2000 palette of more than 256 colours");
    if (index * n < pal.size()) {
      std::vector<uint8_t> next(pal.begin(), pal.begin() + index * n);
      next.insert(next.end(), c.begin(), c.end());
      if (index * n + n < pal.size()) next.insert(next.end(), pal.begin() + index * n + n, pal.end());
      pal.swap(next);
    } else {
      pal.insert(pal.end(), c.begin(), c.end());
    }
  }
  std::vector<uint8_t> rgb(256 * 3, 0);
  for (size_t i = 0; i < 256 && (i + 1) * n <= pal.size(); ++i)
    for (size_t k = 0; k < 3; ++k) rgb[3 * i + k] = pal[n * i + k];
  return rgb;
}

// Pillow's BoxReader over [pos, end): the next box's type and its payload.
struct PilBoxes {
  const uint8_t* d;
  size_t pos, end;
  bool next(uint32_t* type, size_t* body, size_t* body_end) {
    if (pos >= end) return false;
    if (end - pos < 8) corrupt("Not enough data in header");
    uint64_t lbox = be32(d + pos);
    *type = be32(d + pos + 4);
    size_t hlen = 8;
    if (lbox == 1) {
      if (end - pos < 16) corrupt("Not enough data in header");
      lbox = (uint64_t(be32(d + pos + 8)) << 32) | be32(d + pos + 12);
      hlen = 16;
    }
    if (lbox < hlen || lbox > end - pos) corrupt("Invalid header length");
    *body = pos + hlen;
    *body_end = pos + lbox;
    pos += lbox;
    return true;
  }
};

// Jpeg2KImagePlugin._parse_jp2_header: size and mode (and the palette).
void pil_parse_jp2(const uint8_t* d, size_t n, Header* h) {
  PilBoxes top{d, 12, n};
  uint32_t type;
  size_t b, e;
  bool found = false;
  while (top.next(&type, &b, &e)) {
    if (type == 0x6a703268) {  // jp2h
      found = true;
      break;
    }
  }
  if (!found) corrupt("no jp2h box");
  PilBoxes hdr{d, b, e};
  bool have_size = false, have_mode = false;
  int nc = 0;
  while (hdr.next(&type, &b, &e)) {
    if (type == 0x69686472) {  // ihdr
      if (e - b < 11) corrupt("Not enough data in header");
      h->height = static_cast<int>(be32(d + b));
      h->width = static_cast<int>(be32(d + b + 4));
      nc = static_cast<int>(be16(d + b + 8));
      int bpc = d[b + 10];
      have_size = true;
      if (nc == 1 && (bpc & 0x7F) > 8) {
        h->mode = M_I16, have_mode = true;
      } else if (nc == 1) {
        h->mode = M_L, have_mode = true;
      } else if (nc == 2) {
        h->mode = M_LA, have_mode = true;
      } else if (nc == 3) {
        h->mode = M_RGB, have_mode = true;
      } else if (nc == 4) {
        h->mode = M_RGBA, have_mode = true;
      }
    } else if (type == 0x636f6c72 && nc == 4) {  // colr
      if (e - b < 7) corrupt("Not enough data in header");
      if (d[b] == 1 && be32(d + b + 3) == 12) h->mode = M_CMYK, have_mode = true;
    } else if (type == 0x70636c72 && have_mode && (h->mode == M_L || h->mode == M_LA)) {  // pclr
      if (e - b < 3) corrupt("Not enough data in header");
      int ne = static_cast<int>(be16(d + b)), npc = d[b + 2];
      if (e - b < 3 + static_cast<size_t>(npc)) corrupt("Not enough data in header");
      int max_depth = 0;
      for (int i = 0; i < npc; ++i) max_depth = std::max(max_depth, int(d[b + 3 + i]));
      if (max_depth <= 8) {
        if (e - b < 3 + static_cast<size_t>(npc) * (1 + ne)) corrupt("Not enough data in header");
        std::vector<std::vector<uint32_t>> entries(ne);
        for (int i = 0; i < ne; ++i)
          for (int k = 0; k < npc; ++k) entries[i].push_back(d[b + 3 + npc * (1 + i) + k]);
        h->palette = pillow_palette(entries, npc);
        h->mode = h->mode == M_L ? M_P : M_PA;
      }
    }
  }
  if (!have_size || !have_mode) corrupt("Malformed JP2 header");
}

// Jpeg2KImagePlugin._parse_codestream: size and mode from SIZ.
void pil_parse_j2k(const uint8_t* d, size_t n, Header* h) {
  if (n < 6) corrupt("truncated SIZ");
  size_t lsiz = be16(d + 4);
  if (lsiz < 38 || 4 + lsiz > n) corrupt("truncated SIZ");
  const uint8_t* s = d + 4;
  uint32_t xsiz = be32(s + 4), ysiz = be32(s + 8), xo = be32(s + 12), yo = be32(s + 16);
  int csiz = static_cast<int>(be16(s + 36));
  h->width = static_cast<int>(int64_t(xsiz) - int64_t(xo));
  h->height = static_cast<int>(int64_t(ysiz) - int64_t(yo));
  if (csiz == 1) {
    if (lsiz < 39) corrupt("truncated SIZ");
    h->mode = (s[38] & 0x7F) + 1 > 8 ? M_I16 : M_L;
  } else if (csiz == 2) {
    h->mode = M_LA;
  } else if (csiz == 3) {
    h->mode = M_RGB;
  } else if (csiz == 4) {
    h->mode = M_RGBA;
  } else {
    corrupt("unable to determine J2K image mode");
  }
}

// OpenJPEG's jp2.c header procedure: the checks it makes, the colour space it
// sets, where the codestream starts.
void opj_read_jp2(const uint8_t* d, size_t n, Header* h) {
  enum { S_SIG = 1, S_FTYP = 2, S_HEADER = 4, S_CS = 8 };
  int state = 0;
  size_t pos = 0;
  uint32_t enumcs = 0, numcomps = 0;
  bool has_colr = false, has_ihdr_box = false, has_pclr = false, pclr_cmap = false, has_cdef = false;
  uint32_t npclr_channels = 0, bpc = 0;
  bool has_jp2h = false;
  auto img_box = [&](uint32_t type, const uint8_t* p, uint32_t size) -> bool {
    switch (type) {
      case 0x69686472: {  // ihdr
        if (has_ihdr_box) return true;  // "Ignoring ihdr box. First ihdr box already read"
        if (size != 14) corrupt("Bad image header box (bad size)");
        h->ihdr_h = be32(p);
        h->ihdr_w = be32(p + 4);
        numcomps = be16(p + 8);
        if (numcomps - 1u >= 16384u) corrupt("Invalid number of components (ihdr)");
        bpc = p[10];
        has_ihdr_box = true;
        return true;
      }
      case 0x636f6c72: {  // colr
        if (size < 3) corrupt("Bad COLR header box (bad size)");
        if (has_colr) return true;
        uint32_t meth = p[0];
        if (meth == 1) {
          if (size < 7) corrupt("Bad COLR header box (bad size)");
          enumcs = be32(p + 3);
          if (enumcs == 14) queued("a JP2 in CIELab");
          has_colr = true;
        } else if (meth == 2) {
          has_colr = true;  // an ICC profile: enumcs stays 0
        }
        return true;
      }
      case 0x62706363:  // bpcc
        if (size != numcomps) corrupt("Bad BPCC header box (bad size)");
        return true;
      case 0x70636c72: {  // pclr
        if (has_pclr) corrupt("second PCLR box");
        if (size < 3) corrupt("bad PCLR box");
        uint32_t ne = be16(p), npc = p[2];
        if (ne == 0 || ne > 1024) corrupt("Invalid PCLR box");
        if (npc == 0) corrupt("Invalid PCLR box. Reports 0 palette columns");
        if (size < 3 + npc) corrupt("bad PCLR box");
        std::vector<uint32_t> bytes(npc);
        for (uint32_t i = 0; i < npc; ++i) bytes[i] = std::min<uint32_t>(4, ((p[3 + i] & 0x7F) + 1 + 7) >> 3);
        size_t off = 3 + npc;
        for (uint32_t j = 0; j < ne; ++j)
          for (uint32_t i = 0; i < npc; ++i) {
            if (size < off + bytes[i]) corrupt("bad PCLR box");
            off += bytes[i];
          }
        has_pclr = true;
        npclr_channels = npc;
        return true;
      }
      case 0x636d6170:  // cmap
        if (!has_pclr) corrupt("Need to read a PCLR box before the CMAP box.");
        if (pclr_cmap) corrupt("Only one CMAP box is allowed.");
        if (size < npclr_channels * 4) corrupt("Insufficient data for CMAP box.");
        pclr_cmap = true;
        return true;
      case 0x63646566: {  // cdef
        if (has_cdef) corrupt("second CDEF box");
        if (size < 2) corrupt("Insufficient data for CDEF box.");
        uint32_t nd = be16(p);
        if (nd == 0) corrupt("Number of channel description is equal to zero in CDEF box.");
        if (size < 2 + nd * 6) corrupt("Insufficient data for CDEF box.");
        has_cdef = true;
        return true;
      }
    }
    return false;
  };
  for (;;) {
    if (n - pos < 8) break;  // opj_jp2_read_boxhdr fails: the header loop ends
    uint32_t length = be32(d + pos), type = be32(d + pos + 4);
    uint32_t hlen = 8;
    pos += 8;
    if (length == 0) {
      length = static_cast<uint32_t>(n - pos) + 8;
    } else if (length == 1) {
      if (n - pos < 8) break;
      if (be32(d + pos) != 0) corrupt("Cannot handle box sizes higher than 2^32");
      length = be32(d + pos + 4);
      hlen = 16;
      pos += 8;
    }
    if (type == 0x6a703263) {  // jp2c
      if (!(state & S_HEADER)) corrupt("bad placed jpeg codestream");
      state |= S_CS;
      break;
    }
    if (length == 0) corrupt("Cannot handle box of undefined sizes");
    if (length < hlen) corrupt("invalid box size");
    uint32_t size = length - hlen;
    bool top = type == 0x6a502020 || type == 0x66747970 || type == 0x6a703268;  // jP, ftyp, jp2h
    bool img = type == 0x69686472 || type == 0x636f6c72 || type == 0x62706363 || type == 0x70636c72 ||
               type == 0x636d6170 || type == 0x63646566;
    if (top || img) {
      if (!top) {  // a misplaced image box
        if (!(state & S_HEADER)) {
          if (n - pos < size) corrupt("Problem with skipping JPEG2000 box, stream error");
          pos += size;
          continue;
        }
      }
      if (size > n - pos) corrupt("Invalid box size");
      const uint8_t* p = d + pos;
      pos += size;
      if (type == 0x6a502020) {  // jP
        if (state != 0) corrupt("The signature box must be the first box in the file.");
        if (size != 4) corrupt("Error with JP signature Box size");
        if (be32(p) != 0x0d0a870a) corrupt("Error with JP Signature : bad magic number");
        state |= S_SIG;
      } else if (type == 0x66747970) {  // ftyp
        if (state != S_SIG) corrupt("The ftyp box must be the second box in the file.");
        if (size < 8 || ((size - 8) & 3)) corrupt("Error with FTYP signature Box size");
        state |= S_FTYP;
      } else if (type == 0x6a703268) {  // jp2h
        if ((state & S_FTYP) != S_FTYP) corrupt("The  box must be the first box in the file.");
        bool ihdr = false;
        uint32_t left = size;
        const uint8_t* q = p;
        while (left > 0) {
          if (left < 8) corrupt("Cannot handle box of less than 8 bytes");
          uint32_t blen = be32(q), btype = be32(q + 4), bh = 8;
          if (blen == 1) {
            if (left < 16) corrupt("Cannot handle XL box of less than 16 bytes");
            if (be32(q + 8) != 0) corrupt("Cannot handle box sizes higher than 2^32");
            blen = be32(q + 12);
            bh = 16;
            if (blen == 0) corrupt("Cannot handle box of undefined sizes");
          } else if (blen == 0) {
            corrupt("Cannot handle box of undefined sizes");
          }
          if (blen < bh) corrupt("Box length is inconsistent.");
          if (blen > left) corrupt("Stream error while reading JP2 Header box: box length is inconsistent.");
          img_box(btype, q + bh, blen - bh);
          if (btype == 0x69686472) ihdr = true;
          q += blen;
          left -= blen;
        }
        if (!ihdr) corrupt("Stream error while reading JP2 Header box: no 'ihdr' box.");
        state |= S_HEADER;
        has_jp2h = true;
      } else {
        img_box(type, p, size);
      }
    } else {
      if (!(state & S_SIG)) corrupt("Malformed JP2 file format: first box must be JPEG 2000 signature box");
      if (!(state & S_FTYP)) corrupt("Malformed JP2 file format: second box must be file type box");
      if (n - pos < size) corrupt("Problem with skipping JPEG2000 box, stream error");
      pos += size;
    }
  }
  if (!has_jp2h) corrupt("JP2H box missing. Required.");
  if (!has_ihdr_box) corrupt("IHDR box_missing. Required.");
  h->cs_start = pos;
  h->color_space = enumcs == 16   ? CS_SRGB
                   : enumcs == 17 ? CS_GRAY
                   : enumcs == 18 ? CS_SYCC
                   : enumcs == 24 ? CS_EYCC
                   : enumcs == 12 ? CS_CMYK
                                  : CS_UNKNOWN;
  (void)bpc;
}

// ----------------------------------------------------------- codestream ----

constexpr uint32_t kMaxRes = 33, kMaxBands = 3 * kMaxRes - 2;
constexpr uint32_t CSTY_PRT = 1, CSTY_SOP = 2, CSTY_EPH = 4;
// code-block styles (predictable termination, 16, changes no decoded bit)
constexpr uint32_t CBLK_LAZY = 1, CBLK_RESET = 2, CBLK_TERMALL = 4, CBLK_VSC = 8, CBLK_SEGSYM = 32, CBLK_HT = 64,
                   CBLK_HTMIXED = 128;
// j2k.c decoder states
constexpr uint32_t ST_MHSOC = 1, ST_MHSIZ = 2, ST_MH = 4, ST_TPHSOT = 8, ST_TPH = 16, ST_NEOC = 64,
                   ST_DATA = 128, ST_EOC = 256;

struct Comp {
  uint32_t dx = 1, dy = 1, prec = 8, sgnd = 0;
  uint32_t resno_decoded = 0;
};

struct Stepsize {
  int32_t expn = 0, mant = 0;
};

struct Tccp {
  uint32_t csty = 0, numres = 0, cblkw = 0, cblkh = 0, cblksty = 0, qmfbid = 0, qntsty = 0, numgbits = 0,
           roishift = 0;
  Stepsize steps[kMaxBands];
  uint32_t prcw[kMaxRes] = {}, prch[kMaxRes] = {};
};

struct PocEntry {
  uint32_t resno0 = 0, compno0 = 0, layno1 = 0, resno1 = 0, compno1 = 0;
  int prg = 0;
};

struct Tcp {
  uint32_t csty = 0, numlayers = 0, mct = 0;
  int prg = 0;
  std::vector<Tccp> tccps;
  bool poc = false;
  std::vector<PocEntry> pocs;
  bool ppt = false;
  std::map<uint32_t, std::vector<uint8_t>> ppt_markers;
  std::vector<uint8_t> data;
  bool has_data = false;
  int cur_part = -1;
  uint32_t nb_parts = 0;
};

// One tile as tcd.c lays it out for decoding.
struct Seg {
  uint32_t len = 0, numpasses = 0, real_num_passes = 0, maxpasses = 0, numnewpasses = 0, newlen = 0;
};

struct Cblk {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numbps = 0, numlenbits = 0, numnewpasses = 0, numsegs = 0, real_num_segs = 0;
  std::vector<Seg> segs;
  std::vector<std::pair<const uint8_t*, uint32_t>> chunks;
};

// tgt.c's tag tree
struct TagTree {
  struct Node {
    int parent = -1;
    int32_t value = 999, low = 0;
  };
  std::vector<Node> nodes;
  void init(uint32_t w, uint32_t h) {
    nodes.clear();
    if (!w || !h) return;
    std::vector<uint32_t> nw, nh;
    uint32_t cw = w, ch = h;
    size_t total = 0;
    for (;;) {
      nw.push_back(cw), nh.push_back(ch);
      total += size_t(cw) * ch;
      if (size_t(cw) * ch <= 1) break;
      cw = (cw + 1) / 2, ch = (ch + 1) / 2;
    }
    nodes.resize(total);
    size_t base = 0;
    for (size_t l = 0; l + 1 < nw.size(); ++l) {
      size_t next = base + size_t(nw[l]) * nh[l];
      for (uint32_t j = 0; j < nh[l]; ++j)
        for (uint32_t i = 0; i < nw[l]; ++i)
          nodes[base + size_t(j) * nw[l] + i].parent = static_cast<int>(next + size_t(j >> 1) * nw[l + 1] + (i >> 1));
      base = next;
    }
  }
  void reset() {
    for (auto& n : nodes) n.value = 999, n.low = 0;
  }
};

struct Precinct {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t cw = 0, ch = 0;
  std::vector<Cblk> cblks;
  TagTree incl, imsb;
};

struct Band {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t bandno = 0;
  int32_t numbps = 0;
  float stepsize = 0;
  std::vector<Precinct> precincts;
  bool empty() const { return x1 - x0 == 0 || y1 - y0 == 0; }
};

struct Res {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t pw = 0, ph = 0, pdx = 0, pdy = 0, numbands = 0;
  Band bands[3];
};

struct TileComp {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  uint32_t numres = 0;
  std::vector<Res> res;
  std::vector<int32_t> data;  // int32 samples, or fp32 bits on the irreversible path
};

struct Tile {
  int32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0;
  std::vector<TileComp> comps;
};

float as_float(int32_t v) {
  float f;
  memcpy(&f, &v, 4);
  return f;
}
int32_t as_int(float f) {
  int32_t v;
  memcpy(&v, &f, 4);
  return v;
}

// The bit reader of bio.c (packet headers).
struct Bio {
  const uint8_t* start;
  const uint8_t* bp;
  const uint8_t* end;
  uint32_t buf = 0, ct = 0;
  Bio(const uint8_t* p, uint32_t len) : start(p), bp(p), end(p + len) {}
  bool bytein() {
    buf = (buf << 8) & 0xffff;
    ct = buf == 0xff00 ? 7 : 8;
    if (bp >= end) return false;
    buf |= *bp++;
    return true;
  }
  uint32_t bit() {
    if (ct == 0) bytein();
    --ct;
    return (buf >> ct) & 1;
  }
  uint32_t read(uint32_t n) {
    uint32_t v = 0;
    for (uint32_t i = n - 1; i < n; --i) v |= bit() << i;
    return v;
  }
  bool inalign() {
    if ((buf & 0xff) == 0xff) {
      if (!bytein()) return false;
    }
    ct = 0;
    return true;
  }
  size_t numbytes() const { return static_cast<size_t>(bp - start); }
};

uint32_t tgt_decode(Bio& bio, TagTree& tree, uint32_t leaf, int32_t threshold) {
  int stk[64];
  int sp = 0;
  int node = static_cast<int>(leaf);
  while (tree.nodes[node].parent >= 0) {
    stk[sp++] = node;
    node = tree.nodes[node].parent;
  }
  int32_t low = 0;
  for (;;) {
    TagTree::Node& nd = tree.nodes[node];
    if (low > nd.low) {
      nd.low = low;
    } else {
      low = nd.low;
    }
    while (low < threshold && low < nd.value) {
      if (bio.read(1)) {
        nd.value = low;
      } else {
        ++low;
      }
    }
    nd.low = low;
    if (sp == 0) break;
    node = stk[--sp];
  }
  return tree.nodes[node].value < threshold ? 1 : 0;
}

// The codestream reader: j2k.c's main header procedure, then its tile-part
// state machine as opj_read_tile_header / opj_decode_tile_data drive it.
class Codestream {
 public:
  Codestream(const uint8_t* d, size_t n, size_t start, const Header& hdr) : d_(d), n_(n), pos_(start), hdr_(hdr) {}

  uint32_t x0 = 0, y0 = 0, x1 = 0, y1 = 0, tdx = 0, tdy = 0, tx0 = 0, ty0 = 0, tw = 0, th = 0;
  std::vector<Comp> comps;
  std::vector<Tcp> tcps;
  bool ppm = false;
  std::map<uint32_t, std::vector<uint8_t>> ppm_markers;
  std::vector<uint8_t> ppm_data;
  size_t ppm_pos = 0;

  size_t left() const { return n_ - pos_; }

  void read_main_header() {
    state_ = ST_MHSOC;
    if (left() < 2 || be16(d_ + pos_) != 0xFF4F) corrupt("Expected a SOC marker");
    pos_ += 2;
    state_ = ST_MHSIZ;
    uint32_t marker = read_u16("Stream too short");
    bool has_siz = false, has_cod = false, has_qcd = false;
    default_.tccps.clear();
    while (marker != 0xFF90) {
      if (marker < 0xFF00) corrupt("A marker ID was expected");
      uint32_t states = marker_states(marker);
      if (!states) {  // opj_j2k_read_unk
        for (;;) {
          uint32_t m = read_u16("Stream too short");
          if (m >= 0xFF00) {
            uint32_t s = marker_states(m);
            if (!(state_ & (s ? s : ST_MH | ST_TPH))) corrupt("Marker is not compliant with its position");
            if (s) {
              marker = m;
              break;
            }
          }
        }
        if (marker == 0xFF90) break;
        states = marker_states(marker);
      }
      if (marker == 0xFF51) has_siz = true;
      if (marker == 0xFF52) has_cod = true;
      if (marker == 0xFF5C) has_qcd = true;
      if (!(state_ & states)) corrupt("Marker is not compliant with its position");
      uint32_t size = read_u16("Stream too short");
      if (size < 2) corrupt("Invalid marker size");
      size -= 2;
      if (left() < size) corrupt("Stream too short");
      const uint8_t* p = d_ + pos_;
      pos_ += size;
      handle(marker, p, size);
      marker = read_u16("Stream too short");
    }
    if (!has_siz) corrupt("required SIZ marker not found in main header");
    if (!has_cod) corrupt("required COD marker not found in main header");
    if (!has_qcd) corrupt("required QCD marker not found in main header");
    merge_ppm();
    tcps.assign(size_t(tw) * th, default_);
    state_ = ST_TPHSOT;
  }

  // opj_j2k_read_tile_header: false when no tile is left to decode.
  bool next_tile(uint32_t* tile_no) {
    uint32_t marker = 0xFF90;
    const uint32_t nb_tiles = tw * th;
    if (state_ == ST_EOC) {
      marker = 0xFFD9;
    } else if (state_ != ST_TPHSOT) {
      corrupt("tile header expected");
    }
    while (!can_decode_ && marker != 0xFFD9) {
      while (marker != 0xFF93) {
        if (left() == 0) {
          state_ = ST_NEOC;
          break;
        }
        uint32_t size = read_u16("Stream too short");
        if (size < 2) corrupt("Inconsistent marker size");
        if (marker == 0x8080 && left() == 0) {
          state_ = ST_NEOC;
          break;
        }
        if (state_ & ST_TPH) {
          if (sot_length_ < size + 2) corrupt("Sot length is less than marker size + marker ID");
          sot_length_ -= size + 2;
        }
        size -= 2;
        uint32_t states = marker_states(marker);
        if (!(state_ & (states ? states : ST_MH | ST_TPH))) corrupt("Marker is not compliant with its position");
        if (left() < size) corrupt("Stream too short");
        if (!states) corrupt("unknown marker in a tile-part header");
        const uint8_t* p = d_ + pos_;
        pos_ += size;
        handle(marker, p, size);
        marker = read_u16("Stream too short");
      }
      if (left() == 0 && state_ == ST_NEOC) break;
      read_sod();
      if (!can_decode_) {
        if (left() < 2) {
          // j2k.c's SPOT6 rule: the last tile's TPsot == TNsot == 0 and no EOC
          if (cur_tile_ + 1 == nb_tiles) {
            uint32_t t = 0;
            for (; t < nb_tiles; ++t)
              if (tcps[t].cur_part == 0 && tcps[t].nb_parts == 0) break;
            if (t < nb_tiles) {
              cur_tile_ = t;
              marker = 0xFFD9;
              state_ = ST_EOC;
              break;
            }
          }
          corrupt("Stream too short");
        }
        marker = read_u16("Stream too short");
      }
    }
    if (marker == 0xFFD9 && state_ != ST_EOC) {
      cur_tile_ = 0;
      state_ = ST_EOC;
    }
    if (!can_decode_) {
      while (cur_tile_ < nb_tiles && !tcps[cur_tile_].has_data) ++cur_tile_;
      if (cur_tile_ == nb_tiles) return false;
    }
    *tile_no = cur_tile_;
    state_ |= ST_DATA;
    return true;
  }

  // The end of opj_j2k_decode_tile, after the tile was decoded.
  void tile_done() {
    Tcp& tcp = tcps[cur_tile_];
    tcp.data.clear();
    tcp.data.shrink_to_fit();
    tcp.has_data = false;
    can_decode_ = false;
    state_ &= ~ST_DATA;
    if (left() == 0 && state_ == ST_NEOC) return;
    if (state_ != ST_EOC) {
      uint32_t marker = read_u16("Stream too short");
      if (marker == 0xFFD9) {
        cur_tile_ = 0;
        state_ = ST_EOC;
      } else if (marker != 0xFF90) {
        if (left() == 0) {
          state_ = ST_NEOC;
          return;
        }
        corrupt("Stream too short");
      }
    }
  }

 private:
  const uint8_t* d_;
  size_t n_, pos_;
  const Header& hdr_;
  uint32_t state_ = 0;
  Tcp default_;
  uint32_t cur_tile_ = 0, sot_length_ = 0;
  bool can_decode_ = false, last_tile_part_ = false;

  uint32_t read_u16(const char* msg) {
    if (left() < 2) corrupt(msg);
    uint32_t v = be16(d_ + pos_);
    pos_ += 2;
    return v;
  }

  // opj_j2k_get_marker_handler's states; 0 for an unknown marker.
  uint32_t marker_states(uint32_t m) const {
    switch (m) {
      case 0xFF90: return ST_MH | ST_TPHSOT;  // SOT
      case 0xFF52: case 0xFF53: case 0xFF5E: case 0xFF5C: case 0xFF5D: case 0xFF5F: case 0xFF64:
        return ST_MH | ST_TPH;  // COD COC RGN QCD QCC POC COM
      case 0xFF51: return ST_MHSIZ;            // SIZ
      case 0xFF55: case 0xFF57: case 0xFF60: case 0xFF63:
        return ST_MH;  // TLM PLM PPM CRG
      case 0xFF58: case 0xFF61: return ST_TPH;  // PLT PPT
      case 0xFF91: return 0x40000000;          // SOP: a handler for no state
      case 0xFF74: case 0xFF75: case 0xFF77: return ST_MH | ST_TPH;  // MCT MCC MCO
      case 0xFF78: case 0xFF50: case 0xFF59: return ST_MH;            // CBD CAP CPF
    }
    return 0;
  }

  Tcp& cur_tcp() { return state_ == ST_TPH ? tcps[cur_tile_] : default_; }

  void handle(uint32_t m, const uint8_t* p, uint32_t size) {
    switch (m) {
      case 0xFF51: read_siz(p, size); break;
      case 0xFF52: read_cod(p, size); break;
      case 0xFF53: read_coc(p, size); break;
      case 0xFF5C: read_qcd(p, size); break;
      case 0xFF5D: read_qcc(p, size); break;
      case 0xFF5E: read_rgn(p, size); break;
      case 0xFF5F: read_poc(p, size); break;
      case 0xFF55: read_tlm(p, size); break;
      case 0xFF57:
        if (size < 1) corrupt("Error reading PLM marker");
        break;
      case 0xFF58: read_plt(p, size); break;
      case 0xFF60: read_ppm(p, size); break;
      case 0xFF61: read_ppt(p, size); break;
      case 0xFF63:
        if (size != comps.size() * 4) corrupt("Error reading CRG marker");
        break;
      case 0xFF64: break;  // COM
      case 0xFF90: read_sot(p, size); break;
      case 0xFF50: queued("HTJ2K (a CAP marker)");
      case 0xFF59: queued("a JPEG 2000 CPF marker");
      case 0xFF74: case 0xFF75: case 0xFF77: case 0xFF78:
        queued("a JPEG 2000 Part 2 multi-component transform");
      case 0xFF91: corrupt("Not sure how that happened.");
    }
  }

  void read_siz(const uint8_t* p, uint32_t size) {
    if (size < 36) corrupt("Error with SIZ marker size");
    uint32_t rem = size - 36;
    if (rem % 3) corrupt("Error with SIZ marker size");
    x1 = be32(p + 2), y1 = be32(p + 6), x0 = be32(p + 10), y0 = be32(p + 14);
    tdx = be32(p + 18), tdy = be32(p + 22), tx0 = be32(p + 26), ty0 = be32(p + 30);
    uint32_t nc = be16(p + 34);
    if (nc >= 16385) corrupt("Error with SIZ marker: number of component is illegal");
    if (nc != rem / 3) corrupt("Error with SIZ marker: number of component is not compatible");
    if (x0 >= x1 || y0 >= y1) corrupt("Error with SIZ marker: negative or zero image size");
    if (tdx == 0 || tdy == 0) corrupt("Error with SIZ marker: invalid tile size");
    uint64_t tx1 = std::min<uint64_t>(uint64_t(tx0) + tdx, 0xFFFFFFFFu);
    uint64_t ty1 = std::min<uint64_t>(uint64_t(ty0) + tdy, 0xFFFFFFFFu);
    if (tx0 > x0 || ty0 > y0 || tx1 <= x0 || ty1 <= y0) corrupt("Error with SIZ marker: illegal tile offset");
    if (hdr_.ihdr_w > 0 && hdr_.ihdr_h > 0 && (hdr_.ihdr_w != x1 - x0 || hdr_.ihdr_h != y1 - y0))
      corrupt("Error with SIZ marker: IHDR w h vs. SIZ w h");
    comps.assign(nc, Comp());
    for (uint32_t i = 0; i < nc; ++i) {
      const uint8_t* c = p + 36 + 3 * i;
      comps[i].prec = (c[0] & 0x7F) + 1;
      comps[i].sgnd = c[0] >> 7;
      comps[i].dx = c[1];
      comps[i].dy = c[2];
      if (comps[i].dx < 1 || comps[i].dy < 1) corrupt("Invalid values for comp dx dy");
      if (comps[i].prec > 31) corrupt("Invalid values for comp prec");
    }
    tw = uceildiv(x1 - tx0, tdx);
    th = uceildiv(y1 - ty0, tdy);
    if (tw == 0 || th == 0 || tw > 65535 / th) corrupt("Invalid number of tiles");
    default_.tccps.assign(nc, Tccp());
    state_ = ST_MH;
  }

  void read_spcod(uint32_t compno, const uint8_t*& p, uint32_t& size) {
    Tccp& t = cur_tcp().tccps[compno];
    if (size < 5) corrupt("Error reading SPCod SPCoc element");
    t.numres = p[0] + 1u;
    if (t.numres > kMaxRes) corrupt("Invalid value for numresolutions");
    t.cblkw = p[1] + 2u;
    t.cblkh = p[2] + 2u;
    if (t.cblkw > 10 || t.cblkh > 10 || t.cblkw + t.cblkh > 12)
      corrupt("Error reading SPCod SPCoc element, Invalid cblkw/cblkh combination");
    t.cblksty = p[3];
    if (t.cblksty & CBLK_HTMIXED) refused("a JPEG 2000 of mixed HT code-blocks");
    t.qmfbid = p[4];
    if (t.qmfbid > 1) corrupt("Error reading SPCod SPCoc element, Invalid transformation found");
    p += 5;
    size -= 5;
    if (t.csty & CSTY_PRT) {
      if (size < t.numres) corrupt("Error reading SPCod SPCoc element");
      for (uint32_t i = 0; i < t.numres; ++i) {
        uint32_t v = p[i];
        if (i != 0 && ((v & 0xF) == 0 || (v >> 4) == 0)) corrupt("Invalid precinct size");
        t.prcw[i] = v & 0xF;
        t.prch[i] = v >> 4;
      }
      p += t.numres;
      size -= t.numres;
    } else {
      for (uint32_t i = 0; i < t.numres; ++i) t.prcw[i] = t.prch[i] = 15;
    }
  }

  void read_cod(const uint8_t* p, uint32_t size) {
    Tcp& tcp = cur_tcp();
    if (size < 5) corrupt("Error reading COD marker");
    tcp.csty = p[0];
    if (tcp.csty & ~(CSTY_PRT | CSTY_SOP | CSTY_EPH)) corrupt("Unknown Scod value in COD marker");
    tcp.prg = p[1] > CPRL ? -1 : p[1];
    tcp.numlayers = be16(p + 2);
    if (tcp.numlayers < 1) corrupt("Invalid number of layers in COD marker");
    tcp.mct = p[4];
    if (tcp.mct > 1) corrupt("Invalid multiple component transformation");
    p += 5;
    size -= 5;
    for (auto& t : tcp.tccps) t.csty = tcp.csty & CSTY_PRT;
    read_spcod(0, p, size);
    if (size != 0) corrupt("Error reading COD marker");
    // opj_j2k_copy_tile_component_parameters
    const Tccp ref = tcp.tccps[0];
    for (auto& t : tcp.tccps) {
      t.numres = ref.numres, t.cblkw = ref.cblkw, t.cblkh = ref.cblkh, t.cblksty = ref.cblksty;
      t.qmfbid = ref.qmfbid;
      memcpy(t.prcw, ref.prcw, sizeof t.prcw);
      memcpy(t.prch, ref.prch, sizeof t.prch);
    }
  }

  uint32_t comp_room() const { return comps.size() <= 256 ? 1 : 2; }

  void read_coc(const uint8_t* p, uint32_t size) {
    Tcp& tcp = cur_tcp();
    uint32_t room = comp_room();
    if (size < room + 1) corrupt("Error reading COC marker");
    size -= room + 1;
    uint32_t c = room == 1 ? p[0] : be16(p);
    p += room;
    if (c >= comps.size()) corrupt("Error reading COC marker (bad number of components)");
    tcp.tccps[c].csty = p[0];
    ++p;
    read_spcod(c, p, size);
    if (size != 0) corrupt("Error reading COC marker");
  }

  void read_sqcd(uint32_t compno, const uint8_t* p, uint32_t& size) {
    Tccp& t = cur_tcp().tccps[compno];
    if (size < 1) corrupt("Error reading SQcd or SQcc element");
    size -= 1;
    t.qntsty = p[0] & 0x1F;
    t.numgbits = p[0] >> 5;
    ++p;
    uint32_t nb = t.qntsty == 1 ? 1 : t.qntsty == 0 ? size : size / 2;
    if (t.qntsty == 0) {
      if (size < nb) corrupt("Error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < nb; ++b)
        if (b < kMaxBands) t.steps[b].expn = p[b] >> 3, t.steps[b].mant = 0;
      size -= nb;
    } else {
      if (size < 2 * nb) corrupt("Error reading SQcd or SQcc element");
      for (uint32_t b = 0; b < nb; ++b) {
        uint32_t v = be16(p + 2 * b);
        if (b < kMaxBands) t.steps[b].expn = v >> 11, t.steps[b].mant = v & 0x7FF;
      }
      size -= 2 * nb;
    }
    if (t.qntsty == 1)
      for (uint32_t b = 1; b < kMaxBands; ++b) {
        int32_t e = t.steps[0].expn - int32_t((b - 1) / 3);
        t.steps[b].expn = e > 0 ? e : 0;
        t.steps[b].mant = t.steps[0].mant;
      }
  }

  void read_qcd(const uint8_t* p, uint32_t size) {
    read_sqcd(0, p, size);
    if (size != 0) corrupt("Error reading QCD marker");
    Tcp& tcp = cur_tcp();
    const Tccp ref = tcp.tccps[0];
    for (auto& t : tcp.tccps) {
      t.qntsty = ref.qntsty, t.numgbits = ref.numgbits;
      memcpy(t.steps, ref.steps, sizeof t.steps);
    }
  }

  void read_qcc(const uint8_t* p, uint32_t size) {
    uint32_t room = comp_room();
    if (size < room) corrupt("Error reading QCC marker");
    uint32_t c = room == 1 ? p[0] : be16(p);
    p += room;
    size -= room;
    if (c >= comps.size()) corrupt("Invalid component number in QCC");
    read_sqcd(c, p, size);
    if (size != 0) corrupt("Error reading QCC marker");
  }

  void read_rgn(const uint8_t* p, uint32_t size) {
    uint32_t room = comp_room();
    if (size != 2 + room) corrupt("Error reading RGN marker");
    uint32_t c = room == 1 ? p[0] : be16(p);
    if (c >= comps.size()) corrupt("bad component number in RGN");
    cur_tcp().tccps[c].roishift = p[room + 1];
  }

  void read_poc(const uint8_t* p, uint32_t size) {
    uint32_t room = comp_room(), chunk = 5 + 2 * room;
    uint32_t nb = size / chunk;
    if (nb == 0 || size % chunk) corrupt("Error reading POC marker");
    Tcp& tcp = cur_tcp();
    uint32_t old = tcp.poc ? static_cast<uint32_t>(tcp.pocs.size()) : 0;
    if (old + nb >= 32) corrupt("Too many POCs");
    tcp.poc = true;
    tcp.pocs.resize(old);
    for (uint32_t i = 0; i < nb; ++i, p += chunk) {
      PocEntry e;
      e.resno0 = p[0];
      e.compno0 = room == 1 ? p[1] : be16(p + 1);
      e.layno1 = std::min(be16(p + 1 + room), tcp.numlayers);
      e.resno1 = p[3 + room];
      e.compno1 = std::min<uint32_t>(room == 1 ? p[4 + room] : be16(p + 4 + room), static_cast<uint32_t>(comps.size()));
      e.prg = p[4 + 2 * room];
      tcp.pocs.push_back(e);
    }
  }

  void read_tlm(const uint8_t* p, uint32_t size) {
    if (size < 2) corrupt("Error reading TLM marker");
    uint32_t st = (p[1] >> 4) & 3, sp = (p[1] >> 6) & 1;
    if (st == 3) corrupt("opj_j2k_read_tlm(): ST = 3 is invalid");
    if ((size - 2) % ((sp + 1) * 2 + st)) corrupt("Error reading TLM marker");
  }

  void read_plt(const uint8_t* p, uint32_t size) {
    if (size < 1) corrupt("Error reading PLT marker");
    uint32_t len = 0;
    for (uint32_t i = 1; i < size; ++i) {
      len |= p[i] & 0x7F;
      if (p[i] & 0x80) {
        len <<= 7;
      } else {
        len = 0;
      }
    }
    if (len != 0) corrupt("Error reading PLT marker");
  }

  void read_ppm(const uint8_t* p, uint32_t size) {
    if (size < 2) corrupt("Error reading PPM marker");
    ppm = true;
    uint32_t z = p[0];
    if (ppm_markers.count(z)) corrupt("Zppm already read");
    ppm_markers[z].assign(p + 1, p + size);
  }

  void merge_ppm() {
    if (!ppm) return;
    uint32_t remaining = 0;
    for (auto& kv : ppm_markers) {
      const std::vector<uint8_t>& m = kv.second;
      size_t i = 0, sz = m.size();
      if (remaining >= sz) {
        remaining -= static_cast<uint32_t>(sz);
        ppm_data.insert(ppm_data.end(), m.begin(), m.end());
        continue;
      }
      ppm_data.insert(ppm_data.end(), m.begin(), m.begin() + remaining);
      i = remaining;
      remaining = 0;
      while (i < sz) {
        if (sz - i < 4) corrupt("Not enough bytes to read Nppm");
        uint32_t nppm = be32(m.data() + i);
        i += 4;
        if (sz - i >= nppm) {
          ppm_data.insert(ppm_data.end(), m.begin() + i, m.begin() + i + nppm);
          i += nppm;
        } else {
          ppm_data.insert(ppm_data.end(), m.begin() + i, m.end());
          remaining = nppm - static_cast<uint32_t>(sz - i);
          i = sz;
        }
      }
    }
    if (remaining != 0) corrupt("Corrupted PPM markers");
  }

  void read_ppt(const uint8_t* p, uint32_t size) {
    if (size < 2) corrupt("Error reading PPT marker");
    if (ppm) corrupt("Error reading PPT marker: packet headers were found in the main header (PPM)");
    Tcp& tcp = tcps[cur_tile_];
    tcp.ppt = true;
    uint32_t z = p[0];
    if (tcp.ppt_markers.count(z)) corrupt("Zppt already read");
    tcp.ppt_markers[z].assign(p + 1, p + size);
  }

  void read_sot(const uint8_t* p, uint32_t size) {
    if (size != 8) corrupt("Error reading SOT marker");
    uint32_t tile = be16(p), tot_len = be32(p + 2), part = p[6], num_parts = p[7];
    cur_tile_ = tile;
    if (tile >= tw * th) corrupt("Invalid tile number");
    Tcp& tcp = tcps[tile];
    if (tcp.cur_part + 1 != static_cast<int>(part)) corrupt("Invalid tile part index");
    tcp.cur_part = static_cast<int>(part);
    if (tot_len != 0 && tot_len < 14 && tot_len != 12) corrupt("Psot value is not correct regards to the norm");
    if (!tot_len) last_tile_part_ = true;
    if (tcp.nb_parts != 0 && part >= tcp.nb_parts) corrupt("In SOT marker, TPSot is not valid");
    if (num_parts != 0) {
      if (part >= num_parts) corrupt("In SOT marker, TPSot is not valid regards to the current number of tile-part");
      tcp.nb_parts = num_parts;
    }
    if (tcp.nb_parts && tcp.nb_parts == part + 1) can_decode_ = true;
    sot_length_ = last_tile_part_ ? 0 : tot_len - 12;
    state_ = ST_TPH;
  }

  void read_sod() {
    Tcp& tcp = tcps[cur_tile_];
    if (last_tile_part_) {
      sot_length_ = static_cast<uint32_t>(left() - 2);
    } else if (sot_length_ >= 2) {
      sot_length_ -= 2;
    }
    if (sot_length_) {
      if (sot_length_ > left()) corrupt("Tile part length size inconsistent with stream length");
      tcp.data.insert(tcp.data.end(), d_ + pos_, d_ + pos_ + sot_length_);
      pos_ += sot_length_;
      tcp.has_data = true;  // j2k.c allocates the tile's data only for a part that has some
    }
    state_ = ST_TPHSOT;
  }
};

// ------------------------------------------------------- packet iterator ----

// pi.c's decoding iterator over one tile: opj_pi_create_decode, the POC or
// default bounds, opj_pi_next_{lrcp,rlcp,rpcl,pcrl,cprl} with their include
// table, written as loops that call `visit(compno, resno, precno, layno)`.
// The tile's bounds and each resolution's precinct sizes and counts are
// `init_tile`'s, which opj_get_all_encoding_parameters computes alike.
struct PiComp {
  uint32_t dx, dy, numres;
  const std::vector<Res>* res;
};

template <class Visit>
void iterate_packets(const Codestream& cs, const Tcp& tcp, const Tile& tile, Visit visit) {
  const uint32_t tx0 = static_cast<uint32_t>(tile.x0), ty0 = static_cast<uint32_t>(tile.y0);
  const uint32_t tx1 = static_cast<uint32_t>(tile.x1), ty1 = static_cast<uint32_t>(tile.y1);
  const uint32_t nc = static_cast<uint32_t>(cs.comps.size());
  uint32_t max_prec = 0, max_res = 0;
  std::vector<PiComp> comps(nc);
  for (uint32_t c = 0; c < nc; ++c) {
    comps[c] = {cs.comps[c].dx, cs.comps[c].dy, tcp.tccps[c].numres, &tile.comps[c].res};
    max_res = std::max(max_res, comps[c].numres);
    for (const Res& r : tile.comps[c].res) max_prec = std::max(max_prec, r.pw * r.ph);
  }
  const uint64_t step_c = max_prec, step_r = nc * step_c, step_l = max_res * step_r;
  const uint64_t include_size = (uint64_t(tcp.numlayers) + 1) * step_l;
  std::vector<uint8_t> include(include_size, 0);
  // true: go on; false: the iterator ends (an invalid index)
  auto emit = [&](uint32_t layno, uint32_t resno, uint32_t compno, uint32_t precno) -> int {
    uint64_t index = layno * step_l + resno * step_r + compno * step_c + precno;
    if (index >= include_size) return -1;
    if (include[index]) return 0;
    include[index] = 1;
    visit(compno, resno, precno, layno);
    return 0;
  };
  const uint32_t bound = tcp.poc ? static_cast<uint32_t>(tcp.pocs.size()) : 1;
  for (uint32_t pino = 0; pino < bound; ++pino) {
    int prg;
    uint32_t resno0, compno0, resno1, compno1, layno1;
    if (tcp.poc) {
      const PocEntry& e = tcp.pocs[pino];
      prg = e.prg, resno0 = e.resno0, compno0 = e.compno0, resno1 = e.resno1, compno1 = e.compno1;
      layno1 = std::min(e.layno1, tcp.numlayers);
    } else {
      prg = tcp.prg, resno0 = 0, compno0 = 0, resno1 = max_res, compno1 = nc, layno1 = tcp.numlayers;
    }
    if (prg == -1) corrupt("unknown progression order");
    if (prg > CPRL) continue;
    if (compno0 >= nc || compno1 >= nc + 1) continue;  // "invalid compno0/compno1": no packet
    if (prg == LRCP || prg == RLCP) {
      bool stop = false;
      auto body = [&](uint32_t layno, uint32_t resno) {
        for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
          if (resno >= comps[c].numres) continue;
          const Res& r = (*comps[c].res)[resno];
          for (uint32_t pr = 0; pr < r.pw * r.ph; ++pr)
            if (emit(layno, resno, c, pr) < 0) {
              stop = true;
              break;
            }
        }
      };
      if (prg == LRCP) {
        for (uint32_t l = 0; l < layno1 && !stop; ++l)
          for (uint32_t r = resno0; r < resno1 && !stop; ++r) body(l, r);
      } else {
        for (uint32_t r = resno0; r < resno1 && !stop; ++r)
          for (uint32_t l = 0; l < layno1 && !stop; ++l) body(l, r);
      }
      continue;
    }
    // position-driven orders
    auto steps = [&](uint32_t c0, uint32_t c1, uint32_t* pdx, uint32_t* pdy) {
      uint32_t dx = 0, dy = 0;
      for (uint32_t c = c0; c < c1; ++c)
        for (uint32_t r = 0; r < comps[c].numres; ++r) {
          const PiComp& pc = comps[c];
          const Res& res = (*pc.res)[r];
          uint32_t sx = res.pdx + pc.numres - 1 - r, sy = res.pdy + pc.numres - 1 - r;
          if (sx < 32 && pc.dx <= 0xFFFFFFFFu / (1u << sx)) {
            uint32_t v = pc.dx * (1u << sx);
            dx = !dx ? v : std::min(dx, v);
          }
          if (sy < 32 && pc.dy <= 0xFFFFFFFFu / (1u << sy)) {
            uint32_t v = pc.dy * (1u << sy);
            dy = !dy ? v : std::min(dy, v);
          }
        }
      *pdx = dx, *pdy = dy;
    };
    bool stop = false;
    // the packets of one (x, y, comp, res): true when the iterator must end
    auto at = [&](uint32_t x, uint32_t y, uint32_t c, uint32_t resno) {
      const PiComp& pc = comps[c];
      if (resno >= pc.numres) return;
      const Res& r = (*pc.res)[resno];
      uint32_t levelno = pc.numres - 1 - resno;
      if (levelno >= 32 || ((pc.dx << levelno) >> levelno) != pc.dx || ((pc.dy << levelno) >> levelno) != pc.dy) return;
      if ((uint64_t(pc.dx) << levelno) > 0x7FFFFFFF || (uint64_t(pc.dy) << levelno) > 0x7FFFFFFF) return;
      uint32_t trx0 = uceildiv(tx0, pc.dx << levelno), try0 = uceildiv(ty0, pc.dy << levelno);
      uint32_t trx1 = uceildiv(tx1, pc.dx << levelno), try1 = uceildiv(ty1, pc.dy << levelno);
      uint32_t rpx = r.pdx + levelno, rpy = r.pdy + levelno;
      if (rpx >= 31 || ((pc.dx << rpx) >> rpx) != pc.dx || rpy >= 31 || ((pc.dy << rpy) >> rpy) != pc.dy) return;
      if (!((uint64_t(y) % (uint64_t(pc.dy) << rpy) == 0) ||
            (y == ty0 && ((uint64_t(try0) << levelno) % (uint64_t(1) << rpy)))))
        return;
      if (!((uint64_t(x) % (uint64_t(pc.dx) << rpx) == 0) ||
            (x == tx0 && ((uint64_t(trx0) << levelno) % (uint64_t(1) << rpx)))))
        return;
      if (r.pw == 0 || r.ph == 0) return;
      if (trx0 == trx1 || try0 == try1) return;
      uint32_t prci = (uceildiv(x, pc.dx << levelno) >> r.pdx) - (trx0 >> r.pdx);
      uint32_t prcj = (uceildiv(y, pc.dy << levelno) >> r.pdy) - (try0 >> r.pdy);
      uint32_t precno = prci + prcj * r.pw;
      for (uint32_t l = 0; l < layno1; ++l)
        if (emit(l, resno, c, precno) < 0) {
          stop = true;
          return;
        }
    };
    auto grid = [&](uint32_t dx, uint32_t dy, auto inner) {
      for (uint32_t y = ty0; y < ty1 && !stop; y += dy - (y % dy))
        for (uint32_t x = tx0; x < tx1 && !stop; x += dx - (x % dx)) inner(x, y);
    };
    if (prg == CPRL) {
      for (uint32_t c = compno0; c < compno1 && !stop; ++c) {
        uint32_t dx, dy;
        steps(c, c + 1, &dx, &dy);
        if (!dx || !dy) break;
        grid(dx, dy, [&](uint32_t x, uint32_t y) {
          for (uint32_t r = resno0; r < std::min(resno1, comps[c].numres) && !stop; ++r) at(x, y, c, r);
        });
      }
      continue;
    }
    uint32_t dx, dy;
    steps(0, nc, &dx, &dy);
    if (!dx || !dy) continue;
    if (prg == RPCL) {
      for (uint32_t r = resno0; r < resno1 && !stop; ++r)
        grid(dx, dy, [&](uint32_t x, uint32_t y) {
          for (uint32_t c = compno0; c < compno1 && !stop; ++c) at(x, y, c, r);
        });
    } else {  // PCRL
      grid(dx, dy, [&](uint32_t x, uint32_t y) {
        for (uint32_t c = compno0; c < compno1 && !stop; ++c)
          for (uint32_t r = resno0; r < resno1 && !stop; ++r) at(x, y, c, r);
      });
    }
  }
}

// ------------------------------------------------------------------ tcd ----

// opj_tcd_init_tile for decoding.
void init_tile(const Codestream& cs, const Tcp& tcp, uint32_t tileno, Tile* tile) {
  uint32_t p = tileno % cs.tw, q = tileno / cs.tw;
  uint32_t ltx0 = cs.tx0 + p * cs.tdx, lty0 = cs.ty0 + q * cs.tdy;
  tile->x0 = static_cast<int32_t>(std::max(ltx0, cs.x0));
  tile->y0 = static_cast<int32_t>(std::max(lty0, cs.y0));
  tile->x1 = static_cast<int32_t>(std::min<uint64_t>(std::min<uint64_t>(uint64_t(ltx0) + cs.tdx, 0xFFFFFFFFu), cs.x1));
  tile->y1 = static_cast<int32_t>(std::min<uint64_t>(std::min<uint64_t>(uint64_t(lty0) + cs.tdy, 0xFFFFFFFFu), cs.y1));
  if (tile->x0 < 0 || tile->x1 <= tile->x0 || tile->y0 < 0 || tile->y1 <= tile->y0)
    corrupt("Tile coordinates are not supported");
  tile->comps.assign(cs.comps.size(), TileComp());
  for (size_t c = 0; c < cs.comps.size(); ++c) {
    const Tccp& tc = tcp.tccps[c];
    const Comp& ic = cs.comps[c];
    TileComp& tcmp = tile->comps[c];
    tcmp.x0 = ceildiv(tile->x0, ic.dx), tcmp.y0 = ceildiv(tile->y0, ic.dy);
    tcmp.x1 = ceildiv(tile->x1, ic.dx), tcmp.y1 = ceildiv(tile->y1, ic.dy);
    tcmp.numres = tc.numres;
    tcmp.res.assign(tc.numres, Res());
    uint32_t level = tc.numres;
    uint32_t step = 0;
    for (uint32_t r = 0; r < tc.numres; ++r) {
      Res& res = tcmp.res[r];
      --level;
      res.x0 = ceildivpow2(tcmp.x0, level), res.y0 = ceildivpow2(tcmp.y0, level);
      res.x1 = ceildivpow2(tcmp.x1, level), res.y1 = ceildivpow2(tcmp.y1, level);
      uint32_t pdx = tc.prcw[r], pdy = tc.prch[r];
      res.pdx = pdx, res.pdy = pdy;
      int32_t prc_x0 = floordivpow2(res.x0, pdx) << pdx, prc_y0 = floordivpow2(res.y0, pdy) << pdy;
      uint64_t bx = uint64_t(uint32_t(ceildivpow2(res.x1, pdx))) << pdx;
      uint64_t by = uint64_t(uint32_t(ceildivpow2(res.y1, pdy))) << pdy;
      if (bx > 0x7FFFFFFF || by > 0x7FFFFFFF) corrupt("Integer overflow");
      res.pw = res.x0 == res.x1 ? 0 : static_cast<uint32_t>((int32_t(bx) - prc_x0) >> pdx);
      res.ph = res.y0 == res.y1 ? 0 : static_cast<uint32_t>((int32_t(by) - prc_y0) >> pdy);
      uint64_t nprec = uint64_t(res.pw) * res.ph;
      if (nprec > 0xFFFFFFFFu) corrupt("Size of tile data exceeds system limits");
      int32_t cbgx0, cbgy0;
      uint32_t cbgw, cbgh;
      if (r == 0) {
        cbgx0 = prc_x0, cbgy0 = prc_y0, cbgw = pdx, cbgh = pdy, res.numbands = 1;
      } else {
        cbgx0 = ceildivpow2(prc_x0, 1), cbgy0 = ceildivpow2(prc_y0, 1);
        cbgw = pdx - 1, cbgh = pdy - 1, res.numbands = 3;
      }
      uint32_t cbw = std::min(tc.cblkw, cbgw), cbh = std::min(tc.cblkh, cbgh);
      for (uint32_t b = 0; b < res.numbands; ++b, ++step) {
        Band& band = res.bands[b];
        if (r == 0) {
          band.bandno = 0;
          band.x0 = ceildivpow2(tcmp.x0, level), band.y0 = ceildivpow2(tcmp.y0, level);
          band.x1 = ceildivpow2(tcmp.x1, level), band.y1 = ceildivpow2(tcmp.y1, level);
        } else {
          band.bandno = b + 1;
          int64_t xob = band.bandno & 1, yob = band.bandno >> 1;
          auto cdp = [](int64_t a, uint32_t s) { return static_cast<int32_t>((a + (int64_t(1) << s) - 1) >> s); };
          band.x0 = cdp(tcmp.x0 - (xob << level), level + 1), band.y0 = cdp(tcmp.y0 - (yob << level), level + 1);
          band.x1 = cdp(tcmp.x1 - (xob << level), level + 1), band.y1 = cdp(tcmp.y1 - (yob << level), level + 1);
        }
        const Stepsize& ss = tc.steps[std::min(step, kMaxBands - 1)];
        int32_t log2_gain = tc.qmfbid == 0 ? 0 : band.bandno == 0 ? 0 : band.bandno == 3 ? 2 : 1;
        int32_t rb = static_cast<int32_t>(ic.prec) + log2_gain;
        band.stepsize = static_cast<float>((1.0 + ss.mant / 2048.0) * std::pow(2.0, rb - ss.expn));
        band.numbps = ss.expn + static_cast<int32_t>(tc.numgbits) - 1;
        band.precincts.assign(nprec, Precinct());
        for (uint32_t pi = 0; pi < nprec; ++pi) {
          Precinct& prc = band.precincts[pi];
          int32_t gx0 = cbgx0 + static_cast<int32_t>(pi % res.pw) * (1 << cbgw);
          int32_t gy0 = cbgy0 + static_cast<int32_t>(pi / res.pw) * (1 << cbgh);
          int32_t gx1 = gx0 + (1 << cbgw), gy1 = gy0 + (1 << cbgh);
          prc.x0 = std::max(gx0, band.x0), prc.y0 = std::max(gy0, band.y0);
          prc.x1 = std::min(gx1, band.x1), prc.y1 = std::min(gy1, band.y1);
          int32_t cx0 = floordivpow2(prc.x0, cbw) << cbw, cy0 = floordivpow2(prc.y0, cbh) << cbh;
          int32_t cx1 = ceildivpow2(prc.x1, cbw) << cbw, cy1 = ceildivpow2(prc.y1, cbh) << cbh;
          prc.cw = static_cast<uint32_t>((cx1 - cx0) >> cbw);
          prc.ch = static_cast<uint32_t>((cy1 - cy0) >> cbh);
          uint64_t ncb = uint64_t(prc.cw) * prc.ch;
          if (ncb > (1u << 24)) corrupt("Size of tile data exceeds system limits");
          prc.cblks.assign(ncb, Cblk());
          for (uint32_t k = 0; k < ncb; ++k) {
            Cblk& cb = prc.cblks[k];
            int32_t bx0 = cx0 + static_cast<int32_t>(k % prc.cw) * (1 << cbw);
            int32_t by0 = cy0 + static_cast<int32_t>(k / prc.cw) * (1 << cbh);
            cb.x0 = std::max(bx0, prc.x0), cb.y0 = std::max(by0, prc.y0);
            cb.x1 = std::min(bx0 + (1 << cbw), prc.x1), cb.y1 = std::min(by0 + (1 << cbh), prc.y1);
          }
          prc.incl.init(prc.cw, prc.ch);
          prc.imsb.init(prc.cw, prc.ch);
        }
      }
    }
  }
}

// ------------------------------------------------------------------- t2 ----

void init_seg(Cblk& cb, uint32_t index, uint32_t cblksty, bool first) {
  if (cb.segs.size() < index + 1) cb.segs.resize(index + 1);
  Seg& seg = cb.segs[index];
  seg = Seg();
  if (cblksty & CBLK_TERMALL) {
    seg.maxpasses = 1;
  } else if (cblksty & CBLK_LAZY) {
    if (first) {
      seg.maxpasses = 10;
    } else {
      uint32_t prev = cb.segs[index - 1].maxpasses;
      seg.maxpasses = (prev == 1 || prev == 10) ? 2 : 1;
    }
  } else {
    seg.maxpasses = 109;
  }
}

uint32_t floorlog2(uint32_t a) {
  uint32_t l = 0;
  while (a > 1) a >>= 1, ++l;
  return l;
}

// opj_t2_decode_packets over one tile's data.
void t2_decode(Codestream& cs, Tcp& tcp, Tile& tile) {
  const uint8_t* src = tcp.data.data();
  uint32_t max_len = static_cast<uint32_t>(tcp.data.size());
  const uint8_t* cur = src;
  // PPT data of this tile (opj_j2k_merge_ppt)
  std::vector<uint8_t> ppt;
  for (auto& kv : tcp.ppt_markers) ppt.insert(ppt.end(), kv.second.begin(), kv.second.end());
  size_t ppt_pos = 0;
  iterate_packets(cs, tcp, tile, [&](uint32_t compno, uint32_t resno, uint32_t precno, uint32_t layno) {
    Res& res = tile.comps[compno].res[resno];
    const uint32_t cblksty = tcp.tccps[compno].cblksty;
    if (cblksty & CBLK_HT) queued("HTJ2K code-blocks");
    // -- opj_t2_read_packet_header
    if (layno == 0) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        if (precno >= band.precincts.size()) corrupt("Invalid precinct");
        Precinct& prc = band.precincts[precno];
        prc.incl.reset();
        prc.imsb.reset();
        for (auto& cb : prc.cblks) cb.numsegs = 0, cb.real_num_segs = 0;
      }
    }
    uint32_t avail = max_len - static_cast<uint32_t>(cur - src);
    if (tcp.csty & CSTY_SOP) {
      if (avail >= 6 && cur[0] == 0xFF && cur[1] == 0x91) cur += 6;
    }
    const uint8_t* hdr;
    uint32_t hdr_len;
    if (cs.ppm) {
      hdr = cs.ppm_data.data() + cs.ppm_pos, hdr_len = static_cast<uint32_t>(cs.ppm_data.size() - cs.ppm_pos);
    } else if (tcp.ppt) {
      hdr = ppt.data() + ppt_pos, hdr_len = static_cast<uint32_t>(ppt.size() - ppt_pos);
    } else {
      hdr = cur, hdr_len = static_cast<uint32_t>(src + max_len - cur);
    }
    Bio bio(hdr, hdr_len);
    bool present = bio.read(1);
    if (present) {
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        if (band.empty()) continue;
        Precinct& prc = band.precincts[precno];
        for (uint32_t k = 0; k < prc.cblks.size(); ++k) {
          Cblk& cb = prc.cblks[k];
          uint32_t included = !cb.numsegs ? tgt_decode(bio, prc.incl, k, static_cast<int32_t>(layno + 1)) : bio.read(1);
          if (!included) {
            cb.numnewpasses = 0;
            continue;
          }
          if (!cb.numsegs) {
            uint32_t i = 0;
            while (!tgt_decode(bio, prc.imsb, k, static_cast<int32_t>(i))) ++i;
            cb.numbps = static_cast<uint32_t>(band.numbps) + 1 - i;
            cb.numlenbits = 3;
          }
          // opj_t2_getnumpasses
          uint32_t np;
          if (!bio.read(1)) {
            np = 1;
          } else if (!bio.read(1)) {
            np = 2;
          } else if ((np = bio.read(2)) != 3) {
            np = 3 + np;
          } else if ((np = bio.read(5)) != 31) {
            np = 6 + np;
          } else {
            np = 37 + bio.read(7);
          }
          cb.numnewpasses = np;
          uint32_t inc = 0;
          while (bio.read(1)) ++inc;
          cb.numlenbits += inc;
          uint32_t segno = 0;
          if (!cb.numsegs) {
            init_seg(cb, 0, cblksty, true);
          } else {
            segno = cb.numsegs - 1;
            if (cb.segs[segno].numpasses == cb.segs[segno].maxpasses) init_seg(cb, ++segno, cblksty, false);
          }
          int32_t n = static_cast<int32_t>(cb.numnewpasses);
          do {
            Seg& seg = cb.segs[segno];
            seg.numnewpasses =
                static_cast<uint32_t>(std::min<int32_t>(static_cast<int32_t>(seg.maxpasses - seg.numpasses), n));
            uint32_t bits = cb.numlenbits + floorlog2(seg.numnewpasses);
            if (bits > 32) corrupt("Invalid bit number in opj_t2_read_packet_header()");
            seg.newlen = bio.read(bits);
            n -= static_cast<int32_t>(seg.numnewpasses);
            if (n > 0) init_seg(cb, ++segno, cblksty, false);
          } while (n > 0);
        }
      }
      if (!bio.inalign()) corrupt("packet header runs past the data");
    } else {
      bio.inalign();
    }
    const uint8_t* h = hdr + bio.numbytes();
    if (tcp.csty & CSTY_EPH) {  // required (an SOP marker only warned about)
      if (hdr_len - static_cast<uint32_t>(h - hdr) < 2) corrupt("Not enough space for required EPH marker");
      if (h[0] != 0xFF || h[1] != 0x92) corrupt("Expected EPH marker");
      h += 2;
    }
    uint32_t header_length = static_cast<uint32_t>(h - hdr);
    if (cs.ppm) {
      cs.ppm_pos += header_length;
    } else if (tcp.ppt) {
      ppt_pos += header_length;
    } else {
      cur += header_length;
    }
    Comp& ic = cs.comps[compno];
    ic.resno_decoded = std::max(resno, ic.resno_decoded);
    if (!present) return;
    // -- opj_t2_read_packet_data
    const uint8_t* data_end = src + max_len;
    for (uint32_t b = 0; b < res.numbands; ++b) {
      Band& band = res.bands[b];
      if (band.empty()) continue;
      Precinct& prc = band.precincts[precno];
      for (auto& cb : prc.cblks) {
        if (!cb.numnewpasses) continue;
        size_t si;
        if (!cb.numsegs) {
          si = 0;
          ++cb.numsegs;
        } else {
          si = cb.numsegs - 1;
          if (cb.segs[si].numpasses == cb.segs[si].maxpasses) {
            ++si;
            ++cb.numsegs;
          }
        }
        do {
          Seg& seg = cb.segs[si];
          if (seg.newlen > static_cast<uint32_t>(data_end - cur))
            corrupt("read: segment too long");
          cb.chunks.push_back({cur, seg.newlen});
          cur += seg.newlen;
          seg.len += seg.newlen;
          seg.numpasses += seg.numnewpasses;
          cb.numnewpasses -= seg.numnewpasses;
          seg.real_num_passes = seg.numpasses;
          if (cb.numnewpasses > 0) {
            ++si;
            ++cb.numsegs;
          }
        } while (cb.numnewpasses > 0);
        cb.real_num_segs = cb.numsegs;
      }
    }
  });
}

// ------------------------------------------------------------ mqc / t1 ----

// The MQ coder's states (ISO 15444-1 Table C.2): Qe, next on MPS, next on
// LPS, switch.
const uint16_t kQe[47] = {0x5601, 0x3401, 0x1801, 0x0ac1, 0x0521, 0x0221, 0x5601, 0x5401, 0x4801, 0x3801,
                          0x3001, 0x2401, 0x1c01, 0x1601, 0x5601, 0x5401, 0x5101, 0x4801, 0x3801, 0x3401,
                          0x3001, 0x2801, 0x2401, 0x2201, 0x1c01, 0x1801, 0x1601, 0x1401, 0x1201, 0x1101,
                          0x0ac1, 0x09c1, 0x08a1, 0x0521, 0x0441, 0x02a1, 0x0221, 0x0141, 0x0111, 0x0085,
                          0x0049, 0x0025, 0x0015, 0x0009, 0x0005, 0x0001, 0x5601};
const uint8_t kNmps[47] = {1,  2,  3,  4,  5,  38, 7,  8,  9,  10, 11, 12, 13, 29, 15, 16,
                           17, 18, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32,
                           33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 45, 46};
const uint8_t kNlps[47] = {1,  6,  9,  12, 29, 33, 6,  14, 14, 14, 17, 18, 20, 21, 14, 14,
                           15, 16, 17, 18, 19, 19, 20, 21, 22, 23, 24, 25, 26, 27, 28, 29,
                           30, 31, 32, 33, 34, 35, 36, 37, 38, 39, 40, 41, 42, 43, 46};
const uint8_t kSwitch[47] = {1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                             0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0};

constexpr int CTX_ZC = 0, CTX_SC = 9, CTX_MAG = 14, CTX_AGG = 17, CTX_UNI = 18, NUM_CTX = 19;

// mqc.c's decoder over one segment, which OpenJPEG ends with two 0xFF bytes
// (past them it never reads).
struct Mqc {
  const uint8_t* seg;
  uint32_t len, bp = 0;
  uint32_t a = 0, c = 0, ct = 0;
  uint8_t state[NUM_CTX], mps[NUM_CTX];

  uint32_t byte(uint32_t i) const { return i < len ? seg[i] : 0xFF; }

  void reset_states() {
    memset(state, 0, sizeof state);
    memset(mps, 0, sizeof mps);
    state[CTX_UNI] = 46;
    state[CTX_AGG] = 3;
    state[CTX_ZC] = 4;
  }
  void bytein() {
    uint32_t next = byte(bp + 1);
    if (byte(bp) == 0xFF) {
      if (next > 0x8F) {
        c += 0xFF00;
        ct = 8;
      } else {
        ++bp;
        c += next << 9;
        ct = 7;
      }
    } else {
      ++bp;
      c += next << 8;
      ct = 8;
    }
  }
  void init(const uint8_t* p, uint32_t n) {
    seg = p, len = n, bp = 0;
    c = byte(0) << 16;
    bytein();
    c <<= 7;
    ct -= 7;
    a = 0x8000;
  }
  void renorm() {
    do {
      if (ct == 0) bytein();
      a <<= 1;
      c <<= 1;
      --ct;
    } while (a < 0x8000);
  }
  uint32_t decode(int cx) {
    uint32_t s = state[cx], qe = kQe[s], d;
    a -= qe;
    if ((c >> 16) < qe) {
      if (a < qe) {
        a = qe;
        d = mps[cx];
        state[cx] = kNmps[s];
      } else {
        a = qe;
        d = 1 - mps[cx];
        if (kSwitch[s]) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
        state[cx] = kNlps[s];
      }
      renorm();
    } else {
      c -= qe << 16;
      if ((a & 0x8000) == 0) {
        if (a < qe) {
          d = 1 - mps[cx];
          if (kSwitch[s]) mps[cx] = static_cast<uint8_t>(1 - mps[cx]);
          state[cx] = kNlps[s];
        } else {
          d = mps[cx];
          state[cx] = kNmps[s];
        }
        renorm();
      } else {
        d = mps[cx];
      }
    }
    return d;
  }
  // opj_mqc_raw_init_dec / opj_mqc_raw_decode (bypass)
  void raw_init(const uint8_t* p, uint32_t n) {
    seg = p, len = n, bp = 0;
    c = 0;
    ct = 0;
  }
  uint32_t raw() {
    if (ct == 0) {
      if (c == 0xFF) {
        if (byte(bp) > 0x8F) {
          c = 0xFF;
          ct = 8;
        } else {
          c = byte(bp);
          ++bp;
          ct = 7;
        }
      } else {
        c = byte(bp);
        ++bp;
        ct = 8;
      }
    }
    --ct;
    return (c >> ct) & 1;
  }
};

// One code-block's decoding (t1.c opj_t1_decode_cblk): the three passes over
// a flag plane with a border of one sample.
class T1 {
 public:
  std::vector<int32_t> data;
  uint32_t w = 0, h = 0;

  bool decode(const Cblk& cb, uint32_t orient, uint32_t roishift, uint32_t cblksty) {
    w = static_cast<uint32_t>(cb.x1 - cb.x0), h = static_cast<uint32_t>(cb.y1 - cb.y0);
    data.assign(size_t(w) * h, 0);
    fs_ = w + 2;
    flags_.assign(size_t(fs_) * (h + 2), 0);
    orient_ = orient;
    vsc_ = (cblksty & CBLK_VSC) != 0;
    int32_t bpno_plus_one = static_cast<int32_t>(roishift + cb.numbps);
    if (bpno_plus_one >= 31) return false;  // "unsupported bpno_plus_one"
    uint32_t passtype = 2;
    mq_.reset_states();
    if (cb.chunks.empty()) return true;
    std::vector<uint8_t> buf;
    for (auto& ch : cb.chunks) buf.insert(buf.end(), ch.first, ch.first + ch.second);
    uint32_t index = 0;
    for (uint32_t segno = 0; segno < cb.real_num_segs; ++segno) {
      const Seg& seg = cb.segs[segno];
      bool raw = bpno_plus_one <= static_cast<int32_t>(cb.numbps) - 4 && passtype < 2 && (cblksty & CBLK_LAZY);
      const uint8_t* p = buf.data() + index;
      if (raw) {
        mq_.raw_init(p, seg.len);
      } else {
        mq_.init(p, seg.len);
      }
      index += seg.len;
      for (uint32_t pass = 0; pass < seg.real_num_passes && bpno_plus_one >= 1; ++pass) {
        if (passtype == 0) {
          sigpass(bpno_plus_one, raw);
        } else if (passtype == 1) {
          refpass(bpno_plus_one, raw);
        } else {
          clnpass(bpno_plus_one, (cblksty & CBLK_SEGSYM) != 0);
        }
        if ((cblksty & CBLK_RESET) && !raw) mq_.reset_states();
        if (++passtype == 3) {
          passtype = 0;
          --bpno_plus_one;
        }
      }
    }
    return true;
  }

 private:
  enum { SIG = 1, NEG = 2, VISIT = 4, REFINED = 8 };
  std::vector<uint8_t> flags_;
  uint32_t fs_ = 0, orient_ = 0;
  bool vsc_ = false;
  Mqc mq_;

  uint8_t* fl(uint32_t x, uint32_t y) { return &flags_[size_t(y + 1) * fs_ + x + 1]; }
  // the south row is hidden from a stripe's last row under VSC
  bool south_hidden(uint32_t y) const { return vsc_ && (y & 3) == 3; }

  uint32_t zc_ctx(uint32_t x, uint32_t y) {
    const uint8_t* f = fl(x, y);
    const uint8_t* n = f - fs_;
    const uint8_t* s = f + fs_;
    bool hs = south_hidden(y);
    uint32_t hh = (f[-1] & SIG) + (f[1] & SIG);
    uint32_t vv = (n[0] & SIG) + (hs ? 0 : (s[0] & SIG));
    uint32_t dd = (n[-1] & SIG) + (n[1] & SIG) + (hs ? 0 : (s[-1] & SIG) + (s[1] & SIG));
    uint32_t ctx;
    if (orient_ == 3) {
      uint32_t hv = hh + vv;
      if (dd == 0) {
        ctx = hv == 0 ? 0 : hv == 1 ? 1 : 2;
      } else if (dd == 1) {
        ctx = hv == 0 ? 3 : hv == 1 ? 4 : 5;
      } else if (dd == 2) {
        ctx = hv == 0 ? 6 : 7;
      } else {
        ctx = 8;
      }
    } else {
      if (orient_ == 1) std::swap(hh, vv);
      if (hh == 0) {
        ctx = vv == 0 ? (dd == 0 ? 0 : dd == 1 ? 1 : 2) : vv == 1 ? 3 : 4;
      } else if (hh == 1) {
        ctx = vv == 0 ? (dd == 0 ? 5 : 6) : 7;
      } else {
        ctx = 8;
      }
    }
    return CTX_ZC + ctx;
  }
  bool any_neighbour(uint32_t x, uint32_t y) {
    const uint8_t* f = fl(x, y);
    const uint8_t* n = f - fs_;
    const uint8_t* s = f + fs_;
    uint32_t v = (f[-1] | f[1] | n[-1] | n[0] | n[1]) & SIG;
    if (!south_hidden(y)) v |= (s[-1] | s[0] | s[1]) & SIG;
    return v != 0;
  }
  static int contrib(uint8_t f) { return (f & SIG) ? ((f & NEG) ? -1 : 1) : 0; }
  // sign context and its XOR bit (t1_init_ctxno_sc / t1_init_spb)
  void sc_ctx(uint32_t x, uint32_t y, int* ctx, uint32_t* spb) {
    const uint8_t* f = fl(x, y);
    uint8_t s = south_hidden(y) ? 0 : f[fs_];
    auto clampsum = [](uint8_t a, uint8_t b) {
      int pos = std::min(((a & (SIG | NEG)) == SIG) + ((b & (SIG | NEG)) == SIG), 1);
      int neg = std::min(((a & (SIG | NEG)) == (SIG | NEG)) + ((b & (SIG | NEG)) == (SIG | NEG)), 1);
      return pos - neg;
    };
    int hc = clampsum(f[1], f[-1]), vc = clampsum(f[-static_cast<int>(fs_)], s);
    *spb = (!hc && !vc) ? 0 : !(hc > 0 || (!hc && vc > 0));
    if (hc < 0) hc = -hc, vc = -vc;
    int n;
    if (!hc) {
      n = vc == 0 ? 0 : 1;
    } else {
      n = vc == -1 ? 2 : vc == 0 ? 3 : 4;
    }
    *ctx = CTX_SC + n;
  }
  void set_sig(uint32_t x, uint32_t y, uint32_t neg, int32_t oneplushalf) {
    *fl(x, y) |= SIG | (neg ? NEG : 0);
    data[size_t(y) * w + x] = neg ? -oneplushalf : oneplushalf;
  }
  void decode_sign(uint32_t x, uint32_t y, int32_t oneplushalf) {
    int ctx;
    uint32_t spb;
    sc_ctx(x, y, &ctx, &spb);
    set_sig(x, y, mq_.decode(ctx) ^ spb, oneplushalf);
  }

  void sigpass(int32_t bpno, bool raw) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (uint32_t k = 0; k < h; k += 4)
      for (uint32_t x = 0; x < w; ++x)
        for (uint32_t y = k; y < std::min(k + 4, h); ++y) {
          uint8_t& f = *fl(x, y);
          if ((f & (SIG | VISIT)) || !any_neighbour(x, y)) continue;
          if (raw) {
            if (mq_.raw()) set_sig(x, y, mq_.raw(), oneplushalf);
          } else if (mq_.decode(zc_ctx(x, y))) {
            decode_sign(x, y, oneplushalf);
          }
          f |= VISIT;
        }
  }
  void refpass(int32_t bpno, bool raw) {
    const int32_t poshalf = (1 << bpno) >> 1;
    for (uint32_t k = 0; k < h; k += 4)
      for (uint32_t x = 0; x < w; ++x)
        for (uint32_t y = k; y < std::min(k + 4, h); ++y) {
          uint8_t& f = *fl(x, y);
          if ((f & (SIG | VISIT)) != SIG) continue;
          uint32_t v;
          if (raw) {
            v = mq_.raw();
          } else {
            int ctx = (f & REFINED) ? CTX_MAG + 2 : any_neighbour(x, y) ? CTX_MAG + 1 : CTX_MAG;
            v = mq_.decode(ctx);
          }
          int32_t& d = data[size_t(y) * w + x];
          d += (v ^ (d < 0 ? 1u : 0u)) ? poshalf : -poshalf;
          f |= REFINED;
        }
  }
  void clnpass(int32_t bpno, bool segsym) {
    const int32_t one = 1 << bpno, oneplushalf = one | (one >> 1);
    for (uint32_t k = 0; k < h; k += 4)
      for (uint32_t x = 0; x < w; ++x) {
        uint32_t y = k, y_end = std::min(k + 4, h);
        if (y_end - k == 4) {
          bool run = true;
          for (uint32_t j = k; j < y_end && run; ++j)
            if ((*fl(x, j) & (SIG | VISIT)) || any_neighbour(x, j)) run = false;
          if (run) {
            if (!mq_.decode(CTX_AGG)) {
              for (uint32_t j = k; j < y_end; ++j) *fl(x, j) &= ~VISIT;
              continue;
            }
            uint32_t runlen = mq_.decode(CTX_UNI);
            runlen = (runlen << 1) | mq_.decode(CTX_UNI);
            y = k + runlen;
            decode_sign(x, y, oneplushalf);
            ++y;
          }
        }
        for (; y < y_end; ++y) {
          uint8_t f = *fl(x, y);
          if (f & (SIG | VISIT)) continue;
          if (mq_.decode(zc_ctx(x, y))) decode_sign(x, y, oneplushalf);
        }
        for (uint32_t j = k; j < y_end; ++j) *fl(x, j) &= ~VISIT;
      }
    if (segsym)
      for (int i = 0; i < 4; ++i) mq_.decode(CTX_UNI);
  }
};

// ------------------------------------------------------------------ dwt ----

inline int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

// One 5/3 line (dwt.c opj_idwt53_h / _v): `in` holds sn low then dn high
// coefficients; `out` the len samples.
void idwt53_line(const int32_t* in, int32_t sn, int32_t dn, int cas, int32_t* out) {
  const int32_t len = sn + dn;
  if (cas == 0) {
    if (len <= 1) {
      if (len == 1) out[0] = in[0];
      return;
    }
    const int32_t* L = in;
    const int32_t* H = in + sn;
    // even samples: L[i] - ((H[i-1] + H[i] + 2) >> 2), H[-1] = H[0], H[dn] = H[dn-1]
    for (int32_t i = 0; i < sn; ++i) {
      int32_t hl = H[i > 0 ? i - 1 : 0], hr = H[i < dn ? i : dn - 1];
      out[2 * i] = L[i] - ((hl + hr + 2) >> 2);
    }
    for (int32_t i = 0; i < dn; ++i) {
      int32_t sl = out[2 * i], sr = 2 * i + 2 < len ? out[2 * i + 2] : out[2 * i];
      out[2 * i + 1] = wrap_add(H[i], wrap_add(sl, sr) >> 1);
    }
  } else {
    if (len == 1) {
      out[0] = in[0] / 2;
      return;
    }
    if (len == 0) return;
    const int32_t* L = in;  // at odd positions
    const int32_t* H = in + sn;  // at even positions
    for (int32_t i = 0; i < sn; ++i) {
      int32_t hl = H[i], hr = i + 1 < dn ? H[i + 1] : H[dn - 1];
      out[2 * i + 1] = L[i] - ((hl + hr + 2) >> 2);
    }
    for (int32_t i = 0; i < dn; ++i) {
      int32_t dl = i > 0 ? out[2 * i - 1] : out[1], dr = 2 * i + 1 < len ? out[2 * i + 1] : out[2 * i - 1];
      out[2 * i] = wrap_add(H[i], wrap_add(dl, dr) >> 1);
    }
  }
}

// One 9/7 line (dwt.c opj_v8dwt_decode, per element): `x` is the
// interleaved line, lows at cas, cas + 2, ...
constexpr float kDwtAlpha = -1.586134342f, kDwtBeta = -0.052980118f, kDwtGamma = 0.882911075f,
                kDwtDelta = 0.443506852f, kDwtK = 1.230174105f, kTwoInvK = 1.625732422f;

void v8_step1(float* w, int32_t n, float c) {
  for (int32_t i = 0; i < n; ++i) w[2 * i] = w[2 * i] * c;
}
void v8_step2(float* l, float* w, uint32_t end, uint32_t m, float c) {
  float* fl = l;
  float* fw = w;
  uint32_t imax = std::min(end, m);
  for (uint32_t i = 0; i < imax; ++i) {
    fw[-1] = fw[-1] + (fl[0] + fw[0]) * c;
    fl = fw;
    fw += 2;
  }
  if (m < end) {
    c += c;
    fw[-1] = fw[-1] + fl[0] * c;
  }
}
void idwt97_line(float* x, int32_t sn, int32_t dn, int cas) {
  int32_t a, b;
  if (cas == 0) {
    if (!(dn > 0 || sn > 1)) return;
    a = 0, b = 1;
  } else {
    if (!(sn > 0 || dn > 1)) return;
    a = 1, b = 0;
  }
  v8_step1(x + a, sn, kDwtK);
  v8_step1(x + b, dn, kTwoInvK);
  v8_step2(x + b, x + a + 1, static_cast<uint32_t>(sn), static_cast<uint32_t>(std::min(sn, dn - a)), -kDwtDelta);
  v8_step2(x + a, x + b + 1, static_cast<uint32_t>(dn), static_cast<uint32_t>(std::min(dn, sn - b)), -kDwtGamma);
  v8_step2(x + b, x + a + 1, static_cast<uint32_t>(sn), static_cast<uint32_t>(std::min(sn, dn - a)), -kDwtBeta);
  v8_step2(x + a, x + b + 1, static_cast<uint32_t>(dn), static_cast<uint32_t>(std::min(dn, sn - b)), -kDwtAlpha);
}

// opj_dwt_decode / opj_dwt_decode_real over `numres` resolutions.
void idwt(TileComp& tc, uint32_t numres, bool reversible) {
  const Res& top = tc.res[tc.numres - 1];
  const size_t stride = static_cast<size_t>(top.x1 - top.x0);
  int32_t* d = tc.data.data();
  size_t cap = 16;
  for (const Res& r : tc.res) cap = std::max<size_t>(cap, std::max(r.x1 - r.x0, r.y1 - r.y0) + 16);
  std::vector<int32_t> in(cap), out(cap);
  std::vector<float> xf(cap);
  for (uint32_t r = 1; r < numres; ++r) {
    const Res& pr = tc.res[r - 1];
    const Res& cr = tc.res[r];
    int32_t rw = cr.x1 - cr.x0, rh = cr.y1 - cr.y0;
    int32_t snh = pr.x1 - pr.x0, snv = pr.y1 - pr.y0;
    int cash = cr.x0 % 2, casv = cr.y0 % 2;
    int32_t dnh = rw - snh, dnv = rh - snv;
    for (int32_t y = 0; y < rh; ++y) {
      int32_t* row = d + y * stride;
      if (reversible) {
        std::copy(row, row + rw, in.begin());
        idwt53_line(in.data(), snh, dnh, cash, out.data());
        std::copy(out.begin(), out.begin() + rw, row);
      } else {
        std::fill(xf.begin(), xf.end(), 0.0f);
        for (int32_t i = 0; i < snh; ++i) xf[cash + 2 * i] = as_float(row[i]);
        for (int32_t i = 0; i < dnh; ++i) xf[1 - cash + 2 * i] = as_float(row[snh + i]);
        idwt97_line(xf.data(), snh, dnh, cash);
        for (int32_t i = 0; i < rw; ++i) row[i] = as_int(xf[i]);
      }
    }
    for (int32_t x = 0; x < rw; ++x) {
      int32_t* col = d + x;
      if (reversible) {
        for (int32_t i = 0; i < rh; ++i) in[i] = col[i * stride];
        idwt53_line(in.data(), snv, dnv, casv, out.data());
        for (int32_t i = 0; i < rh; ++i) col[i * stride] = out[i];
      } else {
        std::fill(xf.begin(), xf.end(), 0.0f);
        for (int32_t i = 0; i < snv; ++i) xf[casv + 2 * i] = as_float(col[i * stride]);
        for (int32_t i = 0; i < dnv; ++i) xf[1 - casv + 2 * i] = as_float(col[(snv + i) * stride]);
        idwt97_line(xf.data(), snv, dnv, casv);
        for (int32_t i = 0; i < rh; ++i) col[i * stride] = as_int(xf[i]);
      }
    }
  }
}

// ------------------------------------------------------------ one tile ----

// opj_tcd_decode_tile + opj_tcd_update_tile_data over a tile `init_tile`
// laid out: the tile's components, each at its decoded resolution, as 1, 2
// or 4-byte samples one after another.
std::vector<uint8_t> decode_tile(Codestream& cs, uint32_t tileno, Tile& tile) {
  Tcp& tcp = cs.tcps[tileno];
  for (size_t c = 0; c < tile.comps.size(); ++c) {
    TileComp& tc = tile.comps[c];
    const Res& top = tc.res[tc.numres - 1];
    tc.data.assign(size_t(top.x1 - top.x0) * size_t(top.y1 - top.y0), 0);
  }
  t2_decode(cs, tcp, tile);
  // t1 + dequantization
  T1 t1;
  for (size_t c = 0; c < tile.comps.size(); ++c) {
    TileComp& tc = tile.comps[c];
    const Tccp& tccp = tcp.tccps[c];
    const size_t tile_w = static_cast<size_t>(tc.res[tc.numres - 1].x1 - tc.res[tc.numres - 1].x0);
    for (uint32_t r = 0; r < tc.numres; ++r) {
      Res& res = tc.res[r];
      for (uint32_t b = 0; b < res.numbands; ++b) {
        Band& band = res.bands[b];
        for (auto& prc : band.precincts)
          for (auto& cb : prc.cblks) {
            if (!t1.decode(cb, band.bandno, tccp.roishift, tccp.cblksty)) corrupt("code-block bit-planes past 30");
            int32_t x = cb.x0 - band.x0, y = cb.y0 - band.y0;
            if (band.bandno & 1) x += tc.res[r - 1].x1 - tc.res[r - 1].x0;
            if (band.bandno & 2) y += tc.res[r - 1].y1 - tc.res[r - 1].y0;
            std::vector<int32_t>& dp = t1.data;
            if (tccp.roishift) {
              if (tccp.roishift >= 31) {
                std::fill(dp.begin(), dp.end(), 0);
              } else {
                int32_t thresh = 1 << tccp.roishift;
                for (auto& v : dp) {
                  int32_t mag = v < 0 ? -v : v;
                  if (mag >= thresh) {
                    mag >>= tccp.roishift;
                    v = v < 0 ? -mag : mag;
                  }
                }
              }
            }
            int32_t* tiled = tc.data.data() + size_t(y) * tile_w + x;
            if (tccp.qmfbid == 1) {
              for (uint32_t j = 0; j < t1.h; ++j)
                for (uint32_t i = 0; i < t1.w; ++i) tiled[j * tile_w + i] = dp[size_t(j) * t1.w + i] / 2;
            } else {
              const float step = 0.5f * band.stepsize;
              for (uint32_t j = 0; j < t1.h; ++j)
                for (uint32_t i = 0; i < t1.w; ++i)
                  tiled[j * tile_w + i] = as_int(static_cast<float>(dp[size_t(j) * t1.w + i]) * step);
            }
          }
      }
    }
  }
  for (size_t c = 0; c < tile.comps.size(); ++c)
    idwt(tile.comps[c], cs.comps[c].resno_decoded + 1, tcp.tccps[c].qmfbid == 1);
  // mct
  if (tcp.mct && tile.comps.size() >= 3) {
    auto area = [&](size_t c) {
      const Res& r = tile.comps[c].res[tile.comps[c].numres - 1];
      return size_t(r.x1 - r.x0) * size_t(r.y1 - r.y0);
    };
    size_t n = area(0);
    if (tile.comps[1].numres != tile.comps[0].numres || tile.comps[2].numres != tile.comps[0].numres)
      corrupt("Tiles don't all have the same dimension. Skip the MCT step.");
    const uint32_t r0 = cs.comps[0].resno_decoded;
    if (r0 != cs.comps[1].resno_decoded || r0 != cs.comps[2].resno_decoded || area(1) != n || area(2) != n)
      corrupt("Tiles don't all have the same dimension. Skip the MCT step.");
    int32_t* c0 = tile.comps[0].data.data();
    int32_t* c1 = tile.comps[1].data.data();
    int32_t* c2 = tile.comps[2].data.data();
    if (tcp.tccps[0].qmfbid == 1) {
      for (size_t i = 0; i < n; ++i) {
        int32_t y = c0[i], u = c1[i], v = c2[i];
        int32_t g = y - ((u + v) >> 2);
        int32_t r = v + g, b = u + g;
        c0[i] = r, c1[i] = g, c2[i] = b;
      }
    } else {
      for (size_t i = 0; i < n; ++i) {
        float y = as_float(c0[i]), u = as_float(c1[i]), v = as_float(c2[i]);
        float r = y + (v * 1.402f);
        float g = y - (u * 0.34413f) - (v * (0.71414f));
        float b = y + (u * 1.772f);
        c0[i] = as_int(r), c1[i] = as_int(g), c2[i] = as_int(b);
      }
    }
  }
  // dc level shift, then the decoded resolution into 1, 2 or 4-byte samples
  std::vector<uint8_t> out;
  for (size_t c = 0; c < tile.comps.size(); ++c) {
    TileComp& tc = tile.comps[c];
    const Comp& ic = cs.comps[c];
    const Res& r = tc.res[ic.resno_decoded];
    const Res& top = tc.res[tc.numres - 1];
    const size_t stride = static_cast<size_t>(top.x1 - top.x0);
    const size_t w = static_cast<size_t>(r.x1 - r.x0), h = static_cast<size_t>(r.y1 - r.y0);
    int32_t lo, hi;
    if (ic.sgnd) {
      lo = -(1 << (ic.prec - 1)), hi = (1 << (ic.prec - 1)) - 1;
    } else {
      lo = 0, hi = static_cast<int32_t>((1u << ic.prec) - 1);
    }
    const int32_t shift = ic.sgnd ? 0 : 1 << (ic.prec - 1);
    const bool rev = tcp.tccps[c].qmfbid == 1;
    size_t csize = (ic.prec + 7) >> 3;
    if (csize == 3) csize = 4;
    size_t base = out.size();
    out.resize(base + w * h * csize);
    uint8_t* o = out.data() + base;
    for (size_t y = 0; y < h; ++y)
      for (size_t x = 0; x < w; ++x) {
        int32_t v = tc.data[y * stride + x];
        if (rev) {
          v = std::min(std::max(wrap_add(v, shift), lo), hi);
        } else {
          float f = as_float(v);
          if (f > static_cast<float>(INT32_MAX)) {
            v = hi;
          } else if (f < static_cast<float>(INT32_MIN)) {
            v = lo;
          } else {
            int64_t vi = static_cast<int64_t>(lrintf(f)) + shift;
            v = static_cast<int32_t>(std::min<int64_t>(std::max<int64_t>(vi, lo), hi));
          }
        }
        if (csize == 1) {
          *o++ = static_cast<uint8_t>(v);
        } else if (csize == 2) {
          uint16_t s = static_cast<uint16_t>(v);
          memcpy(o, &s, 2);
          o += 2;
        } else {
          memcpy(o, &v, 4);
          o += 4;
        }
      }
  }
  return out;
}

// -------------------------------------------------------- Pillow's side ----

// Jpeg2KDecode.c's unpackers (by mode, colour space, components, whether
// they take sub-sampled components).
enum Unpacker {
  U_NONE, U_GRAY_L, U_GRAY_I, U_GRAYA_LA, U_GRAY_RGB, U_SRGB_RGB, U_SYCC_RGB, U_SRGBA_RGBA, U_SYCCA_RGBA
};

Unpacker find_unpacker(Mode mode, ColorSpace cs, uint32_t nc, int subsampling) {
  struct Row {
    Mode mode;
    ColorSpace cs;
    uint32_t nc;
    bool sub;
    Unpacker u;
  };
  static const Row rows[] = {
      {M_L, CS_GRAY, 1, false, U_GRAY_L},        {M_P, CS_SRGB, 1, false, U_GRAY_L},
      {M_PA, CS_SRGB, 2, false, U_GRAYA_LA},     {M_I16, CS_GRAY, 1, false, U_GRAY_I},
      {M_LA, CS_GRAY, 2, false, U_GRAYA_LA},     {M_RGB, CS_GRAY, 1, false, U_GRAY_RGB},
      {M_RGB, CS_GRAY, 2, false, U_GRAY_RGB},    {M_RGB, CS_SRGB, 3, true, U_SRGB_RGB},
      {M_RGB, CS_SYCC, 3, true, U_SYCC_RGB},     {M_RGB, CS_SRGB, 4, true, U_SRGB_RGB},
      {M_RGB, CS_SYCC, 4, true, U_SYCC_RGB},     {M_RGBA, CS_GRAY, 1, false, U_GRAY_RGB},
      {M_RGBA, CS_GRAY, 2, false, U_GRAYA_LA},   {M_RGBA, CS_SRGB, 3, true, U_SRGB_RGB},
      {M_RGBA, CS_SYCC, 3, true, U_SYCC_RGB},    {M_RGBA, CS_SRGB, 4, true, U_SRGBA_RGBA},
      {M_RGBA, CS_SYCC, 4, true, U_SYCCA_RGBA},  {M_CMYK, CS_CMYK, 4, true, U_SRGBA_RGBA},
  };
  for (const Row& r : rows)
    if (r.cs == cs && r.nc == nc && (r.sub || subsampling == -1) && r.mode == mode) return r.u;
  return U_NONE;
}

// Pillow's ConvertYCbCr.c tables (SCALE 6), as its generator rounds them.
struct YccTables {
  int32_t r_cr[256], g_cb[256], g_cr[256], b_cb[256];
  YccTables() {
    for (int i = 0; i < 256; ++i) {
      r_cr[i] = static_cast<int32_t>(1.402 * 64 * (i - 128) + 0.5);
      g_cb[i] = static_cast<int32_t>(-0.34414 * 64 * (i - 128) + 0.5);
      g_cr[i] = static_cast<int32_t>(-0.71414 * 64 * (i - 128) + 0.5);
      b_cb[i] = static_cast<int32_t>(1.772 * 64 * (i - 128) + 0.5);
    }
  }
};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v <= 0 ? 0 : v >= 255 ? 255 : v); }

// ImagingConvertYCbCr2RGB over one row of 4-byte pixels, in place
void ycbcr_to_rgb(uint8_t* row, uint32_t w) {
  static const YccTables t;
  for (uint32_t x = 0; x < w; ++x, row += 4) {
    int y = row[0], cb = row[1], cr = row[2];
    row[0] = clip8(y + (t.r_cr[cr] >> 6));
    row[1] = clip8(y + ((t.g_cb[cb] + t.g_cr[cr]) >> 6));
    row[2] = clip8(y + (t.b_cb[cb] >> 6));
  }
}

// The image Pillow fills, in its mode's storage: 1 byte (L, P), 2 (I;16) or
// 4 (the rest) per pixel.
struct PilImage {
  Mode mode;
  uint32_t w, h, bpp;
  std::vector<uint8_t> px;
  uint8_t* row(uint32_t y) { return px.data() + size_t(y) * w * bpp; }
};

struct CompFmt {
  int shift;
  uint32_t offset, csiz, dx, dy;
};

CompFmt comp_fmt(const Comp& c, int bits) {
  CompFmt f;
  f.shift = bits - static_cast<int>(c.prec);
  f.offset = c.sgnd ? 1u << (c.prec - 1) : 0;
  f.csiz = (c.prec + 7) >> 3;
  if (f.csiz == 3) f.csiz = 4;
  if (f.shift < 0) f.offset += 1u << (-f.shift - 1);
  f.dx = c.dx, f.dy = c.dy;
  return f;
}

inline uint32_t j2ku_shift(uint32_t x, int n) { return n < 0 ? x >> -n : x << n; }

inline uint32_t word_at(const uint8_t* p, uint32_t csiz, size_t i) {
  if (csiz == 1) return p[i];
  if (csiz == 2) {
    uint16_t v;
    memcpy(&v, p + 2 * i, 2);
    return v;
  }
  uint32_t v;
  memcpy(&v, p + 4 * i, 4);
  return v;
}

// One tile through its unpacker into `im` (tile coordinates relative to the
// image origin).
void unpack(Unpacker u, const std::vector<Comp>& comps, uint32_t x0, uint32_t y0, uint32_t w, uint32_t h,
            const uint8_t* data, PilImage& im) {
  if (u == U_GRAY_L || u == U_GRAY_I || u == U_GRAY_RGB) {
    CompFmt f = comp_fmt(comps[0], u == U_GRAY_I ? 16 : 8);
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* d = data + size_t(f.csiz) * y * w;
      uint8_t* row = im.row(y0 + y);
      for (uint32_t x = 0; x < w; ++x) {
        uint32_t v = j2ku_shift(f.offset + word_at(d, f.csiz, x), f.shift);
        if (u == U_GRAY_L) {
          row[x0 + x] = static_cast<uint8_t>(v);
        } else if (u == U_GRAY_I) {
          uint16_t s = static_cast<uint16_t>(v);
          memcpy(row + 2 * (x0 + x), &s, 2);
        } else {
          uint8_t* p = row + 4 * (x0 + x);
          p[0] = p[1] = p[2] = static_cast<uint8_t>(v);
          p[3] = 255;
        }
      }
    }
    return;
  }
  if (u == U_GRAYA_LA) {
    CompFmt f = comp_fmt(comps[0], 8), af = comp_fmt(comps[1], 8);
    const uint8_t* adata = data + size_t(f.csiz) * w * h;
    for (uint32_t y = 0; y < h; ++y) {
      const uint8_t* d = data + size_t(f.csiz) * y * w;
      const uint8_t* a = adata + size_t(af.csiz) * y * w;
      uint8_t* p = im.row(y0 + y) + 4 * x0;
      for (uint32_t x = 0; x < w; ++x, p += 4) {
        uint8_t v = static_cast<uint8_t>(j2ku_shift(f.offset + word_at(d, f.csiz, x), f.shift));
        p[0] = p[1] = p[2] = v;
        p[3] = static_cast<uint8_t>(j2ku_shift(af.offset + word_at(a, af.csiz, x), af.shift));
      }
    }
    return;
  }
  const uint32_t n = (u == U_SRGBA_RGBA || u == U_SYCCA_RGBA) ? 4 : 3;
  CompFmt f[4];
  const uint8_t* cdata[4];
  const uint8_t* cptr = data;
  for (uint32_t c = 0; c < n; ++c) {
    f[c] = comp_fmt(comps[c], 8);
    cdata[c] = cptr;
    cptr += size_t(f[c].csiz) * (w / f[c].dx) * (h / f[c].dy);
  }
  for (uint32_t y = 0; y < h; ++y) {
    uint8_t* row = im.row(y0 + y) + 4 * x0;
    const uint8_t* d[4];
    for (uint32_t c = 0; c < n; ++c) d[c] = cdata[c] + size_t(f[c].csiz) * (y / f[c].dy) * (w / f[c].dx);
    uint8_t* p = row;
    for (uint32_t x = 0; x < w; ++x, p += 4) {
      for (uint32_t c = 0; c < n; ++c)
        p[c] = static_cast<uint8_t>(j2ku_shift(f[c].offset + word_at(d[c], f[c].csiz, x / f[c].dx), f[c].shift));
      if (n == 3) p[3] = 0xFF;
    }
    if (u == U_SYCC_RGB || u == U_SYCCA_RGBA) ycbcr_to_rgb(row, w);
  }
}

void to_rgb(PilImage& im, const std::vector<uint8_t>& palette, uint8_t* out) {
  for (uint32_t y = 0; y < im.h; ++y) {
    const uint8_t* r = im.row(y);
    uint8_t* o = out + size_t(y) * im.w * 3;
    for (uint32_t x = 0; x < im.w; ++x, o += 3) {
      switch (im.mode) {
        case M_L:
          o[0] = o[1] = o[2] = r[x];
          break;
        case M_I16: {
          uint16_t v;
          memcpy(&v, r + 2 * x, 2);
          o[0] = o[1] = o[2] = static_cast<uint8_t>(v > 255 ? 255 : v);
          break;
        }
        case M_P:
        case M_PA: {
          uint32_t i = im.mode == M_P ? r[x] : r[4 * x];
          o[0] = palette[3 * i], o[1] = palette[3 * i + 1], o[2] = palette[3 * i + 2];
          break;
        }
        case M_LA:
          o[0] = o[1] = o[2] = r[4 * x];
          break;
        case M_CMYK:
          cmyk_to_rgb(r[4 * x], r[4 * x + 1], r[4 * x + 2], r[4 * x + 3], o);
          break;
        default:
          o[0] = r[4 * x], o[1] = r[4 * x + 1], o[2] = r[4 * x + 2];
      }
    }
  }
}

// Pillow's open: the size and mode, and the decompression-bomb limit.
Header open_header(const uint8_t* d, size_t n) {
  Header h;
  if (n >= 4 && be32(d) == 0xFF4FFF51) {
    h.jp2 = false;
    pil_parse_j2k(d, n, &h);
  } else if (n >= 12 && memcmp(d, "\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a", 12) == 0) {
    h.jp2 = true;
    pil_parse_jp2(d, n, &h);
  } else {
    corrupt("not a JPEG 2000 file");
  }
  if (h.width <= 0 || h.height <= 0) corrupt("a JPEG 2000 image of size 0");
  if (uint64_t(h.width) * uint64_t(h.height) > kMaxPixels) refused("a JPEG 2000 image past twice MAX_IMAGE_PIXELS");
  return h;
}

void decode(const uint8_t* d, size_t n, Header& h, uint8_t* out) {
  if (h.jp2) opj_read_jp2(d, n, &h);
  Codestream cs(d, n, h.cs_start, h);
  cs.read_main_header();
  const size_t nc = cs.comps.size();
  if (nc < 1 || nc > 4) refused("a JPEG 2000 of " + std::to_string(nc) + " components");
  ColorSpace space = h.jp2 ? h.color_space : CS_UNSPECIFIED;
  int subsampling = -1;
  for (size_t c = 0; c < cs.comps.size(); ++c)
    if (cs.comps[c].dx != 1 || cs.comps[c].dy != 1) {
      subsampling = static_cast<int>(c);
      break;
    }
  // Pillow's guess for a codestream without a colour space OpenJPEG names:
  // grey for 1-2 components, else sRGB, or sYCC where a component after the
  // first is sub-sampled
  if (space == CS_UNSPECIFIED || space == CS_UNKNOWN) space = nc <= 2 ? CS_GRAY : subsampling >= 1 ? CS_SYCC : CS_SRGB;
  Unpacker u = find_unpacker(h.mode, space, static_cast<uint32_t>(cs.comps.size()), subsampling);
  if (u == U_NONE) refused("a JPEG 2000 whose mode, colour space and components Pillow has no unpacker for");
  PilImage im{h.mode, static_cast<uint32_t>(h.width), static_cast<uint32_t>(h.height),
              h.mode == M_L || h.mode == M_P ? 1u : h.mode == M_I16 ? 2u : 4u, {}};
  im.px.assign(size_t(im.w) * im.h * im.bpp, 0);
  std::vector<uint8_t> buffer;
  uint64_t total_component_width = 0;
  uint32_t tileno;
  while (cs.next_tile(&tileno)) {
    // a tile whose tile-parts hold no data: opj_j2k_decode_tile fails
    if (!cs.tcps[tileno].has_data) corrupt("a tile without data");
    Tile tile;
    init_tile(cs, cs.tcps[tileno], tileno, &tile);
    uint32_t tx0 = static_cast<uint32_t>(tile.x0), ty0 = static_cast<uint32_t>(tile.y0);
    uint32_t tx1 = static_cast<uint32_t>(tile.x1), ty1 = static_cast<uint32_t>(tile.y1);
    if (tx0 >= tx1 || ty0 >= ty1 || tx0 < cs.x0 || ty0 < cs.y0 || int64_t(tx1) - cs.x0 > int64_t(im.w) ||
        int64_t(ty1) - cs.y0 > int64_t(im.h))
      corrupt("tile outside the image");
    for (const Comp& c : cs.comps) {
      uint32_t cz = (c.prec + 7) >> 3;
      total_component_width += cz == 3 ? 4 : cz;
    }
    uint64_t tile_bytes = uint64_t(tx1 - tx0) * (ty1 - ty0) * total_component_width;
    std::vector<uint8_t> data = decode_tile(cs, tileno, tile);
    // Pillow's buffer: zero-filled when it grows, else what the last tile left
    size_t need = std::max<size_t>(data.size(), tile_bytes);
    if (buffer.size() < need) buffer.assign(need, 0);
    std::copy(data.begin(), data.end(), buffer.begin());
    cs.tile_done();
    unpack(u, cs.comps, tx0 - cs.x0, ty0 - cs.y0, tx1 - tx0, ty1 - ty0, buffer.data(), im);
  }
  to_rgb(im, h.palette, out);
}

}  // namespace

extern "C" {

// JPEG 2000 bytes (JP2 or J2K) -> RGB. With out == nullptr (or too small) the
// header is read, dims = {height, width} and RF_NEED_BUFFER returned.
int rf_jpeg2000_decode(const uint8_t* data, int64_t n, uint8_t* out, int64_t cap, int32_t* dims, char* err,
                       int64_t err_cap) {
  try {
    Header h = open_header(data, static_cast<size_t>(n));
    dims[0] = h.height;
    dims[1] = h.width;
    if (!out || cap < int64_t(h.width) * h.height * 3) return RF_NEED_BUFFER;
    decode(data, static_cast<size_t>(n), h, out);
    return RF_OK;
  } catch (const Fail& f) {
    write_err(f.msg, err, err_cap);
    return f.code;
  } catch (const std::exception& e) {
    write_err(std::string("JPEG 2000 decode failed: ") + e.what(), err, err_cap);
    return RF_CORRUPT;
  }
}

}  // extern "C"
