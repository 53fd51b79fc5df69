// JPEG decode for the host image reader (superdiff_torch/data/image_io.py),
// giving the samples libjpeg(-turbo) gives with its default settings, which
// is what PIL's JpegImagePlugin asks for: the ISLOW integer IDCT, "fancy"
// (triangle-filter) chroma upsampling and the fixed-point YCbCr->RGB tables.
//
// Forms decoded: baseline (SOF0) and extended sequential (SOF1) Huffman at 8
// bits, progressive (SOF2) Huffman including successive approximation, with
// or without restart intervals (DRI / RSTn); 1 component (gray), 3 (YCbCr,
// or RGB under an Adobe APP14 marker with transform 0 or component ids
// 'R','G','B') or 4 (CMYK, or YCCK under an Adobe marker whose transform is
// not 0); each component's sampling factor equal to the largest or half of
// it in each direction. Anything else is refused with a message that names
// the form: arithmetic coding (SOF9-11, DAC), lossless (SOF3), hierarchical
// (SOF5-7, SOF13-15), 12-bit samples, 2 components, other sampling factors,
// more than 10 blocks in an MCU, progressive scans that leave coefficients
// unrefined (libjpeg would block-smooth them) and truncated data. Corrupt
// data are refused where libjpeg refuses them (an over-full Huffman table,
// a DC symbol above 15, a DC sum outside int) and before any write they
// could send out of bounds. A sequential frame whose later scans
// are missing decodes as libjpeg decodes it: unscanned components are flat.
//
// The stages that set the bits, each as libjpeg does it:
//   - Huffman decode: jdhuff.c (sequential) and jdphuff.c (progressive:
//     DC first / refine, AC first with EOB runs, AC refine);
//   - dequantisation and jidctint.c's jpeg_idct_islow (CONST_BITS 13,
//     PASS1_BITS 2) with the post-IDCT range-limit table of jdmaster.c,
//     which masks its index to 10 bits (far out-of-range values wrap, they
//     are not clamped);
//   - jdsample.c: fullsize, h2v1 / h2v2 fancy upsampling when the
//     component is more than 2 samples wide (else box replication), h1v2
//     fancy upsampling, with the edge samples replicated as jdmainct.c's
//     context rows and the SIMD routines' dummy column do;
//   - jdcolor.c's ycc_rgb_convert tables (SCALEBITS 16), and its
//     ycck_cmyk_convert (the same tables, inverted, K passed through) for
//     YCCK; CMYK comes out as stored (PIL inverts it as Adobe files
//     store it, data/image_io.py).
//
// C API (ctypes):
//   int superdiff_jpeg_header(const uint8_t* data, int64_t n, int64_t* dims,
//                             char* err, int64_t errlen)
//     dims[0..2] = height, width, output channels (1, 3 or 4).
//   int superdiff_jpeg_decode(const uint8_t* data, int64_t n, uint8_t* out,
//                             int64_t out_size, char* err, int64_t errlen)
//     out: height * width * channels bytes, row-major, RGB or CMYK
//     interleaved.
//   Both return 0, or 1 with a message in err (a NUL-terminated string).
//
// Build: g++ -O2 -fPIC -std=c++17 -pthread -shared (superdiff_torch/ops/
// _build.py::build_host, into build/superdiff_torch/).

#include <algorithm>
#include <array>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

// zigzag index -> natural index, with 16 extra entries so that a corrupt
// run past coefficient 63 lands on 63 (as jpeg_natural_order does)
const int kNatural[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Huffman {
  bool defined = false;
  const char* bad = nullptr;  // why the table cannot be used, if it cannot
  uint8_t vals[256];
  int maxcode[18];   // largest code of each length, -1 if none
  int valptr[17];    // index in vals of the first code of each length
  int mincode[17];
  uint16_t fast[512];  // 9-bit lookahead: (length << 8) | value, 0 = slow

  // jdhuff.c jpeg_make_d_derived_tbl's checks, made when the table is
  // defined but raised (as libjpeg raises them) only by a scan that uses it:
  // the codes of each length must fit in that length without the all-ones
  // code, and a DC table's symbols (coefficient sizes) must be at most 15.
  void build(const uint8_t* bits, const uint8_t* v, int nvals, bool is_dc) {
    defined = true;
    bad = nullptr;
    std::memcpy(vals, v, nvals);
    std::memset(fast, 0, sizeof(fast));
    if (is_dc)
      for (int i = 0; i < nvals; ++i)
        if (vals[i] > 15) {
          bad = "corrupt data: bad Huffman table (a DC symbol above 15)";
          return;
        }
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      if (code + bits[l] >= (1 << l)) {
        bad = "corrupt data: bad Huffman table (more codes than fit)";
        return;
      }
      valptr[l] = k;
      mincode[l] = code;
      for (int i = 0; i < bits[l]; ++i, ++k, ++code) {
        if (l <= 9) {
          const int shift = 9 - l;
          for (int j = 0; j < (1 << shift); ++j)
            fast[(code << shift) | j] = static_cast<uint16_t>(
                (l << 8) | vals[k]);
        }
      }
      maxcode[l] = bits[l] ? code - 1 : -1;
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
  }

  // the table, for a scan that decodes with it
  const Huffman& use() const {
    if (!defined) fail("corrupt data: Huffman table missing");
    if (bad) fail(bad);
    return *this;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int bw = 0, bh = 0;            // blocks allocated per row / column
  int comp_w = 0, comp_h = 0;    // downsampled width / height in samples
  bool quant_latched = false;
  uint16_t quant[64];            // natural order, latched at its first scan
  std::vector<int16_t> coef;     // bw * bh blocks of 64 (natural order)
  int coef_bits[64];             // progressive: current Al, -1 if unseen
  int dc_pred = 0;
};

// Entropy-coded segment reader: MSB-first bit buffer over the bytes, with
// 0xFF00 unstuffed; at a marker it feeds zeros (as libjpeg does) and at the
// end of the data it records that the data are truncated.
struct BitReader {
  const uint8_t* d;
  size_t pos, end;
  uint64_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  BitReader(const uint8_t* data, size_t p, size_t e) : d(data), pos(p),
                                                       end(e) {}

  void fill() {
    while (cnt <= 56) {
      uint64_t byte = 0;
      if (!at_marker) {
        if (pos >= end) fail("truncated data (the file ends inside a scan)");
        const uint8_t b = d[pos];
        if (b == 0xFF) {
          size_t q = pos + 1;
          while (q < end && d[q] == 0xFF) ++q;       // fill bytes
          if (q >= end) fail("truncated data (the file ends inside a scan)");
          if (d[q] == 0x00) {
            byte = 0xFF;
            pos = q + 1;
          } else {
            at_marker = true;                         // pos stays on 0xFF
          }
        } else {
          byte = b;
          ++pos;
        }
      }
      buf |= byte << (56 - cnt);
      cnt += 8;
    }
  }

  inline int bits(int n) {
    if (n == 0) return 0;
    if (cnt < n) fill();
    const int v = static_cast<int>(buf >> (64 - n));
    buf <<= n;
    cnt -= n;
    return v;
  }

  inline int bit() { return bits(1); }

  inline int decode(const Huffman& h) {
    if (cnt < 16) fill();
    const int look = static_cast<int>(buf >> (64 - 9));
    const uint16_t f = h.fast[look];
    if (f) {
      const int l = f >> 8;
      buf <<= l;
      cnt -= l;
      return f & 0xFF;
    }
    int code = static_cast<int>(buf >> (64 - 10));
    int l = 10;
    while (l <= 16 && code > h.maxcode[l]) {
      ++l;
      code = static_cast<int>(buf >> (64 - l));
    }
    if (l > 16) fail("corrupt data: bad Huffman code");
    buf <<= l;
    cnt -= l;
    return h.vals[h.valptr[l] + code - h.mincode[l]];
  }

  // Drop the buffered bits and step past the next marker, which must be the
  // restart marker RSTn expected at this point of the scan.
  void restart(int expected) {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (true) {
      while (pos < end && d[pos] != 0xFF) ++pos;
      while (pos < end && d[pos] == 0xFF) ++pos;
      if (pos >= end) fail("truncated data (a restart marker is missing)");
      if (d[pos] != 0x00) break;
      ++pos;
    }
    if (d[pos] != 0xD0 + expected)
      fail("corrupt data: restart marker out of sequence");
    ++pos;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

struct Decoder {
  const uint8_t* d;
  size_t n;
  int width = 0, height = 0, ncomp = 0;
  int sof = -1;
  bool progressive = false;
  int max_h = 1, max_v = 1, mcus_x = 0, mcus_y = 0;
  int restart_interval = 0;
  bool saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  Component comp[4];
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  bool frame_done = false;

  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}

  int u16(size_t p) const {
    if (p + 2 > n) fail("truncated data (inside a marker segment)");
    return (d[p] << 8) | d[p + 1];
  }

  // ------------------------------------------------------------- markers --
  void read_sof(size_t p, int len, int marker) {
    if (sof >= 0) fail("more than one frame header (SOF)");
    sof = marker;
    progressive = marker == 0xC2;
    if (len < 6) fail("corrupt data: short frame header");
    const int precision = d[p];
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = d[p + 5];
    if (precision != 8)
      fail("unsupported form: " + std::to_string(precision) +
           "-bit samples (only 8-bit JPEG is decoded)");
    if (height == 0)
      fail("unsupported form: height defined by a DNL marker");
    if (width == 0) fail("corrupt data: zero width");
    if (ncomp != 1 && ncomp != 3 && ncomp != 4)
      fail("unsupported form: " + std::to_string(ncomp) + " components");
    if (len < 6 + 3 * ncomp) fail("corrupt data: short frame header");
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      k.id = d[p + 6 + 3 * c];
      k.h = d[p + 7 + 3 * c] >> 4;
      k.v = d[p + 7 + 3 * c] & 15;
      k.tq = d[p + 8 + 3 * c];
      if (k.h < 1 || k.h > 4 || k.v < 1 || k.v > 4 || k.tq > 3)
        fail("corrupt data: bad component parameters");
      max_h = std::max(max_h, k.h);
      max_v = std::max(max_v, k.v);
    }
    mcus_x = (width + 8 * max_h - 1) / (8 * max_h);
    mcus_y = (height + 8 * max_v - 1) / (8 * max_v);
    for (int c = 0; c < ncomp; ++c) {
      Component& k = comp[c];
      if (ncomp > 1 &&
          !((k.h == max_h || 2 * k.h == max_h) &&
            (k.v == max_v || 2 * k.v == max_v)))
        fail("unsupported form: sampling factors " + std::to_string(k.h) +
             "x" + std::to_string(k.v) + " against " +
             std::to_string(max_h) + "x" + std::to_string(max_v) +
             " (only 1:1 and 2:1 in each direction)");
      k.comp_w = static_cast<int>(
          (static_cast<int64_t>(width) * k.h + max_h - 1) / max_h);
      k.comp_h = static_cast<int>(
          (static_cast<int64_t>(height) * k.v + max_v - 1) / max_v);
      k.bw = mcus_x * k.h;
      k.bh = mcus_y * k.v;
      for (int i = 0; i < 64; ++i) k.coef_bits[i] = -1;
    }
  }

  void read_dqt(size_t p, size_t e) {
    while (p < e) {
      const int pq = d[p] >> 4, tq = d[p] & 15;
      ++p;
      if (tq > 3) fail("corrupt data: bad quantisation table id");
      const size_t need = pq ? 128 : 64;
      if (p + need > e) fail("corrupt data: short quantisation table");
      for (int i = 0; i < 64; ++i)
        qt[tq][kNatural[i]] = static_cast<uint16_t>(
            pq ? (d[p + 2 * i] << 8) | d[p + 2 * i + 1] : d[p + i]);
      qt_defined[tq] = true;
      p += need;
    }
  }

  void read_dht(size_t p, size_t e) {
    while (p < e) {
      if (p + 17 > e) fail("corrupt data: short Huffman table");
      const int tc = d[p] >> 4, th = d[p] & 15;
      if (tc > 1 || th > 3) fail("corrupt data: bad Huffman table id");
      uint8_t bits[17] = {0};
      int total = 0;
      for (int l = 1; l <= 16; ++l) total += bits[l] = d[p + l];
      if (total > 256 || p + 17 + total > e)
        fail("corrupt data: bad Huffman table");
      (tc ? ac[th] : dc[th]).build(bits, d + p + 17, total, tc == 0);
      p += 17 + total;
    }
  }

  void read_app(size_t p, int len, int marker) {
    const int body = len - 2;
    if (marker == 0xE0 && body >= 14 && std::memcmp(d + p, "JFIF\0", 5) == 0)
      saw_jfif = true;
    if (marker == 0xEE && body >= 12 && std::memcmp(d + p, "Adobe", 5) == 0) {
      saw_adobe = true;
      adobe_transform = d[p + 11];
    }
  }

  // Parse up to the first SOS (header only) or the whole file.
  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    size_t p = 2;
    while (true) {
      // next marker: skip anything up to 0xFF, then fill bytes
      while (p < n && d[p] != 0xFF) ++p;
      while (p < n && d[p] == 0xFF) ++p;
      if (p >= n) fail("truncated data (no end-of-image marker)");
      const int marker = d[p++];
      if (marker == 0x00 || (marker >= 0xD0 && marker <= 0xD7) ||
          marker == 0x01)
        continue;                                    // RSTn / TEM: no body
      if (marker == 0xD9) break;                     // EOI
      if (marker == 0xD8) fail("corrupt data: a second start-of-image");
      const int len = u16(p);
      if (len < 2 || p + len > n)
        fail("truncated data (inside a marker segment)");
      const size_t body = p + 2, end = p + len;
      switch (marker) {
        case 0xC0: case 0xC1: case 0xC2:
          read_sof(body, len - 2, marker);
          break;
        case 0xC3:
          fail("unsupported form: lossless JPEG (SOF3)");
        case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
          fail("unsupported form: hierarchical JPEG (SOF" +
               std::to_string(marker - 0xC0) + ")");
        case 0xC9: case 0xCA: case 0xCB:
          fail("unsupported form: arithmetic coding (SOF" +
               std::to_string(marker - 0xC0) + ")");
        case 0xCC:
          fail("unsupported form: arithmetic coding (DAC)");
        case 0xC4:
          read_dht(body, end);
          break;
        case 0xDB:
          read_dqt(body, end);
          break;
        case 0xDD:
          if (len < 4) fail("corrupt data: short restart interval");
          restart_interval = u16(body);
          break;
        case 0xDC:
          fail("unsupported form: height defined by a DNL marker");
        case 0xDA: {
          if (sof < 0) fail("corrupt data: scan before the frame header");
          if (header_only) return;
          p = scan(body, end);
          continue;
        }
        default:
          if (marker >= 0xE0 && marker <= 0xEF) read_app(body, len, marker);
          break;
      }
      p = end;
    }
    if (header_only || sof < 0) fail("corrupt data: no frame or scan");
    if (!frame_done) fail("corrupt data: no scan");
    // A component of a sequential frame that no scan named (its scans are
    // missing before EOI) keeps libjpeg's pre-zeroed coefficients and its
    // zeroed dequantisation table, so it decodes flat at 128 as PIL gives
    // it. Progressive frames with unscanned components are refused below.
    if (!progressive)
      for (int c = 0; c < ncomp; ++c)
        if (!comp[c].quant_latched) {
          std::memset(comp[c].quant, 0, sizeof(comp[c].quant));
          comp[c].coef.assign(
              static_cast<size_t>(comp[c].bw) * comp[c].bh * 64, 0);
          comp[c].quant_latched = true;
        }
    if (progressive)
      for (int c = 0; c < ncomp; ++c)
        for (int k = 0; k < 10; ++k)
          if (comp[c].coef_bits[k] != 0)
            fail("unsupported form: progressive scans that leave "
                 "coefficients unrefined (libjpeg block-smooths them)");
  }

  // ---------------------------------------------------------------- scans --
  size_t scan(size_t p, size_t end) {
    if (end <= p) fail("corrupt data: bad scan header");
    const int ns = d[p];
    if (ns < 1 || ns > ncomp || end < p + 1 + 2 * ns + 3)
      fail("corrupt data: bad scan header");
    Component* sc[4];
    for (int i = 0; i < ns; ++i) {
      const int cid = d[p + 1 + 2 * i], t = d[p + 2 + 2 * i];
      int c = 0;
      while (c < ncomp && comp[c].id != cid) ++c;
      if (c == ncomp) fail("corrupt data: scan names an unknown component");
      sc[i] = &comp[c];
      sc[i]->dc_tbl = t >> 4;
      sc[i]->ac_tbl = t & 15;
      if (sc[i]->dc_tbl > 3 || sc[i]->ac_tbl > 3)
        fail("corrupt data: bad Huffman table id");
    }
    if (ns > 1) {                 // jdinput.c per_scan_setup
      int blocks = 0;
      for (int i = 0; i < ns; ++i) blocks += sc[i]->h * sc[i]->v;
      if (blocks > 10)
        fail("unsupported form: sampling factors too large for an "
             "interleaved scan (" + std::to_string(blocks) +
             " blocks in an MCU, at most 10)");
    }
    const size_t q = p + 1 + 2 * ns;
    const int ss = d[q], se = d[q + 1], ah = d[q + 2] >> 4, al = d[q + 2] & 15;
    if (progressive) {
      if (ss > se || se > 63 || (ss == 0 && se != 0) ||
          (ss > 0 && ns != 1) || (ah != 0 && al != ah - 1) || al > 13)
        fail("corrupt data: bad progressive scan parameters");
    } else if (ss != 0 || se != 63 || ah != 0 || al != 0) {
      fail("corrupt data: bad sequential scan parameters");
    }
    for (int i = 0; i < ns; ++i) {
      Component& k = *sc[i];
      if (!k.quant_latched) {                 // jdinput.c latch_quant_tables
        if (!qt_defined[k.tq]) fail("corrupt data: quantisation table "
                                    "missing");
        std::memcpy(k.quant, qt[k.tq], sizeof(k.quant));
        k.quant_latched = true;
        k.coef.assign(static_cast<size_t>(k.bw) * k.bh * 64, 0);
      }
      // DC first scans and sequential scans decode DC codes; every scan
      // but a progressive DC scan decodes AC codes
      if (ss == 0 && ah == 0) dc[k.dc_tbl].use();
      if (!progressive || ss > 0) ac[k.ac_tbl].use();
      k.dc_pred = 0;
      if (progressive) {
        for (int c = ss; c <= se; ++c) {
          if (ah != (k.coef_bits[c] < 0 ? 0 : k.coef_bits[c]))
            fail("corrupt data: successive approximation out of order");
          k.coef_bits[c] = al;
        }
      }
    }

    BitReader br(d, end, n);
    int eobrun = 0;
    // MCU geometry: interleaved scans walk the frame's MCUs; a scan of one
    // component walks that component's blocks one at a time
    const bool single = ns == 1;
    const int mx = single ? (sc[0]->comp_w + 7) / 8 : mcus_x;
    const int my = single ? (sc[0]->comp_h + 7) / 8 : mcus_y;
    const int64_t total = static_cast<int64_t>(mx) * my;
    int restarts = 0;
    for (int64_t m = 0; m < total; ++m) {
      if (restart_interval && m > 0 && m % restart_interval == 0) {
        br.restart(restarts & 7);
        ++restarts;
        eobrun = 0;
        for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
      }
      const int mcol = static_cast<int>(m % mx);
      const int mrow = static_cast<int>(m / mx);
      for (int i = 0; i < ns; ++i) {
        Component& k = *sc[i];
        const int hh = single ? 1 : k.h, vv = single ? 1 : k.v;
        for (int by = 0; by < vv; ++by)
          for (int bx = 0; bx < hh; ++bx) {
            const int col = mcol * hh + bx, row = mrow * vv + by;
            int16_t* blk = &k.coef[(static_cast<size_t>(row) * k.bw + col) *
                                   64];
            if (!progressive)
              block_sequential(br, k, blk);
            else if (ss == 0)
              block_dc(br, k, blk, ah, al);
            else if (ah == 0)
              block_ac_first(br, k, blk, ss, se, al, eobrun);
            else
              block_ac_refine(br, k, blk, ss, se, al, eobrun);
          }
      }
    }
    frame_done = true;
    // the entropy-coded data end at the next marker
    size_t r = br.pos;
    while (true) {
      while (r < n && d[r] != 0xFF) ++r;
      size_t s = r;
      while (s < n && d[s] == 0xFF) ++s;
      if (s >= n) fail("truncated data (no end-of-image marker)");
      if (d[s] != 0x00) return r;
      r = s + 1;
    }
  }

  // the running DC value plus a decoded difference; libjpeg-turbo refuses a
  // sum outside int, and stores its low 16 bits (a JCOEF)
  static void add_dc(Component& k, int diff) {
    const int64_t v = static_cast<int64_t>(k.dc_pred) + diff;
    if (v > INT32_MAX || v < INT32_MIN)
      fail("corrupt data: DC coefficient out of range");
    k.dc_pred = static_cast<int>(v);
  }

  void block_sequential(BitReader& br, Component& k, int16_t* blk) {
    int s = br.decode(dc[k.dc_tbl]);
    add_dc(k, s ? extend(br.bits(s), s) : 0);
    blk[0] = static_cast<int16_t>(k.dc_pred);
    const Huffman& h = ac[k.ac_tbl];
    for (int i = 1; i < 64; ++i) {
      const int rs = br.decode(h);
      const int r = rs >> 4;
      s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.bits(s), s));
      } else {
        if (r != 15) break;
        i += 15;
      }
    }
  }

  void block_dc(BitReader& br, Component& k, int16_t* blk, int ah, int al) {
    if (ah == 0) {
      const int s = br.decode(dc[k.dc_tbl]);
      add_dc(k, s ? extend(br.bits(s), s) : 0);
      blk[0] = static_cast<int16_t>(static_cast<uint32_t>(k.dc_pred) << al);
    } else if (br.bit()) {
      blk[0] = static_cast<int16_t>(blk[0] | (1 << al));
    }
  }

  void block_ac_first(BitReader& br, Component& k, int16_t* blk, int ss,
                      int se, int al, int& eobrun) {
    if (eobrun > 0) {
      --eobrun;
      return;
    }
    const Huffman& h = ac[k.ac_tbl];
    for (int i = ss; i <= se; ++i) {
      const int rs = br.decode(h);
      int r = rs >> 4;
      const int s = rs & 15;
      if (s) {
        i += r;
        blk[kNatural[i]] = static_cast<int16_t>(extend(br.bits(s), s) *
                                                (1 << al));
      } else if (r == 15) {
        i += 15;
      } else {
        eobrun = 1 << r;
        if (r) eobrun += br.bits(r);
        --eobrun;
        break;
      }
    }
  }

  void block_ac_refine(BitReader& br, Component& k, int16_t* blk, int ss,
                       int se, int al, int& eobrun) {
    const int p1 = 1 << al, m1 = -1 * (1 << al);
    int i = ss;
    auto correct = [&](int16_t* c) {
      if (br.bit() && (*c & p1) == 0)
        *c = static_cast<int16_t>(*c >= 0 ? *c + p1 : *c + m1);
    };
    if (eobrun == 0) {
      const Huffman& h = ac[k.ac_tbl];
      for (; i <= se; ++i) {
        const int rs = br.decode(h);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          if (s != 1) fail("corrupt data: bad refinement coefficient size");
          s = br.bit() ? p1 : m1;
        } else if (r != 15) {
          eobrun = 1 << r;
          if (r) eobrun += br.bits(r);
          break;
        }
        do {
          int16_t* c = blk + kNatural[i];
          if (*c != 0) {
            correct(c);
          } else if (--r < 0) {
            break;
          }
          ++i;
        } while (i <= se);
        if (s) blk[kNatural[i]] = static_cast<int16_t>(s);
      }
    }
    if (eobrun > 0) {
      for (; i <= se; ++i) {
        int16_t* c = blk + kNatural[i];
        if (*c != 0) correct(c);
      }
      --eobrun;
    }
  }

  // ---------------------------------------------------------- reconstruct --
  // jdmaster.c prepare_range_limit_table, the post-IDCT part: index
  // (value & 1023) of a table placed CENTERJSAMPLE into the sample table.
  static const uint8_t* idct_limit() {
    static const std::array<uint8_t, 1024> table = [] {
      std::array<uint8_t, 1024> t{};
      for (int v = 0; v < 1024; ++v)
        t[v] = static_cast<uint8_t>(v < 128 ? 128 + v
                                    : v < 512 ? 255
                                    : v < 896 ? 0
                                              : v - 896);
      return t;
    }();
    return table.data();
  }

  // jidctint.c's 1-D butterfly (CONST_BITS 13) on one column or row: the
  // eight sums before descaling, in output order
  static void islow_1d(const int64_t* in, int64_t* out) {
    constexpr int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
                      F0899 = 7373, F1175 = 9633, F1501 = 12299,
                      F1847 = 15137, F1961 = 16069, F2053 = 16819,
                      F2562 = 20995, F3072 = 25172;
    int64_t z1 = (in[2] + in[6]) * F0541;
    int64_t tmp2 = z1 + in[6] * -F1847;
    int64_t tmp3 = z1 + in[2] * F0765;
    int64_t tmp0 = (in[0] + in[4]) * (1 << 13);
    int64_t tmp1 = (in[0] - in[4]) * (1 << 13);
    const int64_t t10 = tmp0 + tmp3, t13 = tmp0 - tmp3;
    const int64_t t11 = tmp1 + tmp2, t12 = tmp1 - tmp2;
    tmp0 = in[7];
    tmp1 = in[5];
    tmp2 = in[3];
    tmp3 = in[1];
    z1 = (tmp0 + tmp3) * -F0899;
    const int64_t z2 = (tmp1 + tmp2) * -F2562;
    const int64_t z5 = (tmp0 + tmp1 + tmp2 + tmp3) * F1175;
    const int64_t z3 = (tmp0 + tmp2) * -F1961 + z5;
    const int64_t z4 = (tmp1 + tmp3) * -F0390 + z5;
    tmp0 = tmp0 * F0298 + z1 + z3;
    tmp1 = tmp1 * F2053 + z2 + z4;
    tmp2 = tmp2 * F3072 + z2 + z3;
    tmp3 = tmp3 * F1501 + z1 + z4;
    out[0] = t10 + tmp3;
    out[7] = t10 - tmp3;
    out[1] = t11 + tmp2;
    out[6] = t11 - tmp2;
    out[2] = t12 + tmp1;
    out[5] = t12 - tmp1;
    out[3] = t13 + tmp0;
    out[4] = t13 - tmp0;
  }

  // jidctint.c jpeg_idct_islow (PASS1_BITS 2): coefficients * quant, columns
  // then rows, -> 8x8 samples through the range-limit table. The all-zero
  // AC shortcuts give the same values as the full butterfly.
  static void idct_islow(const int16_t* in, const uint16_t* q, uint8_t* out,
                         int stride, const uint8_t* limit) {
    auto descale = [](int64_t x, int n) {
      return (x + (int64_t(1) << (n - 1))) >> n;
    };
    int64_t ws[64], v[8], r[8];
    for (int c = 0; c < 8; ++c) {
      bool ac = false;
      for (int k = 0; k < 8; ++k) {
        v[k] = in[8 * k + c] * q[8 * k + c];
        ac |= k > 0 && v[k] != 0;
      }
      if (!ac) {
        for (int k = 0; k < 8; ++k) ws[8 * k + c] = v[0] * 4;
        continue;
      }
      islow_1d(v, r);
      for (int k = 0; k < 8; ++k) ws[8 * k + c] = descale(r[k], 11);
    }
    for (int row = 0; row < 8; ++row) {
      const int64_t* w = ws + 8 * row;
      uint8_t* op = out + static_cast<size_t>(row) * stride;
      if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
        std::memset(op, limit[static_cast<int>(descale(w[0], 5)) & 1023], 8);
        continue;
      }
      islow_1d(w, r);
      for (int k = 0; k < 8; ++k)
        op[k] = limit[static_cast<int>(descale(r[k], 18)) & 1023];
    }
  }

  // IDCT of the blocks that cover the component's downsampled area
  std::vector<uint8_t> plane(const Component& k, int& pw) const {
    const int nbx = (k.comp_w + 7) / 8, nby = (k.comp_h + 7) / 8;
    pw = nbx * 8;
    std::vector<uint8_t> out(static_cast<size_t>(pw) * nby * 8);
    const uint8_t* limit = idct_limit();
    for (int by = 0; by < nby; ++by)
      for (int bx = 0; bx < nbx; ++bx)
        idct_islow(&k.coef[(static_cast<size_t>(by) * k.bw + bx) * 64],
                   k.quant, &out[(static_cast<size_t>(by) * 8) * pw + bx * 8],
                   pw, limit);
    return out;
  }

  // jdsample.c: the component at full size (width x height), from its
  // plane (row stride pw, comp_w x comp_h valid samples)
  std::vector<uint8_t> upsample(const Component& k) const {
    int pw;
    const std::vector<uint8_t> src = plane(k, pw);
    const int W = width, H = height, dw = k.comp_w, dh = k.comp_h;
    std::vector<uint8_t> out(static_cast<size_t>(W) * H);
    const bool h2 = k.h * 2 == max_h, v2 = k.v * 2 == max_v;
    auto at = [&](int y, int x) -> int {           // edge-replicated sample
      y = y < 0 ? 0 : (y >= dh ? dh - 1 : y);
      x = x < 0 ? 0 : (x >= dw ? dw - 1 : x);
      return src[static_cast<size_t>(y) * pw + x];
    };
    for (int y = 0; y < H; ++y) {
      uint8_t* o = &out[static_cast<size_t>(y) * W];
      if (!h2 && !v2) {                            // fullsize
        std::memcpy(o, &src[static_cast<size_t>(y) * pw], W);
      } else if (h2 && !v2) {
        if (dw > 2) {                              // h2v1 fancy
          for (int x = 0; x < W; ++x) {
            const int j = x >> 1, c = at(y, j) * 3;
            o[x] = static_cast<uint8_t>(
                x & 1 ? (c + at(y, j + 1) + 2) >> 2
                      : (c + at(y, j - 1) + 1) >> 2);
          }
        } else {                                   // h2v1 box
          for (int x = 0; x < W; ++x)
            o[x] = static_cast<uint8_t>(at(y, x >> 1));
        }
      } else if (!h2 && v2) {                      // h1v2 fancy
        const int i = y >> 1, far = y & 1 ? i + 1 : i - 1;
        const int bias = y & 1 ? 2 : 1;
        for (int x = 0; x < W; ++x)
          o[x] = static_cast<uint8_t>((at(i, x) * 3 + at(far, x) + bias) >> 2);
      } else if (dw > 2) {                         // h2v2 fancy
        const int i = y >> 1, far = y & 1 ? i + 1 : i - 1;
        auto colsum = [&](int j) { return at(i, j) * 3 + at(far, j); };
        for (int x = 0; x < W; ++x) {
          const int j = x >> 1, c = colsum(j) * 3;
          o[x] = static_cast<uint8_t>(
              x & 1 ? (c + colsum(j + 1) + 7) >> 4
                    : (c + colsum(j - 1) + 8) >> 4);
        }
      } else {                                     // h2v2 box
        for (int x = 0; x < W; ++x)
          o[x] = static_cast<uint8_t>(at(y >> 1, x >> 1));
      }
    }
    return out;
  }

  // jdapimin.c default_decompress_parms: the colour space of the stored
  // components. Three: RGB or YCbCr; four: CMYK, or YCCK under an Adobe
  // marker whose transform is not 0 (2, or unknown and "assumed YCCK").
  bool rgb_source() const {
    if (ncomp == 4) return !saw_adobe || adobe_transform == 0;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return comp[0].id == 82 && comp[1].id == 71 && comp[2].id == 66;
  }

  void output(uint8_t* out) const {
    const size_t npx = static_cast<size_t>(width) * height;
    if (ncomp == 1) {
      const std::vector<uint8_t> y = upsample(comp[0]);
      std::memcpy(out, y.data(), npx);
      return;
    }
    const int nc = ncomp;
    const std::vector<uint8_t> c0 = upsample(comp[0]), c1 = upsample(comp[1]),
                               c2 = upsample(comp[2]),
                               c3 = nc == 4 ? upsample(comp[3])
                                            : std::vector<uint8_t>();
    if (nc == 4)
      for (size_t i = 0; i < npx; ++i) out[4 * i + 3] = c3[i];   // K
    if (rgb_source()) {
      for (size_t i = 0; i < npx; ++i) {
        out[nc * i] = c0[i];
        out[nc * i + 1] = c1[i];
        out[nc * i + 2] = c2[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table (SCALEBITS 16)
    constexpr int SB = 16;
    constexpr int64_t HALF = int64_t(1) << (SB - 1);
    auto fix = [](double x) {
      return static_cast<int64_t>(x * (int64_t(1) << SB) + 0.5);
    };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      const int64_t x = i - 128;
      cr_r[i] = static_cast<int>((fix(1.40200) * x + HALF) >> SB);
      cb_b[i] = static_cast<int>((fix(1.77200) * x + HALF) >> SB);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + HALF;
    }
    auto clamp = [](int v) {
      return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    // ycck_cmyk_convert stores range_limit[255 - (y + ...)], which is
    // 255 - the clamped RGB sample
    const uint8_t flip = nc == 4 ? 255 : 0;
    for (size_t i = 0; i < npx; ++i) {
      const int y = c0[i], cb = c1[i], cr = c2[i];
      out[nc * i] = flip ^ clamp(y + cr_r[cr]);
      out[nc * i + 1] =
          flip ^ clamp(y + static_cast<int>((cb_g[cb] + cr_g[cr]) >> SB));
      out[nc * i + 2] = flip ^ clamp(y + cb_b[cb]);
    }
  }
};

void copy_error(const std::string& msg, char* err, int64_t errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, static_cast<size_t>(errlen), "%s", msg.c_str());
  }
}

}  // namespace

extern "C" int superdiff_jpeg_header(const uint8_t* data, int64_t n,
                                     int64_t* dims, char* err,
                                     int64_t errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.parse(true);
    dims[0] = dec.height;
    dims[1] = dec.width;
    dims[2] = dec.ncomp;
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
  }
  return 1;
}

extern "C" int superdiff_jpeg_decode(const uint8_t* data, int64_t n,
                                     uint8_t* out, int64_t out_size,
                                     char* err, int64_t errlen) {
  try {
    Decoder dec(data, static_cast<size_t>(n));
    dec.parse(false);
    if (static_cast<int64_t>(dec.width) * dec.height * dec.ncomp != out_size)
      throw Error{"output buffer of the wrong size"};
    dec.output(out);
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
  }
  return 1;
}
