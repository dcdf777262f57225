// Sequential Huffman JPEG decoder (SOF0 baseline, SOF1 extended; 8-bit
// samples; 1 or 3 components; sampling factors up to 2x2; restart
// intervals), bound with ctypes by utils/jpeg.py.
//
// The arithmetic follows the IJG library's default decompression path, as
// libjpeg-turbo runs it: the integer "islow" IDCT (jidctint.c) with its
// range-limit table (jdmaster.c), "fancy" triangle-filter upsampling for
// h2v1 and h2v2 chroma (jdsample.c; box replication where a component is at
// most two samples wide), edge rows replicated for the vertical filter
// (jdmainct.c), and the fixed-point YCbCr -> RGB tables of jdcolor.c. So the
// decoded bytes equal those of a libjpeg-turbo build at its defaults.
//
// Anything else (progressive, arithmetic-coded, lossless, hierarchical,
// 12-bit, four components, other sampling ratios) is refused with a message
// that names the marker; there is no fallback.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

const int kZigzag[64] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

struct Error {
  std::string msg;
};

[[noreturn]] void fail(const std::string& msg) { throw Error{msg}; }

std::string hex_marker(int m) {
  char buf[16];
  std::snprintf(buf, sizeof(buf), "0xFF%02X", m);
  return buf;
}

const int kLookBits = 9;

struct Huffman {
  bool defined = false;
  int maxcode[18];
  int valptr[17];
  int mincode[17];
  uint8_t vals[256];
  uint8_t look_len[1 << kLookBits];
  uint8_t look_val[1 << kLookBits];

  void build(const uint8_t* counts, const uint8_t* symbols, int nsym) {
    std::memcpy(vals, symbols, nsym);
    std::memset(look_len, 0, sizeof(look_len));
    int code = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      valptr[l] = k;
      mincode[l] = code;
      code += counts[l - 1];
      k += counts[l - 1];
      maxcode[l] = counts[l - 1] ? code - 1 : -1;
      if (counts[l - 1] && l <= kLookBits) {
        for (int c = mincode[l]; c <= maxcode[l]; ++c) {
          int sym = valptr[l] + c - mincode[l];
          int lo = c << (kLookBits - l), n = 1 << (kLookBits - l);
          for (int j = 0; j < n; ++j) {
            look_len[lo + j] = (uint8_t)l;
            look_val[lo + j] = vals[sym];
          }
        }
      }
      code <<= 1;
    }
    maxcode[17] = 0x7fffffff;
    defined = true;
  }
};

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int dw = 0, dh = 0;  // downsampled width / height in samples
  int stride = 0, rows = 0;
  std::vector<uint8_t> plane;
  int dc_pred = 0;
};

// jdmaster.c prepare_range_limit_table, post-IDCT part: index (x & 1023)
// for a descaled value x centred on 0
struct RangeLimit {
  uint8_t t[1024];
  RangeLimit() {
    for (int x = 0; x < 1024; ++x) {
      int v;
      if (x < 128) v = x + 128;
      else if (x < 512) v = 255;
      else if (x < 896) v = 0;
      else v = x - 896;
      t[x] = (uint8_t)v;
    }
  }
};
const RangeLimit kRange;

inline int descale(int64_t x, int n) { return (int)((x + ((int64_t)1 << (n - 1))) >> n); }

// jidctint.c jpeg_idct_islow (CONST_BITS 13, PASS1_BITS 2)
void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out, int stride) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qq = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] && !in[56]) {
      int dc = (in[0] * (int)qq[0]) * 4;
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = in[16] * (int64_t)qq[16], z3 = in[48] * (int64_t)qq[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = in[0] * (int64_t)qq[0];
    z3 = in[32] * (int64_t)qq[32];
    int64_t tmp0 = (z2 + z3) * 8192;
    int64_t tmp1 = (z2 - z3) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = in[56] * (int64_t)qq[56];
    tmp1 = in[40] * (int64_t)qq[40];
    tmp2 = in[24] * (int64_t)qq[24];
    tmp3 = in[8] * (int64_t)qq[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    w[0] = descale(tmp10 + tmp3, 11);
    w[56] = descale(tmp10 - tmp3, 11);
    w[8] = descale(tmp11 + tmp2, 11);
    w[48] = descale(tmp11 - tmp2, 11);
    w[16] = descale(tmp12 + tmp1, 11);
    w[40] = descale(tmp12 - tmp1, 11);
    w[24] = descale(tmp13 + tmp0, 11);
    w[32] = descale(tmp13 - tmp0, 11);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (size_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = kRange.t[descale(w[0], 5) & 1023];
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * -F1847;
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * 8192;
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * 8192;
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = w[7];
    tmp1 = w[5];
    tmp2 = w[3];
    tmp3 = w[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int64_t z4 = tmp1 + tmp3;
    int64_t z5 = (z3 + z4) * F1175;
    tmp0 *= F0298;
    tmp1 *= F2053;
    tmp2 *= F3072;
    tmp3 *= F1501;
    z1 *= -F0899;
    z2 *= -F2562;
    z3 *= -F1961;
    z4 *= -F0390;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    o[0] = kRange.t[descale(tmp10 + tmp3, 18) & 1023];
    o[7] = kRange.t[descale(tmp10 - tmp3, 18) & 1023];
    o[1] = kRange.t[descale(tmp11 + tmp2, 18) & 1023];
    o[6] = kRange.t[descale(tmp11 - tmp2, 18) & 1023];
    o[2] = kRange.t[descale(tmp12 + tmp1, 18) & 1023];
    o[5] = kRange.t[descale(tmp12 - tmp1, 18) & 1023];
    o[3] = kRange.t[descale(tmp13 + tmp0, 18) & 1023];
    o[4] = kRange.t[descale(tmp13 - tmp0, 18) & 1023];
  }
}

// entropy-coded segment reader: bytes 0xFF 0x00 are one 0xFF; at a marker
// it feeds zero bits, as libjpeg does
struct BitReader {
  const uint8_t* d;
  size_t n, pos;
  uint32_t buf = 0;
  int cnt = 0;
  bool at_marker = false;

  void fill() {
    while (cnt <= 24) {
      uint32_t b = 0;
      if (!at_marker && pos < n) {
        b = d[pos];
        if (b == 0xFF) {
          uint8_t b2 = pos + 1 < n ? d[pos + 1] : 0xD9;
          if (b2 == 0x00) {
            pos += 2;
          } else {
            at_marker = true;
            b = 0;
          }
        } else {
          ++pos;
        }
      }
      buf |= b << (24 - cnt);
      cnt += 8;
    }
  }
  void skip(int k) {
    buf <<= k;
    cnt -= k;
  }
  int receive(int s) {
    if (s == 0) return 0;
    fill();
    int v = (int)(buf >> (32 - s));
    skip(s);
    return v;
  }
  int decode(const Huffman& h) {
    fill();
    int look = (int)(buf >> (32 - kLookBits));
    int l = h.look_len[look];
    if (l) {
      skip(l);
      return h.look_val[look];
    }
    for (l = kLookBits + 1; l <= 16; ++l) {
      int code = (int)(buf >> (32 - l));
      if (code <= h.maxcode[l]) {
        skip(l);
        return h.vals[h.valptr[l] + code - h.mincode[l]];
      }
    }
    fail("corrupt Huffman code in the entropy-coded data");
  }
  // at a restart boundary: drop the partial byte, expect RSTn
  void restart() {
    buf = 0;
    cnt = 0;
    at_marker = false;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)) ++pos;
    if (pos + 1 < n) pos += 2;
  }
};

inline int extend(int v, int s) { return (s && v < (1 << (s - 1))) ? v - (1 << s) + 1 : v; }

struct Decoder {
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int width = 0, height = 0, ncomp = 0, hmax = 1, vmax = 1;
  bool have_frame = false, jfif = false;
  int adobe_transform = -1;
  int restart_interval = 0;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huffman dc[4], ac[4];
  Component comp[3];

  int u8() {
    if (pos >= n) fail("unexpected end of data");
    return d[pos++];
  }
  int u16() {
    int hi = u8();
    return (hi << 8) | u8();
  }

  void read_dqt(size_t end) {
    while (pos < end) {
      int pq_tq = u8();
      int pq = pq_tq >> 4, tq = pq_tq & 15;
      if (tq > 3 || pq > 1) fail("bad quantization table (DQT)");
      for (int k = 0; k < 64; ++k) qt[tq][kZigzag[k]] = (uint16_t)(pq ? u16() : u8());
      qt_defined[tq] = true;
    }
  }

  void read_dht(size_t end) {
    while (pos < end) {
      int tc_th = u8();
      int tc = tc_th >> 4, th = tc_th & 15;
      if (tc > 1 || th > 3) fail("bad Huffman table (DHT)");
      uint8_t counts[16];
      int total = 0;
      for (int i = 0; i < 16; ++i) total += counts[i] = (uint8_t)u8();
      if (total > 256 || pos + total > n) fail("bad Huffman table (DHT)");
      (tc ? ac : dc)[th].build(counts, d + pos, total);
      pos += total;
    }
  }

  void read_sof(int marker) {
    int precision = u8();
    if (precision != 8)
      fail(std::to_string(precision) + "-bit samples (" + hex_marker(marker) +
           ") are not supported; only 8-bit");
    height = u16();
    width = u16();
    ncomp = u8();
    if (height == 0) fail("height 0 (DNL) is not supported");
    if (width == 0) fail("width 0");
    if (ncomp != 1 && ncomp != 3)
      fail(std::to_string(ncomp) + " components (" + hex_marker(marker) +
           ") are not supported; only gray or YCbCr / RGB");
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 2 || c.v < 1 || c.v > 2 || c.tq > 3)
        fail("sampling factors above 2x2 or a bad table index (" + hex_marker(marker) + ")");
    }
    hmax = vmax = 1;
    for (int i = 0; i < ncomp; ++i) {
      hmax = comp[i].h > hmax ? comp[i].h : hmax;
      vmax = comp[i].v > vmax ? comp[i].v : vmax;
    }
    int mcux = (width + 8 * hmax - 1) / (8 * hmax), mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.dw = (width * c.h + hmax - 1) / hmax;
      c.dh = (height * c.v + vmax - 1) / vmax;
      c.stride = mcux * c.h * 8;
      c.rows = mcuy * c.v * 8;
      c.plane.assign((size_t)c.stride * c.rows, 0);
    }
    have_frame = true;
  }

  void decode_block(BitReader& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const Huffman& hd = dc[c.td];
    const Huffman& ha = ac[c.ta];
    int s = br.decode(hd);
    if (s > 15) fail("bad DC difference size in the entropy-coded data");
    c.dc_pred += extend(br.receive(s), s);
    blk[0] = (int16_t)c.dc_pred;
    for (int k = 1; k < 64; ++k) {
      int rs = br.decode(ha);
      int r = rs >> 4;
      s = rs & 15;
      if (s) {
        k += r;
        if (k > 63) fail("AC coefficient index past 63 in the entropy-coded data");
        blk[kZigzag[k]] = (int16_t)extend(br.receive(s), s);
      } else if (r == 15) {
        k += 15;
      } else {
        break;
      }
    }
  }

  void read_scan() {
    int len = u16();
    size_t end = pos - 2 + len;
    int ns = u8();
    if (!have_frame) fail("scan (SOS) before the frame header");
    if (ns < 1 || ns > ncomp) fail("bad component count in SOS");
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int cid = u8();
      int tables = u8();
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) found = &comp[j];
      if (!found) fail("SOS names a component the frame lacks");
      found->td = tables >> 4;
      found->ta = tables & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined || !ac[found->ta].defined)
        fail("SOS uses an undefined Huffman table");
      if (!qt_defined[found->tq]) fail("frame uses an undefined quantization table");
      sc[i] = found;
    }
    int ss = u8(), se = u8(), ahal = u8();
    if (ss != 0 || se != 63 || ahal != 0) fail("spectral selection / approximation in a sequential scan");
    pos = end;
    BitReader br{d, n, pos};
    for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
    int16_t blk[64];
    int mcus_x, mcus_y;
    if (ns == 1) {
      mcus_x = (sc[0]->dw + 7) / 8;
      mcus_y = (sc[0]->dh + 7) / 8;
    } else {
      mcus_x = (width + 8 * hmax - 1) / (8 * hmax);
      mcus_y = (height + 8 * vmax - 1) / (8 * vmax);
    }
    long total = (long)mcus_x * mcus_y, done = 0;
    for (int my = 0; my < mcus_y; ++my) {
      for (int mx = 0; mx < mcus_x; ++mx) {
        if (restart_interval && done && done % restart_interval == 0) {
          br.restart();
          for (int i = 0; i < ns; ++i) sc[i]->dc_pred = 0;
        }
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          int bh = ns == 1 ? 1 : c.h, bv = ns == 1 ? 1 : c.v;
          for (int by = 0; by < bv; ++by)
            for (int bx = 0; bx < bh; ++bx) {
              decode_block(br, c, blk);
              int row = (my * bv + by) * 8, col = (mx * bh + bx) * 8;
              idct_islow(blk, qt[c.tq], c.plane.data() + (size_t)row * c.stride + col, c.stride);
            }
        }
        ++done;
      }
    }
    (void)total;
    // continue after the entropy-coded data: the next marker
    pos = br.pos;
    while (pos + 1 < n && !(d[pos] == 0xFF && d[pos + 1] != 0x00 &&
                            !(d[pos + 1] >= 0xD0 && d[pos + 1] <= 0xD7)))
      ++pos;
  }

  void parse(bool header_only) {
    if (n < 4 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (no SOI marker)");
    pos = 2;
    bool scanned = false;
    while (true) {
      int b = u8();
      if (b != 0xFF) fail("expected a marker at byte " + std::to_string(pos - 1));
      int m = u8();
      while (m == 0xFF) m = u8();  // fill bytes
      if (m == 0xD9) break;        // EOI
      if (m >= 0xD0 && m <= 0xD7) continue;
      if (m == 0xC0 || m == 0xC1) {
        int len = u16();
        size_t end = pos - 2 + len;
        if (have_frame) fail("a second frame header (" + hex_marker(m) + ")");
        read_sof(m);
        pos = end;
        if (header_only) return;
        continue;
      }
      if (m == 0xC2 || m == 0xC6 || m == 0xCA || m == 0xCE)
        fail("progressive JPEG (" + hex_marker(m) + ") is not supported; only baseline / extended sequential Huffman");
      if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF)
        fail("lossless JPEG (" + hex_marker(m) + ") is not supported");
      if (m == 0xC5) fail("hierarchical JPEG (" + hex_marker(m) + ") is not supported");
      if (m == 0xC9 || m == 0xCC || m == 0xCD)
        fail("arithmetic-coded JPEG (" + hex_marker(m) + ") is not supported");
      if (m == 0xDC) fail("DNL marker (" + hex_marker(m) + ") is not supported");
      if (m == 0xDA) {
        if (header_only) fail("scan before the frame header");
        read_scan();
        scanned = true;
        continue;
      }
      int len = u16();
      size_t end = pos - 2 + len;
      if (len < 2 || end > n) fail("truncated segment " + hex_marker(m));
      if (m == 0xDB) {
        read_dqt(end);
      } else if (m == 0xC4) {
        read_dht(end);
      } else if (m == 0xDD) {
        restart_interval = u16();
      } else if (m == 0xE0 && len >= 7 && std::memcmp(d + pos, "JFIF", 4) == 0) {
        jfif = true;
      } else if (m == 0xEE && len >= 14 && std::memcmp(d + pos, "Adobe", 5) == 0) {
        adobe_transform = d[pos + 11];
      }
      pos = end;
    }
    if (!have_frame) fail("no frame header (SOF0 / SOF1)");
    if (!header_only && !scanned) fail("no scan (SOS)");
  }

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (jfif) return false;
    if (adobe_transform >= 0) return adobe_transform == 0;
    return comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B';
  }

  // one component at full resolution, (height, width), edges replicated
  std::vector<uint8_t> upsample(const Component& c) const {
    std::vector<uint8_t> out((size_t)width * height);
    int fh = hmax / c.h, fv = vmax / c.v;
    const uint8_t* p = c.plane.data();
    auto row = [&](int r) {
      r = r < 0 ? 0 : (r >= c.dh ? c.dh - 1 : r);
      return p + (size_t)r * c.stride;
    };
    std::vector<uint8_t> line((size_t)2 * c.dw + 2);
    bool fancy = c.dw > 2;
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out.data() + (size_t)y * width;
      if (fh == 1 && fv == 1) {
        std::memcpy(o, row(y), width);
      } else if (fh == 2 && fv == 1) {
        const uint8_t* in = row(y);
        if (!fancy) {
          for (int x = 0; x < width; ++x) o[x] = in[x / 2];
          continue;
        }
        int dw = c.dw, k = 0;
        line[k++] = in[0];
        line[k++] = (uint8_t)((in[0] * 3 + in[1] + 2) >> 2);
        for (int i = 1; i < dw - 1; ++i) {
          int v = in[i] * 3;
          line[k++] = (uint8_t)((v + in[i - 1] + 1) >> 2);
          line[k++] = (uint8_t)((v + in[i + 1] + 2) >> 2);
        }
        line[k++] = (uint8_t)((in[dw - 1] * 3 + in[dw - 2] + 1) >> 2);
        line[k++] = in[dw - 1];
        std::memcpy(o, line.data(), width);
      } else if (fh == 2 && fv == 2) {
        int r = y / 2;
        const uint8_t* in0 = row(r);
        if (!fancy) {
          for (int x = 0; x < width; ++x) o[x] = in0[x / 2];
          continue;
        }
        const uint8_t* in1 = row(y % 2 == 0 ? r - 1 : r + 1);
        int dw = c.dw, k = 0;
        int this_sum = in0[0] * 3 + in1[0];
        int next_sum = in0[1] * 3 + in1[1];
        line[k++] = (uint8_t)((this_sum * 4 + 8) >> 4);
        line[k++] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
        int last_sum = this_sum;
        this_sum = next_sum;
        for (int i = 2; i < dw; ++i) {
          next_sum = in0[i] * 3 + in1[i];
          line[k++] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
          line[k++] = (uint8_t)((this_sum * 3 + next_sum + 7) >> 4);
          last_sum = this_sum;
          this_sum = next_sum;
        }
        line[k++] = (uint8_t)((this_sum * 3 + last_sum + 8) >> 4);
        line[k++] = (uint8_t)((this_sum * 4 + 7) >> 4);
        std::memcpy(o, line.data(), width);
      } else {
        fail("sampling ratio " + std::to_string(fh) + "x" + std::to_string(fv) +
             " (4:4:0 or other) is not supported; only 4:4:4, 4:2:2 and 4:2:0");
      }
    }
    return out;
  }

  void output(uint8_t* out) const {
    if (ncomp == 1) {
      std::vector<uint8_t> g = upsample(comp[0]);
      std::memcpy(out, g.data(), g.size());
      return;
    }
    std::vector<uint8_t> a = upsample(comp[0]), b = upsample(comp[1]), c = upsample(comp[2]);
    size_t npix = (size_t)width * height;
    if (is_rgb()) {
      for (size_t i = 0; i < npix; ++i) {
        out[3 * i] = a[i];
        out[3 * i + 1] = b[i];
        out[3 * i + 2] = c[i];
      }
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t one_half = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    static int cr_r[256], cb_b[256];
    static int64_t cr_g[256], cb_g[256];
    static bool built = false;
    if (!built) {
      for (int i = 0; i < 256; ++i) {
        int64_t x = i - 128;
        cr_r[i] = (int)((fix(1.40200) * x + one_half) >> 16);
        cb_b[i] = (int)((fix(1.77200) * x + one_half) >> 16);
        cr_g[i] = -fix(0.71414) * x;
        cb_g[i] = -fix(0.34414) * x + one_half;
      }
      built = true;
    }
    auto clamp = [](int v) { return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v)); };
    for (size_t i = 0; i < npix; ++i) {
      int y = a[i], cb = b[i], cr = c[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

// ---------------------------------------------------------------------------
// Baseline encoder: what libjpeg-turbo writes at its compression defaults
// (the defaults of PIL's Image.save for JPEG): quality 75 by the IJG
// scaling of the Annex K tables, 4:2:0 sampling for colour, the standard
// Huffman tables (not optimised), the fixed-point RGB -> YCbCr tables of
// jccolor.c, h2v2 downsampling with the alternating 1, 2 bias of
// jcsample.c, edge columns and rows replicated as jcsample.c and jcprepct.c
// pad them, the "islow" forward DCT of jfdctint.c and the reciprocal
// quantisation of jcdctmgr.c, dummy blocks at the right and bottom edges as
// jccoefct.c makes them, and jcmarker.c's marker order (SOI, JFIF APP0,
// DQT, SOF0, DHT, SOS, EOI).

const uint8_t kStdLumaQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromaQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// jcparam.c jpeg_quality_scaling + jpeg_add_quant_table (force_baseline)
void scaled_qtable(const uint8_t* base, int quality, uint16_t* q) {
  if (quality <= 0) quality = 1;
  if (quality > 100) quality = 100;
  int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
  for (int i = 0; i < 64; ++i) {
    long t = ((long)base[i] * scale + 50L) / 100L;
    if (t <= 0) t = 1;
    if (t > 255) t = 255;
    q[i] = (uint16_t)t;
  }
}

// jcdctmgr.c compute_reciprocal for 16-bit DCTELEMs: (|x| + corr) * recip >> shift
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t d) {
  if (d == 1) return {1, 0, 0};
  int b = 31 - __builtin_clz(d);  // flss(d) - 1
  int r = 16 + b;
  uint64_t fq = ((uint64_t)1 << r) / d, fr = ((uint64_t)1 << r) % d;
  uint32_t c = d / 2;
  if (fr == 0) {
    fq >>= 1;
    --r;
  } else if (fr <= d / 2U) {
    ++c;
  } else {
    ++fq;
  }
  return {(uint32_t)fq, c, r};
}

// jfdctint.c jpeg_fdct_islow: in place, output scaled up by 8
void fdct_islow(int32_t* data) {
  const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270, F0899 = 7373,
                F1175 = 9633, F1501 = 12299, F1847 = 15137, F1961 = 16069, F2053 = 16819,
                F2562 = 20995, F3072 = 25172;
  const int CB = 13, P1 = 2;
  for (int pass = 0; pass < 2; ++pass) {
    const int step = pass == 0 ? 1 : 8, next = pass == 0 ? 8 : 1;
    const int odd_shift = pass == 0 ? CB - P1 : CB + P1;
    for (int ctr = 0; ctr < 8; ++ctr) {
      int32_t* p = data + ctr * next;
      int64_t tmp0 = p[0] + p[7 * step], tmp7 = p[0] - p[7 * step];
      int64_t tmp1 = p[step] + p[6 * step], tmp6 = p[step] - p[6 * step];
      int64_t tmp2 = p[2 * step] + p[5 * step], tmp5 = p[2 * step] - p[5 * step];
      int64_t tmp3 = p[3 * step] + p[4 * step], tmp4 = p[3 * step] - p[4 * step];
      int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
      if (pass == 0) {
        p[0] = (int32_t)((tmp10 + tmp11) * (1 << P1));
        p[4 * step] = (int32_t)((tmp10 - tmp11) * (1 << P1));
      } else {
        p[0] = descale(tmp10 + tmp11, P1);
        p[4 * step] = descale(tmp10 - tmp11, P1);
      }
      int64_t z1 = (tmp12 + tmp13) * F0541;
      p[2 * step] = descale(z1 + tmp13 * F0765, odd_shift);
      p[6 * step] = descale(z1 - tmp12 * F1847, odd_shift);
      z1 = tmp4 + tmp7;
      int64_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
      int64_t z5 = (z3 + z4) * F1175;
      tmp4 *= F0298;
      tmp5 *= F2053;
      tmp6 *= F3072;
      tmp7 *= F1501;
      z1 *= -F0899;
      z2 *= -F2562;
      z3 *= -F1961;
      z4 *= -F0390;
      z3 += z5;
      z4 += z5;
      p[7 * step] = descale(tmp4 + z1 + z3, odd_shift);
      p[5 * step] = descale(tmp5 + z2 + z4, odd_shift);
      p[3 * step] = descale(tmp6 + z2 + z3, odd_shift);
      p[step] = descale(tmp7 + z1 + z4, odd_shift);
    }
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint32_t acc = 0;
  int n = 0;
  void put(uint32_t code, int len) {
    for (int i = len - 1; i >= 0; --i) {
      acc = (acc << 1) | ((code >> i) & 1);
      if (++n == 8) {
        out.push_back((uint8_t)acc);
        if (acc == 0xFF) out.push_back(0);
        acc = 0;
        n = 0;
      }
    }
  }
  void flush() {  // jchuff.c flush_bits: pad with one bits
    if (n) put(0x7F, 8 - n);
  }
};

struct HuffCodes {
  uint16_t code[256];
  uint8_t len[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(len, 0, sizeof(len));
    int c = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l - 1]; ++i, ++k) {
        code[vals[k]] = (uint16_t)c++;
        len[vals[k]] = (uint8_t)l;
      }
      c <<= 1;
    }
  }
};

inline int bit_count(int v) {
  int n = 0;
  for (v = v < 0 ? -v : v; v; v >>= 1) ++n;
  return n;
}

// one component's sample plane, padded to whole blocks as libjpeg pads it
struct Plane {
  int w = 0, h = 0;  // padded size (multiples of 8)
  std::vector<uint8_t> px;
};

void put_marker_segment(std::vector<uint8_t>& out, int marker, const std::vector<uint8_t>& body) {
  out.push_back(0xFF);
  out.push_back((uint8_t)marker);
  size_t len = body.size() + 2;
  out.push_back((uint8_t)(len >> 8));
  out.push_back((uint8_t)len);
  out.insert(out.end(), body.begin(), body.end());
}

std::vector<uint8_t> encode_jpeg(const uint8_t* src, int width, int height, int channels, int quality) {
  if (width < 1 || height < 1 || width > 65535 || height > 65535) fail("image size out of range");
  if (channels != 1 && channels != 3) fail("the encoder takes 1 (gray) or 3 (RGB) channels");
  const bool color = channels == 3;
  const int hmax = color ? 2 : 1, vmax = hmax;
  const int mcu_w = 8 * hmax, mcu_h = 8 * vmax;
  const int mcus_x = (width + mcu_w - 1) / mcu_w, mcus_y = (height + mcu_h - 1) / mcu_h;
  const int ncomp = channels;

  // colour conversion into full-resolution planes (jccolor.c rgb_ycc_convert)
  std::vector<std::vector<uint8_t>> full(ncomp, std::vector<uint8_t>((size_t)width * height));
  if (color) {
    const int32_t SB = 16, HALF = 1 << 15, OFF = 128 << 16;
    auto fix = [](double x) { return (int32_t)(x * 65536.0 + 0.5); };
    const int32_t ry = fix(0.29900), gy = fix(0.58700), by = fix(0.11400);
    const int32_t rcb = -fix(0.16874), gcb = -fix(0.33126), bcb = fix(0.50000);
    const int32_t gcr = -fix(0.41869), bcr = -fix(0.08131);
    for (size_t i = 0; i < (size_t)width * height; ++i) {
      int32_t r = src[3 * i], g = src[3 * i + 1], b = src[3 * i + 2];
      full[0][i] = (uint8_t)((ry * r + gy * g + by * b + HALF) >> SB);
      full[1][i] = (uint8_t)((rcb * r + gcb * g + bcb * b + OFF + HALF - 1) >> SB);
      full[2][i] = (uint8_t)((bcb * r + gcr * g + bcr * b + OFF + HALF - 1) >> SB);
    }
  } else {
    std::memcpy(full[0].data(), src, (size_t)width * height);
  }

  // padded planes: rows padded to a multiple of vmax by replicating the last
  // row (jcprepct.c), columns by replicating the last column (jcsample.c
  // expand_right_edge), downsampled, then rows padded to the iMCU height by
  // replicating the last (downsampled) row
  std::vector<Plane> planes(ncomp);
  int hs[3] = {hmax, 1, 1};
  for (int c = 0; c < ncomp; ++c) {
    Plane& p = planes[c];
    const int wib = (width * hs[c] + 8 * hmax - 1) / (8 * hmax);  // width_in_blocks
    p.w = wib * 8;
    p.h = mcus_y * 8 * hs[c];
    p.px.assign((size_t)p.w * p.h, 0);
    const int in_rows = (height + vmax - 1) / vmax * vmax;
    auto sample = [&](int x, int y) {  // replicated edges of the full plane
      if (x >= width) x = width - 1;
      if (y >= height) y = height - 1;
      return (int)full[c][(size_t)y * width + x];
    };
    int rows_made;
    if (hs[c] == hmax) {  // fullsize_downsample
      rows_made = in_rows;
      for (int y = 0; y < rows_made; ++y)
        for (int x = 0; x < p.w; ++x) p.px[(size_t)y * p.w + x] = (uint8_t)sample(x, y);
    } else {  // h2v2_downsample
      rows_made = in_rows / 2;
      for (int y = 0; y < rows_made; ++y) {
        int bias = 1;
        for (int x = 0; x < p.w; ++x) {
          int s = sample(2 * x, 2 * y) + sample(2 * x + 1, 2 * y) + sample(2 * x, 2 * y + 1) +
                  sample(2 * x + 1, 2 * y + 1);
          p.px[(size_t)y * p.w + x] = (uint8_t)((s + bias) >> 2);
          bias ^= 3;
        }
      }
    }
    for (int y = rows_made; y < p.h; ++y)
      std::memcpy(&p.px[(size_t)y * p.w], &p.px[(size_t)(rows_made - 1) * p.w], p.w);
  }

  uint16_t qt[2][64];
  scaled_qtable(kStdLumaQ, quality, qt[0]);
  scaled_qtable(kStdChromaQ, quality, qt[1]);
  Divisor div[2][64];
  for (int t = 0; t < 2; ++t)
    for (int i = 0; i < 64; ++i) div[t][i] = reciprocal((uint32_t)qt[t][i] << 3);
  HuffCodes dc[2], ac[2];
  dc[0].build(kDcLumaBits, kDcVals);
  ac[0].build(kAcLumaBits, kAcLumaVals);
  dc[1].build(kDcChromaBits, kDcVals);
  ac[1].build(kAcChromaBits, kAcChromaVals);

  std::vector<uint8_t> out;
  out.push_back(0xFF);
  out.push_back(0xD8);
  put_marker_segment(out, 0xE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
  for (int t = 0; t < (color ? 2 : 1); ++t) {
    std::vector<uint8_t> body{(uint8_t)t};
    for (int i = 0; i < 64; ++i) body.push_back((uint8_t)qt[t][kZigzag[i]]);
    put_marker_segment(out, 0xDB, body);
  }
  {
    std::vector<uint8_t> body{8, (uint8_t)(height >> 8), (uint8_t)height, (uint8_t)(width >> 8),
                              (uint8_t)width, (uint8_t)ncomp};
    for (int c = 0; c < ncomp; ++c) {
      body.push_back((uint8_t)(c + 1));
      body.push_back((uint8_t)((hs[c] << 4) | hs[c]));
      body.push_back((uint8_t)(c ? 1 : 0));
    }
    put_marker_segment(out, 0xC0, body);
  }
  const uint8_t* bits_tab[2][2] = {{kDcLumaBits, kAcLumaBits}, {kDcChromaBits, kAcChromaBits}};
  const uint8_t* vals_tab[2][2] = {{kDcVals, kAcLumaVals}, {kDcVals, kAcChromaVals}};
  for (int t = 0; t < (color ? 2 : 1); ++t)
    for (int k = 0; k < 2; ++k) {
      std::vector<uint8_t> body{(uint8_t)((k << 4) | t)};
      int count = 0;
      for (int i = 0; i < 16; ++i) {
        body.push_back(bits_tab[t][k][i]);
        count += bits_tab[t][k][i];
      }
      body.insert(body.end(), vals_tab[t][k], vals_tab[t][k] + count);
      put_marker_segment(out, 0xC4, body);
    }
  {
    std::vector<uint8_t> body{(uint8_t)ncomp};
    for (int c = 0; c < ncomp; ++c) {
      body.push_back((uint8_t)(c + 1));
      body.push_back((uint8_t)(c ? 0x11 : 0x00));
    }
    body.insert(body.end(), {0, 63, 0});
    put_marker_segment(out, 0xDA, body);
  }

  BitWriter bw{out};
  int last_dc[3] = {0, 0, 0};
  auto encode_block = [&](const int16_t* blk, int c) {  // jchuff.c encode_one_block
    const int t = c ? 1 : 0;
    int diff = blk[0] - last_dc[c];
    last_dc[c] = blk[0];
    int nb = bit_count(diff);
    bw.put(dc[t].code[nb], dc[t].len[nb]);
    if (nb) bw.put((uint32_t)(diff < 0 ? diff - 1 : diff) & ((1u << nb) - 1), nb);
    int run = 0;
    for (int k = 1; k < 64; ++k) {
      int v = blk[kZigzag[k]];
      if (v == 0) {
        ++run;
        continue;
      }
      while (run > 15) {
        bw.put(ac[t].code[0xF0], ac[t].len[0xF0]);
        run -= 16;
      }
      nb = bit_count(v);
      int sym = (run << 4) | nb;
      bw.put(ac[t].code[sym], ac[t].len[sym]);
      bw.put((uint32_t)(v < 0 ? v - 1 : v) & ((1u << nb) - 1), nb);
      run = 0;
    }
    if (run > 0) bw.put(ac[t].code[0], ac[t].len[0]);
  };
  auto forward_block = [&](const Plane& p, int bx, int by, int t, int16_t* blk) {
    int32_t ws[64];
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        ws[y * 8 + x] = (int32_t)p.px[(size_t)(by * 8 + y) * p.w + bx * 8 + x] - 128;
    fdct_islow(ws);
    for (int i = 0; i < 64; ++i) {
      const Divisor& d = div[t][i];
      uint32_t a = (uint32_t)(ws[i] < 0 ? -ws[i] : ws[i]);
      int32_t qv = (int32_t)(((uint64_t)(a + d.corr) * d.recip) >> d.shift);
      blk[i] = (int16_t)(ws[i] < 0 ? -qv : qv);
    }
  };

  int16_t mcu[6][64];
  for (int my = 0; my < mcus_y; ++my)
    for (int mx = 0; mx < mcus_x; ++mx) {
      int blkn = 0;
      for (int c = 0; c < ncomp; ++c) {
        const Plane& p = planes[c];
        const int wib = p.w / 8, hib = (height * hs[c] + 8 * vmax - 1) / (8 * vmax);
        for (int yi = 0; yi < hs[c]; ++yi) {
          const int by = my * hs[c] + yi;
          for (int xi = 0; xi < hs[c]; ++xi, ++blkn) {
            const int bx = mx * hs[c] + xi;
            if (by < hib && bx < wib) {
              forward_block(p, bx, by, c ? 1 : 0, mcu[blkn]);
            } else {  // dummy block: zeros, the DC of the block before it
              std::memset(mcu[blkn], 0, sizeof(mcu[blkn]));
              mcu[blkn][0] = by < hib ? mcu[blkn - 1][0] : mcu[blkn - xi - 1][0];
            }
          }
        }
      }
      blkn = 0;
      for (int c = 0; c < ncomp; ++c)
        for (int i = 0; i < hs[c] * hs[c]; ++i) encode_block(mcu[blkn++], c);
    }
  bw.flush();
  out.push_back(0xFF);
  out.push_back(0xD9);
  return out;
}

void copy_error(const std::string& msg, char* err, int errlen) {
  if (errlen <= 0) return;
  std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

}  // namespace

extern "C" {

// (width, height, channels) of a JPEG's frame header; 0 on success, else 1
// with a message in err
int ngm_jpeg_info(const uint8_t* data, size_t n, int* width, int* height, int* channels,
                  char* err, int errlen) {
  try {
    Decoder dec{data, n};
    dec.parse(true);
    *width = dec.width;
    *height = dec.height;
    *channels = dec.ncomp;
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  }
}

// decode into out (height * width * channels bytes, row-major, RGB or gray)
int ngm_jpeg_decode(const uint8_t* data, size_t n, uint8_t* out, size_t out_len, char* err,
                    int errlen) {
  try {
    Decoder dec{data, n};
    dec.parse(false);
    if ((size_t)dec.width * dec.height * dec.ncomp != out_len) fail("output buffer size mismatch");
    dec.output(out);
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
    return 1;
  }
}

// encode (height, width, channels) uint8 samples (gray or RGB) as a baseline
// JPEG at quality; the file's bytes go to out when they fit out_cap, and
// their count to out_len either way. 0 on success, 2 when out is too small,
// 1 with a message in err on an error
int ngm_jpeg_encode(const uint8_t* pixels, int width, int height, int channels, int quality,
                    uint8_t* out, size_t out_cap, size_t* out_len, char* err, int errlen) {
  try {
    std::vector<uint8_t> file = encode_jpeg(pixels, width, height, channels, quality);
    *out_len = file.size();
    if (file.size() > out_cap) return 2;
    std::memcpy(out, file.data(), file.size());
    return 0;
  } catch (const Error& e) {
    copy_error(e.msg, err, errlen);
    return 1;
  } catch (const std::bad_alloc&) {
    copy_error("out of memory", err, errlen);
    return 1;
  }
}
}
