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
}
