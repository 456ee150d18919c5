// Baseline JPEG decoder and encoder, host C++ bound through ctypes
// (street_sparse_3dgs_tpu_torch/data/jpeg.py).
//
// Decoder: sequential Huffman JPEG, 8-bit samples, 1 or 3 components,
// sampling 4:4:4, 4:2:2, 4:2:0 (and 4:4:0), restart intervals, any size.
// Its output is what libjpeg-turbo gives with its defaults (what
// np.asarray(PIL.Image.open(path)) returns): the accurate integer inverse
// DCT (jidctint.c, "islow"), fancy (triangle) chroma upsampling
// (jdsample.c: h2v1, h2v2 and h1v2 fancy, edge rows and columns
// replicated as jdmainct.c does), and the fixed-point YCbCr->RGB tables
// of jdcolor.c.  Progressive, lossless, hierarchical, arithmetic-coded and
// 12-bit files are refused with a message.
//
// Encoder: baseline, YCbCr 4:2:0 (libjpeg's default and PIL's) or 4:4:4
// (1 component for grey), the IJG quality-scaled standard quantization
// tables and the standard Huffman tables of ITU-T T.81 Annex K, a JFIF
// APP0 header.
//
// Build: g++ -O2 -shared -fPIC jpeg_codec.cpp -o libjpeg_codec.so

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

const int kZigzag[64 + 16] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    // k past 63 on corrupt data lands on the last coefficient (jutils.c)
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

struct Error {
  char msg[256];
};

void fail(Error* e, const char* what) {
  std::snprintf(e->msg, sizeof(e->msg), "%s", what);
}

// ------------------------------------------------------------ Huffman

struct Huff {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
  int32_t maxcode[18];
  int32_t valoff[18];
  // 9-bit lookahead: (length << 8) | value, 0 when longer than 9 bits
  uint16_t look[512];

  bool build() {
    int code = 0, k = 0;
    int huffcode[257];
    uint8_t huffsize[257];
    for (int l = 1; l <= 16; ++l)
      for (int i = 0; i < bits[l]; ++i) huffsize[k++] = (uint8_t)l;
    if (k > 256) return false;
    huffsize[k] = 0;
    int n = k;
    k = 0;
    int si = huffsize[0];
    while (k < n && huffsize[k]) {
      while (k < n && huffsize[k] == si) huffcode[k++] = code++;
      if (code >= (1 << si)) return false;
      code <<= 1;
      ++si;
    }
    int p = 0;
    for (int l = 1; l <= 16; ++l) {
      if (bits[l]) {
        valoff[l] = p - huffcode[p];
        p += bits[l];
        maxcode[l] = huffcode[p - 1];
      } else {
        maxcode[l] = -1;
      }
    }
    maxcode[17] = 0x7fffffff;
    std::memset(look, 0, sizeof(look));
    p = 0;
    for (int l = 1; l <= 9; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++p) {
        int lookbits = huffcode[p] << (9 - l);
        for (int c = 0; c < (1 << (9 - l)); ++c)
          look[lookbits + c] = (uint16_t)((l << 8) | vals[p]);
      }
    }
    defined = true;
    return true;
  }
};

// ------------------------------------------------------------ bit reader

struct Bits {
  const uint8_t* data;
  int64_t len;
  int64_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  bool hit_marker = false;

  void fill() {
    while (nbits <= 56) {
      uint8_t byte = 0;
      if (!hit_marker && pos < len) {
        byte = data[pos];
        if (byte == 0xFF) {
          int64_t q = pos + 1;
          while (q < len && data[q] == 0xFF) ++q;  // fill bytes
          if (q < len && data[q] == 0x00) {
            pos = q + 1;
          } else {
            hit_marker = true;  // a marker: feed zeros from here (libjpeg)
            byte = 0;
          }
        } else {
          ++pos;
        }
      }
      acc |= (uint64_t)byte << (56 - nbits);
      nbits += 8;
    }
  }
  int get(int n) {
    if (n == 0) return 0;
    if (nbits < n) fill();
    int v = (int)(acc >> (64 - n));
    acc <<= n;
    nbits -= n;
    return v;
  }
  int decode(const Huff& h) {
    if (nbits < 16) fill();
    int peek = (int)(acc >> (64 - 9));
    uint16_t e = h.look[peek];
    if (e) {
      int l = e >> 8;
      acc <<= l;
      nbits -= l;
      return e & 0xFF;
    }
    int code = get(9);
    int l = 9;
    while (l < 16 && code > h.maxcode[l]) {
      code = (code << 1) | get(1);
      ++l;
    }
    if (code > h.maxcode[l]) return 0;  // corrupt: libjpeg returns 0 too
    return h.vals[(h.valoff[l] + code) & 0xFF];
  }
  // Skip to the restart marker that ends this interval.
  void restart() {
    acc = 0;
    nbits = 0;
    if (!hit_marker) {
      while (pos < len && !(data[pos] == 0xFF && pos + 1 < len &&
                            data[pos + 1] >= 0xD0 && data[pos + 1] <= 0xD7))
        ++pos;
    } else {
      // pos sits on the 0xFF of the marker that stopped the reader
      while (pos < len && data[pos] != 0xFF) ++pos;
    }
    while (pos < len && data[pos] == 0xFF) ++pos;
    if (pos < len && data[pos] >= 0xD0 && data[pos] <= 0xD7) ++pos;
    hit_marker = false;
  }
};

inline int extend(int v, int s) {
  return v < (1 << (s - 1)) ? v - (1 << s) + 1 : v;
}

// ------------------------------------------------------------ islow IDCT

const int CONST_BITS = 13, PASS1_BITS = 2;
const int64_t F0298 = 2446, F0390 = 3196, F0541 = 4433, F0765 = 6270,
              F0899 = 7373, F1175 = 9633, F1501 = 12299, F1847 = 15137,
              F1961 = 16069, F2053 = 16819, F2562 = 20995, F3072 = 25172;

inline int64_t descale(int64_t x, int n) {
  return (x + ((int64_t)1 << (n - 1))) >> n;
}

// The post-IDCT range limit of jdmaster.c: x + 128 clamped, on x & 1023.
inline uint8_t idct_limit(int64_t x) {
  int m = (int)(x & 1023);
  if (m < 128) return (uint8_t)(m + 128);
  if (m < 512) return 255;
  if (m < 896) return 0;
  return (uint8_t)(m - 896);
}

void idct_islow(const int16_t* coef, const uint16_t* q, uint8_t* out,
                int stride) {
  int ws[64];
  for (int c = 0; c < 8; ++c) {
    const int16_t* in = coef + c;
    const uint16_t* qt = q + c;
    int* w = ws + c;
    if (!in[8] && !in[16] && !in[24] && !in[32] && !in[40] && !in[48] &&
        !in[56]) {
      int dc = (int)in[0] * qt[0] * (1 << PASS1_BITS);
      for (int r = 0; r < 8; ++r) w[8 * r] = dc;
      continue;
    }
    int64_t z2 = (int64_t)in[16] * qt[16], z3 = (int64_t)in[48] * qt[48];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    z2 = (int64_t)in[0] * qt[0];
    z3 = (int64_t)in[32] * qt[32];
    int64_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int64_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = (int64_t)in[56] * qt[56];
    tmp1 = (int64_t)in[40] * qt[40];
    tmp2 = (int64_t)in[24] * qt[24];
    tmp3 = (int64_t)in[8] * qt[8];
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
    const int n = CONST_BITS - PASS1_BITS;
    w[0] = (int)descale(tmp10 + tmp3, n);
    w[56] = (int)descale(tmp10 - tmp3, n);
    w[8] = (int)descale(tmp11 + tmp2, n);
    w[48] = (int)descale(tmp11 - tmp2, n);
    w[16] = (int)descale(tmp12 + tmp1, n);
    w[40] = (int)descale(tmp12 - tmp1, n);
    w[24] = (int)descale(tmp13 + tmp0, n);
    w[32] = (int)descale(tmp13 - tmp0, n);
  }
  for (int r = 0; r < 8; ++r) {
    const int* w = ws + 8 * r;
    uint8_t* o = out + (int64_t)r * stride;
    if (!w[1] && !w[2] && !w[3] && !w[4] && !w[5] && !w[6] && !w[7]) {
      uint8_t v = idct_limit(descale(w[0], PASS1_BITS + 3));
      for (int c = 0; c < 8; ++c) o[c] = v;
      continue;
    }
    int64_t z2 = w[2], z3 = w[6];
    int64_t z1 = (z2 + z3) * F0541;
    int64_t tmp2 = z1 + z3 * (-F1847);
    int64_t tmp3 = z1 + z2 * F0765;
    int64_t tmp0 = ((int64_t)w[0] + w[4]) * (1 << CONST_BITS);
    int64_t tmp1 = ((int64_t)w[0] - w[4]) * (1 << CONST_BITS);
    int64_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
    int64_t tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
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
    const int n = CONST_BITS + PASS1_BITS + 3;
    o[0] = idct_limit(descale(tmp10 + tmp3, n));
    o[7] = idct_limit(descale(tmp10 - tmp3, n));
    o[1] = idct_limit(descale(tmp11 + tmp2, n));
    o[6] = idct_limit(descale(tmp11 - tmp2, n));
    o[2] = idct_limit(descale(tmp12 + tmp1, n));
    o[5] = idct_limit(descale(tmp12 - tmp1, n));
    o[3] = idct_limit(descale(tmp13 + tmp0, n));
    o[4] = idct_limit(descale(tmp13 - tmp0, n));
  }
}

// ------------------------------------------------------------ decoder

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int td = 0, ta = 0;
  int width = 0, height = 0;    // downsampled size (ceil)
  int bw = 0, bh = 0;           // blocks per row / column in the plane
  std::vector<uint8_t> plane;   // bw*8 x bh*8 samples
  int pred = 0;
};

struct Decoder {
  const uint8_t* data;
  int64_t len;
  Error* err;
  int width = 0, height = 0, ncomp = 0;
  int hmax = 1, vmax = 1, mcux = 0, mcuy = 0;
  int restart_interval = 0;
  bool saw_frame = false, saw_jfif = false, saw_adobe = false;
  int adobe_transform = -1;
  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  Huff dc[4], ac[4];
  Component comp[3];

  int u16(int64_t p) { return (data[p] << 8) | data[p + 1]; }

  bool parse_dqt(int64_t p, int64_t end) {
    while (p < end) {
      int pq = data[p] >> 4, tq = data[p] & 15;
      ++p;
      if (tq > 3) return fail(err, "DQT: table id over 3"), false;
      for (int i = 0; i < 64; ++i) {
        int v;
        if (pq) {
          if (p + 1 >= end) return fail(err, "DQT: truncated"), false;
          v = u16(p);
          p += 2;
        } else {
          if (p >= end) return fail(err, "DQT: truncated"), false;
          v = data[p++];
        }
        qt[tq][kZigzag[i]] = (uint16_t)v;
      }
      qt_defined[tq] = true;
    }
    return true;
  }

  bool parse_dht(int64_t p, int64_t end) {
    while (p < end) {
      int tc = data[p] >> 4, th = data[p] & 15;
      ++p;
      if (tc > 1 || th > 3) return fail(err, "DHT: bad table class/id"), false;
      Huff& hf = tc ? ac[th] : dc[th];
      int total = 0;
      if (p + 16 > end) return fail(err, "DHT: truncated"), false;
      for (int l = 1; l <= 16; ++l) {
        hf.bits[l] = data[p++];
        total += hf.bits[l];
      }
      if (total > 256 || p + total > end)
        return fail(err, "DHT: bad code count"), false;
      for (int i = 0; i < total; ++i) hf.vals[i] = data[p++];
      if (!hf.build()) return fail(err, "DHT: bad Huffman table"), false;
    }
    return true;
  }

  bool parse_sof(int64_t p, int64_t end) {
    if (saw_frame) return fail(err, "two frame headers"), false;
    if (end - p < 6) return fail(err, "SOF: truncated"), false;
    int precision = data[p];
    if (precision != 8)
      return fail(err, "sample precision other than 8 bits is not "
                       "supported"), false;
    height = u16(p + 1);
    width = u16(p + 3);
    ncomp = data[p + 5];
    if (width == 0 || height == 0)
      return fail(err, "zero image size (DNL not supported)"), false;
    if (ncomp != 1 && ncomp != 3)
      return fail(err, "only 1 or 3 components are supported"), false;
    if (end - p < 6 + 3 * ncomp) return fail(err, "SOF: truncated"), false;
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      c.id = data[p + 6 + 3 * i];
      c.h = data[p + 7 + 3 * i] >> 4;
      c.v = data[p + 7 + 3 * i] & 15;
      c.tq = data[p + 8 + 3 * i];
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4 || c.tq > 3)
        return fail(err, "SOF: bad sampling factor or table"), false;
      if (c.h > hmax) hmax = c.h;
      if (c.v > vmax) vmax = c.v;
    }
    mcux = (width + 8 * hmax - 1) / (8 * hmax);
    mcuy = (height + 8 * vmax - 1) / (8 * vmax);
    for (int i = 0; i < ncomp; ++i) {
      Component& c = comp[i];
      int eh = hmax / c.h, ev = vmax / c.v;
      if (hmax % c.h || vmax % c.v || eh > 2 || ev > 2)
        return fail(err, "sampling other than 4:4:4, 4:2:2, 4:2:0 or "
                         "4:4:0 is not supported"), false;
      c.width = (int)(((int64_t)width * c.h + hmax - 1) / hmax);
      c.height = (int)(((int64_t)height * c.v + vmax - 1) / vmax);
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.plane.assign((size_t)c.bw * 8 * c.bh * 8, 0);
    }
    saw_frame = true;
    return true;
  }

  bool decode_block(Bits& br, Component& c, int16_t* blk) {
    std::memset(blk, 0, 64 * sizeof(int16_t));
    const Huff& hd = dc[c.td];
    const Huff& ha = ac[c.ta];
    int t = br.decode(hd);
    if (t > 15) return fail(err, "corrupt DC code"), false;
    int diff = t ? extend(br.get(t), t) : 0;
    c.pred += diff;
    blk[0] = (int16_t)c.pred;
    for (int k = 1; k < 64;) {
      int rs = br.decode(ha);
      int r = rs >> 4, s = rs & 15;
      if (s) {
        k += r;
        blk[kZigzag[k]] = (int16_t)extend(br.get(s), s);
        ++k;
      } else {
        if (r != 15) break;
        k += 16;
      }
    }
    return true;
  }

  void put_block(Component& c, const int16_t* blk, int bx, int by) {
    int stride = c.bw * 8;
    idct_islow(blk, qt[c.tq], c.plane.data() + (int64_t)by * 8 * stride +
                                  bx * 8, stride);
  }

  // Returns the position just past the scan's entropy-coded data.
  int64_t decode_scan(int64_t p, int64_t hdr_end) {
    int ns = data[p];
    if (ns < 1 || ns > ncomp || hdr_end - p < 4 + 2 * ns)
      return fail(err, "SOS: bad component count"), -1;
    Component* sc[3];
    for (int i = 0; i < ns; ++i) {
      int cid = data[p + 1 + 2 * i];
      Component* found = nullptr;
      for (int j = 0; j < ncomp; ++j)
        if (comp[j].id == cid) found = &comp[j];
      if (!found) return fail(err, "SOS: unknown component"), -1;
      found->td = data[p + 2 + 2 * i] >> 4;
      found->ta = data[p + 2 + 2 * i] & 15;
      if (found->td > 3 || found->ta > 3 || !dc[found->td].defined ||
          !ac[found->ta].defined)
        return fail(err, "SOS: Huffman table not defined"), -1;
      if (!qt_defined[found->tq])
        return fail(err, "quantization table not defined"), -1;
      sc[i] = found;
    }
    int ss = data[p + 1 + 2 * ns], se = data[p + 2 + 2 * ns];
    int ahal = data[p + 3 + 2 * ns];
    if (ss != 0 || se != 63 || ahal != 0)
      return fail(err, "SOS: spectral selection of a non-sequential "
                       "scan"), -1;
    Bits br{data, len, hdr_end};
    for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
    int16_t blk[64];
    int64_t n_units, units_x;
    if (ns == 1) {
      Component& c = *sc[0];
      units_x = (c.width + 7) / 8;
      n_units = units_x * (int64_t)((c.height + 7) / 8);
    } else {
      units_x = mcux;
      n_units = (int64_t)mcux * mcuy;
    }
    int64_t todo = restart_interval;
    for (int64_t u = 0; u < n_units; ++u) {
      if (restart_interval) {
        if (todo == 0) {
          br.restart();
          for (int i = 0; i < ns; ++i) sc[i]->pred = 0;
          todo = restart_interval;
        }
        --todo;
      }
      int ux = (int)(u % units_x), uy = (int)(u / units_x);
      if (ns == 1) {
        if (!decode_block(br, *sc[0], blk)) return -1;
        put_block(*sc[0], blk, ux, uy);
      } else {
        for (int i = 0; i < ns; ++i) {
          Component& c = *sc[i];
          for (int by = 0; by < c.v; ++by)
            for (int bx = 0; bx < c.h; ++bx) {
              if (!decode_block(br, c, blk)) return -1;
              put_block(c, blk, ux * c.h + bx, uy * c.v + by);
            }
        }
      }
    }
    // Step to the next marker.
    int64_t q = br.pos;
    while (q < len && !(data[q] == 0xFF && q + 1 < len && data[q + 1] != 0 &&
                        !(data[q + 1] >= 0xD0 && data[q + 1] <= 0xD7) &&
                        data[q + 1] != 0xFF))
      ++q;
    return q;
  }

  // The markers and, unless header_only, the scans (header_only stops at
  // the first scan, once the frame header is known).
  bool parse(bool header_only) {
    if (len < 4 || data[0] != 0xFF || data[1] != 0xD8)
      return fail(err, "not a JPEG file (no SOI marker)"), false;
    int64_t p = 2;
    bool scanned = false;
    while (p < len) {
      if (data[p] != 0xFF) {
        ++p;
        continue;
      }
      while (p < len && data[p] == 0xFF) ++p;
      if (p >= len) break;
      int m = data[p++];
      if (m == 0xD9) break;                       // EOI
      if (m == 0xD8 || (m >= 0xD0 && m <= 0xD7) || m == 0x01) continue;
      if (p + 2 > len) return fail(err, "truncated marker"), false;
      int seg = u16(p);
      int64_t body = p + 2, end = p + seg;
      if (seg < 2 || end > len) return fail(err, "truncated segment"), false;
      if (m == 0xC0 || m == 0xC1) {
        if (!parse_sof(body, end)) return false;
      } else if (m == 0xC2 || m == 0xC6) {
        return fail(err, "progressive JPEG is not supported"), false;
      } else if (m == 0xC3 || m == 0xC7 || m == 0xCB || m == 0xCF) {
        return fail(err, "lossless JPEG is not supported"), false;
      } else if (m == 0xC5) {
        return fail(err, "hierarchical JPEG is not supported"), false;
      } else if (m == 0xC9 || m == 0xCA || m == 0xCD || m == 0xCE ||
                 m == 0xCC) {
        return fail(err, "arithmetic-coded JPEG is not supported"), false;
      } else if (m == 0xC4) {
        if (!parse_dht(body, end)) return false;
      } else if (m == 0xDB) {
        if (!parse_dqt(body, end)) return false;
      } else if (m == 0xDD) {
        if (seg < 4) return fail(err, "DRI: truncated"), false;
        restart_interval = u16(body);
      } else if (m == 0xE0) {
        if (seg >= 7 && std::memcmp(data + body, "JFIF\0", 5) == 0)
          saw_jfif = true;
      } else if (m == 0xEE) {
        if (seg >= 14 && std::memcmp(data + body, "Adobe", 5) == 0) {
          saw_adobe = true;
          adobe_transform = data[body + 11];
        }
      } else if (m == 0xDA) {
        if (!saw_frame) return fail(err, "scan before frame header"), false;
        if (header_only) return true;
        int64_t q = decode_scan(body, end);
        if (q < 0) return false;
        scanned = true;
        p = q;
        continue;
      }
      p = end;
    }
    if (!saw_frame) return fail(err, "no frame header"), false;
    if (!scanned && !header_only) return fail(err, "no scan"), false;
    return true;
  }

  bool is_rgb() const {
    if (ncomp != 3) return false;
    if (comp[0].id == 1 && comp[1].id == 2 && comp[2].id == 3) return false;
    if (comp[0].id == 'R' && comp[1].id == 'G' && comp[2].id == 'B')
      return true;
    if (saw_jfif) return false;
    if (saw_adobe) return adobe_transform == 0;
    return false;
  }

  // Upsample component c to full size into out (width x height).
  void upsample(const Component& c, uint8_t* out) const {
    const int stride = c.bw * 8;
    const uint8_t* pl = c.plane.data();
    const int eh = hmax / c.h, ev = vmax / c.v;
    const int cw = c.width, ch = c.height;
    std::vector<uint8_t> row(2 * (size_t)cw + 2);
    std::vector<int> colsum(cw);
    for (int y = 0; y < height; ++y) {
      uint8_t* o = out + (int64_t)y * width;
      if (eh == 1 && ev == 1) {
        std::memcpy(o, pl + (int64_t)y * stride, width);
        continue;
      }
      int iy = y / ev;
      const uint8_t* r0 = pl + (int64_t)iy * stride;
      if (ev == 2) {
        // nearest row and the next nearest, replicated at the edges
        int ny = (y & 1) ? (iy + 1 < ch ? iy + 1 : ch - 1)
                         : (iy > 0 ? iy - 1 : 0);
        const uint8_t* r1 = pl + (int64_t)ny * stride;
        if (eh == 1) {                     // h1v2 fancy
          int bias = (y & 1) ? 2 : 1;
          for (int x = 0; x < width; ++x)
            o[x] = (uint8_t)((r0[x] * 3 + r1[x] + bias) >> 2);
          continue;
        }
        if (cw <= 2) {                     // h2v2 plain replication
          for (int x = 0; x < width; ++x) o[x] = r0[x >> 1];
          continue;
        }
        for (int x = 0; x < cw; ++x) colsum[x] = r0[x] * 3 + r1[x];
        uint8_t* rp = row.data();
        rp[0] = (uint8_t)((colsum[0] * 4 + 8) >> 4);
        rp[1] = (uint8_t)((colsum[0] * 3 + colsum[1] + 7) >> 4);
        for (int x = 1; x < cw - 1; ++x) {
          rp[2 * x] = (uint8_t)((colsum[x] * 3 + colsum[x - 1] + 8) >> 4);
          rp[2 * x + 1] = (uint8_t)((colsum[x] * 3 + colsum[x + 1] + 7) >> 4);
        }
        rp[2 * cw - 2] =
            (uint8_t)((colsum[cw - 1] * 3 + colsum[cw - 2] + 8) >> 4);
        rp[2 * cw - 1] = (uint8_t)((colsum[cw - 1] * 4 + 7) >> 4);
        std::memcpy(o, rp, width);
      } else {                             // eh == 2, ev == 1
        if (cw <= 2) {                     // h2v1 plain replication
          for (int x = 0; x < width; ++x) o[x] = r0[x >> 1];
          continue;
        }
        uint8_t* rp = row.data();
        rp[0] = r0[0];
        rp[1] = (uint8_t)((r0[0] * 3 + r0[1] + 2) >> 2);
        for (int x = 1; x < cw - 1; ++x) {
          int v = r0[x] * 3;
          rp[2 * x] = (uint8_t)((v + r0[x - 1] + 1) >> 2);
          rp[2 * x + 1] = (uint8_t)((v + r0[x + 1] + 2) >> 2);
        }
        rp[2 * cw - 2] = (uint8_t)((r0[cw - 1] * 3 + r0[cw - 2] + 1) >> 2);
        rp[2 * cw - 1] = r0[cw - 1];
        std::memcpy(o, rp, width);
      }
    }
  }

  void output(uint8_t* out) const {
    const int64_t n = (int64_t)width * height;
    if (ncomp == 1) {
      upsample(comp[0], out);
      return;
    }
    std::vector<uint8_t> planes[3];
    for (int i = 0; i < 3; ++i) {
      planes[i].resize(n);
      upsample(comp[i], planes[i].data());
    }
    if (is_rgb()) {
      for (int64_t i = 0; i < n; ++i)
        for (int k = 0; k < 3; ++k) out[3 * i + k] = planes[k][i];
      return;
    }
    // jdcolor.c build_ycc_rgb_table, SCALEBITS 16
    const int64_t ONE_HALF = (int64_t)1 << 15;
    auto fix = [](double x) { return (int64_t)(x * 65536.0 + 0.5); };
    int cr_r[256], cb_b[256];
    int64_t cr_g[256], cb_g[256];
    for (int i = 0; i < 256; ++i) {
      int64_t x = i - 128;
      cr_r[i] = (int)((fix(1.40200) * x + ONE_HALF) >> 16);
      cb_b[i] = (int)((fix(1.77200) * x + ONE_HALF) >> 16);
      cr_g[i] = -fix(0.71414) * x;
      cb_g[i] = -fix(0.34414) * x + ONE_HALF;
    }
    auto clamp = [](int v) -> uint8_t {
      return (uint8_t)(v < 0 ? 0 : (v > 255 ? 255 : v));
    };
    const uint8_t *Y = planes[0].data(), *Cb = planes[1].data(),
                  *Cr = planes[2].data();
    for (int64_t i = 0; i < n; ++i) {
      int y = Y[i], cb = Cb[i], cr = Cr[i];
      out[3 * i] = clamp(y + cr_r[cr]);
      out[3 * i + 1] = clamp(y + (int)((cb_g[cb] + cr_g[cr]) >> 16));
      out[3 * i + 2] = clamp(y + cb_b[cb]);
    }
  }
};

// ------------------------------------------------------------ encoder

const uint8_t kStdLumQ[64] = {
    16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,  58,  60,  55,
    14, 13, 16, 24, 40,  57,  69,  56,  14, 17, 22, 29, 51,  87,  80,  62,
    18, 22, 37, 56, 68,  109, 103, 77,  24, 35, 55, 64, 81,  104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

const uint8_t kDcLumBits[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kDcChromBits[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumBits[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kAcLumVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08,
    0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52, 0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7a, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a, 0xa2, 0xa3,
    0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9,
    0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2,
    0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kAcChromBits[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kAcChromVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33, 0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1,
    0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18, 0x19, 0x1a, 0x26,
    0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5a, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9a,
    0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7,
    0xc8, 0xc9, 0xca, 0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda,
    0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4,
    0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

struct Code {
  uint16_t code[256];
  uint8_t size[256];
  void build(const uint8_t* bits, const uint8_t* vals) {
    std::memset(size, 0, sizeof(size));
    int code_v = 0, k = 0;
    for (int l = 1; l <= 16; ++l) {
      for (int i = 0; i < bits[l]; ++i, ++k) {
        code[vals[k]] = (uint16_t)code_v++;
        size[vals[k]] = (uint8_t)l;
      }
      code_v <<= 1;
    }
  }
};

struct Writer {
  std::vector<uint8_t> out;
  uint32_t acc = 0;
  int nbits = 0;
  void byte(uint8_t b) { out.push_back(b); }
  void u16(int v) {
    byte((uint8_t)(v >> 8));
    byte((uint8_t)v);
  }
  void put(uint32_t v, int n) {
    acc = (acc << n) | (v & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
  }
  void flush() {
    if (nbits) put(0x7F, 8 - nbits);  // pad with one-bits
  }
};

void quant_table(const uint8_t* base, int quality, uint16_t* q) {
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

// jfdctflt.c's AAN float forward DCT on an 8x8 block in place, then
// quantisation with jcdctmgr.c's float divisors (1 / (q * aan[u] * aan[v]
// * 8)), rounded to nearest.
const float kAanScale[8] = {1.0f,         1.387039845f, 1.306562965f,
                            1.175875602f, 1.0f,         0.785694958f,
                            0.541196100f, 0.275899379f};

inline void aan_1d(float* d, int s) {
  float tmp0 = d[0] + d[7 * s], tmp7 = d[0] - d[7 * s];
  float tmp1 = d[s] + d[6 * s], tmp6 = d[s] - d[6 * s];
  float tmp2 = d[2 * s] + d[5 * s], tmp5 = d[2 * s] - d[5 * s];
  float tmp3 = d[3 * s] + d[4 * s], tmp4 = d[3 * s] - d[4 * s];
  float tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3;
  float tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  d[0] = tmp10 + tmp11;
  d[4 * s] = tmp10 - tmp11;
  float z1 = (tmp12 + tmp13) * 0.707106781f;
  d[2 * s] = tmp13 + z1;
  d[6 * s] = tmp13 - z1;
  tmp10 = tmp4 + tmp5;
  tmp11 = tmp5 + tmp6;
  tmp12 = tmp6 + tmp7;
  float z5 = (tmp10 - tmp12) * 0.382683433f;
  float z2 = 0.541196100f * tmp10 + z5;
  float z4 = 1.306562965f * tmp12 + z5;
  float z3 = tmp11 * 0.707106781f;
  float z11 = tmp7 + z3, z13 = tmp7 - z3;
  d[5 * s] = z13 + z2;
  d[3 * s] = z13 - z2;
  d[s] = z11 + z4;
  d[7 * s] = z11 - z4;
}

void quant_divisors(const uint16_t* q, float* div) {
  for (int v = 0; v < 8; ++v)
    for (int u = 0; u < 8; ++u)
      div[8 * v + u] =
          1.0f / ((float)q[8 * v + u] * kAanScale[v] * kAanScale[u] * 8.0f);
}

void fdct_quant(float* blk, const float* div, int* out) {
  for (int r = 0; r < 8; ++r) aan_1d(blk + 8 * r, 1);
  for (int c = 0; c < 8; ++c) aan_1d(blk + c, 8);
  for (int i = 0; i < 64; ++i)
    out[i] = (int)(blk[i] * div[i] + 16384.5f) - 16384;
}

void encode_block(Writer& w, const int* coef, int& pred, const Code& dcc,
                  const Code& acc) {
  auto nbits_of = [](int v) {
    int a = v < 0 ? -v : v, n = 0;
    while (a) {
      ++n;
      a >>= 1;
    }
    return n;
  };
  int diff = coef[0] - pred;
  pred = coef[0];
  int s = nbits_of(diff);
  w.put(dcc.code[s], dcc.size[s]);
  if (s) w.put((uint32_t)(diff < 0 ? diff - 1 : diff), s);
  int run = 0;
  for (int k = 1; k < 64; ++k) {
    int v = coef[kZigzag[k]];
    if (v == 0) {
      ++run;
      continue;
    }
    while (run > 15) {
      w.put(acc.code[0xF0], acc.size[0xF0]);
      run -= 16;
    }
    int n = nbits_of(v);
    int rs = (run << 4) | n;
    w.put(acc.code[rs], acc.size[rs]);
    w.put((uint32_t)(v < 0 ? v - 1 : v), n);
    run = 0;
  }
  if (run) w.put(acc.code[0x00], acc.size[0x00]);
}

void write_dht(Writer& w, int cls_id, const uint8_t* bits,
               const uint8_t* vals) {
  int total = 0;
  for (int l = 1; l <= 16; ++l) total += bits[l];
  w.byte(0xFF);
  w.byte(0xC4);
  w.u16(2 + 1 + 16 + total);
  w.byte((uint8_t)cls_id);
  for (int l = 1; l <= 16; ++l) w.byte(bits[l]);
  for (int i = 0; i < total; ++i) w.byte(vals[i]);
}

}  // namespace

extern "C" {

// Header of a JPEG in memory: width, height, components (1 or 3).
// 0 on success; otherwise -1 and a message in err (errlen bytes).
int jpeg_info(const uint8_t* data, int64_t len, int* width, int* height,
              int* ncomp, char* err, int errlen) {
  Error e{};
  Decoder* d = new Decoder();
  d->data = data;
  d->len = len;
  d->err = &e;
  int rc = d->parse(true) ? 0 : -1;
  if (rc == 0) {
    *width = d->width;
    *height = d->height;
    *ncomp = d->ncomp;
  } else if (errlen > 0) {
    std::snprintf(err, errlen, "%s", e.msg);
  }
  delete d;
  return rc;
}

// Decode a JPEG into out ([height, width, ncomp] uint8, sized from
// jpeg_info).  0 on success; otherwise -1 and a message in err.
int jpeg_decode(const uint8_t* data, int64_t len, uint8_t* out, char* err,
                int errlen) {
  Error e{};
  Decoder* d = new Decoder();
  d->data = data;
  d->len = len;
  d->err = &e;
  int rc = d->parse(false) ? 0 : -1;
  if (rc == 0) d->output(out);
  if (rc != 0 && errlen > 0) std::snprintf(err, errlen, "%s", e.msg);
  delete d;
  return rc;
}

// Encode [height, width, ncomp] uint8 (ncomp 1 or 3) as a baseline JPEG
// at IJG quality `quality` (3 components: YCbCr, chroma halved in both
// directions when subsample is nonzero (4:2:0), else full (4:4:4)).
// Returns the byte count written into out, or -(bytes needed) when cap is
// too small, or 0 on bad arguments.
int64_t jpeg_encode(const uint8_t* img, int width, int height, int ncomp,
                    int quality, int subsample, uint8_t* out, int64_t cap) {
  if (width <= 0 || height <= 0 || width > 65535 || height > 65535 ||
      (ncomp != 1 && ncomp != 3))
    return 0;
  uint16_t q[2][64];
  quant_table(kStdLumQ, quality, q[0]);
  quant_table(kStdChromQ, quality, q[1]);
  float div[2][64];
  quant_divisors(q[0], div[0]);
  quant_divisors(q[1], div[1]);
  Code dcc[2], acc[2];
  dcc[0].build(kDcLumBits, kDcVals);
  dcc[1].build(kDcChromBits, kDcVals);
  acc[0].build(kAcLumBits, kAcLumVals);
  acc[1].build(kAcChromBits, kAcChromVals);
  const int hs = ncomp == 3 && subsample ? 2 : 1;  // luma sampling factor
  const int mcu = 8 * hs;
  const int mx = (width + mcu - 1) / mcu, my = (height + mcu - 1) / mcu;
  const int pw = mx * mcu, ph = my * mcu;
  // Planes padded to the MCU grid by edge replication.
  std::vector<float> Y((size_t)pw * ph);
  std::vector<float> Cb, Cr;
  const int cw = pw / hs, chh = ph / hs;
  if (ncomp == 3) {
    Cb.assign((size_t)cw * chh, 0);
    Cr.assign((size_t)cw * chh, 0);
  }
  std::vector<uint8_t> cbf, crf;
  if (ncomp == 3) {
    cbf.resize((size_t)pw * ph);
    crf.resize((size_t)pw * ph);
  }
  for (int y = 0; y < ph; ++y) {
    int sy = y < height ? y : height - 1;
    for (int x = 0; x < pw; ++x) {
      int sx = x < width ? x : width - 1;
      const uint8_t* px = img + ((int64_t)sy * width + sx) * ncomp;
      size_t i = (size_t)y * pw + x;
      if (ncomp == 1) {
        Y[i] = (float)px[0] - 128.0f;
        continue;
      }
      // jccolor.c's fixed-point RGB -> YCbCr (SCALEBITS 16)
      const int32_t r = px[0], g = px[1], b = px[2];
      Y[i] = (float)((19595 * r + 38470 * g + 7471 * b + 32768) >> 16) -
             128.0f;
      cbf[i] = (uint8_t)((-11059 * r - 21709 * g + 32768 * b +
                          (128 << 16) + 32767) >> 16);
      crf[i] = (uint8_t)((32768 * r - 27439 * g - 5329 * b + (128 << 16) +
                          32767) >> 16);
    }
  }
  if (ncomp == 3 && hs == 1) {
    for (size_t i = 0; i < (size_t)pw * ph; ++i) {
      Cb[i] = (float)cbf[i] - 128.0f;
      Cr[i] = (float)crf[i] - 128.0f;
    }
  } else if (ncomp == 3) {
    // jcsample.c h2v2_downsample: 2x2 means, bias alternating 1, 2
    for (int y = 0; y < chh; ++y)
      for (int x = 0; x < cw; ++x) {
        int bias = (x & 1) ? 2 : 1;
        size_t a = (size_t)(2 * y) * pw + 2 * x, b = a + pw;
        Cb[(size_t)y * cw + x] =
            (float)((cbf[a] + cbf[a + 1] + cbf[b] + cbf[b + 1] + bias) >> 2) -
            128.0f;
        Cr[(size_t)y * cw + x] =
            (float)((crf[a] + crf[a + 1] + crf[b] + crf[b + 1] + bias) >> 2) -
            128.0f;
      }
  }
  Writer w;
  w.out.reserve((size_t)width * height / 2 + 1024);
  static const uint8_t jfif[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J',
                                 'F',  'I',  'F',  0x00, 0x01, 0x01, 0x00,
                                 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  w.out.insert(w.out.end(), jfif, jfif + sizeof(jfif));
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); ++t) {
    w.byte(0xFF);
    w.byte(0xDB);
    w.u16(67);
    w.byte((uint8_t)t);
    for (int i = 0; i < 64; ++i) w.byte((uint8_t)q[t][kZigzag[i]]);
  }
  w.byte(0xFF);
  w.byte(0xC0);
  w.u16(8 + 3 * ncomp);
  w.byte(8);
  w.u16(height);
  w.u16(width);
  w.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte((uint8_t)(c + 1));
    w.byte(c == 0 ? (uint8_t)((hs << 4) | hs) : 0x11);
    w.byte(c == 0 ? 0 : 1);
  }
  write_dht(w, 0x00, kDcLumBits, kDcVals);
  write_dht(w, 0x10, kAcLumBits, kAcLumVals);
  if (ncomp == 3) {
    write_dht(w, 0x01, kDcChromBits, kDcVals);
    write_dht(w, 0x11, kAcChromBits, kAcChromVals);
  }
  w.byte(0xFF);
  w.byte(0xDA);
  w.u16(6 + 2 * ncomp);
  w.byte((uint8_t)ncomp);
  for (int c = 0; c < ncomp; ++c) {
    w.byte((uint8_t)(c + 1));
    w.byte(c == 0 ? 0x00 : 0x11);
  }
  w.byte(0);
  w.byte(63);
  w.byte(0);
  int pred[3] = {0, 0, 0};
  float blk[64];
  int coef[64];
  auto load = [&](const std::vector<float>& pl, int stride, int bx, int by) {
    for (int y = 0; y < 8; ++y)
      for (int x = 0; x < 8; ++x)
        blk[8 * y + x] = pl[(size_t)(by * 8 + y) * stride + bx * 8 + x];
  };
  for (int my_ = 0; my_ < my; ++my_)
    for (int mx_ = 0; mx_ < mx; ++mx_) {
      for (int by = 0; by < hs; ++by)
        for (int bx = 0; bx < hs; ++bx) {
          load(Y, pw, mx_ * hs + bx, my_ * hs + by);
          fdct_quant(blk, div[0], coef);
          encode_block(w, coef, pred[0], dcc[0], acc[0]);
        }
      if (ncomp == 3) {
        load(Cb, cw, mx_, my_);
        fdct_quant(blk, div[1], coef);
        encode_block(w, coef, pred[1], dcc[1], acc[1]);
        load(Cr, cw, mx_, my_);
        fdct_quant(blk, div[1], coef);
        encode_block(w, coef, pred[2], dcc[1], acc[1]);
      }
    }
  w.flush();
  w.byte(0xFF);
  w.byte(0xD9);
  int64_t n = (int64_t)w.out.size();
  if (n > cap) return -n;
  std::memcpy(out, w.out.data(), (size_t)n);
  return n;
}

}  // extern "C"
