// LASzip point-record codec (decoder + encoder), C++ host-side component.
//
// Closes the reference's `.laz` LiDAR-tile path (ss_make_chunk.py:36-235
// reads tiles with laspy) without external dependencies: this implements
// the public LASzip v2 stream format — FastAC-style adaptive arithmetic
// coding, the IntegerCompressor corrector scheme, and the POINT10 /
// GPSTIME11 / RGB12 v2 item codecs plus the compressed chunk table.
// Header/VLR parsing stays in Python (preprocess/laz.py); this file works
// on raw chunk byte ranges and raw little-endian point records.
//
// Encoder notes: POINT10/RGB12 are encoded with the full adaptive scheme
// (bit-exact mirror of the decoder); GPSTIME11 uses the valid-but-simple
// branch set {unchanged, 32-bit-diff, full-64} of the state machine, which
// real decoders accept.  Roundtrip (our encoder -> our decoder) is
// parity-tested in tests/test_laz.py.

#include <cstdint>
#include <cstring>
#include <vector>

typedef uint8_t U8;
typedef uint16_t U16;
typedef uint32_t U32;
typedef uint64_t U64;
typedef int8_t I8;
typedef int16_t I16;
typedef int32_t I32;
typedef int64_t I64;

static const U32 AC_MaxLength = 0xFFFFFFFFu;
static const U32 AC_MinLength = 0x01000000u;
static const U32 DM_LengthShift = 15;
static const U32 DM_MaxCount = 1u << DM_LengthShift;
static const U32 BM_LengthShift = 13;
static const U32 BM_MaxCount = 1u << BM_LengthShift;

// ---------------------------------------------------------------- models

struct BitModel {
  U32 bit_0_count, bit_count, bit_0_prob, update_cycle, bits_until_update;
  void init() {
    bit_0_count = 1; bit_count = 2;
    bit_0_prob = 1u << (BM_LengthShift - 1);
    update_cycle = bits_until_update = 4;
  }
  void update() {
    if ((bit_count += update_cycle) > BM_MaxCount) {
      bit_count = (bit_count + 1) >> 1;
      bit_0_count = (bit_0_count + 1) >> 1;
      if (bit_0_count == bit_count) ++bit_count;
    }
    U32 scale = 0x80000000u / bit_count;
    bit_0_prob = (bit_0_count * scale) >> (31 - BM_LengthShift);
    update_cycle = (5 * update_cycle) >> 2;
    if (update_cycle > 64) update_cycle = 64;
    bits_until_update = update_cycle;
  }
};

struct SymModel {
  U32 symbols, last_symbol, table_size, table_shift;
  U32 total_count, update_cycle, symbols_until_update;
  bool compress_mode;
  std::vector<U32> distribution, symbol_count, decoder_table;

  void init(U32 n, bool compressor) {
    symbols = n; last_symbol = n - 1; compress_mode = compressor;
    if (!compressor && n > 16) {
      U32 table_bits = 3;
      while (n > (1u << (table_bits + 2))) ++table_bits;
      table_size = 1u << table_bits;
      table_shift = DM_LengthShift - table_bits;
      decoder_table.assign(table_size + 2, 0);
    } else {
      table_size = table_shift = 0;
      decoder_table.clear();
    }
    distribution.assign(n, 0);
    symbol_count.assign(n, 1);
    total_count = 0;
    update_cycle = n;
    update();
    symbols_until_update = update_cycle = (n + 6) >> 1;
  }
  void update() {
    if ((total_count += update_cycle) > DM_MaxCount) {
      total_count = 0;
      for (U32 k = 0; k < symbols; k++)
        total_count += (symbol_count[k] = (symbol_count[k] + 1) >> 1);
    }
    U32 sum = 0, s = 0;
    U32 scale = 0x80000000u / total_count;
    if (compress_mode || table_size == 0) {
      for (U32 k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
      }
    } else {
      for (U32 k = 0; k < symbols; k++) {
        distribution[k] = (scale * sum) >> (31 - DM_LengthShift);
        sum += symbol_count[k];
        U32 w = distribution[k] >> table_shift;
        while (s < w) decoder_table[++s] = k - 1;
      }
      decoder_table[0] = 0;
      while (s <= table_size) decoder_table[++s] = symbols - 1;
    }
    update_cycle = (5 * update_cycle) >> 2;
    U32 max_cycle = (symbols + 6) << 3;
    if (update_cycle > max_cycle) update_cycle = max_cycle;
    symbols_until_update = update_cycle;
  }
};

// --------------------------------------------------------------- decoder

struct Decoder {
  const U8* buf; size_t len, pos;
  U32 value, length;
  void init(const U8* b, size_t n) {
    buf = b; len = n; pos = 0;
    value = ((U32)get() << 24) | ((U32)get() << 16) |
            ((U32)get() << 8) | (U32)get();
    length = AC_MaxLength;
  }
  inline U8 get() { return pos < len ? buf[pos++] : 0; }
  inline void renorm() {
    do { value = (value << 8) | get(); } while ((length <<= 8) < AC_MinLength);
  }
  U32 decodeBit(BitModel& m) {
    U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    U32 sym = (value >= x);
    if (sym == 0) { length = x; ++m.bit_0_count; }
    else { value -= x; length -= x; }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
    return sym;
  }
  U32 decodeSymbol(SymModel& m) {
    U32 n, sym, x, y = length;
    if (!m.decoder_table.empty()) {
      U32 dv = value / (length >>= DM_LengthShift);
      U32 t = dv >> m.table_shift;
      sym = m.decoder_table[t];
      n = m.decoder_table[t + 1] + 1;
      while (n > sym + 1) {
        U32 k = (sym + n) >> 1;
        if (m.distribution[k] > dv) n = k; else sym = k;
      }
      x = m.distribution[sym] * length;
      if (sym != m.last_symbol) y = m.distribution[sym + 1] * length;
    } else {
      x = sym = 0;
      length >>= DM_LengthShift;
      U32 k = (n = m.symbols) >> 1;
      do {
        U32 z = length * m.distribution[k];
        if (z > value) { n = k; y = z; } else { sym = k; x = z; }
      } while ((k = (sym + n) >> 1) != sym);
    }
    value -= x;
    length = y - x;
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
    return sym;
  }
  U32 readBits(U32 bits) {
    if (bits > 19) {
      U32 lo = readBits(16);
      U32 hi = readBits(bits - 16);
      return (hi << 16) | lo;
    }
    U32 sym = value / (length >>= bits);
    value -= length * sym;
    if (length < AC_MinLength) renorm();
    return sym;
  }
  U32 readInt() { return readBits(32); }
};

// --------------------------------------------------------------- encoder

struct Encoder {
  std::vector<U8>* out;
  U32 base_, length;
  size_t start;
  void init(std::vector<U8>* o) {
    out = o; start = o->size(); base_ = 0; length = AC_MaxLength;
  }
  inline void carry() {
    size_t p = out->size();
    while (p > start && (*out)[p - 1] == 0xFF) { (*out)[p - 1] = 0; --p; }
    if (p > start) ++(*out)[p - 1];
  }
  inline void renorm() {
    do { out->push_back((U8)(base_ >> 24)); base_ <<= 8; }
    while ((length <<= 8) < AC_MinLength);
  }
  void encodeBit(BitModel& m, U32 bit) {
    U32 x = m.bit_0_prob * (length >> BM_LengthShift);
    if (!bit) { length = x; ++m.bit_0_count; }
    else {
      U32 init_base = base_;
      base_ += x; length -= x;
      if (init_base > base_) carry();
    }
    if (length < AC_MinLength) renorm();
    if (--m.bits_until_update == 0) m.update();
  }
  void encodeSymbol(SymModel& m, U32 sym) {
    U32 x, init_base = base_;
    if (sym == m.last_symbol) {
      x = m.distribution[sym] * (length >> DM_LengthShift);
      base_ += x;
      length -= x;
    } else {
      x = m.distribution[sym] * (length >>= DM_LengthShift);
      base_ += x;
      length = m.distribution[sym + 1] * length - x;
    }
    if (init_base > base_) carry();
    if (length < AC_MinLength) renorm();
    ++m.symbol_count[sym];
    if (--m.symbols_until_update == 0) m.update();
  }
  void writeBits(U32 bits, U32 sym) {
    if (bits > 19) {
      writeBits(16, sym & 0xFFFF);
      writeBits(bits - 16, sym >> 16);
      return;
    }
    U32 init_base = base_;
    base_ += sym * (length >>= bits);
    if (init_base > base_) carry();
    if (length < AC_MinLength) renorm();
  }
  void writeInt(U32 v) { writeBits(32, v); }
  void done() {
    U32 init_base = base_;
    if (length > 2 * AC_MinLength) {
      base_ += AC_MinLength;
      length = AC_MinLength >> 1;
    } else {
      base_ += AC_MinLength >> 1;
      length = AC_MinLength >> 9;
    }
    if (init_base > base_) carry();
    renorm();
    out->push_back(0);  // keep the decoder's 4-byte lookahead in bounds
    out->push_back(0);
  }
};

// ----------------------------------------------- integer (de)compressor

struct IntCodec {
  U32 bits, contexts, bits_high;
  U32 corr_bits, corr_range;
  I32 corr_min, corr_max;
  U32 k;
  std::vector<SymModel> mBits, mCorrector;
  std::vector<BitModel> mCorrector0;

  void setup(U32 bits_, U32 contexts_, bool compressor, U32 bits_high_ = 8) {
    bits = bits_; contexts = contexts_; bits_high = bits_high_;
    if (bits && bits < 32) {
      corr_bits = bits;
      corr_range = 1u << bits;
      corr_min = -(I32)(corr_range / 2);
      corr_max = corr_min + (I32)corr_range - 1;
    } else {
      corr_bits = 32; corr_range = 0;
      corr_min = INT32_MIN; corr_max = INT32_MAX;
    }
    mBits.resize(contexts);
    for (U32 c = 0; c < contexts; c++) mBits[c].init(corr_bits + 1, compressor);
    mCorrector0.resize(1);
    mCorrector0[0].init();
    mCorrector.resize(corr_bits + 1);
    for (U32 i = 1; i <= corr_bits; i++)
      mCorrector[i].init(i <= bits_high ? (1u << i) : (1u << bits_high),
                         compressor);
  }

  I32 readCorrector(Decoder& dec, SymModel& mb) {
    I32 c;
    k = dec.decodeSymbol(mb);
    if (k) {
      if (k < 32) {
        if (k <= bits_high) {
          c = (I32)dec.decodeSymbol(mCorrector[k]);
        } else {
          U32 k1 = k - bits_high;
          c = (I32)dec.decodeSymbol(mCorrector[k]);
          U32 c1 = dec.readBits(k1);
          c = (I32)(((U32)c << k1) | c1);
        }
        if (c >= (I32)(1u << (k - 1))) c += 1;
        else c -= (I32)((1u << k) - 1);
      } else {
        c = corr_min;
      }
    } else {
      c = (I32)dec.decodeBit(mCorrector0[0]);
    }
    return c;
  }
  I32 decompress(Decoder& dec, I32 pred, U32 context) {
    I32 real = (I32)((U32)pred + (U32)readCorrector(dec, mBits[context]));
    if (corr_range) {
      if (real < 0) real += (I32)corr_range;
      else if ((U32)real >= corr_range) real -= (I32)corr_range;
    }
    return real;
  }

  void writeCorrector(Encoder& enc, I32 c, SymModel& mb) {
    U32 c1 = c <= 0 ? (U32)(-(I64)c) : (U32)(c - 1);
    k = 0;
    while (c1) { c1 >>= 1; k++; }
    enc.encodeSymbol(mb, k);
    if (k) {
      if (k < 32) {
        U32 cc;
        if (c >= 0) cc = (U32)(c - 1);
        else cc = (U32)(c + (I32)((1u << k) - 1));
        if (k <= bits_high) {
          enc.encodeSymbol(mCorrector[k], cc);
        } else {
          U32 k1 = k - bits_high;
          enc.encodeSymbol(mCorrector[k], cc >> k1);
          enc.writeBits(k1, cc & ((1u << k1) - 1));
        }
      }
    } else {
      enc.encodeBit(mCorrector0[0], (U32)c);
    }
  }
  void compress(Encoder& enc, I32 pred, I32 real, U32 context) {
    I32 corr = (I32)((U32)real - (U32)pred);
    if (corr_range) {
      if (corr < corr_min) corr += (I32)corr_range;
      else if (corr > corr_max) corr -= (I32)corr_range;
    }
    writeCorrector(enc, corr, mBits[context]);
  }
};

// ------------------------------------------------------- streaming median

struct Median5 {
  I32 v[5]; bool high;
  void init() { v[0] = v[1] = v[2] = v[3] = v[4] = 0; high = true; }
  void add(I32 x) {
    if (high) {
      if (x < v[2]) {
        v[4] = v[3]; v[3] = v[2];
        if (x < v[0]) { v[2] = v[1]; v[1] = v[0]; v[0] = x; }
        else if (x < v[1]) { v[2] = v[1]; v[1] = x; }
        else v[2] = x;
      } else {
        if (x < v[3]) { v[4] = v[3]; v[3] = x; }
        else v[4] = x;
        high = false;
      }
    } else {
      if (v[2] < x) {
        v[0] = v[1]; v[1] = v[2];
        if (v[4] < x) { v[2] = v[3]; v[3] = v[4]; v[4] = x; }
        else if (v[3] < x) { v[2] = v[3]; v[3] = x; }
        else v[2] = x;
      } else {
        if (v[1] < x) { v[0] = v[1]; v[1] = x; }
        else v[0] = x;
        high = true;
      }
    }
  }
  I32 get() const { return v[2]; }
};

static const U8 number_return_map[8][8] = {
  {15, 14, 13, 12, 11, 10, 9, 8},
  {14, 0, 1, 3, 6, 10, 10, 9},
  {13, 1, 2, 4, 7, 11, 11, 10},
  {12, 3, 4, 5, 8, 12, 12, 11},
  {11, 6, 7, 8, 9, 13, 13, 12},
  {10, 10, 11, 12, 13, 14, 14, 13},
  {9, 10, 11, 12, 13, 14, 15, 14},
  {8, 9, 10, 11, 12, 13, 14, 15}};
static const U8 number_return_level[8][8] = {
  {0, 1, 2, 3, 4, 5, 6, 7},
  {1, 0, 1, 2, 3, 4, 5, 6},
  {2, 1, 0, 1, 2, 3, 4, 5},
  {3, 2, 1, 0, 1, 2, 3, 4},
  {4, 3, 2, 1, 0, 1, 2, 3},
  {5, 4, 3, 2, 1, 0, 1, 2},
  {6, 5, 4, 3, 2, 1, 0, 1},
  {7, 6, 5, 4, 3, 2, 1, 0}};

static inline U8 u8_fold(I32 n) { return (U8)(n & 0xFF); }
static inline I32 u8_clamp(I32 n) { return n < 0 ? 0 : (n > 255 ? 255 : n); }

// ------------------------------------------------------------ POINT10 v2

// raw layout: I32 x, I32 y, I32 z, U16 intensity, U8 bit_byte,
// U8 classification, I8 scan_angle_rank, U8 user_data, U16 point_source
struct Point10State {
  U8 last[20];
  U16 last_intensity[16];
  Median5 mx[16], my[16];
  I32 last_height[8];
  SymModel m_changed_values, m_scan_angle_rank[2];
  std::vector<SymModel> m_bit_byte, m_classification, m_user_data;
  std::vector<bool> bb_used, cl_used, ud_used;
  IntCodec ic_dx, ic_dy, ic_z, ic_intensity, ic_point_source;
  bool compressor;

  void init(const U8* first, bool comp) {
    compressor = comp;
    for (int i = 0; i < 16; i++) {
      mx[i].init(); my[i].init(); last_intensity[i] = 0;
    }
    for (int i = 0; i < 8; i++) last_height[i] = 0;
    m_changed_values.init(64, comp);
    m_scan_angle_rank[0].init(256, comp);
    m_scan_angle_rank[1].init(256, comp);
    m_bit_byte.assign(256, SymModel());
    m_classification.assign(256, SymModel());
    m_user_data.assign(256, SymModel());
    bb_used.assign(256, false);
    cl_used.assign(256, false);
    ud_used.assign(256, false);
    ic_dx.setup(32, 2, comp);
    ic_dy.setup(32, 22, comp);
    ic_z.setup(32, 20, comp);
    ic_intensity.setup(16, 4, comp);
    ic_point_source.setup(16, 1, comp);
    memcpy(last, first, 20);
    last[12] = last[13] = 0;  // "but set intensity to 0"
  }

  inline SymModel& lazy(std::vector<SymModel>& ms, std::vector<bool>& used,
                        U8 idx) {
    if (!used[idx]) { ms[idx].init(256, compressor); used[idx] = true; }
    return ms[idx];
  }

  void read(Decoder& dec, U8* item) {
    U32 r, n, m, l;
    U32 changed = dec.decodeSymbol(m_changed_values);
    if (changed) {
      if (changed & 32)
        last[14] = (U8)dec.decodeSymbol(lazy(m_bit_byte, bb_used, last[14]));
      r = last[14] & 7;
      n = (last[14] >> 3) & 7;
      m = number_return_map[n][r];
      l = number_return_level[n][r];
      if (changed & 16) {
        U16 inten = (U16)ic_intensity.decompress(
            dec, last_intensity[m], m < 3 ? m : 3);
        last[12] = (U8)(inten & 0xFF); last[13] = (U8)(inten >> 8);
        last_intensity[m] = inten;
      } else {
        last[12] = (U8)(last_intensity[m] & 0xFF);
        last[13] = (U8)(last_intensity[m] >> 8);
      }
      if (changed & 8)
        last[15] =
            (U8)dec.decodeSymbol(lazy(m_classification, cl_used, last[15]));
      if (changed & 4) {
        U32 val = dec.decodeSymbol(m_scan_angle_rank[(last[14] >> 6) & 1]);
        last[16] = u8_fold((I32)val + (I32)last[16]);
      }
      if (changed & 2)
        last[17] = (U8)dec.decodeSymbol(lazy(m_user_data, ud_used, last[17]));
      if (changed & 1) {
        U16 ps = (U16)((U16)last[18] | ((U16)last[19] << 8));
        ps = (U16)ic_point_source.decompress(dec, ps, 0);
        last[18] = (U8)(ps & 0xFF); last[19] = (U8)(ps >> 8);
      }
    } else {
      r = last[14] & 7;
      n = (last[14] >> 3) & 7;
      m = number_return_map[n][r];
      l = number_return_level[n][r];
      last[12] = (U8)(last_intensity[m] & 0xFF);
      last[13] = (U8)(last_intensity[m] >> 8);
    }
    I32 x, y, z;
    memcpy(&x, last + 0, 4); memcpy(&y, last + 4, 4); memcpy(&z, last + 8, 4);
    I32 median = mx[m].get();
    I32 diff = ic_dx.decompress(dec, median, n == 1);
    x = (I32)((U32)x + (U32)diff);
    mx[m].add(diff);
    U32 k_bits = ic_dx.k;
    median = my[m].get();
    diff = ic_dy.decompress(
        dec, median, (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    y = (I32)((U32)y + (U32)diff);
    my[m].add(diff);
    k_bits = (ic_dx.k + ic_dy.k) / 2;
    z = ic_z.decompress(
        dec, last_height[l], (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    last_height[l] = z;
    memcpy(last + 0, &x, 4); memcpy(last + 4, &y, 4); memcpy(last + 8, &z, 4);
    memcpy(item, last, 20);
  }

  void write(Encoder& enc, const U8* item) {
    U32 r = item[14] & 7;
    U32 n = (item[14] >> 3) & 7;
    U32 m = number_return_map[n][r];
    U32 l = number_return_level[n][r];
    U16 inten = (U16)((U16)item[12] | ((U16)item[13] << 8));
    U16 ps_new = (U16)((U16)item[18] | ((U16)item[19] << 8));
    U16 ps_old = (U16)((U16)last[18] | ((U16)last[19] << 8));
    U32 changed = ((last[14] != item[14]) ? 32u : 0u) |
                  ((last_intensity[m] != inten) ? 16u : 0u) |
                  ((last[15] != item[15]) ? 8u : 0u) |
                  ((last[16] != item[16]) ? 4u : 0u) |
                  ((last[17] != item[17]) ? 2u : 0u) |
                  ((ps_old != ps_new) ? 1u : 0u);
    enc.encodeSymbol(m_changed_values, changed);
    if (changed) {
      if (changed & 32) {
        enc.encodeSymbol(lazy(m_bit_byte, bb_used, last[14]), item[14]);
        last[14] = item[14];
      }
      if (changed & 16) {
        ic_intensity.compress(enc, last_intensity[m], inten, m < 3 ? m : 3);
        last_intensity[m] = inten;
      }
      if (changed & 8) {
        enc.encodeSymbol(lazy(m_classification, cl_used, last[15]), item[15]);
        last[15] = item[15];
      }
      if (changed & 4) {
        enc.encodeSymbol(m_scan_angle_rank[(item[14] >> 6) & 1],
                         u8_fold((I32)item[16] - (I32)last[16]));
        last[16] = item[16];
      }
      if (changed & 2) {
        enc.encodeSymbol(lazy(m_user_data, ud_used, last[17]), item[17]);
        last[17] = item[17];
      }
      if (changed & 1) ic_point_source.compress(enc, ps_old, ps_new, 0);
    }
    I32 x, y, z, lx, ly;
    memcpy(&x, item + 0, 4); memcpy(&y, item + 4, 4);
    memcpy(&z, item + 8, 4);
    memcpy(&lx, last + 0, 4); memcpy(&ly, last + 4, 4);
    I32 median = mx[m].get();
    I32 diff = (I32)((U32)x - (U32)lx);
    ic_dx.compress(enc, median, diff, n == 1);
    mx[m].add(diff);
    U32 k_bits = ic_dx.k;
    median = my[m].get();
    diff = (I32)((U32)y - (U32)ly);
    ic_dy.compress(enc, median, diff,
                   (n == 1) + (k_bits < 20 ? (k_bits & ~1u) : 20));
    my[m].add(diff);
    k_bits = (ic_dx.k + ic_dy.k) / 2;
    ic_z.compress(enc, last_height[l], z,
                  (n == 1) + (k_bits < 18 ? (k_bits & ~1u) : 18));
    last_height[l] = z;
    memcpy(last, item, 20);
    last[12] = (U8)(last_intensity[m] & 0xFF);
    last[13] = (U8)(last_intensity[m] >> 8);
  }
};

// -------------------------------------------------------------- RGB12 v2

struct Rgb12State {
  U16 last[3];
  SymModel m_byte_used, m_diff[6];
  void init(const U8* first, bool comp) {
    m_byte_used.init(128, comp);
    for (int i = 0; i < 6; i++) m_diff[i].init(256, comp);
    memcpy(last, first, 6);
  }
  void read(Decoder& dec, U8* item) {
    U16 rgb[3];
    I32 diff = 0;
    U32 corr;
    U32 sym = dec.decodeSymbol(m_byte_used);
    if (sym & 1) {
      corr = dec.decodeSymbol(m_diff[0]);
      rgb[0] = (U16)u8_fold((I32)corr + (last[0] & 255));
    } else rgb[0] = last[0] & 0xFF;
    if (sym & 2) {
      corr = dec.decodeSymbol(m_diff[1]);
      rgb[0] |= ((U16)u8_fold((I32)corr + (last[0] >> 8))) << 8;
    } else rgb[0] |= last[0] & 0xFF00;
    if (sym & 64) {
      diff = (rgb[0] & 0xFF) - (last[0] & 0xFF);
      if (sym & 4) {
        corr = dec.decodeSymbol(m_diff[2]);
        rgb[1] = (U16)u8_fold((I32)corr + u8_clamp(diff + (last[1] & 255)));
      } else rgb[1] = last[1] & 0xFF;
      if (sym & 16) {
        corr = dec.decodeSymbol(m_diff[4]);
        diff = (diff + ((rgb[1] & 0xFF) - (last[1] & 0xFF))) / 2;
        rgb[2] = (U16)u8_fold((I32)corr + u8_clamp(diff + (last[2] & 255)));
      } else rgb[2] = last[2] & 0xFF;
      diff = (rgb[0] >> 8) - (last[0] >> 8);
      if (sym & 8) {
        corr = dec.decodeSymbol(m_diff[3]);
        rgb[1] |= ((U16)u8_fold((I32)corr + u8_clamp(diff + (last[1] >> 8))))
                  << 8;
      } else rgb[1] |= last[1] & 0xFF00;
      if (sym & 32) {
        corr = dec.decodeSymbol(m_diff[5]);
        diff = (diff + ((rgb[1] >> 8) - (last[1] >> 8))) / 2;
        rgb[2] |= ((U16)u8_fold((I32)corr + u8_clamp(diff + (last[2] >> 8))))
                  << 8;
      } else rgb[2] |= last[2] & 0xFF00;
    } else {
      rgb[1] = rgb[0];
      rgb[2] = rgb[0];
    }
    memcpy(item, rgb, 6);
    memcpy(last, rgb, 6);
  }
  void write(Encoder& enc, const U8* item) {
    U16 rgb[3];
    memcpy(rgb, item, 6);
    I32 diff = 0;
    U32 sym = 0;
    if ((rgb[0] & 0xFF) != (last[0] & 0xFF)) sym |= 1;
    if ((rgb[0] & 0xFF00) != (last[0] & 0xFF00)) sym |= 2;
    if ((rgb[1] & 0xFF) != (rgb[0] & 0xFF) ||
        (rgb[2] & 0xFF) != (rgb[0] & 0xFF) ||
        (rgb[1] & 0xFF00) != (rgb[0] & 0xFF00) ||
        (rgb[2] & 0xFF00) != (rgb[0] & 0xFF00))
      sym |= 64;
    if (sym & 64) {
      if ((rgb[1] & 0xFF) != (last[1] & 0xFF)) sym |= 4;
      if ((rgb[1] & 0xFF00) != (last[1] & 0xFF00)) sym |= 8;
      if ((rgb[2] & 0xFF) != (last[2] & 0xFF)) sym |= 16;
      if ((rgb[2] & 0xFF00) != (last[2] & 0xFF00)) sym |= 32;
    }
    enc.encodeSymbol(m_byte_used, sym);
    if (sym & 1)
      enc.encodeSymbol(m_diff[0],
                       u8_fold((I32)(rgb[0] & 0xFF) - (last[0] & 255)));
    if (sym & 2)
      enc.encodeSymbol(m_diff[1],
                       u8_fold((I32)(rgb[0] >> 8) - (last[0] >> 8)));
    if (sym & 64) {
      diff = (rgb[0] & 0xFF) - (last[0] & 0xFF);
      if (sym & 4)
        enc.encodeSymbol(
            m_diff[2],
            u8_fold((I32)(rgb[1] & 0xFF) - u8_clamp(diff + (last[1] & 255))));
      if (sym & 16) {
        diff = (diff + ((rgb[1] & 0xFF) - (last[1] & 0xFF))) / 2;
        enc.encodeSymbol(
            m_diff[4],
            u8_fold((I32)(rgb[2] & 0xFF) - u8_clamp(diff + (last[2] & 255))));
      }
      diff = (rgb[0] >> 8) - (last[0] >> 8);
      if (sym & 8)
        enc.encodeSymbol(
            m_diff[3],
            u8_fold((I32)(rgb[1] >> 8) - u8_clamp(diff + (last[1] >> 8))));
      if (sym & 32) {
        diff = (diff + ((rgb[1] >> 8) - (last[1] >> 8))) / 2;
        enc.encodeSymbol(
            m_diff[5],
            u8_fold((I32)(rgb[2] >> 8) - u8_clamp(diff + (last[2] >> 8))));
      }
    }
    memcpy(last, rgb, 6);
  }
};

// ----------------------------------------------------------- GPSTIME11 v2

static const I32 GT_MULTI = 500;
static const I32 GT_MULTI_MINUS = -10;
static const U32 GT_MULTI_UNCHANGED = (U32)(GT_MULTI - GT_MULTI_MINUS + 1);
static const U32 GT_MULTI_CODE_FULL = GT_MULTI_UNCHANGED + 1;
static const U32 GT_MULTI_TOTAL = (U32)(GT_MULTI - GT_MULTI_MINUS + 6);

struct GpsState {
  U64 last_gpstime[4];
  I32 last_diff[4];
  U32 extreme_counter[4];
  U32 last, next;
  SymModel m_multi, m_0diff;
  IntCodec ic;

  void init(const U8* first, bool comp) {
    m_multi.init(GT_MULTI_TOTAL, comp);
    m_0diff.init(6, comp);
    ic.setup(32, 9, comp);
    last = next = 0;
    for (int i = 0; i < 4; i++) {
      last_gpstime[i] = 0; last_diff[i] = 0; extreme_counter[i] = 0;
    }
    memcpy(&last_gpstime[0], first, 8);
  }

  void read(Decoder& dec, U8* item) {
    for (int guard = 0; guard < 8; guard++) {  // sequence-switch recursion
      if (last_diff[last] == 0) {
        U32 multi = dec.decodeSymbol(m_0diff);
        if (multi == 1) {
          last_diff[last] = ic.decompress(dec, 0, 0);
          last_gpstime[last] += (I64)last_diff[last];
          extreme_counter[last] = 0;
        } else if (multi == 2) {
          next = (next + 1) & 3;
          U64 hi = (U64)(U32)ic.decompress(
              dec, (I32)(last_gpstime[last] >> 32), 8);
          last_gpstime[next] = (hi << 32) | (U64)dec.readInt();
          last = next;
          last_diff[last] = 0;
          extreme_counter[last] = 0;
        } else if (multi > 2) {
          last = (last + multi - 2) & 3;
          continue;  // re-read with the switched sequence
        }
      } else {
        U32 multi = dec.decodeSymbol(m_multi);
        if (multi == 1) {
          last_gpstime[last] +=
              (I64)ic.decompress(dec, last_diff[last], 1);
          extreme_counter[last] = 0;
        } else if (multi < GT_MULTI_UNCHANGED) {
          I32 diff;
          if (multi == 0) {
            diff = ic.decompress(dec, 0, 7);
            if (++extreme_counter[last] > 3) {
              last_diff[last] = diff;
              extreme_counter[last] = 0;
            }
          } else if (multi < (U32)GT_MULTI) {
            diff = ic.decompress(
                dec, (I32)multi * last_diff[last], multi < 10 ? 2 : 3);
          } else if (multi == (U32)GT_MULTI) {
            diff = ic.decompress(dec, GT_MULTI * last_diff[last], 4);
            if (++extreme_counter[last] > 3) {
              last_diff[last] = diff;
              extreme_counter[last] = 0;
            }
          } else {
            I32 mneg = GT_MULTI - (I32)multi;
            if (mneg > GT_MULTI_MINUS) {
              diff = ic.decompress(dec, mneg * last_diff[last], 5);
            } else {
              diff = ic.decompress(
                  dec, GT_MULTI_MINUS * last_diff[last], 6);
              if (++extreme_counter[last] > 3) {
                last_diff[last] = diff;
                extreme_counter[last] = 0;
              }
            }
          }
          last_gpstime[last] += (I64)diff;
        } else if (multi == GT_MULTI_CODE_FULL) {
          next = (next + 1) & 3;
          U64 hi = (U64)(U32)ic.decompress(
              dec, (I32)(last_gpstime[last] >> 32), 8);
          last_gpstime[next] = (hi << 32) | (U64)dec.readInt();
          last = next;
          last_diff[last] = 0;
          extreme_counter[last] = 0;
        } else if (multi > GT_MULTI_CODE_FULL) {
          last = (last + multi - GT_MULTI_CODE_FULL) & 3;
          continue;
        }
      }
      break;
    }
    memcpy(item, &last_gpstime[last], 8);
  }

  // Simple valid encoder: {unchanged | 32-bit diff when diff state is 0 |
  // full 64-bit update}.  Mirrors the decoder state transitions exactly.
  void write(Encoder& enc, const U8* item) {
    U64 value;
    memcpy(&value, item, 8);
    if (last_diff[last] == 0) {
      if (value == last_gpstime[last]) {
        enc.encodeSymbol(m_0diff, 0);
      } else {
        I64 d64 = (I64)(value - last_gpstime[last]);
        if (d64 >= INT32_MIN && d64 <= INT32_MAX) {
          enc.encodeSymbol(m_0diff, 1);
          ic.compress(enc, 0, (I32)d64, 0);
          last_diff[last] = (I32)d64;
          last_gpstime[last] = value;
          extreme_counter[last] = 0;
        } else {
          enc.encodeSymbol(m_0diff, 2);
          next = (next + 1) & 3;
          ic.compress(enc, (I32)(last_gpstime[last] >> 32),
                      (I32)(value >> 32), 8);
          enc.writeInt((U32)(value & 0xFFFFFFFFu));
          last = next;
          last_gpstime[last] = value;
          last_diff[last] = 0;
          extreme_counter[last] = 0;
        }
      }
    } else {
      if (value == last_gpstime[last]) {
        enc.encodeSymbol(m_multi, GT_MULTI_UNCHANGED);
      } else {
        enc.encodeSymbol(m_multi, GT_MULTI_CODE_FULL);
        next = (next + 1) & 3;
        ic.compress(enc, (I32)(last_gpstime[last] >> 32),
                    (I32)(value >> 32), 8);
        enc.writeInt((U32)(value & 0xFFFFFFFFu));
        last = next;
        last_gpstime[last] = value;
        last_diff[last] = 0;
        extreme_counter[last] = 0;
      }
    }
  }
};

// -------------------------------------------------------------- chunk API

extern "C" {

// Decode one LAZ chunk. data points at the chunk start (raw first point),
// n_points total points in the chunk, point_size = 20 + 8*have_gps +
// 6*have_rgb. out receives n_points * point_size raw little-endian records.
// Returns 0 on success.
int laz_decode_chunk(const U8* data, int64_t len, U32 n_points, int have_gps,
                     int have_rgb, U8* out) {
  if (n_points == 0) return 0;
  U32 psize = 20 + (have_gps ? 8 : 0) + (have_rgb ? 6 : 0);
  if ((I64)psize > len) return 1;
  // first point raw, in item order (point10, gpstime, rgb)
  memcpy(out, data, psize);
  Decoder dec;
  dec.init(data + psize, (size_t)(len - psize));
  Point10State p10;
  GpsState gps;
  Rgb12State rgb;
  const U8* f = out;
  p10.init(f, false);
  if (have_gps) gps.init(f + 20, false);
  if (have_rgb) rgb.init(f + (have_gps ? 28 : 20), false);
  for (U32 i = 1; i < n_points; i++) {
    U8* item = out + (size_t)i * psize;
    p10.read(dec, item);
    if (have_gps) gps.read(dec, item + 20);
    if (have_rgb) rgb.read(dec, item + (have_gps ? 28 : 20));
  }
  return 0;
}

// Encode one chunk of raw records into out (capacity out_cap). Returns the
// number of bytes written, or -1 if out_cap is too small.
int64_t laz_encode_chunk(const U8* raw, U32 n_points, int have_gps,
                         int have_rgb, U8* out, int64_t out_cap) {
  if (n_points == 0) return 0;
  U32 psize = 20 + (have_gps ? 8 : 0) + (have_rgb ? 6 : 0);
  std::vector<U8> buf;
  buf.reserve((size_t)n_points * psize / 2 + 64);
  for (U32 b = 0; b < psize; b++) buf.push_back(raw[b]);
  Encoder enc;
  enc.init(&buf);
  Point10State p10;
  GpsState gps;
  Rgb12State rgb;
  p10.init(raw, true);
  if (have_gps) gps.init(raw + 20, true);
  if (have_rgb) rgb.init(raw + (have_gps ? 28 : 20), true);
  for (U32 i = 1; i < n_points; i++) {
    const U8* item = raw + (size_t)i * psize;
    p10.write(enc, item);
    if (have_gps) gps.write(enc, item + 20);
    if (have_rgb) rgb.write(enc, item + (have_gps ? 28 : 20));
  }
  enc.done();
  if ((int64_t)buf.size() > out_cap) return -1;
  memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

// Chunk table payload (after the u32 version / u32 number_chunks header):
// compressed chunk byte-sizes. Returns 0 on success.
int laz_decode_chunk_table(const U8* data, int64_t len, U32 n_chunks,
                           U32* sizes) {
  Decoder dec;
  dec.init(data, (size_t)len);
  IntCodec ic;
  ic.setup(32, 2, false);
  U32 prev = 0;
  for (U32 i = 0; i < n_chunks; i++) {
    U32 s = (U32)ic.decompress(dec, (I32)prev, 1);
    sizes[i] = s;
    prev = s;
  }
  return 0;
}

int64_t laz_encode_chunk_table(const U32* sizes, U32 n_chunks, U8* out,
                               int64_t out_cap) {
  std::vector<U8> buf;
  Encoder enc;
  enc.init(&buf);
  IntCodec ic;
  ic.setup(32, 2, true);
  U32 prev = 0;
  for (U32 i = 0; i < n_chunks; i++) {
    ic.compress(enc, (I32)prev, (I32)sizes[i], 1);
    prev = sizes[i];
  }
  enc.done();
  if ((int64_t)buf.size() > out_cap) return -1;
  memcpy(out, buf.data(), buf.size());
  return (int64_t)buf.size();
}

}  // extern "C"
