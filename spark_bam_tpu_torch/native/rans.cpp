// The rANS 4x8 decoder of CRAM 3.0 (block compression method 4): four
// interleaved 32-bit states, byte renormalisation, 12-bit frequencies;
// order-0 and order-1 (reference spark_bam_tpu/native/spark_bam_native.cpp:
// the rans namespace and sbt_rans_decompress, and nothing else of it).
// The layout is u8 order, u32 compressed size, u32 raw size, the frequency
// table(s), then the interleaved byte stream. cram/rans.py keeps the
// encoder and the Python decoder, the plain version this one is held
// against.
//
// Built by spark_bam_tpu_torch/native/build.py (g++ -O3 -fPIC -shared) and
// called through ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace rans {

constexpr int kTot = 4096;
constexpr uint32_t kLow = 1u << 23;

struct Rd {
  const uint8_t* p;
  int64_t n;
  int64_t pos;
  bool ok;
  inline uint8_t u8() {
    if (pos >= n) {
      ok = false;
      return 0;
    }
    return p[pos++];
  }
  inline uint32_t u32() {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i) v |= (uint32_t)u8() << (8 * i);
    return v;
  }
};

static bool read_freqs(Rd& r, uint16_t F[256]) {
  std::memset(F, 0, 256 * sizeof(uint16_t));
  int sym = r.u8();
  int rle = 0;
  while (r.ok) {
    int f = r.u8();
    if (f >= 0x80) f = ((f & 0x7F) << 8) | r.u8();
    F[sym] = (uint16_t)f;
    if (rle) {
      --rle;
      ++sym;
      // A run past symbol 255 is malformed (the Python decoder rejects
      // it too); wrapping would silently clobber low-symbol frequencies.
      if (sym > 255) return false;
    } else if (r.pos < r.n && sym + 1 == r.p[r.pos]) {
      sym = r.u8();
      rle = r.u8();
    } else {
      sym = r.u8();
      if (sym == 0) break;
    }
  }
  return r.ok;
}

struct Ctx {
  uint16_t freq[256];
  uint16_t cum[257];
  uint8_t lookup[kTot];
  // Validates the total BEFORE any lookup write: a malformed table (two-
  // byte freqs can claim up to 32767 each) must not index past lookup[].
  // Unclaimed slots stay 0, matching the Python decoder's zero-filled
  // table, so native and Python decode malformed slots identically.
  bool build() {
    cum[0] = 0;
    uint32_t total = 0;
    for (int s = 0; s < 256; ++s) {
      total += freq[s];
      if (total > (uint32_t)kTot) return false;
      cum[s + 1] = (uint16_t)total;
    }
    if (total == 0) return false;
    std::memset(lookup, 0, sizeof(lookup));
    for (int s = 0; s < 256; ++s)
      for (int k = cum[s]; k < cum[s + 1]; ++k) lookup[k] = (uint8_t)s;
    return true;
  }
};

static inline void renorm(uint32_t& st, Rd& r) {
  while (st < kLow && r.pos < r.n) st = (st << 8) | r.p[r.pos++];
}

static int64_t decode_o0(Rd& r, uint8_t* out, int64_t out_sz) {
  Ctx c;
  if (!read_freqs(r, c.freq)) return -1;
  if (!c.build()) return -1;
  uint32_t st[4];
  for (int j = 0; j < 4; ++j) st[j] = r.u32();
  if (!r.ok) return -1;
  for (int64_t i = 0; i < out_sz; ++i) {
    uint32_t& s = st[i & 3];
    uint32_t m = s & (kTot - 1);
    uint8_t sym = c.lookup[m];
    out[i] = sym;
    s = c.freq[sym] * (s >> 12) + m - c.cum[sym];
    renorm(s, r);
  }
  return out_sz;
}

static int64_t decode_o1(Rd& r, uint8_t* out, int64_t out_sz) {
  std::vector<Ctx> ctxs(256);
  std::vector<bool> present(256, false);
  int ctx = r.u8();
  int rle = 0;
  while (r.ok) {
    if (!read_freqs(r, ctxs[ctx].freq)) return -1;
    if (!ctxs[ctx].build()) return -1;
    present[ctx] = true;
    if (rle) {
      --rle;
      ++ctx;
      if (ctx > 255) return -1;  // context run past 255: malformed
    } else if (r.pos < r.n && ctx + 1 == r.p[r.pos]) {
      ctx = r.u8();
      rle = r.u8();
    } else {
      ctx = r.u8();
      if (ctx == 0) break;
    }
  }
  if (!r.ok) return -1;
  int64_t isz4 = out_sz >> 2;
  uint32_t st[4];
  for (int j = 0; j < 4; ++j) st[j] = r.u32();
  if (!r.ok) return -1;
  int last[4] = {0, 0, 0, 0};
  int64_t i4[4] = {0, isz4, 2 * isz4, 3 * isz4};
  for (int64_t i = 0; i < isz4; ++i) {
    for (int j = 0; j < 4; ++j) {
      if (!present[last[j]]) return -1;
      Ctx& c = ctxs[last[j]];
      uint32_t m = st[j] & (kTot - 1);
      uint8_t sym = c.lookup[m];
      out[i4[j] + i] = sym;
      st[j] = c.freq[sym] * (st[j] >> 12) + m - c.cum[sym];
      renorm(st[j], r);
      last[j] = sym;
    }
  }
  for (int64_t pos = 4 * isz4; pos < out_sz; ++pos) {
    if (!present[last[3]]) return -1;
    Ctx& c = ctxs[last[3]];
    uint32_t m = st[3] & (kTot - 1);
    uint8_t sym = c.lookup[m];
    out[pos] = sym;
    st[3] = c.freq[sym] * (st[3] >> 12) + m - c.cum[sym];
    renorm(st[3], r);
    last[3] = sym;
  }
  return out_sz;
}

}  // namespace rans

extern "C" {

// Decode one rANS 4x8 stream (header included). Returns bytes produced,
// or -1 on malformed input / capacity overflow.
int64_t sbt_rans_decompress(
    const uint8_t* in, int64_t in_len, uint8_t* out, int64_t out_cap) {
  rans::Rd r{in, in_len, 0, true};
  int order = r.u8();
  (void)r.u32();  // compressed size (informational)
  int64_t out_sz = (int64_t)r.u32();
  if (!r.ok || out_sz > out_cap) return -1;
  if (out_sz == 0) return 0;
  if (order == 0) return rans::decode_o0(r, out, out_sz);
  if (order == 1) return rans::decode_o1(r, out, out_sz);
  return -1;
}

}  // extern "C"
