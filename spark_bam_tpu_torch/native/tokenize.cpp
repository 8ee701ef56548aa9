// The host DEFLATE entropy phase (reference spark_bam_tpu/native/
// spark_bam_native.cpp: BitReader, the canonical Huffman tables,
// tokenize_one and sbt_tokenize_deflate, and nothing else of it).
//
// For each uncompressed output position i of a raw-DEFLATE stream it records
//   dist[i] = 0    and lit[i] = the byte, for literal and stored output
//   dist[i] = dist and lit[i] = 0,        for back-reference output
// and zeroes both planes past the produced length: the token convention of
// the device tokenizer (tpu/tokenize_device.py). Position i's byte is the
// literal at the root of its chain i -> i - dist[i] -> ..., which the
// device's LZ77 kernel resolves (csrc/lz77.cu); this phase copies no bytes.
// DEFLATE distances fit 16 bits (at most 32768), so a token is 3 bytes.
//
// Built by spark_bam_tpu_torch/native/build.py (g++ -O3 -fPIC -shared) and
// called through ctypes, which releases the GIL for the call: threads
// tokenize disjoint row ranges of one buffer at once.

#include <cstdint>

namespace {

struct BitReader {
  const uint8_t* p;
  int64_t n;
  int64_t pos;     // next byte index
  uint32_t buf;    // bit buffer, LSB-first
  int cnt;         // valid bits in buf
  bool ok;
};

static inline uint32_t br_bits(BitReader& br, int need) {
  while (br.cnt < need) {
    if (br.pos >= br.n) {
      br.ok = false;
      return 0;
    }
    br.buf |= (uint32_t)br.p[br.pos++] << br.cnt;
    br.cnt += 8;
  }
  uint32_t v = br.buf & ((1u << need) - 1);
  br.buf >>= need;
  br.cnt -= need;
  return v;
}

// Canonical Huffman decoding from code lengths (RFC 1951 §3.2.2): count
// codes per length, then peel bits LSB-first comparing against the running
// first-code-of-length.
struct Huff {
  int16_t count[16];    // number of codes of each bit length
  int16_t symbol[288];  // symbols ordered by (length, symbol)
};

static bool huff_build(Huff& h, const uint8_t* lens, int n) {
  for (int i = 0; i < 16; ++i) h.count[i] = 0;
  for (int i = 0; i < n; ++i) h.count[lens[i]]++;
  // An all-zero table is legal (RFC 1951 §3.2.7: a stream with no matches
  // may declare no distance codes); huff_decode then fails only if a
  // symbol is actually requested from it.
  if (h.count[0] == n) return true;
  int left = 1;  // over-subscription check
  for (int len = 1; len < 16; ++len) {
    left <<= 1;
    left -= h.count[len];
    if (left < 0) return false;
  }
  int16_t offs[16];
  offs[1] = 0;
  for (int len = 1; len < 15; ++len) offs[len + 1] = offs[len] + h.count[len];
  for (int i = 0; i < n; ++i)
    if (lens[i]) h.symbol[offs[lens[i]]++] = (int16_t)i;
  return true;
}

static inline int huff_decode(BitReader& br, const Huff& h) {
  int code = 0, first = 0, index = 0;
  for (int len = 1; len < 16; ++len) {
    code |= (int)br_bits(br, 1);
    if (!br.ok) return -1;
    int cnt = h.count[len];
    if (code - cnt < first) return h.symbol[index + (code - first)];
    index += cnt;
    first += cnt;
    first <<= 1;
    code <<= 1;
  }
  return -1;
}

static const int16_t kLenBase[29] = {
    3,  4,  5,  6,  7,  8,  9,  10, 11,  13,  15,  17,  19,  23, 27,
    31, 35, 43, 51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
static const int16_t kLenExtra[29] = {0, 0, 0, 0, 0, 0, 0, 0, 1, 1,
                                      1, 1, 2, 2, 2, 2, 3, 3, 3, 3,
                                      4, 4, 4, 4, 5, 5, 5, 5, 0};
static const int16_t kDistBase[30] = {
    1,    2,    3,    4,    5,    7,     9,     13,    17,   25,
    33,   49,   65,   97,   129,  193,   257,   385,   513,  769,
    1025, 1537, 2049, 3073, 4097, 6145,  8193,  12289, 16385, 24577};
static const int16_t kDistExtra[30] = {0, 0, 0,  0,  1,  1,  2,  2,  3,  3,
                                       4, 4, 5,  5,  6,  6,  7,  7,  8,  8,
                                       9, 9, 10, 10, 11, 11, 12, 12, 13, 13};

static bool fixed_tables(Huff& lit, Huff& dist) {
  uint8_t lens[288];
  for (int i = 0; i < 144; ++i) lens[i] = 8;
  for (int i = 144; i < 256; ++i) lens[i] = 9;
  for (int i = 256; i < 280; ++i) lens[i] = 7;
  for (int i = 280; i < 288; ++i) lens[i] = 8;
  if (!huff_build(lit, lens, 288)) return false;
  for (int i = 0; i < 30; ++i) lens[i] = 5;
  return huff_build(dist, lens, 30);
}

static bool dynamic_tables(BitReader& br, Huff& lit, Huff& dist) {
  static const uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                     11, 4,  12, 3, 13, 2, 14, 1, 15};
  int hlit = (int)br_bits(br, 5) + 257;
  int hdist = (int)br_bits(br, 5) + 1;
  int hclen = (int)br_bits(br, 4) + 4;
  if (!br.ok || hlit > 286 || hdist > 30) return false;
  uint8_t cl_lens[19] = {0};
  for (int i = 0; i < hclen; ++i) cl_lens[kOrder[i]] = (uint8_t)br_bits(br, 3);
  if (!br.ok) return false;
  Huff cl;
  if (!huff_build(cl, cl_lens, 19)) return false;
  uint8_t lens[288 + 30] = {0};
  int i = 0;
  while (i < hlit + hdist) {
    int sym = huff_decode(br, cl);
    if (sym < 0) return false;
    if (sym < 16) {
      lens[i++] = (uint8_t)sym;
    } else {
      int repeat, value = 0;
      if (sym == 16) {
        if (i == 0) return false;
        value = lens[i - 1];
        repeat = 3 + (int)br_bits(br, 2);
      } else if (sym == 17) {
        repeat = 3 + (int)br_bits(br, 3);
      } else {
        repeat = 11 + (int)br_bits(br, 7);
      }
      if (!br.ok || i + repeat > hlit + hdist) return false;
      while (repeat--) lens[i++] = (uint8_t)value;
    }
  }
  if (lens[256] == 0) return false;  // need an end-of-block code
  return huff_build(lit, lens, hlit) && huff_build(dist, lens + hlit, hdist);
}

// Tokenize one raw-DEFLATE stream. Returns bytes produced, or -1 on error.
static int64_t tokenize_one(const uint8_t* comp, int64_t clen, uint8_t* lit,
                            uint16_t* dist_out, int64_t cap) {
  BitReader br{comp, clen, 0, 0, 0, true};
  int64_t o = 0;
  for (;;) {
    uint32_t final_blk = br_bits(br, 1);
    uint32_t type = br_bits(br, 2);
    if (!br.ok) return -1;
    if (type == 0) {  // stored: byte-aligned len/~len then raw literals
      br.buf = 0;
      br.cnt = 0;
      if (br.pos + 4 > br.n) return -1;
      uint32_t len = (uint32_t)comp[br.pos] | ((uint32_t)comp[br.pos + 1] << 8);
      uint32_t nlen =
          (uint32_t)comp[br.pos + 2] | ((uint32_t)comp[br.pos + 3] << 8);
      if ((len ^ 0xffff) != nlen) return -1;
      br.pos += 4;
      if (br.pos + len > br.n || o + len > cap) return -1;
      for (uint32_t k = 0; k < len; ++k) {
        lit[o] = comp[br.pos + k];
        dist_out[o] = 0;
        ++o;
      }
      br.pos += len;
    } else if (type == 3) {
      return -1;
    } else {
      Huff hl, hd;
      bool built =
          type == 1 ? fixed_tables(hl, hd) : dynamic_tables(br, hl, hd);
      if (!built) return -1;
      for (;;) {
        int sym = huff_decode(br, hl);
        if (sym < 0) return -1;
        if (sym < 256) {
          if (o >= cap) return -1;
          lit[o] = (uint8_t)sym;
          dist_out[o] = 0;
          ++o;
        } else if (sym == 256) {
          break;
        } else {
          sym -= 257;
          if (sym >= 29) return -1;
          int len = kLenBase[sym] + (int)br_bits(br, kLenExtra[sym]);
          int dsym = huff_decode(br, hd);
          if (dsym < 0 || dsym >= 30) return -1;
          int dist = kDistBase[dsym] + (int)br_bits(br, kDistExtra[dsym]);
          if (!br.ok || dist > o || o + len > cap) return -1;
          for (int k = 0; k < len; ++k) {
            lit[o] = 0;
            dist_out[o] = (uint16_t)dist;
            ++o;
          }
        }
      }
    }
    if (final_blk) return o;
  }
}

}  // namespace

extern "C" {

// Tokenize `count` raw-DEFLATE payloads into (count, stride) lit/dist
// rows; pads each row's tail with dist=0 (identity) so the device resolver
// works on fixed shapes. Returns 0, or the 1-based index of the first
// failing block.
long sbt_tokenize_deflate(
    const uint8_t* comp,
    const int64_t* offsets,
    const int64_t* lengths,
    int64_t count,
    uint8_t* lit,
    uint16_t* dist,
    int64_t stride,
    int64_t* out_lens) {
  for (int64_t i = 0; i < count; ++i) {
    uint8_t* l = lit + i * stride;
    uint16_t* d = dist + i * stride;
    int64_t produced =
        tokenize_one(comp + offsets[i], lengths[i], l, d, stride);
    if (produced < 0) return i + 1;
    out_lens[i] = produced;
    for (int64_t k = produced; k < stride; ++k) {
      l[k] = 0;
      d[k] = 0;
    }
  }
  return 0;
}

}  // extern "C"
