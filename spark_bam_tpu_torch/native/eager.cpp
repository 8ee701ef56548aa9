// The host eager checker and the fast BGZF inflate: the CPU yardstick the
// card's count is measured against (reference spark_bam_tpu/native/
// spark_bam_native.cpp: sbt_eager_check, sbt_find_record_start,
// sbt_eager_check_window, sbt_find_record_start_window and
// sbt_inflate_blocks_fast with its table decoder; the same code, so the
// same verdicts and bytes). sbt_inflate_blocks, which needs zlib, lives in
// inflate_zlib.cpp so that nothing the card host runs needs zlib's headers.
//
// Built by spark_bam_tpu_torch/native/build.py (g++ -O3 -march=native
// -fPIC -shared; the library's name carries a token of the host CPU) and
// called through ctypes, which releases the GIL for each call.

#include <cstdint>
#include <cstring>

extern "C" {

// ---------------------------------------------------------------- checker
// Exact port of the eager checker semantics (check/eager.py; reference
// eager/Checker.scala:18-177) over a flat uncompressed buffer of n bytes
// that ends at EOF. Returns 1 (boundary) / 0.
static inline int32_t rd_i32(const uint8_t* p) {
  uint32_t v = (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
               ((uint32_t)p[3] << 24);
  return (int32_t)v;
}

// Core chain walk. `touched` (when non-null) is set to 1 iff the verdict
// depended on the buffer edge `n` — the chain was cut mid-walk, so a
// caller whose buffer end is NOT the file's EOF must treat the result as
// uncertain in BOTH directions (a cut mid-record false-fails; a cut
// exactly at a record edge false-passes). Verdicts that return without
// touching `n` are exact regardless of what lies beyond the buffer.
static int eager_ok_ex(
    const uint8_t* buf, int64_t n, int64_t start,
    const int32_t* contig_lengths, int32_t num_contigs, int32_t reads_to_check,
    int* touched) {
  int64_t logical = start;   // the recursion's startPos bookkeeping
  int64_t physical = start;  // actual stream position
  for (int32_t successes = 0;; ++successes) {
    if (successes == reads_to_check) return 1;
    if (physical >= n) {
      // Zero bytes exactly at the expected record edge after >=1 success.
      if (touched) *touched = 1;
      return physical == logical && successes > 0;
    }
    if (physical + 36 > n) {
      if (touched) *touched = 1;
      return 0;
    }

    const uint8_t* p = buf + physical;
    int32_t remaining = rd_i32(p);
    int32_t ref_idx = rd_i32(p + 4);
    int32_t ref_pos = rd_i32(p + 8);
    if (ref_idx < -1 || ref_idx >= num_contigs || ref_pos < -1) return 0;
    if (ref_idx >= 0 && ref_pos > contig_lengths[ref_idx]) return 0;

    int32_t name_len = p[12];
    if (name_len == 0 || name_len == 1) return 0;

    uint32_t fnc = (uint32_t)rd_i32(p + 16);
    uint32_t flags = fnc >> 16;
    int32_t n_cigar = (int32_t)(fnc & 0xffff);
    int32_t seq_len = rd_i32(p + 20);
    if ((flags & 4) == 0 && (seq_len == 0 || n_cigar == 0)) return 0;

    // JVM int32 wrap + truncating division.
    int32_t t = seq_len + 1;
    int32_t half = t / 2;  // C++ division truncates toward zero, like the JVM
    int32_t rhs = (int32_t)(32 + name_len + 4 * n_cigar + half + seq_len);
    if (remaining < rhs) return 0;

    int32_t next_ref = rd_i32(p + 24);
    int32_t next_pos = rd_i32(p + 28);
    if (next_ref < -1 || next_ref >= num_contigs || next_pos < -1) return 0;
    if (next_ref >= 0 && next_pos > contig_lengths[next_ref]) return 0;

    int64_t name_end = physical + 36 + name_len;
    if (name_end > n) {
      if (touched) *touched = 1;
      return 0;
    }
    if (buf[name_end - 1] != 0) return 0;
    for (int64_t j = physical + 36; j < name_end - 1; ++j) {
      uint8_t b = buf[j];
      if (b < 0x21 || b > 0x7e || b == 0x40) return 0;
    }

    int64_t cig_end = name_end + 4 * (int64_t)n_cigar;
    if (cig_end > n) {
      if (touched) *touched = 1;
      return 0;
    }
    for (int64_t j = name_end; j < cig_end; j += 4)
      if ((buf[j] & 0xf) > 8) return 0;

    int64_t next_logical = logical + 4 + (int64_t)remaining;
    int64_t next_physical = cig_end > next_logical ? cig_end : next_logical;
    if (next_physical > n) next_physical = n;  // stream skip clamps at EOF
    logical = next_logical;
    physical = next_physical;
  }
}

static int eager_ok(
    const uint8_t* buf, int64_t n, int64_t start,
    const int32_t* contig_lengths, int32_t num_contigs, int32_t reads_to_check) {
  return eager_ok_ex(buf, n, start, contig_lengths, num_contigs,
                     reads_to_check, nullptr);
}

// Verdicts for `m` candidate offsets.
void sbt_eager_check(
    const uint8_t* buf, int64_t n,
    const int64_t* candidates, int64_t m,
    const int32_t* contig_lengths, int32_t num_contigs,
    int32_t reads_to_check, uint8_t* out) {
  for (int64_t i = 0; i < m; ++i)
    out[i] = (uint8_t)eager_ok(buf, n, candidates[i], contig_lengths,
                               num_contigs, reads_to_check);
}

// First boundary at/after `start`, scanning < max_read_size bytes; -1 if none.
int64_t sbt_find_record_start(
    const uint8_t* buf, int64_t n, int64_t start,
    const int32_t* contig_lengths, int32_t num_contigs,
    int32_t reads_to_check, int64_t max_read_size) {
  int64_t limit = start + max_read_size;
  for (int64_t pos = start; pos < limit && pos < n; ++pos)
    if (eager_ok(buf, n, pos, contig_lengths, num_contigs, reads_to_check))
      return pos;
  return -1;
}

// Tri-state verdicts for `m` candidates over a bounded window: out[i] is
// 0/1 when the chain resolved on in-window bytes alone (certain — exact
// regardless of what lies beyond), 2 when the verdict depended on the
// window edge (caller must retry with more lookahead). exact_eof nonzero
// = the window end IS the file end (classic semantics, never 2). The
// streaming deferral path resolves escaped candidates with this instead
// of re-running a whole-buffer flag pass per window.
void sbt_eager_check_window(
    const uint8_t* buf, int64_t n, const int64_t* candidates, int64_t m,
    const int32_t* contig_lengths, int32_t num_contigs,
    int32_t reads_to_check, int32_t exact_eof, uint8_t* out) {
  for (int64_t i = 0; i < m; ++i) {
    int touched = 0;
    int ok = eager_ok_ex(buf, n, candidates[i], contig_lengths, num_contigs,
                         reads_to_check, &touched);
    out[i] = (touched && !exact_eof) ? (uint8_t)2 : (uint8_t)ok;
  }
}

// Tri-state scan for bounded windows whose end is NOT the file's EOF
// (split-boundary resolution over a partial inflate — load/api.py).
// Returns the first position in [start, start+max_read_size) ∩ [0, n)
// whose chain passes using only in-window bytes (a *certain* pass).
// Scanning stops at the first position whose verdict depended on the
// window edge: its index goes to *uncertain_at (else -1) and -1 is
// returned — every position before it carries a certain verdict, so the
// caller can grow the window and resume exactly there. With exact_eof
// nonzero the window end IS the file end: classic semantics, never
// uncertain.
int64_t sbt_find_record_start_window(
    const uint8_t* buf, int64_t n, int64_t start,
    const int32_t* contig_lengths, int32_t num_contigs,
    int32_t reads_to_check, int64_t max_read_size,
    int32_t exact_eof, int64_t* uncertain_at) {
  *uncertain_at = -1;
  int64_t limit = start + max_read_size;
  for (int64_t pos = start; pos < limit && pos < n; ++pos) {
    int touched = 0;
    int ok = eager_ok_ex(buf, n, pos, contig_lengths, num_contigs,
                         reads_to_check, &touched);
    if (touched && !exact_eof) {
      *uncertain_at = pos;
      return -1;
    }
    if (ok) return pos;
  }
  return -1;
}

}  // extern "C"


// DEFLATE length and distance tables (RFC 1951 3.2.5).
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

// ---------------------------------------------------------- fast inflate
// A raw-DEFLATE decoder specialized for BGZF blocks: a 64-bit bit buffer
// refilled 8 bytes at a time, two-level Huffman tables (an 11-bit root and
// subtables for longer codes) and word-wise LZ77 copies under an 8-byte
// slack contract against the whole output allocation. A block it rejects
// returns its index; the caller decodes that block with zlib (the Python
// wrapper), so the output is always zlib's, never a guess.

namespace fastinf {

struct FB {
  const uint8_t* p;
  const uint8_t* end;
  uint64_t buf;  // LSB-first bit buffer
  int cnt;       // valid bits in buf
};

static inline void refill(FB& b) {
  if (b.end - b.p >= 8) {
    uint64_t w;
    std::memcpy(&w, b.p, 8);  // little-endian hosts only (x86/arm64)
    b.buf |= w << b.cnt;
    int take = (63 - b.cnt) >> 3;
    b.p += take;
    b.cnt += take << 3;
  } else {
    while (b.cnt <= 56 && b.p < b.end) {
      b.buf |= (uint64_t)(*b.p++) << b.cnt;
      b.cnt += 8;
    }
  }
}

static inline uint32_t take_bits(FB& b, int n) {
  uint32_t v = (uint32_t)(b.buf & ((1ull << n) - 1));
  b.buf >>= n;
  b.cnt -= n;
  return v;
}

// Two-level decode tables (zlib/libdeflate scheme): an 11-bit primary
// table (8 KB, L1-resident; build cost ~2048 entries, not 32768) plus
// per-prefix subtables for the rare >11-bit codes.
//
// u32 entry:
//   direct : (symbol << 8) | total_code_length         (length 1..11)
//   subptr : 0x80000000 | (subtable_offset << 8) | sub_bits
//   0      : invalid
constexpr int kRootBits = 11;
constexpr uint32_t kRootSize = 1u << kRootBits;
// Root + generous subtable arena (legal complete codes need far less;
// the build errors out rather than overrun).
constexpr uint32_t kTabCap = kRootSize + 4096;

static inline uint32_t bitrev(uint32_t c, int len) {
  uint32_t r = 0;
  for (int i = 0; i < len; ++i) {
    r = (r << 1) | (c & 1);
    c >>= 1;
  }
  return r;
}

static bool build_table(uint32_t* tab, const uint8_t* lens, int n) {
  int count[16] = {0};
  for (int i = 0; i < n; ++i) count[lens[i]]++;
  count[0] = 0;  // zero-length = absent, excluded from the Kraft sum
  int left = 1;
  int maxlen = 0;
  for (int len = 1; len <= 15; ++len) {
    left <<= 1;
    left -= count[len];
    if (left < 0) return false;  // over-subscribed
    if (count[len]) maxlen = len;
  }
  // A complete code covers every root entry (short fills + long-prefix
  // subptrs); only incomplete codes (legal for degenerate distance
  // tables, RFC 1951 §3.2.7) need the invalid-fill.
  if (left != 0) std::memset(tab, 0, kRootSize * sizeof(uint32_t));
  uint32_t codes[288 + 30];
  {
    uint32_t code = 0;
    uint32_t next[16] = {0};
    for (int len = 1; len <= 15; ++len) {
      code = (code + (uint32_t)count[len - 1]) << 1;
      next[len] = code;
    }
    for (int sym = 0; sym < n; ++sym)
      if (lens[sym]) codes[sym] = next[lens[sym]]++;
  }

  // Short codes: direct root fill.
  for (int sym = 0; sym < n; ++sym) {
    int L = lens[sym];
    if (!L || L > kRootBits) continue;
    uint32_t e = ((uint32_t)sym << 8) | (uint32_t)L;
    for (uint32_t idx = bitrev(codes[sym], L); idx < kRootSize;
         idx += (1u << L))
      tab[idx] = e;
  }
  if (maxlen <= kRootBits) return true;

  // Long codes: size each used root prefix, then allocate + fill.
  uint8_t submax[kRootSize];
  std::memset(submax, 0, sizeof(submax));
  for (int sym = 0; sym < n; ++sym) {
    int L = lens[sym];
    if (L <= kRootBits) continue;
    uint32_t pfx = bitrev(codes[sym], L) & (kRootSize - 1);
    if (L - kRootBits > submax[pfx]) submax[pfx] = (uint8_t)(L - kRootBits);
  }
  uint32_t suboff[kRootSize];
  uint32_t alloc = kRootSize;
  for (uint32_t pfx = 0; pfx < kRootSize; ++pfx) {
    if (!submax[pfx]) continue;
    uint32_t size = 1u << submax[pfx];
    if (alloc + size > kTabCap) return false;
    suboff[pfx] = alloc;
    std::memset(tab + alloc, 0, size * sizeof(uint32_t));
    tab[pfx] = 0x80000000u | (alloc << 8) | submax[pfx];
    alloc += size;
  }
  for (int sym = 0; sym < n; ++sym) {
    int L = lens[sym];
    if (L <= kRootBits) continue;
    uint32_t r = bitrev(codes[sym], L);
    uint32_t pfx = r & (kRootSize - 1);
    uint32_t hi = r >> kRootBits;  // remaining L - kRootBits stream bits
    uint32_t e = ((uint32_t)sym << 8) | (uint32_t)L;
    for (uint32_t idx = hi; idx < (1u << submax[pfx]);
         idx += (1u << (L - kRootBits)))
      tab[suboff[pfx] + idx] = e;
  }
  return true;
}

// Decode one symbol's table entry from the low bits of `buf`; returns the
// final (direct) entry, 0 if invalid.
static inline uint32_t lookup(const uint32_t* tab, uint64_t buf) {
  uint32_t e = tab[(uint32_t)buf & (kRootSize - 1)];
  if (e & 0x80000000u) {
    uint32_t sb = e & 0xffu;
    e = tab[((e >> 8) & 0x3fffffu) +
            (((uint32_t)(buf >> kRootBits)) & ((1u << sb) - 1))];
  }
  return e;
}

static bool build_fixed(uint32_t* lit_tab, uint32_t* dist_tab) {
  uint8_t lens[288];
  for (int i = 0; i < 144; ++i) lens[i] = 8;
  for (int i = 144; i < 256; ++i) lens[i] = 9;
  for (int i = 256; i < 280; ++i) lens[i] = 7;
  for (int i = 280; i < 288; ++i) lens[i] = 8;
  if (!build_table(lit_tab, lens, 288)) return false;
  for (int i = 0; i < 30; ++i) lens[i] = 5;
  return build_table(dist_tab, lens, 30);
}

// Inflate one raw-DEFLATE stream. `hard_end` bounds the *whole* output
// allocation (8-byte word-copy slack may spill past this block's region
// into bytes that later blocks overwrite, never past hard_end). Returns
// bytes produced, or -1 on any error (caller falls back to zlib).
static int64_t inflate_one(const uint8_t* in, int64_t nin, uint8_t* out,
                           int64_t out_len, uint8_t* hard_end) {
  FB b{in, in + nin, 0, 0};
  uint8_t* dst = out;
  uint8_t* dst_end = out + out_len;
  thread_local static uint32_t lit_tab[kTabCap];
  thread_local static uint32_t dist_tab[kTabCap];
  thread_local static uint32_t fixed_lit[kTabCap];
  thread_local static uint32_t fixed_dist[kTabCap];
  thread_local static bool fixed_ready = false;

  for (;;) {
    refill(b);
    if (b.cnt < 3) return -1;
    uint32_t bfinal = take_bits(b, 1);
    uint32_t btype = take_bits(b, 2);
    if (btype == 3) return -1;
    if (btype == 0) {  // stored: byte-align, LEN/NLEN, raw copy
      take_bits(b, b.cnt & 7);
      const uint8_t* q = b.p - (b.cnt >> 3);
      b.buf = 0;
      b.cnt = 0;
      b.p = q;
      if (b.end - b.p < 4) return -1;
      uint32_t len = (uint32_t)b.p[0] | ((uint32_t)b.p[1] << 8);
      uint32_t nlen = (uint32_t)b.p[2] | ((uint32_t)b.p[3] << 8);
      if ((len ^ 0xffffu) != nlen) return -1;
      b.p += 4;
      if (b.end - b.p < (int64_t)len || dst + len > dst_end) return -1;
      std::memcpy(dst, b.p, len);
      dst += len;
      b.p += len;
    } else {
      const uint32_t* lt;
      const uint32_t* dt;
      if (btype == 1) {
        if (!fixed_ready) {
          if (!build_fixed(fixed_lit, fixed_dist)) return -1;
          fixed_ready = true;
        }
        lt = fixed_lit;
        dt = fixed_dist;
      } else {
        refill(b);
        if (b.cnt < 14) return -1;
        int hlit = (int)take_bits(b, 5) + 257;
        int hdist = (int)take_bits(b, 5) + 1;
        int hclen = (int)take_bits(b, 4) + 4;
        if (hlit > 286 || hdist > 30) return -1;
        static const uint8_t kOrder[19] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                           11, 4,  12, 3, 13, 2, 14, 1, 15};
        uint8_t cl_lens[19] = {0};
        for (int i = 0; i < hclen; ++i) {
          refill(b);
          if (b.cnt < 3) return -1;
          cl_lens[kOrder[i]] = (uint8_t)take_bits(b, 3);
        }
        // The code-length pre-table borrows dist_tab (rebuilt below).
        if (!build_table(dist_tab, cl_lens, 19)) return -1;
        uint8_t lens[288 + 30] = {0};
        int i = 0;
        while (i < hlit + hdist) {
          refill(b);
          uint32_t e = lookup(dist_tab, b.buf);
          int L = (int)(e & 0xff);
          if (!L || L > b.cnt) return -1;
          take_bits(b, L);
          int sym = (int)(e >> 8);
          if (sym < 16) {
            lens[i++] = (uint8_t)sym;
          } else if (sym == 16) {
            if (i == 0 || b.cnt < 2) return -1;
            int rep = 3 + (int)take_bits(b, 2);
            if (i + rep > hlit + hdist) return -1;
            uint8_t prev = lens[i - 1];
            while (rep--) lens[i++] = prev;
          } else if (sym == 17) {
            if (b.cnt < 3) return -1;
            int rep = 3 + (int)take_bits(b, 3);
            if (i + rep > hlit + hdist) return -1;
            i += rep;  // lens[] pre-zeroed
          } else {
            if (b.cnt < 7) return -1;
            int rep = 11 + (int)take_bits(b, 7);
            if (i + rep > hlit + hdist) return -1;
            i += rep;
          }
        }
        if (lens[256] == 0) return -1;  // need an end-of-block code
        if (!build_table(lit_tab, lens, hlit)) return -1;
        if (!build_table(dist_tab, lens + hlit, hdist)) return -1;
        lt = lit_tab;
        dt = dist_tab;
      }

      // One refill per iteration suffices: a full match consumes at most
      // 15 (litlen) + 5 (len extra) + 15 (dist) + 13 (dist extra) = 48
      // bits and refill leaves >= 57 mid-stream; the L > cnt checks only
      // fire at a (malformed) stream end.
      for (;;) {
        refill(b);
        uint32_t e = lookup(lt, b.buf);
        int L = (int)(e & 0xff);
        if (!L || L > b.cnt) return -1;
        b.buf >>= L;
        b.cnt -= L;
        uint32_t sym = e >> 8;
        if (sym < 256) {
          if (dst >= dst_end) return -1;
          *dst++ = (uint8_t)sym;
          // Literal run: keep decoding while the buffer holds a whole code.
          while (b.cnt >= 15) {
            e = lookup(lt, b.buf);
            L = (int)(e & 0xff);
            if (!L) return -1;
            sym = e >> 8;
            if (sym >= 256) break;
            b.buf >>= L;
            b.cnt -= L;
            if (dst >= dst_end) return -1;
            *dst++ = (uint8_t)sym;
          }
          continue;  // non-literal (bits unconsumed): outer loop re-decodes
        }
        if (sym == 256) break;
        int li = (int)sym - 257;
        if (li >= 29) return -1;
        int eb = kLenExtra[li];
        if (b.cnt < eb) return -1;
        uint32_t len = (uint32_t)kLenBase[li] + take_bits(b, eb);
        e = lookup(dt, b.buf);
        L = (int)(e & 0xff);
        if (!L || L > b.cnt) return -1;
        b.buf >>= L;
        b.cnt -= L;
        uint32_t dsym = e >> 8;
        if (dsym >= 30) return -1;
        int deb = kDistExtra[dsym];
        if (b.cnt < deb) return -1;
        uint32_t dist = (uint32_t)kDistBase[dsym] + take_bits(b, deb);
        if ((int64_t)dist > dst - out) return -1;  // BGZF: no prior history
        if (dst + len > dst_end) return -1;
        const uint8_t* src = dst - dist;
        if (dist == 1) {
          std::memset(dst, dst[-1], len);
          dst += len;
        } else if (dist >= 8 && dst + len + 8 <= hard_end) {
          uint8_t* d = dst;
          const uint8_t* s = src;
          int64_t l = (int64_t)len;
          do {
            std::memcpy(d, s, 8);
            d += 8;
            s += 8;
            l -= 8;
          } while (l > 0);
          dst += len;
        } else {
          for (uint32_t k = 0; k < len; ++k) dst[k] = src[k];
          dst += len;
        }
      }
    }
    if (bfinal) return dst - out;
  }
}

}  // namespace fastinf

extern "C" {

// Fast batched raw-DEFLATE inflate. Same contract as sbt_inflate_blocks
// plus `out_capacity`: the total bytes allocated at `out`, which must
// include >=8 bytes of slack beyond the last block's end (word-copy
// overrun room). Returns 0, or the 1-based index of the first failing
// block — the caller re-runs failures through zlib.
long sbt_inflate_blocks_fast(
    const uint8_t* comp,
    const int64_t* offsets,
    const int64_t* lengths,
    int64_t count,
    uint8_t* out,
    const int64_t* out_offsets,
    const int64_t* out_lengths,
    int64_t out_capacity) {
  uint8_t* hard_end = out + out_capacity;
  for (int64_t i = 0; i < count; ++i) {
    int64_t got = fastinf::inflate_one(
        comp + offsets[i], lengths[i], out + out_offsets[i], out_lengths[i],
        hard_end);
    if (got != out_lengths[i]) return i + 1;
  }
  return 0;
}

}  // extern "C"
