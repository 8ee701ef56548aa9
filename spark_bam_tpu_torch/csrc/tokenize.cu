// DEFLATE entropy phase: one raw-DEFLATE BGZF payload per row → lit/dist
// token planes, out_len and ok.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// tokenize_pallas (_tokenize_kernel, row math tokenize_device._tokenize_row).
// The plain version is spark_bam_tpu_torch/tpu/tokenize_device.py; the error
// model (which streams get ok = 0, and what the planes hold then) is stated
// there and reproduced here decision for decision.
//
// What bounds it on the H100: not bytes. The least traffic is the payload in
// plus 3 bytes out per output byte, tens of microseconds for a 32 MiB window;
// but a code's length is known only after it is decoded, so the symbols of
// one member form a serial chain, and the kernel is bound by that chain's
// latency in cycles per symbol times the symbols of the longest row.
//
// Design: a warp per row (one CTA each, so a window's few hundred rows spread
// over the 132 SMs, at most ceil(rows / 132) per SM before a second CTA
// lands on one). All 32 lanes walk the same bits in lockstep: branches are
// uniform and every table or payload load is a broadcast, so the chain costs
// what one thread's would, and the lanes are free for the wide work:
// - decode tables in shared memory, zlib's two-level layout: a 2^12-entry
//   litlen root (2^8 for distances, 2^7 for the code-length code) and, for
//   codes longer than the root, one subtable per root prefix sized by the
//   longest code under it. An entry is one u32 (length, kind, extra bits,
//   value), so a literal, a length or an end-of-block costs one shared load
//   and a distance one more. Sized for the worst case of any code the
//   contract accepts, incomplete ones included (kLitEntries).
// - literal pairs: a second 2^12 root holds, wherever a window starts with
//   two whole literal codes, one entry that emits both (libdeflate's
//   multi-literal trick). BAM's literals are mostly 5-6 bits, so most
//   literals come two to a lookup. A pair that would cross the payload's end
//   or the row's is taken apart and decoded one literal at a time.
// - table builds split over the lanes: code-length counts and per-symbol
//   ranks with __match_any_sync, canonical codes, then each lane fills its
//   symbols' bit-reversed entries (stride 1 << len); unused entries of an
//   incomplete code are zeroed and fail on first use, as in the plain version.
// - the fixed-Huffman tables are built once per CTA, on the row's first fixed
//   block, into a region of their own.
// - match fills (up to 258 dist entries) and stored copies by all lanes,
//   coalesced; a literal is one byte store that every lane makes alike.
// - refills: aligned 32-bit words into a 64-bit bit buffer, the next word
//   always read one refill ahead, from a 2 KiB ring of the row's payload in
//   shared memory that cp.async keeps 1.5 KiB ahead of the decoder (see
//   BitReader); a whole row in shared memory (up to 64 KiB) would cap an SM
//   at three rows.
// - each litlen lookup is issued one symbol early (decode_block).
//
// Bytes past clen are never decisive: a decode whose code would reach past
// the payload's last bit fails whatever the slack holds, as in the plain
// version, which reads zeros there.
//
// Measured (H100 80GB HBM3, 700 W; benchmarks/profile_tokenize.py, whose
// clock64 copy of this kernel splits each row's cycles): on the first
// 32 MiB window of chip_smoke.py's synthetic BAM a row of ~44,000 symbols
// takes ~5.6 M cycles, ~125 per symbol: ~85 per literal (pairs included),
// ~410 per match run, 5.7 % in table builds; 2.93 ms per window. PERF.md
// keeps the figures.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStride = 65536;     // one BGZF block inflates to <= 64 KiB
constexpr int kStoredChunk = 512;  // stored copies fail per chunk (plain)
constexpr unsigned kFull = 0xffffffffu;

// Root bits: dynamic litlen codes, the fixed litlen code (9 bits at most),
// distances and the code-length code.
constexpr int kLitRoot = 12, kFixedLitRoot = 9, kDistRoot = 8, kClRoot = 7;
constexpr uint32_t kDistMask = (1u << kDistRoot) - 1u;
// The payload ring: kSegs segments of kSegBytes.
constexpr int kSegs = 4, kSegShift = 7, kSegWords = 1 << kSegShift;
constexpr int kSegBytes = 4 * kSegWords;
// Worst-case entries: the root plus one subtable per root prefix reached by
// a longer code. Canonical codes tile the code space from 0 without gaps, so
// every prefix but the last is fully covered, and a covered prefix whose
// longest code has length m holds at least m - root + 1 codes; its subtable
// of 2^(m - root) entries therefore costs at most 8/4 entries per code for
// the litlen root (128/8 for distances), and the last prefix at most
// 2^(15 - root) for its one code: 4096 + 285 * 2 + 8 and 256 + 29 * 16 + 128.
constexpr int kLitEntries = 4674, kDistEntries = 848;
// Regions of the per-row table array (u32 entries): the dynamic litlen
// table, its root with literal pairs, distances, the fixed code's two
// tables and the code-length code's.
constexpr int kLit = 0;
constexpr int kPair = kLit + kLitEntries;
constexpr int kDist = kPair + (1 << kLitRoot);
constexpr int kFixedLit = kDist + kDistEntries;
constexpr int kFixedDist = kFixedLit + (1 << kFixedLitRoot);
constexpr int kCl = kFixedDist + (1 << kDistRoot);
constexpr int kTabWords = kCl + (1 << kClRoot);

// Entry: [0,4) code length (0: no code, decoding fails), [4,7) kind,
// [7,11) extra bits (or a subtable's index bits), [11,27) value: the
// literal or code-length symbol, two literals (first in the low byte), the
// length or distance base, or the subtable's offset in the table array.
constexpr uint32_t kKindValue = 0, kKindPair = 1, kKindBase = 2, kKindEob = 3,
                   kKindSub = 4;
enum Code { kCodeLengths, kLitLen, kDistances };

__device__ __forceinline__ uint32_t entry(uint32_t ln, uint32_t kind,
                                          uint32_t extra, uint32_t value) {
  return ln | kind << 4 | extra << 7 | value << 11;
}
__device__ __forceinline__ int e_len(uint32_t e) { return e & 15; }
__device__ __forceinline__ uint32_t e_kind(uint32_t e) { return (e >> 4) & 7; }
__device__ __forceinline__ int e_extra(uint32_t e) { return (e >> 7) & 15; }
__device__ __forceinline__ uint32_t e_value(uint32_t e) { return e >> 11; }

__constant__ uint8_t kClOrder[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

// The entry of symbol `sym` with a code of `ln` bits. Length and distance
// bases follow RFC 1951 3.2.5 arithmetically (no divergent table loads);
// litlen symbols 286/287 (fixed code only) get no entry and fail when used.
__device__ __forceinline__ uint32_t sym_entry(Code code, int sym, int ln) {
  if (code == kCodeLengths) return entry(ln, kKindValue, 0, sym);
  if (code == kDistances) {
    if (sym >= 30) return 0;
    if (sym < 4) return entry(ln, kKindBase, 0, sym + 1);
    int x = (sym >> 1) - 1;
    return entry(ln, kKindBase, x, ((2 + (sym & 1)) << x) + 1);
  }
  if (sym < 256) return entry(ln, kKindValue, 0, sym);
  if (sym == 256) return entry(ln, kKindEob, 0, 0);
  int c = sym - 257;
  if (c >= 29) return 0;
  if (c == 28) return entry(ln, kKindBase, 0, 258);
  if (c < 8) return entry(ln, kKindBase, 0, c + 3);
  int x = (c >> 2) - 1;
  return entry(ln, kKindBase, x, ((4 + (c & 3)) << x) + 3);
}

struct Shared {
  alignas(16) uint32_t ring[kSegs * kSegWords];
  uint32_t tab[kTabWords];
  int32_t count[16];   // codes per length
  int32_t next[16];    // next canonical code per length (rank pass)
  uint16_t goff[288];  // subtable offset of each long-code root prefix
  uint8_t gbits[288];  // its index bits
  uint8_t lens[320];   // code lengths being built (HLIT + HDIST <= 316)
};

// Build the two-level table of the canonical code with lengths
// lens[first, first + n) at tab[base], root kRoot bits. Returns false when
// the code is oversubscribed (the same left-count test as the plain
// version); an incomplete or empty code is legal and its missing entries are
// 0. Every lane returns the same verdict.
template <int kRoot, Code kCode>
__device__ bool build(Shared& s, int first, int n, int base, int lane) {
  constexpr int root = kRoot;
  if (lane < 16) s.count[lane] = 0;
  __syncwarp();
  for (int s0 = 0; s0 < n; s0 += 32) {
    int sym = s0 + lane;
    int v = sym < n ? s.lens[first + sym] : 0;
    unsigned m = __match_any_sync(kFull, v);
    if (v && lane == __ffs(m) - 1) s.count[v] += __popc(m);
    __syncwarp();
  }
  // Uniform over the lanes: the Kraft test, canonical first codes, and the
  // code-space end (in 15-bit units) after each length.
  int left = 1, code_at = 0, prev = 0;
  uint32_t end[16];
  end[0] = 0;
  bool over = false;
#pragma unroll
  for (int l = 1; l <= 15; ++l) {
    int c = s.count[l];
    left = 2 * left - c;
    over |= left < 0;
    code_at = (code_at + prev) << 1;
    if (lane == 0) s.next[l] = code_at;
    prev = c;
    end[l] = end[l - 1] + ((uint32_t)c << (15 - l));
  }
  if (over) return false;

  const int shift = 15 - root;
  const uint32_t x0 = end[root], x1 = end[15];
  const uint32_t p0 = x0 >> shift;
  // Subtables: one per root prefix in [p0, p1], laid out after the root.
  if (x1 > x0) {
    const int groups = (int)(((x1 - 1) >> shift) - p0 + 1);
    int carry = base + (1 << root);
    for (int g0 = 0; g0 < groups; g0 += 32) {
      int g = g0 + lane;
      uint32_t p = p0 + g;
      int size = 0, bits = 0;
      if (g < groups) {
        uint32_t lim = (p + 1) << shift;
        uint32_t last = (lim < x1 ? lim : x1) - 1;  // last unit under p
        int len = 15;
#pragma unroll
        for (int l = 15; l >= 1; --l)
          if (last < end[l]) len = l;
        bits = len - root;
        size = 1 << bits;
      }
      int incl = size;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        int t = __shfl_up_sync(kFull, incl, d);
        if (lane >= d) incl += t;
      }
      if (g < groups) {
        int off = carry + incl - size;
        s.goff[g] = (uint16_t)off;
        s.gbits[g] = (uint8_t)bits;
        s.tab[base + (__brev(p) >> (32 - root))] =
            entry(0, kKindSub, bits, off);
      }
      carry += __shfl_sync(kFull, incl, 31);
    }
    __syncwarp();
    if (x1 & ((1u << shift) - 1)) {  // the last prefix is partly covered
      int off = s.goff[groups - 1], size = 1 << s.gbits[groups - 1];
      for (int k = lane; k < size; k += 32) s.tab[off + k] = 0;
    }
  }
  // Root entries past the covered code space decode to "no code".
  for (uint32_t p = ((x1 + (1u << shift) - 1) >> shift) + lane;
       p < (1u << root); p += 32)
    s.tab[base + (__brev(p) >> (32 - root))] = 0;
  __syncwarp();

  // Ranks within each length in symbol order give the canonical codes; each
  // lane fills its symbol's entries.
  const unsigned below = (1u << lane) - 1u;
  for (int s0 = 0; s0 < n; s0 += 32) {
    int sym = s0 + lane;
    int v = sym < n ? s.lens[first + sym] : 0;
    unsigned m = __match_any_sync(kFull, v);
    int c = v ? s.next[v] + __popc(m & below) : 0;
    __syncwarp();
    if (v && lane == __ffs(m) - 1) s.next[v] += __popc(m);
    __syncwarp();
    if (v) {
      uint32_t e = sym_entry(kCode, sym, v);
      uint32_t rev = __brev((uint32_t)c) >> (32 - v);
      if (v <= root) {
#pragma unroll 4
        for (uint32_t k = rev; k < (1u << root); k += 1u << v)
          s.tab[base + k] = e;
      } else {
        int g = (c >> (v - root)) - (int)p0;
        int off = s.goff[g];
        uint32_t size = 1u << s.gbits[g];
        for (uint32_t k = rev >> root; k < size; k += 1u << (v - root))
          s.tab[off + k] = e;
      }
    }
  }
  __syncwarp();
  return true;
}

// The payload's bits, LSB first, held uniformly by every lane. The payload
// streams through a ring of kSegs 512-byte segments in shared memory: on
// entering segment g the warp issues one cp.async per lane for segment
// g + kSegs - 1 and waits only for g, which was issued kSegs - 1 segments
// (~1,500 symbols) earlier, so the refills never wait on device memory.
struct BitReader {
  const uint8_t* base;  // the row, aligned down to 16 bytes
  uint32_t* ring;       // kSegs * kSegWords words of shared memory
  int skew;             // bytes from base to payload byte 0
  int end;              // bytes from base that may be read (clen + slack)
  int lane;
  int clen8;            // payload length in bits
  int used;             // bits consumed
  int wpos;             // stream word of `ahead` (4-byte words from base)
  uint32_t ahead;       // that word, loaded one refill early
  int cnt;              // bits held in buf
  uint64_t buf;

  // Issue segment g (zero-filled past `end`) as one cp.async group.
  __device__ __forceinline__ void fetch(int g) {
    const int off = g * kSegBytes + lane * 16;
    const int n = min(max(end - off, 0), 16);
    const uint8_t* src = base + (n ? off : 0);
    const uint32_t dst = (uint32_t)__cvta_generic_to_shared(
        ring + (g % kSegs) * kSegWords + lane * 4);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n"
                 "cp.async.commit_group;" ::"r"(dst),
                 "l"(src), "r"(n)
                 : "memory");
  }

  // wpos has just entered a new segment: recycle the slot of the one
  // before it and wait for this one.
  __device__ void cross() {
    fetch((wpos >> kSegShift) + kSegs - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kSegs - 1) : "memory");
    __syncwarp();
  }

  __device__ __forceinline__ uint32_t next_word() {
    if ((++wpos & (kSegWords - 1)) == 0) cross();
    return ring[wpos & (kSegs * kSegWords - 1)];
  }

  __device__ __forceinline__ void refill() {
    buf |= (uint64_t)ahead << cnt;
    cnt += 32;
    ahead = next_word();
  }

  // Refill when fewer than 32 bits are held.
  __device__ __forceinline__ void top_up() {
    if (cnt < 32) refill();
  }

  __device__ __forceinline__ void consume(int n) {
    buf >>= n;
    cnt -= n;
    used += n;
  }

  // Restart at payload byte `byte` (block start, stored blocks): drain the
  // copies in flight, then fill the ring from the segment holding it.
  __device__ void seek(int byte) {
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncwarp();
    const int v = byte + skew;
    wpos = v >> 2;
    for (int g = wpos >> kSegShift, k = 0; k < kSegs; ++k) fetch(g + k);
    asm volatile("cp.async.wait_group %0;" ::"n"(kSegs - 1) : "memory");
    __syncwarp();
    const int sh = (v & 3) * 8;
    buf = ring[wpos & (kSegs * kSegWords - 1)] >> sh;
    cnt = 32 - sh;
    ahead = next_word();
  }

  // n <= 16 bits, or -1 past the payload's last bit.
  __device__ __forceinline__ int bits(int n) {
    if (used + n > clen8) return -1;
    if (cnt < n) refill();
    int v = (int)((uint32_t)buf & ((1u << n) - 1u));
    consume(n);
    return v;
  }

  // One code through the table at tab[base] (root `root` bits): its entry,
  // consumed, or 0 on truncation or when no code matches.
  __device__ __forceinline__ uint32_t decode(const uint32_t* tab, int base,
                                             int root) {
    top_up();
    uint32_t e = tab[base + ((uint32_t)buf & ((1u << root) - 1u))];
    if (e_kind(e) == kKindSub)
      e = tab[e_value(e) +
              (((uint32_t)buf >> root) & ((1u << e_extra(e)) - 1u))];
    const int ln = e_len(e);
    if (ln == 0 || used + ln > clen8) return 0;
    consume(ln);
    return e;
  }
};

// A shared-memory load issued exactly here: the compiler may not sink it
// into the one branch that uses its value.
__device__ __forceinline__ uint32_t lds_now(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"((uint32_t)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

// The pair root: where a root window holds two whole literal codes, one
// entry emits both (BAM's literals are mostly 5-6 bits); every other entry
// is the single-symbol root's.
__device__ void pair_table(Shared& s, int lane) {
#pragma unroll 4
  for (int w = lane; w < (1 << kLitRoot); w += 32) {
    const uint32_t e1 = s.tab[kLit + w];
    const int l1 = e_len(e1);
    uint32_t out = e1;
    if (e_kind(e1) == kKindValue && l1 > 0 && l1 < kLitRoot) {
      const uint32_t e2 = s.tab[kLit + (w >> l1)];
      const int l2 = e_len(e2);
      if (e_kind(e2) == kKindValue && l2 > 0 && l1 + l2 <= kLitRoot)
        out = entry(l1 + l2, kKindPair, 0, e_value(e1) | e_value(e2) << 8);
    }
    s.tab[kPair + w] = out;
  }
  __syncwarp();
}

// Read a dynamic block's header and build its three codes. False where the
// plain version's dynamic_tables returns None.
__device__ bool dynamic_tables(Shared& s, BitReader& br, int lane) {
  int hlit = br.bits(5), hdist = br.bits(5), hclen = br.bits(4);
  if (hlit < 0 || hdist < 0 || hclen < 0) return false;
  hlit += 257;
  hdist += 1;
  hclen += 4;
  if (hlit > 286 || hdist > 30) return false;
  int mine = 0;  // this lane's code-length-code length (lane < 19)
  for (int i = 0; i < hclen; ++i) {
    int v = br.bits(3);
    if (v < 0) return false;
    if (lane == kClOrder[i]) mine = v;
  }
  if (lane < 19) s.lens[lane] = (uint8_t)mine;
  if (!build<kClRoot, kCodeLengths>(s, 0, 19, kCl, lane)) return false;
  const int tot = hlit + hdist;
  int i = 0, prev = 0;
  while (i < tot) {
    uint32_t e = br.decode(s.tab, kCl, kClRoot);
    if (e == 0) return false;
    int sym = e_value(e);
    if (sym < 16) {
      if (lane == 0) s.lens[i] = (uint8_t)sym;
      prev = sym;
      ++i;
      continue;
    }
    int v, rep;
    if (sym == 16) {
      if (i == 0) return false;
      v = br.bits(2);
      rep = 3 + v;
    } else {
      prev = 0;
      v = sym == 17 ? br.bits(3) : br.bits(7);
      rep = (sym == 17 ? 3 : 11) + v;
    }
    if (v < 0 || i + rep > tot) return false;
    for (int k = lane; k < rep; k += 32) s.lens[i + k] = (uint8_t)prev;
    i += rep;
  }
  __syncwarp();
  if (s.lens[256] == 0) return false;
  if (!build<kLitRoot, kLitLen>(s, 0, hlit, kLit, lane)) return false;
  pair_table(s, lane);
  return build<kDistRoot, kDistances>(s, hlit, hdist, kDist, lane);
}

__device__ void fixed_tables(Shared& s, int lane) {
  for (int i = lane; i < 288; i += 32)
    s.lens[i] = i < 144 ? 8 : i < 256 ? 9 : i < 280 ? 7 : 8;
  build<kFixedLitRoot, kLitLen>(s, 0, 288, kFixedLit, lane);
  if (lane < 30) s.lens[lane] = 5;
  build<kDistRoot, kDistances>(s, 0, 30, kFixedDist, lane);
}

// One Huffman block's symbols, up to its end-of-block (true) or the
// plain version's first rejection (false). `root` is the litlen root table
// (kRoot bits; pairs where the block is dynamic), `single` the same root
// without pairs, `dt` the distance table.
//
// Each litlen lookup is issued one symbol early, before the checks of the
// symbol ahead of it, so its shared-memory latency overlaps them: the loop
// keeps cnt >= 32 at its top and a code takes at most 15 bits, so the next
// code's bits are already in the buffer. Literals run straight through;
// matches and end-of-block branch off.
template <int kRoot>
__device__ __forceinline__ bool decode_block(Shared& s, BitReader& br,
                                             const int root, const int single,
                                             const int dt, uint8_t* lit,
                                             uint16_t* dist, int& o,
                                             const int lane) {
  constexpr uint32_t mask = (1u << kRoot) - 1u;
  br.top_up();
  uint32_t e = s.tab[root + ((uint32_t)br.buf & mask)];
  while (true) {
    int ln = e_len(e);
    uint32_t e_next =
        lds_now(&s.tab[root + (((uint32_t)br.buf >> ln) & mask)]);
    uint32_t kind = e_kind(e);
    if (kind == kKindSub) {  // longer than the root
      e = s.tab[e_value(e) +
                (((uint32_t)br.buf >> kRoot) & ((1u << e_extra(e)) - 1u))];
      ln = e_len(e);
      kind = e_kind(e);
      e_next = s.tab[root + (((uint32_t)br.buf >> ln) & mask)];
    }
    // No code (ln == 0), or a code past the payload's last bit.
    const bool short_bits =
        (unsigned)(ln - 1) >= (unsigned)(br.clen8 - br.used);
    if (kind <= kKindPair) {  // one literal, or two
      const int n = 1 + (int)kind;
      if (short_bits || o + n > kStride) {
        if (kind == kKindPair) {  // the first may still fit: take it alone
          e = s.tab[single + ((uint32_t)br.buf & mask)];
          continue;
        }
        return false;
      }
      br.consume(ln);
      const uint32_t v = e_value(e);
      // Every lane stores the same bytes: one transaction, no divergence.
      lit[o] = (uint8_t)v;
      if (kind == kKindPair) lit[o + 1] = (uint8_t)(v >> 8);
      o += n;
      br.top_up();
      e = e_next;
      continue;
    }
    if (short_bits) return false;
    br.consume(ln);
    if (kind == kKindEob) return true;
    const int xb = e_extra(e);
    const int mlen =
        (int)e_value(e) + (int)((uint32_t)br.buf & ((1u << xb) - 1u));
    br.consume(xb);
    br.top_up();  // >= 32 bits: the distance code and its extra bits
    uint32_t d = s.tab[dt + ((uint32_t)br.buf & kDistMask)];
    if (e_kind(d) == kKindSub)
      d = s.tab[e_value(d) +
                (((uint32_t)br.buf >> kDistRoot) & ((1u << e_extra(d)) - 1u))];
    const int ln2 = e_len(d), xb2 = e_extra(d);
    const int mdist = (int)e_value(d) +
                      (int)(((uint32_t)br.buf >> ln2) & ((1u << xb2) - 1u));
    // The plain version stops at the first of: length extra bits past the
    // payload, no distance code, the code or its extra bits past the
    // payload. Each leaves the same state, and the bits consumed only grow,
    // so one test on the total decides them all.
    if (ln2 == 0 || br.used + ln2 + xb2 > br.clen8 || mdist > o ||
        o + mlen > kStride)
      return false;
    br.consume(ln2 + xb2);
    if (lane < mlen) dist[o + lane] = (uint16_t)mdist;
    if (mlen > 32)
      for (int k = lane + 32; k < mlen; k += 32) dist[o + k] = (uint16_t)mdist;
    o += mlen;
    br.top_up();
    e = s.tab[root + ((uint32_t)br.buf & mask)];
  }
}

__global__ void __launch_bounds__(32)
    tokenize_kernel(const uint8_t* __restrict__ staged,
                    const int32_t* __restrict__ clens, int c_pad,
                    uint8_t* __restrict__ lit_out,
                    uint16_t* __restrict__ dist_out,
                    int32_t* __restrict__ out_lens,
                    uint8_t* __restrict__ ok_out) {
  __shared__ Shared s;
  const int lane = threadIdx.x;
  const int r = blockIdx.x;
  const int clen = clens[r];
  if (clen < 0 || clen > c_pad - 8) {  // outside the staging contract
    if (lane == 0) {
      out_lens[r] = 0;
      ok_out[r] = 0;
    }
    return;
  }
  const uint8_t* row = staged + (size_t)r * c_pad;
  const int skew = (int)((uintptr_t)row & 15);
  BitReader br;
  br.base = row - skew;
  br.ring = s.ring;
  br.skew = skew;
  br.end = skew + clen + 8;
  br.lane = lane;
  br.clen8 = clen * 8;
  br.used = 0;
  br.seek(0);
  uint8_t* lit = lit_out + (size_t)r * kStride;
  uint16_t* dist = dist_out + (size_t)r * kStride;
  bool fixed_built = false;
  int o = 0;
  bool ok = true;
  while (ok) {
    int bfinal = br.bits(1), btype = br.bits(2);
    if (bfinal < 0 || btype < 0 || btype == 3) {
      ok = false;
      break;
    }
    if (btype == 0) {
      br.used = (br.used + 7) & ~7;
      br.seek(br.used >> 3);
      int len = br.bits(16), nlen = br.bits(16);
      if (len < 0 || nlen < 0 || (len ^ 0xFFFF) != nlen) {
        ok = false;
        break;
      }
      while (len > 0) {
        int src = br.used >> 3;
        int chunk = len < kStoredChunk ? len : kStoredChunk;
        if (src + chunk > clen || o + chunk > kStride) {
          ok = false;
          break;
        }
        for (int k = lane; k < chunk; k += 32) lit[o + k] = row[src + k];
        len -= chunk;
        br.used += chunk * 8;
        o += chunk;
      }
      br.seek(br.used >> 3);
    } else {
      if (btype == 2) {
        ok = dynamic_tables(s, br, lane) &&
             decode_block<kLitRoot>(s, br, kPair, kLit, kDist, lit, dist, o,
                                    lane);
      } else {
        if (!fixed_built) {
          fixed_tables(s, lane);
          fixed_built = true;
        }
        ok = decode_block<kFixedLitRoot>(s, br, kFixedLit, kFixedLit,
                                         kFixedDist, lit, dist, o, lane);
      }
      if (!ok) break;
    }
    if (bfinal) break;
  }
  asm volatile("cp.async.wait_all;" ::: "memory");
  if (lane == 0) {
    out_lens[r] = o;
    ok_out[r] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int sbt_tokenize(const uint8_t* staged, const int32_t* clens,
                            int b, int c_pad, uint8_t* lit, uint16_t* dist,
                            int32_t* out_lens, uint8_t* ok,
                            cudaStream_t stream) {
  if (b > 0) {
    tokenize_kernel<<<b, 32, 0, stream>>>(staged, clens, c_pad, lit, dist,
                                          out_lens, ok);
  }
  return (int)cudaGetLastError();
}
