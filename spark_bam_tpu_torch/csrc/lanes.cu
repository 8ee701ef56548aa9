// The funnel's stage 1: the bad cigar-op tables, each survivor's deep mask
// and step, the chain walk of each survivor lane, and the owned-span
// count. Three kernels.
//
// Replaces the jnp / lax.scan device program of spark_bam_tpu/tpu/
// checker.py: _funnel_tables with _allowed_before / _badops_before
// (:281-319), _deep_flags_at (:322-411), _misc_at (:184) and the walk of
// _check_lanes (:538-623), and the funnel branch of count_window
// (:741-760). The plain versions are spark_bam_tpu_torch/tpu/kernels.py::
// _bad_op_tables, _survivor_table and _walk_lanes / _count_lanes (the
// reference's PyTorch form, which the CPU route runs).
//
// 1. bad_op_tables_kernel, one pass over the W + PAD window bytes: a bit
//    per byte for "bad cigar op" (low nibble > 8, the op's int inside n),
//    packed into 32-bit words (the reference's cwords, bit for bit), and
//    per stride-4 class c a summary bit per 1,024-byte block: "a bad op of
//    class c lies in this block". Bound by bytes (W + PAD in, an eighth of
//    that out, ~0.011 ms at W = 2^25 and 3.35 TB/s), so the design keeps
//    enough of them in flight: a CTA takes one 32 KiB super-block, each of
//    its 8 warps four 1 KiB blocks, each lane two 16-byte chunks of a
//    block (neighbouring lanes on neighbouring chunks), and a lane issues
//    all eight of its loads before it uses one: 32 KiB in flight a CTA.
//    Pairs of lanes join their half words by a shuffle; the class summary
//    words are ORed in shared memory. No CTA depends on another.
// 2. survivor_table_kernel, a thread a survivor of the prefilter's list
//    (grid-stride over the n_set survivors present, read from device
//    memory): what the walk needs at a survivor that depends on its
//    position alone, computed once instead of at every lane that lands
//    there (on real data the next nine lanes' chains land on it). Its
//    mask: the stage-0 flags, or where they are 0 under the funnel the
//    full 19-bit mask (the fixed block by funnel shifts, flag_bits.cuh;
//    the read name by 16-byte loads and per-byte SIMD range compares;
//    "any bad op of class cig_start & 3 in [cig_start, cig_end)" from the
//    tables: the two end words, at most 62 whole words beside them four
//    loads at a time, and the class summary words between, at most 10).
//    Where the mask is 0: the record's remaining, its body end and the
//    list rank of the position its step lands on when the lane's cursor
//    is at the record (a galloping, then binary, search forward in the
//    sorted list: one probe when that is the next survivor). 16 bytes an
//    entry, ~1.8 MB a window: the walk's reads of it hit L2.
// 3. walk_lanes_kernel, a thread a survivor lane (grid-stride): each lane
//    walks reads_to_check chained records with the reference's cursor
//    logic. At a position in the list it takes the mask and the step from
//    the table entry, the entry's rank from the previous entry where the
//    step landed where that entry says, else from a bounded forward
//    search; at a position not in the list it takes the stage-0 flags and
//    reads the step on the spot (a survivor past the capacity, when the
//    list overflowed, walks as mask 0, as in the reference's scatter).
//    With per-lane outputs it writes res, fail_mask, reads_before,
//    reads_parsed and exact (check_window); in count mode it reduces
//    instead: the grid's last CTAs walk the lanes and count their owned
//    ones with res == 1 and == 2 while the others count the owned offsets
//    whose stage-0 verdict is an escape (16-byte streaming loads of F,
//    eight in flight a thread); each CTA writes its counts to a partials
//    buffer, and the last CTA to take a ticket (kept per stream,
//    kernels.TileStatus) sums them into (count, esc_count, survivors), or
//    (0, owned offsets, survivors) on a capacity overflow. What bounds the
//    count is the F scan's bytes (4 an owned offset, ~84 MB of the ~88 MB
//    at W = 2^25); a lane's ~10 dependent table reads take a few
//    microseconds, and the walk launch starts under the table's
//    (programmatic dependent launch), its scanning CTAs first.
//
// JVM int32 arithmetic as in the reference: the implied record size
// wraps (flag_bits.cuh); remaining and the logical cursor are int64 here,
// clamped to +-(n + 64) as the reference's sentinels, with the same
// overflow test. n, at_eof, lo and own come by value or from device
// memory (a launch captured in a CUDA graph reads each replay's values).

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "flag_bits.cuh"

namespace {

constexpr int kThreads = 256;                  // survivor table and walk
constexpr int kTableThreads = 256;             // bad_op_tables
constexpr int kTableWarps = kTableThreads / 32;
constexpr int kBlockWords = 32;                // bitmap words a summary bit covers
constexpr int kSuperWords = 32 * kBlockWords;  // words a summary word covers
constexpr int kSuperBytes = 32 * kSuperWords;
constexpr int kWarpBlocks = 32 / kTableWarps;  // 1 KiB blocks a table warp packs
constexpr uint32_t kClass = 0x11111111u;       // the bits of class 0 in a word
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int32_t kEscape = sbt::kTooFewFixedBlockBytes |
                            sbt::kTooFewBytesForReadName |
                            sbt::kTooFewBytesForCigarOps;
constexpr int32_t kDefinitive = ((1 << 19) - 1) & ~kEscape;
// A table entry's successor field when the walk must search itself.
constexpr int32_t kNoSucc = INT_MIN;
// The count's F scan: 16-byte loads a thread keeps in flight.
constexpr int kScanDepth = 8;

static_assert(kTableWarps * kWarpBlocks == 32, "a CTA packs a super-block");

// profile launches: bad_op_tables, survivor_table, walk_lanes
// profile phases: load, pack, ballot; block, name, any_bad, successor, entry, search, step
#ifdef SBT_PROFILE
// Profiling build only (benchmarks/profile_lanes.py): clock64 laps of each
// table warp (load, pack, ballot: over its four blocks), of each survivor
// in the table pass (its fixed block and flags, name check, bad-op lookup,
// step and successor search) and of each walk lane (table entries and
// stage-0 flags, searches, the steps' arithmetic and on-the-spot blocks),
// with the steps a lane took: row i holds survivor i's table laps and lane
// i's walk laps. A lap ends after an instruction that consumes the lap's
// last load, so it counts the load's latency and not just its issue.
constexpr int kProfWarps = 16384;
constexpr int kProfLanes = 1 << 17;
constexpr int kLaneCols = 8;
__device__ long long g_tab_marks[3 * kProfWarps];
__device__ long long g_walk_marks[kLaneCols * kProfLanes];
__device__ unsigned g_prof_sink;
struct Prof {
  long long c[kLaneCols - 1];
  long long t;
  unsigned sink;
  __host__ __device__ Prof() : c{0, 0, 0, 0, 0, 0, 0}, t(0), sink(0) {}
};
#define SBT_LAP(p, k, x)                                              \
  do {                                                                \
    asm volatile("add.u32 %0, %0, %1;" : "+r"((p).sink)               \
                 : "r"((unsigned)(x)));                               \
    const long long now_ = clock64();                                 \
    (p).c[k] += now_ - (p).t;                                         \
    (p).t = now_;                                                     \
  } while (0)
#define SBT_RESTART(p) ((p).t = clock64())
#else
struct Prof {};
#define SBT_LAP(p, k, x)
#define SBT_RESTART(p)
#endif

// Bit k of the result: byte k of the 16 has a low nibble above 8.
__device__ __forceinline__ uint32_t nibble_bits(uint4 u) {
  const uint32_t v[4] = {u.x, u.y, u.z, u.w};
  uint32_t bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    // Bit 4 of each byte: its low nibble is at least 9; then the four
    // bits (at 0, 8, 16, 24 after the shift) gathered to 21-24 by one
    // multiply whose partial products never meet.
    const uint32_t hi =
        (((v[k] & 0x0F0F0F0Fu) + 0x07070707u) & 0x10101010u) >> 4;
    bits |= ((hi * 0x00204081u) >> 21 & 0xFu) << (4 * k);
  }
  return bits;
}

// The 16 bytes at ``j`` (a multiple of 16) as a uint4, the bytes at or
// past ``total`` read as 0 (the last, partial super-block).
__device__ __forceinline__ uint4 chunk_at(const uint8_t* __restrict__ padded,
                                          long long j, int total) {
  if (j + 16 <= total)
    return __ldg(reinterpret_cast<const uint4*>(padded + j));
  uint32_t v[4] = {0, 0, 0, 0};
  for (int k = 0; k < 16; ++k)
    if (j + k < total)
      v[k >> 2] |= (uint32_t)__ldg(padded + j + k) << (8 * (k & 3));
  return make_uint4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kTableThreads)
bad_op_tables_kernel(const uint8_t* __restrict__ padded, int total,
                     int n_val, const int32_t* __restrict__ n_ptr,
                     uint32_t* __restrict__ words, int nwords,
                     uint32_t* __restrict__ blocks, int nsuper) {
  __shared__ uint32_t part[kTableWarps][4];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int sb = blockIdx.x;
  const long long n = n_ptr ? __ldg(n_ptr) : n_val;
  const long long base = (long long)sb * kSuperBytes;
  Prof prof;
  SBT_RESTART(prof);
  // Block warp + 8 i of the super-block; lane l reads its chunks l and
  // l + 32 (bytes 16 l and 512 + 16 l).
  uint4 u[kWarpBlocks][2];
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const long long at = base + 1024LL * (warp + kTableWarps * i) + 16 * lane;
    u[i][0] = chunk_at(padded, at, total);
    u[i][1] = chunk_at(padded, at + 512, total);
  }
  SBT_LAP(prof, 0, u[0][0].x ^ u[kWarpBlocks - 1][1].w);
  const bool odd = lane & 1;
  uint32_t cls[4] = {0, 0, 0, 0};  // class c's block bits
#pragma unroll
  for (int i = 0; i < kWarpBlocks; ++i) {
    const int blk = warp + kTableWarps * i;
    const uint32_t h0 = nibble_bits(u[i][0]), h1 = nibble_bits(u[i][1]);
    const uint32_t p0 = __shfl_xor_sync(kAll, h0, 1);
    const uint32_t p1 = __shfl_xor_sync(kAll, h1, 1);
    // An even lane 2m holds word m of the block (its chunk the low half,
    // its partner's the high); an odd lane 2m + 1 word 16 + m.
    uint32_t bits = odd ? (p1 | h1 << 16) : (h0 | p0 << 16);
    const int wi = sb * kSuperWords + blk * kBlockWords +
                   (odd ? 16 + (lane >> 1) : lane >> 1);
    // Only ops whose 4-byte int ends inside n: j + 4 <= n.
    const long long lim = n - 4 - 32LL * wi;  // the last bit that may stay
    if (lim < 0)
      bits = 0;
    else if (lim < 31)
      bits &= (2u << lim) - 1u;
    if (wi < nwords) words[wi] = bits;
    SBT_LAP(prof, 1, bits);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      if (__ballot_sync(kAll, (bits & (kClass << c)) != 0))
        cls[c] |= 1u << blk;
    SBT_LAP(prof, 2, cls[0]);
  }
  if (lane == 0)
    for (int c = 0; c < 4; ++c) part[warp][c] = cls[c];
  __syncthreads();
  if (threadIdx.x < 4) {
    uint32_t acc = 0;
    for (int v = 0; v < kTableWarps; ++v) acc |= part[v][threadIdx.x];
    blocks[threadIdx.x * nsuper + sb] = acc;
  }
#ifdef SBT_PROFILE
  const int pw = sb * kTableWarps + warp;
  if (lane == 0 && pw < kProfWarps)
    for (int k = 0; k < 3; ++k) g_tab_marks[3 * pw + k] = prof.c[k];
  if (prof.sink == 0x9E3779B9u) g_prof_sink = prof.sink;
#endif
}

// Any of the class bits ``cm`` in whole words [k0, k1), four loads at once.
__device__ __forceinline__ bool any_in_words(const uint32_t* __restrict__ words,
                                             int k0, int k1, uint32_t cm) {
  for (int k = k0; k < k1; k += 4) {
    uint32_t acc = __ldg(words + k);
    if (k + 1 < k1) acc |= __ldg(words + k + 1);
    if (k + 2 < k1) acc |= __ldg(words + k + 2);
    if (k + 3 < k1) acc |= __ldg(words + k + 3);
    if (acc & cm) return true;
  }
  return false;
}

// Any bad op of class c (offsets j = c mod 4) in [a, b), 0 <= a <= b;
// ``wa_word`` and ``wb_word`` are the words that hold bytes a and b - 1
// (loaded by the caller with its other loads).
__device__ bool any_bad(const uint32_t* __restrict__ words,
                        const uint32_t* __restrict__ blocks, int nsuper,
                        int a, int b, int c, uint32_t wa_word,
                        uint32_t wb_word) {
  if (a >= b) return false;
  const uint32_t cm = kClass << c;
  const int wa = a >> 5, wb = (b - 1) >> 5;
  const uint32_t lo_mask = kAll << (a & 31);
  const uint32_t hi_mask = kAll >> (31 - ((b - 1) & 31));
  if (wa == wb) return (wa_word & cm & lo_mask & hi_mask) != 0;
  if (wa_word & cm & lo_mask) return true;
  if (wb_word & cm & hi_mask) return true;
  // Whole words [w0, w1), and whole blocks [b0, b1) among them.
  const int w0 = wa + 1, w1 = wb;
  const int b0 = (w0 + kBlockWords - 1) / kBlockWords, b1 = w1 / kBlockWords;
  if (b0 >= b1) return any_in_words(words, w0, w1, cm);
  if (any_in_words(words, w0, b0 * kBlockWords, cm)) return true;
  if (any_in_words(words, b1 * kBlockWords, w1, cm)) return true;
  const uint32_t* cb = blocks + c * nsuper;
  const int s0 = b0 >> 5, s1 = (b1 - 1) >> 5;
  for (int s = s0; s <= s1; ++s) {
    uint32_t m = __ldg(cb + s);
    if (s == s0) m &= kAll << (b0 & 31);
    if (s == s1) m &= kAll >> (31 - ((b1 - 1) & 31));
    if (m) return true;
  }
  return false;
}

struct LaneArgs {
  const uint8_t* padded;
  int total, w;
  const int32_t* lengths;
  int cmax, num_contigs;
  int n_val, ae_val, lo_val, own_val;
  const int32_t *n_ptr, *ae_ptr, *lo_ptr, *own_ptr;
  const int32_t* F;
  const int32_t* cand;
  int capacity;
  const int32_t* n_set;
  const uint32_t* words;
  const uint32_t* blocks;
  int nsuper;
  int reads_to_check, funnel;
  int4* table;
  // Per-lane outputs (check_window), or null.
  int8_t* res;
  int32_t *fail_mask, *reads_before, *reads_parsed;
  uint8_t* exact;
  // Count mode (count_window), or null.
  int32_t* status;
  unsigned ticket_base;
  int32_t* partials;
  long long* out;
};

// The survivors present in the list: min(n_set, capacity).
__device__ __forceinline__ int live_lanes(const LaneArgs& a) {
  return min(max(__ldg(a.n_set), 0), a.capacity);
}

// The 36-byte fixed block at byte offset q (q & ~15 + 48 <= total): three
// 16-byte loads from q's 16-byte boundary (three transactions a thread,
// not nine), then the nine words from the one that holds byte q, picked
// by selects (a register array indexed at run time would go to local
// memory).
__device__ __forceinline__ sbt::FixedBlock block_at(const uint8_t* padded,
                                                    int q) {
  const uint4* src = reinterpret_cast<const uint4*>(padded + (q & ~15));
  const uint4 c0 = __ldg(src), c1 = __ldg(src + 1), c2 = __ldg(src + 2);
  const uint32_t w[12] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y,
                          c1.z, c1.w, c2.x, c2.y, c2.z, c2.w};
  const int k = (q >> 2) & 3;
  uint32_t v[9];
#pragma unroll
  for (int j = 0; j < 9; ++j)
    v[j] = k == 0 ? w[j] : k == 1 ? w[j + 1] : k == 2 ? w[j + 2] : w[j + 3];
  return sbt::fixed_block(v, 8u * (q & 3));
}

// The bytes of the word at byte address ``at`` that lie in [lo, hi), as a
// byte mask.
__device__ __forceinline__ uint32_t byte_window(int at, int lo, int hi) {
  const int a = lo - at, z = hi - at;  // keep bytes k with a <= k < z
  const uint32_t from = a <= 0 ? kAll : (a >= 4 ? 0u : kAll << (8 * a));
  const uint32_t to = z >= 4 ? kAll : (z <= 0 ? 0u : kAll >> (8 * (4 - z)));
  return from & to;
}

// A byte of [q0, q1) outside the read name's alphabet (0x21-0x7E but '@'):
// 32 bytes at a time from q0's 16-byte boundary (the first 32, ``u0`` and
// ``u1``, loaded by the caller), four bytes a SIMD compare.
__device__ bool name_has_bad_byte(const uint8_t* __restrict__ p, int total,
                                  int q0, int q1, uint4 u0, uint4 u1) {
  for (int c = q0 & ~15; c < q1; c += 32) {
    if (c != (q0 & ~15)) {
      u0 = chunk_at(p, c, total);
      u1 = chunk_at(p, c + 16, total);
    }
    const uint32_t v[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
    uint32_t bad = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t out = __vcmpltu4(v[k], 0x21212121u) |
                           __vcmpgtu4(v[k], 0x7E7E7E7Eu) |
                           __vcmpeq4(v[k], 0x40404040u);
      bad |= out & byte_window(c + 4 * k, q0, q1);
    }
    if (bad) return true;
  }
  return false;
}

// The full 19-bit mask at ``pos`` (0 <= pos < w) as the reference's
// _deep_flags_at computes it, quirks included; ``b`` is the fixed block
// there and ``f`` the bits it alone decides.
__device__ int32_t deep_flags(const LaneArgs& a, int pos, int n,
                              const sbt::FixedBlock& b, int32_t f,
                              Prof& prof) {
  const uint8_t* p = a.padded;
  const int total = a.total;
  const int name_len = (int)b.name_len;
  const int name_start = pos + 36;
  const int name_end = name_start + name_len;
  const bool has_name = name_len >= 2;
  const bool name_eof = has_name && name_end > n;
  const bool name_in = has_name && !name_eof;
  const int last = min(max(name_end - 1, 0), total - 1);
  const int q0 = min(max(name_start, 0), total - 1);
  const int cig_start = name_start + (name_in ? name_len : 0);
  const int cig_end = cig_start + 4 * (int)b.n_cigar;
  const bool considered = !name_eof;
  const int qa = min(max(cig_start, 0), total - 1);
  const int qb = min(max(cig_end, 0), total - 1);
  // The loads that depend on the block alone, issued together: the name's
  // last byte and first 32 bytes, the cigar's two end words.
  const uint32_t last_byte = __ldg(p + last);
  const uint4 u0 = chunk_at(p, q0 & ~15, total);
  const uint4 u1 = chunk_at(p, (q0 & ~15) + 16, total);
  const bool span = considered && qa < qb;
  const uint32_t wa_word = span ? __ldg(a.words + (qa >> 5)) : 0u;
  const uint32_t wb_word = span ? __ldg(a.words + ((qb - 1) >> 5)) : 0u;

  if (name_eof) f |= sbt::kTooFewBytesForReadName;
  const bool non_null = name_in && last_byte != 0;
  if (non_null) f |= sbt::kNonNullTerminatedReadName;
  if (name_in && !non_null) {
    // Allowed bytes in [name_start, last) against name_len - 1: every one.
    if (last - q0 != name_len - 1 ||
        name_has_bad_byte(p, total, q0, last, u0, u1))
      f |= sbt::kNonASCIIReadName;
  }
  SBT_LAP(prof, 1, f);

  bool has_bad = false;
  if (considered)
    has_bad = any_bad(a.words, a.blocks, a.nsuper, qa, qb, cig_start & 3,
                      wa_word, wb_word);
  if (has_bad) f |= sbt::kInvalidCigarOp;
  const bool cig_eof = considered && !has_bad && cig_end > n;
  if (cig_eof) f |= sbt::kTooFewBytesForCigarOps;
  const bool empty_ok =
      considered && !has_bad && !cig_eof && ((b.flag >> 2) & 1u) == 0;
  // Swapped on purpose: reference quirk (EmptyMapped binds its fields in
  // the other order).
  if (empty_ok && b.seq_len == 0) f |= sbt::kEmptyMappedCigar;
  if (empty_ok && b.n_cigar == 0) f |= sbt::kEmptyMappedSeq;
  if (pos > n - 36) f = sbt::kTooFewFixedBlockBytes;
  SBT_LAP(prof, 2, f);
  return f;
}

// The reference's _misc_at body end of the record at pi.
__device__ __forceinline__ long long body_end(const sbt::FixedBlock& b,
                                              int pi, int n) {
  const int name_len = (int)b.name_len;
  const bool has_name = name_len >= 2;
  const bool name_eof = has_name && pi + 36 + name_len > n;
  const bool name_in = has_name && !name_eof;
  const long long cig_start = pi + 36 + (name_in ? name_len : 0);
  return pi > n - 36 ? pi + 36
                     : cig_start + (name_eof ? 0 : 4LL * (int)b.n_cigar);
}

__device__ __forceinline__ long long clamp64(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// One step of a lane's cursors from a record with ``rem`` and ``b_end``:
// out-of-range logical cursors collapse to sentinels +-(n + 64); a lane
// whose cursor would need to re-enter range is flagged.
struct Step {
  long long logical, physical;
  bool overflow;
};
__device__ __forceinline__ Step step_from(long long logical, long long rem,
                                          long long b_end, int n) {
  const long long bound = (long long)n + 64;
  const long long rem_c = clamp64(rem, -bound, bound);
  const long long next_logical = logical + 4 + rem_c;
  const long long clamped = clamp64(next_logical, -bound, bound);
  Step s;
  s.overflow = rem > bound || rem < -bound || next_logical != clamped;
  s.physical = min(b_end > clamped ? b_end : clamped, (long long)n);
  s.logical = clamped;
  return s;
}

// The first index i in [from, live) with cand[i] >= x, or live; every
// entry before ``from`` is below x. Galloping probes forward from
// ``from`` (one when x is at or before the entry there), then a binary
// search between the last two probes: at most 2 log2(live) + 2 loads.
__device__ int rank_from(const int32_t* __restrict__ cand, int from, int live,
                         int x) {
  int lo = from, hi = live;
  for (int d = 1;; d <<= 1) {
    const int probe = lo + d - 1;
    if (probe >= live) break;
    if (__ldg(cand + probe) >= x) {
      hi = probe;
      break;
    }
    lo = probe + 1;
  }
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(cand + mid) >= x)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// Survivor r's table entry: (mask, remaining, body end, successor). Where
// the mask is not 0 the walk stops there and the rest is (0, 0, kNoSucc).
// The successor is the list rank of the position the record's step lands
// on when the lane's logical cursor is at it, if that position is in the
// list, else ~(its lower bound); kNoSucc where that position is at or past
// n or past w - 1 (the walk then needs no lookup, or searches itself).
__device__ int4 survivor_entry(const LaneArgs& a, int r, int live, int n,
                               Prof& prof) {
  const int q = min(max(__ldg(a.cand + r), 0), a.w - 1);
  int32_t f = __ldg(a.F + q);
  const sbt::FixedBlock b = block_at(a.padded, q);
  // The step from the record and the next survivor, loaded beside the
  // deep mask's loads (used where the mask is 0).
  const long long b_end = body_end(b, q, n);
  const long long nat = step_from(q, b.remaining, b_end, n).physical;
  const int next = r + 1 < live ? __ldg(a.cand + r + 1) : INT_MAX;
  if (a.funnel && f == 0) {
    const int32_t fixed =
        sbt::fixed_bits(b, a.lengths, a.cmax, a.num_contigs);
    SBT_LAP(prof, 0, fixed);
    f = deep_flags(a, q, n, b, fixed, prof);
  } else {
    SBT_LAP(prof, 0, f ^ b.remaining);
  }
  int4 e = make_int4(f, 0, 0, kNoSucc);
  if (f != 0) return e;
  e.y = b.remaining;
  e.z = (int)b_end;
  if (nat < n && nat <= a.w - 1) {
    // One probe when the next survivor is at or past the step's landing.
    const int lb = r + 1 >= live || next >= nat
                       ? r + 1
                       : rank_from(a.cand, r + 2, live, (int)nat);
    const int at = lb == r + 1 ? next : (lb < live ? __ldg(a.cand + lb) : 0);
    e.w = lb < live && at == (int)nat ? lb : ~lb;
  }
  SBT_LAP(prof, 3, e.w);
  return e;
}

// Hopper's programmatic dependent launch: the walk, launched with
// programmatic stream serialization right after the survivor table, may
// start once every table CTA has run launch_dependents; its threads that
// read the table first wait until the table's grid has completed and its
// writes are visible. The count's scanning CTAs wait only when done, so
// the F scan runs under the table pass, and the walk's grid still ends
// after the table's (later work on the stream may count on that).
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}
__device__ __forceinline__ void wait_for_table() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads) survivor_table_kernel(LaneArgs a) {
  launch_dependents();
  const int n = a.n_ptr ? __ldg(a.n_ptr) : a.n_val;
  const int live = live_lanes(a);
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < live;
       r += gridDim.x * kThreads) {
    Prof prof;
    SBT_RESTART(prof);
    a.table[r] = survivor_entry(a, r, live, n, prof);
#ifdef SBT_PROFILE
    if (r < kProfLanes)
      for (int j = 0; j < 4; ++j) g_walk_marks[kLaneCols * r + j] = prof.c[j];
    if (prof.sink == 0x9E3779B9u) g_prof_sink = prof.sink;
#endif
  }
}

struct LaneOut {
  int r, rb, rp;
  int32_t fm;
  bool ex;
};

// The walk of lane k < live (reads_to_check chained records from cand[k]),
// line for line the reference's _check_lanes step.
__device__ LaneOut walk_lane(const LaneArgs& a, int k, int live, int n,
                             bool ae, Prof& prof) {
  LaneOut o{0, 0, 0, 0, true};
  const int w = a.w;
  const int4* table = a.table;
  long long logical = __ldg(a.cand + k), physical = logical;
  bool lov = false;
  // The list rank at or after the lane's position, and whether the
  // position is the entry there (e its entry).
  int lb = k;
  bool have = true;
  int4 e = __ldg(table + k);
  SBT_LAP(prof, 4, e.x);
  int step = 0;
  for (; step < a.reads_to_check; ++step) {
    // EOF at a record edge (zero bytes left): eager/Checker.scala:36-39.
    if (physical >= n) {
      const bool edge = physical == logical && !lov && step > 0;
      const bool maybe_edge = lov && step > 0;
      if (ae && edge) {
        o.r = 1;
        o.rp = step;
      } else if (ae && !maybe_edge) {
        o.r = -1;
        o.fm = sbt::kTooFewFixedBlockBytes;
        o.rb = step;
      } else {
        o.r = 2;
      }
      break;
    }
    const int pi = (int)clamp64(physical, 0, w - 1);
    const int32_t f = have ? e.x : __ldg(a.F + pi);
    if (f != 0) {
      // Every bit is definitive or an escape bit.
      const int32_t definitive = f & kDefinitive, boundary = f & kEscape;
      if (definitive != 0 || (ae && boundary != 0)) {
        o.r = -1;
        o.fm = f;
        o.rb = step;
        if (!ae && definitive != 0 && boundary != 0) o.ex = false;
      } else {
        o.r = 2;
      }
      break;
    }
    long long rem, b_end;
    if (have) {
      rem = e.y;
      b_end = e.z;
    } else {
      // Not in the list (past the capacity): the step read on the spot.
      const sbt::FixedBlock b = block_at(a.padded, pi);
      rem = b.remaining;
      b_end = body_end(b, pi, n);
    }
    const Step s = step_from(logical, rem, b_end, n);
    SBT_LAP(prof, 6, (unsigned)s.physical);
    if (s.physical < n) {
      const int npi = (int)min(s.physical, (long long)(w - 1));
      if (have && e.w != kNoSucc &&
          s.physical == step_from(pi, rem, b_end, n).physical) {
        have = e.w >= 0;
        lb = have ? e.w : ~e.w;
      } else {
        lb = rank_from(a.cand, have && npi > pi ? lb + 1 : lb, live, npi);
        have = lb < live && __ldg(a.cand + lb) == npi;
      }
      SBT_LAP(prof, 5, lb);
      if (have) e = __ldg(table + lb);
      SBT_LAP(prof, 4, e.x);
    }
    logical = s.logical;
    physical = s.physical;
    lov = lov || s.overflow;
  }
  if (o.r == 0) {
    o.r = 1;
    o.rp = a.reads_to_check;
  }
#ifdef SBT_PROFILE
  if (k < kProfLanes) {
    for (int j = 4; j < kLaneCols - 1; ++j)
      g_walk_marks[kLaneCols * k + j] = prof.c[j];
    g_walk_marks[kLaneCols * k + kLaneCols - 1] = step;
  }
  if (prof.sink == 0x9E3779B9u) g_prof_sink = prof.sink;
#endif
  return o;
}

// Owned offsets in [i0, i1) whose stage-0 verdict is an escape, this
// thread's grid-stride share: scalars up to a 16-byte boundary and past
// the last whole group, 16-byte streaming loads between, kScanDepth in
// flight.
__device__ int scan_escapes(const int32_t* __restrict__ F, int i0, int i1,
                           int t, int stride) {
  if (i0 >= i1) return 0;
  const auto esc = [](int32_t f) {
    return (f & kDefinitive) == 0 && (f & kEscape) != 0 ? 1 : 0;
  };
  const int head = min(
      (int)(((16 - (reinterpret_cast<uintptr_t>(F + i0) & 15)) & 15) >> 2),
      i1 - i0);
  const int v0 = i0 + head;
  const int groups = (i1 - v0) >> 2;
  const int tail0 = v0 + 4 * groups;
  int e = 0;
  for (int j = t; j < head; j += stride) e += esc(__ldg(F + i0 + j));
  for (int j = tail0 + t; j < i1; j += stride) e += esc(__ldg(F + j));
  const int4* F4 = reinterpret_cast<const int4*>(F + v0);
  for (int g = t; g < groups; g += kScanDepth * stride) {
    int4 v[kScanDepth];
#pragma unroll
    for (int u = 0; u < kScanDepth; ++u)
      v[u] = g + u * stride < groups ? __ldcs(F4 + g + u * stride)
                                     : make_int4(0, 0, 0, 0);
#pragma unroll
    for (int u = 0; u < kScanDepth; ++u)
      e += esc(v[u].x) + esc(v[u].y) + esc(v[u].z) + esc(v[u].w);
  }
  return e;
}

// Sum of one int over the CTA (every thread gets it).
__device__ int block_sum(int v, int* scratch) {
  for (int d = 16; d > 0; d >>= 1) v += __shfl_down_sync(kAll, v, d);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  int s = 0;
  for (int k = 0; k < kThreads / 32; ++k) s += scratch[k];
  return s;
}

__global__ void __launch_bounds__(kThreads) walk_lanes_kernel(LaneArgs a) {
  __shared__ int scratch[kThreads / 32];
  __shared__ bool last_cta;
  const int n = a.n_ptr ? __ldg(a.n_ptr) : a.n_val;
  const bool ae = (a.ae_ptr ? __ldg(a.ae_ptr) : a.ae_val) != 0;
  const int n_set = __ldg(a.n_set);
  const int live = live_lanes(a);
  const bool overflow = n_set > a.capacity;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;

  if (a.res != nullptr) {
    // From the list's end: the CTAs that start first, under the table
    // pass, write the empty lanes past the survivors, and a thread waits
    // for the table only when it reaches a survivor's lane.
    for (int k = a.capacity - 1 - t; k >= 0; k -= stride) {
      Prof prof;
      SBT_RESTART(prof);
      if (k < live) wait_for_table();
      const LaneOut o = k < live ? walk_lane(a, k, live, n, ae, prof)
                                 : LaneOut{-1, 0, 0, 0, true};
      a.res[k] = (int8_t)o.r;
      a.fail_mask[k] = o.fm;
      a.reads_before[k] = o.rb;
      a.reads_parsed[k] = o.rp;
      a.exact[k] = o.ex ? 1 : 0;
    }
    wait_for_table();
    return;
  }

  // Count mode: the owned lanes' verdicts, and the owned offsets whose
  // stage-0 verdict is an escape. The grid is one wave, so its CTAs run at
  // once: the last walk the lanes (their chains wait on L2) while the
  // others, at least a quarter of them, scan F (at HBM's rate). The
  // scanners come first, so that they take the SMs as the survivor
  // table's CTAs leave them and scan under the table pass.
  const int lo = a.lo_ptr ? __ldg(a.lo_ptr) : a.lo_val;
  const int own = a.own_ptr ? __ldg(a.own_ptr) : a.own_val;
  const int grid = gridDim.x;
  const int walkers = grid == 1 ? 1
                                : min((live + kThreads - 1) / kThreads,
                                      grid - max(1, grid / 4));
  const int scanners = grid == 1 ? 1 : grid - walkers;
  const int walker = (int)blockIdx.x - (grid - walkers);  // < 0: none
  int cnt = 0, esc = 0;
  if (walker >= 0) {
    wait_for_table();
    for (int k = walker * kThreads + threadIdx.x; k < live;
         k += walkers * kThreads) {
      Prof prof;
      SBT_RESTART(prof);
      const int c = __ldg(a.cand + k);
      const LaneOut o = walk_lane(a, k, live, n, ae, prof);
      const bool owned = c >= 0 && c >= lo && c < own;
      cnt += owned && o.r == 1;
      esc += owned && o.r == 2;
    }
  }
  const int i0 = max(lo, 0), i1 = min(own, a.w);
  if (!ae && (int)blockIdx.x < scanners)
    esc += scan_escapes(a.F, i0, i1, t, scanners * kThreads);
  wait_for_table();
  cnt = block_sum(cnt, scratch);
  esc = block_sum(esc, scratch);
  if (threadIdx.x == 0) {
    a.partials[2 * blockIdx.x] = cnt;
    a.partials[2 * blockIdx.x + 1] = esc;
    __threadfence();
    const unsigned ticket =
        atomicAdd(reinterpret_cast<unsigned*>(a.status), 1u);
    last_cta = ticket - a.ticket_base == gridDim.x - 1;
  }
  __syncthreads();
  if (!last_cta) return;
  __threadfence();
  long long c_sum = 0, e_sum = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads) {
    c_sum += __ldcg(a.partials + 2 * b);
    e_sum += __ldcg(a.partials + 2 * b + 1);
  }
  // Each sum is below 2^31 (at most the window's offsets).
  const int count = block_sum((int)c_sum, scratch);
  const int escaped = block_sum((int)e_sum, scratch);
  if (threadIdx.x == 0) {
    a.out[0] = overflow ? 0 : count;
    a.out[1] = overflow ? (long long)max(i1 - i0, 0) : escaped;
    a.out[2] = n_set;
  }
}

}  // namespace

// ``padded`` holds ``total`` bytes (starting on a 16-byte boundary);
// ``words`` holds ceil(total / 32) words and ``blocks`` 4 * nsuper, nsuper
// = ceil(total / 32768). The valid byte count is ``n`` or, when ``n_ptr``
// is not null, the int32 it points to in device memory.
extern "C" int sbt_bad_op_tables(const uint8_t* padded, int total, int n,
                                 const int32_t* n_ptr, uint32_t* words,
                                 int nwords, uint32_t* blocks, int nsuper,
                                 cudaStream_t stream) {
  if (total <= 0 || nsuper <= 0) return (int)cudaGetLastError();
  bad_op_tables_kernel<<<nsuper, kTableThreads, 0, stream>>>(
      padded, total, n, n_ptr, words, nwords, blocks, nsuper);
  return (int)cudaGetLastError();
}

// The CTAs of the survivor table and the walk that run at once on the
// current device: the wrappers launch min(that, ceil(capacity / 256)).
extern "C" int sbt_lanes_ctas() {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, walk_lanes_kernel,
                                                kThreads, 0);
  return sms * per_sm;
}

namespace {

LaneArgs table_args(const uint8_t* padded, int total, int w,
                    const int32_t* lengths, int cmax, int num_contigs, int n,
                    const int32_t* n_ptr, const int32_t* F,
                    const int32_t* cand, int capacity, const int32_t* n_set,
                    const uint32_t* words, const uint32_t* blocks, int nsuper,
                    int funnel, int4* table) {
  LaneArgs a{};
  a.padded = padded;
  a.total = total;
  a.w = w;
  a.lengths = lengths;
  a.cmax = cmax;
  a.num_contigs = num_contigs;
  a.n_val = n;
  a.n_ptr = n_ptr;
  a.F = F;
  a.cand = cand;
  a.capacity = capacity;
  a.n_set = n_set;
  a.words = words;
  a.blocks = blocks;
  a.nsuper = nsuper;
  a.funnel = funnel;
  a.table = table;
  return a;
}

}  // namespace

// The ``table`` (capacity int4) entries of the first min(n_set, capacity)
// survivors of ``cand`` (the ``capacity``-long survivor list in increasing
// order, -1 past the population; ``n_set`` the exact survivor count in
// device memory). ``F`` holds the stage-0 flags (``funnel`` 1: the
// prefilter's, with the deep mask computed where they are 0 from the
// bad-op tables ``words`` and ``blocks``) or the full pass's (``funnel``
// 0: looked up as they are). ``grid`` CTAs of 256 threads. The valid
// byte count is ``n`` or, where ``n_ptr`` is not null, the int32 there.
extern "C" int sbt_survivor_table(
    const uint8_t* padded, int total, int w, const int32_t* lengths, int cmax,
    int num_contigs, int n, const int32_t* n_ptr, const int32_t* F,
    const int32_t* cand, int capacity, const int32_t* n_set,
    const uint32_t* words, const uint32_t* blocks, int nsuper, int funnel,
    int4* table, int grid, cudaStream_t stream) {
  if (capacity <= 0 || w <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  survivor_table_kernel<<<grid, kThreads, 0, stream>>>(
      table_args(padded, total, w, lengths, cmax, num_contigs, n, n_ptr, F,
                 cand, capacity, n_set, words, blocks, nsuper, funnel,
                 table));
  return (int)cudaGetLastError();
}

// ``sbt_survivor_table`` into ``table``, then the walk of every lane of
// the list over it, both in ``grid`` CTAs of 256 threads. The walk is
// launched with programmatic stream serialization, so it may start before
// the table's grid has finished: its threads that read the table wait for
// that grid; all else it reads (and the ticket counter, zeroed or not) is
// complete before the table's launch. Each scalar is the value beside it
// or, where its pointer is not null, the int32 there. With ``res`` not
// null the walk writes the five per-lane outputs; otherwise it counts over
// [lo, own) into ``out`` (3 int64: count, escaped, survivors) through
// ``partials`` (2 int32 a CTA) and a ticket counter at ``status``, of one
// stream, whose tickets for this launch start at ``ticket_base`` (one
// ticket a CTA).
extern "C" int sbt_walk_lanes(
    const uint8_t* padded, int total, int w, const int32_t* lengths, int cmax,
    int num_contigs, int n, const int32_t* n_ptr, const int32_t* F,
    const int32_t* cand, int capacity, const int32_t* n_set,
    const uint32_t* words, const uint32_t* blocks, int nsuper, int funnel,
    int at_eof, const int32_t* ae_ptr, int4* table, int reads_to_check,
    int8_t* res, int32_t* fail_mask, int32_t* reads_before,
    int32_t* reads_parsed, uint8_t* exact, int lo, const int32_t* lo_ptr,
    int own, const int32_t* own_ptr, int32_t* status, unsigned ticket_base,
    int32_t* partials, long long* out, int grid, cudaStream_t stream) {
  if (capacity <= 0 || w <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
  LaneArgs a = table_args(padded, total, w, lengths, cmax, num_contigs, n,
                          n_ptr, F, cand, capacity, n_set, words, blocks,
                          nsuper, funnel, table);
  survivor_table_kernel<<<grid, kThreads, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  a.ae_val = at_eof;
  a.ae_ptr = ae_ptr;
  a.lo_val = lo;
  a.lo_ptr = lo_ptr;
  a.own_val = own;
  a.own_ptr = own_ptr;
  a.reads_to_check = reads_to_check;
  a.res = res;
  a.fail_mask = fail_mask;
  a.reads_before = reads_before;
  a.reads_parsed = reads_parsed;
  a.exact = exact;
  a.status = status;
  a.ticket_base = ticket_base;
  a.partials = partials;
  a.out = out;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, walk_lanes_kernel, a);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

#ifdef SBT_PROFILE
// The table warps' laps (3 a warp) and the survivors' and walk lanes' laps
// and steps (8 a row) of the last launches, for the first ``warps`` and
// ``lanes``.
extern "C" int sbt_lanes_profile(long long* tab, int warps, long long* walk,
                                 int lanes) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(tab, g_tab_marks,
                               3 * min(warps, kProfWarps) * sizeof(long long));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(
        walk, g_walk_marks,
        kLaneCols * min(lanes, kProfLanes) * sizeof(long long));
  return (int)err;
}
#endif
