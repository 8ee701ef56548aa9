// The funnel's stage 1: the deep flags at the stage-0 survivors, the chain
// walk of each survivor lane, and the owned-span count. Two kernels.
//
// Replaces the jnp / lax.scan device program of spark_bam_tpu/tpu/
// checker.py: _funnel_tables with _allowed_before / _badops_before
// (:281-319), _deep_flags_at (:322-411), _misc_at (:184) and the walk of
// _check_lanes (:538-623), and the funnel branch of count_window
// (:741-760). The plain versions are spark_bam_tpu_torch/tpu/kernels.py::
// _bad_op_tables and _walk_lanes / _count_lanes (the reference's PyTorch
// form, which the CPU route runs).
//
// 1. bad_op_tables_kernel, one pass over the W + PAD window bytes: a bit
//    per byte for "bad cigar op" (low nibble > 8, the op's int inside n),
//    packed into 32-bit words (the reference's cwords, bit for bit), and
//    per stride-4 class c a summary bit per 1,024-byte block: "a bad op of
//    class c lies in this block". A warp takes 32 blocks (32 KiB) and
//    writes one summary word per class, so no CTA depends on another and
//    nothing needs clearing. Bound by bytes: it reads W + PAD bytes and
//    writes an eighth of that, ~0.011 ms at W = 2^25 and 3.35 TB/s.
// 2. walk_lanes_kernel, one thread a survivor lane (the prefilter's
//    compacted list): the lane walks reads_to_check chained records. At
//    each position it reads the stage-0 flags F; where they are 0 it
//    computes the full 19-bit mask on the spot (fixed block by funnel
//    shifts, flag_bits.cuh; the read name by a scan of its <= 254 bytes;
//    "any bad op of class cig_start & 3 in [cig_start, cig_end)" from the
//    tables: the two end words, at most 62 whole words beside them, and
//    the class summary words between, at most 10, whatever n_cigar is).
//    A survivor past the capacity (the list overflowed) has no deep mask
//    in the reference's scatter and walks as mask 0, so here too. With
//    per-lane outputs it writes res, fail_mask, reads_before,
//    reads_parsed and exact (check_window); in count mode it reduces
//    instead: each CTA counts its owned lanes with res == 1 and == 2 and
//    a grid-stride share of the owned offsets whose stage-0 verdict is an
//    escape, writes them to a partials buffer, and the last CTA to take a
//    ticket (kept per stream, kernels.TileStatus) sums them into
//    (count, esc_count, survivors), or (0, owned offsets, survivors) on a
//    capacity overflow. What bounds it is the serial chain of dependent
//    loads of each lane (ten steps of fixed block, name and cigar reads);
//    its bytes, F read once (4 W) and the lanes' records, are ~0.05 ms.
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

constexpr int kThreads = 256;
constexpr int kTableThreads = 128;
constexpr int kBlockWords = 32;            // bitmap words a summary bit covers
constexpr int kSuperWords = 32 * kBlockWords;  // words a summary word covers
constexpr uint32_t kClass = 0x11111111u;   // the bits of class 0 in a word
constexpr unsigned kAll = 0xFFFFFFFFu;
constexpr int32_t kEscape = sbt::kTooFewFixedBlockBytes |
                            sbt::kTooFewBytesForReadName |
                            sbt::kTooFewBytesForCigarOps;
constexpr int32_t kDefinitive = ((1 << 19) - 1) & ~kEscape;

__global__ void __launch_bounds__(kTableThreads)
bad_op_tables_kernel(const uint8_t* __restrict__ padded, int total,
                     int n_val, const int32_t* __restrict__ n_ptr,
                     uint32_t* __restrict__ words, int nwords,
                     uint32_t* __restrict__ blocks, int nsuper) {
  const int lane = threadIdx.x & 31;
  const int sb = (blockIdx.x * kTableThreads + threadIdx.x) >> 5;
  if (sb >= nsuper) return;  // the whole warp
  const long long n = n_ptr ? __ldg(n_ptr) : n_val;
  uint32_t acc = 0;  // lane c < 4: class c's summary word
  for (int it = 0; it < 32; ++it) {
    const int wi = sb * kSuperWords + it * kBlockWords + lane;
    const long long j0 = 32LL * wi;
    uint32_t bits = 0;
    if (j0 + 32 <= total) {
      const uint4* q = reinterpret_cast<const uint4*>(padded + j0);
      const uint4 a = __ldg(q), b = __ldg(q + 1);
      const uint32_t v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        // Bit 4 of each byte: its low nibble is at least 9.
        const uint32_t hi = ((v[k] & 0x0F0F0F0Fu) + 0x07070707u) & 0x10101010u;
        bits |= ((hi >> 4) & 1u) << (4 * k);
        bits |= ((hi >> 12) & 1u) << (4 * k + 1);
        bits |= ((hi >> 20) & 1u) << (4 * k + 2);
        bits |= ((hi >> 28) & 1u) << (4 * k + 3);
      }
    } else {
      for (int k = 0; k < 32; ++k)
        if (j0 + k < total && (padded[j0 + k] & 0xFu) > 8u) bits |= 1u << k;
    }
    // Only ops whose 4-byte int ends inside n: j + 4 <= n.
    const long long lim = n - 4 - j0;  // the last bit that may stay
    if (lim < 0)
      bits = 0;
    else if (lim < 31)
      bits &= (2u << lim) - 1u;
    if (wi < nwords) words[wi] = bits;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned any = __ballot_sync(kAll, (bits & (kClass << c)) != 0);
      if (lane == c && any) acc |= 1u << it;
    }
  }
  if (lane < 4) blocks[lane * nsuper + sb] = acc;
}

// Any bad op of class c (offsets j = c mod 4) in [a, b), 0 <= a <= b.
__device__ bool any_bad(const uint32_t* __restrict__ words,
                        const uint32_t* __restrict__ blocks, int nsuper,
                        int a, int b, int c) {
  if (a >= b) return false;
  const uint32_t cm = kClass << c;
  const int wa = a >> 5, wb = (b - 1) >> 5;
  const uint32_t lo_mask = kAll << (a & 31);
  const uint32_t hi_mask = kAll >> (31 - ((b - 1) & 31));
  if (wa == wb) return (__ldg(words + wa) & cm & lo_mask & hi_mask) != 0;
  if (__ldg(words + wa) & cm & lo_mask) return true;
  if (__ldg(words + wb) & cm & hi_mask) return true;
  // Whole words [w0, w1), and whole blocks [b0, b1) among them.
  const int w0 = wa + 1, w1 = wb;
  const int b0 = (w0 + kBlockWords - 1) / kBlockWords, b1 = w1 / kBlockWords;
  if (b0 >= b1) {
    for (int k = w0; k < w1; ++k)
      if (__ldg(words + k) & cm) return true;
    return false;
  }
  for (int k = w0; k < b0 * kBlockWords; ++k)
    if (__ldg(words + k) & cm) return true;
  for (int k = b1 * kBlockWords; k < w1; ++k)
    if (__ldg(words + k) & cm) return true;
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

struct WalkArgs {
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

// The 36-byte fixed block at byte offset q (q + 36 <= total): nine aligned
// words from the one that holds byte q.
__device__ __forceinline__ sbt::FixedBlock block_at(const uint8_t* padded,
                                                    int q) {
  const uint32_t* src = reinterpret_cast<const uint32_t*>(padded) + (q >> 2);
  uint32_t v[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) v[k] = __ldg(src + k);
  return sbt::fixed_block(v, 8u * (q & 3));
}

__device__ __forceinline__ bool name_byte_ok(uint32_t b) {
  return b >= 0x21u && b <= 0x7Eu && b != 0x40u;
}

// The full 19-bit mask at ``pos`` (0 <= pos < w) as the reference's
// _deep_flags_at computes it, quirks included.
__device__ int32_t deep_flags(const WalkArgs& a, int pos, int n) {
  const uint8_t* p = a.padded;
  const int total = a.total;
  const int pc = min(max(pos, 0), total - 36);  // the slab's clamp
  const sbt::FixedBlock b = block_at(p, pc);
  int32_t f = sbt::fixed_bits(b, a.lengths, a.cmax, a.num_contigs);

  const int name_len = (int)b.name_len;
  const int name_start = pos + 36;
  const int name_end = name_start + name_len;
  const bool has_name = name_len >= 2;
  const bool name_eof = has_name && name_end > n;
  if (name_eof) f |= sbt::kTooFewBytesForReadName;
  const bool name_in = has_name && !name_eof;
  const int last = min(max(name_end - 1, 0), total - 1);
  const bool non_null = name_in && __ldg(p + last) != 0;
  if (non_null) f |= sbt::kNonNullTerminatedReadName;
  if (name_in && !non_null) {
    // Allowed bytes in [name_start, last) against name_len - 1: every one.
    const int q0 = min(max(name_start, 0), total - 1);
    bool good = true;
    for (int q = q0; q < last && good; ++q) good = name_byte_ok(__ldg(p + q));
    if (!good || last - q0 != name_len - 1) f |= sbt::kNonASCIIReadName;
  }

  const int cig_start = name_start + (name_in ? name_len : 0);
  const int cig_end = cig_start + 4 * (int)b.n_cigar;
  const bool considered = !name_eof;
  bool has_bad = false;
  if (considered) {
    const int qa = min(max(cig_start, 0), total - 1);
    const int qb = min(max(cig_end, 0), total - 1);
    has_bad = any_bad(a.words, a.blocks, a.nsuper, qa, qb, cig_start & 3);
  }
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
  return f;
}

__device__ __forceinline__ long long clamp64(long long x, long long lo,
                                             long long hi) {
  return x < lo ? lo : (x > hi ? hi : x);
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

__global__ void __launch_bounds__(kThreads) walk_lanes_kernel(WalkArgs a) {
  __shared__ int scratch[kThreads / 32];
  __shared__ bool last_cta;
  const int n = a.n_ptr ? __ldg(a.n_ptr) : a.n_val;
  const bool ae = (a.ae_ptr ? __ldg(a.ae_ptr) : a.ae_val) != 0;
  const int n_set = __ldg(a.n_set);
  const bool overflow = n_set > a.capacity;
  // A survivor past the list's last entry has no deep mask (mask 0).
  const int last_cand = overflow ? __ldg(a.cand + a.capacity - 1) : INT_MAX;
  const int w = a.w;
  const long long bound = (long long)n + 64;
  const int k = blockIdx.x * kThreads + threadIdx.x;

  int cand = -1;
  int r = -1, rb = 0, rp = 0;
  int32_t fm = 0;
  bool ex = true;
  if (k < a.capacity) cand = __ldg(a.cand + k);
  if (cand >= 0) {
    long long logical = cand, physical = cand;
    bool lov = false;
    r = 0;
    for (int step = 0; step < a.reads_to_check; ++step) {
      // EOF at a record edge (zero bytes left): eager/Checker.scala:36-39.
      if (physical >= n) {
        const bool edge = physical == logical && !lov && step > 0;
        const bool maybe_edge = lov && step > 0;
        if (ae && edge) {
          r = 1;
          rp = step;
        } else if (ae && !maybe_edge) {
          r = -1;
          fm = sbt::kTooFewFixedBlockBytes;
          rb = step;
        } else {
          r = 2;
        }
        break;
      }
      const int pi = (int)clamp64(physical, 0, w - 1);
      int32_t f = __ldg(a.F + pi);
      if (a.funnel && f == 0) f = pi <= last_cand ? deep_flags(a, pi, n) : 0;
      if (f != 0) {
        // Every bit is definitive or an escape bit.
        const int32_t definitive = f & kDefinitive, boundary = f & kEscape;
        if (definitive != 0 || (ae && boundary != 0)) {
          r = -1;
          fm = f;
          rb = step;
          if (!ae && definitive != 0 && boundary != 0) ex = false;
        } else {
          r = 2;
        }
        break;
      }
      // Step to the next record (the reference's _misc_at at pi).
      const sbt::FixedBlock b = block_at(a.padded, pi);
      const long long rem = b.remaining;
      const int name_len = (int)b.name_len;
      const bool has_name = name_len >= 2;
      const bool name_eof = has_name && pi + 36 + name_len > n;
      const bool name_in = has_name && !name_eof;
      const long long cig_start = pi + 36 + (name_in ? name_len : 0);
      const long long b_end =
          pi > n - 36 ? pi + 36
                      : cig_start + (name_eof ? 0 : 4LL * (int)b.n_cigar);
      // Out-of-range logical cursors collapse to sentinels +-(n + 64); a
      // lane whose cursor would need to re-enter range is flagged.
      const long long rem_c = clamp64(rem, -bound, bound);
      const long long next_logical = logical + 4 + rem_c;
      const long long clamped = clamp64(next_logical, -bound, bound);
      const bool overflow_now =
          rem > bound || rem < -bound || next_logical != clamped;
      const long long next_physical =
          min(b_end > clamped ? b_end : clamped, (long long)n);
      logical = clamped;
      physical = next_physical;
      lov = lov || overflow_now;
    }
    if (r == 0) {
      r = 1;
      rp = a.reads_to_check;
    }
  }

  if (a.res != nullptr) {
    if (k < a.capacity) {
      a.res[k] = (int8_t)r;
      a.fail_mask[k] = fm;
      a.reads_before[k] = rb;
      a.reads_parsed[k] = rp;
      a.exact[k] = ex ? 1 : 0;
    }
    return;
  }

  // Count mode: the owned lanes' verdicts, and a share of the owned
  // offsets whose stage-0 verdict is an escape.
  const int lo = a.lo_ptr ? __ldg(a.lo_ptr) : a.lo_val;
  const int own = a.own_ptr ? __ldg(a.own_ptr) : a.own_val;
  const bool owned = cand >= 0 && cand >= lo && cand < own;
  const int cnt = __syncthreads_count(owned && r == 1);
  int esc = __syncthreads_count(owned && r == 2);
  const int i0 = max(lo, 0), i1 = min(own, w);
  int esc0 = 0;
  if (!ae) {
    for (long long i = i0 + (long long)blockIdx.x * kThreads + threadIdx.x;
         i < i1; i += (long long)gridDim.x * kThreads) {
      const int32_t f = __ldg(a.F + i);
      esc0 += (f & kDefinitive) == 0 && (f & kEscape) != 0;
    }
  }
  esc += block_sum(esc0, scratch);
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
  const int warps = kTableThreads / 32;
  bad_op_tables_kernel<<<(nsuper + warps - 1) / warps, kTableThreads, 0,
                         stream>>>(padded, total, n, n_ptr, words, nwords,
                                   blocks, nsuper);
  return (int)cudaGetLastError();
}

// One thread per lane of the ``capacity``-long survivor list ``cand``
// (-1 past the population; ``n_set`` the exact survivor count in device
// memory). ``F`` holds the stage-0 flags (``funnel`` 1: the prefilter's,
// with the deep mask computed where they are 0 from the bad-op tables) or
// the full pass's (``funnel`` 0: looked up as they are). Each scalar is
// the value beside it or, where its pointer is not null, the int32 there.
// With ``res`` not null the launch writes the five per-lane outputs;
// otherwise it counts over [lo, own) into ``out`` (3 int64: count,
// escaped, survivors) through ``partials`` (2 int32 a CTA) and a ticket
// counter at ``status``, of one stream, whose tickets for this launch
// start at ``ticket_base`` (one ticket a CTA, ceil(capacity / 256) CTAs).
extern "C" int sbt_walk_lanes(
    const uint8_t* padded, int total, int w, const int32_t* lengths, int cmax,
    int num_contigs, int n, const int32_t* n_ptr, int at_eof,
    const int32_t* ae_ptr, const int32_t* F, const int32_t* cand,
    int capacity, const int32_t* n_set, const uint32_t* words,
    const uint32_t* blocks, int nsuper, int reads_to_check, int funnel,
    int8_t* res, int32_t* fail_mask, int32_t* reads_before,
    int32_t* reads_parsed, uint8_t* exact, int lo, const int32_t* lo_ptr,
    int own, const int32_t* own_ptr, int32_t* status, unsigned ticket_base,
    int32_t* partials, long long* out, cudaStream_t stream) {
  if (capacity <= 0 || w <= 0) return (int)cudaErrorInvalidValue;
  WalkArgs a;
  a.padded = padded;
  a.total = total;
  a.w = w;
  a.lengths = lengths;
  a.cmax = cmax;
  a.num_contigs = num_contigs;
  a.n_val = n;
  a.ae_val = at_eof;
  a.lo_val = lo;
  a.own_val = own;
  a.n_ptr = n_ptr;
  a.ae_ptr = ae_ptr;
  a.lo_ptr = lo_ptr;
  a.own_ptr = own_ptr;
  a.F = F;
  a.cand = cand;
  a.capacity = capacity;
  a.n_set = n_set;
  a.words = words;
  a.blocks = blocks;
  a.nsuper = nsuper;
  a.reads_to_check = reads_to_check;
  a.funnel = funnel;
  a.res = res;
  a.fail_mask = fail_mask;
  a.reads_before = reads_before;
  a.reads_parsed = reads_parsed;
  a.exact = exact;
  a.status = status;
  a.ticket_base = ticket_base;
  a.partials = partials;
  a.out = out;
  walk_lanes_kernel<<<(capacity + kThreads - 1) / kThreads, kThreads, 0,
                      stream>>>(a);
  return (int)cudaGetLastError();
}
