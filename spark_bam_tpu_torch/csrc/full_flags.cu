// The full pass: all 19 flag bits at every byte offset of a window.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// full_check_flags (_full_flags_kernel). The plain version is
// spark_bam_tpu_torch/tpu/kernels.py::_compute_flags.
//
// What bounds it on the H100: bytes. It must read the W + PAD window bytes
// and write one int32 per offset: at the main path's W = 2^25 that is
// 168 MB, ~50 us at 3.35 TB/s. The work per offset is a few dozen integer
// operations plus O(1) shared-memory lookups.
//
// Why it is not the Pallas kernel's shape: the TPU kernel copies a 32 KiB
// tile plus a 257 KiB halo per grid step, so every cigar and name scan
// resolves inside one slab. That slab is above the 227 KB a Hopper CTA can
// hold. And a per-offset walk over the cigar would cost up to 65,535 steps
// at an offset: packed sequence bytes have low nibbles 1, 2, 4 and 8, all
// valid ops, so inside long reads the first bad op is often far away.
//
// Design, three launches:
// 1. first_bad_kernel: for each 1 KiB chunk of the buffer and each stride-4
//    class c, the first position j = c (mod 4) in the chunk holding a bad
//    cigar op (low nibble > 8, and the op's int inside n: j + 4 <= n). One
//    warp per chunk, a warp min-reduction per class.
// 2. suffix_min_kernel: one CTA turns those into "first bad op at or after
//    the chunk's start", a suffix-min over the chunks (the table).
// 3. full_flags_kernel: one CTA per 8 KiB tile of offsets holds the tile
//    plus 1 KiB of lookahead in shared memory (an offset's fixed block, name
//    and cigar start all lie within 291 bytes of it). Warp ballots pack two
//    bitmaps of that region: allowed read-name bytes, and bad ops per
//    stride-4 class. A word-level popcount prefix answers "allowed bytes
//    before q" and a word-level suffix "next nonzero word" answers "first
//    bad op at or after q in its class" inside the region; past the region
//    the table answers. So each offset decides invalidCigarOp by comparing
//    one position with cig_end, and nonASCIIReadName with two prefix counts.
//
// Every other bit is as in the prefilter (flag_bits.cuh). Quirks kept as
// in the reference: tooFewFixedBlockBytes overwrites the other bits, and
// emptyMappedCigar / emptyMappedSeq are swapped.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "flag_bits.cuh"

namespace {

constexpr int kTile = 8192;                 // offsets per CTA
constexpr int kLook = 1024;                 // lookahead bytes, >= 36 + 255
constexpr int kRegion = kTile + kLook;      // bytes a CTA holds
constexpr int kChunk = 1024;                // table granularity
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegionWords = kRegion / 4;   // 32-bit words of the region
constexpr int kNameWords = kRegion / 32;    // bitmap words, one bit a byte
constexpr int kClassWords = kRegion / 128;  // bitmap words per class
constexpr int32_t kNone = INT_MAX;
constexpr unsigned kAll = 0xFFFFFFFFu;

static_assert(kTile % kChunk == 0 && kLook % kChunk == 0,
              "the region must end on a table chunk");
static_assert(kNameWords % 32 == 0, "one warp scans the name bitmap");
static_assert(kClassWords <= 96, "one warp scans a class bitmap");

__device__ __forceinline__ bool bad_op(uint32_t byte, int j, int n) {
  return (byte & 0xFu) > 8u && j + 4 <= n;
}

__device__ __forceinline__ int4 min4(int4 a, int4 b) {
  return make_int4(min(a.x, b.x), min(a.y, b.y), min(a.z, b.z),
                   min(a.w, b.w));
}

__device__ __forceinline__ int4 shfl_down4(int4 v, int d) {
  return make_int4(__shfl_down_sync(kAll, v.x, d),
                   __shfl_down_sync(kAll, v.y, d),
                   __shfl_down_sync(kAll, v.z, d),
                   __shfl_down_sync(kAll, v.w, d));
}

// 1. One warp per chunk: the first bad op of each class in the chunk.
__global__ void first_bad_kernel(const uint32_t* __restrict__ words,
                                 int total_words, int chunks, int n,
                                 int4* __restrict__ first) {
  const int lane = threadIdx.x & 31;
  const int chunk = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (chunk >= chunks) return;
  int m[4] = {kNone, kNone, kNone, kNone};
  for (int r = 0; r < kChunk / 128; ++r) {
    const int wi = chunk * (kChunk / 4) + r * 32 + lane;
    if (wi >= total_words) break;
    const uint32_t v = __ldg(words + wi);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = 4 * wi + c;
      if (bad_op((v >> (8 * c)) & 0xFFu, j, n)) m[c] = min(m[c], j);
    }
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) m[c] = __reduce_min_sync(kAll, m[c]);
  if (lane == 0) first[chunk] = make_int4(m[0], m[1], m[2], m[3]);
}

// 2. One CTA: table[k] = min(first[k..chunks)), table[chunks] = none. Each
// thread takes a run of chunks; a block-wide suffix-min of the run minima
// gives each run the minimum of the runs after it.
__global__ void suffix_min_kernel(const int4* __restrict__ first, int chunks,
                                  int4* __restrict__ table) {
  __shared__ int4 warp_min[32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int4 none = make_int4(kNone, kNone, kNone, kNone);
  const int per = (chunks + blockDim.x - 1) / blockDim.x;
  const int lo = min(t * per, chunks), hi = min(lo + per, chunks);
  int4 run = none;
  for (int k = lo; k < hi; ++k) run = min4(run, first[k]);
  int4 incl = run;  // min over this thread's run and every later one in the warp
  for (int d = 1; d < 32; d <<= 1) {
    const int4 o = shfl_down4(incl, d);
    if (lane + d < 32) incl = min4(incl, o);
  }
  if (lane == 0) warp_min[warp] = incl;
  __syncthreads();
  int4 after = shfl_down4(incl, 1);
  if (lane == 31) after = none;
  for (int w2 = warp + 1; w2 < nwarps; ++w2) after = min4(after, warp_min[w2]);
  for (int k = hi - 1; k >= lo; --k) {
    after = min4(after, first[k]);
    table[k] = after;
  }
  if (t == 0) table[chunks] = none;
}

// 3. The flag pass over one tile of offsets.
__global__ void __launch_bounds__(kThreads)
full_flags_kernel(const uint32_t* __restrict__ words, int w, int total_words,
                  const int32_t* __restrict__ lengths, int cmax,
                  int num_contigs, int n, const int4* __restrict__ table,
                  int chunks, int32_t* __restrict__ out) {
  __shared__ uint32_t region[kRegionWords];
  __shared__ uint32_t name_bits[kNameWords];
  __shared__ int name_pre[kNameWords];
  __shared__ uint32_t cls_bits[4][kClassWords];
  __shared__ int cls_next[4][kClassWords + 1];
  __shared__ int beyond[4];

  const int base = blockIdx.x * kTile;
  const int base_w = base >> 2;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  for (int k = t; k < kRegionWords; k += kThreads) {
    const int wi = base_w + k;
    region[k] = wi < total_words ? __ldg(words + wi) : 0u;
  }
  if (t < 4) {
    const int4 e = table[min((base + kRegion) / kChunk, chunks)];
    beyond[t] = t == 0 ? e.x : t == 1 ? e.y : t == 2 ? e.z : e.w;
  }
  __syncthreads();
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(region);

  // Bitmaps by warp ballot: name_bits bit b of word m is byte 32m + b;
  // cls_bits[c] bit b of word k is byte 4(32k + b) + c.
  for (int m = warp; m < kNameWords; m += kWarps) {
    const uint32_t b = bytes[32 * m + lane];
    const unsigned bits = __ballot_sync(kAll, b >= 0x21u && b <= 0x7Eu &&
                                                  b != 0x40u);
    if (lane == 0) name_bits[m] = bits;
  }
  for (int k = warp; k < kClassWords; k += kWarps) {
    const uint32_t v = region[32 * k + lane];
    const int j = base + 4 * (32 * k + lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned bits =
          __ballot_sync(kAll, bad_op((v >> (8 * c)) & 0xFFu, j + c, n));
      if (lane == 0) cls_bits[c][k] = bits;
    }
  }
  __syncthreads();

  if (warp < 4) {
    // Class ``warp``: cls_next[c][k] = the first word >= k with a bad op.
    constexpr int per = (kClassWords + 31) / 32;
    const int c = warp;
    int loc[per];
    int run = kNone;
#pragma unroll
    for (int r = per - 1; r >= 0; --r) {
      const int k = per * lane + r;
      if (k < kClassWords && cls_bits[c][k]) run = k;
      loc[r] = run;
    }
    int incl = run;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_down_sync(kAll, incl, d);
      if (lane + d < 32) incl = min(incl, o);
    }
    int after = __shfl_down_sync(kAll, incl, 1);
    if (lane == 31) after = kNone;
#pragma unroll
    for (int r = 0; r < per; ++r) {
      const int k = per * lane + r;
      if (k < kClassWords) cls_next[c][k] = min(loc[r], after);
    }
    if (lane == 0) cls_next[c][kClassWords] = kNone;
  } else if (warp == 4) {
    // name_pre[m] = allowed bytes in words before m.
    constexpr int per = kNameWords / 32;
    int cnt[per];
    int sum = 0;
#pragma unroll
    for (int r = 0; r < per; ++r) {
      cnt[r] = __popc(name_bits[per * lane + r]);
      sum += cnt[r];
    }
    int incl = sum;
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(kAll, incl, d);
      if (lane >= d) incl += o;
    }
    int acc = incl - sum;
#pragma unroll
    for (int r = 0; r < per; ++r) {
      name_pre[per * lane + r] = acc;
      acc += cnt[r];
    }
  }
  __syncthreads();

  for (int rel = t; rel < kTile; rel += kThreads) {
    const int i = base + rel;
    if (i >= w) break;
    uint32_t v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = region[(rel >> 2) + k];
    const sbt::FixedBlock b = sbt::fixed_block(v, 8u * (uint32_t)(rel & 3));
    int32_t f = sbt::fixed_bits(b, lengths, cmax, num_contigs);

    // Read name: bytes [rel + 36, rel + 36 + name_len) of the region.
    const int name_len = (int)b.name_len;
    const bool has_name = name_len >= 2;
    const bool name_eof = has_name && i + 36 + name_len > n;
    if (name_eof) f |= sbt::kTooFewBytesForReadName;
    const bool name_in = has_name && !name_eof;
    const int last = rel + 36 + name_len - 1;
    const bool non_null = name_in && bytes[last] != 0;
    if (non_null) f |= sbt::kNonNullTerminatedReadName;
    if (name_in && !non_null) {
      const int q0 = rel + 36;
      const int good =
          name_pre[last >> 5] +
          __popc(name_bits[last >> 5] & ((1u << (last & 31)) - 1u)) -
          name_pre[q0 >> 5] -
          __popc(name_bits[q0 >> 5] & ((1u << (q0 & 31)) - 1u));
      if (good != name_len - 1) f |= sbt::kNonASCIIReadName;
    }

    // Cigar: the first bad op at or after cig_start in its class, against
    // cig_end.
    const int cs = rel + 36 + (name_in ? name_len : 0);
    const int cig_end = base + cs + 4 * (int)b.n_cigar;
    const bool considered = !name_eof;
    bool has_bad = false;
    if (considered) {
      const int c = cs & 3, bit = cs >> 2, kw = bit >> 5;
      const uint32_t here = cls_bits[c][kw] & (kAll << (bit & 31));
      int first;
      if (here) {
        first = base + 4 * (32 * kw + __ffs(here) - 1) + c;
      } else {
        const int k2 = cls_next[c][kw + 1];
        first = k2 == kNone
                    ? beyond[c]
                    : base + 4 * (32 * k2 + __ffs(cls_bits[c][k2]) - 1) + c;
      }
      has_bad = first < cig_end;
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
    if (i > n - 36) f = sbt::kTooFewFixedBlockBytes;
    out[i] = f;
  }
}

}  // namespace

// ``padded`` holds ``total`` bytes (a multiple of 4): the window's ``w``
// offsets and the padding past them. ``scratch`` holds 2 * chunks + 1
// int4, chunks = ceil(total / 1024): the per-chunk firsts, then the table
// (its last row is "none").
extern "C" int sbt_full_flags(const uint8_t* padded, int total, int w,
                              const int32_t* lengths, int cmax,
                              int num_contigs, int n, int32_t* scratch,
                              int32_t* out, cudaStream_t stream) {
  if (w <= 0) return (int)cudaGetLastError();
  const int total_words = total / 4;
  const int chunks = (total + kChunk - 1) / kChunk;
  const uint32_t* words = reinterpret_cast<const uint32_t*>(padded);
  int4* first = reinterpret_cast<int4*>(scratch);
  int4* table = first + chunks;
  first_bad_kernel<<<(chunks + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
      words, total_words, chunks, n, first);
  int err = (int)cudaGetLastError();
  if (err) return err;
  suffix_min_kernel<<<1, 1024, 0, stream>>>(first, chunks, table);
  err = (int)cudaGetLastError();
  if (err) return err;
  full_flags_kernel<<<(w + kTile - 1) / kTile, kThreads, 0, stream>>>(
      words, w, total_words, lengths, cmax, num_contigs, n, table, chunks,
      out);
  return (int)cudaGetLastError();
}
