// The full pass: all 19 flag bits at every byte offset of a window.
//
// Replaces the Pallas kernel spark_bam_tpu/tpu/pallas_kernels.py::
// full_check_flags (_full_flags_kernel). The plain version is
// spark_bam_tpu_torch/tpu/kernels.py::_compute_flags.
//
// What bounds it on the H100: bytes. It must read the W + PAD window bytes
// and write one int32 per offset: at the main path's W = 2^25 that is
// 168 MB, ~50 us at 3.35 TB/s. The work per offset is a few dozen integer
// operations plus O(1) shared-memory lookups, ~0.1 ms of issue at W = 2^25.
//
// Why it is not the Pallas kernel's shape: the TPU kernel copies a 32 KiB
// tile plus a 257 KiB halo per grid step, so every cigar and name scan
// resolves inside one slab. That slab is above the 227 KB a Hopper CTA can
// hold. And a per-offset walk over the cigar would cost up to 65,535 steps
// at an offset: packed sequence bytes have low nibbles 1, 2, 4 and 8, all
// valid ops, so inside long reads the first bad op is often far away.
//
// Design, one launch. A CTA takes a 16 KiB tile of the buffer (tiles cover
// all W + PAD bytes; those past W only scan) and holds it plus 512 bytes
// of lookahead in shared memory (an offset's fixed block, name and cigar
// start all lie within 291 bytes of it), loaded by one bulk async copy.
// 1. Warp ballots pack two bitmaps of that region: allowed read-name
//    bytes, and bad cigar ops (low nibble > 8, the op's int inside n) per
//    stride-4 class. A word-level popcount prefix answers "allowed bytes
//    before q"; a word-level suffix "next nonzero word" answers "first bad
//    op at or after q in its class" inside the region.
// 2. Past the region, "first bad op of class c at or after the region's
//    end" comes from the tiles after this one, through status records in
//    device memory: each tile publishes, per class, its first bad op in
//    the whole tile and in the part past a predecessor's lookahead, as
//    soon as its class bitmaps stand. A cigar ends within 36 + 255 +
//    4 * 65535 bytes of its offset, so only the next 17 tiles can hold a
//    bad op that matters: one warp reads their records at once (a bad op
//    beyond them, or none, answers every comparison the same way). Tiles
//    take their index from an atomic ticket in reverse order, so the tiles
//    a tile waits for always started first, and no tile waits for anything
//    before publishing: the wait cannot deadlock. Each status word holds
//    the launch's epoch, so the records, kept per stream between launches
//    (the wrapper), need no clearing.
// 3. Each thread takes 4 consecutive offsets at a time: their fixed blocks
//    come from the same nine shared-memory words, and one 16-byte store
//    writes their flags. Each offset decides invalidCigarOp by comparing
//    one position with its cigar's end, and nonASCIIReadName with two
//    prefix counts.
//
// Every other bit is as in the prefilter (flag_bits.cuh). Quirks kept as
// in the reference: tooFewFixedBlockBytes overwrites the other bits, and
// emptyMappedCigar / emptyMappedSeq are swapped.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "flag_bits.cuh"
#include "per_device.cuh"

namespace {

constexpr int kTile = 16384;                // offsets and scanned bytes per CTA
constexpr int kLook = 512;                  // lookahead bytes, >= 3 + 36 + 255
constexpr int kRegion = kTile + kLook;      // bytes a CTA holds
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRegionWords = kRegion / 4;   // 32-bit words of the region
constexpr int kNameWords = kRegion / 32;    // bitmap words, one bit a byte
constexpr int kClassWords = kRegion / 128;  // bitmap words per class
constexpr int kTileClassWords = kTile / 128;
constexpr int kRecord = 16;                 // int32 per tile status record
// The farthest a cigar reaches past its offset (fixed block, name, 65,535
// ops), and so the tiles after this one that can matter.
constexpr int kCigarReach = 36 + 255 + 4 * 65535;
constexpr int kReach = (kTile - 1 + kCigarReach - 1) / kTile;
constexpr int32_t kNone = INT_MAX;
constexpr unsigned kAll = 0xFFFFFFFFu;

static_assert(kLook % 128 == 0 && kRegion % 16 == 0, "bitmap words, copy");
static_assert(kReach < 32, "one warp reads the records it needs");

// profile launches: full pass
// profile phases: load, bitmaps and look-forward, flags
#ifdef SBT_PROFILE
// Profiling build only (benchmarks/profile_resolve_flags.py): CUDA events
// around the launch, and per-tile clock64 marks at the phases' edges.
__device__ long long g_ff_marks[4 * 8192];
cudaEvent_t g_ff_events[2];
#define SBT_MARK(k)                                                    \
  do {                                                                 \
    __syncthreads();                                                   \
    if (t == 0 && tile < 8192) g_ff_marks[4 * tile + (k)] = clock64(); \
  } while (0)
#define SBT_EVENT(k, stream)                                           \
  do {                                                                 \
    if (!g_ff_events[k]) cudaEventCreate(&g_ff_events[k]);             \
    cudaEventRecord(g_ff_events[k], stream);                           \
  } while (0)
#else
#define SBT_MARK(k)
#define SBT_EVENT(k, stream)
#endif

__device__ __forceinline__ bool bad_op(uint32_t byte, int j, int n) {
  return (byte & 0xFu) > 8u && j + 4 <= n;
}

__device__ __forceinline__ int4 warp_min4(int4 v) {
  return make_int4(__reduce_min_sync(kAll, v.x), __reduce_min_sync(kAll, v.y),
                   __reduce_min_sync(kAll, v.z), __reduce_min_sync(kAll, v.w));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ uint32_t load_acquire(const int32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_release(int32_t* p, uint32_t v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

struct Bitmaps {
  uint32_t name_bits[kNameWords];    // bit b of word m: byte 32m + b allowed
  int name_pre[kNameWords];          // allowed bytes in words before m
  uint32_t cls[4][kClassWords];      // bit b of word k: byte 4(32k + b) + c
  int cls_next[4][kClassWords + 1];  // first word >= k with a bad op
};

// The first bad op of class c at or after class word ``from`` inside the
// tile's own bytes (not its lookahead), or kNone.
__device__ __forceinline__ int first_in_tile(const Bitmaps& s, int c,
                                             int from, int base) {
  const int k = s.cls_next[c][from];
  return k < kTileClassWords
             ? base + 4 * (32 * k + __ffs(s.cls[c][k]) - 1) + c
             : kNone;
}

// The 19 bits at the tile's offset ``rel0 + R``, whose fixed block starts
// R bytes into the word ``v[0]``.
template <int R>
__device__ __forceinline__ int32_t flags_at(
    const uint32_t v[9], int rel0, int base, const uint8_t* bytes,
    const Bitmaps& s, const int* beyond, const int32_t* __restrict__ lengths,
    int cmax, int num_contigs, int n) {
  const int rel = rel0 + R;
  const int i = base + rel;
  const sbt::FixedBlock b = sbt::fixed_block(v, 8u * R);
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
        s.name_pre[last >> 5] +
        __popc(s.name_bits[last >> 5] & ((1u << (last & 31)) - 1u)) -
        s.name_pre[q0 >> 5] -
        __popc(s.name_bits[q0 >> 5] & ((1u << (q0 & 31)) - 1u));
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
    const uint32_t here = s.cls[c][kw] & (kAll << (bit & 31));
    int first;
    if (here) {
      first = base + 4 * (32 * kw + __ffs(here) - 1) + c;
    } else {
      const int k2 = s.cls_next[c][kw + 1];
      first = k2 == kNone
                  ? beyond[c]
                  : base + 4 * (32 * k2 + __ffs(s.cls[c][k2]) - 1) + c;
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
  return f;
}

__global__ void __launch_bounds__(kThreads)
full_flags_kernel(const uint8_t* __restrict__ padded, int total, int w,
                  const int32_t* __restrict__ lengths, int cmax,
                  int num_contigs, int n_val,
                  const int32_t* __restrict__ n_ptr, int32_t* status,
                  uint32_t ticket_base, uint32_t epoch, int tiles,
                  int32_t* __restrict__ out) {
  __shared__ __align__(128) uint32_t region[kRegionWords];
  __shared__ Bitmaps s;
  __shared__ int beyond[4];
  __shared__ int tile_s;
  __shared__ __align__(8) uint64_t bar_s;

  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int n = n_ptr ? __ldg(n_ptr) : n_val;
  const uint32_t bar = smem_addr(&bar_s);
  if (t == 0) {
    const uint32_t ticket = atomicAdd(reinterpret_cast<uint32_t*>(status), 1u);
    tile_s = tiles - 1 - (int)(ticket - ticket_base);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int tile = tile_s;
  const int base = tile * kTile;
  SBT_MARK(0);

  // The region: one bulk copy of its whole 16-byte units inside the
  // buffer; the few bytes after them, then zeros, by plain loads.
  const int avail = min(kRegion, total - base);
  const int bulk = avail & ~15;
  if (t == 0) {
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
        "r"(bulk)
        : "memory");
    if (bulk > 0)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(region)),
          "l"(padded + base), "r"(bulk), "r"(bar)
          : "memory");
  }
  const uint32_t* words = reinterpret_cast<const uint32_t*>(padded + base);
  for (int k = bulk / 4 + t; k < kRegionWords; k += kThreads)
    region[k] = 4 * k < avail ? __ldg(words + k) : 0u;
  mbar_wait(bar, 0);
  __syncthreads();
  SBT_MARK(1);
  const uint8_t* bytes = reinterpret_cast<const uint8_t*>(region);

  // 1. Bitmaps by warp ballot, then their scans; the class bitmaps first,
  // so that this tile's record goes out as early as it can.
  for (int k = warp; k < kClassWords; k += kWarps) {
    const uint32_t v = region[32 * k + lane];
    const int j = base + 4 * (32 * k + lane);
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const unsigned bits =
          __ballot_sync(kAll, bad_op((v >> (8 * c)) & 0xFFu, j + c, n));
      if (lane == 0) s.cls[c][k] = bits;
    }
  }
  __syncthreads();

  int32_t* rec = status + kRecord * (1 + tile);
  if (warp < 4) {
    // Class ``warp``: cls_next[c][k] = the first word >= k with a bad op.
    constexpr int per = (kClassWords + 31) / 32;
    const int c = warp;
    int loc[per];
    int run = kNone;
#pragma unroll
    for (int r = per - 1; r >= 0; --r) {
      const int k = per * lane + r;
      if (k < kClassWords && s.cls[c][k]) run = k;
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
      if (k < kClassWords) s.cls_next[c][k] = min(loc[r], after);
    }
    if (lane == 0) s.cls_next[c][kClassWords] = kNone;
    asm volatile("bar.sync 1, 128;\n" ::: "memory");  // warps 0-3 only
    if (t == 0) {
      // This tile's record: the first bad op per class in the whole tile,
      // and in its part past a predecessor's lookahead.
      constexpr int kPast = kLook / 128;
      *reinterpret_cast<int4*>(rec + 4) = make_int4(
          first_in_tile(s, 0, 0, base), first_in_tile(s, 1, 0, base),
          first_in_tile(s, 2, 0, base), first_in_tile(s, 3, 0, base));
      *reinterpret_cast<int4*>(rec + 8) = make_int4(
          first_in_tile(s, 0, kPast, base), first_in_tile(s, 1, kPast, base),
          first_in_tile(s, 2, kPast, base), first_in_tile(s, 3, kPast, base));
      store_release(rec, epoch);
    }
  } else {
#pragma unroll 4
    for (int m = warp - 4; m < kNameWords; m += kWarps - 4) {
      const uint32_t b = bytes[32 * m + lane];
      const unsigned bits =
          __ballot_sync(kAll, b >= 0x21u && b <= 0x7Eu && b != 0x40u);
      if (lane == 0) s.name_bits[m] = bits;
    }
  }
  __syncthreads();

  if (warp == 0) {
    // 2. ``beyond``: the next tile's part past this tile's lookahead, and
    // the whole of the kReach - 1 tiles after it, one record a lane.
    const int j = tile + 1 + lane;
    int4 val = make_int4(kNone, kNone, kNone, kNone);
    if (lane < kReach && j < tiles) {
      const int32_t* jrec = rec + kRecord * (1 + lane);
      while (load_acquire(jrec) != epoch) {
      }
      val = __ldcg(reinterpret_cast<const int4*>(jrec + (lane ? 4 : 8)));
    }
    const int4 bey = warp_min4(val);
    if (lane < 4)
      beyond[lane] = lane == 0 ? bey.x : lane == 1 ? bey.y
                   : lane == 2 ? bey.z : bey.w;
  } else if (warp == 4) {
    // name_pre[m] = allowed bytes in words before m.
    constexpr int per = (kNameWords + 31) / 32;
    int cnt[per];
    int sum = 0;
#pragma unroll
    for (int r = 0; r < per; ++r) {
      const int m = per * lane + r;
      cnt[r] = m < kNameWords ? __popc(s.name_bits[m]) : 0;
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
      const int m = per * lane + r;
      if (m < kNameWords) s.name_pre[m] = acc;
      acc += cnt[r];
    }
  }
  __syncthreads();
  SBT_MARK(2);

  // 3. Four consecutive offsets a thread, one 16-byte store.
  for (int g = t; g < kTile / 4; g += kThreads) {
    const int rel0 = 4 * g;
    if (base + rel0 >= w) break;
    uint32_t v[9];
#pragma unroll
    for (int k = 0; k < 9; ++k) v[k] = region[g + k];
    const int4 f = make_int4(
        flags_at<0>(v, rel0, base, bytes, s, beyond, lengths, cmax,
                    num_contigs, n),
        flags_at<1>(v, rel0, base, bytes, s, beyond, lengths, cmax,
                    num_contigs, n),
        flags_at<2>(v, rel0, base, bytes, s, beyond, lengths, cmax,
                    num_contigs, n),
        flags_at<3>(v, rel0, base, bytes, s, beyond, lengths, cmax,
                    num_contigs, n));
    *reinterpret_cast<int4*>(out + base + rel0) = f;
  }
  SBT_MARK(3);
}

}  // namespace

// ``padded`` holds ``total`` bytes (a multiple of 4, starting on a 16-byte
// boundary): the window's ``w`` offsets (a multiple of 4) and the padding
// past them. The valid byte count is ``n`` or, when ``n_ptr`` is not
// null, the int32 it points to in device memory (a launch captured in a
// CUDA graph then reads each replay's value). ``status`` holds
// 16 * (1 + ceil(total / 16384)) int32: the
// ticket counter, then one record per tile. It belongs to one stream; this
// launch's tickets start at ``ticket_base`` and its records carry
// ``epoch`` (non-zero), larger than any epoch already there.
extern "C" int sbt_full_flags(const uint8_t* padded, int total, int w,
                              const int32_t* lengths, int cmax,
                              int num_contigs, int n, const int32_t* n_ptr,
                              int32_t* status, unsigned ticket_base,
                              unsigned epoch, int32_t* out,
                              cudaStream_t stream) {
  if (w <= 0) return (int)cudaGetLastError();
  // Once per device: all of the SM's shared memory, so that eight CTAs
  // fit (25 KB each).
  static std::once_flag once[sbt::kMaxDevices];
  static cudaError_t set[sbt::kMaxDevices];
  const cudaError_t attr = sbt::once_per_device(once, set, [] {
    return cudaFuncSetAttribute(
        full_flags_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
        (int)cudaSharedmemCarveoutMaxShared);
  });
  if (attr != cudaSuccess) return (int)attr;
  const int tiles = (total + kTile - 1) / kTile;
  SBT_EVENT(0, stream);
  full_flags_kernel<<<tiles, kThreads, 0, stream>>>(
      padded, total, w, lengths, cmax, num_contigs, n, n_ptr, status,
      ticket_base, epoch, tiles, out);
  SBT_EVENT(1, stream);
  return (int)cudaGetLastError();
}

// CTAs of the kernel that fit on one SM (for the profile script).
extern "C" int sbt_full_flags_occupancy() {
  int ctas = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas, full_flags_kernel,
                                                kThreads, 0);
  return ctas;
}

#ifdef SBT_PROFILE
// Milliseconds of the last call's launch, and the tiles' marks.
extern "C" int sbt_full_flags_profile(float* ms, long long* marks, int tiles) {
  cudaError_t err = cudaEventSynchronize(g_ff_events[1]);
  if (err == cudaSuccess)
    err = cudaEventElapsedTime(&ms[0], g_ff_events[0], g_ff_events[1]);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaMemcpyFromSymbol(marks, g_ff_marks,
                                   4 * tiles * sizeof(long long));
}
#endif
