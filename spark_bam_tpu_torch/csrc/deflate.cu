// The write path's device lanes: CRC-32 and literal-only fixed-Huffman
// DEFLATE of up to 64 KiB payload lanes, one dispatch per batch of lanes.
//
// Replaces the jnp/XLA programs spark_bam_tpu/compress/kernels.py::
// crc32_lanes (_crc_body, a slice-by-4 fori_loop over 4-byte groups) and
// deflate_fixed_lanes (per-byte table lookups, a cumulative sum and one
// scatter-add of every set bit). The plain versions are
// spark_bam_tpu_torch/compress/kernels.py::crc32_lanes_plain and
// deflate_fixed_lanes_plain.
//
// What bounds them on the H100: bytes. A lane is 65,536 bytes in; the CRC
// writes 4 bytes a lane, the pack 65,544 + 8. At the writer's 16 lanes a
// dispatch moves ~1.05 MB (CRC) or ~2.1 MB (pack): 0.3 or 0.6 us at
// 3.35 TB/s, less than one launch. So a dispatch is launch-bound, and the
// design keeps a lane's whole work inside one CTA rather than chase the
// bound.
//
// Design: one CTA of 1,024 threads per lane; thread t holds bytes
// [64t, 64t + 64) of its lane in registers (four 16-byte loads).
// CRC (both kernels, block_crc):
//   each thread runs the byte-wise table CRC over its bytes from register
//   0 (thread 0 from 0xFFFFFFFF, the init). The CRC register is linear in
//   its start value over zero bytes, so with L = 64q + r, the lane's
//   register is Z_r( XOR_{t<q} Z_{64(q-1-t)}(c_t) ) ^ c_q, where Z_n
//   advances a register over n zero bytes (zlib's crc32_combine
//   operator) and c_q is the short last chunk. Z_{2^k} for k = 0..15 come
//   from the host as 8 nibble tables of 16 words each (a 32x32 GF(2)
//   matrix applied in 8 lookups); each full chunk applies the ones of
//   its 10-bit multiple of 64, a block XOR-reduction sums them, and
//   thread 0 applies Z_r. Pad bytes never enter the digest: a thread
//   stops at the lane's length. Length 0 gives 0.
// Pack (deflate_fixed_lanes):
//   each byte's code is 8 bits (0x30 + b, below 144) or 9 (0x100 + b),
//   bit-reversed; a block-wide exclusive scan of the threads' bit counts,
//   starting at bit 3, places every code. Each thread ORs its codes into
//   a 64-bit accumulator over two words of a 32-bit-word copy of the
//   output plane in dynamic shared memory (65,544 bytes, zeroed first),
//   and flushes a finished word with atomicOr: bits are unique, so the
//   ORs are exact in any order and the plane is the same in every run.
//   Words at or past OUT_BYTES are dropped (a lane that outgrows the
//   plane keeps its true total_bits; the codec picks stored for it). The
//   header's 3 (BFINAL = 1, BTYPE = 01) is ORed into word 0, the 7-bit
//   all-zero end-of-block code needs no write, and the whole plane is
//   stored, zeros included, as the reference's zeroed plane is.

#include <cstdint>
#include <cuda_runtime.h>

#include "per_device.cuh"

namespace {

constexpr int kStride = 65536;              // lane width (one BGZF payload)
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kStride / kThreads;  // bytes a thread holds
constexpr int kOutBytes = kStride + 8;      // OUT_BYTES
constexpr int kOutWords = kOutBytes / 4;
constexpr int kOps = 16;                    // Z_{2^k}, k = 0..15
constexpr int kConsts = 256 + kOps * 8 * 16;  // byte table, nibble tables

static_assert(kChunk == 64, "four 16-byte loads a thread");
static_assert(kOutBytes % 4 == 0, "whole words");

struct Smem {
  uint32_t table[256];          // reflected CRC-32 byte table
  uint32_t ops[kOps][8][16];    // nibble tables of Z_{2^k}
  uint32_t scan[kWarps];
  uint32_t red[kWarps];
  uint32_t last;                // c_q, the short last chunk's register
};

__device__ __forceinline__ uint32_t gf2_apply(const uint32_t (&op)[8][16],
                                              uint32_t v) {
  uint32_t r = 0;
#pragma unroll
  for (int p = 0; p < 8; ++p) r ^= op[p][(v >> (4 * p)) & 15u];
  return r;
}

__device__ __forceinline__ uint32_t byte_at(const uint32_t (&w)[16], int i) {
  return (w[i >> 2] >> (8 * (i & 3))) & 0xFFu;
}

// Loads the constants and thread t's bytes; returns the lane's length,
// clamped to [0, kStride].
__device__ __forceinline__ int load_lane(const uint8_t* data,
                                         const int32_t* lengths,
                                         const uint32_t* consts, Smem& s,
                                         uint32_t (&w)[16]) {
  const int t = threadIdx.x;
  const int lane = blockIdx.x;
  const int len = min(max(lengths[lane], 0), kStride);
  uint32_t* flat = &s.table[0];
  for (int i = t; i < kConsts; i += kThreads) flat[i] = __ldg(consts + i);
  if (t == 0) s.last = 0;
  if (kChunk * t < len) {
    const uint4* p = reinterpret_cast<const uint4*>(
                         data + static_cast<size_t>(lane) * kStride) +
                     4 * t;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 q = __ldg(p + k);
      w[4 * k] = q.x;
      w[4 * k + 1] = q.y;
      w[4 * k + 2] = q.z;
      w[4 * k + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < 16; ++k) w[k] = 0;
  }
  __syncthreads();
  return len;
}

// The lane's CRC-32, in thread 0. Every thread of the block calls it.
__device__ uint32_t block_crc(const uint32_t (&w)[16], int len, Smem& s) {
  const int t = threadIdx.x;
  const int q = len >> 6, r = len & 63;
  const int n = min(max(len - kChunk * t, 0), kChunk);
  uint32_t c = t == 0 ? 0xFFFFFFFFu : 0u;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < n) c = (c >> 8) ^ s.table[(c ^ byte_at(w, i)) & 0xFFu];
  }
  uint32_t full = 0;
  if (t < q) {
    const int m = q - 1 - t;  // chunks after this one, each 64 bytes
#pragma unroll 1
    for (int j = 0; j < 10; ++j) {
      if ((m >> j) & 1) c = gf2_apply(s.ops[6 + j], c);
    }
    full = c;
  } else if (t == q) {
    s.last = c;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) full ^= __shfl_xor_sync(0xFFFFFFFFu, full, o);
  if ((t & 31) == 0) s.red[t >> 5] = full;
  __syncthreads();
  uint32_t crc = 0;
  if (t < 32) {
    uint32_t x = s.red[t];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x ^= __shfl_xor_sync(0xFFFFFFFFu, x, o);
    if (t == 0) {
#pragma unroll 1
      for (int k = 0; k < 6; ++k) {
        if ((r >> k) & 1) x = gf2_apply(s.ops[k], x);
      }
      crc = x ^ s.last ^ 0xFFFFFFFFu;
    }
  }
  return crc;
}

__global__ void __launch_bounds__(kThreads)
crc32_lanes_kernel(const uint8_t* __restrict__ data,
                   const int32_t* __restrict__ lengths,
                   const uint32_t* __restrict__ consts,
                   uint32_t* __restrict__ crc_out) {
  __shared__ Smem s;
  uint32_t w[16];
  const int len = load_lane(data, lengths, consts, s, w);
  const uint32_t crc = block_crc(w, len, s);
  if (threadIdx.x == 0) crc_out[blockIdx.x] = crc;
}

__device__ __forceinline__ void flush_word(uint32_t* plane, int word,
                                           uint32_t v) {
  if (v != 0 && word < kOutWords) atomicOr(plane + word, v);
}

__global__ void __launch_bounds__(kThreads)
deflate_fixed_kernel(const uint8_t* __restrict__ data,
                     const int32_t* __restrict__ lengths,
                     const uint32_t* __restrict__ consts,
                     uint8_t* __restrict__ packed,
                     int32_t* __restrict__ total_bits,
                     uint32_t* __restrict__ crc_out) {
  extern __shared__ __align__(16) uint32_t plane[];
  __shared__ Smem s;
  const int t = threadIdx.x;
  const int lane_id = t & 31, warp = t >> 5;
  for (int i = t; i < kOutWords; i += kThreads) plane[i] = 0;
  uint32_t w[16];
  const int len = load_lane(data, lengths, consts, s, w);  // syncs
  const int n = min(max(len - kChunk * t, 0), kChunk);

  // Bits of this thread's codes: 8 a byte, 9 from 144.
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < n) bits += 8u + (byte_at(w, i) >= 144u);
  }
  // Exclusive block scan of ``bits``.
  uint32_t x = bits;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, x, o);
    if (lane_id >= o) x += y;
  }
  if (lane_id == 31) s.scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    uint32_t v = s.scan[lane_id];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(0xFFFFFFFFu, v, o);
      if (lane_id >= o) v += y;
    }
    s.scan[lane_id] = v;
  }
  __syncthreads();
  const uint32_t before = x - bits + (warp > 0 ? s.scan[warp - 1] : 0u);
  const uint32_t total = s.scan[kWarps - 1];

  // Codes into the plane: a 64-bit accumulator over words ``word`` and
  // ``word + 1``; a word is flushed once the next code starts past it.
  uint32_t pos = 3u + before;
  int word = static_cast<int>(pos >> 5);
  unsigned long long acc = 0;
#pragma unroll
  for (int i = 0; i < kChunk; ++i) {
    if (i < n) {
      while (pos - 32u * static_cast<uint32_t>(word) >= 32u) {
        flush_word(plane, word, static_cast<uint32_t>(acc));
        acc >>= 32;
        ++word;
      }
      const uint32_t b = byte_at(w, i);
      const uint32_t nb = 8u + (b >= 144u);
      const uint32_t code = b < 144u ? 0x30u + b : 0x100u + b;
      const uint32_t rc = __brev(code) >> (32u - nb);
      acc |= static_cast<unsigned long long>(rc)
             << (pos - 32u * static_cast<uint32_t>(word));
      pos += nb;
    }
  }
  if (n > 0) {
    flush_word(plane, word, static_cast<uint32_t>(acc));
    flush_word(plane, word + 1, static_cast<uint32_t>(acc >> 32));
  }
  if (t == 0) atomicOr(plane, 3u);  // BFINAL = 1, BTYPE = 01

  const uint32_t crc = block_crc(w, len, s);  // syncs after every OR
  __syncthreads();
  uint32_t* out = reinterpret_cast<uint32_t*>(
      packed + static_cast<size_t>(blockIdx.x) * kOutBytes);
  for (int i = t; i < kOutWords; i += kThreads) out[i] = plane[i];
  if (t == 0) {
    total_bits[blockIdx.x] = static_cast<int32_t>(3u + total + 7u);
    crc_out[blockIdx.x] = crc;
  }
}

}  // namespace

// ``data`` (b, 65536) u8 on a 16-byte boundary, ``lengths`` (b,) i32,
// ``consts`` the 2,304 words of compress/kernels.py::_crc_consts.
extern "C" int sbt_crc32_lanes(const uint8_t* data, const int32_t* lengths,
                               int b, const uint32_t* consts, uint32_t* crc,
                               cudaStream_t stream) {
  if (b > 0) {
    crc32_lanes_kernel<<<b, kThreads, 0, stream>>>(data, lengths, consts,
                                                   crc);
  }
  return (int)cudaGetLastError();
}

// As above; ``packed`` (b, 65544) u8 on a 4-byte boundary, ``total_bits``
// (b,) i32 and ``crc`` (b,) u32.
extern "C" int sbt_deflate_fixed_lanes(const uint8_t* data,
                                       const int32_t* lengths, int b,
                                       const uint32_t* consts,
                                       uint8_t* packed, int32_t* total_bits,
                                       uint32_t* crc, cudaStream_t stream) {
  constexpr int kPlane = kOutWords * 4;
  static std::once_flag once[sbt::kMaxDevices];
  static cudaError_t set[sbt::kMaxDevices];
  const cudaError_t attr = sbt::once_per_device(once, set, [] {
    return cudaFuncSetAttribute(deflate_fixed_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                kPlane);
  });
  if (attr != cudaSuccess) return (int)attr;
  if (b > 0) {
    deflate_fixed_kernel<<<b, kThreads, kPlane, stream>>>(
        data, lengths, consts, packed, total_bits, crc);
  }
  return (int)cudaGetLastError();
}
