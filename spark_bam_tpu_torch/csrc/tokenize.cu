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
// but the symbol loop is bit-serial (a code's length is known only after it
// is decoded), so one thread walks one member and the kernel is bound by the
// latency of that serial chain. Design: one thread per row (a window has a
// few hundred rows), each alone in its warp so that rows never diverge
// against each other, two rows per CTA so that they spread over the SMs;
// puff-style count/symbol canonical tables (zlib's contrib/puff structure:
// no sort, the (length, symbol) order falls out of counting offsets) in the
// thread's local memory; a 64-bit bit buffer so a code is peeled without a
// load per bit; and writes of only the non-zero plane bytes (the wrapper
// zero-fills both planes). Faster designs (a warp per member, multi-bit
// table lookups) are later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kStride = 65536;     // one BGZF block inflates to <= 64 KiB
constexpr int kStoredChunk = 512;  // stored copies fail per chunk, as planned
constexpr int kMaxBits = 15;
constexpr int kWarpsPerBlock = 2;  // rows per CTA: spreads rows over the SMs

__constant__ uint16_t kLenBase[29] = {
    3, 4, 5, 6, 7, 8, 9, 10, 11, 13, 15, 17, 19, 23, 27, 31, 35, 43,
    51, 59, 67, 83, 99, 115, 131, 163, 195, 227, 258};
__constant__ uint8_t kLenExtra[29] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4,
    4, 4, 5, 5, 5, 5, 0};
__constant__ uint16_t kDistBase[30] = {
    1, 2, 3, 4, 5, 7, 9, 13, 17, 25, 33, 49, 65, 97, 129, 193, 257,
    385, 513, 769, 1025, 1537, 2049, 3073, 4097, 6145, 8193, 12289,
    16385, 24577};
__constant__ uint8_t kDistExtra[30] = {
    0, 0, 0, 0, 1, 1, 2, 2, 3, 3, 4, 4, 5, 5, 6, 6, 7, 7, 8, 8, 9, 9,
    10, 10, 11, 11, 12, 12, 13, 13};
__constant__ uint8_t kClOrder[19] = {
    16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15};

struct BitReader {
  const uint8_t* row;
  int clen8;     // payload length in bits
  int used;      // bits consumed
  int pos;       // next byte to load; pos * 8 == used + cnt
  int cnt;       // bits held in buf
  uint64_t buf;

  __device__ void refill() {
    uint32_t w = (uint32_t)row[pos] | ((uint32_t)row[pos + 1] << 8) |
                 ((uint32_t)row[pos + 2] << 16) |
                 ((uint32_t)row[pos + 3] << 24);
    buf |= (uint64_t)w << cnt;
    pos += 4;
    cnt += 32;
  }

  // n <= 16 bits LSB first, or -1 past the payload's last bit.
  __device__ int bits(int n) {
    if (used + n > clen8) return -1;
    if (cnt < n) refill();
    int v = (int)(buf & ((1u << n) - 1u));
    buf >>= n;
    cnt -= n;
    used += n;
    return v;
  }

  // Drop to the next byte boundary (stored blocks) and restart the buffer.
  __device__ void align() {
    used = (used + 7) & ~7;
    pos = used >> 3;
    cnt = 0;
    buf = 0;
  }
};

struct Huffman {
  int16_t count[kMaxBits + 1];
  int16_t symbol[288];
};

// Canonical code from code lengths. Returns false when oversubscribed; an
// incomplete (or empty) code is legal and fails on first use instead.
__device__ bool build(Huffman& h, const uint8_t* lens, int n) {
  for (int l = 0; l <= kMaxBits; ++l) h.count[l] = 0;
  for (int s = 0; s < n; ++s) h.count[lens[s]]++;
  int left = 1;
  for (int l = 1; l <= kMaxBits; ++l) {
    left = left * 2 - h.count[l];
    if (left < 0) return false;
  }
  int16_t offs[kMaxBits + 1];
  offs[1] = 0;
  for (int l = 1; l < kMaxBits; ++l) offs[l + 1] = offs[l] + h.count[l];
  for (int s = 0; s < n; ++s)
    if (lens[s]) h.symbol[offs[lens[s]]++] = (int16_t)s;
  return true;
}

// One symbol, peeling bits MSB-of-code first; -1 on truncation or when no
// code of length <= 15 matches.
__device__ int decode(BitReader& br, const Huffman& h) {
  if (br.cnt < kMaxBits) br.refill();
  int code = 0, first = 0, index = 0;
  for (int l = 1; l <= kMaxBits; ++l) {
    if (br.used + l > br.clen8) return -1;
    code |= (int)((br.buf >> (l - 1)) & 1u);
    int count = h.count[l];
    if (code - count < first) {
      br.buf >>= l;
      br.cnt -= l;
      br.used += l;
      return h.symbol[index + (code - first)];
    }
    index += count;
    first = (first + count) << 1;
    code <<= 1;
  }
  return -1;
}

__device__ bool dynamic_tables(BitReader& br, Huffman& lit, Huffman& dist) {
  int hlit = br.bits(5), hdist = br.bits(5), hclen = br.bits(4);
  if (hlit < 0 || hdist < 0 || hclen < 0) return false;
  hlit += 257;
  hdist += 1;
  hclen += 4;
  if (hlit > 286 || hdist > 30) return false;
  uint8_t lens[286 + 30];
  for (int i = 0; i < 19; ++i) lens[i] = 0;
  for (int i = 0; i < hclen; ++i) {
    int v = br.bits(3);
    if (v < 0) return false;
    lens[kClOrder[i]] = (uint8_t)v;
  }
  Huffman cl;
  if (!build(cl, lens, 19)) return false;
  int tot = hlit + hdist;
  int i = 0;
  while (i < tot) {
    int sym = decode(br, cl);
    if (sym < 0) return false;
    if (sym < 16) {
      lens[i++] = (uint8_t)sym;
      continue;
    }
    int v, rep;
    uint8_t val = 0;
    if (sym == 16) {
      if (i == 0) return false;
      val = lens[i - 1];
      v = br.bits(2);
      rep = 3 + v;
    } else if (sym == 17) {
      v = br.bits(3);
      rep = 3 + v;
    } else {
      v = br.bits(7);
      rep = 11 + v;
    }
    if (v < 0 || i + rep > tot) return false;
    while (rep--) lens[i++] = val;
  }
  if (lens[256] == 0) return false;
  return build(lit, lens, hlit) && build(dist, lens + hlit, hdist);
}

__device__ void fixed_tables(Huffman& lit, Huffman& dist) {
  uint8_t lens[288];
  for (int s = 0; s < 144; ++s) lens[s] = 8;
  for (int s = 144; s < 256; ++s) lens[s] = 9;
  for (int s = 256; s < 280; ++s) lens[s] = 7;
  for (int s = 280; s < 288; ++s) lens[s] = 8;
  build(lit, lens, 288);
  for (int s = 0; s < 30; ++s) lens[s] = 5;
  build(dist, lens, 30);
}

__global__ void tokenize_kernel(const uint8_t* __restrict__ staged,
                                const int32_t* __restrict__ clens, int b,
                                int c_pad, uint8_t* __restrict__ lit_out,
                                uint16_t* __restrict__ dist_out,
                                int32_t* __restrict__ out_lens,
                                uint8_t* __restrict__ ok_out) {
  // Lane 0 of each warp decodes one row: rows in one warp would diverge
  // on every symbol, serialising each other.
  if (threadIdx.x % 32 != 0) return;
  int r = blockIdx.x * kWarpsPerBlock + threadIdx.x / 32;
  if (r >= b) return;
  int clen = clens[r];
  if (clen < 0 || clen > c_pad - 8) {  // outside the staging contract
    out_lens[r] = 0;
    ok_out[r] = 0;
    return;
  }
  BitReader br{staged + (size_t)r * c_pad, clen * 8, 0, 0, 0, 0};
  uint8_t* lit = lit_out + (size_t)r * kStride;
  uint16_t* dist = dist_out + (size_t)r * kStride;
  Huffman hl, hd;
  int o = 0;
  bool ok = true;
  while (ok) {
    int bfinal = br.bits(1), btype = br.bits(2);
    if (bfinal < 0 || btype < 0 || btype == 3) {
      ok = false;
      break;
    }
    if (btype == 0) {
      br.align();
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
        for (int k = 0; k < chunk; ++k) lit[o + k] = br.row[src + k];
        len -= chunk;
        br.used += chunk * 8;
        o += chunk;
      }
      br.align();
    } else {
      if (btype == 2) {
        if (!dynamic_tables(br, hl, hd)) {
          ok = false;
          break;
        }
      } else {
        fixed_tables(hl, hd);
      }
      while (true) {
        int sym = decode(br, hl);
        if (sym < 0) {
          ok = false;
          break;
        }
        if (sym < 256) {
          if (o >= kStride) {
            ok = false;
            break;
          }
          lit[o++] = (uint8_t)sym;
          continue;
        }
        if (sym == 256) break;
        int s2 = sym - 257;
        if (s2 >= 29) {
          ok = false;
          break;
        }
        int v = br.bits(kLenExtra[s2]);
        int d = v >= 0 ? decode(br, hd) : -1;
        int vd = d >= 0 ? br.bits(kDistExtra[d]) : -1;
        if (vd < 0) {
          ok = false;
          break;
        }
        int mlen = kLenBase[s2] + v;
        int mdist = kDistBase[d] + vd;
        if (mdist > o || o + mlen > kStride) {
          ok = false;
          break;
        }
        for (int k = 0; k < mlen; ++k) dist[o + k] = (uint16_t)mdist;
        o += mlen;
      }
    }
    if (bfinal) break;
  }
  out_lens[r] = o;
  ok_out[r] = ok ? 1 : 0;
}

}  // namespace

extern "C" int sbt_tokenize(const uint8_t* staged, const int32_t* clens,
                            int b, int c_pad, uint8_t* lit, uint16_t* dist,
                            int32_t* out_lens, uint8_t* ok,
                            cudaStream_t stream) {
  if (b > 0) {
    tokenize_kernel<<<(b + kWarpsPerBlock - 1) / kWarpsPerBlock,
                      32 * kWarpsPerBlock, 0, stream>>>(
        staged, clens, b, c_pad, lit, dist, out_lens, ok);
  }
  return (int)cudaGetLastError();
}
