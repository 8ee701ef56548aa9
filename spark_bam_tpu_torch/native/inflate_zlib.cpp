// Batched raw-DEFLATE inflate of BGZF payloads through zlib (reference
// spark_bam_tpu/native/spark_bam_native.cpp: sbt_inflate_blocks), the
// host-zlib yardstick beside the table decoder in eager.cpp. A source of
// its own because it needs zlib.h and -lz, which the card host is not
// known to have: nothing the card runs loads it.
//
// Built by spark_bam_tpu_torch/native/build.py (g++ -O3 -fPIC -shared
// ... -lz) and called through ctypes, which releases the GIL.

#include <cstdint>
#include <cstring>
#include <zlib.h>

extern "C" {

// Inflate `count` raw-deflate payloads; offsets/lengths index into `comp`,
// out_offsets into `out`. Returns 0 on success, 1-based index of the first
// failing block otherwise.
long sbt_inflate_blocks(
    const uint8_t* comp,
    const int64_t* offsets,
    const int64_t* lengths,
    int64_t count,
    uint8_t* out,
    const int64_t* out_offsets,
    const int64_t* out_lengths) {
  for (int64_t i = 0; i < count; ++i) {
    z_stream zs;
    std::memset(&zs, 0, sizeof(zs));
    if (inflateInit2(&zs, -15) != Z_OK) return i + 1;
    zs.next_in = const_cast<uint8_t*>(comp + offsets[i]);
    zs.avail_in = static_cast<uInt>(lengths[i]);
    zs.next_out = out + out_offsets[i];
    zs.avail_out = static_cast<uInt>(out_lengths[i]);
    int rc = inflate(&zs, Z_FINISH);
    int64_t produced = static_cast<int64_t>(zs.total_out);
    inflateEnd(&zs);
    if (rc != Z_STREAM_END || produced != out_lengths[i]) return i + 1;
  }
  return 0;
}

}  // extern "C"
