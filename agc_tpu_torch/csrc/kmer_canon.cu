// Canonical k-mer fill for splitter discovery: for every position of every
// packed row, where(valid, min(dir, rc) << (64 - 2k), SENTINEL), written
// straight into the int64 pool in the port's convention (bit 63 flipped,
// so SENTINEL is INT64_MAX and sorts last).
//
// Replaces the TPU kernel _kmer_halves_kernel / _kmer_halves_grid_kernel
// via kmer_halves_pallas and kmer_core_via_pallas
// (agc_tpu/ops/pallas_kmers.py:106-213) together with the canon_rows_p4
// epilogue (agc_tpu/ops/kmers.py:747-758): the TPU kernel built u32
// halves with a k-step shift-add ladder and left validity to a cumsum in
// XLA; here one thread rolls both orientations over 32 consecutive
// positions (k-1 warm-up symbols) in native 64-bit registers and tracks
// the run of valid symbols, so validity needs no cumsum.
//
// What bounds it on the H100: the 8-byte store per position (16x the
// 0.5-byte packed input). It runs over a whole contig in one launch, or
// over seam-packed rows of many contigs; the 80 GB card holds the pool of
// a whole chromosome, so discovery needs no chunking.
#include "kmer_common.cuh"

namespace agc {
namespace {

__global__ void kmer_canon_kernel(const uint8_t* __restrict__ packed,
                                  int64_t half, int64_t n, int k,
                                  int64_t* __restrict__ out) {
  const int64_t b = blockIdx.y;
  const uint8_t* row = packed + b * half;
  int64_t* orow = out + b * n;
  const int64_t p0 =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kPerThread;
  if (p0 >= n) return;
  const uint64_t mask = kmer_mask(k);
  const int rc_shift = 2 * (k - 1);
  const int align = 64 - 2 * k;
  const int64_t s = p0 - (k - 1) > 0 ? p0 - (k - 1) : 0;
  const int64_t e = p0 + kPerThread < n ? p0 + kPerThread : n;
  DirRoll r;
  uint64_t rc = 0;
  for (int64_t p = s; p < e; ++p) {
    const uint32_t c = sym_at(row, p);
    r.push(c, mask);
    const uint64_t comp = c > 3u ? 3ull : static_cast<uint64_t>(3u - c);
    rc = (rc >> 2) | (comp << rc_shift);
    if (p >= p0) {
      int64_t v = INT64_MAX;
      if (r.run >= k) {
        const uint64_t canon = (r.dir < rc ? r.dir : rc) << align;
        v = static_cast<int64_t>(canon ^ 0x8000000000000000ull);
      }
      orow[p] = v;
    }
  }
}

}  // namespace
}  // namespace agc

// packed: u8[B, half]; out: int64[B, 2 * half].
extern "C" int agc_kmer_canon(const uint8_t* packed, int64_t B, int64_t half,
                              int k, int64_t* out, void* stream) {
  using namespace agc;
  const int64_t n = 2 * half;
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  kmer_canon_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, out);
  return static_cast<int>(cudaGetLastError());
}
