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
// positions (after 32 warm-up symbols, of which the last k-1 count) in
// native 64-bit registers and tracks the run of valid symbols, so
// validity needs no cumsum.
//
// What bounds it on the H100: the 8-byte store per position (16x the
// 0.5-byte packed input), 537 MB for a 64 Mi-symbol contig. The kernel
// this one replaces stored each thread's position straight from the
// rolling loop: the lanes of a warp stored 256 B apart, one sector each,
// and reached ~245 GB/s. Here a block of 128 threads takes a tile of
// 4096 positions: it loads the tile's packed bytes (and the 16 before
// them, the warm-up) into shared memory with coalesced loads, each thread
// takes its 32 symbols and the 32 before them as two 16-byte shared
// loads, rolls them in registers and stages its 32 codes in shared memory
// (a stride of 33 words, so that the 64-bit stores of a half-warp fall on
// distinct banks); then the block writes the tile with neighbouring
// threads on neighbouring 8-byte words, 256 contiguous bytes a warp. The
// tile is the kernel's own (kmer_common.cuh's kTile serves dir_mix): its
// 35 KB of static shared memory let six blocks share an SM, so that one
// block's stores overlap another's rolling.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kCanonThreads = 128;
constexpr int kCanonTile = kCanonThreads * kPerThread;  // positions a block
constexpr int kInBytes = 16 + kCanonTile / 2;  // warm-up bytes + the tile's
constexpr int kStage = kCanonTile + kCanonTile / 32;

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

__global__ void __launch_bounds__(kCanonThreads)
    kmer_canon_kernel(const uint8_t* __restrict__ packed, int64_t half,
                      int64_t n, int k, int64_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_in[kInBytes];
  __shared__ int64_t s_out[kStage];
  const int64_t b = blockIdx.y;
  const uint8_t* row = packed + b * half;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCanonTile;
  const int64_t byte0 = base / 2 - 16;
  for (int j = threadIdx.x; j < kInBytes; j += kCanonThreads) {
    const int64_t at = byte0 + j;
    s_in[j] = at >= 0 && at < half ? row[at] : 0xFF;  // outside the row: invalid
  }
  __syncthreads();
  const uint4 prev = *reinterpret_cast<const uint4*>(s_in + 16 * threadIdx.x);
  const uint4 own = *reinterpret_cast<const uint4*>(s_in + 16 * threadIdx.x + 16);
  const uint32_t words[8] = {prev.x, prev.y, prev.z, prev.w,
                             own.x, own.y, own.z, own.w};
  const uint64_t mask = kmer_mask(k);
  const int rc_shift = 2 * (k - 1);
  const int align = 64 - 2 * k;
  const int j0 = kPerThread * threadIdx.x;
  DirRoll r;
  uint64_t rc = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t c = (words[w] >> (4 * s)) & 15u;
      r.push(c, mask);
      const uint64_t comp = c > 3u ? 3ull : static_cast<uint64_t>(3u - c);
      rc = (rc >> 2) | (comp << rc_shift);
      if (w >= 4) {
        int64_t v = INT64_MAX;
        if (r.run >= k) {
          const uint64_t canon = (r.dir < rc ? r.dir : rc) << align;
          v = static_cast<int64_t>(canon ^ 0x8000000000000000ull);
        }
        s_out[padded(j0 + 8 * (w - 4) + s)] = v;
      }
    }
  }
  __syncthreads();
  const int64_t left = n - base;
  const int m = left < kCanonTile ? static_cast<int>(left) : kCanonTile;
  int64_t* orow = out + b * n + base;
  for (int j = threadIdx.x; j < m; j += kCanonThreads) orow[j] = s_out[padded(j)];
}

}  // namespace
}  // namespace agc

// packed: u8[B, half]; out: int64[B, 2 * half].
extern "C" int agc_kmer_canon(const uint8_t* packed, int64_t B, int64_t half,
                              int k, int64_t* out, void* stream) {
  using namespace agc;
  const int64_t n = 2 * half;
  if (B <= 0 || n <= 0) return 0;
  const int64_t n_tiles = (n + kCanonTile - 1) / kCanonTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  kmer_canon_kernel<<<grid, kCanonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, out);
  return static_cast<int>(cudaGetLastError());
}
