// Direct k-mer code halves per position of nibble-packed rows: for every
// position of every row, dlo / dhi = the low / high 32 bits of the direct
// code of the window ending there (dir = sum_t sym[p-t] * 4^t over the
// last min(k, p+1) symbols of the row, invalid symbols counted as 0), and
// valid = the window holds k valid symbols inside the row.
//
// This is what the large-table join (scan_batch_join_global_p4) reads:
// the XLA _dir_halves k-step shift-add ladder of agc_tpu
// (agc_tpu/ops/kmers.py:58-110, vmapped at :1372-1376). The port's plain
// version of it (cuda_kmers.dir_halves) makes k shifted int64 passes over
// the whole batch. Its values, invalid positions included, are what this
// kernel writes: the join's fill slots read dlo / dhi at flat position 0.
//
// What bounds it on the H100: the 9 bytes written per position (two u32
// halves and a flag) against 0.5 byte read. One thread rolls 32
// consecutive positions with kmer_common.cuh's DirRoll (k-1 warm-up
// symbols), as scan_fused does; the block stages its 8192 positions in
// shared memory (padded against bank conflicts, validity as one 32-bit
// mask per thread) so that the stores to device memory are coalesced.
#include "kmer_common.cuh"

namespace agc {
namespace {

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

constexpr int kStage = kTile + kTile / 32;  // padded u32 slots per half

__global__ void dir_mix_kernel(const uint8_t* __restrict__ packed,
                               int64_t half, int64_t n, int k,
                               uint32_t* __restrict__ dlo,
                               uint32_t* __restrict__ dhi,
                               uint8_t* __restrict__ valid) {
  extern __shared__ uint32_t s_buf[];
  uint32_t* s_lo = s_buf;
  uint32_t* s_hi = s_buf + kStage;
  uint32_t* s_valid = s_buf + 2 * kStage;  // one bit per position
  const int64_t b = blockIdx.y;
  const uint8_t* row = packed + b * half;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t p0 = base + threadIdx.x * kPerThread;
  uint32_t bits = 0;
  if (p0 < n) {
    const uint64_t mask = kmer_mask(k);
    const int64_t s = p0 - (k - 1) > 0 ? p0 - (k - 1) : 0;
    const int64_t e = p0 + kPerThread < n ? p0 + kPerThread : n;
    DirRoll r;
    for (int64_t p = s; p < e; ++p) {
      r.push(sym_at(row, p), mask);
      if (p >= p0) {
        const int j = static_cast<int>(p - base);
        s_lo[padded(j)] = static_cast<uint32_t>(r.dir);
        s_hi[padded(j)] = static_cast<uint32_t>(r.dir >> 32);
        if (r.run >= k) bits |= 1u << (p - p0);
      }
    }
  }
  s_valid[threadIdx.x] = bits;
  __syncthreads();
  const int64_t left = n - base;
  const int m = left < kTile ? static_cast<int>(left) : kTile;
  const int64_t o = b * n + base;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    dlo[o + j] = s_lo[padded(j)];
    dhi[o + j] = s_hi[padded(j)];
    valid[o + j] = static_cast<uint8_t>((s_valid[j >> 5] >> (j & 31)) & 1u);
  }
}

}  // namespace
}  // namespace agc

// packed: u8[B, half]; dlo, dhi: u32[B, 2 * half]; valid: u8[B, 2 * half].
extern "C" int agc_dir_mix(const uint8_t* packed, int64_t B, int64_t half,
                           int k, uint32_t* dlo, uint32_t* dhi, uint8_t* valid,
                           void* stream) {
  using namespace agc;
  const int64_t n = 2 * half;
  if (B <= 0 || n <= 0) return 0;
  const size_t smem = (2 * static_cast<size_t>(kStage) + kThreads) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      dir_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_tiles = (n + kTile - 1) / kTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  dir_mix_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, dlo, dhi, valid);
  return static_cast<int>(cudaGetLastError());
}
