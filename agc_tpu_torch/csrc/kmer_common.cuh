// Shared device helpers for the k-mer kernels (sm_90a).
//
// Symbols arrive nibble-packed, two per byte, low nibble first; a nibble
// above 3 is an invalid symbol (the host packer writes 15, row padding
// is 0xFF). A k-mer window is valid when it holds k valid symbols, all
// inside its row.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace agc {

constexpr int kThreads = 256;   // threads per block of the rolling kernels
constexpr int kPerThread = 32;  // consecutive positions rolled by one thread
constexpr int kTile = kThreads * kPerThread;  // positions per block

__device__ __forceinline__ uint32_t sym_at(const uint8_t* row, int64_t p) {
  const uint8_t b = row[p >> 1];
  return (p & 1) ? (b >> 4) : (b & 15u);
}

__host__ __device__ __forceinline__ uint64_t kmer_mask(int k) {
  return k >= 32 ? ~0ull : ((1ull << (2 * k)) - 1ull);
}

// Rolling state of the direct code: dir = sum_t sym[i-t] * 4^t over the
// last k symbols (the newest symbol in the lowest bit pair), plus the
// length of the current run of valid symbols.
struct DirRoll {
  uint64_t dir = 0;
  int run = 0;

  __device__ __forceinline__ void push(uint32_t c, uint64_t mask) {
    if (c > 3u) {
      run = 0;
      c = 0u;
    } else {
      ++run;
    }
    dir = ((dir << 2) | c) & mask;
  }
};

// lower_bound in a sorted u32 table; true when x is present.
__device__ __forceinline__ bool in_sorted_u32(const uint32_t* t, int n,
                                              uint32_t x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (t[mid] < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n && t[lo] == x;
}

}  // namespace agc
