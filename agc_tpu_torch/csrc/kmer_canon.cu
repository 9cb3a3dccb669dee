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
//
// kmer_dir_rc, on the same tile, writes all of kmer_halves_pallas's
// outputs instead of their minimum: per position the direct and the
// reverse-complement codes (left-aligned, flipped int64), the valid flag
// (uint8) and, given a set, membership of the canonical code in it (the
// dense scan of -f: agc_tpu's contig_kmers_dir_rc and
// contig_kmers_dir_rc_with_membership, ops/kmers.py:251-264, through
// kmer_core_via_pallas, pallas_kmers.py:197-213). It is bound by its 17
// bytes out a position (18 with membership) against 0.5 in.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kCanonThreads = 128;
constexpr int kCanonTile = kCanonThreads * kPerThread;  // positions a block
constexpr int kInBytes = 16 + kCanonTile / 2;  // warm-up bytes + the tile's
constexpr int kStage = kCanonTile + kCanonTile / 32;

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// The tile's packed bytes and the 16 before them, coalesced; bytes outside
// the row are invalid symbols.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ row, int64_t half,
                                          int64_t base, uint8_t* s_in) {
  const int64_t byte0 = base / 2 - 16;
  for (int j = threadIdx.x; j < kInBytes; j += kCanonThreads) {
    const int64_t at = byte0 + j;
    s_in[j] = at >= 0 && at < half ? row[at] : 0xFF;
  }
  __syncthreads();
}

enum class Code { kCanon, kDir, kRc };

// Rolls the thread's 32 positions after its 32 warm-up symbols (`words`,
// two 16-byte shared loads) and stages one code a position in s_out, left
// aligned and flipped: the canonical code where the window is valid and
// SENTINEL elsewhere (kCanon), or the direct or the reverse-complement
// code at every position (kDir, kRc). An invalid symbol counts as 0 in the
// direct code and as 3 in the reverse complement, as do the symbols before
// the row's start.
template <Code kWhat>
__device__ __forceinline__ void roll_stage(const uint32_t (&words)[8], int k,
                                           int64_t* s_out) {
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
        uint64_t u;
        if (kWhat == Code::kDir) {
          u = r.dir << align;
        } else if (kWhat == Code::kRc) {
          u = rc << align;
        } else {
          u = r.run >= k ? (r.dir < rc ? r.dir : rc) << align : ~0ull;
        }
        s_out[padded(j0 + 8 * (w - 4) + s)] = static_cast<int64_t>(u ^ 0x8000000000000000ull);
      }
    }
  }
}

__device__ __forceinline__ void thread_words(const uint8_t* s_in, uint32_t (&words)[8]) {
  const uint4 prev = *reinterpret_cast<const uint4*>(s_in + 16 * threadIdx.x);
  const uint4 own = *reinterpret_cast<const uint4*>(s_in + 16 * threadIdx.x + 16);
  words[0] = prev.x, words[1] = prev.y, words[2] = prev.z, words[3] = prev.w;
  words[4] = own.x, words[5] = own.y, words[6] = own.z, words[7] = own.w;
}

// The block writes its m staged codes, neighbouring threads on neighbouring
// 8-byte words.
__device__ __forceinline__ void store_tile(const int64_t* s_out, int64_t* __restrict__ dst,
                                           int m) {
  for (int j = threadIdx.x; j < m; j += kCanonThreads) dst[j] = s_out[padded(j)];
}

__device__ __forceinline__ int tile_len(int64_t n, int64_t base) {
  const int64_t left = n - base;
  return left < kCanonTile ? static_cast<int>(left) : kCanonTile;
}

__global__ void __launch_bounds__(kCanonThreads)
    kmer_canon_kernel(const uint8_t* __restrict__ packed, int64_t half,
                      int64_t n, int k, int64_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_in[kInBytes];
  __shared__ int64_t s_out[kStage];
  const int64_t b = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCanonTile;
  load_tile(packed + b * half, half, base, s_in);
  uint32_t words[8];
  thread_words(s_in, words);
  roll_stage<Code::kCanon>(words, k, s_out);
  __syncthreads();
  store_tile(s_out, out + b * n + base, tile_len(n, base));
}

// kmer_dir_rc: three rolls of the same registers, each staged and stored
// coalesced in turn (one int64 stage fits the static shared memory, two do
// not): the direct codes, the reverse complements, then the canonical
// codes, which stay in the stage for the flags. A thread then takes the
// positions threadIdx.x + 128 r, two at a time, writes each one's valid
// flag (its canonical code is not SENTINEL) and, when a set is given, its
// membership: a lookup of the canonical code in the set's walk index, the
// device function greedy_walk uses, two lookups in flight together.
__global__ void __launch_bounds__(kCanonThreads)
    kmer_dir_rc_kernel(const uint8_t* __restrict__ packed, int64_t half, int64_t n,
                       int k, int64_t* __restrict__ udir, int64_t* __restrict__ urc,
                       uint8_t* __restrict__ valid, uint8_t* __restrict__ member,
                       Singles set) {
  __shared__ __align__(16) uint8_t s_in[kInBytes];
  __shared__ int64_t s_out[kStage];
  const int64_t b = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCanonTile;
  const int64_t at = b * n + base;
  const int m = tile_len(n, base);
  load_tile(packed + b * half, half, base, s_in);
  uint32_t words[8];
  thread_words(s_in, words);
  roll_stage<Code::kDir>(words, k, s_out);
  __syncthreads();
  store_tile(s_out, udir + at, m);
  __syncthreads();
  roll_stage<Code::kRc>(words, k, s_out);
  __syncthreads();
  store_tile(s_out, urc + at, m);
  __syncthreads();
  roll_stage<Code::kCanon>(words, k, s_out);
  __syncthreads();
#pragma unroll 4
  for (int r = 0; r < kPerThread; r += 2) {
    int64_t v[2];
    bool hit[2] = {false, false};
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = threadIdx.x + kCanonThreads * (r + q);
      v[q] = j < m ? s_out[padded(j)] : INT64_MAX;
    }
    if (member != nullptr) lookup(set, v, hit);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int j = threadIdx.x + kCanonThreads * (r + q);
      if (j < m) {
        valid[at + j] = v[q] != INT64_MAX;
        if (member != nullptr) member[at + j] = hit[q];
      }
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
  if (B <= 0 || n <= 0) return 0;
  const int64_t n_tiles = (n + kCanonTile - 1) / kCanonTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  kmer_canon_kernel<<<grid, kCanonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

// packed: u8[B, half]; udir, urc: int64[B, 2 * half]; valid: u8[B, 2 * half];
// member: u8[B, 2 * half] or null (no set); singles, dir, bits: the set's
// walk index (agc_walk_index), read only when member is given.
extern "C" int agc_kmer_dir_rc(const uint8_t* packed, int64_t B, int64_t half, int k,
                               int64_t* udir, int64_t* urc, uint8_t* valid,
                               uint8_t* member, const int64_t* singles,
                               const uint32_t* dir, int bits, void* stream) {
  using namespace agc;
  const int64_t n = 2 * half;
  if (B <= 0 || n <= 0) return 0;
  const int64_t n_tiles = (n + kCanonTile - 1) / kCanonTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  kmer_dir_rc_kernel<<<grid, kCanonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, udir, urc, valid, member, Singles{singles, dir, bits});
  return static_cast<int>(cudaGetLastError());
}
