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

constexpr int kThreads = 256;   // threads per block of dir_mix
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

// Membership in a sorted u32 mix table, with a one-probe filter in front
// of the search (scan_fused and member_mix). A MixSet is, in u32 words:
//   - a bitmap of 2^20 bits (128 KiB) in which every table entry sets the
//     bits (v * kMixC1) >> 12 and (v * kMixC2) >> 12. Built from every
//     entry, padding and duplicates included, it has no false negative;
//   - a directory of the table's top d bits (mix_dir_bits): dir[b] is the
//     first index whose value's top d bits are >= b, b in [0, 2^d].
// mix_set_build (member_mix.cu) builds its image in device memory once a
// launch, with a grid of global atomics; each block of a kernel then
// copies the image into its dynamic shared memory (MixSet::load, 16-byte
// loads). A mix that misses either bit is no member: two shared loads, no
// dependent chain, and that is the common case. One that passes is
// searched in its bucket table[dir[b], dir[b + 1]) in device memory, which
// L2 holds. The plain model of both is cuda_kmers.mix_filter_plain /
// mix_dir_plain; agc_mix_set_debug (member_mix.cu) writes what one block
// loaded, so the card's structures are compared with the model.
constexpr int kMixFilterLog2 = 20;
constexpr int kMixFilterWords = 1 << (kMixFilterLog2 - 5);
constexpr uint32_t kMixC1 = 0x9E3779B1u;
constexpr uint32_t kMixC2 = 0x85EBCA77u;
constexpr int kMixDirMaxBits = 14;

// Directory bits for a T-entry table: ceil(log2 T) - 2 within [1, 14], so
// a bucket holds about four entries (more above 2^16 entries).
__host__ __device__ __forceinline__ int mix_dir_bits(int64_t T) {
  int lg = 0;
  while ((int64_t{1} << lg) < T) ++lg;
  const int d = lg - 2;
  return d < 1 ? 1 : (d > kMixDirMaxBits ? kMixDirMaxBits : d);
}

// u32 words of a MixSet: a multiple of four, so the image and whatever
// follows it in shared memory stay 16-byte aligned.
__host__ __device__ __forceinline__ int mix_set_words(int64_t T) {
  return (kMixFilterWords + (1 << mix_dir_bits(T)) + 1 + 3) & ~3;
}

__device__ __forceinline__ uint32_t mix_hash(uint32_t v, uint32_t c) {
  return (v * c) >> (32 - kMixFilterLog2);
}

// Builds the MixSet image of table u32[T] into image u32[mix_set_words(T)]
// on stream st.
cudaError_t mix_set_build(const uint32_t* table, int T, uint32_t* image, cudaStream_t st);

// lower_bound of x in its bucket of the directory; true when x is in the
// table. Out of line: only the mixes that pass the filter come here.
static __device__ __noinline__ bool mix_exact(const int32_t* dir, const uint32_t* table,
                                            int shift, uint32_t x) {
  const uint32_t b = x >> shift;
  int lo = dir[b];
  const int end = dir[b + 1];
  int hi = end;
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (__ldg(table + mid) < x) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < end && __ldg(table + lo) == x;
}

// The walk index of a set of flipped int64 codes (walk_index,
// greedy_walk.cu): the sorted values that occur once, and a directory of
// 2^bits + 1 offsets into them over the top `bits` bits of the unsigned
// code. greedy_walk looks up a pool's singletons in it (kmer_dir_rc's set
// has a table of its own, kmer_canon.cu).
struct Singles {
  const int64_t* __restrict__ v;     // sorted flipped codes that occur once
  const uint32_t* __restrict__ dir;  // 2^bits + 1 bucket offsets into v
  int bits;
};

constexpr int kScan = 4;  // bucket entries compared at once

__device__ __forceinline__ uint32_t bucket_of(int64_t v, int bits) {
  return static_cast<uint32_t>(
      (static_cast<uint64_t>(v) ^ 0x8000000000000000ull) >> (64 - bits));
}

// hit[j] = v[j] is in the index (INT64_MAX, the SENTINEL, never is). The
// P lookups advance together, so their loads are in flight at once.
template <int P>
__device__ __forceinline__ void lookup(const Singles& s, const int64_t (&v)[P],
                                       bool (&hit)[P]) {
  int64_t lo[P], hi[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    lo[j] = hi[j] = 0;
    if (v[j] != INT64_MAX) {
      const uint32_t b = bucket_of(v[j], s.bits);
      lo[j] = s.dir[b];
      hi[j] = s.dir[b + 1];
    }
  }
  // a bucket holds under one singleton on average; a larger one (a skewed
  // prefix) is halved until kScan entries are left
  bool more = true;
  while (more) {
    more = false;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (hi[j] - lo[j] > kScan) {
        const int64_t mid = (lo[j] + hi[j]) >> 1;
        if (s.v[mid] < v[j]) {
          lo[j] = mid + 1;
        } else {
          hi[j] = mid + 1;
        }
        more |= hi[j] - lo[j] > kScan;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    bool h = false;
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (lo[j] + q < hi[j]) h |= s.v[lo[j] + q] == v[j];
    }
    hit[j] = h;
  }
}

// A device-wide exclusive scan by decoupled look-back (set_table's spill
// and walk_index's singletons): block t publishes its own count in
// status[t] (flag kFlagOwn), then the sum of every block up to and with it
// (kFlagPrefix), value below the flag. Blocks start in index order (as in
// CUB's single-pass scans), so a block waits only on blocks that run or
// have run. status is zero when the kernel starts.
constexpr uint64_t kFlagOwn = uint64_t(1) << 62;
constexpr uint64_t kFlagPrefix = uint64_t(2) << 62;
constexpr uint64_t kFlagValue = kFlagOwn - 1;

__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// Every thread of block t > 0 (kN threads): the sum of the counts of blocks
// 0 .. t-1. Each pass reads the words of the kN blocks below `look`, a
// thread each, each thread waiting until its word is set, and adds them
// down to the nearest that holds a prefix, so every thread gets the sum.
// scratch: kN / 32 words.
template <int kN>
__device__ __forceinline__ int64_t look_back(const uint64_t* status, int64_t t,
                                             int64_t* scratch) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int64_t sum = 0;
  for (int64_t look = t - 1;; look -= kN) {
    const int64_t i = look - threadIdx.x;
    uint64_t w = kFlagPrefix;  // below block 0: a prefix of 0
    if (i >= 0) {
      while (((w = load_relaxed(status + i)) >> 62) == 0) __nanosleep(32);
    }
    // the nearest block with a prefix: the least thread whose word has one
    const unsigned pre = __ballot_sync(0xffffffffu, (w >> 62) == 2);
    if (lane == 0) scratch[warp] = pre ? 32 * warp + __ffs(pre) - 1 : kN;
    __syncthreads();
    int stop = kN;
#pragma unroll
    for (int v = 0; v < kN / 32; ++v) stop = min(stop, static_cast<int>(scratch[v]));
    int64_t x = static_cast<int>(threadIdx.x) <= stop ? static_cast<int64_t>(w & kFlagValue) : 0;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
    __syncthreads();  // every thread has read the stops
    if (lane == 0) scratch[warp] = x;
    __syncthreads();
#pragma unroll
    for (int v = 0; v < kN / 32; ++v) sum += scratch[v];
    __syncthreads();  // scratch is rewritten by the next pass
    if (stop < kN) return sum;
  }
}

struct MixSet {
  uint32_t* bits;
  int32_t* dir;
  const uint32_t* table;
  int T;
  int shift;  // 32 - directory bits

  __device__ MixSet(uint32_t* smem, const uint32_t* table_, int T_)
      : bits(smem),
        dir(reinterpret_cast<int32_t*>(smem + kMixFilterWords)),
        table(table_),
        T(T_),
        shift(32 - mix_dir_bits(T_)) {}

  // Copies the image mix_set_build made. Every thread of the block calls
  // it; it ends synchronised.
  __device__ void load(const uint32_t* image) {
    const int n = mix_set_words(T) / 4;
    const uint4* src = reinterpret_cast<const uint4*>(image);
    uint4* dst = reinterpret_cast<uint4*>(bits);
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
    __syncthreads();
  }

  // False: x is no member. True: x may be one (every member passes).
  __device__ __forceinline__ bool maybe(uint32_t x) const {
    const uint32_t h1 = mix_hash(x, kMixC1);
    const uint32_t h2 = mix_hash(x, kMixC2);
    return ((bits[h1 >> 5] >> (h1 & 31)) & (bits[h2 >> 5] >> (h2 & 31)) & 1u) != 0;
  }

  __device__ __forceinline__ bool exact(uint32_t x) const {
    return mix_exact(dir, table, shift, x);
  }

  __device__ __forceinline__ bool contains(uint32_t x) const {
    return maybe(x) && exact(x);
  }
};

}  // namespace agc
