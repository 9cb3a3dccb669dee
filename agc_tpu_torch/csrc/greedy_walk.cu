// Greedy singleton splitter walk over a sorted k-mer pool, one block per
// contig, and the index of the pool's singletons that its lookups use.
//
// Replaces the XLA lax.while_loop _greedy_over_canon in singleton mode
// (agc_tpu/ops/kmers.py:599-733, reached through splitter_greedy_canon_*
// and find_splitter_emissions_*). As torch ops every step of the walk
// would be a round trip to the host; here the whole walk stays in one
// block.
//
// A position p of a contig is a hit when canon[p] != SENTINEL and the
// value occurs exactly once in the pool. Emissions: the first hit of the
// contig, then repeatedly the first hit at least `seg` past the last
// emission, until the contig ends or `cap` emissions. The tail is the
// rightmost hit of the contig, independent of the emissions.
//
// Output per contig, int64: [count, pos[cap], kmer[cap], tail_pos,
// tail_kmer], positions relative to the contig start, kmers in the
// flipped convention, tail_pos = INT64_MAX when the contig has no hit.
//
// What bounds it on the H100: latency. Emission j+1 starts seg past
// emission j, so a contig's walk is a chain of dependent steps, and its
// time is the number of serial rounds times the time of one round. The
// kernel this one replaces probed one 256-position window a step on one
// SM, each position a binary search of the whole pool in device memory
// (26-28 dependent loads over a 64 M to 172 M-entry pool that the 50 MB
// L2 does not hold), about 10-12 us an emission. This design cuts the
// round's latency, the round's width in time, and the number of rounds:
//
// - A probe is a constant expected number of dependent loads. The walk
//   index is built once a pool, in two launches: singles_kernel reads the
//   pool once and compacts its singletons (sorted, distinct, coalesced),
//   each tile's offset from a decoupled look-back; then, S known (one host
//   read), dir_kernel reads the singletons and writes a directory of
//   2^bits + 1 u32 offsets into them over the top `bits` bits of the
//   unsigned code, bits = ceil(log2 S), so a bucket holds under one
//   singleton on average. What bounds the build: the pool read once, the
//   singletons written once and read once, the directory written once;
//   the singletons' buffer has the pool's length, since S is known only
//   after the pass. A probe loads its bucket's two bounds and compares
//   the value with the bucket's entries, kScan at once (`lookup`,
//   kmer_common.cuh): two dependent device-memory loads after the
//   code's. Repeated k-mers, deep runs of equal values in the pool, are
//   not in the index; the canonical codes' skew toward A-rich prefixes
//   makes the densest buckets about twice the mean, and a larger bucket is
//   halved first. A hash set of the singletons would save the bounds'
//   load, but its build (random inserts) is slower than these passes.
// - A round probes kSpec = 16 windows of kWin = 512 positions at t,
//   t+seg, ..., t+15*seg, speculatively, as agc_tpu's _GREEDY_SPEC loop
//   does (kmers.py:650-687), and commits them in order: window i's
//   eligible hits are those at or after D, the in-window offset of the
//   previous commit (the previous emission p = t+(i-1)*seg+D, so
//   p+seg = t+i*seg+D, whether or not the windows overlap). The first
//   window with no eligible hit ends the round, which resumes at that
//   window's end; so does `cap`. D only grows within a round, by each
//   step's distance from its start to its hit, so a round commits at
//   most about kWin over that distance: wide windows, few of them.
// - One SM keeps only so many random loads in flight, so a round's 8192
//   lookups are spread over a cluster of kCluster = 8 blocks on 8 SMs
//   (two lookups a lane, in flight together); the blocks meet at two
//   cluster barriers a round and exchange the window masks and the
//   round's end through distributed shared memory.
#include <cooperative_groups.h>

#include "kmer_common.cuh"

namespace cg = cooperative_groups;

namespace agc {
namespace {

constexpr int kCluster = 8;   // blocks (SMs) that walk one contig together
constexpr int kWarps = 16;    // warps a block
constexpr int kWalkThreads = 32 * kWarps;
constexpr int kPer = 2;       // positions a lane, their lookups in flight together
constexpr int kWarpsWin = 8;  // warps a window
constexpr int kWin = 32 * kPer * kWarpsWin;           // positions a window
constexpr int kWords = kWin / 32;                     // mask words a window
constexpr int kSpec = kCluster * kWarps / kWarpsWin;  // windows a round
constexpr int kBack = kCluster * kWalkThreads * kPer;  // positions a tail step
constexpr int kIndexThreads = 256;
constexpr int kIndexPer = 16;  // pool entries a thread of the build, strided
constexpr int kIndexTile = kIndexThreads * kIndexPer;

// The offset of a window's first hit at or after d, or -1.
__device__ __forceinline__ int first_hit(const unsigned* m, int d) {
  for (int h = d >> 5; h < kWords; ++h) {
    const unsigned x = h == (d >> 5) ? m[h] & (~0u << (d & 31)) : m[h];
    if (x) return 32 * h + __ffs(x) - 1;
  }
  return -1;
}

// dir[lo .. hi] = val for each lane's range (empty when lo > hi); every
// lane of the warp calls it: a lane writes a short range itself, the whole
// warp a long one, neighbouring lanes on neighbouring words.
__device__ __forceinline__ void dir_range(uint32_t* __restrict__ dir, int64_t lo, int64_t hi,
                                          uint32_t val, int lane) {
  const bool wide = hi - lo >= 32;
  if (!wide) {
    for (int64_t b = lo; b <= hi; ++b) dir[b] = val;
  }
  unsigned todo = __ballot_sync(0xffffffffu, wide);
  while (todo) {
    const int src = __ffs(todo) - 1;
    todo &= todo - 1;
    const int64_t l = __shfl_sync(0xffffffffu, lo, src);
    const int64_t h = __shfl_sync(0xffffffffu, hi, src);
    const uint32_t v = __shfl_sync(0xffffffffu, val, src);
    for (int64_t b = l + lane; b <= h; b += 32) dir[b] = v;
  }
}

// walk_index's one read of the pool: a block takes a tile of kIndexTile
// entries, stages it in shared memory with the entry on each side (outside
// the pool: SENTINEL, which is never a singleton), flags its singletons
// (not SENTINEL and unlike both neighbours), publishes their count,
// learns the count before it by decoupled look-back and writes them in
// order from there, neighbouring lanes on neighbouring singletons. The
// last tile writes S, the singletons' count, to total.
__global__ void __launch_bounds__(kIndexThreads)
    singles_kernel(const int64_t* __restrict__ pool, int64_t P, uint64_t* __restrict__ status,
                   int64_t* __restrict__ singles, int64_t* __restrict__ total) {
  constexpr int kWarpsIdx = kIndexThreads / 32;
  __shared__ int64_t s_pool[kIndexTile + 2];
  __shared__ int s_cnt[kIndexPer * kWarpsIdx];  // a round's warp's singletons, then their offset
  __shared__ int64_t s_look[kWarpsIdx];
  __shared__ int s_tile;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  const int64_t base = t * kIndexTile;
  {
    int64_t v[kIndexPer];  // every load in flight before the first store
#pragma unroll
    for (int r = 0; r < kIndexPer; ++r) {
      const int64_t g = base + r * kIndexThreads + threadIdx.x;
      v[r] = g < P ? pool[g] : INT64_MAX;
    }
#pragma unroll
    for (int r = 0; r < kIndexPer; ++r) s_pool[r * kIndexThreads + threadIdx.x + 1] = v[r];
  }
  if (threadIdx.x == 0) s_pool[0] = base > 0 ? pool[base - 1] : INT64_MAX;
  if (threadIdx.x == 1) {
    s_pool[kIndexTile + 1] = base + kIndexTile < P ? pool[base + kIndexTile] : INT64_MAX;
  }
  __syncthreads();
  unsigned flags = 0;  // bit r: entry base + r * kIndexThreads + threadIdx.x
#pragma unroll
  for (int r = 0; r < kIndexPer; ++r) {
    const int j = r * kIndexThreads + threadIdx.x + 1;
    const int64_t v = s_pool[j];
    const bool f = v != INT64_MAX && v != s_pool[j - 1] && v != s_pool[j + 1];
    flags |= static_cast<unsigned>(f) << r;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) s_cnt[r * kWarpsIdx + warp] = __popc(m);
  }
  __syncthreads();
  if (warp == 0) {
    // exclusive sums of the counts in (round, warp) order, kEach a lane
    constexpr int kEach = kIndexPer * kWarpsIdx / 32;
    int c[kEach], own = 0;
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      c[e] = s_cnt[lane * kEach + e];
      own += c[e];
    }
    int incl = own;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, incl, o);
      if (lane >= o) incl += y;
    }
    int run = incl - own;
#pragma unroll
    for (int e = 0; e < kEach; ++e) {
      s_cnt[lane * kEach + e] = run;
      run += c[e];
    }
    const int tile = __shfl_sync(0xffffffffu, incl, 31);
    if (lane == 0) {
      if (t > 0) store_relaxed(status + t, kFlagOwn | static_cast<uint64_t>(tile));
      s_tile = tile;
    }
  }
  __syncthreads();
  const int64_t at = t > 0 ? look_back<kIndexThreads>(status, t, s_look) : 0;
  if (threadIdx.x == 0) {
    store_relaxed(status + t, kFlagPrefix | static_cast<uint64_t>(at + s_tile));
    if (t == gridDim.x - 1) *total = at + s_tile;
  }
#pragma unroll
  for (int r = 0; r < kIndexPer; ++r) {
    const int j = r * kIndexThreads + threadIdx.x;
    const bool f = (flags >> r) & 1u;
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (f) singles[at + s_cnt[r * kWarpsIdx + warp] + __popc(m & ((1u << lane) - 1u))] =
        s_pool[j + 1];
  }
}

// dir[b] = the first singles index whose bucket is >= b, for b in
// [0, 2^bits]: thread i writes the buckets in (bucket(v[i-1]),
// bucket(v[i])] (the last, i = S, those to 2^bits).
__global__ void dir_kernel(const int64_t* __restrict__ v, int64_t S, int bits,
                           uint32_t* __restrict__ dir) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  int64_t lo = 0, hi = -1;
  if (i <= S) {
    lo = i > 0 ? static_cast<int64_t>(bucket_of(v[i - 1], bits)) + 1 : 0;
    hi = i < S ? static_cast<int64_t>(bucket_of(v[i], bits)) : (1ll << bits);
  }
  dir_range(dir, lo, hi, static_cast<uint32_t>(i), threadIdx.x & 31);
}

// One cluster of kCluster blocks a contig. Block rank 0 holds the round's
// window masks (every block stores its warps' masks there through
// distributed shared memory) and its thread 0 commits them; the round's
// end (t, count) goes back to every block the same way.
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kWalkThreads)
    greedy_walk_kernel(const int64_t* __restrict__ canon,
                       const int64_t* __restrict__ starts,
                       const int64_t* __restrict__ n_reals, Singles singles,
                       int64_t seg, int cap, int64_t* __restrict__ out) {
  // window i's hits: bit b of word h is its position 32h + b (rank 0)
  __shared__ unsigned s_mask[kSpec * kWords];
  __shared__ int64_t s_next;
  __shared__ int s_count;
  __shared__ long long s_best;
  __shared__ long long s_tail[kCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  unsigned* r0_mask = cluster.map_shared_rank(s_mask, 0);
  const int lane = threadIdx.x & 31;
  const int g = static_cast<int>(rank) * kWarps + (threadIdx.x >> 5);
  const int win = g / kWarpsWin;
  const int sub = g % kWarpsWin;
  const int64_t c = blockIdx.x / kCluster;
  const int64_t* cc = canon + starts[c];
  const int64_t n = n_reals[c];
  int64_t* o = out + c * (3 + 2 * static_cast<int64_t>(cap));
  int64_t t = 0;
  int count = 0;
  while (t < n && count < cap) {
    const int64_t w0 = t + win * seg + sub * 32 * kPer;
    int64_t v[kPer];
    bool hit[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t p = w0 + lane + 32 * j;
      v[j] = p < n ? cc[p] : INT64_MAX;
    }
    lookup(singles, v, hit);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const unsigned m = __ballot_sync(0xffffffffu, hit[j]);
      if (lane == 0) r0_mask[win * kWords + sub * kPer + j] = m;
    }
    cluster.sync();
    if (rank == 0 && threadIdx.x == 0) {
      int64_t next = t;
      int d = 0;
      for (int i = 0; i < kSpec; ++i) {
        const int64_t wi = t + i * seg;
        d = first_hit(s_mask + i * kWords, d);
        if (d < 0) {
          next = wi + kWin;
          break;
        }
        o[1 + count] = wi + d;
        ++count;
        next = wi + d + seg;
        if (count == cap) break;
      }
      for (int r = 0; r < kCluster; ++r) {
        *cluster.map_shared_rank(&s_next, r) = next;
        *cluster.map_shared_rank(&s_count, r) = count;
      }
    }
    cluster.sync();
    t = s_next;
    count = s_count;
  }
  // the emitted k-mers, read once the positions are known
  for (int64_t k = rank * kWalkThreads + threadIdx.x; k < count;
       k += kCluster * kWalkThreads) {
    o[1 + cap + k] = cc[o[1 + k]];
  }
  // rightmost hit: backward steps of kBack positions from the end
  long long tail = -1;
  for (int64_t s = n - kBack; s > -kBack; s -= kBack) {
    const int64_t off = s > 0 ? s : 0;
    if (threadIdx.x == 0) s_best = -1;
    __syncthreads();
    int64_t v[kPer];
    bool hit[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int64_t p = off + rank * kWalkThreads + threadIdx.x +
                        static_cast<int64_t>(kCluster) * kWalkThreads * j;
      v[j] = p < n ? cc[p] : INT64_MAX;
    }
    lookup(singles, v, hit);
    long long best = -1;
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (hit[j]) {
        best = off + rank * kWalkThreads + threadIdx.x +
               static_cast<int64_t>(kCluster) * kWalkThreads * j;
      }
    }
    if (best >= 0) atomicMax(&s_best, best);
    __syncthreads();
    if (threadIdx.x < kCluster) cluster.map_shared_rank(s_tail, threadIdx.x)[rank] = s_best;
    cluster.sync();
    for (int r = 0; r < kCluster; ++r) tail = s_tail[r] > tail ? s_tail[r] : tail;
    cluster.sync();  // s_tail and s_best are rewritten by the next step
    if (tail >= 0) break;
  }
  if (rank == 0 && threadIdx.x == 0) {
    o[0] = count;
    o[1 + 2 * cap] = tail >= 0 ? tail : INT64_MAX;
    o[2 + 2 * cap] = tail >= 0 ? cc[tail] : 0;
  }
}

}  // namespace
}  // namespace agc

// Pool entries a block of agc_walk_singles takes: status has
// ceil(P / agc_walk_index_tile()) words.
extern "C" int agc_walk_index_tile() { return agc::kIndexTile; }

// pool: sorted int64[P]; status: u64[ceil(P / tile)], zero; singles:
// int64[P], its first S entries written, S = *total (int64).
extern "C" int agc_walk_singles(const int64_t* pool, int64_t P, uint64_t* status,
                                int64_t* singles, int64_t* total, void* stream) {
  using namespace agc;
  const int64_t tiles = (P + kIndexTile - 1) / kIndexTile;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (tiles > 0) {
    singles_kernel<<<static_cast<unsigned>(tiles), kIndexThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(pool, P, status, singles, total);
  }
  return static_cast<int>(cudaGetLastError());
}

// singles: the S sorted singletons; dir: u32[2^bits + 1], 1 <= bits <= 30,
// S < 2^32.
extern "C" int agc_walk_dir(const int64_t* singles, int64_t S, int bits, uint32_t* dir,
                            void* stream) {
  using namespace agc;
  if (bits < 1 || bits > 30 || S < 0 || S >= (int64_t{1} << 32) - 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (S + 1 + kIndexThreads - 1) / kIndexThreads;
  dir_kernel<<<static_cast<unsigned>(blocks), kIndexThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(singles, S, bits, dir);
  return static_cast<int>(cudaGetLastError());
}

// canon: int64[N] flipped codes; starts, n_reals: int64[C]; singles, dir:
// the walk index of agc_walk_index; out: int64[C, 3 + 2 * cap], zeroed.
extern "C" int agc_greedy_walk(const int64_t* canon, const int64_t* starts,
                               const int64_t* n_reals, int64_t C,
                               const int64_t* singles, const uint32_t* dir,
                               int bits, int64_t seg, int cap, int64_t* out,
                               void* stream) {
  using namespace agc;
  if (C > 0) {
    greedy_walk_kernel<<<static_cast<unsigned>(C * kCluster), kWalkThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        canon, starts, n_reals, Singles{singles, dir, bits}, seg, cap, out);
  }
  return static_cast<int>(cudaGetLastError());
}
