// Greedy singleton splitter walk over a sorted k-mer pool, one block per
// contig.
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
// What bounds it on the H100: latency. Each step is a window of 256
// positions probed in parallel, one thread each, by a binary search of
// the pool in device memory (26 dependent loads for a 64 M pool); a
// ballot picks the first (or, for the tail, last) hit of the window.
// Singleton hits are dense in real references, so nearly every step
// emits; one contig occupies one SM, so many-contig references fill the
// card and a single chromosome is a latency-bound walk of about
// length / seg steps.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kWindow = kThreads;

__device__ __forceinline__ bool pool_singleton(const int64_t* __restrict__ pool,
                                               int64_t P, int64_t v) {
  if (v == INT64_MAX) return false;
  int64_t lo = 0, hi = P;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (pool[mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  if (lo >= P || pool[lo] != v) return false;
  return lo + 1 >= P || pool[lo + 1] != v;
}

// Index (0..kWindow-1) of the first (last=false) or last (last=true)
// thread whose flag is set, or -1; block-uniform result.
__device__ __forceinline__ int block_pick(bool flag, bool last,
                                          unsigned* s_mask, int* s_pick) {
  const unsigned m = __ballot_sync(0xffffffffu, flag);
  if ((threadIdx.x & 31) == 0) s_mask[threadIdx.x >> 5] = m;
  __syncthreads();
  if (threadIdx.x == 0) {
    int pick = -1;
    constexpr int nw = kWindow / 32;
    for (int i = 0; i < nw; ++i) {
      const int w = last ? nw - 1 - i : i;
      const unsigned mw = s_mask[w];
      if (mw) {
        pick = w * 32 + (last ? 31 - __clz(mw) : __ffs(mw) - 1);
        break;
      }
    }
    *s_pick = pick;
  }
  __syncthreads();
  const int pick = *s_pick;
  __syncthreads();  // s_mask / s_pick are reused by the next call
  return pick;
}

__global__ void greedy_walk_kernel(const int64_t* __restrict__ canon,
                                   const int64_t* __restrict__ starts,
                                   const int64_t* __restrict__ n_reals,
                                   const int64_t* __restrict__ pool, int64_t P,
                                   int64_t seg, int cap,
                                   int64_t* __restrict__ out) {
  __shared__ unsigned s_mask[kWindow / 32];
  __shared__ int s_pick;
  const int64_t c = blockIdx.x;
  const int64_t* cc = canon + starts[c];
  const int64_t n = n_reals[c];
  int64_t* o = out + c * (3 + 2 * static_cast<int64_t>(cap));
  int64_t t = 0;
  int count = 0;
  while (t < n && count < cap) {
    const int64_t p = t + threadIdx.x;
    const int64_t v = p < n ? cc[p] : INT64_MAX;
    const bool hit = p < n && pool_singleton(pool, P, v);
    const int pick = block_pick(hit, false, s_mask, &s_pick);
    if (pick >= 0) {
      if (static_cast<int>(threadIdx.x) == pick) {
        o[1 + count] = p;
        o[1 + cap + count] = v;
      }
      ++count;
      t = t + pick + seg;
    } else {
      t += kWindow;
    }
  }
  // rightmost hit: backward windows from the end
  bool found = false;
  for (int64_t s = n - kWindow; s > -kWindow; s -= kWindow) {
    const int64_t off = s > 0 ? s : 0;
    const int64_t p = off + threadIdx.x;
    const int64_t v = p < n ? cc[p] : INT64_MAX;
    const bool hit = p < n && pool_singleton(pool, P, v);
    const int pick = block_pick(hit, true, s_mask, &s_pick);
    if (pick >= 0) {
      if (static_cast<int>(threadIdx.x) == pick) {
        o[1 + 2 * cap] = p;
        o[2 + 2 * cap] = v;
      }
      found = true;
      break;
    }
  }
  if (threadIdx.x == 0) {
    o[0] = count;
    if (!found) {
      o[1 + 2 * cap] = INT64_MAX;
      o[2 + 2 * cap] = 0;
    }
  }
}

}  // namespace
}  // namespace agc

// canon: int64[N] flipped codes; starts, n_reals: int64[C]; pool: sorted
// int64[P]; out: int64[C, 3 + 2 * cap].
extern "C" int agc_greedy_walk(const int64_t* canon, const int64_t* starts,
                               const int64_t* n_reals, int64_t C,
                               const int64_t* pool, int64_t P, int64_t seg,
                               int cap, int64_t* out,
                               void* stream) {
  using namespace agc;
  if (C > 0) {
    greedy_walk_kernel<<<static_cast<unsigned>(C), kWindow, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        canon, starts, n_reals, pool, P, seg, cap, out);
  }
  return static_cast<int>(cudaGetLastError());
}
