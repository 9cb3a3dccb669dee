// Approximate LZ token cost of (segment row, candidate group) pairs, the
// device estimate that ranks candidate groups before the host estimates a
// short list exactly.
//
// Replaces agc_tpu's XLA program _estimate_kernel
// (agc_tpu/ops/match.py:363-452). For each pair it probes the candidate's
// dual min/max hash-slot tables once a probe block (a strided seed key),
// finds the blocks covered by a seed of key_len symbols (q0 = key_len /
// stride whole blocks, then r = key_len % stride symbols), counts uncovered
// ACGT symbols as literals, and costs each covered run by the digits of its
// diagonal's jump from the previous run's. The result equals agc_tpu's
// exactly: every step is integer and in the same order.
//
// What bounds it on the H100: a probe is one random 16-byte slot entry of a
// candidate's table (the bank keeps a slot's min and max entries side by
// side, so one 32-byte sector), and at a whole-genome dispatch the bank's
// tables (64 MiB) exceed the 50 MB L2. Read once each, the inputs take
// ~0.03 ms; read a sector a probe from HBM, they take ten times that. So
// the design is about where the sectors come from:
//
// - the wrapper sorts a dispatch's pairs by bank row (stable, on the card)
//   and a persistent grid walks that order, a window of a few blocks an SM
//   at a time: the pairs that probe one table run together, and after the
//   first of them its sectors come from L2;
// - a thread owns 4 consecutive probe blocks of a 1024-block tile, issues
//   their 4 entry loads together, and scans them in registers. Coverage
//   needs only the index of the last hit up to a block (a hit at u covers
//   blocks u .. u + q0 - 1, and the offsets below r of u + q0), so a max-scan of
//   it replaces the prefix counts and their halo; a second max-scan carries
//   the latest (block, diagonal) run start. Each is a warp shuffle scan and
//   one block-level combine through shared memory: 2 barriers a tile of
//   1024 blocks.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace agc {
namespace match {

constexpr int kThreads = 256;
constexpr int kPer = 4;                   // probe blocks a thread, consecutive
constexpr int kTile = kThreads * kPer;    // probe blocks a tile
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQ0 = 63;                // key_len / stride at most
constexpr int kPosBits = 24;
constexpr int kFpBits = 39;
constexpr uint64_t kHashMul = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kFpMul = 0xC2B2AE3D27D4EB4Full;
constexpr int64_t kSlotSent = INT64_MAX;
constexpr int64_t kPosMask = (int64_t(1) << kPosBits) - 1;
constexpr int64_t kBias = int64_t(1) << 31;
constexpr int32_t kNoHit = -(1 << 30);  // "no hit yet": covers nothing

__device__ __forceinline__ int digits(int32_t x) {
  return 1 + (x >= 10) + (x >= 100) + (x >= 1000) + (x >= 10000) +
         (x >= 100000) + (x >= 1000000) + (x >= 10000000);
}

// Inclusive max-scan over a warp.
template <typename V>
__device__ __forceinline__ V warp_max_scan(V v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o && u > v) v = u;
  }
  return v;
}

// Persistent grid over the pairs in `order` (sorted by bank row). keys:
// i64[Q, T] seed keys (-1 = invalid); a_lo, a_hi: i32[Q, T] ACGT counts of
// a block's offsets below / from r; nrun: i32[Q]; rows, cands, order:
// i32[P]; bank: {min, max} slot entries, i64[R, H, 2].
__global__ void __launch_bounds__(kThreads) match_estimate_kernel(
    const int64_t* __restrict__ keys, const int32_t* __restrict__ a_lo,
    const int32_t* __restrict__ a_hi, const int32_t* __restrict__ nrun,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cands,
    const int32_t* __restrict__ order, const longlong2* __restrict__ bank,
    int64_t n_pairs, int64_t T, int64_t H, int log2_h, int q0, int r,
    int stride, bool vec, int64_t* __restrict__ out) {
  __shared__ int32_t hit_sh[kWarps];  // a warp's last hit block
  __shared__ int64_t run_sh[kWarps];  // a warp's latest packed run start
  __shared__ int64_t red_sh[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hash_shift = 64 - log2_h;
  for (int64_t i = blockIdx.x; i < n_pairs; i += gridDim.x) {
    const int pair = order[i];
    const int64_t row = rows[pair];
    const int64_t* kr = keys + row * T;
    const int32_t* lr = a_lo + row * T;
    const int32_t* hr = a_hi + row * T;
    const longlong2* tab = bank + static_cast<int64_t>(cands[pair]) * H;
    int32_t carry_hit = kNoHit;  // last hit block before this tile
    int64_t carry_run = -1;      // latest packed run start before this tile
    int64_t acc = 0;
    for (int64_t t0 = 0; t0 < T; t0 += kTile) {
      const int64_t tb = t0 + tid * kPer;
      int64_t q[kPer];
      int32_t lo[kPer], hi[kPer];
      if (vec && tb + kPer <= T) {
        const longlong2 k01 = *reinterpret_cast<const longlong2*>(kr + tb);
        const longlong2 k23 = *reinterpret_cast<const longlong2*>(kr + tb + 2);
        q[0] = k01.x; q[1] = k01.y; q[2] = k23.x; q[3] = k23.y;
        const int4 h4 = *reinterpret_cast<const int4*>(hr + tb);
        hi[0] = h4.x; hi[1] = h4.y; hi[2] = h4.z; hi[3] = h4.w;
        if (r) {
          const int4 l4 = *reinterpret_cast<const int4*>(lr + tb);
          lo[0] = l4.x; lo[1] = l4.y; lo[2] = l4.z; lo[3] = l4.w;
        } else {
#pragma unroll
          for (int j = 0; j < kPer; ++j) lo[j] = 0;
        }
      } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
          const bool in = tb + j < T;
          q[j] = in ? kr[tb + j] : -1;
          hi[j] = in ? hr[tb + j] : 0;
          lo[j] = in && r ? lr[tb + j] : 0;
        }
      }
      // the 4 probes: every entry load issued before any is used
      longlong2 e[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const uint64_t uq = static_cast<uint64_t>(q[j]);
        const int64_t bkt = q[j] != -1 ? static_cast<int64_t>((uq * kHashMul) >> hash_shift) : 0;
        e[j] = __ldg(tab + bkt);
      }
      bool hit[kPer];
      int32_t rpos[kPer];
      int32_t th_last = kNoHit;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int64_t fp =
            static_cast<int64_t>((static_cast<uint64_t>(q[j]) * kFpMul) >> (64 - kFpBits));
        const bool ha = q[j] != -1 && e[j].x != kSlotSent && (e[j].x >> kPosBits) == fp;
        const bool hb = q[j] != -1 && e[j].y >= 0 && (e[j].y >> kPosBits) == fp;
        hit[j] = ha || hb;
        rpos[j] = ha ? static_cast<int32_t>(e[j].x & kPosMask)
                     : (hb ? static_cast<int32_t>(e[j].y & kPosMask) : 0);
        if (hit[j]) th_last = static_cast<int32_t>(tb + j);
      }
      // last hit before this thread's first block
      const int32_t hit_incl = warp_max_scan(th_last);
      int32_t before = __shfl_up_sync(0xffffffffu, hit_incl, 1);
      if (lane == 0) before = kNoHit;
      if (lane == 31) hit_sh[warp] = hit_incl;
      __syncthreads();
      int32_t tile_hit = carry_hit;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int32_t v = hit_sh[w];
        if (w < warp && v > before) before = v;
        if (v > tile_hit) tile_hit = v;
      }
      if (carry_hit > before) before = carry_hit;
      carry_hit = tile_hit;
      // coverage, literals and run starts, in block order
      bool start[kPer];
      int32_t diag[kPer];
      int64_t th_run = -1;
      int32_t prev = before;  // last hit up to the block before
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int64_t t = tb + j;
        const int32_t t32 = static_cast<int32_t>(t);
        const int32_t last = hit[j] ? t32 : prev;
        const bool cov_hi = last > t32 - q0;
        const bool cov_lo = last >= t32 - q0;
        const bool prev_hi = prev > t32 - 1 - q0;
        const bool in = t < T;
        start[j] = in && (r ? cov_lo : cov_hi) && !prev_hi;
        diag[j] = rpos[j] - t32 * stride;
        if (in) acc += (cov_lo ? 0 : lo[j]) + (cov_hi ? 0 : hi[j]);
        if (start[j]) th_run = (t << 32) | (static_cast<int64_t>(diag[j]) + kBias);
        prev = last;
      }
      // latest run start before this thread's first block
      const int64_t run_incl = warp_max_scan(th_run);
      int64_t run_before = __shfl_up_sync(0xffffffffu, run_incl, 1);
      if (lane == 0) run_before = -1;
      if (lane == 31) run_sh[warp] = run_incl;
      __syncthreads();
      int64_t tile_run = carry_run;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int64_t v = run_sh[w];
        if (w < warp && v > run_before) run_before = v;
        if (v > tile_run) tile_run = v;
      }
      if (carry_run > run_before) run_before = carry_run;
      carry_run = tile_run;
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (!start[j]) continue;
        const int32_t pd = run_before >= 0
            ? static_cast<int32_t>((run_before & 0xFFFFFFFFll) - kBias) : 0;
        const int32_t dd = diag[j] >= pd ? diag[j] - pd : pd - diag[j];
        acc += digits(dd) + 4;
        run_before = ((tb + j) << 32) | (static_cast<int64_t>(diag[j]) + kBias);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
    if (lane == 0) red_sh[warp] = acc;
    __syncthreads();
    if (tid == 0) {
      int64_t s = nrun[row];
      for (int w = 0; w < kWarps; ++w) s += red_sh[w];
      out[pair] = s;
    }
  }
}

}  // namespace match
}  // namespace agc

extern "C" int agc_match_estimate_tile() { return agc::match::kTile; }

// keys: i64[Q, T]; a_lo, a_hi: i32[Q, T]; nrun: i32[Q]; rows, cands,
// order: i32[P] (order: the pairs sorted by cands); bank: i64[R, H, 2], H =
// 2^log2_h, 16-byte aligned; out: i64[P] in pair order. grid: the
// persistent grid's blocks.
extern "C" int agc_match_estimate(const int64_t* keys, const int32_t* a_lo,
                                  const int32_t* a_hi, const int32_t* nrun,
                                  const int32_t* rows, const int32_t* cands,
                                  const int32_t* order, const int64_t* bank,
                                  int64_t n_pairs, int64_t T, int64_t H,
                                  int log2_h, int key_len, int stride, int grid,
                                  int64_t* out, void* stream) {
  using namespace agc::match;
  if (n_pairs <= 0) return 0;
  if (stride <= 0 || grid <= 0 || n_pairs > INT32_MAX || T >= (int64_t(1) << 30) ||
      log2_h < 1 || log2_h > 62 || key_len / stride > kMaxQ0 ||
      reinterpret_cast<uintptr_t>(bank) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int q0 = key_len / stride, r = key_len % stride;
  const int64_t g = n_pairs < grid ? n_pairs : grid;
  // 16-byte loads of a thread's 4 blocks where every row starts aligned
  const bool vec = T % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(a_lo) |
       reinterpret_cast<uintptr_t>(a_hi)) % 16 == 0;
  match_estimate_kernel<<<static_cast<unsigned>(g), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, a_lo, a_hi, nrun, rows, cands, order,
      reinterpret_cast<const longlong2*>(bank), n_pairs, T, H, log2_h, q0, r,
      stride, vec, out);
  return static_cast<int>(cudaGetLastError());
}
