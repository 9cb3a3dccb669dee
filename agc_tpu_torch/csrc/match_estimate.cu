// Approximate LZ token cost of (segment row, candidate group) pairs, the
// device estimate that ranks candidate groups before the host estimates a
// short list exactly.
//
// Replaces agc_tpu's XLA program _estimate_kernel
// (agc_tpu/ops/match.py:363-452). For each pair it probes the candidate's
// dual min/max hash-slot tables once a probe block (a strided seed key),
// counts hits cumulatively, derives the blocks covered by a seed of
// key_len symbols (q0 = key_len / stride whole blocks, then r =
// key_len % stride symbols), counts uncovered ACGT symbols as literals,
// and costs each covered run by the digits of its diagonal's jump from
// the previous run's. The result equals agc_tpu's exactly: every step is
// integer and in the same order.
//
// What bounds it on the H100: per probe block it reads the 8-byte key, the
// two 4-byte ACGT counts and two random 8-byte slot entries (a 32-byte
// sector each) of tables that, at the dispatch shape, do not fit in L2.
// As torch ops the same function is ~25 launches that materialise ten
// (P, T) int64 arrays; here one block walks one pair's probe grid in
// tiles of 256 blocks, one a thread, and keeps everything else on chip:
// a block scan of the hits and one of the packed (block, diagonal) run
// starts, each carried into the next tile, and a halo of the last q0 + 1
// prefix counts in shared memory for the coverage windows.
#include <cstdint>
#include <cuda_runtime.h>

namespace agc {
namespace match {

constexpr int kThreads = 256;  // probe blocks per tile, one a thread
constexpr int kWarps = kThreads / 32;
constexpr int kHalo = 64;  // prefix counts kept from the previous tile (>= q0 + 1)
constexpr int kPosBits = 24;
constexpr int kFpBits = 39;
constexpr uint64_t kHashMul = 0x9E3779B97F4A7C15ull;
constexpr uint64_t kFpMul = 0xC2B2AE3D27D4EB4Full;
constexpr int64_t kSlotSent = INT64_MAX;
constexpr int64_t kPosMask = (int64_t(1) << kPosBits) - 1;
constexpr int64_t kBias = int64_t(1) << 31;

__device__ __forceinline__ int digits(int32_t x) {
  return 1 + (x >= 10) + (x >= 100) + (x >= 1000) + (x >= 10000) +
         (x >= 100000) + (x >= 1000000) + (x >= 10000000);
}

// Inclusive prefix sum over the block; `sh` holds one value a warp. The
// caller synchronises before `sh` is used again.
__device__ __forceinline__ int32_t block_sum_scan(int32_t v, int32_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int32_t w = lane < kWarps ? sh[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int32_t u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kWarps) sh[lane] = w;
  }
  __syncthreads();
  return warp > 0 ? v + sh[warp - 1] : v;
}

// Inclusive prefix maximum over the block, the same way.
__device__ __forceinline__ int64_t block_max_scan(int64_t v, int64_t* sh) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int64_t u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o && u > v) v = u;
  }
  if (lane == 31) sh[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int64_t w = lane < kWarps ? sh[lane] : -1;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int64_t u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o && u > w) w = u;
    }
    if (lane < kWarps) sh[lane] = w;
  }
  __syncthreads();
  if (warp > 0 && sh[warp - 1] > v) v = sh[warp - 1];
  return v;
}

// One block a pair. keys: i64[Q, T] seed keys (-1 = invalid); a_lo, a_hi:
// i32[Q, T] ACGT counts of a block's offsets below / from r; nrun: i32[Q];
// rows, cands: i32[P]; bta, btb: i64[R, H] min / max slot tables.
__global__ void __launch_bounds__(kThreads) match_estimate_kernel(
    const int64_t* __restrict__ keys, const int32_t* __restrict__ a_lo,
    const int32_t* __restrict__ a_hi, const int32_t* __restrict__ nrun,
    const int32_t* __restrict__ rows, const int32_t* __restrict__ cands,
    const int64_t* __restrict__ bta, const int64_t* __restrict__ btb,
    int64_t T, int64_t H, int log2_h, int q0, int r, int stride,
    int64_t* __restrict__ out) {
  __shared__ int32_t cpre[kHalo + kThreads];  // prefix hit counts, halo first
  __shared__ int64_t incl[kThreads];          // inclusive run-start maxima
  __shared__ int32_t sum_sh[kWarps];
  __shared__ int64_t max_sh[kWarps];
  __shared__ int64_t red_sh[kWarps];
  const int tid = threadIdx.x;
  const int64_t row = rows[blockIdx.x];
  const int64_t* kr = keys + row * T;
  const int32_t* lo = a_lo + row * T;
  const int32_t* hi = a_hi + row * T;
  const int64_t* ta = bta + static_cast<int64_t>(cands[blockIdx.x]) * H;
  const int64_t* tb = btb + static_cast<int64_t>(cands[blockIdx.x]) * H;
  const int hash_shift = 64 - log2_h;
  for (int i = tid; i < kHalo; i += kThreads) cpre[i] = 0;  // c[t < 0] = 0
  int32_t carry_c = 0;      // hits before this tile
  int64_t carry_last = -1;  // latest run start before this tile
  int64_t acc = 0;
  __syncthreads();
  for (int64_t t0 = 0; t0 < T; t0 += kThreads) {
    const int64_t t = t0 + tid;
    const bool in = t < T;
    int32_t hit = 0, rpos = 0;
    if (in) {
      const int64_t q = kr[t];
      if (q != -1) {
        const uint64_t uq = static_cast<uint64_t>(q);
        const int64_t bkt = static_cast<int64_t>((uq * kHashMul) >> hash_shift);
        const int64_t fp = static_cast<int64_t>((uq * kFpMul) >> (64 - kFpBits));
        const int64_t ea = ta[bkt];
        const int64_t eb = tb[bkt];
        const bool ha = ea != kSlotSent && (ea >> kPosBits) == fp;
        const bool hb = eb >= 0 && (eb >> kPosBits) == fp;
        hit = ha || hb;
        rpos = ha ? static_cast<int32_t>(ea & kPosMask)
                  : (hb ? static_cast<int32_t>(eb & kPosMask) : 0);
      }
    }
    const int32_t c = carry_c + block_sum_scan(hit, sum_sh);
    cpre[kHalo + tid] = c;
    __syncthreads();
    const int32_t* cp = cpre + kHalo + tid;
    // a hit at block u covers blocks u .. u + q0 from offset r on, and
    // u .. u + q0 + 1 below offset r
    const bool cov_hi = c - cp[-q0] > 0;
    const bool cov_lo = c - cp[-q0 - 1] > 0;
    const bool prev_hi = t > 0 && cp[-1] - cp[-1 - q0] > 0;
    const bool start = in && (r ? cov_lo : cov_hi) && !prev_hi;
    const int32_t diag = rpos - static_cast<int32_t>(t * stride);
    const int64_t packed =
        start ? ((t << 32) | (static_cast<int64_t>(diag) + kBias)) : -1;
    int64_t m = block_max_scan(packed, max_sh);
    if (carry_last > m) m = carry_last;
    incl[tid] = m;
    if (in) acc += (cov_lo ? 0 : lo[t]) + (cov_hi ? 0 : hi[t]);
    __syncthreads();
    if (start) {
      const int64_t prev = tid > 0 ? incl[tid - 1] : carry_last;
      const int32_t pd =
          prev >= 0 ? static_cast<int32_t>((prev & 0xFFFFFFFFll) - kBias) : 0;
      const int32_t dd = diag >= pd ? diag - pd : pd - diag;
      acc += digits(dd) + 4;
    }
    carry_c = cpre[kHalo + kThreads - 1];
    carry_last = incl[kThreads - 1];
    __syncthreads();
    if (tid < kHalo) cpre[tid] = cpre[kThreads + tid];
    __syncthreads();
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  if ((tid & 31) == 0) red_sh[tid >> 5] = acc;
  __syncthreads();
  if (tid == 0) {
    int64_t s = nrun[row];
    for (int w = 0; w < kWarps; ++w) s += red_sh[w];
    out[blockIdx.x] = s;
  }
}

}  // namespace match
}  // namespace agc

extern "C" int agc_match_estimate_tile() { return agc::match::kThreads; }

// keys: i64[Q, T]; a_lo, a_hi: i32[Q, T]; nrun: i32[Q]; rows, cands:
// i32[P]; bta, btb: i64[R, H], H = 2^log2_h; out: i64[P].
extern "C" int agc_match_estimate(const int64_t* keys, const int32_t* a_lo,
                                  const int32_t* a_hi, const int32_t* nrun,
                                  const int32_t* rows, const int32_t* cands,
                                  const int64_t* bta, const int64_t* btb,
                                  int64_t n_pairs, int64_t T, int64_t H,
                                  int log2_h, int key_len, int stride,
                                  int64_t* out, void* stream) {
  using namespace agc::match;
  if (n_pairs <= 0) return 0;
  const int q0 = key_len / stride, r = key_len % stride;
  if (stride <= 0 || q0 + 1 > kHalo || n_pairs > INT32_MAX ||
      log2_h < 1 || log2_h > 62)
    return static_cast<int>(cudaErrorInvalidValue);
  match_estimate_kernel<<<static_cast<unsigned>(n_pairs), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      keys, a_lo, a_hi, nrun, rows, cands, bta, btb, T, H, log2_h, q0, r,
      stride, out);
  return static_cast<int>(cudaGetLastError());
}
