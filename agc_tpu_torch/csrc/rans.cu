// Lane-interleaved order-0 rANS, the coder of the tpu-rans archive profile
// (agc_tpu_torch/core/entropy.py defines the bitstream): rans_encode codes
// every part of a flush in one launch, rans_compact packs the lanes' byte
// streams into one flat buffer, rans_decode decodes one blob.
//
// Replaces agc_tpu's XLA programs _encode_fn / _encode_batch_fn
// (agc_tpu/ops/device_rans.py:55-84, :142-186), reverse lax.scans over
// (steps, [B,] L) symbol grids that return every step's two emission slots
// and counts for the host to pack, and _decode_fn (:276-307), the forward
// scan whose symbol is sum(cum[1:] <= slot). The blobs are byte-equal: the
// state machine, its uint32 arithmetic and the order of its bytes are the
// same.
//
// What bounds rans_encode on the H100: each symbol is one dependent step of
// its lane's state, x = (x / f << 12) + x % f + c, after at most two renorm
// bytes. The runtime division by f is the expensive part: ~17 integer
// instructions (reciprocal, multiply-high, two corrections) for the quotient,
// two more for the remainder, ~8 for the renorm tests, shifts and table
// reads: ~27 int32 operations a symbol against 1 byte read and ~0.5 written,
// so it is bound by operations, not bytes. rans_decode has no division:
// ~10 operations a symbol, a slot table in shared memory. Both are
// sequential within a lane, so the design gives each lane one thread and
// keeps its state in a register; a lane's symbols t * L + lane are read
// (encode) and written (decode) coalesced across neighbouring lanes, and the
// 256-entry frequency and cumulative tables sit in shared memory. Encode
// writes each lane's bytes backwards from the end of a region of 2 bytes a
// step, so the region ends in the lane's stream already in decode order (the
// reversal agc_tpu's host pack does); rans_compact then copies the streams,
// one warp a lane, to offsets from a prefix sum of the lanes' counts.
#include <cstdint>
#include <cuda_runtime.h>

namespace agc {
namespace rans {

constexpr uint32_t kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;
constexpr uint32_t kXMaxBase = (kRansL >> kProbBits) << 8;  // x_max = kXMaxBase * f
constexpr int kThreads = 256;  // encode and compact: lanes are strided over the block
constexpr int kMeta = 5;       // meta row: data offset, n, lanes, first lane, region base

// Frequencies of one part into shared memory, with their exclusive prefix
// sums (cum[256] = the total). Warp 0 does it: 8 entries a thread and a
// shuffle scan of the thread sums. Every thread of the block calls it.
__device__ __forceinline__ void load_tables(const int32_t* __restrict__ fr,
                                            uint32_t* f_sh, uint32_t* c_sh) {
  if (threadIdx.x < 32) {
    const int l = threadIdx.x;
    uint32_t v[8];
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = static_cast<uint32_t>(fr[l * 8 + i]);
      sum += v[i];
    }
    uint32_t incl = sum;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
      if (l >= o) incl += u;
    }
    uint32_t run = incl - sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      f_sh[l * 8 + i] = v[i];
      c_sh[l * 8 + i] = run;
      run += v[i];
    }
    if (l == 31) c_sh[256] = run;
  }
  __syncthreads();
}

// One block a part, its threads strided over the part's lanes.
__global__ void __launch_bounds__(kThreads) rans_encode_kernel(
    const uint8_t* __restrict__ data, const int64_t* __restrict__ meta,
    const int32_t* __restrict__ freqs, uint8_t* __restrict__ region,
    int32_t* __restrict__ counts, int32_t* __restrict__ states) {
  __shared__ uint32_t f_sh[256];
  __shared__ uint32_t c_sh[257];
  const int64_t* m = meta + static_cast<int64_t>(blockIdx.x) * kMeta;
  const int64_t off = m[0], n = m[1], lane0 = m[3], base = m[4];
  const int L = static_cast<int>(m[2]);
  load_tables(freqs + static_cast<int64_t>(blockIdx.x) * 256, f_sh, c_sh);
  const int64_t cap = 2 * ((n + L - 1) / L);  // bytes a lane: at most 2 a step
  for (int lane = threadIdx.x; lane < L; lane += kThreads) {
    const int64_t steps = lane < n ? (n - lane + L - 1) / L : 0;
    const uint8_t* src = data + off + lane;
    uint8_t* end = region + base + (lane + 1) * cap;
    uint32_t x = kRansL;
    int32_t cnt = 0;
    for (int64_t t = steps - 1; t >= 0; --t) {
      const uint32_t s = src[t * L];
      const uint32_t f = f_sh[s];
      const uint32_t x_max = kXMaxBase * f;
      if (x >= x_max) {  // the renorm emits at most 2 bytes
        end[-1 - cnt++] = static_cast<uint8_t>(x);
        x >>= 8;
        if (x >= x_max) {
          end[-1 - cnt++] = static_cast<uint8_t>(x);
          x >>= 8;
        }
      }
      x = ((x / f) << kProbBits) + (x % f) + c_sh[s];
    }
    counts[lane0 + lane] = cnt;
    states[lane0 + lane] = static_cast<int32_t>(x);
  }
}

// One block a part, one warp a lane: the last counts[lane] bytes of the
// lane's region to out[lane_out[lane]...].
__global__ void __launch_bounds__(kThreads) rans_compact_kernel(
    const uint8_t* __restrict__ region, const int64_t* __restrict__ meta,
    const int32_t* __restrict__ counts, const int64_t* __restrict__ lane_out,
    uint8_t* __restrict__ out) {
  const int64_t* m = meta + static_cast<int64_t>(blockIdx.x) * kMeta;
  const int64_t n = m[1], lane0 = m[3], base = m[4];
  const int L = static_cast<int>(m[2]);
  const int64_t cap = 2 * ((n + L - 1) / L);
  const int warp = threadIdx.x >> 5, wl = threadIdx.x & 31;
  for (int lane = warp; lane < L; lane += kThreads / 32) {
    const int32_t c = counts[lane0 + lane];
    const uint8_t* src = region + base + (lane + 1) * cap - c;
    uint8_t* dst = out + lane_out[lane0 + lane];
    for (int i = wl; i < c; i += 32) dst[i] = src[i];
  }
}

// One block for a blob of L lanes, one thread a lane. lane_off: i64[L + 1]
// offsets of the lanes' streams; a read past a lane's bytes gives 0.
__global__ void __launch_bounds__(1024) rans_decode_kernel(
    const uint8_t* __restrict__ stream, const int64_t* __restrict__ lane_off,
    const int64_t* __restrict__ states, const int32_t* __restrict__ freqs,
    int64_t n, int L, uint8_t* __restrict__ out) {
  __shared__ uint32_t f_sh[256];
  __shared__ uint32_t c_sh[257];
  __shared__ uint8_t sym[kProbScale];  // slot -> symbol
  load_tables(freqs, f_sh, c_sh);
  for (int slot = threadIdx.x; slot < static_cast<int>(kProbScale); slot += blockDim.x) {
    // the number of symbols s with cum[s + 1] <= slot (agc_tpu's rank)
    int lo = 0, hi = 256;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (c_sh[mid + 1] <= static_cast<uint32_t>(slot)) lo = mid + 1; else hi = mid;
    }
    sym[slot] = static_cast<uint8_t>(lo < 255 ? lo : 255);
  }
  __syncthreads();
  const int lane = threadIdx.x;
  if (lane >= L) return;
  const uint8_t* src = stream + lane_off[lane];
  const int64_t len = lane_off[lane + 1] - lane_off[lane];
  const int64_t steps = lane < n ? (n - lane + L - 1) / L : 0;
  uint32_t x = static_cast<uint32_t>(states[lane]);
  int64_t cur = 0;
  for (int64_t t = 0; t < steps; ++t) {
    const uint32_t slot = x & (kProbScale - 1);
    const uint32_t s = sym[slot];
    out[t * L + lane] = static_cast<uint8_t>(s);
    x = f_sh[s] * (x >> kProbBits) + slot - c_sh[s];
    if (x < kRansL) {  // the renorm reads at most 2 bytes
      x = (x << 8) | (cur < len ? src[cur] : 0u);
      ++cur;
      if (x < kRansL) {
        x = (x << 8) | (cur < len ? src[cur] : 0u);
        ++cur;
      }
    }
  }
}

}  // namespace rans
}  // namespace agc

// data: u8 symbols of the flush's parts; meta: i64[P, 5] per part (data
// offset, n >= 1, lanes L, first lane, region base); freqs: i32[P, 256]
// quantized frequencies; region: u8 of 2 * ceil(n / L) bytes a lane; counts,
// states: i32 a lane.
extern "C" int agc_rans_encode(const uint8_t* data, const int64_t* meta,
                               const int32_t* freqs, int64_t n_parts,
                               uint8_t* region, int32_t* counts,
                               int32_t* states, void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  if (n_parts > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rans_encode_kernel<<<static_cast<unsigned>(n_parts), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      data, meta, freqs, region, counts, states);
  return static_cast<int>(cudaGetLastError());
}

// lane_out: i64 exclusive prefix sum of counts; out: their total in bytes.
extern "C" int agc_rans_compact(const uint8_t* region, const int64_t* meta,
                                const int32_t* counts, const int64_t* lane_out,
                                int64_t n_parts, uint8_t* out, void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  if (n_parts > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rans_compact_kernel<<<static_cast<unsigned>(n_parts), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      region, meta, counts, lane_out, out);
  return static_cast<int>(cudaGetLastError());
}

// One blob: lanes L in {1, 8, 64, 256, 1024}; states: i64[L] (u32 values);
// freqs: i32[256]; out: u8[n].
extern "C" int agc_rans_decode(const uint8_t* stream_bytes, const int64_t* lane_off,
                               const int64_t* states, const int32_t* freqs,
                               int64_t n, int lanes, uint8_t* out, void* stream) {
  using namespace agc::rans;
  if (n <= 0) return 0;
  if (lanes < 1 || lanes > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = lanes > kThreads ? lanes : kThreads;
  rans_decode_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      stream_bytes, lane_off, states, freqs, n, lanes, out);
  return static_cast<int>(cudaGetLastError());
}
