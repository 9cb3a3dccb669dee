// Membership of precomputed 32-bit XOR-mixes in a mix table:
// member[i] = mix[i] in table, for a table sorted by unsigned value.
//
// Replaces the TPU kernel _member_mix_kernel / member_mix_pallas
// (agc_tpu/ops/pallas_kmers.py:333-384), which ORs mix == table[t] over
// every table entry (its docstring speaks of a min-reduction; the code
// ORs equality, and this kernel computes what the code computes). In the
// port it is the membership stage of the large-table join
// (scan_batch_join_global_p4), the one every scan runs once a create has
// more than 8192 splitters.
//
// What bounds it on the H100: bytes, 4 in and 1 out a mix, provided a
// test costs about one probe. The TPU's compare-all loop over T entries
// is not carried over, and a binary search for every mix would cost
// log2(T) dependent probes (15 at 32,768 entries). Nearly every mix is no
// member (a splitter occurs about once in 60 kbases), so kmer_common.cuh's MixSet
// rejects it with two independent shared-memory loads of a 2^20-bit
// filter, and only the mixes that pass (true members and ~0.2% of the
// rest at 32,768 entries) are searched, in their bucket of the table's
// top-bits directory, in device memory that L2 holds. The MixSet is built
// once a launch by a grid (mix_set_build; building it in every block, with
// shared-memory atomics, was slower); a persistent grid
// (one 1024-thread block an SM) copies it and walks the mixes: each lane
// has four 16-byte loads of four mixes in flight (a scalar head and tail
// where the pointer or n is not 16-byte aligned) and writes each four
// flags as one 4-byte store. The candidates of a warp step are searched
// together: compacted into a per-warp queue, one search a lane, so a warp
// pays one search's latency however many of its 128 mixes pass (no slower
// than each lane searching its own at 32,768 entries, faster at 131,072).
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kMixThreads = 1024;
constexpr int kMixWarps = kMixThreads / 32;
constexpr int kVecs = 4;        // 16-byte loads a lane has in flight
constexpr int kQueue = 4 * 32;  // the mixes of one warp step

// A warp's candidates: their mixes, their slots (lane * 4 + word) and the
// flags found for its 32 lanes.
struct WarpQueue {
  uint32_t mix[kQueue];
  uint32_t res[32];
  uint8_t slot[kQueue];
};

__device__ __forceinline__ uint32_t word_of(const uint4& m, int s) {
  return s == 0 ? m.x : (s == 1 ? m.y : (s == 2 ? m.z : m.w));
}

// Flags (one byte each, 0 or 1) of this lane's four mixes `m`, whose
// filter passes are the bits of `c`. Every lane of the warp calls it.
__device__ __forceinline__ uint32_t resolve(WarpQueue& q, const MixSet& set,
                                            const uint4& m, uint32_t c) {
  if (!__any_sync(0xffffffffu, c != 0)) return 0;
  const int lane = threadIdx.x & 31;
  const int cnt = __popc(c);
  int incl = cnt;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  const int total = __shfl_sync(0xffffffffu, incl, 31);
  int at = incl - cnt;
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    if ((c >> s) & 1u) {
      q.mix[at] = word_of(m, s);
      q.slot[at] = static_cast<uint8_t>(4 * lane + s);
      ++at;
    }
  }
  q.res[lane] = 0;
  __syncwarp();
  for (int i = lane; i < total; i += 32) {
    if (set.exact(q.mix[i])) {
      const int slot = q.slot[i];
      atomicOr(&q.res[slot >> 2], 1u << (8 * (slot & 3)));
    }
  }
  __syncwarp();
  const uint32_t r = q.res[lane];
  __syncwarp();  // the queue is free for the next step
  return r;
}

__global__ void __launch_bounds__(kMixThreads, 1)
    member_mix_kernel(const uint32_t* __restrict__ mix, int64_t n, int64_t head,
                      const uint32_t* __restrict__ table, int T,
                      const uint32_t* __restrict__ image,
                      uint8_t* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t smem[];
  MixSet set(smem, table, T);
  set.load(image);
  WarpQueue& q = reinterpret_cast<WarpQueue*>(smem + mix_set_words(T))[threadIdx.x >> 5];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kMixThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kMixThreads + threadIdx.x;
  // the body: 16-byte words from mix + head; the scalar head and tail
  const int64_t n_vec = (n - head) / 4;
  const int64_t tail = head + 4 * n_vec;
  if (tid < head) out[tid] = set.contains(mix[tid]);
  if (tid < n - tail) out[tail + tid] = set.contains(mix[tail + tid]);
  const uint4* vec = reinterpret_cast<const uint4*>(mix + head);
  uint8_t* obody = out + head;
  const bool out_aligned = (reinterpret_cast<uintptr_t>(obody) & 3) == 0;
  // warp-uniform trip count: the queue needs every lane of the warp
  const int lane = threadIdx.x & 31;
  for (int64_t j0 = tid - lane; j0 < n_vec; j0 += kVecs * stride) {
    uint4 m[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t j = j0 + u * stride + lane;
      m[u] = j < n_vec ? __ldcs(vec + j) : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int64_t j = j0 + u * stride + lane;
      const bool live = j < n_vec;
      uint32_t c = 0;
      if (live) {
#pragma unroll
        for (int s = 0; s < 4; ++s) c |= static_cast<uint32_t>(set.maybe(word_of(m[u], s))) << s;
      }
      const uint32_t r = resolve(q, set, m[u], c);
      if (!live) continue;
      if (out_aligned) {
        __stcs(reinterpret_cast<unsigned int*>(obody + 4 * j), r);
      } else {
#pragma unroll
        for (int s = 0; s < 4; ++s) obody[4 * j + s] = static_cast<uint8_t>(r >> (8 * s));
      }
    }
  }
}

// Adds entries i in [0, T] of the table to a MixSet image whose filter
// words are zero: the directory entries that entry i opens (the buckets
// after its predecessor's, up to its own; T closes the rest) and, for
// i < T, its two filter bits. Its time grows with T (chip_smoke.py times
// it apart); blocks that each own a slice of the filter and set it with
// shared-memory atomics were no faster, with 4-byte or 16-byte loads of
// the table.
__global__ void mix_set_build_kernel(const uint32_t* __restrict__ table, int T,
                                     uint32_t* __restrict__ image) {
  int32_t* dir = reinterpret_cast<int32_t*>(image + kMixFilterWords);
  const int shift = 32 - mix_dir_bits(T);
  const int64_t n_buckets = int64_t{1} << (32 - shift);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i <= T;
       i += stride) {
    const int64_t from = i > 0 ? static_cast<int64_t>(__ldg(table + i - 1) >> shift) + 1 : 0;
    const uint32_t v = i < T ? __ldg(table + i) : 0u;
    const int64_t to = i < T ? static_cast<int64_t>(v >> shift) : n_buckets;
    for (int64_t b = from; b <= to; ++b) dir[b] = static_cast<int32_t>(i);
    if (i < T) {
      const uint32_t h1 = mix_hash(v, kMixC1);
      const uint32_t h2 = mix_hash(v, kMixC2);
      atomicOr(image + (h1 >> 5), 1u << (h1 & 31));
      atomicOr(image + (h2 >> 5), 1u << (h2 & 31));
    }
  }
}

// One block loads the image into shared memory and writes back what it
// holds: the filter's words and the directory.
__global__ void __launch_bounds__(kMixThreads, 1)
    mix_set_debug_kernel(const uint32_t* __restrict__ table, int T,
                         const uint32_t* __restrict__ image,
                         uint32_t* __restrict__ bits, int32_t* __restrict__ dir) {
  extern __shared__ __align__(16) uint32_t smem[];
  MixSet set(smem, table, T);
  set.load(image);
  for (int i = threadIdx.x; i < kMixFilterWords; i += kMixThreads) bits[i] = set.bits[i];
  const int n_dir = (1 << mix_dir_bits(T)) + 1;
  for (int i = threadIdx.x; i < n_dir; i += kMixThreads) dir[i] = set.dir[i];
}

}  // namespace

cudaError_t mix_set_build(const uint32_t* table, int T, uint32_t* image, cudaStream_t st) {
  cudaError_t err = cudaMemsetAsync(image, 0, kMixFilterWords * sizeof(uint32_t), st);
  if (err != cudaSuccess) return err;
  constexpr int kBuildThreads = 256;
  const int64_t need = (static_cast<int64_t>(T) + kBuildThreads) / kBuildThreads;
  const unsigned blocks = static_cast<unsigned>(need < 4096 ? need : 4096);
  mix_set_build_kernel<<<blocks, kBuildThreads, 0, st>>>(table, T, image);
  return cudaGetLastError();
}

}  // namespace agc

// u32 words of the MixSet image of a T-entry table (the scratch that
// agc_member_mix and agc_mix_set_debug take), and its directory bits.
extern "C" int agc_mix_set_words(int64_t T) { return agc::mix_set_words(T); }
extern "C" int agc_mix_dir_bits(int64_t T) { return agc::mix_dir_bits(T); }

// mix: u32[n], 4-byte aligned; table: u32[T] sorted by unsigned value,
// 1 <= T < 2^31; image: u32[agc_mix_set_words(T)], 16-byte aligned
// scratch; out: u8[n] (0/1).
extern "C" int agc_member_mix(const uint32_t* mix, int64_t n,
                              const uint32_t* table, int T, uint32_t* image,
                              uint8_t* out, void* stream) {
  using namespace agc;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = mix_set_build(table, T, image, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(mix_set_words(T)) * sizeof(uint32_t) +
                      kMixWarps * sizeof(WarpQueue);
  err = cudaFuncSetAttribute(member_mix_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, member_mix_kernel,
                                                      kMixThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  // elements before the first 16-byte boundary (mix is 4-byte aligned)
  const int64_t head_max = ((16 - (reinterpret_cast<uintptr_t>(mix) & 15)) & 15) / 4;
  const int64_t head = head_max < n ? head_max : n;
  const int64_t need = ((n - head) / 4 + kMixThreads - 1) / kMixThreads;
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(need < 1 ? 1 : (need < full ? need : full));
  member_mix_kernel<<<blocks, kMixThreads, smem, st>>>(mix, n, head, table, T, image, out);
  return static_cast<int>(cudaGetLastError());
}

// Builds the MixSet of table u32[T] into image (as agc_member_mix does),
// then one block loads it and writes its filter words into bits
// u32[2^15] and its directory into dir int32[2^d + 1], d =
// agc_mix_dir_bits(T).
extern "C" int agc_mix_set_debug(const uint32_t* table, int T, uint32_t* image,
                                 uint32_t* bits, int32_t* dir, void* stream) {
  using namespace agc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = mix_set_build(table, T, image, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(mix_set_words(T)) * sizeof(uint32_t);
  err = cudaFuncSetAttribute(mix_set_debug_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  mix_set_debug_kernel<<<1, kMixThreads, smem, st>>>(table, T, image, bits, dir);
  return static_cast<int>(cudaGetLastError());
}
