// Fused membership scan: nibble unpack, rolling direct k-mer code, the
// valid flag, the XOR-mix dlo ^ dhi, membership in the mix table, and hit
// compaction, for a batch of packed rows.
//
// Replaces the TPU kernel _scan_fused_kernel / scan_fused_pallas
// (agc_tpu/ops/pallas_kmers.py:232-330) together with the XLA unpack
// (_unpack4_dev) and the top_k compaction of _hits_out_vec
// (agc_tpu/ops/kmers.py:320, 339-356): it computes the whole of
// scan_batch_compact_p4.
//
// Output per row, u32 bit patterns in int32:
//   [count, pos[cap] ascending with leading fills, dlo[cap], dhi[cap]]
// count is exact; when count > cap the LAST cap hits are kept (the order
// top_k gives), so the host decoder and cap-overflow retry are shared
// with agc_tpu. Fill slots hold pos = 0xFFFFFFFF and dlo = dhi = 0.
//
// What bounds it on the H100: reading the packed rows (0.5 byte per
// position) and, per valid position, one binary search of the mix table.
// The TPU compared every position against every table entry (a VPU-shaped
// choice); here the table (at most 16384 u32 = 64 KB, above the 48 KB
// static limit, so dynamic shared memory) is sorted once per table and
// each block binary-searches its shared-memory copy: 14 probes at most.
// One thread rolls 32 consecutive positions (k-1 warm-up symbols), so the
// k-step ladder becomes one shift-or per position. Compaction is
// deterministic in three launches: per-tile hit counts, a per-row
// exclusive scan (which also writes count and the fills), and an emit
// pass that re-rolls only the tiles holding kept hits - hits are sparse,
// so the emit pass costs little.
#include "kmer_common.cuh"

namespace agc {
namespace {

__device__ __forceinline__ void load_table(uint32_t* s_tab,
                                           const uint32_t* table, int T) {
  for (int i = threadIdx.x; i < T; i += blockDim.x) s_tab[i] = table[i];
  __syncthreads();
}

// Hit bitmask of this thread's positions [p0, p0 + kPerThread).
__device__ __forceinline__ uint32_t thread_hits(const uint8_t* row, int64_t n,
                                                int k, const uint32_t* s_tab,
                                                int T, int64_t p0) {
  uint32_t bits = 0;
  if (p0 >= n) return bits;
  const uint64_t mask = kmer_mask(k);
  const int64_t s = p0 - (k - 1) > 0 ? p0 - (k - 1) : 0;
  const int64_t e = p0 + kPerThread < n ? p0 + kPerThread : n;
  DirRoll r;
  for (int64_t p = s; p < e; ++p) {
    r.push(sym_at(row, p), mask);
    if (p >= p0 && r.run >= k) {
      const uint32_t mix =
          static_cast<uint32_t>(r.dir) ^ static_cast<uint32_t>(r.dir >> 32);
      if (in_sorted_u32(s_tab, T, mix)) bits |= 1u << (p - p0);
    }
  }
  return bits;
}

__global__ void scan_count_kernel(const uint8_t* __restrict__ packed,
                                  int64_t half, int64_t n, int k,
                                  const uint32_t* __restrict__ table, int T,
                                  int32_t* __restrict__ tile_counts,
                                  int n_tiles) {
  extern __shared__ uint32_t s_tab[];
  __shared__ int s_warp[kThreads / 32];
  load_table(s_tab, table, T);
  const int64_t b = blockIdx.y;
  const uint8_t* row = packed + b * half;
  const int64_t p0 =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kPerThread;
  int c = __popc(thread_hits(row, n, k, s_tab, T, p0));
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = c;
  __syncthreads();
  if (threadIdx.x == 0) {
    int total = 0;
    for (int w = 0; w < kThreads / 32; ++w) total += s_warp[w];
    tile_counts[b * n_tiles + blockIdx.x] = total;
  }
}

__global__ void scan_offsets_kernel(const int32_t* __restrict__ tile_counts,
                                    int32_t* __restrict__ tile_offsets,
                                    int n_tiles, int32_t* __restrict__ out,
                                    int64_t stride, int cap) {
  __shared__ int32_t s_part[kThreads];
  __shared__ int32_t s_total;
  const int64_t b = blockIdx.x;
  const int32_t* tc = tile_counts + b * n_tiles;
  int32_t* to = tile_offsets + b * n_tiles;
  const int per = (n_tiles + kThreads - 1) / kThreads;
  const int t0 = threadIdx.x * per;
  const int t1 = t0 + per < n_tiles ? t0 + per : n_tiles;
  int32_t sum = 0;
  for (int t = t0; t < t1; ++t) sum += tc[t];
  s_part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int32_t acc = 0;
    for (int i = 0; i < kThreads; ++i) {
      const int32_t v = s_part[i];
      s_part[i] = acc;
      acc += v;
    }
    s_total = acc;
  }
  __syncthreads();
  int32_t acc = s_part[threadIdx.x];
  for (int t = t0; t < t1; ++t) {
    to[t] = acc;
    acc += tc[t];
  }
  const int32_t count = s_total;
  const int32_t kept = count < cap ? count : cap;
  int32_t* o = out + b * stride;
  if (threadIdx.x == 0) o[0] = count;
  for (int i = threadIdx.x; i < cap - kept; i += kThreads) {
    o[1 + i] = -1;
    o[1 + cap + i] = 0;
    o[1 + 2 * cap + i] = 0;
  }
}

__global__ void scan_emit_kernel(const uint8_t* __restrict__ packed,
                                 int64_t half, int64_t n, int k,
                                 const uint32_t* __restrict__ table, int T,
                                 const int32_t* __restrict__ tile_counts,
                                 const int32_t* __restrict__ tile_offsets,
                                 int n_tiles, int32_t* __restrict__ out,
                                 int64_t stride, int cap) {
  extern __shared__ uint32_t s_tab[];
  __shared__ int s_warp[kThreads / 32];
  const int64_t b = blockIdx.y;
  const int64_t ti = b * n_tiles + blockIdx.x;
  const int32_t tcnt = tile_counts[ti];
  int32_t* o = out + b * stride;
  const int32_t count = o[0];
  const int32_t first_kept = count - (count < cap ? count : cap);
  const int32_t base = tile_offsets[ti];
  // block-uniform early exits: no hits here, or none of them is kept
  if (tcnt == 0 || base + tcnt <= first_kept) return;
  load_table(s_tab, table, T);
  const uint8_t* row = packed + b * half;
  const int64_t p0 =
      static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x * kPerThread;
  const uint32_t bits = thread_hits(row, n, k, s_tab, T, p0);
  // exclusive scan of per-thread hit counts (threads own ascending ranges)
  const int c = __popc(bits);
  const int lane = threadIdx.x & 31;
  int incl = c;
  for (int o2 = 1; o2 < 32; o2 <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o2);
    if (lane >= o2) incl += v;
  }
  if (lane == 31) s_warp[threadIdx.x >> 5] = incl;
  __syncthreads();
  int warp_base = 0;
  for (int w = 0; w < (threadIdx.x >> 5); ++w) warp_base += s_warp[w];
  int32_t rank = base + warp_base + incl - c;
  if (bits == 0) return;
  const uint64_t mask = kmer_mask(k);
  const int64_t s = p0 - (k - 1) > 0 ? p0 - (k - 1) : 0;
  const int64_t e = p0 + kPerThread < n ? p0 + kPerThread : n;
  DirRoll r;
  for (int64_t p = s; p < e; ++p) {
    r.push(sym_at(row, p), mask);
    if (p >= p0 && ((bits >> (p - p0)) & 1u)) {
      if (rank >= first_kept) {
        const int32_t slot = cap - (count - rank);
        o[1 + slot] = static_cast<int32_t>(p);
        o[1 + cap + slot] = static_cast<int32_t>(static_cast<uint32_t>(r.dir));
        o[1 + 2 * cap + slot] =
            static_cast<int32_t>(static_cast<uint32_t>(r.dir >> 32));
      }
      ++rank;
    }
  }
}

}  // namespace
}  // namespace agc

// packed: u8[B, half] (n = 2 * half positions per row); table: sorted
// u32[T]; scratch: int32[2, B, n_tiles]; out: int32[B, 1 + 3 * cap].
extern "C" int agc_scan_fused(const uint8_t* packed, int64_t B, int64_t half,
                              int k, const uint32_t* table, int T, int cap,
                              int32_t* scratch, int32_t* out, void* stream) {
  using namespace agc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = 2 * half;
  const int n_tiles = static_cast<int>((n + kTile - 1) / kTile);
  const int64_t stride = 1 + 3 * static_cast<int64_t>(cap);
  int32_t* tile_counts = scratch;
  int32_t* tile_offsets = scratch + B * n_tiles;
  const size_t smem = static_cast<size_t>(T) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      scan_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(scan_emit_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, static_cast<unsigned>(B));
  scan_count_kernel<<<grid, kThreads, smem, st>>>(packed, half, n, k, table,
                                                   T, tile_counts, n_tiles);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_offsets_kernel<<<static_cast<unsigned>(B), kThreads, 0, st>>>(
      tile_counts, tile_offsets, n_tiles, out, stride, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_emit_kernel<<<grid, kThreads, smem, st>>>(
      packed, half, n, k, table, T, tile_counts, tile_offsets, n_tiles, out,
      stride, cap);
  return static_cast<int>(cudaGetLastError());
}
