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
// What bounds it on the H100: the operations a position needs (the
// rolling code, the mix and one membership test), the packed input being
// 0.5 byte a position. The TPU compared every position with every table
// entry; a binary search for every valid position would cost 14 dependent
// probes at 16,384 entries, and a copy of the 64 KB table for every small
// block of positions would move more bytes than the input. Here
// kmer_common.cuh's MixSet is built once a launch and copied once a block
// of a persistent grid (one 1024-thread block an SM): a non-member costs
// two independent shared-memory loads, and only the mixes that pass the
// filter are searched, in device memory.
// The MixSet takes most of the SM's shared memory, so one block runs on
// it, and a block-wide barrier a tile would idle the SM; so each warp
// works alone, on tiles of 1024 positions: it stages a tile's packed bytes
// and the 16 before them (the warm-up) in its slice of shared memory with
// one 16-byte load a lane, loading the next tile into registers meanwhile;
// each lane takes its 32 symbols and the 32 before them as two 16-byte
// shared loads (as kmer_canon does) and runs the filter over its 32
// positions without a branch; only the positions that pass read their code
// again from the stage for the search. Compaction is deterministic in
// three launches: the persistent pass writes each tile's hit count and
// each lane's 32-bit hit mask, a per-row exclusive scan writes count and
// the fills, and a persistent emit pass stages only the tiles holding kept
// hits and reads the codes of the hits in its masks from the stage.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kScanThreads = 1024;
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kScanTile = 32 * kPerThread;      // positions a (warp) tile
constexpr int kScanStage = 16 + kScanTile / 2;  // warm-up + tile bytes

// The 16 staged bytes of chunk c of the tile at `base`: the packed bytes
// from base / 2 - 16 + 16 c, 0xFF (invalid symbols) outside the row. One
// 16-byte load where the chunk lies in the row and the row is 16-byte
// aligned (the engine's rows are), else byte by byte.
__device__ __forceinline__ uint4 fetch_chunk(const uint8_t* row, int64_t half,
                                             int64_t base, int c) {
  const int64_t at = base / 2 - 16 + 16 * c;  // a multiple of 16
  if ((reinterpret_cast<uintptr_t>(row) & 15) == 0 && at >= 0 && at + 16 <= half) {
    return __ldg(reinterpret_cast<const uint4*>(row + at));
  }
  uint32_t w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    w[q] = 0;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int64_t p = at + 4 * q + e;
      w[q] |= static_cast<uint32_t>(p >= 0 && p < half ? row[p] : 0xFF) << (8 * e);
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// A tile's 33 chunks: lane l holds chunk l, lane 0 chunk 32 too.
struct TileChunks {
  uint4 c0, c1;

  __device__ __forceinline__ void fetch(const uint8_t* packed, int64_t half,
                                        int n_tiles, int64_t w) {
    const int64_t b = w / n_tiles;
    const uint8_t* row = packed + b * half;
    const int64_t base = (w - b * n_tiles) * kScanTile;
    const int lane = threadIdx.x & 31;
    c0 = fetch_chunk(row, half, base, lane);
    if (lane == 0) c1 = fetch_chunk(row, half, base, 32);
  }

  // Into the warp's stage, once its lanes are done with the last tile.
  __device__ __forceinline__ void stage(uint8_t* s_in) const {
    const int lane = threadIdx.x & 31;
    __syncwarp();
    reinterpret_cast<uint4*>(s_in)[lane] = c0;
    if (lane == 0) reinterpret_cast<uint4*>(s_in)[32] = c1;
    __syncwarp();
  }
};

__device__ __forceinline__ uint32_t mix_of(uint64_t dir) {
  return static_cast<uint32_t>(dir) ^ static_cast<uint32_t>(dir >> 32);
}

// The positions j in [0, 32) of this thread whose window holds k valid
// symbols inside the row and whose mix passes the filter. The thread rolls
// its 32 symbols after 32 warm-up symbols, branch-free, so the filter's
// shared-memory loads of its positions overlap. Validity comes from a mask
// of the 64 symbols' invalid flags widened over k positions, so the roll
// is a shift and an OR a symbol (an invalid symbol rolls in junk bits, but
// only into windows that are not valid).
__device__ __forceinline__ uint32_t filter_thread(const uint8_t* s_in, int k,
                                                  const MixSet& set) {
  const int lane = threadIdx.x & 31;
  const uint4 prev = *reinterpret_cast<const uint4*>(s_in + 16 * lane);
  const uint4 own = *reinterpret_cast<const uint4*>(s_in + 16 * lane + 16);
  const uint32_t words[8] = {prev.x, prev.y, prev.z, prev.w,
                             own.x, own.y, own.z, own.w};
  // bit i: symbol i (nibble i, low nibble first) is above 3
  uint64_t bad = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    uint32_t x = ((words[w] >> 2) | (words[w] >> 3)) & 0x11111111u;
    x = (x | (x >> 3)) & 0x03030303u;
    x = (x | (x >> 6)) & 0x000F000Fu;
    x = (x | (x >> 12)) & 0xFFu;
    bad |= static_cast<uint64_t>(x) << (8 * w);
  }
  // bit i: an invalid symbol among symbols i - k + 1 .. i
  int width = 1;
  while (2 * width <= k) {
    bad |= bad << width;
    width *= 2;
  }
  bad |= bad << (k - width);
  const uint64_t mask = kmer_mask(k);
  uint64_t dir = 0;
  uint32_t pass = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      dir = (dir << 2) | ((words[w] >> (4 * s)) & 3u);
      if (w >= 4) pass |= static_cast<uint32_t>(set.maybe(mix_of(dir & mask))) << (8 * (w - 4) + s);
    }
  }
  return pass & ~static_cast<uint32_t>(bad >> 32);
}

// The direct code of this thread's valid window ending at position j, read
// again from the staged tile (for the few positions that need it).
__device__ __forceinline__ uint64_t dir_at(const uint8_t* s_in, int j, int k) {
  const uint8_t* mine = s_in + 16 * (threadIdx.x & 31);  // 32 warm-up + 32 own symbols
  uint64_t dir = 0;
  for (int q = 32 + j - k + 1; q <= 32 + j; ++q) {
    dir = (dir << 2) | ((mine[q >> 1] >> (4 * (q & 1))) & 3u);
  }
  return dir;
}

__global__ void __launch_bounds__(kScanThreads, 1)
    scan_count_kernel(const uint8_t* __restrict__ packed, int64_t half, int k,
                      const uint32_t* __restrict__ table, int T,
                      const uint32_t* __restrict__ image, int64_t n_work,
                      int n_tiles, int32_t* __restrict__ tile_counts,
                      uint32_t* __restrict__ masks) {
  extern __shared__ __align__(16) uint32_t smem[];
  MixSet set(smem, table, T);
  set.load(image);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t* s_in = reinterpret_cast<uint8_t*>(smem + mix_set_words(T)) + warp * kScanStage;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kScanWarps + warp;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kScanWarps;
  // the next tile's bytes are loaded into registers while this one rolls
  TileChunks next;
  if (first < n_work) next.fetch(packed, half, n_tiles, first);
  for (int64_t w = first; w < n_work; w += stride) {
    next.stage(s_in);
    if (w + stride < n_work) next.fetch(packed, half, n_tiles, w + stride);
    uint32_t bits = 0;
    for (uint32_t cand = filter_thread(s_in, k, set); cand != 0; cand &= cand - 1) {
      const int j = __ffs(cand) - 1;
      if (set.exact(mix_of(dir_at(s_in, j, k)))) bits |= 1u << j;
    }
    masks[w * 32 + lane] = bits;
    int c = __popc(bits);
    for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
    if (lane == 0) tile_counts[w] = c;
  }
}

// One block a row: the exclusive scan of the row's tile counts into its
// tile offsets, then count and the fill slots of the row's hit vector.
__global__ void __launch_bounds__(kScanThreads)
    scan_offsets_kernel(const int32_t* __restrict__ tile_counts,
                        int32_t* __restrict__ tile_offsets, int n_tiles,
                        int32_t* __restrict__ out, int64_t stride, int cap) {
  __shared__ int32_t s_warp[kScanWarps];
  __shared__ int32_t s_count;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t b = blockIdx.x;
  const int32_t* tc = tile_counts + b * n_tiles;
  int32_t* to = tile_offsets + b * n_tiles;
  const int per = (n_tiles + kScanThreads - 1) / kScanThreads;
  const int t0 = threadIdx.x * per;
  const int t1 = t0 + per < n_tiles ? t0 + per : n_tiles;
  int32_t sum = 0;
  for (int t = t0; t < t1; ++t) sum += tc[t];
  // block-wide exclusive scan of the threads' sums: lanes, then warps
  int32_t incl = sum;
  for (int o = 1; o < 32; o <<= 1) {
    const int32_t v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int32_t own = s_warp[lane];
    int32_t w_incl = own;
    for (int o = 1; o < 32; o <<= 1) {
      const int32_t v = __shfl_up_sync(0xffffffffu, w_incl, o);
      if (lane >= o) w_incl += v;
    }
    s_warp[lane] = w_incl - own;
  }
  __syncthreads();
  int32_t acc = s_warp[warp] + incl - sum;
  for (int t = t0; t < t1; ++t) {
    to[t] = acc;
    acc += tc[t];
  }
  // the thread with the row's last tile holds the row's count
  const int last = (n_tiles - 1) / per;
  int32_t* o = out + b * stride;
  if (threadIdx.x == last) o[0] = s_count = acc;
  __syncthreads();
  const int32_t count = s_count;
  const int32_t kept = count < cap ? count : cap;
  for (int i = threadIdx.x; i < cap - kept; i += kScanThreads) {
    o[1 + i] = -1;
    o[1 + cap + i] = 0;
    o[1 + 2 * cap + i] = 0;
  }
}

// Persistent too: each warp walks tiles and skips those without kept hits
// (most of them: hits are sparse).
__global__ void __launch_bounds__(kScanThreads)
    scan_emit_kernel(const uint8_t* __restrict__ packed, int64_t half, int k,
                     const int32_t* __restrict__ tile_counts,
                     const int32_t* __restrict__ tile_offsets,
                     const uint32_t* __restrict__ masks, int64_t n_work, int n_tiles,
                     int32_t* __restrict__ out, int64_t stride, int cap) {
  __shared__ __align__(16) uint8_t s_stage[kScanWarps * kScanStage];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  uint8_t* s_in = s_stage + warp * kScanStage;
  const int64_t w_stride = static_cast<int64_t>(gridDim.x) * kScanWarps;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * kScanWarps + warp; w < n_work;
       w += w_stride) {
    const int64_t b = w / n_tiles;
    const int32_t tcnt = tile_counts[w];
    int32_t* o = out + b * stride;
    const int32_t count = o[0];
    const int32_t first_kept = count - (count < cap ? count : cap);
    const int32_t base = tile_offsets[w];
    if (tcnt == 0 || base + tcnt <= first_kept) continue;
    TileChunks chunks;
    chunks.fetch(packed, half, n_tiles, w);
    chunks.stage(s_in);
    const uint32_t bits = masks[w * 32 + lane];
    // exclusive scan of the lanes' hit counts (lanes own ascending ranges)
    const int c = __popc(bits);
    int incl = c;
    for (int o2 = 1; o2 < 32; o2 <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, incl, o2);
      if (lane >= o2) incl += v;
    }
    int32_t rank = base + incl - c;
    const int64_t p0 = (w - b * n_tiles) * kScanTile + kPerThread * lane;
    for (uint32_t left = bits; left != 0; left &= left - 1, ++rank) {
      if (rank < first_kept) continue;
      const int j = __ffs(left) - 1;
      const uint64_t dir = dir_at(s_in, j, k);
      const int32_t slot = cap - (count - rank);
      o[1 + slot] = static_cast<int32_t>(p0 + j);
      o[1 + cap + slot] = static_cast<int32_t>(static_cast<uint32_t>(dir));
      o[1 + 2 * cap + slot] = static_cast<int32_t>(static_cast<uint32_t>(dir >> 32));
    }
  }
}

}  // namespace
}  // namespace agc

// Positions a tile; the wrapper sizes the scratch from it.
extern "C" int agc_scan_fused_tile() { return agc::kScanTile; }

// packed: u8[B, half] (n = 2 * half positions per row); table: sorted
// u32[T]; scratch: int32[agc_mix_set_words(T) + B * n_tiles * (2 + tile /
// 32)], 16-byte aligned (the MixSet image, tile counts, tile offsets,
// per-lane hit masks); out: int32[B, 1 + 3 * cap].
extern "C" int agc_scan_fused(const uint8_t* packed, int64_t B, int64_t half,
                              int k, const uint32_t* table, int T, int cap,
                              int32_t* scratch, int32_t* out, void* stream) {
  using namespace agc;
  if (B <= 0 || half <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n = 2 * half;
  const int n_tiles = static_cast<int>((n + kScanTile - 1) / kScanTile);
  const int64_t n_work = B * n_tiles;
  const int64_t stride = 1 + 3 * static_cast<int64_t>(cap);
  uint32_t* image = reinterpret_cast<uint32_t*>(scratch);
  int32_t* tile_counts = scratch + mix_set_words(T);
  int32_t* tile_offsets = tile_counts + n_work;
  uint32_t* masks = reinterpret_cast<uint32_t*>(tile_offsets + n_work);
  const size_t smem = static_cast<size_t>(mix_set_words(T)) * sizeof(uint32_t) +
                      kScanWarps * kScanStage;
  cudaError_t err = mix_set_build(table, T, image, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(
      scan_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scan_count_kernel,
                                                      kScanThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  // blocks of 32 warps, one tile a warp at a time
  const int64_t need = (n_work + kScanWarps - 1) / kScanWarps;
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(need < full ? need : full);
  scan_count_kernel<<<blocks, kScanThreads, smem, st>>>(
      packed, half, k, table, T, image, n_work, n_tiles, tile_counts, masks);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_offsets_kernel<<<static_cast<unsigned>(B), kScanThreads, 0, st>>>(
      tile_counts, tile_offsets, n_tiles, out, stride, cap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t emit_full = 2 * static_cast<int64_t>(sms);  // two blocks an SM
  scan_emit_kernel<<<static_cast<unsigned>(need < emit_full ? need : emit_full),
                     kScanThreads, 0, st>>>(
      packed, half, k, tile_counts, tile_offsets, masks, n_work, n_tiles, out, stride, cap);
  return static_cast<int>(cudaGetLastError());
}
