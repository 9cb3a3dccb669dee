// Lane-interleaved order-0 rANS, the coder of the tpu-rans archive profile
// (agc_tpu_torch/core/entropy.py defines the bitstream). A store flush is
// coded by four kernels: rans_tables (each part's symbol counts and
// quantized frequencies, and the encoder's per-symbol reciprocals),
// rans_encode (every lane of every part: its byte count and final state),
// rans_layout (each part's blob size, raw or coded, and the blobs' and the
// lanes' offsets, by one device-wide scan) and rans_write (each part's
// whole blob, or its raw escape, at its offset); rans_decode decodes a
// batch of blobs in one launch. Nothing of a flush goes back to the host between them: the output
// buffer is sized from the flush's shapes, which bound its blobs.
//
// Replaces agc_tpu's XLA programs _encode_fn / _encode_batch_fn
// (agc_tpu/ops/device_rans.py:55-84, :142-186), reverse lax.scans over
// (steps, [B,] L) symbol grids that return every step's two emission slots
// and counts for the host to pack, the host work around them (per-part
// counts and entropy.quantize_freqs, :242; _pack_part_streams and
// assemble_blob, :189, :266), and _decode_fn (:276-307), the forward scan
// whose symbol is sum(cum[1:] <= slot). The blobs are byte-equal: the
// tables follow quantize_freqs' integer rule exactly, and the state
// machine, its uint32 arithmetic and the order of its bytes are the same.
//
// What bounds a flush on the H100: each symbol is one dependent step of its
// lane's state, x = (x / f << 12) + x % f + c, after at most two renorm
// bytes. The division is a multiply-high by a reciprocal and a shift
// (ryg_rans' RansEncSymbol, exact for a 12-bit scale and x < 2^31),
// computed once a symbol of a part by rans_tables: ~12 int32 operations a
// symbol against 1 byte read, so the state machine is bound by operations,
// and by its longest lane (n / 1024 steps of a large part), whose symbols
// and table entries are loaded a batch ahead of the state chain. Storing
// the bytes is what costs: a lane's stream is scattered single bytes, and
// where it goes is known only once every lane's count is. So rans_encode
// stores nothing; rans_write runs the coded parts' lanes again, each
// writing its stream backwards in place in its blob, whole 8-byte words
// where the words are its own. A part that is stored raw (random bytes:
// the reference parts of a whole-genome create) is never run twice, and
// its payload is copied as 16-byte words: aligned loads of the source,
// shifted to the destination's alignment across two words, aligned stores;
// only the ragged ends go byte by byte. A flush of raw escapes is bound by
// its bytes, read once and written once.
//
// The parts' sizes run from 1 byte to megabytes, so no kernel gives a large
// part to one block: rans_tables reads every 64 KB chunk of a part in a
// block of its own into a shared-memory histogram with a private column a
// lane (conflict-free atomics), and the part's counts go to scratch (added
// up over a larger part's chunks); a second launch takes a part a warp,
// empties its counts and ranks by a bitonic sort of the 256 (key, symbol)
// pairs, 8 a lane. The state machine
// gives a block 256 lanes of a large part, a warp an 8- or 64-lane part, a
// thread a 1-lane part, 256 to a block; rans_layout and rans_write's coded
// heads take a part a warp, and rans_write's raw payloads a 64 KB chunk a
// block. rans_decode has no division: ~10 operations a symbol, one thread
// a lane, lanes independent, so its schedule (_decode_rows in
// ops/device_rans.py) gives a block 256 lanes of a 256- or 1024-lane blob,
// or packs up to 8 smaller blobs of one tier into a block. A blob's
// symbol comes from its slot table in shared memory (4096 bytes, filled
// from the cumulative frequencies, 16 slots a thread, a search only where
// a symbol's range ends).
//
// Scratch that rans_tables and rans_layout are given is zero when they
// start and zero again when they end (the block that consumes a value
// resets it), so the wrapper keeps one buffer a stream and no memset runs.
// Only rans_layout's look-back waits on other blocks, and only on tiles of
// lower index, which start first (as in CUB's single-pass scans); what it
// waits for depends on the part count alone, never on the data.
//
// The chunk list that rans_tables and rans_write take is checked on the
// card, entry by entry (chunk_ok): a list that is not _prepare's leaves a
// table of zeros, which makes rans_layout size the blobs past any buffer,
// or makes rans_write set blob_off[P] to -1; either way nothing hangs, the
// scratch is left zero and the download raises.
#include <cstdint>
#include <cuda_runtime.h>

namespace agc {
namespace rans {

constexpr uint32_t kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;
constexpr int kXMaxShift = 19;  // x_max = ((kRansL >> kProbBits) << 8) * f = f << 19
constexpr int kThreads = 256;   // threads a block of every kernel
constexpr int kWarps = kThreads / 32;
constexpr int kMeta = 4;        // meta row: data offset, n, lanes, first lane
constexpr int kMaxLanes = 1024;
constexpr int kLaneRows = kMaxLanes / 32;  // a warp's passes over a part's lanes
constexpr int64_t kChunk = 1 << 16;  // bytes of a part a histogram or raw-copy block
constexpr int kAhead = 16;  // symbols a lane loads ahead of its state chain
constexpr uint8_t kMagic = 0xA9;
constexpr uint8_t kRawFlag = 0x80;
constexpr unsigned kAll = 0xffffffffu;
// encode work rows (kind, first index into sel, parts)
constexpr int kBlockPart = 0;  // 256 lanes of a part of 256 or 1024 lanes a block
constexpr int kWarpPart = 1;   // up to 8 parts of 8 or 64 lanes, one a warp
constexpr int kLanePart = 2;   // up to 256 parts of 1 lane, one a thread

__device__ __forceinline__ int varint_len(uint64_t v) {
  int n = 1;
  while (v >= 0x80) {
    v >>= 7;
    ++n;
  }
  return n;
}

__device__ __forceinline__ int put_varint(uint8_t* out, uint64_t v) {
  int n = 0;
  while (v >= 0x80) {
    out[n++] = static_cast<uint8_t>(v | 0x80);
    v >>= 7;
  }
  out[n++] = static_cast<uint8_t>(v);
  return n;
}

template <typename V>
__device__ __forceinline__ V warp_sum(V v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kAll, v, o);
  return v;
}

// Inclusive prefix sum of v over the warp's lanes.
template <typename V>
__device__ __forceinline__ V warp_incl_scan(V v) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V u = __shfl_up_sync(kAll, v, o);
    if (lane >= o) v += u;
  }
  return v;
}

// The 8 int32 values at p (32-byte aligned).
__device__ __forceinline__ void load8(const int32_t* p, int32_t v[8]) {
  const int4 a = reinterpret_cast<const int4*>(p)[0];
  const int4 b = reinterpret_cast<const int4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// ---------------------------------------------------------------------------
// rans_tables: a block a chunk, then a warp a part
// ---------------------------------------------------------------------------

// Loads and stores other blocks see while a kernel runs (rans_layout's look-back).
__device__ __forceinline__ uint64_t load_relaxed(const uint64_t* p) {
  uint64_t v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_relaxed(uint64_t* p, uint64_t v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

// ceil(2^(shift + 31) / f) for f in [2, 4096], 2^(shift - 1) < f <= 2^shift
// (ryg_rans' reciprocal, < 2^32), computed when the kernels are compiled.
struct RcpTable {
  uint32_t v[kProbScale + 1];
};

constexpr RcpTable make_rcp_table() {
  RcpTable t{};
  for (uint32_t f = 2; f <= kProbScale; ++f) {
    uint32_t shift = 0;
    while ((1u << shift) < f) ++shift;
    t.v[f] = static_cast<uint32_t>(((uint64_t(1) << (shift + 31)) + f - 1) / f);
  }
  return t;
}

__device__ const RcpTable kRcp = make_rcp_table();

// enc entry of a symbol: .x the reciprocal, .y bias | shift << 13 | f << 17
// (bias = start, + 4095 for f = 1; bias < 2^13, shift < 2^4, f <= 2^12).
__device__ __forceinline__ uint2 enc_entry(uint32_t f, uint32_t start) {
  if (f == 0) return make_uint2(0, 0);
  if (f == 1) return make_uint2(0xFFFFFFFFu, (start + kProbScale - 1) | (1u << 17));
  const uint32_t shift = 32 - __clz(f - 1);  // 2^(shift - 1) < f <= 2^shift
  return make_uint2(kRcp.v[f], start | ((shift - 1) << 13) | (f << 17));
}

// Ascending bitonic sort of the warp's 256 keys, key[j] of lane l at
// position 8 l + j: strides below 8 swap inside a lane, the others trade
// with lane l ^ (stride / 8).
template <typename K>
__device__ __forceinline__ void warp_sort256(K key[8]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int lk = 1; lk <= 8; ++lk) {
    const int k = 1 << lk;
#pragma unroll
    for (int ls = lk - 1; ls >= 0; --ls) {
      const int st = 1 << ls;
      if (st >= 8) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const K o = __shfl_xor_sync(kAll, key[j], st >> 3);
          const int i = 8 * lane + j;
          const bool keep_min = ((i & st) == 0) == ((i & k) == 0);
          key[j] = keep_min ? (o < key[j] ? o : key[j]) : (o > key[j] ? o : key[j]);
        }
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if ((j & st) == 0) {
            const K a = key[j], b = key[j | st];
            const bool swap = ((8 * lane + j) & k) == 0 ? a > b : a < b;
            key[j] = swap ? b : a;
            key[j | st] = swap ? a : b;
          }
        }
      }
    }
  }
}

// quantize_freqs of one part (counts c8, total n) by one warp, lane l
// holding symbols 8 l .. 8 l + 7: q = c * 4096 // n, every present symbol at
// least 1; for diff = 4096 - sum(q) > 0 each of the m present symbols gets
// diff // m and the first diff % m by (-rem, symbol) one more; for diff < 0,
// passes of -1 over (rem, symbol), each over the symbols with q > 1: pass k
// takes from those with q > k, so K - 1 whole passes take min(q - 1, K - 1)
// from each and pass K one from the first of those with q > K, K the least
// pass whose running total reaches -diff (at most the part's largest q).
// Ranks come from warp_sort256 of (rem, symbol) keys; d_sh (256 ints of
// shared memory) marks the symbols ranked first. X: the integer type of
// c * 4096, rem and the keys, uint32_t for n < 2^20 (a quarter of the
// 64-bit divisions' work, half the shuffles). Writes the part's
// frequencies and enc table.
template <typename X>
__device__ __forceinline__ void quantize_warp(const uint32_t c8[8], int64_t n, int32_t* d_sh,
                                              int32_t* __restrict__ fr,
                                              uint2* __restrict__ en) {
  constexpr X kTop = (X(1) << (sizeof(X) == 4 ? 23 : 55)) - 1;  // above any rem
  const int lane = threadIdx.x & 31;
  const X total = static_cast<X>(n);
  uint32_t q[8];
  X rem[8];
  int32_t qsum = 0, n_present = 0;
  uint32_t q_max = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const X c = c8[j];
    const X x = c * kProbScale;
    const X qj = x / total;
    rem[j] = x - qj * total;
    q[j] = c > 0 && qj == 0 ? 1u : static_cast<uint32_t>(qj);
    qsum += static_cast<int32_t>(q[j]);
    n_present += c > 0;
    q_max = q[j] > q_max ? q[j] : q_max;
  }
  const int32_t diff = static_cast<int32_t>(kProbScale) - warp_sum(qsum);
  if (diff != 0) {  // warp-uniform
    X key[8];
    int32_t K = 0, first = 0;  // the last -1 pass; how many ranked first get one more
    if (diff > 0) {
      n_present = warp_sum(n_present);
      first = diff % n_present;
#pragma unroll
      for (int j = 0; j < 8; ++j)  // (-rem, symbol) ascending
        key[j] = c8[j] > 0 ? ((kTop - rem[j]) << 8) | X(8 * lane + j) : ~X(0);
    } else {
      const int32_t need = -diff;
      for (int o = 16; o > 0; o >>= 1) {
        const uint32_t u = __shfl_xor_sync(kAll, q_max, o);
        q_max = u > q_max ? u : q_max;
      }
      auto taken = [&](int32_t k) {  // decrements in passes 1 .. k
        int32_t t = 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int32_t qu = static_cast<int32_t>(q[j]) - 1;
          t += qu < 0 ? 0 : (qu < k ? qu : k);
        }
        return warp_sum(t);
      };
      int32_t lo = 1, hi = static_cast<int32_t>(q_max);
      while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (taken(mid) >= need) hi = mid; else lo = mid + 1;
      }
      K = lo;
      first = need - taken(K - 1);
#pragma unroll
      for (int j = 0; j < 8; ++j)  // (rem, symbol) ascending
        key[j] = q[j] > static_cast<uint32_t>(K) ? (rem[j] << 8) | X(8 * lane + j) : ~X(0);
    }
    warp_sort256(key);
#pragma unroll
    for (int j = 0; j < 8; ++j) d_sh[8 * lane + j] = 0;
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (8 * lane + j < first) d_sh[key[j] & 0xFF] = 1;  // ranked keys are real symbols
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t more = static_cast<uint32_t>(d_sh[8 * lane + j]);
      if (diff > 0) {
        if (c8[j] > 0) q[j] += diff / n_present + more;
      } else {
        if (q[j] >= 1) q[j] -= min(q[j] - 1, static_cast<uint32_t>(K - 1));
        q[j] -= more;
      }
    }
  }
  uint32_t sum = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) sum += q[j];
  uint32_t start = warp_incl_scan(sum) - sum;
  int4* f4 = reinterpret_cast<int4*>(fr + 8 * lane);
  f4[0] = make_int4(q[0], q[1], q[2], q[3]);
  f4[1] = make_int4(q[4], q[5], q[6], q[7]);
  uint2 e[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    e[j] = enc_entry(q[j], start);
    start += q[j];
  }
  uint4* e4 = reinterpret_cast<uint4*>(en + 8 * lane);
#pragma unroll
  for (int j = 0; j < 4; ++j)
    e4[j] = make_uint4(e[2 * j].x, e[2 * j].y, e[2 * j + 1].x, e[2 * j + 1].y);
}

// Whether entry c = (p, start) of a chunk list is where _prepare puts it:
// (0, 0) first, then each entry the successor of the one before (the next
// 64 KB of its part, or the next part's first), the last entry the last
// part's last chunk. A list whose every entry passes is _prepare's. p is
// checked against n_parts before meta is read.
__device__ __forceinline__ bool chunk_ok(const int64_t* __restrict__ chunks, int64_t c,
                                         int64_t n_chunks, const int64_t* __restrict__ meta,
                                         int64_t n_parts, int64_t p, int64_t start) {
  if (p < 0 || p >= n_parts || start < 0 || start % kChunk != 0) return false;
  const int64_t n = meta[p * kMeta + 1];
  bool ok = start < n;
  if (c == 0) {
    ok = ok && p == 0 && start == 0;
  } else {
    const int64_t q = chunks[2 * (c - 1)], s = chunks[2 * (c - 1) + 1];
    if (start > 0) {
      ok = ok && q == p && s == start - kChunk;
    } else {  // the previous part's last chunk
      ok = ok && p > 0 && q == p - 1 && s >= 0 && s % kChunk == 0 &&
           s < meta[q * kMeta + 1] && s + kChunk >= meta[q * kMeta + 1];
    }
  }
  if (c == n_chunks - 1) ok = ok && p == n_parts - 1 && start + kChunk >= n;
  return ok;
}

// A chunk of a part (kChunk bytes at most) a block: its bytes into a
// histogram in shared memory with a private column a lane, so that a
// warp's 32 atomics hit 32 banks, then the chunk's counts to the part's row
// of counts (stored by a part's only chunk, added by each of a larger
// part's). A chunk entry that is not _prepare's marks its part and the
// previous entry's part (where they are parts) invalid, and counts nothing.
// scratch: u32[P * 256] counts, then u32[P] marks; zero when the launch
// starts, emptied again by rans_quantize_kernel.
__global__ void __launch_bounds__(kThreads, 6) rans_hist_kernel(
    const uint8_t* __restrict__ data, int64_t n_data, const int64_t* __restrict__ meta,
    const int64_t* __restrict__ chunks, int64_t n_chunks, int64_t n_parts,
    uint32_t* __restrict__ scratch) {
  __shared__ __align__(16) uint32_t hist[256 * 32];  // [symbol][lane]
  uint32_t* part_counts = scratch;
  uint32_t* marks = scratch + n_parts * 256;
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t b = blockIdx.x;
  const int64_t p = chunks[2 * b];
  const int64_t start = chunks[2 * b + 1];
  if (!chunk_ok(chunks, b, n_chunks, meta, n_parts, p, start)) {
    if (tid == 0) {
      if (p >= 0 && p < n_parts) marks[p] = 1;
      const int64_t q = b > 0 ? chunks[2 * (b - 1)] : -1;
      if (q >= 0 && q < n_parts) marks[q] = 1;
    }
    return;
  }
  const int64_t* m = meta + p * kMeta;
  const int64_t n = m[1];
  const int64_t off = m[0] + start;
  const int64_t end = off + (n - start < kChunk ? n - start : kChunk);
  // 16-byte words over the chunk, kBatch a thread loaded at a time (the
  // first batch before the histogram is zeroed), the edges masked; bytes
  // one by one in the last word of the data
  constexpr int kBatch = 4;
  constexpr int64_t kStride = int64_t(kThreads) * 16;
  int64_t w = (off & ~int64_t(15)) + int64_t(tid) * 16;
  uint4 v[kBatch];
  auto load = [&]() {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t at = w + u * kStride;
      v[u] = at < end && at + 16 <= n_data ? *reinterpret_cast<const uint4*>(data + at)
                                           : make_uint4(0, 0, 0, 0);
    }
  };
  load();
  for (int i = tid; i < 256 * 32 / 4; i += kThreads)
    reinterpret_cast<uint4*>(hist)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  while (w < end) {
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int64_t at = w + u * kStride;
      if (at >= end) break;
      if (at + 16 <= n_data) {
        const uint32_t word[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
#pragma unroll
        for (int k = 0; k < 16; ++k) {
          if (at + k >= off && at + k < end)
            atomicAdd(&hist[((word[k >> 2] >> (8 * (k & 3))) & 0xFF) * 32 + lane], 1u);
        }
      } else {
        for (int64_t i = at > off ? at : off; i < at + 16 && i < end; ++i)
          atomicAdd(&hist[data[i] * 32 + lane], 1u);
      }
    }
    w += kBatch * kStride;
    if (w < end) load();
  }
  __syncthreads();
  const int s = tid;
  uint32_t c = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) c += hist[s * 32 + ((j + s) & 31)];
  uint32_t* pc = part_counts + p * 256;
  if (n <= kChunk) {
    pc[s] = c;
  } else if (c) {
    atomicAdd(&pc[s], c);
  }
}

// A part a warp, 8 a block: takes the part's counts and mark, zeroing
// them, and quantizes. A part that is marked, or whose counts do not sum
// to its length (its chunks were not _prepare's), gets a table of zeros:
// rans_layout then sizes its blob past any buffer, rans_write writes
// nothing and the download raises.
__global__ void __launch_bounds__(kThreads, 4) rans_quantize_kernel(
    const int64_t* __restrict__ meta, int64_t n_parts, uint32_t* __restrict__ scratch,
    int32_t* __restrict__ freqs, uint2* __restrict__ enc) {
  __shared__ int32_t d_sh[kWarps * 256];
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t p = static_cast<int64_t>(blockIdx.x) * kWarps + (tid >> 5);
  if (p >= n_parts) return;
  uint4* row = reinterpret_cast<uint4*>(scratch + p * 256 + 8 * lane);
  const uint4 a = row[0], c = row[1];
  row[0] = row[1] = make_uint4(0, 0, 0, 0);
  uint32_t* mark = scratch + n_parts * 256 + p;
  const uint32_t marked = *mark;
  if (lane == 0 && marked) *mark = 0;
  const uint32_t c8[8] = {a.x, a.y, a.z, a.w, c.x, c.y, c.z, c.w};
  const int64_t n = meta[p * kMeta + 1];
  uint64_t total = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) total += c8[j];
  if (marked || warp_sum(total) != static_cast<uint64_t>(n)) {  // warp-uniform
    int4* f4 = reinterpret_cast<int4*>(freqs + p * 256 + 8 * lane);
    f4[0] = f4[1] = make_int4(0, 0, 0, 0);
    uint4* e4 = reinterpret_cast<uint4*>(enc + p * 256 + 8 * lane);
#pragma unroll
    for (int j = 0; j < 4; ++j) e4[j] = make_uint4(0, 0, 0, 0);
    return;
  }
  int32_t* warp_d = d_sh + 256 * (tid >> 5);
  if (n < (int64_t(1) << 20))  // c * 4096 < 2^32
    quantize_warp<uint32_t>(c8, n, warp_d, freqs + p * 256, enc + p * 256);
  else
    quantize_warp<uint64_t>(c8, n, warp_d, freqs + p * 256, enc + p * 256);
}

// ---------------------------------------------------------------------------
// rans_encode and the streams of rans_write: one state machine, run twice
// ---------------------------------------------------------------------------

// Where a lane writes its stream (rans_write): its bytes run backwards from
// `top` (exclusive) in the flush's output buffer, the stream in decode
// order; the 8-byte words wholly inside [lo, top) are stored whole, the
// bytes of the two words it shares with its neighbours one by one.
struct Sink {
  uint8_t* out;
  int64_t top, lo_word, hi_word;  // words [lo_word, hi_word) are the lane's own
};

// One step of a lane's state: the renorm's bytes (to the sink, when kEmit),
// then x = (x / f << 12) + x % f + start by the reciprocal.
template <bool kEmit>
__device__ __forceinline__ void encode_step(uint32_t& x, int32_t& cnt, uint64_t& buf,
                                            const Sink& sink, const uint2 e) {
  const uint32_t f = e.y >> 17;
  const uint32_t x_max = f << kXMaxShift;
#pragma unroll
  for (int k = 0; k < 2; ++k) {  // the renorm emits at most 2 bytes
    if (x >= x_max) {
      ++cnt;
      if (kEmit) {
        const int64_t at = sink.top - cnt;
        if (at >= sink.hi_word || at < sink.lo_word) {
          sink.out[at] = static_cast<uint8_t>(x);
        } else {  // the newest byte at the bottom of a little-endian word
          buf = (buf << 8) | (x & 0xFF);
          if ((at & 7) == 0) *reinterpret_cast<uint64_t*>(sink.out + at) = buf;
        }
      }
      x >>= 8;
    }
  }
  const uint32_t q = __umulhi(x, e.x) >> ((e.y >> 13) & 15);
  x += (e.y & 0x1FFF) + q * (kProbScale - f);
}

// One lane: its steps from the last down. The symbols are loaded kAhead at
// a time, a batch ahead, and their table entries before the state chain
// that depends on them.
template <bool kEmit>
__device__ __forceinline__ void encode_lane(const uint8_t* __restrict__ src, int L,
                                            int64_t steps, const uint2* tab, const Sink& sink,
                                            int32_t* cnt_out, int32_t* x_out) {
  uint32_t x = kRansL;
  int32_t cnt = 0;
  uint64_t buf = 0;
  int64_t t = steps - 1;
  uint32_t nxt[kAhead];
  if (t >= kAhead - 1) {
#pragma unroll
    for (int j = 0; j < kAhead; ++j) nxt[j] = src[(t - j) * L];
  }
  for (; t >= kAhead - 1; t -= kAhead) {
    uint2 ent[kAhead];
#pragma unroll
    for (int j = 0; j < kAhead; ++j) ent[j] = tab[nxt[j]];
    if (t - kAhead >= kAhead - 1) {
#pragma unroll
      for (int j = 0; j < kAhead; ++j) nxt[j] = src[(t - kAhead - j) * L];
    }
#pragma unroll
    for (int j = 0; j < kAhead; ++j) encode_step<kEmit>(x, cnt, buf, sink, ent[j]);
  }
  for (; t >= 0; --t) encode_step<kEmit>(x, cnt, buf, sink, tab[src[t * L]]);
  if (!kEmit) {
    *cnt_out = cnt;
    *x_out = static_cast<int32_t>(x);
  }
}

// Lanes lane_begin, lane_begin + lane_step, ... below lane_end of part p.
// kEmit: write the streams of a coded part (stream_at: where each blob's
// streams start, -1 for a raw escape; lane_cs: the lanes' byte counts'
// exclusive prefix sum) into out; else its counts and states.
template <bool kEmit>
__device__ __forceinline__ void encode_part(
    const uint8_t* __restrict__ data, const int64_t* __restrict__ meta, int p,
    const uint2* tab, int lane_begin, int lane_step, int lane_end, int32_t* __restrict__ counts,
    int32_t* __restrict__ states, const int64_t* __restrict__ stream_at,
    const int64_t* __restrict__ lane_cs, uint8_t* __restrict__ out) {
  const int64_t* m = meta + static_cast<int64_t>(p) * kMeta;
  const int64_t off = m[0], n = m[1], lane0 = m[3];
  const int L = static_cast<int>(m[2]);
  if (lane_end > L) lane_end = L;
  Sink sink{out, 0, 0, 0};
  for (int lane = lane_begin; lane < lane_end; lane += lane_step) {
    const int64_t steps = lane < n ? (n - lane + L - 1) / L : 0;
    if (kEmit) {
      const int64_t lo = stream_at[p] + lane_cs[lane0 + lane] - lane_cs[lane0];
      sink.top = lo + lane_cs[lane0 + lane + 1] - lane_cs[lane0 + lane];
      sink.lo_word = (lo + 7) & ~int64_t(7);
      sink.hi_word = sink.top & ~int64_t(7);
    }
    encode_lane<kEmit>(data + off + lane, L, steps, tab, sink, counts + lane0 + lane,
                       states + lane0 + lane);
  }
}

// One work row a block: (kBlockPart, index into sel, first lane): 256 lanes
// of a large part, one a thread; (kWarpPart, first index into sel, parts):
// a part a warp; (kLanePart, first index into sel, parts): a part a thread.
template <bool kEmit>
__device__ __forceinline__ void encode_work(
    const int32_t* __restrict__ w, const uint8_t* __restrict__ data,
    const int64_t* __restrict__ meta, const uint2* __restrict__ enc,
    const int32_t* __restrict__ sel, int32_t* __restrict__ counts,
    int32_t* __restrict__ states, const int64_t* __restrict__ stream_at,
    const int64_t* __restrict__ lane_cs, uint8_t* __restrict__ out, uint2* tab) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kind = w[0], first = w[1], arg = w[2];
  if (kind == kBlockPart) {
    const int p = sel[first];
    if (kEmit && stream_at[p] < 0) return;  // a raw escape: no stream to write
    tab[tid] = enc[static_cast<int64_t>(p) * 256 + tid];
    __syncthreads();
    encode_part<kEmit>(data, meta, p, tab, arg + tid, kThreads, arg + kThreads, counts, states,
                       stream_at, lane_cs, out);
  } else if (kind == kWarpPart) {
    if (warp >= arg) return;
    const int p = sel[first + warp];
    if (kEmit && stream_at[p] < 0) return;
    uint2* t = tab + warp * 256;
    for (int i = lane; i < 256; i += 32) t[i] = enc[static_cast<int64_t>(p) * 256 + i];
    __syncwarp();
    encode_part<kEmit>(data, meta, p, t, lane, 32, kMaxLanes, counts, states, stream_at,
                       lane_cs, out);
  } else {
    if (tid >= arg) return;
    const int p = sel[first + tid];
    if (kEmit && stream_at[p] < 0) return;
    encode_part<kEmit>(data, meta, p, enc + static_cast<int64_t>(p) * 256, 0, 1, 1, counts,
                       states, stream_at, lane_cs, out);
  }
}

// rans_encode: every lane's byte count and final state, no byte stored.
__global__ void __launch_bounds__(kThreads) rans_encode_kernel(
    const uint8_t* __restrict__ data, const int64_t* __restrict__ meta,
    const uint2* __restrict__ enc, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ work, int32_t* __restrict__ counts,
    int32_t* __restrict__ states) {
  __shared__ uint2 tab[kWarps * 256];
  encode_work<false>(work + static_cast<int64_t>(blockIdx.x) * 3, data, meta, enc, sel, counts,
                     states, nullptr, nullptr, nullptr, tab);
}

// ---------------------------------------------------------------------------
// rans_layout: a warp a part, a tile of 8 parts a block, one device-wide
// scan by decoupled look-back
// ---------------------------------------------------------------------------

// A tile's status word, one for each of its two sums: the flag in the top
// two bits (1: the tile's own sum, 2: the sum of every tile up to and with
// it), the value below.
constexpr uint64_t kFlagOwn = uint64_t(1) << 62;
constexpr uint64_t kFlagPrefix = uint64_t(2) << 62;
constexpr uint64_t kValue = kFlagOwn - 1;
// A blob whose part has no valid table: larger than any buffer (the
// wrapper holds n_data below 2^40 and P below 2^21, so the sum stays below
// 2^62).
constexpr int64_t kInvalidSize = int64_t(1) << 40;

// Warp 0 of tile t (t > 0): the sums of the tiles before it. Each pass reads
// the words of the 32 tiles below `look`, waits until every one is set, and
// adds them down to the nearest that holds a prefix.
__device__ __forceinline__ void look_back(const uint64_t* status, int64_t t, int64_t* ex_b,
                                          int64_t* ex_s) {
  const int lane = threadIdx.x & 31;
  int64_t sb = 0, ss = 0;
  for (int64_t look = t - 1;; look -= 32) {
    const int64_t i = look - lane;
    uint64_t wb = kFlagPrefix, ws = kFlagPrefix;  // below tile 0: a prefix of 0
    for (;;) {
      if (i >= 0) {
        wb = load_relaxed(status + 2 * i);
        ws = load_relaxed(status + 2 * i + 1);
      }
      // the two words of a tile are stored one after the other: wait until
      // both carry the same flag
      if (__all_sync(kAll, (wb >> 62) != 0 && (wb >> 62) == (ws >> 62))) break;
      __nanosleep(64);
    }
    const unsigned pre = __ballot_sync(kAll, (wb >> 62) == 2);
    const int stop = pre ? __ffs(pre) - 1 : 31;
    sb += warp_sum(lane <= stop ? static_cast<int64_t>(wb & kValue) : int64_t(0));
    ss += warp_sum(lane <= stop ? static_cast<int64_t>(ws & kValue) : int64_t(0));
    if (pre) break;
  }
  *ex_b = sb;
  *ex_s = ss;
}

// Each part's blob size (entropy.assemble_blob: header, 256 frequency
// varints, a lane-length varint and 4 state bytes a lane, the streams; or
// the raw escape, header + n, where that is not smaller; kInvalidSize where
// the frequencies do not sum to 4096, rans_tables' table of zeros), then the
// exclusive prefix sums of the blob sizes (blob_off) and of the lanes'
// byte counts (lane_cs) across the flush. status: u64[2 tiles + 1], zero
// (two words a tile, then a ticket); the last tile to finish zeroes it
// again. Tiles look back only at lower ones: blocks start in index order.
__global__ void __launch_bounds__(kThreads) rans_layout_kernel(
    const int64_t* __restrict__ meta, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ counts, int64_t n_parts, uint64_t* __restrict__ status,
    int64_t* __restrict__ blob_off, int64_t* __restrict__ stream_at,
    int64_t* __restrict__ lane_cs) {
  __shared__ int64_t size_sh[kWarps], sum_sh[kWarps], base_sh[2];
  __shared__ int32_t last_sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t t = blockIdx.x, n_tiles = gridDim.x;
  const int64_t p = t * kWarps + warp;
  int32_t cnt[kLaneRows];  // the part's lane counts, lane + 32 j
  int64_t size = 0, sum = 0, streams = -1, lane0 = 0;
  int L = 0;
  if (p < n_parts) {
    const int64_t* m = meta + p * kMeta;
    const int64_t n = m[1];
    L = static_cast<int>(m[2]);
    lane0 = m[3];
    int32_t f[8];
    load8(freqs + p * 256 + 8 * lane, f);
    int32_t vb = 0, f_sum = 0;  // varint bytes of the frequencies and the lane lengths
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      vb += f[j] >= 0x80 ? 2 : 1;
      f_sum += f[j];
    }
#pragma unroll
    for (int j = 0; j < kLaneRows; ++j) {
      const int l = 32 * j + lane;
      cnt[j] = l < L ? counts[lane0 + l] : 0;
      sum += cnt[j];
      vb += l < L ? varint_len(static_cast<uint32_t>(cnt[j])) : 0;
    }
    sum = warp_sum(sum);
    const int64_t head = 2 + varint_len(static_cast<uint64_t>(n));
    streams = head + warp_sum(vb) + 4 * L;
    const bool raw = streams + sum >= head + n;
    size = raw ? head + n : streams + sum;
    if (raw) streams = -1;
    if (warp_sum(f_sum) != static_cast<int32_t>(kProbScale)) {  // rans_tables' mark
      size = kInvalidSize;
      streams = -1;
    }
  }
  if (lane == 0) {
    size_sh[warp] = size;
    sum_sh[warp] = sum;
  }
  __syncthreads();
  if (warp == 0) {
    int64_t own_b = 0, own_s = 0, ex_b = 0, ex_s = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      own_b += size_sh[w];
      own_s += sum_sh[w];
    }
    uint64_t* word = status + 2 * t;
    if (t > 0) {
      if (lane == 0) {
        store_relaxed(word, kFlagOwn | static_cast<uint64_t>(own_b));
        store_relaxed(word + 1, kFlagOwn | static_cast<uint64_t>(own_s));
      }
      look_back(status, t, &ex_b, &ex_s);
    }
    if (lane == 0) {
      store_relaxed(word, kFlagPrefix | static_cast<uint64_t>(ex_b + own_b));
      store_relaxed(word + 1, kFlagPrefix | static_cast<uint64_t>(ex_s + own_s));
      base_sh[0] = ex_b;
      base_sh[1] = ex_s;
      __threadfence();
      last_sh = atomicAdd(reinterpret_cast<unsigned long long*>(status + 2 * n_tiles), 1ull) ==
                static_cast<unsigned long long>(n_tiles - 1);
    }
  }
  __syncthreads();
  if (p < n_parts) {
    int64_t at = base_sh[0], run = base_sh[1];
    for (int w = 0; w < warp; ++w) {
      at += size_sh[w];
      run += sum_sh[w];
    }
    if (lane == 0) {
      blob_off[p] = at;
      stream_at[p] = streams < 0 ? -1 : at + streams;
      if (p == n_parts - 1) blob_off[n_parts] = at + size;
    }
#pragma unroll
    for (int j = 0; j < kLaneRows; ++j) {
      if (32 * j >= L) break;
      const int l = 32 * j + lane;
      const int32_t incl = warp_incl_scan(cnt[j]);
      if (l < L) lane_cs[lane0 + l] = run + incl - cnt[j];
      run += __shfl_sync(kAll, incl, 31);
    }
    if (p == n_parts - 1 && lane == 0) lane_cs[lane0 + L] = run;
  }
  if (last_sh)  // every tile has looked back: the status words are free again
    for (int64_t i = tid; i <= 2 * n_tiles; i += kThreads) status[i] = 0;
}

// ---------------------------------------------------------------------------
// rans_write: two kernels, so that no large part rests on one block and
// the copies do not run at the state machine's occupancy. rans_write_kernel:
// a 64 KB chunk of a part a block, its raw payload (and, for its first
// chunk, its header) where the part is a raw escape; then a coded part's
// head a warp (header, frequency and lane-length varints, states), 8 parts
// a block; then 256 work rows of rans_encode a block, a thread a row,
// marking the rows that hold a coded part. rans_streams_kernel: a work row
// a block, whose coded parts' lanes run their state machines again and
// write their streams in place; a row without one costs its block one load.
// ---------------------------------------------------------------------------

// 16 bytes of data from byte s on, any alignment: the aligned 16-byte words
// that hold them, shifted down by s % 16 bytes (8, then 4, then a funnel
// shift of 0-3 bytes). Next to the end of the data, byte by byte.
__device__ __forceinline__ uint4 load16_at(const uint8_t* __restrict__ data, int64_t s,
                                           int64_t n_data) {
  const int64_t base = s & ~int64_t(15);
  const int r = static_cast<int>(s & 15);
  if (base + (r ? 32 : 16) > n_data) {
    uint32_t v[4] = {0, 0, 0, 0};
    for (int k = 0; k < 16 && s + k < n_data; ++k)
      v[k >> 2] |= static_cast<uint32_t>(data[s + k]) << (8 * (k & 3));
    return make_uint4(v[0], v[1], v[2], v[3]);
  }
  const uint4 lo = *reinterpret_cast<const uint4*>(data + base);
  if (r == 0) return lo;
  const uint4 hi = *reinterpret_cast<const uint4*>(data + base + 16);
  uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  if (r & 8) {
#pragma unroll
    for (int k = 0; k < 6; ++k) w[k] = w[k + 2];
  }
  if (r & 4) {
#pragma unroll
    for (int k = 0; k < 5; ++k) w[k] = w[k + 1];
  }
  const int sh = 8 * (r & 3);
  return make_uint4(__funnelshift_r(w[0], w[1], sh), __funnelshift_r(w[1], w[2], sh),
                    __funnelshift_r(w[2], w[3], sh), __funnelshift_r(w[3], w[4], sh));
}

// A block copies len bytes from data + s0 to out + d0: the 16-byte words of
// out wholly inside [d0, d0 + len) as whole words, the ragged ends (under 16
// bytes each) byte by byte.
__device__ __forceinline__ void copy_realigned(uint8_t* __restrict__ out, int64_t d0,
                                               const uint8_t* __restrict__ data, int64_t s0,
                                               int64_t len, int64_t n_data) {
  const int tid = threadIdx.x;
  const int64_t a = (d0 + 15) & ~int64_t(15), e = (d0 + len) & ~int64_t(15);
  if (a >= e) {
    for (int64_t i = tid; i < len; i += kThreads) out[d0 + i] = data[s0 + i];
    return;
  }
  if (tid < a - d0) out[d0 + tid] = data[s0 + tid];
  if (tid < d0 + len - e) out[e + tid] = data[s0 + (e - d0) + tid];
  const int64_t shift = s0 - d0;
#pragma unroll 4
  for (int64_t w = a + 16 * int64_t(tid); w < e; w += 16 * int64_t(kThreads))
    *reinterpret_cast<uint4*>(out + w) = load16_at(data, w + shift, n_data);
}

// A coded part's head by one warp: header, the 256 frequency varints (8
// symbols a lane), the lane-length varints and the 4-byte states.
__device__ __forceinline__ void write_head(const int64_t* __restrict__ m,
                                           const int32_t* __restrict__ fr,
                                           const int32_t* __restrict__ counts,
                                           const int32_t* __restrict__ states, uint8_t* blob) {
  const int lane = threadIdx.x & 31;
  const int64_t n = m[1], lane0 = m[3];
  const int L = static_cast<int>(m[2]);
  if (lane == 0) {
    blob[0] = kMagic;
    blob[1] = static_cast<uint8_t>(31 - __clz(L));
    put_varint(blob + 2, static_cast<uint64_t>(n));
  }
  const int head = 2 + varint_len(static_cast<uint64_t>(n));
  int32_t f[8];
  load8(fr + 8 * lane, f);
  int32_t fb = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) fb += f[j] >= 0x80 ? 2 : 1;
  const int32_t f_incl = warp_incl_scan(fb);
  uint8_t* at = blob + head + f_incl - fb;
#pragma unroll
  for (int j = 0; j < 8; ++j) at += put_varint(at, static_cast<uint32_t>(f[j]));
  uint8_t* lens = blob + head + __shfl_sync(kAll, f_incl, 31);
  int32_t run = 0;
  for (int j = 0; 32 * j < L; ++j) {
    const int l = 32 * j + lane;
    const int32_t c = l < L ? counts[lane0 + l] : 0;
    const int32_t vl = l < L ? varint_len(static_cast<uint32_t>(c)) : 0;
    const int32_t incl = warp_incl_scan(vl);
    if (l < L) put_varint(lens + run + incl - vl, static_cast<uint32_t>(c));
    run += __shfl_sync(kAll, incl, 31);
  }
  uint8_t* st = lens + run;
  for (int l = lane; l < L; l += 32) {
    const uint32_t x = static_cast<uint32_t>(states[lane0 + l]);
#pragma unroll
    for (int k = 0; k < 4; ++k) st[4 * l + k] = static_cast<uint8_t>(x >> (8 * k));
  }
}

// blob_off: i64[P + 1] the blobs' offsets; stream_at: i64[P], where each
// part's streams start in the output (-1 for a raw escape); lane_cs:
// i64[lanes + 1], the exclusive prefix sum of the lanes' byte counts (all
// three from rans_layout). Neither kernel writes when the blobs would
// overrun the buffer's cap bytes (the host sees blob_off[P] > cap); a chunk
// entry that is not _prepare's sets blob_off[P] to -1 and copies nothing.
// Blocks that read blob_off[P] after that write nothing either (it is out
// of [0, cap] as unsigned); those that read it before write inside the
// buffer, as the offsets are rans_layout's.
__device__ __forceinline__ bool blobs_fit(const int64_t* blob_off, int64_t n_parts,
                                          int64_t cap) {
  return static_cast<uint64_t>(blob_off[n_parts]) <= static_cast<uint64_t>(cap);
}

__global__ void __launch_bounds__(kThreads) rans_write_kernel(
    const uint8_t* __restrict__ data, int64_t n_data, const int64_t* __restrict__ meta,
    const int64_t* __restrict__ chunks, int64_t n_chunks, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ work, int64_t n_work, const int32_t* __restrict__ freqs,
    const int32_t* __restrict__ counts, const int32_t* __restrict__ states,
    int64_t* __restrict__ blob_off, const int64_t* __restrict__ stream_at,
    int64_t n_parts, int64_t cap, uint8_t* __restrict__ out, uint8_t* __restrict__ live) {
  const int64_t b = blockIdx.x;
  const bool fit = blobs_fit(blob_off, n_parts, cap);
  const int64_t n_head = (n_parts + kWarps - 1) / kWarps;
  if (b >= n_chunks + n_head) {  // which work rows hold a coded part
    const int64_t row = (b - n_chunks - n_head) * kThreads + threadIdx.x;
    if (row >= n_work || !fit) return;
    const int32_t* w = work + row * 3;
    const int parts = w[0] == kBlockPart ? 1 : w[2];
    bool coded = false;
    for (int i = 0; i < parts && !coded; ++i) coded = stream_at[sel[w[1] + i]] >= 0;
    live[row] = coded;
    return;
  }
  if (b < n_chunks) {  // a chunk of a raw escape
    const int64_t p = chunks[2 * b], start = chunks[2 * b + 1];
    if (!chunk_ok(chunks, b, n_chunks, meta, n_parts, p, start)) {
      if (threadIdx.x == 0) blob_off[n_parts] = -1;
      return;
    }
    // the part's words together, before the first is used
    const int64_t at = stream_at[p], blob = blob_off[p], src = meta[p * kMeta],
                  n = meta[p * kMeta + 1];
    if (at >= 0 || !fit) return;
    const int head = 2 + varint_len(static_cast<uint64_t>(n));
    if (start == 0 && threadIdx.x == 0) {
      out[blob] = kMagic;
      out[blob + 1] = kRawFlag;
      put_varint(out + blob + 2, static_cast<uint64_t>(n));
    }
    copy_realigned(out, blob + head + start, data, src + start,
                   n - start < kChunk ? n - start : kChunk, n_data);
    return;
  }
  const int64_t p = (b - n_chunks) * kWarps + (threadIdx.x >> 5);
  if (p >= n_parts || stream_at[p] < 0 || !fit) return;
  write_head(meta + p * kMeta, freqs + p * 256, counts, states, out + blob_off[p]);
}

__global__ void __launch_bounds__(kThreads) rans_streams_kernel(
    const uint8_t* __restrict__ data, const int64_t* __restrict__ meta,
    const uint2* __restrict__ enc, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ work, const int64_t* __restrict__ blob_off,
    const int64_t* __restrict__ stream_at, const int64_t* __restrict__ lane_cs, int64_t n_parts,
    int64_t cap, uint8_t* __restrict__ out, const uint8_t* __restrict__ live) {
  __shared__ uint2 tab[kWarps * 256];
  if (!blobs_fit(blob_off, n_parts, cap) || !live[blockIdx.x]) return;
  encode_work<true>(work + static_cast<int64_t>(blockIdx.x) * 3, data, meta, enc, sel, nullptr,
                    nullptr, stream_at, lane_cs, out, tab);
}

// ---------------------------------------------------------------------------
// rans_decode
// ---------------------------------------------------------------------------

// rans_decode work rows: (first index into sel, blobs, first lane)
constexpr int kDecodeBlobs = 8;  // blobs a decode block at most
// a blob's shared bytes: 256 words f << 16 | cum, then its slot table
constexpr int kBlobBytes = 256 * 4 + kProbScale;
// a decode block's shared bytes: its blobs' tables, then its stream bytes
// (39 KB for a row of one blob, 4 KB for a row of 8); 44 KB leaves five
// blocks an SM
constexpr int kDecodeBytes = 44 << 10;

// The number of symbols s < 255 with cum[s + 1] <= slot (agc_tpu's rank,
// sum(cum[1:] <= slot), which cum[256] = 4096 keeps below 256), searched
// between lo and hi, which must hold it. t: a blob's 256 words f << 16 |
// cum.
__device__ __forceinline__ int rank_in(const uint32_t* t, uint32_t slot, int lo, int hi) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if ((t[mid + 1] & 0xFFFFu) <= slot) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// One lane's symbols, written at out[t * L] (out already at the lane); a
// read past the lane's bytes gives 0. src is in global or shared memory,
// so its loads are generic.
__device__ __forceinline__ void decode_lane(const uint8_t* __restrict__ src, int64_t len,
                                            uint32_t x, int64_t steps, int L,
                                            const uint32_t* t, const uint8_t* sym,
                                            uint8_t* __restrict__ out) {
  int64_t cur = 0;
  for (int64_t i = 0; i < steps; ++i) {
    const uint32_t slot = x & (kProbScale - 1);
    const uint32_t s = sym[slot];
    out[i * L] = static_cast<uint8_t>(s);
    const uint32_t e = t[s];
    x = (e >> 16) * (x >> kProbBits) + slot - (e & 0xFFFFu);
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

// A block a work row: 256 lanes of a large blob, or up to 8 small blobs of
// one tier. Warp w loads the frequencies of blobs w, w + 8, ... of the row
// and scans them into f << 16 | cum words (8 a lane, a shuffle scan of the
// lane sums). The row's stream bytes go to the shared bytes its tables
// leave, blob by blob while they fit, as 16-byte words: read from global
// memory a byte a renorm, they waited on L2 (the lanes of an SM touch
// more lines than the L1 beside the blocks' shared memory keeps). The
// block then fills each blob's 4096-slot table, a thread a run of 16-slot
// chunks, each one 16-byte store: the symbol of the first slot by a
// binary search, and a search again only where a symbol's range ends, so
// a run of symbols of frequency 0 (a blob of digits and 255, say) costs
// one search, not a step a symbol. Then a blob of the row has 256 / blobs
// threads, one a lane.
// meta: i64[B, 4] (n, L, first lane, output offset); a lane's bytes are
// read only inside its lane_off range, clamped to the stream.
__global__ void __launch_bounds__(kThreads) rans_decode_kernel(
    const uint8_t* __restrict__ stream, int64_t n_stream, const int64_t* __restrict__ lane_off,
    const int64_t* __restrict__ states, const int32_t* __restrict__ freqs,
    const int64_t* __restrict__ meta, const int32_t* __restrict__ sel,
    const int32_t* __restrict__ work, uint8_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t smem[kDecodeBytes];
  // each blob's stream range and its place among the staged bytes (-1: not
  // staged)
  __shared__ int64_t s_lo[kDecodeBlobs], s_hi[kDecodeBlobs], s_at[kDecodeBlobs];
  const int32_t* row = work + 3 * static_cast<int64_t>(blockIdx.x);
  const int first = row[0];
  const int count = row[1];
  const int lane0 = row[2];
  if (count < 1 || count > kDecodeBlobs) return;  // not a row of ours
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem);
  uint8_t* sym = smem + count * 1024;
  uint8_t* stage = smem + count * kBlobBytes;
  const int64_t stage_cap = kDecodeBytes - count * kBlobBytes;
  const int warp = threadIdx.x >> 5;
  const int l = threadIdx.x & 31;
  for (int r = warp; r < count; r += kWarps) {
    const int32_t* fr = freqs + 256 * static_cast<int64_t>(sel[first + r]);
    uint32_t v[8];
    uint32_t sum = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      v[i] = static_cast<uint32_t>(__ldg(fr + l * 8 + i));
      sum += v[i];
    }
    uint32_t run = warp_incl_scan(sum) - sum;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      tab[r * 256 + l * 8 + i] = (v[i] << 16) | (run & 0xFFFFu);
      run += v[i];
    }
  }
  if (static_cast<int>(threadIdx.x) < count) {  // the row's lanes of blob r, contiguous
    const int64_t* m0 = meta + 4 * static_cast<int64_t>(sel[first + threadIdx.x]);
    const int64_t g0 = m0[2] + lane0;
    const int64_t nl = m0[1] - lane0 < kThreads ? m0[1] - lane0 : kThreads;
    int64_t lo = lane_off[g0], hi = lane_off[g0 + nl];
    lo = lo < 0 ? 0 : (lo > n_stream ? n_stream : lo);
    hi = hi < lo ? lo : (hi > n_stream ? n_stream : hi);
    s_lo[threadIdx.x] = lo;
    s_hi[threadIdx.x] = hi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    // blob r's bytes at an offset of the same alignment as in the stream,
    // so that their middle copies as 16-byte words
    int64_t run = 0;
    for (int r = 0; r < count; ++r) {
      const int64_t len = s_hi[r] - s_lo[r];
      const int64_t at = ((run + 15) & ~int64_t{15}) +
                         static_cast<int64_t>(reinterpret_cast<uintptr_t>(stream + s_lo[r]) & 15);
      s_at[r] = at + len <= stage_cap ? at : -1;
      run = s_at[r] < 0 ? run : at + len;
    }
  }
  __syncthreads();
  for (int r = 0; r < count; ++r) {
    if (s_at[r] < 0) continue;
    const uint8_t* from = stream + s_lo[r];
    uint8_t* to = stage + s_at[r];
    const int64_t len = s_hi[r] - s_lo[r];
    const int64_t head = (16 - static_cast<int64_t>(reinterpret_cast<uintptr_t>(from) & 15)) & 15;
    const int64_t words = len > head ? (len - head) >> 4 : 0;
    const int64_t body = head + 16 * words;  // [head, body): whole words
    if (threadIdx.x < head && threadIdx.x < len) to[threadIdx.x] = __ldg(from + threadIdx.x);
    for (int64_t j = body + threadIdx.x; j < len; j += kThreads) to[j] = __ldg(from + j);
    const uint4* src4 = reinterpret_cast<const uint4*>(from + head);
    uint4* dst4 = reinterpret_cast<uint4*>(to + head);
#pragma unroll 4
    for (int64_t j = threadIdx.x; j < words; j += kThreads) dst4[j] = __ldg(src4 + j);
  }
  // each thread fills a run of 16-slot chunks of blob threadIdx.x / (256 /
  // count): the first slot by a binary search, the next ones by a search
  // again only where a symbol's range ends (one load where the next symbol
  // takes over; a binary search past a run of frequency-0 symbols)
  {
    const int tpb = kThreads / count;  // threads a blob
    const int rb = threadIdx.x / tpb;
    const uint32_t span = 16 * ((256 + tpb - 1) / tpb);  // slots a thread
    const uint32_t lo = static_cast<uint32_t>(threadIdx.x % tpb) * span;
    const uint32_t hi = lo + span < kProbScale ? lo + span : kProbScale;
    if (rb < count && lo < hi) {
      const uint32_t* t = tab + rb * 256;
      uint8_t* dst = sym + rb * kProbScale;
      int s = rank_in(t, lo, 0, 255);
      uint32_t end = s < 255 ? (t[s + 1] & 0xFFFFu) : kProbScale;
      for (uint32_t at = lo; at < hi; at += 16) {
        uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
        for (int q = 0; q < 16; ++q) {
          const uint32_t slot = at + q;
          if (slot >= end) {
            ++s;
            if (s < 255 && (t[s + 1] & 0xFFFFu) <= slot) s = rank_in(t, slot, s + 1, 255);
            end = s < 255 ? (t[s + 1] & 0xFFFFu) : kProbScale;
          }
          w[q >> 2] |= static_cast<uint32_t>(s) << (8 * (q & 3));
        }
        *reinterpret_cast<uint4*>(dst + at) = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
  }
  __syncthreads();
  const int per = kThreads / count;  // threads a blob of the row
  const int r = threadIdx.x / per;
  if (r >= count) return;
  const int64_t* m = meta + 4 * static_cast<int64_t>(sel[first + r]);
  const int64_t n = m[0];
  const int L = static_cast<int>(m[1]);
  const int lane = lane0 + threadIdx.x % per;
  if (lane >= L || lane >= n) return;
  const int64_t g = m[2] + lane;
  int64_t start = lane_off[g], end = lane_off[g + 1];
  start = start < 0 ? 0 : (start > n_stream ? n_stream : start);
  end = end < start ? start : (end > n_stream ? n_stream : end);
  const uint8_t* src = stream + start;
  if (s_at[r] >= 0) {  // read the staged copy, inside the blob's staged range
    const int64_t lo = s_lo[r], hi = s_hi[r];
    start = start < lo ? lo : (start > hi ? hi : start);
    end = end < start ? start : (end > hi ? hi : end);
    src = stage + s_at[r] + (start - lo);
  }
  const int64_t steps = (n - lane + L - 1) / L;
  const uint32_t x = static_cast<uint32_t>(states[g]);
  decode_lane(src, end - start, x, steps, L, tab + r * 256, sym + r * kProbScale,
              out + m[3] + lane);
}

}  // namespace rans
}  // namespace agc

// data: u8[n_data] symbols of the flush's parts, 16-byte aligned; meta:
// i64[P, 4] per part (data offset, n >= 1, lanes L, first lane); chunks:
// i64[C, 2] (part, start) of every kChunk bytes of every part; scratch:
// u32[P * 257], zero, left zero; freqs: i32[P, 256] quantized frequencies;
// enc: u32[P, 256, 2] the encoder's symbol table. Two launches: the
// histograms, then the quantizers.
extern "C" int agc_rans_tables(const uint8_t* data, int64_t n_data, const int64_t* meta,
                               const int64_t* chunks, int64_t n_chunks, int64_t n_parts,
                               uint32_t* scratch, int32_t* freqs, uint32_t* enc, void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  const int64_t quant = (n_parts + kWarps - 1) / kWarps;  // 8 quantizers a block
  if (n_chunks <= 0 || n_chunks > INT32_MAX || quant > INT32_MAX ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rans_hist_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0, st>>>(
      data, n_data, meta, chunks, n_chunks, n_parts, scratch);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_quantize_kernel<<<static_cast<unsigned>(quant), kThreads, 0, st>>>(
      meta, n_parts, scratch, freqs, reinterpret_cast<uint2*>(enc));
  return static_cast<int>(cudaGetLastError());
}

// sel: i32[P] part indices in work order; work: i32[B, 3] (kind, index into
// sel, first lane or parts); counts, states: i32 a lane.
extern "C" int agc_rans_encode(const uint8_t* data, const int64_t* meta, const uint32_t* enc,
                               const int32_t* sel, const int32_t* work, int64_t n_work,
                               int32_t* counts, int32_t* states, void* stream) {
  using namespace agc::rans;
  if (n_work <= 0) return 0;
  if (n_work > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rans_encode_kernel<<<static_cast<unsigned>(n_work), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      data, meta, reinterpret_cast<const uint2*>(enc), sel, work, counts, states);
  return static_cast<int>(cudaGetLastError());
}

// status: u64[2 * tiles + 1] (tiles of 8 parts), zero, left zero; blob_off:
// i64[P + 1]; stream_at: i64[P]; lane_cs: i64[lanes + 1].
extern "C" int agc_rans_layout(const int64_t* meta, const int32_t* freqs, const int32_t* counts,
                               int64_t n_parts, uint64_t* status, int64_t* blob_off,
                               int64_t* stream_at, int64_t* lane_cs, void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  const int64_t tiles = (n_parts + kWarps - 1) / kWarps;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rans_layout_kernel<<<static_cast<unsigned>(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(meta, freqs, counts, n_parts, status,
                                                            blob_off, stream_at, lane_cs);
  return static_cast<int>(cudaGetLastError());
}

// blob_off, stream_at, lane_cs: rans_layout's; out: cap bytes, 16-byte
// aligned, the blobs at blob_off; live: u8[B], scratch; data as for
// agc_rans_tables.
extern "C" int agc_rans_write(const uint8_t* data, int64_t n_data, const int64_t* meta,
                              const int64_t* chunks, int64_t n_chunks, const uint32_t* enc,
                              const int32_t* sel, const int32_t* work, int64_t n_work,
                              const int32_t* freqs, const int32_t* counts,
                              const int32_t* states, int64_t* blob_off,
                              const int64_t* stream_at, const int64_t* lane_cs, int64_t n_parts,
                              int64_t cap, uint8_t* out, uint8_t* live, void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  // chunks, 8 heads a block, 256 work rows a block
  const int64_t blocks =
      n_chunks + (n_parts + kWarps - 1) / kWarps + (n_work + kThreads - 1) / kThreads;
  if (n_parts > INT32_MAX || blocks > INT32_MAX || n_work > INT32_MAX ||
      n_chunks < n_parts ||
      reinterpret_cast<uintptr_t>(data) % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  rans_write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(
      data, n_data, meta, chunks, n_chunks, sel, work, n_work, freqs, counts, states, blob_off,
      stream_at, n_parts, cap, out, live);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_work <= 0) return static_cast<int>(e);
  rans_streams_kernel<<<static_cast<unsigned>(n_work), kThreads, 0, st>>>(
      data, meta, reinterpret_cast<const uint2*>(enc), sel, work, blob_off, stream_at, lane_cs,
      n_parts, cap, out, live);
  return static_cast<int>(cudaGetLastError());
}

// A batch of B blobs: stream: u8[n_stream], every lane's bytes; lane_off:
// i64[lanes + 1]; states: i64[lanes] (u32 values); freqs: i32[B, 256];
// meta: i64[B, 4] (n, L, first lane, output offset); sel: i32[B] blob
// indices in work order; work: i32[n_work, 3] (first index into sel,
// blobs, first lane); out: the blobs' symbols at their offsets. The
// wrapper checks meta, sel and work against each other before the launch.
extern "C" int agc_rans_decode(const uint8_t* stream_bytes, int64_t n_stream,
                               const int64_t* lane_off, const int64_t* states,
                               const int32_t* freqs, const int64_t* meta, const int32_t* sel,
                               const int32_t* work, int64_t n_work, uint8_t* out, void* stream) {
  using namespace agc::rans;
  if (n_work <= 0) return 0;
  if (n_work > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  rans_decode_kernel<<<static_cast<unsigned>(n_work), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(stream_bytes, n_stream, lane_off,
                                                            states, freqs, meta, sel, work, out);
  return static_cast<int>(cudaGetLastError());
}
