// Lane-interleaved order-0 rANS, the coder of the tpu-rans archive profile
// (agc_tpu_torch/core/entropy.py defines the bitstream). A store flush is
// coded by three launches: rans_tables (each part's symbol counts and
// quantized frequencies, and the encoder's per-symbol reciprocals),
// rans_encode (every lane of every part: its byte count and final state)
// and rans_write (each part's whole blob, or its raw escape, at an offset
// from a prefix sum of the blob sizes); rans_decode decodes one blob.
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
// the reference parts of a whole-genome create) is never run twice.
//
// The parts' sizes run from 1 byte to megabytes, so no kernel gives a large
// part to one block: rans_tables reads every 64 KB chunk of a part in a
// block of its own into a shared-memory histogram with a private column a
// lane (conflict-free atomics), and quantizes a part a block; the state
// machine gives a block 256 lanes of a large part, a warp an 8- or 64-lane
// part, a thread a 1-lane part, 256 to a block; rans_write writes a part's
// head a block and a raw payload a 64 KB chunk a block. rans_decode has no
// division: ~10 operations a symbol, a slot table in shared memory, one
// thread a lane.
#include <cstdint>
#include <cuda_runtime.h>

namespace agc {
namespace rans {

constexpr uint32_t kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;
constexpr int kXMaxShift = 19;  // x_max = ((kRansL >> kProbBits) << 8) * f = f << 19
constexpr int kThreads = 256;   // every kernel but rans_decode
constexpr int kWarps = kThreads / 32;
constexpr int kMeta = 4;        // meta row: data offset, n, lanes, first lane
constexpr int kMaxLanes = 1024;
constexpr int64_t kChunk = 1 << 16;  // bytes of a part a histogram or raw-copy block
constexpr int kAhead = 16;  // symbols a lane loads ahead of its state chain
constexpr uint8_t kMagic = 0xA9;
constexpr uint8_t kRawFlag = 0x80;
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

// Block-wide sum of v (every thread gets it). `sh` holds kWarps values and
// is free again when the call returns.
template <typename V>
__device__ __forceinline__ V block_sum(V v, V* sh) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) sh[threadIdx.x >> 5] = v;
  __syncthreads();
  V s = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) s += sh[w];
  __syncthreads();
  return s;
}

// Block-wide exclusive prefix sum of v in thread order; *total gets the
// sum. `sh` as for block_sum.
template <typename V>
__device__ __forceinline__ V block_excl_scan(V v, V* sh, V* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  V incl = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const V u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  if (lane == 31) sh[warp] = incl;
  __syncthreads();
  V before = 0, all = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += sh[w];
    all += sh[w];
  }
  __syncthreads();
  *total = all;
  return before + incl - v;
}

// ---------------------------------------------------------------------------
// rans_tables: rans_hist (a block a chunk), then rans_quantize (a block a part)
// ---------------------------------------------------------------------------

// enc entry of a symbol: .x the reciprocal, .y bias | shift << 13 | f << 17
// (bias = start, + 4095 for f = 1; bias < 2^13, shift < 2^4, f <= 2^12).
__device__ __forceinline__ uint2 enc_entry(uint32_t f, uint32_t start) {
  if (f == 0) return make_uint2(0, 0);
  if (f == 1) return make_uint2(0xFFFFFFFFu, (start + kProbScale - 1) | (1u << 17));
  const uint32_t shift = 32 - __clz(f - 1);  // 2^(shift - 1) < f <= 2^shift
  const uint32_t rcp =
      static_cast<uint32_t>(((uint64_t(1) << (shift + 31)) + f - 1) / f);
  return make_uint2(rcp, start | ((shift - 1) << 13) | (f << 17));
}

// One block a chunk of a part (kChunk bytes at most): its bytes into a
// histogram in shared memory with a private column a lane, so that a warp's
// 32 atomics hit 32 banks, then the part's global counts.
__global__ void __launch_bounds__(kThreads) rans_hist_kernel(
    const uint8_t* __restrict__ data, int64_t n_data, const int64_t* __restrict__ meta,
    const int64_t* __restrict__ chunks, uint32_t* __restrict__ counts) {
  __shared__ uint32_t hist[256 * 32];  // [symbol][lane]
  const int tid = threadIdx.x, lane = tid & 31;
  const int64_t p = chunks[2 * static_cast<int64_t>(blockIdx.x)];
  const int64_t start = chunks[2 * static_cast<int64_t>(blockIdx.x) + 1];
  const int64_t* m = meta + p * kMeta;
  const int64_t off = m[0] + start;
  const int64_t end = off + (m[1] - start < kChunk ? m[1] - start : kChunk);
  for (int i = tid; i < 256 * 32; i += kThreads) hist[i] = 0;
  __syncthreads();
  // 16-byte words over the chunk, the edges masked; bytes one by one in
  // the last word of the data
  for (int64_t w = (off & ~int64_t(15)) + int64_t(tid) * 16; w < end;
       w += int64_t(kThreads) * 16) {
    if (w + 16 <= n_data) {
      const uint4 v = *reinterpret_cast<const uint4*>(data + w);
      const uint32_t word[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int64_t at = w + b;
        if (at >= off && at < end)
          atomicAdd(&hist[((word[b >> 2] >> (8 * (b & 3))) & 0xFF) * 32 + lane], 1u);
      }
    } else {
      for (int64_t at = w > off ? w : off; at < w + 16 && at < end; ++at)
        atomicAdd(&hist[data[at] * 32 + lane], 1u);
    }
  }
  __syncthreads();
  const int s = tid;
  uint32_t c = 0;
#pragma unroll 8
  for (int j = 0; j < 32; ++j) c += hist[s * 32 + ((j + s) & 31)];
  if (c) atomicAdd(&counts[p * 256 + s], c);
}

// One block a part, one thread a symbol: quantize_freqs of the part's
// counts, then the encoder's table of the result.
__global__ void __launch_bounds__(kThreads) rans_quantize_kernel(
    const int64_t* __restrict__ meta, const uint32_t* __restrict__ counts,
    int32_t* __restrict__ freqs, uint2* __restrict__ enc) {
  __shared__ uint64_t key_sh[256];
  __shared__ uint32_t q_sh[256];
  __shared__ int32_t red32[kWarps];
  __shared__ int32_t kk_sh[2];  // the last pass K and the decrements before it
  const int tid = threadIdx.x, lane = tid & 31;
  const int s = tid;
  const int64_t n = meta[static_cast<int64_t>(blockIdx.x) * kMeta + 1];
  const uint64_t c = counts[static_cast<int64_t>(blockIdx.x) * 256 + s];
  // quantize_freqs: q = c * 4096 // n, every present symbol at least 1
  const uint64_t total = static_cast<uint64_t>(n);
  const bool present = c > 0;
  uint32_t q = static_cast<uint32_t>(c * kProbScale / total);
  const uint64_t rem = c * kProbScale % total;
  if (present && q == 0) q = 1;
  const int32_t diff = static_cast<int32_t>(kProbScale) -
                       block_sum<int32_t>(static_cast<int32_t>(q), red32);
  if (diff > 0) {
    // +1s cycling over the present symbols by (-rem, symbol)
    const int32_t n_present = __syncthreads_count(present);
    key_sh[s] = present ? (rem << 8) + (255 - s) + 1 : 0;
    __syncthreads();
    int32_t rank = 0;
    const uint64_t key = key_sh[s];
    for (int u = 0; u < 256; ++u) rank += key_sh[u] > key;
    if (present) q += diff / n_present + (rank < diff % n_present);
  } else if (diff < 0) {
    // passes of -1 over (rem, symbol), each over the symbols with q > 1:
    // pass k takes from those with q > k, so K - 1 whole passes take
    // sum(min(q - 1, K - 1)) and pass K the rest, in (rem, symbol) order
    const int32_t need = -diff;
    q_sh[s] = q;
    __syncthreads();
    if (tid < 32) {
      auto taken = [&](int32_t k) {  // decrements in passes 1 .. k
        int32_t t = 0;
        for (int u = lane; u < 256; u += 32) {
          const int32_t qu = static_cast<int32_t>(q_sh[u]) - 1;
          t += qu < 0 ? 0 : (qu < k ? qu : k);
        }
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
        return t;
      };
      int32_t lo = 1, hi = static_cast<int32_t>(kProbScale);
      while (lo < hi) {
        const int32_t mid = (lo + hi) >> 1;
        if (taken(mid) >= need) hi = mid; else lo = mid + 1;
      }
      const int32_t before = taken(lo - 1);
      if (lane == 0) {
        kk_sh[0] = lo;
        kk_sh[1] = before;
      }
    }
    __syncthreads();
    const int32_t K = kk_sh[0], left = need - kk_sh[1];
    const bool eligible = q > static_cast<uint32_t>(K);
    key_sh[s] = eligible ? (rem << 8) + s : ~uint64_t(0);
    __syncthreads();
    int32_t rank = 0;
    const uint64_t key = key_sh[s];
    for (int u = 0; u < 256; ++u) rank += key_sh[u] < key;
    if (q >= 1) q -= min(q - 1, static_cast<uint32_t>(K - 1));
    if (eligible && rank < left) q -= 1;
  }
  freqs[static_cast<int64_t>(blockIdx.x) * 256 + s] = static_cast<int32_t>(q);
  int32_t all;
  const int32_t start = block_excl_scan<int32_t>(static_cast<int32_t>(q), red32, &all);
  enc[static_cast<int64_t>(blockIdx.x) * 256 + s] = enc_entry(q, static_cast<uint32_t>(start));
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
// rans_write: blocks of three roles, so that no large part rests on one
// block: [0, P) a part's head each (header, frequency and lane-length
// varints, states); then a work row of rans_encode each, whose coded parts'
// lanes run their state machines again and write their streams in place;
// then a 64 KB chunk of a part each, its raw payload where the part is a
// raw escape.
// ---------------------------------------------------------------------------

// blob_off: i64[P + 1] the blobs' offsets (a part whose size is its raw
// size takes it only when written raw); stream_at: i64[P], where each
// part's streams start in the output (-1 for a raw escape); lane_cs:
// i64[lanes + 1], the exclusive prefix sum of the lanes' byte counts.
__global__ void __launch_bounds__(kThreads) rans_write_kernel(
    const uint8_t* __restrict__ data, const int64_t* __restrict__ meta,
    const int64_t* __restrict__ chunks, const uint2* __restrict__ enc,
    const int32_t* __restrict__ sel, const int32_t* __restrict__ work,
    const int32_t* __restrict__ freqs, const int32_t* __restrict__ counts,
    const int32_t* __restrict__ states, const int64_t* __restrict__ blob_off,
    const int64_t* __restrict__ stream_at, const int64_t* __restrict__ lane_cs,
    int n_parts, int64_t n_work, uint8_t* __restrict__ out) {
  __shared__ uint2 tab[kWarps * 256];
  __shared__ int32_t red32[kWarps];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  if (b >= n_parts + n_work) {  // a chunk of a raw escape's payload
    const int64_t* c = chunks + 2 * (b - n_parts - n_work);
    const int64_t p = c[0], start = c[1];
    if (stream_at[p] >= 0) return;
    const int64_t* m = meta + p * kMeta;
    const int64_t n = m[1];
    const int64_t len = n - start < kChunk ? n - start : kChunk;
    uint8_t* dst = out + blob_off[p] + 2 + varint_len(static_cast<uint64_t>(n)) + start;
    const uint8_t* src = data + m[0] + start;
    for (int64_t i = tid; i < len; i += kThreads) dst[i] = src[i];
    return;
  }
  if (b >= n_parts) {  // the streams of a work row's coded parts
    encode_work<true>(work + (b - n_parts) * 3, data, meta, enc, sel, nullptr, nullptr,
                      stream_at, lane_cs, out, tab);
    return;
  }
  const int p = static_cast<int>(b);
  const int64_t* m = meta + static_cast<int64_t>(p) * kMeta;
  const int64_t n = m[1], lane0 = m[3];
  const int L = static_cast<int>(m[2]);
  const bool raw = stream_at[p] < 0;
  uint8_t* blob = out + blob_off[p];
  if (tid == 0) {
    blob[0] = kMagic;
    blob[1] = raw ? kRawFlag : static_cast<uint8_t>(31 - __clz(L));
    put_varint(blob + 2, static_cast<uint64_t>(n));
  }
  if (raw) return;
  const int head = 2 + varint_len(static_cast<uint64_t>(n));
  // 256 frequency varints
  const uint32_t f = static_cast<uint32_t>(freqs[static_cast<int64_t>(p) * 256 + tid]);
  int32_t f_bytes;
  const int32_t f_at = block_excl_scan<int32_t>(f >= 0x80 ? 2 : 1, red32, &f_bytes);
  put_varint(blob + head + f_at, f);
  // lane-length varints, then the states; 4 lanes a thread
  int32_t cnt[4];
  int32_t vl = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = tid * 4 + j;
    cnt[j] = l < L ? counts[lane0 + l] : 0;
    vl += l < L ? varint_len(static_cast<uint32_t>(cnt[j])) : 0;
  }
  int32_t l_bytes;
  int32_t l_at = block_excl_scan<int32_t>(vl, red32, &l_bytes);
  const int64_t lens_at = head + f_bytes, states_at = lens_at + l_bytes;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int l = tid * 4 + j;
    if (l >= L) break;
    l_at += put_varint(blob + lens_at + l_at, static_cast<uint32_t>(cnt[j]));
    const uint32_t x = static_cast<uint32_t>(states[lane0 + l]);
#pragma unroll
    for (int k = 0; k < 4; ++k) blob[states_at + 4 * l + k] = static_cast<uint8_t>(x >> (8 * k));
  }
}

// ---------------------------------------------------------------------------
// rans_decode
// ---------------------------------------------------------------------------

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

// data: u8[n_data] symbols of the flush's parts, 16-byte aligned; meta:
// i64[P, 4] per part (data offset, n >= 1, lanes L, first lane); chunks:
// i64[C, 2] (part, start) of every kChunk bytes of every part; counts:
// u32[P, 256], zero; freqs: i32[P, 256] quantized frequencies; enc: u32[P,
// 256, 2] the encoder's symbol table.
extern "C" int agc_rans_tables(const uint8_t* data, int64_t n_data, const int64_t* meta,
                               const int64_t* chunks, int64_t n_chunks, int64_t n_parts,
                               uint32_t* counts, int32_t* freqs, uint32_t* enc,
                               void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  if (n_parts > INT32_MAX || n_chunks > INT32_MAX || n_chunks < n_parts)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (reinterpret_cast<uintptr_t>(data) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  rans_hist_kernel<<<static_cast<unsigned>(n_chunks), kThreads, 0, st>>>(data, n_data, meta,
                                                                          chunks, counts);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  rans_quantize_kernel<<<static_cast<unsigned>(n_parts), kThreads, 0, st>>>(
      meta, counts, freqs, reinterpret_cast<uint2*>(enc));
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

// blob_off: i64[P + 1] exclusive prefix sum of the blob sizes; stream_at:
// i64[P], where each part's streams start in out, -1 for a raw escape;
// lane_cs: i64[lanes + 1]; out: the blobs, 8-byte aligned.
extern "C" int agc_rans_write(const uint8_t* data, const int64_t* meta, const int64_t* chunks,
                              int64_t n_chunks, const uint32_t* enc, const int32_t* sel,
                              const int32_t* work, int64_t n_work, const int32_t* freqs,
                              const int32_t* counts, const int32_t* states,
                              const int64_t* blob_off, const int64_t* stream_at,
                              const int64_t* lane_cs, int64_t n_parts, uint8_t* out,
                              void* stream) {
  using namespace agc::rans;
  if (n_parts <= 0) return 0;
  const int64_t blocks = n_parts + n_work + n_chunks;
  if (n_parts > INT32_MAX || blocks > INT32_MAX ||
      reinterpret_cast<uintptr_t>(out) % 8 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  rans_write_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      data, meta, chunks, reinterpret_cast<const uint2*>(enc), sel, work, freqs, counts, states,
      blob_off, stream_at, lane_cs, static_cast<int>(n_parts), n_work, out);
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
