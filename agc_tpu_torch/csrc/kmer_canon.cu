// Canonical k-mer fill for splitter discovery: for every position of every
// packed row, where(valid, min(dir, rc) << (64 - 2k), SENTINEL), written
// straight into the int64 pool in the port's convention (bit 63 flipped,
// so SENTINEL is INT64_MAX and sorts last).
//
// Replaces the TPU kernel _kmer_halves_kernel / _kmer_halves_grid_kernel
// via kmer_halves_pallas and kmer_core_via_pallas
// (agc_tpu/ops/pallas_kmers.py:106-213) together with the canon_rows_p4
// epilogue (agc_tpu/ops/kmers.py:747-758): the TPU kernel built u32
// halves with a k-step shift-add ladder and left validity to a cumsum in
// XLA; here one thread rolls both orientations over 32 consecutive
// positions (after 32 warm-up symbols, of which the last k-1 count) in
// native 64-bit registers and tracks the run of valid symbols, so
// validity needs no cumsum.
//
// What bounds it on the H100: the 8-byte store per position (16x the
// 0.5-byte packed input), 537 MB for a 64 Mi-symbol contig. The kernel
// this one replaces stored each thread's position straight from the
// rolling loop: the lanes of a warp stored 256 B apart, one sector each,
// and reached ~245 GB/s. Here a block of 128 threads takes a tile of
// 4096 positions: it loads the tile's packed bytes (and the 16 before
// them, the warm-up) into shared memory with coalesced loads, each thread
// takes its 32 symbols and the 32 before them as two 16-byte shared
// loads, rolls them in registers and stages its 32 codes in shared memory
// (a stride of 33 words, so that the 64-bit stores of a half-warp fall on
// distinct banks); then the block writes the tile with neighbouring
// threads on neighbouring 8-byte words, 256 contiguous bytes a warp. The
// tile is the kernel's own (kmer_common.cuh's kTile serves dir_mix): its
// 35 KB of static shared memory let six blocks share an SM, so that one
// block's stores overlap another's rolling.
//
// kmer_dir_rc, on the same tile, writes all of kmer_halves_pallas's
// outputs instead of their minimum: per position the direct and the
// reverse-complement codes (left-aligned, flipped int64), the valid flag
// (uint8) and, given a set, membership of the canonical code in it (the
// dense scan of -f: agc_tpu's contig_kmers_dir_rc and
// contig_kmers_dir_rc_with_membership, ops/kmers.py:251-264, through
// kmer_core_via_pallas, pallas_kmers.py:197-213). It is bound by its 17
// bytes out a position (18 with membership) against 0.5 in.
//
// The set is looked up in a sector-bucket table that set_table_build
// (below) makes once a set: 2^bits buckets of four int64 slots, 32 bytes,
// one DRAM sector, a bucket chosen by a multiplicative hash of the code.
// Not by its top bits: a canonical code is the smaller orientation, so the
// low prefixes are twice as dense as the mean; and not by a rank
// interpolated in the set's order either: the mutated copies of a repeat
// give runs of nearly equal codes, which crowd such buckets (on an H100
// run of a 64 Mi-base reference, 5.1% of its singletons spilled that way,
// 2.2% hashed). A bucket holds its four smallest values in ascending order
// and SENTINEL in the slots it does not fill. The values past a bucket's
// fourth (~2% of a set at the 1 to 2 values a bucket that bits gives)
// make a second table of the same form under another multiplier, with
// twice the buckets it needs, and what that one cannot hold is a short
// sorted tail. A lookup reads its bucket as two 16-byte loads of one
// sector and compares all four slots: no dependent second read, as the
// walk index's directory needed. Only a code above the last slot of a
// full bucket can be past it, so only such a code (~2% of lookups) reads
// the second table, and only its spills search the tail; a warp waits on
// any of its lanes' searches, so a binary search over the whole spill
// would stall nearly every round. A set of a reference's singletons does
// not fit in L2 (55.6 M values: 1.07 GB of buckets), so a lookup is one
// random sector of DRAM, and an H100 serves those at ~27-33 G a second:
// that, not the bytes the bound counts, holds the set form back. Each
// thread keeps kInFlight lookups in flight.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kCanonThreads = 128;
constexpr int kInFlight = 8;  // set lookups a thread keeps in flight
constexpr int kSetSlots = 4;   // int64 slots a bucket: one 32-byte sector
constexpr int kSetAhead = 4;   // values an inserting thread reads ahead
constexpr int kSetSliceBits = 19;  // buckets of a partition: 2^19 x 32 B = 16 MB of L2
constexpr int kPartChunk = 4096;   // values a block of the partition passes
constexpr int kCanonTile = kCanonThreads * kPerThread;  // positions a block
constexpr int kInBytes = 16 + kCanonTile / 2;  // warm-up bytes + the tile's
constexpr int kStage = kCanonTile + kCanonTile / 32;

__device__ __forceinline__ int padded(int j) { return j + (j >> 5); }

// The tile's packed bytes and the 16 before them, coalesced; bytes outside
// the row are invalid symbols.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ row, int64_t half,
                                          int64_t base, uint8_t* s_in) {
  const int64_t byte0 = base / 2 - 16;
  for (int j = threadIdx.x; j < kInBytes; j += kCanonThreads) {
    const int64_t at = byte0 + j;
    s_in[j] = at >= 0 && at < half ? row[at] : 0xFF;
  }
  __syncthreads();
}

enum class Code { kCanon, kDir, kRc };

// Rolls the thread's 32 positions after its 32 warm-up symbols (`words`,
// two 16-byte shared loads) and stages one code a position in s_out, left
// aligned and flipped: the canonical code where the window is valid and
// SENTINEL elsewhere (kCanon), or the direct or the reverse-complement
// code at every position (kDir, kRc). An invalid symbol counts as 0 in the
// direct code and as 3 in the reverse complement, as do the symbols before
// the row's start.
template <Code kWhat>
__device__ __forceinline__ void roll_stage(const uint32_t (&words)[8], int k,
                                           int64_t* s_out) {
  const uint64_t mask = kmer_mask(k);
  const int rc_shift = 2 * (k - 1);
  const int align = 64 - 2 * k;
  const int j0 = kPerThread * threadIdx.x;
  DirRoll r;
  uint64_t rc = 0;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const uint32_t c = (words[w] >> (4 * s)) & 15u;
      r.push(c, mask);
      const uint64_t comp = c > 3u ? 3ull : static_cast<uint64_t>(3u - c);
      rc = (rc >> 2) | (comp << rc_shift);
      if (w >= 4) {
        uint64_t u;
        if (kWhat == Code::kDir) {
          u = r.dir << align;
        } else if (kWhat == Code::kRc) {
          u = rc << align;
        } else {
          u = r.run >= k ? (r.dir < rc ? r.dir : rc) << align : ~0ull;
        }
        s_out[padded(j0 + 8 * (w - 4) + s)] = static_cast<int64_t>(u ^ 0x8000000000000000ull);
      }
    }
  }
}

__device__ __forceinline__ void thread_words(const uint8_t* s_in, uint32_t (&words)[8]) {
  const uint4 prev = *reinterpret_cast<const uint4*>(s_in + 16 * threadIdx.x);
  const uint4 own = *reinterpret_cast<const uint4*>(s_in + 16 * threadIdx.x + 16);
  words[0] = prev.x, words[1] = prev.y, words[2] = prev.z, words[3] = prev.w;
  words[4] = own.x, words[5] = own.y, words[6] = own.z, words[7] = own.w;
}

// The block writes its m staged codes, neighbouring threads on neighbouring
// 8-byte words.
__device__ __forceinline__ void store_tile(const int64_t* s_out, int64_t* __restrict__ dst,
                                           int m) {
  for (int j = threadIdx.x; j < m; j += kCanonThreads) dst[j] = s_out[padded(j)];
}

__device__ __forceinline__ int tile_len(int64_t n, int64_t base) {
  const int64_t left = n - base;
  return left < kCanonTile ? static_cast<int>(left) : kCanonTile;
}

__global__ void __launch_bounds__(kCanonThreads)
    kmer_canon_kernel(const uint8_t* __restrict__ packed, int64_t half,
                      int64_t n, int k, int64_t* __restrict__ out) {
  __shared__ __align__(16) uint8_t s_in[kInBytes];
  __shared__ int64_t s_out[kStage];
  const int64_t b = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCanonTile;
  load_tile(packed + b * half, half, base, s_in);
  uint32_t words[8];
  thread_words(s_in, words);
  roll_stage<Code::kCanon>(words, k, s_out);
  __syncthreads();
  store_tile(s_out, out + b * n + base, tile_len(n, base));
}

// One table of a set: 2^bits buckets, and the odd multiplier of its hash.
struct SetLevel {
  const longlong2* __restrict__ buckets;
  uint64_t hash;
  int bits;
};

struct SetTable {
  SetLevel first, second;            // the set, then what its buckets spill
  const int64_t* __restrict__ tail;  // what the second spills, sorted
  int64_t n_tail;
};

// The bucket of a flipped code: the top `bits` bits of (v ^ (v >> 32)) *
// hash (the fold lets the zero low bits of a small k's left-aligned codes
// take part), bits in [1, 63].
__device__ __forceinline__ uint64_t set_bucket(int64_t v, uint64_t hash, int bits) {
  const uint64_t x = static_cast<uint64_t>(v);
  return ((x ^ (x >> 32)) * hash) >> (64 - bits);
}

// lower_bound of v in the sorted tail. Out of line: only a code that
// spills from both tables comes here.
static __device__ __noinline__ bool in_tail(const int64_t* tail, int64_t n, int64_t v) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (__ldg(tail + mid) < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n && __ldg(tail + lo) == v;
}

// True when v is in the bucket (a, b); *spill when it is not but may be
// past it: the bucket is full and v is above its last slot.
__device__ __forceinline__ bool in_bucket(const longlong2& a, const longlong2& b, long long v,
                                          bool* spill) {
  const bool h = a.x == v || a.y == v || b.x == v || b.y == v;
  *spill = !h && b.y != INT64_MAX && v > b.y;
  return h;
}

// hit[j] = v[j] is in the set (SENTINEL never is). All P first-table
// buckets are loaded before any is compared, so their sectors are in
// flight together; a spill reads the second table, then the tail.
template <int P>
__device__ __forceinline__ void set_lookup(const SetTable& t, const int64_t (&v)[P],
                                           bool (&hit)[P]) {
  longlong2 lo[P], hi[P];
#pragma unroll
  for (int j = 0; j < P; ++j) {
    if (v[j] != INT64_MAX) {
      const longlong2* b = t.first.buckets + 2 * set_bucket(v[j], t.first.hash, t.first.bits);
      lo[j] = __ldg(b);
      hi[j] = __ldg(b + 1);
    } else {
      lo[j] = hi[j] = make_longlong2(INT64_MAX, INT64_MAX);
    }
  }
#pragma unroll
  for (int j = 0; j < P; ++j) {
    bool spill;
    bool h = v[j] != INT64_MAX && in_bucket(lo[j], hi[j], v[j], &spill);
    if (v[j] != INT64_MAX && spill) {
      const longlong2* b = t.second.buckets + 2 * set_bucket(v[j], t.second.hash, t.second.bits);
      h = in_bucket(__ldg(b), __ldg(b + 1), v[j], &spill);
      if (spill) h = in_tail(t.tail, t.n_tail, v[j]);
    }
    hit[j] = h;
  }
}

// kmer_dir_rc: three rolls of the same registers, each staged and stored
// coalesced in turn (one int64 stage fits the static shared memory, two do
// not): the direct codes, the reverse complements, then the canonical
// codes, which stay in the stage for the flags. A thread then takes the
// positions threadIdx.x + 128 r and writes each one's valid flag (its
// canonical code is not SENTINEL) and, when a set is given, its
// membership: kInFlight lookups in the set's table at once.
__global__ void __launch_bounds__(kCanonThreads)
    kmer_dir_rc_kernel(const uint8_t* __restrict__ packed, int64_t half, int64_t n,
                       int k, int64_t* __restrict__ udir, int64_t* __restrict__ urc,
                       uint8_t* __restrict__ valid, uint8_t* __restrict__ member,
                       SetTable set) {
  __shared__ __align__(16) uint8_t s_in[kInBytes];
  __shared__ int64_t s_out[kStage];
  const int64_t b = blockIdx.y;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kCanonTile;
  const int64_t at = b * n + base;
  const int m = tile_len(n, base);
  load_tile(packed + b * half, half, base, s_in);
  uint32_t words[8];
  thread_words(s_in, words);
  roll_stage<Code::kDir>(words, k, s_out);
  __syncthreads();
  store_tile(s_out, udir + at, m);
  __syncthreads();
  roll_stage<Code::kRc>(words, k, s_out);
  __syncthreads();
  store_tile(s_out, urc + at, m);
  __syncthreads();
  roll_stage<Code::kCanon>(words, k, s_out);
  __syncthreads();
  if (member == nullptr) {
    for (int j = threadIdx.x; j < m; j += kCanonThreads) {
      valid[at + j] = s_out[padded(j)] != INT64_MAX;
    }
    return;
  }
  for (int r = 0; r < kPerThread; r += kInFlight) {
    int64_t v[kInFlight];
    bool hit[kInFlight];
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int j = threadIdx.x + kCanonThreads * (r + q);
      v[q] = j < m ? s_out[padded(j)] : INT64_MAX;
    }
    set_lookup(set, v, hit);
#pragma unroll
    for (int q = 0; q < kInFlight; ++q) {
      const int j = threadIdx.x + kCanonThreads * (r + q);
      if (j < m) {
        valid[at + j] = v[q] != INT64_MAX;
        member[at + j] = hit[q];
      }
    }
  }
}

// set_table_build's fill: every slot SENTINEL, the spill count 0.
__global__ void set_fill_kernel(longlong2* __restrict__ halves, int64_t n_halves,
                                unsigned long long* __restrict__ count) {
  const longlong2 empty = make_longlong2(INT64_MAX, INT64_MAX);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < n_halves;
       i += stride) {
    halves[i] = empty;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *count = 0;
}

// The partition of a value: the top pbits bits of its bucket (0 when
// pbits is 0), so that a partition's buckets are one slice of the table.
__device__ __forceinline__ uint32_t set_part(int64_t v, uint64_t hash, int bits, int pbits) {
  return pbits ? static_cast<uint32_t>(set_bucket(v, hash, bits) >> (bits - pbits)) : 0u;
}

// agc_set_partition_count: each block counts its kPartChunk values by
// partition in shared memory, counts[p * blocks + block].
__global__ void set_count_kernel(const int64_t* __restrict__ values, int64_t n, uint64_t hash,
                                 int bits, int pbits, int32_t* __restrict__ counts) {
  extern __shared__ uint32_t hist[];
  const int parts = 1 << pbits;
  for (int p = threadIdx.x; p < parts; p += blockDim.x) hist[p] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kPartChunk;
  const int64_t end = n - base < kPartChunk ? n : base + kPartChunk;
  for (int64_t i = base + threadIdx.x; i < end; i += blockDim.x) {
    atomicAdd(hist + set_part(values[i], hash, bits, pbits), 1u);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < parts; p += blockDim.x) {
    counts[static_cast<int64_t>(p) * gridDim.x + blockIdx.x] = static_cast<int32_t>(hist[p]);
  }
}

// Exclusive prefix sum of a[0, n) in shared memory, in place; every thread
// of the block calls it. scratch: kThreads words.
__device__ void block_exclusive_scan(uint32_t* a, int n, uint32_t* scratch) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < n ? lo + per : n;
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  scratch[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t run = 0;
    for (int t = 0; t < kThreads; ++t) {
      const uint32_t x = scratch[t];
      scratch[t] = run;
      run += x;
    }
  }
  __syncthreads();
  uint32_t run = scratch[threadIdx.x];
  for (int i = lo; i < hi; ++i) {
    const uint32_t x = a[i];
    a[i] = run;
    run += x;
  }
  __syncthreads();
}

// set_table_build's partition pass: each block moves its kPartChunk values
// to their places in the partitions (offsets: the exclusive prefix sum of
// counts, in the same layout). It sorts them by partition in shared memory
// first (the order inside a partition is the shared atomics', which the
// inserts do not depend on), so that its writes are runs of ~chunk /
// partitions values, neighbouring threads on neighbouring words. Shared
// memory: the chunk, then per partition its local start, cursor and
// global offset.
__global__ void __launch_bounds__(kThreads)
    set_scatter_kernel(const int64_t* __restrict__ values, int64_t n, uint64_t hash, int bits,
                       int pbits, const int64_t* __restrict__ offsets,
                       int64_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int parts = 1 << pbits;
  int64_t* staged = reinterpret_cast<int64_t*>(smem);
  int64_t* base_of = staged + kPartChunk;
  uint32_t* start = reinterpret_cast<uint32_t*>(base_of + parts);
  uint32_t* cursor = start + parts;
  __shared__ uint32_t scratch[kThreads];
  for (int p = threadIdx.x; p < parts; p += kThreads) {
    start[p] = 0;
    cursor[p] = 0;
    base_of[p] = offsets[static_cast<int64_t>(p) * gridDim.x + blockIdx.x];
  }
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kPartChunk;
  const int m = n - base < kPartChunk ? static_cast<int>(n - base) : kPartChunk;
  for (int j = threadIdx.x; j < m; j += kThreads) {
    atomicAdd(start + set_part(values[base + j], hash, bits, pbits), 1u);
  }
  __syncthreads();
  block_exclusive_scan(start, parts, scratch);
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const int64_t v = values[base + j];
    const uint32_t p = set_part(v, hash, bits, pbits);
    staged[start[p] + atomicAdd(cursor + p, 1u)] = v;
  }
  __syncthreads();
  for (int j = threadIdx.x; j < m; j += kThreads) {
    const int64_t v = staged[j];
    const uint32_t p = set_part(v, hash, bits, pbits);
    out[base_of[p] + (j - start[p])] = v;
  }
}

// Second launch: each value goes into its bucket by a chain of atomicMin
// down the four slots. A slot keeps the smaller of what it held and what
// arrives and passes the larger on; the chain stops at an empty slot.
// Whatever the order of the threads, each slot ends as the least value
// that ever reached it, so a bucket ends as its four smallest values in
// order, and a value passed on from the last slot is one of the rest: it
// is appended to spill (up to cap; count says how many there were, so the
// wrapper can build again with room for all). An atomic on a sector that
// is not in L2 costs a DRAM read and a write-back of its own, so a table
// of more than 2^19 buckets gets its values by partition (the scatter
// pass), and the blocks sweep the table one 16 MB slice after another, in
// L2, where the atomics, not DRAM, set the pace. A thread reads kSetAhead
// buckets at once, and its chain starts at the first slot not already
// below its value: a slot only falls, so such a slot would pass the value
// on unchanged. SENTINEL, which no code looks up, is skipped.
__global__ void set_insert_kernel(const int64_t* __restrict__ values, int64_t n, uint64_t hash,
                                  int bits, long long* __restrict__ slots,
                                  int64_t* __restrict__ spill, int64_t cap,
                                  unsigned long long* __restrict__ count) {
  // a block takes kSetAhead * 256 consecutive values, so the blocks on the
  // card at once cover ~1 M values: a 20 MB stretch of the partitions
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * kSetAhead * blockDim.x + threadIdx.x;
  long long v[kSetAhead];
  uint64_t b[kSetAhead];
  longlong2 lo[kSetAhead], hi[kSetAhead];
#pragma unroll
  for (int q = 0; q < kSetAhead; ++q) {
    const int64_t i = i0 + q * blockDim.x;
    v[q] = i < n ? values[i] : INT64_MAX;
    b[q] = set_bucket(v[q], hash, bits);
    if (v[q] != INT64_MAX) {
      const longlong2* at = reinterpret_cast<const longlong2*>(slots) + 2 * b[q];
      lo[q] = __ldcg(at);
      hi[q] = __ldcg(at + 1);
    }
  }
#pragma unroll
  for (int q = 0; q < kSetAhead; ++q) {
    if (v[q] == INT64_MAX) continue;
    const long long seen[kSetSlots] = {lo[q].x, lo[q].y, hi[q].x, hi[q].y};
    long long x = v[q];
    long long* s = slots + kSetSlots * b[q];
    int j = 0;
    while (j < kSetSlots && seen[j] < x) ++j;
    for (; j < kSetSlots; ++j) {
      const long long old = atomicMin(s + j, x);
      if (old == INT64_MAX) break;
      x = old > x ? old : x;
    }
    if (j == kSetSlots) {
      const unsigned long long to = atomicAdd(count, 1ull);
      if (to < static_cast<unsigned long long>(cap)) spill[to] = x;
    }
  }
}

unsigned grid_for(int64_t items) {
  const int64_t blocks = (items + 255) / 256;
  return static_cast<unsigned>(blocks < 132 * 32 ? (blocks > 0 ? blocks : 1) : 132 * 32);
}

}  // namespace
}  // namespace agc

// packed: u8[B, half]; out: int64[B, 2 * half].
extern "C" int agc_kmer_canon(const uint8_t* packed, int64_t B, int64_t half,
                              int k, int64_t* out, void* stream) {
  using namespace agc;
  const int64_t n = 2 * half;
  if (B <= 0 || n <= 0) return 0;
  const int64_t n_tiles = (n + kCanonTile - 1) / kCanonTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  kmer_canon_kernel<<<grid, kCanonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, out);
  return static_cast<int>(cudaGetLastError());
}

// packed: u8[B, half]; udir, urc: int64[B, 2 * half]; valid: u8[B, 2 * half];
// member: u8[B, 2 * half] or null (no set); buckets1, hash1, bits1 and
// buckets2, hash2, bits2: the set's two tables (agc_set_table_build), tail
// and n_tail what the second spills, sorted; read only when member is
// given.
extern "C" int agc_kmer_dir_rc(const uint8_t* packed, int64_t B, int64_t half, int k,
                               int64_t* udir, int64_t* urc, uint8_t* valid, uint8_t* member,
                               const int64_t* buckets1, uint64_t hash1, int bits1,
                               const int64_t* buckets2, uint64_t hash2, int bits2,
                               const int64_t* tail, int64_t n_tail, void* stream) {
  using namespace agc;
  const int64_t n = 2 * half;
  if (B <= 0 || n <= 0) return 0;
  if (member != nullptr && (bits1 < 1 || bits1 > 40 || bits2 < 1 || bits2 > 40))
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_tiles = (n + kCanonTile - 1) / kCanonTile;
  const dim3 grid(static_cast<unsigned>(n_tiles), static_cast<unsigned>(B));
  const SetTable set{{reinterpret_cast<const longlong2*>(buckets1), hash1, bits1},
                     {reinterpret_cast<const longlong2*>(buckets2), hash2, bits2}, tail, n_tail};
  kmer_dir_rc_kernel<<<grid, kCanonThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      packed, half, n, k, udir, urc, valid, member, set);
  return static_cast<int>(cudaGetLastError());
}

// Values a block of the partition passes.
extern "C" int agc_set_part_chunk() { return agc::kPartChunk; }

// Partition bits of a 2^bits-bucket table: slices of at most 2^19 buckets.
extern "C" int agc_set_part_bits(int bits) {
  return bits > agc::kSetSliceBits ? bits - agc::kSetSliceBits : 0;
}

// values: int64[n]; counts: int32[2^pbits * blocks], blocks = ceil(n /
// agc_set_part_chunk()), partition-major.
extern "C" int agc_set_partition_count(const int64_t* values, int64_t n, uint64_t hash, int bits,
                                       int pbits, int32_t* counts, void* stream) {
  using namespace agc;
  const int64_t blocks = (n + kPartChunk - 1) / kPartChunk;
  if (n <= 0) return 0;
  if (pbits < 1 || pbits > 12 || pbits > bits || blocks > INT32_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  set_count_kernel<<<static_cast<unsigned>(blocks), 256, sizeof(uint32_t) << pbits,
                     static_cast<cudaStream_t>(stream)>>>(values, n, hash, bits, pbits, counts);
  return static_cast<int>(cudaGetLastError());
}

// One table of a set: values: int64[n], in any order (SENTINEL entries are
// skipped); hash: an odd multiplier; pbits: agc_set_part_bits(bits), and
// when it is not 0, offsets: the exclusive prefix sum of
// agc_set_partition_count's counts (int64, same layout) and part: int64[n]
// scratch; buckets: int64[4 << bits], 16-byte aligned; spill: int64[cap],
// the values past a bucket's four, in no order; count: u64, the number of
// them (all, also past cap). Launches: the partition pass (when pbits is
// not 0), the fill, the inserts.
extern "C" int agc_set_table_build(const int64_t* values, int64_t n, uint64_t hash, int bits,
                                   int pbits, const int64_t* offsets, int64_t* part,
                                   int64_t* buckets, int64_t* spill, int64_t cap,
                                   unsigned long long* count, void* stream) {
  using namespace agc;
  if (bits < 1 || bits > 40 || n < 0 || cap < 0 || (hash & 1) == 0 || pbits < 0 ||
      pbits > 12 || pbits > bits || reinterpret_cast<uintptr_t>(buckets) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (pbits > 0 && n > 0) {
    const size_t smem = kPartChunk * sizeof(int64_t) + ((sizeof(int64_t) + 8) << pbits);
    cudaError_t e = cudaFuncSetAttribute(set_scatter_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    set_scatter_kernel<<<static_cast<unsigned>((n + kPartChunk - 1) / kPartChunk), kThreads,
                         smem, st>>>(values, n, hash, bits, pbits, offsets, part);
    values = part;
  }
  const int64_t halves = int64_t{2} << bits;
  set_fill_kernel<<<grid_for(halves), 256, 0, st>>>(reinterpret_cast<longlong2*>(buckets),
                                                     halves, count);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n == 0) return static_cast<int>(e);
  const int64_t blocks = (n + kSetAhead * 256 - 1) / (kSetAhead * 256);
  if (blocks > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  set_insert_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
      values, n, hash, bits, reinterpret_cast<long long*>(buckets), spill, cap, count);
  return static_cast<int>(cudaGetLastError());
}
