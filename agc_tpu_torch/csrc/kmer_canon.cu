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
// The set is looked up in a sector-bucket table that set_table
// (agc_set_slice_build, below) makes once a set: 2^bits buckets of four
// int64 slots, 32 bytes, one DRAM sector, a bucket chosen by a
// multiplicative hash of the code.
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
//
// The build writes each table in slices of 2^11 buckets, 64 KB, one
// block's shared memory: a block takes a slice's values, builds its image
// there and writes it whole, SENTINELs included, with coalesced 16-byte
// stores; its spill goes out at an offset from a decoupled look-back. So
// the table is written once, with no fill pass and no global atomic. A set
// of up to four slices (16,384 values) is read whole by each slice's
// block. A larger one is first moved to its slices by one or two partition
// levels of at most 2^10 bins (a count, torch.cumsum of the counts, a
// scatter): two at -f discovery's 55.6 M values (2^14 slices), the first
// writing into the table's own memory, which the build then overwrites,
// so beside the set the build holds the table, one scratch copy of the set
// and the counts. The bound is the set read once and the table written
// once; each partition level adds two reads and a write of the set.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kCanonThreads = 128;
constexpr int kInFlight = 8;  // set lookups a thread keeps in flight
constexpr int kSetSlots = 4;   // int64 slots a bucket: one 32-byte sector
constexpr int kSetAhead = 16;  // values a thread of the set build reads at once
constexpr int kSetSliceBits = 11;  // buckets of a slice: 2^11 x 32 B = 64 KB of shared memory
constexpr int kSliceThreads = 256;
static_assert(kSliceThreads == kThreads, "block_exclusive_scan is written for kThreads");
constexpr int kPartChunk = 4096;   // values a block of a partition level stages at once
constexpr int kPartMaxBits = 10;   // bins of a partition level
constexpr int kSetDirectSlices = 4;  // slices of a table built without a partition
// values a slice's block sorts in its shared memory: what the chain
// path's image and tie counters take (36 bytes a bucket), less a word a
// bucket for its place and one for its spill's, 8 bytes a value
constexpr int kSliceCap = (28 << kSetSliceBits) / 8;
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

// ---------------------------------------------------------------------------
// set_table's build: partitions by slice, then a block a slice in shared
// memory
// ---------------------------------------------------------------------------

// The partition bin of a value: bits [shift, shift + pbits) of its bucket.
__device__ __forceinline__ uint32_t set_bin(int64_t v, uint64_t hash, int bits, int shift,
                                            int pbits) {
  return static_cast<uint32_t>(set_bucket(v, hash, bits) >> shift) & ((1u << pbits) - 1u);
}

// The source of a partition level: `segs` segments (the whole of [0, n)
// when seg is null, else segment a is [seg[a * stride], seg[(a + 1) *
// stride]), the bins of the level before), each cut into q pieces of
// ceil(m / q) values. Block a * q + j takes piece j of segment a.
struct Pieces {
  const int32_t* __restrict__ seg;
  int64_t stride;
  int64_t n;
  int64_t q;

  __device__ __forceinline__ void range(int64_t block, int64_t* lo, int64_t* hi) const {
    const int64_t a = block / q, j = block % q;
    const int64_t s = seg ? seg[a * stride] : 0;
    const int64_t e = seg ? seg[(a + 1) * stride] : n;
    const int64_t per = (e - s + q - 1) / q;
    *lo = s + j * per < e ? s + j * per : e;
    *hi = *lo + per < e ? *lo + per : e;
  }
};

// The count of a level: each block counts its piece by bin in shared
// memory, counts[((a << pbits) + bin) * q + j], so that the exclusive sum of
// counts in that order gives each bin's piece its place, the bins of a
// segment in turn and a bin's pieces in order.
__global__ void __launch_bounds__(kThreads)
    set_count_kernel(const int64_t* __restrict__ src, Pieces pc, uint64_t hash, int bits,
                     int shift, int pbits, int32_t* __restrict__ counts) {
  __shared__ uint32_t hist[1 << kPartMaxBits];
  const int bins = 1 << pbits;
  for (int c = threadIdx.x; c < bins; c += kThreads) hist[c] = 0;
  __syncthreads();
  int64_t lo, hi;
  pc.range(blockIdx.x, &lo, &hi);
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kSetAhead * kThreads) {
    int64_t v[kSetAhead];  // loads in flight together
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      const int64_t i = i0 + q * kThreads;
      v[q] = i < hi ? src[i] : 0;
    }
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      if (i0 + q * kThreads < hi) atomicAdd(hist + set_bin(v[q], hash, bits, shift, pbits), 1u);
    }
  }
  __syncthreads();
  const int64_t a = blockIdx.x / pc.q, j = blockIdx.x % pc.q;
  for (int c = threadIdx.x; c < bins; c += kThreads) {
    counts[((a << pbits) + c) * pc.q + j] = static_cast<int32_t>(hist[c]);
  }
}

// Exclusive prefix sum of a[0, n) in shared memory, in place; every thread
// of the block (kThreads of them) calls it, and each gets the total.
// scratch: kThreads / 32 words.
__device__ uint32_t block_exclusive_scan(uint32_t* a, int n, uint32_t* scratch) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = threadIdx.x * per;
  const int hi = lo + per < n ? lo + per : n;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t sum = 0;
  for (int i = lo; i < hi; ++i) sum += a[i];
  uint32_t incl = sum;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) scratch[warp] = incl;
  __syncthreads();
  uint32_t run = incl - sum, total = 0;
  for (int w = 0; w < kThreads / 32; ++w) {
    run += w < warp ? scratch[w] : 0;
    total += scratch[w];
  }
  for (int i = lo; i < hi; ++i) {
    const uint32_t x = a[i];
    a[i] = run;
    run += x;
  }
  __syncthreads();
  return total;
}

// The scatter of a level: each block moves its piece to its bins' places
// (offsets: the exclusive sum of set_count_kernel's counts, then the
// total), kPartChunk values at a time. It sorts each chunk by bin in shared
// memory first (the order inside a bin is the shared atomics', which the
// slice build does not depend on), so that its writes are runs of about
// chunk / bins values, neighbouring threads on neighbouring words.
__global__ void __launch_bounds__(kThreads, 4)
    set_scatter_kernel(const int64_t* __restrict__ src, Pieces pc, uint64_t hash, int bits,
                       int shift, int pbits, const int32_t* __restrict__ offsets,
                       int64_t* __restrict__ out) {
  __shared__ int64_t staged[kPartChunk];
  __shared__ uint32_t start[1 << kPartMaxBits], cursor[1 << kPartMaxBits];
  __shared__ int32_t base[1 << kPartMaxBits];
  __shared__ uint32_t scratch[kThreads / 32];
  constexpr int kPer = kPartChunk / kThreads;
  const int bins = 1 << pbits;
  const int64_t a = blockIdx.x / pc.q, j = blockIdx.x % pc.q;
  for (int c = threadIdx.x; c < bins; c += kThreads) base[c] = offsets[((a << pbits) + c) * pc.q + j];
  int64_t lo, hi;
  pc.range(blockIdx.x, &lo, &hi);
  for (int64_t at = lo; at < hi; at += kPartChunk) {
    const int m = hi - at < kPartChunk ? static_cast<int>(hi - at) : kPartChunk;
    for (int c = threadIdx.x; c < bins; c += kThreads) start[c] = cursor[c] = 0;
    __syncthreads();
    int64_t v[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int i = threadIdx.x + r * kThreads;
      v[r] = i < m ? src[at + i] : 0;
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (threadIdx.x + r * kThreads < m) {
        atomicAdd(start + set_bin(v[r], hash, bits, shift, pbits), 1u);
      }
    }
    __syncthreads();
    block_exclusive_scan(start, bins, scratch);
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (threadIdx.x + r * kThreads < m) {
        const uint32_t c = set_bin(v[r], hash, bits, shift, pbits);
        staged[start[c] + atomicAdd(cursor + c, 1u)] = v[r];
      }
    }
    __syncthreads();
    for (int i = threadIdx.x; i < m; i += kThreads) {
      const int64_t x = staged[i];
      const uint32_t c = set_bin(x, hash, bits, shift, pbits);
      out[base[c] + (i - static_cast<int>(start[c]))] = x;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < bins; c += kThreads) base[c] += static_cast<int32_t>(cursor[c]);
  }
}

// Every thread of slice block t, which has published its spill count
// `own`: looks back for the spill before it and publishes the sum; the
// last block writes the whole spill's size to count. Returns the offset.
__device__ __forceinline__ int64_t spill_offset(uint64_t* status, int64_t t, uint64_t own,
                                                int64_t* count) {
  __shared__ int64_t s_look[kSliceThreads / 32];
  const int64_t ex = t > 0 ? look_back<kSliceThreads>(status, t, s_look) : 0;
  if (threadIdx.x == 0) {
    store_relaxed(status + t, kFlagPrefix | (ex + own));
    if (t == gridDim.x - 1) *count = ex + static_cast<int64_t>(own);
  }
  return ex;
}

// A slice of at most kSliceCap values (every slice of a set of typical
// skew), sorted by bucket in shared memory with 32-bit atomics only:
// the slice's values are counted a bucket (their spill too: past four a
// bucket), the counts summed into each bucket's place, and the values read
// again (from L2) and moved there; then a thread a bucket keeps its four
// smallest in order, sends the rest to the spill, and writes the bucket's
// 32 bytes, neighbouring threads on neighbouring buckets. The spill count
// goes out before the second read, the look-back follows it. Shared
// memory: the values, then a word a bucket for its place and one for its
// spill's.
__device__ __forceinline__ void slice_sorted(const int64_t* __restrict__ src, int64_t lo,
                                             int64_t hi, int64_t t, uint64_t hash, int bits,
                                             longlong2* __restrict__ dst,
                                             int64_t* __restrict__ spill, int64_t cap,
                                             uint64_t* __restrict__ status,
                                             int64_t* __restrict__ count, unsigned char* smem) {
  constexpr int kB = 1 << kSetSliceBits;
  constexpr uint32_t kMask = kB - 1;
  __shared__ uint32_t scratch[kSliceThreads / 32];
  long long* placed = reinterpret_cast<long long*>(smem);
  uint32_t* at = reinterpret_cast<uint32_t*>(placed + kSliceCap);
  uint32_t* sp = at + kB;
  for (int b = threadIdx.x; b < kB; b += kSliceThreads) at[b] = 0;
  __syncthreads();
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kSetAhead * kSliceThreads) {
    int64_t v[kSetAhead];
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      const int64_t i = i0 + q * kSliceThreads;
      v[q] = i < hi ? src[i] : INT64_MAX;
    }
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      if (v[q] != INT64_MAX) atomicAdd(at + (set_bucket(v[q], hash, bits) & kMask), 1u);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < kB; b += kSliceThreads) sp[b] = at[b] > 4 ? at[b] - 4 : 0;
  block_exclusive_scan(at, kB, scratch);
  const uint32_t own = block_exclusive_scan(sp, kB, scratch);
  if (threadIdx.x == 0 && t > 0) store_relaxed(status + t, kFlagOwn | own);
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kSetAhead * kSliceThreads) {
    int64_t v[kSetAhead];
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      const int64_t i = i0 + q * kSliceThreads;
      v[q] = i < hi ? src[i] : INT64_MAX;
    }
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      if (v[q] != INT64_MAX) {
        placed[atomicAdd(at + (set_bucket(v[q], hash, bits) & kMask), 1u)] = v[q];
      }
    }
  }
  __syncthreads();  // at[b] is now the end of bucket b
  const int64_t base = spill_offset(status, t, own, count);
  for (int b = threadIdx.x; b < kB; b += kSliceThreads) {
    long long s0 = INT64_MAX, s1 = INT64_MAX, s2 = INT64_MAX, s3 = INT64_MAX;
    int64_t to = base + sp[b];
    for (uint32_t k = b ? at[b - 1] : 0; k < at[b]; ++k) {
      long long x = placed[k];
      if (x < s3) {  // x takes its place, the fourth moves out
        const long long out = s3;
        s3 = x < s2 ? s2 : x;
        if (x < s2) s2 = x < s1 ? s1 : x;
        if (x < s1) s1 = x < s0 ? s0 : x;
        if (x < s0) s0 = x;
        x = out;
      }
      if (x != INT64_MAX) {  // past the bucket's four
        if (to < cap) spill[to] = x;
        ++to;
      }
    }
    dst[2 * b] = make_longlong2(s0, s1);
    dst[2 * b + 1] = make_longlong2(s2, s3);
  }
}

// Any slice (one that outgrows kSliceCap, or one of a set that was not
// partitioned: src is then read whole and the block keeps its slice's
// values), with no bound on its values. Three steps, the image in shared
// memory throughout:
//
// 1. Every slot SENTINEL, then each value into its bucket by a chain of
//    shared atomicMin down the four slots: a slot keeps the smaller of what
//    it held and what arrives and passes the larger on; the chain stops at
//    an empty slot. Whatever the order of the threads, each slot ends as the
//    least value that ever reached it, so a bucket ends as its four smallest
//    values in order, and a value passed on from the last slot is one of
//    the rest, which the block counts.
// 2. The count goes out in status[t], the spill's offset comes from the
//    look-back, and the image is written whole, SENTINELs included, 16
//    bytes a thread, neighbouring threads on neighbouring words.
// 3. The values are read again (from L2) and those past their full
//    bucket's fourth slot go to spill from that offset (up to cap): above
//    the last slot, or equal to it beyond the copies the slots hold (a
//    value held twice), counted by a shared counter a bucket.
//
// On an H100 the 64-bit shared atomicMin chains took most of this build's
// time at -f's 55.6 M-value set, which is why slice_sorted takes every
// slice it can hold.
__device__ __forceinline__ void slice_chains(const int64_t* __restrict__ src, int64_t lo,
                                             int64_t hi, int64_t t, uint64_t hash, int bits,
                                             int sbits, longlong2* __restrict__ dst,
                                             int64_t* __restrict__ spill, int64_t cap,
                                             uint64_t* __restrict__ status,
                                             int64_t* __restrict__ count, unsigned char* smem) {
  const int halves = 2 << sbits;
  longlong2* img2 = reinterpret_cast<longlong2*>(smem);
  long long* img = reinterpret_cast<long long*>(smem);
  uint32_t* ties = reinterpret_cast<uint32_t*>(img2 + halves);
  __shared__ uint32_t s_spilled, s_cursor;
  const uint64_t mask = (uint64_t{1} << sbits) - 1;
  const longlong2 empty = make_longlong2(INT64_MAX, INT64_MAX);
  for (int i = threadIdx.x; i < halves; i += kSliceThreads) img2[i] = empty;
  for (int i = threadIdx.x; i <= static_cast<int>(mask); i += kSliceThreads) ties[i] = 0;
  if (threadIdx.x == 0) s_spilled = s_cursor = 0;
  __syncthreads();
  for (int64_t i0 = lo + threadIdx.x; i0 < hi; i0 += kSetAhead * kSliceThreads) {
    long long v[kSetAhead];
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      const int64_t i = i0 + q * kSliceThreads;
      v[q] = i < hi ? src[i] : INT64_MAX;
    }
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      const uint64_t b = set_bucket(v[q], hash, bits);
      if (v[q] == INT64_MAX || static_cast<int64_t>(b >> sbits) != t) continue;
      long long* s = img + kSetSlots * (b & mask);
      long long x = v[q];
      // a slot only falls: one already below x would pass it on unchanged
      const volatile long long* seen = s;
      int j = 0;
      while (j < kSetSlots && seen[j] < x) ++j;
      for (; j < kSetSlots; ++j) {
        const long long old = atomicMin(s + j, x);
        if (old == INT64_MAX) break;
        x = old > x ? old : x;
      }
      if (j == kSetSlots) atomicAdd(&s_spilled, 1u);
    }
  }
  __syncthreads();
  const uint32_t own = s_spilled;
  if (threadIdx.x == 0 && t > 0) store_relaxed(status + t, kFlagOwn | own);
  for (int i = threadIdx.x; i < halves; i += kSliceThreads) dst[i] = img2[i];
  const int64_t base = spill_offset(status, t, own, count);
  const int lane = threadIdx.x & 31;
  // every lane of a warp takes the loops the same number of times, so the
  // ballot that places the warp's spills together sees all 32
  for (int64_t i0 = lo; i0 < hi; i0 += kSetAhead * kSliceThreads) {
    long long v[kSetAhead];
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      const int64_t i = i0 + q * kSliceThreads + threadIdx.x;
      v[q] = i < hi ? src[i] : INT64_MAX;
    }
#pragma unroll
    for (int q = 0; q < kSetAhead; ++q) {
      bool out = false;
      const uint64_t b = set_bucket(v[q], hash, bits);
      if (v[q] != INT64_MAX && static_cast<int64_t>(b >> sbits) == t) {
        const long long* s = img + kSetSlots * (b & mask);
        const long long last = s[kSetSlots - 1];
        if (last != INT64_MAX && v[q] > last) {
          out = true;
        } else if (last != INT64_MAX && v[q] == last) {
          const uint32_t held = (s[0] == v[q]) + (s[1] == v[q]) + (s[2] == v[q]) + 1;
          out = atomicAdd(ties + (b & mask), 1u) >= held;
        }
      }
      const unsigned m = __ballot_sync(0xffffffffu, out);
      uint32_t first = 0;
      if (lane == 0 && m) first = atomicAdd(&s_cursor, static_cast<uint32_t>(__popc(m)));
      first = __shfl_sync(0xffffffffu, first, 0);
      if (out) {
        const int64_t to = base + first + __popc(m & ((1u << lane) - 1u));
        if (to < cap) spill[to] = v[q];
      }
    }
  }
}

// The build of slice t (blockIdx.x), its 2^sbits buckets: from the values
// in [bounds[t * stride], bounds[(t + 1) * stride]) of src, or from every
// value of src when bounds is null. The slice's image is written whole,
// SENTINELs included: no fill pass and no global atomic. Its spill goes
// to spill from an offset the decoupled look-back gives (up to cap); the
// last block writes the spill's size, all of it, to count.
__global__ void __launch_bounds__(kSliceThreads)
    set_slice_kernel(const int64_t* __restrict__ src, int64_t n,
                     const int32_t* __restrict__ bounds, int64_t stride, uint64_t hash, int bits,
                     int sbits, longlong2* __restrict__ buckets, int64_t* __restrict__ spill,
                     int64_t cap, uint64_t* __restrict__ status, int64_t* __restrict__ count) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int64_t t = blockIdx.x;
  const int64_t lo = bounds ? bounds[t * stride] : 0;
  const int64_t hi = bounds ? bounds[(t + 1) * stride] : n;
  longlong2* dst = buckets + (t << (sbits + 1));
  if (bounds != nullptr && hi - lo <= kSliceCap) {
    slice_sorted(src, lo, hi, t, hash, bits, dst, spill, cap, status, count, smem);
  } else {
    slice_chains(src, lo, hi, t, hash, bits, sbits, dst, spill, cap, status, count, smem);
  }
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
// buckets2, hash2, bits2: the set's two tables (agc_set_slice_build), tail
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


// The constants the build's plan (cuda_kmers.set_partition_plan) is made
// of, into out[5]: the buckets of a slice (a table of 2^bits buckets is
// built in slices of 2^min(bits, kSetSliceBits) buckets, a block a slice),
// the values a slice's block sorts in shared memory, the values a block of
// a partition level stages at once (its pieces' size), the bins of a
// partition level (2^kPartMaxBits at most), and the slices of a table
// that is built unpartitioned (every block reading the whole set).
extern "C" int agc_set_build_constants(int64_t* out) {
  using namespace agc;
  const int64_t c[5] = {kSetSliceBits, kSliceCap, kPartChunk, kPartMaxBits, kSetDirectSlices};
  for (int i = 0; i < 5; ++i) out[i] = c[i];
  return 0;
}

namespace {

// The arguments both partition passes check: pbits in [1, 10], the bins
// within the bucket's bits, the grid a positive int.
bool bad_level(const int64_t* src, int64_t n, int64_t segs, int64_t q, uint64_t hash, int bits,
               int shift, int pbits) {
  return src == nullptr || n <= 0 || n > INT32_MAX || segs < 1 || q < 1 ||
         segs * q > INT32_MAX || (hash & 1) == 0 || bits < 1 || bits > 40 || shift < 0 ||
         pbits < 1 || pbits > agc::kPartMaxBits || shift + pbits > bits ||
         (segs << pbits) * q >= INT32_MAX;
}

}  // namespace

// One partition level's count. src: int64[n]; the source's segments:
// [0, n) when seg is null (segs = 1), else segment a in [seg[a * stride],
// seg[(a + 1) * stride]); each cut into q pieces; bins: bits [shift,
// shift + pbits) of a value's bucket (hash, bits); counts: int32[(segs <<
// pbits) * q], bin-major within a segment.
extern "C" int agc_set_partition_count(const int64_t* src, int64_t n, const int32_t* seg,
                                       int64_t stride, int64_t segs, int64_t q, uint64_t hash,
                                       int bits, int shift, int pbits, int32_t* counts,
                                       void* stream) {
  using namespace agc;
  if (bad_level(src, n, segs, q, hash, bits, shift, pbits))
    return static_cast<int>(cudaErrorInvalidValue);
  set_count_kernel<<<static_cast<unsigned>(segs * q), kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(src, Pieces{seg, stride, n, q}, hash,
                                                          bits, shift, pbits, counts);
  return static_cast<int>(cudaGetLastError());
}

// The same level's scatter: offsets: int32[(segs << pbits) * q + 1], the
// exclusive sums of the counts and then n; out: int64[n], the values by
// bin, a segment's bins in turn (the next level's segments: seg = offsets,
// stride = q).
extern "C" int agc_set_partition_scatter(const int64_t* src, int64_t n, const int32_t* seg,
                                         int64_t stride, int64_t segs, int64_t q,
                                         uint64_t hash, int bits, int shift, int pbits,
                                         const int32_t* offsets, int64_t* out, void* stream) {
  using namespace agc;
  if (bad_level(src, n, segs, q, hash, bits, shift, pbits))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t e = cudaFuncSetAttribute(set_scatter_kernel,
                                             cudaFuncAttributePreferredSharedMemoryCarveout,
                                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_scatter_kernel<<<static_cast<unsigned>(segs * q), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(src, Pieces{seg, stride, n, q},
                                                            hash, bits, shift, pbits, offsets,
                                                            out);
  return static_cast<int>(cudaGetLastError());
}

// One table of a set, 2^bits buckets, slice by slice: src: int64[n] (SENTINEL
// entries are skipped); bounds: null (every block reads all of src and keeps
// its slice's values) or the last partition level's offsets, slice t's
// values in [bounds[t * stride], bounds[(t + 1) * stride]); hash: an odd
// multiplier; buckets: int64[4 << bits], 16-byte aligned, written whole;
// spill: int64[cap], the values past a bucket's four, in no order; status:
// u64[slices], zero; count: int64, the spill's size (all of it, also past
// cap). One launch.
extern "C" int agc_set_slice_build(const int64_t* src, int64_t n, const int32_t* bounds,
                                   int64_t stride, uint64_t hash, int bits, int64_t* buckets,
                                   int64_t* spill, int64_t cap, uint64_t* status, int64_t* count,
                                   void* stream) {
  using namespace agc;
  if (bits < 1 || bits > 40 || n < 0 || n > INT32_MAX || cap < 0 || (hash & 1) == 0 ||
      (bounds != nullptr && stride < 1) || reinterpret_cast<uintptr_t>(buckets) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int sbits = bits < kSetSliceBits ? bits : kSetSliceBits;
  const int64_t slices = int64_t{1} << (bits - sbits);
  // partitions are of whole 2^kSetSliceBits-bucket slices; an unpartitioned
  // set goes to at most kSetDirectSlices blocks, each reading all of it
  if (slices > INT32_MAX || (bounds != nullptr && sbits != kSetSliceBits) ||
      (bounds == nullptr && n > 0 && slices > kSetDirectSlices))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 36 << sbits;  // the image, 32 bytes a bucket, and a tie counter a bucket
  cudaError_t e = cudaFuncSetAttribute(set_slice_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  // all of the SM's shared memory: three blocks of a 2^11-bucket slice
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(set_slice_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_slice_kernel<<<static_cast<unsigned>(slices), kSliceThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      src, n, bounds, stride, hash, bits, sbits, reinterpret_cast<longlong2*>(buckets), spill,
      cap, status, count);
  return static_cast<int>(cudaGetLastError());
}
