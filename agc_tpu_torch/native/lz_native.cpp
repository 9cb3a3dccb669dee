// Native LZ-diff codec core for agc-tpu.
//
// Implements the serial seed-and-extend token encoder/estimator/decoder used
// by the segment store (same token grammar as the reference tool's
// CLZDiff_V2 at src/common/lz_diff.{h,cpp}; fresh implementation).
//
// Built as a shared library, consumed from Python via ctypes
// (agc_tpu/native/__init__.py). The batched estimate path also runs on
// device (agc_tpu/ops/match.py); this library covers the irreducibly serial
// encode/emit loop and the host decode fallback.
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC lz_native.cpp -o liblznative.so

#include <algorithm>
#include <cstdint>
#include <atomic>
#include <cstring>
#include <mutex>
#include <string>
#include <vector>
#include <map>
#include <unordered_map>
#if defined(__AVX512VBMI__)
#include <immintrin.h>
#endif

namespace {

constexpr uint8_t kNCode = 4;
constexpr uint8_t kNRunStarter = 0x1E;
constexpr uint32_t kMinNRunLen = 4;
constexpr uint32_t kHashingStep = 4;
constexpr uint32_t kMaxTries = 64;
constexpr double kMaxLoadFactor = 0.7;
constexpr uint8_t kInvalidSymbol = 31;

inline uint64_t murmur64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xFF51AFD7ED558CCDULL;
  h ^= h >> 33;
  h *= 0xC4CEB9FE1A85EC53ULL;
  h ^= h >> 33;
  return h;
}

inline uint32_t uint_len(uint32_t x) {
  if (x < 10) return 1;
  if (x < 100) return 2;
  if (x < 1000) return 3;
  if (x < 10000) return 4;
  if (x < 100000) return 5;
  if (x < 1000000) return 6;
  if (x < 10000000) return 7;
  return 8;
}

struct LZContext {
  uint32_t min_match_len;
  uint32_t key_len;
  uint64_t key_mask;
  // emit the V1 token grammar (reference: CLZDiff_V1::Encode,
  // lz_diff.cpp:443-584): plain literals only (no '!' same-as-reference
  // substitution) and matches always carry ",len-mml" (no match-to-end
  // omission). Used when appending to format-1.x archives.
  bool v1_grammar = false;
  std::vector<uint8_t> ref;  // padded with key_len invalid symbols
  uint64_t ref_len = 0;      // unpadded length
  std::vector<int64_t> ht;   // position table, -1 empty (large refs)
  // small-ref variant: (pos << 8) | tag fits uint32 whenever the padded
  // reference is <= 0xFFFFFF bytes (virtually every segment group - the
  // standard group reference is ~60 kb). Halves the per-group index
  // memory, the same ht16/ht32 split the reference tool uses
  // (lz_diff.cpp:146). 0xFFFFFFFF = empty (unreachable: pos <= 0xFFFFF6).
  std::vector<uint32_t> ht32;
  bool ht_use32 = false;
  // smallest-ref variant (the ht16 half of the reference's split):
  // sampled positions are multiples of kHashingStep, so pos/step fits
  // uint16 for refs up to ~256 KB - i.e. every standard segment group.
  // Entries drop the key tag; tag filtering only skips slots whose
  // first key_len symbols cannot match (equal symbols <=> equal codes
  // <=> equal tags), and such slots are rejected by the f_len >=
  // key_len check anyway, so match choices (and archives) are
  // IDENTICAL - the probes just touch the reference bytes instead.
  // Quarters the per-group index memory vs ht32: the LZ contexts were
  // the largest single block of the create-at-scale RSS anatomy
  // (~2 GB of the 7.5 GB peak at 5 Gbase).
  std::vector<uint16_t> ht16;
  bool ht_use16 = false;
  uint64_t ht_mask = 0;
  std::atomic<bool> index_ready = false;
  // anchor-mode occurrence map (key -> min/max dense ref positions),
  // built once per prepared reference on first anchor encode
  std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>> anchor_occ;
  std::atomic<bool> anchor_occ_ready = false;
  std::mutex anchor_mtx;

  // key_len is clamped to [8, 31]: below 8 the word-at-a-time
  // match_forward could read past the key_len-byte reference padding,
  // and outside [1, 31] the mask shift is UB. Legitimate mml (the
  // format's 15..32) maps to key_len 12..29 and is never clamped; the
  // archive readers additionally validate mml at open.
  explicit LZContext(uint32_t mml)
      : min_match_len(mml),
        key_len(std::min<uint32_t>(
            31, std::max<uint32_t>(
                    8, mml >= kHashingStep ? mml - kHashingStep + 1 : 8))),
        key_mask(~0ULL >> (64 - 2 * key_len)) {}

  std::mutex index_mtx;

  void prepare(const uint8_t* data, uint64_t len) {
    ref.assign(data, data + len);
    ref.resize(len + key_len, kInvalidSymbol);
    ref_len = len;
    index_ready = false;
    anchor_occ_ready = false;
  }

  // 2-bit pack key_len symbols; ~0 when any symbol is non-ACGT.
  inline uint64_t code_at(const uint8_t* s) const {
    uint64_t x = 0;
    for (uint32_t i = 0; i < key_len; ++i) {
      if (s[i] > 3) return ~0ULL;
      x = (x << 2) | s[i];
    }
    return x;
  }

  void build_index() {
    // One rolling pass collects the sampled (position, code) pairs —
    // code_at would re-derive key_len symbols per sampled position (and
    // twice, for the count then the fill), which used to dominate
    // per-group cost; the rolling window does one shift+or per base.
    // Positions, codes, table size, and insertion order are IDENTICAL
    // to the old double code_at walk, so match choices (and archives)
    // are unchanged.
    const uint64_t padded = ref.size();
    std::vector<std::pair<uint64_t, uint64_t>> poscode;
    if (padded > key_len) {
      poscode.reserve((padded - key_len) / kHashingStep + 1);
      const uint64_t kmask =
          key_len >= 32 ? ~0ULL : ((1ULL << (2 * key_len)) - 1);
      uint64_t code = 0;
      int64_t last_invalid = -1;
      for (uint64_t t = 0; t + 1 < key_len; ++t) {
        const uint8_t s = ref[t];
        if (s > 3) last_invalid = static_cast<int64_t>(t);
        code = (code << 2) | (s & 3);
      }
      for (uint64_t i = 0; i + key_len < padded; ++i) {
        const uint8_t s = ref[i + key_len - 1];
        if (s > 3) last_invalid = static_cast<int64_t>(i + key_len - 1);
        code = (code << 2) | (s & 3);
        if ((i % kHashingStep) == 0 &&
            last_invalid < static_cast<int64_t>(i))
          poscode.emplace_back(i, code & kmask);
      }
    }

    uint64_t ht_size =
        static_cast<uint64_t>(poscode.size() / kMaxLoadFactor);
    while (ht_size & (ht_size - 1)) ht_size &= ht_size - 1;  // floor pow2
    ht_size <<= 1;
    if (ht_size < 8) ht_size = 8;
    ht_mask = ht_size - 1;
    ht_use16 = ref.size() / kHashingStep < 0xFFFF;
    ht_use32 = !ht_use16 && ref.size() <= 0xFFFFFF;
    ht.clear();
    ht.shrink_to_fit();
    ht32.clear();
    ht32.shrink_to_fit();
    ht16.clear();
    ht16.shrink_to_fit();
    if (ht_use16)
      ht16.assign(ht_size, 0xFFFFu);
    else if (ht_use32)
      ht32.assign(ht_size, 0xFFFFFFFFu);
    else
      ht.assign(ht_size, -1);

    for (const auto& [i, code] : poscode) {
      uint64_t h = murmur64(code);
      uint64_t pos = h & ht_mask;
      // entry layout: (position << 8) | key-tag. The tag lets probes skip
      // entries whose key cannot match without touching the reference
      // bytes (equal first key_len symbols <=> equal codes, so tag
      // filtering never changes which matches are found).
      uint64_t entry = (i << 8) | (h >> 56);
      for (uint32_t t = 0; t < kMaxTries; ++t) {
        uint64_t p = (pos + t) & ht_mask;
        if (ht_use16) {
          if (ht16[p] == 0xFFFFu) {
            ht16[p] = static_cast<uint16_t>(i / kHashingStep);
            break;
          }
        } else if (ht_use32) {
          if (ht32[p] == 0xFFFFFFFFu) {
            ht32[p] = static_cast<uint32_t>(entry);
            break;
          }
        } else if (ht[p] < 0) {
          ht[p] = static_cast<int64_t>(entry);
          break;
        }
      }
    }
    index_ready = true;
  }

  inline void assure_index() {
    // double-checked with a mutex: the matcher thread estimates against a
    // group while the store worker encodes members into it
    if (index_ready) return;
    std::lock_guard<std::mutex> lk(index_mtx);
    if (!index_ready) build_index();
  }

  inline uint32_t match_forward(const uint8_t* a, const uint8_t* b,
                                uint32_t max_len) const {
    uint32_t i = 0;
    // word-at-a-time compare
    for (; i + 8 <= max_len; i += 8) {
      uint64_t wa, wb;
      std::memcpy(&wa, a + i, 8);
      std::memcpy(&wb, b + i, 8);
      uint64_t diff = wa ^ wb;
      if (diff) return i + (__builtin_ctzll(diff) >> 3);
    }
    for (; i < max_len; ++i)
      if (a[i] != b[i]) break;
    return i;
  }

  // best match covering text position i; returns true when total length
  // exceeds min_match_len
  bool find_best_match(const uint8_t* text, uint64_t text_len, uint64_t i,
                       uint64_t code, uint32_t no_prev_literals,
                       uint64_t& ref_pos, uint32_t& len_bck,
                       uint32_t& len_fwd) const {
    len_bck = 0;
    len_fwd = 0;
    uint32_t min_to_update = min_match_len;
    uint64_t hsh = murmur64(code);
    uint64_t pos = hsh & ht_mask;
    const uint8_t tag = static_cast<uint8_t>(hsh >> 56);
    const uint8_t* s = text + i;
    const uint32_t max_len = static_cast<uint32_t>(text_len - i);
    bool found = false;
    for (uint32_t t = 0; t < kMaxTries; ++t) {
      int64_t h;
      if (ht_use16) {
        const uint16_t e16 = ht16[(pos + t) & ht_mask];
        if (e16 == 0xFFFFu) break;
        h = static_cast<int64_t>(e16) * kHashingStep;
      } else if (ht_use32) {
        const uint32_t e32 = ht32[(pos + t) & ht_mask];
        if (e32 == 0xFFFFFFFFu) break;
        const int64_t e = static_cast<int64_t>(e32);
        if (static_cast<uint8_t>(e) != tag) continue;
        h = e >> 8;
      } else {
        const int64_t e = ht[(pos + t) & ht_mask];
        if (e < 0) break;
        if (static_cast<uint8_t>(e) != tag) continue;
        h = e >> 8;
      }
      const uint8_t* p = ref.data() + h;
      uint32_t limit = max_len;
      // padded reference guarantees in-bounds reads; padding mismatches text
      uint32_t f_len = match_forward(s, p, limit);
      if (f_len >= key_len) {
        uint32_t b_max = no_prev_literals < (uint64_t)h
                             ? no_prev_literals
                             : static_cast<uint32_t>(h);
        uint32_t b_len = 0;
        while (b_len < b_max && s[-(int64_t)b_len - 1] == p[-(int64_t)b_len - 1])
          ++b_len;
        if (b_len + f_len > min_to_update) {
          len_bck = b_len;
          len_fwd = f_len;
          ref_pos = static_cast<uint64_t>(h);
          min_to_update = b_len + f_len;
          found = true;
        }
      }
    }
    (void)found;
    return len_bck + len_fwd >= min_match_len;
  }
};

inline void append_uint(std::string& out, uint64_t x) {
  char buf[24];
  char* p = buf + 24;
  do {
    *--p = static_cast<char>('0' + (x % 10));
    x /= 10;
  } while (x);
  out.append(p, buf + 24 - p);
}

inline void append_int(std::string& out, int64_t x) {
  if (x < 0) {
    out.push_back('-');
    append_uint(out, static_cast<uint64_t>(-x));
  } else {
    append_uint(out, static_cast<uint64_t>(x));
  }
}

inline uint32_t nrun_len(const uint8_t* s, uint64_t max_len) {
  if (max_len < 3 || s[0] != kNCode || s[1] != kNCode || s[2] != kNCode)
    return 0;
  uint32_t len = 3;
  while (len < max_len && s[len] == kNCode) ++len;
  return len;
}

}  // namespace

extern "C" {

void* lz_create(uint32_t min_match_len) { return new LZContext(min_match_len); }

void lz_destroy(void* ctx) { delete static_cast<LZContext*>(ctx); }

void lz_prepare(void* vctx, const uint8_t* ref, uint64_t len) {
  static_cast<LZContext*>(vctx)->prepare(ref, len);
}

void lz_assure_index(void* vctx) {
  static_cast<LZContext*>(vctx)->assure_index();
}

// Prepared-reference accessors: the context's own copy is the single
// resident copy of every group reference (the Python layer used to
// retain a duplicate bytes object per group — ~60 KB x thousands of
// groups at multi-Gbase scale). The pointer is stable until the next
// lz_prepare on the same context.
const uint8_t* lz_ref_ptr(void* vctx) {
  return static_cast<LZContext*>(vctx)->ref.data();
}

uint64_t lz_ref_len(void* vctx) {
  return static_cast<LZContext*>(vctx)->ref_len;
}

// Resident bytes of one LZ context (ref copy + hash index + anchor
// occurrence map) — memory accounting for the create-at-scale RSS
// anatomy (tools/mem_anatomy.py; round-4 verdict: 7.8 GB vs the
// reference binary's 4.3 at 5 Gbase).
uint64_t lz_ctx_bytes(void* vctx) {
  LZContext& c = *static_cast<LZContext*>(vctx);
  uint64_t b = c.ref.capacity();
  b += c.ht.capacity() * sizeof(int64_t);
  b += c.ht32.capacity() * sizeof(uint32_t);
  b += c.ht16.capacity() * sizeof(uint16_t);
  // unordered_map: buckets + one heap node per entry (approximate)
  b += c.anchor_occ.bucket_count() * sizeof(void*);
  b += c.anchor_occ.size() *
       (sizeof(std::pair<const uint64_t, std::pair<uint32_t, uint32_t>>) +
        2 * sizeof(void*));
  return b;
}

void lz_set_v1(void* vctx, int flag) {
  static_cast<LZContext*>(vctx)->v1_grammar = flag != 0;
}

// Encode; returns output length, or -(needed) if cap insufficient.
int64_t lz_encode(void* vctx, const uint8_t* text, uint64_t text_len,
                  uint8_t* out, uint64_t cap) {
  LZContext& ctx = *static_cast<LZContext*>(vctx);
  ctx.assure_index();
  const uint32_t key_len = ctx.key_len;
  const uint32_t mml = ctx.min_match_len;

  if (text_len == ctx.ref_len &&
      std::memcmp(text, ctx.ref.data(), text_len) == 0)
    return 0;  // identical to reference -> empty encoding

  std::string enc;
  enc.reserve(text_len / 16 + 64);

  uint64_t i = 0;
  uint64_t pred_pos = 0;
  uint32_t no_prev_literals = 0;
  uint64_t x_prev = ~0ULL;

  while (i + key_len < text_len) {
    uint64_t x;
    if (x_prev != ~0ULL && no_prev_literals > 0) {
      uint8_t s = text[i + key_len - 1];
      x = (s > 3) ? ~0ULL : (((x_prev << 2) & ctx.key_mask) | s);
    } else {
      x = ctx.code_at(text + i);
    }
    x_prev = x;

    if (x == ~0ULL) {
      uint32_t nr = nrun_len(text + i, text_len - i);
      if (nr >= kMinNRunLen) {
        enc.push_back(static_cast<char>(kNRunStarter));
        append_uint(enc, nr - kMinNRunLen);
        enc.push_back(static_cast<char>(kNCode));
        i += nr;
        no_prev_literals = 0;
      } else {
        enc.push_back(static_cast<char>('A' + text[i]));
        ++i;
        ++pred_pos;
        ++no_prev_literals;
      }
      continue;
    }

    uint64_t match_pos;
    uint32_t len_bck, len_fwd;
    if (!ctx.find_best_match(text, text_len, i, x, no_prev_literals, match_pos,
                             len_bck, len_fwd)) {
      enc.push_back(static_cast<char>('A' + text[i]));
      ++i;
      ++pred_pos;
      ++no_prev_literals;
      continue;
    }

    if (len_bck) {
      enc.resize(enc.size() - len_bck);
      match_pos -= len_bck;
      pred_pos -= len_bck;
      i -= len_bck;
    }

    // rewrite trailing literals equal to the reference as '!' (V2 only)
    if (!ctx.v1_grammar && match_pos == pred_pos) {
      size_t e_size = enc.size();
      for (uint64_t j = 1; j < e_size && j < match_pos; ++j) {
        char c = enc[e_size - j];
        if (c < 'A' || c > 'Z') break;
        if (static_cast<uint8_t>(c - 'A') == ctx.ref[match_pos - j])
          enc[e_size - j] = '!';
      }
    }

    uint64_t total = len_bck + len_fwd;
    append_int(enc, static_cast<int64_t>(match_pos) -
                        static_cast<int64_t>(pred_pos));
    bool to_end = !ctx.v1_grammar && (i + total == text_len) &&
                  (match_pos + total == ctx.ref_len);
    if (!to_end) {
      enc.push_back(',');
      append_uint(enc, total - mml);
    }
    enc.push_back('.');
    pred_pos = match_pos + total;
    i += total;
    no_prev_literals = 0;
  }

  for (; i < text_len; ++i) enc.push_back(static_cast<char>('A' + text[i]));

  if (enc.size() > cap) return -static_cast<int64_t>(enc.size());
  std::memcpy(out, enc.data(), enc.size());
  return static_cast<int64_t>(enc.size());
}

uint64_t lz_estimate(void* vctx, const uint8_t* text, uint64_t text_len,
                     uint64_t bound) {
  LZContext& ctx = *static_cast<LZContext*>(vctx);
  ctx.assure_index();
  const uint32_t key_len = ctx.key_len;
  const uint32_t mml = ctx.min_match_len;

  if (text_len == ctx.ref_len &&
      std::memcmp(text, ctx.ref.data(), text_len) == 0)
    return 0;

  uint64_t cost = 0;
  uint64_t i = 0;
  uint64_t pred_pos = 0;
  uint32_t no_prev_literals = 0;
  uint64_t x_prev = ~0ULL;

  while (i + key_len < text_len) {
    if (cost > bound) return cost;
    uint64_t x;
    if (x_prev != ~0ULL && no_prev_literals > 0) {
      uint8_t s = text[i + key_len - 1];
      x = (s > 3) ? ~0ULL : (((x_prev << 2) & ctx.key_mask) | s);
    } else {
      x = ctx.code_at(text + i);
    }
    x_prev = x;

    if (x == ~0ULL) {
      uint32_t nr = nrun_len(text + i, text_len - i);
      if (nr >= kMinNRunLen) {
        cost += 2 + uint_len(nr - kMinNRunLen);
        i += nr;
        no_prev_literals = 0;
      } else {
        ++cost;
        ++i;
        ++pred_pos;
        ++no_prev_literals;
      }
      continue;
    }

    uint64_t match_pos;
    uint32_t len_bck, len_fwd;
    if (!ctx.find_best_match(text, text_len, i, x, no_prev_literals, match_pos,
                             len_bck, len_fwd)) {
      ++cost;
      ++i;
      ++pred_pos;
      ++no_prev_literals;
      continue;
    }

    if (len_bck) {
      cost -= len_bck;
      match_pos -= len_bck;
      pred_pos -= len_bck;
      i -= len_bck;
    }
    uint64_t total = len_bck + len_fwd;
    int64_t dif = static_cast<int64_t>(match_pos) - static_cast<int64_t>(pred_pos);
    uint32_t c = uint_len(static_cast<uint32_t>(dif < 0 ? -dif : dif)) +
                 (dif < 0 ? 1 : 0);
    // V1 grammar always spells out ',len' (see lz_encode above), so the
    // match-to-end discount applies to V2 only
    bool to_end = !ctx.v1_grammar && (i + total == text_len) &&
                  (match_pos + total == ctx.ref_len);
    if (!to_end) c += 1 + uint_len(static_cast<uint32_t>(total - mml));
    cost += c + 1;
    pred_pos = match_pos + total;
    i += total;
    no_prev_literals = 0;
  }
  cost += text_len - i;
  return cost;
}

// Per-position coding costs (V1-style match cost, as in the reference's
// GetCodingCostVector). out must have text_len entries.
void lz_cost_vector(void* vctx, const uint8_t* text, uint64_t text_len,
                    int prefix_costs, uint32_t* out) {
  LZContext& ctx = *static_cast<LZContext*>(vctx);
  ctx.assure_index();
  const uint32_t key_len = ctx.key_len;
  const uint32_t mml = ctx.min_match_len;

  uint64_t n_out = 0;
  uint64_t i = 0;
  uint64_t pred_pos = 0;
  uint32_t no_prev_literals = 0;
  uint64_t x_prev = ~0ULL;

  auto emit_block = [&](uint32_t tc, uint64_t span) {
    if (prefix_costs) {
      out[n_out++] = tc;
      for (uint64_t j = 1; j < span; ++j) out[n_out++] = 0;
    } else {
      for (uint64_t j = 1; j < span; ++j) out[n_out++] = 0;
      out[n_out++] = tc;
    }
  };

  while (i + key_len < text_len) {
    uint64_t x;
    if (x_prev != ~0ULL && no_prev_literals > 0) {
      uint8_t s = text[i + key_len - 1];
      x = (s > 3) ? ~0ULL : (((x_prev << 2) & ctx.key_mask) | s);
    } else {
      x = ctx.code_at(text + i);
    }
    x_prev = x;

    if (x == ~0ULL) {
      uint32_t nr = nrun_len(text + i, text_len - i);
      if (nr >= kMinNRunLen) {
        emit_block(2 + uint_len(nr - kMinNRunLen), nr);
        i += nr;
        no_prev_literals = 0;
      } else {
        out[n_out++] = 1;
        ++i;
        ++pred_pos;
        ++no_prev_literals;
      }
      continue;
    }

    uint64_t match_pos;
    uint32_t len_bck, len_fwd;
    if (!ctx.find_best_match(text, text_len, i, x, no_prev_literals, match_pos,
                             len_bck, len_fwd)) {
      out[n_out++] = 1;
      ++i;
      ++pred_pos;
      ++no_prev_literals;
      continue;
    }
    if (len_bck) {
      n_out -= len_bck;
      match_pos -= len_bck;
      pred_pos -= len_bck;
      i -= len_bck;
    }
    uint64_t total = len_bck + len_fwd;
    int64_t dif = static_cast<int64_t>(match_pos) - static_cast<int64_t>(pred_pos);
    uint32_t tc = uint_len(static_cast<uint32_t>(dif < 0 ? -dif : dif)) +
                  (dif < 0 ? 1 : 0);
    tc += uint_len(static_cast<uint32_t>(total - mml)) + 2;
    emit_block(tc, total);
    pred_pos = match_pos + total;
    i += total;
    no_prev_literals = 0;
  }
  for (; i < text_len; ++i) out[n_out++] = 1;
}

// Decode a V2 token stream. Returns the decoded length when it fits in
// cap; when cap is too small the walk continues WITHOUT writing and the
// total required size is returned negated (-(needed)), so the caller can
// allocate exactly once and apply a sanity ceiling before doing so (a
// corrupt N-run can claim petabytes). kLzCorrupt (INT64_MIN) flags a
// token stream that walks outside the reference or the grammar —
// possible only for corrupted archives, so decode stays robust against
// hostile inputs (the reference tool segfaults here).
constexpr int64_t kLzCorrupt = INT64_MIN;
constexpr uint64_t kMaxTokenValue = 1ULL << 50;  // digit-parse overflow guard
constexpr uint64_t kAbsurdOut = 1ULL << 62;      // total-size overflow guard

int64_t lz_decode_v2(const uint8_t* ref, uint64_t ref_len, const uint8_t* enc,
                     uint64_t enc_len, uint32_t mml, uint8_t* out,
                     uint64_t cap) {
  uint64_t n_out = 0;
  uint64_t pred_pos = 0;
  uint64_t i = 0;
  while (i < enc_len) {
    uint8_t c = enc[i];
    if (c >= 'A' && c <= 'A' + 20) {
      if (n_out < cap) out[n_out] = c - 'A';
      ++n_out;
      ++pred_pos;
      ++i;
    } else if (c == '!') {
      if (pred_pos >= ref_len) return kLzCorrupt;
      if (n_out < cap) out[n_out] = ref[pred_pos];
      ++n_out;
      ++pred_pos;
      ++i;
    } else if (c == kNRunStarter) {
      ++i;
      uint64_t v = 0;
      while (i < enc_len && enc[i] != kNCode) {
        if (enc[i] < '0' || enc[i] > '9' || v > kMaxTokenValue)
          return kLzCorrupt;
        v = v * 10 + (enc[i++] - '0');
      }
      ++i;  // stop marker
      uint64_t len = v + kMinNRunLen;
      if (n_out < cap)
        std::memset(out + n_out, kNCode, std::min(len, cap - n_out));
      n_out += len;
      if (n_out > kAbsurdOut) return kLzCorrupt;
    } else {
      bool neg = false;
      if (c == '-') {
        neg = true;
        ++i;
      }
      uint64_t v = 0;
      bool any = false;
      while (i < enc_len && enc[i] >= '0' && enc[i] <= '9') {
        if (v > kMaxTokenValue) return kLzCorrupt;
        v = v * 10 + (enc[i++] - '0');
        any = true;
      }
      if (!any) return kLzCorrupt;  // stray byte outside the grammar
      int64_t dif = neg ? -static_cast<int64_t>(v) : static_cast<int64_t>(v);
      if (dif < 0 && static_cast<uint64_t>(-dif) > pred_pos)
        return kLzCorrupt;
      uint64_t ref_pos = pred_pos + static_cast<uint64_t>(dif);
      if (ref_pos > ref_len) return kLzCorrupt;
      uint64_t len;
      if (i < enc_len && enc[i] == ',') {
        ++i;
        v = 0;
        while (i < enc_len && enc[i] >= '0' && enc[i] <= '9') {
          if (v > kMaxTokenValue) return kLzCorrupt;
          v = v * 10 + (enc[i++] - '0');
        }
        len = v + mml;
      } else {
        len = ref_len - ref_pos;
      }
      ++i;  // '.'
      if (len > ref_len - ref_pos) return kLzCorrupt;
      if (n_out < cap)
        std::memcpy(out + n_out, ref + ref_pos, std::min(len, cap - n_out));
      n_out += len;
      if (n_out > kAbsurdOut) return kLzCorrupt;
      pred_pos = ref_pos + len;
    }
  }
  if (n_out > cap) return -static_cast<int64_t>(n_out);
  return static_cast<int64_t>(n_out);
}

// Decode a V1 token stream (length always follows ',' unless '.' directly).
// Same return contract as lz_decode_v2.
int64_t lz_decode_v1(const uint8_t* ref, uint64_t ref_len, const uint8_t* enc,
                     uint64_t enc_len, uint32_t mml, uint8_t* out,
                     uint64_t cap) {
  uint64_t n_out = 0;
  uint64_t pred_pos = 0;
  uint64_t i = 0;
  while (i < enc_len) {
    uint8_t c = enc[i];
    if ((c >= 'A' && c <= 'A' + 20) || c == '!') {
      if (n_out < cap)
        out[n_out] = (c == '!') ? static_cast<uint8_t>('!' - 'A') : c - 'A';
      ++n_out;
      ++pred_pos;
      ++i;
    } else if (c == kNRunStarter) {
      ++i;
      uint64_t v = 0;
      while (i < enc_len && enc[i] != kNCode) {
        if (enc[i] < '0' || enc[i] > '9' || v > kMaxTokenValue)
          return kLzCorrupt;
        v = v * 10 + (enc[i++] - '0');
      }
      ++i;
      uint64_t len = v + kMinNRunLen;
      if (n_out < cap)
        std::memset(out + n_out, kNCode, std::min(len, cap - n_out));
      n_out += len;
      if (n_out > kAbsurdOut) return kLzCorrupt;
    } else {
      bool neg = false;
      if (c == '-') {
        neg = true;
        ++i;
      }
      uint64_t v = 0;
      bool any = false;
      while (i < enc_len && enc[i] >= '0' && enc[i] <= '9') {
        if (v > kMaxTokenValue) return kLzCorrupt;
        v = v * 10 + (enc[i++] - '0');
        any = true;
      }
      if (!any) return kLzCorrupt;
      int64_t dif = neg ? -static_cast<int64_t>(v) : static_cast<int64_t>(v);
      if (dif < 0 && static_cast<uint64_t>(-dif) > pred_pos)
        return kLzCorrupt;
      uint64_t ref_pos = pred_pos + static_cast<uint64_t>(dif);
      if (ref_pos > ref_len) return kLzCorrupt;
      ++i;  // ','
      uint64_t len;
      if (i < enc_len && enc[i] == '.') {
        len = ref_len - ref_pos;
      } else {
        v = 0;
        while (i < enc_len && enc[i] >= '0' && enc[i] <= '9') {
          if (v > kMaxTokenValue) return kLzCorrupt;
          v = v * 10 + (enc[i++] - '0');
        }
        len = v + mml;
      }
      ++i;  // '.'
      if (len > ref_len - ref_pos) return kLzCorrupt;
      if (n_out < cap)
        std::memcpy(out + n_out, ref + ref_pos, std::min(len, cap - n_out));
      n_out += len;
      if (n_out > kAbsurdOut) return kLzCorrupt;
      pred_pos = ref_pos + len;
    }
  }
  if (n_out > cap) return -static_cast<int64_t>(n_out);
  return static_cast<int64_t>(n_out);
}

// FASTA body preprocessing: keep bytes >= 64 (drops \n, \r, digits,
// spaces), map through a 256-entry ASCII->numeric LUT (reference:
// preprocess_raw_contig, agc_compressor.cpp:907-951). Returns the number
// of symbols written. GIL-free under ctypes -> overlaps device compute.
uint64_t fasta_preprocess(const uint8_t* raw, uint64_t n, const uint8_t* lut,
                          uint8_t* out) {
  uint64_t m = 0;
  for (uint64_t i = 0; i < n; ++i) {
    uint8_t c = raw[i];
    out[m] = lut[c];
    m += (c >= 64);
  }
  return m;
}

// Numeric codes -> wrapped FASTA body in one pass (reference:
// CNumAlphaConverter::convert_and_split_into_lines,
// agc_decompressor_lib.cpp:562-645). line_len 0 = no wrapping. Every
// line, including the last partial one, is newline-terminated. Returns
// bytes written; caller allocates n + n/max(line_len,1) + 2.
uint64_t numeric_to_fasta(const uint8_t* codes, uint64_t n,
                          const uint8_t* cnv_num, uint32_t line_len,
                          uint8_t* out) {
  uint64_t o = 0;
  if (line_len == 0) {
    // unwrapped body still ends with ONE newline, like the streaming
    // sink — otherwise the next header glues onto the sequence line
    for (uint64_t i = 0; i < n; ++i) out[o++] = cnv_num[codes[i] & 0x7F];
    if (n) out[o++] = '\n';
    return o;
  }
  uint64_t i = 0;
  while (i < n) {
    uint64_t take = n - i < line_len ? n - i : line_len;
    for (uint64_t j = 0; j < take; ++j) out[o++] = cnv_num[codes[i + j] & 0x7F];
    out[o++] = '\n';
    i += take;
  }
  return o;
}

// Nibble-pack numeric symbols for the host->device link: 2 symbols/byte,
// any symbol > 3 (non-ACGT) collapses to 15 (the scan kernels only need
// an invalid marker). n may be odd; the trailing nibble of the last byte
// is 15. out size = (n + 1) / 2.
// Fused missing-middle split-point search (reference:
// find_cand_segment_with_missing_middle_splitter, agc_compressor.cpp:
// 1502-1627): combine the left group's prefix coding costs with the
// right group's suffix costs and return argmin — both cost walks, the
// two cumulative sums, and the argmin in one GIL-free call with no
// intermediate arrays crossing the FFI boundary.
//   t1/pc1/rev1: text, prefix flag, and reverse flag for ctx1's walk
//   mode2: 0 = suffix-cumsum of cost(ctx2, t2, /*prefix=*/0)
//          1 = reversed prefix-cumsum of cost(ctx2, t2, /*prefix=*/1)
// Texts share length n (the dir and rc views of one segment).
int64_t lz_split_point(void* vctx1, const uint8_t* t1, int pc1, int rev1,
                       void* vctx2, const uint8_t* t2, int mode2,
                       uint64_t n) {
  if (n == 0) return 0;
  std::vector<uint32_t> c1(n), c2(n);
  lz_cost_vector(vctx1, t1, n, pc1, c1.data());
  lz_cost_vector(vctx2, t2, n, mode2 == 1 ? 1 : 0, c2.data());

  // V1[i] = cumsum(c1')[i] where c1' = rev1 ? reverse(c1) : c1
  // V2[i] = mode2 ? reversed-cumsum(c2)[i] : suffix-sum(c2)[i]
  // best = argmin_i V1[i] + V2[i]; scan i ascending with running sums.
  uint64_t best_pos = 0;
  uint64_t best = ~0ULL;
  uint64_t s1 = 0;
  if (mode2 == 0) {
    // suffix sums of c2: S2[i] = sum(c2[i..n-1])
    uint64_t tot2 = 0;
    for (uint64_t i = 0; i < n; ++i) tot2 += c2[i];
    uint64_t pre2 = 0;  // sum(c2[0..i-1])
    for (uint64_t i = 0; i < n; ++i) {
      s1 += c1[rev1 ? n - 1 - i : i];
      uint64_t v = s1 + (tot2 - pre2);  // s1 + sum(c2[i..n-1])
      if (v < best) { best = v; best_pos = i; }
      pre2 += c2[i];
    }
  } else {
    // V2 = reverse(cumsum(c2)): V2[i] = sum(c2[0..n-1-i])
    // precompute prefix sums once (single pass, then combined pass)
    std::vector<uint64_t> p2(n);
    uint64_t acc = 0;
    for (uint64_t i = 0; i < n; ++i) { acc += c2[i]; p2[i] = acc; }
    for (uint64_t i = 0; i < n; ++i) {
      s1 += c1[rev1 ? n - 1 - i : i];
      uint64_t v = s1 + p2[n - 1 - i];
      if (v < best) { best = v; best_pos = i; }
    }
  }
  return static_cast<int64_t>(best_pos);
}

// Fused reverse-complement of a numeric sequence: out[i] =
// complement(in[n-1-i]), where ACGT (0-3) maps to 3-x and any other
// code (N=4, IUPAC 5-15, invalid 30) passes through unchanged
// (reference: reverse_complement_copy, agc_basic.cpp:257-315). One pass,
// GIL-free under ctypes -> overlaps the matcher thread.
void rc_numeric(const uint8_t* in, uint64_t n, uint8_t* out) {
  uint8_t lut[256];
  for (int i = 0; i < 256; ++i) lut[i] = (uint8_t)i;
  for (int i = 0; i < 4; ++i) lut[i] = (uint8_t)(3 - i);
  for (uint64_t i = 0; i < n; ++i) out[i] = lut[in[n - 1 - i]];
}

// Unpack the segment-reference "tuples" repack (segment.py bytes2tuples;
// reference: CSegment::tuples2bytes, segment.h:73-169): each stored byte
// holds nb base-mult symbols most-significant-first; the byte before the
// trailing marker carries the `trailing` leftover symbols; marker =
// (nb << 4) | trailing. Returns the output length. One 256 x nb LUT pass,
// GIL-free under ctypes.
uint64_t tuples_to_bytes(const uint8_t* data, uint64_t n, uint8_t* out) {
  const uint8_t marker = data[n - 1];
  const int nb = marker >> 4;
  const int trailing = marker & 0xF;
  if (nb == 1) {
    std::memcpy(out, data, n - 1);
    return n - 1;
  }
  const int mult = nb == 4 ? 4 : (nb == 3 ? 6 : 16);
  const uint64_t main_n = n - 2;
  uint8_t lut[256][4];
  for (int v = 0; v < 256; ++v) {
    int c = v;
    for (int k = nb - 1; k >= 0; --k) {
      lut[v][k] = (uint8_t)(c % mult);
      c /= mult;
    }
  }
  uint8_t* o = out;
  if (nb == 4) {
    for (uint64_t i = 0; i < main_n; ++i, o += 4)
      std::memcpy(o, lut[data[i]], 4);
  } else if (nb == 3) {
    for (uint64_t i = 0; i < main_n; ++i, o += 3)
      std::memcpy(o, lut[data[i]], 3);
  } else {
    for (uint64_t i = 0; i < main_n; ++i, o += 2)
      std::memcpy(o, lut[data[i]], 2);
  }
  o = out + main_n * (uint64_t)nb;
  if (trailing) {
    int c = data[n - 2];
    for (int k = trailing - 1; k >= 0; --k) {
      o[k] = (uint8_t)(c % mult);
      c /= mult;
    }
  }
  return main_n * (uint64_t)nb + (uint64_t)trailing;
}

void pack_nibbles(const uint8_t* in, uint64_t n, uint8_t* out) {
  uint64_t i = 0, o = 0;
  for (; i + 2 <= n; i += 2, ++o) {
    uint8_t a = in[i] > 3 ? 15 : in[i];
    uint8_t b = in[i + 1] > 3 ? 15 : in[i + 1];
    out[o] = (uint8_t)(a | (b << 4));
  }
  if (i < n) {
    uint8_t a = in[i] > 3 ? 15 : in[i];
    out[o] = (uint8_t)(a | 0xF0);
  }
}

// FASTA body -> numeric codes, run-structured: bytes < 64 (newlines /
// controls) are dropped, the rest map through lut. FASTA bodies are
// long runs of sequence bytes broken by single newlines, so the scan
// advances 8 bytes per iteration inside a run (a zero byte in
// w & 0xC0.. marks the first byte < 64) and the translation loop is
// branch-free and unrollable — ~4x the byte-at-a-time loop above.
// The IUPAC validity check (code <= 15) is fused as an OR-accumulate
// over the OUTPUT words: returns the first invalid output index in
// *bad_pos (or -1), so the caller skips its own full max() pass.
int64_t fasta_preprocess2(const uint8_t* raw, uint64_t n,
                          const uint8_t* lut, uint8_t* out,
                          int64_t* bad_pos) {
  const uint64_t HI = 0xC0C0C0C0C0C0C0C0ULL;
  const uint64_t LO1 = 0x0101010101010101ULL;
  const uint64_t HI8 = 0x8080808080808080ULL;
#if defined(__AVX512VBMI__) && defined(__AVX512BW__)
  // The ASCII->code table is PERIODIC over [64, 128): lut[64+o] ==
  // lut[96+o] for o in [0, 32) (upper/lowercase rows are identical),
  // so one vpermb with a 64-byte table over (byte & 63) translates a
  // whole run lane-parallel. Bytes < 64 (newlines) are compressed out
  // with a movemask + compress-store per 64-byte block.
  __m512i table;
  {
    uint8_t t64[64];
    for (int o = 0; o < 64; ++o) t64[o] = lut[64 + (o & 31)];
    table = _mm512_loadu_si512(t64);
  }
  uint64_t m = 0, i = 0;
  for (; i + 64 <= n; i += 64) {
    __m512i v = _mm512_loadu_si512(raw + i);
    // keep = byte >= 64 <=> (signed) byte < 0 for >=128 is impossible
    // in FASTA, but stay exact: keep = (v & 0xC0) != 0 fails for
    // 128..191? lut covers >=128 as 255 via the scalar path only —
    // match the scalar semantics: keep = byte >= 64 (unsigned)
    __mmask64 keep = _mm512_cmpge_epu8_mask(v, _mm512_set1_epi8(64));
    __m512i tr = _mm512_permutexvar_epi8(
        _mm512_and_si512(v, _mm512_set1_epi8(63)), table);
    // bytes >= 128 index the table like 64..127 would; the reference
    // LUT maps 128.. to 255 — replicate: force 255 where byte >= 128
    __mmask64 hi = _mm512_movepi8_mask(v);  // top bit set
    tr = _mm512_mask_mov_epi8(tr, hi, _mm512_set1_epi8((char)255));
    _mm512_mask_compressstoreu_epi8(out + m, keep, tr);
    m += (uint64_t)_mm_popcnt_u64(keep);
  }
  for (; i < n; ++i) {
    uint8_t c = raw[i];
    out[m] = lut[c];
    m += (c >= 64);
  }
#else
  uint64_t m = 0, i = 0;
  while (i < n) {
    while (i < n && raw[i] < 64) ++i;
    uint64_t j = i;
    while (j + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, raw + j, 8);
      uint64_t t = w & HI;
      if (((t - LO1) & ~t & HI8) != 0) break;  // some byte < 64
      j += 8;
    }
    while (j < n && raw[j] >= 64) ++j;
    uint64_t len = j - i;
    uint64_t q = 0;
    for (; q + 8 <= len; q += 8) {
      out[m + q + 0] = lut[raw[i + q + 0]];
      out[m + q + 1] = lut[raw[i + q + 1]];
      out[m + q + 2] = lut[raw[i + q + 2]];
      out[m + q + 3] = lut[raw[i + q + 3]];
      out[m + q + 4] = lut[raw[i + q + 4]];
      out[m + q + 5] = lut[raw[i + q + 5]];
      out[m + q + 6] = lut[raw[i + q + 6]];
      out[m + q + 7] = lut[raw[i + q + 7]];
    }
    for (; q < len; ++q) out[m + q] = lut[raw[i + q]];
    m += len;
    i = j;
  }
#endif
  // fused validity: valid codes are 0..15 (low nibble); any 0xF0 bit
  // set anywhere marks a non-IUPAC symbol (lut gives 30/32/255)
  const uint64_t NIB = 0xF0F0F0F0F0F0F0F0ULL;
  *bad_pos = -1;
  uint64_t acc = 0, p = 0;
  for (; p + 8 <= m; p += 8) {
    uint64_t w;
    std::memcpy(&w, out + p, 8);
    acc |= w;
  }
  for (; p < m; ++p) acc |= out[p];
  if ((acc & NIB) != 0) {
    for (uint64_t q2 = 0; q2 < m; ++q2) {
      if (out[q2] > 15) { *bad_pos = (int64_t)q2; break; }
    }
  }
  return (int64_t)m;
}

// ===========================================================================
// Anchor-mode LZ encode (the device-assisted encode path).
//
// The classic encoder above probes an insertion-ordered linear-probe hash
// table at every position — a walk a TPU cannot replicate exactly. Anchor
// mode redefines the ENCODE DECISION RULE (not the V2 token grammar) to be
// a pure function of (text, ref) built from operations both a TPU kernel
// (ops/match.py::anchor_tables) and this C++ twin compute identically:
//
//   1. ref index = dual min/max hash-slot tables over seed keys at EVERY
//      reference position (dense, unlike the estimate bank's stride-4
//      sampling: text probes run on a stride-4 grid, so a sampled ref
//      index could only ever discover diagonals divisible by 4 — every
//      indel whose shift is not a multiple of 4 would degenerate to
//      literals). Same multipliers, fingerprint and entry packing as
//      ops/match.py::_ref_index_kernel; H = 2 x pow2-padded ref length
//      (load <= 0.5); entry = fp39 << 24 | pos; min and max per bucket;
//   2. text anchors = per sampled text position, the (<= 2) candidate
//      diagonals from probing the min/max slots, expressed as u8 indices
//      into the top-32 diagonal set D (count desc, diag asc);
//   3. greedy tiling (lz_encode_anchored below, HOST-only, O(n)): scan
//      for the next anchor, verify + extend the byte-equality run on its
//      diagonal(s), emit V2 tokens (literals / '!' rewrites / N-runs /
//      matches with the match-to-end discount) exactly as the classic
//      emitter does.
//
// Archives are byte-identical whether the anchor tables come from the
// device kernel or lz_anchor_table below — that is the parity contract
// (tests/test_lz_anchor.py). reference for the grammar itself:
// lz_diff.cpp:631-798.

constexpr uint64_t kAHashMul = 0x9E3779B97F4A7C15ULL;  // match.py _HASH_MUL
constexpr uint64_t kAFpMul = 0xC2B2AE3D27D4EB4FULL;    // match.py _FP_MUL
constexpr int kAPosBits = 24;                          // match.py _POS_BITS
constexpr int kAFpBits = 39;                           // match.py _FP_BITS
constexpr int64_t kASlotSent = INT64_MAX;              // match.py _SLOT_SENT
constexpr uint32_t kAStride = 4;                       // HASHING_STEP
constexpr uint32_t kANDiag = 32;                       // diagonal-set cap
constexpr uint64_t kAMinRefBucket = 2048;  // match.py _MIN_REF_KEY_BUCKET*2

static inline bool anchor_key_at(const uint8_t* s, uint32_t kl,
                                 uint64_t* key) {
  uint64_t x = 0;
  for (uint32_t t = 0; t < kl; ++t) {
    if (s[t] > 3) return false;
    x = (x << 2) | s[t];
  }
  *key = x;
  return true;
}

// Sampled-position count of the anchor grid over a text of length n.
uint64_t lz_anchor_T(uint64_t n) { return (n + kAStride - 1) / kAStride; }

// Anchor occurrence map: every dense reference key -> exact (min, max)
// occurrence positions. Shared by the stateless twin and the
// LZContext-cached production path.
static void anchor_build_occ(
    const uint8_t* ref, uint64_t m, uint32_t kl,
    std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>>& occ) {
  const uint64_t kmask = (kl < 32) ? ((1ULL << (2 * kl)) - 1) : ~0ULL;
  occ.reserve(m);
  uint64_t key = 0;
  int64_t last_bad = -1;
  for (uint64_t e = 0; e < m; ++e) {
    uint8_t s = ref[e];
    key = ((key << 2) & kmask) | (s & 3);
    if (s > 3) last_bad = (int64_t)e;
    if (e + 1 < kl) continue;
    uint64_t j = e + 1 - kl;
    if (last_bad >= (int64_t)j) continue;
    auto it = occ.find(key);
    if (it == occ.end())
      occ.emplace(key, std::make_pair((uint32_t)j, (uint32_t)j));
    else {
      if (j < it->second.first) it->second.first = (uint32_t)j;
      if (j > it->second.second) it->second.second = (uint32_t)j;
    }
  }
}

// Strided text probes over the occurrence map -> top-32 diagonal set
// (count desc, diag asc). Returns the diagonal count.
static int64_t anchor_diags_from_occ(
    const std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>>& occ,
    const uint8_t* text, uint64_t n, uint32_t kl, int32_t* diags_out) {
  const uint64_t kmask = (kl < 32) ? ((1ULL << (2 * kl)) - 1) : ~0ULL;
  std::map<int32_t, uint32_t> hist;
  uint64_t key = 0;
  int64_t last_bad = -1;
  for (uint64_t e = 0; e < n; ++e) {
    uint8_t s = text[e];
    key = ((key << 2) & kmask) | (s & 3);
    if (s > 3) last_bad = (int64_t)e;
    if (e + 1 < kl) continue;
    uint64_t j = e + 1 - kl;
    if (j % kAStride != 0 || last_bad >= (int64_t)j) continue;
    auto it = occ.find(key);
    if (it == occ.end()) continue;
    hist[(int32_t)((int64_t)it->second.first - (int64_t)j)] += 1;
    hist[(int32_t)((int64_t)it->second.second - (int64_t)j)] += 1;
  }
  std::vector<std::pair<int32_t, uint32_t>> hs(hist.begin(), hist.end());
  std::stable_sort(hs.begin(), hs.end(),
                   [](const auto& x, const auto& y) {
                     if (x.second != y.second) return x.second > y.second;
                     return x.first < y.first;
                   });
  uint32_t nd = 0;
  for (uint32_t i = 0; i < kANDiag; ++i) {
    if (i < hs.size()) {
      diags_out[i] = hs[i].first;
      ++nd;
    } else {
      diags_out[i] = INT32_MIN;
    }
  }
  return (int64_t)nd;
}

static inline bool anchor_applies_nm(uint64_t n, uint64_t m, uint32_t kl) {
  return m < (1ULL << kAPosBits) && n < (1ULL << kAPosBits) &&
         m >= kl + kAStride;
}

// Build the anchor DIAGONAL SET for (text, ref) on the host — the
// device twin is ops/match.py::anchor_diag_sets (sort-merge join; no
// hash tables, no scatters, identical min/max-occurrence semantics).
// diags_out: kANDiag int32 (unused tail = INT32_MIN). Returns the
// number of diagonals, or -1 when anchor mode does not apply to this
// (n, m). Only the SET crosses the device link (128 bytes per
// segment): the emitter below rediscovers anchors by direct byte
// equality against each diagonal, so no per-position table pays the
// download tax. Stateless (parity tests); the production host path is
// lz_anchor_diags_ctx, which caches the occurrence map per reference.
int64_t lz_anchor_diags(const uint8_t* text, uint64_t n, const uint8_t* ref,
                        uint64_t m, uint32_t mml, int32_t* diags_out) {
  const uint32_t kl = mml - kAStride + 1;
  if (!anchor_applies_nm(n, m, kl)) return -1;
  std::unordered_map<uint64_t, std::pair<uint32_t, uint32_t>> occ;
  anchor_build_occ(ref, m, kl, occ);
  return anchor_diags_from_occ(occ, text, n, kl, diags_out);
}

// Greedy tiling + V2 emission from anchor tables (host leg of both the
// device path and the all-host twin). Token grammar identical to the
// classic lz_encode above: literals 'A'+code, '!' ref-equal rewrites,
// N-runs 0x1E dec(len-4) 0x04, matches dec(dpos)[,len-mml]'.' with the
// match-to-end discount. Returns token length or -(needed) when cap is
// too small.
int64_t lz_encode_anchored(const uint8_t* text, uint64_t n,
                           const uint8_t* ref, uint64_t m, uint32_t mml,
                           const int32_t* diags, uint32_t ndiag,
                           uint8_t* out, uint64_t cap) {
  if (n == m && std::memcmp(text, ref, n) == 0) return 0;
  if (ndiag > kANDiag) ndiag = kANDiag;

  std::string enc;
  enc.reserve(n / 16 + 64);
  uint64_t i = 0;
  uint64_t pred_pos = 0;
  uint64_t tp = 0;  // monotone sampled-grid cursor

  // next usable match at or after position i: at each grid position,
  // try EVERY diagonal in D by direct byte equality (a run of the
  // text against ref shifted by d is contiguous, so any grid point
  // inside it discovers it); extend the run, keep (start, end, diag)
  // when end - max(i, run start) >= mml. Longer wins; ties take the
  // smaller diagonal. Spurious byte agreements on wrong diagonals die
  // after a ~1.3-byte expected extension, so this stays O(|D|) per
  // grid position worst case and O(1) amortized on matched data.
  auto find_match = [&](uint64_t from, uint64_t* ms, uint64_t* me,
                        int64_t* md) -> bool {
    if (ndiag == 0) return false;
    while (tp * kAStride < from) ++tp;
    for (;; ++tp) {
      uint64_t j = tp * kAStride;
      if (j >= n) return false;
      uint64_t best_len = 0, best_s = 0, best_e = 0;
      int64_t best_d = 0;
      for (uint32_t ix = 0; ix < ndiag; ++ix) {
        int64_t d = diags[ix];
        int64_t rj = (int64_t)j + d;
        if (rj < 0 || (uint64_t)rj >= m) continue;
        if (text[j] != ref[rj]) continue;
        // extend forward from j
        uint64_t e = j;
        uint64_t e_lim = ((int64_t)n < (int64_t)m - d)
                             ? n
                             : (uint64_t)((int64_t)m - d);
        while (e < e_lim && text[e] == ref[e + d]) ++e;
        // extend backward from j, not past `from`
        uint64_t s = j;
        while (s > from && (int64_t)s - 1 + d >= 0 &&
               text[s - 1] == ref[s - 1 + d])
          --s;
        uint64_t len = e - s;
        if (len >= mml &&
            (len > best_len || (len == best_len && d < best_d))) {
          best_len = len;
          best_s = s;
          best_e = e;
          best_d = d;
        }
      }
      if (best_len) {
        *ms = best_s;
        *me = best_e;
        *md = best_d;
        return true;
      }
    }
  };

  while (i < n) {
    uint64_t ms, me;
    int64_t md;
    bool found = find_match(i, &ms, &me, &md);
    uint64_t target = found ? ms : n;
    // literal / N-run stretch [i, target)
    while (i < target) {
      uint32_t nr = nrun_len(text + i, target - i);
      if (nr >= kMinNRunLen) {
        enc.push_back(static_cast<char>(kNRunStarter));
        append_uint(enc, nr - kMinNRunLen);
        enc.push_back(static_cast<char>(kNCode));
        i += nr;  // N-runs do not advance pred_pos (classic parity)
      } else {
        enc.push_back(static_cast<char>('A' + text[i]));
        ++i;
        ++pred_pos;
      }
    }
    if (!found) break;
    // match [ms, me) on diagonal md; i == ms
    uint64_t match_pos = ms + md;
    uint64_t total = me - ms;
    if (match_pos == pred_pos) {
      // rewrite trailing ref-equal literals as '!' (classic parity)
      size_t e_size = enc.size();
      for (uint64_t j2 = 1; j2 < e_size && j2 < match_pos; ++j2) {
        char c = enc[e_size - j2];
        if (c < 'A' || c > 'Z') break;
        if (static_cast<uint8_t>(c - 'A') == ref[match_pos - j2])
          enc[e_size - j2] = '!';
      }
    }
    append_int(enc, static_cast<int64_t>(match_pos) -
                        static_cast<int64_t>(pred_pos));
    bool to_end = (ms + total == n) && (match_pos + total == m);
    if (!to_end) {
      enc.push_back(',');
      append_uint(enc, total - mml);
    }
    enc.push_back('.');
    pred_pos = match_pos + total;
    i = me;
  }

  if (enc.size() > cap) return -static_cast<int64_t>(enc.size());
  std::memcpy(out, enc.data(), enc.size());
  return static_cast<int64_t>(enc.size());
}

// All-host anchor encode (twin of the device-assisted path): builds the
// anchor tables with lz_anchor_table, then emits. Returns token length,
// -(needed) when cap is too small, or INT64_MIN when anchor mode does
// not apply (caller should use the classic encoder).
int64_t lz_encode_anchor_host(const uint8_t* text, uint64_t n,
                              const uint8_t* ref, uint64_t m, uint32_t mml,
                              uint8_t* out, uint64_t cap) {
  std::vector<int32_t> diags(kANDiag);
  int64_t nd = lz_anchor_diags(text, n, ref, m, mml, diags.data());
  if (nd < 0) return INT64_MIN;
  return lz_encode_anchored(text, n, ref, m, mml, diags.data(),
                            (uint32_t)nd, out, cap);
}

// Production host path: anchor encode against a PREPARED LZContext,
// with the occurrence map built once per reference (prepare()
// invalidates it) — the stateless twin above rebuilds it per call,
// which is only acceptable for tests.
int64_t lz_encode_anchor_ctx(void* vctx, const uint8_t* text, uint64_t n,
                             uint8_t* out, uint64_t cap) {
  LZContext& ctx = *static_cast<LZContext*>(vctx);
  const uint32_t kl = ctx.key_len;
  const uint64_t m = ctx.ref_len;
  if (ctx.v1_grammar || !anchor_applies_nm(n, m, kl)) return INT64_MIN;
  if (!ctx.anchor_occ_ready.load(std::memory_order_acquire)) {
    std::lock_guard<std::mutex> lk(ctx.anchor_mtx);
    if (!ctx.anchor_occ_ready.load(std::memory_order_relaxed)) {
      ctx.anchor_occ.clear();
      anchor_build_occ(ctx.ref.data(), m, kl, ctx.anchor_occ);
      ctx.anchor_occ_ready.store(true, std::memory_order_release);
    }
  }
  std::vector<int32_t> diags(kANDiag);
  int64_t nd = anchor_diags_from_occ(ctx.anchor_occ, text, n, kl,
                                     diags.data());
  return lz_encode_anchored(text, n, ctx.ref.data(), m, ctx.min_match_len,
                            diags.data(), (uint32_t)nd, out, cap);
}

// Reference-part repack decision + tuples encode in one call
// (reference: segment.h:73-169, 218-255; the numpy twin is
// core/segment.py ref_payload/bytes2tuples). Probes the first 8 KiB
// for autocorrelation at lags 4..31 (early exit at frac >= 0.5): if no
// lag repeats, the part stays plain (returns -1; caller zstd-19s the
// original). Otherwise the tuples repack is written to out (capacity
// n / 2 + 2 suffices for nb >= 2; n + 1 covers the nb-1 passthrough)
// and its length returned; *marker_out is the store marker (1).
int64_t ref_payload_tuples(const uint8_t* data, uint64_t n, uint8_t* out,
                           int32_t* marker_out) {
  uint64_t probe_n = n < 8192 ? n : 8192;
  double best_frac = 0.0;
  // acgt prefix counts for the probe window (cur = count(acgt[:-lag]))
  for (uint32_t lag = 4; lag < 32 && lag < probe_n; ++lag) {
    uint64_t cnt = 0, cur = 0;
    for (uint64_t t = 0; t + lag < probe_n; ++t) {
      cnt += (data[t] == data[t + lag]);
      cur += (data[t] < 4);
    }
    double frac = cur ? (double)cnt / (double)cur : 0.0;
    if (frac > best_frac) {
      best_frac = frac;
      if (best_frac >= 0.5) break;
    }
  }
  if (best_frac >= 0.5) return -1;  // plain, zstd level 19, marker 0
  *marker_out = 1;
  uint8_t me = 0;
  for (uint64_t t = 0; t < n; ++t) me = me > data[t] ? me : data[t];
  uint32_t nb, mult;
  if (me < 4) { nb = 4; mult = 4; }
  else if (me < 6) { nb = 3; mult = 6; }
  else if (me < 16) { nb = 2; mult = 16; }
  else {
    std::memcpy(out, data, n);
    out[n] = 0x10;
    return (int64_t)(n + 1);
  }
  uint64_t n_full = n / nb;
  if (nb == 4) {
    for (uint64_t t = 0; t < n_full; ++t) {
      const uint8_t* p = data + t * 4;
      out[t] = (uint8_t)((((p[0] << 2 | p[1]) << 2 | p[2]) << 2) | p[3]);
    }
  } else if (nb == 3) {
    for (uint64_t t = 0; t < n_full; ++t) {
      const uint8_t* p = data + t * 3;
      out[t] = (uint8_t)((p[0] * 6 + p[1]) * 6 + p[2]);
    }
  } else {
    for (uint64_t t = 0; t < n_full; ++t) {
      const uint8_t* p = data + t * 2;
      out[t] = (uint8_t)(p[0] * 16 + p[1]);
    }
  }
  uint32_t c = 0;
  for (uint64_t t = n_full * nb; t < n; ++t) c = c * mult + data[t];
  out[n_full] = (uint8_t)c;
  out[n_full + 1] = (uint8_t)((nb << 4) | (n % nb));
  return (int64_t)(n_full + 2);
}

}  // extern "C"

// ===========================================================================
// Lane-interleaved order-0 rANS (TPU-native archive profile entropy stage).
//
// BITSTREAM SPEC: agc_tpu/core/entropy.py (the host/device reference
// implementation). This scalar path exploits that lanes are fully
// independent: lane j owns positions j, j+L, j+2L, ... with its own
// 32-bit state and byte stream, so it encodes/decodes lane-by-lane in
// cache order and produces byte-identical blobs to the lockstep
// host-numpy and device-XLA implementations.
// ===========================================================================

namespace rans {

constexpr uint32_t kProbBits = 12;
constexpr uint32_t kProbScale = 1u << kProbBits;
constexpr uint32_t kRansL = 1u << 23;
constexpr uint8_t kMagic = 0xA9;
constexpr uint8_t kRawFlag = 0x80;

inline int lanes_for(int64_t n) {
  if (n >= (1 << 16)) return 1024;
  if (n >= (1 << 13)) return 256;
  if (n >= (1 << 10)) return 64;
  if (n >= 64) return 8;
  return 1;
}

inline void put_varint(std::vector<uint8_t>& out, uint64_t v) {
  while (true) {
    uint8_t b = v & 0x7F;
    v >>= 7;
    if (v) out.push_back(b | 0x80); else { out.push_back(b); return; }
  }
}

inline bool get_varint(const uint8_t* buf, int64_t len, int64_t& pos,
                       uint64_t& v) {
  v = 0;
  int shift = 0;
  while (pos < len) {
    uint8_t b = buf[pos++];
    if (shift >= 64) return false;  // overlong encoding (shift UB guard)
    v |= (uint64_t)(b & 0x7F) << shift;
    if (!(b & 0x80)) return true;
    shift += 7;
  }
  return false;
}

inline int varint_len(uint64_t v) {
  int n = 1;
  while (v >= 0x80) { v >>= 7; ++n; }
  return n;
}

// integer-deterministic quantization; mirrors entropy.quantize_freqs
// (ties: larger remainder first / ascending symbol; -1 pass unfiltered)
inline void quantize(const uint64_t counts[256], uint32_t q[256]) {
  uint64_t total = 0;
  for (int i = 0; i < 256; ++i) total += counts[i];
  if (!total) { for (int i = 0; i < 256; ++i) q[i] = 0; return; }
  int64_t qq[256], rem[256];
  int64_t sum = 0;
  for (int i = 0; i < 256; ++i) {
    unsigned __int128 p = (unsigned __int128)counts[i] * kProbScale;
    qq[i] = (int64_t)(p / total);
    rem[i] = (int64_t)(p % total);
    if (counts[i] && !qq[i]) qq[i] = 1;
    sum += qq[i];
  }
  int64_t diff = (int64_t)kProbScale - sum;
  int ord[256];
  for (int i = 0; i < 256; ++i) ord[i] = i;
  if (diff > 0) {
    std::stable_sort(ord, ord + 256,
                     [&](int a, int b) { return rem[a] > rem[b]; });
    int m = 0;
    for (int i = 0; i < 256; ++i)
      if (counts[ord[i]]) ord[m++] = ord[i];
    for (int64_t i = 0; i < diff; ++i) qq[ord[i % m]] += 1;
  } else if (diff < 0) {
    std::stable_sort(ord, ord + 256,
                     [&](int a, int b) { return rem[a] < rem[b]; });
    while (diff < 0) {
      for (int i = 0; i < 256 && diff < 0; ++i) {
        int s = ord[i];
        if (qq[s] > 1) { qq[s] -= 1; ++diff; }
      }
    }
  }
  for (int i = 0; i < 256; ++i) q[i] = (uint32_t)qq[i];
}

}  // namespace rans

extern "C" {

// Compress n bytes into the rANS blob; returns blob length, or -needed
// when cap is too small (call again with a bigger buffer).
int64_t rans_compress(const uint8_t* data, int64_t n, uint8_t* out,
                      int64_t cap) {
  using namespace rans;
  std::vector<uint8_t> blob;
  blob.reserve((size_t)n + 4096);
  blob.push_back(kMagic);
  if (n == 0) {
    blob.push_back(0);
    put_varint(blob, 0);
  } else {
    uint64_t counts[256] = {0};
    for (int64_t i = 0; i < n; ++i) counts[data[i]]++;
    uint32_t F[256];
    quantize(counts, F);
    uint32_t C[257];
    C[0] = 0;
    for (int i = 0; i < 256; ++i) C[i + 1] = C[i] + F[i];

    const int L = lanes_for(n);
    int flags = 0;
    while ((1 << flags) < L) ++flags;
    blob.push_back((uint8_t)flags);
    put_varint(blob, (uint64_t)n);
    for (int i = 0; i < 256; ++i) put_varint(blob, F[i]);

    std::vector<std::vector<uint8_t>> streams((size_t)L);
    std::vector<uint32_t> states((size_t)L);
    const uint32_t xmax_base = (kRansL >> kProbBits) << 8;
    // division-free encode step: ((x/f)<<12) + x%f + c  ==
    // x + (x/f)*(4096-f) + c, with floor(x/f) by exact fixed-point
    // reciprocal (rcp = floor(2^45/f)+1 is exact for x < 2^31, f <= 4096:
    // the error term x*e/(f*2^45) < 2^-14 never crosses a floor boundary
    // since frac(x/f) <= 1 - 2^-12). Handles f = 4096 uniformly (cmpl 0).
    uint64_t rcp[256];
    uint32_t cmpl[256], bias[256];
    for (int s = 0; s < 256; ++s) {
      const uint64_t f = F[s] ? F[s] : 1;
      rcp[s] = ((uint64_t)1 << 45) / f + 1;
      cmpl[s] = kProbScale - (uint32_t)f;
      bias[s] = C[s];
    }
    // 4-way lane interleave (see the decode loop): four independent
    // state chains per iteration hide the mul/renorm latency. Lanes with
    // the extra symbol (cnt differs by <=1 within a group of 4 adjacent
    // lanes) process their highest t first, then the shared descent.
    const int64_t per_lane_cap = 2 * ((n + L - 1) / L) + 8;
    for (int j = 0; j < L; ++j) streams[(size_t)j].reserve(per_lane_cap);
    auto enc_one = [&](uint32_t& x, std::vector<uint8_t>& st, uint8_t s) {
      const uint32_t x_max = xmax_base * F[s];
      while (x >= x_max) { st.push_back((uint8_t)(x & 0xFF)); x >>= 8; }
      const uint32_t q =
          (uint32_t)(((unsigned __int128)x * rcp[s]) >> 45);
      x = x + q * cmpl[s] + bias[s];
    };
    int j = 0;
    for (; j + 4 <= L; j += 4) {
      uint32_t x0 = kRansL, x1 = kRansL, x2 = kRansL, x3 = kRansL;
      auto &s0v = streams[(size_t)j], &s1v = streams[(size_t)j + 1];
      auto &s2v = streams[(size_t)j + 2], &s3v = streams[(size_t)j + 3];
      const int64_t cnt_min = (n - (j + 3) + L - 1) / L;
      // tails first (encode walks t downward)
      for (int u = 0; u < 4; ++u) {
        const int lane = j + u;
        const int64_t cnt = (n - lane + L - 1) / L;
        uint32_t* xs[4] = {&x0, &x1, &x2, &x3};
        for (int64_t t = cnt - 1; t >= cnt_min; --t)
          enc_one(*xs[u], streams[(size_t)lane], data[lane + t * L]);
      }
      // cnt_min == 0 (part shorter than one full lane-group row) must not
      // even form the out-of-bounds row pointer (UB before the loop guard)
      const uint8_t* row = cnt_min > 0 ? data + (cnt_min - 1) * L + j : nullptr;
      for (int64_t t = cnt_min - 1; t >= 0; --t, row -= L) {
        const uint8_t c0 = row[0], c1 = row[1], c2 = row[2], c3 = row[3];
        const uint32_t m0 = xmax_base * F[c0], m1 = xmax_base * F[c1];
        const uint32_t m2 = xmax_base * F[c2], m3 = xmax_base * F[c3];
        while (x0 >= m0) { s0v.push_back((uint8_t)(x0 & 0xFF)); x0 >>= 8; }
        while (x1 >= m1) { s1v.push_back((uint8_t)(x1 & 0xFF)); x1 >>= 8; }
        while (x2 >= m2) { s2v.push_back((uint8_t)(x2 & 0xFF)); x2 >>= 8; }
        while (x3 >= m3) { s3v.push_back((uint8_t)(x3 & 0xFF)); x3 >>= 8; }
        x0 += (uint32_t)(((unsigned __int128)x0 * rcp[c0]) >> 45) * cmpl[c0] + bias[c0];
        x1 += (uint32_t)(((unsigned __int128)x1 * rcp[c1]) >> 45) * cmpl[c1] + bias[c1];
        x2 += (uint32_t)(((unsigned __int128)x2 * rcp[c2]) >> 45) * cmpl[c2] + bias[c2];
        x3 += (uint32_t)(((unsigned __int128)x3 * rcp[c3]) >> 45) * cmpl[c3] + bias[c3];
      }
      states[(size_t)j] = x0;
      states[(size_t)j + 1] = x1;
      states[(size_t)j + 2] = x2;
      states[(size_t)j + 3] = x3;
      std::reverse(s0v.begin(), s0v.end());
      std::reverse(s1v.begin(), s1v.end());
      std::reverse(s2v.begin(), s2v.end());
      std::reverse(s3v.begin(), s3v.end());
    }
    for (; j < L; ++j) {
      uint32_t x = kRansL;
      auto& st = streams[(size_t)j];
      const int64_t cnt = (n - j + L - 1) / L;
      for (int64_t t = cnt - 1; t >= 0; --t)
        enc_one(x, st, data[j + t * L]);
      std::reverse(st.begin(), st.end());
      states[(size_t)j] = x;
    }
    for (int j = 0; j < L; ++j) put_varint(blob, streams[(size_t)j].size());
    for (int j = 0; j < L; ++j) {
      uint32_t v = states[(size_t)j];
      blob.push_back((uint8_t)(v & 0xFF));
      blob.push_back((uint8_t)((v >> 8) & 0xFF));
      blob.push_back((uint8_t)((v >> 16) & 0xFF));
      blob.push_back((uint8_t)((v >> 24) & 0xFF));
    }
    for (int j = 0; j < L; ++j)
      blob.insert(blob.end(), streams[(size_t)j].begin(),
                  streams[(size_t)j].end());
    if ((int64_t)blob.size() >= n + 2 + varint_len((uint64_t)n)) {
      blob.clear();
      blob.push_back(kMagic);
      blob.push_back(kRawFlag);
      put_varint(blob, (uint64_t)n);
      blob.insert(blob.end(), data, data + n);
    }
  }
  if ((int64_t)blob.size() > cap) return -(int64_t)blob.size();
  std::memcpy(out, blob.data(), blob.size());
  return (int64_t)blob.size();
}

// Decode a blob (trailing bytes ignored); returns n, INT64_MIN on a
// corrupt blob, or -needed when cap is too small.
int64_t rans_decompress(const uint8_t* blob, int64_t blob_len, uint8_t* out,
                        int64_t cap) {
  using namespace rans;
  constexpr int64_t kCorrupt = INT64_MIN;
  if (blob_len < 2 || blob[0] != kMagic) return kCorrupt;
  const uint8_t flags = blob[1];
  int64_t pos = 2;
  uint64_t n64;
  if (!get_varint(blob, blob_len, pos, n64)) return kCorrupt;
  if (n64 > (1ULL << 62)) return kCorrupt;  // absurd size = corruption,
  // and keeps the int64 cast / negation below well-defined
  const int64_t n = (int64_t)n64;
  if (n == 0) return 0;
  if (n > cap) return -n;
  if (flags & kRawFlag) {
    if (n > blob_len - pos) return kCorrupt;
    std::memcpy(out, blob + pos, (size_t)n);
    return n;
  }
  uint32_t F[256];
  {
    uint64_t total = 0;
    for (int i = 0; i < 256; ++i) {
      uint64_t v;
      if (!get_varint(blob, blob_len, pos, v)) return kCorrupt;
      if (v > kProbScale) return kCorrupt;  // a wrapping uint32 cumsum
      // could pass the total check while C[s+1] > kProbScale, making the
      // slot-table fill write past cum2sym
      F[i] = (uint32_t)v;
      total += v;
    }
    if (total != kProbScale) return kCorrupt;
  }
  uint32_t C[257];
  C[0] = 0;
  for (int i = 0; i < 256; ++i) C[i + 1] = C[i] + F[i];
  // slot -> symbol table
  std::vector<uint8_t> cum2sym(kProbScale);
  for (int s = 0; s < 256; ++s)
    for (uint32_t i = C[s]; i < C[s + 1]; ++i) cum2sym[i] = (uint8_t)s;

  const int L = lanes_for(n);
  std::vector<uint64_t> lens((size_t)L);
  for (int j = 0; j < L; ++j)
    if (!get_varint(blob, blob_len, pos, lens[(size_t)j])) return kCorrupt;
  if (pos + 4 * (int64_t)L > blob_len) return kCorrupt;
  std::vector<uint32_t> states((size_t)L);
  for (int j = 0; j < L; ++j) {
    states[(size_t)j] = (uint32_t)blob[pos] | ((uint32_t)blob[pos + 1] << 8) |
                        ((uint32_t)blob[pos + 2] << 16) |
                        ((uint32_t)blob[pos + 3] << 24);
    pos += 4;
  }
  // per-lane stream bounds
  std::vector<const uint8_t*> ptrs((size_t)L), ends((size_t)L);
  {
    int64_t off = pos;
    for (int j = 0; j < L; ++j) {
      // bound each length BEFORE forming pointers: a length >= 2^63
      // cast to int64 would step off backwards past the check
      if (lens[(size_t)j] > (uint64_t)(blob_len - off)) return kCorrupt;
      ptrs[(size_t)j] = blob + off;
      off += (int64_t)lens[(size_t)j];
      ends[(size_t)j] = blob + off;
    }
  }
  // 4-way lane interleave: each lane's state chain is serial (multiply ->
  // table lookup -> refill), so decoding four independent lanes per loop
  // iteration hides the chain latency. Lane counts within a group of 4
  // adjacent lanes differ by at most one symbol (interleaved layout);
  // the shared loop runs to the group minimum, tails finish per lane.
  int j = 0;
  for (; j + 4 <= L; j += 4) {
    uint32_t x0 = states[(size_t)j], x1 = states[(size_t)j + 1];
    uint32_t x2 = states[(size_t)j + 2], x3 = states[(size_t)j + 3];
    const uint8_t *p0 = ptrs[(size_t)j], *p1 = ptrs[(size_t)j + 1];
    const uint8_t *p2 = ptrs[(size_t)j + 2], *p3 = ptrs[(size_t)j + 3];
    const uint8_t *e0 = ends[(size_t)j], *e1 = ends[(size_t)j + 1];
    const uint8_t *e2 = ends[(size_t)j + 2], *e3 = ends[(size_t)j + 3];
    const int64_t cnt_min = (n - (j + 3) + L - 1) / L;
    uint8_t* o = out + j;
    for (int64_t t = 0; t < cnt_min; ++t, o += L) {
      uint32_t slot0 = x0 & (kProbScale - 1), slot1 = x1 & (kProbScale - 1);
      uint32_t slot2 = x2 & (kProbScale - 1), slot3 = x3 & (kProbScale - 1);
      const uint8_t s0 = cum2sym[slot0], s1 = cum2sym[slot1];
      const uint8_t s2 = cum2sym[slot2], s3 = cum2sym[slot3];
      o[0] = s0; o[1] = s1; o[2] = s2; o[3] = s3;
      x0 = F[s0] * (x0 >> kProbBits) + slot0 - C[s0];
      x1 = F[s1] * (x1 >> kProbBits) + slot1 - C[s1];
      x2 = F[s2] * (x2 >> kProbBits) + slot2 - C[s2];
      x3 = F[s3] * (x3 >> kProbBits) + slot3 - C[s3];
      while (x0 < kRansL && p0 < e0) x0 = (x0 << 8) | *p0++;
      while (x1 < kRansL && p1 < e1) x1 = (x1 << 8) | *p1++;
      while (x2 < kRansL && p2 < e2) x2 = (x2 << 8) | *p2++;
      while (x3 < kRansL && p3 < e3) x3 = (x3 << 8) | *p3++;
    }
    // tails (lanes with one extra symbol) + write back cursors
    uint32_t xs[4] = {x0, x1, x2, x3};
    const uint8_t* ps[4] = {p0, p1, p2, p3};
    const uint8_t* es[4] = {e0, e1, e2, e3};
    for (int u = 0; u < 4; ++u) {
      const int lane = j + u;
      const int64_t cnt = (n - lane + L - 1) / L;
      uint32_t x = xs[u];
      const uint8_t* ptr = ps[u];
      for (int64_t t = cnt_min; t < cnt; ++t) {
        const uint32_t slot = x & (kProbScale - 1);
        const uint8_t s = cum2sym[slot];
        out[lane + t * L] = s;
        x = F[s] * (x >> kProbBits) + slot - C[s];
        while (x < kRansL && ptr < es[u]) x = (x << 8) | *ptr++;
      }
    }
  }
  for (; j < L; ++j) {
    const uint8_t* ptr = ptrs[(size_t)j];
    const uint8_t* end = ends[(size_t)j];
    uint32_t x = states[(size_t)j];
    const int64_t cnt = (n - j + L - 1) / L;
    for (int64_t t = 0; t < cnt; ++t) {
      const uint32_t slot = x & (kProbScale - 1);
      const uint8_t s = cum2sym[slot];
      out[j + t * L] = s;
      x = F[s] * (x >> kProbBits) + slot - C[s];
      while (x < kRansL && ptr < end) x = (x << 8) | *ptr++;
    }
  }
  return n;
}

// ---------------------------------------------------------------------------
// Host membership scan: rolling canonical k-mer over numeric codes, hit
// when the canonical code is in the sorted splitter table. This is the
// host twin of the device scan kernels in ops/kmers.py (the fallback the
// scan pipeline hedges to when the device link is degraded); the result
// contract matches _decode_scan_vec exactly: ascending end-of-window
// positions with both orientations' LEFT-ALIGNED u64 codes.
// Reference behavior: the rolling CKmer walk of compress_contig
// (agc_compressor.cpp:1997-2051) with the bloom+hash splitter check
// replaced by one open-addressing probe per valid window.
// ---------------------------------------------------------------------------

namespace {

constexpr uint64_t kScanMul1 = 0x9E3779B97F4A7C15ull;  // Fibonacci hashing
constexpr uint64_t kScanMul2 = 0xC2B2AE3D27D4EB4Full;

struct ScanHit {
  int64_t pos;
  uint64_t dir, rc;
};

}  // namespace

// Full per-position canonical k-mer materialization: out_canon[i] is the
// LEFT-ALIGNED canonical code of the window ending at i, out_valid[i]
// whether the window is in-bounds and ACGT-only. Exact twin of the numpy
// canon_kmers_np (ops/kmers.py): symbols > 3 roll a 0 into the chain (so
// values at invalid positions match numpy's garbage bit-for-bit) but
// reset the validity run. 4 interleaved lanes over contiguous quarters.
void kmer_canon_all(const uint8_t* codes, int64_t n, uint32_t k,
                    uint64_t* out_canon, uint8_t* out_valid) {
  if (n <= 0) return;
  const uint32_t shift_align = 64 - 2 * k;
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
  const uint32_t rc_top = 2 * (k - 1);
  constexpr int kLanes = 4;
  int64_t bounds[kLanes + 1];
  for (int l = 0; l <= kLanes; ++l) bounds[l] = n * l / kLanes;
  // rc chains start all-ones over the 2k window: numpy's twin treats
  // phantom (pre-sequence) symbols as A, whose complement is T (0b11) —
  // with this init the values at i < k-1 match numpy bit-for-bit too.
  uint64_t dirv[kLanes] = {0, 0, 0, 0};
  uint64_t rcv[kLanes] = {mask, mask, mask, mask};
  uint32_t runv[kLanes] = {0, 0, 0, 0};
  int64_t cur[kLanes], end[kLanes], emit_from[kLanes];
  int64_t steps = 0;
  for (int l = 0; l < kLanes; ++l) {
    emit_from[l] = bounds[l];
    cur[l] = l == 0 ? 0 : std::max<int64_t>(0, bounds[l] - (k - 1));
    end[l] = bounds[l + 1];
    if (end[l] - cur[l] > steps) steps = end[l] - cur[l];
  }
  // the warmup ramp (k-1 symbols before each lane's emit range) fully
  // determines every emitted window's k symbol pairs, so lane seams are
  // exact.
  for (int64_t s = 0; s < steps; ++s) {
    for (int l = 0; l < kLanes; ++l) {
      const int64_t i = cur[l];
      if (i >= end[l]) continue;
      cur[l] = i + 1;
      const uint8_t craw = codes[i];
      const uint8_t c = craw > 3 ? 0 : craw;
      const uint64_t dir = ((dirv[l] << 2) | c) & mask;
      const uint64_t rc = (rcv[l] >> 2) | ((uint64_t)(3 - c) << rc_top);
      dirv[l] = dir;
      rcv[l] = rc;
      runv[l] = craw > 3 ? 0 : runv[l] + 1;
      if (i < emit_from[l]) continue;
      out_canon[i] = (dir < rc ? dir : rc) << shift_align;
      out_valid[i] = (i >= (int64_t)k - 1) && (runv[l] >= k);
    }
  }
}

// Host splitter-discovery greedy: exact twin of the Python probe walk
// in Compressor._determine_splitters_host (reference semantics:
// find_splitters_in_contig, agc_compressor.cpp:762-825). pool_sorted is
// the reference's full canonical k-mer pool (left-aligned, duplicates
// retained, ascending); a window is a SPLITTER candidate when its
// canonical code occurs exactly once in the pool. Walk: emit the first
// singleton at/after t, then jump t = pos + seg; afterwards emit the
// rightmost singleton anywhere iff it is >= last_emission + k (the
// reference's rightmost-candidate tail). Rolling-chain semantics match
// kmer_scan_members (symbols > 3 reset the validity run). Returns the
// emission count; positions ascending (the tail, when emitted, is
// strictly greatest). out arrays must hold >= cap entries; the return
// value can exceed cap only if cap < 2 + n/seg (callers size for that).
int64_t kmer_discover_splitters(const uint8_t* codes, int64_t n,
                                uint32_t k, const uint64_t* pool_sorted,
                                int64_t t, int64_t seg, int64_t* out_pos,
                                uint64_t* out_kmer, int64_t cap) {
  if (n < (int64_t)k || t <= 0) return 0;
  const uint32_t shift_align = 64 - 2 * k;
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
  const uint32_t rc_top = 2 * (k - 1);
  // singleton test: exactly one pool entry equals the key
  auto singleton = [&](uint64_t key) {
    const uint64_t* p = std::lower_bound(pool_sorted, pool_sorted + t, key);
    if (p == pool_sorted + t || *p != key) return false;
    return (p + 1 == pool_sorted + t) || (p[1] != key);
  };
  // scan [from, until): first (dir=+1) or last (dir=-1 caller loops
  // blocks) singleton position; chain warms up k-1 symbols before
  // `from`. Returns -1 when none; else fills canon.
  auto first_singleton = [&](int64_t from, int64_t until, bool want_last,
                             uint64_t* canon_out) -> int64_t {
    uint64_t dirv = 0, rcv = 0;
    uint32_t run = 0;
    int64_t found = -1;
    for (int64_t i = std::max<int64_t>(0, from - ((int64_t)k - 1));
         i < until; ++i) {
      const uint8_t c = codes[i];
      if (c > 3) { run = 0; continue; }
      dirv = ((dirv << 2) | c) & mask;
      rcv = (rcv >> 2) | ((uint64_t)(3 - c) << rc_top);
      if (++run < k || i < from) continue;
      const uint64_t canon = (dirv < rcv ? dirv : rcv) << shift_align;
      if (!singleton(canon)) continue;
      if (!want_last) { *canon_out = canon; return i; }
      found = i;
      *canon_out = canon;
    }
    return found;
  };
  int64_t cnt = 0;
  int64_t last = -1;
  int64_t pos = 0;
  uint64_t canon;
  while (pos < n) {
    const int64_t p = first_singleton(pos, n, false, &canon);
    if (p < 0) break;
    if (cnt < cap) { out_pos[cnt] = p; out_kmer[cnt] = canon; }
    ++cnt;
    last = p;
    pos = p + seg;
  }
  // rightmost-candidate tail: first non-empty block scanning backward
  // holds the overall rightmost singleton; emit iff >= last + k
  const int64_t floor_pos = last >= 0 ? last + (int64_t)k : 0;
  const int64_t kBlock = 1 << 16;
  for (int64_t be = n; be > 0; be -= kBlock) {
    const int64_t bs = std::max<int64_t>(0, be - kBlock);
    const int64_t p = first_singleton(bs, be, true, &canon);
    if (p >= 0) {
      if (p >= floor_pos && p != last) {
        if (cnt < cap) { out_pos[cnt] = p; out_kmer[cnt] = canon; }
        ++cnt;
      }
      break;
    }
    if (bs == 0) break;
  }
  return cnt;
}

// Compacted pool fill: write the LEFT-ALIGNED canonical code of every
// valid window (in-bounds, ACGT-only) of `codes` into out[0..ret), in
// position order. Single pass, no per-position valid array, no numpy
// temporaries — the discovery pool fill used to materialize canon
// (8 B/pos) + valid (1 B/pos) + the boolean-mask gather per contig,
// which at a 500 Mbase reference cost gigabytes of transient
// allocations on a box whose first-touch fault cost swings 0.1-9 GB/s
// (the round-4 "box CPU drift"). Four interleaved lanes over
// contiguous quarters, each compacting into its own out region
// (a lane's valid count never exceeds its quarter length), stitched
// contiguous with memmove at the end.
int64_t kmer_canon_fill(const uint8_t* codes, int64_t n, uint32_t k,
                        uint64_t* out) {
  if (n < (int64_t)k) return 0;
  const uint32_t shift_align = 64 - 2 * k;
  const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
  const uint32_t rc_top = 2 * (k - 1);
  constexpr int kLanes = 4;
  int64_t bounds[kLanes + 1];
  for (int l = 0; l <= kLanes; ++l) bounds[l] = n * l / kLanes;
  uint64_t dirv[kLanes] = {0, 0, 0, 0};
  uint64_t rcv[kLanes] = {0, 0, 0, 0};
  uint32_t runv[kLanes] = {0, 0, 0, 0};
  int64_t cur[kLanes], end[kLanes], emit_from[kLanes], w[kLanes];
  int64_t steps = 0;
  for (int l = 0; l < kLanes; ++l) {
    emit_from[l] = bounds[l];
    cur[l] = l == 0 ? 0 : std::max<int64_t>(0, bounds[l] - (k - 1));
    end[l] = bounds[l + 1];
    w[l] = bounds[l];
    if (end[l] - cur[l] > steps) steps = end[l] - cur[l];
  }
  for (int64_t s = 0; s < steps; ++s) {
    for (int l = 0; l < kLanes; ++l) {
      const int64_t i = cur[l];
      if (i >= end[l]) continue;
      cur[l] = i + 1;
      const uint8_t craw = codes[i];
      const uint8_t c = craw > 3 ? 0 : craw;
      dirv[l] = ((dirv[l] << 2) | c) & mask;
      rcv[l] = (rcv[l] >> 2) | ((uint64_t)(3 - c) << rc_top);
      runv[l] = craw > 3 ? 0 : runv[l] + 1;
      if (i < emit_from[l] || i < (int64_t)k - 1 || runv[l] < k) continue;
      out[w[l]++] =
          (dirv[l] < rcv[l] ? dirv[l] : rcv[l]) << shift_align;
    }
  }
  // stitch lanes contiguous
  int64_t total = w[0] - bounds[0];
  for (int l = 1; l < kLanes; ++l) {
    const int64_t cnt = w[l] - bounds[l];
    if (cnt && total != bounds[l])
      std::memmove(out + total, out + bounds[l], cnt * sizeof(uint64_t));
    total += cnt;
  }
  return total;
}

int64_t kmer_scan_members(const uint8_t* codes, int64_t n, uint32_t k,
                          const uint64_t* table_sorted, int64_t t,
                          int64_t* out_pos, uint64_t* out_dir,
                          uint64_t* out_rc, int64_t cap) {
  if (n < (int64_t)k || t <= 0) return 0;
  // byte-bloom prefilter over UNALIGNED canonical codes: slot from the
  // top bits of ONE multiply-shift hash, 1-of-8 tag bit from the 3 bits
  // just below the slot (a second multiply measured ~25% of the whole
  // scan's wall on the bench core). OR-accumulating bits means
  // colliding table entries can never be missed (no false negatives);
  // false positives fall through to the exact check.
  uint32_t bloom_log = 12;
  while (bloom_log < 20 && (1u << bloom_log) < (uint64_t)t * 16) ++bloom_log;
  std::vector<uint8_t> bloom(1u << bloom_log, 0);
  const uint32_t shift_align = 64 - 2 * k;
  const uint32_t hsh = 64 - bloom_log;
  for (int64_t i = 0; i < t; ++i) {
    const uint64_t v = table_sorted[i] >> shift_align;  // unaligned
    const uint64_t h = v * kScanMul1;
    bloom[h >> hsh] |= (uint8_t)(1u << ((h >> (hsh - 3)) & 7));
  }
  // 8 interleaved lanes over contiguous eighths: the rolling dir/rc
  // chains are serial per position, so one lane is latency-bound;
  // eight independent chains in one fused loop fill the core's ports
  // (lane sweep on the bench core: 4 lanes 217, 6 375, 8 464, 12+
  // spill — Msym/s). Lanes 1..7 roll a k-1 warmup ramp (no emission)
  // so hits are identical to the single-chain walk. Eighths are
  // contiguous and in order, so per-lane hit vectors concatenate
  // already sorted by position. The steady-state loop keeps all lane
  // state in named locals and carries NO per-step bounds/emit
  // bookkeeping (the warmup ramp and lane tails run separately).
  constexpr int kLanes = 8;
  std::vector<ScanHit> hits[kLanes];
  int64_t bounds[kLanes + 1];
  for (int l = 0; l <= kLanes; ++l) bounds[l] = n * l / kLanes;
  {
    const uint64_t mask = (k < 32) ? ((1ull << (2 * k)) - 1) : ~0ull;
    const uint32_t rc_top = 2 * (k - 1);
    uint64_t d[kLanes] = {}, r[kLanes] = {};
    uint32_t q[kLanes] = {};
    // warmup ramp: lanes 1.. roll k-1 symbols before their block
    for (int l = 1; l < kLanes; ++l) {
      const int64_t from = std::max<int64_t>(0, bounds[l] - ((int64_t)k - 1));
      for (int64_t i = from; i < bounds[l]; ++i) {
        const uint8_t c = codes[i];
        if (c > 3) { q[l] = 0; continue; }
        d[l] = ((d[l] << 2) | c) & mask;
        r[l] = (r[l] >> 2) | ((uint64_t)(3 - c) << rc_top);
        ++q[l];
      }
    }
    int64_t len[kLanes];
    const uint8_t* base[kLanes];
    for (int l = 0; l < kLanes; ++l) {
      len[l] = bounds[l + 1] - bounds[l];
      base[l] = codes + bounds[l];
    }
    int64_t steady = len[0];
    for (int l = 1; l < kLanes; ++l) steady = std::min(steady, len[l]);
    const uint8_t* bl = bloom.data();
    // validity as a last-invalid POSITION register instead of a
    // per-symbol run counter: li[J] is set only on the rare invalid
    // symbol (predicted-not-taken branch), and a window ending at i is
    // valid iff i - li[J] >= k (li starts at -1 - warmup_run so the
    // warmup ramp's run carries over). Invalid symbols roll their low
    // 2 bits into the chain — emitted values are unaffected because a
    // hit requires k valid symbols, which fully determine both masked
    // chains. Complement via XOR (3-c == c^3 for 2-bit codes). Two
    // rare branches (invalid; bloom-hit) per symbol, nothing else.
    int64_t li[kLanes];
    for (int l = 0; l < kLanes; ++l) li[l] = -1 - (int64_t)q[l];
    for (int64_t i = 0; i < steady; ++i) {
#pragma GCC unroll 8
      for (int J = 0; J < kLanes; ++J) {
        const uint8_t craw = base[J][i];
        if (__builtin_expect(craw > 3, 0)) li[J] = i;
        const uint64_t c = craw & 3u;
        d[J] = ((d[J] << 2) | c) & mask;
        r[J] = (r[J] >> 2) | ((c ^ 3ull) << rc_top);
        const uint64_t canon = d[J] < r[J] ? d[J] : r[J];
        const uint64_t h = canon * kScanMul1;
        const bool hit =
            (bl[h >> hsh] & (uint8_t)(1u << ((h >> (hsh - 3)) & 7))) &&
            i - li[J] >= (int64_t)k;
        if (__builtin_expect(hit, 0)) {
          const uint64_t key = canon << shift_align;
          const uint64_t* p =
              std::lower_bound(table_sorted, table_sorted + t, key);
          if (p != table_sorted + t && *p == key)
            hits[J].push_back({bounds[J] + i, d[J] << shift_align,
                               r[J] << shift_align});
        }
      }
    }
    for (int l = 0; l < kLanes; ++l) {
      const int64_t run = steady - 1 - li[l];
      q[l] = run < 0 ? 0u : (uint32_t)std::min<int64_t>(run, 1 << 30);
    }
    // lane tails (block lengths differ by at most 1)
    for (int l = 0; l < kLanes; ++l) {
      for (int64_t i = steady; i < len[l]; ++i) {
        const uint8_t c = base[l][i];
        if (c > 3) { q[l] = 0; continue; }
        d[l] = ((d[l] << 2) | c) & mask;
        r[l] = (r[l] >> 2) | ((uint64_t)(3 - c) << rc_top);
        if (++q[l] < k) continue;
        const uint64_t canon = d[l] < r[l] ? d[l] : r[l];
        const uint64_t h = canon * kScanMul1;
        if (!(bloom[h >> hsh] & (uint8_t)(1u << ((h >> (hsh - 3)) & 7))))
          continue;
        const uint64_t key = canon << shift_align;
        const uint64_t* p =
            std::lower_bound(table_sorted, table_sorted + t, key);
        if (p == table_sorted + t || *p != key) continue;
        hits[l].push_back({bounds[l] + i, d[l] << shift_align,
                           r[l] << shift_align});
      }
    }
  }
  int64_t cnt = 0;
  for (int l = 0; l < kLanes; ++l) {
    for (const ScanHit& h : hits[l]) {
      if (cnt < cap) {
        out_pos[cnt] = h.pos;
        out_dir[cnt] = h.dir;
        out_rc[cnt] = h.rc;
      }
      ++cnt;
    }
  }
  return cnt;
}

}  // extern "C"
