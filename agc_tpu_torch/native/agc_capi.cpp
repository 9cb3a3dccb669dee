// agc-tpu native C API: decompression-only access to AGC archives from
// C/C++ without a Python runtime.
//
// Mirrors the reference library's C ABI exactly (reference:
// src/lib-cxx/agc-api.h:119-203, lib-cxx.cpp C section) so existing C
// clients of AGC can link against this library unchanged. The on-disk
// formats implemented here follow the same layout as the Python engine
// (agc_tpu_torch/core/{archive,collection,segment,codecs}.py), which is
// bit-compatible with AGC 3.x archives:
//   - archive container: parts + footer (reference: archive.cpp:142-293)
//   - collection v3: batched sample/contig metadata with tokenized
//     delta-coded names and 5 zstd substreams of segment details
//     (reference: collection_v3.cpp)
//   - segment groups: zstd refs (optional "tuples" repack) + LZ-diff
//     delta packs (reference: segment.cpp, lz_diff.cpp)
//
// Compiled together with lz_native.cpp (shares the LZ decoders); links
// against libzstd's runtime library (libzstd.so.1).

#include <algorithm>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

// The three libzstd functions this reader calls, from zstd.h's stable
// ABI, declared here so the library builds where only libzstd.so.1 is
// installed (no zstd.h, no unversioned libzstd.so).
extern "C" {
size_t ZSTD_findFrameCompressedSize(const void* src, size_t srcSize);
unsigned ZSTD_isError(size_t code);
size_t ZSTD_decompress(void* dst, size_t dstCapacity, const void* src,
                       size_t compressedSize);
}

// from lz_native.cpp
extern "C" {
int64_t lz_decode_v2(const uint8_t* ref, uint64_t ref_len, const uint8_t* enc,
                     uint64_t enc_len, uint32_t mml, uint8_t* out, uint64_t cap);
int64_t lz_decode_v1(const uint8_t* ref, uint64_t ref_len, const uint8_t* enc,
                     uint64_t enc_len, uint32_t mml, uint8_t* out, uint64_t cap);
}

namespace agctpu {

// ===========================================================================
// small codecs (agc_tpu_torch/core/codecs.py)
// ===========================================================================

// footer varint: 1 length byte + big-endian payload
static bool dec_be_varint(const uint8_t* buf, size_t len, size_t& pos,
                          uint64_t& out) {
  if (pos >= len) return false;
  uint32_t n = buf[pos++];
  if (n > 8 || pos + n > len) return false;
  uint64_t x = 0;
  for (uint32_t i = 0; i < n; ++i) x = (x << 8) | buf[pos++];
  out = x;
  return true;
}

// collection prefix varint (reference: collection.h:100-217)
static bool dec_prefix_varint(const uint8_t* buf, size_t len, size_t& pos,
                              uint64_t& out) {
  if (pos >= len) return false;
  uint32_t b0 = buf[pos];
  const uint64_t THR1 = 1ull << 7, THR2 = THR1 + (1ull << 14),
                 THR3 = THR2 + (1ull << 21), THR4 = THR3 + (1ull << 28);
  if ((b0 & 0x80) == 0) { out = b0; pos += 1; return true; }
  if ((b0 & 0xC0) == 0x80) {
    if (pos + 2 > len) return false;
    out = ((uint64_t)(b0 - 0x80) << 8) + buf[pos + 1] + THR1;
    pos += 2; return true;
  }
  if ((b0 & 0xE0) == 0xC0) {
    if (pos + 3 > len) return false;
    out = ((uint64_t)(b0 - 0xC0) << 16) + ((uint64_t)buf[pos + 1] << 8) +
          buf[pos + 2] + THR2;
    pos += 3; return true;
  }
  if ((b0 & 0xF0) == 0xE0) {
    if (pos + 4 > len) return false;
    out = ((uint64_t)(b0 - 0xE0) << 24) + ((uint64_t)buf[pos + 1] << 16) +
          ((uint64_t)buf[pos + 2] << 8) + buf[pos + 3] + THR3;
    pos += 4; return true;
  }
  if (pos + 5 > len) return false;
  out = ((uint64_t)buf[pos + 1] << 24) + ((uint64_t)buf[pos + 2] << 16) +
        ((uint64_t)buf[pos + 3] << 8) + buf[pos + 4] + THR4;
  pos += 5;
  return true;
}

static int64_t zigzag_decode_pred(uint64_t x_val, int64_t x_prev) {
  if ((int64_t)x_val >= 2 * x_prev) return (int64_t)x_val;
  if (x_val & 1) return (2 * x_prev - (int64_t)x_val) / 2;
  return ((int64_t)x_val + 2 * x_prev) / 2;
}

static const char B64_DIGITS[] =
    "0123456789ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz_#";

static std::string int_to_base64(uint64_t n) {
  std::string r;
  while (true) {
    r.push_back(B64_DIGITS[n & 0x3F]);
    n /= 64;
    if (!n) break;
  }
  return r;
}

// numeric -> ASCII (reference: agc_basic.h:40-50)
static const char CNV_NUM_TAB[] = "ACGTNRYSWKMBDHVU";

static std::string extract_contig_name(const std::string& s) {
  size_t i = s.find_first_of(" \n\r\t");
  return i == std::string::npos ? s : s.substr(0, i);
}

// ===========================================================================
// archive reader (agc_tpu_torch/core/archive.py; reference: archive.cpp)
// ===========================================================================

struct Stream {
  std::vector<std::pair<uint64_t, uint64_t>> parts;  // (offset, size)
  uint64_t raw_size = 0;
};

class Archive {
 public:
  bool open(const char* path, bool prefetch) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return false;
    std::fseek(f, 0, SEEK_END);
    long fsz = std::ftell(f);
    if (fsz < 8) { std::fclose(f); return false; }
    fsize_ = (uint64_t)fsz;
    if (prefetch) {
      buf_.resize(fsize_);
      std::fseek(f, 0, SEEK_SET);
      if (std::fread(buf_.data(), 1, fsize_, f) != fsize_) {
        std::fclose(f); return false;
      }
      std::fclose(f);
      f_ = nullptr;
    } else {
      f_ = f;
    }
    return deserialize();
  }

  ~Archive() {
    if (f_) std::fclose(f_);
  }

  bool read_at(uint64_t off, uint64_t size, uint8_t* out) const {
    // subtraction form: off + size can wrap for hostile footer offsets
    if (off > fsize_ || size > fsize_ - off) return false;
    if (!buf_.empty()) {
      std::memcpy(out, buf_.data() + off, size);
      return true;
    }
    std::lock_guard<std::mutex> lk(io_mtx_);
    if (std::fseek(f_, (long)off, SEEK_SET) != 0) return false;
    return std::fread(out, 1, size, f_) == size;
  }

  const Stream* stream(const std::string& name) const {
    auto it = by_name_.find(name);
    return it == by_name_.end() ? nullptr : &streams_[it->second];
  }

  // (data, metadata) of one part; empty part -> data empty, metadata 0
  bool get_part(const std::string& name, size_t part_id,
                std::vector<uint8_t>& data, uint64_t& metadata) const {
    const Stream* s = stream(name);
    if (!s || part_id >= s->parts.size()) return false;
    auto [off, size] = s->parts[part_id];
    if (size == 0) { data.clear(); metadata = 0; return true; }
    if (off > fsize_ || size > fsize_ - off) return false;  // hostile footer
    uint8_t head[9];
    uint64_t head_n = std::min<uint64_t>(9, fsize_ - off);
    if (!read_at(off, head_n, head)) return false;
    size_t p = 0;
    if (!dec_be_varint(head, head_n, p, metadata)) return false;
    data.resize(size);
    return read_at(off + p, size, data.data());
  }

 private:
  bool deserialize() {
    uint8_t tail[8];
    if (!read_at(fsize_ - 8, 8, tail)) return false;
    uint64_t footer_size = 0;
    for (int i = 7; i >= 0; --i) footer_size = (footer_size << 8) | tail[i];
    if (footer_size > fsize_ - 8) return false;  // subtraction form
    std::vector<uint8_t> footer(footer_size);
    if (!read_at(fsize_ - 8 - footer_size, footer_size, footer.data()))
      return false;
    size_t pos = 0;
    uint64_t n_streams = 0;
    if (!dec_be_varint(footer.data(), footer.size(), pos, n_streams))
      return false;
    streams_.reserve(n_streams);
    for (uint64_t i = 0; i < n_streams; ++i) {
      const void* nul = memchr(footer.data() + pos, 0, footer.size() - pos);
      if (!nul) return false;
      std::string name((const char*)footer.data() + pos);
      pos = (const uint8_t*)nul - footer.data() + 1;
      uint64_t n_parts = 0, raw_size = 0;
      if (!dec_be_varint(footer.data(), footer.size(), pos, n_parts))
        return false;
      if (!dec_be_varint(footer.data(), footer.size(), pos, raw_size))
        return false;
      Stream s;
      s.raw_size = raw_size;
      s.parts.reserve(n_parts);
      for (uint64_t j = 0; j < n_parts; ++j) {
        uint64_t off = 0, sz = 0;
        if (!dec_be_varint(footer.data(), footer.size(), pos, off)) return false;
        if (!dec_be_varint(footer.data(), footer.size(), pos, sz)) return false;
        s.parts.emplace_back(off, sz);
      }
      by_name_[name] = streams_.size();
      streams_.push_back(std::move(s));
    }
    return true;
  }

  FILE* f_ = nullptr;
  mutable std::mutex io_mtx_;
  uint64_t fsize_ = 0;
  std::vector<uint8_t> buf_;
  std::vector<Stream> streams_;
  std::unordered_map<std::string, size_t> by_name_;
};

// lane-interleaved rANS decoder from lz_native.cpp (linked into this
// library): the tpu-rans archive profile replaces zstd frames with
// self-identifying 0xA9 blobs (spec: agc_tpu_torch/core/entropy.py)
extern "C" int64_t rans_decompress(const uint8_t* blob, int64_t blob_len,
                                   uint8_t* out, int64_t cap);

// one compressed frame, ignoring trailing marker bytes (the writer
// appends a 1-byte marker after the frame; reference: segment.cpp:304).
// zstd frames start 0x28 B5 2F FD; tpu-rans blobs start 0xA9 — sniffed,
// so one reader serves both archive profiles.
static bool zstd_decompress_tolerant(const uint8_t* src, size_t src_len,
                                     uint64_t raw_size,
                                     std::vector<uint8_t>& out) {
  // raw_size comes from the part's footer varint: a damaged value must
  // not drive the allocation (64 GiB ceiling, as in the Python readers)
  if (raw_size > (64ULL << 30)) return false;
  if (src_len >= 2 && src[0] == 0xA9) {
    out.resize(raw_size);
    int64_t m = rans_decompress(src, (int64_t)src_len, out.data(),
                                (int64_t)out.size());
    // cap == the part's recorded raw size, so a -needed result means the
    // blob's size header disagrees with the metadata: corruption, not a
    // small buffer (growing here let a damaged header drive a huge
    // allocation straight into std::terminate)
    if (m < 0) return false;
    out.resize((size_t)m);
    return true;
  }
  size_t frame = ZSTD_findFrameCompressedSize(src, src_len);
  if (ZSTD_isError(frame)) return false;
  out.resize(raw_size);
  size_t got = ZSTD_decompress(out.data(), raw_size, src, frame);
  if (ZSTD_isError(got)) return false;
  out.resize(got);
  return true;
}

// tuples repacking decode (agc_tpu_torch/core/segment.py; reference: segment.h:73-169)
static bool tuples2bytes(const std::vector<uint8_t>& data,
                         std::vector<uint8_t>& out) {
  if (data.empty()) { out.clear(); return true; }
  uint8_t marker = data.back();
  uint32_t nb = marker >> 4;
  uint32_t trailing = marker & 0xF;
  if (nb == 1) {
    out.assign(data.begin(), data.end() - 1);
    return true;
  }
  uint32_t mult;
  switch (nb) {
    case 4: mult = 4; break;
    case 3: mult = 6; break;
    case 2: mult = 16; break;
    default: return false;
  }
  // mirror the Python twin's guards (segment.py tuples2bytes): a 1-byte
  // part would underflow main_n to SIZE_MAX; trailing must be < nb
  if (data.size() < 2 || trailing >= nb) return false;
  size_t main_n = data.size() - 2;  // last two: packed tail + marker
  size_t out_n = main_n * nb + trailing;
  out.resize(out_n);
  size_t o = 0;
  for (size_t i = 0; i < main_n; ++i) {
    uint32_t v = data[i];
    for (int j = (int)nb - 1; j >= 0; --j) {
      out[o + j] = (uint8_t)(v % mult);
      v /= mult;
    }
    o += nb;
  }
  if (trailing) {
    uint32_t c = data[data.size() - 2];
    for (int j = (int)trailing - 1; j >= 0; --j) {
      out[o + j] = (uint8_t)(c % mult);
      c /= mult;
    }
  }
  return true;
}

// ===========================================================================
// collection v3 (agc_tpu_torch/core/collection.py; reference: collection_v3.cpp)
// ===========================================================================

struct SegmentDesc {
  uint32_t group_id;
  uint32_t in_group_id;
  bool is_rev_comp;
  uint32_t raw_length;
};

struct Contig {
  std::string name;
  std::vector<SegmentDesc> segments;
};

struct Sample {
  std::string name;
  std::vector<Contig> contigs;
  bool contigs_loaded = false;
  bool details_loaded = false;
};

class AgcFile {
 public:
  bool open(const char* path, bool prefetch) {
    if (!arch_.open(path, prefetch)) return false;
    if (!load_file_type_info()) return false;
    if (!load_params()) return false;
    if (archive_version_ < 2000) return load_collection_v1();
    if (archive_version_ < 3000) return load_collection_v2();
    return load_sample_names();
  }

  int n_sample() const { return (int)samples_.size(); }

  int n_ctg(const std::string& sample) {
    std::lock_guard<std::mutex> lk(mtx_);
    int sid = sample_id(sample);
    if (sid < 0) return -1;
    if (!ensure_names(sid)) return -1;
    return (int)samples_[sid].contigs.size();
  }

  std::string reference_sample() const {
    return samples_.empty() ? std::string() : samples_[0].name;
  }

  std::vector<std::string> list_samples() const {
    std::vector<std::string> v;
    v.reserve(samples_.size());
    for (auto& s : samples_) v.push_back(s.name);
    return v;
  }

  bool list_ctg(const std::string& sample, std::vector<std::string>& out) {
    std::lock_guard<std::mutex> lk(mtx_);
    int sid = sample_id(sample);
    if (sid < 0 || !ensure_names(sid)) return false;
    out.clear();
    for (auto& c : samples_[sid].contigs) out.push_back(c.name);
    return true;
  }

  // resolve (sample may be empty -> must be unique across samples)
  const Contig* find_contig(const std::string& sample,
                            const std::string& name) {
    std::lock_guard<std::mutex> lk(mtx_);
    std::string short_name = extract_contig_name(name);
    if (!sample.empty()) {
      int sid = sample_id(sample);
      if (sid < 0 || !ensure_details(sid)) return nullptr;
      for (auto& c : samples_[sid].contigs)
        if (extract_contig_name(c.name) == short_name) return &c;
      return nullptr;
    }
    const Contig* found = nullptr;
    for (size_t sid = 0; sid < samples_.size(); ++sid) {
      if (!ensure_names((int)sid)) return nullptr;
      for (auto& c : samples_[sid].contigs) {
        if (extract_contig_name(c.name) == short_name) {
          if (found) return nullptr;  // ambiguous
          if (!ensure_details((int)sid)) return nullptr;
          for (auto& c2 : samples_[sid].contigs)
            if (extract_contig_name(c2.name) == short_name) found = &c2;
        }
      }
    }
    return found;
  }

  int64_t contig_length(const Contig& c) const {
    if (c.segments.empty()) return 0;  // size()-1 would wrap to +k
    int64_t total = 0;
    for (auto& s : c.segments) total += s.raw_length;
    return total - (int64_t)(c.segments.size() - 1) * kmer_length_;
  }

  // numeric contig with [from, to] trimming
  // (agc_tpu_torch/core/decompressor.py decompress_contig; reference:
  //  agc_decompressor_lib.cpp:172-286)
  bool decompress_contig(const Contig& c, int64_t from, int64_t to,
                         std::vector<uint8_t>& out) {
    const int64_t HUGE_POS = 1ll << 62;
    if (from < 0 && to < 0) { from = 0; to = HUGE_POS; }
    else {
      if (from < 0) from = 0;
      if (to < 0) to = HUGE_POS;
      if (from > to) { from = 0; to = HUGE_POS; }
    }
    out.clear();
    int64_t curr_pos = 0;
    bool first = true;
    uint32_t k = kmer_length_;
    std::vector<uint8_t> seg_data;
    for (auto& seg : c.segments) {
      int64_t seg_len = seg.raw_length;
      if (curr_pos + seg_len < from) {
        from -= seg_len - k;
        to -= seg_len - k;
        continue;
      }
      if (curr_pos > to) break;
      if (!decompress_segment(seg.group_id, seg.in_group_id, seg_data))
        return false;
      if (seg.is_rev_comp)

        reverse_complement(seg_data);
      size_t skip = first ? 0 : k;
      first = false;
      out.insert(out.end(), seg_data.begin() + std::min(skip, seg_data.size()),
                 seg_data.end());
      curr_pos += seg_len - k;
    }
    if ((int64_t)out.size() > to + 1) out.resize(to + 1);
    if (from != 0) {
      if (from > (int64_t)out.size()) from = (int64_t)out.size();
      out.erase(out.begin(), out.begin() + from);
    }
    return true;
  }

  uint32_t kmer_length() const { return kmer_length_; }

 private:
  static void reverse_complement(std::vector<uint8_t>& v) {
    std::reverse(v.begin(), v.end());
    for (auto& x : v)
      if (x < 4) x = 3 - x;
  }

  int sample_id(const std::string& name) const {
    auto it = sample_ids_.find(name);
    return it == sample_ids_.end() ? -1 : (int)it->second;
  }

  bool load_file_type_info() {
    std::vector<uint8_t> data;
    uint64_t n_items = 0;
    if (!arch_.get_part("file_type_info", 0, data, n_items)) return false;
    size_t pos = 0;
    std::map<std::string, std::string> info;
    for (uint64_t i = 0; i < n_items; ++i) {
      const void* n1 = memchr(data.data() + pos, 0, data.size() - pos);
      if (!n1) return false;
      std::string key((const char*)data.data() + pos);
      pos = (const uint8_t*)n1 - data.data() + 1;
      const void* n2 = memchr(data.data() + pos, 0, data.size() - pos);
      if (!n2) return false;
      std::string val((const char*)data.data() + pos);
      pos = (const uint8_t*)n2 - data.data() + 1;
      info[key] = val;
    }
    int maj = info.count("file_version_major")
                  ? atoi(info["file_version_major"].c_str()) : 3;
    int mino = info.count("file_version_minor")
                   ? atoi(info["file_version_minor"].c_str()) : 0;
    archive_version_ = maj * 1000 + mino;
    return archive_version_ < 4000;
  }

  bool load_params() {
    std::vector<uint8_t> data;
    uint64_t meta = 0;
    if (!arch_.get_part("params", 0, data, meta)) return false;
    if (data.size() < 12) return false;
    auto rd_u32 = [&](size_t o) {
      return (uint32_t)data[o] | ((uint32_t)data[o + 1] << 8) |
             ((uint32_t)data[o + 2] << 16) | ((uint32_t)data[o + 3] << 24);
    };
    kmer_length_ = rd_u32(0);
    min_match_len_ = rd_u32(4);
    pack_cardinality_ = rd_u32(8);
    segment_size_ = data.size() >= 16 ? rd_u32(12) : 0;
    // a valid writer clamps both >= 1; zero means a damaged stream (and
    // pack_cardinality_ is a divisor on every member lookup: SIGFPE).
    // k and mml outside the format's ranges (k <= 32: two bits per base
    // in a u64; mml in [12, 32]: the LZ index's key math shifts by
    // 2*(mml-3) and assumes >= 8-symbol keys) mean the same
    if (pack_cardinality_ < 1 || kmer_length_ < 1 || kmer_length_ > 32)
      return false;
    if (min_match_len_ < 12 || min_match_len_ > 32) return false;
    return true;
  }

  static bool read_cstr(const std::vector<uint8_t>& data, size_t& pos,
                        std::string& out) {
    const void* nul = memchr(data.data() + pos, 0, data.size() - pos);
    if (!nul) return false;
    out.assign((const char*)data.data() + pos);
    pos = (const uint8_t*)nul - data.data() + 1;
    return true;
  }

  static int64_t zigzag_decode_plain(uint64_t x) {
    return (x & 1) ? -(int64_t)((x + 1) / 2) : (int64_t)(x / 2);
  }

  // legacy 1.x collection: one zstd blob in "collection-desc"
  // (reference: collection_v1.cpp serialize/deserialize)
  bool load_collection_v1() {
    std::vector<uint8_t> data;
    if (!load_batch_zstd_part("collection-desc", 0, data)) return false;
    size_t pos = 0;
    uint64_t n_samples = 0;
    if (!dec_prefix_varint(data.data(), data.size(), pos, n_samples))
      return false;
    samples_.resize(n_samples);
    for (uint64_t i = 0; i < n_samples; ++i) {
      Sample& s = samples_[i];
      if (!read_cstr(data, pos, s.name)) return false;
      sample_ids_[s.name] = i;
      uint64_t n_contigs = 0;
      if (!dec_prefix_varint(data.data(), data.size(), pos, n_contigs))
        return false;
      s.contigs.assign(n_contigs, Contig{});
      for (uint64_t j = 0; j < n_contigs; ++j) {
        Contig& c = s.contigs[j];
        if (!read_cstr(data, pos, c.name)) return false;
        uint64_t n_seg = 0;
        if (!dec_prefix_varint(data.data(), data.size(), pos, n_seg))
          return false;
        c.segments.resize(n_seg);
        int64_t pg = 0, pig = 0, prl = 0;
        for (uint64_t m = 0; m < n_seg; ++m) {
          uint64_t eg, ei, er, eo;
          if (!dec_prefix_varint(data.data(), data.size(), pos, eg) ||
              !dec_prefix_varint(data.data(), data.size(), pos, ei) ||
              !dec_prefix_varint(data.data(), data.size(), pos, er) ||
              !dec_prefix_varint(data.data(), data.size(), pos, eo))
            return false;
          pg += zigzag_decode_plain(eg);
          pig += zigzag_decode_plain(ei);
          prl += zigzag_decode_plain(er);
          c.segments[m] = {(uint32_t)pg, (uint32_t)pig, eo != 0,
                           (uint32_t)prl};
        }
      }
      s.contigs_loaded = s.details_loaded = true;
    }
    return true;  // trailing cmd lines not needed by the C API surface
  }

  // legacy 2.x collection: "collection-main" + per-batch
  // "collection-details" (4 concatenated field-major substreams;
  // reference: collection_v2.cpp)
  bool load_collection_v2() {
    std::vector<uint8_t> main;
    if (!load_batch_zstd_part("collection-main", 0, main)) return false;
    size_t pos = 0;
    uint64_t batch_size = 0, n_samples = 0;
    if (!dec_prefix_varint(main.data(), main.size(), pos, batch_size) ||
        !dec_prefix_varint(main.data(), main.size(), pos, n_samples))
      return false;
    if (!batch_size) batch_size = 1;
    samples_.resize(n_samples);
    for (uint64_t i = 0; i < n_samples; ++i) {
      Sample& s = samples_[i];
      if (!read_cstr(main, pos, s.name)) return false;
      sample_ids_[s.name] = i;
      uint64_t n_contigs = 0;
      if (!dec_prefix_varint(main.data(), main.size(), pos, n_contigs))
        return false;
      s.contigs.assign(n_contigs, Contig{});
      for (uint64_t j = 0; j < n_contigs; ++j) {
        Contig& c = s.contigs[j];
        if (!read_cstr(main, pos, c.name)) return false;
        uint64_t n_seg = 0;
        if (!dec_prefix_varint(main.data(), main.size(), pos, n_seg))
          return false;
        c.segments.resize(n_seg);
      }
      s.contigs_loaded = true;
    }
    uint64_t batch_id = 0;
    for (uint64_t base = 0; base < n_samples; base += batch_size, ++batch_id) {
      std::vector<uint8_t> det;
      if (!load_batch_zstd_part("collection-details", batch_id, det))
        return false;
      uint64_t hi = std::min(base + batch_size, n_samples);
      size_t dpos = 0;
      for (int field = 0; field < 4; ++field) {
        for (uint64_t i = base; i < hi; ++i) {
          for (auto& c : samples_[i].contigs) {
            int64_t prev = 0;
            for (auto& seg : c.segments) {
              uint64_t v = 0;
              if (!dec_prefix_varint(det.data(), det.size(), dpos, v))
                return false;
              switch (field) {
                case 0: seg.group_id = (uint32_t)(prev =
                            zigzag_decode_pred(v, prev)); break;
                case 1: seg.in_group_id = (uint32_t)(prev =
                            zigzag_decode_pred(v, prev)); break;
                case 2: seg.raw_length = (uint32_t)(prev =
                            zigzag_decode_pred(v, prev)); break;
                default: seg.is_rev_comp = v != 0;
              }
            }
          }
        }
      }
      for (uint64_t i = base; i < hi; ++i)
        samples_[i].details_loaded = true;
    }
    return true;
  }

  bool load_sample_names() {
    std::vector<uint8_t> part;
    uint64_t raw_size = 0;
    if (!arch_.get_part("collection-samples", 0, part, raw_size)) return false;
    std::vector<uint8_t> data;
    if (raw_size) {
      if (!zstd_decompress_tolerant(part.data(), part.size(), raw_size, data))
        return false;
    } else {
      data = part;
    }
    size_t pos = 0;
    uint64_t n_samples = 0;
    if (!dec_prefix_varint(data.data(), data.size(), pos, n_samples))
      return false;
    samples_.resize(n_samples);
    for (uint64_t i = 0; i < n_samples; ++i) {
      const void* nul = memchr(data.data() + pos, 0, data.size() - pos);
      if (!nul) return false;
      samples_[i].name.assign((const char*)data.data() + pos);
      pos = (const uint8_t*)nul - data.data() + 1;
      sample_ids_[samples_[i].name] = i;
    }
    return true;
  }

  // batch loads --------------------------------------------------------

  bool load_batch_zstd_part(const char* stream, size_t batch_id,
                            std::vector<uint8_t>& data) {
    std::vector<uint8_t> part;
    uint64_t raw_size = 0;
    if (!arch_.get_part(stream, batch_id, part, raw_size)) return false;
    if (raw_size)
      return zstd_decompress_tolerant(part.data(), part.size(), raw_size, data);
    data = std::move(part);
    return true;
  }

  // tokenized delta name decode (collection_v3.cpp:369-465)
  static std::vector<std::string> split_tokens(const std::string& s) {
    std::vector<std::string> out;
    size_t start = 0;
    while (true) {
      size_t sp = s.find(' ', start);
      if (sp == std::string::npos) { out.push_back(s.substr(start)); break; }
      out.push_back(s.substr(start, sp - start));
      start = sp + 1;
    }
    return out;
  }

  bool load_batch_names(size_t batch_id) {
    std::vector<uint8_t> data;
    if (!load_batch_zstd_part("collection-contigs", batch_id, data))
      return false;
    size_t pos = 0;
    uint64_t n_in_batch = 0;
    if (!dec_prefix_varint(data.data(), data.size(), pos, n_in_batch))
      return false;
    size_t base = batch_id * pack_cardinality_;
    // archive-supplied count: never index past the real sample table
    if (base >= samples_.size() || n_in_batch > samples_.size() - base)
      return false;
    for (uint64_t i = 0; i < n_in_batch; ++i) {
      uint64_t n_contigs = 0;
      if (!dec_prefix_varint(data.data(), data.size(), pos, n_contigs))
        return false;
      Sample& sample = samples_[base + i];
      if (n_contigs > data.size()) return false;  // each name needs >=1 byte
      sample.contigs.assign(n_contigs, Contig{});
      std::vector<std::string> prev_split;
      for (uint64_t j = 0; j < n_contigs; ++j) {
        const void* nul = memchr(data.data() + pos, 0, data.size() - pos);
        if (!nul) return false;
        std::string enc((const char*)data.data() + pos);
        pos = (const uint8_t*)nul - data.data() + 1;
        std::vector<std::string> curr_split = split_tokens(enc);
        std::string name;
        if (curr_split.size() != prev_split.size()) {
          name = enc;
          prev_split = std::move(curr_split);
        } else {
          // decode each token against the previous contig's token
          std::vector<std::string> out_tokens;
          for (size_t t = 0; t < curr_split.size(); ++t) {
            const std::string& p_tok = prev_split[t];
            const std::string& c_tok = curr_split[t];
            std::string dec;
            if (c_tok.size() == 1 && (uint8_t)c_tok[0] == 0x81) {
              dec = p_tok;  // SAME_COMPONENT_MARKER
            } else {
              size_t p_pos = 0;
              for (uint8_t ch : c_tok) {
                if (ch < 0x80) {
                  dec.push_back((char)ch);
                  p_pos += 1;
                } else {
                  size_t n = 256 - ch;
                  dec.append(p_tok, p_pos, n);
                  p_pos += n;
                }
              }
            }
            out_tokens.push_back(dec);
            if (t) name.push_back(' ');
            name += dec;
          }
          prev_split = std::move(out_tokens);
        }
        sample.contigs[j].name = std::move(name);
      }
      sample.contigs_loaded = true;
    }
    return true;
  }

  bool load_batch_details(size_t batch_id) {
    std::vector<uint8_t> part;
    uint64_t meta = 0;
    if (!arch_.get_part("collection-details", batch_id, part, meta))
      return false;
    size_t pos = 0;
    uint64_t sizes[5][2];
    for (int i = 0; i < 5; ++i) {
      if (!dec_prefix_varint(part.data(), part.size(), pos, sizes[i][0]))
        return false;
      if (!dec_prefix_varint(part.data(), part.size(), pos, sizes[i][1]))
        return false;
    }
    std::vector<uint8_t> v_data[5];
    for (int i = 0; i < 5; ++i) {
      if (pos + sizes[i][1] > part.size()) return false;
      if (!zstd_decompress_tolerant(part.data() + pos, sizes[i][1],
                                    sizes[i][0], v_data[i]))
        return false;
      pos += sizes[i][1];
    }
    size_t base = batch_id * pack_cardinality_;
    if (!samples_[base].contigs_loaded && !load_batch_names(batch_id))
      return false;
    // counts substream
    size_t p0 = 0;
    uint64_t n_in_batch = 0;
    auto& d0 = v_data[0];
    if (!dec_prefix_varint(d0.data(), d0.size(), p0, n_in_batch)) return false;
    std::vector<std::vector<uint64_t>> seg_counts(n_in_batch);
    for (uint64_t i = 0; i < n_in_batch; ++i) {
      uint64_t n_contigs = 0;
      if (!dec_prefix_varint(d0.data(), d0.size(), p0, n_contigs)) return false;
      if (n_contigs > d0.size()) return false;  // each count needs >=1 byte
      seg_counts[i].resize(n_contigs);
      for (uint64_t j = 0; j < n_contigs; ++j)
        if (!dec_prefix_varint(d0.data(), d0.size(), p0, seg_counts[i][j]))
          return false;
    }
    // archive-supplied counts: details must agree with the names part
    if (base >= samples_.size() || n_in_batch > samples_.size() - base)
      return false;
    size_t p[4] = {0, 0, 0, 0};
    std::unordered_map<uint32_t, int64_t> in_group_state;
    int64_t pred_raw_length = (int64_t)segment_size_ + kmer_length_;
    for (uint64_t i = 0; i < n_in_batch; ++i) {
      Sample& sample = samples_[base + i];
      if (seg_counts[i].size() > sample.contigs.size()) return false;
      for (size_t j = 0; j < seg_counts[i].size(); ++j) {
        Contig& ctg = sample.contigs[j];
        ctg.segments.resize(seg_counts[i][j]);
        for (auto& seg : ctg.segments) {
          uint64_t group_id = 0, e_in_group = 0, e_raw_len = 0, is_rc = 0;
          if (!dec_prefix_varint(v_data[1].data(), v_data[1].size(), p[0],
                                 group_id)) return false;
          if (!dec_prefix_varint(v_data[2].data(), v_data[2].size(), p[1],
                                 e_in_group)) return false;
          if (!dec_prefix_varint(v_data[3].data(), v_data[3].size(), p[2],
                                 e_raw_len)) return false;
          if (!dec_prefix_varint(v_data[4].data(), v_data[4].size(), p[3],
                                 is_rc)) return false;
          auto it = in_group_state.find((uint32_t)group_id);
          int64_t prev = it == in_group_state.end() ? -1 : it->second;
          int64_t in_group;
          if (prev == -1) in_group = (int64_t)e_in_group;
          else if (e_in_group == 0) in_group = 0;
          else if (e_in_group == 1) in_group = prev + 1;
          else in_group = zigzag_decode_pred(e_in_group - 1, prev + 1);
          seg.group_id = (uint32_t)group_id;
          seg.in_group_id = (uint32_t)in_group;
          seg.raw_length =
              (uint32_t)zigzag_decode_pred(e_raw_len, pred_raw_length);
          seg.is_rev_comp = is_rc != 0;
          if (in_group > prev && in_group > 0)
            in_group_state[(uint32_t)group_id] = in_group;
        }
      }
      sample.details_loaded = true;
    }
    return true;
  }

  bool ensure_names(int sid) {
    Sample& s = samples_[sid];
    if (s.contigs_loaded) return true;
    return load_batch_names(sid / pack_cardinality_);
  }

  bool ensure_details(int sid) {
    if (!ensure_names(sid)) return false;
    Sample& s = samples_[sid];
    if (s.details_loaded) return true;
    return load_batch_details(sid / pack_cardinality_);
  }

  // segment decode (agc_tpu_torch/core/segment.py; reference: segment.cpp)

  struct SegGroup {
    std::vector<uint8_t> ref;
    bool ref_loaded = false;
    std::map<size_t, std::vector<std::pair<size_t, size_t>>> pack_index;
    std::map<size_t, std::vector<uint8_t>> pack_data;
  };

  // version-aware segment stream names (reference: utils.cpp ss_*;
  // v3: "x<b64>r"/"x<b64>d", v1/v2: "seg-<n>-ref"/"seg-<n>-delta")
  std::string ref_stream(uint32_t gid) const {
    if (archive_version_ < 3000)
      return "seg-" + std::to_string(gid) + "-ref";
    return "x" + int_to_base64(gid) + "r";
  }
  std::string delta_stream(uint32_t gid) const {
    if (archive_version_ < 3000)
      return "seg-" + std::to_string(gid) + "-delta";
    return "x" + int_to_base64(gid) + "d";
  }

  bool load_pack(const std::string& delta_name, size_t part_id, SegGroup& g) {
    if (g.pack_data.count(part_id)) return true;
    std::vector<uint8_t> part;
    uint64_t raw_size = 0;
    if (!arch_.get_part(delta_name, part_id, part, raw_size)) return false;
    std::vector<uint8_t> pack;
    if (raw_size) {
      if (!zstd_decompress_tolerant(part.data(), part.size(), raw_size, pack))
        return false;
    } else {
      pack = std::move(part);
    }
    // split at 0xFF separators
    std::vector<std::pair<size_t, size_t>> idx;
    size_t start = 0;
    for (size_t i = 0; i < pack.size(); ++i) {
      if (pack[i] == 0xFF) {
        idx.emplace_back(start, i - start);
        start = i + 1;
      }
    }
    if (g.pack_data.size() >= 2) {  // small LRU, like the Python reader
      g.pack_data.erase(g.pack_data.begin());
      g.pack_index.erase(g.pack_index.begin());
    }
    g.pack_index[part_id] = std::move(idx);
    g.pack_data[part_id] = std::move(pack);
    return true;
  }

  bool decompress_segment(uint32_t group_id, uint32_t in_group_id,
                          std::vector<uint8_t>& out) {
    std::lock_guard<std::mutex> lk(seg_mtx_);
    SegGroup& g = groups_[group_id];
    const std::string d_name = delta_stream(group_id);
    const uint32_t NO_RAW_GROUPS = 16;  // reference: agc_basic.h:81
    if (group_id < NO_RAW_GROUPS) {
      size_t part_id = in_group_id / pack_cardinality_;
      size_t idx = in_group_id % pack_cardinality_;
      if (!load_pack(d_name, part_id, g)) return false;
      auto& index = g.pack_index[part_id];
      if (idx >= index.size()) return false;
      auto [off, len] = index[idx];
      auto& pd = g.pack_data[part_id];
      out.assign(pd.begin() + off, pd.begin() + off + len);
      return true;
    }
    if (!g.ref_loaded) {
      std::vector<uint8_t> part;
      uint64_t raw_size = 0;
      if (!arch_.get_part(ref_stream(group_id), 0, part, raw_size)) return false;
      if (raw_size == 0) {
        g.ref = std::move(part);
      } else {
        std::vector<uint8_t> payload;
        if (part.empty()) return false;
        if (!zstd_decompress_tolerant(part.data(), part.size() - 1, raw_size,
                                      payload))
          return false;
        if (part.back() == 1) {
          if (!tuples2bytes(payload, g.ref)) return false;
        } else {
          g.ref = std::move(payload);
        }
      }
      g.ref_loaded = true;
    }
    if (in_group_id == 0) {
      out = g.ref;
      return true;
    }
    size_t part_id = (in_group_id - 1) / pack_cardinality_;
    size_t idx = (in_group_id - 1) % pack_cardinality_;
    if (!load_pack(d_name, part_id, g)) return false;
    auto& index = g.pack_index[part_id];
    if (idx >= index.size()) return false;
    auto [off, len] = index[idx];
    auto& pd = g.pack_data[part_id];
    // decode LZ delta against the group reference
    out.resize(g.ref.size() * 2 + len * 4 + 4096);
    int64_t n;
    if (archive_version_ < 2000)
      n = lz_decode_v1(g.ref.data(), g.ref.size(), pd.data() + off, len,
                       min_match_len_, out.data(), out.size());
    else
      n = lz_decode_v2(g.ref.data(), g.ref.size(), pd.data() + off, len,
                       min_match_len_, out.data(), out.size());
    if (n < 0) {
      // -(needed): retry once with the exact size (very long N runs can
      // exceed the guess); INT64_MIN = corrupt, and a needed size past
      // the sanity ceiling is treated as corruption rather than an
      // attempted multi-GB allocation
      constexpr int64_t kMaxSegmentBytes = 4LL << 30;
      if (n == INT64_MIN || -n > kMaxSegmentBytes) return false;
      out.resize((size_t)(-n));
      if (archive_version_ < 2000)
        n = lz_decode_v1(g.ref.data(), g.ref.size(), pd.data() + off, len,
                         min_match_len_, out.data(), out.size());
      else
        n = lz_decode_v2(g.ref.data(), g.ref.size(), pd.data() + off, len,
                         min_match_len_, out.data(), out.size());
      if (n < 0) return false;
    }
    out.resize(n);
    return true;
  }

  Archive arch_;
  std::mutex mtx_;
  std::mutex seg_mtx_;
  int archive_version_ = 0;
  uint32_t kmer_length_ = 0, min_match_len_ = 0, pack_cardinality_ = 0,
           segment_size_ = 0;
  std::vector<Sample> samples_;
  std::unordered_map<std::string, size_t> sample_ids_;
  std::unordered_map<uint32_t, SegGroup> groups_;
};

}  // namespace agctpu

// ===========================================================================
// C ABI (reference: agc-api.h:119-203)
// ===========================================================================

extern "C" {

typedef struct agc_t agc_t;

agc_t* agc_open(char* fn, int prefetching) {
  // try/catch at every ABI entry: a corrupt archive can make a resize
  // throw (length_error/bad_alloc); crossing the C boundary with an
  // exception would std::terminate the caller instead of returning an
  // error value
  try {
    auto* f = new agctpu::AgcFile();
    if (!f->open(fn, prefetching != 0)) {
      delete f;
      return nullptr;
    }
    return reinterpret_cast<agc_t*>(f);
  } catch (...) {
    return nullptr;
  }
}

int agc_close(agc_t* agc) {
  if (!agc) return -1;
  delete reinterpret_cast<agctpu::AgcFile*>(agc);
  return 0;
}

int agc_n_sample(const agc_t* agc) {
  if (!agc) return -1;
  return reinterpret_cast<const agctpu::AgcFile*>(agc)->n_sample();
}

int agc_n_ctg(const agc_t* agc, const char* sample) {
  if (!agc || !sample) return -1;
  try {
    return const_cast<agctpu::AgcFile*>(
               reinterpret_cast<const agctpu::AgcFile*>(agc))
        ->n_ctg(sample);
  } catch (...) {
    return -1;
  }
}

int agc_get_ctg_len(const agc_t* agc, const char* sample, const char* name) {
  if (!agc || !name) return -1;
  try {
    auto* f = const_cast<agctpu::AgcFile*>(
        reinterpret_cast<const agctpu::AgcFile*>(agc));
    const agctpu::Contig* c = f->find_contig(sample ? sample : "", name);
    if (!c) return -1;
    return (int)f->contig_length(*c);
  } catch (...) {
    return -1;
  }
}

int agc_get_ctg_seq(const agc_t* agc, const char* sample, const char* name,
                    int start, int end, char* buf) {
  if (!agc || !name || !buf) return -1;
  try {
  auto* f = const_cast<agctpu::AgcFile*>(
      reinterpret_cast<const agctpu::AgcFile*>(agc));
  const agctpu::Contig* c = f->find_contig(sample ? sample : "", name);
  if (!c) return -1;
  std::vector<uint8_t> numeric;
  if (!f->decompress_contig(*c, start, end, numeric)) return -1;
  for (size_t i = 0; i < numeric.size(); ++i) {
    uint8_t x = numeric[i];
    buf[i] = x < 16 ? agctpu::CNV_NUM_TAB[x] : ' ';
  }
  buf[numeric.size()] = '\0';
  return (int)numeric.size();
  } catch (...) {
    return -1;
  }
}

char* agc_reference_sample(const agc_t* agc) {
  if (!agc) return nullptr;
  try {
  std::string s =
      reinterpret_cast<const agctpu::AgcFile*>(agc)->reference_sample();
  char* out = (char*)malloc(s.size() + 1);
  std::memcpy(out, s.c_str(), s.size() + 1);
  return out;
  } catch (...) {
    return nullptr;
  }
}

char** agc_list_sample(const agc_t* agc, int* n_sample) {
  if (!agc || !n_sample) return nullptr;
  try {
  auto v = reinterpret_cast<const agctpu::AgcFile*>(agc)->list_samples();
  char** out = (char**)malloc((v.size() + 1) * sizeof(char*));
  for (size_t i = 0; i < v.size(); ++i) {
    out[i] = (char*)malloc(v[i].size() + 1);
    std::memcpy(out[i], v[i].c_str(), v[i].size() + 1);
  }
  out[v.size()] = nullptr;
  *n_sample = (int)v.size();
  return out;
  } catch (...) {
    return nullptr;
  }
}

char** agc_list_ctg(const agc_t* agc, const char* sample, int* n_ctg) {
  if (!agc || !sample || !n_ctg) return nullptr;
  try {
  auto* f = const_cast<agctpu::AgcFile*>(
      reinterpret_cast<const agctpu::AgcFile*>(agc));
  std::vector<std::string> v;
  if (!f->list_ctg(sample, v)) return nullptr;
  char** out = (char**)malloc((v.size() + 1) * sizeof(char*));
  for (size_t i = 0; i < v.size(); ++i) {
    out[i] = (char*)malloc(v[i].size() + 1);
    std::memcpy(out[i], v[i].c_str(), v[i].size() + 1);
  }
  out[v.size()] = nullptr;
  *n_ctg = (int)v.size();
  return out;
  } catch (...) {
    return nullptr;
  }
}

int agc_list_destroy(char** list) {
  if (!list) return -1;
  for (char** p = list; *p; ++p) free(*p);
  free(list);
  return 0;
}

int agc_string_destroy(char* sample) {
  free(sample);
  return 0;
}

}  // extern "C"
