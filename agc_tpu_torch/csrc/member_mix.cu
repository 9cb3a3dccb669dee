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
// What bounds it on the H100: not bytes (4 bytes in and 1 out per mix)
// but the dependent probes of a binary search, log2(T) per mix, so the
// TPU's compare-all loop over T entries is not carried over. Where the
// table fits a block's dynamic shared memory (T * 4 bytes <= 227 KB, set
// with cudaFuncSetAttribute) every block loads it once and walks a
// grid-stride loop over the mixes, so the load is amortised over
// N / (blocks) mixes. Larger tables (a whole human assembly gives about
// 131,072 entries = 512 KB) are searched in device memory, where the
// 50 MB L2 holds them after the first probes.
#include "kmer_common.cuh"

namespace agc {
namespace {

constexpr int kMixThreads = 1024;
constexpr int kMaxSharedTable = 232448 / 4;  // 227 KB of u32

template <bool kShared>
__global__ void member_mix_kernel(const uint32_t* __restrict__ mix, int64_t n,
                                  const uint32_t* __restrict__ table, int T,
                                  uint8_t* __restrict__ out) {
  extern __shared__ uint32_t s_tab[];
  const uint32_t* tab = table;
  if (kShared) {
    for (int i = threadIdx.x; i < T; i += blockDim.x) s_tab[i] = table[i];
    __syncthreads();
    tab = s_tab;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = in_sorted_u32(tab, T, mix[i]) ? 1 : 0;
  }
}

template <bool kShared>
int launch(const uint32_t* mix, int64_t n, const uint32_t* table, int T,
           uint8_t* out, cudaStream_t st) {
  const size_t smem = kShared ? static_cast<size_t>(T) * sizeof(uint32_t) : 0;
  cudaError_t err = cudaSuccess;
  if (kShared) {
    err = cudaFuncSetAttribute(member_mix_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, member_mix_kernel<kShared>, kMixThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) per_sm = 1;
  const int64_t need = (n + kMixThreads - 1) / kMixThreads;
  const int64_t full = static_cast<int64_t>(sms) * per_sm;
  const unsigned blocks = static_cast<unsigned>(need < full ? need : full);
  member_mix_kernel<kShared><<<blocks, kMixThreads, smem, st>>>(mix, n, table,
                                                               T, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace agc

// mix: u32[n]; table: u32[T] sorted by unsigned value; out: u8[n] (0/1).
// The table goes to shared memory when it fits (T <= 58112, see
// agc_member_mix_shared_max), else it is searched in device memory.
extern "C" int agc_member_mix_shared_max() { return agc::kMaxSharedTable; }

extern "C" int agc_member_mix(const uint32_t* mix, int64_t n,
                              const uint32_t* table, int T, uint8_t* out,
                              void* stream) {
  using namespace agc;
  if (n <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= kMaxSharedTable) return launch<true>(mix, n, table, T, out, st);
  return launch<false>(mix, n, table, T, out, st);
}
