// Hopper kernels for ULEEN's Bloom-filter scoring: packed_wnn and fused_wnn.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/packed_wnn.py::packed_wnn   (body packed_wnn_kernel)
//   repro/kernels/fused_wnn.py::fused_wnn     (body fused_wnn_kernel)
// Both compute, for each batch row b and class m,
//   scores[b, m] = bias[m] + sum_f (mask[m, f] != 0) * AND_j bit(m, f, h_j(b, f))
// where h_j is the H3 hash of tuple (b, f) (XOR of the params row j entries
// selected by the tuple's set bits) and bit() reads entry h of filter (m, f):
//   packed: bit (h & 31) of the uint32 word words[m, f, h >> 5];
//   fused:  table[m, f, h] != 0 on the int8 (M, N_f, E) table.
//
// The TPU kernels turn the lookup into a one-hot MXU contraction because
// gathers are slow there. On Hopper the lookup is a direct load: the tables
// of a whole ULN-L ensemble (373 KiB packed) stay in L2 and mostly in L1.
//
// What bounds it: the (B, N_f, n) int8 tuples are the one large input, read
// once (bytes / 3.35 TB/s), but the integer work on them (hash folds,
// per-class lookups and votes) at Hopper's int32 issue rate, half its fp32
// lane rate, is the higher floor. As written it runs several times above
// that floor; PERF.md keeps its times beside the bound.
// Design: one warp per batch row, one lane per filter. A lane reads its
// tuple (as 32-bit words when n % 4 == 0), computes its k hashes once with
// the (k, n) params in shared memory, then walks the classes. The class
// count is a warp vote: the popcount of the ballot of the lanes' responses,
// kept in the register of lane m, so no atomics and no shared-memory
// reduction. Classes come in groups of 32 (one per lane). int32 sums are
// exact in any order, so the scores are bit-equal to the plain versions.
// A hash at or past E (only from malformed params) reads nothing and
// answers 0, as the TPU kernels' one-hot does.
#include <cuda_runtime.h>

#include <cstdint>

#include "h3.cuh"

namespace {

constexpr int kMaxHashes = 8;       // kernels/launch.py MAX_HASHES
constexpr int kMaxTupleBits = 64;   // kernels/launch.py MAX_TUPLE_BITS
constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

// A lookup policy names the table's element type, its elements per filter
// and how entry h of one filter is tested. The kernel checks h < entries
// once per hash, so bit() never reads out of range.
struct PackedLookup {
  using Elem = uint32_t;
  const uint32_t* __restrict__ table;  // (M, N_f, W) bitplanes
  int per_filter;                      // W
  int entries;                         // 32 * W
  __device__ __forceinline__ uint32_t bit(const uint32_t* filter,
                                          int32_t h) const {
    return (__ldg(filter + (h >> 5)) >> (h & 31)) & 1u;
  }
};

struct ByteLookup {
  using Elem = int8_t;
  const int8_t* __restrict__ table;    // (M, N_f, E) {0,1}
  int per_filter;                      // E
  int entries;                         // E
  __device__ __forceinline__ uint32_t bit(const int8_t* filter,
                                          int32_t h) const {
    return __ldg(filter + h) != 0;
  }
};

// K, the number of hashes, is a template argument: the hash and lookup
// loops then unroll to exactly K steps (a runtime k unrolled to the bound
// of 8 executes the predicated-off steps too, and the kernel is
// instruction-bound).
template <int K, class Lookup>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
wnn_kernel(const int8_t* __restrict__ tuples, const int32_t* __restrict__ params,
           Lookup lookup, const int8_t* __restrict__ mask,
           const int32_t* __restrict__ bias, int32_t* __restrict__ out,
           int batch, int num_filters, int n, int m) {
  using Elem = typename Lookup::Elem;
  __shared__ int32_t s_params[kMaxHashes * kMaxTupleBits];
  for (int i = threadIdx.x; i < K * n; i += blockDim.x) s_params[i] = params[i];
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const bool by_word = (n & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(tuples) & 3) == 0;
  const size_t class_stride = static_cast<size_t>(num_filters) * lookup.per_filter;
  // The row loop is uniform across a warp, so every ballot below runs
  // with all 32 lanes.
  for (int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5); row < batch;
       row += gridDim.x * kWarpsPerBlock) {
    const int8_t* trow = tuples + static_cast<size_t>(row) * num_filters * n;
    for (int c0 = 0; c0 < m; c0 += 32) {
      const int classes = min(32, m - c0);
      int32_t count = 0;  // lane c holds class c0 + c
      for (int f0 = 0; f0 < num_filters; f0 += 32) {
        const int f = f0 + lane;
        bool live = f < num_filters;
        int32_t h[K];
#pragma unroll
        for (int j = 0; j < K; ++j) h[j] = 0;
        if (live) {
          h3_tuple<K>(h, trow + static_cast<size_t>(f) * n, s_params, n, by_word);
#pragma unroll
          for (int j = 0; j < K; ++j)
            live &= static_cast<uint32_t>(h[j]) < static_cast<uint32_t>(lookup.entries);
        }
        // walk the classes with pointers: the hashes' word offsets and bit
        // positions are the same for every class
        const int8_t* mptr = mask + static_cast<size_t>(c0) * num_filters + f;
        const Elem* fptr = lookup.table +
            (static_cast<size_t>(c0) * num_filters + f) * lookup.per_filter;
        for (int c = 0; c < classes; ++c, mptr += num_filters, fptr += class_stride) {
          uint32_t resp = live && __ldg(mptr) != 0;
#pragma unroll
          for (int j = 0; j < K; ++j)
            if (resp) resp = lookup.bit(fptr, h[j]);
          const int votes = __popc(__ballot_sync(kFullMask, resp));
          if (lane == c) count += votes;
        }
      }
      if (lane < classes)
        out[static_cast<size_t>(row) * m + c0 + lane] = count + bias[c0 + lane];
    }
  }
}

int check_geometry(int batch, int n, int k, int m) {
  if (batch < 1 || n < 1 || n > kMaxTupleBits || k < 1 || k > kMaxHashes || m < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <int K, class Lookup>
void launch_k(const void* tuples, const void* params, Lookup lookup,
              const void* mask, const void* bias, void* out, int batch,
              int num_filters, int n, int m, cudaStream_t stream) {
  const int blocks = (batch + kWarpsPerBlock - 1) / kWarpsPerBlock;
  wnn_kernel<K, Lookup><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const int8_t*>(tuples), static_cast<const int32_t*>(params),
      lookup, static_cast<const int8_t*>(mask),
      static_cast<const int32_t*>(bias), static_cast<int32_t*>(out), batch,
      num_filters, n, m);
}

template <class Lookup>
int launch(const void* tuples, const void* params, Lookup lookup,
           const void* mask, const void* bias, void* out, int batch,
           int num_filters, int n, int k, int m, void* stream_ptr) {
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WNN_LAUNCH_K(K)                                                     \
  case K:                                                                   \
    launch_k<K>(tuples, params, lookup, mask, bias, out, batch, num_filters, \
                n, m, stream);                                              \
    break;
  switch (k) {
    WNN_LAUNCH_K(1) WNN_LAUNCH_K(2) WNN_LAUNCH_K(3) WNN_LAUNCH_K(4)
    WNN_LAUNCH_K(5) WNN_LAUNCH_K(6) WNN_LAUNCH_K(7) WNN_LAUNCH_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WNN_LAUNCH_K
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points (bound with ctypes). Each returns the CUDA error of
// its launch, 0 when the kernel was queued on `stream`.
extern "C" int packed_wnn_launch(const void* tuples, const void* params,
                                 const void* words, const void* mask,
                                 const void* bias, void* out, int batch,
                                 int num_filters, int n, int k, int m,
                                 int words_per_filter, int entries,
                                 void* stream) {
  if (int rc = check_geometry(batch, n, k, m)) return rc;
  PackedLookup lookup{static_cast<const uint32_t*>(words), words_per_filter,
                      entries};
  return launch(tuples, params, lookup, mask, bias, out, batch, num_filters,
                n, k, m, stream);
}

extern "C" int fused_wnn_launch(const void* tuples, const void* params,
                                const void* table, const void* mask,
                                const void* bias, void* out, int batch,
                                int num_filters, int n, int k, int m,
                                int entries, void* stream) {
  if (int rc = check_geometry(batch, n, k, m)) return rc;
  ByteLookup lookup{static_cast<const int8_t*>(table), entries, entries};
  return launch(tuples, params, lookup, mask, bias, out, batch, num_filters,
                n, k, m, stream);
}
