// Hopper kernel for ULEEN's training-side hash precompute: h3_hash.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/h3_hash.py::h3_hash_tiled   (body h3_hash_kernel)
// which computes, for each tuple (b, f) of a (B, N_f, n) int8 {0,1} batch and
// each row j of the (k, n) int32 H3 parameters,
//   hashes[b, f, j] = XOR over the set bits i of tuples[b, f, :] of params[j, i].
//
// The TPU kernel tiles (batch x filters) into VMEM and pads both axes to its
// block sizes. Here nothing is padded: one thread per (b, f) tuple, a
// grid-stride loop over exactly B * N_f tuples, and the (k, n) parameters in
// shared memory, or read from global memory through the caches when k * n
// words do not fit in the 48 KB a block gets without opting in.
//
// What bounds it: each tuple is read once (n bytes) and its k hashes written
// once (4k bytes); the work is 2·n·k integer operations per tuple (select and
// XOR). At ULEEN's k = 2 the bytes are the higher floor at every ULN-L
// geometry (n = 12..32), so the design reads a tuple as 32-bit words where
// n % 4 == 0 and keeps the parameters on chip. It is not tuned further:
// PERF.md keeps its time beside the bound.
//
// k up to 8 is a template argument (one pass, hashes in registers, loops
// unrolled to exactly k steps, as in wnn.cu). A larger k runs the one-hash
// instantiation in k passes over the tuple. Neither bounds n.
#include <cuda_runtime.h>

#include <cstdint>

#include "h3.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 32;                 // grid-stride beyond this
constexpr size_t kSharedParamsBytes = 48 * 1024;

// K hashes per pass; K == k (one pass) or K == 1 (k passes).
template <int K>
__global__ void __launch_bounds__(kThreads)
h3_hash_kernel(const int8_t* __restrict__ tuples, const int32_t* __restrict__ params,
               int32_t* __restrict__ out, long long num_tuples, int n, int k,
               bool params_in_shared) {
  extern __shared__ int32_t s_params[];
  const int32_t* p = params;
  if (params_in_shared) {
    for (int i = threadIdx.x; i < k * n; i += blockDim.x) s_params[i] = params[i];
    __syncthreads();
    p = s_params;
  }
  const bool by_word = (n & 3) == 0 &&
                       (reinterpret_cast<uintptr_t>(tuples) & 3) == 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       t < num_tuples; t += stride) {
    const int8_t* tuple = tuples + t * n;
    int32_t* o = out + t * k;
    for (int j0 = 0; j0 < k; j0 += K) {
      int32_t h[K];
#pragma unroll
      for (int j = 0; j < K; ++j) h[j] = 0;
      h3_tuple<K>(h, tuple, p + static_cast<size_t>(j0) * n, n, by_word);
#pragma unroll
      for (int j = 0; j < K; ++j) o[j0 + j] = h[j];
    }
  }
}

template <int K>
void launch_k(const void* tuples, const void* params, void* out,
              long long num_tuples, int n, int k, bool params_in_shared,
              size_t shared_bytes, cudaStream_t stream) {
  const long long blocks = (num_tuples + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
  h3_hash_kernel<K><<<grid, kThreads, shared_bytes, stream>>>(
      static_cast<const int8_t*>(tuples), static_cast<const int32_t*>(params),
      static_cast<int32_t*>(out), num_tuples, n, k, params_in_shared);
}

}  // namespace

// Plain C entry point (bound with ctypes). tuples (num_tuples, n) int8,
// params (k, n) int32, out (num_tuples, k) int32, all contiguous on the
// device of `stream`. Returns the CUDA error of the launch, 0 when the
// kernel was queued.
extern "C" int h3_hash_launch(const void* tuples, const void* params, void* out,
                              long long num_tuples, int n, int k, void* stream_ptr) {
  if (num_tuples < 1 || n < 1 || k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const size_t param_bytes = static_cast<size_t>(k) * n * sizeof(int32_t);
  const bool in_shared = param_bytes <= kSharedParamsBytes;
  const size_t shared_bytes = in_shared ? param_bytes : 0;
#define H3_LAUNCH_K(K)                                                        \
  case K:                                                                     \
    launch_k<K>(tuples, params, out, num_tuples, n, k, in_shared, shared_bytes, \
                stream);                                                      \
    break;
  switch (k) {
    H3_LAUNCH_K(1) H3_LAUNCH_K(2) H3_LAUNCH_K(3) H3_LAUNCH_K(4)
    H3_LAUNCH_K(5) H3_LAUNCH_K(6) H3_LAUNCH_K(7) H3_LAUNCH_K(8)
    default:
      launch_k<1>(tuples, params, out, num_tuples, n, k, in_shared,
                  shared_bytes, stream);
  }
#undef H3_LAUNCH_K
  return static_cast<int>(cudaGetLastError());
}
