// Hopper kernels for ULEEN's input front end: thermometer encode and
// bus decompression.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/thermometer.py::thermometer_encode     (body thermometer_kernel)
//   repro/kernels/thermometer.py::thermometer_decompress (body decompress_kernel)
//   encode:     bits[b, f, t] = x[b, f] > thresholds[f, t]   (NaN gives 0)
//   decompress: bits[b, f, t] = t < counts[b, f]             (paper Fig. 8)
//
// What bounds them: bytes. Each reads one value per (b, f) and writes T
// int8 bits, with no reuse but the (F, T) thresholds, which stay in cache.
// As written they reach about a quarter of the bytes bound (PERF.md): each
// thread stores its T bits one byte at a time.
// Design:one thread per (b, f) in a grid-stride loop, writing its T bits;
// neighbouring threads write neighbouring T-byte groups. The TPU version
// pads F with +inf thresholds to its block; here a bound check on the flat
// (b, f) index takes its place.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 64;  // 64 blocks per H100 SM

int blocks_for(int64_t total) {
  const int64_t want = (total + kThreads - 1) / kThreads;
  return static_cast<int>(want < kMaxBlocks ? want : kMaxBlocks);
}

__global__ void __launch_bounds__(kThreads)
thermometer_kernel(const float* __restrict__ x,
                   const float* __restrict__ thresholds,
                   int8_t* __restrict__ out, int64_t total, int features,
                   int bits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const float v = x[i];
    const float* t = thresholds + (i % features) * bits;
    int8_t* o = out + i * bits;
    for (int j = 0; j < bits; ++j) o[j] = v > __ldg(t + j);
  }
}

__global__ void __launch_bounds__(kThreads)
decompress_kernel(const uint8_t* __restrict__ counts, int8_t* __restrict__ out,
                  int64_t total, int bits) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int c = counts[i];
    int8_t* o = out + i * bits;
    for (int j = 0; j < bits; ++j) o[j] = j < c;
  }
}

}  // namespace

// Plain C entry points (bound with ctypes). `total` is B * F. Each returns
// the CUDA error of its launch, 0 when the kernel was queued on `stream`.
extern "C" int thermometer_encode_launch(const void* x, const void* thresholds,
                                         void* out, long long total,
                                         int features, int bits, void* stream) {
  if (total < 1 || features < 1 || bits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  thermometer_kernel<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(thresholds),
      static_cast<int8_t*>(out), total, features, bits);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int thermometer_decompress_launch(const void* counts, void* out,
                                             long long total, int bits,
                                             void* stream) {
  if (total < 1 || bits < 1) return static_cast<int>(cudaErrorInvalidValue);
  decompress_kernel<<<blocks_for(total), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(counts), static_cast<int8_t*>(out), total,
      bits);
  return static_cast<int>(cudaGetLastError());
}
