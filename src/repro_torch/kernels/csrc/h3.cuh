// H3 hashing on the device for the hash-precompute kernel (h3_hash.cu).
// (The WNN scoring kernel, wnn.cu, folds the hash into its permutation
// gather itself, eight rows per gathered index.)
//
// A tuple is n int8 {0,1} bytes; hash j of a tuple is the XOR of the
// parameter words params[j * n + i] over the set bits i. K, the number of
// hashes computed in one pass, is a template argument, so the loops over
// the hashes unroll to exactly K steps.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// Fold input bit i of a tuple into its K H3 hashes (branch-free select).
template <int K>
__device__ __forceinline__ void h3_fold(int32_t (&h)[K], const int32_t* params,
                                        int n, int i, bool set) {
  const int32_t sel = -static_cast<int32_t>(set);
#pragma unroll
  for (int j = 0; j < K; ++j) h[j] ^= params[j * n + i] & sel;
}

// XOR the K hashes of the n-bit tuple at `t` into h (the caller zeroes h).
// With `by_word` (n % 4 == 0 and `t` 4-byte aligned) the tuple is read as
// 32-bit words, four bits per load.
template <int K>
__device__ __forceinline__ void h3_tuple(int32_t (&h)[K], const int8_t* t,
                                         const int32_t* params, int n,
                                         bool by_word) {
  if (by_word) {
    const uint32_t* t4 = reinterpret_cast<const uint32_t*>(t);
    for (int q = 0; q < (n >> 2); ++q) {
      const uint32_t v = __ldg(t4 + q);
#pragma unroll
      for (int b = 0; b < 4; ++b)
        h3_fold<K>(h, params, n, 4 * q + b, ((v >> (8 * b)) & 0xffu) != 0);
    }
  } else {
    for (int i = 0; i < n; ++i) h3_fold<K>(h, params, n, i, __ldg(t + i) != 0);
  }
}
