// Hopper kernel for LM prefill attention: flash_attention.
//
// Replaces the Pallas TPU kernel
//   repro/kernels/flash_attention.py::flash_attention_tiled   (body _flash_kernel)
// together with the GQA head repetition of repro/kernels/ops.py::flash_attention.
// For each batch row b, query head h and query row i it computes
//   out[b, h, i] = softmax_j(scale * q[b, h, i] . k[b, h / G, j]) @ v[b, h / G]
// over the visible keys j: j < Sk; j <= i + q_offset when causal; and
// j > i + q_offset - window when window > 0 (rows and keys both counted from
// 0, the TPU kernel's top-left alignment). G = H / Hkv: query head h reads KV
// head h / G in place, so no repeated copy of K or V is made. Scores, the
// running (max m, denominator l, accumulator acc) and the output division
// acc / max(l, 1e-20) are float32 for float32 and bf16 inputs alike, as the
// TPU kernel upcasts; masked scores are -1e30, its NEG_INF. The output is
// cast to the inputs' type.
//
// Design: one block of 256 threads per (tile of 64 query rows, h, b). The
// query tile sits in shared memory as float32; a loop walks the key tiles of
// 64 that hold a visible key for some row of the block (key tiles wholly
// masked by the causal or window rule are never loaded, as pl.when skips
// them on the TPU), staging K and V in shared memory as float32. Per key
// tile: each thread computes a 4 x 4 block of the 64 x 64 scores, four
// threads take one row's running softmax with warp shuffles, and each thread
// rescales and accumulates a 4 x (D / 16) block of the 64 x D output in
// registers. D is a template argument (16, 32, 64, 128, 256). Shared rows of
// Q, K and the scores have an odd float stride, so the lanes of a warp that
// read different rows hit different banks. Above 48 KB of shared memory
// (D >= 64) the launch opts in with cudaFuncAttributeMaxDynamicSharedMemorySize.
//
// Strides: q, k, v and out are read and written through (batch, head, row)
// element strides with the head dimension contiguous, so the (B, S, H, D)
// projections of the model enter without a transposed copy and the output
// can be written in the layout the output projection reads.
//
// What bounds it: at prefill shapes the multiply-adds. Q·K^T and P·V are
// 2·Sq·Sk·D multiply-adds per head (halved by the causal mask), read once
// from device memory but many times from shared memory. This design runs
// them on the float32 CUDA cores, not the tensor cores, and its shared-memory
// loads (about one per two multiply-adds) are its limit before the FMA rate.
// It is the simple version: mma/wgmma on bf16 tiles, TMA staging and a
// pipelined key loop are the work of the PR that makes it fast. PERF.md keeps
// its time beside its bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;          // a 16 x 16 grid of threads
constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF

struct Strides {
  long long b, h, s;                   // elements; the head dim is contiguous
};

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f32(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int D>
struct Smem {
  static constexpr int kRowStride = D + 1;          // Q and K rows (odd)
  static constexpr int kScoreStride = kBlockK + 1;  // score rows (odd)
  static constexpr int q = kBlockQ * kRowStride;
  static constexpr int k = kBlockK * kRowStride;
  static constexpr int v = kBlockK * D;
  static constexpr int s = kBlockQ * kScoreStride;
  static constexpr size_t bytes =
      static_cast<size_t>(q + k + v + s + 3 * kBlockQ) * sizeof(float);
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int group,
                       int sq, int sk, Strides qs, Strides ks, Strides vs,
                       Strides os, float scale, bool causal, int window,
                       int q_offset) {
  using S = Smem<D>;
  constexpr int kCols = D / 16;        // output columns per thread
  extern __shared__ float smem[];
  float* q_s = smem;
  float* k_s = q_s + S::q;
  float* v_s = k_s + S::k;
  float* s_s = v_s + S::v;
  float* m_s = s_s + S::s;
  float* l_s = m_s + kBlockQ;
  float* a_s = l_s + kBlockQ;          // this tile's rescale factor per row

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + hk * ks.h;
  const T* vb = v + b * vs.b + hk * vs.h;
  T* ob = o + b * os.b + h * os.h;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const int row = q0 + r;
    q_s[r * S::kRowStride + d] = row < sq ? load_f32(qb + row * qs.s + d) : 0.f;
  }
  if (tid < kBlockQ) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }

  float acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;

  // Key range that holds a visible key for some real row of this block.
  const int first = q0 + q_offset;
  const int last = min(q0 + kBlockQ, sq) - 1 + q_offset;
  const int k_end = causal ? min(sk, last + 1) : sk;
  const int k_begin = window > 0 ? max(0, first - window + 1) : 0;

  for (int k0 = (k_begin / kBlockK) * kBlockK; k0 < k_end; k0 += kBlockK) {
    __syncthreads();                   // the previous tile is consumed
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      const int r = i / D, d = i % D;
      const int key = k0 + r;
      const bool in = key < sk;
      k_s[r * S::kRowStride + d] = in ? load_f32(kb + key * ks.s + d) : 0.f;
      v_s[i] = in ? load_f32(vb + key * vs.s + d) : 0.f;
    }
    __syncthreads();

    // scores of rows ty + 16 i against keys tx + 16 j
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = q_s[(ty + 16 * i) * S::kRowStride + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = k_s[(tx + 16 * j) * S::kRowStride + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      const int qi = q0 + r + q_offset;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kj = k0 + c;
        bool visible = kj < sk;
        if (causal) visible = visible && kj <= qi;
        if (window > 0) visible = visible && kj > qi - window;
        s_s[r * S::kScoreStride + c] = visible ? sc[i][j] * scale : kNegInf;
      }
    }
    __syncthreads();

    // running softmax: four lanes per row, 16 scores each
    {
      const int r = tid >> 2, part = tid & 3;
      float* row = s_s + r * S::kScoreStride + part * 16;
      float mx = kNegInf;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        // A row that has seen no visible key yet (m_new = -1e30) takes
        // exp(0) here, as the TPU kernel does; its first visible key then
        // rescales that by exp(-1e30 - m) = 0.
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (part == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P @ V for rows ty + 16 i, columns tx + 16 j
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float alpha = a_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kCols; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < kBlockK; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = s_s[(ty + 16 * i) * S::kScoreStride + c];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float vv = v_s[c * D + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(p[i], vv, acc[i][j]);
      }
    }
  }

  __syncthreads();                     // l_s is final (also when no tile ran)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    const int row = q0 + r;
    if (row >= sq) continue;
    const float denom = fmaxf(l_s[r], 1e-20f);
    T* out_row = ob + row * os.s;
#pragma unroll
    for (int j = 0; j < kCols; ++j) store_f32(out_row + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch_d(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int group, int sq, int sk, Strides qs, Strides ks,
             Strides vs, Strides os, float scale, bool causal, int window,
             int q_offset, cudaStream_t stream) {
  const size_t shared = Smem<D>::bytes;
  static bool opted_in = false;        // once per instantiation and process
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(shared));
    if (err != cudaSuccess) return static_cast<int>(err);
    opted_in = true;
  }
  const dim3 grid((sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_attention_kernel<T, D><<<grid, kThreads, shared, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), group, sq, sk, qs, ks, vs,
      os, scale, causal, window, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_t(const void* q, const void* k, const void* v, void* o, int batch,
             int heads, int group, int sq, int sk, int d, Strides qs,
             Strides ks, Strides vs, Strides os, float scale, bool causal,
             int window, int q_offset, cudaStream_t stream) {
#define FLASH_LAUNCH_D(DIM)                                                    \
  case DIM:                                                                    \
    return launch_d<T, DIM>(q, k, v, o, batch, heads, group, sq, sk, qs, ks,   \
                            vs, os, scale, causal, window, q_offset, stream);
  switch (d) {
    FLASH_LAUNCH_D(16) FLASH_LAUNCH_D(32) FLASH_LAUNCH_D(64)
    FLASH_LAUNCH_D(128) FLASH_LAUNCH_D(256)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef FLASH_LAUNCH_D
}

}  // namespace

// Plain C entry point (bound with ctypes). q (B, H, Sq, D), k and v
// (B, Hkv, Sk, D), out (B, H, Sq, D), each addressed through its (batch,
// head, row) element strides with the last dimension contiguous, all float32
// (dtype 0) or bf16 (dtype 1) on the device of `stream`. H must be a
// multiple of Hkv and D one of 16, 32, 64, 128, 256. Returns the CUDA error
// of the launch, 0 when the kernel was queued.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int kv_heads, int sq, int sk, int d,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, int q_offset, void* stream_ptr) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || sq < 1 ||
      sk < 1 || window < 0 || q_offset < 0 || batch > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const Strides qs{q_sb, q_sh, q_ss}, ks{k_sb, k_sh, k_ss},
      vs{v_sb, v_sh, v_ss}, os{o_sb, o_sh, o_ss};
  const int group = heads / kv_heads;
  if (dtype == 0)
    return launch_t<float>(q, k, v, out, batch, heads, group, sq, sk, d, qs, ks,
                           vs, os, scale, causal != 0, window, q_offset, stream);
  if (dtype == 1)
    return launch_t<__nv_bfloat16>(q, k, v, out, batch, heads, group, sq, sk, d,
                                   qs, ks, vs, os, scale, causal != 0, window,
                                   q_offset, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
