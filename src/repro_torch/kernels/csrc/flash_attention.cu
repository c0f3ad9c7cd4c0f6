// Hopper kernels for LM prefill attention: flash_attention.
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
// TPU kernel upcasts; a masked score is -1e30, its NEG_INF, so a row that
// has seen no visible key yet takes exp(0) until its first visible key
// rescales that by 0. Scores are kept pre-scaled by scale * log2(e) and
// exponentiated in base 2 with the SFU's ex2.approx.ftz (2 ulp; within the
// 2e-5 float32 tolerance). The output is cast to the inputs' type.
//
// Query and key rows are D wide, value and output rows Dv (Dv = D except
// for DeepSeek MLA's prefill, D = 192 over Dv = 128, which both routes
// take).
//
// What bounds it: at prefill shapes the multiply-adds, 2 (D + Dv) FLOP per
// visible (query, key) pair (4 D where Dv = D), read from device memory
// once but from shared memory many times. So both products run on the tensor cores, one route per type:
//
// * bf16, `wgmma` (flash_bf16_kernel). A block is one producer warpgroup and
//   C consumer warpgroups of 64 query rows (C = 2 at D <= 128; 1 at D = 256,
//   and for short prompts, where 2 would leave SMs idle). One thread of the
//   producer loads the block's Q tile once and then K and V tiles with TMA
//   (128/64/32-byte swizzle by row width) into a ring of two stages,
//   completing on mbarriers; consumers release a stage through another
//   mbarrier. Each consumer computes S = Q K^T with wgmma m64nBKk16 (Q and K
//   K-major in shared memory, float32 accumulators), takes the running
//   softmax on the accumulator registers (each row's four threads reduce max
//   with two quad shuffles; l stays a per-thread partial sum, reduced once
//   at the end), rounds P to bf16 in registers and runs O += P V with wgmma
//   taking P as its register A operand and V from shared memory in MN-major
//   form. The S accumulator layout is exactly the A-fragment layout, so P
//   never leaves the registers. Two overlaps keep the tensor cores busy
//   while the softmax (64 exponentials a thread a tile, on the SFU) runs:
//   a consumer issues S of tile j together with P V of tile j - 1 and runs
//   the softmax of tile j under that product; and two consumers take turns
//   to issue (named barriers, FA3's ping-pong), so one's softmax runs
//   under the other's products. With C = 2, setmaxnreg gives the consumers
//   240 registers and the producer 24 (C = 1 leaves 255 to each thread
//   without it). D = 256 takes one consumer and 64-key tiles to fit the
//   128 accumulator registers of O. (D, Dv) = (192, 128) keeps Q and K as
//   three 64-column panels and V as two, each with its own tensor map, in
//   64-key tiles: Q 48 KB, and 40 KB of K and V a stage at 128 query rows
//   (129 KB a block with the barriers and alignment). Rounding P to bf16
//   (the TPU kernel keeps it float32) changes an output by at most about
//   2^-9 of its size.
// * float32, 3xTF32 `mma.sync.m16n8k8` (flash_f32_kernel). Each operand x
//   is split as big = tf32(x), small = tf32(x - big) and a b is taken as
//   small_a big_b + big_a small_b + big_a big_b, accumulated in float32:
//   float32 accuracy at up to a third of the TF32 tensor-core rate, against
//   67 TFLOP/s on the CUDA cores. (wgmma's TF32 form takes only K-major
//   operands from shared memory, which would need a transposed V copy and
//   big and small halves of K and V there; mma.sync takes register
//   fragments, so the split is per element.) A warp owns 16 query rows,
//   up to 8 warps a block (4 below D = 128, two blocks an SM). Q and a
//   two-stage ring of K and V tiles of 64 keys (16 at D = 256; 32 at
//   (D, Dv) = (192, 128), whose Q and K rows take 196 floats and V rows 132:
//   180 KB a block of 8 warps) sit in shared memory, filled with 16-byte
//   cp.async; rows are padded by four floats so fragment loads hit 32
//   distinct banks. The keys of each 8-key
//   step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7) on both sides of
//   P V, which makes the S accumulator fragment the A fragment of P V: P
//   moves neither through shuffles nor through shared memory.
//
// Both: a block walks only the key tiles that hold a visible key for one of
// its rows (a warp or warpgroup skips the tiles wholly masked for its own
// rows); the mask is applied only on tiles that cross the causal diagonal,
// the window's edge or Sk. Causal query tiles are launched longest first
// (blockIdx.z counts down), so the last wave is not one long tile. The
// output is written from registers through (batch, head, row) strides.
// Tile sizes are fixed per (D, type) below and mirrored by the host-side
// plan in kernels/flash_attention.py, which picks the query tile (warps or
// warpgroups per block) and passes it here; a plan this file does not
// instantiate is refused with cudaErrorInvalidValue.
//
// Tensor maps are encoded on the host with libcuda's
// cuTensorMapEncodeTiled, fetched through the runtime's entry-point query,
// so the library needs no -lcuda.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long b, h, s;                   // elements; the head dim is contiguous
};

struct Problem {
  int group;                           // H / Hkv
  int sq, sk;
  int causal, window, q_offset;
  float scale_log2;                    // scale * log2(e)
};

// Keys [begin, end) that hold a visible key for some row of [r0, r1).
struct KeyRange {
  int begin, end;
};

__device__ __forceinline__ KeyRange key_range(const Problem& p, int r0,
                                              int r1) {
  const int first = r0 + p.q_offset, last = r1 - 1 + p.q_offset;
  KeyRange r;
  r.end = p.causal ? min(p.sk, last + 1) : p.sk;
  r.begin = p.window > 0 ? max(0, first - p.window + 1) : 0;
  return r;
}

// Whether some (row, key) of rows [r0, r1) x keys [k0, k0 + n) is masked.
__device__ __forceinline__ bool tile_needs_mask(const Problem& p, int r0,
                                                int r1, int k0, int n) {
  if (k0 + n > p.sk) return true;
  if (p.causal && k0 + n - 1 > r0 + p.q_offset) return true;
  if (p.window > 0 && k0 <= r1 - 1 + p.q_offset - p.window) return true;
  return false;
}

__device__ __forceinline__ bool visible(const Problem& p, int row, int key) {
  const int pos = row + p.q_offset;
  return key < p.sk && (!p.causal || key <= pos) &&
         (p.window <= 0 || key > pos - p.window);
}

// 2^x on the special-function unit (ex2.approx.ftz: 2 ulp, denormal
// results flushed to 0), the running softmax's exponential.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// One step of the running softmax for the two rows a thread holds (rows g
// and g + 8 of its 16), over `n` pre-scaled scores laid out as mma
// accumulators: s[4 j + r] is row g + 8 (r >> 1). Turns s into
// p = exp2(s - m_new), rescales the partial sums l, and returns the two
// rows' factors alpha = exp2(m_old - m_new) for the output accumulator.
template <int N>
__device__ __forceinline__ float2 online_softmax(float (&s)[N], float (&m)[2],
                                                 float (&l)[2]) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int i = 0; i < N; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], quad_max(mx[r]));
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const int r = (i >> 1) & 1;
    s[i] = fast_exp2(s[i] - m[r]);
    sum[r] += s[i];
  }
  l[0] = l[0] * alpha[0] + sum[0];
  l[1] = l[1] * alpha[1] + sum[1];
  return make_float2(alpha[0], alpha[1]);
}

// Scale raw scores to the log2 domain and, on a tile that crosses a mask
// edge, replace masked ones by -1e30. Element 4 j + r of a thread sits at
// row `row0 + 8 (r >> 1)`, key `key0 + 8 j + (r & 1)` (row0 and key0 carry
// the thread's own offsets).
template <int N>
__device__ __forceinline__ void scale_and_mask(float (&s)[N], const Problem& p,
                                               bool mask, int row0,
                                               int key0) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    s[i] *= p.scale_log2;
    if (mask) {
      const int row = row0 + 8 * ((i >> 1) & 1);
      const int key = key0 + 8 * (i >> 2) + (i & 1);
      if (!visible(p, row, key)) s[i] = kNegInf;
    }
  }
}

// ---------------------------------------------------------------------------
// float32: 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

// DQ: the head dim of q and k; DV: that of v and the output (MLA's
// prefill attends with DQ = 192 over DV = 128; every other caller has
// DQ = DV). Q and K rows are staged DQ + 4 floats wide, V rows DV + 4.
template <int DQ, int DV>
struct F32Tile {
  static constexpr int kBlockK = DQ != DV ? 32 : (DQ <= 128 ? 64 : 16);
  static constexpr int kMaxWarps = DQ >= 128 ? 8 : 4;
  static constexpr int kMinBlocks = DQ >= 128 ? 1 : 2;
  static constexpr int kStages = 2;
  static constexpr int kLdQ = DQ + 4;  // floats per staged Q or K row
  static constexpr int kLdV = DV + 4;  // floats per staged V row
  static constexpr int kStageFloats = kBlockK * (kLdQ + kLdV);  // K + V
  static size_t smem_bytes(int warps) {
    return (static_cast<size_t>(warps) * 16 * kLdQ +
            static_cast<size_t>(kStages) * kStageFloats) *
           sizeof(float);
  }
};

__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

struct Split {
  uint32_t big, small;
};

__device__ __forceinline__ Split split(float x) {
  Split r;
  r.big = to_tf32(x);
  r.small = to_tf32(x - __uint_as_float(r.big));
  return r;
}

__device__ __forceinline__ void mma_tf32(float* d, uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// d += a b in 3xTF32, small products first.
__device__ __forceinline__ void mma_3xtf32(float* d, const Split (&a)[4],
                                           Split b0, Split b1) {
  mma_tf32(d, a[0].small, a[1].small, a[2].small, a[3].small, b0.big, b1.big);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b0.small, b1.small);
  mma_tf32(d, a[0].big, a[1].big, a[2].big, a[3].big, b0.big, b1.big);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool in) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(in ? 16 : 0) : "memory");
}

// rows x D floats from `src` (row stride `ld_src`, rows >= `valid`
// zero-filled) into shared `dst` (row stride LD), by all threads.
template <int D, int LD>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           long long ld_src, int rows,
                                           int valid) {
  constexpr int kChunks = D / 4;
  for (int i = threadIdx.x; i < rows * kChunks; i += blockDim.x) {
    const int r = i / kChunks, c = i % kChunks;
    const bool in = r < valid;
    cp_async16(dst + r * LD + 4 * c, in ? src + r * ld_src + 4 * c : src,
               in);
  }
}

template <int DQ, int DV>
__global__ void __launch_bounds__(32 * F32Tile<DQ, DV>::kMaxWarps,
                                  F32Tile<DQ, DV>::kMinBlocks)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 Strides qs, Strides ks, Strides vs, Strides os, Problem p,
                 int n_qtiles) {
  using T = F32Tile<DQ, DV>;
  constexpr int BK = T::kBlockK, LD = T::kLdQ, LDV = T::kLdV;
  constexpr int kSn = BK / 8;          // 8-key accumulator tiles of S
  constexpr int kOn = DV / 8;          // 8-column accumulator tiles of O
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x / 32;
  const int block_q = 16 * warps;
  float* q_s = smem;
  float* kv_s = q_s + block_q * LD;    // stage s: K, then V

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_qtiles - 1 - blockIdx.z) * block_q;
  const int hk = h / p.group;
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + hk * ks.h;
  const float* vb = v + b * vs.b + hk * vs.h;

  const KeyRange blk = key_range(p, q0, min(q0 + block_q, p.sq));
  const int tile0 = blk.begin / BK;
  const int n_tiles = (blk.end + BK - 1) / BK - tile0;
  // this warp's real rows and the keys they see
  const int w0 = q0 + 16 * warp, w1 = min(w0 + 16, p.sq);
  const KeyRange wk = key_range(p, w0, w1);

  auto stage_kv = [&](int it) {
    const int k0 = (tile0 + it) * BK;
    float* ks_ = kv_s + (it % T::kStages) * T::kStageFloats;
    stage_rows<DQ, LD>(ks_, kb + k0 * ks.s, ks.s, BK, p.sk - k0);
    stage_rows<DV, LDV>(ks_ + BK * LD, vb + k0 * vs.s, vs.s, BK, p.sk - k0);
  };
  stage_rows<DQ, LD>(q_s, qb + q0 * qs.s, qs.s, block_q, p.sq - q0);
  stage_kv(0);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  float acc[kOn][4];
#pragma unroll
  for (int j = 0; j < kOn; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) stage_kv(it + 1);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                   // tile `it` (and Q) landed
    const int k0 = (tile0 + it) * BK;
    if (w0 < w1 && k0 < wk.end && k0 + BK > wk.begin) {
      const float* k_s = kv_s + (it % T::kStages) * T::kStageFloats;
      const float* v_s = k_s + BK * LD;
      const float* qw = q_s + (16 * warp + g) * LD + t;
      // S = Q K^T: A = Q rows (g, g + 8) x dims (t, t + 4) of each 8-step,
      // B = K rows (keys) 8 j + g x the same dims
      float s[kSn * 4];
#pragma unroll
      for (int i = 0; i < kSn * 4; ++i) s[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DQ / 8; ++kk) {
        const Split a[4] = {split(qw[8 * kk]), split(qw[8 * LD + 8 * kk]),
                            split(qw[8 * kk + 4]),
                            split(qw[8 * LD + 8 * kk + 4])};
#pragma unroll
        for (int j = 0; j < kSn; ++j) {
          const float* kr = k_s + (8 * j + g) * LD + 8 * kk + t;
          mma_3xtf32(s + 4 * j, a, split(kr[0]), split(kr[4]));
        }
      }
      // accumulator element 4 j + r: row g + 8 (r >> 1), key 8 j + 2 t + (r & 1)
      scale_and_mask(s, p, tile_needs_mask(p, w0, w1, k0, BK), w0 + g,
                     k0 + 2 * t);
      const float2 alpha = online_softmax(s, m, l);
#pragma unroll
      for (int j = 0; j < kOn; ++j) {
        acc[j][0] *= alpha.x;
        acc[j][1] *= alpha.x;
        acc[j][2] *= alpha.y;
        acc[j][3] *= alpha.y;
      }
      // O += P V over 8-key steps whose A column c is key 2 c (c < 4) or
      // 2 (c - 4) + 1: then A = (s0, s2, s1, s3) of the step's S tile, and
      // B rows t and t + 4 are keys 2 t and 2 t + 1
#pragma unroll
      for (int j = 0; j < kSn; ++j) {
        const Split a[4] = {split(s[4 * j]), split(s[4 * j + 2]),
                            split(s[4 * j + 1]), split(s[4 * j + 3])};
        const float* vr = v_s + (8 * j + 2 * t) * LDV + g;
#pragma unroll
        for (int n = 0; n < kOn; ++n)
          mma_3xtf32(acc[n], a, split(vr[8 * n]), split(vr[LDV + 8 * n]));
      }
    }
    __syncthreads();                   // stage `it % 2` may be refilled
  }

  // acc / max(l, 1e-20); l was a per-thread partial sum of its row
  const float den[2] = {fmaxf(quad_sum(l[0]), 1e-20f),
                        fmaxf(quad_sum(l[1]), 1e-20f)};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = w0 + g + 8 * r;
    if (row >= p.sq) continue;
    float* out = o + b * os.b + h * os.h + row * os.s + 2 * t;
#pragma unroll
    for (int n = 0; n < kOn; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * r] / den[r], acc[n][2 * r + 1] / den[r]);
  }
}

// ---------------------------------------------------------------------------
// bf16: TMA producer, wgmma consumers
// ---------------------------------------------------------------------------

// DQ: the head dim of q and k; DV: that of v and the output (DQ = 192
// over DV = 128 for MLA's prefill; DQ = DV for every other caller).
template <int DQ, int DV, int C>
struct Bf16Tile {
  static constexpr int kBlockQ = 64 * C;
  // 64-key tiles where O's accumulators (D = 256) or the wider Q and K rows
  // (MLA's 192) need the room, 128 otherwise
  static constexpr int kBlockK = (DQ == 256 || DQ != DV) ? 64 : 128;
  static constexpr int kStages = 2;
  static constexpr int kThreads = 128 * (C + 1);      // consumers, producer
  // With two consumers the launch bound leaves 168 registers a thread;
  // setmaxnreg moves the producer's down to 24 and the consumers' up to
  // 240. With one, the bound leaves 255 to every thread and none move.
  static constexpr bool kMoveRegs = C == 2;
  static constexpr int kConsumerRegs = 240;
  static constexpr int kProducerRegs = 24;
  // A tile is stored as column panels of kPanelCols columns (DQ / kPanelCols
  // for Q and K, DV / kPanelCols for V), rows of kRowBytes, in the layout
  // TMA writes with a swizzle as wide as the row. DQ and DV share the panel
  // width: both are at least 64 where they differ.
  static constexpr int kPanelCols = DQ < 64 ? DQ : 64;
  static_assert(DQ == DV || (DQ % 64 == 0 && DV % 64 == 0),
                "unequal head dims need whole 64-column panels");
  static constexpr int kPanelsQ = DQ / kPanelCols;
  static constexpr int kPanelsV = DV / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;
  static constexpr int kGroupBytes = 8 * kRowBytes;   // 8-row swizzle atom
  static constexpr uint64_t kLayout =                 // descriptor swizzle
      kRowBytes == 128 ? 1 : (kRowBytes == 64 ? 2 : 3);
  static constexpr int kQBytes = kBlockQ * DQ * 2;
  static constexpr int kKTileBytes = kBlockK * DQ * 2;   // one K tile
  static constexpr int kVTileBytes = kBlockK * DV * 2;   // one V tile
  static constexpr int kStageBytes = kKTileBytes + kVTileBytes;
  static constexpr int kBarrierOffset = kQBytes + kStages * kStageBytes;
  static constexpr size_t kSmem =
      1024 + kBarrierOffset + 8 * (1 + 2 * kStages);  // + 1024-B alignment
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// A box of the 4-d tensor map (D, S, H, B) at (col, row, head, batch) into
// shared memory, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar),
         "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle of the layout.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed wgmma groups are still running.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keeps the compiler from moving accesses of wgmma's registers across the
// asynchronous instructions that own them (and from reusing an operand's
// registers while a wgmma still reads them).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

// Named barrier `id` over 256 threads: one warpgroup waits on it while the
// other arrives (the two consumers' turn-taking).
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" :: "r"(id) : "memory");
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int N>
struct Wgmma;

template <> struct Wgmma<16> {
  // d += A B, A (bf16 pairs) in registers, B MN-major in shared memory
  __device__ static void rs(float (&d)[8],
                                   const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  // d += A B, A (bf16 pairs) in registers, B MN-major in shared memory
  __device__ static void rs(float (&d)[16],
                                   const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  // S = A B^T, A and B K-major in shared memory; scale_d 0 overwrites d
  __device__ static void ss(float (&d)[32],
                                   uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "%32, %33, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A (bf16 pairs) in registers, B MN-major in shared memory
  __device__ static void rs(float (&d)[32],
                                   const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  // S = A B^T, A and B K-major in shared memory; scale_d 0 overwrites d
  __device__ static void ss(float (&d)[64],
                                   uint64_t a, uint64_t b, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "%64, %65, p, 1, 1, 0, 0;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
  // d += A B, A (bf16 pairs) in registers, B MN-major in shared memory
  __device__ static void rs(float (&d)[64],
                                   const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<256> {
  // d += A B, A (bf16 pairs) in registers, B MN-major in shared memory
  __device__ static void rs(float (&d)[128],
                                   const uint32_t (&a)[4], uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
        "{"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127}, "
        "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
        :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};


template <int DQ, int DV, int C>
__global__ void __launch_bounds__(Bf16Tile<DQ, DV, C>::kThreads, 1)
flash_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
                  const __grid_constant__ CUtensorMap k_map,
                  const __grid_constant__ CUtensorMap v_map,
                  __nv_bfloat16* __restrict__ o, Strides os, Problem p,
                  int n_qtiles) {
  using T = Bf16Tile<DQ, DV, C>;
  constexpr int BK = T::kBlockK;
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms of TMA and wgmma are addressed from a 1024-byte boundary
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t kv_s = q_s + T::kQBytes;   // stage s: its K tile, then V
  const uint32_t q_full = q_s + T::kBarrierOffset;
  const uint32_t full0 = q_full + 8;                  // full[s]: K, V landed
  const uint32_t empty0 = full0 + 8 * T::kStages;     // empty[s]: released

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (n_qtiles - 1 - blockIdx.z) * T::kBlockQ;
  const KeyRange blk = key_range(p, q0, min(q0 + T::kBlockQ, p.sq));
  const int tile0 = blk.begin / BK;
  const int n_tiles = (blk.end + BK - 1) / BK - tile0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 4 * C);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == C) {
    // producer warpgroup: one thread issues every TMA load of the block
    if constexpr (T::kMoveRegs)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n"
                   :: "n"(T::kProducerRegs));
    if (threadIdx.x == 128 * C) {
      const int hk = h / p.group;
      mbar_expect_tx(q_full, T::kQBytes);
      for (int pn = 0; pn < T::kPanelsQ; ++pn)
        tma_load(q_s + pn * T::kBlockQ * T::kRowBytes, &q_map, q_full,
                 pn * T::kPanelCols, q0, h, b);
      for (int it = 0; it < n_tiles; ++it) {
        const int s = it % T::kStages;
        mbar_wait(empty0 + 8 * s, ((it / T::kStages) & 1) ^ 1);
        mbar_expect_tx(full0 + 8 * s, T::kStageBytes);
        const int k0 = (tile0 + it) * BK;
        const uint32_t k_dst = kv_s + s * T::kStageBytes;
        for (int pn = 0; pn < T::kPanelsQ; ++pn)
          tma_load(k_dst + pn * BK * T::kRowBytes, &k_map, full0 + 8 * s,
                   pn * T::kPanelCols, k0, hk, b);
        for (int pn = 0; pn < T::kPanelsV; ++pn)
          tma_load(k_dst + T::kKTileBytes + pn * BK * T::kRowBytes, &v_map,
                   full0 + 8 * s, pn * T::kPanelCols, k0, hk, b);
      }
    }
  } else {
    // consumer warpgroup wg: query rows [q0 + 64 wg, q0 + 64 wg + 64)
    if constexpr (T::kMoveRegs)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                   :: "n"(T::kConsumerRegs));
    const int warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const int g = lane / 4, t = lane % 4;
    const int r0 = q0 + 64 * wg, r1 = min(r0 + 64, p.sq);
    const int row0 = r0 + 16 * warp + g;       // rows row0 and row0 + 8
    // the tiles [it_lo, it_hi) that hold a visible key for these rows;
    // two consumers take turns on every tile of the block instead
    int it_lo = C == 2 ? 0 : n_tiles, it_hi = n_tiles;
    if (C == 1 && r0 < r1) {
      const KeyRange wk = key_range(p, r0, r1);
      it_lo = wk.begin / BK - tile0;
      it_hi = (wk.end + BK - 1) / BK - tile0;
    }
    float o_acc[DV / 2];
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) o_acc[i] = 0.f;
    float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

    auto wait_full = [&](int it) {
      mbar_wait(full0 + 8 * (it % T::kStages), (it / T::kStages) & 1);
    };
    auto release = [&](int it) {
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * (it % T::kStages));
    };
    auto k_tile = [&](int it) {
      return kv_s + (it % T::kStages) * T::kStageBytes;
    };
    // S = Q K^T of tile `it`, 16 dims a step: both K-major, SBO = one
    // 8-row swizzle atom (issued, not waited for)
    auto issue_s = [&](float (&sc)[BK / 2], int it) {
#pragma unroll
      for (int kk = 0; kk < DQ / 16; ++kk) {
        const int pn = 16 * kk / T::kPanelCols;
        const int col = 2 * (16 * kk % T::kPanelCols);
        const uint64_t da = smem_desc(
            q_s + (pn * T::kBlockQ + 64 * wg) * T::kRowBytes + col, 16,
            T::kGroupBytes, T::kLayout);
        const uint64_t db = smem_desc(k_tile(it) + pn * BK * T::kRowBytes +
                                      col, 16, T::kGroupBytes, T::kLayout);
        Wgmma<BK>::ss(sc, da, db, kk);
      }
    };
    // O += P V of tile `it`, 16 keys a step: V MN-major, SBO = one 8-key
    // atom, LBO = one column panel (issued, not waited for)
    auto issue_pv = [&](uint32_t (&pa)[BK / 16][4], int it) {
      const uint32_t v_tile = k_tile(it) + T::kKTileBytes;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<DV>::rs(o_acc, pa[kk],
                     smem_desc(v_tile + 16 * kk * T::kRowBytes,
                               BK * T::kRowBytes, T::kGroupBytes,
                               T::kLayout));
    };
    // the running softmax of tile `it` on its scores, in place (sc
    // becomes P); returns the rows' rescale of the output
    auto softmax = [&](float (&sc)[BK / 2], int it) {
      const int k0 = (tile0 + it) * BK;
      // accumulator element 4 j + r: row row0 + 8 (r >> 1),
      // key k0 + 8 j + 2 t + (r & 1)
      scale_and_mask(sc, p, tile_needs_mask(p, r0, r1, k0, BK), row0,
                     k0 + 2 * t);
      return online_softmax(sc, m, l);
    };
    // P rounded to bf16: accumulator tiles 2 kk and 2 kk + 1 are exactly
    // the A fragment of keys [16 kk, 16 kk + 16)
    auto pack_p = [&](const float (&sc)[BK / 2], uint32_t (&pa)[BK / 16][4]) {
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sc[8 * kk + 2 * r], sc[8 * kk + 2 * r + 1]);
    };

    // Ping-pong (two consumers): a warpgroup issues its wgmmas only in its
    // turn (named barrier 1 + wg) and then hands the turn over, so one's
    // softmax runs while the other's products occupy the tensor cores.
    // Consumer 1 opens consumer 0's first turn; its own last hand-over
    // would have no taker and is skipped.
    int phase = 0;
    const int last_phase = it_hi - it_lo;
    auto take_turn = [&]() {
      if (C == 2) named_sync(1 + wg);
    };
    auto pass_turn = [&]() {
      if (C == 2 && !(wg == 1 && phase == last_phase)) named_arrive(2 - wg);
      ++phase;
    };
    if (C == 2 && wg == 1) named_arrive(1);

    mbar_wait(q_full, 0);
    for (int it = 0; it < it_lo; ++it) {       // wholly masked for these rows
      wait_full(it);
      release(it);
    }
    if (it_lo < it_hi) {
      // Software pipeline: while the softmax of tile `it` runs on the CUDA
      // cores, the tensor cores finish O += P V of tile it - 1. P is packed
      // only once that product is done, so no register a running wgmma
      // reads is written under it.
      float sc[BK / 2];
      uint32_t pa[BK / 16][4];
      wait_full(it_lo);
      take_turn();
      wgmma_fence();
      issue_s(sc, it_lo);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(sc, it_lo);                      // o_acc is 0: no rescale
      pack_p(sc, pa);
      for (int it = it_lo + 1; it < it_hi; ++it) {
        wait_full(it);
        take_turn();
        wgmma_fence();
        issue_s(sc, it);
        wgmma_commit();
        issue_pv(pa, it - 1);
        wgmma_commit();
        pass_turn();
        wgmma_wait<1>();                       // S of tile `it` is done
        fence_regs(sc);
        const float2 alpha = softmax(sc, it);
        wgmma_wait<0>();                       // P V of tile it - 1 is done
        fence_regs(o_acc);
        fence_regs(pa);
        release(it - 1);
#pragma unroll
        for (int i = 0; i < DV / 2; ++i)
          o_acc[i] *= ((i >> 1) & 1) ? alpha.y : alpha.x;
        pack_p(sc, pa);
      }
      take_turn();
      wgmma_fence();
      issue_pv(pa, it_hi - 1);
      wgmma_commit();
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o_acc);
      fence_regs(pa);
      release(it_hi - 1);
    }
    for (int it = it_hi; it < n_tiles; ++it) {  // wholly masked as well
      wait_full(it);
      release(it);
    }

    // acc / max(l, 1e-20); l was a per-thread partial sum of its row
    const float den[2] = {fmaxf(quad_sum(l[0]), 1e-20f),
                          fmaxf(quad_sum(l[1]), 1e-20f)};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = row0 + 8 * r;
      if (row >= p.sq) continue;
      __nv_bfloat16* out = o + b * os.b + h * os.h + row * os.s + 2 * t;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j)
        *reinterpret_cast<uint32_t*>(out + 8 * j) =
            pack_bf16(o_acc[4 * j + 2 * r] / den[r],
                      o_acc[4 * j + 2 * r + 1] / den[r]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

using EncodeTiled = CUresult (*)(
    CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
    const cuuint64_t*, const cuuint32_t*, const cuuint32_t*,
    CUtensorMapInterleave, CUtensorMapSwizzle, CUtensorMapL2promotion,
    CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// The (D, rows, heads, batch) map of a bf16 tensor read through its (batch,
// head, row) strides, in boxes of box_cols x box_rows.
bool encode_map(CUtensorMap* map, const void* base, int d, int rows,
                int heads, int batch, Strides st, int box_cols, int box_rows,
                int row_bytes) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : (row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                          : CU_TENSOR_MAP_SWIZZLE_32B);
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
int opt_in_shared(K kernel, size_t bytes) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int batch, heads, kv_heads;
  Strides qs, ks, vs, os;
  Problem p;
  cudaStream_t stream;
};

template <int DQ, int DV>
int launch_f32(const Args& a, int warps) {
  using T = F32Tile<DQ, DV>;
  if (warps < 1 || warps > T::kMaxWarps)
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;        // once per instantiation and process
  if (!opted_in) {
    const int err = opt_in_shared(flash_f32_kernel<DQ, DV>,
                                  T::smem_bytes(T::kMaxWarps));
    if (err) return err;
    opted_in = true;
  }
  const int n_qtiles = (a.p.sq + 16 * warps - 1) / (16 * warps);
  if (n_qtiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.heads, a.batch, n_qtiles);
  flash_f32_kernel<DQ, DV>
      <<<grid, 32 * warps, T::smem_bytes(warps), a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.qs, a.ks,
      a.vs, a.os, a.p, n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

template <int DQ, int DV, int C>
int launch_bf16(const Args& a) {
  using T = Bf16Tile<DQ, DV, C>;
  CUtensorMap q_map, k_map, v_map;
  // V's map is DV wide: its boxes are the same 64-column panels
  if (!encode_map(&q_map, a.q, DQ, a.p.sq, a.heads, a.batch, a.qs,
                  T::kPanelCols, T::kBlockQ, T::kRowBytes) ||
      !encode_map(&k_map, a.k, DQ, a.p.sk, a.kv_heads, a.batch, a.ks,
                  T::kPanelCols, T::kBlockK, T::kRowBytes) ||
      !encode_map(&v_map, a.v, DV, a.p.sk, a.kv_heads, a.batch, a.vs,
                  T::kPanelCols, T::kBlockK, T::kRowBytes))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool opted_in = false;
  if (!opted_in) {
    const int err = opt_in_shared(flash_bf16_kernel<DQ, DV, C>, T::kSmem);
    if (err) return err;
    opted_in = true;
  }
  const int n_qtiles = (a.p.sq + T::kBlockQ - 1) / T::kBlockQ;
  if (n_qtiles > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(a.heads, a.batch, n_qtiles);
  flash_bf16_kernel<DQ, DV, C><<<grid, T::kThreads, T::kSmem, a.stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(a.o), a.os, a.p,
      n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

// The instantiation of a (type, D, Dv, query tile, key tile) plan, or
// cudaErrorInvalidValue when this file has none. Dv differs from D only
// at (192, 128), MLA's prefill, on both routes.
int dispatch(const Args& a, int dtype, int d, int dv, int block_q,
             int block_k) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
#define FLASH_F32(DIM)                                                       \
  case DIM:                                                                  \
    if (block_k != F32Tile<DIM, DIM>::kBlockK || block_q % 16) return bad;   \
    return launch_f32<DIM, DIM>(a, block_q / 16);
#define FLASH_BF16(DIM)                                                      \
  case DIM:                                                                  \
    if (block_q == 128 && block_k == Bf16Tile<DIM, DIM, 2>::kBlockK)         \
      return launch_bf16<DIM, DIM, 2>(a);                                    \
    if (block_q == 64 && block_k == Bf16Tile<DIM, DIM, 1>::kBlockK)          \
      return launch_bf16<DIM, DIM, 1>(a);                                    \
    return bad;
  if (dtype == 0 && d == 192 && dv == 128) {
    if (block_k != F32Tile<192, 128>::kBlockK || block_q % 16) return bad;
    return launch_f32<192, 128>(a, block_q / 16);
  }
  if (dtype == 1 && d == 192 && dv == 128) {
    if (block_q == 128 && block_k == Bf16Tile<192, 128, 2>::kBlockK)
      return launch_bf16<192, 128, 2>(a);
    if (block_q == 64 && block_k == Bf16Tile<192, 128, 1>::kBlockK)
      return launch_bf16<192, 128, 1>(a);
    return bad;
  }
  if (dv != d) return bad;
  if (dtype == 0) {
    switch (d) {
      FLASH_F32(16) FLASH_F32(32) FLASH_F32(64) FLASH_F32(128) FLASH_F32(256)
      default: return bad;
    }
  }
  if (dtype == 1) {
    switch (d) {
      FLASH_BF16(16) FLASH_BF16(32) FLASH_BF16(64) FLASH_BF16(128)
      case 256:
        if (block_q != 64 || block_k != Bf16Tile<256, 256, 1>::kBlockK)
          return bad;
        return launch_bf16<256, 256, 1>(a);
      default: return bad;
    }
  }
  return bad;
#undef FLASH_F32
#undef FLASH_BF16
}

}  // namespace

// Plain C entry point (bound with ctypes). q (B, H, Sq, D), k (B, Hkv, Sk,
// D), v (B, Hkv, Sk, Dv), out (B, H, Sq, Dv), each addressed through its
// (batch, head, row) element strides with the last dimension contiguous,
// all float32 (dtype 0) or bf16 (dtype 1) on the device of `stream`. H must
// be a multiple of Hkv, D one of 16, 32, 64, 128, 256 with Dv = D, or
// D = 192 with Dv = 128. (block_q, block_k) is
// the host-side plan's tile (kernels/flash_attention.py::plan): float32
// takes block_q = 16 x warps, bf16 block_q = 64 x consumer warpgroups.
// bf16 tensors must meet TMA's rules (16-byte aligned base, strides in
// multiples of 16 bytes), float32 ones cp.async's (16-byte aligned rows).
// Returns the CUDA error of the launch, 0 when the kernel was queued.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype,
    int batch, int heads, int kv_heads, int sq, int sk, int d, int dv,
    long long q_sb, long long q_sh, long long q_ss,
    long long k_sb, long long k_sh, long long k_ss,
    long long v_sb, long long v_sh, long long v_ss,
    long long o_sb, long long o_sh, long long o_ss,
    float scale, int causal, int window, int q_offset, int block_q,
    int block_k, void* stream_ptr) {
  if (batch < 1 || heads < 1 || kv_heads < 1 || heads % kv_heads || sq < 1 ||
      sk < 1 || window < 0 || q_offset < 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = out;
  a.batch = batch;
  a.heads = heads;
  a.kv_heads = kv_heads;
  a.qs = Strides{q_sb, q_sh, q_ss};
  a.ks = Strides{k_sb, k_sh, k_ss};
  a.vs = Strides{v_sb, v_sh, v_ss};
  a.os = Strides{o_sb, o_sh, o_ss};
  a.p = Problem{heads / kv_heads, sq, sk, causal != 0, window, q_offset,
                scale * kLog2e};
  a.stream = static_cast<cudaStream_t>(stream_ptr);
  return dispatch(a, dtype, d, dv, block_q, block_k);
}
