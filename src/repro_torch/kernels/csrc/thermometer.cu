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
// int8 bits, with no reuse but the (F, T) thresholds; at 65536 ULN-L rows
// the output alone is 360 MB, seven times the 50 MB L2. The first version
// gave each thread one (b, f) and stored its T bits a byte at a time (a
// warp's store touched 32 bytes spread over 32·T), about a quarter of the
// bytes bound.
//
// Design: the output is one flat array of B·F·T bytes, and
//   encode:     out[o] = x_flat[o / T] > thr_flat[o mod (F·T)]
//   decompress: out[o] = (o mod T) < counts_flat[o / T]
// A block walks 16 KB tiles of it (grid-stride), each warp four 512-byte
// chunks of a tile. The tile's inputs (its ~16384 / T x values or counts)
// are copied into shared memory with cp.async, the next tile's while the
// current one is built, so the loads' latency hides behind the work.
// Lane l builds words l, l + 32, l + 64, l + 96 of a chunk in registers,
// the warp swaps them through 512 bytes of shared memory so that lane l
// holds bytes [16 l, 16 l + 16), and each lane issues one streaming
// 16-byte store (st.global.cs.v4): a warp writes 512 contiguous bytes an
// instruction. The tile's cursor (feature o / T, its bit o mod T, the
// threshold o mod F·T) advances by a constant step with carries, so the
// loop divides only by T, a template argument for T <= 16 (a multiply
// and a shift) and a run-time value above. A 4-byte word spans at most
// two features for T >= 3: encode compares each byte with one of the
// two x values (set.gt, the four results packed with byte permutes);
// decompress builds the word's four bytes at once with byte-wise integer
// arithmetic. Thresholds: thr_flat followed by its first 512 values (a
// ring, so a chunk's thresholds are contiguous) is staged in shared
// memory when it fits (F·T + 512 floats within 44 KB; ULN-L's is
// 23.9 KB) and read a word's four with one conflict-free 16-byte load;
// past that they are read through __ldg. What is left between these and
// the bytes bound is instruction issue (PERF.md). The TPU version pads F
// with +inf thresholds to its block; here bounds checks on the last tile
// take its place.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <mutex>
#include <type_traits>

// Ablations for scripts/front_end_variants.py, 0 in the port's own build:
// 1 no input copies (each tile reads whatever its buffer holds): the
// words' arithmetic and the stores alone; 2 no arithmetic (each word
// holds its bit offset): the input copies and the stores alone.
#ifndef FRONT_END_ABLATE
#define FRONT_END_ABLATE 0
#endif

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kChunk = 512;              // output bytes a warp writes a step
constexpr int kTileChunks = 4;           // chunks a warp a tile
constexpr int kTile = kWarps * kChunk * kTileChunks;   // 16 KB of output
constexpr int kMaxStaged = 11264;        // kernels/thermometer.py STAGED_FLOATS

// Bytes of one input buffer: a tile's (b, f) values (at most
// kTile / T + 2 of `elem` bytes) from the 16-byte boundary at or below the
// first, in whole 16-byte copies.
__host__ __device__ constexpr int input_bytes(int T, int elem) {
  return ((kTile / T + 2) * elem + 15) / 16 * 16 + 16;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A block's tile: its first byte o, the feature q = o / T, the bit
// t = o mod T and the threshold r = o mod F·T of that byte.
struct Cursor {
  int64_t o, q;
  int t, r;
};

// The block's next tile: the grid's step (dq, dt, dr) with carries.
__device__ __forceinline__ Cursor advance(Cursor c, int64_t step, int64_t dq,
                                          int dt, int dr, int T, int row) {
  c.o += step;
  c.q += dq;
  c.t += dt;
  if (c.t >= T) {
    c.t -= T;
    ++c.q;
  }
  c.r += dr;
  if (c.r >= row) c.r -= row;
  return c;
}

// The tile's last (b, f), relative to its first.
__device__ __forceinline__ int tile_last(const Cursor& c, int T,
                                         int64_t last) {
  const int64_t hi = c.q + (c.t + kTile - 1) / T;
  return static_cast<int>((hi < last ? hi : last) - c.q);
}

// Queue the copy of a tile's inputs, features q .. q + tile_last, to
// `dst` from the 16-byte boundary at or below the first. The first and
// last copies may read up to 15 bytes outside them, inside the same
// aligned 16 bytes (never another page).
template <class Src>
__device__ __forceinline__ void copy_inputs(const Src* src, const Cursor& c,
                                            int hi, unsigned char* dst) {
  const uintptr_t first = reinterpret_cast<uintptr_t>(src + c.q);
  const uintptr_t start = first & ~static_cast<uintptr_t>(15);
  const int n16 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(src + c.q + hi + 1) - start + 15) >> 4);
  for (int i = threadIdx.x; i < n16 && FRONT_END_ABLATE != 1; i += kThreads)
    cp_async16(dst + 16 * i, reinterpret_cast<const void*>(start + 16 * i));
}

// 0xffffffff where a > b, else 0 (NaN compares false).
__device__ __forceinline__ uint32_t greater(float a, float b) {
  uint32_t r;
  asm("set.gt.u32.f32 %0, %1, %2;" : "=r"(r) : "f"(a), "f"(b));
  return r;
}

// Byte 0 of each of four words, as one word's bytes 0..3, each 0 or 1.
__device__ __forceinline__ uint32_t pack_bytes(uint32_t b0, uint32_t b1,
                                               uint32_t b2, uint32_t b3) {
  return __byte_perm(__byte_perm(b0, b1, 0x0040), __byte_perm(b2, b3, 0x0040),
                     0x5410) & 0x01010101u;
}

// One 512-byte chunk of a tile, `d` bytes past its first, whose first
// threshold is rc: lane l builds words l + 32 i from the tile's inputs
// `vals` (features 0 .. hi past its first) and thresholds, swaps them
// through the warp's `buf` so that it holds bytes [16 l, 16 l + 16), and
// stores them.
template <int kT, bool kStaged, bool kEncode, class Src>
__device__ __forceinline__ void emit_chunk(
    const Cursor& c, int d, int rc, const Src* vals, int hi,
    const float* __restrict__ thr, const float* ring, uint32_t* buf,
    int8_t* __restrict__ out, int64_t total, int row, int T, int lane) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int off = 4 * (lane + 32 * i);   // the word's byte in the chunk
    // its first byte's bit past q's, its feature and bit (unsigned: the
    // division by T is a multiply and a shift)
    const unsigned n0 = c.t + d + off;
    const int qa = n0 / static_cast<unsigned>(T);
    const int ta = n0 - qa * T;
    uint32_t w = 0;
    if constexpr (kEncode) {
      float th[4];
      if constexpr (kStaged) {
        if ((rc & 3) == 0) {
          const float4 f4 = *reinterpret_cast<const float4*>(ring + rc + off);
          th[0] = f4.x; th[1] = f4.y; th[2] = f4.z; th[3] = f4.w;
        } else {
#pragma unroll
          for (int k = 0; k < 4; ++k) th[k] = ring[rc + off + k];
        }
      } else {   // row > kMaxStaged - kChunk: at most one wrap
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int rr = rc + off + k;
          th[k] = __ldg(thr + (rr >= row ? rr - row : rr));
        }
      }
      uint32_t g[4];
      if constexpr (kT == 1 || kT == 2) {   // up to four features a word
#pragma unroll
        for (int k = 0; k < 4; ++k)
          g[k] = greater(vals[min(static_cast<int>((n0 + k) / T), hi)], th[k]);
      } else {   // T >= 3: features qa and qa + 1; byte 0 is qa's
        const float xa = vals[min(qa, hi)], xb = vals[min(qa + 1, hi)];
        g[0] = greater(xa, th[0]);
#pragma unroll
        for (int k = 1; k < 4; ++k) g[k] = greater(ta + k >= T ? xb : xa, th[k]);
      }
      w = pack_bytes(g[0], g[1], g[2], g[3]);
    } else {
      if constexpr (kT == 1 || kT == 2) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int qk = (n0 + k) / T;
          w |= (n0 + k - qk * T < vals[min(qk, hi)] ? 1u : 0u) << (8 * k);
        }
      } else if constexpr (kT > 0) {
        // four bytes at once: byte k holds bit tk = ta + k (less T past
        // the word's boundary s = T - ta) and the count of its feature,
        // clamped to 127 (tk <= 18); tk < c iff bit 7 of
        // (0x80 + tk - c) is clear, with no borrow between bytes
        const int s = T - ta;
        const uint32_t next = s >= 4 ? 0u : 0xffffffffu << (8 * s);
        const uint32_t tk = ta * 0x01010101u + 0x03020100u -
                            (next & (T * 0x01010101u));
        const uint32_t ca = min(static_cast<uint32_t>(vals[min(qa, hi)]), 127u);
        const uint32_t cb =
            min(static_cast<uint32_t>(vals[min(qa + 1, hi)]), 127u);
        const uint32_t c4 =
            ((ca * 0x01010101u) & ~next) | ((cb * 0x01010101u) & next);
        w = (~((tk | 0x80808080u) - c4) >> 7) & 0x01010101u;
      } else {   // run-time T
        const int ca = vals[min(qa, hi)], cb = vals[min(qa + 1, hi)];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const bool next = ta + k >= T;
          w |= ((next ? ta + k - T : ta + k) < (next ? cb : ca) ? 1u : 0u)
               << (8 * k);
        }
      }
    }
    buf[lane + 32 * i] = FRONT_END_ABLATE == 2 ? n0 : w;
  }
  __syncwarp();
  const uint4 words = reinterpret_cast<const uint4*>(buf)[lane];
  const int64_t o = c.o + d;
  const int64_t left = total - o;
  if (left >= kChunk) {
    __stcs(reinterpret_cast<uint4*>(out + o) + lane, words);
  } else {   // the last chunk
    const int8_t* bytes = reinterpret_cast<const int8_t*>(buf);
    for (int j = 16 * lane; j < 16 * lane + 16 && j < left; ++j)
      out[o + j] = bytes[j];
  }
  __syncwarp();   // `buf` is free for the next chunk
}

// kT > 0: T = kT, known to the compiler; kT = 0: T at run time (> 16).
// kStaged: the threshold ring in shared memory (encode only). A block
// walks 16 KB tiles of the output (grid-stride); the copy of the next
// tile's inputs overlaps the current tile's work.
template <int kT, bool kStaged, bool kEncode>
__global__ void __launch_bounds__(kThreads)
front_end_kernel(const float* __restrict__ x,
                 const uint8_t* __restrict__ counts,
                 const float* __restrict__ thr, int8_t* __restrict__ out,
                 int64_t total, int row, int t_rt) {
  using Src = typename std::conditional<kEncode, float, uint8_t>::type;
  const Src* src;
  if constexpr (kEncode) src = x; else src = counts;
  const int T = kT > 0 ? kT : t_rt;
  const int ib = input_bytes(T, sizeof(Src));
  extern __shared__ __align__(16) unsigned char smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem) + warp * (kChunk / 4);
  unsigned char* inputs = smem + kWarps * kChunk;   // two buffers of ib
  float* ring = reinterpret_cast<float*>(inputs + 2 * ib);
  if constexpr (kStaged)   // read after the loop's first barrier
    for (int i = threadIdx.x; i < row + kChunk; i += kThreads)
      ring[i] = __ldg(thr + (i < row ? i : (i - row) % row));
  const int64_t last = total / T - 1;    // the last (b, f)
  const int64_t step = static_cast<int64_t>(gridDim.x) * kTile;
  const int64_t dq = step / T;
  const int dt = static_cast<int>(step - dq * T);
  const int dr = static_cast<int>(step % row);
  int chunk_r[kTileChunks];   // the warp's chunks' thresholds past c.r
#pragma unroll
  for (int j = 0; j < kTileChunks; ++j)
    chunk_r[j] = kEncode ? ((j * kWarps + warp) * kChunk) % row : 0;
  Cursor c;
  c.o = static_cast<int64_t>(blockIdx.x) * kTile;
  c.q = c.o / T;
  c.t = static_cast<int>(c.o - c.q * T);
  c.r = static_cast<int>(c.o % row);

  if (c.o < total) copy_inputs(src, c, tile_last(c, T, last), inputs);
  cp_async_commit();
  for (int s = 0; c.o < total; s ^= 1) {
    const Cursor n = advance(c, step, dq, dt, dr, T, row);
    if (n.o < total)
      copy_inputs(src, n, tile_last(n, T, last), inputs + (s ^ 1) * ib);
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();   // the tile's inputs (and the ring) have landed
    const unsigned char* in = inputs + s * ib;
    const Src* vals = reinterpret_cast<const Src*>(
        in + (reinterpret_cast<uintptr_t>(src + c.q) & 15));
    const int hi = tile_last(c, T, last);
#pragma unroll
    for (int j = 0; j < kTileChunks; ++j) {
      const int d = (j * kWarps + warp) * kChunk;
      const int rc = kEncode ? c.r + chunk_r[j] : 0;
      if (c.o + d < total)
        emit_chunk<kT, kStaged, kEncode>(c, d, rc >= row ? rc - row : rc,
                                         vals, hi, thr, ring, buf, out,
                                         total, row, T, lane);
    }
    __syncthreads();   // the buffer is free for the tile after next
    c = n;
  }
  cp_async_wait_all();
}

template <int kT, bool kStaged, bool kEncode>
int launch(const void* x, const void* counts, const void* thr, void* out,
           int64_t total, int row, int bits, cudaStream_t stream) {
  auto kernel = front_end_kernel<kT, kStaged, kEncode>;
  const int smem = kWarps * kChunk +
                   2 * input_bytes(bits, kEncode ? 4 : 1) +
                   (kStaged ? (row + kChunk) * 4 : 0);
  // the resident blocks of this kernel at this shared memory, asked once
  // per device and size: a launch's host work is part of its time
  static std::mutex mu;
  static int known_dev = -1, known_smem = -1, resident = 0;
  int dev = 0;
  if (cudaError_t e = cudaGetDevice(&dev)) return static_cast<int>(e);
  {
    std::lock_guard<std::mutex> lock(mu);
    if (dev != known_dev || smem != known_smem) {
      int sms = 0, per_sm = 0;
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (cudaError_t e = cudaFuncSetAttribute(
              kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
        return static_cast<int>(e);
      if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
              &per_sm, kernel, kThreads, smem))
        return static_cast<int>(e);
      known_dev = dev;
      known_smem = smem;
      resident = std::max(1, per_sm) * sms;
    }
  }
  const int64_t want = (total + kTile - 1) / kTile;
  const int blocks =
      static_cast<int>(std::min(want, static_cast<int64_t>(resident)));
  kernel<<<blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(counts),
      static_cast<const float*>(thr), static_cast<int8_t*>(out), total, row,
      bits);
  return static_cast<int>(cudaGetLastError());
}

template <bool kStaged, bool kEncode>
int dispatch(const void* x, const void* counts, const void* thr, void* out,
             int64_t total, int row, int bits, cudaStream_t stream) {
#define FRONT_END_T(T) \
  case T:              \
    return launch<T, kStaged, kEncode>(x, counts, thr, out, total, row, \
                                       bits, stream);
  switch (bits) {
    FRONT_END_T(1) FRONT_END_T(2) FRONT_END_T(3) FRONT_END_T(4)
    FRONT_END_T(5) FRONT_END_T(6) FRONT_END_T(7) FRONT_END_T(8)
    FRONT_END_T(9) FRONT_END_T(10) FRONT_END_T(11) FRONT_END_T(12)
    FRONT_END_T(13) FRONT_END_T(14) FRONT_END_T(15) FRONT_END_T(16)
    default:
      return launch<0, kStaged, kEncode>(x, counts, thr, out, total, row,
                                         bits, stream);
  }
#undef FRONT_END_T
}

// B·F·T output bytes, a 16-byte aligned output (the wrapper allocates
// it) and a row F·T that int32 cursors hold.
bool valid(const void* out, long long total, int features, int bits) {
  return total >= 1 && features >= 1 && bits >= 1 &&
         static_cast<long long>(features) * bits < (1LL << 31) - kChunk &&
         total <= (1LL << 62) / bits &&
         (reinterpret_cast<uintptr_t>(out) & 15) == 0;
}

}  // namespace

// Plain C entry points (bound with ctypes). `total` is B·F. Each returns
// the CUDA error of its launch, 0 when the kernel was queued on `stream`.
extern "C" int thermometer_encode_launch(const void* x, const void* thresholds,
                                         void* out, long long total,
                                         int features, int bits, void* stream) {
  if (!valid(out, total, features, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  const int row = features * bits;
  const int64_t bytes = static_cast<int64_t>(total) * bits;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return row + kChunk <= kMaxStaged
             ? dispatch<true, true>(x, nullptr, thresholds, out, bytes, row,
                                    bits, s)
             : dispatch<false, true>(x, nullptr, thresholds, out, bytes, row,
                                     bits, s);
}

extern "C" int thermometer_decompress_launch(const void* counts, void* out,
                                             long long total, int bits,
                                             void* stream) {
  if (!valid(out, total, 1, bits))
    return static_cast<int>(cudaErrorInvalidValue);
  return dispatch<false, false>(nullptr, counts, nullptr, out,
                                static_cast<int64_t>(total) * bits, bits, bits,
                                static_cast<cudaStream_t>(stream));
}
