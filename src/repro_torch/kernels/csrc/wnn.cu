// Hopper kernel for ULEEN's Bloom-filter scoring of a whole ensemble:
// the one kernel behind packed_wnn and fused_wnn.
//
// Replaces the Pallas TPU kernels
//   repro/kernels/packed_wnn.py::packed_wnn   (body packed_wnn_kernel)
//   repro/kernels/fused_wnn.py::fused_wnn     (body fused_wnn_kernel)
// Both compute, for each batch row b and class m,
//   scores[b, m] = bias[m] + sum_s sum_f (mask_s[m, f] != 0)
//                  * AND_j bit_s(m, f, h_j(bits[b, perm_s[f, :]]))
// where h_j is the H3 hash of the filter's n input bits (XOR of the
// params row j entries selected by its set bits) and bit_s() reads entry
// h of filter (m, f) of submodel s. Here one launch computes all
// submodels, with the permutation gather inside, on the batch's
// (B, total_bits) rows; the TPU kernels (and this port's first version)
// ran once per submodel on (B, N_f, n) tuples gathered outside.
//
// Layout (kernels/wnn_ensemble.py): the tables are class-sliced, entry
// [f, h] of an (N_f, E) array holds the M class bits of table entry h of
// filter f (uint8/uint16/uint32 for M <= 8/16/32, P = ceil(M/32) uint32
// words past that), and a filter's mask is one M-bit word. Up to 4
// classes an entry takes 1, 2 or 4 bits (the power of two >= M) and a
// byte holds 8 / bits entries: entry h of filter f is
//   (slices[f, h / epb] >> ((h % epb) * bits)) & ((1 << bits) - 1)
// (the `Sub` instantiations; the width follows from M at run time). So a
// filter's k probes answer every class at once:
//   resp = mask_f & AND_j slices[f, h_j]        (k loads, not M·k)
// and class m's vote is bit m of resp. Past 4 words (M > 128) the grid's
// second axis splits the classes into groups of 128: block (x, g) reads
// words [4g, 4g + 4) of each entry and scores classes [128g, 128g + 128),
// redoing the gather and fold; with P <= 4 there is one group.
// Permutations are stored (n, N_f) per submodel, so a warp's lanes (one
// filter each) read neighbouring indices: uint16 while the inputs read
// lie below 65536 (the shared-tile route below), int32 past that (the
// global-gather route).
//
// Design. A persistent block (16 warps; 8 where large K or P need more
// than 128 registers a thread) walks tiles of kRows = 8 rows. The tile
// is transposed into shared memory as one byte per input bit that a
// filter reads (bit r = row r): columns [0, cols) where cols is one past
// the largest perm index, so the tile costs cols bytes whatever the row
// width. The rows reach it through a staging buffer of at most kWindow
// columns a row, copied with cp.async in 16-byte chunks from the 16-byte
// boundary at or below each row's window (any row width, one code path);
// wider inputs take several windows. The copy of the next tile's first
// window overlaps the current tile's work. Each warp takes 32-filter
// chunks of the ensemble's submodels in turn, one filter a lane; for each
// of the filter's n inputs it loads the index once, reads the 8 rows'
// bits with one shared byte load, and folds them into the 8 rows' k
// hashes (a row's bit guards k XORs of the params words). Then k probes a
// row through __ldg (the ULN-L ensemble's slices, 596 KiB, stay in the
// 50 MB L2). Votes: per class a ballot over the 32 filters, kept by the
// lane of that class, popcounted once per row and chunk; each warp's
// int32 counts go to the tile's scores with shared-memory atomics (exact
// in any order), and the block adds the bias and stores the (rows, M)
// scores once. int32 sums are exact, so the scores are bit-equal to the
// plain versions.
//
// Inputs past 65536 columns take the global-gather route, a template
// flag of the same kernel chosen by the wrapper from the perms' reach:
// no tile in shared memory (one byte a column would outgrow the 227 KB a
// block may hold), each gathered index reads its 8 rows' bytes from
// global memory through L1/L2, and the fold, probes and votes are the
// tile route's. It is instantiated with K = 8 only (k at run time).
//
// What bounds it: integer issue and the probes, not bytes (the rows,
// read once, are ~4× below the operation count's time). Removing parts
// on the H100 (scripts/wnn_variants.py, switched by WNN_ABLATE below)
// splits a batch's time between the gather and hash fold and the probes
// and votes: each probe load's 32 lanes read 32 different filters'
// slices. PERF.md keeps the measurements beside the bound.
//
// A hash at or past E (only from malformed params) reads nothing and
// answers 0, as the TPU kernels' one-hot does.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

// Ablations for scripts/wnn_variants.py, 0 in the port's own build:
// 1 every probe reads entry 0 or 1 of its filter's slice (the probes
// without their cache misses), 2 no gather or hash fold (every hash 0),
// 3 no votes (the compiler drops hash and probes too: the tile copy,
// transpose and score stores alone). WNN_WARPS, when set, fixes the
// warps a block.
#ifndef WNN_ABLATE
#define WNN_ABLATE 0
#endif
#ifndef WNN_WARPS
#define WNN_WARPS 0
#endif
// WNN_SUB_BYTE=0 reads 1-byte slices of M <= 4 classes a byte an entry,
// the layout before the sub-byte one (scripts/wnn_variants.py times the
// two on the same rows); 1 in the port's own build.
#ifndef WNN_SUB_BYTE
#define WNN_SUB_BYTE 1
#endif

namespace {

constexpr int kRows = 8;             // rows a tile: one bit each of a byte
constexpr int kWindow = 8192;        // staged columns a row and copy
// Warps per block: 16 where a thread's registers (8 rows × K hashes and
// P response words) stay within the 128 that 512 threads allow, else 8.
template <int K, int P>
__host__ __device__ constexpr int warps_per_block() {
  return WNN_WARPS ? WNN_WARPS : (K <= 4 && P <= 2 ? 16 : 8);
}
constexpr int kMaxHashes = 8;        // kernels/launch.py MAX_HASHES
constexpr int kGroupPlanes = 4;      // kernels/wnn_ensemble.py GROUP_PLANES
constexpr int kTileCols = 65536;     // the shared-tile route: uint16 indices
constexpr unsigned kFullMask = 0xffffffffu;

// One row of the descriptor array (kernels/wnn_ensemble.py DESC_FIELDS);
// offsets are in elements of their arrays.
struct Submodel {
  int num_filters, n, k, entries, perm_off, param_off, slice_off, mask_off,
      chunk_begin;
};

struct SharedLayout {   // byte offsets into the dynamic shared memory
  int trans, stage, slot, scores, total;
};

__host__ __device__ inline int up16(int x) { return (x + 15) & ~15; }

// kernels/wnn_ensemble.py shared_bytes mirrors this: the transposed tile
// (a byte an input column), the staged window (a row's slot holds its
// window and the head below its 16-byte boundary) and the int32 scores
// of the block's m classes (at most 128, one group). The global-gather
// route keeps the scores alone.
__host__ __device__ inline SharedLayout shared_layout(int cols, int m,
                                                      bool global_gather) {
  SharedLayout s;
  s.trans = 0;
  if (global_gather) {
    s.stage = s.slot = s.scores = 0;
  } else {
    s.stage = up16(cols);
    s.slot = up16(min(cols, kWindow)) + 16;
    s.scores = s.stage + kRows * s.slot;
  }
  s.total = s.scores + kRows * m * 4;
  return s;
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Address of column c0 of a row.
__device__ __forceinline__ uintptr_t window_start(const int8_t* bits, int row,
                                                  int row_bits, int c0) {
  return reinterpret_cast<uintptr_t>(bits + static_cast<size_t>(row) *
                                                row_bits + c0);
}

// Copy columns [c0, c0 + w) of rows [r0, r0 + rows) to their slots of
// `stage`, each from the 16-byte boundary at or below its start. A row's
// last chunk may read up to 15 bytes past its window inside the same
// aligned 16 bytes (never another page).
template <int kThreads>
__device__ __forceinline__ void copy_window(unsigned char* stage, int slot,
                                            const int8_t* bits, int r0,
                                            int rows, int row_bits, int c0,
                                            int w) {
  const int per_row = slot >> 4;
  for (int c = threadIdx.x; c < rows * per_row; c += kThreads) {
    const int r = c / per_row, j = c - r * per_row;
    const uintptr_t first = window_start(bits, r0 + r, row_bits, c0);
    const uintptr_t start = first & ~static_cast<uintptr_t>(15);
    if (16 * j < static_cast<int>(first - start) + w)
      cp_async16(stage + r * slot + 16 * j,
                 reinterpret_cast<const void*>(start + 16 * j));
  }
}

// Transpose a staged window: trans[i] bit r = row r has column c0 + i
// set (rows past the batch read as 0).
template <int kThreads>
__device__ __forceinline__ void transpose_window(
    unsigned char* trans, const unsigned char* stage, int slot,
    const int8_t* bits, int r0, int rows, int row_bits, int c0, int w) {
  int head[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
    head[r] = r * slot +
              static_cast<int>(window_start(bits, r0 + r, row_bits, c0) & 15);
  for (int i = threadIdx.x; i < w; i += kThreads) {
    uint32_t v = 0;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      v |= (r < rows && stage[head[r] + i] != 0) ? 1u << r : 0u;
    trans[i] = static_cast<unsigned char>(v);
  }
}

template <class Elem>
__device__ __forceinline__ uint32_t load_word(const Elem* p) {
  return static_cast<uint32_t>(__ldg(p));
}

// P: the class words a block reads (P < 4: the whole slice, one group;
// P = 4: the group blockIdx.y of `planes` words an entry). Global: the
// global-gather route (int32 perms, no tile in shared memory). Sub: the
// sub-byte layout of M <= 4 classes (uint8 elements, P = 1).
template <class Elem, int P, int K, bool Global, bool Sub>
__global__ void __launch_bounds__(32 * warps_per_block<K, P>())
wnn_ensemble_kernel(const int8_t* __restrict__ bits, int batch, int row_bits,
                    int cols, const void* __restrict__ perms,
                    const int32_t* __restrict__ params,
                    const Elem* __restrict__ slices,
                    const Elem* __restrict__ masks,
                    const Submodel* __restrict__ subs, int num_subs,
                    int chunks, const int32_t* __restrict__ bias,
                    int32_t* __restrict__ out, int m, int planes) {
  constexpr int kWarps = warps_per_block<K, P>();
  constexpr int kThreads = 32 * kWarps;
  constexpr bool kGrouped = P == kGroupPlanes;
  // the block's classes: [c_base, c_base + mg), words [w_base, w_base + pg)
  // of an entry of `stride` words; compile-time for P < 4
  const int stride = kGrouped ? planes : P;
  const int w_base = kGrouped ? P * static_cast<int>(blockIdx.y) : 0;
  const int c_base = 32 * w_base;
  const int mg = kGrouped ? min(32 * P, m - c_base) : m;
  const int pg = kGrouped ? min(P, planes - w_base) : P;
  const int mb = min(m, 32 * P);   // the scores' row stride in shared memory
  // the sub-byte layout: log2 of the bits an entry and of the entries a
  // byte, and the entry's bits
  const int sub_log2 = !Sub ? 3 : m <= 1 ? 0 : m <= 2 ? 1 : 2;
  const int epb_log2 = 3 - sub_log2;
  const uint32_t entry_mask = (1u << (1 << sub_log2)) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  const SharedLayout lay = shared_layout(cols, mb, Global);
  unsigned char* trans = smem + lay.trans;
  unsigned char* stage = smem + lay.stage;
  int32_t* s_scores = reinterpret_cast<int32_t*>(smem + lay.scores);
  const int win = min(cols, kWindow);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tiles = (batch + kRows - 1) / kRows;

  int tile = blockIdx.x;
  if constexpr (!Global) {
    if (tile < tiles)
      copy_window<kThreads>(stage, lay.slot, bits, tile * kRows,
                            min(kRows, batch - tile * kRows), row_bits, 0,
                            win);
    cp_async_commit();
  }

  for (; tile < tiles; tile += gridDim.x) {
    const int r0 = tile * kRows;
    const int rows = min(kRows, batch - r0);
    if constexpr (Global) {
      __syncthreads();   // the last tile's scores are stored
      for (int e = threadIdx.x; e < kRows * mb; e += kThreads)
        s_scores[e] = 0;
      __syncthreads();
    } else {
      for (int c0 = 0; c0 < cols; c0 += win) {
        const int w = min(win, cols - c0);
        if (c0 > 0) {   // later windows of wide rows: copied in turn
          copy_window<kThreads>(stage, lay.slot, bits, r0, rows, row_bits,
                                c0, w);
          cp_async_commit();
        }
        cp_async_wait_all();
        __syncthreads();   // the window has landed; the last tile's scores
                           // are stored
        if (c0 == 0)
          for (int e = threadIdx.x; e < kRows * mb; e += kThreads)
            s_scores[e] = 0;
        transpose_window<kThreads>(trans + c0, stage, lay.slot, bits, r0,
                                   rows, row_bits, c0, w);
        __syncthreads();   // `stage` is free; after the last window the
                           // transposed tile is ready
      }
      if (tile + static_cast<int>(gridDim.x) < tiles) {
        const int next = (tile + gridDim.x) * kRows;
        copy_window<kThreads>(stage, lay.slot, bits, next,
                              min(kRows, batch - next), row_bits, 0, win);
      }
      cp_async_commit();
    }

    int32_t acc[kRows][P];   // lane c: class c_base + 32 p + c of row r
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int p = 0; p < P; ++p) acc[r][p] = 0;

    int s = 0;
    for (int g = warp; g < chunks; g += kWarps) {
      while (s + 1 < num_subs && g >= __ldg(&subs[s + 1].chunk_begin)) ++s;
      const Submodel sm = subs[s];
      const int f = (g - sm.chunk_begin) * 32 + lane;
      const bool live = f < sm.num_filters;
      const int n = WNN_ABLATE == 2 ? 0 : sm.n;
      const int k = sm.k;
      const int32_t* prm = params + sm.param_off;

      int32_t h[kRows][K];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < K; ++j) h[r][j] = 0;
      // gather and hash: each index and params word serves 8 rows
#pragma unroll 2
      for (int i = 0; i < n; ++i) {
        int idx = 0;
        if (live) {
          const size_t at = static_cast<size_t>(sm.perm_off) +
                            static_cast<size_t>(i) * sm.num_filters + f;
          idx = Global ? __ldg(static_cast<const int32_t*>(perms) + at)
                       : __ldg(static_cast<const uint16_t*>(perms) + at);
        }
        uint32_t v;
        if constexpr (Global) {   // the 8 rows' bytes of column idx
          v = 0;
          if (live) {
            const int8_t* col = bits + static_cast<size_t>(r0) * row_bits + idx;
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              v |= (r < rows &&
                    __ldg(col + static_cast<size_t>(r) * row_bits) != 0)
                       ? 1u << r : 0u;
          }
        } else {
          v = trans[idx];
        }
        int32_t pj[K];
#pragma unroll
        for (int j = 0; j < K; ++j)
          pj[j] = j < k ? __ldg(prm + j * sm.n + i) : 0;
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          if (v & (1u << r)) {
#pragma unroll
            for (int j = 0; j < K; ++j) h[r][j] ^= pj[j];
          }
        }
      }
      // probe: k loads a row answer every class of the block
      uint32_t mk[P];
      uint32_t any = 0;
#pragma unroll
      for (int p = 0; p < P; ++p) {
        mk[p] = live && p < pg
                    ? load_word(masks + sm.mask_off +
                                static_cast<size_t>(f) * stride + w_base + p)
                    : 0u;
        any |= mk[p];
      }
      uint32_t resp[kRows][P];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int p = 0; p < P; ++p) resp[r][p] = mk[p];
      if (any) {
        const Elem* sl =
            slices + sm.slice_off +
            (Sub ? static_cast<size_t>(f) * (sm.entries >> epb_log2)
                 : static_cast<size_t>(f) * sm.entries * stride + w_base);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int j = 0; j < K; ++j) {
            if (j < k) {
              const int32_t hh = WNN_ABLATE == 1 ? h[r][j] & 1 : h[r][j];
              const bool ok = static_cast<uint32_t>(hh) <
                              static_cast<uint32_t>(sm.entries);
              if constexpr (Sub) {
                resp[r][0] &=
                    ok ? (load_word(sl + (static_cast<uint32_t>(hh) >>
                                          epb_log2)) >>
                          ((hh & ((1 << epb_log2) - 1)) << sub_log2)) &
                             entry_mask
                       : 0u;
              } else {
#pragma unroll
                for (int p = 0; p < P; ++p)
                  resp[r][p] &= ok && p < pg
                                    ? load_word(sl + static_cast<size_t>(hh) *
                                                         stride + p)
                                    : 0u;
              }
            }
          }
        }
      }
      // votes: the ballot of class c's bit over the chunk's 32 filters,
      // kept by lane c
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const int classes = WNN_ABLATE == 3 ? 0 : min(32, mg - 32 * p);
        uint32_t mine[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) mine[r] = 0;
        for (int c = 0; c < classes; ++c) {
          const bool me = lane == c;
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            const uint32_t b = __ballot_sync(kFullMask, (resp[r][p] >> c) & 1u);
            mine[r] = me ? b : mine[r];
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r][p] += __popc(mine[r]);
      }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
      if (lane < mg - 32 * p) {
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (acc[r][p])
            atomicAdd(&s_scores[r * mb + 32 * p + lane], acc[r][p]);
      }
    }
    __syncthreads();   // every warp's votes are in
    if constexpr (kGrouped) {   // the group's columns of the (B, M) scores
      for (int e = threadIdx.x; e < rows * mg; e += kThreads) {
        const int r = e / mg, c = e - r * mg;
        out[static_cast<size_t>(r0 + r) * m + c_base + c] =
            s_scores[r * mb + c] + __ldg(bias + c_base + c);
      }
    } else {
      int32_t* dst = out + static_cast<size_t>(r0) * m;
      for (int e = threadIdx.x; e < rows * m; e += kThreads)
        dst[e] = s_scores[e] + __ldg(bias + e % m);
    }
  }
  if constexpr (!Global) cp_async_wait_all();
}

template <class Elem, int P, int K, bool Global, bool Sub>
int launch_k(const void* bits, int batch, int row_bits, int cols,
             const void* perms, const void* params, const void* slices,
             const void* masks, const void* subs, int num_subs, int chunks,
             const void* bias, void* out, int m, int planes,
             cudaStream_t stream) {
  auto kernel = wnn_ensemble_kernel<Elem, P, K, Global, Sub>;
  constexpr int kThreads = 32 * warps_per_block<K, P>();
  const int smem = shared_layout(cols, std::min(m, 32 * P), Global).total;
  const int groups = (planes + P - 1) / P;   // 1 unless P = 4 and M > 128
  int dev = 0, sms = 0, optin = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (cudaError_t e = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem))
    return static_cast<int>(e);
  int per_sm = 0;
  if (cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem))
    return static_cast<int>(e);
  const int tiles = (batch + kRows - 1) / kRows;
  const int blocks =
      std::min(tiles, std::max(1, std::max(1, per_sm) * sms / groups));
  kernel<<<dim3(blocks, groups), kThreads, smem, stream>>>(
      static_cast<const int8_t*>(bits), batch, row_bits, cols, perms,
      static_cast<const int32_t*>(params), static_cast<const Elem*>(slices),
      static_cast<const Elem*>(masks), static_cast<const Submodel*>(subs),
      num_subs, chunks, static_cast<const int32_t*>(bias),
      static_cast<int32_t*>(out), m, planes);
  return static_cast<int>(cudaGetLastError());
}

template <class Elem, int P, bool Sub = false>
int launch_p(int k, bool global_gather, const void* bits, int batch,
             int row_bits, int cols, const void* perms, const void* params,
             const void* slices, const void* masks, const void* subs,
             int num_subs, int chunks, const void* bias, void* out, int m,
             int planes, cudaStream_t stream) {
#define WNN_LAUNCH_ARGS                                                     \
  bits, batch, row_bits, cols, perms, params, slices, masks, subs,          \
      num_subs, chunks, bias, out, m, planes, stream
  // the global-gather route: one instantiation, k at run time
  if (global_gather)
    return launch_k<Elem, P, kMaxHashes, true, Sub>(WNN_LAUNCH_ARGS);
#define WNN_LAUNCH_K(K) \
  case K:               \
    return launch_k<Elem, P, K, false, Sub>(WNN_LAUNCH_ARGS);
  switch (k) {
    WNN_LAUNCH_K(1) WNN_LAUNCH_K(2) WNN_LAUNCH_K(3) WNN_LAUNCH_K(4)
    WNN_LAUNCH_K(5) WNN_LAUNCH_K(6) WNN_LAUNCH_K(7) WNN_LAUNCH_K(8)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef WNN_LAUNCH_K
#undef WNN_LAUNCH_ARGS
}

}  // namespace

// Plain C entry point (bound with ctypes): scores (B, M) int32 of a whole
// ensemble in one launch. Rows are `row_bits` bytes apart; the perms read
// columns below `cols` (<= row_bits). `index_bytes` names the perms'
// type and the route: 2, uint16 indices (cols <= 65536) through the
// shared tile; 4, int32 indices gathered from global memory.
// `elem_bytes` (1, 2 or 4) and `planes` (P >= 1 words an entry, P > 1
// only with 4-byte words) name the class-slice layout (1 byte and
// M <= 4: the sub-byte layout, 1, 2 or 4 bits an entry; `entries` in
// the descriptor is then the padded count, a multiple of 8 / bits), `max_k` the
// largest submodel k (smaller ones skip the extra hashes). Returns the
// CUDA error of the launch, 0 when the kernel was queued on `stream`.
extern "C" int wnn_ensemble_launch(const void* bits, int batch, int row_bits,
                                   int cols, const void* perms,
                                   const void* params, const void* slices,
                                   const void* masks, const void* subs,
                                   int num_subs, int chunks, const void* bias,
                                   void* out, int m, int elem_bytes,
                                   int planes, int max_k, int index_bytes,
                                   void* stream_ptr) {
  const bool global_gather = index_bytes == 4;
  if (batch < 1 || cols < 1 || cols > row_bits || m < 1 || num_subs < 1 ||
      chunks < 1 || max_k < 1 || max_k > kMaxHashes || planes < 1 ||
      m > 32 * planes || (planes + kGroupPlanes - 1) / kGroupPlanes > 65535 ||
      (planes > 1 && elem_bytes != 4) || m > 8 * elem_bytes * planes ||
      (index_bytes != 2 && index_bytes != 4) ||
      (!global_gather && cols > kTileCols))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
#define WNN_ARGS                                                            \
  max_k, global_gather, bits, batch, row_bits, cols, perms, params, slices, \
      masks, subs, num_subs, chunks, bias, out, m, planes, stream
  if (elem_bytes == 1)
    return WNN_SUB_BYTE && m <= 4 ? launch_p<uint8_t, 1, true>(WNN_ARGS)
                  : launch_p<uint8_t, 1>(WNN_ARGS);
  if (elem_bytes == 2) return launch_p<uint16_t, 1>(WNN_ARGS);
  if (elem_bytes != 4) return static_cast<int>(cudaErrorInvalidValue);
  switch (planes) {
    case 1: return launch_p<uint32_t, 1>(WNN_ARGS);
    case 2: return launch_p<uint32_t, 2>(WNN_ARGS);
    case 3: return launch_p<uint32_t, 3>(WNN_ARGS);
    default: return launch_p<uint32_t, kGroupPlanes>(WNN_ARGS);
  }
#undef WNN_ARGS
}
