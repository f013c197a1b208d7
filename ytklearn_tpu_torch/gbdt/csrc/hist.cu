// GBDT int8 histograms on Hopper: the full-scan kernel (K2) and the gather
// kernel over a compacted row list (K4). The f32/bf16 kernels K1 and K3 are
// in hist_float.cu.
//
// Replaces the JAX package's Pallas kernels
//   K2  ytklearn_tpu/gbdt/hist.py::_hist_pallas_q        (pallas_call :158)
//   K4  ytklearn_tpu/gbdt/hist.py::_hist_gather_pallas_q (pallas_call :319)
// Both compute, for each node slot s of the wave (node_ids[s] = a tree
// node id, negative = pad), each feature f and bin b:
//   out[s, f, b, :] = sum over rows r with pos[r] == node_ids[s] and
//                     bin(f, r) == b of (g[r], h[r], 1)
// so a duplicated id gets the same sums in each of its slots, as the
// reference's one-hot P = (node_ids == pos) gives them.
// g/h are f32 integers in [-127, 127] (the caller's quantized gradients)
// summed in int32: int32 addition is associative, so any order and any
// atomics give the reference's exact sums.
//
// The TPU kernels build node and bin one-hots and run them through the MXU;
// a GPU needs none of that. Here every row adds its (g, h, 1) straight into
// the bins of its node:
//   * pos -> slot: a lookup table over tree node ids in shared memory, built
//     per block from node_ids (lowest slot wins a duplicate id), so a row
//     costs one shared load and no scan of the wave's ids. After the row
//     pass the same space holds each slot's next duplicate (the wave's id
//     pairs compared once per block, spread over its threads), and the
//     flush adds a counter of slot s to s and to each later slot of its
//     id. A wave whose ids do not repeat (the engine's) pays that compare
//     and a block-wide flag: nothing per row or per counter.
//   * privatisation: a block owns a tile of ng slots x fg features of the
//     (N, F, B, 3) histogram in shared memory and accumulates with shared
//     atomics (int32), then flushes the nonzero counters to global memory
//     with atomicAdd. At the root wave (N = 1) every row hits the same
//     F x B bins: plain global atomics would contend there.
//   * grid: x = tile (fastest, so the blocks of one row chunk run together
//     and share its pos/bins reads through L2), y = row chunk.
// Bound: the bytes of bins, pos, g and h read once and the histogram
// written once (memory), unless shared-atomic conflicts on skewed bins
// dominate. A wave of many slots leaves few rows to each tile, so a warp
// holds one or two rows of its tile at a time: their bins loads are
// issued eight at a time, not one after another. The full-scan kernels read
// bins (F, n) feature-major, so a warp's loads of one feature are
// coalesced; the gather kernels read row-major (n_rows, F) bins through the
// index list (one row's features are contiguous).
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/hist.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int LOADS_IN_FLIGHT = 8;

// value modes: the int8-quantized kernels (K2/K4)
enum ValMode { VAL_Q = 0 };

template <int MODE> struct Acc { typedef float T; };
template <> struct Acc<VAL_Q> { typedef int32_t T; };

template <int MODE>
__device__ __forceinline__ typename Acc<MODE>::T to_acc(float v) {
  if constexpr (MODE == VAL_Q) {
    return (int32_t)v;  // f32 integers: truncation is exact
  } else {
    return v;
  }
}

template <typename BinT, bool GATHER, int MODE>
__global__ void hist_kernel(
    const BinT* __restrict__ bins,      // full scan: (F, n) ; gather: (n_rows, F)
    long long n_bins_rows,              // full scan: n ; gather: n_rows
    const int32_t* __restrict__ idx,    // gather: (n,) row ids ; else unused
    const int32_t* __restrict__ pos,    // (n,) node id per row, -1 = dead
    const float* __restrict__ g,        // (n,)
    const float* __restrict__ h,        // (n,)
    long long n,                        // rows scanned (full scan: n ; gather: R)
    const int32_t* __restrict__ node_ids, int N,
    int M,                              // node ids < M (lookup table size)
    int L,                              // lookup space: max(M, N), padded to 4
    int F, int B, int fg, int ng, int n_ftiles,
    long long rows_per_chunk,
    typename Acc<MODE>::T* __restrict__ out)  // (N, F, B, 3), zeroed by the caller
{
  typedef typename Acc<MODE>::T AccT;
  extern __shared__ int32_t smem[];
  int32_t* lut = smem;                                 // M entries, then N
  AccT* hist = (AccT*)(smem + L);                      // ng * fg * B * 3

  const int ft = blockIdx.x % n_ftiles;
  const int nt = blockIdx.x / n_ftiles;
  const int f0 = ft * fg;
  const int s0 = nt * ng;
  const int fcnt = min(fg, F - f0);
  const int scnt = min(ng, N - s0);
  const int tile_len = ng * fg * B * 3;

  for (int i = threadIdx.x; i < M; i += blockDim.x) lut[i] = INT_MAX;
  for (int i = threadIdx.x; i < tile_len; i += blockDim.x) hist[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int id = node_ids[i];
    if (id >= 0 && id < M) atomicMin(&lut[id], i);
  }
  __syncthreads();

  const AccT one = 1;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const int p = pos[r];
    if (p < 0 || p >= M) continue;
    const int s = lut[p] - s0;  // INT_MAX - s0 for a node outside the wave
    if ((unsigned)s >= (unsigned)scnt) continue;
    long long row = r;
    if (GATHER) {
      row = idx[r];
      if (row < 0 || row >= n_bins_rows) continue;
    }
    const AccT gv = to_acc<MODE>(g[r]);
    const AccT hv = to_acc<MODE>(h[r]);
    AccT* hs = hist + (size_t)s * fg * B * 3;
    // a row's bins are LOADS_IN_FLIGHT independent global loads issued
    // before their atomics: one row's features do not wait on each other
    for (int fb = 0; fb < fcnt; fb += LOADS_IN_FLIGHT) {
      int b[LOADS_IN_FLIGHT];
#pragma unroll
      for (int k = 0; k < LOADS_IN_FLIGHT; ++k) {
        const int f = f0 + fb + k;
        b[k] = fb + k >= fcnt ? -1
             : GATHER ? (int)bins[row * F + f]
                      : (int)bins[(long long)f * n_bins_rows + row];
      }
#pragma unroll
      for (int k = 0; k < LOADS_IN_FLIGHT; ++k) {
        if ((unsigned)b[k] >= (unsigned)B) continue;
        AccT* c = hs + ((size_t)(fb + k) * B + b[k]) * 3;
        atomicAdd(c, gv);
        atomicAdd(c + 1, hv);
        atomicAdd(c + 2, one);
      }
    }
  }
  __syncthreads();

  // the lookup is done with: its space now holds each slot's next slot of
  // the same id (INT_MAX: none), from all (i, j > i) pairs of the wave's
  // ids spread over the block. Only an id in [0, M) has rows
  int32_t* next_dup = lut;
  for (int i = threadIdx.x; i < N; i += blockDim.x) next_dup[i] = INT_MAX;
  __syncthreads();
  int dup = 0;
  // a 32-bit pair index: shared memory caps N near 58k, so N * N < 2^32,
  // and a 64-bit division here cost the full-scan int8 kernel a quarter
  // of its time on the card
  const unsigned n_pairs = (unsigned)N * (unsigned)N;
  for (unsigned p = threadIdx.x; p < n_pairs; p += blockDim.x) {
    const int i = (int)(p / (unsigned)N);
    const int j = (int)(p - (unsigned)i * (unsigned)N);
    if (j <= i) continue;
    const int id = node_ids[i];
    if (id >= 0 && id < M && node_ids[j] == id) {
      atomicMin(&next_dup[i], j);
      dup = 1;
    }
  }
  const bool any_dup = __syncthreads_or(dup);

  // flush: a counter that is zero (+0 or -0) adds nothing to the zeroed
  // output, so it is skipped
  const int per_slot = fg * B * 3;
  const int run = B * 3;
  for (int i = threadIdx.x; i < scnt * per_slot; i += blockDim.x) {
    const AccT v = hist[i];
    if (v == 0) continue;
    const int sl = i / per_slot;
    const int rem = i - sl * per_slot;
    const int fl = rem / run;
    if (fl >= fcnt) continue;
    const int within = rem - fl * run;
    const size_t col = (size_t)(f0 + fl) * run + within;
    atomicAdd(out + (size_t)(s0 + sl) * F * run + col, v);
    if (any_dup) {
      for (int s = next_dup[s0 + sl]; s != INT_MAX; s = next_dup[s])
        atomicAdd(out + (size_t)s * F * run + col, v);
    }
  }
}

template <typename BinT, bool GATHER, int MODE>
int launch(const void* bins, long long n_bins_rows, const int32_t* idx,
           const int32_t* pos, const float* g, const float* h, long long n,
           const int32_t* node_ids, int N, int M, int F, int B, int fg,
           int ng, int n_ftiles, int n_tiles, int n_chunks,
           long long rows_per_chunk, int threads, int smem_bytes,
           void* out, cudaStream_t stream) {
  const int L = ((M > N ? M : N) + 3) & ~3;
  auto kern = hist_kernel<BinT, GATHER, MODE>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, n_chunks);
  kern<<<grid, threads, smem_bytes, stream>>>(
      (const BinT*)bins, n_bins_rows, idx, pos, g, h, n, node_ids, N, M, L,
      F, B, fg, ng, n_ftiles, rows_per_chunk,
      (typename Acc<MODE>::T*)out);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch(int bin_bytes, int gather, const void* bins,
             long long n_bins_rows, const int32_t* idx, const int32_t* pos,
             const float* g, const float* h, long long n,
             const int32_t* node_ids, int N, int M, int F, int B, int fg,
             int ng, int n_ftiles, int n_tiles, int n_chunks,
             long long rows_per_chunk, int threads, int smem_bytes,
             void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define YTK_ARGS bins, n_bins_rows, idx, pos, g, h, n, node_ids, N, M, F, \
    B, fg, ng, n_ftiles, n_tiles, n_chunks, rows_per_chunk, threads,      \
    smem_bytes, out, st
  if (bin_bytes == 1) {
    return gather ? launch<uint8_t, true, MODE>(YTK_ARGS)
                  : launch<uint8_t, false, MODE>(YTK_ARGS);
  }
  if (bin_bytes == 4) {
    return gather ? launch<int32_t, true, MODE>(YTK_ARGS)
                  : launch<int32_t, false, MODE>(YTK_ARGS);
  }
#undef YTK_ARGS
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// int8 kernels: bin_bytes 1 (uint8 bins) or 4 (int32 bins); gather 0 = K2,
// 1 = K4; out (N, F, B, 3) int32. Returns the cudaError_t of the launch
// (0 = launched).
int ytk_hist_q(int bin_bytes, int gather, const void* bins,
               long long n_bins_rows, const int32_t* idx, const int32_t* pos,
               const float* gq, const float* hq, long long n,
               const int32_t* node_ids, int N, int M, int F, int B, int fg,
               int ng, int n_ftiles, int n_tiles, int n_chunks,
               long long rows_per_chunk, int threads, int smem_bytes,
               int32_t* out, void* stream) {
  return dispatch<VAL_Q>(bin_bytes, gather, bins, n_bins_rows, idx, pos, gq,
                         hq, n, node_ids, N, M, F, B, fg, ng, n_ftiles,
                         n_tiles, n_chunks, rows_per_chunk, threads,
                         smem_bytes, out, stream);
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
