// int8 GBDT histograms on Hopper: the full-scan kernel (K2) and the
// gather kernel over a compacted row list (K4).
//
// Replaces the JAX package's Pallas kernels
//   K2  ytklearn_tpu/gbdt/hist.py::_hist_pallas_q        (pallas_call :158)
//   K4  ytklearn_tpu/gbdt/hist.py::_hist_gather_pallas_q (pallas_call :319)
// Both compute, for each node slot s of the wave (node_ids[s] = a tree node
// id, negative = pad), each feature f and bin b:
//   out[s, f, b, :] = sum over rows r with pos[r] == node_ids[s] and
//                     bin(f, r) == b of (gq[r], hq[r], 1)
// with gq/hq f32 integers in [-127, 127] (the caller's quantized gradients)
// and int32 sums. Int32 addition is associative, so any order and any
// atomics give the reference's exact sums.
//
// The TPU kernels build node and bin one-hots and run them through the MXU;
// a GPU needs none of that. Here every row adds its (g, h, 1) straight into
// the bins of its node:
//   * pos -> slot: a lookup table over tree node ids in shared memory, built
//     per block from node_ids (lowest slot wins a duplicate id), so a row
//     costs one shared load and no scan of the wave's ids.
//   * privatisation: a block owns a tile of ng slots x fg features of the
//     (N, F, B, 3) histogram in shared memory and accumulates with shared
//     atomics, then flushes the nonzero counters to global memory with
//     atomicAdd. At the root wave (N = 1) every row hits the same F x B
//     bins: plain global atomics would contend there.
//   * grid: x = tile (fastest, so the blocks of one row chunk run together
//     and share its pos/bins reads through L2), y = row chunk.
// Bound: the bytes of bins, pos, gq and hq read once and the histogram
// written once (memory), unless shared-atomic conflicts on skewed bins
// dominate. A wave of many slots leaves few rows to each tile, so a warp
// holds one or two rows of its tile at a time: their bins loads are
// issued eight at a time, not one after another. K2 reads bins (F, n)
// feature-major, so a warp's loads of one feature are coalesced; K4 reads
// row-major (n_rows, F) bins through the index list (one row's features
// are contiguous).
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/hist.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int LOADS_IN_FLIGHT = 8;

template <typename BinT, bool GATHER>
__global__ void hist_q_kernel(
    const BinT* __restrict__ bins,      // K2: (F, n) ; K4: (n_rows, F)
    long long n_bins_rows,              // K2: n ; K4: n_rows (bounds idx)
    const int32_t* __restrict__ idx,    // K4: (n,) row ids ; K2: unused
    const int32_t* __restrict__ pos,    // (n,) node id per row, -1 = dead
    const float* __restrict__ gq,       // (n,)
    const float* __restrict__ hq,       // (n,)
    long long n,                        // rows scanned (K2: n ; K4: R)
    const int32_t* __restrict__ node_ids, int N,
    int M,                              // node ids < M (lookup table size)
    int F, int B, int fg, int ng, int n_ftiles,
    long long rows_per_chunk,
    int32_t* __restrict__ out)          // (N, F, B, 3), zeroed by the caller
{
  extern __shared__ int32_t smem[];
  int32_t* lut = smem;                       // M entries
  int32_t* hist = smem + ((M + 3) & ~3);     // ng * fg * B * 3 entries

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
    const int gv = (int)gq[r];  // f32 integers: truncation is exact
    const int hv = (int)hq[r];
    int32_t* hs = hist + (size_t)s * fg * B * 3;
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
        int32_t* c = hs + ((size_t)(fb + k) * B + b[k]) * 3;
        atomicAdd(c, gv);
        atomicAdd(c + 1, hv);
        atomicAdd(c + 2, 1);
      }
    }
  }
  __syncthreads();

  const int per_slot = fg * B * 3;
  const int run = B * 3;
  for (int i = threadIdx.x; i < scnt * per_slot; i += blockDim.x) {
    const int v = hist[i];
    if (v == 0) continue;
    const int sl = i / per_slot;
    const int rem = i - sl * per_slot;
    const int fl = rem / run;
    if (fl >= fcnt) continue;
    const int within = rem - fl * run;
    atomicAdd(out + ((size_t)(s0 + sl) * F + (f0 + fl)) * run + within, v);
  }
}

template <typename BinT, bool GATHER>
int launch(const void* bins, long long n_bins_rows, const int32_t* idx,
           const int32_t* pos, const float* gq, const float* hq, long long n,
           const int32_t* node_ids, int N, int M, int F, int B, int fg,
           int ng, int n_ftiles, int n_tiles, int n_chunks,
           long long rows_per_chunk, int threads, int smem_bytes,
           int32_t* out, cudaStream_t stream) {
  auto kern = hist_q_kernel<BinT, GATHER>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_tiles, n_chunks);
  kern<<<grid, threads, smem_bytes, stream>>>(
      (const BinT*)bins, n_bins_rows, idx, pos, gq, hq, n, node_ids, N, M, F,
      B, fg, ng, n_ftiles, rows_per_chunk, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_bytes: 1 (uint8 bins) or 4 (int32 bins); gather: 0 = K2, 1 = K4.
// Returns the cudaError_t of the launch (0 = launched).
int ytk_hist_q(int bin_bytes, int gather, const void* bins,
               long long n_bins_rows, const int32_t* idx, const int32_t* pos,
               const float* gq, const float* hq, long long n,
               const int32_t* node_ids, int N, int M, int F, int B, int fg,
               int ng, int n_ftiles, int n_tiles, int n_chunks,
               long long rows_per_chunk, int threads, int smem_bytes,
               int32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
#define YTK_ARGS bins, n_bins_rows, idx, pos, gq, hq, n, node_ids, N, M, F, \
    B, fg, ng, n_ftiles, n_tiles, n_chunks, rows_per_chunk, threads,        \
    smem_bytes, out, st
  if (bin_bytes == 1) {
    return gather ? launch<uint8_t, true>(YTK_ARGS)
                  : launch<uint8_t, false>(YTK_ARGS);
  }
  if (bin_bytes == 4) {
    return gather ? launch<int32_t, true>(YTK_ARGS)
                  : launch<int32_t, false>(YTK_ARGS);
  }
#undef YTK_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
