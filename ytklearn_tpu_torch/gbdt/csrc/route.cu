// Wave routing on Hopper (K5): move every row of a split node to its child.
//
// Replaces the JAX package's Pallas kernel
//   K5  ytklearn_tpu/gbdt/route.py::_route_pallas (pallas_call :63)
// For each row r with p = pos[r] (the position BEFORE this wave) and each
// wave slot i in order, if valid[i] and p == nid[i]:
//   b = bins[feat[i], r]
//   pos[r] = (b > slot[i] && b >= lo[i] && b <= hi[i]) ? rch[i] : lch[i]
// A later matching slot wins, as in the Pallas kernel (the engine's wave
// holds distinct node ids, so at most one slot matches).
//
// One thread per row: pos is read once and written once, the 8 x NW slot
// table sits in shared memory (every thread of a warp reads the same
// entry: a broadcast), and the bin of the matching slot's feature is the
// only other read. Bound: memory (8 bytes of pos per row, plus one bin
// byte per row of each distinct split feature).
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/route.py.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename BinT>
__global__ void route_kernel(const BinT* __restrict__ bins,  // (F, n)
                             long long n, int F,
                             const int32_t* pos_in,          // (n,)
                             const int32_t* __restrict__ tab,  // (8, NW)
                             int NW,
                             int32_t* pos_out) {             // (n,), may alias
  extern __shared__ int32_t st[];
  for (int i = threadIdx.x; i < 8 * NW; i += blockDim.x) st[i] = tab[i];
  __syncthreads();
  const int32_t* valid = st;
  const int32_t* nid = st + NW;
  const int32_t* feat = st + 2 * NW;
  const int32_t* slot = st + 3 * NW;
  const int32_t* lch = st + 4 * NW;
  const int32_t* rch = st + 5 * NW;
  const int32_t* lo = st + 6 * NW;
  const int32_t* hi = st + 7 * NW;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x; r < n;
       r += stride) {
    const int p = pos_in[r];
    int newp = p;
    for (int i = 0; i < NW; ++i) {
      if (nid[i] != p || valid[i] == 0) continue;
      // the reference clamps the feature into range (dynamic_slice)
      const int f = min(max(feat[i], 0), F - 1);
      const int b = (int)bins[(long long)f * n + r];
      const bool right = b > slot[i] && b >= lo[i] && b <= hi[i];
      newp = right ? rch[i] : lch[i];
    }
    pos_out[r] = newp;
  }
}

template <typename BinT>
int launch(const void* bins, long long n, int F, const int32_t* pos_in,
           const int32_t* tab, int NW, int32_t* pos_out, int blocks,
           int threads, cudaStream_t stream) {
  const int smem = 8 * NW * (int)sizeof(int32_t);
  auto kern = route_kernel<BinT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, threads, smem, stream>>>((const BinT*)bins, n, F, pos_in,
                                          tab, NW, pos_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_bytes: 1 (uint8 bins) or 4 (int32 bins). Returns the cudaError_t of
// the launch (0 = launched).
int ytk_route(int bin_bytes, const void* bins, long long n, int F,
              const int32_t* pos_in, const int32_t* tab, int NW,
              int32_t* pos_out, int blocks, int threads, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, n, F, pos_in, tab, NW, pos_out, blocks,
                           threads, st);
  if (bin_bytes == 4)
    return launch<int32_t>(bins, n, F, pos_in, tab, NW, pos_out, blocks,
                           threads, st);
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
