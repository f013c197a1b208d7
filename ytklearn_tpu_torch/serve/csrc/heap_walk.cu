// GBDT ensemble walks over perfect-heap trees for Hopper (sm_90a): the f64
// walk (K6) and the binned walk (K7).
//
// Replace the TPU kernel ytklearn_tpu/serve/kernels.py::_walk_block in its
// float mode (K6, reached through fused_scores -> _fused_call, pallas_call at
// kernels.py:405) and in its binned mode (K7, binned_scores_pallas :439, the
// same pallas_call). They compute the same function, not the same blocks: the
// Pallas body resolves every (tree, depth) step with one-hot select-reduces
// because Mosaic has no gathers; a CUDA thread just indexes.
//
// Semantics (bit for bit those of the JAX fused and stacked rungs and of the
// host tree walk):
//   - x is (B, F) row-major f64, NaN = missing;
//   - per tree, `depth` steps of pos = 2*pos + 2 - go_left, where
//     go_left = isnan(v) ? dleft[pos] : v <= split[pos];
//   - the row's sum starts at +0.0 and adds leaf[t, pos - (LL-1)] for the
//     padded trees in ascending order (a strict left fold). Pad trees hold
//     -0.0 leaves, a no-op on any sum that started at +0.0; pad slots hold
//     split=+inf, dleft=1, feat=0, so every row goes left there.
//   No fast math, no reordered or tree-parallel sums: the adds are
//   __dadd_rn, one after the other.
//
// The binned walk (K7) is the same walk on bin indices: rows arrive binned
// once per batch on the host, (B, F) row-major uint8 or uint16, with the
// missing value as the sentinel (255 or 65535). Each heap slot is ONE packed
// int32 word, the layout of serve/kernels.py::pack_heap_nodes (and of the
// reference's make_binned_xla): feat (12 bits) | rank1 (16 bits) << 12 |
// dleft (1 bit) << 28, so a step costs one node load where K6 takes three;
// go_left = bin == sentinel ? dleft : bin < rank1. Pad slots hold rank1 =
// 0xFFFF, so every non-missing row keeps going left there (a real bin is
// below the sentinel), and dleft = 1 takes a missing one left too. The fold
// is K6's: +0.0, then __dadd_rn over the padded trees in ascending order.
// Its bytes are the bins (1 or 2 B each) where K6 reads 8-byte values.
//
// Layout and bound: one thread per row walks every tree; the node arrays are
// read from global memory through the read-only path, and every thread of a
// block reads the same tree at once, so they stay in L1. The least time for
// the work is the bytes it must move (the X elements, inner heap slots and
// leaves the rows visit, read once; the scores written once) over HBM
// bandwidth: the last heap level is read only as leaves. A thread's walk is a
// chain of dependent loads, so at serving batch sizes this first version is
// bound by load latency across few SMs, not by bytes. Spreading the walks
// over trees and folding in a second pass is the next step (see PERF.md).

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
heap_walk_f64_kernel(const double* __restrict__ x, int B, int F,
                     const int* __restrict__ feat,
                     const double* __restrict__ split,
                     const int* __restrict__ dleft,
                     const double* __restrict__ leaf, int T, int depth,
                     double* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  const int H = (2 << depth) - 1;
  const int LL = 1 << depth;
  const double* xr = x + static_cast<size_t>(row) * F;
  double acc = 0.0;
  for (int t = 0; t < T; ++t) {
    const size_t base = static_cast<size_t>(t) * H;
    int pos = 0;
    for (int d = 0; d < depth; ++d) {
      const double v = xr[__ldg(feat + base + pos)];
      const bool go_left =
          isnan(v) ? (__ldg(dleft + base + pos) > 0)
                   : (v <= __ldg(split + base + pos));
      pos = 2 * pos + 2 - (go_left ? 1 : 0);
    }
    acc = __dadd_rn(acc, __ldg(leaf + static_cast<size_t>(t) * LL + pos - (LL - 1)));
  }
  out[row] = acc;
}

template <typename BinT>
__global__ void __launch_bounds__(kThreads)
binned_walk_kernel(const BinT* __restrict__ bins, int B, int F,
                   const int* __restrict__ packed,
                   const double* __restrict__ leaf, int T, int depth,
                   int sentinel, double* __restrict__ out) {
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= B) return;
  const int H = (2 << depth) - 1;
  const int LL = 1 << depth;
  const BinT* br = bins + static_cast<size_t>(row) * F;
  double acc = 0.0;
  for (int t = 0; t < T; ++t) {
    const size_t base = static_cast<size_t>(t) * H;
    int pos = 0;
    for (int d = 0; d < depth; ++d) {
      const int pk = __ldg(packed + base + pos);
      const int v = br[pk & 0xFFF];
      const bool go_left =
          v == sentinel ? ((pk >> 28) & 1) != 0 : v < ((pk >> 12) & 0xFFFF);
      pos = 2 * pos + 2 - (go_left ? 1 : 0);
    }
    acc = __dadd_rn(acc, __ldg(leaf + static_cast<size_t>(t) * LL + pos - (LL - 1)));
  }
  out[row] = acc;
}

}  // namespace

// Launches the walk on `stream` (a cudaStream_t, 0 = the legacy default
// stream) of the calling thread's current CUDA device, which must hold the
// stream and every array. All pointers are device pointers to contiguous
// arrays: x (B, F) f64, feat/dleft (T, H) i32 with every feat id in [0, F),
// split (T, H) f64, leaf (T, LL) f64, out (B,) f64, with H = 2^(depth+1)-1
// and LL = 2^depth. Returns the cudaError_t of the launch (0 = launched); it
// does not synchronise.
extern "C" int ytk_heap_walk_f64(const void* x, int B, int F,
                                 const void* feat, const void* split,
                                 const void* dleft, const void* leaf, int T,
                                 int depth, void* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  heap_walk_f64_kernel<<<blocks, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), B, F, static_cast<const int*>(feat),
      static_cast<const double*>(split), static_cast<const int*>(dleft),
      static_cast<const double*>(leaf), T, depth, static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Launches the binned walk on `stream` of the calling thread's current CUDA
// device. bins (B, F) row-major with bin_bytes 1 (uint8) or 2 (uint16), every
// packed feat id in [0, F); packed (T, H) int32 words; leaf (T, LL) f64; out
// (B,) f64; sentinel 255 or 65535. Returns the cudaError_t of the launch.
extern "C" int ytk_binned_walk(int bin_bytes, const void* bins, int B, int F,
                               const void* packed, const void* leaf, int T,
                               int depth, int sentinel, void* out,
                               void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + kThreads - 1) / kThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* pk = static_cast<const int*>(packed);
  const double* lf = static_cast<const double*>(leaf);
  double* o = static_cast<double*>(out);
  if (bin_bytes == 1) {
    binned_walk_kernel<unsigned char><<<blocks, kThreads, 0, st>>>(
        static_cast<const unsigned char*>(bins), B, F, pk, lf, T, depth,
        sentinel, o);
  } else if (bin_bytes == 2) {
    binned_walk_kernel<unsigned short><<<blocks, kThreads, 0, st>>>(
        static_cast<const unsigned short*>(bins), B, F, pk, lf, T, depth,
        sentinel, o);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ytk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
