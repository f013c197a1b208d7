// GBDT ensemble walks over perfect-heap trees for Hopper (sm_90a): the f64
// walk (K6) and the binned walk (K7), one kernel template for both.
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
//   No fast math and no partial sums: a row's adds are __dadd_rn, one after
//   the other, in tree order, into one accumulator. The walks may run in any
//   order and in parallel; the adds may not be reassociated, so there are no
//   warp shuffles and no per-chunk partials merged later.
//
// The binned walk (K7) is the same walk on bin indices: rows arrive binned
// once per batch on the host, (B, F) row-major uint8 or uint16, with the
// missing value as the sentinel (255 or 65535). Each heap slot is ONE packed
// int32 word, the layout of serve/kernels.py::pack_heap_nodes (and of the
// reference's make_binned_xla): feat (12 bits) | rank1 (16 bits) << 12 |
// dleft (1 bit) << 28; go_left = bin == sentinel ? dleft : bin < rank1. Pad
// slots hold rank1 = 0xFFFF, so every non-missing row keeps going left there
// (a real bin is below the sentinel), and dleft = 1 takes a missing one left
// too. K6's slot is one 16-byte record (split f64, feat i32, dleft i32:
// serve/kernels.py::node_records), so a step of either walk is one node load.
//
// Layout. One block owns a tile of R rows and walks every tree for them in
// chunks of C trees. The tile's rows are staged in shared memory once, so a
// step is one global node load (the node tables, 1 MB at 504 trees x depth 6
// and 16 MB at depth 10, stay in L2) and one shared load. The first
// ceil(R/32) warps fold; the others walk (row, tree) pairs of the chunk, one
// pair a thread (up to four chains in flight a thread past 1024 threads),
// and write each leaf value into shared memory
// (a C x R buffer, two of them). In round k the walkers fill chunk k's buffer
// while fold thread r adds chunk k-1's C values for row r in tree order into
// its register accumulator, which starts at +0.0 and is carried across
// chunks; one barrier a round. The planner (serve/kernels.py::walk_plan)
// picks R, C and the threads: one row a block at serving batches up to the
// SM count (rung 1 is one block walking all trees), enough row tiles to
// cover the SMs at rung 512.
//
// Bound. The least time for the work is the bytes it must move (the row
// elements, inner heap slots and leaves the rows visit, read once; the
// scores written once) over HBM bandwidth: well under a microsecond at
// serving batches. What the bytes miss is the chain each row still has: a
// walk of `depth` dependent node loads, then T dependent f64 adds in order,
// a few microseconds at 504 trees however the walks are spread.

#include <cuda_runtime.h>

#include <atomic>
#include <cstddef>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;  // walk chains in flight a thread

// K6: the 16-byte node record and the f64 compare.
struct F64Nodes {
  using Elem = double;
  using Node = int4;
  const int4* __restrict__ rec;
  __device__ __forceinline__ int4 load(size_t slot) const {
    return __ldg(rec + slot);
  }
  __device__ __forceinline__ bool go_left(int4 n, const double* xr) const {
    const double v = xr[n.z];
    return isnan(v) ? n.w > 0 : v <= __hiloint2double(n.y, n.x);
  }
};

// K7: the packed int32 word and the bin compare.
template <typename BinT>
struct BinnedNodes {
  using Elem = BinT;
  using Node = int;
  const int* __restrict__ packed;
  int sentinel;
  __device__ __forceinline__ int load(size_t slot) const {
    return __ldg(packed + slot);
  }
  __device__ __forceinline__ bool go_left(int pk, const BinT* xr) const {
    const int v = xr[pk & 0xFFF];
    return v == sentinel ? ((pk >> 28) & 1) != 0 : v < ((pk >> 12) & 0xFFFF);
  }
};

// Shared memory: two C x R double buffers of leaf values, then the tile's R
// rows of F elements.
inline size_t smem_bytes(int R, int C, int F, int elem_bytes) {
  const size_t rows = static_cast<size_t>(R) * F * elem_bytes;
  return static_cast<size_t>(16) * C * R + (rows + 15) / 16 * 16;
}

template <class Nodes>
__global__ void __launch_bounds__(kMaxThreads)
walk_kernel(Nodes nodes, const typename Nodes::Elem* __restrict__ x, int B,
            int F, const double* __restrict__ leaf, int T, int depth, int R,
            int C, double* __restrict__ out) {
  using Elem = typename Nodes::Elem;
  using Node = typename Nodes::Node;
  extern __shared__ __align__(16) unsigned char smem[];
  double* vals = reinterpret_cast<double*>(smem);
  Elem* rows = reinterpret_cast<Elem*>(smem + static_cast<size_t>(16) * C * R);
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * R;
  const int nr = min(R, B - row0);
  {
    const Elem* src = x + static_cast<size_t>(row0) * F;
    const int n = nr * F;
    for (int i = tid; i < n; i += blockDim.x) rows[i] = src[i];
  }
  __syncthreads();
  const int H = (2 << depth) - 1;
  const int LL = 1 << depth;
  const int n_fold = (R + 31) / 32 * 32;
  const int n_walk = blockDim.x - n_fold;
  const int n_chunks = (T + C - 1) / C;
  double acc = 0.0;
  for (int k = 0; k <= n_chunks; ++k) {
    if (tid < n_fold) {
      // fold chunk k-1 for row `tid`, in tree order
      if (k > 0 && tid < nr) {
        const int nc = min(C, T - (k - 1) * C);
        const double* v = vals + ((k - 1) & 1) * C * R + tid;
#pragma unroll 8
        for (int c = 0; c < nc; ++c) acc = __dadd_rn(acc, v[c * R]);
      }
    } else if (k < n_chunks) {
      // walk chunk k's (row, tree) pairs p = tl * nr + r
      const int t0 = k * C;
      const int np = min(C, T - t0) * nr;
      double* v = vals + (k & 1) * C * R;
      for (int p0 = tid - n_fold; p0 < np; p0 += kUnroll * n_walk) {
        int r[kUnroll], pos[kUnroll];
        size_t tree[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          // a chain past the chunk repeats its last pair and stores nothing
          const int p = min(p0 + u * n_walk, np - 1);
          const int tl = p / nr;
          r[u] = p - tl * nr;
          tree[u] = static_cast<size_t>(t0 + tl);
          pos[u] = 0;
        }
        for (int d = 0; d < depth; ++d) {
          Node nd[kUnroll];
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            nd[u] = nodes.load(tree[u] * H + pos[u]);
#pragma unroll
          for (int u = 0; u < kUnroll; ++u)
            pos[u] = 2 * pos[u] + 2 -
                     (nodes.go_left(nd[u], rows + r[u] * F) ? 1 : 0);
        }
        double lv[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          lv[u] = __ldg(leaf + tree[u] * LL + pos[u] - (LL - 1));
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int p = p0 + u * n_walk;
          if (p < np) v[(static_cast<int>(tree[u]) - t0) * R + r[u]] = lv[u];
        }
      }
    }
    __syncthreads();
  }
  if (tid < nr) out[row0 + tid] = acc;
}

// Checks the shape, lets the kernel take shared memory past 48 KB (once),
// and launches it; returns the cudaError_t of the launch.
template <class Nodes>
int launch(Nodes nodes, const void* x, int B, int F, const void* leaf, int T,
           int depth, int R, int C, int threads, void* out, void* stream) {
  if (B <= 0) return 0;
  const int n_fold = (R + 31) / 32 * 32;
  if (R < 1 || C < 1 || T < 0 || F < 1 || depth < 1 || depth > 10 ||
      threads % 32 != 0 || threads > kMaxThreads || threads < n_fold + 32) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // the attribute is per device: one bit a device (ids past 63 set it on
  // every launch)
  static std::atomic<unsigned long long> opened{0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (!(opened.load() & bit)) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess) {
      e = cudaFuncSetAttribute(walk_kernel<Nodes>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    }
    if (e != cudaSuccess) return static_cast<int>(e);
    opened.fetch_or(bit);
  }
  using Elem = typename Nodes::Elem;
  const size_t smem = smem_bytes(R, C, F, sizeof(Elem));
  const int blocks = (B + R - 1) / R;
  walk_kernel<Nodes><<<blocks, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      nodes, static_cast<const Elem*>(x), B, F,
      static_cast<const double*>(leaf), T, depth, R, C,
      static_cast<double*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the f64 walk (K6) on `stream` (a cudaStream_t, 0 = the legacy
// default stream) of the calling thread's current CUDA device, which must
// hold the stream and every array. All pointers are device pointers to
// contiguous arrays: x (B, F) f64; nodes (T, H) 16-byte records {split f64,
// feat i32 in [0, F), dleft i32}, 16-byte aligned; leaf (T, LL) f64; out
// (B,) f64; H = 2^(depth+1)-1, LL = 2^depth. The launch shape: R rows a
// block, C trees a chunk, `threads` a block (a multiple of 32, at least
// 32 * ceil(R/32) + 32). Returns the cudaError_t of the launch (0 =
// launched); it does not synchronise.
extern "C" int ytk_heap_walk_f64(const void* x, int B, int F,
                                 const void* nodes, const void* leaf, int T,
                                 int depth, int R, int C, int threads,
                                 void* out, void* stream) {
  return launch(F64Nodes{static_cast<const int4*>(nodes)}, x, B, F, leaf, T,
                depth, R, C, threads, out, stream);
}

// Launches the binned walk (K7) on `stream` of the calling thread's current
// CUDA device. bins (B, F) row-major with bin_bytes 1 (uint8) or 2 (uint16),
// every packed feat id in [0, F); packed (T, H) int32 words; leaf (T, LL)
// f64; out (B,) f64; sentinel 255 or 65535; R, C and threads as for K6.
// Returns the cudaError_t of the launch.
extern "C" int ytk_binned_walk(int bin_bytes, const void* bins, int B, int F,
                               const void* packed, const void* leaf, int T,
                               int depth, int sentinel, int R, int C,
                               int threads, void* out, void* stream) {
  const int* pk = static_cast<const int*>(packed);
  if (bin_bytes == 1) {
    return launch(BinnedNodes<unsigned char>{pk, sentinel}, bins, B, F, leaf,
                  T, depth, R, C, threads, out, stream);
  }
  if (bin_bytes == 2) {
    return launch(BinnedNodes<unsigned short>{pk, sentinel}, bins, B, F, leaf,
                  T, depth, R, C, threads, out, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ytk_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
