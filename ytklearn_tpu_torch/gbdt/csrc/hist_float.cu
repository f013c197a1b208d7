// GBDT f32/bf16 histograms on Hopper: the full scan (K1) and the gather
// over a compacted row list (K3).
//
// Replaces the JAX package's Pallas kernels
//   K1  ytklearn_tpu/gbdt/hist.py::_hist_pallas          (pallas_call :93)
//   K3  ytklearn_tpu/gbdt/hist.py::_hist_gather_pallas   (pallas_call :319)
// Both compute, for each node slot s of the wave (node_ids[s] = a tree node
// id, negative = pad), each feature f and bin b:
//   out[s, f, b, :] = sum over rows r with pos[r] == node_ids[s] and
//                     bin(f, r) == b of (g[r], h[r], 1)
// so a duplicated id gets the same sums in each of its slots, as the
// reference's one-hot P = (node_ids == pos) gives them. In bf16 mode each g
// and h is first rounded to bf16 (round to nearest even, as
// jnp.astype(bfloat16) does, hist.py:74-76 and :408-409) and widened back;
// the sums stay f32. Float sums depend on their order and the atomics below
// add in an order that changes from run to run, so the kernels agree with
// the reference and with themselves to a tolerance; the count channel is
// exact (an int32 sum in shared memory, an f32 sum of ones below 2^24 rows
// a bin in global memory).
//
// The full scan reads bins feature-major (F, n); the gather reads the
// compacted rows' bins row-major (n_rows, F) through idx, with pos_g/g/h
// indexed by the gathered position r. Every launch adds into an
// (N, F, B, 4) f32 scratch (g, h, count, unused), zeroed by the caller and
// small enough to stay in L2, with 16-byte vector atomics
// (red.global.add.v4.f32, sm_90); a row adds only into the lowest slot of
// its id, and a finish kernel writes the (N, F, B, 3) output, a duplicated
// id's later slots copied from its first. Three kinds of launch:
//   * tile (K1 only): a block owns a tile of ng slots x fg features x a
//     range of bt bins of the histogram in shared memory, adds one chunk of
//     rows, then adds its nonzero bins to the scratch; one wave of resident
//     blocks walks the tiles x chunks. A tile's bins are all B (nb = 1)
//     unless one slot x feature of B bins outgrows shared memory; then B is
//     cut into nb ranges of bt bins, each tile one range, and a row whose
//     bin falls outside the tile's range adds nothing there. g and h take f32 shared atomics (on sm_90 each is a
//     compare-and-store loop, ATOMS.CAST.SPIN; one 64-bit CAS for the pair
//     measured 2-4x slower), the count an int32 atomic. The planner takes
//     all the wave's slots and few features a tile (bins feature-major: a
//     thread's four rows of a feature are one word, a warp's are
//     contiguous). Every tile is one more pass over the rows' positions and
//     gradients: the kind for waves whose histogram is one tile (the root).
//   * red: no tile. Each in-wave row adds (g, h, 1, 0) for each feature
//     with one vector atomic straight into the scratch; every row's
//     position, g, h and bins are read once, whatever the wave's width,
//     and the L2's rate of vector atomics bounds it, so its time follows
//     the rows in the wave. The kind for every K3 launch (a warp-per-row
//     tile of a few slots over all features measured no faster at the
//     fused rungs' sizes).
//   * auto (K1 with more than one tile): a tile costs a pass over every
//     row per tile, red a vector atomic per in-wave row and feature, and
//     which is less depends on how many rows the wave holds, which the
//     host does not know. A count kernel adds them up on the device; then
//     the tile kernel and the red kernel are both launched and the one the
//     count does not pick returns at once.
// What bounds it: the bytes of bins, pos, g and h read once and the
// histogram written once; on the card, first the atomics and the latency
// of each row's chain (position -> lookup -> g/h/bins -> atomics). So a
// thread takes four consecutive rows at a time (positions as one int4, g
// and h as float4s, four rows' bins of a feature as one 32-bit word, int32
// bins as an int4, a gathered row's uint8 bins as 32-bit words) and issues
// a batch of loads before the first atomic; rows that are not 16-byte
// aligned, and the ragged tail of a chunk, take the one-row path.
//
// The node lookup (tree node id -> lowest slot) is of one of two kinds
// (hist.py's lookup_kind): built in each block's shared memory over all M
// ids, beside the tile (GLUT false: every tree whose lookup fits there with
// one slot x feature tile), or, for larger trees, one int32 table of M
// entries in global memory (GLUT true) that the lookup kernel, one block
// launched first, fills and marks; every block then reads it through L2.
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/hist.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

// the full scan loads this many features' bin words before their atomics
constexpr int FEAT_BATCH = 4;
// the gather loads this many of a row's bin words (or bins) before theirs
constexpr int WORD_BATCH = 8;

__device__ __forceinline__ float round_val(float v, int bf16) {
  return bf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

template <int V>
__device__ __forceinline__ void load_i(const int32_t* p, int (&o)[V]) {
  if constexpr (V == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

template <int V>
__device__ __forceinline__ void load_f(const float* p, float (&o)[V]) {
  if constexpr (V == 4) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  } else {
    o[0] = __ldg(p);
  }
}

// V consecutive rows' bins of one feature (feature-major bins)
template <typename BinT, int V> struct ScanBins;
template <> struct ScanBins<uint8_t, 4> {
  uint32_t w;
  __device__ __forceinline__ void load(const uint8_t* p) {
    w = __ldg(reinterpret_cast<const unsigned int*>(p));
  }
  __device__ __forceinline__ int get(int j) const {
    return (int)((w >> (8 * j)) & 0xFFu);
  }
};
template <> struct ScanBins<int32_t, 4> {
  int4 w;
  __device__ __forceinline__ void load(const int32_t* p) {
    w = __ldg(reinterpret_cast<const int4*>(p));
  }
  __device__ __forceinline__ int get(int j) const {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
};
template <typename BinT> struct ScanBins<BinT, 1> {
  int w;
  __device__ __forceinline__ void load(const BinT* p) { w = (int)__ldg(p); }
  __device__ __forceinline__ int get(int) const { return w; }
};

// Where a (slot, feature, bin) update goes: a tile in shared memory (three
// words a bin: g and h as f32, the count as int32; a stride of 3 words
// spreads a warp's random bins over all 32 banks) or the (N, F, B, 4)
// scratch.
template <bool RED> struct Sink;
template <> struct Sink<false> {
  float* hist;  // [ng][fg][B][3]
  __device__ __forceinline__ void add(size_t cell, float gv, float hv) const {
    float* c = hist + cell * 3;
    atomicAdd(c, gv);
    atomicAdd(c + 1, hv);
    atomicAdd(reinterpret_cast<int*>(c + 2), 1);
  }
};
template <> struct Sink<true> {
  float4* acc;  // [N][F][B]
  __device__ __forceinline__ void add(size_t cell, float gv, float hv) const {
    atomicAdd(acc + cell, make_float4(gv, hv, 1.f, 0.f));
  }
};

// The part of the histogram a block adds into: slots [s0, s0 + scnt),
// features [f0, f0 + fcnt) and bins [b0, b0 + bcnt) of a tile fg features
// x bt bins wide (red: everything, b0 = 0 and bcnt = bt = B).
struct Part {
  int s0, scnt, f0, fcnt, fg, b0, bcnt, bt;
};

// One group of V rows starting at r (the gathered positions r.. for the
// gather): positions -> slots through the lookup, then g, h and the bins of
// the rows in the part, then the atomics.
template <typename BinT, int V, bool GATHER, bool RED>
__device__ __forceinline__ void add_rows(
    long long r, const BinT* __restrict__ bins, long long n_bins_rows,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
    const float* __restrict__ g, const float* __restrict__ h,
    const int32_t* lut, int M, int F, int B, const Part& pt, int bf16,
    int words, const Sink<RED>& sink) {
  int p[V];
  load_i<V>(pos + r, p);
  int s[V];
  bool any = false;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    int sl = -1;
    if ((unsigned)p[j] < (unsigned)M) {
      const int q = lut[p[j]];  // INT_MAX: a node outside the wave
      if (q != INT_MAX && (unsigned)(q - pt.s0) < (unsigned)pt.scnt)
        sl = q - pt.s0;
    }
    s[j] = sl;
    any |= sl >= 0;
  }
  if (!any) return;
  float gv[V], hv[V];
  load_f<V>(g + r, gv);
  load_f<V>(h + r, hv);
#pragma unroll
  for (int j = 0; j < V; ++j) {
    gv[j] = round_val(gv[j], bf16);
    hv[j] = round_val(hv[j], bf16);
  }
  if constexpr (!GATHER) {
    for (int fb = 0; fb < pt.fcnt; fb += FEAT_BATCH) {
      ScanBins<BinT, V> w[FEAT_BATCH];
#pragma unroll
      for (int k = 0; k < FEAT_BATCH; ++k)
        if (fb + k < pt.fcnt)
          w[k].load(bins + (size_t)(pt.f0 + fb + k) * n_bins_rows + r);
#pragma unroll
      for (int k = 0; k < FEAT_BATCH; ++k) {
        if (fb + k >= pt.fcnt) break;
#pragma unroll
        for (int j = 0; j < V; ++j) {
          if (s[j] < 0) continue;
          const int b = w[k].get(j) - pt.b0;
          if ((unsigned)b >= (unsigned)pt.bcnt) continue;
          sink.add(((size_t)s[j] * pt.fg + fb + k) * pt.bt + b, gv[j], hv[j]);
        }
      }
    }
  } else {
    int rid[V];
    load_i<V>(idx + r, rid);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      if (s[j] < 0 || rid[j] < 0 || (long long)rid[j] >= n_bins_rows)
        continue;
      const BinT* rp = bins + (size_t)rid[j] * F + pt.f0;
      const size_t base = (size_t)s[j] * pt.fg * pt.bt;
      bool done = false;
      if constexpr (sizeof(BinT) == 1) {
        if (words) {
          // the row's bins of the part as 32-bit words: the caller set
          // `words` only when F and f0 are multiples of 4 and the rows are
          // 4-byte aligned, so the last word stays inside the row
          const unsigned int* wp = reinterpret_cast<const unsigned int*>(rp);
          const int nw = (pt.fcnt + 3) >> 2;
          for (int wb = 0; wb < nw; wb += WORD_BATCH) {
            unsigned int w[WORD_BATCH];
#pragma unroll
            for (int k = 0; k < WORD_BATCH; ++k)
              if (wb + k < nw) w[k] = __ldg(wp + wb + k);
#pragma unroll
            for (int k = 0; k < WORD_BATCH; ++k) {
              if (wb + k >= nw) break;
#pragma unroll
              for (int q = 0; q < 4; ++q) {
                const int f = (wb + k) * 4 + q;
                const int b = (int)((w[k] >> (8 * q)) & 0xFFu) - pt.b0;
                if (f < pt.fcnt && (unsigned)b < (unsigned)pt.bcnt)
                  sink.add(base + (size_t)f * pt.bt + b, gv[j], hv[j]);
              }
            }
          }
          done = true;
        }
      }
      if (!done) {
        for (int fb = 0; fb < pt.fcnt; fb += WORD_BATCH) {
          int b[WORD_BATCH];
#pragma unroll
          for (int k = 0; k < WORD_BATCH; ++k)
            b[k] = fb + k < pt.fcnt ? (int)__ldg(rp + fb + k) - pt.b0 : -1;
#pragma unroll
          for (int k = 0; k < WORD_BATCH; ++k)
            if ((unsigned)b[k] < (unsigned)pt.bcnt)
              sink.add(base + (size_t)(fb + k) * pt.bt + b[k], gv[j], hv[j]);
        }
      }
    }
  }
}

// A block's chunk of rows [r0, r1): groups of V rows from r0 (a multiple
// of V), then the ragged tail one row at a time.
template <typename BinT, int V, bool GATHER, bool RED>
__device__ __forceinline__ void add_chunk(
    long long r0, long long r1, const BinT* __restrict__ bins,
    long long n_bins_rows, const int32_t* __restrict__ idx,
    const int32_t* __restrict__ pos, const float* __restrict__ g,
    const float* __restrict__ h, const int32_t* lut, int M, int F, int B,
    const Part& pt, int bf16, int words, const Sink<RED>& sink) {
  long long rt = r0;
  if constexpr (V > 1) {
    rt = r0 + ((r1 - r0) / V) * V;
    for (long long r = r0 + (long long)threadIdx.x * V; r < rt;
         r += (long long)blockDim.x * V)
      add_rows<BinT, V, GATHER, RED>(r, bins, n_bins_rows, idx, pos, g, h,
                                     lut, M, F, B, pt, bf16, words, sink);
  }
  for (long long r = rt + threadIdx.x; r < r1; r += blockDim.x)
    add_rows<BinT, 1, GATHER, RED>(r, bins, n_bins_rows, idx, pos, g, h,
                                   lut, M, F, B, pt, bf16, words, sink);
}

// The lookup over tree node ids [0, M): the lowest slot of each id (INT_MAX:
// no slot), built per block in shared memory, or once a launch in global
// memory by lookup_kernel.
__device__ __forceinline__ void fill_lut(int32_t* lut, int M) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) lut[i] = INT_MAX;
}
__device__ __forceinline__ void mark_lut(int32_t* lut, int M,
                                         const int32_t* node_ids, int N) {
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int id = node_ids[i];
    if (id >= 0 && id < M) atomicMin(&lut[id], i);
  }
}

// The global lookup kind's table: one block fills it and marks the wave's
// ids before the launch's other kernels read it.
__global__ void __launch_bounds__(1024) lookup_kernel(
    int32_t* __restrict__ lut, int M, const int32_t* __restrict__ node_ids,
    int N) {
  fill_lut(lut, M);
  __syncthreads();
  mark_lut(lut, M, node_ids, N);
}

// The rows of the wave (a position with a slot), added into *live: what the
// auto kind decides by, on the device, before the tile or red kernel runs.
template <int V, bool GLUT>
__global__ void __launch_bounds__(1024) count_kernel(
    const int32_t* __restrict__ pos, long long n,
    const int32_t* __restrict__ node_ids, int N, int M,
    const int32_t* __restrict__ glut, unsigned long long* __restrict__ live) {
  extern __shared__ int32_t smem[];
  const int32_t* lut = GLUT ? glut : smem;
  if constexpr (!GLUT) {
    fill_lut(smem, M);
    __syncthreads();
    mark_lut(smem, M, node_ids, N);
    __syncthreads();
  }
  unsigned long long c = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long groups = n / V;
  for (long long q = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       q < groups; q += stride) {
    int p[V];
    load_i<V>(pos + q * V, p);
#pragma unroll
    for (int j = 0; j < V; ++j)
      c += (unsigned)p[j] < (unsigned)M && lut[p[j]] != INT_MAX;
  }
  for (long long r = groups * V + (long long)blockIdx.x * blockDim.x
                     + threadIdx.x; r < n; r += stride) {
    const int p = __ldg(pos + r);
    c += (unsigned)p < (unsigned)M && lut[p] != INT_MAX;
  }
  for (int o = 16; o; o >>= 1) c += __shfl_down_sync(0xffffffffu, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(live, c);
}

// The auto kind launches both kernels; each returns at once unless the
// wave's row count picks it: red below red_rows, the tile at or above.
// live == nullptr: the kernel runs.
__device__ __forceinline__ bool skip(const unsigned long long* live,
                                     long long red_rows, bool red) {
  return live != nullptr && (*live < (unsigned long long)red_rows) != red;
}

// One wave of resident blocks walks the n_tiles x n_chunks items (tile
// fastest, so the blocks at work on one chunk share its reads through L2;
// a tile is (slot tile, bin range, feature tile), feature tile fastest):
// per item, zero the tile, add the chunk's rows, flush. A shared lookup is
// built once per block, and an auto launch that picks red skips one wave.
template <typename BinT, int V, bool GLUT>
__global__ void __launch_bounds__(1024) tile_kernel(
    const BinT* __restrict__ bins,      // (F, n)
    const int32_t* __restrict__ pos,    // (n,) node id per row, -1 = dead
    const float* __restrict__ g, const float* __restrict__ h, long long n,
    const int32_t* __restrict__ node_ids, int N,
    int M,                              // node ids < M (lookup table size)
    int L,                              // shared lookup: max(M, N) padded
                                        // to 4 (GLUT: 0)
    int F, int B, int fg, int ng, int n_ftiles, int n_tiles,
    int nb,                             // bin ranges, each of bt bins
    int bt, int n_items, long long rows_per_chunk, int bf16,
    const int32_t* __restrict__ glut,
    const unsigned long long* __restrict__ live, long long red_rows,
    float4* __restrict__ acc)           // (N, F, B) x 4, zeroed by the caller
{
  if (skip(live, red_rows, false)) return;
  extern __shared__ int32_t smem[];
  const int32_t* lut = GLUT ? glut : smem;
  Sink<false> sink{reinterpret_cast<float*>(smem + L)};
  const float* hist = sink.hist;
  const int words = ng * fg * bt * 3;
  const int per_slot = fg * bt;

  if constexpr (!GLUT) {
    fill_lut(smem, M);
    __syncthreads();
    mark_lut(smem, M, node_ids, N);
  }

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item % n_tiles;
    const int ft = tile % n_ftiles;
    const int rest = tile / n_ftiles;
    Part pt;
    pt.f0 = ft * fg;
    pt.s0 = rest / nb * ng;
    pt.b0 = rest % nb * bt;
    pt.fcnt = min(fg, F - pt.f0);
    pt.scnt = min(ng, N - pt.s0);
    pt.bcnt = min(bt, B - pt.b0);
    pt.fg = fg;
    pt.bt = bt;
    for (int i = threadIdx.x; i < words; i += blockDim.x) smem[L + i] = 0;
    __syncthreads();

    const long long r0 = (long long)(item / n_tiles) * rows_per_chunk;
    const long long r1 = min(n, r0 + rows_per_chunk);
    add_chunk<BinT, V, false, false>(r0, r1, bins, n, nullptr, pos, g, h,
                                     lut, M, F, B, pt, bf16, 0, sink);
    __syncthreads();

    // flush: a bin no row reached (count 0) has nothing to add; the
    // range's bin i is bin b0 + i of the histogram
    for (int i = threadIdx.x; i < pt.scnt * per_slot; i += blockDim.x) {
      const int c = reinterpret_cast<const int*>(hist)[3 * i + 2];
      if (c == 0) continue;
      const int sl = i / per_slot;
      const int rem = i - sl * per_slot;
      const int fl = rem / bt;
      atomicAdd(acc + ((size_t)(pt.s0 + sl) * F + pt.f0 + fl) * B + pt.b0
                    + (rem - fl * bt),
                make_float4(hist[3 * i], hist[3 * i + 1], (float)c, 0.f));
    }
    __syncthreads();  // the next item zeroes the tile
  }
}

template <typename BinT, int V, bool GATHER, bool GLUT>
__global__ void __launch_bounds__(1024) red_kernel(
    const BinT* __restrict__ bins, long long n_bins_rows,
    const int32_t* __restrict__ idx, const int32_t* __restrict__ pos,
    const float* __restrict__ g, const float* __restrict__ h, long long n,
    const int32_t* __restrict__ node_ids, int N, int M, int F, int B,
    long long rows_per_chunk, int bf16, int words,
    const int32_t* __restrict__ glut,
    const unsigned long long* __restrict__ live, long long red_rows,
    float4* __restrict__ acc)           // (N, F, B) x 4, zeroed by the caller
{
  if (skip(live, red_rows, true)) return;
  extern __shared__ int32_t smem[];
  const int32_t* lut = GLUT ? glut : smem;
  if constexpr (!GLUT) {
    fill_lut(smem, M);
    __syncthreads();
    mark_lut(smem, M, node_ids, N);
    __syncthreads();
  }
  Part pt;
  pt.s0 = 0;
  pt.scnt = N;
  pt.f0 = 0;
  pt.fcnt = F;
  pt.fg = F;
  pt.b0 = 0;
  pt.bcnt = B;
  pt.bt = B;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n, r0 + rows_per_chunk);
  Sink<true> sink{acc};
  add_chunk<BinT, V, GATHER, true>(r0, r1, bins, n_bins_rows, idx, pos, g, h,
                                   lut, M, F, B, pt, bf16, words, sink);
}

// out[s] = acc[first slot of s's id] without the fourth word; a pad or an
// id outside [0, M) has no rows, so its acc slot (its own) is zero
__global__ void finish_kernel(const float4* __restrict__ acc,
                              const int32_t* __restrict__ node_ids, int N,
                              int M, int cells, float* __restrict__ out) {
  __shared__ int first;
  for (int s = blockIdx.y; s < N; s += gridDim.y) {
    if (threadIdx.x == 0) first = s;
    __syncthreads();
    const int id = node_ids[s];
    if (id >= 0 && id < M)
      for (int j = threadIdx.x; j < s; j += blockDim.x)
        if (node_ids[j] == id) atomicMin(&first, j);
    __syncthreads();
    const float4* src = acc + (size_t)first * cells;
    float* dst = out + (size_t)s * cells * 3;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
         i += gridDim.x * blockDim.x) {
      const float4 v = src[i];
      dst[3 * i] = v.x;
      dst[3 * i + 1] = v.y;
      dst[3 * i + 2] = v.z;
    }
    __syncthreads();  // `first` is rewritten for the next slot
  }
}

struct Args {
  const void* bins; long long n_bins_rows; const int32_t* idx;
  const int32_t* pos; const float* g; const float* h; long long n;
  const int32_t* node_ids; int N, M, F, B, fg, ng, n_ftiles, n_tiles, nb,
      bt, n_chunks; long long rows_per_chunk; int threads, smem;
  // the red launch of the auto kind (the red kind's own shape is above)
  int red_chunks; long long red_rows_per_chunk; int red_threads, red_smem;
  long long red_rows; unsigned long long* live;
  int bf16, words; float* out; float* acc;
  int32_t* glut;  // the global lookup's table, or nullptr: the shared kind
  cudaStream_t st;
};

// Above the 48 KB every kernel may use, a kernel's dynamic shared memory
// needs raising first.
template <typename K>
cudaError_t allow_smem(K kern, int smem) {
  return smem > 48 * 1024
      ? cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem)
      : cudaSuccess;
}

template <typename BinT, int V, bool GLUT>
int launch_tile(const Args& a) {
  const int L = GLUT ? 0 : ((a.M > a.N ? a.M : a.N) + 3) & ~3;
  auto kern = tile_kernel<BinT, V, GLUT>;
  cudaError_t err = allow_smem(kern, a.smem);
  if (err != cudaSuccess) return (int)err;
  // one wave of resident blocks over the items
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        a.threads, a.smem);
  if (err != cudaSuccess) return (int)err;
  const int n_items = a.n_tiles * a.n_chunks;
  const int resident = (per_sm > 0 ? per_sm : 1) * sms;
  const int blocks = n_items < resident ? n_items : resident;
  kern<<<blocks, a.threads, a.smem, a.st>>>(
      (const BinT*)a.bins, a.pos, a.g, a.h, a.n, a.node_ids, a.N, a.M, L,
      a.F, a.B, a.fg, a.ng, a.n_ftiles, a.n_tiles, a.nb, a.bt, n_items,
      a.rows_per_chunk, a.bf16, a.glut, a.live, a.red_rows, (float4*)a.acc);
  return (int)cudaGetLastError();
}

template <typename BinT, int V, bool GATHER, bool GLUT>
int launch_red(const Args& a, int chunks, long long rows_per_chunk,
               int threads, int smem) {
  auto kern = red_kernel<BinT, V, GATHER, GLUT>;
  cudaError_t err = allow_smem(kern, smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<chunks, threads, smem, a.st>>>(
      (const BinT*)a.bins, a.n_bins_rows, a.idx, a.pos, a.g, a.h, a.n,
      a.node_ids, a.N, a.M, a.F, a.B, rows_per_chunk, a.bf16, a.words,
      a.glut, a.live, a.red_rows, (float4*)a.acc);
  return (int)cudaGetLastError();
}

template <int V, bool GLUT>
int launch_count(const Args& a) {
  auto kern = count_kernel<V, GLUT>;
  cudaError_t err = allow_smem(kern, a.red_smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.red_chunks, a.red_threads, a.red_smem, a.st>>>(
      a.pos, a.n, a.node_ids, a.N, a.M, a.glut, a.live);
  return (int)cudaGetLastError();
}

int launch_lookup(const Args& a) {
  lookup_kernel<<<1, 1024, 0, a.st>>>(a.glut, a.M, a.node_ids, a.N);
  return (int)cudaGetLastError();
}

int launch_finish(const Args& a) {
  const int cells = a.F * a.B;
  const int threads = 256;
  dim3 grid((cells + threads - 1) / threads, a.N < 65535 ? a.N : 65535);
  finish_kernel<<<grid, threads, 0, a.st>>>((const float4*)a.acc,
                                            a.node_ids, a.N, a.M, cells,
                                            a.out);
  return (int)cudaGetLastError();
}

// kind 0 = tile, 1 = red, 2 = auto (count, then tile and red, one of
// which returns at once); GLUT: the lookup kernel first
template <typename BinT, bool GATHER, bool GLUT>
int launch_kind(int kind, int vec, const Args& a) {
  int err = GLUT ? launch_lookup(a) : 0;
  if (!err && kind == 2)
    err = vec ? launch_count<4, GLUT>(a) : launch_count<1, GLUT>(a);
  if (!err && kind != 1) {
    if constexpr (GATHER)
      err = (int)cudaErrorInvalidValue;  // K3 takes the red kind only
    else
      err = vec ? launch_tile<BinT, 4, GLUT>(a) : launch_tile<BinT, 1, GLUT>(a);
  }
  if (!err && kind != 0) {
    const bool own = kind == 1;  // the red kind's shape, else auto's red one
    const int chunks = own ? a.n_chunks : a.red_chunks;
    const long long rpc = own ? a.rows_per_chunk : a.red_rows_per_chunk;
    const int threads = own ? a.threads : a.red_threads;
    const int smem = own ? a.smem : a.red_smem;
    err = vec ? launch_red<BinT, 4, GATHER, GLUT>(a, chunks, rpc, threads,
                                                  smem)
              : launch_red<BinT, 1, GATHER, GLUT>(a, chunks, rpc, threads,
                                                  smem);
  }
  return err ? err : launch_finish(a);
}

template <typename BinT, bool GATHER>
int launch_lut(int kind, int vec, const Args& a) {
  return a.glut ? launch_kind<BinT, GATHER, true>(kind, vec, a)
                : launch_kind<BinT, GATHER, false>(kind, vec, a);
}

}  // namespace

extern "C" {

// K1 (gather 0) and K3 (gather 1), kind 0 = tile (K1 only), 1 = red, 2 =
// auto (K1 only: a count of the wave's rows, then the tile kernel, or the
// red kernel in the red_* shape when fewer than red_rows rows are in the
// wave). A tile holds ng slots x fg features x one of nb ranges of bt bins
// (range i: bins [i * bt, min(B, (i + 1) * bt)); nb = 1, bt = B for the red
// kind); n_tiles counts the ranges too. acc: the (N, F, B, 4) f32 scratch and then 16 bytes whose first 8
// hold auto's count, all zeroed here first; out (N, F, B, 3) f32 written
// whole by the finish kernel. bin_bytes 1 (uint8 bins) or 4 (int32); vec 1 takes rows four at a
// time (pos/g/h and idx 16-byte aligned, rows_per_chunk a multiple of 4;
// the scan's bins aligned to four rows and n a multiple of 4); words 1
// reads a gathered row's uint8 bins as 32-bit words (the red kind). lut:
// nullptr for the shared lookup kind, else the global kind's table of M
// int32 (padded to 4), filled by the launch (smem_bytes and red_smem then
// hold no lookup). Returns the cudaError_t of the launches (0 = launched).
int ytk_hist_float(int kind, int bin_bytes, int gather, int vec, int bf16,
                   int words, const void* bins, long long n_bins_rows,
                   const int32_t* idx, const int32_t* pos, const float* g,
                   const float* h, long long n, const int32_t* node_ids,
                   int N, int M, int F, int B, int fg, int ng, int n_ftiles,
                   int n_tiles, int nb, int bt, int n_chunks,
                   long long rows_per_chunk,
                   int threads, int smem_bytes, int red_chunks,
                   long long red_rows_per_chunk, int red_threads,
                   int red_smem, long long red_rows, float* out, float* acc,
                   int32_t* lut, void* stream) {
  const size_t cells = (size_t)N * F * B * 4;
  unsigned long long* live = (unsigned long long*)(acc + cells);
  Args a{bins, n_bins_rows, idx, pos, g, h, n, node_ids, N, M, F, B, fg, ng,
         n_ftiles, n_tiles, nb, bt, n_chunks, rows_per_chunk, threads, smem_bytes,
         red_chunks, red_rows_per_chunk, red_threads, red_smem, red_rows,
         kind == 2 ? live : nullptr, bf16, words, out, acc, lut,
         (cudaStream_t)stream};
  const cudaError_t err =
      cudaMemsetAsync(acc, 0, (cells + 4) * sizeof(float), a.st);
  if (err != cudaSuccess) return (int)err;
  if (bin_bytes == 1)
    return gather ? launch_lut<uint8_t, true>(kind, vec, a)
                  : launch_lut<uint8_t, false>(kind, vec, a);
  if (bin_bytes == 4)
    return gather ? launch_lut<int32_t, true>(kind, vec, a)
                  : launch_lut<int32_t, false>(kind, vec, a);
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
