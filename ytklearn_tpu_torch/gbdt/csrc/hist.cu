// GBDT int8 histograms on Hopper: the full scan (K2) and the gather over a
// compacted row list (K4). The f32/bf16 kernels K1 and K3 are in
// hist_float.cu.
//
// Replaces the JAX package's Pallas kernels
//   K2  ytklearn_tpu/gbdt/hist.py::_hist_pallas_q        (pallas_call :158)
//   K4  ytklearn_tpu/gbdt/hist.py::_hist_gather_pallas_q (pallas_call :319)
// Both compute, for each node slot s of the wave (node_ids[s] = a tree node
// id, negative = pad), each feature f and bin b:
//   out[s, f, b, :] = sum over rows r with pos[r] == node_ids[s] and
//                     bin(f, r) == b of (g[r], h[r], 1)
// so a duplicated id gets the same sums in each of its slots, as the
// reference's one-hot P = (node_ids == pos) gives them.
//
// Exactness (hist.py states the same bounds): g/h are f32 integers in
// [-127, 127] (engine._quantize's range), held in a packed row word as
// int8, so |g|, |h| <= 127 is the one bound on the inputs. Every sum (a
// tile's g, h and count, the scratch, the output) is an int32 lane that
// wraps mod 2^32 as the reference's int32 sums do: integer addition gives
// the same result in any order, so the atomics' order does not matter and
// no chunk length or row count bounds a lane (engine._quantize keeps qmax
// * n <= 2^31 - 1, so on its gradients no lane wraps at all).
//
// The TPU kernels build node and bin one-hots and run them through the MXU;
// a GPU needs none of that. Every in-wave row adds (g, h, 1) into the bins
// of its id's lowest slot, and a finish kernel copies that slot to the
// id's other slots. The launches of one call, on the caller's stream:
//   * pack: one pass over the rows writes a 32-bit word per row: its lowest
//     wave slot (0xFFFF: not in the wave) and g, h as int8. The node lookup
//     (tree node id -> lowest slot) lives in the pack kernel's shared
//     memory, or, for a tree whose lookup does not fit there (hist.py's
//     lookup_kind "global"), in one int32 table of M entries in global
//     memory that the lookup kernel, one block launched first, fills and
//     marks; so the passes after it read 4 bytes a row, not 12, and do no
//     lookup; it also counts the wave's rows for the auto kind. For K4 it
//     gathers too: each gathered row's bins go into an (F, R) feature-major
//     copy (R padded to four rows), so K4 runs K2's tile and red kernels.
//   * tile: a block owns a tile of ng slots x fg features x a range of bt
//     bins of the histogram in shared memory (all B bins, nb = 1, unless one
//     slot x feature of B bins outgrows shared memory; then B is cut into
//     nb ranges, each tile one range, and a row whose bin falls outside the
//     tile's range adds nothing there) (int32 g, h and count a bin: native ATOMS.ADD; a
//     64-bit (g, h) lane is a compare-and-swap loop on sm_90 and measured
//     slower) and adds one chunk of packed rows. One wave of resident
//     blocks walks the tiles x chunks (tile fastest, so the blocks at work
//     on one chunk share its packed words through L2), and the planner
//     makes the chunks few, one item a block where it can: a tile's flush
//     costs as much as many rows. With few chunks (hist.py's
//     Q_STORE_CHUNKS) a tile is stored whole, plain stores, into its
//     chunk's partial sums, which the finish kernel adds up; with more, its
//     nonzero bins are added into the scratch, three REDG a bin.
//   * red: no tile; each in-wave row adds each feature's bin straight into
//     an (N, F, B) scratch of 16-byte cells in L2 with three int32 REDG,
//     every row read once: for waves that hold few of the rows.
//   * auto: the pack kernel's count of the wave's rows picks tile or red on
//     the device; both are launched and the other returns at once.
//   * finish: out[s] = the sums of s's id's lowest slot (the partial sums
//     added up, or the scratch).
// What bounds it: the bytes of bins, pos, g and h read once and the
// histogram written once; on the card, the shared atomics and each row's
// chain of loads. So a thread takes four consecutive rows a group (packed
// words as one int4, four rows' bins of a feature as one 32-bit word,
// int32 bins as an int4) and Q_UNROLL groups at a time, a warp's groups
// each contiguous, and issues every group's packed and bin loads before
// the first atomic; rows that are not 16-byte aligned take a one-row path.
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/hist.py.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <mutex>

namespace {

// groups of four rows a thread takes at a time (1, 2 and 3 measured: 3 the
// fastest by a few percent at the 64-slot wave, with register spills)
constexpr int Q_UNROLL = 2;
// a gathered row's bin words (or bins) loaded before they are written
constexpr int WORD_BATCH = 8;
// a packed row word's slot field: not in the wave
constexpr uint32_t NO_SLOT = 0xFFFFu;
constexpr uint32_t DEAD = NO_SLOT << 16;

__device__ __forceinline__ uint32_t pack_row(int slot, float g, float h) {
  // g, h: f32 integers in [-127, 127]; truncation to int is exact
  return ((uint32_t)slot << 16) | (((uint32_t)(int)g & 0xFFu) << 8)
         | ((uint32_t)(int)h & 0xFFu);
}
__device__ __forceinline__ int word_g(uint32_t w) {
  return (int)(signed char)((w >> 8) & 0xFFu);
}
__device__ __forceinline__ int word_h(uint32_t w) {
  return (int)(signed char)(w & 0xFFu);
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

// Where a (slot, feature, bin) update goes: a shared-memory tile of three
// int32 words a bin (g, h, count: a stride of 3 words spreads a warp's
// random bins over all 32 banks) or the scratch's (g, h, count, unused)
// cell.
template <bool RED> struct Sink;
template <> struct Sink<false> {
  int* t;
  __device__ __forceinline__ void add(size_t cell, int g, int h) const {
    int* c = t + 3 * cell;
    atomicAdd(c, g);
    atomicAdd(c + 1, h);
    atomicAdd(c + 2, 1);
  }
};
template <> struct Sink<true> {
  int4* acc;
  __device__ __forceinline__ void add(size_t cell, int g, int h) const {
    atomicAdd(&acc[cell].x, g);
    atomicAdd(&acc[cell].y, h);
    atomicAdd(&acc[cell].z, 1);
  }
};

// The part of the histogram a block adds into: slots [s0, s0 + scnt),
// features [f0, f0 + fcnt) and bins [b0, b0 + bcnt) of a tile fg features
// x bt bins wide (red: everything, b0 = 0 and bcnt = bt = B).
struct Part {
  int s0, scnt, f0, fcnt, fg, b0, bcnt, bt;
};

// U groups of V packed rows, group u starting at r + u * step: the rows
// whose slot is in the part add each feature's bin. Every group's packed
// words, then a batch of features' bin words of every group, are loaded
// before their atomics.
template <typename BinT, int V, int U, bool RED>
__device__ __forceinline__ void add_packed(
    long long r, long long step, const BinT* __restrict__ bins, long long n,
    const uint32_t* __restrict__ packed, const Part& pt,
    const Sink<RED>& sink) {
  // int32 bins: one feature's int4 per group at a time, to spare registers
  constexpr int FB = sizeof(BinT) == 1 ? 4 : 1;
  int w[U][V];
#pragma unroll
  for (int u = 0; u < U; ++u)
    load_i<V>(reinterpret_cast<const int32_t*>(packed) + r + u * step, w[u]);
  bool any = false;
#pragma unroll
  for (int u = 0; u < U; ++u)
#pragma unroll
    for (int j = 0; j < V; ++j)
      any |= (unsigned)((int)((uint32_t)w[u][j] >> 16) - pt.s0)
             < (unsigned)pt.scnt;
  if (!any) return;
  for (int fb = 0; fb < pt.fcnt; fb += FB) {
    ScanBins<BinT, V> wb[U][FB];
#pragma unroll
    for (int k = 0; k < FB; ++k)
      if (fb + k < pt.fcnt)
#pragma unroll
        for (int u = 0; u < U; ++u)
          wb[u][k].load(bins + (size_t)(pt.f0 + fb + k) * n + r + u * step);
#pragma unroll
    for (int k = 0; k < FB; ++k) {
      if (fb + k >= pt.fcnt) break;
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j) {
          const uint32_t wj = (uint32_t)w[u][j];
          const int s = (int)(wj >> 16) - pt.s0;
          const int b = wb[u][k].get(j) - pt.b0;
          if ((unsigned)s >= (unsigned)pt.scnt
              || (unsigned)b >= (unsigned)pt.bcnt)
            continue;
          sink.add(((size_t)s * pt.fg + fb + k) * pt.bt + b, word_g(wj),
                   word_h(wj));
        }
    }
  }
}

// A block's rows [r0, r1) of the part: Q_UNROLL groups of V rows a thread
// while whole rounds fit (each of a warp's loads contiguous), then single
// groups, then the rows past the last whole group one at a time.
template <typename BinT, int V, bool RED>
__device__ __forceinline__ void add_rows(
    long long r0, long long r1, const BinT* __restrict__ bins, long long n,
    const uint32_t* __restrict__ packed, const Part& pt,
    const Sink<RED>& sink) {
  const long long group = (long long)blockDim.x * V;
  long long r = r0;
  if constexpr (V > 1) {
    const long long round = group * Q_UNROLL;
    const long long rr = r0 + (r1 - r0) / round * round;
    for (; r < rr; r += round)
      add_packed<BinT, V, Q_UNROLL, RED>(r + (long long)threadIdx.x * V,
                                         group, bins, n, packed, pt, sink);
    const long long rg = r0 + (r1 - r0) / V * V;
    for (long long q = r + (long long)threadIdx.x * V; q < rg; q += group)
      add_packed<BinT, V, 1, RED>(q, 0, bins, n, packed, pt, sink);
    r = rg;
  }
  for (long long q = r + threadIdx.x; q < r1; q += blockDim.x)
    add_packed<BinT, 1, 1, RED>(q, 0, bins, n, packed, pt, sink);
}

// The lookup over tree node ids [0, M): the lowest slot of each id
// (INT_MAX: no slot), built per block in shared memory, or once a launch in
// global memory by lookup_kernel.
__device__ __forceinline__ void build_lut(int32_t* lut, int M,
                                          const int32_t* node_ids, int N) {
  for (int i = threadIdx.x; i < M; i += blockDim.x) lut[i] = INT_MAX;
  __syncthreads();
  for (int i = threadIdx.x; i < N; i += blockDim.x) {
    const int id = node_ids[i];
    if (id >= 0 && id < M) atomicMin(&lut[id], i);
  }
  __syncthreads();
}

// The global lookup kind's table: one block fills it and marks the wave's
// ids before the pack kernel reads it.
__global__ void __launch_bounds__(1024) lookup_kernel(
    int32_t* __restrict__ lut, int M, const int32_t* __restrict__ node_ids,
    int N) {
  build_lut(lut, M, node_ids, N);
}

// A gathered row's F bins into column r of the (F, n_pad) copy.
template <typename BinT>
__device__ __forceinline__ void gather_bins(
    const BinT* __restrict__ rows, long long rid, int F, int words,
    long long r, long long n_pad, BinT* __restrict__ gbins) {
  const BinT* rp = rows + (size_t)rid * F;
  if constexpr (sizeof(BinT) == 1) {
    if (words) {
      // the caller set `words` only when F is a multiple of 4 and the rows
      // are 4-byte aligned
      const unsigned int* wp = reinterpret_cast<const unsigned int*>(rp);
      for (int wb = 0; wb < F / 4; wb += WORD_BATCH) {
        unsigned int w[WORD_BATCH];
#pragma unroll
        for (int k = 0; k < WORD_BATCH; ++k)
          if (wb + k < F / 4) w[k] = __ldg(wp + wb + k);
#pragma unroll
        for (int k = 0; k < WORD_BATCH; ++k) {
          if (wb + k >= F / 4) break;
#pragma unroll
          for (int q = 0; q < 4; ++q)
            gbins[(size_t)((wb + k) * 4 + q) * n_pad + r] =
                (BinT)((w[k] >> (8 * q)) & 0xFFu);
        }
      }
      return;
    }
  }
  for (int fb = 0; fb < F; fb += WORD_BATCH) {
    BinT b[WORD_BATCH];
#pragma unroll
    for (int k = 0; k < WORD_BATCH; ++k)
      if (fb + k < F) b[k] = __ldg(rp + fb + k);
#pragma unroll
    for (int k = 0; k < WORD_BATCH; ++k)
      if (fb + k < F) gbins[(size_t)(fb + k) * n_pad + r] = b[k];
  }
}

// Four gathered rows' uint8 bins (rows r..r+3 of the copy) as one 32-bit
// word a feature: the rows' bins as 32-bit words (`words`: F a multiple of
// 4, rows 4-byte aligned), WORD_BATCH words of each row loaded before they
// are stored; a row outside the wave as bin 0 (its packed word keeps it
// out of every sum).
__device__ __forceinline__ void gather4_words(
    const uint8_t* __restrict__ rows, const int (&rid)[4],
    const uint32_t (&w)[4], int F, long long r, long long n_pad,
    uint8_t* __restrict__ gbins) {
  const unsigned int* wp[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    wp[j] = w[j] == DEAD ? nullptr
          : reinterpret_cast<const unsigned int*>(rows + (size_t)rid[j] * F);
  for (int wb = 0; wb < F / 4; wb += WORD_BATCH) {
    unsigned int b[4][WORD_BATCH];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int k = 0; k < WORD_BATCH; ++k)
        b[j][k] = wp[j] && wb + k < F / 4 ? __ldg(wp[j] + wb + k) : 0u;
#pragma unroll
    for (int k = 0; k < WORD_BATCH; ++k) {
      if (wb + k >= F / 4) break;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const uint32_t col = ((b[0][k] >> (8 * q)) & 0xFFu)
                             | (((b[1][k] >> (8 * q)) & 0xFFu) << 8)
                             | (((b[2][k] >> (8 * q)) & 0xFFu) << 16)
                             | (((b[3][k] >> (8 * q)) & 0xFFu) << 24);
        *reinterpret_cast<uint32_t*>(
            gbins + (size_t)((wb + k) * 4 + q) * n_pad + r) = col;
      }
    }
  }
}

// pack: one chunk of rows [0, n_pad) a block; each row's word (rows past n
// and rows outside the wave: DEAD), and (live != nullptr) the wave's rows
// added into *live. GATHER (K4): row r is rows[idx[r]] (an idx outside
// [0, n_bins_rows) adds nothing), its bins copied into gbins. GLUT: the
// lookup is the global table glut, else built in shared memory.
template <typename BinT, int V, bool GATHER, bool GLUT>
__global__ void __launch_bounds__(1024) pack_kernel(
    const int32_t* __restrict__ pos, const float* __restrict__ g,
    const float* __restrict__ h, long long n, long long n_pad,
    const int32_t* __restrict__ idx, const BinT* __restrict__ rows,
    long long n_bins_rows, int F, int words,
    const int32_t* __restrict__ node_ids, int N, int M,
    const int32_t* __restrict__ glut, long long rows_per_chunk,
    uint32_t* __restrict__ packed, BinT* __restrict__ gbins,
    unsigned long long* __restrict__ live) {
  extern __shared__ int32_t smem_lut[];
  const int32_t* lut = GLUT ? glut : smem_lut;
  if constexpr (!GLUT) build_lut(smem_lut, M, node_ids, N);
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = min(n_pad, r0 + rows_per_chunk);
  const long long rn = min(n, r1);
  const long long rt = V > 1 && rn > r0 ? r0 + ((rn - r0) / V) * V : r0;
  unsigned long long c = 0;
  for (long long r = r0 + (long long)threadIdx.x * V; r < rt;
       r += (long long)blockDim.x * V) {
    int p[V];
    load_i<V>(pos + r, p);
    int s[V];
    bool any = false;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const int q = (unsigned)p[j] < (unsigned)M ? lut[p[j]] : INT_MAX;
      s[j] = q == INT_MAX ? -1 : q;
      any |= s[j] >= 0;
    }
    uint32_t w[V];
#pragma unroll
    for (int j = 0; j < V; ++j) w[j] = DEAD;
    if (any) {
      float gv[V], hv[V];
      load_f<V>(g + r, gv);
      load_f<V>(h + r, hv);
      int rid[V];
      if constexpr (GATHER) load_i<V>(idx + r, rid);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        if (s[j] < 0) continue;
        if constexpr (GATHER) {
          if (rid[j] < 0 || (long long)rid[j] >= n_bins_rows) continue;
        }
        w[j] = pack_row(s[j], gv[j], hv[j]);
        ++c;
      }
      if constexpr (GATHER) {
        if constexpr (V == 4 && sizeof(BinT) == 1) {
          if (words) {
            gather4_words(rows, rid, w, F, r, n_pad, gbins);
          } else {
#pragma unroll
            for (int j = 0; j < V; ++j)
              if (w[j] != DEAD)
                gather_bins<BinT>(rows, rid[j], F, 0, r + j, n_pad, gbins);
          }
        } else {
#pragma unroll
          for (int j = 0; j < V; ++j)
            if (w[j] != DEAD)
              gather_bins<BinT>(rows, rid[j], F, words, r + j, n_pad, gbins);
        }
      }
    }
    if constexpr (V == 4) {
      *reinterpret_cast<uint4*>(packed + r) = make_uint4(w[0], w[1], w[2],
                                                         w[3]);
    } else {
      packed[r] = w[0];
    }
  }
  for (long long r = rt + threadIdx.x; r < r1; r += blockDim.x) {
    uint32_t w = DEAD;
    if (r < n) {
      const int p = __ldg(pos + r);
      const int q = (unsigned)p < (unsigned)M ? lut[p] : INT_MAX;
      bool in = q != INT_MAX;
      if constexpr (GATHER) {
        const int rid = __ldg(idx + r);
        in = in && rid >= 0 && (long long)rid < n_bins_rows;
        if (in) gather_bins<BinT>(rows, rid, F, words, r, n_pad, gbins);
      }
      if (in) {
        w = pack_row(q, __ldg(g + r), __ldg(h + r));
        ++c;
      }
    }
    packed[r] = w;
  }
  if (live == nullptr) return;
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
// fastest; a tile is (slot tile, bin range, feature tile), feature tile
// fastest): per item, zero the tile, add the chunk's packed rows, flush.
// STORE: the tile is stored whole into its chunk's part of the (n_chunks,
// N, F, B, 3) partial sums, plain stores; else its nonzero bins are added
// into the scratch, three REDG a bin.
template <typename BinT, int V, bool STORE>
__global__ void __launch_bounds__(1024) tile_kernel(
    const BinT* __restrict__ bins,        // (F, n)
    const uint32_t* __restrict__ packed,  // (n,) from pack_kernel
    long long n, int N, int F, int B, int fg, int ng, int n_ftiles,
    int n_tiles, int nb, int bt, int n_items, long long rows_per_chunk,
    const unsigned long long* __restrict__ live, long long red_rows,
    int4* __restrict__ acc,               // (N, F, B), zeroed by the caller
    int32_t* __restrict__ partial)        // STORE: (n_chunks, N, F, B, 3)
{
  if (skip(live, red_rows, false)) return;
  extern __shared__ int32_t smem[];
  const Sink<false> sink{smem};
  const int per_slot = fg * bt;

  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const int tile = item % n_tiles;
    const int rest = tile / n_ftiles;
    Part pt;
    pt.f0 = (tile % n_ftiles) * fg;
    pt.s0 = rest / nb * ng;
    pt.b0 = rest % nb * bt;
    pt.fcnt = min(fg, F - pt.f0);
    pt.scnt = min(ng, N - pt.s0);
    pt.bcnt = min(bt, B - pt.b0);
    pt.fg = fg;
    pt.bt = bt;
    for (int i = threadIdx.x; i < 3 * ng * per_slot; i += blockDim.x)
      smem[i] = 0;
    __syncthreads();

    const int chunk = item / n_tiles;
    const long long r0 = (long long)chunk * rows_per_chunk;
    add_rows<BinT, V, false>(r0, min(n, r0 + rows_per_chunk), bins, n,
                             packed, pt, sink);
    __syncthreads();

    if constexpr (STORE) {
      // (slot, feature) runs of bt x 3 words, each contiguous in both: the
      // range's run starts at bin b0 of the partial sums' B x 3
      const int run = 3 * bt;
      for (int i = threadIdx.x; i < pt.scnt * fg * run; i += blockDim.x) {
        const int sf = i / run;
        const int sl = sf / fg;
        const int fl = sf - sl * fg;
        const int at = i - sf * run;
        if (fl >= pt.fcnt || at >= 3 * pt.bcnt) continue;
        partial[(((size_t)chunk * N + pt.s0 + sl) * F + pt.f0 + fl) * 3 * B
                + 3 * pt.b0 + at] = smem[i];
      }
      __syncthreads();  // the next item zeroes the tile
      continue;
    }
    // flush: a bin no row reached (count 0) has nothing to add; the
    // range's bin i is bin b0 + i of the histogram
    for (int i = threadIdx.x; i < pt.scnt * per_slot; i += blockDim.x) {
      const int c = smem[3 * i + 2];
      if (c == 0) continue;
      const int sl = i / per_slot;
      const int rem = i - sl * per_slot;
      const int fl = rem / bt;
      if (fl >= pt.fcnt) continue;
      int4* dst = acc + ((size_t)(pt.s0 + sl) * F + pt.f0 + fl) * B + pt.b0
                  + (rem - fl * bt);
      atomicAdd(&dst->x, smem[3 * i]);
      atomicAdd(&dst->y, smem[3 * i + 1]);
      atomicAdd(&dst->z, c);
    }
    __syncthreads();  // the next item zeroes the tile
  }
}

// red over the packed rows: one chunk of rows a block, every feature of
// every in-wave row straight into the scratch.
template <typename BinT, int V>
__global__ void __launch_bounds__(1024) red_kernel(
    const BinT* __restrict__ bins, const uint32_t* __restrict__ packed,
    long long n, int N, int F, int B, long long rows_per_chunk,
    const unsigned long long* __restrict__ live, long long red_rows,
    int4* __restrict__ acc)               // (N, F, B), zeroed by the caller
{
  if (skip(live, red_rows, true)) return;
  const Sink<true> sink{acc};
  const Part pt{0, N, 0, F, F, 0, B, B};
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  add_rows<BinT, V, true>(r0, min(n, r0 + rows_per_chunk), bins, n, packed,
                          pt, sink);
}

// out[s] = the sums of the first slot of s's id, as int32 (g, h, count):
// the sum of the stored tiles' n_store chunks when the tile kernel ran in
// store mode (n_store > 0, and auto's count did not pick red), else acc.
// A pad or an id outside [0, M) has no rows, so its own slot is zero.
__global__ void finish_kernel(const int4* __restrict__ acc,
                              const int32_t* __restrict__ partial,
                              int n_store,
                              const unsigned long long* __restrict__ live,
                              long long red_rows,
                              const int32_t* __restrict__ node_ids, int N,
                              int M, int cells, int32_t* __restrict__ out) {
  const bool stored = n_store > 0 && !skip(live, red_rows, false);
  __shared__ int first;
  for (int s = blockIdx.y; s < N; s += gridDim.y) {
    if (threadIdx.x == 0) first = s;
    __syncthreads();
    const int id = node_ids[s];
    if (id >= 0 && id < M)
      for (int j = threadIdx.x; j < s; j += blockDim.x)
        if (node_ids[j] == id) atomicMin(&first, j);
    __syncthreads();
    const int4* src = acc + (size_t)first * cells;
    int32_t* dst = out + (size_t)s * cells * 3;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < cells;
         i += gridDim.x * blockDim.x) {
      if (stored) {
        // unsigned: the partial sums add mod 2^32, as the atomics do
        uint32_t v0 = 0, v1 = 0, v2 = 0;
        for (int c = 0; c < n_store; ++c) {
          const int32_t* p =
              partial + (((size_t)c * N + first) * cells + i) * 3;
          v0 += (uint32_t)p[0];
          v1 += (uint32_t)p[1];
          v2 += (uint32_t)p[2];
        }
        dst[3 * i] = (int32_t)v0;
        dst[3 * i + 1] = (int32_t)v1;
        dst[3 * i + 2] = (int32_t)v2;
      } else {
        const int4 v = src[i];
        dst[3 * i] = v.x;
        dst[3 * i + 1] = v.y;
        dst[3 * i + 2] = v.z;
      }
    }
    __syncthreads();  // `first` is rewritten for the next slot
  }
}

struct Args {
  const void* bins; long long n_bins_rows; const int32_t* idx;
  const int32_t* pos; const float* g; const float* h; long long n, n_pad;
  const int32_t* node_ids; int N, M, F, B, fg, ng, n_ftiles, n_tiles, nb,
      bt, n_chunks; long long rows_per_chunk; int threads;
  int smem;
  // the pack launch, and the red launch of the auto kind (the red kind's
  // own shape is above)
  int pack_chunks; long long pack_rows_per_chunk; int pack_threads,
      pack_smem; long long red_rows; unsigned long long* live;
  int words; uint32_t* packed; void* gbins; int32_t* out; int4* acc;
  int32_t* partial; int n_store;  // the tile's store mode: its chunks, or 0
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

template <typename BinT, int V, bool GATHER, bool GLUT>
int launch_pack(const Args& a) {
  if constexpr (GLUT) {
    lookup_kernel<<<1, 1024, 0, a.st>>>(a.glut, a.M, a.node_ids, a.N);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto kern = pack_kernel<BinT, V, GATHER, GLUT>;
  cudaError_t err = allow_smem(kern, a.pack_smem);
  if (err != cudaSuccess) return (int)err;
  kern<<<a.pack_chunks, a.pack_threads, a.pack_smem, a.st>>>(
      a.pos, a.g, a.h, a.n, a.n_pad, a.idx, (const BinT*)a.bins,
      a.n_bins_rows, a.F, a.words, a.node_ids, a.N, a.M, a.glut,
      a.pack_rows_per_chunk, a.packed, (BinT*)a.gbins, a.live);
  return (int)cudaGetLastError();
}

template <typename BinT, bool GATHER>
int launch_pack_kind(int pack_vec, const Args& a) {
  if (a.glut)
    return pack_vec ? launch_pack<BinT, 4, GATHER, true>(a)
                    : launch_pack<BinT, 1, GATHER, true>(a);
  return pack_vec ? launch_pack<BinT, 4, GATHER, false>(a)
                  : launch_pack<BinT, 1, GATHER, false>(a);
}

// The resident blocks of a kernel at (threads, smem) on the current device,
// remembered: the occupancy query costs host time on every launch otherwise.
template <typename K>
cudaError_t resident_blocks(K kern, int threads, int smem, int* out) {
  struct Seen { const void* fn; int dev, threads, smem, blocks; };
  static Seen seen[16];
  static int n_seen = 0;
  static std::mutex lock;
  const void* fn = reinterpret_cast<const void*>(kern);
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> hold(lock);
  for (int i = 0; i < n_seen; ++i)
    if (seen[i].fn == fn && seen[i].dev == dev && seen[i].threads == threads
        && seen[i].smem == smem) {
      *out = seen[i].blocks;
      return cudaSuccess;
    }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  *out = (per_sm > 0 ? per_sm : 1) * sms;
  if (n_seen < 16) seen[n_seen++] = Seen{fn, dev, threads, smem, *out};
  return cudaSuccess;
}

template <typename BinT, int V, bool STORE>
int launch_tile(const Args& a, const BinT* bins) {
  auto kern = tile_kernel<BinT, V, STORE>;
  cudaError_t err = allow_smem(kern, a.smem);
  if (err != cudaSuccess) return (int)err;
  // one wave of resident blocks over the items
  int resident = 0;
  err = resident_blocks(kern, a.threads, a.smem, &resident);
  if (err != cudaSuccess) return (int)err;
  const int n_items = a.n_tiles * a.n_chunks;
  const int blocks = n_items < resident ? n_items : resident;
  kern<<<blocks, a.threads, a.smem, a.st>>>(
      bins, a.packed, a.n_pad, a.N, a.F, a.B, a.fg, a.ng, a.n_ftiles,
      a.n_tiles, a.nb, a.bt, n_items, a.rows_per_chunk, a.live, a.red_rows, a.acc,
      a.partial);
  return (int)cudaGetLastError();
}

template <typename BinT, int V>
int launch_red(const Args& a, const BinT* bins, int chunks,
               long long rows_per_chunk, int threads) {
  red_kernel<BinT, V><<<chunks, threads, 0, a.st>>>(
      bins, a.packed, a.n_pad, a.N, a.F, a.B, rows_per_chunk, a.live,
      a.red_rows, a.acc);
  return (int)cudaGetLastError();
}

int launch_finish(const Args& a) {
  const int cells = a.F * a.B;
  const int threads = 256;
  dim3 grid((cells + threads - 1) / threads, a.N < 65535 ? a.N : 65535);
  finish_kernel<<<grid, threads, 0, a.st>>>(
      a.acc, a.partial, a.n_store, a.live, a.red_rows, a.node_ids, a.N, a.M,
      cells, a.out);
  return (int)cudaGetLastError();
}

// kind 0 = tile, 1 = red, 2 = auto: pack (K4: pack and gather; the global
// lookup kind: the lookup kernel first), then the tile and/or red kernel
// over the packed rows, then finish. pack_vec: the pack's inputs four rows
// at a time; scan_vec: the tile and red kernels'.
template <typename BinT, bool GATHER>
int launch_kind(int kind, int pack_vec, int scan_vec, const Args& a) {
  int err = launch_pack_kind<BinT, GATHER>(pack_vec, a);
  const BinT* bins = (const BinT*)(GATHER ? a.gbins : a.bins);
  if (!err && kind != 1) {
    if (a.n_store)
      err = scan_vec ? launch_tile<BinT, 4, true>(a, bins)
                     : launch_tile<BinT, 1, true>(a, bins);
    else
      err = scan_vec ? launch_tile<BinT, 4, false>(a, bins)
                     : launch_tile<BinT, 1, false>(a, bins);
  }
  if (!err && kind != 0) {
    const bool own = kind == 1;  // the red kind's shape, else the pack's
    const int chunks = own ? a.n_chunks : a.pack_chunks;
    const long long rpc = own ? a.rows_per_chunk : a.pack_rows_per_chunk;
    const int threads = own ? a.threads : a.pack_threads;
    err = scan_vec ? launch_red<BinT, 4>(a, bins, chunks, rpc, threads)
                   : launch_red<BinT, 1>(a, bins, chunks, rpc, threads);
  }
  return err ? err : launch_finish(a);
}

}  // namespace

extern "C" {

// K2 (gather 0: bins (F, n) feature-major) and K4 (gather 1: bins (n_rows,
// F) row-major, gathered through idx). kind 0 = tile, 1 = red, 2 = auto
// (red when the pack kernel counts fewer than red_rows rows in the wave, in
// the pack_* shape; else the tile). A tile holds ng slots x fg features x
// one of nb ranges of bt bins (range i: bins [i * bt, min(B, (i + 1) *
// bt)); nb = 1, bt = B for the red kind); n_tiles counts the ranges too.
// n_pad: n (K2) or n rounded up to 4
// (K4). acc, 16-byte aligned: the (N, F, B) scratch of 16-byte cells, 16
// bytes whose first 8 hold auto's count, n_pad packed row words, (K4) the
// (F, n_pad) gathered bins, then (n_store > 0) the (n_store, N, F, B, 3)
// partial sums of the tile's store mode (n_store = n_chunks). The cells
// and the count are zeroed here when red, auto or the tile's atomic flush
// reads them. out (N, F, B, 3) int32, written whole by the finish kernel.
// bin_bytes 1 (uint8 bins) or 4 (int32); pack_vec 1: the pack kernel takes
// rows four at a time (pos/gq/hq and idx 16-byte aligned,
// pack_rows_per_chunk a multiple of 4); scan_vec 1: the tile and red
// kernels do (rows_per_chunk a multiple of 4; K2's bins aligned to four
// rows and n a multiple of 4); words 1 reads a gathered row's uint8 bins as
// 32-bit words. lut: nullptr for the shared lookup kind, else the global
// kind's table of M int32 (padded to 4), filled by the launch (pack_smem
// then holds no lookup). Returns the cudaError_t of the launches (0 =
// launched).
int ytk_hist_q(int kind, int bin_bytes, int gather, int pack_vec,
               int scan_vec, int words,
               const void* bins, long long n_bins_rows, const int32_t* idx,
               const int32_t* pos, const float* gq, const float* hq,
               long long n, long long n_pad, const int32_t* node_ids, int N,
               int M, int F, int B, int fg, int ng, int n_ftiles,
               int n_tiles, int nb, int bt, int n_chunks,
               long long rows_per_chunk,
               int threads, int smem_bytes, int pack_chunks,
               long long pack_rows_per_chunk, int pack_threads,
               int pack_smem, long long red_rows, int n_store, int32_t* out,
               void* acc, int32_t* lut, void* stream) {
  const size_t cells = (size_t)N * F * B;
  int4* cell = (int4*)acc;
  unsigned long long* live = (unsigned long long*)(cell + cells);
  uint32_t* packed = (uint32_t*)(cell + cells + 1);
  uint8_t* gbins = (uint8_t*)(packed + n_pad);
  int32_t* partial = (int32_t*)(gather ? gbins + (size_t)F * n_pad
                                               * bin_bytes
                                       : gbins);
  if (kind == 1) n_store = 0;
  Args a{bins, n_bins_rows, idx, pos, gq, hq, n, n_pad, node_ids, N, M, F,
         B, fg, ng, n_ftiles, n_tiles, nb, bt, n_chunks, rows_per_chunk,
         threads,
         smem_bytes, pack_chunks, pack_rows_per_chunk, pack_threads,
         pack_smem, red_rows, kind == 2 ? live : nullptr, words, packed,
         gbins, out, cell, partial, n_store, lut, (cudaStream_t)stream};
  // the count is read by auto only, the cells by red and the tile's
  // atomic flush: the tile kind in store mode zeroes nothing
  if (kind != 0 || n_store == 0) {
    const size_t len = (cells + (kind == 2 ? 1 : 0)) * sizeof(int4);
    const cudaError_t err = cudaMemsetAsync(acc, 0, len, a.st);
    if (err != cudaSuccess) return (int)err;
  }
  if (bin_bytes == 1)
    return gather ? launch_kind<uint8_t, true>(kind, pack_vec, scan_vec, a)
                  : launch_kind<uint8_t, false>(kind, pack_vec, scan_vec, a);
  if (bin_bytes == 4)
    return gather ? launch_kind<int32_t, true>(kind, pack_vec, scan_vec, a)
                  : launch_kind<int32_t, false>(kind, pack_vec, scan_vec, a);
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
