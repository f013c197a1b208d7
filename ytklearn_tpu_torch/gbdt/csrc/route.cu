// Wave routing on Hopper (K5): move every row of a split node to its child.
//
// Replaces the JAX package's Pallas kernel
//   K5  ytklearn_tpu/gbdt/route.py::_route_pallas (pallas_call :63)
// For each row r with p = pos[r] (the position BEFORE this wave) and each
// wave slot i in order, if valid[i] and p == nid[i]:
//   b = bins[clamp(feat[i], 0, F-1), r]
//   pos[r] = (b > slot[i] && b >= lo[i] && b <= hi[i]) ? rch[i] : lch[i]
// A later matching slot wins, as in the Pallas kernel (the engine's wave
// holds distinct node ids, so at most one slot matches).
//
// Bound: memory. A row's position is read once and written once (8 bytes),
// plus the bin of its matching slot's feature (about 0.06 ms over the
// bench cell's 10.5M rows on an H100). What the design does about it:
//   * a persistent grid (a few blocks an SM, grid-stride), so the slot
//     table is read and prepared once a block, not once every 256 rows;
//   * a node -> slot lookup in shared memory instead of a scan of every
//     slot a row: a direct map over the wave's [min id, max id] of valid
//     slots where that span fits (map_cap entries), else the valid
//     (id, slot) pairs sorted by id and slot and a binary search (the last
//     equal key is the highest slot). Either way the highest valid slot of
//     an id wins, and ids of any size route;
//   * the slot fields are read where the caller keeps them, in their own
//     integer types (no table is stacked on the host: one launch a wave),
//     and each winning slot's fields (feature clamped, split slot,
//     children, member range) packed into one 24-byte shared entry;
//   * four rows a thread, two such quads in flight: one 16-byte load and
//     store of pos where pos and out are 16-byte aligned (a scalar path
//     for other views such as pos[1:] and for the ragged tail), and one
//     32-bit load of four u8 bins (16 bytes of i32 bins) when the four
//     rows share a split feature and the word is aligned;
//   * when out is pos, a quad whose positions do not change is not stored.
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/route.py.

#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 2;  // quads a thread has in flight

struct Entry {  // one winning slot, 24 bytes
  int2 fs;      // feature (clamped to [0, F-1]), split slot
  int2 ch;      // left child, right child
  int2 range;   // member range lo, hi
};

// The wave's eight per-slot fields (valid, nid, feat, slot, lch, rch, lo,
// hi), each read where the caller keeps it: code = its element bytes (1
// unsigned, -1 signed, 2, 4 or 8; 0: absent, the default is used).
struct Fields {
  const void* p[8];
  int code[8];
};

__device__ __forceinline__ int field(const Fields& fl, int k, int i,
                                     int dflt) {
  const void* p = fl.p[k];
  switch (fl.code[k]) {
    case 1: return ((const uint8_t*)p)[i];
    case -1: return ((const int8_t*)p)[i];
    case 2: return ((const int16_t*)p)[i];
    case 4: return ((const int32_t*)p)[i];
    case 8: return (int)((const long long*)p)[i];  // as .to(torch.int32)
  }
  return dflt;
}

constexpr int HI_DEFAULT = 1 << 30;  // route.py::HI_DEFAULT

struct Lookup {
  // direct: slot + 1 by id - lo_id (0 = none); sorted: the valid ids by
  // rank, the entries in the same order
  const int* tab;
  int cnt, lo_id, hi_id, direct;

  // entry index of position p, or -1 when no valid slot holds p
  __device__ __forceinline__ int find(int p) const {
    if (direct) {
      if (p < lo_id || p > hi_id) return -1;
      return tab[p - lo_id] - 1;
    }
    int a = 0, b = cnt;
    while (a < b) {
      const int m = (a + b) >> 1;
      if (tab[m] <= p) a = m + 1; else b = m;
    }
    return (a > 0 && tab[a - 1] == p) ? a - 1 : -1;
  }
};

__device__ __forceinline__ int route_one(const Entry& e, int b) {
  return (b > e.fs.y && b >= e.range.x && b <= e.range.y) ? e.ch.y : e.ch.x;
}

template <typename BinT>
__device__ __forceinline__ void load4(const BinT* bins, long long off,
                                      int (&b)[4]);

template <>
__device__ __forceinline__ void load4<uint8_t>(const uint8_t* bins,
                                               long long off, int (&b)[4]) {
  const uint32_t w = *(const uint32_t*)(bins + off);
  b[0] = w & 0xFF; b[1] = (w >> 8) & 0xFF; b[2] = (w >> 16) & 0xFF;
  b[3] = w >> 24;
}

template <>
__device__ __forceinline__ void load4<int32_t>(const int32_t* bins,
                                               long long off, int (&b)[4]) {
  const int4 w = *(const int4*)(bins + off);
  b[0] = w.x; b[1] = w.y; b[2] = w.z; b[3] = w.w;
}

// Shared memory: the entries (NW x 24 B), then the direct map (map_cap
// ints) or the sorted keys (NW ints), whichever is larger.
template <typename BinT>
__global__ void __launch_bounds__(THREADS)
route_kernel(const BinT* __restrict__ bins,  // (F, n)
             long long n, int F,
             const int32_t* pos_in,            // (n,)
             Fields fl, int NW, int map_cap, int vec, int bins_vec,
             int skip_same,
             int32_t* pos_out) {               // (n,), may alias pos_in
  extern __shared__ int2 smem_i2[];
  Entry* ent = (Entry*)smem_i2;
  int* tail = (int*)(ent + NW);  // map or keys
  __shared__ int s_lo, s_hi, s_cnt;
  if (threadIdx.x == 0) { s_lo = INT_MAX; s_hi = INT_MIN; s_cnt = 0; }
  __syncthreads();
  int lo = INT_MAX, hi = INT_MIN, cnt = 0;
  for (int i = threadIdx.x; i < NW; i += blockDim.x) {
    if (field(fl, 0, i, 0) == 0) continue;
    const int id = field(fl, 1, i, 0);
    lo = min(lo, id);
    hi = max(hi, id);
    ++cnt;
  }
  if (cnt) {
    atomicMin(&s_lo, lo);
    atomicMax(&s_hi, hi);
    atomicAdd(&s_cnt, cnt);
  }
  __syncthreads();
  Lookup lk;
  lk.tab = tail;
  lk.cnt = s_cnt;
  lk.lo_id = s_lo;
  lk.hi_id = s_hi;
  lk.direct = lk.cnt > 0 &&
      (long long)lk.hi_id - (long long)lk.lo_id < (long long)map_cap;
  if (lk.cnt == 0) {
    lk.direct = 1;  // an empty map: every find() misses
    lk.lo_id = 1;
    lk.hi_id = 0;
  }
  const int span = lk.direct ? lk.hi_id - lk.lo_id + 1 : 0;
  for (int i = threadIdx.x; i < span; i += blockDim.x) tail[i] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < NW; i += blockDim.x) {
    if (field(fl, 0, i, 0) == 0) continue;
    const int id = field(fl, 1, i, 0);
    int at = i;
    if (lk.direct) {
      atomicMax(&tail[id - lk.lo_id], i + 1);  // the highest slot wins
    } else {  // rank by (id, slot)
      at = 0;
      for (int j = 0; j < NW; ++j) {
        const int jd = field(fl, 1, j, 0);
        at += field(fl, 0, j, 0) != 0 && (jd < id || (jd == id && j < i));
      }
      tail[at] = id;
    }
    Entry e;
    e.fs = make_int2(min(max(field(fl, 2, i, 0), 0), F - 1),
                     field(fl, 3, i, 0));
    e.ch = make_int2(field(fl, 4, i, 0), field(fl, 5, i, 0));
    e.range = make_int2(field(fl, 6, i, 0), field(fl, 7, i, HI_DEFAULT));
    ent[at] = e;
  }
  __syncthreads();

  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long gtid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nq = vec ? n / 4 : 0;
  // U quads a thread at a time, every load of the U issued before any use
  for (long long q0 = gtid; q0 < nq; q0 += U * stride) {
    int4 p4[U];
    bool ok[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ok[u] = q0 + u * stride < nq;
      p4[u] = ok[u] ? *(const int4*)(pos_in + 4 * (q0 + u * stride))
                    : make_int4(0, 0, 0, 0);
    }
    int s[U][4], b[U][4];
    bool any[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int p[4] = {p4[u].x, p4[u].y, p4[u].z, p4[u].w};
      any[u] = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[u][j] = ok[u] ? lk.find(p[j]) : -1;
        any[u] |= s[u][j] >= 0;
      }
      if (!any[u]) continue;
      // the rows in the wave share a feature: one load of the quad's bins
      const long long r = 4 * (q0 + u * stride);
      int f[4], f0 = -1;
      bool same = true;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[j] = s[u][j] >= 0 ? ent[s[u][j]].fs.x : -1;
        if (f0 < 0) f0 = f[j];
        same &= f[j] < 0 || f[j] == f0;
      }
      if (same && bins_vec) {
        load4<BinT>(bins, (long long)f0 * n + r, b[u]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[u][j] = s[u][j] >= 0 ? (int)bins[(long long)f[j] * n + r + j]
                                 : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (!ok[u] || (!any[u] && skip_same)) continue;
      const long long r = 4 * (q0 + u * stride);
      const int p[4] = {p4[u].x, p4[u].y, p4[u].z, p4[u].w};
      int np[4];
      bool changed = false;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        np[j] = s[u][j] >= 0 ? route_one(ent[s[u][j]], b[u][j]) : p[j];
        changed |= np[j] != p[j];
      }
      if (changed || !skip_same)
        *(int4*)(pos_out + r) = make_int4(np[0], np[1], np[2], np[3]);
    }
  }
  // the rows past the last quad, or every row when pos or out is not
  // 16-byte aligned: one row a thread
  for (long long r = 4 * nq + gtid; r < n; r += stride) {
    const int p = pos_in[r];
    const int si = lk.find(p);
    if (si < 0) {
      if (!skip_same) pos_out[r] = p;
      continue;
    }
    const Entry e = ent[si];
    const int np = route_one(e, (int)bins[(long long)e.fs.x * n + r]);
    if (np != p || !skip_same) pos_out[r] = np;
  }
}

template <typename BinT>
int launch(const void* bins, long long n, int F, const int32_t* pos_in,
           const Fields& fl, int NW, int map_cap, int vec, int bins_vec,
           int skip_same, int32_t* pos_out, int blocks, int smem,
           cudaStream_t stream) {
  auto kern = route_kernel<BinT>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kern<<<blocks, THREADS, smem, stream>>>((const BinT*)bins, n, F, pos_in,
                                          fl, NW, map_cap, vec, bins_vec,
                                          skip_same, pos_out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// bin_bytes: 1 (uint8 bins) or 4 (int32 bins). fields: the eight per-slot
// arrays (valid, nid, feat, slot, lch, rch, lo, hi) of NW entries, codes:
// their element bytes (1 unsigned, -1 signed, 2, 4, 8; 0: lo/hi absent,
// 0 and 2^30). vec: pos_in and pos_out are 16-byte aligned (four rows a
// thread); bins_vec: bins is 16-byte aligned and n a multiple of 4 (a
// quad's bins of one feature are one aligned word); skip_same: pos_out is
// pos_in. smem = 24 * NW + 4 * max(map_cap, NW) bytes
// (route.py::route_plan). Returns the cudaError_t of the launch (0 =
// launched).
int ytk_route(int bin_bytes, const void* bins, long long n, int F,
              const int32_t* pos_in, const void* const* fields,
              const int* codes, int NW, int map_cap, int vec, int bins_vec,
              int skip_same, int32_t* pos_out, int blocks, int smem,
              void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  Fields fl;
  for (int k = 0; k < 8; ++k) {
    fl.p[k] = fields[k];
    fl.code[k] = codes[k];
  }
  if (bin_bytes == 1)
    return launch<uint8_t>(bins, n, F, pos_in, fl, NW, map_cap, vec,
                           bins_vec, skip_same, pos_out, blocks, smem, st);
  if (bin_bytes == 4)
    return launch<int32_t>(bins, n, F, pos_in, fl, NW, map_cap, vec,
                           bins_vec, skip_same, pos_out, blocks, smem, st);
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
