// K8: GBDT int8 histograms as a one-hot matrix product on the tensor cores.
//
// Replaces the JAX package's tuning variant of K2,
//   scripts/tune_hist_kernel.py::hist_q_u8 (:71, pallas_call :106),
// which the reference's own spot check holds equal to K2
// (ytklearn_tpu/gbdt/hist.py::_hist_pallas_q :113). It computes, for each
// feature f, each row of PV and bin b,
//   out[f, c*N + s, b] = sum over rows k with node_ids[s] >= 0,
//                        pos[k] == node_ids[s] and bins[f, k] == b of v_c[k]
// with v_0 = gq, v_1 = hq (f32 integers in [-127, 127]) and v_2 = 1: the
// product PV @ OH^T of PV = [P*gq ; P*hq ; P] (3N x n, int8, P the node
// one-hot) and OH = (bins == iota_B) (B x n, int8), summed in int32. Every
// slot compares its own id with the row's position, so a duplicated id gets
// the same sums in each of its slots. int32 addition is associative: any
// order of the mma steps and atomics gives the reference's exact sums
// (|sum| <= n * 127, within int32 up to 16.9M rows).
//
// Bounds. The function moves K2's bytes (bins, pos, gq, hq read once, the
// histogram written once: about 0.13 ms at the tune shape of 10.5M rows x
// 28 features, B = 256, N = 32). The product does 2 * 16*ceil(3N/16) *
// 8*ceil(B/8) * n * F int8 operations (1.44e13 there: 7.3 ms at the H100's
// 1,979 dense int8 TOP/s), so this design is bound by the tensor cores
// while K2's shared-memory atomics need only three adds per row and
// feature. What the design does about it:
//   * mma.sync m16n8k32 s8.s8.s32 (16 x 8 output tiles, 32 rows deep).
//     A warp's tiles (mtw m-tiles x ntw n-tiles, 16 in all) stay in
//     registers for the whole row chunk and reach device memory once, as
//     int32 atomicAdds (zeros skipped).
//   * PV is built once per 32-row step for the whole block, in shared
//     memory and already in the A-fragment order (one 16-byte load per
//     m-tile and lane), and shared by every warp: all features and bins of
//     the block. Each (slot, 4 rows) pair costs one compare of 4 positions
//     and three ANDs, one per channel.
//   * OH never exists in memory: a lane's B fragment is its 8 rows' bins
//     (two 32-bit words from shared memory) compared byte-wise with its
//     bin index (__vcmpeq4), so bins stay uint8 as in the reference.
//   * the ragged edge is masked here: a row past the chunk has position -1
//     and zero values, so n needs to be a multiple of nothing.
// A simple first version: no wgmma, no TMA, no double buffering of the
// staged rows (two block barriers per 128 rows).
//
// Grid: x = feature group (fastest) x slice of a feature's warp tasks,
// y = row chunk. Built by ytklearn_tpu_torch/cuda_build.py with nvcc for
// sm_90a; bound by ctypes from ytklearn_tpu_torch/gbdt/hist.py::hist_q_u8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 128;           // rows staged per block pass
constexpr int STEPS = KT / 32;    // m16n8k32 steps per pass
constexpr int MAX_THREADS = 512;  // hist.py::U8_WARPS warps

__device__ __forceinline__ void mma_s8(int32_t (&c)[4], const uint4& a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

template <int MTW, int NTW>
__global__ void __launch_bounds__(MAX_THREADS)
hist_u8_kernel(const uint8_t* __restrict__ bins,  // (F, n)
               long long n,
               const int32_t* __restrict__ pos,    // (n,) node id, -1 dead
               const float* __restrict__ gq,       // (n,) integers
               const float* __restrict__ hq,       // (n,) integers
               const int32_t* __restrict__ node_ids, int N, int F, int B,
               int fg, int n_fgroups, int tps, long long rows_per_block,
               int32_t* __restrict__ out)          // (F, 3N, B), zeroed
{
  const int MT = (3 * N + 15) / 16;  // 16-row tiles of PV
  const int NT = (B + 7) / 8;        // 8-bin tiles of OH
  const int m_groups = (MT + MTW - 1) / MTW;
  const int tpf = m_groups * ((NT + NTW - 1) / NTW);

  // shared: PV fragments [STEPS][MT][32 lanes] x 16 B, then the staged
  // rows' positions, int8 gq and hq, the wave's ids and fg features' bins
  extern __shared__ uint4 smem_u4[];
  uint4* afrag = smem_u4;
  int32_t* spos = (int32_t*)(afrag + STEPS * MT * 32);
  int8_t* sg = (int8_t*)(spos + KT);
  int8_t* sh = sg + KT;
  int32_t* sids = (int32_t*)(sh + KT);
  uint8_t* sbins = (uint8_t*)(sids + ((N + 3) & ~3));

  const int fgi = blockIdx.x % n_fgroups;
  const int slice = blockIdx.x / n_fgroups;
  const int f0 = fgi * fg;
  const int fcnt = min(fg, F - f0);
  const long long r0 = (long long)blockIdx.y * rows_per_block;
  const long long r1 = min(n, r0 + rows_per_block);

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = lane >> 2;  // groupID of the mma fragment layouts
  const int tig = lane & 3;   // thread in group
  const int fl = warp / tps;
  const int task = slice * tps + warp % tps;
  const bool active = fl < fcnt && task < tpf;
  const int mg = task % m_groups;
  const int ngr = task / m_groups;

  // PV rows past 3N stay zero: clear the buffer once, the build below
  // writes only rows < 3N
  for (int i = threadIdx.x; i < STEPS * MT * 32; i += blockDim.x)
    afrag[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < N; i += blockDim.x) sids[i] = node_ids[i];

  int32_t acc[MTW][NTW][4];
#pragma unroll
  for (int m = 0; m < MTW; ++m)
#pragma unroll
    for (int t = 0; t < NTW; ++t)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[m][t][i] = 0;

  uint32_t* afrag_w = (uint32_t*)afrag;
  for (long long t0 = r0; t0 < r1; t0 += KT) {
    __syncthreads();  // the previous pass's readers are done
    for (int i = threadIdx.x; i < KT; i += blockDim.x) {
      const long long k = t0 + i;
      const bool ok = k < r1;
      spos[i] = ok ? pos[k] : -1;
      sg[i] = ok ? (int8_t)__float2int_rz(gq[k]) : 0;
      sh[i] = ok ? (int8_t)__float2int_rz(hq[k]) : 0;
    }
    for (int i = threadIdx.x; i < fcnt * KT; i += blockDim.x) {
      const int f = i / KT;
      const long long k = t0 + (i - f * KT);
      sbins[i] = k < r1 ? bins[(long long)(f0 + f) * n + k] : 0;
    }
    __syncthreads();

    // PV in A-fragment order. Item (slot s, word kw) covers rows 4kw..4kw+3
    // of the pass: one mask of 4 position compares, one word per channel.
    // m16n8k32 A (row-major 16 x 32 s8): lane = 4*groupID + tig holds rows
    // groupID (regs 0, 2) and groupID + 8 (regs 1, 3), columns tig*4..+3
    // (regs 0, 1) and 16 + tig*4..+3 (regs 2, 3)
    for (int it = threadIdx.x; it < N * (KT / 4); it += blockDim.x) {
      const int s = it / (KT / 4);
      const int kw = it - s * (KT / 4);
      const int id = sids[s];
      const int4 p4 = *(const int4*)(spos + 4 * kw);
      uint32_t mask = 0;
      if (id >= 0) {
        mask = (p4.x == id ? 0x000000FFu : 0u) | (p4.y == id ? 0x0000FF00u : 0u)
             | (p4.z == id ? 0x00FF0000u : 0u) | (p4.w == id ? 0xFF000000u : 0u);
      }
      const uint32_t vals[3] = {*(const uint32_t*)(sg + 4 * kw),
                                *(const uint32_t*)(sh + 4 * kw), 0x01010101u};
      const int step = kw >> 3;
      const int kwi = kw & 7;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int r = c * N + s;
        const int mt = r >> 4;
        const int w16 = r & 15;
        const int ln = (w16 & 7) * 4 + (kwi & 3);
        const int reg = (w16 >> 3) + 2 * (kwi >> 2);
        afrag_w[((step * MT + mt) * 32 + ln) * 4 + reg] = mask & vals[c];
      }
    }
    __syncthreads();

    if (active) {
#pragma unroll 1
      for (int st = 0; st < STEPS; ++st) {
        // B fragment (col-major 32 x 8): a lane holds column groupID, rows
        // tig*4..+3 (reg 0) and 16 + tig*4..+3 (reg 1): its rows' bins
        const uint8_t* bb = sbins + fl * KT + st * 32 + tig * 4;
        const uint32_t bw0 = *(const uint32_t*)bb;
        const uint32_t bw1 = *(const uint32_t*)(bb + 16);
        uint4 a[MTW];
#pragma unroll
        for (int m = 0; m < MTW; ++m) {
          const int mt = mg * MTW + m;
          a[m] = mt < MT ? afrag[(st * MT + mt) * 32 + lane]
                         : make_uint4(0, 0, 0, 0);
        }
#pragma unroll
        for (int t = 0; t < NTW; ++t) {
          const int nt = ngr * NTW + t;
          if (nt >= NT) continue;
          const uint32_t bin4 = (uint32_t)(nt * 8 + grp) * 0x01010101u;
          const uint32_t b0 = __vcmpeq4(bw0, bin4) & 0x01010101u;
          const uint32_t b1 = __vcmpeq4(bw1, bin4) & 0x01010101u;
#pragma unroll
          for (int m = 0; m < MTW; ++m) {
            if (mg * MTW + m < MT) mma_s8(acc[m][t], a[m], b0, b1);
          }
        }
      }
    }
  }

  // C fragment (16 x 8 s32): lane holds rows groupID (regs 0, 1) and
  // groupID + 8 (regs 2, 3), columns tig*2 and tig*2 + 1
  if (!active) return;
  const int rows3 = 3 * N;
  int32_t* of = out + (size_t)(f0 + fl) * rows3 * B;
#pragma unroll
  for (int m = 0; m < MTW; ++m) {
#pragma unroll
    for (int t = 0; t < NTW; ++t) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int v = acc[m][t][i];
        const int row = (mg * MTW + m) * 16 + grp + (i >> 1) * 8;
        const int col = (ngr * NTW + t) * 8 + tig * 2 + (i & 1);
        if (v != 0 && row < rows3 && col < B)
          atomicAdd(of + (size_t)row * B + col, v);
      }
    }
  }
}

template <int MTW>
int launch(const uint8_t* bins, long long n, const int32_t* pos,
           const float* gq, const float* hq, const int32_t* node_ids, int N,
           int F, int B, int fg, int n_fgroups, int tps, int n_slices,
           int n_chunks, int threads, int smem_bytes,
           long long rows_per_block, int32_t* out, cudaStream_t stream) {
  auto kern = hist_u8_kernel<MTW, 16 / MTW>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(n_fgroups * n_slices, n_chunks);
  kern<<<grid, threads, smem_bytes, stream>>>(
      bins, n, pos, gq, hq, node_ids, N, F, B, fg, n_fgroups, tps,
      rows_per_block, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8 launch: mtw = m-tiles per warp (1, 2, 4 or 8; the warp holds 16/mtw
// n-tiles), threads = 32 * fg * tps <= 512. out (F, 3N, B) int32, zeroed by
// the caller. Returns the cudaError_t of the launch (0 = launched).
int ytk_hist_q_u8(const uint8_t* bins, long long n, const int32_t* pos,
                  const float* gq, const float* hq, const int32_t* node_ids,
                  int N, int F, int B, int fg, int n_fgroups, int tps,
                  int mtw, int n_slices, int n_chunks, int threads,
                  int smem_bytes, long long rows_per_block, int32_t* out,
                  void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (threads < 32 || threads > MAX_THREADS || B < 1 || B > 256)
    return (int)cudaErrorInvalidValue;
#define YTK_ARGS bins, n, pos, gq, hq, node_ids, N, F, B, fg, n_fgroups, \
    tps, n_slices, n_chunks, threads, smem_bytes, rows_per_block, out, st
  switch (mtw) {
    case 1: return launch<1>(YTK_ARGS);
    case 2: return launch<2>(YTK_ARGS);
    case 4: return launch<4>(YTK_ARGS);
    case 8: return launch<8>(YTK_ARGS);
  }
#undef YTK_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
