// K8: GBDT int8 histograms as a one-hot matrix product on Hopper's
// warpgroup tensor cores (wgmma).
//
// Replaces the JAX package's tuning variant of K2,
//   scripts/tune_hist_kernel.py::hist_q_u8 (:71, pallas_call :106),
// which the reference's own spot check holds equal to K2
// (ytklearn_tpu/gbdt/hist.py::_hist_pallas_q :113). It computes, for each
// feature f, each row p = c*N + s of PV and bin b,
//   out[f, p, b] = sum over rows k with node_ids[s] >= 0,
//                  pos[k] == node_ids[s] and bins[f, k] == b of v_c[k]
// with v_0 = gq, v_1 = hq (f32 integers in [-127, 127]) and v_2 = 1: the
// product OH @ PV^T of OH = (bins == iota_B) (B x n, int8) and PV = [P*gq ;
// P*hq ; P] (3N x n, int8, P the node one-hot), summed in int32. Every slot
// compares its own id with the row's position, so a duplicated id gets the
// same sums in each of its slots. int32 addition is associative: any order
// of the products and atomics gives the reference's exact sums (|sum| <=
// n * 127, within int32 up to 16.9M rows).
//
// Bounds. The function moves K2's bytes (about 0.13 ms at the tune shape of
// 10.5M rows x 28 features, B = 256, N = 32, on an H100). The product does
// 2 * 64 ceil(B/64) * W * n * F int8 operations, W = 3N rounded up to the
// wgmma width (1.44e13 there: 7.3 ms at 1,979 dense int8 TOP/s), so the
// formulation is bound by the tensor cores, and even at that floor it is
// slower than K2's shared-memory atomics (three adds a row and feature).
// What the design does to reach the floor:
//   * wgmma.mma_async m64nWk32 s32.s8.s8, the only path to the full int8
//     rate: M is 64 bins, N the W rows of PV (3N rounded up to 32, 64, 96,
//     128, 192 or 256; past 256 the PV rows are cut into n-tiles of at most
//     256), K 32 rows of data. The one-hot is the A operand, built in
//     registers: a thread's four 32-bit A registers are four byte-equality
//     tests of its packed bins against its two bin rows (eq_bytes, five
//     integer ops each). PV is the B operand, read by the tensor cores from
//     shared memory (K-major, no swizzle: 8 x 16-byte core matrices, the
//     two k-halves 128 bytes apart, 8-row groups 256 bytes apart).
//   * warp specialisation: a block is one producer warpgroup and
//     U8_CONSUMERS consumer warpgroups. The producer copies rows (pos, gq,
//     hq, 16 bytes a thread, and the consumers' features' bins) by
//     cp.async into staged slots of its own, 1024 rows ahead, converts g
//     and h to int8 once, and builds each stage's PV once for every
//     consumer into a ring of stages guarded by mbarriers (full / empty).
//     A stage is KT = 512, 256 or 128 rows (the longest whose ring holds
//     three stages), so the handshakes are few.
//   * each consumer warpgroup owns one unit (a feature, an n-tile of PV
//     rows and MTW 64-bin m-tiles) and keeps its MTW x W/2 int32
//     accumulators a thread in registers over the item's whole row chunk;
//     wgmma groups of two k-steps run while the next group's A fragments
//     are built (two register sets). It flushes once an item, with int32
//     atomics (zeros skipped), into the zeroed output.
//   * a persistent grid (one block an SM) walks items (a group of fg
//     features x a chunk of rows_per_block rows); the item's units run in
//     rounds of U8_CONSUMERS, each round a pass over the chunk.
//   * the ragged edge: a staged row past the chunk has position -1, so
//     rows need to be a multiple of nothing; rows are copied 4 bytes at a
//     time and bins a byte at a time where the views are not aligned.
//
// Built by ytklearn_tpu_torch/cuda_build.py with nvcc for sm_90a; bound by
// ctypes from ytklearn_tpu_torch/gbdt/hist.py::hist_q_u8 (launch shape:
// hist.py::u8_plan, checked by hist.py::check_u8_plan).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CW = 2;               // consumer warpgroups (U8_CONSUMERS)
constexpr int THREADS = 128 * (1 + CW);
// A stage is KT rows (KT / 32 k-steps; 128, 256 or 512 by the plan). The
// producer loads AHEAD stages ahead, 1024 rows at least, into AHEAD + 1
// staged slots: pos (int32), gq, hq (f32), gq, hq as int8 of KT rows, then
// the consumers' features' bins (CW x KT).
__host__ __device__ constexpr int ahead_of(int kt) {
  return 1024 / kt > 2 ? 1024 / kt : 2;
}
__host__ __device__ constexpr int raw_bytes_of(int kt) {
  return kt * 14 + CW * kt;
}

// ---- PTX wrappers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most AHEAD - 1 of this thread's cp.async groups are in
// flight: the oldest stage has landed
template <int AHEAD>
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(AHEAD - 1) : "memory");
}

__device__ __forceinline__ void producer_sync() {
  asm volatile("bar.sync 1, 128;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int PENDING>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(PENDING)
               : "memory");
}

// B-operand descriptor of one k-step of PV: K-major, no swizzle; the two
// 16-byte k-halves of a core matrix 128 bytes apart (leading byte offset),
// 8-row groups 256 bytes apart (stride byte offset)
__device__ __forceinline__ uint64_t pv_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4)
       | ((uint64_t)(128 >> 4) << 16) | ((uint64_t)(256 >> 4) << 32);
}

// D (64 x W, s32) += A (64 x 32 s8, registers) * B (32 x W s8, smem)
template <int W>
__device__ __forceinline__ void wgmma_rs(int32_t (&d)[W / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_rs<32>(
    int32_t (&d)[16], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(
    int32_t (&d)[32], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<96>(
    int32_t (&d)[48], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(
    int32_t (&d)[64], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<192>(
    int32_t (&d)[96], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %101, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95"
      "}, {%96, %97, %98, %99}, %100, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_rs<256>(
    int32_t (&d)[128], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63]), "+r"(d[64]),
        "+r"(d[65]), "+r"(d[66]), "+r"(d[67]), "+r"(d[68]), "+r"(d[69]),
        "+r"(d[70]), "+r"(d[71]), "+r"(d[72]), "+r"(d[73]), "+r"(d[74]),
        "+r"(d[75]), "+r"(d[76]), "+r"(d[77]), "+r"(d[78]), "+r"(d[79]),
        "+r"(d[80]), "+r"(d[81]), "+r"(d[82]), "+r"(d[83]), "+r"(d[84]),
        "+r"(d[85]), "+r"(d[86]), "+r"(d[87]), "+r"(d[88]), "+r"(d[89]),
        "+r"(d[90]), "+r"(d[91]), "+r"(d[92]), "+r"(d[93]), "+r"(d[94]),
        "+r"(d[95]), "+r"(d[96]), "+r"(d[97]), "+r"(d[98]), "+r"(d[99]),
        "+r"(d[100]), "+r"(d[101]), "+r"(d[102]), "+r"(d[103]), "+r"(d[104]),
        "+r"(d[105]), "+r"(d[106]), "+r"(d[107]), "+r"(d[108]), "+r"(d[109]),
        "+r"(d[110]), "+r"(d[111]), "+r"(d[112]), "+r"(d[113]), "+r"(d[114]),
        "+r"(d[115]), "+r"(d[116]), "+r"(d[117]), "+r"(d[118]), "+r"(d[119]),
        "+r"(d[120]), "+r"(d[121]), "+r"(d[122]), "+r"(d[123]), "+r"(d[124]),
        "+r"(d[125]), "+r"(d[126]), "+r"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc),
        "r"(1));
}


// ---- the work list ---------------------------------------------------------

// four f32 integers in [-127, 127] as packed int8, row j in byte j
__device__ __forceinline__ uint32_t pack_i8(float4 v) {
  return ((uint32_t)(uint8_t)__float2int_rz(v.x))
       | ((uint32_t)(uint8_t)__float2int_rz(v.y) << 8)
       | ((uint32_t)(uint8_t)__float2int_rz(v.z) << 16)
       | ((uint32_t)(uint8_t)__float2int_rz(v.w) << 24);
}

struct Shape {
  const uint8_t* bins;
  long long n, rows_per_block;
  int F, N, B, fg, n_fgroups, n_items, upf, n_mgroups, n_ntiles, kt;
};

struct Unit {  // one consumer's share of an item
  int f, ntile, mgroup;
};

// A block's walk over its items (blockIdx.x, + gridDim.x, ...), each item's
// rounds and each round's stages; the producer's two cursors and each
// consumer's one step through the same sequence. A round's units (and
// their divisions) are worked out once, when the round starts.
struct Cursor {
  int item, round, stage, rounds, stages, u0, u1;
  long long r0, r1;
  Unit un[CW];
  bool on[CW];  // consumer c has a unit this round
  int reg1;     // consumer 1's PV region: 1 when its n-tile is not c0's

  __device__ void start(const Shape& s, int it) {
    item = it;
    round = stage = 0;
    if (it >= s.n_items) return;
    const int fgi = it % s.n_fgroups;
    const long long chunk = it / s.n_fgroups;
    const int f0 = fgi * s.fg;
    const int f1 = min(s.F, f0 + s.fg);
    u0 = f0 * s.upf;
    u1 = f1 * s.upf;
    rounds = (u1 - u0 + CW - 1) / CW;
    r0 = chunk * s.rows_per_block;
    r1 = min(s.n, r0 + s.rows_per_block);
    stages = (int)((r1 - r0 + s.kt - 1) / s.kt);
    set_round(s);
  }
  __device__ void set_round(const Shape& s) {
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      const int u = u0 + round * CW + c;
      on[c] = u < u1;
      un[c].f = u / s.upf;
      const int rem = u - un[c].f * s.upf;
      un[c].ntile = rem / s.n_mgroups;
      un[c].mgroup = rem - un[c].ntile * s.n_mgroups;
    }
    reg1 = on[0] && on[1] && un[1].ntile != un[0].ntile;
  }
  __device__ bool done(const Shape& s) const { return item >= s.n_items; }
  __device__ void advance(const Shape& s) {
    if (++stage < stages) return;
    stage = 0;
    if (++round < rounds) {
      set_round(s);
      return;
    }
    start(s, item + gridDim.x);
  }
  __device__ long long row0(const Shape& s) const {
    return r0 + (long long)stage * s.kt;
  }
};

// 0x01 in each byte of w that equals the byte of bb, else 0x00: an exact
// zero-byte test of w ^ bb (the 7-bit sums carry into no other byte)
__device__ __forceinline__ uint32_t eq_bytes(uint32_t w, uint32_t bb) {
  const uint32_t x = w ^ bb;
  const uint32_t y = (x & 0x7F7F7F7Fu) + 0x7F7F7F7Fu;
  return (~(y | x) & 0x80808080u) >> 7;
}

// A fragments of two k-steps (64 bytes of bins at sb): rows (bins) bin
// and bin + 8 of m-tile m, k columns 4 tig .. + 3 (registers 0, 1) and
// 16 + 4 tig .. + 3 (2, 3); bb[m][h] is bin + 8 h of m-tile m in all four
// bytes
template <int MTW>
__device__ __forceinline__ void one_hot(uint32_t (&a)[2][MTW][4],
                                        const uint8_t* sb, int tig,
                                        const uint32_t (&bb)[MTW][2]) {
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint32_t w0 = *(const uint32_t*)(sb + kk * 32 + tig * 4);
    const uint32_t w1 = *(const uint32_t*)(sb + kk * 32 + 16 + tig * 4);
#pragma unroll
    for (int m = 0; m < MTW; ++m) {
      a[kk][m][0] = eq_bytes(w0, bb[m][0]);
      a[kk][m][1] = eq_bytes(w0, bb[m][1]);
      a[kk][m][2] = eq_bytes(w1, bb[m][0]);
      a[kk][m][3] = eq_bytes(w1, bb[m][1]);
    }
  }
}

// one wgmma group: two k-steps of PV (at pv) x MTW m-tiles
template <int W, int MTW>
__device__ __forceinline__ void mma_group(int32_t (&acc)[MTW][W / 2],
                                          const uint32_t (&a)[2][MTW][4],
                                          const uint8_t* pv) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    const uint64_t desc = pv_desc(pv + kk * W * 32);
#pragma unroll
    for (int m = 0; m < MTW; ++m) wgmma_rs<W>(acc[m], a[kk][m], desc);
  }
  wgmma_commit();
}

__device__ __forceinline__ uint32_t row_mask(int4 p4, int id) {
  return (p4.x == id ? 0x000000FFu : 0u) | (p4.y == id ? 0x0000FF00u : 0u)
       | (p4.z == id ? 0x00FF0000u : 0u) | (p4.w == id ? 0xFF000000u : 0u);
}

// ---- the kernel ------------------------------------------------------------

// Shared memory: `ring` stages of [PV regions x (KT / 32 k-steps x W x 32
// bytes) | the consumers' bins (CW x KT)], AHEAD + 1 staged slots of rows
// (raw_bytes_of(KT) each), the full and empty mbarriers of the ring, and
// the producer's per-round tables (id and channel of each PV row of each
// region) for waves of more than one n-tile.
//
// The producer loads rows AHEAD stages ahead into the staged slots, which
// only it reads (cp.async; no wait on the consumers), converts the g and h
// of the rows it loaded to int8 once, and builds PV into the ring once its
// slot is free. With one n-tile (3N <= W, every wave up to 85 slots) a
// producer thread owns fixed (slot, 4-row quad) pairs for the whole
// kernel: slot 8 (gb + 2i) + r, quad 4 cq + kkw of every k-step, the slot's
// id in a register. Per pair and k-step it makes one mask of four position
// compares and stores it ANDed with g, h and 1 into the slot's three PV
// rows (c*N + s); a warp's stores fall in 32 distinct banks. Pad ids and
// the rows past 3N are never written: the PV buffers are zeroed once.
// With more n-tiles every word of a region is written from per-round
// tables.
template <int W, int MTW, int KT>
__global__ void __launch_bounds__(THREADS, 1)
hist_u8_kernel(Shape s, const int32_t* __restrict__ pos,
               const float* __restrict__ gq, const float* __restrict__ hq,
               const int32_t* __restrict__ node_ids, int regions, int ring,
               int rows_vec, int bins_vec, int32_t* __restrict__ out) {
  constexpr int KSTEPS = KT / 32;
  constexpr int AHEAD = ahead_of(KT);
  constexpr int RAW = AHEAD + 1;
  constexpr int RAW_BYTES = raw_bytes_of(KT);
  extern __shared__ __align__(128) uint8_t smem[];
  const int pv_bytes = KSTEPS * W * 32;  // one region of one stage
  const int stage_bytes = regions * pv_bytes + CW * KT;
  uint8_t* raw = smem + (size_t)ring * stage_bytes;
  uint64_t* full = (uint64_t*)(raw + RAW * RAW_BYTES);
  uint64_t* empty = full + ring;
  int32_t* tab_id = (int32_t*)(empty + ring);  // [regions][W]
  uint8_t* tab_ch = (uint8_t*)(tab_id + 2 * W);  // [regions][W]

  if (threadIdx.x == 0) {
    for (int i = 0; i < ring; ++i) {
      mbar_init(&full[i], 128);
      mbar_init(&empty[i], 128 * CW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int slot = 0; slot < ring; ++slot) {  // PV starts all zero
    uint4* pv = (uint4*)(smem + (size_t)slot * stage_bytes);
    for (int i = threadIdx.x; i < regions * pv_bytes / 16; i += THREADS)
      pv[i] = make_uint4(0, 0, 0, 0);
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const int wg = threadIdx.x / 128;
  const int t = threadIdx.x % 128;
  const int rows3 = 3 * s.N;

  if (wg == 0) {
    // ---------------- producer ----------------
    Cursor ld, bd;
    ld.start(s, blockIdx.x);
    bd.start(s, blockIdx.x);
    // staged slots (loads, builds) and the ring's slot and phase, kept as
    // counters: no division a stage
    int raw_ld = 0, raw_bd = 0, slot = 0;
    uint32_t phase = 0;
    bool wrapped = false;  // the ring has been filled once

    // stage a stage's rows into staged slot rs_slot: cp.async, one group a
    // stage (an empty group past the last stage keeps the count)
    auto issue = [&](const Cursor& c, int rs_slot) {
      if (!c.done(s)) {
        uint8_t* st = raw + rs_slot * RAW_BYTES;
        int32_t* spos = (int32_t*)st;
        float* sg = (float*)(st + KT * 4);
        float* sh = (float*)(st + KT * 8);
        uint8_t* sb = st + KT * 14;
        const long long rs = c.row0(s);
        // four rows a thread: 16-byte copies where the rows allow
        for (int rr = 4 * t; rr < KT; rr += 512) {
          const long long k = rs + rr;
          if (rows_vec && k + 4 <= c.r1) {
            cp_async16(spos + rr, pos + k);
            cp_async16(sg + rr, gq + k);
            cp_async16(sh + rr, hq + k);
            continue;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            if (k + j < c.r1) {
              cp_async4(spos + rr + j, pos + k + j);
              cp_async4(sg + rr + j, gq + k + j);
              cp_async4(sh + rr + j, hq + k + j);
            } else {
              spos[rr + j] = -1;  // past the chunk: in no node, no PV
            }
          }
        }
#pragma unroll
        for (int cc = 0; cc < CW; ++cc) {
          if (!c.on[cc]) continue;
          const uint8_t* src = s.bins + (long long)c.un[cc].f * s.n + rs;
          uint8_t* dst = sb + cc * KT;
          if (!bins_vec) {
            for (int rr = t; rr < KT; rr += 128)
              dst[rr] = rs + rr < s.n ? src[rr] : 0;
          } else if (t < KT / 16) {
            const int j = 16 * t;
            if (rs + j + 16 <= s.n) {
              cp_async16(dst + j, src + j);
            } else {
              for (int b = 0; b < 16; ++b)
                dst[j + b] = rs + j + b < s.n ? src[j + b] : 0;
            }
          }
        }
      }
      cp_async_commit();
    };

    // the one-n-tile build's fixed pairs (see above)
    constexpr int SP = (W / 3 + 15) / 16;
    const int lane = t & 31, wp = t >> 5;
    const int r8 = lane >> 2, kkw = lane & 3, cq = wp & 1, gb = wp >> 1;
    const int q = cq * 4 + kkw;
    int sid[SP];
    int off[SP][3];
#pragma unroll
    for (int i = 0; i < SP; ++i) {
      const int sl = 8 * (gb + 2 * i) + r8;
      sid[i] = sl < s.N ? max(node_ids[sl], -1) : -1;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int p = ch * s.N + sl;
        off[i][ch] = (p >> 3) * 256 + cq * 128 + (p & 7) * 16 + kkw * 4;
      }
    }
    // the tables' fixed words: word t + 128 i of a k-step block is PV row
    // p0 + 16 i, rows 4 qt .. 4 qt + 3 of the k-step
    const int p0 = (t >> 6) * 8 + ((t >> 2) & 7);
    const int qt = ((t >> 5) & 1) * 4 + (t & 3);

    for (int k = 0; k < AHEAD; ++k) {
      issue(ld, raw_ld);
      raw_ld = raw_ld + 1 == RAW ? 0 : raw_ld + 1;
      if (!ld.done(s)) ld.advance(s);
    }
    while (!bd.done(s)) {
      uint8_t* rw = raw + raw_bd * RAW_BYTES;
      const int32_t* spos = (const int32_t*)rw;
      int8_t* sgi = (int8_t*)(rw + KT * 12);
      int8_t* shi = sgi + KT;
      cp_async_wait_oldest<AHEAD>();
      // g and h as int8 of the rows this thread loaded (past the chunk:
      // unused)
      for (int rr = 4 * t; rr < KT; rr += 512) {  // the rows it loaded
        const float4* g4 = (const float4*)(rw + KT * 4) + rr / 4;
        const float4* h4 = (const float4*)(rw + KT * 8) + rr / 4;
        *(uint32_t*)(sgi + rr) = pack_i8(*g4);
        *(uint32_t*)(shi + rr) = pack_i8(*h4);
      }
      producer_sync();  // the stage's rows are in; the last build is done
      // the staged slot of the stage AHEAD on was read by the last build
      issue(ld, raw_ld);
      raw_ld = raw_ld + 1 == RAW ? 0 : raw_ld + 1;
      raw_bd = raw_bd + 1 == RAW ? 0 : raw_bd + 1;
      if (!ld.done(s)) ld.advance(s);

      if (wrapped)  // the consumers are done with the slot's last stage
        mbar_wait(&empty[slot], phase ^ 1);
      uint8_t* st = smem + (size_t)slot * stage_bytes;
      for (int e = t; e < CW * KT / 16; e += 128)  // the consumers' bins
        ((uint4*)(st + regions * pv_bytes))[e] =
            ((const uint4*)(rw + KT * 14))[e];
      if (s.n_ntiles == 1) {
#pragma unroll 4
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const int kr = ks * 32 + 4 * q;
          const int4 p4 = *(const int4*)(spos + kr);
          const uint32_t gw = *(const uint32_t*)(sgi + kr);
          const uint32_t hw = *(const uint32_t*)(shi + kr);
          uint8_t* pv = st + ks * W * 32;
#pragma unroll
          for (int i = 0; i < SP; ++i) {
            if (sid[i] < 0) continue;
            const uint32_t m = row_mask(p4, sid[i]);
            *(uint32_t*)(pv + off[i][0]) = m & gw;
            *(uint32_t*)(pv + off[i][1]) = m & hw;
            *(uint32_t*)(pv + off[i][2]) = m & 0x01010101u;
          }
        }
      } else {
        if (bd.stage == 0) {  // a new round: the regions' row tables
          for (int e = t; e < 2 * W; e += 128) {
            const int rg = e / W, pl = e % W;
            const int nt = rg == 0 ? (bd.on[0] ? bd.un[0].ntile : -1)
                                   : (bd.reg1 ? bd.un[1].ntile : -1);
            const int p = nt * W + pl;
            int id = -1, ch = 0;
            if (nt >= 0 && p < rows3) {
              ch = p / s.N;
              id = max(node_ids[p - ch * s.N], -1);  // a pad matches none
            }
            tab_id[e] = id;
            tab_ch[e] = (uint8_t)ch;
          }
          producer_sync();
        }
#pragma unroll 1
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const int kr = ks * 32 + 4 * qt;
          const int4 p4 = *(const int4*)(spos + kr);
          const uint32_t gw = *(const uint32_t*)(sgi + kr);
          const uint32_t hw = *(const uint32_t*)(shi + kr);
          for (int rg = 0; rg <= bd.reg1; ++rg) {
            uint32_t* pw = (uint32_t*)(st + rg * pv_bytes + ks * W * 32);
#pragma unroll
            for (int i = 0; i < W / 16; ++i) {
              const int pl = p0 + 16 * i;
              const int id = tab_id[rg * W + pl];
              uint32_t w = 0;
              if (id >= 0) {
                const int ch = tab_ch[rg * W + pl];
                w = row_mask(p4, id)
                    & (ch == 0 ? gw : ch == 1 ? hw : 0x01010101u);
              }
              pw[t + 128 * i] = w;
            }
          }
        }
      }
      // PV is read by the tensor cores (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      mbar_arrive(&full[slot]);
      if (++slot == ring) {
        slot = 0;
        phase ^= 1;
        wrapped = true;
      }
      bd.advance(s);
    }
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    return;
  }

  // ---------------- consumers ----------------
  const int c = wg - 1;
  const int wq = t / 32;         // warp of the warpgroup: bins 16 wq ..
  const int grp = (t % 32) / 4;  // groupID of the fragment layouts
  const int tig = t % 4;         // thread in group
  int32_t acc[MTW][W / 2];
  Cursor cur;
  cur.start(s, blockIdx.x);
  int slot = 0;
  uint32_t phase = 0;
  Unit un = {0, 0, 0};
  bool active = false;
  int rg = 0;
  while (!cur.done(s)) {
    if (cur.stage == 0) {  // (c selects without indexing: no local memory)
      active = c == 0 ? cur.on[0] : cur.on[1];
      un = c == 0 ? cur.un[0] : cur.un[1];
      rg = c == 1 ? cur.reg1 : 0;
#pragma unroll
      for (int m = 0; m < MTW; ++m)
#pragma unroll
        for (int i = 0; i < W / 2; ++i) acc[m][i] = 0;
    }
    mbar_wait(&full[slot], phase);
    if (active) {
      const uint8_t* st = smem + (size_t)slot * stage_bytes;
      const uint8_t* sb = st + regions * pv_bytes + c * KT;
      // two k-steps a wgmma group; a group's A fragments are built while
      // the previous group runs, in the other of two register sets
      const uint8_t* pv = st + rg * pv_bytes;
      uint32_t a0[2][MTW][4], a1[2][MTW][4];
      uint32_t bb[MTW][2];
#pragma unroll
      for (int m = 0; m < MTW; ++m)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          bb[m][h] = (uint32_t)((un.mgroup * MTW + m) * 64 + wq * 16 + grp
                                + 8 * h) * 0x01010101u;
#pragma unroll 1
      for (int k0 = 0; k0 < KSTEPS; k0 += 4) {
        one_hot<MTW>(a0, sb + k0 * 32, tig, bb);
        mma_group<W, MTW>(acc, a0, pv + k0 * W * 32);
        wgmma_wait<1>();  // the group before (a1's) is done
        one_hot<MTW>(a1, sb + (k0 + 2) * 32, tig, bb);
        mma_group<W, MTW>(acc, a1, pv + (k0 + 2) * W * 32);
        wgmma_wait<1>();  // a0's group is done
      }
      wgmma_wait<0>();
    }
    mbar_arrive(&empty[slot]);
    if (++slot == ring) {
      slot = 0;
      phase ^= 1;
    }
    const bool last = cur.stage + 1 == cur.stages;
    if (last && active) {
      // D fragment (64 x W s32): n8 block j, register i holds bin row
      // 16 wq + grp (+ 8 for i >= 2), PV row 8 j + 2 tig (+ 1 for odd i)
      int32_t* of = out + (size_t)un.f * rows3 * s.B;
#pragma unroll
      for (int m = 0; m < MTW; ++m) {
        const int bin0 = (un.mgroup * MTW + m) * 64 + wq * 16 + grp;
#pragma unroll
        for (int i = 0; i < W / 2; ++i) {
          const int v = acc[m][i];
          const int bin = bin0 + ((i & 2) ? 8 : 0);
          const int p = un.ntile * W + (i / 4) * 8 + 2 * tig + (i & 1);
          if (v != 0 && bin < s.B && p < rows3)
            atomicAdd(of + (size_t)p * s.B + bin, v);
        }
      }
    }
    cur.advance(s);
  }
}

template <int W, int MTW, int KT>
int launch(const Shape& s, const int32_t* pos, const float* gq,
           const float* hq, const int32_t* node_ids, int regions, int ring,
           int rows_vec, int bins_vec, int blocks, int smem_bytes,
           int32_t* out, cudaStream_t stream) {
  auto kern = hist_u8_kernel<W, MTW, KT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return (int)err;
  kern<<<blocks, THREADS, smem_bytes, stream>>>(s, pos, gq, hq, node_ids,
                                                regions, ring, rows_vec,
                                                bins_vec, out);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K8 launch (hist.py::u8_plan): W the wgmma width of an n-tile, mtw its
// 64-bin m-tiles a consumer, kt the rows of a stage, n_ntiles x n_mgroups
// units a feature, fg features an item, blocks a persistent grid over
// n_fgroups x n_chunks items, ring stages of PV (smem_bytes in all);
// rows_vec / bins_vec: the rows / bins may be copied 16 bytes at a time.
// out (F, 3N, B) int32, zeroed by the caller. Returns the cudaError_t of
// the launch (0 = launched).
int ytk_hist_q_u8(const uint8_t* bins, long long n, const int32_t* pos,
                  const float* gq, const float* hq, const int32_t* node_ids,
                  int N, int F, int B, int W, int mtw, int kt, int n_ntiles,
                  int n_mgroups, int fg, int n_fgroups, long long n_chunks,
                  long long rows_per_block, int regions, int ring,
                  int rows_vec, int bins_vec, int blocks, int smem_bytes,
                  int32_t* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const long long items = (long long)n_fgroups * n_chunks;
  if (B < 1 || B > 256 || items > 0x7FFFFFFF || regions < 1 || regions > CW
      || ring < 2)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.bins = bins;
  s.n = n;
  s.rows_per_block = rows_per_block;
  s.F = F;
  s.N = N;
  s.B = B;
  s.fg = fg;
  s.n_fgroups = n_fgroups;
  s.n_items = (int)items;
  s.upf = n_ntiles * n_mgroups;
  s.n_mgroups = n_mgroups;
  s.n_ntiles = n_ntiles;
  s.kt = kt;
#define YTK_ARGS s, pos, gq, hq, node_ids, regions, ring, rows_vec, bins_vec, \
    blocks, smem_bytes, out, st
  // the (W, mtw, kt) instances hist.py::u8_plan picks
  switch ((W * 8 + mtw) * 1024 + kt) {
    case (32 * 8 + 1) * 1024 + 512: return launch<32, 1, 512>(YTK_ARGS);
    case (32 * 8 + 2) * 1024 + 512: return launch<32, 2, 512>(YTK_ARGS);
    case (64 * 8 + 1) * 1024 + 512: return launch<64, 1, 512>(YTK_ARGS);
    case (64 * 8 + 2) * 1024 + 512: return launch<64, 2, 512>(YTK_ARGS);
    case (96 * 8 + 1) * 1024 + 512: return launch<96, 1, 512>(YTK_ARGS);
    case (96 * 8 + 2) * 1024 + 512: return launch<96, 2, 512>(YTK_ARGS);
    case (128 * 8 + 1) * 1024 + 512: return launch<128, 1, 512>(YTK_ARGS);
    case (192 * 8 + 1) * 1024 + 256: return launch<192, 1, 256>(YTK_ARGS);
    case (192 * 8 + 1) * 1024 + 128: return launch<192, 1, 128>(YTK_ARGS);
    case (256 * 8 + 1) * 1024 + 256: return launch<256, 1, 256>(YTK_ARGS);
    case (256 * 8 + 1) * 1024 + 128: return launch<256, 1, 128>(YTK_ARGS);
  }
#undef YTK_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* ytk_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
