// Hopper (sm_90a) building blocks for the flash-attention kernels:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the three
// wgmma shapes the bf16/fp16 kernels use (f32 accumulators), the two tf32
// shapes of the f32 kernels (m64n64k8 with A from shared memory or from
// registers), register-count hand-off (setmaxnreg), named barriers, and
// the host-side tensor maps of a [B, S, H, D] bf16 or fp16 operand (D =
// 128 to 512) and of a [B, S, H, D] f32 one.
//
// Tile layout shared by TMA and wgmma. Every operand tile is 64 rows of D
// two-byte elements (D / 64 panels), stored as D / 64 panels of 8 KB
// (columns 0-63, 64-127, ...), each 64 rows of 128 bytes with the 128-byte
// swizzle (16-byte chunk c of row r sits at chunk c ^ (r % 8)). One TMA box
// is one panel ({64 columns, 1 head, 64 rows, 1 batch}); a panel is
// 1024-byte aligned, so the swizzle phase matches what wgmma's SWIZZLE_128B
// layout expects. Rows past the end of the sequence are filled with zeros
// by TMA (the box may reach past it; a load still completes the whole
// box's bytes on its mbarrier).
//   * K-major operand (rows are M or N, the D columns are K): k-step kk
//     (16 columns, kk < D / 16) starts at panel kk / 4, byte 32 * (kk % 4);
//     8-row groups are 1024 bytes apart (SBO).
//   * N-major operand (rows are K, the columns are N): k-step kk (16 rows)
//     starts at byte 2048 * kk of a panel; one wgmma reads N = 128 columns,
//     two neighbouring panels 8 KB apart (LBO), 8-row groups 1024 bytes
//     apart (SBO). Columns 128-255 of a D = 256 tile start at panel 2. The
//     64-column form (m64n64k16) reads one panel.
//
// Accumulator layout of wgmma m64nN (f32): thread t of the warpgroup,
// warp w = t / 32, lane l; register 4n + e holds row 16w + l/4 + 8(e/2),
// column 8n + 2(l%4) + e%2. Every row is spread over the 4 lanes of one
// quad, so a row reduction is two xor-shuffles (1, 2).
//
// f32 tiles (tf32 wgmma). A 128-byte row holds 32 f32 values, so a panel
// is 64 rows of 32 columns (8 KB, the same bytes as a bf16 panel) and one
// TMA box of the f32 map is one such panel. tf32 wgmma reads its shared-
// memory operands K-major only (no transpose bit): k-step kk of a panel
// (8 columns, kk < 4) starts at byte 32 kk, 8-row groups 1024 bytes apart
// (desc_panel). Its register A fragment (m64k8, 4 registers) is that of
// mma.m16n8k8.tf32: register r of lane l of warp w holds row 16w + l/4 +
// 8(r%2), column l%4 + 4(r/2), which is not the accumulator's 2(l%4) +
// e%2 (see the kernels for how they reconcile the two).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>
#include <dlfcn.h>
#include <stdint.h>

#include <type_traits>

namespace hopper {

constexpr int TILE_ROWS = 64;
constexpr int PANEL_BYTES = TILE_ROWS * 128;  // 64 rows x 64 elements
// A whole 64-row tile of head_dim D: D / 64 panels.
template <int D>
constexpr int TILE_BYTES = D / 64 * PANEL_BYTES;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ----------------------------------------------------------------- mbarrier

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and add `bytes` to the transactions the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Block until the barrier's current phase parity differs from `parity`
// (i.e. the phase numbered `parity` has completed).
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------------- TMA

// One box {64 columns, 1 head, 64 rows, 1 batch} of a [B, S, H, D] map
// at column c0, head h, row s, batch b into `dst` (8 KB, 1024-aligned).
__device__ __forceinline__ void tma_load_panel(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int c0, int h,
                                              int s, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(h),
      "r"(s), "r"(b)
      : "memory");
}

// A whole 64 x D tile: its D / 64 panels (TILE_BYTES<D> of transactions).
template <int D>
__device__ __forceinline__ void tma_load_tile(void* dst, const CUtensorMap* map,
                                              uint64_t* bar, int h, int s,
                                              int b) {
#pragma unroll
  for (int c = 0; c < D / 64; ++c)
    tma_load_panel(static_cast<char*>(dst) + c * PANEL_BYTES, map, bar, 64 * c,
                  h, s, b);
}

// Contiguous bytes (16-byte aligned, a multiple of 16) into shared memory.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// -------------------------------------------------------------------- wgmma

__device__ __forceinline__ uint64_t desc_encode(const void* p, uint32_t lbo,
                                                uint32_t sbo) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
  return d;
}

// k-step kk (8 f32 columns, kk < 4) of one 64-row K-major f32 panel.
__device__ __forceinline__ uint64_t desc_panel(const void* panel, int kk) {
  return desc_encode(static_cast<const char*>(panel) + kk * 32, 16, 1024);
}

// k-step kk (16 of the D columns) of a K-major tile.
__device__ __forceinline__ uint64_t desc_kmajor(const void* tile, int kk) {
  const char* p = static_cast<const char*>(tile) + (kk / 4) * PANEL_BYTES +
                  (kk % 4) * 32;
  return desc_encode(p, 16, 1024);
}

// k-step kk (16 of the 64 rows) of an N-major tile: the 128 columns from
// `tile`'s first panel on.
__device__ __forceinline__ uint64_t desc_nmajor(const void* tile, int kk) {
  return desc_encode(static_cast<const char*>(tile) + kk * 2048, PANEL_BYTES,
                     1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Wait until at most N committed groups are still in flight (groups
// complete in order).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (its asm statement names them as written
// at once, but they are written when the group completes).
template <int N>
__device__ __forceinline__ void reg_fence(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D[64 x 64] (f32, 32 registers a thread) (+)= A[64 x 16] . B[64 x 16]^T,
// A and B both K-major in shared memory (descriptors); accumulate = 0
// overwrites D. T is __nv_bfloat16 or __half.
#define HOPPER_WGMMA_SS(TY)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "         \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "         \
      "%26, %27, %28, %29, %30, %31 "                                        \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "l"(da), "l"(db), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t da,
                                                   uint64_t db, int accumulate) {
  if constexpr (std::is_same<T, __half>::value)
    HOPPER_WGMMA_SS("f16");
  else
    HOPPER_WGMMA_SS("bf16");
}

// D[64 x 128] (f32, 64 registers a thread) += A[64 x 16] . B[16 x 128],
// A from registers (pairs of T, see frag_a), B N-major in shared memory
// (transposed read, imm-trans-b = 1).
#define HOPPER_WGMMA_RS(TY)                                                   \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"          \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "         \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "         \
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "         \
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "         \
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "         \
      "%62, %63 "                                                            \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),     \
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),     \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),     \
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),     \
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),     \
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),     \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                   \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    HOPPER_WGMMA_RS("f16");
  else
    HOPPER_WGMMA_RS("bf16");
}

// D[64 x 64] (f32, 32 registers a thread) += A[64 x 16] . B[16 x 64]: the
// 64-column form of the above, B one N-major panel.
#define HOPPER_WGMMA_RS64(TY)                                                 \
  asm volatile(                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                           \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"           \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "         \
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "         \
      "%26, %27, %28, %29, %30, %31 "                                        \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),          \
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),          \
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),     \
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),     \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),     \
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),     \
        "+f"(d[30]), "+f"(d[31])                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  if constexpr (std::is_same<T, __half>::value)
    HOPPER_WGMMA_RS64("f16");
  else
    HOPPER_WGMMA_RS64("bf16");
}

// D[64 x 64] (f32, 32 registers a thread) (+)= A[64 x 8] . B[64 x 8]^T in
// tf32, A and B K-major in shared memory (descriptors); accumulate = 0
// overwrites D. tf32 takes no transpose immediates.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[32], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] . B[64 x 8]^T in tf32, A from registers (four
// tf32 values in the m16n8k8 A layout, see above), B K-major in shared
// memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// Two f32 values rounded to a pair of T (round to nearest even), low
// half first.
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<T, __half>::value) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
}

// A-operand fragment (k-step kk: columns 16kk..16kk+15) of a 64 x 64 f32
// accumulator, rounded to T: wgmma's register A layout is the accumulator
// layout of those 16 columns, two values to a register.
template <typename T>
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const float (&s)[32],
                                       int kk) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
    a[r] = pack2<T>(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
}

// ------------------------------------------------ warp specialisation

template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Named barrier `id` (1-15; 0 is __syncthreads) over `count` threads:
// wait, or (named_arrive) arrive without waiting. Shared-memory writes made
// before an arrival are visible to the threads that waited on it.
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ host

// Tensor map of a [B, S, H, D] bf16 (or, with fp16 set, fp16) tensor
// with element strides (sb, ss, sh) and unit stride over the D: one box
// is one tile panel (see tma_load_panel). S is the real length: rows of a
// box at or past it load as zeros. cuTensorMapEncodeTiled is looked up in
// libcuda, which the CUDA runtime has already loaded, so the library
// links no -lcuda.
inline CUresult make_bshd_map(CUtensorMap* map, const void* base, int B, int S,
                              int H, int D, int sb, int ss, int sh, bool fp16) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
    if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, TILE_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map,
                fp16 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                4, const_cast<void*>(base),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Tensor map of a [B, S, H, D] f32 tensor with element strides (sb, ss,
// sh) and unit stride over the D: one box is one f32 panel, {32 columns,
// 1 head, 64 rows, 1 batch}, 128-byte swizzled; rows at or past S load as
// zeros. Any 4-D f32 array whose inner index has unit stride maps so (a
// [B, H, D, S] transpose as B, D rows, H, S columns).
inline CUresult make_bshd_map_f32(CUtensorMap* map, const void* base, int B,
                                  int S, int H, int D, int64_t sb, int64_t ss,
                                  int64_t sh) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr)
      encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(
          dlsym(lib, "cuTensorMapEncodeTiled"));
    if (encode == nullptr) return CUDA_ERROR_NOT_FOUND;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 4, (cuuint64_t)ss * 4,
                                 (cuuint64_t)sb * 4};
  const cuuint32_t box[4] = {32, 1, TILE_ROWS, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4,
                const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

}  // namespace hopper
