// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels
// of f32 inputs, on tensor cores, at head_dim 128, 256, 384 and 512.
//
// Replace, for f32 inputs, the three Pallas TPU kernels of
// tf_operator_tpu/ops/flash_attention.py:
//   flash_fwd_f32tc_kernel <- _fwd_kernel (:95; _fwd, pallas_call :143)
//   flash_dkv_f32tc_kernel <- _dkv_kernel (:207; _bwd_impl, pallas_call :289)
//   flash_dq_f32tc_kernel  <- _dq_kernel  (:183; _bwd_impl, pallas_call :261)
// with the TPU kernels' function, no cast points in f32: causal or not
// with q_offset, GQA (head h reads KV head h / (H / Hkv)), lengths of any
// multiple of 8 (rows past Sq or Sk load as zeros and are never stored;
// query columns past Sq get P = dS = 0), masked scores at the finite
// -1e30, a softmax sum of 0 guarded as 1, keys no query sees given zero
// dK and dV, and dK/dV summed over the GQA group inside one CTA in a
// fixed order (no atomics: deterministic).
//
// 3xTF32. A TF32 product keeps 10 mantissa bits of each operand, about
// 1e-4 of a value, where the f32 kernels are held to 1e-5. So every f32
// operand x, loaded (Q, K, V, dO) or computed (P, P^T, dS^T, dS), is split
// into hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each
// product is lo.hi + hi.lo + hi.hi, small terms first: about 2^-21 of a
// product is left (the lo.lo term, 2^-22, is dropped).
//
// What bounds them on the card. The least time is the tensor cores': per
// visible (key, query) pair and head the forward does 4 D FLOPs, the dK/dV
// 8 D and the dQ 6 D, each as three TF32 products at 494.7 TFLOP/s (H100
// SXM dense TF32). Every operand they stream is twice f32's bytes (hi and
// lo), 128 KB of tiles a forward k tile (2 q tiles), 256 KB a dK/dV item
// and 192 KB a dQ k tile at D = 128, some 1 KB per 50-100 KFLOP. What
// holds the dK/dV back is that L2 traffic: leaving its K and V loads out
// of a run (results wrong) cut its time by the third of the bytes they
// are, so the designs below keep what they can resident and stream the
// rest. The dQ at D = 128 is not held back so; at 256-512 it is (see
// there).
//
// All three are the Hopper design of the bf16 kernels (flash_attention.cu,
// hopper.cuh): warp-specialised CTAs of 384 threads, two consumer
// warpgroups (setmaxnreg 232) that run wgmma.mma_async m64n64k8
// .f32.tf32.tf32 and one producer warpgroup (setmaxnreg 40) whose first
// thread (in the streamed dK/dV and dQ, first two) issues TMA loads
// (cp.async.bulk.tensor, 128-byte swizzle) of 64-row f32 panels into a
// ring of shared-memory slots with a "full" (TMA transaction bytes) and an
// "empty" mbarrier each; no __syncthreads after set-up. How each hard part
// is met:
//   1. Operand layout. tf32 wgmma reads shared-memory operands K-major
//      only. S = Q K^T, dP = dO V^T and, in the dK/dV, S^T = K Q^T and
//      dP^T = V dO^T reduce over head_dim, along which Q, K, V and dO are
//      contiguous: both operands come straight from their rows. O += P V,
//      dV += P^T dO, dK += dS^T Q and dQ += dS K reduce over keys or
//      queries, so their B operands are V^T, dO^T, Q^T and K^T. A prologue
//      kernel (flash_split_f32tc_kernel, one launch an operand) writes
//      them once a call, [B, H, D, S] beside [B, S, H, D] copies of the
//      operands the entry reads in rows, each as hi and lo; its launches
//      are part of the entry's, so its time is part of the kernel's. The
//      other choice, a transposition in shared memory after each tile
//      lands, needs an f32 staging tile beside the hi and lo tiles in 227
//      KB that they already fill, and a store, a proxy fence and a barrier
//      before every product. Reckoned at D = 128, S = 2048, H = 32, Hkv =
//      8: the forward's prologue reads 48 MiB and writes 96, the dQ's
//      reads 80 and writes 176, the dK/dV's reads 80 and writes 288 (some
//      45, 76 and 110 us at 3.35 TB/s; chip_smoke.py times it apart,
//      prologue_ms). One prologue for both backward kernels would write
//      Q, dO, K and V once: not done yet (ROADMAP).
//   2. Register A against the accumulator. The computed operand (P in the
//      forward; P^T and dS^T in the dK/dV; dS in the dQ) is wgmma's A from
//      registers, split there. Its tf32 fragment (hopper.cuh) holds
//      columns l%4 and l%4 + 4 of each 8-column k-step, where the
//      accumulator holds 2(l%4) and 2(l%4) + 1. So the reduced index is
//      permuted within each group of 8: fragment column c is accumulator
//      column PERM8[c] = 0, 2, 4, 6, 1, 3, 5, 7 (register e of the
//      fragment = accumulator register 4kk + (0, 2, 1, 3)[e]: no
//      shuffle), and the prologue writes the
//      transposed copies with the same permutation along S (position 8g +
//      c holds row 8g + PERM8[c]), so A and B pair the same keys or
//      queries and the sum is unchanged.
//   3. The split. hi and lo of every shared-memory operand are made by the
//      prologue (separate halves of its output, hi first), so a tile is
//      TMA'd as it will be read; a 64-row f32 panel (32 columns) is 8 KB.
//      head_dim is split over CTAs: a CTA owns CW = 128 columns of O or of
//      dK and dV (D / 128 CTAs a tile), and up to 256 of dQ (at most 128 a
//      warpgroup), so no accumulator is over 64 registers at any D; the
//      column slices of one tile each reduce S (and dP) over all of
//      head_dim again, (D / 128 + 1) / 2 times the work at 256-512 (1.5x,
//      2x, 2.5x) in the forward and the dK/dV, (2 NZ + 1) / 3 in the dQ
//      (1x at 256, 1.67x at 384-512).
//   4. Accumulator rounding. The tensor cores add into their f32
//      accumulator rounding toward zero, so a long running sum kept there
//      drifts about half an ulp of the sum a step, all one way (some 1e-4
//      of dV at S = 2048). So each unit's products (4 or 8 k-steps, 12 or
//      24 wgmma) start from zero in the tensor cores and are added to the
//      f32 registers (S, O, dV, dK) with round-to-nearest adds; S's unit
//      sums alternate between two 32-register buffers so that one unit's
//      wgmma run while the last one's sum is added.
//
// Forward (flash_fwd_f32tc_kernel): a CTA per (two 64-row q tiles, head,
// batch, column slice z); consumer warpgroup g owns q tile 2c + g and O's
// columns 128 z .. 128 z + 127. Per k tile of 64 keys: S = Q K^T, the
// online softmax on the accumulator layout (quad shuffles, expf), P split
// in registers, O += P V over two 64-column units of V^T. Both warpgroups
// take every unit; a warpgroup whose q tile sees fewer k tiles waits for
// and releases the rest unread.
//   Shared memory: D = 128: the 2 Q tiles resident (hi, lo: 128 KB) and 3
//   slots of 32 KB (a 64-column chunk of K, or of V^T, hi and lo): 225 KB
//   of 227. D = 256-512: 4 slots of 48 KB (a 32-column panel of K and of
//   both q tiles' Q, or a chunk of V^T): 193 KB.
//   Registers of a consumer (each D): O 64, S 32, two unit sums 64, the P
//   fragments 64 (hi and lo, 8 k-steps); S's buffers are dead before P's
//   fragments live: at most 192 of 232, 0 spills (ptxas).
//
// dK/dV (flash_dkv_f32tc_kernel): a CTA per (pair of 64-key tiles j and
// nkt - 1 - j, so that under the causal mask every CTA walks about the
// same number of items; KV head; batch; column slice z). Warpgroup 0
// reduces S^T = K Q^T, makes P^T = exp(S^T scale - lse), hands it to
// warpgroup 1 through shared memory (16 KB, named barriers) and owns dV +=
// P^T dO^T-panels; warpgroup 1 reduces dP^T = V dO^T, makes dS^T = P^T
// (dP^T - delta) scale and owns dK += dS^T Q^T-panels; items (GQA member,
// q tile) in a fixed order.
//   D = 128 (dkv_resident): K and V resident (hi, lo: 128 KB), one ring of
//   5 slots of 16 KB (a 32-column panel of Q or dO, or 64 rows by 32
//   queries of dO^T or Q^T, hi and lo) that both warpgroups walk (see
//   there: why each passes the other's units), the hand-off, lse and
//   delta: 226 KB of 227.
//   D = 256-512 (dkv_streamed): hi and lo K and V (256 KB and up) cannot
//   stay; a ring of 3 slots of 32 KB a warpgroup (a 32-column panel of K
//   and Q, or of V and dO, or a 64-column unit of dO^T or Q^T), K and V
//   read again each item: 210 KB.
//   Registers of a consumer: dV or dK 64, S^T or dP^T 32, unit sums 64,
//   fragments 64: at most 192 of 232, 0 spills.
//
// dQ (flash_dq_f32tc_kernel): a CTA per (64-row q tile, head, batch,
// column slice z of NZ = D / 256 rounded up; CW = 128 / 256 / 192 / 256
// columns at D = 128 / 256 / 384 / 512), heaviest causal q tiles first;
// per k tile of 64 keys in order, warpgroup 0 reduces S = Q K^T and makes
// P = exp(S scale - lse), hands it to warpgroup 1 through shared memory
// (16 KB, named barriers), which reduces dP = dO V^T, makes dS = P (dP -
// delta) scale and hands it back in place; each then adds dS K^T-units to
// its half of the CTA's dQ columns (at 384, 128 and 64). So each does 3 D
// FLOPs of the 6 D a pair (the two at 2 D against 4 D had warpgroup 1 alone
// owned dQ). Each dQ row is summed in one CTA in key order: deterministic,
// no atomics. lse and delta are per query, so the CTA's rows stay in
// registers.
//   D = 128 (dq_resident): Q and dO resident (hi, lo: 128 KB), one ring of
//   5 slots of 16 KB (a 32-column panel of K or V, or 64 head_dim rows by
//   32 keys of K^T, hi and lo) that both warpgroups walk, the hand-off:
//   225 KB of 227. L2 bytes a k tile: 12 panels, 192 KB, for 3 x 6 x 128 x
//   64 x 64 = 9.4 MFLOP (1 KB per 49 KFLOP).
//   D = 256-512 (dq_streamed): hi and lo Q and dO (256 KB and up) cannot
//   stay; a ring of 3 slots of 32 KB a warpgroup (a 32-column panel of Q
//   and K, or of dO and V, or a 64-column unit of K^T), Q and dO read again
//   each k tile: 209 KB. L2 bytes a k tile and CTA: (2 D / 32 + NUC) x 32
//   KB, 640 / 864 / 1152 KB at 256 / 384 / 512 for 18.9 / 23.6 / 31.5
//   MFLOP (1 KB per 29, 27, 27 KFLOP).
//   Registers of a consumer: dQ up to 64, S or dP 32, unit sums 64,
//   fragments 64, as the dK/dV's: 0 spills (ptxas).
//   What bounds it (hack/torch/f32tc-dq-bound.py, builds with parts of
//   the work left out, results wrong, on an H100 SXM): at D = 128 not the
//   L2. Without its ring's loads or without the hand-off's barriers it ran
//   within 3% of the full build; its products keep the tensor cores busy
//   about 40% of its time after the prologue, and between them both warpgroups wait for the
//   last unit's sum, make P or dS, hand it over and split it while
//   nothing runs on the tensor cores. Overlapping that with the next k
//   tile's products (a q tile a warpgroup, or the next S issued before
//   the hand-off) is left to a later design. At 256-512 the streamed
//   bytes are: without its ring's loads it ran 35% (256) and 27-28%
//   (512) faster. Multicasting the panels that CTAs share (Q, dO, K, V
//   across the column slices of one q tile) over a cluster would cut
//   them; untried.
//
// The extern "C" entries launch on the caller's stream and return
// cudaGetLastError(), cudaErrorInvalidValue for a (dtype, head_dim) they
// were not built for, or the negated CUresult when a tensor map cannot be
// built; the Python wrapper raises on any non-zero value. Each takes a
// workspace of flash_f32tc_workspace bytes for its prologue's copies.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

// The C entry's `dtype` code for f32 (the Python wrapper's).
constexpr int DT_F32 = 2;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// ------------------------------------------- Hopper kernels (wgmma, TMA)

constexpr int T = 64;                          // tile rows (q and k)
constexpr int NT_WS = 384;                     // 2 consumer warpgroups + producer
constexpr int CONSUMER_WARPS = 8;
constexpr int PANEL = hopper::PANEL_BYTES;     // 64 rows x 32 f32: 8 KB
constexpr int UNIT = 4 * PANEL;                // a ring slot: 32 KB
constexpr int CW = 128;                        // output columns of a CTA
constexpr int P_FULL = 1, P_EMPTY = 2;         // named barriers (dK/dV)
constexpr int DS_FULL = 3;                     // (dQ, with P_FULL)

// Fragment column c of a k-step is accumulator column PERM8[c] (see the
// header, hard part 2); the prologue permutes the S index of the
// transposed copies the same way.
__host__ __device__ __forceinline__ constexpr int perm8(int c) {
  return c < 4 ? 2 * c : 2 * (c - 4) + 1;
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Row and column of accumulator register i (wgmma m64nN layout, see
// hopper.cuh) for this thread of its warpgroup.
__device__ __forceinline__ int acc_row(int i, int warp, int lane) {
  return 16 * warp + lane / 4 + 8 * ((i % 4) / 2);
}
__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i / 4) + 2 * (lane % 4) + (i % 2);
}

// Write the first `rows` rows of a 64 x 64 f32 accumulator (rows
// `row_stride` floats apart; rows past the sequence's end not stored).
__device__ __forceinline__ void store_acc(float* dst, const float (&acc)[32],
                                          int row_stride, int rows, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 32; i += 2) {
    const int r = acc_row(i, warp, lane);
    if (r < rows)
      *reinterpret_cast<float2*>(dst + static_cast<int64_t>(r) * row_stride +
                                 acc_col(i, lane)) =
          make_float2(acc[i], acc[i + 1]);
  }
}

__host__ __device__ __forceinline__ int n_tiles(int len) { return cdiv(len, T); }

// Last k tile (exclusive) visible to q tile i: the TPU's _block_visible,
// j * T <= i * T + q_offset + T - 1.
__device__ __forceinline__ int k_tiles_visible(int i, int nk, int causal,
                                               int q_offset) {
  if (!causal) return nk;
  return min(nk, (i * T + q_offset + T - 1) / T + 1);
}

// First q tile that sees k tile j (causal): i * T + q_offset + T - 1 >= j * T.
__device__ __forceinline__ int first_q_tile(int j, int causal, int q_offset) {
  if (!causal) return 0;
  const int need = j * T - q_offset - (T - 1);
  return need > 0 ? cdiv(need, T) : 0;
}

// The running sum s of a unit's tensor-core sum t (round to nearest; the
// first unit's sum is taken as it is).
__device__ __forceinline__ void add_unit(float (&s)[32], float (&t)[32],
                                         bool first) {
  hopper::reg_fence(t);
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = first ? t[e] : s[e] + t[e];
}

// The register A fragments of the 8 k-steps of a 64 x 64 computed operand
// x (accumulator layout), split: fragment register (0, 1, 2, 3) of k-step
// kk is accumulator register 4 kk + (0, 2, 1, 3), i.e. fragment column c
// is accumulator column perm8(c).
__device__ __forceinline__ void split_frags(uint32_t (&hi)[8][4],
                                            uint32_t (&lo)[8][4],
                                            const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = x[4 * kk + (r == 1 ? 2 : r == 2 ? 1 : r)];
      hi[kk][r] = tf32_rna(v);
      lo[kk][r] = tf32_rna(v - __uint_as_float(hi[kk][r]));
    }
}

// acc (+)= A . B over one output unit: A the split register fragments (8
// k-steps of 8 keys or queries), B the unit's 64 rows by 64 k columns, hi
// panels 0-1 then lo panels 2-3. lo.hi + hi.lo + hi.hi a k-step.
__device__ __forceinline__ void unit_rs(float (&acc)[32],
                                        const uint32_t (&hi)[8][4],
                                        const uint32_t (&lo)[8][4],
                                        const unsigned char* slot) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const uint64_t bhi = desc_panel(slot + (kk / 4) * PANEL, kk % 4);
    const uint64_t blo = desc_panel(slot + (2 + kk / 4) * PANEL, kk % 4);
    wgmma_tf32_rs(acc, lo[kk], bhi, kk > 0);
    wgmma_tf32_rs(acc, hi[kk], blo, 1);
    wgmma_tf32_rs(acc, hi[kk], bhi, 1);
  }
}

// acc (+)= A . B^T over `steps` k-steps, A and B both K-major in shared
// memory: k-step kk of A's hi at panel a_hi(kk), offset kk % 4, and so on.
template <int STEPS, typename FA, typename FB>
__device__ __forceinline__ void unit_ss(float (&acc)[32], FA a, FB b) {
  using namespace hopper;
#pragma unroll
  for (int kk = 0; kk < STEPS; ++kk) {
    const uint64_t ahi = desc_panel(a(kk, 0), kk % 4);
    const uint64_t alo = desc_panel(a(kk, 1), kk % 4);
    const uint64_t bhi = desc_panel(b(kk, 0), kk % 4);
    const uint64_t blo = desc_panel(b(kk, 1), kk % 4);
    wgmma_tf32_ss(acc, alo, bhi, kk > 0);
    wgmma_tf32_ss(acc, ahi, blo, 1);
    wgmma_tf32_ss(acc, ahi, bhi, 1);
  }
}

// ---------------------------------------------------------------- prologue
//
// x [B, S, H, D] (element strides sb, ss, sh; unit over D) split into its
// TF32 parts, hi = rna(x) and lo = rna(x - hi): into nat (if given) as
// [2][B][S][H][D], hi first, and into trn (if given) as [2][B][H][D][S],
// where position 8g + c along S holds row 8g + perm8(c). A block per 32
// rows by 32 columns of one (batch, head), the transpose through shared
// memory so that both writes are coalesced. S is a multiple of 8.
__global__ void __launch_bounds__(256) flash_split_f32tc_kernel(
    const float* __restrict__ x, int B, int S, int H, int D, int sb, int ss,
    int sh, float* __restrict__ nat, float* __restrict__ trn) {
  __shared__ float tile[32][33];
  const int s0 = blockIdx.x * 32, d0 = blockIdx.y * 32;
  const int b = blockIdx.z / H, h = blockIdx.z % H;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  const int64_t n = static_cast<int64_t>(B) * S * H * D;
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const int s = s0 + r;
    float v = 0.0f;
    if (s < S) {
      v = x[static_cast<int64_t>(b) * sb + static_cast<int64_t>(s) * ss +
            static_cast<int64_t>(h) * sh + d0 + tx];
      if (nat != nullptr) {
        const uint32_t hi = tf32_rna(v);
        const int64_t at =
            ((static_cast<int64_t>(b) * S + s) * H + h) * D + d0 + tx;
        nat[at] = __uint_as_float(hi);
        nat[n + at] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
      }
    }
    tile[r][tx] = v;
  }
  if (trn == nullptr) return;
  __syncthreads();
  const int p = s0 + tx;
  if (p >= S) return;
  const int src = (tx & ~7) + perm8(tx & 7);
#pragma unroll
  for (int r = ty; r < 32; r += 8) {
    const float v = tile[src][r];
    const uint32_t hi = tf32_rna(v);
    const int64_t at =
        ((static_cast<int64_t>(b) * H + h) * D + d0 + r) * S + p;
    trn[at] = __uint_as_float(hi);
    trn[n + at] = __uint_as_float(tf32_rna(v - __uint_as_float(hi)));
  }
}

// ----------------------------------------------------------------- forward

template <int D>
struct Fwd {
  static constexpr int NZ = D / CW;            // column slices of O
  static constexpr bool QRES = D == 128;       // Q resident (else streamed)
  static constexpr int NSU = QRES ? D / 64 : D / 32;  // S units a k tile
  static constexpr int KPU = QRES ? 8 : 4;     // k-steps an S unit
  static constexpr int SLOT = QRES ? UNIT : 6 * PANEL;
  static constexpr int R = QRES ? 3 : 4;       // ring slots
  static constexpr int QTILE = 2 * (D / 32) * PANEL;  // a resident Q, hi+lo
  static constexpr int QBYTES = QRES ? 2 * QTILE : 0;
  static constexpr int SMEM = 1024 + QBYTES + R * SLOT + 8 * (1 + 2 * R);
};

template <int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_fwd_f32tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, float* __restrict__ out,
    float* __restrict__ lse, int B, int H, int Hkv, int Sq, int Sk,
    int causal, int q_offset, float scale) {
  using namespace hopper;
  using F = Fwd<D>;
  constexpr int R = F::R, NSU = F::NSU;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);     // QRES: 2 tiles, hi then lo
  unsigned char* sRing = sQ + F::QBYTES;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sRing + R * F::SLOT);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + R;

  // Blocks: heaviest q-tile pairs first, then (slice, head, batch).
  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk), ncta = cdiv(nqt, 2);
  const int rest = gridDim.x / ncta;             // NZ * H * B
  const int blk = static_cast<int>(blockIdx.x);
  const int c = ncta - 1 - blk / rest, r = blk % rest;
  const int z = r % F::NZ, h = r / F::NZ % H, b = r / F::NZ / H;
  const int hk = h / (H / Hkv), tiles = min(2, nqt - 2 * c);
  const int nk = k_tiles_visible(2 * c + tiles - 1, nkt, causal, q_offset);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: the Q tiles (QRES), then per k tile its S units and V^T
    // units. Batch index b + B is the lo half of the prologue's copies.
    reg_dealloc<40>();
    if (threadIdx.x == 256) {
      if constexpr (F::QRES) {
        mbar_expect_tx(q_full, tiles * F::QTILE);
        for (int g = 0; g < tiles; ++g)
          for (int part = 0; part < 2; ++part)
            for (int p = 0; p < D / 32; ++p)
              tma_load_panel(sQ + g * F::QTILE + (part * D / 32 + p) * PANEL,
                             &qmap, q_full, 32 * p, h, (2 * c + g) * T,
                             b + part * B);
      }
      int u = 0;
      for (int j = 0; j < nk; ++j) {
        for (int su = 0; su < NSU + 2; ++su, ++u) {
          const int s = u % R, use = u / R;
          if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
          unsigned char* dst = sRing + s * F::SLOT;
          if (su >= NSU) {
            // V^T rows 128 z + 64 (su - NSU) .., keys of tile j.
            const int row = CW * z + 64 * (su - NSU);
            mbar_expect_tx(&full[s], UNIT);
            for (int part = 0; part < 2; ++part)
              for (int p = 0; p < 2; ++p)
                tma_load_panel(dst + (2 * part + p) * PANEL, &vmap, &full[s],
                               j * T + 32 * p, hk, row, b + part * B);
          } else if constexpr (F::QRES) {
            // K columns 64 su .. 64 su + 63.
            mbar_expect_tx(&full[s], UNIT);
            for (int part = 0; part < 2; ++part)
              for (int p = 0; p < 2; ++p)
                tma_load_panel(dst + (2 * part + p) * PANEL, &kmap, &full[s],
                               64 * su + 32 * p, hk, j * T, b + part * B);
          } else {
            // Panel su (32 columns) of K and of each q tile's Q.
            mbar_expect_tx(&full[s], (2 + 2 * tiles) * PANEL);
            for (int part = 0; part < 2; ++part) {
              tma_load_panel(dst + part * PANEL, &kmap, &full[s], 32 * su, hk,
                             j * T, b + part * B);
              for (int g = 0; g < tiles; ++g)
                tma_load_panel(dst + (2 + 2 * g + part) * PANEL, &qmap,
                               &full[s], 32 * su, h, (2 * c + g) * T,
                               b + part * B);
            }
          }
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
  const int iq = 2 * c + wg;                     // this warpgroup's q tile
  const int my_nk =
      wg < tiles ? k_tiles_visible(iq, nkt, causal, q_offset) : 0;
  const unsigned char* myQ = sQ + wg * F::QTILE;
  auto slot_of = [&](int unit) { return sRing + unit % R * F::SLOT; };
  auto release = [&](int unit) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[unit % R]);
  };

  float o[2][32];
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] = 0.0f;
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  if constexpr (F::QRES) mbar_wait(q_full, 0);
  // The k tiles this q tile sees, then the rest of the CTA's (a q tile
  // past Sq, or the first of a causal pair, sees fewer): waited for and
  // released unread.
  int u = 0;
  for (int j = 0; j < my_nk; ++j, u += NSU + 2) {
    float s[32], t[2][32];
    // S = Q K^T, a unit's sum in t[su % 2] while the last one's is added.
#pragma unroll
    for (int su = 0; su < NSU; ++su) {
      mbar_wait(&full[(u + su) % R], ((u + su) / R) & 1);
      const unsigned char* st = slot_of(u + su);
      wgmma_fence();
      if constexpr (F::QRES)
        unit_ss<F::KPU>(
            t[su % 2],
            [&](int kk, int part) {
              return myQ + (part * D / 32 + 2 * su + kk / 4) * PANEL;
            },
            [&](int kk, int part) { return st + (2 * part + kk / 4) * PANEL; });
      else
        unit_ss<F::KPU>(
            t[su % 2],
            [&](int kk, int part) { return st + (2 + 2 * wg + part) * PANEL; },
            [&](int kk, int part) { return st + part * PANEL; });
      wgmma_commit();
      if (su > 0) {
        wgmma_wait<1>();
        add_unit(s, t[(su - 1) % 2], su == 1);
        release(u + su - 1);
      }
    }
    wgmma_wait<0>();
    add_unit(s, t[(NSU - 1) % 2], NSU == 1);
    release(u + NSU - 1);

    // Scale, mask (diagonal tiles; keys past Sk on a partial last tile),
    // online softmax; O rescaled; P split into fragments.
    const int q0 = iq * T;
    const bool diag = causal && j * T + T - 1 > q0 + q_offset;
    const int keys = Sk - j * T;
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = s[e] * scale;
      if ((diag && q0 + acc_row(e, warp, lane) + q_offset <
                       j * T + acc_col(e, lane)) ||
          acc_col(e, lane) >= keys)
        x = NEG_INF;
      s[e] = x;
      mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], x);
    }
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = quad_max(mx[rr]);
      corr[rr] = expf(m[rr] - mx[rr]);
      m[rr] = mx[rr];
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      s[e] = expf(s[e] - m[(e % 4) / 2]);
      psum[(e % 4) / 2] += s[e];
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) l[rr] = l[rr] * corr[rr] + psum[rr];
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[n][e] *= corr[(e % 4) / 2];
    uint32_t ph[8][4], pl[8][4];
    split_frags(ph, pl, s);

    // O += P V over the two 64-column units of the slice, one unit's sum
    // in the tensor cores at a time (the P fragments hold 64 registers).
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      const int unit = u + NSU + n;
      mbar_wait(&full[unit % R], (unit / R) & 1);
      wgmma_fence();
      unit_rs(t[0], ph, pl, slot_of(unit));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(t[0]);
#pragma unroll
      for (int e = 0; e < 32; ++e) o[n][e] += t[0][e];
      release(unit);
    }
  }
  for (; u < nk * (NSU + 2); ++u) {
    mbar_wait(&full[u % R], (u / R) & 1);
    release(u);
  }
  if (wg >= tiles) return;

  // O / l (l == 0 guarded as 1) and lse (slice 0), rows below Sq only.
  const int q0 = iq * T;
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const float sum = quad_sum(l[rr]);
    const float safe = sum == 0.0f ? 1.0f : sum;
    inv[rr] = 1.0f / safe;
    const int row = q0 + 16 * warp + lane / 4 + 8 * rr;
    if (z == 0 && lane % 4 == 0 && row < Sq)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[rr] + logf(safe);
  }
  float* dst = out + (static_cast<int64_t>(b) * Sq + q0) * H * D +
               static_cast<int64_t>(h) * D + CW * z;
#pragma unroll
  for (int n = 0; n < 2; ++n) {
#pragma unroll
    for (int e = 0; e < 32; ++e) o[n][e] *= inv[(e % 4) / 2];
    store_acc(dst + 64 * n, o[n], H * D, Sq - q0, warp, lane);
  }
}

// ------------------------------------------------------------------- dK/dV
//
// Two layouts of one design (header): at D = 128 K and V stay resident
// (hi and lo, 128 KB) and each item streams its Q, dO, Q^T and dO^T panels
// through one ring of 16 KB slots (dkv_resident); at 256-512 they cannot,
// and K and V panels ride with each item's Q and dO panels through a ring
// of 32 KB slots a warpgroup (dkv_streamed). Re-reading K and V every item
// is a third of the streamed layout's L2 traffic.

template <int D>
struct Dkv {
  static constexpr bool KVRES = D == 128;      // K and V resident
  static constexpr int NZ = D / CW;            // column slices of dK/dV
  static constexpr int NSU = D / 32;           // S^T / dP^T units an item
  // Resident: units of one panel (hi, lo: 16 KB), 8 a warpgroup an item,
  // in one ring; streamed: units of 32 KB, NSU + 2 a warpgroup an item,
  // in a ring each.
  static constexpr int SLOT = KVRES ? 2 * PANEL : UNIT;
  static constexpr int U = KVRES ? 2 * (NSU + 4) : NSU + 2;
  static constexpr int R = KVRES ? 5 : 3;
  static constexpr int RINGS = KVRES ? 1 : 2;
  static constexpr int KV = KVRES ? 2 * 2 * (D / 32) * PANEL : 0;
  static constexpr int SMEM = 1024 + KV + RINGS * R * SLOT + T * T * 4 +
                              2 * 2 * T * 4 + 8 * (2 + 2 * RINGS * R);
  // The lse/delta buffer of item n is loaded again for item n + 2 once the
  // slot's last unit is released: one of item n + 1 (a ring a warpgroup)
  // or, in the shared ring (released by both warpgroups), one past item
  // n + 1's P^T hand-off, which either warpgroup reaches only after both
  // finished reading item n's.
  static_assert(KVRES ? U - R >= 2 * NSU : U >= R,
                "the lse/delta buffers would be reloaded too early");
};

// The operand of dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1)
// from x = S^T or dP^T of item n (q tile i, k tile j): P^T = exp(S^T scale
// - lse), the causal mask on diagonal tiles, handed to warpgroup 1 through
// sP; dS^T = P^T (dP^T - delta) scale. Query columns past Sq (their lse
// and delta are stale) are zero.
__device__ __forceinline__ void dkv_operand(float (&x)[32], int wg,
                                            const float* sRow, float* sP,
                                            int n, int total, int i, int j,
                                            int Sq, int causal, int q_offset,
                                            float scale, int tid) {
  using namespace hopper;
  const int warp = tid / 32, lane = tid % 32;
  const int queries = Sq - i * T;
  if (wg == 0) {
    const bool diag = causal && j * T + T - 1 > i * T + q_offset;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = acc_col(e, lane);
      float y = x[e] * scale;
      if (diag && i * T + col + q_offset < j * T + acc_row(e, warp, lane))
        y = NEG_INF;
      x[e] = expf(y - sRow[col]);
    }
    if (queries < T) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (acc_col(e, lane) >= queries) x[e] = 0.0f;
    }
    if (n > 0) named_sync(P_EMPTY, 256);
#pragma unroll
    for (int e = 0; e < 32; ++e) sP[e * 128 + tid] = x[e];
    named_arrive(P_FULL, 256);
  } else {
    named_sync(P_FULL, 256);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      x[e] = sP[e * 128 + tid] * (x[e] - sRow[acc_col(e, lane)]) * scale;
    if (n + 1 < total) named_arrive(P_EMPTY, 256);
    if (queries < T) {
#pragma unroll
      for (int e = 0; e < 32; ++e)
        if (acc_col(e, lane) >= queries) x[e] = 0.0f;
    }
  }
}

// The pair of k tiles of one CTA (j and nkt - 1 - j), their visible q
// tiles, and its (slice, KV head, batch).
struct DkvWork {
  int pair, z, hk, b, n_jt, nqt, nkt, group, total;
  __device__ int k_tile(int v) const { return v == 0 ? pair : nkt - 1 - pair; }
};

template <int NZ>
__device__ __forceinline__ DkvWork dkv_work(int H, int Hkv, int Sq, int Sk,
                                            int causal, int q_offset) {
  DkvWork w;
  w.nqt = n_tiles(Sq);
  w.nkt = n_tiles(Sk);
  w.group = H / Hkv;
  const int rest = gridDim.x / cdiv(w.nkt, 2);   // NZ * Hkv * B
  const int blk = static_cast<int>(blockIdx.x);
  w.pair = blk / rest;
  const int r = blk % rest;
  w.z = r % NZ;
  w.hk = r / NZ % Hkv;
  w.b = r / NZ / Hkv;
  w.n_jt = w.nkt - 1 - w.pair != w.pair ? 2 : 1;
  w.total = 0;
  for (int v = 0; v < w.n_jt; ++v)
    w.total += w.group *
               max(w.nqt - first_q_tile(w.k_tile(v), causal, q_offset), 0);
  return w;
}

// D = 128: K and V of the k tile resident (hi then lo, 4 panels each), one
// ring of R slots of one panel's hi and lo, filled by thread 256 in the
// order the warpgroups take them: per item, unit k of warpgroup w at 2k +
// w (k < 4: Q or dO panel k; k >= 4: dO^T or Q^T rows 64 c, queries 32 p
// for k - 4 = 2c + p). Every consumer warp walks every position: before
// taking its own unit it waits for the other warpgroup's unit just ahead
// to land and releases it unread. With R odd a slot alternates between
// the warpgroups, and a warpgroup that ran two phases ahead of a slot
// would find that phase's parity already completed (try_wait.parity sees
// only parity) and read a slot still being filled; walking every position
// keeps each waiter within one phase of every slot.
template <int D>
__device__ __forceinline__ void dkv_resident(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap,
    const CUtensorMap* qtmap, const CUtensorMap* dotmap, const float* lse,
    const float* delta, float* dk, float* dv, int B, int H, int Hkv, int Sq,
    int Sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  using F = Dkv<D>;
  constexpr int R = F::R, NP = D / 32, U = F::U;
  unsigned char* sKV = align_1024(smem);          // K at 0, V at KV / 2
  unsigned char* sRing = sKV + F::KV;
  float* sP = reinterpret_cast<float*>(sRing + R * F::SLOT);
  float* sStat = sP + T * T;                      // [wg][item % 2][64]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sStat + 2 * 2 * T);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + R;

  const DkvWork w = dkv_work<F::NZ>(H, Hkv, Sq, Sk, causal, q_offset);
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMER_WARPS);
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == 256) {
      int u = 0, n = 0;
      for (int v = 0; v < w.n_jt; ++v) {
        const int j = w.k_tile(v);
        const int nqv = max(w.nqt - first_q_tile(j, causal, q_offset), 0);
        const int i0 = w.nqt - nqv;
        if (v > 0) mbar_wait(kv_empty, (v - 1) & 1);
        mbar_expect_tx(kv_full, F::KV);
        for (int part = 0; part < 2; ++part)
          for (int p = 0; p < NP; ++p) {
            tma_load_panel(sKV + (part * NP + p) * PANEL, kmap, kv_full,
                           32 * p, w.hk, j * T, w.b + part * B);
            tma_load_panel(sKV + F::KV / 2 + (part * NP + p) * PANEL, vmap,
                           kv_full, 32 * p, w.hk, j * T, w.b + part * B);
          }
        for (int t = 0; t < w.group * nqv; ++t, ++n) {
          const int h = w.hk * w.group + t / nqv, i = i0 + t % nqv;
          const int64_t row = (static_cast<int64_t>(w.b) * H + h) * Sq + i * T;
          const uint32_t stat_bytes = min(T, Sq - i * T) * 4;
          for (int o = 0; o < U; ++o, ++u) {
            const int s = u % R, use = u / R, g = o % 2, k = o / 2;
            if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
            unsigned char* dst = sRing + s * F::SLOT;
            uint64_t* bar = &full[s];
            mbar_expect_tx(bar, F::SLOT + (k == 0 ? stat_bytes : 0));
            for (int part = 0; part < 2; ++part) {
              if (k < NP)
                tma_load_panel(dst + part * PANEL, g == 0 ? qmap : domap, bar,
                               32 * k, h, i * T, w.b + part * B);
              else
                tma_load_panel(dst + part * PANEL, g == 0 ? dotmap : qtmap,
                               bar, i * T + 32 * ((k - NP) % 2), h,
                               CW * w.z + 64 * ((k - NP) / 2),
                               w.b + part * B);
            }
            if (k == 0)
              bulk_load(sStat + (g * 2 + (n & 1)) * T,
                        (g == 0 ? lse : delta) + row, stat_bytes, bar);
          }
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const unsigned char* sA = sKV + wg * (F::KV / 2);  // K (wg 0) or V
  // Unit k of this warpgroup in item n.
  auto pos = [&](int n, int k) { return n * U + 2 * k + wg; };
  auto slot_of = [&](int unit) { return sRing + unit % R * F::SLOT; };
  auto release = [&](int unit) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[unit % R]);
  };
  // Take this warpgroup's unit, passing the other's just before it.
  auto acquire = [&](int unit) {
    if (unit > 0) {
      mbar_wait(&full[(unit - 1) % R], ((unit - 1) / R) & 1);
      release(unit - 1);
    }
    mbar_wait(&full[unit % R], (unit / R) & 1);
  };

  int n = 0;
  for (int v = 0; v < w.n_jt; ++v) {
    const int j = w.k_tile(v);
    const int nqv = max(w.nqt - first_q_tile(j, causal, q_offset), 0);
    const int i0 = w.nqt - nqv;
    float acc[2][32];                            // dV (wg 0) or dK
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;

    mbar_wait(kv_full, v & 1);
    for (int t = 0; t < w.group * nqv; ++t, ++n) {
      const int i = i0 + t % nqv;
      float x[32], tc[2][32];
      // S^T = K Q^T (wg 0) or dP^T = V dO^T over head_dim, a panel a unit.
#pragma unroll
      for (int p = 0; p < NP; ++p) {
        acquire(pos(n, p));
        const unsigned char* st = slot_of(pos(n, p));
        wgmma_fence();
        unit_ss<4>(
            tc[p % 2],
            [&](int kk, int part) { return sA + (part * NP + p) * PANEL; },
            [&](int kk, int part) { return st + part * PANEL; });
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          add_unit(x, tc[(p - 1) % 2], p == 1);
          release(pos(n, p - 1));
        }
      }
      wgmma_wait<0>();
      add_unit(x, tc[(NP - 1) % 2], NP == 1);
      release(pos(n, NP - 1));
      if (t == w.group * nqv - 1) {
        __syncwarp();
        if (lane == 0) mbar_arrive(kv_empty);    // K, V free for the next tile
      }

      dkv_operand(x, wg, sStat + (wg * 2 + (n & 1)) * T, sP, n, w.total, i,
                  j, Sq, causal, q_offset, scale, tid);

      // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1): per 64-column chunk c,
      // the two 32-query panels of the transposed copy, 8 k-steps summed
      // in the tensor cores.
      uint32_t fh[8][4], fl[8][4];
      split_frags(fh, fl, x);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        wgmma_fence();
#pragma unroll
        for (int pq = 0; pq < 2; ++pq) {
          const int unit = pos(n, NP + 2 * c + pq);
          acquire(unit);
          const unsigned char* st = slot_of(unit);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            const uint64_t bhi = desc_panel(st, kk);
            const uint64_t blo = desc_panel(st + PANEL, kk);
            wgmma_tf32_rs(tc[0], fl[4 * pq + kk], bhi, pq > 0 || kk > 0);
            wgmma_tf32_rs(tc[0], fh[4 * pq + kk], blo, 1);
            wgmma_tf32_rs(tc[0], fh[4 * pq + kk], bhi, 1);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(tc[0]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] += tc[0][e];
        release(pos(n, NP + 2 * c));
        release(pos(n, NP + 2 * c + 1));
      }
    }
    if (nqv == 0) {                              // no item: free K, V
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);
    }

    float* dst = (wg == 0 ? dv : dk) +
                 (static_cast<int64_t>(w.b) * Sk + j * T) * Hkv * D +
                 static_cast<int64_t>(w.hk) * D + CW * w.z;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      store_acc(dst + 64 * c, acc[c], Hkv * D, Sk - j * T, warp, lane);
  }
}

// D = 256-512: two rings of R slots of 32 KB, one a warpgroup, each with
// its producer thread: warpgroup 0's (thread 256) K and Q panels, then dO^T
// (lse with an item's first unit); warpgroup 1's (thread 288) V and dO
// panels, then Q^T (delta).
template <int D>
__device__ __forceinline__ void dkv_streamed(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap,
    const CUtensorMap* qtmap, const CUtensorMap* dotmap, const float* lse,
    const float* delta, float* dk, float* dv, int B, int H, int Hkv, int Sq,
    int Sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  using F = Dkv<D>;
  constexpr int R = F::R, NSU = F::NSU, U = F::U;
  unsigned char* sRing = align_1024(smem);        // ring g: R slots at g R
  float* sP = reinterpret_cast<float*>(sRing + 2 * R * UNIT);  // P^T hand-off
  float* sStat = sP + T * T;                      // [ring][item % 2][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(sStat + 2 * 2 * T);
  uint64_t* empty = full + 2 * R;                 // [ring][slot]

  const DkvWork w = dkv_work<F::NZ>(H, Hkv, Sq, Sk, causal, q_offset);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS / 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<40>();
    const int g = (threadIdx.x - 256) / 32;
    if (threadIdx.x % 32 == 0 && g < 2) {
      const CUtensorMap* amap = g == 0 ? kmap : vmap;
      const CUtensorMap* bmap = g == 0 ? qmap : domap;
      const CUtensorMap* tmap = g == 0 ? dotmap : qtmap;
      const float* stat = g == 0 ? lse : delta;
      unsigned char* ring = sRing + g * R * UNIT;
      int u = 0, n = 0;
      for (int v = 0; v < w.n_jt; ++v) {
        const int j = w.k_tile(v);
        const int nqv = max(w.nqt - first_q_tile(j, causal, q_offset), 0);
        const int i0 = w.nqt - nqv;
        for (int t = 0; t < w.group * nqv; ++t, ++n) {
          const int h = w.hk * w.group + t / nqv, i = i0 + t % nqv;
          const int64_t row = (static_cast<int64_t>(w.b) * H + h) * Sq + i * T;
          // The item's lse or delta up to Sq only: a multiple of 8 rows,
          // so 32-byte aligned copies of a multiple of 32 bytes.
          const uint32_t stat_bytes = min(T, Sq - i * T) * 4;
          for (int p = 0; p < U; ++p, ++u) {
            const int s = u % R, use = u / R;
            if (use > 0) mbar_wait(&empty[g * R + s], (use - 1) & 1);
            unsigned char* dst = ring + s * UNIT;
            uint64_t* bar = &full[g * R + s];
            mbar_expect_tx(bar, UNIT + (p == 0 ? stat_bytes : 0));
            for (int part = 0; part < 2; ++part) {
              if (p < NSU) {
                tma_load_panel(dst + part * PANEL, amap, bar, 32 * p, w.hk,
                               j * T, w.b + part * B);
                tma_load_panel(dst + (2 + part) * PANEL, bmap, bar, 32 * p, h,
                               i * T, w.b + part * B);
              } else {
                const int drow = CW * w.z + 64 * (p - NSU);
                for (int c = 0; c < 2; ++c)
                  tma_load_panel(dst + (2 * part + c) * PANEL, tmap, bar,
                                 i * T + 32 * c, h, drow, w.b + part * B);
              }
            }
            if (p == 0)
              bulk_load(sStat + (g * 2 + (n & 1)) * T, stat + row, stat_bytes,
                        bar);
          }
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const unsigned char* ring = sRing + wg * R * UNIT;
  auto slot_of = [&](int unit) { return ring + unit % R * UNIT; };
  auto wait_unit = [&](int unit) {
    mbar_wait(&full[wg * R + unit % R], (unit / R) & 1);
  };
  auto release = [&](int unit) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[wg * R + unit % R]);
  };

  int u = 0, n = 0;
  for (int v = 0; v < w.n_jt; ++v) {
    const int j = w.k_tile(v);
    const int nqv = max(w.nqt - first_q_tile(j, causal, q_offset), 0);
    const int i0 = w.nqt - nqv;
    float acc[2][32];                            // dV (wg 0) or dK, 128 cols
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;

    for (int t = 0; t < w.group * nqv; ++t, ++n, u += U) {
      const int i = i0 + t % nqv;
      float x[32], tc[2][32];
      // S^T = K Q^T (wg 0) or dP^T = V dO^T (wg 1) over head_dim: a unit
      // is a 32-column panel of both operands, A at panels 0-1, B at 2-3.
#pragma unroll
      for (int p = 0; p < NSU; ++p) {
        wait_unit(u + p);
        const unsigned char* st = slot_of(u + p);
        wgmma_fence();
        unit_ss<4>(
            tc[p % 2], [&](int kk, int part) { return st + part * PANEL; },
            [&](int kk, int part) { return st + (2 + part) * PANEL; });
        wgmma_commit();
        if (p > 0) {
          wgmma_wait<1>();
          add_unit(x, tc[(p - 1) % 2], p == 1);
          release(u + p - 1);
        }
      }
      wgmma_wait<0>();
      add_unit(x, tc[(NSU - 1) % 2], NSU == 1);
      release(u + NSU - 1);

      dkv_operand(x, wg, sStat + (wg * 2 + (n & 1)) * T, sP, n, w.total, i,
                  j, Sq, causal, q_offset, scale, tid);

      // dV += P^T dO (wg 0) or dK += dS^T Q (wg 1): the two 64-column
      // units of the slice, B the transposed copy (dO^T or Q^T).
      uint32_t fh[8][4], fl[8][4];
      split_frags(fh, fl, x);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int unit = u + NSU + c;
        wait_unit(unit);
        wgmma_fence();
        unit_rs(tc[0], fh, fl, slot_of(unit));
        wgmma_commit();
        wgmma_wait<0>();
        reg_fence(tc[0]);
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] += tc[0][e];
        release(unit);
      }
    }

    // The slice of dV (warpgroup 0) or dK; key rows past Sk never.
    float* dst = (wg == 0 ? dv : dk) +
                 (static_cast<int64_t>(w.b) * Sk + j * T) * Hkv * D +
                 static_cast<int64_t>(w.hk) * D + CW * w.z;
#pragma unroll
    for (int c = 0; c < 2; ++c)
      store_acc(dst + 64 * c, acc[c], Hkv * D, Sk - j * T, warp, lane);
  }
}

template <int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_dkv_f32tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap qtmap,
    const __grid_constant__ CUtensorMap dotmap, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int B, int H, int Hkv, int Sq, int Sk,
    int causal, int q_offset, float scale) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (Dkv<D>::KVRES)
    dkv_resident<D>(smem_raw, &qmap, &kmap, &vmap, &domap, &qtmap, &dotmap,
                    lse, delta, dk, dv, B, H, Hkv, Sq, Sk, causal, q_offset,
                    scale);
  else
    dkv_streamed<D>(smem_raw, &qmap, &kmap, &vmap, &domap, &qtmap, &dotmap,
                    lse, delta, dk, dv, B, H, Hkv, Sq, Sk, causal, q_offset,
                    scale);
}

// ---------------------------------------------------------------------- dQ
//
// Two layouts of one design (header), as the dK/dV's: at D = 128 Q and dO
// stay resident (hi and lo, 128 KB) and each k tile streams its K, V and
// K^T panels through one ring of 16 KB slots (dq_resident); at 256-512
// they cannot, and Q and dO panels ride with each k tile's K and V panels
// through a ring of 32 KB slots a warpgroup (dq_streamed).

template <int D>
struct Dq {
  static constexpr bool QRES = D == 128;       // Q and dO resident
  static constexpr int NZ = (D + 255) / 256;   // column slices of dQ
  static constexpr int NUC = D / 64 / NZ;      // its 64-column units: 2-4
  // Units of warpgroup 0 and 1 (at 384, 2 and 1).
  static constexpr int NU0 = (NUC + 1) / 2, NU1 = NUC / 2;
  static constexpr int CW = 64 * NUC;          // columns of a CTA
  static constexpr int NSU = D / 32;           // S / dP units a k tile
  // Resident: units of one panel (hi, lo: 16 KB), NSU + 2 a warpgroup a k
  // tile, in one ring; streamed: units of 32 KB, NSU + NU_g a warpgroup a k
  // tile, in a ring each.
  static constexpr int SLOT = QRES ? 2 * PANEL : UNIT;
  static constexpr int R = QRES ? 5 : 3;
  static constexpr int RINGS = QRES ? 1 : 2;
  static constexpr int QD = QRES ? 2 * 2 * NSU * PANEL : 0;
  static constexpr int SMEM =
      1024 + QD + RINGS * R * SLOT + T * T * 4 + 8 * (1 + 2 * RINGS * R);
};

// The q tile of one CTA, its visible k tiles, its (column slice, head,
// batch) and the first of its dQ columns; heaviest causal q tiles first.
struct DqWork {
  int i, h, hk, b, nk, col0;
};

template <int NZ, int CW>
__device__ __forceinline__ DqWork dq_work(int H, int Hkv, int Sq, int Sk,
                                          int causal, int q_offset) {
  DqWork w;
  const int nqt = n_tiles(Sq);
  const int rest = gridDim.x / nqt;               // NZ * H * B
  const int blk = static_cast<int>(blockIdx.x);
  const int r = blk % rest;
  w.i = nqt - 1 - blk / rest;
  w.h = r / NZ % H;
  w.b = r / NZ / H;
  w.hk = w.h / (H / Hkv);
  w.nk = k_tiles_visible(w.i, n_tiles(Sk), causal, q_offset);
  w.col0 = CW * (r % NZ);
  return w;
}

// lse (warpgroup 0) or delta of this thread's two accumulator rows of q
// tile i; rows past Sq get 0 (their Q and dO rows load as zeros, so their
// P and dS stay finite, and they are never stored).
__device__ __forceinline__ void dq_rows(float (&stat)[2], const float* row,
                                        int i, int Sq, int tid) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int q = i * T + 16 * (tid / 32) + (tid % 32) / 4 + 8 * r;
    stat[r] = q < Sq ? row[q] : 0.0f;
  }
}

// dS of q tile i, k tile j from x = S (warpgroup 0) or dP (warpgroup 1),
// in both warpgroups' x: warpgroup 0 makes P = exp(S scale - lse) (the
// causal mask on diagonal tiles, keys past Sk at -1e30) and hands it to
// warpgroup 1 through sP; warpgroup 1 makes dS = P (dP - delta) scale and
// hands it back in place. Each thread reads and writes only its own
// accumulator positions, so neither hand-off needs more than its barrier:
// warpgroup 0 writes the next P only after reading this dS, and warpgroup 1
// reads sP only after the next P_FULL.
__device__ __forceinline__ void dq_operand(float (&x)[32], int wg,
                                           const float (&stat)[2], float* sP,
                                           int i, int j, int Sk, int causal,
                                           int q_offset, float scale,
                                           int tid) {
  using namespace hopper;
  const int warp = tid / 32, lane = tid % 32;
  if (wg == 0) {
    const bool diag = causal && j * T + T - 1 > i * T + q_offset;
    const int keys = Sk - j * T;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int col = acc_col(e, lane);
      float y = x[e] * scale;
      if ((diag && i * T + acc_row(e, warp, lane) + q_offset < j * T + col) ||
          col >= keys)
        y = NEG_INF;
      x[e] = expf(y - stat[(e % 4) / 2]);
    }
#pragma unroll
    for (int e = 0; e < 32; ++e) sP[e * 128 + tid] = x[e];
    named_arrive(P_FULL, 256);
    named_sync(DS_FULL, 256);
#pragma unroll
    for (int e = 0; e < 32; ++e) x[e] = sP[e * 128 + tid];
  } else {
    named_sync(P_FULL, 256);
#pragma unroll
    for (int e = 0; e < 32; ++e)
      x[e] = sP[e * 128 + tid] * (x[e] - stat[(e % 4) / 2]) * scale;
#pragma unroll
    for (int e = 0; e < 32; ++e) sP[e * 128 + tid] = x[e];
    named_arrive(DS_FULL, 256);
  }
}

// D = 128: Q and dO of the q tile resident (hi then lo, 4 panels each),
// one ring of R slots of one panel's hi and lo, filled by thread 256 in
// the order the warpgroups take them: per k tile, unit k of warpgroup w at
// 2k + w (k < 4: K or V panel k; k = 4, 5: keys 32 (k - 4) .. of K^T rows
// col0 + 64 w ..). Every consumer warp walks every position, as in
// dkv_resident (see there why).
template <int D>
__device__ __forceinline__ void dq_resident(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap,
    const CUtensorMap* ktmap, const float* lse, const float* delta,
    float* dq, int B, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  using namespace hopper;
  using F = Dq<D>;
  constexpr int R = F::R, NP = F::NSU, U = 2 * (NP + 2);
  static_assert(F::NU0 == 1 && F::NU1 == 1, "one unit a warpgroup");
  unsigned char* sQD = align_1024(smem);          // Q at 0, dO at QD / 2
  unsigned char* sRing = sQD + F::QD;
  float* sP = reinterpret_cast<float*>(sRing + R * F::SLOT);
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(sP + T * T);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + R;

  const DqWork w = dq_work<F::NZ, F::CW>(H, Hkv, Sq, Sk, causal, q_offset);
  if (threadIdx.x == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<40>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qd_full, F::QD);
      for (int part = 0; part < 2; ++part)
        for (int p = 0; p < NP; ++p) {
          tma_load_panel(sQD + (part * NP + p) * PANEL, qmap, qd_full, 32 * p,
                         w.h, w.i * T, w.b + part * B);
          tma_load_panel(sQD + F::QD / 2 + (part * NP + p) * PANEL, domap,
                         qd_full, 32 * p, w.h, w.i * T, w.b + part * B);
        }
      int u = 0;
      for (int j = 0; j < w.nk; ++j) {
        for (int o = 0; o < U; ++o, ++u) {
          const int s = u % R, use = u / R, g = o % 2, k = o / 2;
          if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
          unsigned char* dst = sRing + s * F::SLOT;
          mbar_expect_tx(&full[s], F::SLOT);
          for (int part = 0; part < 2; ++part) {
            if (k < NP)
              tma_load_panel(dst + part * PANEL, g == 0 ? kmap : vmap,
                             &full[s], 32 * k, w.hk, j * T, w.b + part * B);
            else
              tma_load_panel(dst + part * PANEL, ktmap, &full[s],
                             j * T + 32 * (k - NP), w.hk, w.col0 + 64 * g,
                             w.b + part * B);
          }
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const unsigned char* sA = sQD + wg * (F::QD / 2);  // Q (wg 0) or dO
  // Unit k of this warpgroup in k tile j.
  auto pos = [&](int j, int k) { return j * U + 2 * k + wg; };
  auto slot_of = [&](int unit) { return sRing + unit % R * F::SLOT; };
  auto release = [&](int unit) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[unit % R]);
  };
  // Take this warpgroup's unit, passing the other's just before it.
  auto acquire = [&](int unit) {
    if (unit > 0) {
      mbar_wait(&full[(unit - 1) % R], ((unit - 1) / R) & 1);
      release(unit - 1);
    }
    mbar_wait(&full[unit % R], (unit / R) & 1);
  };

  float stat[2];
  dq_rows(stat, (wg == 0 ? lse : delta) +
                    (static_cast<int64_t>(w.b) * H + w.h) * Sq,
          w.i, Sq, tid);
  float acc[32];                                  // dQ, 64 columns
#pragma unroll
  for (int e = 0; e < 32; ++e) acc[e] = 0.0f;

  mbar_wait(qd_full, 0);
  for (int j = 0; j < w.nk; ++j) {
    float x[32], tc[2][32];
    // S = Q K^T (wg 0) or dP = dO V^T over head_dim, a panel a unit.
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      acquire(pos(j, p));
      const unsigned char* st = slot_of(pos(j, p));
      wgmma_fence();
      unit_ss<4>(
          tc[p % 2],
          [&](int kk, int part) { return sA + (part * NP + p) * PANEL; },
          [&](int kk, int part) { return st + part * PANEL; });
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        add_unit(x, tc[(p - 1) % 2], p == 1);
        release(pos(j, p - 1));
      }
    }
    wgmma_wait<0>();
    add_unit(x, tc[(NP - 1) % 2], NP == 1);
    release(pos(j, NP - 1));

    dq_operand(x, wg, stat, sP, w.i, j, Sk, causal, q_offset, scale, tid);

    // dQ += dS K over this warpgroup's 64 columns: the two 32-key panels
    // of K^T, 8 k-steps summed in the tensor cores.
    uint32_t fh[8][4], fl[8][4];
    split_frags(fh, fl, x);
    wgmma_fence();
#pragma unroll
    for (int pk = 0; pk < 2; ++pk) {
      const int unit = pos(j, NP + pk);
      acquire(unit);
      const unsigned char* st = slot_of(unit);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t bhi = desc_panel(st, kk);
        const uint64_t blo = desc_panel(st + PANEL, kk);
        wgmma_tf32_rs(tc[0], fl[4 * pk + kk], bhi, pk > 0 || kk > 0);
        wgmma_tf32_rs(tc[0], fh[4 * pk + kk], blo, 1);
        wgmma_tf32_rs(tc[0], fh[4 * pk + kk], bhi, 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    reg_fence(tc[0]);
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[e] += tc[0][e];
    release(pos(j, NP));
    release(pos(j, NP + 1));
  }

  // This warpgroup's 64 columns of dQ; query rows past Sq never.
  store_acc(dq + (static_cast<int64_t>(w.b) * Sq + w.i * T) * H * D +
                static_cast<int64_t>(w.h) * D + w.col0 + 64 * wg,
            acc, H * D, Sq - w.i * T, warp, lane);
}

// D = 256-512: two rings of R slots of 32 KB, one a warpgroup, each with
// its producer thread: warpgroup 0's (thread 256) Q and K panels, then its
// K^T units; warpgroup 1's (thread 288) dO and V panels, then its K^T
// units. A K^T unit is 64 head_dim rows by the k tile's 64 keys.
template <int D>
__device__ __forceinline__ void dq_streamed(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap,
    const CUtensorMap* ktmap, const float* lse, const float* delta,
    float* dq, int B, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  using namespace hopper;
  using F = Dq<D>;
  constexpr int R = F::R, NSU = F::NSU;
  unsigned char* sRing = align_1024(smem);        // ring g: R slots at g R
  float* sP = reinterpret_cast<float*>(sRing + 2 * R * UNIT);  // P, dS
  uint64_t* full = reinterpret_cast<uint64_t*>(sP + T * T);
  uint64_t* empty = full + 2 * R;                 // [ring][slot]

  const DqWork w = dq_work<F::NZ, F::CW>(H, Hkv, Sq, Sk, causal, q_offset);
  if (threadIdx.x == 0) {
    for (int s = 0; s < 2 * R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS / 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    reg_dealloc<40>();
    const int g = (threadIdx.x - 256) / 32;
    if (threadIdx.x % 32 == 0 && g < 2) {
      const CUtensorMap* amap = g == 0 ? qmap : domap;
      const CUtensorMap* bmap = g == 0 ? kmap : vmap;
      const int U = NSU + (g == 0 ? F::NU0 : F::NU1);
      const int col = w.col0 + 64 * (g == 0 ? 0 : F::NU0);
      unsigned char* ring = sRing + g * R * UNIT;
      int u = 0;
      for (int j = 0; j < w.nk; ++j) {
        for (int p = 0; p < U; ++p, ++u) {
          const int s = u % R, use = u / R;
          if (use > 0) mbar_wait(&empty[g * R + s], (use - 1) & 1);
          unsigned char* dst = ring + s * UNIT;
          uint64_t* bar = &full[g * R + s];
          mbar_expect_tx(bar, UNIT);
          for (int part = 0; part < 2; ++part) {
            if (p < NSU) {
              tma_load_panel(dst + part * PANEL, amap, bar, 32 * p, w.h,
                             w.i * T, w.b + part * B);
              tma_load_panel(dst + (2 + part) * PANEL, bmap, bar, 32 * p,
                             w.hk, j * T, w.b + part * B);
            } else {
              for (int c = 0; c < 2; ++c)
                tma_load_panel(dst + (2 * part + c) * PANEL, ktmap, bar,
                               j * T + 32 * c, w.hk, col + 64 * (p - NSU),
                               w.b + part * B);
            }
          }
        }
      }
    }
    return;
  }

  reg_alloc<232>();
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int nu = wg == 0 ? F::NU0 : F::NU1;       // this warpgroup's units
  const int U = NSU + nu;
  const unsigned char* ring = sRing + wg * R * UNIT;
  auto slot_of = [&](int unit) { return ring + unit % R * UNIT; };
  auto wait_unit = [&](int unit) {
    mbar_wait(&full[wg * R + unit % R], (unit / R) & 1);
  };
  auto release = [&](int unit) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[wg * R + unit % R]);
  };

  float stat[2];
  dq_rows(stat, (wg == 0 ? lse : delta) +
                    (static_cast<int64_t>(w.b) * H + w.h) * Sq,
          w.i, Sq, tid);
  float acc[2][32];                               // dQ, up to 128 columns
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;

  int u = 0;
  for (int j = 0; j < w.nk; ++j, u += U) {
    float x[32], tc[2][32];
    // S = Q K^T (wg 0) or dP = dO V^T (wg 1) over head_dim: a unit is a
    // 32-column panel of both operands, A at panels 0-1, B at 2-3.
#pragma unroll
    for (int p = 0; p < NSU; ++p) {
      wait_unit(u + p);
      const unsigned char* st = slot_of(u + p);
      wgmma_fence();
      unit_ss<4>(
          tc[p % 2], [&](int kk, int part) { return st + part * PANEL; },
          [&](int kk, int part) { return st + (2 + part) * PANEL; });
      wgmma_commit();
      if (p > 0) {
        wgmma_wait<1>();
        add_unit(x, tc[(p - 1) % 2], p == 1);
        release(u + p - 1);
      }
    }
    wgmma_wait<0>();
    add_unit(x, tc[(NSU - 1) % 2], NSU == 1);
    release(u + NSU - 1);

    dq_operand(x, wg, stat, sP, w.i, j, Sk, causal, q_offset, scale, tid);

    // dQ += dS K over this warpgroup's 64-column units, B a K^T unit.
    uint32_t fh[8][4], fl[8][4];
    split_frags(fh, fl, x);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (c >= nu) break;
      const int unit = u + NSU + c;
      wait_unit(unit);
      wgmma_fence();
      unit_rs(tc[0], fh, fl, slot_of(unit));
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(tc[0]);
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] += tc[0][e];
      release(unit);
    }
  }

  // This warpgroup's units of dQ; query rows past Sq never.
  float* dst = dq + (static_cast<int64_t>(w.b) * Sq + w.i * T) * H * D +
               static_cast<int64_t>(w.h) * D + w.col0 +
               64 * (wg == 0 ? 0 : F::NU0);
#pragma unroll
  for (int c = 0; c < 2; ++c)
    if (c < nu) store_acc(dst + 64 * c, acc[c], H * D, Sq - w.i * T, warp,
                          lane);
}

template <int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_dq_f32tc_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap,
    const __grid_constant__ CUtensorMap ktmap, const float* __restrict__ lse,
    const float* __restrict__ delta, float* __restrict__ dq, int B, int H,
    int Hkv, int Sq, int Sk, int causal, int q_offset, float scale) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (Dq<D>::QRES)
    dq_resident<D>(smem_raw, &qmap, &kmap, &vmap, &domap, &ktmap, lse, delta,
                   dq, B, H, Hkv, Sq, Sk, causal, q_offset, scale);
  else
    dq_streamed<D>(smem_raw, &qmap, &kmap, &vmap, &domap, &ktmap, lse, delta,
                   dq, B, H, Hkv, Sq, Sk, causal, q_offset, scale);
}

static_assert(Fwd<128>::SMEM <= 232448 && Fwd<256>::SMEM <= 232448 &&
                  Fwd<384>::SMEM <= 232448 && Fwd<512>::SMEM <= 232448 &&
                  Dkv<128>::SMEM <= 232448 && Dkv<512>::SMEM <= 232448 &&
                  Dq<128>::SMEM <= 232448 && Dq<512>::SMEM <= 232448,
              "shared memory over the 227 KB a block can use");

// The prologue's copies, in floats: the forward's Q and K ([2][B][S][H][D])
// and V^T ([2][B][Hkv][D][Sk]); the dK/dV's Q, dO, K and V and Q^T, dO^T.
struct Copies {
  int64_t q, kv;   // floats of one part (hi or lo) of a q-side, kv-side copy
};
inline Copies copies(int B, int H, int Hkv, int Sq, int Sk, int D) {
  return {static_cast<int64_t>(B) * Sq * H * D,
          static_cast<int64_t>(B) * Sk * Hkv * D};
}

// Split x [B, S, H, D] into nat and/or trn (flash_split_f32tc_kernel).
int split(const float* x, int B, int S, int H, int D, int sb, int ss, int sh,
          float* nat, float* trn, cudaStream_t stream) {
  const dim3 grid(cdiv(S, 32), D / 32, B * H);
  flash_split_f32tc_kernel<<<grid, 256, 0, stream>>>(x, B, S, H, D, sb, ss,
                                                     sh, nat, trn);
  return (int)cudaGetLastError();
}

// The tensor map of a split natural copy [2B, S, H, D] or transposed one
// [2B, H, D, S] (read as B, D rows, H, S columns).
CUresult nat_map(CUtensorMap* m, const float* base, int B, int S, int H,
                 int D) {
  return hopper::make_bshd_map_f32(m, base, 2 * B, S, H, D,
                                   static_cast<int64_t>(S) * H * D,
                                   static_cast<int64_t>(H) * D, D);
}
CUresult trn_map(CUtensorMap* m, const float* base, int B, int S, int H,
                 int D) {
  return hopper::make_bshd_map_f32(m, base, 2 * B, D, H, S,
                                   static_cast<int64_t>(H) * D * S, S,
                                   static_cast<int64_t>(D) * S);
}

// The forward's prologue: Q and K split, V^T split, into ws as [Q | K |
// V^T] (flash_f32tc_workspace).
int prologue_fwd(const float* q, const float* k, const float* v, float* ws,
                 int B, int H, int Hkv, int Sq, int Sk, int D, int q_sb,
                 int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                 int v_ss, int v_sh, cudaStream_t stream) {
  const Copies n = copies(B, H, Hkv, Sq, Sk, D);
  float* qs = ws;
  float* ks = qs + 2 * n.q;
  float* vt = ks + 2 * n.kv;
  int rc;
  if ((rc = split(q, B, Sq, H, D, q_sb, q_ss, q_sh, qs, nullptr, stream)) ||
      (rc = split(k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, ks, nullptr, stream)))
    return rc;
  return split(v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, nullptr, vt, stream);
}

// The dK/dV's prologue: Q and dO split and transposed, K and V split, into
// ws as [Q | dO | Q^T | dO^T | K | V].
int prologue_dkv(const float* q, const float* k, const float* v,
                 const float* dout, float* ws, int B, int H, int Hkv, int Sq,
                 int Sk, int D, int q_sb, int q_ss, int q_sh, int k_sb,
                 int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
                 int do_ss, int do_sh, cudaStream_t stream) {
  const Copies n = copies(B, H, Hkv, Sq, Sk, D);
  float* qs = ws;
  float* dos = qs + 2 * n.q;
  float* qt = dos + 2 * n.q;
  float* dot = qt + 2 * n.q;
  float* ks = dot + 2 * n.q;
  float* vs = ks + 2 * n.kv;
  int rc;
  if ((rc = split(q, B, Sq, H, D, q_sb, q_ss, q_sh, qs, qt, stream)) ||
      (rc = split(dout, B, Sq, H, D, do_sb, do_ss, do_sh, dos, dot,
                  stream)) ||
      (rc = split(k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, ks, nullptr, stream)))
    return rc;
  return split(v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, vs, nullptr, stream);
}

// The dQ's copies in its workspace: [Q | dO | K | V | K^T].
struct DqCopies {
  float *q, *dout, *k, *v, *kt;
};
inline DqCopies dq_copies(float* ws, int B, int H, int Hkv, int Sq, int Sk,
                          int D) {
  const Copies n = copies(B, H, Hkv, Sq, Sk, D);
  DqCopies c;
  c.q = ws;
  c.dout = c.q + 2 * n.q;
  c.k = c.dout + 2 * n.q;
  c.v = c.k + 2 * n.kv;
  c.kt = c.v + 2 * n.kv;
  return c;
}

// The dQ's prologue: Q, dO and V split, K split and transposed.
int prologue_dq(const float* q, const float* k, const float* v,
                const float* dout, float* ws, int B, int H, int Hkv, int Sq,
                int Sk, int D, int q_sb, int q_ss, int q_sh, int k_sb,
                int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
                int do_ss, int do_sh, cudaStream_t stream) {
  const DqCopies c = dq_copies(ws, B, H, Hkv, Sq, Sk, D);
  int rc;
  if ((rc = split(q, B, Sq, H, D, q_sb, q_ss, q_sh, c.q, nullptr, stream)) ||
      (rc = split(dout, B, Sq, H, D, do_sb, do_ss, do_sh, c.dout, nullptr,
                  stream)) ||
      (rc = split(k, B, Sk, Hkv, D, k_sb, k_ss, k_sh, c.k, c.kt, stream)))
    return rc;
  return split(v, B, Sk, Hkv, D, v_sb, v_ss, v_sh, c.v, nullptr, stream);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, float* ws, int B, int H, int Hkv, int Sq, int Sk,
               int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
               int v_sb, int v_ss, int v_sh, int causal, int q_offset,
               float scale, cudaStream_t stream) {
  const Copies n = copies(B, H, Hkv, Sq, Sk, D);
  float* qs = ws;
  float* ks = qs + 2 * n.q;
  float* vt = ks + 2 * n.kv;
  int rc;
  if ((rc = prologue_fwd(q, k, v, ws, B, H, Hkv, Sq, Sk, D, q_sb, q_ss, q_sh,
                         k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, stream)))
    return rc;
  CUtensorMap qm, km, vm;
  CUresult cr;
  if ((cr = nat_map(&qm, qs, B, Sq, H, D)) ||
      (cr = nat_map(&km, ks, B, Sk, Hkv, D)) ||
      (cr = trn_map(&vm, vt, B, Sk, Hkv, D)))
    return -static_cast<int>(cr);
  cudaFuncSetAttribute(flash_fwd_f32tc_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Fwd<D>::SMEM);
  const int grid = cdiv(n_tiles(Sq), 2) * Fwd<D>::NZ * H * B;
  flash_fwd_f32tc_kernel<D><<<grid, NT_WS, Fwd<D>::SMEM, stream>>>(
      qm, km, vm, out, lse, B, H, Hkv, Sq, Sk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, float* ws, int B, int H, int Hkv, int Sq, int Sk,
              int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
              int v_sb, int v_ss, int v_sh, int do_sb, int do_ss, int do_sh,
              int causal, int q_offset, float scale, cudaStream_t stream) {
  const DqCopies c = dq_copies(ws, B, H, Hkv, Sq, Sk, D);
  int rc;
  if ((rc = prologue_dq(q, k, v, dout, ws, B, H, Hkv, Sq, Sk, D, q_sb, q_ss,
                        q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb,
                        do_ss, do_sh, stream)))
    return rc;
  CUtensorMap qm, km, vm, dom, ktm;
  CUresult cr;
  if ((cr = nat_map(&qm, c.q, B, Sq, H, D)) ||
      (cr = nat_map(&dom, c.dout, B, Sq, H, D)) ||
      (cr = nat_map(&km, c.k, B, Sk, Hkv, D)) ||
      (cr = nat_map(&vm, c.v, B, Sk, Hkv, D)) ||
      (cr = trn_map(&ktm, c.kt, B, Sk, Hkv, D)))
    return -static_cast<int>(cr);
  cudaFuncSetAttribute(flash_dq_f32tc_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Dq<D>::SMEM);
  const int grid = n_tiles(Sq) * Dq<D>::NZ * H * B;
  flash_dq_f32tc_kernel<D><<<grid, NT_WS, Dq<D>::SMEM, stream>>>(
      qm, km, vm, dom, ktm, lse, delta, dq, B, H, Hkv, Sq, Sk, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, float* ws, int B, int H, int Hkv, int Sq,
               int Sk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
               int k_sh, int v_sb, int v_ss, int v_sh, int do_sb, int do_ss,
               int do_sh, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  const Copies n = copies(B, H, Hkv, Sq, Sk, D);
  float* qs = ws;
  float* dos = qs + 2 * n.q;
  float* qt = dos + 2 * n.q;
  float* dot = qt + 2 * n.q;
  float* ks = dot + 2 * n.q;
  float* vs = ks + 2 * n.kv;
  int rc;
  if ((rc = prologue_dkv(q, k, v, dout, ws, B, H, Hkv, Sq, Sk, D, q_sb, q_ss,
                         q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb,
                         do_ss, do_sh, stream)))
    return rc;
  CUtensorMap qm, km, vm, dom, qtm, dotm;
  CUresult cr;
  if ((cr = nat_map(&qm, qs, B, Sq, H, D)) ||
      (cr = nat_map(&dom, dos, B, Sq, H, D)) ||
      (cr = nat_map(&km, ks, B, Sk, Hkv, D)) ||
      (cr = nat_map(&vm, vs, B, Sk, Hkv, D)) ||
      (cr = trn_map(&qtm, qt, B, Sq, H, D)) ||
      (cr = trn_map(&dotm, dot, B, Sq, H, D)))
    return -static_cast<int>(cr);
  cudaFuncSetAttribute(flash_dkv_f32tc_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       Dkv<D>::SMEM);
  const int grid = cdiv(n_tiles(Sk), 2) * Dkv<D>::NZ * Hkv * B;
  flash_dkv_f32tc_kernel<D><<<grid, NT_WS, Dkv<D>::SMEM, stream>>>(
      qm, km, vm, dom, qtm, dotm, lse, delta, dk, dv, B, H, Hkv, Sq, Sk,
      causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

#define F32TC_CASES(L, ARGS)                 \
  switch (head_dim) {                        \
    case 128: return L<128> ARGS;            \
    case 256: return L<256> ARGS;            \
    case 384: return L<384> ARGS;            \
    case 512: return L<512> ARGS;            \
  }                                          \
  return (int)cudaErrorInvalidValue;

// Bytes of the workspace the forward (kind 0), the dQ (kind 1) or the
// dK/dV (kind 2) takes for its prologue's copies.
long long flash_f32tc_workspace(int kind, int B, int H, int Hkv, int Sq,
                                int Sk, int head_dim) {
  const Copies n = copies(B, H, Hkv, Sq, Sk, head_dim);
  const int64_t parts = kind == 0   ? 2 * n.q + 4 * n.kv
                        : kind == 1 ? 4 * n.q + 6 * n.kv
                                    : 8 * n.q + 4 * n.kv;
  return static_cast<long long>(parts) * 4;
}

// The prologue of the forward (kind 0), the dQ (kind 1) or the dK/dV
// (kind 2) alone, into a workspace of flash_f32tc_workspace bytes: the
// launches the three entries below make first, for timing them apart and
// checking the copies (dout unread by the forward's).
int flash_prologue_f32tc(int kind, const void* q, const void* k,
                         const void* v, const void* dout, int B, int H,
                         int Hkv, int Sq, int Sk, int q_sb, int q_ss,
                         int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                         int v_ss, int v_sh, int do_sb, int do_ss, int do_sh,
                         void* workspace, int head_dim, void* stream) {
  if (kind < 0 || kind > 2 || workspace == nullptr ||
      (head_dim != 128 && head_dim != 256 && head_dim != 384 &&
       head_dim != 512))
    return (int)cudaErrorInvalidValue;
  if (kind == 0)
    return prologue_fwd((const float*)q, (const float*)k, (const float*)v,
                        (float*)workspace, B, H, Hkv, Sq, Sk, head_dim, q_sb,
                        q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
                        (cudaStream_t)stream);
  if (kind == 1)
    return prologue_dq((const float*)q, (const float*)k, (const float*)v,
                       (const float*)dout, (float*)workspace, B, H, Hkv, Sq,
                       Sk, head_dim, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                       v_ss, v_sh, do_sb, do_ss, do_sh, (cudaStream_t)stream);
  return prologue_dkv((const float*)q, (const float*)k, (const float*)v,
                      (const float*)dout, (float*)workspace, B, H, Hkv, Sq,
                      Sk, head_dim, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
                      v_ss, v_sh, do_sb, do_ss, do_sh, (cudaStream_t)stream);
}

int flash_fwd_f32tc(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int H, int Hkv, int Sq, int Sk,
                    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
                    int k_sh, int v_sb, int v_ss, int v_sh, void* workspace,
                    int causal, int q_offset, float scale, int dtype,
                    int head_dim, void* stream) {
  if (dtype != DT_F32 || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  F32TC_CASES(launch_fwd,
              ((const float*)q, (const float*)k, (const float*)v,
               (float*)out, (float*)lse, (float*)workspace, B, H, Hkv, Sq,
               Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh,
               causal, q_offset, scale, (cudaStream_t)stream))
}

// workspace: flash_f32tc_workspace(1, ...) bytes for the prologue's
// copies.
int flash_dq_f32tc(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
                   int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                   int v_ss, int v_sh, int do_sb, int do_ss, int do_sh,
                   void* workspace, int causal, int q_offset, float scale,
                   int dtype, int head_dim, void* stream) {
  if (dtype != DT_F32 || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  F32TC_CASES(launch_dq,
              ((const float*)q, (const float*)k, (const float*)v,
               (const float*)dout, (const float*)lse, (const float*)delta,
               (float*)dq, (float*)workspace, B, H, Hkv, Sq, Sk, q_sb, q_ss,
               q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
               causal, q_offset, scale, (cudaStream_t)stream))
}

// workspace: flash_f32tc_workspace(2, ...) bytes for the prologue's
// copies; splits is the wgmma dK/dV's (flash_attention.cu) and must be 1.
int flash_dkv_f32tc(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
                    int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
                    int do_ss, int do_sh, void* workspace, int splits,
                    int causal, int q_offset, float scale, int dtype,
                    int head_dim, void* stream) {
  if (dtype != DT_F32 || splits != 1 || workspace == nullptr)
    return (int)cudaErrorInvalidValue;
  F32TC_CASES(launch_dkv,
              ((const float*)q, (const float*)k, (const float*)v,
               (const float*)dout, (const float*)lse, (const float*)delta,
               (float*)dk, (float*)dv, (float*)workspace, B, H, Hkv, Sq, Sk,
               q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb,
               do_ss, do_sh, causal, q_offset, scale, (cudaStream_t)stream))
}

}  // extern "C"
