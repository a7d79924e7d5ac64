// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of
// tf_operator_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel  (launched by _fwd,      pallas_call :143)
//   flash_dq_kernel   <- _dq_kernel   (launched by _bwd_impl, pallas_call :261)
//   flash_dkv_kernel  <- _dkv_kernel  (launched by _bwd_impl, pallas_call :289)
//
// What each computes is the TPU kernel's function, with its cast points:
// scores and softmax statistics in f32, P cast to bf16 before P.V and
// P^T.dO, dS cast to bf16 before dS.K and dS^T.Q, every product
// accumulated in f32. Masked scores are the finite -1e30 of the TPU
// kernel, never -inf, so a fully masked row gives exp(0), not NaN; a
// softmax sum of 0 is guarded as 1. lse and delta are [B, H, S] f32.
// Tensors are read as [B, S, H, 128] through their strides (no
// transpose); head h reads KV head h / (H / Hkv) (native GQA). Sequence
// lengths must be multiples of 64 and D must be 128; the Python gate
// (flash_supported) states exactly that.
//
// What bounds them on the card: at D = 128 every (64 x 64) tile pair does
// 2-4 tensor-core products of 64x64x128 for 2-4 tile loads of 16 KB, so
// with the resident tiles reused across the whole loop the work is bounded
// by tensor-core operations, not by device memory.
//
// Forward and dK/dV (the Hopper design, hopper.cuh):
//   * Warp-specialised CTAs of 384 threads: two consumer warpgroups that
//     run wgmma (setmaxnreg 240 registers) and one producer warpgroup
//     (setmaxnreg 24) whose first thread streams tiles in with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle) into a ring of shared-memory
//     stages, each with a "full" mbarrier (TMA transaction bytes) and an
//     "empty" one (one arrival per consumer warp). Loads overlap the math;
//     the CTA never calls __syncthreads after the barriers are set up.
//   * Accumulators live in registers in wgmma's documented layout (each
//     row on the 4 lanes of a quad), so the softmax statistics need only
//     quad shuffles, P and dS become wgmma's register A operand without
//     touching shared memory, and every accumulator is written once.
//   * The tensor maps are built on the host in each C entry
//     (cuTensorMapEncodeTiled looked up in libcuda, no -lcuda) and passed
//     as __grid_constant__ parameters.
// dQ keeps the first port's design: nvcuda::wmma 16x16x16 tiles in shared
// memory, 4 warps per CTA, synchronous loads.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), or the negated CUresult when a tensor map cannot be
// built; the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "hopper.cuh"

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;        // head_dim
constexpr int T = 64;         // tile rows (q and k)
constexpr int NT = 128;       // threads per dQ CTA (4 warps)
constexpr int LDH = D + 8;    // bf16 row stride of a [64, 128] tile
constexpr int LDP = T + 8;    // bf16 row stride of a [64, 64] tile
constexpr int LDS = T + 4;    // f32 row stride of a [64, 64] tile
constexpr int LDO = D + 4;    // f32 row stride of a [64, 128] tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int TILE_H = T * LDH * 2;   // bytes of one bf16 [64, 128] tile
constexpr int TILE_S = T * LDS * 4;   // bytes of one f32 [64, 64] tile
constexpr int TILE_P = T * LDP * 2;   // bytes of one bf16 [64, 64] tile
constexpr int TILE_O = T * LDO * 4;   // bytes of one f32 [64, 128] tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// The warp-specialised kernels (forward, dK/dV).
constexpr int NT_WS = 384;            // 2 consumer warpgroups + 1 producer
constexpr int CONSUMER_WARPS = 8;
constexpr int TILE = hopper::TILE_BYTES;

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// Quad (4-lane) reductions over one accumulator row.
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

struct Strides {  // element strides of a [B, S, H, D] tensor (D stride 1)
  int b, s, h;
};

__device__ __forceinline__ const bf16* row_ptr(const bf16* base, Strides st,
                                               int b, int row, int h) {
  return base + (int64_t)b * st.b + (int64_t)row * st.s + (int64_t)h * st.h;
}

// Copy 64 rows of 128 bf16 (row r at src + r * row_stride) into a padded
// shared tile, 16 bytes per thread per step.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          int row_stride) {
  for (int idx = threadIdx.x; idx < T * (D / 8); idx += NT) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + (int64_t)r * row_stride + c);
  }
}

// Write 64 rows of 128 f32 as bf16.
__device__ __forceinline__ void store_tile(bf16* dst, int row_stride,
                                           const float* src) {
  for (int idx = threadIdx.x; idx < T * (D / 2); idx += NT) {
    const int r = idx / (D / 2), c = (idx % (D / 2)) * 2;
    const __nv_bfloat162 v = __floats2bfloat162_rn(src[r * LDO + c],
                                                   src[r * LDO + c + 1]);
    *reinterpret_cast<__nv_bfloat162*>(dst + (int64_t)r * row_stride + c) = v;
  }
}

// out[16 x 64] (f32, ld LDS) = A[16 x 128] . B^T where B is [64 x 128]
// row-major (so B^T is read column-major).
__device__ __forceinline__ void mm_abt(float* out, const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int n = 0; n < T / 16; ++n) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBc fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, b + n * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + n * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[n] (16 x 128 as 8 fragments) += A[16 x 64] (ld LDP) . B[64 x 128]
// (row-major, ld LDH).
__device__ __forceinline__ void mm_acc(FragC* acc, const bf16* a,
                                       const bf16* b) {
#pragma unroll
  for (int kk = 0; kk < T / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDP);
#pragma unroll
    for (int n = 0; n < D / 16; ++n) {
      FragBr fb;
      wmma::load_matrix_sync(fb, b + kk * 16 * LDH + n * 16, LDH);
      wmma::mma_sync(acc[n], fa, fb, acc[n]);
    }
  }
}

// Last k tile (exclusive) visible to q tile i: the TPU's _block_visible,
// j * T <= i * T + q_offset + T - 1.
__device__ __forceinline__ int k_tiles_visible(int i, int nk, int causal,
                                               int q_offset) {
  if (!causal) return nk;
  const int last = (i * T + q_offset + T - 1) / T;
  return min(nk, last + 1);
}

// First q tile that sees k tile j (causal): i * T + q_offset + T - 1 >= j * T.
__device__ __forceinline__ int first_q_tile(int j, int causal, int q_offset) {
  if (!causal) return 0;
  const int need = j * T - q_offset - (T - 1);
  return need > 0 ? (need + T - 1) / T : 0;
}

// ---------------------------------------------------------------------------
// Forward: one CTA per (128 query rows, head, batch). Replaces _fwd_kernel
// (tf_operator_tpu/ops/flash_attention.py:95). Bound by tensor-core
// operations: 4 D FLOPs per visible (q, k) pair against the K and V tile
// loads, which the producer streams through a FWD_STAGES ring while the
// consumers compute.
//   * Consumer warpgroup g owns q tile 2c + g (64 rows; with an odd count
//     of q tiles the last CTA's second warpgroup has no rows, computes
//     nothing and still releases every stage). Its Q tile stays resident.
//   * Per k tile: S = Q K^T (8 wgmma m64n64k16, both K-major from shared
//     memory), scale and the causal mask (diagonal tiles only) in
//     registers, online softmax on the accumulator layout (quad shuffles),
//     P rounded to bf16 in registers and O += P V (4 wgmma m64n128k16, A
//     from registers, V N-major). O, m and l never leave registers; O is
//     rescaled there and written once.
//   * Causal k tiles past a q tile's diagonal are never loaded (the
//     producer stops at the CTA's last visible tile).
//   * Blocks are numbered heaviest q tiles first, so the short causal
//     tiles fill the last wave instead of the long ones.
// ---------------------------------------------------------------------------
constexpr int FWD_STAGES = 2;
constexpr int SMEM_FWD = 1024 + 2 * TILE + FWD_STAGES * 2 * TILE +
                         8 * (1 + 2 * FWD_STAGES);

__global__ void __launch_bounds__(NT_WS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sQ = align_1024(smem_raw);               // 2 tiles
  unsigned char* sKV = sQ + 2 * TILE;                     // stage s: K, V
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sKV + FWD_STAGES * 2 * TILE);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + FWD_STAGES;

  const int nqt = Sq / T, nkt = Sk / T;
  const int ncta = (nqt + 1) / 2;
  const int hb = gridDim.x / ncta;                        // H * B
  const int c = ncta - 1 - static_cast<int>(blockIdx.x) / hb;
  const int h = static_cast<int>(blockIdx.x) % hb % H;
  const int b = static_cast<int>(blockIdx.x) % hb / H;
  const int hk = h / (H / Hkv);
  const int tiles_here = min(2, nqt - 2 * c);
  // k tiles the CTA streams: those its last q tile sees.
  const int nk = k_tiles_visible(2 * c + tiles_here - 1, nkt, causal, q_offset);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < FWD_STAGES; ++s) {
      mbar_init(&kv_full[s], 1);
      mbar_init(&kv_empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: Q once, then K and V tile by tile through the ring.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(q_full, tiles_here * TILE);
      for (int g = 0; g < tiles_here; ++g)
        tma_load_tile(sQ + g * TILE, &qmap, q_full, h, (2 * c + g) * T, b);
      for (int j = 0; j < nk; ++j) {
        const int s = j % FWD_STAGES, use = j / FWD_STAGES;
        if (use > 0) mbar_wait(&kv_empty[s], (use - 1) & 1);
        unsigned char* st = sKV + s * 2 * TILE;
        mbar_expect_tx(&kv_full[s], 2 * TILE);
        tma_load_tile(st, &kmap, &kv_full[s], hk, j * T, b);
        tma_load_tile(st + TILE, &vmap, &kv_full[s], hk, j * T, b);
      }
    }
  } else {
    reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int iq = 2 * c + wg;                            // this q tile
    const int my_nk =
        wg < tiles_here ? k_tiles_visible(iq, nkt, causal, q_offset) : 0;
    const unsigned char* myQ = sQ + wg * TILE;

    float o[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) o[i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % FWD_STAGES;
      mbar_wait(&kv_full[s], (j / FWD_STAGES) & 1);
      if (j < my_nk) {
        const unsigned char* sK = sKV + s * 2 * TILE;
        const unsigned char* sV = sK + TILE;
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n64k16_ss(sc, desc_kmajor(myQ, kk), desc_kmajor(sK, kk),
                             kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);

        // Scale, mask (diagonal tiles only), online softmax.
        const bool diag = causal && j * T + T - 1 > iq * T + q_offset;
        float mx[2] = {m[0], m[1]};
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          float x = sc[i] * scale;
          if (diag && iq * T + acc_row(i, warp, lane) + q_offset <
                          j * T + acc_col(i, lane))
            x = NEG_INF;
          sc[i] = x;
          mx[(i % 4) / 2] = fmaxf(mx[(i % 4) / 2], x);
        }
        float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = quad_max(mx[r]);
          corr[r] = exp2f((m[r] - mx[r]) * LOG2E);
          m[r] = mx[r];
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const float p = exp2f((sc[i] - mx[(i % 4) / 2]) * LOG2E);
          sc[i] = p;
          psum[(i % 4) / 2] += p;
        }
#pragma unroll
        for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
        for (int i = 0; i < 64; ++i) o[i] *= corr[(i % 4) / 2];

        // O += P V, P as bf16 register fragments.
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_a(pa[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs(o, pa[kk], desc_nmajor(sV, kk));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(o);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);
    }
    if (wg >= tiles_here) return;

    // Finalize: O / l (l == 0 guarded as 1, as the TPU kernel does), lse.
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float sum = quad_sum(l[r]);
      const float safe = sum == 0.0f ? 1.0f : sum;
      inv[r] = 1.0f / safe;
      const int row = iq * T + 16 * warp + lane / 4 + 8 * r;
      if (lane % 4 == 0)
        lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[r] + logf(safe);
    }
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = iq * T + acc_row(i, warp, lane);
      const float sc_ = inv[(i % 4) / 2];
      *reinterpret_cast<__nv_bfloat162*>(
          out + ((static_cast<int64_t>(b) * Sq + row) * H + h) * D +
          acc_col(i, lane)) = __floats2bfloat162_rn(o[i] * sc_, o[i + 1] * sc_);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ: one CTA per (q tile, head, batch). Replaces _dq_kernel
// (flash_attention.py:183). Bound by tensor-core operations (6 D FLOPs per
// visible pair: S, dP and dS.K); Q, dO, lse and delta stay resident and
// the dQ accumulator lives in wmma fragments, written once at the end.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_dq_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int H, int Hkv, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, Strides dos, int causal, int q_offset,
    float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + TILE_H);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * TILE_H);
  float* sS = reinterpret_cast<float*>(smem + 4 * TILE_H);
  float* sdP = reinterpret_cast<float*>(smem + 4 * TILE_H + TILE_S);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * TILE_H + 2 * TILE_S);
  float* sLse = reinterpret_cast<float*>(smem + 4 * TILE_H + 2 * TILE_S + TILE_P);
  float* sDelta = sLse + T;
  float* sStage = sS;  // after the loop: [64, 128] f32 over sS and sdP

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile(sQ, row_ptr(q, qs, b, i * T, h), qs.s);
  load_tile(sdO, row_ptr(dout, dos, b, i * T, h), dos.s);
  if (threadIdx.x < T) {
    const int64_t row = ((int64_t)b * H + h) * Sq + i * T + threadIdx.x;
    sLse[threadIdx.x] = lse[row];
    sDelta[threadIdx.x] = delta[row];
  }

  FragC acc[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) wmma::fill_fragment(acc[n], 0.0f);

  const int nk = k_tiles_visible(i, Sk / T, causal, q_offset);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();
    load_tile(sK, row_ptr(k, ks, b, j * T, hk), ks.s);
    load_tile(sV, row_ptr(v, vs, b, j * T, hk), vs.s);
    __syncthreads();

    mm_abt(sS + r0 * LDS, sQ + r0 * LDH, sK);     // S  = Q K^T
    mm_abt(sdP + r0 * LDS, sdO + r0 * LDH, sV);   // dP = dO V^T
    __syncwarp();

    for (int idx = lane; idx < 16 * T; idx += 32) {
      const int r = r0 + idx / T, col = idx % T;
      float s = sS[r * LDS + col] * scale;
      if (causal && i * T + r + q_offset < j * T + col) s = NEG_INF;
      const float p = expf(s - sLse[r]);
      const float ds = p * (sdP[r * LDS + col] - sDelta[r]) * scale;
      sdS[r * LDP + col] = __float2bfloat16_rn(ds);
    }
    __syncwarp();

    mm_acc(acc, sdS + r0 * LDP, sK);              // dQ += dS K
  }
  __syncthreads();  // sS / sdP are free: stage dQ through them

#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sStage + r0 * LDO + n * 16, acc[n], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  const Strides gs = {Sq * H * D, H * D, D};
  store_tile(dq + (int64_t)b * gs.b + (int64_t)(i * T) * gs.s +
                 (int64_t)h * gs.h,
             gs.s, sStage);
}

// ---------------------------------------------------------------------------
// Backward, dK/dV: one CTA per (pair of k tiles, kv head, batch). Replaces
// _dkv_kernel (flash_attention.py:207). Bound by tensor-core operations (8
// D FLOPs per visible pair: S^T, dP^T, P^T.dO, dS^T.Q).
//   * The CTA takes k tile j and then k tile nk - 1 - j (one tile when
//     they coincide). Under the causal mask tile j is seen by nq - j q
//     tiles, so every CTA walks the same number of (q tile, member) items
//     (nq + 1 per member when Sq = Sk) and the grid runs as one balanced
//     wave instead of a tail of long CTAs.
//   * Per k tile, K and V stay resident; the producer streams the items
//     (q tile i, group member g) -- Q, dO, lse and delta of head hk * G + g
//     -- through a DKV_STAGES ring, items alternating between the two
//     consumer warpgroups (two stages each).
//   * Both consumer warpgroups own the tile's 64 key rows and compute
//     transposed scores, so nothing is transposed through shared memory:
//     S^T = K Q^T and dP^T = V dO^T (wgmma, K and V resident, Q and dO
//     K-major B), P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) scale
//     in registers with lse and delta per column from the stage's row,
//     then dV += P^T dO and dK += dS^T Q (A from registers, dO and Q
//     N-major B).
//   * dK and dV stay in registers (64 each a thread). At the end of the
//     tile the second warpgroup hands its partial sums to the first
//     through shared memory, which adds and writes: the GQA sum stays
//     inside the CTA in a fixed order (deterministic, no atomics). A k
//     tile no query row sees gets zeros.
// ---------------------------------------------------------------------------
constexpr int DKV_STAGES = 4;
constexpr int DKV_STAGE = 2 * TILE + 1024;  // Q, dO, lse[64], delta[64]
constexpr int SMEM_DKV = 1024 + 2 * TILE + DKV_STAGES * DKV_STAGE +
                         T * D * 4 + 8 * (2 + 2 * DKV_STAGES);

__device__ __forceinline__ void store_acc(bf16* dst, const float (&acc)[64],
                                          int row_stride, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < 64; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(
        dst + static_cast<int64_t>(acc_row(i, warp, lane)) * row_stride +
        acc_col(i, lane)) = __floats2bfloat162_rn(acc[i], acc[i + 1]);
}

__global__ void __launch_bounds__(NT_WS, 1) flash_dkv_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
    const float* __restrict__ delta, bf16* __restrict__ dk,
    bf16* __restrict__ dv, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  using namespace hopper;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sK = align_1024(smem_raw);
  unsigned char* sV = sK + TILE;
  unsigned char* sStage = sV + TILE;
  float* xbuf = reinterpret_cast<float*>(sStage + DKV_STAGES * DKV_STAGE);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(xbuf + T * D);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* st_full = kv_empty + 1;
  uint64_t* st_empty = st_full + DKV_STAGES;

  const int nqt = Sq / T, nkt = Sk / T, group = H / Hkv;
  const int hb = gridDim.x / ((nkt + 1) / 2);            // Hkv * B
  const int pair = static_cast<int>(blockIdx.x) / hb;
  const int hk = static_cast<int>(blockIdx.x) % hb % Hkv;
  const int b = static_cast<int>(blockIdx.x) % hb / Hkv;
  const int n_jt = nkt - 1 - pair != pair ? 2 : 1;  // k tiles pair, nkt-1-pair

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMER_WARPS);
    for (int s = 0; s < DKV_STAGES; ++s) {
      mbar_init(&st_full[s], 1);
      mbar_init(&st_empty[s], CONSUMER_WARPS / 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: per k tile, K and V, then every item in order; item t goes
    // to warpgroup t % 2, whose n-th item uses stage (t % 2) + 2 (n % 2).
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      int cnt0 = 0, cnt1 = 0;  // items handed to each warpgroup so far
      for (int u = 0; u < n_jt; ++u) {
        const int j = u == 0 ? pair : nkt - 1 - pair;
        if (u > 0) mbar_wait(kv_empty, (u - 1) & 1);
        mbar_expect_tx(kv_full, 2 * TILE);
        tma_load_tile(sK, &kmap, kv_full, hk, j * T, b);
        tma_load_tile(sV, &vmap, kv_full, hk, j * T, b);
        const int i0 = first_q_tile(j, causal, q_offset);
        const int nqv = max(nqt - i0, 0);
        for (int t = 0; t < group * nqv; ++t) {
          const int w = t & 1, n = w ? cnt1++ : cnt0++;
          const int s = w + 2 * (n & 1), use = n >> 1;
          if (use > 0) mbar_wait(&st_empty[s], (use - 1) & 1);
          const int h = hk * group + t / nqv, i = i0 + t % nqv;
          unsigned char* st = sStage + s * DKV_STAGE;
          const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + i * T;
          mbar_expect_tx(&st_full[s], 2 * TILE + 2 * T * 4);
          tma_load_tile(st, &qmap, &st_full[s], h, i * T, b);
          tma_load_tile(st + TILE, &domap, &st_full[s], h, i * T, b);
          bulk_load(st + 2 * TILE, lse + row, T * 4, &st_full[s]);
          bulk_load(st + 2 * TILE + T * 4, delta + row, T * 4, &st_full[s]);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    int cnt = 0;
    for (int u = 0; u < n_jt; ++u) {
      const int j = u == 0 ? pair : nkt - 1 - pair;
      const int i0 = first_q_tile(j, causal, q_offset);
      const int nqv = max(nqt - i0, 0);
      float acc_dk[64], acc_dv[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.0f;

      mbar_wait(kv_full, u & 1);
      for (int t = wg; t < group * nqv; t += 2) {
        const int n = cnt++;
        const int s = wg + 2 * (n & 1);
        mbar_wait(&st_full[s], (n >> 1) & 1);
        const unsigned char* sQ = sStage + s * DKV_STAGE;
        const unsigned char* sdO = sQ + TILE;
        const float* sLse = reinterpret_cast<const float*>(sQ + 2 * TILE);
        const float* sDelta = sLse + T;
        const int i = i0 + t % nqv;

        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n64k16_ss(st, desc_kmajor(sK, kk), desc_kmajor(sQ, kk),
                             kk > 0);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk)
          wgmma_m64n64k16_ss(dpt, desc_kmajor(sV, kk), desc_kmajor(sdO, kk),
                             kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        reg_fence(dpt);

        // Rows are keys, columns queries of this item.
        const bool diag = causal && j * T + T - 1 > i * T + q_offset;
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int col = acc_col(e, lane);
          float x = st[e] * scale;
          if (diag && i * T + col + q_offset < j * T + acc_row(e, warp, lane))
            x = NEG_INF;
          const float p = exp2f((x - sLse[col]) * LOG2E);
          dpt[e] = p * (dpt[e] - sDelta[col]) * scale;
          st[e] = p;
        }

        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          frag_a(pa[kk], st, kk);
          frag_a(da[kk], dpt, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs(acc_dv, pa[kk], desc_nmajor(sdO, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs(acc_dk, da[kk], desc_nmajor(sQ, kk));
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(acc_dv);
        reg_fence(acc_dk);
        __syncwarp();
        if (lane == 0) mbar_arrive(&st_empty[s]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);  // K, V free for the next tile

      // Sum the two warpgroups' partials (fixed order) and write.
      const int64_t base =
          (static_cast<int64_t>(b) * Sk + j * T) * Hkv * D +
          static_cast<int64_t>(hk) * D;
      if (wg == 1)
#pragma unroll
        for (int i = 0; i < 64; ++i) xbuf[i * 128 + tid] = acc_dv[i];
      named_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc_dv[i] += xbuf[i * 128 + tid];
        store_acc(dv + base, acc_dv, Hkv * D, warp, lane);
      }
      named_sync(1, 256);
      if (wg == 1)
#pragma unroll
        for (int i = 0; i < 64; ++i) xbuf[i * 128 + tid] = acc_dk[i];
      named_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc_dk[i] += xbuf[i * 128 + tid];
        store_acc(dk + base, acc_dk, Hkv * D, warp, lane);
      }
      named_sync(1, 256);
    }
  }
}

constexpr int SMEM_DQ = 4 * TILE_H + 2 * TILE_S + TILE_P + 2 * T * 4;
static_assert(2 * TILE_S >= TILE_O, "dQ staging must fit over the score tiles");
static_assert(SMEM_FWD <= 232448 && SMEM_DKV <= 232448,
              "shared memory over the 227 KB a block can use");

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
              int v_ss, int v_sh, int causal, int q_offset, float scale,
              void* stream) {
  CUtensorMap qm, km, vm;
  CUresult rc;
  if ((rc = hopper::make_bshd_map(&qm, q, B, Sq, H, q_sb, q_ss, q_sh)) ||
      (rc = hopper::make_bshd_map(&km, k, B, Sk, Hkv, k_sb, k_ss, k_sh)) ||
      (rc = hopper::make_bshd_map(&vm, v, B, Sk, Hkv, v_sb, v_ss, v_sh)))
    return -static_cast<int>(rc);
  cudaFuncSetAttribute(flash_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  const int ncta = (Sq / T + 1) / 2;
  flash_fwd_kernel<<<ncta * H * B, NT_WS, SMEM_FWD, (cudaStream_t)stream>>>(
      qm, km, vm, (bf16*)out, (float*)lse, H, Hkv, Sq, Sk, causal, q_offset,
      scale);
  return (int)cudaGetLastError();
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H,
             int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh, int k_sb,
             int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
             int do_ss, int do_sh, int causal, int q_offset, float scale,
             void* stream) {
  cudaFuncSetAttribute(flash_dq_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DQ);
  const dim3 grid(Sq / T, H, B);
  flash_dq_kernel<<<grid, NT, SMEM_DQ, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dq, H, Hkv, Sq, Sk,
      Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh}, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh,
              int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
              int do_sb, int do_ss, int do_sh, int causal, int q_offset,
              float scale, void* stream) {
  CUtensorMap qm, km, vm, dom;
  CUresult rc;
  if ((rc = hopper::make_bshd_map(&qm, q, B, Sq, H, q_sb, q_ss, q_sh)) ||
      (rc = hopper::make_bshd_map(&km, k, B, Sk, Hkv, k_sb, k_ss, k_sh)) ||
      (rc = hopper::make_bshd_map(&vm, v, B, Sk, Hkv, v_sb, v_ss, v_sh)) ||
      (rc = hopper::make_bshd_map(&dom, dout, B, Sq, H, do_sb, do_ss, do_sh)))
    return -static_cast<int>(rc);
  cudaFuncSetAttribute(flash_dkv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
  const int npair = (Sk / T + 1) / 2;
  flash_dkv_kernel<<<npair * Hkv * B, NT_WS, SMEM_DKV, (cudaStream_t)stream>>>(
      qm, km, vm, dom, (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, H, Hkv, Sq, Sk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
