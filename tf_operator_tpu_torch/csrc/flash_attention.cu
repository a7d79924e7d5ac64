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
// kernel, never -inf, so a fully masked row gives exp(0), not NaN.
//
// What bounds them on the card: at D = 128 every (64 x 64) tile pair does
// 2-4 tensor-core products of 64x64x128 for 3-4 tile loads of 16 KB, so
// with the K/V (or Q/dO) tiles reused across the whole loop the work is
// bounded by tensor-core operations, not by device memory.
//
// Design (simple and right first; wgmma/TMA/warp specialisation are later
// work):
//   * The TPU grid runs in order and carries the online-softmax state in
//     VMEM scratch from one k-block to the next. Blocks on the card run in
//     parallel with nothing carried between them, so the sequential grid
//     axis becomes a loop inside one CTA: forward and dQ run one CTA per
//     (b, h, 64-row q tile) looping over the visible k tiles; dK/dV runs
//     one CTA per (b, h_kv, 64-row k tile) looping over every visible
//     (q tile, GQA group member), as _dkv_kernel does, so the GQA
//     reduction needs no atomics.
//   * 4 warps per CTA; warp w owns rows [16w, 16w+16) of every per-row
//     quantity (scores, P, the accumulators), so the softmax and the
//     elementwise backward need only __syncwarp, and the CTA synchronises
//     only around the tile loads.
//   * Products use nvcuda::wmma 16x16x16 bf16 fragments with f32
//     accumulation on tiles held in shared memory. Shared-memory rows are
//     padded by 16 bytes against bank conflicts while keeping every
//     fragment pointer 32-byte aligned.
//   * Tensors are read as [B, S, H, D] through their strides (no
//     transpose); head h reads KV head h / (H / Hkv) (native GQA).
//   * lse and delta are [B, H, S] f32. Sequence lengths must be multiples
//     of 64 and D must be 128; the Python gate (flash_supported) states
//     exactly that.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(); the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;        // head_dim
constexpr int T = 64;         // tile rows (q and k)
constexpr int NT = 128;       // threads per CTA (4 warps)
constexpr int LDH = D + 8;    // bf16 row stride of a [64, 128] tile
constexpr int LDP = T + 8;    // bf16 row stride of a [64, 64] tile
constexpr int LDS = T + 4;    // f32 row stride of a [64, 64] tile
constexpr int LDO = D + 4;    // f32 row stride of a [64, 128] tile
constexpr float NEG_INF = -1e30f;

constexpr int TILE_H = T * LDH * 2;   // bytes of one bf16 [64, 128] tile
constexpr int TILE_S = T * LDS * 4;   // bytes of one f32 [64, 64] tile
constexpr int TILE_P = T * LDP * 2;   // bytes of one bf16 [64, 64] tile
constexpr int TILE_O = T * LDO * 4;   // bytes of one f32 [64, 128] tile

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

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

// Write 64 rows of 128 f32 (scaled per row by inv[r], or 1) as bf16.
__device__ __forceinline__ void store_tile(bf16* dst, int row_stride,
                                           const float* src,
                                           const float* inv) {
  for (int idx = threadIdx.x; idx < T * (D / 2); idx += NT) {
    const int r = idx / (D / 2), c = (idx % (D / 2)) * 2;
    const float s = inv ? inv[r] : 1.0f;
    const __nv_bfloat162 v = __floats2bfloat162_rn(src[r * LDO + c] * s,
                                                   src[r * LDO + c + 1] * s);
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Last k tile (exclusive) visible to q tile i: the TPU's _block_visible,
// j * T <= i * T + q_offset + T - 1.
__device__ __forceinline__ int k_tiles_visible(int i, int nk, int causal,
                                               int q_offset) {
  if (!causal) return nk;
  const int last = (i * T + q_offset + T - 1) / T;
  return min(nk, last + 1);
}

// ---------------------------------------------------------------------------
// Forward: one CTA per (q tile, head, batch). Replaces _fwd_kernel
// (tf_operator_tpu/ops/flash_attention.py:95). Bound by tensor-core
// operations: 4 D FLOPs per visible (q, k) pair against 2 tile loads of
// K and V per k tile; the Q tile stays resident in shared memory for the
// whole loop, and causal k tiles past the diagonal are never loaded.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_fwd_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, bf16* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, Strides qs,
    Strides ks, Strides vs, int causal, int q_offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * TILE_H);
  float* sS = reinterpret_cast<float*>(smem + 3 * TILE_H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * TILE_H + TILE_S);
  float* sO = reinterpret_cast<float*>(smem + 3 * TILE_H + TILE_S + TILE_P);
  float* sM = reinterpret_cast<float*>(smem + 3 * TILE_H + TILE_S + TILE_P + TILE_O);
  float* sL = sM + T;

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;

  load_tile(sQ, row_ptr(q, qs, b, i * T, h), qs.s);
  for (int idx = threadIdx.x; idx < T * LDO; idx += NT) sO[idx] = 0.0f;
  if (threadIdx.x < T) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.0f;
  }

  const int nk = k_tiles_visible(i, Sk / T, causal, q_offset);
  for (int j = 0; j < nk; ++j) {
    __syncthreads();  // previous tiles fully consumed
    load_tile(sK, row_ptr(k, ks, b, j * T, hk), ks.s);
    load_tile(sV, row_ptr(v, vs, b, j * T, hk), vs.s);
    __syncthreads();

    mm_abt(sS + r0 * LDS, sQ + r0 * LDH, sK);
    __syncwarp();

    // Online softmax on this warp's 16 rows; each lane owns 2 columns.
    for (int r = r0; r < r0 + 16; ++r) {
      const int q_pos = i * T + r + q_offset;
      float s[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = lane + 32 * c;
        s[c] = sS[r * LDS + col] * scale;
        if (causal && q_pos < j * T + col) s[c] = NEG_INF;
      }
      const float m_prev = sM[r];
      const float m_next = fmaxf(m_prev, warp_max(fmaxf(s[0], s[1])));
      const float corr = expf(m_prev - m_next);
      float psum = 0.0f;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const float p = expf(s[c] - m_next);
        psum += p;
        sP[r * LDP + lane + 32 * c] = __float2bfloat16_rn(p);
      }
      psum = warp_sum(psum);
#pragma unroll
      for (int c = 0; c < D / 32; ++c) sO[r * LDO + lane + 32 * c] *= corr;
      __syncwarp();
      if (lane == 0) {
        sL[r] = sL[r] * corr + psum;
        sM[r] = m_next;
      }
    }
    __syncwarp();

    // O[r0:r0+16] += P . V, accumulated through the shared f32 tile.
    FragC acc[D / 16];
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::load_matrix_sync(acc[n], sO + r0 * LDO + n * 16, LDO,
                             wmma::mem_row_major);
    mm_acc(acc, sP + r0 * LDP, sV);
#pragma unroll
    for (int n = 0; n < D / 16; ++n)
      wmma::store_matrix_sync(sO + r0 * LDO + n * 16, acc[n], LDO,
                              wmma::mem_row_major);
  }
  __syncthreads();

  // Finalize: O / l (guard l == 0 as the TPU kernel does) and lse.
  if (threadIdx.x < T) {
    const int r = threadIdx.x;
    const float l = sL[r] == 0.0f ? 1.0f : sL[r];
    lse[((int64_t)b * H + h) * Sq + i * T + r] = sM[r] + logf(l);
    sL[r] = 1.0f / l;
  }
  __syncthreads();
  const Strides os = {Sq * H * D, H * D, D};
  store_tile(out + (int64_t)b * os.b + (int64_t)(i * T) * os.s +
                 (int64_t)h * os.h,
             os.s, sO, sL);
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
             gs.s, sStage, nullptr);
}

// ---------------------------------------------------------------------------
// Backward, dK/dV: one CTA per (k tile, kv head, batch); loops over every
// visible (q tile, group member) so the GQA sum stays inside the CTA.
// Replaces _dkv_kernel (flash_attention.py:207). Bound by tensor-core
// operations (8 D FLOPs per visible pair: S^T, dP^T, P^T.dO, dS^T.Q); K
// and V stay resident, both accumulators live in wmma fragments (which
// costs registers: see PERF.md), and no atomics are needed.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(NT) flash_dkv_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hkv, int Sq,
    int Sk, Strides qs, Strides ks, Strides vs, Strides dos, int causal,
    int q_offset, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + TILE_H);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * TILE_H);
  bf16* sdO = reinterpret_cast<bf16*>(smem + 3 * TILE_H);
  float* sSt = reinterpret_cast<float*>(smem + 4 * TILE_H);
  float* sdPt = reinterpret_cast<float*>(smem + 4 * TILE_H + TILE_S);
  bf16* sPt = reinterpret_cast<bf16*>(smem + 4 * TILE_H + 2 * TILE_S);
  bf16* sdSt = reinterpret_cast<bf16*>(smem + 4 * TILE_H + 2 * TILE_S + TILE_P);
  float* sLse = reinterpret_cast<float*>(smem + 4 * TILE_H + 2 * TILE_S + 2 * TILE_P);
  float* sDelta = sLse + T;
  float* sStage = sSt;  // after the loop: [64, 128] f32 over sSt and sdPt

  const int j = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int group = H / Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's k rows

  load_tile(sK, row_ptr(k, ks, b, j * T, hk), ks.s);
  load_tile(sV, row_ptr(v, vs, b, j * T, hk), vs.s);

  FragC acc_dk[D / 16], acc_dv[D / 16];
#pragma unroll
  for (int n = 0; n < D / 16; ++n) {
    wmma::fill_fragment(acc_dk[n], 0.0f);
    wmma::fill_fragment(acc_dv[n], 0.0f);
  }

  // First q tile that sees k tile j: i * T + q_offset + T - 1 >= j * T.
  const int nq = Sq / T;
  int i0 = 0;
  if (causal) {
    const int need = j * T - q_offset - (T - 1);
    i0 = need > 0 ? (need + T - 1) / T : 0;
  }
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    for (int i = i0; i < nq; ++i) {
      __syncthreads();
      load_tile(sQ, row_ptr(q, qs, b, i * T, h), qs.s);
      load_tile(sdO, row_ptr(dout, dos, b, i * T, h), dos.s);
      if (threadIdx.x < T) {
        const int64_t row = ((int64_t)b * H + h) * Sq + i * T + threadIdx.x;
        sLse[threadIdx.x] = lse[row];
        sDelta[threadIdx.x] = delta[row];
      }
      __syncthreads();

      mm_abt(sSt + r0 * LDS, sK + r0 * LDH, sQ);    // S^T  = K Q^T
      mm_abt(sdPt + r0 * LDS, sV + r0 * LDH, sdO);  // dP^T = V dO^T
      __syncwarp();

      for (int idx = lane; idx < 16 * T; idx += 32) {
        const int r = r0 + idx / T, col = idx % T;  // k row, q row
        float s = sSt[r * LDS + col] * scale;
        if (causal && i * T + col + q_offset < j * T + r) s = NEG_INF;
        const float p = expf(s - sLse[col]);
        const float ds = p * (sdPt[r * LDS + col] - sDelta[col]) * scale;
        sPt[r * LDP + col] = __float2bfloat16_rn(p);
        sdSt[r * LDP + col] = __float2bfloat16_rn(ds);
      }
      __syncwarp();

      mm_acc(acc_dv, sPt + r0 * LDP, sdO);          // dV += P^T dO
      mm_acc(acc_dk, sdSt + r0 * LDP, sQ);          // dK += dS^T Q
    }
  }
  __syncthreads();

  const Strides gs = {Sk * Hkv * D, Hkv * D, D};
  const int64_t base = (int64_t)b * gs.b + (int64_t)(j * T) * gs.s +
                       (int64_t)hk * gs.h;
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sStage + r0 * LDO + n * 16, acc_dv[n], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  store_tile(dv + base, gs.s, sStage, nullptr);
  __syncthreads();
#pragma unroll
  for (int n = 0; n < D / 16; ++n)
    wmma::store_matrix_sync(sStage + r0 * LDO + n * 16, acc_dk[n], LDO,
                            wmma::mem_row_major);
  __syncthreads();
  store_tile(dk + base, gs.s, sStage, nullptr);
}

constexpr int SMEM_FWD = 3 * TILE_H + TILE_S + TILE_P + TILE_O + 2 * T * 4;
constexpr int SMEM_DQ = 4 * TILE_H + 2 * TILE_S + TILE_P + 2 * T * 4;
constexpr int SMEM_DKV = 4 * TILE_H + 2 * TILE_S + 2 * TILE_P + 2 * T * 4;
static_assert(2 * TILE_S >= TILE_O, "dQ/dKV staging must fit over the score tiles");

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
              int v_ss, int v_sh, int causal, int q_offset, float scale,
              void* stream) {
  cudaFuncSetAttribute(flash_fwd_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_FWD);
  const dim3 grid(Sq / T, H, B);
  flash_fwd_kernel<<<grid, NT, SMEM_FWD, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)out,
      (float*)lse, H, Hkv, Sq, Sk, Strides{q_sb, q_ss, q_sh},
      Strides{k_sb, k_ss, k_sh}, Strides{v_sb, v_ss, v_sh}, causal, q_offset,
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
  cudaFuncSetAttribute(flash_dkv_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_DKV);
  const dim3 grid(Sk / T, Hkv, B);
  flash_dkv_kernel<<<grid, NT, SMEM_DKV, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout,
      (const float*)lse, (const float*)delta, (bf16*)dk, (bf16*)dv, H, Hkv,
      Sq, Sk, Strides{q_sb, q_ss, q_sh}, Strides{k_sb, k_ss, k_sh},
      Strides{v_sb, v_ss, v_sh}, Strides{do_sb, do_ss, do_sh}, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
