// Flash attention for Hopper (sm_90a), SIMT kernel: the forward of bf16
// or fp16 inputs at head_dim 384 and 512, the one case of the TPU
// kernels' domain that the tensor-core kernels do not take yet. (Every
// other forward, and every dQ and dK/dV, is a tensor-core kernel's: the
// wgmma kernels of flash_attention.cu for bf16 and fp16, the 3xTF32 ones
// of flash_attention_f32tc.cu for f32.)
//
// Replaces, for that case, the Pallas TPU kernel
//   flash_fwd_simt_kernel <- _fwd_kernel (:95; _fwd, pallas_call :143)
// of tf_operator_tpu/ops/flash_attention.py.
//
// It computes the TPU kernel's function with its cast points, as the
// wgmma kernels do: scores, softmax statistics and every product in f32,
// P rounded to the input type E before P.V, masked scores the finite
// -1e30, a softmax sum of 0 guarded as 1, lse [B, H, S] f32. Tensors are
// read as [B, S, H, D] through their element strides; head h reads KV
// head h / (H / Hkv). Sequences are any length >= 8 (the gate asks for
// multiples of 8): rows past the end load as zeros, keys past Sk score
// -1e30, and rows past the end are never stored. Its products are exact
// in f32 (bf16 and fp16 operands), so the results are those of a
// tensor-core product with f32 sums.
//
// What bounds it on the card: f32 FMA, 67 TFLOP/s on an H100 SXM without
// tensor cores, where the wgmma kernels' bound is 989. Each (64 x 64) tile
// product reads its two operand chunks once from device memory (mostly L2)
// for 64 x 64 x 64 FMAs, so arithmetic, not bytes, is the limit. Design,
// simple before fast (the move onto wgmma is queued):
//   * 256 threads as a 16 x 16 grid (ty, tx); each thread holds a 4 x 4
//     block of every tile product in registers and reads its operands
//     from shared memory as float4, with both operand tiles stored with
//     the reduced index outermost (rows padded to 68 floats, so the reads
//     are 16-byte aligned and broadcast).
//   * head_dim is walked in chunks of C = 64 columns through two
//     shared-memory tiles (35 KB, static), so one template serves
//     both D; O stays in registers (4 x D / 16 a thread).
//   * One CTA per (64 query rows, head, batch), heaviest causal q tiles
//     first; k tiles of 64 keys in order; causal k tiles past the CTA's
//     last real row are skipped. Each output row is summed in one CTA in
//     k-tile order: no atomics, so the results are deterministic.
//   * No cp.async pipeline, no tensor cores: each chunk is loaded, the
//     block synchronises, and multiplies.
//
// The extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a (dtype, head_dim)
// it was not built for; the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // query rows of a CTA
constexpr int BK = 64;    // keys of a k tile
constexpr int C = 64;     // head_dim columns a chunk
constexpr int NT = 256;   // threads: a 16 x 16 grid
constexpr float NEG_INF = -1e30f;

// Element types of the C entries' `dtype` argument (the Python wrapper's
// codes).
enum { DT_BF16 = 0, DT_FP16 = 1 };

__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }

template <typename E>
__device__ __forceinline__ E from_f(float x);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to E and back (the cast point of P).
template <typename E>
__device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<E>(x));
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// Reductions over the 16 lanes (tx) that share a row of a tile product.
__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o *= 2) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows s0 .. s0 + ROWS - 1 (zeros at or past S) and C columns of a tensor
// whose element (s, c) is src[s * ss + c], as f32 into shared memory:
// transposed, dst[c * (ROWS + 4) + r], or not, dst[r * (C + 4) + c].
template <typename E, int ROWS, bool TRANS>
__device__ __forceinline__ void load_tile(float* dst, const E* src, int ss,
                                          int s0, int S) {
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * C; e += NT) {
    const int r = e / C, c = e % C, s = s0 + r;
    const float x = s < S ? to_f(src[static_cast<int64_t>(s) * ss + c]) : 0.0f;
    if (TRANS)
      dst[c * (ROWS + 4) + r] = x;
    else
      dst[r * (C + 4) + c] = x;
  }
}

// acc[i][j] += sum over kk < 64 of A[kk * LDA + ty * 4 + i] *
// B[kk * LDB + tx * 4 + j]: this thread's 4 x 4 block of a tile product
// whose operands are stored with the reduced index outermost.
template <int LDA, int LDB>
__device__ __forceinline__ void mm_acc(float (&acc)[4][4], const float* A,
                                       const float* B) {
  const float* a = A + (threadIdx.x / 16) * 4;
  const float* b = B + (threadIdx.x % 16) * 4;
#pragma unroll 16
  for (int kk = 0; kk < 64; ++kk) {
    const float4 av = *reinterpret_cast<const float4*>(a + kk * LDA);
    const float4 bv = *reinterpret_cast<const float4*>(b + kk * LDB);
    const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(ar[i], bv.x, acc[i][0]);
      acc[i][1] = fmaf(ar[i], bv.y, acc[i][1]);
      acc[i][2] = fmaf(ar[i], bv.z, acc[i][2]);
      acc[i][3] = fmaf(ar[i], bv.w, acc[i][3]);
    }
  }
}

constexpr int LQ = BQ + 4;    // row stride of a tile transposed from 64 rows
constexpr int LC = C + 4;     // row stride of a chunk kept as rows

// The (query tile, head, batch) of a CTA, heaviest causal q tiles first.
struct QTile {
  int q0, h, b;
};

__device__ __forceinline__ QTile q_tile(int Sq, int H) {
  const int nqt = cdiv(Sq, BQ);
  const int hb = gridDim.x / nqt;  // H * B
  const int blk = static_cast<int>(blockIdx.x);
  return {(nqt - 1 - blk / hb) * BQ, blk % hb % H, blk % hb / H};
}

// k tiles a CTA of q rows q0 .. needs: causal tiles past its last real row
// are skipped.
__device__ __forceinline__ int k_tiles(int q0, int Sq, int Sk, int causal,
                                       int q_offset) {
  const int nkt = cdiv(Sk, BK);
  if (!causal) return nkt;
  const int last = min(q0 + BQ, Sq) - 1 + q_offset;
  return min(nkt, last / BK + 1);
}

// ---------------------------------------------------------------------------
// Forward. Replaces _fwd_kernel for bf16 and fp16 at D = 384 and 512.
// Per k tile: S = Q K^T over D / C chunks (Q^T and K^T chunks in sA, sB),
// scale, mask, online softmax on the thread's 4 x 4 block (row max and sum
// over 16 lanes), P rounded to E into sA as P^T, then O += P V over the
// chunks of V (in sB). O, m and the thread's partial l stay in registers.
// ---------------------------------------------------------------------------
template <typename E, int D>
__global__ void __launch_bounds__(NT) flash_fwd_simt_kernel(
    const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
    E* __restrict__ out, float* __restrict__ lse, int H, int Hkv, int Sq,
    int Sk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int causal, int q_offset, float scale) {
  constexpr int NC = D / C;
  __shared__ __align__(16) float sA[C * LQ];
  __shared__ __align__(16) float sB[C * LC];
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const QTile w = q_tile(Sq, H);
  const int q0 = w.q0, h = w.h, b = w.b, hk = h / (H / Hkv);
  const E* qp = q + static_cast<int64_t>(b) * q_sb + static_cast<int64_t>(h) * q_sh;
  const E* kp = k + static_cast<int64_t>(b) * k_sb + static_cast<int64_t>(hk) * k_sh;
  const E* vp = v + static_cast<int64_t>(b) * v_sb + static_cast<int64_t>(hk) * v_sh;
  const int nk = k_tiles(q0, Sq, Sk, causal, q_offset);

  float o[NC][4][4] = {};
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = NEG_INF, l[i] = 0.0f;

  for (int j = 0; j < nk; ++j) {
    float s[4][4] = {};
    for (int c = 0; c < NC; ++c) {
      __syncthreads();
      load_tile<E, BQ, true>(sA, qp + c * C, q_ss, q0, Sq);
      load_tile<E, BK, true>(sB, kp + c * C, k_ss, j * BK, Sk);
      __syncthreads();
      mm_acc<LQ, LQ>(s, sA, sB);
    }
    float mx[4], corr[4], psum[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      mx[i] = m[i];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int row = q0 + ty * 4 + i, key = j * BK + tx * 4 + jj;
        float x = s[i][jj] * scale;
        if (key >= Sk || (causal && row + q_offset < key)) x = NEG_INF;
        s[i][jj] = x;
        mx[i] = fmaxf(mx[i], x);
      }
      mx[i] = max16(mx[i]);
      corr[i] = expf(m[i] - mx[i]);
      m[i] = mx[i];
      psum[i] = 0.0f;
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const float p = expf(s[i][jj] - mx[i]);
        psum[i] += p;
        s[i][jj] = round_to<E>(p);
      }
      l[i] = l[i] * corr[i] + psum[i];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) o[c][i][jj] *= corr[i];
    }
    __syncthreads();  // every thread is done reading sA's last chunk
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        sA[(tx * 4 + jj) * LQ + ty * 4 + i] = s[i][jj];  // P^T [key][row]
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      if (c > 0) __syncthreads();
      load_tile<E, BK, false>(sB, vp + c * C, v_ss, j * BK, Sk);
      __syncthreads();
      mm_acc<LQ, LC>(o[c], sA, sB);
    }
  }

  // Finalize: O / l (l == 0 guarded as 1), lse; rows past Sq not stored.
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    const float sum = sum16(l[i]);
    const float safe = sum == 0.0f ? 1.0f : sum;
    const float inv = 1.0f / safe;
    if (row >= Sq) continue;
    if (tx == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + row] = m[i] + logf(safe);
    E* dst = out + (static_cast<int64_t>(b) * Sq + row) * H * D +
             static_cast<int64_t>(h) * D + tx * 4;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
        dst[c * C + jj] = from_f<E>(o[c][i][jj] * inv);
  }
}

// The launcher, one instantiation a (E, D) of the case.
template <typename E, int D>
int launch_fwd(const void* q, const void* k, const void* v, void* out,
               void* lse, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
               int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
               int v_ss, int v_sh, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  flash_fwd_simt_kernel<E, D><<<cdiv(Sq, BQ) * H * B, NT, 0, stream>>>(
      (const E*)q, (const E*)k, (const E*)v, (E*)out, (float*)lse, H, Hkv,
      Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal,
      q_offset, scale);
  return (int)cudaGetLastError();
}

// The instantiation for (dtype, head_dim).
#define SIMT_CASES(L, ARGS)                                        \
  switch (dtype * 1024 + head_dim) {                               \
    case DT_BF16 * 1024 + 384: return L<__nv_bfloat16, 384> ARGS;  \
    case DT_BF16 * 1024 + 512: return L<__nv_bfloat16, 512> ARGS;  \
    case DT_FP16 * 1024 + 384: return L<__half, 384> ARGS;         \
    case DT_FP16 * 1024 + 512: return L<__half, 512> ARGS;         \
  }                                                                \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

int flash_fwd_simt(const void* q, const void* k, const void* v, void* out,
                   void* lse, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
                   int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                   int v_ss, int v_sh, int causal, int q_offset, float scale,
                   int dtype, int head_dim, void* stream) {
  SIMT_CASES(launch_fwd,
             (q, k, v, out, lse, B, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh, k_sb,
              k_ss, k_sh, v_sb, v_ss, v_sh, causal, q_offset, scale,
              (cudaStream_t)stream))
}

}  // extern "C"
