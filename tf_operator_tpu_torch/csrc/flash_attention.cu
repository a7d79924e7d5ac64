// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Replaces the three Pallas TPU kernels of
// tf_operator_tpu/ops/flash_attention.py:
//   flash_fwd_kernel  <- _fwd_kernel  (launched by _fwd,      pallas_call :143)
//   flash_dq_kernel   <- _dq_kernel   (launched by _bwd_impl, pallas_call :261)
//   flash_dkv_kernel  <- _dkv_kernel  (launched by _bwd_impl, pallas_call :289)
//
// What each computes is the TPU kernel's function, with its cast points:
// scores and softmax statistics in f32, P cast to the input type before
// P.V and P^T.dO, dS cast to it before dS.K and dS^T.Q, every product
// accumulated in f32. Masked scores are the finite -1e30 of the TPU
// kernel, never -inf, so a fully masked row gives exp(0), not NaN; a
// softmax sum of 0 is guarded as 1. lse and delta are [B, H, S] f32.
// Tensors are read as [B, S, H, D] through their strides (no
// transpose); head h reads KV head h / (H / Hkv) (native GQA). The kernels
// are templates over the element type E, bf16 or fp16 (wgmma's bf16 and
// f16 variants), and head_dim D: 128, 256, 384 or 512 for all three. The
// other case of the domain, f32, goes to the 3xTF32 tensor-core kernels of
// flash_attention_f32tc.cu.
//
// Ragged sequences. Sq and Sk are any multiples of 8 (>= 8), tiled in 64
// rows with a partial last tile. The tensor maps carry the real lengths,
// so TMA loads the rows past the end as zeros. Zero keys would still
// score 0, so keys >= Sk are set to -1e30 in every kernel (last k tile
// only); rows >= Sq of O, lse and dQ and rows >= Sk of dK/dV are never
// stored; lse and delta are read only for rows < Sq (the dK/dV kernel's
// bulk copies stop at Sq, and query columns >= Sq get P = dS = 0, so the
// stale row statistics of a stage never reach a sum).
//
// What bounds them on the card: every (64 x 64) tile pair does 2-4
// tensor-core products of 64x64xD for 2-4 tile loads of D / 8 KB, so with
// the resident tiles reused across the whole loop the work is bounded by
// tensor-core operations, not by device memory.
//
// All three share one Hopper design (hopper.cuh):
//   * Warp-specialised CTAs of 384 threads: two consumer warpgroups that
//     run wgmma (setmaxnreg 240 registers) and one producer warpgroup
//     (setmaxnreg 24) whose first thread streams tiles in with TMA
//     (cp.async.bulk.tensor, 128-byte swizzle) into a ring of shared-memory
//     stages, each with a "full" mbarrier (TMA transaction bytes) and an
//     "empty" one (one arrival per consumer warp). Loads overlap the math;
//     the CTA never calls __syncthreads after the barriers are set up.
//   * Accumulators live in registers in wgmma's documented layout (each
//     row on the 4 lanes of a quad), so the softmax statistics need only
//     quad shuffles, P and dS become wgmma's register A operand (the D >=
//     256 dK/dV also hands P^T between its warpgroups through shared
//     memory), and every accumulator is written once. A 64 x D output is
//     D / 128 accumulators of 64 x 128 (64 registers a thread each), one
//     wgmma m64n128k16 each; at D = 384-512 the column slice of O, dQ or
//     dK/dV that a warpgroup owns is DC / 64 accumulators of 64 x 64, one
//     m64n64k16 each.
//   * The tensor maps are built on the host in each C entry
//     (cuTensorMapEncodeTiled looked up in libcuda, no -lcuda) and passed
//     as __grid_constant__ parameters.
//   * No atomics: every output element is summed inside one CTA in a fixed
//     order (at D = 384-512, where the GQA items of a key tile may be split
//     over CTAs, their partial sums are added by a second kernel in split
//     order), so the results are deterministic.
//
// Each extern "C" entry launches on the caller's stream and returns
// cudaGetLastError(), cudaErrorInvalidValue for a (dtype, head_dim) it was
// not built for, or the negated CUresult when a tensor map cannot be
// built; the Python wrapper raises on any non-zero value.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int T = 64;         // tile rows (q and k)
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

constexpr int NT_WS = 384;            // 2 consumer warpgroups + 1 producer
constexpr int CONSUMER_WARPS = 8;
template <int D>
constexpr int TILE = hopper::TILE_BYTES<D>;

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

// Two neighbouring accumulator values stored as a pair of O: E (rounded)
// or f32.
template <typename O>
__device__ __forceinline__ void store2(O* p, float a, float b) {
  if constexpr (std::is_same<O, float>::value)
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else
    *reinterpret_cast<uint32_t*>(p) = hopper::pack2<O>(a, b);
}

// Write the first `rows` rows of a 64 x (N / 2) f32 accumulator (N = 64:
// 128 columns, N = 32: 64) as rows of O (the columns from dst on, rows
// `row_stride` elements apart; rows past the sequence's end are not
// stored).
template <typename O, int N>
__device__ __forceinline__ void store_acc(O* dst, const float (&acc)[N],
                                          int row_stride, int rows, int warp,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < N; i += 2) {
    const int r = acc_row(i, warp, lane);
    if (r < rows)
      store2<O>(dst + static_cast<int64_t>(r) * row_stride + acc_col(i, lane),
                acc[i], acc[i + 1]);
  }
}

// Tiles of T rows over a sequence of `len` (the last may be partial).
__host__ __device__ __forceinline__ int n_tiles(int len) {
  return (len + T - 1) / T;
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

// One k tile of the forward's online softmax on the accumulator layout:
// the scores sc of k tile j against the q tile whose first row is q0 are
// scaled and masked (the causal mask on diagonal tiles, keys >= Sk on a
// partial last tile: a uniform branch, so whole interior tiles skip it)
// and become P = exp(S - m), the rows' running max m and sum l moving on;
// corr is the factor each row's O must be scaled by before P V is added.
__device__ __forceinline__ void online_softmax(float (&sc)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2], int q0,
                                               int j, int Sk, int causal,
                                               int q_offset, float scale,
                                               int warp, int lane) {
  const bool diag = causal && j * T + T - 1 > q0 + q_offset;
  const int keys = Sk - j * T;                  // < T on a partial tile
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int e = 0; e < 32; ++e) sc[e] *= scale;
  if (diag || keys < T) {
#pragma unroll
    for (int e = 0; e < 32; ++e)
      if ((diag && q0 + acc_row(e, warp, lane) + q_offset <
                       j * T + acc_col(e, lane)) ||
          acc_col(e, lane) >= keys)
        sc[e] = NEG_INF;
  }
#pragma unroll
  for (int e = 0; e < 32; ++e)
    mx[(e % 4) / 2] = fmaxf(mx[(e % 4) / 2], sc[e]);
  float psum[2] = {0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = quad_max(mx[r]);
    corr[r] = exp2f((m[r] - mx[r]) * LOG2E);
    m[r] = mx[r];
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) {
    const float p = exp2f((sc[e] - mx[(e % 4) / 2]) * LOG2E);
    sc[e] = p;
    psum[(e % 4) / 2] += p;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
}

// The forward's end of a q tile (first row q0): each row's 1 / l in inv
// (a sum of 0 guarded as 1, as the TPU kernel does) and, where `write`,
// its lse into lse_rows[row] for rows < Sq.
__device__ __forceinline__ void finish_rows(float (&inv)[2],
                                            const float (&m)[2],
                                            const float (&l)[2],
                                            float* lse_rows, int q0, int Sq,
                                            bool write, int warp, int lane) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float sum = quad_sum(l[r]);
    const float safe = sum == 0.0f ? 1.0f : sum;
    inv[r] = 1.0f / safe;
    const int row = q0 + 16 * warp + lane / 4 + 8 * r;
    if (write && lane % 4 == 0 && row < Sq) lse_rows[row] = m[r] + logf(safe);
  }
}

// The work of one forward or dQ CTA: q tiles 2c and 2c + 1 (`tiles` of
// them, 1 for the last CTA of an odd count) of head h, batch b. Blocks are
// numbered heaviest q tiles first, so the short causal tiles fill the last
// wave instead of the long ones.
struct QPair {
  int c, h, b, tiles;
};

__device__ __forceinline__ QPair q_pair(int nqt, int H) {
  const int ncta = (nqt + 1) / 2;
  const int hb = gridDim.x / ncta;                        // H * B
  const int blk = static_cast<int>(blockIdx.x);
  QPair w;
  w.c = ncta - 1 - blk / hb;
  w.h = blk % hb % H;
  w.b = blk % hb / H;
  w.tiles = min(2, nqt - 2 * w.c);
  return w;
}

// Producer side of a K/V ring: K and V tiles 0 .. nk - 1 of kv head hk
// into `stages` stages of 2 tiles, stage s reused once every consumer warp
// has released it.
template <int D>
__device__ __forceinline__ void stream_kv(unsigned char* sKV, uint64_t* full,
                                          uint64_t* empty, int stages,
                                          const CUtensorMap* kmap,
                                          const CUtensorMap* vmap, int nk,
                                          int hk, int b) {
  using namespace hopper;
  for (int j = 0; j < nk; ++j) {
    const int s = j % stages, use = j / stages;
    if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
    unsigned char* st = sKV + s * 2 * TILE<D>;
    mbar_expect_tx(&full[s], 2 * TILE<D>);
    tma_load_tile<D>(st, kmap, &full[s], hk, j * T, b);
    tma_load_tile<D>(st + TILE<D>, vmap, &full[s], hk, j * T, b);
  }
}

// ---------------------------------------------------------------------------
// Forward. Replaces _fwd_kernel (tf_operator_tpu/ops/flash_attention.py
// :95). Bound by tensor-core operations: 4 D FLOPs per visible (q, k) pair
// against the K and V tile loads, which the producer streams through a
// ring while the consumers compute. The head_dims split the work in two
// ways: fwd_by_tiles (D = 128, 256; below) and fwd_by_slice (D = 384, 512;
// after the dQ, whose column halves it mirrors).
// D = 128 and 256: one CTA per (128 query rows, head, batch).
//   * Consumer warpgroup g owns q tile 2c + g (64 rows; with an odd count
//     of q tiles the last CTA's second warpgroup has no rows, computes
//     nothing and still releases every stage). Its Q tile stays resident.
//   * Per k tile: S = Q K^T (D / 16 wgmma m64n64k16, both K-major from
//     shared memory), scale and the causal mask (diagonal tiles only) in
//     registers, online softmax on the accumulator layout (quad shuffles),
//     P rounded to E in registers and O += P V (4 k-steps of D / 128
//     wgmma m64n128k16, A from registers, V N-major, one wgmma per 128
//     columns). O, m and l never leave registers; O is rescaled there and
//     written once.
//   * Causal k tiles past a q tile's diagonal are never loaded (the
//     producer stops at the CTA's last visible tile). With a partial last
//     q tile, a tile that only its rows past Sq would see may be loaded;
//     the per-element mask gives it no weight in any real row, whose
//     running max is finite from k tile 0 on (key 0 is visible to every
//     row at q_offset >= 0).
//   * Budgets. Shared memory: 2 resident Q tiles and FWD_STAGES stages of
//     K and V, 4 + 4 FWD_STAGES tiles of D / 8 KB (D = 128: 96 KB; D = 256:
//     192 KB, of the 227 KB a block may use). Registers of a consumer
//     thread: O is D / 2 (128 at D = 256), S 32, the P fragments 16, under
//     the 240 that setmaxnreg gives it.
// ---------------------------------------------------------------------------
constexpr int FWD_STAGES = 2;
template <int D>
constexpr int SMEM_FWD_TILES = 1024 + 2 * TILE<D> +
                               FWD_STAGES * 2 * TILE<D> +
                               8 * (1 + 2 * FWD_STAGES);

template <typename E, int D>
__device__ __forceinline__ void fwd_by_tiles(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, E* out, float* lse, int H, int Hkv, int Sq,
    int Sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  constexpr int NO = D / 128;                              // O accumulators
  unsigned char* sQ = align_1024(smem);                   // 2 tiles
  unsigned char* sKV = sQ + 2 * TILE<D>;                  // stage s: K, V
  uint64_t* q_full =
      reinterpret_cast<uint64_t*>(sKV + FWD_STAGES * 2 * TILE<D>);
  uint64_t* kv_full = q_full + 1;
  uint64_t* kv_empty = kv_full + FWD_STAGES;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk);
  const QPair w = q_pair(nqt, H);
  const int c = w.c, h = w.h, b = w.b, tiles_here = w.tiles;
  const int hk = h / (H / Hkv);
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
      mbar_expect_tx(q_full, tiles_here * TILE<D>);
      for (int g = 0; g < tiles_here; ++g)
        tma_load_tile<D>(sQ + g * TILE<D>, qmap, q_full, h, (2 * c + g) * T,
                         b);
      stream_kv<D>(sKV, kv_full, kv_empty, FWD_STAGES, kmap, vmap, nk, hk, b);
    }
  } else {
    reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int iq = 2 * c + wg;                            // this q tile
    const int my_nk =
        wg < tiles_here ? k_tiles_visible(iq, nkt, causal, q_offset) : 0;
    const unsigned char* myQ = sQ + wg * TILE<D>;

    float o[NO][64];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) o[n][i] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      const int s = j % FWD_STAGES;
      mbar_wait(&kv_full[s], (j / FWD_STAGES) & 1);
      if (j < my_nk) {
        const unsigned char* sK = sKV + s * 2 * TILE<D>;
        const unsigned char* sV = sK + TILE<D>;
        float sc[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss<E>(sc, desc_kmajor(myQ, kk), desc_kmajor(sK, kk),
                                kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);

        float corr[2];
        online_softmax(sc, m, l, corr, iq * T, j, Sk, causal, q_offset,
                       scale, warp, lane);
#pragma unroll
        for (int n = 0; n < NO; ++n)
#pragma unroll
          for (int i = 0; i < 64; ++i) o[n][i] *= corr[(i % 4) / 2];

        // O += P V, P as register fragments of E, 128 columns a wgmma.
        uint32_t pa[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_a<E>(pa[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int n = 0; n < NO; ++n)
            wgmma_m64n128k16_rs<E>(
                o[n], pa[kk], desc_nmajor(sV + 2 * n * PANEL_BYTES, kk));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < NO; ++n) reg_fence(o[n]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&kv_empty[s]);
    }
    if (wg >= tiles_here) return;

    // Finalize: O / l, lse.
    float inv[2];
    finish_rows(inv, m, l, lse + (static_cast<int64_t>(b) * H + h) * Sq,
                iq * T, Sq, true, warp, lane);
    E* dst = out + (static_cast<int64_t>(b) * Sq + iq * T) * H * D +
             static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
#pragma unroll
      for (int i = 0; i < 64; ++i) o[n][i] *= inv[(i % 4) / 2];
      store_acc<E>(dst + 128 * n, o[n], H * D, Sq - iq * T, warp, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward, dQ. Replaces _dq_kernel (tf_operator_tpu/ops/flash_attention.py
// :183). Bound by tensor-core operations: 6 D FLOPs per visible (q, k)
// pair (S = Q K^T, dP = dO V^T, dQ += dS K) against the K and V tile
// loads, which the producer streams through a ring while the consumers
// compute (the forward's shape, one product more per tile pair). The
// head_dims split the work in two ways: dq_by_tiles (D = 128, 256; below)
// and dq_by_slice (D = 384, 512; after the dK/dV, whose column slices it
// mirrors).
// D = 128 and 256: one CTA per (128 query rows, head, batch).
//   * Consumer warpgroup g owns q tile 2c + g; with an odd count of q
//     tiles the last CTA's second warpgroup computes nothing and still
//     releases every tile. Its Q and dO tiles come once, on one barrier,
//     and stay resident; the lse and delta of its rows sit in registers
//     (the thread's 2 accumulator rows).
//   * K and V stream through a ring. D = 128: 2 stages of a (K_j, V_j)
//     pair on one barrier each, as the forward (single tiles there, with
//     S and dP issued apart, ran 14% slower). D = 256: 3 slots of one
//     tile, tile n (K_j at n = 2j, V_j at 2j + 1) in slot n % 3 with its
//     own barriers; S is issued as soon as K_j has landed, V_j is released
//     after dP and K_j after dQ, so K_j+1 loads during tile j.
//   * Per k tile: S = Q K^T and dP = dO V^T (D / 16 wgmma m64n64k16 each,
//     every operand K-major), scale and the causal mask (diagonal tiles
//     only, per element) in registers, P = exp(S - lse) and dS = P (dP -
//     delta) scale there, dS rounded to E register fragments, and dQ += dS
//     K (4 k-steps of D / 128 wgmma m64n128k16, A from registers, one wgmma
//     per 128 columns): the K tile that was the K-major B of S is read
//     N-major here.
//   * dQ (D / 2 f32 registers a thread) is written once, as E, straight
//     from registers. Each dQ row is summed by one warpgroup in k-tile
//     order: no atomics, deterministic.
//   * Causal k tiles past the CTA's last diagonal are never loaded.
//   * Budgets. Shared memory: 2 resident Q and 2 dO tiles and the ring, of
//     D / 8 KB a tile: D = 128, 4 tiles, 128 KB; D = 256, 3 tiles (K_j, V_j
//     and K_j+1 in flight), 224 KB of the 227 KB a block may use.
//     Registers of a consumer thread: dQ D / 2 (128 at D = 256), S and dP
//     32 each, the dS fragments 16, under the 240 that setmaxnreg gives it.
// ---------------------------------------------------------------------------
// Ring slots (D = 128: stages of a K, V pair; D = 256: single tiles) and
// the tiles they hold.
template <int D>
constexpr int DQ_RING = D == 128 ? 2 : 3;
template <int D>
constexpr int DQ_RING_TILES = D == 128 ? 4 : 3;
template <int D>
constexpr int SMEM_DQ_TILES = 1024 + 4 * TILE<D> +
                              DQ_RING_TILES<D> * TILE<D> +
                              8 * (1 + 2 * DQ_RING<D>);

template <typename E, int D>
__device__ __forceinline__ void dq_by_tiles(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* delta, E* dq, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  using namespace hopper;
  constexpr int NO = D / 128;                              // dQ accumulators
  constexpr int R = DQ_RING<D>;
  unsigned char* sQ = align_1024(smem);                   // 2 tiles
  unsigned char* sdO = sQ + 2 * TILE<D>;                  // 2 tiles
  unsigned char* sRing = sdO + 2 * TILE<D>;               // the ring
  uint64_t* qdo_full =
      reinterpret_cast<uint64_t*>(sRing + DQ_RING_TILES<D> * TILE<D>);
  uint64_t* full = qdo_full + 1;
  uint64_t* empty = full + R;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk);
  const QPair w = q_pair(nqt, H);
  const int c = w.c, h = w.h, b = w.b, tiles_here = w.tiles;
  const int hk = h / (H / Hkv);
  const int nk = k_tiles_visible(2 * c + tiles_here - 1, nkt, causal, q_offset);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: Q and dO once, then K and V through the ring.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qdo_full, 2 * tiles_here * TILE<D>);
      for (int g = 0; g < tiles_here; ++g) {
        tma_load_tile<D>(sQ + g * TILE<D>, qmap, qdo_full, h,
                         (2 * c + g) * T, b);
        tma_load_tile<D>(sdO + g * TILE<D>, domap, qdo_full, h,
                         (2 * c + g) * T, b);
      }
      if (D == 128) {
        stream_kv<D>(sRing, full, empty, R, kmap, vmap, nk, hk, b);
      } else {
        for (int n = 0; n < 2 * nk; ++n) {
          const int s = n % R, use = n / R;
          if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
          mbar_expect_tx(&full[s], TILE<D>);
          tma_load_tile<D>(sRing + s * TILE<D>, n % 2 ? vmap : kmap,
                           &full[s], hk, n / 2 * T, b);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int iq = 2 * c + wg;                            // this q tile
    const bool active = wg < tiles_here;
    const int my_nk = active ? k_tiles_visible(iq, nkt, causal, q_offset) : 0;
    const unsigned char* myQ = sQ + wg * TILE<D>;
    const unsigned char* mydO = sdO + wg * TILE<D>;

    // Rows past Sq keep lse = delta = 0: their Q and dO rows are zeros,
    // so their P and dS stay finite, and they are never stored.
    float row_lse[2] = {0.0f, 0.0f}, row_delta[2] = {0.0f, 0.0f};
    if (active) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pos = iq * T + 16 * warp + lane / 4 + 8 * r;
        const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + pos;
        if (pos < Sq) {
          row_lse[r] = lse[row];
          row_delta[r] = delta[row];
        }
      }
    }

    float acc[NO][64];
#pragma unroll
    for (int n = 0; n < NO; ++n)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[n][i] = 0.0f;

    mbar_wait(qdo_full, 0);
    for (int j = 0; j < nk; ++j) {
      // The slots and barrier phases of K_j and V_j (one pair stage at
      // D = 128).
      const int sk = D == 128 ? j % R : (2 * j) % R;
      const int sv = D == 128 ? sk : (2 * j + 1) % R;
      const uint32_t pk = (D == 128 ? j / R : (2 * j) / R) & 1;
      const uint32_t pv = (D == 128 ? j / R : (2 * j + 1) / R) & 1;
      const unsigned char* sK =
          sRing + (D == 128 ? 2 * sk : sk) * TILE<D>;
      const unsigned char* sV =
          D == 128 ? sK + TILE<D> : sRing + sv * TILE<D>;
      const bool mine = j < my_nk;
      float sc[32], dp[32];
      // At D = 256, S is issued while V_j may still be landing (its slot
      // was freed only by the previous tile's dQ); at D = 128 both tiles
      // come on one barrier, and S and dP go out as one group.
      mbar_wait(&full[sk], pk);
      if (D > 128 && mine) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss<E>(sc, desc_kmajor(myQ, kk), desc_kmajor(sK, kk),
                                kk > 0);
        wgmma_commit();
      }
      if (D > 128) mbar_wait(&full[sv], pv);
      if (mine) {
        wgmma_fence();
        if (D == 128) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_m64n64k16_ss<E>(sc, desc_kmajor(myQ, kk),
                                  desc_kmajor(sK, kk), kk > 0);
        }
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss<E>(dp, desc_kmajor(mydO, kk), desc_kmajor(sV, kk),
                                kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(sc);
        reg_fence(dp);
      }
      if (D > 128) {
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[sv]);  // V_j done
      }
      if (mine) {
        // Scale, mask (diagonal tiles and a partial last k tile only, a
        // uniform branch), P and dS; dS overwrites S.
        const bool diag = causal && j * T + T - 1 > iq * T + q_offset;
        const int keys = Sk - j * T;
#pragma unroll
        for (int i = 0; i < 32; ++i) sc[i] *= scale;
        if (diag || keys < T) {
#pragma unroll
          for (int i = 0; i < 32; ++i)
            if ((diag && iq * T + acc_row(i, warp, lane) + q_offset <
                             j * T + acc_col(i, lane)) ||
                acc_col(i, lane) >= keys)
              sc[i] = NEG_INF;
        }
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i % 4) / 2;
          const float p = exp2f((sc[i] - row_lse[r]) * LOG2E);
          sc[i] = p * (dp[i] - row_delta[r]) * scale;
        }

        // dQ += dS K, dS as register fragments of E, 128 columns a wgmma.
        uint32_t da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_a<E>(da[kk], sc, kk);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int n = 0; n < NO; ++n)
            wgmma_m64n128k16_rs<E>(
                acc[n], da[kk], desc_nmajor(sK + 2 * n * PANEL_BYTES, kk));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int n = 0; n < NO; ++n) reg_fence(acc[n]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[sk]);  // K_j (D = 128: and V_j) done
    }
    if (!active) return;
    E* dst = dq + (static_cast<int64_t>(b) * Sq + iq * T) * H * D +
             static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NO; ++n)
      store_acc<E>(dst + 128 * n, acc[n], H * D, Sq - iq * T, warp, lane);
  }
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
//     -- through a ring of stages.
//   * Every product is transposed, with the tile's 64 key rows as M, so
//     nothing is transposed through shared memory: S^T = K Q^T and
//     dP^T = V dO^T (wgmma, K and V resident, Q and dO K-major B),
//     P^T = exp(S^T - lse) and dS^T = P^T (dP^T - delta) scale in registers
//     with lse and delta per column from the stage, then dV += P^T dO and
//     dK += dS^T Q (A from registers, dO and Q N-major B).
//   * The GQA sum stays inside the CTA in a fixed order (deterministic, no
//     atomics). A k tile no query row sees gets zeros. A partial last q
//     tile: its lse and delta are copied up to Sq only, and its query
//     columns >= Sq get P = dS = 0.
// The head_dims split the work between the consumer warpgroups in three
// ways: dkv_by_items (D = 128), dkv_by_accumulator (D = 256) and
// dkv_by_slice (D = 384, 512; each CTA one half of head_dim's columns).
// ---------------------------------------------------------------------------

// D = 128: items alternate between the two consumer warpgroups (two of
// DKV_STAGES stages each); each keeps partial dK and dV (64 registers a
// thread each) and computes all four products of its items. At the end of
// a k tile the second warpgroup hands its partial sums to the first
// through shared memory (xbuf), which adds them in a fixed order and
// writes.
constexpr int DKV_STAGES = 4;
constexpr int DKV_STAGE = 2 * TILE<128> + 1024;  // Q, dO, lse[64], delta[64]
constexpr int SMEM_DKV_ITEMS = 1024 + 2 * TILE<128> +
                               DKV_STAGES * DKV_STAGE + T * 128 * 4 +
                               8 * (2 + 2 * DKV_STAGES);

template <typename E>
__device__ __forceinline__ void dkv_by_items(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* delta, E* dk, E* dv, int H, int Hkv, int Sq, int Sk,
    int causal, int q_offset, float scale) {
  using namespace hopper;
  constexpr int D = 128;
  unsigned char* sK = align_1024(smem);
  unsigned char* sV = sK + TILE<D>;
  unsigned char* sStage = sV + TILE<D>;
  float* xbuf = reinterpret_cast<float*>(sStage + DKV_STAGES * DKV_STAGE);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(xbuf + T * D);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* st_full = kv_empty + 1;
  uint64_t* st_empty = st_full + DKV_STAGES;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk), group = H / Hkv;
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
        mbar_expect_tx(kv_full, 2 * TILE<D>);
        tma_load_tile<D>(sK, kmap, kv_full, hk, j * T, b);
        tma_load_tile<D>(sV, vmap, kv_full, hk, j * T, b);
        const int i0 = first_q_tile(j, causal, q_offset);
        const int nqv = max(nqt - i0, 0);
        for (int t = 0; t < group * nqv; ++t) {
          const int w = t & 1, n = w ? cnt1++ : cnt0++;
          const int s = w + 2 * (n & 1), use = n >> 1;
          if (use > 0) mbar_wait(&st_empty[s], (use - 1) & 1);
          const int h = hk * group + t / nqv, i = i0 + t % nqv;
          unsigned char* st = sStage + s * DKV_STAGE;
          const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + i * T;
          // lse and delta up to Sq only: a multiple of 8 rows, so 32-byte
          // aligned copies of a multiple of 32 bytes.
          const uint32_t stat_bytes = min(T, Sq - i * T) * 4;
          mbar_expect_tx(&st_full[s], 2 * TILE<D> + 2 * stat_bytes);
          tma_load_tile<D>(st, qmap, &st_full[s], h, i * T, b);
          tma_load_tile<D>(st + TILE<D>, domap, &st_full[s], h, i * T, b);
          bulk_load(st + 2 * TILE<D>, lse + row, stat_bytes, &st_full[s]);
          bulk_load(st + 2 * TILE<D> + T * 4, delta + row, stat_bytes,
                    &st_full[s]);
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
        const unsigned char* sdO = sQ + TILE<D>;
        const float* sLse = reinterpret_cast<const float*>(sQ + 2 * TILE<D>);
        const float* sDelta = sLse + T;
        const int i = i0 + t % nqv;

        float st[32], dpt[32];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss<E>(st, desc_kmajor(sK, kk), desc_kmajor(sQ, kk),
                                kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_m64n64k16_ss<E>(dpt, desc_kmajor(sV, kk), desc_kmajor(sdO, kk),
                                kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        reg_fence(st);
        reg_fence(dpt);

        // Rows are keys, columns queries of this item. Query columns
        // past Sq (a partial last q tile) read stale lse and delta: they
        // get P = dS = 0, set after the fact on that tile only (a uniform
        // branch). Key rows past Sk are never stored.
        const bool diag = causal && j * T + T - 1 > i * T + q_offset;
        const int queries = Sq - i * T;
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
        if (queries < T) {
#pragma unroll
          for (int e = 0; e < 32; ++e)
            if (acc_col(e, lane) >= queries) st[e] = dpt[e] = 0.0f;
        }

        uint32_t pa[4][4], da[4][4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          frag_a<E>(pa[kk], st, kk);
          frag_a<E>(da[kk], dpt, kk);
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs<E>(acc_dv, pa[kk], desc_nmajor(sdO, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n128k16_rs<E>(acc_dk, da[kk], desc_nmajor(sQ, kk));
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
        store_acc<E>(dv + base, acc_dv, Hkv * D, Sk - j * T, warp, lane);
      }
      named_sync(1, 256);
      if (wg == 1)
#pragma unroll
        for (int i = 0; i < 64; ++i) xbuf[i * 128 + tid] = acc_dk[i];
      named_sync(1, 256);
      if (wg == 0) {
#pragma unroll
        for (int i = 0; i < 64; ++i) acc_dk[i] += xbuf[i * 128 + tid];
        store_acc<E>(dk + base, acc_dk, Hkv * D, Sk - j * T, warp, lane);
      }
      named_sync(1, 256);
    }
  }
}

// D = 256: split by accumulator. dK and dV of 64 x 256 are 128 f32
// registers a thread each, so one warpgroup cannot hold both (the D = 128
// split would need 256 of the 240 setmaxnreg gives). Instead every item
// goes to both consumer warpgroups, and each owns one output:
//   * warpgroup 0 (dV): S^T = K Q^T (16 k-steps), P^T = exp(S^T - lse) in
//     f32, handed to warpgroup 1 through shared memory, then dV += P^T dO
//     (4 k-steps of 2 wgmma m64n128k16);
//   * warpgroup 1 (dK): dP^T = V dO^T (16 k-steps) while warpgroup 0
//     computes S^T, then, with warpgroup 0's P^T, dS^T = P^T (dP^T -
//     delta) scale and dK += dS^T Q.
// Each warpgroup does half the tensor work of an item (the 8 D FLOPs a
// pair, no product twice) and writes its own output from registers at the
// end of a k tile: no partial sums to exchange. The other design, each
// warpgroup owning dK and dV over 128 of the 256 columns, needs the
// partial S^T and dP^T summed across warpgroups through 32 KB of shared
// memory an item, which with two stages is over the 227 KB a block may
// use; recomputing S^T in warpgroup 1 instead of the exchange costs 25%
// more tensor work.
//   * The P^T exchange: two buffers of 64 x 64 f32 (16 KB each), item n in
//     buffer n % 2, stored in accumulator-register order (register e of
//     thread t at e * 128 + t, so both warpgroups, which share the
//     accumulator layout, read and write 128 consecutive floats a
//     register: no bank conflicts). Named barriers: P_FULL + n % 2
//     (warpgroup 0 arrives once the buffer holds P^T, warpgroup 1 waits)
//     and P_EMPTY + n % 2 (warpgroup 1 arrives once it has read it,
//     warpgroup 0 waits before it writes item n + 2). Arrivals are made
//     only where a wait follows, so no barrier is left half-arrived at
//     exit.
//   * Budgets. Shared memory: K and V resident (64 KB), DKV_ACC_STAGES
//     stages of Q and dO (64 KB each), their lse and delta (512 bytes
//     each), the exchange (32 KB), the barriers and 1 KB of alignment:
//     226 KB of the 227 KB a block may use. Registers of a consumer
//     thread: its output 128, S^T or dP^T 32, the A fragments 16, under
//     240.
constexpr int DKV_ACC_STAGES = 2;
constexpr int P_FULL = 2, P_EMPTY = 4;    // named barrier ids, 2 each
constexpr int SMEM_DKV_ACC = 1024 + 2 * TILE<256> +
                             DKV_ACC_STAGES * (2 * TILE<256> + 2 * T * 4) +
                             2 * T * T * 4 + 8 * (2 + 2 * DKV_ACC_STAGES);

template <typename E, int D>
__device__ __forceinline__ void dkv_by_accumulator(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* delta, E* dk, E* dv, int H, int Hkv, int Sq, int Sk,
    int causal, int q_offset, float scale) {
  using namespace hopper;
  constexpr int NO = D / 128;                              // accumulators
  unsigned char* sK = align_1024(smem);
  unsigned char* sV = sK + TILE<D>;
  unsigned char* sStage = sV + TILE<D>;                    // stage s: Q, dO
  float* sStat = reinterpret_cast<float*>(sStage +
                                          DKV_ACC_STAGES * 2 * TILE<D>);
  float* sP = sStat + DKV_ACC_STAGES * 2 * T;              // 2 P^T buffers
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sP + 2 * T * T);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* st_full = kv_empty + 1;
  uint64_t* st_empty = st_full + DKV_ACC_STAGES;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk), group = H / Hkv;
  const int hb = gridDim.x / ((nkt + 1) / 2);            // Hkv * B
  const int pair = static_cast<int>(blockIdx.x) / hb;
  const int hk = static_cast<int>(blockIdx.x) % hb % Hkv;
  const int b = static_cast<int>(blockIdx.x) % hb / Hkv;
  const int n_jt = nkt - 1 - pair != pair ? 2 : 1;  // k tiles pair, nkt-1-pair
  // Items of the whole CTA (both k tiles), which both consumers take.
  int total = 0;
  for (int u = 0; u < n_jt; ++u) {
    const int j = u == 0 ? pair : nkt - 1 - pair;
    total += group * max(nqt - first_q_tile(j, causal, q_offset), 0);
  }

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, CONSUMER_WARPS);
    for (int s = 0; s < DKV_ACC_STAGES; ++s) {
      mbar_init(&st_full[s], 1);
      mbar_init(&st_empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: per k tile, K and V, then every item in order, item n in
    // stage n % DKV_ACC_STAGES.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      int n = 0;
      for (int u = 0; u < n_jt; ++u) {
        const int j = u == 0 ? pair : nkt - 1 - pair;
        if (u > 0) mbar_wait(kv_empty, (u - 1) & 1);
        mbar_expect_tx(kv_full, 2 * TILE<D>);
        tma_load_tile<D>(sK, kmap, kv_full, hk, j * T, b);
        tma_load_tile<D>(sV, vmap, kv_full, hk, j * T, b);
        const int i0 = first_q_tile(j, causal, q_offset);
        const int nqv = max(nqt - i0, 0);
        for (int t = 0; t < group * nqv; ++t, ++n) {
          const int s = n % DKV_ACC_STAGES, use = n / DKV_ACC_STAGES;
          if (use > 0) mbar_wait(&st_empty[s], (use - 1) & 1);
          const int h = hk * group + t / nqv, i = i0 + t % nqv;
          unsigned char* st = sStage + s * 2 * TILE<D>;
          float* stat = sStat + s * 2 * T;
          const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + i * T;
          // lse and delta up to Sq only (32-byte multiples, as above).
          const uint32_t stat_bytes = min(T, Sq - i * T) * 4;
          mbar_expect_tx(&st_full[s], 2 * TILE<D> + 2 * stat_bytes);
          tma_load_tile<D>(st, qmap, &st_full[s], h, i * T, b);
          tma_load_tile<D>(st + TILE<D>, domap, &st_full[s], h, i * T, b);
          bulk_load(stat, lse + row, stat_bytes, &st_full[s]);
          bulk_load(stat + T, delta + row, stat_bytes, &st_full[s]);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    int n = 0;
    for (int u = 0; u < n_jt; ++u) {
      const int j = u == 0 ? pair : nkt - 1 - pair;
      const int i0 = first_q_tile(j, causal, q_offset);
      const int nqv = max(nqt - i0, 0);
      float acc[NO][64];
#pragma unroll
      for (int c = 0; c < NO; ++c)
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[c][i] = 0.0f;

      mbar_wait(kv_full, u & 1);
      for (int t = 0; t < group * nqv; ++t, ++n) {
        const int s = n % DKV_ACC_STAGES;
        mbar_wait(&st_full[s], (n / DKV_ACC_STAGES) & 1);
        const unsigned char* sQ = sStage + s * 2 * TILE<D>;
        const unsigned char* sdO = sQ + TILE<D>;
        const float* sLse = sStat + s * 2 * T;
        const float* sDelta = sLse + T;
        float* pbuf = sP + (n & 1) * T * T;
        const int i = i0 + t % nqv;
        const int queries = Sq - i * T;    // < T on a partial last q tile
        float x[32];
        uint32_t a[4][4];
        if (wg == 0) {
          // S^T = K Q^T; P^T = exp(S^T scale - lse), masked to 0 (the
          // causal mask on diagonal tiles, query columns past Sq).
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_m64n64k16_ss<E>(x, desc_kmajor(sK, kk), desc_kmajor(sQ, kk),
                                  kk > 0);
          wgmma_commit();
          wgmma_wait_all();
          reg_fence(x);
          const bool diag = causal && j * T + T - 1 > i * T + q_offset;
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = acc_col(e, lane);
            float v = x[e] * scale;
            if (diag &&
                i * T + col + q_offset < j * T + acc_row(e, warp, lane))
              v = NEG_INF;
            x[e] = exp2f((v - sLse[col]) * LOG2E);
          }
          if (queries < T) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (acc_col(e, lane) >= queries) x[e] = 0.0f;
          }
          if (n >= 2) named_sync(P_EMPTY + (n & 1), 256);
#pragma unroll
          for (int e = 0; e < 32; ++e) pbuf[e * 128 + tid] = x[e];
          named_arrive(P_FULL + (n & 1), 256);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) frag_a<E>(a[kk], x, kk);
        } else {
          // dP^T = V dO^T, then dS^T = P^T (dP^T - delta) scale with
          // warpgroup 0's P^T; query columns past Sq read stale delta and
          // get dS = 0.
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_m64n64k16_ss<E>(x, desc_kmajor(sV, kk),
                                  desc_kmajor(sdO, kk), kk > 0);
          wgmma_commit();
          named_sync(P_FULL + (n & 1), 256);
          wgmma_wait_all();
          reg_fence(x);
#pragma unroll
          for (int e = 0; e < 32; ++e)
            x[e] = pbuf[e * 128 + tid] * (x[e] - sDelta[acc_col(e, lane)]) *
                   scale;
          if (n + 2 < total) named_arrive(P_EMPTY + (n & 1), 256);
          if (queries < T) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (acc_col(e, lane) >= queries) x[e] = 0.0f;
          }
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) frag_a<E>(a[kk], x, kk);
        }
        // dV += P^T dO (warpgroup 0) or dK += dS^T Q (warpgroup 1), 128
        // columns a wgmma.
        const unsigned char* sB = wg == 0 ? sdO : sQ;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int c = 0; c < NO; ++c)
            wgmma_m64n128k16_rs<E>(acc[c], a[kk],
                                   desc_nmajor(sB + 2 * c * PANEL_BYTES, kk));
        wgmma_commit();
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NO; ++c) reg_fence(acc[c]);
        __syncwarp();
        if (lane == 0) mbar_arrive(&st_empty[s]);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);  // K, V free for the next tile

      E* dst = (wg == 0 ? dv : dk) +
               (static_cast<int64_t>(b) * Sk + j * T) * Hkv * D +
               static_cast<int64_t>(hk) * D;
#pragma unroll
      for (int c = 0; c < NO; ++c)
        store_acc<E>(dst + 128 * c, acc[c], Hkv * D, Sk - j * T, warp, lane);
    }
  }
}

// D = 384 and 512: split by output columns. dK and dV of 64 x D in f32
// are 2 x 64 x D x 4 bytes, 256 KB at D = 512: the whole register file of
// an SM. So a CTA owns one column slice [z DC, (z + 1) DC), DC = D / 2, of
// both, and runs the D = 256 split by accumulator on it: warpgroup 0 owns
// the dV slice, warpgroup 1 the dK slice (128 registers a thread at 512, 96
// at 384), P^T goes across in shared memory as above.
//   * The choice. Each slice's CTA still reduces S^T and dP^T over all of
//     head_dim, so the two CTAs of a key block do 2 D + 2 DC = 3 D units
//     of tensor work an item each, 1.5x the 4 D of one CTA that held it
//     all; the bound (chip_smoke.py) counts no redundant work. DC = 128
//     (four slices) costs 2.5x at D = 512, and a 2-CTA cluster summing
//     partial S^T across its pair through distributed shared memory saves
//     the 1.5x at the price of a cluster barrier an item.
//   * Shared memory. K and V stay whole (2 x D / 8 KB: 128 KB at 512, 96
//     at 384), which leaves no room for one item's Q and dO tiles (another
//     128 KB at 512). So Q and dO stream in pairs of 64-column panels (Q
//     panel c, dO panel c: 16 KB a slot) through a ring of SLICE_RING
//     slots, D / 64 pairs an item: the panels outside the slice first
//     (their slots freed as soon as S^T and dP^T have read them), then the
//     slice's own, which stay in their slots for dV += P^T dO and dK +=
//     dS^T Q (one wgmma m64n64k16 a panel and k-step) and are freed panel
//     by panel after them. One wgmma group stays in flight: a slot is
//     released once the next unit's group has been issued. Budget at 512:
//     K, V 128 KB, 5 slots 80 KB, one P^T buffer 16 KB, lse and delta of 2
//     items 1 KB, barriers, 1 KB of alignment: 226 KB; at 384: 96 + 6 x 16
//     + 2 x 16 + 1 KB, 226 KB. The lse and delta of item n sit in buffer
//     n % 2, loaded with its first panel pair: they are written again for
//     item n + 2 only after every consumer has released a slot of item n +
//     1 (SLICE_RING <= D / 64), so after it finished item n.
//   * Grid fill. One CTA per (pair of key tiles, KV head, batch, slice):
//     256 CTAs at Hkv = 8, S = 2048, but 64 at Hkv = 2. Where the grid
//     would leave SMs idle the caller asks for `splits` > 1 (ops/
//     flash_attention.py, dkv_splits): the CTA's GQA items t = s, s +
//     splits, ... go to split s, each split writes its f32 partial dK and
//     dV to a workspace, and flash_dkv_sum_kernel adds the splits in a
//     fixed order (deterministic) and writes E. A split or a key tile with
//     no item writes zeros, so unseen keys stay exact zeros.
template <int D>
constexpr int DC = D / 2;                   // output columns of a slice
template <int D>
constexpr int SLICE_RING = D == 512 ? 5 : 6;
template <int D>
constexpr int SLICE_PBUF = D == 512 ? 1 : 2;   // P^T exchange buffers
constexpr int PAIR_BYTES = 2 * hopper::PANEL_BYTES;  // Q panel, dO panel
template <int D>
constexpr int SMEM_DKV_SLICE = 1024 + 2 * TILE<D> +
                               SLICE_RING<D> * PAIR_BYTES +
                               SLICE_PBUF<D> * T * T * 4 + 2 * 2 * T * 4 +
                               8 * (2 + 2 * SLICE_RING<D>);

// The head_dim panel that reduction unit u (0 .. D / 64 - 1) of an item
// reads in slice z: the panels outside the slice in order, then the
// slice's own.
template <int D>
__device__ __forceinline__ int slice_panel(int u, int z) {
  constexpr int NP = D / 64, NC = DC<D> / 64;
  if (u >= NP - NC) return z * NC + u - (NP - NC);
  return u < z * NC ? u : u + NC;
}

template <typename E, int D>
__device__ __forceinline__ void dkv_by_slice(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* delta, E* dk, E* dv, float* ws, int splits, int H, int Hkv,
    int Sq, int Sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  constexpr int NP = D / 64, NC = DC<D> / 64;       // units, slice panels
  constexpr int R = SLICE_RING<D>, NPB = SLICE_PBUF<D>;
  static_assert(R <= NP && R >= NC, "slots: see the lse/delta buffers");
  unsigned char* sK = align_1024(smem);
  unsigned char* sV = sK + TILE<D>;
  unsigned char* sRing = sV + TILE<D>;                     // R panel pairs
  float* sP = reinterpret_cast<float*>(sRing + R * PAIR_BYTES);
  float* sStat = sP + NPB * T * T;                         // 2 x lse, delta
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(sStat + 2 * 2 * T);
  uint64_t* kv_empty = kv_full + 1;
  uint64_t* full = kv_empty + 1;
  uint64_t* empty = full + R;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk), group = H / Hkv;
  const int rest = gridDim.x / ((nkt + 1) / 2);     // Hkv * B * 2 * splits
  const int pair = static_cast<int>(blockIdx.x) / rest;
  const int r = static_cast<int>(blockIdx.x) % rest;
  const int z = r % 2, split = r / 2 % splits;
  const int hk = r / (2 * splits) % Hkv, b = r / (2 * splits * Hkv);
  const int nb = rest / (2 * splits * Hkv);
  const int n_jt = nkt - 1 - pair != pair ? 2 : 1;  // k tiles pair, nkt-1-pair
  // Items of this split over both k tiles (both consumers take each).
  int total = 0;
  for (int u = 0; u < n_jt; ++u) {
    const int j = u == 0 ? pair : nkt - 1 - pair;
    const int items = group * max(nqt - first_q_tile(j, causal, q_offset), 0);
    total += items > split ? (items - split + splits - 1) / splits : 0;
  }

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
    // Producer: per k tile, K and V, then the split's items, each D / 64
    // panel pairs (slice_panel order) through the ring, the first with the
    // item's lse and delta.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      int n = 0, unit = 0;
      for (int u = 0; u < n_jt; ++u) {
        const int j = u == 0 ? pair : nkt - 1 - pair;
        if (u > 0) mbar_wait(kv_empty, (u - 1) & 1);
        mbar_expect_tx(kv_full, 2 * TILE<D>);
        tma_load_tile<D>(sK, kmap, kv_full, hk, j * T, b);
        tma_load_tile<D>(sV, vmap, kv_full, hk, j * T, b);
        const int i0 = first_q_tile(j, causal, q_offset);
        const int nqv = max(nqt - i0, 0);
        for (int t = split; t < group * nqv; t += splits, ++n) {
          const int h = hk * group + t / nqv, i = i0 + t % nqv;
          const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + i * T;
          // lse and delta up to Sq only (32-byte multiples, as above).
          const uint32_t stat_bytes = min(T, Sq - i * T) * 4;
          float* stat = sStat + (n & 1) * 2 * T;
          for (int p = 0; p < NP; ++p, ++unit) {
            const int s = unit % R, use = unit / R;
            if (use > 0) mbar_wait(&empty[s], (use - 1) & 1);
            unsigned char* dst = sRing + s * PAIR_BYTES;
            const int c0 = 64 * slice_panel<D>(p, z);
            mbar_expect_tx(&full[s],
                           PAIR_BYTES + (p == 0 ? 2 * stat_bytes : 0));
            tma_load_panel(dst, qmap, &full[s], c0, h, i * T, b);
            tma_load_panel(dst + PANEL_BYTES, domap, &full[s], c0, h, i * T,
                           b);
            if (p == 0) {
              bulk_load(stat, lse + row, stat_bytes, &full[s]);
              bulk_load(stat + T, delta + row, stat_bytes, &full[s]);
            }
          }
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // Warpgroup 0 reduces S^T = K Q^T and owns dV (B = dO); warpgroup 1
    // reduces dP^T = V dO^T and owns dK (B = Q).
    const unsigned char* sA = wg == 0 ? sK : sV;
    const int red_off = wg == 0 ? 0 : PANEL_BYTES;         // Q or dO panel
    const int out_off = wg == 0 ? PANEL_BYTES : 0;         // dO or Q panel
    auto release = [&](int unit) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[unit % R]);
    };
    int n = 0, unit = 0;
    for (int u = 0; u < n_jt; ++u) {
      const int j = u == 0 ? pair : nkt - 1 - pair;
      const int i0 = first_q_tile(j, causal, q_offset);
      const int nqv = max(nqt - i0, 0);
      float acc[NC][32];
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;

      mbar_wait(kv_full, u & 1);
      for (int t = split; t < group * nqv; t += splits, ++n, unit += NP) {
        const int i = i0 + t % nqv;
        const int queries = Sq - i * T;    // < T on a partial last q tile
        const float* sLse = sStat + (n & 1) * 2 * T;
        const float* sDelta = sLse + T;
        float* pbuf = sP + (n % NPB) * T * T;
        float x[32];
        uint32_t a[4][4];
        // S^T or dP^T over head_dim, a panel pair a unit.
#pragma unroll
        for (int p = 0; p < NP; ++p) {
          const int s = (unit + p) % R;
          mbar_wait(&full[s], ((unit + p) / R) & 1);
          const unsigned char* sB = sRing + s * PAIR_BYTES + red_off;
          const int col = slice_panel<D>(p, z);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_ss<E>(x, desc_kmajor(sA, 4 * col + kk),
                                  desc_kmajor(sB, kk), p > 0 || kk > 0);
          wgmma_commit();
          if (p > 0) {
            wgmma_wait<1>();
            if (p - 1 < NP - NC) release(unit + p - 1);
          }
        }
        wgmma_wait_all();
        reg_fence(x);
        if (wg == 0) {
          // P^T = exp(S^T scale - lse), masked to 0 (the causal mask on
          // diagonal tiles, query columns past Sq).
          const bool diag = causal && j * T + T - 1 > i * T + q_offset;
#pragma unroll
          for (int e = 0; e < 32; ++e) {
            const int col = acc_col(e, lane);
            float v = x[e] * scale;
            if (diag &&
                i * T + col + q_offset < j * T + acc_row(e, warp, lane))
              v = NEG_INF;
            x[e] = exp2f((v - sLse[col]) * LOG2E);
          }
          if (queries < T) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (acc_col(e, lane) >= queries) x[e] = 0.0f;
          }
          if (n >= NPB) named_sync(P_EMPTY + n % NPB, 256);
#pragma unroll
          for (int e = 0; e < 32; ++e) pbuf[e * 128 + tid] = x[e];
          named_arrive(P_FULL + n % NPB, 256);
        } else {
          // dS^T = P^T (dP^T - delta) scale with warpgroup 0's P^T; query
          // columns past Sq read stale delta and get dS = 0.
          named_sync(P_FULL + n % NPB, 256);
#pragma unroll
          for (int e = 0; e < 32; ++e)
            x[e] = pbuf[e * 128 + tid] * (x[e] - sDelta[acc_col(e, lane)]) *
                   scale;
          if (n + NPB < total) named_arrive(P_EMPTY + n % NPB, 256);
          if (queries < T) {
#pragma unroll
            for (int e = 0; e < 32; ++e)
              if (acc_col(e, lane) >= queries) x[e] = 0.0f;
          }
        }
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) frag_a<E>(a[kk], x, kk);
        // dV += P^T dO or dK += dS^T Q on the slice's panels, still in
        // the last NC slots of the item.
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const int p = NP - NC + c;
          const unsigned char* sB =
              sRing + (unit + p) % R * PAIR_BYTES + out_off;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_m64n64k16_rs<E>(acc[c], a[kk], desc_nmajor(sB, kk));
          wgmma_commit();
          if (c > 0) {
            wgmma_wait<1>();
            release(unit + p - 1);
          }
        }
        wgmma_wait_all();
#pragma unroll
        for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
        release(unit + NP - 1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);  // K, V free for the next tile

      // The slice of dV (warpgroup 0) or dK: as E, or the split's f32
      // partial sum into the workspace [2][splits][B, Sk, Hkv, D].
      const int64_t at = (static_cast<int64_t>(b) * Sk + j * T) * Hkv * D +
                         static_cast<int64_t>(hk) * D + z * DC<D>;
      if (splits == 1) {
        E* dst = (wg == 0 ? dv : dk) + at;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          store_acc<E>(dst + 64 * c, acc[c], Hkv * D, Sk - j * T, warp, lane);
      } else {
        const int64_t per = static_cast<int64_t>(nb) * Sk * Hkv * D;
        float* dst = ws + (wg == 0 ? splits + split : split) * per + at;
#pragma unroll
        for (int c = 0; c < NC; ++c)
          store_acc<float>(dst + 64 * c, acc[c], Hkv * D, Sk - j * T, warp,
                           lane);
      }
    }
  }
}

// dK and dV of a split dkv_by_slice run: element e of each is the sum of
// its splits' partials in split order, rounded to E once.
template <typename E>
__global__ void __launch_bounds__(256) flash_dkv_sum_kernel(
    const float* __restrict__ ws, E* __restrict__ dk, E* __restrict__ dv,
    int64_t n, int splits) {
  const int64_t pairs = n / 2;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       w < 2 * pairs; w += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int o = w >= pairs;                       // 0: dK, 1: dV
    const int64_t e = 2 * (w - o * pairs);
    const float* src = ws + static_cast<int64_t>(o) * splits * n + e;
    float x = 0.0f, y = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float2 v = *reinterpret_cast<const float2*>(src + s * n);
      x += v.x;
      y += v.y;
    }
    store2<E>((o ? dv : dk) + e, x, y);
  }
}

template <int D>
constexpr int SMEM_DKV = D == 128 ? SMEM_DKV_ITEMS
                         : D == 256 ? SMEM_DKV_ACC
                                    : SMEM_DKV_SLICE<D>;

template <typename E, int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_dkv_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dk,
    E* __restrict__ dv, float* __restrict__ ws, int splits, int H, int Hkv,
    int Sq, int Sk, int causal, int q_offset, float scale) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (D == 128)
    dkv_by_items<E>(smem_raw, &qmap, &kmap, &vmap, &domap, lse, delta, dk, dv,
                    H, Hkv, Sq, Sk, causal, q_offset, scale);
  else if constexpr (D == 256)
    dkv_by_accumulator<E, D>(smem_raw, &qmap, &kmap, &vmap, &domap, lse,
                             delta, dk, dv, H, Hkv, Sq, Sk, causal, q_offset,
                             scale);
  else
    dkv_by_slice<E, D>(smem_raw, &qmap, &kmap, &vmap, &domap, lse, delta, dk,
                       dv, ws, splits, H, Hkv, Sq, Sk, causal, q_offset,
                       scale);
}

// ---------------------------------------------------------------------------
// Backward, dQ at D = 384 and 512: split by output columns, as the dK/dV
// there. dQ of 64 x D in f32 is D / 2 registers a thread of one
// warpgroup, 256 at D = 512, over the 240 that setmaxnreg gives; Q and dO
// of the two q tiles of dq_by_tiles take 256 KB at 512. So one CTA per
// (q tile, head, batch), and its two consumer warpgroups each own one
// column half [g DC, (g + 1) DC), DC = D / 2, of the tile's dQ (NC = DC /
// 64 accumulators of 64 x 64: 128 registers a thread at 512, 96 at 384).
//   * The choice. Both warpgroups reduce S = Q K^T and dP = dO V^T over
//     all of head_dim from the same shared tiles, so the two do 2 (2 D +
//     2 D + D) = 10 D FLOPs a visible (q, k) pair where 6 D suffice
//     (1.67x); the bound (chip_smoke.py) counts no redundant work. Two
//     CTAs a q tile, one a half (the dK/dV's split), would do the same
//     work but load Q, dO, K and V twice; a pair of q tiles a CTA cannot
//     hold their Q and dO. Summing the halves' partial S and dP through
//     shared memory instead of recomputing them needs 32 KB that do not
//     fit beside K and a V ring.
//   * Shared memory. Q and dO stay whole (2 x D / 8 KB: 128 KB at 512, 96
//     at 384), loaded once on one barrier. K tile j comes as D / 64 panels,
//     panel c always in K slot c with its own barriers, V as panels
//     through a ring of DQ_VRING slots. Per panel c both warpgroups add
//     its four k-steps to S and dP (one wgmma group, one in flight); a V
//     panel is released after its dP, a K panel by the warpgroup whose
//     half it is not after S, by the other after its dQ += dS K[:, panel],
//     one m64n64k16 a k-step, N-major. So K panel c of tile j + 1 loads
//     while the rest of tile j's dQ runs. Budget at 512: Q, dO 128 KB, K
//     64 KB, 4 V slots 32 KB, 1 KB of alignment and the barriers, 225 KB;
//     at 384: 96 + 48 + 6 x 8 + 1 KB, 193 KB.
//   * Per k tile as in dq_by_tiles: scale and mask (diagonal and partial
//     last tiles), P = exp(S - lse), dS = P (dP - delta) scale rounded to E
//     register fragments (the plain version's cast point). Each dQ row is
//     summed by one warpgroup in k-tile order (deterministic), written
//     once as E; rows past Sq are never stored.
//   * Registers of a consumer thread: dQ 128 at 512, S and dP 32 each, the
//     dS fragments 16, under the 240 that setmaxnreg gives it (as the D =
//     256 dQ of dq_by_tiles).
template <int D>
constexpr int DQ_VRING = D == 512 ? 4 : 6;
template <int D>
constexpr int SMEM_DQ_SLICE = 1024 + 3 * TILE<D> +
                              DQ_VRING<D> * hopper::PANEL_BYTES +
                              8 * (1 + 2 * (D / 64) + 2 * DQ_VRING<D>);

template <typename E, int D>
__device__ __forceinline__ void dq_by_slice(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, const CUtensorMap* domap, const float* lse,
    const float* delta, E* dq, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  using namespace hopper;
  constexpr int NP = D / 64, NC = DC<D> / 64;       // panels, slice panels
  constexpr int RV = DQ_VRING<D>;
  unsigned char* sQ = align_1024(smem);
  unsigned char* sdO = sQ + TILE<D>;
  unsigned char* sK = sdO + TILE<D>;                 // K panel c in slot c
  unsigned char* sV = sK + TILE<D>;                  // RV V panel slots
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(sV + RV * PANEL_BYTES);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* k_empty = k_full + NP;
  uint64_t* v_full = k_empty + NP;
  uint64_t* v_empty = v_full + RV;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk);
  const int hb = gridDim.x / nqt;                    // H * B
  const int blk = static_cast<int>(blockIdx.x);
  const int i = nqt - 1 - blk / hb, h = blk % hb % H, b = blk % hb / H;
  const int hk = h / (H / Hkv);
  const int nk = k_tiles_visible(i, nkt, causal, q_offset);

  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int c = 0; c < NP; ++c) {
      mbar_init(&k_full[c], 1);
      mbar_init(&k_empty[c], CONSUMER_WARPS);
    }
    for (int s = 0; s < RV; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producer: Q and dO once, then per k tile its K and V panels in
    // order, K panel c into slot c, V panel n (of all) into slot n % RV.
    reg_dealloc<24>();
    if (threadIdx.x == 256) {
      mbar_expect_tx(qdo_full, 2 * TILE<D>);
      tma_load_tile<D>(sQ, qmap, qdo_full, h, i * T, b);
      tma_load_tile<D>(sdO, domap, qdo_full, h, i * T, b);
      for (int j = 0; j < nk; ++j) {
        for (int c = 0; c < NP; ++c) {
          if (j > 0) mbar_wait(&k_empty[c], (j - 1) & 1);
          mbar_expect_tx(&k_full[c], PANEL_BYTES);
          tma_load_panel(sK + c * PANEL_BYTES, kmap, &k_full[c], 64 * c, hk,
                         j * T, b);
          const int n = j * NP + c, s = n % RV, use = n / RV;
          if (use > 0) mbar_wait(&v_empty[s], (use - 1) & 1);
          mbar_expect_tx(&v_full[s], PANEL_BYTES);
          tma_load_panel(sV + s * PANEL_BYTES, vmap, &v_full[s], 64 * c, hk,
                         j * T, b);
        }
      }
    }
  } else {
    reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    const int first = wg * NC;                      // the half's first panel
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    // Rows past Sq keep lse = delta = 0: their Q and dO rows are zeros,
    // so their P and dS stay finite, and they are never stored.
    float row_lse[2] = {0.0f, 0.0f}, row_delta[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int pos = i * T + 16 * warp + lane / 4 + 8 * r;
      const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq + pos;
      if (pos < Sq) {
        row_lse[r] = lse[row];
        row_delta[r] = delta[row];
      }
    }

    float acc[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[c][e] = 0.0f;

    mbar_wait(qdo_full, 0);
    for (int j = 0; j < nk; ++j) {
      // S = Q K^T and dP = dO V^T over head_dim, a panel pair a group.
      float sc[32], dp[32];
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        const int n = j * NP + c;
        mbar_wait(&k_full[c], j & 1);
        mbar_wait(&v_full[n % RV], (n / RV) & 1);
        const unsigned char* pK = sK + c * PANEL_BYTES;
        const unsigned char* pV = sV + n % RV * PANEL_BYTES;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss<E>(sc, desc_kmajor(sQ, 4 * c + kk),
                                desc_kmajor(pK, kk), c > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss<E>(dp, desc_kmajor(sdO, 4 * c + kk),
                                desc_kmajor(pV, kk), c > 0 || kk > 0);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release(&v_empty[(n - 1) % RV]);
          if (c - 1 < first || c - 1 >= first + NC) release(&k_empty[c - 1]);
        }
      }
      wgmma_wait_all();
      reg_fence(sc);
      reg_fence(dp);
      release(&v_empty[(j * NP + NP - 1) % RV]);
      if (NP - 1 < first || NP - 1 >= first + NC) release(&k_empty[NP - 1]);

      // Scale, mask (diagonal tiles and a partial last k tile only, a
      // uniform branch), P and dS; dS overwrites S.
      const bool diag = causal && j * T + T - 1 > i * T + q_offset;
      const int keys = Sk - j * T;
#pragma unroll
      for (int e = 0; e < 32; ++e) sc[e] *= scale;
      if (diag || keys < T) {
#pragma unroll
        for (int e = 0; e < 32; ++e)
          if ((diag && i * T + acc_row(e, warp, lane) + q_offset <
                           j * T + acc_col(e, lane)) ||
              acc_col(e, lane) >= keys)
            sc[e] = NEG_INF;
      }
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int r = (e % 4) / 2;
        const float p = exp2f((sc[e] - row_lse[r]) * LOG2E);
        sc[e] = p * (dp[e] - row_delta[r]) * scale;
      }

      // dQ[:, half] += dS K[:, half], dS as register fragments of E, one
      // K panel a group; each panel released once its group is done.
      uint32_t da[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a<E>(da[kk], sc, kk);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<E>(
              acc[c], da[kk],
              desc_nmajor(sK + (first + c) * PANEL_BYTES, kk));
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release(&k_empty[first + c - 1]);
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) reg_fence(acc[c]);
      release(&k_empty[first + NC - 1]);
    }
    E* dst = dq + (static_cast<int64_t>(b) * Sq + i * T) * H * D +
             static_cast<int64_t>(h) * D + wg * DC<D>;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      store_acc<E>(dst + 64 * c, acc[c], H * D, Sq - i * T, warp, lane);
  }
}

template <int D>
constexpr int SMEM_DQ = D <= 256 ? SMEM_DQ_TILES<D> : SMEM_DQ_SLICE<D>;

template <typename E, int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_dq_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap,
    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
    const float* __restrict__ delta, E* __restrict__ dq, int H, int Hkv,
    int Sq, int Sk, int causal, int q_offset, float scale) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (D <= 256)
    dq_by_tiles<E, D>(smem_raw, &qmap, &kmap, &vmap, &domap, lse, delta, dq,
                      H, Hkv, Sq, Sk, causal, q_offset, scale);
  else
    dq_by_slice<E, D>(smem_raw, &qmap, &kmap, &vmap, &domap, lse, delta, dq,
                      H, Hkv, Sq, Sk, causal, q_offset, scale);
}

// ---------------------------------------------------------------------------
// Forward at D = 384 and 512: split by output columns, as the dQ there. O
// of 64 x D in f32 is D / 2 registers a thread of one warpgroup, 256 at D
// = 512, over the 240 that setmaxnreg gives; two q tiles' Q take 128 KB at
// 512. So one CTA per (q tile, head, batch), heaviest causal q tiles first
// (dq_by_slice's numbering), and its two consumer warpgroups each own one
// column half [g DC, (g + 1) DC), DC = D / 2, of the tile's O (NC = DC / 64
// accumulators of 64 x 64: 128 registers a thread at 512, 96 at 384).
//   * The choice. Both warpgroups reduce S = Q K^T over all of head_dim
//     from the same shared tiles, so the two do 2 (2 D) + 2 D = 6 D FLOPs
//     a visible (q, k) pair where 4 D suffice (1.5x); the bound
//     (chip_smoke.py) counts no redundant work. Both run the same wgmma
//     sequence on the same operands, so their S, and so their running max
//     m and sum l, are bit for bit the same: no exchange, and warpgroup 0
//     alone writes lse. Summing the halves' partial S through shared
//     memory instead does 4 D a pair, but with its 16 KB exchange, two
//     named barriers a k tile and the V rings cut to fit, it ran slower
//     on an H100 (PERF.md).
//   * Shared memory. Q stays whole (D / 8 KB: 64 KB at 512, 48 at 384),
//     loaded once. K tile j comes as D / 64 panels, panel c always in K
//     slot c with its own barriers; both warpgroups release panel c once
//     their S group that read it is done (one group in flight), so K
//     panel c of tile j + 1 loads while the rest of tile j runs. V comes
//     as panels through two rings of FWD_VRING slots, one a column half:
//     warpgroup g reads only its own half's NC panels a tile, so a ring's
//     empty barriers count only its 4 warps, and each half streams on its
//     own. Three producer threads in three warps (K; V of half 0; V of
//     half 1) each issue their own loads, so no wait of one stream holds
//     up another. Budget at 512: Q 64 KB, K 64, V 2 x 6 x 8 = 96 (each
//     half one and a half tiles ahead), 1 KB of alignment and the
//     barriers: 225 KB of the 227 KB a block may use; at 384: 48 + 48 + 96
//     + 1 KB, 193 KB (each half two tiles ahead).
//   * Per k tile as in fwd_by_tiles: scale and mask (diagonal and partial
//     last tiles, a uniform branch), the online softmax on the accumulator
//     layout; O is rescaled in registers before the tile's P V, which
//     adds, per panel of the half's V, 4 k-steps of wgmma m64n64k16 (A =
//     P rounded to E from registers, V N-major). Each O row is summed by
//     one warpgroup in k-tile order (deterministic) and written once as E;
//     rows past Sq are never stored. Both warpgroups walk the same k
//     tiles, so every K and V panel loaded is released by its readers.
//   * Registers of a consumer thread: O 128 at 512, S 32, the P fragments
//     16, under the 240 that setmaxnreg gives it (as the D = 256
//     forward).
constexpr int FWD_VRING = 6;                // V panel slots a column half
template <int D>
constexpr int SMEM_FWD_SLICE = 1024 + 2 * TILE<D> +
                               2 * FWD_VRING * hopper::PANEL_BYTES +
                               8 * (1 + 2 * (D / 64) + 2 * 2 * FWD_VRING);

template <typename E, int D>
__device__ __forceinline__ void fwd_by_slice(
    unsigned char* smem, const CUtensorMap* qmap, const CUtensorMap* kmap,
    const CUtensorMap* vmap, E* out, float* lse, int H, int Hkv, int Sq,
    int Sk, int causal, int q_offset, float scale) {
  using namespace hopper;
  constexpr int NP = D / 64, NC = DC<D> / 64;       // panels, slice panels
  constexpr int RV = FWD_VRING;
  unsigned char* sQ = align_1024(smem);
  unsigned char* sK = sQ + TILE<D>;                  // K panel c in slot c
  unsigned char* sV = sK + TILE<D>;                  // half g: slots g RV..
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sV + 2 * RV * PANEL_BYTES);
  uint64_t* k_full = q_full + 1;
  uint64_t* k_empty = k_full + NP;
  uint64_t* v_full = k_empty + NP;
  uint64_t* v_empty = v_full + 2 * RV;

  const int nqt = n_tiles(Sq), nkt = n_tiles(Sk);
  const int hb = gridDim.x / nqt;                    // H * B
  const int blk = static_cast<int>(blockIdx.x);
  const int i = nqt - 1 - blk / hb, h = blk % hb % H, b = blk % hb / H;
  const int hk = h / (H / Hkv);
  const int nk = k_tiles_visible(i, nkt, causal, q_offset);

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int c = 0; c < NP; ++c) {
      mbar_init(&k_full[c], 1);
      mbar_init(&k_empty[c], CONSUMER_WARPS);
    }
    for (int s = 0; s < 2 * RV; ++s) {
      mbar_init(&v_full[s], 1);
      mbar_init(&v_empty[s], CONSUMER_WARPS / 2);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // Producers: warp 0 Q once, then per k tile its K panels, panel c into
    // slot c; warp 1 + g the V panels of half g, the n-th of the half
    // (tile n / NC, panel g NC + n % NC) into its ring's slot n % RV.
    reg_dealloc<24>();
    const int pw = (threadIdx.x - 256) / 32;
    if (threadIdx.x % 32 == 0 && pw == 0) {
      mbar_expect_tx(q_full, TILE<D>);
      tma_load_tile<D>(sQ, qmap, q_full, h, i * T, b);
      for (int j = 0; j < nk; ++j)
        for (int c = 0; c < NP; ++c) {
          if (j > 0) mbar_wait(&k_empty[c], (j - 1) & 1);
          mbar_expect_tx(&k_full[c], PANEL_BYTES);
          tma_load_panel(sK + c * PANEL_BYTES, kmap, &k_full[c], 64 * c, hk,
                         j * T, b);
        }
    } else if (threadIdx.x % 32 == 0 && pw <= 2) {
      const int g = pw - 1;
      for (int n = 0; n < nk * NC; ++n) {
        const int s = g * RV + n % RV, use = n / RV;
        if (use > 0) mbar_wait(&v_empty[s], (use - 1) & 1);
        mbar_expect_tx(&v_full[s], PANEL_BYTES);
        tma_load_panel(sV + s * PANEL_BYTES, vmap, &v_full[s],
                       64 * (g * NC + n % NC), hk, n / NC * T, b);
      }
    }
  } else {
    reg_alloc<240>();
    const int warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar);
    };
    float o[NC][32];
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] = 0.0f;
    float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

    mbar_wait(q_full, 0);
    for (int j = 0; j < nk; ++j) {
      // S = Q K^T over head_dim, a K panel a group, each panel released
      // once its group is done.
      float sc[32];
#pragma unroll
      for (int c = 0; c < NP; ++c) {
        mbar_wait(&k_full[c], j & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_ss<E>(sc, desc_kmajor(sQ, 4 * c + kk),
                                desc_kmajor(sK + c * PANEL_BYTES, kk),
                                c > 0 || kk > 0);
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release(&k_empty[c - 1]);
        }
      }
      wgmma_wait_all();
      reg_fence(sc);
      release(&k_empty[NP - 1]);

      float corr[2];
      online_softmax(sc, m, l, corr, i * T, j, Sk, causal, q_offset, scale,
                     warp, lane);
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 32; ++e) o[c][e] *= corr[(e % 4) / 2];

      // O[:, half] += P V[:, half], P as register fragments of E, one V
      // panel of the half a group; each slot released once its group is
      // done.
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) frag_a<E>(pa[kk], sc, kk);
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int n = j * NC + c, s = wg * RV + n % RV;
        mbar_wait(&v_full[s], (n / RV) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_m64n64k16_rs<E>(o[c], pa[kk],
                                desc_nmajor(sV + s * PANEL_BYTES, kk));
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();
          release(&v_empty[wg * RV + (n - 1) % RV]);
        }
      }
      wgmma_wait_all();
#pragma unroll
      for (int c = 0; c < NC; ++c) reg_fence(o[c]);
      release(&v_empty[wg * RV + (j * NC + NC - 1) % RV]);
    }

    // Finalize: O / l; lse from warpgroup 0 (warpgroup 1's m and l are
    // the same).
    float inv[2];
    finish_rows(inv, m, l, lse + (static_cast<int64_t>(b) * H + h) * Sq,
                i * T, Sq, wg == 0, warp, lane);
    E* dst = out + (static_cast<int64_t>(b) * Sq + i * T) * H * D +
             static_cast<int64_t>(h) * D + wg * DC<D>;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
#pragma unroll
      for (int e = 0; e < 32; ++e) o[c][e] *= inv[(e % 4) / 2];
      store_acc<E>(dst + 64 * c, o[c], H * D, Sq - i * T, warp, lane);
    }
  }
}


template <int D>
constexpr int SMEM_FWD = D <= 256 ? SMEM_FWD_TILES<D> : SMEM_FWD_SLICE<D>;

template <typename E, int D>
__global__ void __launch_bounds__(NT_WS, 1) flash_fwd_kernel(
    const __grid_constant__ CUtensorMap qmap,
    const __grid_constant__ CUtensorMap kmap,
    const __grid_constant__ CUtensorMap vmap, E* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int causal,
    int q_offset, float scale) {
  extern __shared__ unsigned char smem_raw[];
  if constexpr (D <= 256)
    fwd_by_tiles<E, D>(smem_raw, &qmap, &kmap, &vmap, out, lse, H, Hkv, Sq,
                       Sk, causal, q_offset, scale);
  else
    fwd_by_slice<E, D>(smem_raw, &qmap, &kmap, &vmap, out, lse, H, Hkv, Sq,
                       Sk, causal, q_offset, scale);
}

static_assert(SMEM_FWD<128> <= 232448 && SMEM_FWD<256> <= 232448 &&
                  SMEM_FWD<384> <= 232448 && SMEM_FWD<512> <= 232448 &&
                  SMEM_DQ<128> <= 232448 && SMEM_DQ<256> <= 232448 &&
                  SMEM_DQ<384> <= 232448 && SMEM_DQ<512> <= 232448 &&
                  SMEM_DKV<128> <= 232448 && SMEM_DKV<256> <= 232448 &&
                  SMEM_DKV<384> <= 232448 && SMEM_DKV<512> <= 232448,
              "shared memory over the 227 KB a block can use");

// Element types of the C entries' `dtype` argument (the Python wrapper's
// codes): 0 bf16, 1 fp16. head_dim: 128, 256, 384 or 512.
enum { DT_BF16 = 0, DT_FP16 = 1 };

template <typename K>
void set_smem(K kernel, int bytes) {
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       bytes);
}

template <typename E, int D>
int launch_fwd(const CUtensorMap& qm, const CUtensorMap& km,
               const CUtensorMap& vm, void* out, void* lse, int B, int H,
               int Hkv, int Sq, int Sk, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  set_smem(flash_fwd_kernel<E, D>, SMEM_FWD<D>);
  // A CTA per pair of q tiles (D <= 256) or per q tile.
  const int ncta = D <= 256 ? (n_tiles(Sq) + 1) / 2 : n_tiles(Sq);
  flash_fwd_kernel<E, D><<<ncta * H * B, NT_WS, SMEM_FWD<D>, stream>>>(
      qm, km, vm, (E*)out, (float*)lse, H, Hkv, Sq, Sk, causal, q_offset,
      scale);
  return (int)cudaGetLastError();
}

template <typename E, int D>
int launch_dq(const CUtensorMap& qm, const CUtensorMap& km,
              const CUtensorMap& vm, const CUtensorMap& dom, const void* lse,
              const void* delta, void* dq, int B, int H, int Hkv, int Sq,
              int Sk, int causal, int q_offset, float scale,
              cudaStream_t stream) {
  set_smem(flash_dq_kernel<E, D>, SMEM_DQ<D>);
  // A CTA per pair of q tiles (D <= 256) or per q tile.
  const int ncta = D <= 256 ? (n_tiles(Sq) + 1) / 2 : n_tiles(Sq);
  flash_dq_kernel<E, D><<<ncta * H * B, NT_WS, SMEM_DQ<D>, stream>>>(
      qm, km, vm, dom, (const float*)lse, (const float*)delta, (E*)dq, H, Hkv,
      Sq, Sk, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

// D = 384, 512: two column slices a key-tile pair, times `splits` (whose
// partial sums flash_dkv_sum_kernel then adds into dk and dv).
template <typename E, int D>
int launch_dkv(const CUtensorMap& qm, const CUtensorMap& km,
               const CUtensorMap& vm, const CUtensorMap& dom, const void* lse,
               const void* delta, void* dk, void* dv, void* ws, int splits,
               int B, int H, int Hkv, int Sq, int Sk, int causal,
               int q_offset, float scale, cudaStream_t stream) {
  if (D <= 256 ? splits != 1 : splits < 1 || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  set_smem(flash_dkv_kernel<E, D>, SMEM_DKV<D>);
  const int npair = (n_tiles(Sk) + 1) / 2;
  const int per_pair = Hkv * B * (D <= 256 ? 1 : 2 * splits);
  flash_dkv_kernel<E, D><<<npair * per_pair, NT_WS, SMEM_DKV<D>, stream>>>(
      qm, km, vm, dom, (const float*)lse, (const float*)delta, (E*)dk, (E*)dv,
      (float*)ws, splits, H, Hkv, Sq, Sk, causal, q_offset, scale);
  if (splits > 1) {
    const int64_t n = static_cast<int64_t>(B) * Sk * Hkv * D;
    const int blocks = n / 512 < 4096 ? static_cast<int>(n / 512) + 1 : 4096;
    flash_dkv_sum_kernel<E><<<blocks, 256, 0, stream>>>(
        (const float*)ws, (E*)dk, (E*)dv, n, splits);
  }
  return (int)cudaGetLastError();
}

// The instantiation for (dtype, head_dim); the entry has checked both.
#define WGMMA_CASES(L, ARGS)                                            \
  switch (dtype * 1024 + head_dim) {                                    \
    case DT_BF16 * 1024 + 128: return L<__nv_bfloat16, 128> ARGS;       \
    case DT_FP16 * 1024 + 128: return L<__half, 128> ARGS;              \
    case DT_BF16 * 1024 + 256: return L<__nv_bfloat16, 256> ARGS;       \
    case DT_FP16 * 1024 + 256: return L<__half, 256> ARGS;              \
    case DT_BF16 * 1024 + 384: return L<__nv_bfloat16, 384> ARGS;       \
    case DT_FP16 * 1024 + 384: return L<__half, 384> ARGS;              \
    case DT_BF16 * 1024 + 512: return L<__nv_bfloat16, 512> ARGS;       \
    case DT_FP16 * 1024 + 512: return L<__half, 512> ARGS;              \
  }                                                                     \
  return (int)cudaErrorInvalidValue;

}  // namespace

extern "C" {

int flash_fwd(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
              int v_ss, int v_sh, int causal, int q_offset, float scale,
              int dtype, int head_dim, void* stream) {
  if ((head_dim % 128 != 0 || head_dim < 128 || head_dim > 512) ||
      (dtype != DT_BF16 && dtype != DT_FP16))
    return (int)cudaErrorInvalidValue;
  const bool f16 = dtype == DT_FP16;
  const int d = head_dim;
  CUtensorMap qm, km, vm;
  CUresult rc;
  if ((rc = hopper::make_bshd_map(&qm, q, B, Sq, H, d, q_sb, q_ss, q_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&km, k, B, Sk, Hkv, d, k_sb, k_ss, k_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&vm, v, B, Sk, Hkv, d, v_sb, v_ss, v_sh,
                                  f16)))
    return -static_cast<int>(rc);
  WGMMA_CASES(launch_fwd, (qm, km, vm, out, lse, B, H, Hkv, Sq, Sk, causal,
                           q_offset, scale, (cudaStream_t)stream))
}

int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* dq, int B, int H,
             int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh, int k_sb,
             int k_ss, int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
             int do_ss, int do_sh, int causal, int q_offset, float scale,
             int dtype, int head_dim, void* stream) {
  if ((head_dim % 128 != 0 || head_dim < 128 || head_dim > 512) ||
      (dtype != DT_BF16 && dtype != DT_FP16))
    return (int)cudaErrorInvalidValue;
  const bool f16 = dtype == DT_FP16;
  const int d = head_dim;
  CUtensorMap qm, km, vm, dom;
  CUresult rc;
  if ((rc = hopper::make_bshd_map(&qm, q, B, Sq, H, d, q_sb, q_ss, q_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&km, k, B, Sk, Hkv, d, k_sb, k_ss, k_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&vm, v, B, Sk, Hkv, d, v_sb, v_ss, v_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&dom, dout, B, Sq, H, d, do_sb, do_ss,
                                  do_sh, f16)))
    return -static_cast<int>(rc);
  WGMMA_CASES(launch_dq, (qm, km, vm, dom, lse, delta, dq, B, H, Hkv, Sq,
                          Sk, causal, q_offset, scale, (cudaStream_t)stream))
}

// workspace, splits: see dkv_by_slice (head_dim 384 and 512); 1 split and
// no workspace below.
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv, int B,
              int H, int Hkv, int Sq, int Sk, int q_sb, int q_ss, int q_sh,
              int k_sb, int k_ss, int k_sh, int v_sb, int v_ss, int v_sh,
              int do_sb, int do_ss, int do_sh, void* workspace, int splits,
              int causal, int q_offset, float scale, int dtype, int head_dim,
              void* stream) {
  if ((head_dim % 128 != 0 || head_dim < 128 || head_dim > 512) ||
      (dtype != DT_BF16 && dtype != DT_FP16))
    return (int)cudaErrorInvalidValue;
  const bool f16 = dtype == DT_FP16;
  const int d = head_dim;
  CUtensorMap qm, km, vm, dom;
  CUresult rc;
  if ((rc = hopper::make_bshd_map(&qm, q, B, Sq, H, d, q_sb, q_ss, q_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&km, k, B, Sk, Hkv, d, k_sb, k_ss, k_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&vm, v, B, Sk, Hkv, d, v_sb, v_ss, v_sh,
                                  f16)) ||
      (rc = hopper::make_bshd_map(&dom, dout, B, Sq, H, d, do_sb, do_ss,
                                  do_sh, f16)))
    return -static_cast<int>(rc);
  WGMMA_CASES(launch_dkv, (qm, km, vm, dom, lse, delta, dk, dv, workspace,
                           splits, B, H, Hkv, Sq, Sk, causal, q_offset, scale,
                           (cudaStream_t)stream))
}

}  // extern "C"
