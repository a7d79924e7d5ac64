// Flash attention for Hopper (sm_90a): the forward, dQ and dK/dV kernels
// of f32 inputs, on tensor cores, at head_dim 128, 256, 384 and 512.
//
// Replace, for f32 inputs, the three Pallas TPU kernels of
// tf_operator_tpu/ops/flash_attention.py:
//   flash_fwd_f32tc_kernel <- _fwd_kernel (:95; _fwd, pallas_call :143)
//   flash_dkv_f32tc_kernel <- _dkv_kernel (:207; _bwd_impl, pallas_call :289)
//   flash_dq_f32tc_kernel  <- _dq_kernel  (:183; _bwd_impl, pallas_call :261)
// The dK/dV is described here, the dQ and the forward, which share its
// machinery, at their own definitions below.
//
// The dK/dV computes _dkv_kernel's function: for one KV head and a block
// of keys, over every (GQA member, visible query tile) item, S^T = K Q^T
// and dP^T = V dO^T (the head_dim reduced), P^T = exp(S^T scale - lse)
// with the causal mask at the finite -1e30, dS^T = P^T (dP^T - delta)
// scale, then dV += P^T dO and dK += dS^T Q, summed over the GQA group
// inside the CTA in a fixed order (no atomics: deterministic). No cast
// points in f32. Tensors are read as [B, S, H, D] through their element
// strides; head h reads KV head h / (H / Hkv). Ragged lengths (any
// multiple of 8): rows past Sq or Sk load as zeros, query columns past Sq
// get P = dS = 0 (their lse and delta are never read), key rows past Sk
// are never stored, and a key no query row sees gets zeros.
//
// 3xTF32. A TF32 product keeps 10 mantissa bits of each operand, about
// 1e-4 of a value, where the f32 kernels are held to 1e-5. So every f32
// operand x, loaded (K, V, Q, dO) or computed (P^T, dS^T), is split into
// hi = cvt.rna.tf32(x) and lo = cvt.rna.tf32(x - hi), and each product is
// lo.hi + hi.lo + hi.hi, small terms first: about 2^-21 of a product is
// left (the lo.lo term, 2^-22, is dropped). The tensor cores add into
// their f32 accumulator rounding toward zero, so a long running sum kept
// there drifts by about half an ulp of the sum at every step, all one way
// (at S = 2048 some 1e-4 of dV). So no sum stays in the tensor cores for
// long: the products of one 64-column chunk of head_dim (pass 1) or of one
// piece of 8-32 queries (pass 2) are summed there from zero, and added to
// the f32 accumulators in registers with round-to-nearest adds.
//
// What bounds it on the card: tensor-core operations. 8 D FLOPs per
// visible (key, query) pair and head, each done as three TF32 products:
// 3 x 8 D FLOPs at 494.7 TFLOP/s (H100 SXM dense TF32), 2.5x faster than
// the 67 TFLOP/s of f32 FMA the SIMT kernel it replaces ran on. Design:
//   * mma.sync m16n8k8 (f32 += tf32 x tf32), fragments read by ld.shared
//     from padded tiles. Not wgmma: its tf32 shape takes only K-major
//     operands from shared memory, and dV += P^T dO and dK += dS^T Q reduce
//     over the query rows, so dO and Q would need a transposed copy every
//     item.
//   * 256 threads (8 warps), one CTA per (pair of key blocks, KV head,
//     batch): key blocks j and nkb - 1 - j, so under the causal mask every
//     CTA walks about the same number of items (the wgmma dK/dV's pairing).
//     A key block is BKV = 64 keys at D = 128, 32 at D = 256-512, so that
//     dK and dV of a block are at most 128 registers a thread.
//   * K and V of the block stay in shared memory. Q and dO of an item come
//     in pieces by cp.async (16 bytes a copy, zero-filled past the end),
//     double-buffered: the copy of the next piece runs while the current
//     one multiplies, one __syncthreads a piece. Pass 1 takes D / 64
//     pieces of 64 rows by 64 head_dim columns and reduces S^T and dP^T
//     over them; pass 2 takes pieces of R2 rows (32 at D = 128, 16 at 256,
//     8 at 384-512: as many as fit the same room) by all of head_dim, on
//     which every warp adds to all of its dV and dK columns (16 to 32
//     independent accumulators a warp). Each item's Q
//     and dO are thus read twice. Holding them whole instead takes 2 x 64
//     x D floats, double-buffered 512 KB at D = 512 beside 130 KB of K and
//     V: more than the 227 KB a block may use.
//   * Warp w owns row block w % (BKV / 16) of 16 keys and column part w /
//     (BKV / 16): in pass 1 that part of the item's 64 queries, in pass 2
//     that part of head_dim (dV and dK in registers for the whole key
//     block, written once at its end). Between the passes P^T and dS^T go
//     through shared memory (sP, sS), since the warps split the queries
//     in pass 1 and reduce over all of them in pass 2.
//   * Bank conflicts. The fragment loads are conflict-free: K, V and the
//     pieces have row strides of 8 mod 32 floats; pass 1 reads its A (K, V)
//     and B (Q, dO) fragments as float2, the two k values of a thread being
//     columns 2t and 2t + 1 of an 8-column step (a permutation of the
//     reduced index that A and B share, so the sum is unchanged); pass 2
//     reads sP and sS (row stride 4 mod 32) and the pieces' columns as
//     scalars in the mma's own order.
//   * Budgets. Shared memory: K and V (2 BKV (D + 8) floats), 2 slots of a
//     Q and a dO piece (the larger of 64 x 72 and R2 x (D + 8) floats
//     each), sP and sS (2 BKV x 68): 224,256 bytes at D = 512, 178,176 at
//     D = 128, of 232,448. Registers a thread: dK and dV 2 x BKV x D / 256
//     (64 at D = 128 and 256, 96 at 384, 128 at 512), the tensor-core
//     sums of a chunk or piece as many again at most, the split fragments.
//
// The extern "C" entries launch on the caller's stream and return
// cudaGetLastError(), or cudaErrorInvalidValue for a (dtype, head_dim) they
// were not built for; the Python wrapper raises on any non-zero value.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;        // threads: 8 warps
constexpr int BQ = 64;         // query rows of an item
constexpr int C = 64;          // head_dim columns of a Q/dO chunk
constexpr int LDC = C + 8;     // row stride of a chunk (floats, 8 mod 32)
constexpr int LDP = BQ + 4;    // row stride of sP and sS (4 mod 32)
constexpr float NEG_INF = -1e30f;

template <int D>
constexpr int BKV = D == 128 ? 64 : 32;      // keys of a block
template <int D>
constexpr int LDK = D + 8;   // row stride of K, V and a pass-2 piece (8 mod 32)
// Query rows of a pass-2 piece: as many as fit the pass-1 piece's room.
template <int D>
constexpr int R2 = D == 128 ? 32 : D == 256 ? 16 : 8;
template <int D>
constexpr int SLOT = BQ * LDC > R2<D> * LDK<D> ? BQ * LDC : R2<D> * LDK<D>;
template <int D>
constexpr int SMEM = 4 * (2 * BKV<D> * LDK<D> + 4 * SLOT<D> +
                          2 * BKV<D> * LDP);

static_assert(SMEM<128> <= 232448 && SMEM<256> <= 232448 &&
                  SMEM<384> <= 232448 && SMEM<512> <= 232448,
              "shared memory over the 227 KB a block can use");

// The C entry's `dtype` code for f32 (the Python wrapper's).
constexpr int DT_F32 = 2;

__host__ __device__ __forceinline__ int cdiv(int a, int b) {
  return (a + b - 1) / b;
}

// ---------------------------------------------------------------- 3xTF32

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// An A fragment (4 values) or a B fragment (2 values) split into TF32
// hi and lo parts.
template <int N>
struct Frag {
  uint32_t hi[N], lo[N];
};

template <int N>
__device__ __forceinline__ Frag<N> split(const float (&x)[N]) {
  Frag<N> f;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    f.hi[i] = tf32_rna(x[i]);
    f.lo[i] = tf32_rna(x[i] - __uint_as_float(f.hi[i]));
  }
  return f;
}

// d[16 x 8] += a[16 x 8] b[8 x 8], TF32 operands, f32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): a0 (row g, k t), a1 (g + 8, t),
// a2 (g, t + 4), a3 (g + 8, t + 4); b0 (k t, col g), b1 (t + 4, g); d0
// (row g, col 2t), d1 (g, 2t + 1), d2 (g + 8, 2t), d3 (g + 8, 2t + 1).
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d = a b (a fresh sum in the tensor cores).
__device__ __forceinline__ void mma_tf32_new(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.0f));
}

// d (+)= a b in 3xTF32: lo.hi + hi.lo + hi.hi, small terms first; `fresh`
// starts a new sum in the tensor cores instead of adding to d.
__device__ __forceinline__ void mma3(float (&d)[4], const Frag<4>& a,
                                     const Frag<2>& b, bool fresh) {
  if (fresh)
    mma_tf32_new(d, a.lo, b.hi);
  else
    mma_tf32(d, a.lo, b.hi);
  mma_tf32(d, a.hi, b.lo);
  mma_tf32(d, a.hi, b.hi);
}

// -------------------------------------------------------------- cp.async

// 16 bytes from src to dst, or 16 zero bytes when !valid (src unread).
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows s0 .. s0 + ROWS - 1 (zeros at or past S) and COLS floats from
// `src` (row s at src + s * ss) into dst (row stride ld), by all threads.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_rows(float* dst, int ld, const float* src,
                                          int ss, int s0, int S) {
  constexpr int V = COLS / 4;                 // 16-byte copies a row
#pragma unroll 4
  for (int e = threadIdx.x; e < ROWS * V; e += NT) {
    const int r = e / V, c4 = e % V, s = s0 + r;
    const bool ok = s < S;
    cp_async16(dst + r * ld + 4 * c4,
               ok ? src + static_cast<int64_t>(s) * ss + 4 * c4 : src, ok);
  }
}

// ---------------------------------------------------------------- kernel

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_dkv_f32tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dk, float* __restrict__ dv, int H, int Hkv, int Sq,
    int Sk, int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
    int v_sb, int v_ss, int v_sh, int do_sb, int do_ss, int do_sh, int causal,
    int q_offset, float scale) {
  constexpr int KB = BKV<D>, LK = LDK<D>, NC = D / C;
  constexpr int RB = KB / 16, CP = 8 / RB;  // row blocks, column parts
  constexpr int NT1 = BQ / CP / 8;          // pass 1: query n-tiles a warp
  constexpr int NT2 = D / CP / 8;           // pass 2: head_dim n-tiles a warp
  constexpr int P1 = NC, P2 = BQ / R2<D>;   // pieces of the two passes
  constexpr int KS2 = R2<D> / 8;            // k-steps of a pass-2 piece
  extern __shared__ __align__(16) float smem[];
  float* sK = smem;
  float* sV = sK + KB * LK;
  float* sQ = sV + KB * LK;                 // 2 slots of SLOT<D>
  float* sdO = sQ + 2 * SLOT<D>;            // 2 slots
  float* sP = sdO + 2 * SLOT<D>;            // P^T [key][query]
  float* sS = sP + KB * LDP;                // dS^T [key][query]

  const int nkb = cdiv(Sk, KB), nqt = cdiv(Sq, BQ), group = H / Hkv;
  const int hb = gridDim.x / cdiv(nkb, 2);  // Hkv * B
  const int blk = static_cast<int>(blockIdx.x);
  const int pair = blk / hb, hk = blk % hb % Hkv, b = blk % hb / Hkv;
  const int n_blk = nkb - 1 - pair != pair ? 2 : 1;  // blocks pair, nkb-1-pair
  const float* kp = k + static_cast<int64_t>(b) * k_sb +
                    static_cast<int64_t>(hk) * k_sh;
  const float* vp = v + static_cast<int64_t>(b) * v_sb +
                    static_cast<int64_t>(hk) * v_sh;

  // Each key block of the pair: its first key, first visible q tile, and
  // items (GQA member major, q tile minor); an item is P1 + P2 pieces.
  struct Block {
    int k0, first, nqv, items;
  };
  auto block = [&](int kb) {
    int i0 = 0;
    if (causal) {
      const int need = kb * KB - q_offset - (BQ - 1);
      i0 = need > 0 ? cdiv(need, BQ) : 0;
    }
    const int nqv = max(nqt - i0, 0);
    return Block{kb * KB, i0, nqv, group * nqv};
  };
  const Block blk0 = block(pair);
  const Block blk1 = n_blk == 2 ? block(nkb - 1 - pair) : Block{0, 0, 0, 0};
  constexpr int per_item = P1 + P2;
  const int total = (blk0.items + blk1.items) * per_item;

  // Issue the copies of piece p into slot p % 2 (and, on a key block's
  // first piece, its K and V): piece j < P1 of an item is head_dim chunk j
  // of its Q and dO, piece P1 + r their rows R2 r .. R2 (r + 1) - 1.
  auto issue = [&](int p) {
    const bool second = p >= blk0.items * per_item;
    const Block bu = second ? blk1 : blk0;
    const int local = second ? p - blk0.items * per_item : p;
    const int item = local / per_item, j = local % per_item;
    if (local == 0) {
      load_rows<KB, D>(sK, LK, kp, k_ss, bu.k0, Sk);
      load_rows<KB, D>(sV, LK, vp, v_ss, bu.k0, Sk);
    }
    const int h = hk * group + item / bu.nqv;
    const int row0 = (bu.first + item % bu.nqv) * BQ;
    const float* qp = q + static_cast<int64_t>(b) * q_sb +
                      static_cast<int64_t>(h) * q_sh;
    const float* dop = dout + static_cast<int64_t>(b) * do_sb +
                       static_cast<int64_t>(h) * do_sh;
    float* pq = sQ + (p & 1) * SLOT<D>;
    float* pdo = sdO + (p & 1) * SLOT<D>;
    if (j < P1) {
      load_rows<BQ, C>(pq, LDC, qp + j * C, q_ss, row0, Sq);
      load_rows<BQ, C>(pdo, LDC, dop + j * C, do_ss, row0, Sq);
    } else {
      const int r = row0 + (j - P1) * R2<D>;
      load_rows<R2<D>, D>(pq, LK, qp, q_ss, r, Sq);
      load_rows<R2<D>, D>(pdo, LK, dop, do_ss, r, Sq);
    }
    cp_async_commit();
  };
  // Wait for piece p, make it visible, and start piece p + 1 (into the
  // slot that piece p - 1, which every thread is done with, held).
  auto next_piece = [&](int p) {
    cp_async_wait_all();
    __syncthreads();
    if (p + 1 < total) issue(p + 1);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp % RB * 16;            // the warp's 16 keys
  const int cpart = warp / RB;              // its column part

  if (total > 0) issue(0);
  int p = 0;
  for (int u = 0; u < n_blk; ++u) {
    const Block bu = u ? blk1 : blk0;
    const int k0 = bu.k0;
    float acc_dv[NT2][4], acc_dk[NT2][4];
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_dv[n][e] = acc_dk[n][e] = 0.0f;

    for (int item = 0; item < bu.items; ++item) {
      const int h = hk * group + item / bu.nqv;
      const int i = bu.first + item % bu.nqv;

      // Pass 1: S^T = K Q^T and dP^T = V dO^T over the chunks. The warp's
      // queries are n-tiles cpart * NT1 + j. A and B read columns 2t and
      // 2t + 1 of each 8-column step as the mma's k = t and t + 4. A
      // chunk's sums stay in the tensor cores (s_c, d_c), then are added
      // to st and dpt.
      float st[NT1][4], dpt[NT1][4];
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) st[j][e] = dpt[j][e] = 0.0f;
#pragma unroll 1
      for (int c = 0; c < P1; ++c, ++p) {
        next_piece(p);
        const float* cQ = sQ + (p & 1) * SLOT<D>;
        const float* cdO = sdO + (p & 1) * SLOT<D>;
        const float* rK = sK + (r0 + g) * LK + c * C + 2 * t;
        const float* rV = sV + (r0 + g) * LK + c * C + 2 * t;
        float s_c[NT1][4], d_c[NT1][4];
#pragma unroll
        for (int kk = 0; kk < C / 8; ++kk) {
          // Rows g and g + 8 of the warp's keys.
          const float2 kg = *reinterpret_cast<const float2*>(rK + kk * 8);
          const float2 kg8 =
              *reinterpret_cast<const float2*>(rK + 8 * LK + kk * 8);
          const float2 vg = *reinterpret_cast<const float2*>(rV + kk * 8);
          const float2 vg8 =
              *reinterpret_cast<const float2*>(rV + 8 * LK + kk * 8);
          const Frag<4> ak = split<4>({kg.x, kg8.x, kg.y, kg8.y});
          const Frag<4> av = split<4>({vg.x, vg8.x, vg.y, vg8.y});
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            const int n = (cpart * NT1 + j) * 8 + g;
            const float2 q2 = *reinterpret_cast<const float2*>(
                cQ + n * LDC + kk * 8 + 2 * t);
            const float2 o2 = *reinterpret_cast<const float2*>(
                cdO + n * LDC + kk * 8 + 2 * t);
            const Frag<2> bq = split<2>({q2.x, q2.y});
            const Frag<2> bo = split<2>({o2.x, o2.y});
            mma3(s_c[j], ak, bq, kk == 0);
            mma3(d_c[j], av, bo, kk == 0);
          }
        }
#pragma unroll
        for (int j = 0; j < NT1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] += s_c[j][e];
            dpt[j][e] += d_c[j][e];
          }
      }

      // P^T and dS^T of the warp's tile into sP and sS (every warp read
      // them last in the previous item's pass 2, before the syncs above).
      const int64_t row = (static_cast<int64_t>(b) * H + h) * Sq;
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = r0 + g + 8 * (e / 2);
          const int qc = (cpart * NT1 + j) * 8 + 2 * t + e % 2;
          const int qpos = i * BQ + qc;
          float pv = 0.0f, ds = 0.0f;
          if (qpos < Sq) {
            float x = st[j][e] * scale;
            if (causal && qpos + q_offset < k0 + kl) x = NEG_INF;
            pv = expf(x - lse[row + qpos]);
            ds = pv * (dpt[j][e] - delta[row + qpos]) * scale;
          }
          sP[kl * LDP + qc] = pv;
          sS[kl * LDP + qc] = ds;
        }

      // Pass 2: dV += P^T dO and dK += dS^T Q, KS2 8-query steps a piece,
      // on the warp's head_dim columns cpart * D / CP + 8n. A piece's sums
      // stay in the tensor cores (tv, tk), then are added to acc_dv and
      // acc_dk.
#pragma unroll 1
      for (int pc = 0; pc < P2; ++pc, ++p) {
        next_piece(p);
        const float* cQ = sQ + (p & 1) * SLOT<D>;
        const float* cdO = sdO + (p & 1) * SLOT<D>;
        float tv[NT2][4], tk[NT2][4];
#pragma unroll
        for (int ks = 0; ks < KS2; ++ks) {
          const float* aP = sP + (r0 + g) * LDP + pc * R2<D> + ks * 8 + t;
          const float* aS = sS + (r0 + g) * LDP + pc * R2<D> + ks * 8 + t;
          const Frag<4> ap =
              split<4>({aP[0], aP[8 * LDP], aP[4], aP[8 * LDP + 4]});
          const Frag<4> as =
              split<4>({aS[0], aS[8 * LDP], aS[4], aS[8 * LDP + 4]});
#pragma unroll
          for (int n = 0; n < NT2; ++n) {
            const int col = cpart * (D / CP) + n * 8 + g;
            const float* bO = cdO + (ks * 8 + t) * LK + col;
            const float* bQ = cQ + (ks * 8 + t) * LK + col;
            mma3(tv[n], ap, split<2>({bO[0], bO[4 * LK]}), ks == 0);
            mma3(tk[n], as, split<2>({bQ[0], bQ[4 * LK]}), ks == 0);
            if (ks == KS2 - 1) {
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                acc_dv[n][e] += tv[n][e];
                acc_dk[n][e] += tk[n][e];
              }
            }
          }
        }
      }
    }

    // Write the block's dK and dV (keys past Sk never).
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int key = k0 + r0 + g + 8 * half;
      if (key >= Sk) continue;
      const int64_t base = (static_cast<int64_t>(b) * Sk + key) * Hkv * D +
                           static_cast<int64_t>(hk) * D;
#pragma unroll
      for (int n = 0; n < NT2; ++n) {
        const int col = cpart * (D / CP) + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(dv + base + col) =
            make_float2(acc_dv[n][2 * half], acc_dv[n][2 * half + 1]);
        *reinterpret_cast<float2*>(dk + base + col) =
            make_float2(acc_dk[n][2 * half], acc_dk[n][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------- dQ
//
// _dq_kernel's function for f32: S = Q K^T, P = exp(S scale - lse), dP =
// dO V^T, dS = P (dP - delta) scale, dQ += dS K, every product 3xTF32 (Q,
// K, V, dO and dS split alike) with short tensor-core sums, as above. Bound
// by tensor-core operations: 3 x 6 D FLOPs per visible pair and head at
// 494.7 TFLOP/s. Each dQ row is summed in one CTA in key order
// (deterministic). One CTA per (query block, head, batch), heaviest causal
// blocks first:
// QB = 64 queries at D = 128, 32 at 256-512, whose Q and dO stay in shared
// memory (2 x QB x (D + 8) floats: 133 KB at 512), with their lse and
// delta in registers. Key blocks of KB = 64 keys in order, causal blocks
// past the CTA's last real row skipped. Per key block:
//   * pass 1: S = Q K^T and dP = dO V^T over D / 64 pieces, each the 64
//     keys by 64 head_dim columns of K and of V; warp w owns query row
//     block w % (QB / 16) and key part w / (QB / 16). A piece's products
//     are summed in the tensor cores from zero and added to S and dP in
//     registers. Q and dO are the A operands, read as float2 (columns 2t,
//     2t + 1 as the mma's k = t, t + 4), the pieces the B operands, the
//     same way (row strides 8 mod 32: conflict-free);
//   * P = exp(S scale - lse) (keys past Sk and causal keys at -1e30), dS
//     = P (dP - delta) scale into sS [query][key] (row stride 4 mod 32);
//   * pass 2: dQ += dS K over KB / R2 pieces of R2 key rows by all of
//     head_dim (64 / 32 / 16 / 16 rows at D = 128 / 256 / 384 / 512, as
//     many as fit a pass-1 piece's room): K N-major, keys the reduced
//     index, read as scalars at rows 8 mod 32 floats apart, conflict-free;
//     dS the split A operand. Warp w owns the row block and head_dim part
//     w / (QB / 16) of dQ, in registers (64 a thread at D = 512); each
//     piece's sums start from zero in the tensor cores and are added in.
// So K is read twice a key block (in column pieces, then in row pieces)
// and V once, all through the two cp.async slots of the dK/dV kernel.
// Budgets: Q and dO, 2 slots of 2 x 64 x 72 floats, sS: 215,552 bytes at
// D = 512, 160,768 at 128. Registers: dQ 2 x QB x D / 256 (32 at 128, 64
// at 256-512) and as many tensor-core sums in pass 2.
template <int D>
constexpr int DQ_QB = D == 128 ? 64 : 32;   // queries of a CTA
constexpr int DQ_KB = 64;                   // keys of a block
template <int D>
constexpr int DQ_R2 = D == 128 ? 64 : D == 256 ? 32 : 16;  // pass-2 rows
constexpr int DQ_SLOT = 2 * DQ_KB * LDC;    // a K and a V piece (floats)
constexpr int LDS = DQ_KB + 4;              // row stride of sS (4 mod 32)
template <int D>
constexpr int DQ_SMEM = 4 * (2 * DQ_QB<D> * LDK<D> + 2 * DQ_SLOT +
                             DQ_QB<D> * LDS);

static_assert(DQ_R2<128> * LDK<128> <= DQ_SLOT &&
                  DQ_R2<256> * LDK<256> <= DQ_SLOT &&
                  DQ_R2<384> * LDK<384> <= DQ_SLOT &&
                  DQ_R2<512> * LDK<512> <= DQ_SLOT,
              "a pass-2 piece over its slot");
static_assert(DQ_SMEM<128> <= 232448 && DQ_SMEM<256> <= 232448 &&
                  DQ_SMEM<384> <= 232448 && DQ_SMEM<512> <= 232448,
              "shared memory over the 227 KB a block can use");

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_dq_f32tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, int H, int Hkv, int Sq, int Sk, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
    int v_sh, int do_sb, int do_ss, int do_sh, int causal, int q_offset,
    float scale) {
  constexpr int QB = DQ_QB<D>, LK = LDK<D>, R2Q = DQ_R2<D>;
  constexpr int RB = QB / 16, CP = 8 / RB;  // row blocks, column parts
  constexpr int NT1 = DQ_KB / CP / 8;       // pass 1: key n-tiles a warp
  constexpr int NT2 = D / CP / 8;           // pass 2: head_dim n-tiles a warp
  constexpr int P1 = D / C, P2 = DQ_KB / R2Q;  // pieces of the two passes
  constexpr int KS2 = R2Q / 8;              // k-steps of a pass-2 piece
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                         // [QB][LK]
  float* sdO = sQ + QB * LK;
  float* sSlot = sdO + QB * LK;             // 2 slots of DQ_SLOT
  float* sS = sSlot + 2 * DQ_SLOT;          // dS [query][key]

  const int nqb = cdiv(Sq, QB);
  const int hb = gridDim.x / nqb;           // H * B
  const int blk = static_cast<int>(blockIdx.x);
  const int q0 = (nqb - 1 - blk / hb) * QB, h = blk % hb % H;
  const int b = blk % hb / H, hk = h / (H / Hkv);
  int nkb = cdiv(Sk, DQ_KB);
  if (causal)
    nkb = min(nkb, (min(q0 + QB, Sq) - 1 + q_offset) / DQ_KB + 1);
  const float* qp = q + static_cast<int64_t>(b) * q_sb +
                    static_cast<int64_t>(h) * q_sh;
  const float* dop = dout + static_cast<int64_t>(b) * do_sb +
                     static_cast<int64_t>(h) * do_sh;
  const float* kp = k + static_cast<int64_t>(b) * k_sb +
                    static_cast<int64_t>(hk) * k_sh;
  const float* vp = v + static_cast<int64_t>(b) * v_sb +
                    static_cast<int64_t>(hk) * v_sh;
  const int total = nkb * (P1 + P2);

  // Issue the copies of piece p into slot p % 2 (and, first, Q and dO):
  // piece j < P1 of a key block is head_dim chunk j of its K and V, piece
  // P1 + r its K rows R2Q r .. R2Q (r + 1) - 1.
  auto issue = [&](int p) {
    const int k0 = p / (P1 + P2) * DQ_KB, j = p % (P1 + P2);
    float* slot = sSlot + (p & 1) * DQ_SLOT;
    if (p == 0) {
      load_rows<QB, D>(sQ, LK, qp, q_ss, q0, Sq);
      load_rows<QB, D>(sdO, LK, dop, do_ss, q0, Sq);
    }
    if (j < P1) {
      load_rows<DQ_KB, C>(slot, LDC, kp + j * C, k_ss, k0, Sk);
      load_rows<DQ_KB, C>(slot + DQ_KB * LDC, LDC, vp + j * C, v_ss, k0, Sk);
    } else {
      load_rows<R2Q, D>(slot, LK, kp, k_ss, k0 + (j - P1) * R2Q, Sk);
    }
    cp_async_commit();
  };
  auto next_piece = [&](int p) {
    cp_async_wait_all();
    __syncthreads();
    if (p + 1 < total) issue(p + 1);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp % RB * 16;            // the warp's 16 queries
  const int cpart = warp / RB;              // its key part / head_dim part

  // Rows past Sq keep lse = delta = 0: their Q and dO rows are zeros, so
  // their P and dS stay finite, and they are never stored.
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int pos = q0 + r0 + g + 8 * r;
    const int64_t at = (static_cast<int64_t>(b) * H + h) * Sq + pos;
    row_lse[r] = pos < Sq ? lse[at] : 0.0f;
    row_delta[r] = pos < Sq ? delta[at] : 0.0f;
  }

  float acc[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;

  if (total > 0) issue(0);
  int p = 0;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * DQ_KB;
    // Pass 1: S = Q K^T and dP = dO V^T over the chunks. The warp's keys
    // are n-tiles cpart * NT1 + j; a chunk's sums stay in the tensor cores
    // (s_c, d_c), then are added to s and dp.
    float s[NT1][4], dp[NT1][4];
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < P1; ++c, ++p) {
      next_piece(p);
      const float* cK = sSlot + (p & 1) * DQ_SLOT;
      const float* cV = cK + DQ_KB * LDC;
      const float* rQ = sQ + (r0 + g) * LK + c * C + 2 * t;
      const float* rO = sdO + (r0 + g) * LK + c * C + 2 * t;
      float s_c[NT1][4], d_c[NT1][4];
#pragma unroll
      for (int kk = 0; kk < C / 8; ++kk) {
        // Rows g and g + 8 of the warp's queries.
        const float2 qg = *reinterpret_cast<const float2*>(rQ + kk * 8);
        const float2 qg8 =
            *reinterpret_cast<const float2*>(rQ + 8 * LK + kk * 8);
        const float2 og = *reinterpret_cast<const float2*>(rO + kk * 8);
        const float2 og8 =
            *reinterpret_cast<const float2*>(rO + 8 * LK + kk * 8);
        const Frag<4> aq = split<4>({qg.x, qg8.x, qg.y, qg8.y});
        const Frag<4> ao = split<4>({og.x, og8.x, og.y, og8.y});
#pragma unroll
        for (int j = 0; j < NT1; ++j) {
          const int n = (cpart * NT1 + j) * 8 + g;
          const float2 k2 = *reinterpret_cast<const float2*>(
              cK + n * LDC + kk * 8 + 2 * t);
          const float2 v2 = *reinterpret_cast<const float2*>(
              cV + n * LDC + kk * 8 + 2 * t);
          mma3(s_c[j], aq, split<2>({k2.x, k2.y}), kk == 0);
          mma3(d_c[j], ao, split<2>({v2.x, v2.y}), kk == 0);
        }
      }
#pragma unroll
      for (int j = 0; j < NT1; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] += s_c[j][e];
          dp[j][e] += d_c[j][e];
        }
    }

    // dS of the warp's tile into sS (every warp read it last in the
    // previous key block's pass 2, before the syncs above).
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = r0 + g + 8 * (e / 2);
        const int kc = (cpart * NT1 + j) * 8 + 2 * t + e % 2;
        const int key = k0 + kc;
        float x = s[j][e] * scale;
        if (key >= Sk || (causal && q0 + qr + q_offset < key)) x = NEG_INF;
        const float pv = expf(x - row_lse[e / 2]);
        sS[qr * LDS + kc] = pv * (dp[j][e] - row_delta[e / 2]) * scale;
      }

    // Pass 2: dQ += dS K, KS2 8-key steps a piece, on the warp's head_dim
    // columns cpart * D / CP + 8n. A piece's sums stay in the tensor cores
    // (tq), then are added to acc.
#pragma unroll 1
    for (int pc = 0; pc < P2; ++pc, ++p) {
      next_piece(p);
      const float* cK = sSlot + (p & 1) * DQ_SLOT;
      float tq[NT2][4];
#pragma unroll
      for (int ks = 0; ks < KS2; ++ks) {
        const float* aS = sS + (r0 + g) * LDS + pc * R2Q + ks * 8 + t;
        const Frag<4> as =
            split<4>({aS[0], aS[8 * LDS], aS[4], aS[8 * LDS + 4]});
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          const int col = cpart * (D / CP) + n * 8 + g;
          const float* bK = cK + (ks * 8 + t) * LK + col;
          mma3(tq[n], as, split<2>({bK[0], bK[4 * LK]}), ks == 0);
          if (ks == KS2 - 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += tq[n][e];
          }
        }
      }
    }
  }

  // Write the block's dQ rows (rows past Sq never).
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = q0 + r0 + g + 8 * half;
    if (pos >= Sq) continue;
    const int64_t base = (static_cast<int64_t>(b) * Sq + pos) * H * D +
                         static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NT2; ++n) {
      const int col = cpart * (D / CP) + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(dq + base + col) =
          make_float2(acc[n][2 * half], acc[n][2 * half + 1]);
    }
  }
}

// -------------------------------------------------------------- forward
//
// _fwd_kernel's function for f32: S = Q K^T, the online softmax over key
// blocks, O += P V, then O / l and lse = m + log l; every product 3xTF32
// (Q, K, V and the computed P split alike) with short tensor-core sums,
// as above. Bound by tensor-core operations: 3 x 4 D FLOPs per visible
// pair and head at 494.7 TFLOP/s. The dQ's design without dP: one CTA per
// (query block, head, batch), heaviest causal blocks first, QB = 64
// queries at D = 128 and 32 at 256-512, whose Q stays in shared memory;
// key blocks of 64 keys in order, causal blocks past the CTA's last real
// row skipped. Per key block:
//   * pass 1: S = Q K^T over D / 128 pieces, each two 64-column chunks of
//     the block's K (the room of the dQ's K and V chunk); warp w owns
//     query row block w % (QB / 16) and key part w / (QB / 16), as in the
//     dQ; each chunk's products are summed in the tensor cores from zero
//     and added to S in registers;
//   * the online softmax in registers and f32: keys past Sk and causal
//     keys score -1e30; each warp's part of a row's max goes through sRed
//     (one __syncthreads), so every warp of a row block takes the same new
//     max m; O, in registers, is multiplied by exp(m_old - m) before the
//     block's P V is added (never a tensor-core partial); each thread
//     keeps its part of the row sum l, rescaled alike; P = exp(S - m) into
//     sP [query][key] (row stride 4 mod 32);
//   * pass 2: O += P V over pieces of R2 key rows by all of head_dim (the
//     dQ's pass 2 with V for K: keys the reduced index, V N-major, P the
//     split A operand); warp w owns the row block and head_dim part w /
//     (QB / 16) of O, each piece's sums started from zero.
// At the end the parts of l are summed over the quad and, through sRed,
// over the key parts in a fixed order (a sum of 0 guarded as 1); O / l and
// lse are written for rows below Sq only. No query row of the domain is
// fully masked (causal keys are a prefix that holds key 0, q_offset >= 0),
// so a real row's max is finite from the first block on and masked keys
// get exp(-1e30 - m) = 0, as in the plain version. Budgets: Q, 2 slots of
// 2 x 64 x 72 floats, sP and sRed: 149,504 bytes at D = 512, 126,464 at
// 128. Registers: O QB x D / 256 (32 at 128 and 256, 48 at 384, 64 at
// 512) and as many tensor-core sums in pass 2.
template <int D>
constexpr int FWD_SMEM = 4 * (DQ_QB<D> * LDK<D> + 2 * DQ_SLOT +
                              DQ_QB<D> * LDS + 128);

static_assert(FWD_SMEM<128> <= 232448 && FWD_SMEM<256> <= 232448 &&
                  FWD_SMEM<384> <= 232448 && FWD_SMEM<512> <= 232448,
              "shared memory over the 227 KB a block can use");

template <int D>
__global__ void __launch_bounds__(NT, 1) flash_fwd_f32tc_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, float* __restrict__ out,
    float* __restrict__ lse, int H, int Hkv, int Sq, int Sk, int q_sb,
    int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb, int v_ss,
    int v_sh, int causal, int q_offset, float scale) {
  constexpr int QB = DQ_QB<D>, LK = LDK<D>, R2Q = DQ_R2<D>;
  constexpr int RB = QB / 16, CP = 8 / RB;  // row blocks, column parts
  constexpr int NT1 = DQ_KB / CP / 8;       // pass 1: key n-tiles a warp
  constexpr int NT2 = D / CP / 8;           // pass 2: head_dim n-tiles a warp
  constexpr int P1 = D / (2 * C), P2 = DQ_KB / R2Q;  // pieces of the passes
  constexpr int KS2 = R2Q / 8;              // k-steps of a pass-2 piece
  static_assert(CP * QB == 128, "sRed holds CP x QB floats");
  extern __shared__ __align__(16) float smem[];
  float* sQ = smem;                         // [QB][LK]
  float* sSlot = sQ + QB * LK;              // 2 slots of DQ_SLOT
  float* sP = sSlot + 2 * DQ_SLOT;          // P [query][key]
  float* sRed = sP + QB * LDS;              // [CP][QB]: a part's max, sum

  const int nqb = cdiv(Sq, QB);
  const int hb = gridDim.x / nqb;           // H * B
  const int blk = static_cast<int>(blockIdx.x);
  const int q0 = (nqb - 1 - blk / hb) * QB, h = blk % hb % H;
  const int b = blk % hb / H, hk = h / (H / Hkv);
  int nkb = cdiv(Sk, DQ_KB);
  if (causal)
    nkb = min(nkb, (min(q0 + QB, Sq) - 1 + q_offset) / DQ_KB + 1);
  const float* qp = q + static_cast<int64_t>(b) * q_sb +
                    static_cast<int64_t>(h) * q_sh;
  const float* kp = k + static_cast<int64_t>(b) * k_sb +
                    static_cast<int64_t>(hk) * k_sh;
  const float* vp = v + static_cast<int64_t>(b) * v_sb +
                    static_cast<int64_t>(hk) * v_sh;
  const int total = nkb * (P1 + P2);

  // Issue the copies of piece p into slot p % 2 (and, first, Q): piece
  // j < P1 of a key block is head_dim chunks 2j and 2j + 1 of its K, piece
  // P1 + r its V rows R2Q r .. R2Q (r + 1) - 1.
  auto issue = [&](int p) {
    const int k0 = p / (P1 + P2) * DQ_KB, j = p % (P1 + P2);
    float* slot = sSlot + (p & 1) * DQ_SLOT;
    if (p == 0) load_rows<QB, D>(sQ, LK, qp, q_ss, q0, Sq);
    if (j < P1) {
      load_rows<DQ_KB, C>(slot, LDC, kp + 2 * j * C, k_ss, k0, Sk);
      load_rows<DQ_KB, C>(slot + DQ_KB * LDC, LDC, kp + (2 * j + 1) * C,
                          k_ss, k0, Sk);
    } else {
      load_rows<R2Q, D>(slot, LK, vp, v_ss, k0 + (j - P1) * R2Q, Sk);
    }
    cp_async_commit();
  };
  auto next_piece = [&](int p) {
    cp_async_wait_all();
    __syncthreads();
    if (p + 1 < total) issue(p + 1);
  };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int r0 = warp % RB * 16;            // the warp's 16 queries
  const int cpart = warp / RB;              // its key part / head_dim part

  float acc[NT2][4];
#pragma unroll
  for (int n = 0; n < NT2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.0f;
  // Rows g and g + 8: the running max and this thread's part of the sum.
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.0f, 0.0f};

  if (total > 0) issue(0);
  int p = 0;
  for (int kb = 0; kb < nkb; ++kb) {
    const int k0 = kb * DQ_KB;
    // Pass 1: S = Q K^T over the chunks. The warp's keys are n-tiles
    // cpart * NT1 + j; a chunk's sums stay in the tensor cores (s_c), then
    // are added to s.
    float s[NT1][4];
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll 1
    for (int c = 0; c < P1; ++c, ++p) {
      next_piece(p);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const float* cK = sSlot + (p & 1) * DQ_SLOT + half * DQ_KB * LDC;
        const float* rQ = sQ + (r0 + g) * LK + (2 * c + half) * C + 2 * t;
        float s_c[NT1][4];
#pragma unroll
        for (int kk = 0; kk < C / 8; ++kk) {
          // Rows g and g + 8 of the warp's queries.
          const float2 qg = *reinterpret_cast<const float2*>(rQ + kk * 8);
          const float2 qg8 =
              *reinterpret_cast<const float2*>(rQ + 8 * LK + kk * 8);
          const Frag<4> aq = split<4>({qg.x, qg8.x, qg.y, qg8.y});
#pragma unroll
          for (int j = 0; j < NT1; ++j) {
            const int n = (cpart * NT1 + j) * 8 + g;
            const float2 k2 = *reinterpret_cast<const float2*>(
                cK + n * LDC + kk * 8 + 2 * t);
            mma3(s_c[j], aq, split<2>({k2.x, k2.y}), kk == 0);
          }
        }
#pragma unroll
        for (int j = 0; j < NT1; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] += s_c[j][e];
      }
    }

    // Scale and mask; the warp's part of each row's max, over the quad,
    // into sRed (every warp read sRed last before the syncs of pass 1).
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = r0 + g + 8 * (e / 2);
        const int key = k0 + (cpart * NT1 + j) * 8 + 2 * t + e % 2;
        float x = s[j][e] * scale;
        if (key >= Sk || (causal && q0 + qr + q_offset < key)) x = NEG_INF;
        s[j][e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      if (t == 0) sRed[cpart * QB + r0 + g + 8 * r] = mx[r];
    }
    __syncthreads();
    // The new max of each row over every key part; O and l rescaled to
    // it; P = exp(S - m) into sP (every warp read it last in the previous
    // key block's pass 2, before the syncs of pass 1).
    float corr[2], psum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mn = m[r];
#pragma unroll
      for (int c = 0; c < CP; ++c)
        mn = fmaxf(mn, sRed[c * QB + r0 + g + 8 * r]);
      corr[r] = expf(m[r] - mn);
      m[r] = mn;
    }
#pragma unroll
    for (int j = 0; j < NT1; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qr = r0 + g + 8 * (e / 2);
        const int kc = (cpart * NT1 + j) * 8 + 2 * t + e % 2;
        const float pv = expf(s[j][e] - m[e / 2]);
        psum[e / 2] += pv;
        sP[qr * LDS + kc] = pv;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + psum[r];
#pragma unroll
    for (int n = 0; n < NT2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] *= corr[e / 2];

    // Pass 2: O += P V, KS2 8-key steps a piece, on the warp's head_dim
    // columns cpart * D / CP + 8n. A piece's sums stay in the tensor cores
    // (to), then are added to acc.
#pragma unroll 1
    for (int pc = 0; pc < P2; ++pc, ++p) {
      next_piece(p);
      const float* cV = sSlot + (p & 1) * DQ_SLOT;
      float to[NT2][4];
#pragma unroll
      for (int ks = 0; ks < KS2; ++ks) {
        const float* aP = sP + (r0 + g) * LDS + pc * R2Q + ks * 8 + t;
        const Frag<4> ap =
            split<4>({aP[0], aP[8 * LDS], aP[4], aP[8 * LDS + 4]});
#pragma unroll
        for (int n = 0; n < NT2; ++n) {
          const int col = cpart * (D / CP) + n * 8 + g;
          const float* bV = cV + (ks * 8 + t) * LK + col;
          mma3(to[n], ap, split<2>({bV[0], bV[4 * LK]}), ks == 0);
          if (ks == KS2 - 1) {
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[n][e] += to[n][e];
          }
        }
      }
    }
  }

  // The row sums: over the quad, then over the key parts in a fixed order
  // through sRed (after every thread has read its maxes).
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __syncthreads();
  if (t == 0) {
#pragma unroll
    for (int r = 0; r < 2; ++r) sRed[cpart * QB + r0 + g + 8 * r] = l[r];
  }
  __syncthreads();

  // O / l (l == 0 guarded as 1) and lse; rows past Sq never stored.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int pos = q0 + r0 + g + 8 * half;
    float sum = 0.0f;
#pragma unroll
    for (int c = 0; c < CP; ++c) sum += sRed[c * QB + r0 + g + 8 * half];
    const float safe = sum == 0.0f ? 1.0f : sum;
    const float inv = 1.0f / safe;
    if (pos >= Sq) continue;
    if (cpart == 0 && t == 0)
      lse[(static_cast<int64_t>(b) * H + h) * Sq + pos] = m[half] + logf(safe);
    const int64_t base = (static_cast<int64_t>(b) * Sq + pos) * H * D +
                         static_cast<int64_t>(h) * D;
#pragma unroll
    for (int n = 0; n < NT2; ++n) {
      const int col = cpart * (D / CP) + n * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + base + col) =
          make_float2(acc[n][2 * half] * inv, acc[n][2 * half + 1] * inv);
    }
  }
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* out,
               float* lse, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
               int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
               int v_ss, int v_sh, int causal, int q_offset, float scale,
               cudaStream_t stream) {
  cudaFuncSetAttribute(flash_fwd_f32tc_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       FWD_SMEM<D>);
  flash_fwd_f32tc_kernel<D>
      <<<cdiv(Sq, DQ_QB<D>) * H * B, NT, FWD_SMEM<D>, stream>>>(
          q, k, v, out, lse, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss,
          k_sh, v_sb, v_ss, v_sh, causal, q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              float* dq, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
              int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
              int v_ss, int v_sh, int do_sb, int do_ss, int do_sh, int causal,
              int q_offset, float scale, cudaStream_t stream) {
  cudaFuncSetAttribute(flash_dq_f32tc_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       DQ_SMEM<D>);
  flash_dq_f32tc_kernel<D>
      <<<cdiv(Sq, DQ_QB<D>) * H * B, NT, DQ_SMEM<D>, stream>>>(
          q, k, v, dout, lse, delta, dq, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh,
          k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, causal,
          q_offset, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               float* dk, float* dv, int B, int H, int Hkv, int Sq, int Sk,
               int q_sb, int q_ss, int q_sh, int k_sb, int k_ss, int k_sh,
               int v_sb, int v_ss, int v_sh, int do_sb, int do_ss, int do_sh,
               int causal, int q_offset, float scale, cudaStream_t stream) {
  cudaFuncSetAttribute(flash_dkv_f32tc_kernel<D>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM<D>);
  const int npair = cdiv(cdiv(Sk, BKV<D>), 2);
  flash_dkv_f32tc_kernel<D><<<npair * Hkv * B, NT, SMEM<D>, stream>>>(
      q, k, v, dout, lse, delta, dk, dv, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh,
      k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, causal,
      q_offset, scale);
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

int flash_fwd_f32tc(const void* q, const void* k, const void* v, void* out,
                    void* lse, int B, int H, int Hkv, int Sq, int Sk,
                    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
                    int k_sh, int v_sb, int v_ss, int v_sh, int causal,
                    int q_offset, float scale, int dtype, int head_dim,
                    void* stream) {
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
  F32TC_CASES(launch_fwd,
              ((const float*)q, (const float*)k, (const float*)v,
               (float*)out, (float*)lse, B, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, causal, q_offset, scale,
               (cudaStream_t)stream))
}

int flash_dq_f32tc(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   void* dq, int B, int H, int Hkv, int Sq, int Sk, int q_sb,
                   int q_ss, int q_sh, int k_sb, int k_ss, int k_sh, int v_sb,
                   int v_ss, int v_sh, int do_sb, int do_ss, int do_sh,
                   int causal, int q_offset, float scale, int dtype,
                   int head_dim, void* stream) {
  if (dtype != DT_F32) return (int)cudaErrorInvalidValue;
  F32TC_CASES(launch_dq,
              ((const float*)q, (const float*)k, (const float*)v,
               (const float*)dout, (const float*)lse, (const float*)delta,
               (float*)dq, B, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh, k_sb, k_ss,
               k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, causal, q_offset,
               scale, (cudaStream_t)stream))
}

// workspace and splits are the wgmma dK/dV's (flash_attention.cu); this
// kernel takes 1 split and no workspace.
int flash_dkv_f32tc(const void* q, const void* k, const void* v,
                    const void* dout, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int H, int Hkv, int Sq, int Sk,
                    int q_sb, int q_ss, int q_sh, int k_sb, int k_ss,
                    int k_sh, int v_sb, int v_ss, int v_sh, int do_sb,
                    int do_ss, int do_sh, void* workspace, int splits,
                    int causal, int q_offset, float scale, int dtype,
                    int head_dim, void* stream) {
  if (dtype != DT_F32 || splits != 1) return (int)cudaErrorInvalidValue;
  F32TC_CASES(launch_dkv,
              ((const float*)q, (const float*)k, (const float*)v,
               (const float*)dout, (const float*)lse, (const float*)delta,
               (float*)dk, (float*)dv, B, H, Hkv, Sq, Sk, q_sb, q_ss, q_sh,
               k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh,
               causal, q_offset, scale, (cudaStream_t)stream))
}

}  // extern "C"
