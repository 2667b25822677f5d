// Flash attention at head dim 256 on seq-major bf16 operands [b, s, h*256]:
// the forward, and the backward as a dK/dV and a dQ kernel, on mma.sync.
// flash_attention.cu instantiates them as ff_flash_fwd_d256_kernel,
// ff_flash_bwd_dkv_d256_kernel and ff_flash_bwd_dq_d256_kernel (its delta
// at d=256 runs delta_body<256>).
//
// Replaces, at d=256, the Pallas kernels _fwd_kernel_b (:674, via _fwd_bshf
// :938), _delta_kernel (:1203, via _delta_bshf :1222) and
// _bwd_fused_kernel_b (:976, via _bwd_bshf_fused :1250) of
// flexflow_tpu/kernels/flash_attention.py, which the JAX package runs for
// BERT's heads of 256 (hidden 768 over 12 heads with kdim = 3072 / 12).
//
// What bounds them on an H100. At BERT-base's attention (b=64, h=12, s=512,
// d=256) the forward does 4*b*h*s^2*d = 2.06e11 flops on 805 MB of q, k, v
// and o: 0.208 ms at 989 TFLOP/s against 0.240 ms of bytes, near the ridge;
// the backward's 10*b*h*s^2*d = 5.15e11 flops are bound by operations
// (0.521 ms).
//
// Why not the Hopper mainloops of flash_fwd_sm90.cuh / flash_bwd_sm90.cuh.
// At D=256 their register and shared-memory budgets break: the forward's
// O alone is 128 f32 registers a thread beside S, and Q (64 KB) plus one
// K/V stage of 128 rows (128 KB) leaves no second stage; the dK/dV
// mainloop would hold 64 rows x 256 columns of both dK and dV a warpgroup,
// 256 f32 registers a thread. So this is a simpler body, right first:
// - Products on mma.sync m16n8k16 (bf16 in, f32 accumulate), a warp a
//   16-row slice. Operands are read from shared memory by ldmatrix: A and
//   the B operands that run along d (K in S = Q K^T, V in dP = dO V^T) by
//   ldmatrix.x4, one instruction a 16x16 A fragment or two 8-column B
//   fragments; the B operands that run along the sequence (V in O += P V,
//   K in dQ += dS K, Q and dO in dK += dS^T Q and dV += P^T dO) by
//   ldmatrix.x4.trans.
// - Shared rows padded to 264 elements (528 bytes, 132 words): the eight
//   rows a fragment load or an ldmatrix phase touches fall on distinct
//   banks.
// - Tiles of 64 rows by cp.async (16 bytes a thread). The forward commits
//   K and V as two groups, so that the next K tile loads under the softmax
//   and P V of this one, and the next V under the next S. The backward
//   kernels keep two stages of the tiles they stream (dQ: K and V; dK/dV:
//   Q, dO and their lse and delta), the next tile loading under this
//   one's products.
// - Registers: S, P and the accumulators stay in registers; P and dS are
//   rounded to bf16 straight into A fragments. The forward holds O (128
//   f32) and S for 64 keys (32); dQ holds dQ (128) and S and dP for 32 keys
//   at a time (16 + 16); dK/dV splits the 256 columns of dK and dV between
//   two groups of four warps (64 + 64 f32 each), each group recomputing S^T
//   and dP^T over the full d for its 16 keys, 32 queries at a time (1.5x
//   the backward's flops).
// - No atomics and no split over keys: every output is written by one
//   thread, so results repeat bitwise.
// What holds it back: shared-memory reads. Each warp owns 16 rows, so the
// B operand of every product is read from shared memory once a warp (four
// or eight times a tile); in the dK/dV kernel, S^T and dP^T are read for
// both column halves. At 128 bytes a clock a SM that is about as long as
// the products take on mma.sync. A warpgroup's wgmma reads B once for 64
// rows, which is the redesign this body leaves to a later change.
// Causal: the tiles a row block reaches stop at the diagonal tile, and
// masked entries get p = 0 (key position > query position). s is a
// multiple of 64, so no tile is ragged.

#pragma once

#include "flash_fwd_sm90.cuh"  // smem_u32, pack_bf16, LOG2E

namespace {

constexpr int D256 = 256;
constexpr int D256_TILE = 64;          // rows of every tile (query or key)
constexpr int D256_LD = D256 + 8;      // padded shared row, elements
constexpr int D256_TILE_ELEMS = D256_TILE * D256_LD;
constexpr int D256_TILE_BYTES = D256_TILE_ELEMS * 2;  // 33,792
constexpr int D256_FWD_THREADS = 128;  // 4 warps x 16 query rows
constexpr int D256_DQ_THREADS = 128;   // 4 warps x 16 query rows
constexpr int D256_DKV_THREADS = 256;  // 2 column halves x 4 warps x 16 key rows
constexpr size_t D256_FWD_SMEM = 3 * (size_t)D256_TILE_BYTES;   // Q, K, V
constexpr size_t D256_DQ_SMEM = 6 * (size_t)D256_TILE_BYTES;  // Q, dO, two stages of K, V
// K, V, two stages of Q, dO, lse and delta
constexpr size_t D256_DKV_SMEM = 6 * (size_t)D256_TILE_BYTES + 2 * 2 * D256_TILE * 4;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ void cp_async16(bf16* dst, const bf16* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 64 rows of one head (row 0 at g, rows ld apart) into a padded shared tile.
__device__ __forceinline__ void load_tile_d256(bf16* tile, const bf16* g, int ld, int nthreads) {
  for (int c = threadIdx.x; c < D256_TILE * (D256 / 8); c += nthreads) {
    const int r = c / (D256 / 8), col = (c % (D256 / 8)) * 8;
    cp_async16(tile + r * D256_LD + col, g + (size_t)r * ld + col);
  }
}

// c += a b on mma.sync m16n8k16, bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma16816(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory in one instruction: lanes
// 8i..8i+7 give the row addresses of matrix i, and r[i] is each lane's
// pair of it in the mma fragment layout (row lane/4, columns 2*(lane%4)).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const bf16* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// acc[n][*] += A(rows [r0, r0+16) of `a_tile`) . B^T, B being rows
// [n0, n0 + 8*NT) of `b_tile`, over the full d: the product of two
// row-major tiles along d (S = Q K^T, dP = dO V^T, and their transposes).
// The A fragment of each 16-column step is one ldmatrix.x4 (its four
// 8x8 quarters), the B fragments of two n-tiles another.
template <int NT>
__device__ __forceinline__ void gemm_rows_d(float (*acc)[4], const bf16* a_tile, int r0,
                                            const bf16* b_tile, int n0) {
  static_assert(NT % 2 == 0, "two n-tiles per ldmatrix.x4");
  const int lane = threadIdx.x % 32;
  const bf16* a_row = a_tile + (r0 + (lane & 15)) * D256_LD + (lane >> 4) * 8;
  const bf16* b_row = b_tile + (n0 + (lane & 7) + (lane >> 4) * 8) * D256_LD + ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int k0 = 0; k0 < D256; k0 += 16) {
    uint32_t a[4];
    ldmatrix_x4(a, a_row + k0);
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, b_row + n * 8 * D256_LD + k0);
      mma16816(acc[n], a, b[0], b[1]);
      mma16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

// The A fragment of 16 rows x 16 columns (columns 16*kc of a score tile)
// from the score fragment `s` (C layout), rounded to bf16.
__device__ __forceinline__ void scores_to_a(uint32_t* a, const float (*s)[4], int kc) {
  a[0] = pack_bf16(s[2 * kc][0], s[2 * kc][1]);
  a[1] = pack_bf16(s[2 * kc][2], s[2 * kc][3]);
  a[2] = pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]);
  a[3] = pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3]);
}

// acc[n][*] += P . B where P is the score fragment `p` over KC*16 columns
// (C layout) and B is rows [k0, k0 + 16*KC) x columns [c0, c0 + 8*NT) of
// a padded row-major shared tile, read by ldmatrix.trans.
template <int KC, int NT>
__device__ __forceinline__ void gemm_scores_tile(float (*acc)[4], const float (*p)[4],
                                                 const bf16* b_tile, int k0, int c0) {
  static_assert(NT % 2 == 0, "two n-tiles per ldmatrix.x4");
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    uint32_t a[4];
    scores_to_a(a, p, kc);
    const bf16* row = b_tile + (k0 + kc * 16 + (lane & 15)) * D256_LD + c0 + (lane >> 4) * 8;
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t b[4];
      asm volatile(
          "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
          : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
          : "r"(smem_u32(row + n * 8)));
      mma16816(acc[n], a, b[0], b[1]);
      mma16816(acc[n + 1], a, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (*acc)[4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}

// Store a warp's 16 rows x 8*NT columns (C layout, times `scale`) as bf16
// to rows [r0, r0 + 16), columns [c0, ...) of `out` (rows ld apart).
template <int NT>
__device__ __forceinline__ void store_rows(bf16* out, int ld, int r0, int c0,
                                           const float (*acc)[4], float scale) {
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  bf16* p = out + (size_t)(r0 + g) * ld + c0 + 2 * t;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    *reinterpret_cast<uint32_t*>(p + n * 8) = pack_bf16(acc[n][0] * scale, acc[n][1] * scale);
    *reinterpret_cast<uint32_t*>(p + (size_t)8 * ld + n * 8) =
        pack_bf16(acc[n][2] * scale, acc[n][3] * scale);
  }
}

// -- forward ------------------------------------------------------------------

// o and lse of 64 query rows of one (batch, head). Grid (S/64, H, B),
// D256_FWD_THREADS threads, D256_FWD_SMEM bytes.
__device__ __forceinline__ void fwd_d256_body(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v, bf16* __restrict__ o,
                                              float* __restrict__ lse, Layout l, int S, int H,
                                              int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sk = sq + D256_TILE_ELEMS;
  bf16* sv = sk + D256_TILE_ELEMS;
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t base = head_base<D256>(l, b, h);
  const int q0 = qt * D256_TILE, r0 = warp * 16;
  const int tiles = causal ? qt + 1 : S / D256_TILE;
  const float sl2 = scale * LOG2E;

  load_tile_d256(sq, q + base + (size_t)q0 * l.ld, l.ld, D256_FWD_THREADS);
  load_tile_d256(sk, k + base, l.ld, D256_FWD_THREADS);
  cp_async_commit();
  load_tile_d256(sv, v + base, l.ld, D256_FWD_THREADS);
  cp_async_commit();

  float acc[D256 / 8][4];
  zero<D256 / 8>(acc);
  float m[2] = {NEG_INF, NEG_INF}, rs[2] = {0.f, 0.f};  // rows g and g + 8

  for (int j = 0; j < tiles; ++j) {
    cp_async_wait<1>();  // Q and K_j
    __syncthreads();
    float s[D256_TILE / 8][4];
    zero<D256_TILE / 8>(s);
    gemm_rows_d<D256_TILE / 8>(s, sq, r0, sk, 0);
    __syncthreads();  // every warp is done with K_j
    if (j + 1 < tiles) load_tile_d256(sk, k + base + (size_t)(j + 1) * D256_TILE * l.ld, l.ld,
                                      D256_FWD_THREADS);
    cp_async_commit();

    // online softmax in base 2 on rows g (i = 0) and g + 8 (i = 1)
    const bool diag = causal && j == qt;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int qrow = r0 + g + 8 * i;  // within the tile; the key tile is aligned with it
      float mx = m[i];
#pragma unroll
      for (int n = 0; n < D256_TILE / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float x = s[n][2 * i + e] * sl2;
          if (diag && n * 8 + 2 * t + e > qrow) x = NEG_INF;
          s[n][2 * i + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float corr = exp2f(m[i] - mx);
      m[i] = mx;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < D256_TILE / 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2f(s[n][2 * i + e] - mx);
          s[n][2 * i + e] = p;
          sum += p;
        }
      rs[i] = rs[i] * corr + sum;
#pragma unroll
      for (int n = 0; n < D256 / 8; ++n) {
        acc[n][2 * i] *= corr;
        acc[n][2 * i + 1] *= corr;
      }
    }

    cp_async_wait<1>();  // V_j
    __syncthreads();
    gemm_scores_tile<D256_TILE / 16, D256 / 8>(acc, s, sv, 0, 0);
    __syncthreads();  // every warp is done with V_j
    if (j + 1 < tiles) load_tile_d256(sv, v + base + (size_t)(j + 1) * D256_TILE * l.ld, l.ld,
                                      D256_FWD_THREADS);
    cp_async_commit();
  }
  cp_async_wait<0>();

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float sum = rs[i];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    inv[i] = 1.f / sum;
    if (t == 0)
      lse[((size_t)b * H + h) * S + q0 + r0 + g + 8 * i] = (m[i] + log2f(sum)) * LN2;
  }
#pragma unroll
  for (int n = 0; n < D256 / 8; ++n) {
    acc[n][0] *= inv[0];
    acc[n][1] *= inv[0];
    acc[n][2] *= inv[1];
    acc[n][3] *= inv[1];
  }
  store_rows<D256 / 8>(o + base + (size_t)q0 * l.ld, l.ld, r0, 0, acc, 1.f);
}

// -- backward -----------------------------------------------------------------

// dQ of 64 query rows of one (batch, head), streaming the key tiles they
// reach, 32 keys at a time. Grid (S/64, H, B), D256_DQ_THREADS threads,
// D256_DQ_SMEM bytes.
__device__ __forceinline__ void dq_d256_body(const bf16* __restrict__ q,
                                             const bf16* __restrict__ k,
                                             const bf16* __restrict__ v,
                                             const bf16* __restrict__ dout,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             bf16* __restrict__ dq, Layout l, int S, int H,
                                             int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);
  bf16* sdo = sq + D256_TILE_ELEMS;
  bf16* skv = sdo + D256_TILE_ELEMS;  // stage st: K at skv + 2*st tiles, V after it
  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const size_t base = head_base<D256>(l, b, h);
  const int q0 = qt * D256_TILE, r0 = warp * 16;
  const int tiles = causal ? qt + 1 : S / D256_TILE;
  const float sl2 = scale * LOG2E;
  auto load_kv = [&](int j, int st) {
    bf16* sk = skv + 2 * st * D256_TILE_ELEMS;
    load_tile_d256(sk, k + base + (size_t)j * D256_TILE * l.ld, l.ld, D256_DQ_THREADS);
    load_tile_d256(sk + D256_TILE_ELEMS, v + base + (size_t)j * D256_TILE * l.ld, l.ld,
                   D256_DQ_THREADS);
  };

  load_tile_d256(sq, q + base + (size_t)q0 * l.ld, l.ld, D256_DQ_THREADS);
  load_tile_d256(sdo, dout + base + (size_t)q0 * l.ld, l.ld, D256_DQ_THREADS);
  load_kv(0, 0);
  cp_async_commit();

  float lse2[2], dl[2];  // rows g and g + 8: lse in base 2, delta
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t row = ((size_t)b * H + h) * S + q0 + r0 + g + 8 * i;
    lse2[i] = lse[row] * LOG2E;
    dl[i] = delta[row];
  }

  float acc[D256 / 8][4];
  zero<D256 / 8>(acc);
  constexpr int SUB = 32;  // keys a pass
  for (int j = 0; j < tiles; ++j) {
    // the next K/V tile loads into the other stage under this one's products
    if (j + 1 < tiles) load_kv(j + 1, (j + 1) & 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage j & 1
    __syncthreads();
    const bf16* sk = skv + 2 * (j & 1) * D256_TILE_ELEMS;
    const bf16* sv = sk + D256_TILE_ELEMS;
    const bool diag = causal && j == qt;
#pragma unroll 1
    for (int c0 = 0; c0 < D256_TILE; c0 += SUB) {
      float s[SUB / 8][4], dp[SUB / 8][4];
      zero<SUB / 8>(s);
      zero<SUB / 8>(dp);
      gemm_rows_d<SUB / 8>(s, sq, r0, sk, c0);
      gemm_rows_d<SUB / 8>(dp, sdo, r0, sv, c0);
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e / 2, key = c0 + n * 8 + 2 * t + e % 2;
          float p = exp2f(s[n][e] * sl2 - lse2[i]);
          if (diag && key > r0 + g + 8 * i) p = 0.f;
          s[n][e] = p * (dp[n][e] - dl[i]);  // dS
        }
      gemm_scores_tile<SUB / 16, D256 / 8>(acc, s, sk, c0, 0);
    }
    __syncthreads();  // every warp is done with stage j & 1 before it is refilled
  }
  cp_async_wait<0>();
  store_rows<D256 / 8>(dq + base + (size_t)q0 * l.ld, l.ld, r0, 0, acc, scale);
}

// dK and dV of 64 key rows of one (batch, head), streaming the query tiles
// that reach them, 32 queries at a time. Warps 0-3 own columns [0, 128) of
// dK and dV, warps 4-7 columns [128, 256), each warp 16 key rows. Grid
// (S/64, H, B), D256_DKV_THREADS threads, D256_DKV_SMEM bytes.
__device__ __forceinline__ void dkv_d256_body(const bf16* __restrict__ q,
                                              const bf16* __restrict__ k,
                                              const bf16* __restrict__ v,
                                              const bf16* __restrict__ dout,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                                              Layout l, int S, int H, int causal, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);
  bf16* sv = sk + D256_TILE_ELEMS;
  bf16* sqdo = sv + D256_TILE_ELEMS;  // stage st: Q at sqdo + 2*st tiles, dO after it
  float* srows = reinterpret_cast<float*>(sqdo + 4 * D256_TILE_ELEMS);  // stage st: lse2, delta
  const int kt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, t = lane % 4, g = lane / 4;
  const int r0 = (warp % 4) * 16, half = warp / 4;
  constexpr int HALF = D256 / 2;
  const size_t base = head_base<D256>(l, b, h);
  const size_t rows = ((size_t)b * H + h) * S;
  const int k0 = kt * D256_TILE;
  const int first = causal ? kt : 0, tiles = S / D256_TILE;
  const float sl2 = scale * LOG2E;

  // query tile i into stage st: Q and dO by cp.async, lse (base 2) and
  // delta by plain stores that the next block barrier publishes
  auto load_q = [&](int i, int st) {
    const int q0 = i * D256_TILE;
    bf16* sq = sqdo + 2 * st * D256_TILE_ELEMS;
    load_tile_d256(sq, q + base + (size_t)q0 * l.ld, l.ld, D256_DKV_THREADS);
    load_tile_d256(sq + D256_TILE_ELEMS, dout + base + (size_t)q0 * l.ld, l.ld,
                   D256_DKV_THREADS);
    if (threadIdx.x < D256_TILE) {
      srows[2 * st * D256_TILE + threadIdx.x] = lse[rows + q0 + threadIdx.x] * LOG2E;
      srows[(2 * st + 1) * D256_TILE + threadIdx.x] = delta[rows + q0 + threadIdx.x];
    }
  };

  load_tile_d256(sk, k + base + (size_t)k0 * l.ld, l.ld, D256_DKV_THREADS);
  load_tile_d256(sv, v + base + (size_t)k0 * l.ld, l.ld, D256_DKV_THREADS);
  load_q(first, 0);
  cp_async_commit();

  float dk_acc[HALF / 8][4], dv_acc[HALF / 8][4];
  zero<HALF / 8>(dk_acc);
  zero<HALF / 8>(dv_acc);
  constexpr int SUB = 32;  // queries a pass
  for (int i = first; i < tiles; ++i) {
    const int st = (i - first) & 1;
    // the next query tile loads into the other stage under this one's products
    if (i + 1 < tiles) load_q(i + 1, st ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // stage st
    __syncthreads();
    const bf16* sq = sqdo + 2 * st * D256_TILE_ELEMS;
    const bf16* sdo = sq + D256_TILE_ELEMS;
    const float* slse = srows + 2 * st * D256_TILE;
    const float* sdl = slse + D256_TILE;
    const bool diag = causal && i == kt;
#pragma unroll 1
    for (int c0 = 0; c0 < D256_TILE; c0 += SUB) {
      float s[SUB / 8][4], dp[SUB / 8][4];  // S^T and dP^T: rows keys, columns queries
      zero<SUB / 8>(s);
      zero<SUB / 8>(dp);
      gemm_rows_d<SUB / 8>(s, sk, r0, sq, c0);
      gemm_rows_d<SUB / 8>(dp, sv, r0, sdo, c0);
#pragma unroll
      for (int n = 0; n < SUB / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + n * 8 + 2 * t + e % 2, key = r0 + g + 8 * (e / 2);
          float p = exp2f(s[n][e] * sl2 - slse[col]);
          if (diag && key > col) p = 0.f;
          s[n][e] = p;
          dp[n][e] = p * (dp[n][e] - sdl[col]);  // dS^T
        }
      gemm_scores_tile<SUB / 16, HALF / 8>(dv_acc, s, sdo, c0, half * HALF);
      gemm_scores_tile<SUB / 16, HALF / 8>(dk_acc, dp, sq, c0, half * HALF);
    }
    __syncthreads();  // every warp is done with stage st before it is refilled
  }
  cp_async_wait<0>();
  store_rows<HALF / 8>(dk + base + (size_t)k0 * l.ld, l.ld, r0, half * HALF, dk_acc, scale);
  store_rows<HALF / 8>(dv + base + (size_t)k0 * l.ld, l.ld, r0, half * HALF, dv_acc, 1.f);
}

}  // namespace
