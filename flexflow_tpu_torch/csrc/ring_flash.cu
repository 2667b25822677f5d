// One ring step of flash attention for Hopper (sm_90a): the forward, the dQ
// and the dK/dV of one query block against one streamed key/value block, at
// head dim 64 and 128.
//
// Replaces these Pallas kernels of flexflow_tpu/kernels/ring_flash.py:
//   ff_ring_fwd_step[_d64]_kernel  <- _ring_fwd_step_kernel (via _ring_fwd_step)
//   ff_ring_dq_step[_d64]_kernel   <- _ring_dq_step_kernel  (via _ring_dq_step)
//   ff_ring_dkv_step[_d64]_kernel  <- _ring_dkv_step_kernel (via _ring_dkv_step)
//
// A rank of the ring holds the query block of global rows [q_off, q_off + S)
// and, at each step, the key/value block of global rows [k_off, k_off + T)
// that has travelled to it. The forward carries the online-softmax state
// (acc [b, h, S, d], m and l [b, h, S], all f32) from step to step and
// updates it in place; the backward adds this step's dQ into the rank's f32
// dq [b, h, S, d], and this step's dK, dV into the f32 accumulators
// [b, h, T, d] that travel with the key/value block. The causal mask uses
// global positions (q_off + row >= k_off + col).
//
// What bounds them on an H100. The forward step does 4*b*h*d products per
// unmasked (row, col) pair and moves q, k and v (bf16) plus its f32 state,
// 2 x 4 bytes x b*h*S*(d+2) in and out; at the long-context shape (b=4, h=8,
// S=T=8192, d=128, causal) that is 5.5e11 flops on ~0.47 GB, so it is bound
// by the tensor cores (~0.56 ms at 989 TFLOP/s). The backward pair does 14
// s*t*d flops per (b, h) over the unmasked pairs, as the split backward of
// flash_attention.cu does (6 in dQ, 8 in dK/dV), and is bound the same way.
//
// Forward design. fwd_step_body is the Hopper mainloop of flash_fwd_sm90.cuh
// (the one flash_attention.cu's forward runs) with the ring epilogue: each
// block owns 128 query rows as two 64-row consumer warpgroups, which read
// their rows' carried (acc, m, l) into registers, run S = Q K^T and
// O += P V on wgmma over K/V tiles that one producer thread brings by TMA
// into a ring of stages, keep S, P and O in registers throughout (the wmma
// step it replaces kept the state, the scores and P in shared memory, walked
// the softmax row by row and loaded tiles synchronously), and write the
// state back once. The tensor maps read q, k and v by their strides, so the
// projection einsum's [b, s, h, d] view and a contiguous rotated block are
// both read in place. Each warpgroup's key loop stops at the last tile the
// causal mask lets its rows see, so a fully masked step costs no products; a
// block with nothing to see returns before touching memory, and a
// warpgroup whose rows see nothing leaves their state bitwise as it was.
//
// Backward design. Each block owns one 64-row tile of one (batch, head) and
// reads its tiles by stride through a Layout. The dQ and dK/dV kernels load
// their f32 accumulator rows into the wmma accumulators, add the step's
// products and store them back; the k-tile loop stops at the last tile the
// causal mask lets the q tile see (q tiles start at the first tile that sees
// the k tile in dK/dV). One block owns each row, so there are no atomics
// and results repeat bitwise. Masked entries get p = 0 outright, so a row
// that sees no key in a step keeps its state whatever tiles are visited. lse
// and m are in natural log.

#include "flash_fwd_sm90.cuh"

namespace {

// k tiles of a T-row key block that rows [q_off + q0, q_off + q0 + BM) may
// attend under the causal mask: ceil((q_off + q0 + BM - k_off) / BN),
// clamped to [0, T / BN].
__device__ __forceinline__ int causal_k_tiles(int q_off, int q0, int k_off, int T) {
  const int cols = q_off + q0 + BM - k_off;
  return cols <= 0 ? 0 : min((cols + BN - 1) / BN, T / BN);
}

// The first q tile of an S-row query block whose rows reach key row
// k_off + k0 under the causal mask, clamped to [0, S / BM].
__device__ __forceinline__ int causal_first_q_tile(int q_off, int k_off, int k0, int S) {
  const int first = k_off + k0 - q_off;
  return first <= 0 ? 0 : min(first / BM, S / BM);
}

// Forward step: (acc, m, l) of the block's rows updated in place with the
// keys of this block: the Hopper forward mainloop of flash_fwd_sm90.cuh with
// the ring epilogue. Grid fwd_grid(S, H, B).
template <int D>
__device__ __forceinline__ void fwd_step_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                              const CUtensorMap* tv, float* __restrict__ acc,
                                              float* __restrict__ m, float* __restrict__ l, int S,
                                              int T, int H, int q_off, int k_off, int causal,
                                              float scale) {
  fwd_mainloop<D>(tq, tk, tv, RingEpilogue<D>{acc, m, l},
                  FwdShape{S, T, H, q_off, k_off, causal, scale});
}

// dQ step: dq[rows] += scale * dS K over this block's keys, dS = P * (dP -
// delta) with P rebuilt from lse. Grid (S/BM, h, b).
template <int D>
__device__ __forceinline__ void dq_step_body(
    const bf16* __restrict__ q, Layout lq, const bf16* __restrict__ k, Layout lk,
    const bf16* __restrict__ v, Layout lv, const bf16* __restrict__ dout, Layout lo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int S, int T, int H, int q_off, int k_off, int causal, float scale) {
  typedef Tiles<D> Ti;
  constexpr int LDH = Ti::LDH;
  const int q0 = blockIdx.x * BM, hi = blockIdx.y, bi = blockIdx.z;
  const int nk = causal ? causal_k_tiles(q_off, q0, k_off, T) : T / BN;
  if (nk == 0) return;

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + Ti::H);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * Ti::H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * Ti::H);
  float* sS = reinterpret_cast<float*>(smem + 4 * Ti::H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * Ti::H + TILE_S);
  float* sLse = reinterpret_cast<float*>(smem + 4 * Ti::H + TILE_S + TILE_P);
  float* sDelta = sLse + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's q rows
  const size_t rows = ((size_t)bi * H + hi) * S + q0;

  load_tile<D>(sQ, q + head_base<D>(lq, bi, hi) + (size_t)q0 * lq.ld, lq.ld);
  load_tile<D>(sdO, dout + head_base<D>(lo, bi, hi) + (size_t)q0 * lo.ld, lo.ld);
  load_rows(sLse, lse + rows);
  load_rows(sDelta, delta + rows);
  float* dq_rows = dq + (rows + r0) * D;
  FragC dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::load_matrix_sync(dq_acc[j], dq_rows + j * 16, D, wmma::mem_row_major);
  const size_t kbase = head_base<D>(lk, bi, hi), vbase = head_base<D>(lv, bi, hi);

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<D>(sK, k + kbase + (size_t)k0 * lk.ld, lk.ld);
    load_tile<D>(sV, v + vbase + (size_t)k0 * lv.ld, lv.ld);
    __syncthreads();

    gemm_abt<D>(sS + r0 * LDS, sQ + r0 * LDH, sK);  // S = Q K^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const float ls = sLse[r];
      const int qi = q_off + q0 + r;
      for (int c = lane; c < BN; c += 32) {
        const bool ok = !causal || k_off + k0 + c <= qi;
        sP[r * LDP + c] = __float2bfloat16(ok ? __expf(sS[r * LDS + c] * scale - ls) : 0.f);
      }
    }
    __syncwarp();
    gemm_abt<D>(sS + r0 * LDS, sdO + r0 * LDH, sV);  // dP = dO V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const float dl = sDelta[r];
      for (int c = lane; c < BN; c += 32) {
        const float p = __bfloat162float(sP[r * LDP + c]);
        sP[r * LDP + c] = __float2bfloat16(p * (sS[r * LDS + c] - dl) * scale);  // dS, in place
      }
    }
    __syncwarp();
    gemm_acc<D>(dq_acc, sP + r0 * LDP, sK);  // dQ += dS K
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j)
    wmma::store_matrix_sync(dq_rows + j * 16, dq_acc[j], D, wmma::mem_row_major);
}

// dK/dV step: dk[rows] += scale * dS^T Q and dv[rows] += P^T dO over the
// query tiles that see this k tile. Grid (T/BN, h, b); works on transposed
// scores ST[k, q] = K Q^T.
template <int D>
__device__ __forceinline__ void dkv_step_body(
    const bf16* __restrict__ q, Layout lq, const bf16* __restrict__ k, Layout lk,
    const bf16* __restrict__ v, Layout lv, const bf16* __restrict__ dout, Layout lo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int S, int T, int H, int q_off, int k_off, int causal, float scale) {
  typedef Tiles<D> Ti;
  constexpr int LDH = Ti::LDH;
  const int k0 = blockIdx.x * BN, hi = blockIdx.y, bi = blockIdx.z;
  const int qt0 = causal ? causal_first_q_tile(q_off, k_off, k0, S) : 0;
  if (qt0 == S / BM) return;  // no query of the block sees this k tile

  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + Ti::H);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * Ti::H);
  bf16* sdO = reinterpret_cast<bf16*>(smem + 3 * Ti::H);
  float* sS = reinterpret_cast<float*>(smem + 4 * Ti::H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * Ti::H + TILE_S);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * Ti::H + TILE_S + TILE_P);
  float* sLse = reinterpret_cast<float*>(smem + 4 * Ti::H + TILE_S + 2 * TILE_P);
  float* sDelta = sLse + BM;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's k rows
  const size_t qbase = head_base<D>(lq, bi, hi), obase = head_base<D>(lo, bi, hi);
  const size_t qrows = ((size_t)bi * H + hi) * S;

  load_tile<D>(sK, k + head_base<D>(lk, bi, hi) + (size_t)k0 * lk.ld, lk.ld);
  load_tile<D>(sV, v + head_base<D>(lv, bi, hi) + (size_t)k0 * lv.ld, lv.ld);
  const size_t krow = ((size_t)bi * H + hi) * T + k0 + r0;
  float* dk_rows = dk + krow * D;
  float* dv_rows = dv + krow * D;
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::load_matrix_sync(dk_acc[j], dk_rows + j * 16, D, wmma::mem_row_major);
    wmma::load_matrix_sync(dv_acc[j], dv_rows + j * 16, D, wmma::mem_row_major);
  }

  for (int qt = qt0; qt < S / BM; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_tile<D>(sQ, q + qbase + (size_t)q0 * lq.ld, lq.ld);
    load_tile<D>(sdO, dout + obase + (size_t)q0 * lo.ld, lo.ld);
    load_rows(sLse, lse + qrows + q0);
    load_rows(sDelta, delta + qrows + q0);
    __syncthreads();

    gemm_abt<D>(sS + r0 * LDS, sK + r0 * LDH, sQ);  // ST = K Q^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const int kj = k_off + k0 + r;
      for (int c = lane; c < BM; c += 32) {
        const bool ok = !causal || kj <= q_off + q0 + c;
        sP[r * LDP + c] = __float2bfloat16(ok ? __expf(sS[r * LDS + c] * scale - sLse[c]) : 0.f);
      }
    }
    __syncwarp();
    gemm_abt<D>(sS + r0 * LDS, sV + r0 * LDH, sdO);  // dPT = V dO^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      for (int c = lane; c < BM; c += 32) {
        const float p = __bfloat162float(sP[r * LDP + c]);
        sdS[r * LDP + c] = __float2bfloat16(p * (sS[r * LDS + c] - sDelta[c]) * scale);
      }
    }
    __syncwarp();
    gemm_acc<D>(dv_acc, sP + r0 * LDP, sdO);  // dV += PT dO
    gemm_acc<D>(dk_acc, sdS + r0 * LDP, sQ);  // dK += dST Q
  }

#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::store_matrix_sync(dk_rows + j * 16, dk_acc[j], D, wmma::mem_row_major);
    wmma::store_matrix_sync(dv_rows + j * 16, dv_acc[j], D, wmma::mem_row_major);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// Kernels, one per head dim.
// ---------------------------------------------------------------------------

#define RING_FWD_KERNEL(NAME, D)                                                              \
  extern "C" __global__ void __launch_bounds__(FWD_THREADS, 1) NAME(                          \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,         \
      const __grid_constant__ CUtensorMap tv, float* __restrict__ acc, float* __restrict__ m, \
      float* __restrict__ l, int S, int T, int H, int q_off, int k_off, int causal,           \
      float scale) {                                                                          \
    fwd_step_body<D>(&tq, &tk, &tv, acc, m, l, S, T, H, q_off, k_off, causal, scale);         \
  }

#define RING_DQ_KERNEL(NAME, D)                                                                \
  extern "C" __global__ void __launch_bounds__(NTHREADS) NAME(                                 \
      const bf16* __restrict__ q, Layout lq, const bf16* __restrict__ k, Layout lk,            \
      const bf16* __restrict__ v, Layout lv, const bf16* __restrict__ dout, Layout lo,         \
      const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,  \
      int S, int T, int H, int q_off, int k_off, int causal, float scale) {                    \
    dq_step_body<D>(q, lq, k, lk, v, lv, dout, lo, lse, delta, dq, S, T, H, q_off, k_off,      \
                    causal, scale);                                                            \
  }

#define RING_DKV_KERNEL(NAME, D)                                                               \
  extern "C" __global__ void __launch_bounds__(NTHREADS) NAME(                                 \
      const bf16* __restrict__ q, Layout lq, const bf16* __restrict__ k, Layout lk,            \
      const bf16* __restrict__ v, Layout lv, const bf16* __restrict__ dout, Layout lo,         \
      const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,  \
      float* __restrict__ dv, int S, int T, int H, int q_off, int k_off, int causal,           \
      float scale) {                                                                           \
    dkv_step_body<D>(q, lq, k, lk, v, lv, dout, lo, lse, delta, dk, dv, S, T, H, q_off, k_off, \
                     causal, scale);                                                           \
  }

RING_FWD_KERNEL(ff_ring_fwd_step_kernel, 128)
RING_FWD_KERNEL(ff_ring_fwd_step_d64_kernel, 64)
RING_DQ_KERNEL(ff_ring_dq_step_kernel, 128)
RING_DQ_KERNEL(ff_ring_dq_step_d64_kernel, 64)
RING_DKV_KERNEL(ff_ring_dkv_step_kernel, 128)
RING_DKV_KERNEL(ff_ring_dkv_step_d64_kernel, 64)

// ---------------------------------------------------------------------------
// C interface (ctypes). q, k, v and dout are per-head bf16 [B, H, rows, d]
// operands, each given by its row, head and batch strides in elements (unit
// stride along d): q and dout have S rows, k and v T rows. acc, dq, dk and dv
// are contiguous f32 [B, H, rows, d]; m, l, lse and delta contiguous f32
// [B, H, S]. d is 64 or 128, S and T are multiples of 64, and q_off, k_off
// are the global positions of the blocks' first rows. The caller checks all
// of this, including 16-byte alignment of every row and 32-byte alignment of
// the f32 accumulators (the wmma loads and stores of their rows).
// ---------------------------------------------------------------------------

#define PER_HEAD(D, NAME) per_head<D>(NAME##_ld, NAME##_head, NAME##_batch)

template <int D, typename K>
static int ring_fwd(K kernel, const void* q, Layout lq, const void* k, Layout lk, const void* v,
                    Layout lv, void* acc, void* m, void* l, int B, int S, int T, int H,
                    int q_off, int k_off, int causal, cudaStream_t s) {
  CUtensorMap maps[3];
  cudaError_t err = fwd_tensor_maps<D>(maps, q, lq, S, k, lk, v, lv, T, H, B);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kernel, FwdTiles<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_grid(S, H, B), FWD_THREADS, FwdTiles<D>::SMEM, s>>>(
      maps[0], maps[1], maps[2], (float*)acc, (float*)m, (float*)l, S, T, H, q_off, k_off, causal,
      softmax_scale<D>());
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_fwd_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                const void* k, int k_ld, int k_head, int k_batch, const void* v,
                                int v_ld, int v_head, int v_batch, void* acc, void* m, void* l,
                                int B, int S, int T, int H, int q_off, int k_off, int causal,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return ring_fwd<128>(ff_ring_fwd_step_kernel, q, PER_HEAD(128, q), k, PER_HEAD(128, k), v,
                         PER_HEAD(128, v), acc, m, l, B, S, T, H, q_off, k_off, causal, s);
  if (d == 64)
    return ring_fwd<64>(ff_ring_fwd_step_d64_kernel, q, PER_HEAD(64, q), k, PER_HEAD(64, k), v,
                        PER_HEAD(64, v), acc, m, l, B, S, T, H, q_off, k_off, causal, s);
  return (int)cudaErrorInvalidValue;
}

template <int D, typename K>
static int ring_dq(K kernel, const void* q, Layout lq, const void* k, Layout lk, const void* v,
                   Layout lv, const void* dout, Layout lo, const void* lse, const void* delta,
                   void* dq, int B, int S, int T, int H, int q_off, int k_off, int causal,
                   cudaStream_t s) {
  cudaError_t err = allow_smem(kernel, Tiles<D>::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(S / BM, H, B), NTHREADS, Tiles<D>::DQ_SMEM, s>>>(
      (const bf16*)q, lq, (const bf16*)k, lk, (const bf16*)v, lv, (const bf16*)dout, lo,
      (const float*)lse, (const float*)delta, (float*)dq, S, T, H, q_off, k_off, causal,
      softmax_scale<D>());
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_dq_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                               const void* k, int k_ld, int k_head, int k_batch, const void* v,
                               int v_ld, int v_head, int v_batch, const void* dout, int o_ld,
                               int o_head, int o_batch, const void* lse, const void* delta,
                               void* dq, int B, int S, int T, int H, int q_off, int k_off,
                               int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return ring_dq<128>(ff_ring_dq_step_kernel, q, PER_HEAD(128, q), k, PER_HEAD(128, k), v,
                        PER_HEAD(128, v), dout, PER_HEAD(128, o), lse, delta, dq, B, S, T, H,
                        q_off, k_off, causal, s);
  if (d == 64)
    return ring_dq<64>(ff_ring_dq_step_d64_kernel, q, PER_HEAD(64, q), k, PER_HEAD(64, k), v,
                       PER_HEAD(64, v), dout, PER_HEAD(64, o), lse, delta, dq, B, S, T, H,
                       q_off, k_off, causal, s);
  return (int)cudaErrorInvalidValue;
}

template <int D, typename K>
static int ring_dkv(K kernel, const void* q, Layout lq, const void* k, Layout lk, const void* v,
                    Layout lv, const void* dout, Layout lo, const void* lse, const void* delta,
                    void* dk, void* dv, int B, int S, int T, int H, int q_off, int k_off,
                    int causal, cudaStream_t s) {
  cudaError_t err = allow_smem(kernel, Tiles<D>::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(T / BN, H, B), NTHREADS, Tiles<D>::DKV_SMEM, s>>>(
      (const bf16*)q, lq, (const bf16*)k, lk, (const bf16*)v, lv, (const bf16*)dout, lo,
      (const float*)lse, (const float*)delta, (float*)dk, (float*)dv, S, T, H, q_off, k_off,
      causal, softmax_scale<D>());
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_dkv_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                const void* k, int k_ld, int k_head, int k_batch, const void* v,
                                int v_ld, int v_head, int v_batch, const void* dout, int o_ld,
                                int o_head, int o_batch, const void* lse, const void* delta,
                                void* dk, void* dv, int B, int S, int T, int H, int q_off,
                                int k_off, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return ring_dkv<128>(ff_ring_dkv_step_kernel, q, PER_HEAD(128, q), k, PER_HEAD(128, k), v,
                         PER_HEAD(128, v), dout, PER_HEAD(128, o), lse, delta, dk, dv, B, S, T,
                         H, q_off, k_off, causal, s);
  if (d == 64)
    return ring_dkv<64>(ff_ring_dkv_step_d64_kernel, q, PER_HEAD(64, q), k, PER_HEAD(64, k), v,
                        PER_HEAD(64, v), dout, PER_HEAD(64, o), lse, delta, dk, dv, B, S, T, H,
                        q_off, k_off, causal, s);
  return (int)cudaErrorInvalidValue;
}
