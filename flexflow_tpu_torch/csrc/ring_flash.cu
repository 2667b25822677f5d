// One ring step of flash attention for Hopper (sm_90a): the forward, the dQ
// and the dK/dV of one query block against one streamed key/value block, at
// every head dim d with d % 8 == 0 up to 256 (narrow_dim_ok; past it the
// wide step kernels of flash_wide.cu): each step kernel is instantiated at
// a padded width of 64 (the _d64 kernels), 128, 192 (_p192) and 256
// (_d256) and takes the real d at run time, as flash_attention.cu's
// kernels do.
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
// Design. Each step kernel is a Hopper mainloop with the ring's epilogue:
// the forward runs fwd_mainloop of flash_fwd_sm90.cuh, the dQ and dK/dV
// steps dq_mainloop and dkv_mainloop of flash_bwd_sm90.cuh (at padded
// widths past 128 the head-split dq_mainloop_split and dkv_mainloop_split),
// the same mainloops that flash_attention.cu's forward and backward run. A
// block owns 128 rows (64 in the head-split pair) of one (batch, head) as two 64-row consumer warpgroups on wgmma,
// with the scores, P, dP, dS and the accumulators in registers, and one
// producer thread streams the other side's tiles by TMA into a ring of
// mbarrier-guarded stages. The tensor maps read q, k, v and dout by their
// strides, so the projection einsum's [b, s, h, d] view and a contiguous
// rotated block are both read in place. The forward's ring epilogue reads
// the rows' carried (acc, m, l) into registers before the key loop and
// writes them back after it; the backward's starts its registers at 0 and
// after the loop adds them (dQ and dK times the softmax scale) into the
// carried f32 dq (S rows) or dk, dv (T rows), one block owning each row,
// so there are no atomics and results repeat bitwise. The mainloops mask by
// global positions and bound their loops per 64-row warpgroup: a fully
// masked step costs no products, a block with nothing to do returns before
// touching memory, and a warpgroup whose rows see no key (forward, dQ) or
// that no query reaches (dK/dV) leaves its rows' state and accumulators
// bitwise as they were. lse and m are in natural log.

#include "flash_bwd_sm90.cuh"

namespace {

// Forward step: (acc, m, l) of the block's rows updated in place with the
// keys of this block. Grid fwd_grid(S, H, B).
template <int D>
__device__ __forceinline__ void fwd_step_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                              const CUtensorMap* tv, float* __restrict__ acc,
                                              float* __restrict__ m, float* __restrict__ l, int S,
                                              int T, int H, int q_off, int k_off, int causal,
                                              float scale, int d) {
  fwd_mainloop<D>(tq, tk, tv, RingEpilogue<D>{acc, m, l},
                  FwdShape{S, T, H, q_off, k_off, causal, scale, d, 1});
}

// dQ step: dq[rows] += scale * dS K over this block's keys, dS = P * (dP -
// delta) with P rebuilt from lse. Grid bwd_grid_of<D>(S, H, B).
template <int D>
__device__ __forceinline__ void dq_step_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const CUtensorMap* tdo,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta,
                                             float* __restrict__ dq, int S, int T, int H,
                                             int q_off, int k_off, int causal, float scale,
                                             int d) {
  const FwdShape sh{S, T, H, q_off, k_off, causal, scale, d, 1};
  if constexpr (D > 128)
    dq_mainloop_split<D>(tq, tk, tv, tdo, lse, delta, RingGradEpilogue<D>{dq, S}, sh);
  else
    dq_mainloop<D>(tq, tk, tv, tdo, lse, delta, RingGradEpilogue<D>{dq, S}, sh);
}

// dK/dV step: dk[rows] += scale * dS^T Q and dv[rows] += P^T dO over the
// query tiles that reach this block's keys. Grid bwd_grid_of<D>(T, H, B).
template <int D>
__device__ __forceinline__ void dkv_step_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                              const CUtensorMap* tv, const CUtensorMap* tdo,
                                              const float* __restrict__ lse,
                                              const float* __restrict__ delta,
                                              float* __restrict__ dk, float* __restrict__ dv,
                                              int S, int T, int H, int q_off, int k_off,
                                              int causal, float scale, int d) {
  const FwdShape sh{S, T, H, q_off, k_off, causal, scale, d, 1};
  if constexpr (D > 128)
    dkv_mainloop_split<D>(tq, tk, tv, tdo, lse, delta, RingGradEpilogue<D>{dk, T},
                          RingGradEpilogue<D>{dv, T}, sh);
  else
    dkv_mainloop<D>(tq, tk, tv, tdo, lse, delta, RingGradEpilogue<D>{dk, T},
                    RingGradEpilogue<D>{dv, T}, sh);
}

}  // namespace

// ---------------------------------------------------------------------------
// Kernels, one per padded width.
// ---------------------------------------------------------------------------

#define RING_FWD_KERNEL(NAME, D)                                                              \
  extern "C" __global__ void __launch_bounds__(FWD_THREADS, 1) NAME(                          \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,         \
      const __grid_constant__ CUtensorMap tv, float* __restrict__ acc, float* __restrict__ m, \
      float* __restrict__ l, int S, int T, int H, int q_off, int k_off, int causal,           \
      float scale, int d) {                                                                   \
    fwd_step_body<D>(&tq, &tk, &tv, acc, m, l, S, T, H, q_off, k_off, causal, scale, d);      \
  }

#define RING_DQ_KERNEL(NAME, D)                                                               \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) NAME(                          \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,         \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,        \
      const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq, \
      int S, int T, int H, int q_off, int k_off, int causal, float scale, int d) {            \
    dq_step_body<D>(&tq, &tk, &tv, &tdo, lse, delta, dq, S, T, H, q_off, k_off, causal,       \
                    scale, d);                                                                \
  }

#define RING_DKV_KERNEL(NAME, D)                                                              \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) NAME(                          \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,         \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,        \
      const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk, \
      float* __restrict__ dv, int S, int T, int H, int q_off, int k_off, int causal,          \
      float scale, int d) {                                                                   \
    dkv_step_body<D>(&tq, &tk, &tv, &tdo, lse, delta, dk, dv, S, T, H, q_off, k_off, causal,  \
                     scale, d);                                                               \
  }

RING_FWD_KERNEL(ff_ring_fwd_step_kernel, 128)
RING_FWD_KERNEL(ff_ring_fwd_step_d64_kernel, 64)
RING_FWD_KERNEL(ff_ring_fwd_step_p192_kernel, 192)
RING_FWD_KERNEL(ff_ring_fwd_step_d256_kernel, 256)
RING_DQ_KERNEL(ff_ring_dq_step_kernel, 128)
RING_DQ_KERNEL(ff_ring_dq_step_d64_kernel, 64)
RING_DQ_KERNEL(ff_ring_dq_step_p192_kernel, 192)
RING_DQ_KERNEL(ff_ring_dq_step_d256_kernel, 256)
RING_DKV_KERNEL(ff_ring_dkv_step_kernel, 128)
RING_DKV_KERNEL(ff_ring_dkv_step_d64_kernel, 64)
RING_DKV_KERNEL(ff_ring_dkv_step_p192_kernel, 192)
RING_DKV_KERNEL(ff_ring_dkv_step_d256_kernel, 256)

// ---------------------------------------------------------------------------
// C interface (ctypes). q, k, v and dout are per-head bf16 [B, H, rows, d]
// operands, each given by its row, head and batch strides in elements (unit
// stride along d): q and dout have S rows, k and v T rows. acc, dq, dk and dv
// are contiguous f32 [B, H, rows, d]; m, l, lse and delta contiguous f32
// [B, H, S]. d % 8 == 0 with 8 <= d <= 256 (else cudaErrorInvalidValue), S
// and T are multiples of 64, and q_off, k_off are the global positions of
// the blocks' first rows. The caller checks all of this, including 16-byte
// alignment of every row (the TMA boxes) and 32-byte alignment of the f32
// buffers (the dK/dV step bulk-copies lse and delta in 64-row pieces, which
// needs 16).
// ---------------------------------------------------------------------------

#define PER_HEAD(NAME) per_head(NAME##_ld, NAME##_head, NAME##_batch)

// The step kernels of one kind share one signature whatever their width.
typedef decltype(&ff_ring_fwd_step_kernel) RingFwdKernel;
typedef decltype(&ff_ring_dq_step_kernel) RingDqKernel;
typedef decltype(&ff_ring_dkv_step_kernel) RingDkvKernel;

template <int D>
static int ring_fwd(RingFwdKernel kernel, int d, const void* q, Layout lq, const void* k,
                    Layout lk, const void* v, Layout lv, void* acc, void* m, void* l, int B, int S,
                    int T, int H, int q_off, int k_off, int causal, cudaStream_t s) {
  CUtensorMap maps[3];
  cudaError_t err = fwd_tensor_maps<D>(maps, d, q, lq, S, k, lk, v, lv, T, H, B);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kernel, FwdTiles<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_grid(S, H, B), FWD_THREADS, FwdTiles<D>::SMEM, s>>>(
      maps[0], maps[1], maps[2], (float*)acc, (float*)m, (float*)l, S, T, H, q_off, k_off, causal,
      softmax_scale(d), d);
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_fwd_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                const void* k, int k_ld, int k_head, int k_batch, const void* v,
                                int v_ld, int v_head, int v_batch, void* acc, void* m, void* l,
                                int B, int S, int T, int H, int q_off, int k_off, int causal,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!narrow_dim_ok(d)) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 64:
      return ring_fwd<64>(ff_ring_fwd_step_d64_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                          PER_HEAD(v), acc, m, l, B, S, T, H, q_off, k_off, causal, s);
    case 128:
      return ring_fwd<128>(ff_ring_fwd_step_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                           PER_HEAD(v), acc, m, l, B, S, T, H, q_off, k_off, causal, s);
    case 192:
      return ring_fwd<192>(ff_ring_fwd_step_p192_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                           PER_HEAD(v), acc, m, l, B, S, T, H, q_off, k_off, causal, s);
    default:
      return ring_fwd<256>(ff_ring_fwd_step_d256_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                           PER_HEAD(v), acc, m, l, B, S, T, H, q_off, k_off, causal, s);
  }
}

template <int D>
static int ring_dq(RingDqKernel kernel, int d, const void* q, Layout lq, const void* k, Layout lk,
                   const void* v, Layout lv, const void* dout, Layout lo, const void* lse,
                   const void* delta, void* dq, int B, int S, int T, int H, int q_off, int k_off,
                   int causal, cudaStream_t s) {
  CUtensorMap maps[4];
  if (!bwd_tensor_maps(maps, d, q, lq, k, lk, v, lv, dout, lo, S, T, H, B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<D>(false);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bwd_grid_of<D>(S, H, B), BWD_THREADS, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dq, S,
      T, H, q_off, k_off, causal, softmax_scale(d), d);
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_dq_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                               const void* k, int k_ld, int k_head, int k_batch, const void* v,
                               int v_ld, int v_head, int v_batch, const void* dout, int o_ld,
                               int o_head, int o_batch, const void* lse, const void* delta,
                               void* dq, int B, int S, int T, int H, int q_off, int k_off,
                               int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!narrow_dim_ok(d)) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 64:
      return ring_dq<64>(ff_ring_dq_step_d64_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                         PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dq, B, S, T, H, q_off, k_off,
                         causal, s);
    case 128:
      return ring_dq<128>(ff_ring_dq_step_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                          PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dq, B, S, T, H, q_off,
                          k_off, causal, s);
    case 192:
      return ring_dq<192>(ff_ring_dq_step_p192_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                          PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dq, B, S, T, H, q_off,
                          k_off, causal, s);
    default:
      return ring_dq<256>(ff_ring_dq_step_d256_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                          PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dq, B, S, T, H, q_off,
                          k_off, causal, s);
  }
}

template <int D>
static int ring_dkv(RingDkvKernel kernel, int d, const void* q, Layout lq, const void* k,
                    Layout lk, const void* v, Layout lv, const void* dout, Layout lo,
                    const void* lse, const void* delta, void* dk, void* dv, int B, int S, int T,
                    int H, int q_off, int k_off, int causal, cudaStream_t s) {
  CUtensorMap maps[4];
  if (!bwd_tensor_maps(maps, d, q, lq, k, lk, v, lv, dout, lo, S, T, H, B))
    return (int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem_bytes<D>(true);
  cudaError_t err = allow_smem(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<bwd_grid_of<D>(T, H, B), BWD_THREADS, smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, S, T, H, q_off, k_off, causal, softmax_scale(d), d);
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_dkv_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                const void* k, int k_ld, int k_head, int k_batch, const void* v,
                                int v_ld, int v_head, int v_batch, const void* dout, int o_ld,
                                int o_head, int o_batch, const void* lse, const void* delta,
                                void* dk, void* dv, int B, int S, int T, int H, int q_off,
                                int k_off, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (!narrow_dim_ok(d)) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 64:
      return ring_dkv<64>(ff_ring_dkv_step_d64_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                          PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dk, dv, B, S, T, H, q_off,
                          k_off, causal, s);
    case 128:
      return ring_dkv<128>(ff_ring_dkv_step_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                           PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dk, dv, B, S, T, H, q_off,
                           k_off, causal, s);
    case 192:
      return ring_dkv<192>(ff_ring_dkv_step_p192_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                           PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dk, dv, B, S, T, H, q_off,
                           k_off, causal, s);
    default:
      return ring_dkv<256>(ff_ring_dkv_step_d256_kernel, d, q, PER_HEAD(q), k, PER_HEAD(k), v,
                           PER_HEAD(v), dout, PER_HEAD(o), lse, delta, dk, dv, B, S, T, H, q_off,
                           k_off, causal, s);
  }
}
