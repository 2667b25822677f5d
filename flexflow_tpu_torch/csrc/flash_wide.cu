// Flash attention and its ring steps for Hopper (sm_90a) at every head dim
// past 256 (d % 8 == 0, with no upper bound: the Pallas kernels' per-head
// and ring range). flash_attention.cu and ring_flash.cu take the head dims
// up to 256; this library takes the rest, through the wide mainloops of
// flash_wide_sm90.cuh (a block owns a chunk of 256 output columns and
// streams the head dim in 64-column panels; that header's note says why and
// what it costs) and the wide instance of delta_body (flash_delta.cuh).
//
// Replaces these Pallas kernels, past d = 256:
//   ff_flash_fwd[_bhsd]_wide_kernel       <- _fwd_kernel_b (via _fwd_bshf and
//                                           _fwd) and _fwd_kernel (the
//                                           online-softmax loop, s > block)
//   ff_flash_delta[_bhsd]_wide_kernel     <- _delta_kernel (via _delta_bshf and
//                                           _delta_rows)
//   ff_flash_bwd_dkv[_bhsd]_wide_kernel   <- _bwd_fused_kernel_b (via
//   ff_flash_bwd_dq[_bhsd]_wide_kernel       _bwd_bshf_fused and _bwd_rows_fused),
//                                           split in two, which also compute what
//                                           _bwd_onepass_kernel and
//                                           _bwd_dq_kernel/_bwd_dkv_kernel do for
//                                           s > block
//   ff_ring_fwd_step_wide_kernel          <- _ring_fwd_step_kernel
//   ff_ring_dq_step_wide_kernel           <- _ring_dq_step_kernel
//   ff_ring_dkv_step_wide_kernel          <- _ring_dkv_step_kernel
// of flexflow_tpu/kernels/flash_attention.py and ring_flash.py. The
// seq-major and per-head kernels of one kind run one body under two names,
// so that a profile keeps one row per entry.
//
// What bounds them on an H100. At d=512 the forward does 4*b*h*s^2*d flops
// on 4*b*s*h*d*2 bytes: at bench.py --heads 2's b=64, h=2, s=512 that is
// 6.9e10 flops on 268 MB, the ridge, bound by bytes (0.080 ms), as the
// flagship's d=128; the backward pair's 10*b*h*s^2*d (0.17 ms of products)
// against 470 MB (0.14 ms). The ring steps at 4x2x8192x512 causal are bound
// by operations. delta is a read of dO and O, bound by bytes.
//
// The ring forward step reads the carried (m, l) from one pair of buffers
// and writes them to another (the caller ping-pongs them): every column
// chunk's block rescales its acc columns by the old m, and one chunk's
// block may run after another has written the new one. acc, dq, dk and dv
// are updated in place, each element by one block.
//
// Each exported C function launches on the given stream and returns
// cudaGetLastError() (0 on success); a head dim that is not past 256 (or
// not a multiple of 8) returns cudaErrorInvalidValue.

#include "flash_delta.cuh"
#include "flash_wide_sm90.cuh"

#define WIDE_FWD_KERNEL(NAME)                                                              \
  extern "C" __global__ void __launch_bounds__(FWD_THREADS, 1) NAME(                       \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, Layout out,            \
      float* __restrict__ lse, int S, int H, int causal, float scale, int d, int per) {    \
    wide_fwd_mainloop(&tq, &tk, &tv, FlashEpilogue<WIDE_DC>{o, out, lse},                  \
                      FwdShape{S, S, H, 0, 0, causal, scale, d, per});                     \
  }

WIDE_FWD_KERNEL(ff_flash_fwd_wide_kernel)
WIDE_FWD_KERNEL(ff_flash_fwd_bhsd_wide_kernel)

#define WIDE_DELTA_KERNEL(NAME)                                                            \
  extern "C" __global__ void __launch_bounds__(DELTA_THREADS) NAME(                        \
      const bf16* __restrict__ dout, Layout od, const bf16* __restrict__ o, Layout ol,     \
      float* __restrict__ delta, int S, int H, int d) {                                    \
    delta_body<0>(dout, od, o, ol, delta, S, H, d);                                        \
  }

WIDE_DELTA_KERNEL(ff_flash_delta_wide_kernel)
WIDE_DELTA_KERNEL(ff_flash_delta_bhsd_wide_kernel)

#define WIDE_BWD_KERNELS(DKV, DQ)                                                          \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) DKV(                        \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,     \
      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk, \
      bf16* __restrict__ dv, Layout grad, int S, int H, int causal, float scale, int d,    \
      int per) {                                                                           \
    wide_dkv_mainloop(&tq, &tk, &tv, &tdo, lse, delta, FlashGradEpilogue<WIDE_DC>{dk, grad}, \
                      FlashGradEpilogue<WIDE_DC>{dv, grad},                                \
                      FwdShape{S, S, H, 0, 0, causal, scale, d, per});                     \
  }                                                                                        \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) DQ(                         \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,     \
      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, \
      Layout grad, int S, int H, int causal, float scale, int d, int per) {                \
    wide_dq_mainloop(&tq, &tk, &tv, &tdo, lse, delta, FlashGradEpilogue<WIDE_DC>{dq, grad}, \
                     FwdShape{S, S, H, 0, 0, causal, scale, d, per});                      \
  }

WIDE_BWD_KERNELS(ff_flash_bwd_dkv_wide_kernel, ff_flash_bwd_dq_wide_kernel)
WIDE_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_wide_kernel, ff_flash_bwd_dq_bhsd_wide_kernel)

extern "C" __global__ void __launch_bounds__(FWD_THREADS, 1) ff_ring_fwd_step_wide_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, float* __restrict__ acc,
    const float* __restrict__ m_in, const float* __restrict__ l_in, float* __restrict__ m_out,
    float* __restrict__ l_out, int S, int T, int H, int q_off, int k_off, int causal,
    float scale, int d) {
  wide_fwd_mainloop(&tq, &tk, &tv, RingWideEpilogue<WIDE_DC>{acc, m_in, l_in, m_out, l_out},
                    FwdShape{S, T, H, q_off, k_off, causal, scale, d, 1});
}

extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) ff_ring_dq_step_wide_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
    int S, int T, int H, int q_off, int k_off, int causal, float scale, int d) {
  wide_dq_mainloop(&tq, &tk, &tv, &tdo, lse, delta, RingGradEpilogue<WIDE_DC>{dq, S},
                   FwdShape{S, T, H, q_off, k_off, causal, scale, d, 1});
}

extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) ff_ring_dkv_step_wide_kernel(
    const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
    const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
    float* __restrict__ dv, int S, int T, int H, int q_off, int k_off, int causal, float scale,
    int d) {
  wide_dkv_mainloop(&tq, &tk, &tv, &tdo, lse, delta, RingGradEpilogue<WIDE_DC>{dk, T},
                    RingGradEpilogue<WIDE_DC>{dv, T},
                    FwdShape{S, T, H, q_off, k_off, causal, scale, d, 1});
}

// ---------------------------------------------------------------------------
// C interface (ctypes), the narrow libraries' signatures. lse, delta, m and
// l are contiguous [B, H, S] f32; acc and dq contiguous f32 [B, H, S, d], dk
// and dv [B, H, T, d]; S and T are multiples of 64. The seq-major entries
// take contiguous [B, S, H*d] bf16 operands; the _bhsd and ring entries
// per-head [B, H, rows, d] operands by their row, head and batch strides in
// elements (unit stride along d). The caller checks all of this, including
// 16-byte alignment of every row and 32-byte alignment of the f32 buffers.
// ---------------------------------------------------------------------------

#define PER_HEAD(NAME) per_head(NAME##_ld, NAME##_head, NAME##_batch)

typedef decltype(&ff_flash_fwd_wide_kernel) WideFwdKernel;
typedef decltype(&ff_flash_bwd_dkv_wide_kernel) WideDkvKernel;
typedef decltype(&ff_flash_bwd_dq_wide_kernel) WideDqKernel;
typedef decltype(&ff_flash_delta_wide_kernel) WideDeltaKernel;

static int wide_fwd(WideFwdKernel kernel, int d, const void* q, const void* k, const void* v,
                    Layout in, void* o, Layout out, void* lse, int B, int S, int H, int causal,
                    cudaStream_t stream) {
  if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!wide_fwd_tensor_maps(maps, d, q, in, S, k, in, v, in, S, H, B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(kernel, WideFwdTiles::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<wide_fwd_grid(S, H, B, d), FWD_THREADS, WideFwdTiles::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (bf16*)o, out, (float*)lse, S, H, causal, softmax_scale(d), d,
      in.per);
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_wide_fwd(int d, const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int S, int H, int causal, void* stream) {
  const Layout l = dense(d, S, H);
  return wide_fwd(ff_flash_fwd_wide_kernel, d, q, k, v, l, o, l, lse, B, S, H, causal,
                  (cudaStream_t)stream);
}

extern "C" int ff_flash_wide_fwd_bhsd(int d, const void* q, const void* k, const void* v, int ld,
                                      int head, int batch, void* o, int o_ld, int o_head,
                                      int o_batch, void* lse, int B, int S, int H, int causal,
                                      void* stream) {
  return wide_fwd(ff_flash_fwd_bhsd_wide_kernel, d, q, k, v, per_head(ld, head, batch), o,
                  per_head(o_ld, o_head, o_batch), lse, B, S, H, causal, (cudaStream_t)stream);
}

static int wide_delta(WideDeltaKernel kernel, int d, const void* dout, Layout od, const void* o,
                      Layout ol, void* delta, int B, int S, int H, cudaStream_t stream) {
  if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;
  kernel<<<delta_grid(B, S, H), DELTA_THREADS, 0, stream>>>((const bf16*)dout, od, (const bf16*)o,
                                                            ol, (float*)delta, S, H, d);
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_wide_delta(int d, const void* dout, const void* o, void* delta, int B,
                                   int S, int H, void* stream) {
  const Layout l = dense(d, S, H);
  return wide_delta(ff_flash_delta_wide_kernel, d, dout, l, o, l, delta, B, S, H,
                    (cudaStream_t)stream);
}

extern "C" int ff_flash_wide_delta_bhsd(int d, const void* dout, int ld, int head, int batch,
                                        const void* o, int o_ld, int o_head, int o_batch,
                                        void* delta, int B, int S, int H, void* stream) {
  return wide_delta(ff_flash_delta_bhsd_wide_kernel, d, dout, per_head(ld, head, batch), o,
                    per_head(o_ld, o_head, o_batch), delta, B, S, H, (cudaStream_t)stream);
}

// The backward pair: dK/dV, then dQ, on one stream.
static int wide_bwd(WideDkvKernel dkv, WideDqKernel dqk, int d, const void* q, const void* k,
                    const void* v, Layout in, const void* dout, Layout od, const void* lse,
                    const void* delta, void* dq, void* dk, void* dv, Layout grad, int B, int S,
                    int H, int causal, cudaStream_t s) {
  if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_tensor_maps(maps, d, q, in, k, in, v, in, dout, od, S, S, H, B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(dkv, WideBwdTiles::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dqk, WideBwdTiles::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid = wide_bwd_grid(S, H, B, d);
  const float scale = softmax_scale(d);
  dkv<<<grid, BWD_THREADS, WideBwdTiles::DKV_SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, grad, S, H, causal, scale, d, in.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<grid, BWD_THREADS, WideBwdTiles::DQ_SMEM, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dq, grad,
      S, H, causal, scale, d, in.per);
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_wide_bwd(int d, const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta, void* dq,
                                 void* dk, void* dv, int B, int S, int H, int causal,
                                 void* stream) {
  const Layout l = dense(d, S, H);
  return wide_bwd(ff_flash_bwd_dkv_wide_kernel, ff_flash_bwd_dq_wide_kernel, d, q, k, v, l, dout,
                  l, lse, delta, dq, dk, dv, l, B, S, H, causal, (cudaStream_t)stream);
}

extern "C" int ff_flash_wide_bwd_bhsd(int d, const void* q, const void* k, const void* v, int ld,
                                      int head, int batch, const void* dout, int o_ld,
                                      int o_head, int o_batch, const void* lse,
                                      const void* delta, void* dq, void* dk, void* dv, int g_ld,
                                      int g_head, int g_batch, int B, int S, int H, int causal,
                                      void* stream) {
  return wide_bwd(ff_flash_bwd_dkv_bhsd_wide_kernel, ff_flash_bwd_dq_bhsd_wide_kernel, d, q, k,
                  v, per_head(ld, head, batch), dout, per_head(o_ld, o_head, o_batch), lse, delta,
                  dq, dk, dv, per_head(g_ld, g_head, g_batch), B, S, H, causal,
                  (cudaStream_t)stream);
}

extern "C" int ff_ring_wide_fwd_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                     const void* k, int k_ld, int k_head, int k_batch,
                                     const void* v, int v_ld, int v_head, int v_batch, void* acc,
                                     const void* m_in, const void* l_in, void* m_out,
                                     void* l_out, int B, int S, int T, int H, int q_off,
                                     int k_off, int causal, void* stream) {
  if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  if (!wide_fwd_tensor_maps(maps, d, q, PER_HEAD(q), S, k, PER_HEAD(k), v, PER_HEAD(v), T, H, B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ff_ring_fwd_step_wide_kernel, WideFwdTiles::SMEM);
  if (err != cudaSuccess) return (int)err;
  ff_ring_fwd_step_wide_kernel<<<wide_fwd_grid(S, H, B, d), FWD_THREADS, WideFwdTiles::SMEM,
                                 (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], (float*)acc, (const float*)m_in, (const float*)l_in,
      (float*)m_out, (float*)l_out, S, T, H, q_off, k_off, causal, softmax_scale(d), d);
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_wide_dq_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                    const void* k, int k_ld, int k_head, int k_batch,
                                    const void* v, int v_ld, int v_head, int v_batch,
                                    const void* dout, int o_ld, int o_head, int o_batch,
                                    const void* lse, const void* delta, void* dq, int B, int S,
                                    int T, int H, int q_off, int k_off, int causal,
                                    void* stream) {
  if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_tensor_maps(maps, d, q, PER_HEAD(q), k, PER_HEAD(k), v, PER_HEAD(v), dout,
                       PER_HEAD(o), S, T, H, B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ff_ring_dq_step_wide_kernel, WideBwdTiles::DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  ff_ring_dq_step_wide_kernel<<<wide_bwd_grid(S, H, B, d), BWD_THREADS, WideBwdTiles::DQ_SMEM,
                                (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dq, S,
      T, H, q_off, k_off, causal, softmax_scale(d), d);
  return (int)cudaGetLastError();
}

extern "C" int ff_ring_wide_dkv_step(int d, const void* q, int q_ld, int q_head, int q_batch,
                                     const void* k, int k_ld, int k_head, int k_batch,
                                     const void* v, int v_ld, int v_head, int v_batch,
                                     const void* dout, int o_ld, int o_head, int o_batch,
                                     const void* lse, const void* delta, void* dk, void* dv,
                                     int B, int S, int T, int H, int q_off, int k_off,
                                     int causal, void* stream) {
  if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_tensor_maps(maps, d, q, PER_HEAD(q), k, PER_HEAD(k), v, PER_HEAD(v), dout,
                       PER_HEAD(o), S, T, H, B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem(ff_ring_dkv_step_wide_kernel, WideBwdTiles::DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  ff_ring_dkv_step_wide_kernel<<<wide_bwd_grid(T, H, B, d), BWD_THREADS,
                                 WideBwdTiles::DKV_SMEM, (cudaStream_t)stream>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (float*)dk,
      (float*)dv, S, T, H, q_off, k_off, causal, softmax_scale(d), d);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the wide kernels, for the build report: 0 the
// forward (flash and ring), 1 dK/dV, 2 dQ.
extern "C" int ff_wide_smem_bytes(int which) {
  switch (which) {
    case 0: return (int)WideFwdTiles::SMEM;
    case 1: return (int)WideBwdTiles::DKV_SMEM;
    case 2: return (int)WideBwdTiles::DQ_SMEM;
    default: return 0;
  }
}
