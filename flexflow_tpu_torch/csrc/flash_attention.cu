// Flash attention on seq-major and per-head bf16 operands for Hopper
// (sm_90a), at every head dim d with d % 8 == 0 up to 256 (narrow_dim_ok).
// Each body is instantiated at a padded width of 64, 128, 192 or 256 and
// takes the real d at run time: the tensor maps load the columns past d as
// zeros and the epilogues store only those below it (flash_fwd_sm90.cuh's
// note). Head dims past 256 run the wide kernels of flash_wide.cu.
//
// Replaces these Pallas kernels of flexflow_tpu/kernels/flash_attention.py:
//   ff_flash_fwd_kernel          <- _fwd_kernel_b (via _fwd_bshf), single-k-block
//                                   and online-softmax paths alike
//   ff_flash_delta_kernel        <- _delta_kernel (via _delta_bshf)
//   ff_flash_bwd_dkv_kernel      <- _bwd_fused_kernel_b (via _bwd_bshf_fused),
//   ff_flash_bwd_dq_kernel          split in two; the same pair also computes
//                                   the tiled backwards of s > block
//                                   (_bwd_onepass_kernel, _bwd_dq_kernel and
//                                   _bwd_dkv_kernel via _bwd_bshf_onepass and
//                                   _bwd_bshf)
//   ff_flash_fwd_d64_kernel      <- _fwd_kernel_pair (via _fwd_bshf_pair and
//                                   _fwd_bshf_pair_qkv)
//   ff_flash_delta_d64_kernel    <- the delta that _bwd_pair_core computes inline
//                                   (:1105)
//   ff_flash_bwd_dkv_d64_kernel  <- _bwd_pair_core (via _bwd_fused_kernel_pair and
//   ff_flash_bwd_dq_d64_kernel      _bwd_fused_kernel_pair_qkv), split in two
//   ff_flash_fwd_bhsd[_d64]_kernel      <- _fwd_kernel_b and _fwd_kernel via _fwd (the
//                                          per-head [b*h, s, d] entry, batch-folded
//                                          or looped)
//   ff_flash_delta_bhsd[_d64]_kernel    <- _delta_kernel via _delta_rows
//   ff_flash_bwd_dkv_bhsd[_d64]_kernel  <- _bwd_fused_kernel_b via _bwd_rows_fused
//   ff_flash_bwd_dq_bhsd[_d64]_kernel      (s <= block) and _bwd_dq_kernel and
//                                          _bwd_dkv_kernel via _bwd (s > block)
//   ff_flash_fwd_d256_kernel     <- _fwd_kernel_b (via _fwd_bshf) at d=256
//   ff_flash_delta_d256_kernel   <- _delta_kernel (via _delta_bshf) at d=256
//   ff_flash_bwd_dkv_d256_kernel <- _bwd_fused_kernel_b (via _bwd_bshf_fused) at
//   ff_flash_bwd_dq_d256_kernel     d=256, split in two as at d=128
//   (the d=256 forward runs the forward mainloop at 64-key tiles, the d=256
//   backward the head-split mainloops of flash_bwd_sm90.cuh, whose note says
//   why d > 128 needs them; the delta runs delta_body)
// and at the other padded widths the same bodies under their own names, so
// that a profile keeps one row per entry and width: the seq-major
// ff_flash_{fwd,delta,bwd_dkv,bwd_dq}_{p64,p192}_kernel (d <= 64 off the
// head pair, and 128 < d <= 192) beside the d=128 and d=256 kernels, which
// take every d of their width; the per-head _bhsd_d64 (d <= 64), _bhsd
// (64 < d <= 128), _bhsd_p192 and _bhsd_d256 kernels.
//
// What bounds them on an H100. The forward does 4*b*h*s^2*d flops: at the
// flagship's b=64, s=512, h*d=1024 that is 6.9e10 on ~270 MB, the ridge,
// bound by bytes (0.080 ms); at the seq-2048 flagship's b=16, s=2048 it is
// 2.7e11 on the same bytes, bound by operations (0.278 ms). The backward
// pair's 14*b*h*s^2*d flops on ~470 MB lie near the ridge at s=512 and are
// bound by operations at s=2048; delta is a pure read of dO and O and is
// bound by bytes.
//
// Delta design (every delta kernel, rows 2 and 10 and row 7's delta):
// one body, delta_body, reads dO and O through their Layouts with 16-byte
// loads, several rows a thread in flight, a block a tile of (one b, 64
// consecutive s, up to 16 heads), and stores each head's run of sums
// contiguously into [b, h, s] from shared memory. Where the one-warp-a-row
// kernels it replaced made 4-byte loads, launched a block for every 8 rows
// and (bshf) scattered 4-byte stores S*4 bytes apart, it keeps enough bytes
// in flight to run at the card's memory rate. Its note has the details.
//
// Forward design (every _fwd kernel, rows 1, 6 and 9 of the port's
// kernel table at every width): fwd_body is the Hopper mainloop of
// flash_fwd_sm90.cuh with the flash epilogue. Where the shared-tile forward
// it replaced stored every score fragment to an f32 shared tile, walked
// the softmax one row at a time per warp, kept P and the f32 output tile in
// shared memory and loaded K/V synchronously between two block barriers, it
// runs S = Q K^T and O += P V on wgmma with S, P and O in registers, takes
// a row's max and sum from a thread-local pass and two quad shuffles, and
// streams K/V by TMA through a ring of stages that one producer thread
// keeps full while two 64-row consumer warpgroups compute. That header's note has the details.
//
// Backward design (the dK/dV and dQ kernels of rows 3-5, 7, 8, 11 and 12 of
// the port's kernel table at every width): dkv_body and dq_body are the two
// Hopper mainloops of flash_bwd_sm90.cuh with the flash epilogue (at widths
// 192 and 256 the head-split pair, which owns 64 rows a block). The TPU kernels
// hold the whole [s, s] f32 score tile of a (b, h) in VMEM; at s=512 that is
// 1 MB, far beyond the 227 KB of shared memory a block gets, so the
// backward is two kernels that both rebuild P from the saved lse: one that
// owns 128 key rows and streams the query tiles for dK/dV, one that owns
// 128 query rows and streams the key tiles for dQ. No atomics: every output
// element is written by one block, so results repeat bitwise. lse is kept
// in natural log. Where the shared-tile backward it replaced stored every score
// fragment to an f32 shared tile, walked the exp and dS passes one row at a
// time per warp, staged P, dS and the outputs through shared memory and
// loaded tiles synchronously between two block barriers, the new kernels
// run every product on wgmma with S, P, dP, dS and the accumulators in
// registers, compute the element-wise passes on each thread's own fragment,
// and stream tiles by TMA through mbarrier-guarded stages that one producer
// thread keeps full. That header's note has the details.
//
// Operand layout. Every operand is read through a Layout: head h of batch b
// starts at element b * batch + (h / per) * group + (h % per) * sub, and
// its rows lie ld elements apart. Only the d=64 head pair groups heads
// (per = 2, two heads to a 128-lane group); every other layout has one
// head to a group (per = 1, group = sub). The seq-major operands are
// contiguous [b, s, h*d] (ld = h*d, group = sub = d, batch = s*h*d). The
// pair's kernels read either separate q/k/v [b, s, h*64] (ld = h*64,
// group = 128, sub = 64) or the interleaved projection [b, s, 3*h*64] whose
// pair-group g holds [q_pair | k_pair | v_pair] in 384 lanes (q, k, v at
// +0, +128, +256; ld = 3*h*64, group = 384, sub = 64), and the backward
// writes dq/dk/dv into one dqkv of the same interleave. The per-head
// entries read [b, h, s, d] operands by their strides: contiguous ones have
// ld = d, sub = group = s*d, batch = h*s*d, and the per-head projection
// einsum's output (a [b, s, h, d] buffer viewed as [b, h, s, d]) has
// ld = h*d, sub = group = d, batch = s*h*d, the bshf numbers, so it is read
// in place. Every row starts at a multiple of 8 elements, so the
// TMA boxes stay aligned (the wrappers check it); the forward and the
// backward turn the Layout into 5-D tensor maps (fwd_tensor_map).
//
// The Layout lives in flash_tiles.cuh, the forward's mainloop in
// flash_fwd_sm90.cuh, the backward's in flash_bwd_sm90.cuh and delta_body in
// flash_delta.cuh (ring_flash.cu and flash_wide.cu share them). Each
// exported C function
// launches on the given stream and returns cudaGetLastError() (0 on
// success).

#include "flash_bwd_sm90.cuh"
#include "flash_delta.cuh"

namespace {

// o and lse[b, h, s] (natural log) of softmax(scale * q k^T) v: the Hopper
// forward mainloop of flash_fwd_sm90.cuh with the flash epilogue. Grid
// fwd_grid(S, H, B); q, k and v come as tensor maps, o goes out through `out`.
template <int D>
__device__ __forceinline__ void fwd_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, bf16* __restrict__ o, Layout out,
                                         float* __restrict__ lse, int S, int H, int causal,
                                         float scale, int d, int per) {
  fwd_mainloop<D>(tq, tk, tv, FlashEpilogue<D>{o, out, lse},
                  FwdShape{S, S, H, 0, 0, causal, scale, d, per});
}

// dK and dV of 128 key rows of one (batch, head), streaming the query
// tiles that reach them: the Hopper dK/dV mainloop of flash_bwd_sm90.cuh
// with the flash epilogue. Grid bwd_grid(S, H, B); q, k, v and dout come as
// tensor maps of 64-row boxes, dk and dv go out through `grad`.
template <int D>
__device__ __forceinline__ void dkv_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, const CUtensorMap* tdo,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ delta, bf16* __restrict__ dk,
                                         bf16* __restrict__ dv, Layout grad, int S, int H,
                                         int causal, float scale, int d, int per) {
  const FwdShape sh{S, S, H, 0, 0, causal, scale, d, per};
  if constexpr (D > 128)
    dkv_mainloop_split<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>{dk, grad},
                          FlashGradEpilogue<D>{dv, grad}, sh);
  else
    dkv_mainloop<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>{dk, grad},
                    FlashGradEpilogue<D>{dv, grad}, sh);
}

// dQ of 128 query rows, streaming the key tiles they reach: the Hopper dQ
// mainloop of flash_bwd_sm90.cuh with the flash epilogue. Grid
// bwd_grid(S, H, B).
template <int D>
__device__ __forceinline__ void dq_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                        const CUtensorMap* tv, const CUtensorMap* tdo,
                                        const float* __restrict__ lse,
                                        const float* __restrict__ delta, bf16* __restrict__ dq,
                                        Layout grad, int S, int H, int causal, float scale, int d,
                                        int per) {
  const FwdShape sh{S, S, H, 0, 0, causal, scale, d, per};
  if constexpr (D > 128)
    dq_mainloop_split<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>{dq, grad}, sh);
  else
    dq_mainloop<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>{dq, grad}, sh);
}

}  // namespace

// ---------------------------------------------------------------------------
// Kernels, each at one padded width D that takes every head dim d with
// D - 64 < d <= D: seq-major contiguous [b, s, h*d] operands (the d=128 and
// d=256 kernels, and _p64 and _p192); the d=64 head pair on lane-group
// operands (the gradients and dout of theirs); and per-head [b, h, s, d]
// operands of any row, head and batch strides (the _bhsd kernels). The
// forward and backward kernels read their layout from the tensor maps and
// the Layout arguments, so the kernels of one width have the same body:
// they are instantiated under separate names only so that a profile and the
// kernel table keep one row per entry point and width.
// ---------------------------------------------------------------------------

#define FLASH_FWD_KERNEL(NAME, D)                                                          \
  extern "C" __global__ void __launch_bounds__(FWD_THREADS, 1) NAME(                       \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, Layout out,            \
      float* __restrict__ lse, int S, int H, int causal, float scale, int d, int per) {    \
    fwd_body<D>(&tq, &tk, &tv, o, out, lse, S, H, causal, scale, d, per);                  \
  }

FLASH_FWD_KERNEL(ff_flash_fwd_kernel, 128)
FLASH_FWD_KERNEL(ff_flash_fwd_d64_kernel, 64)
FLASH_FWD_KERNEL(ff_flash_fwd_bhsd_kernel, 128)
FLASH_FWD_KERNEL(ff_flash_fwd_bhsd_d64_kernel, 64)
FLASH_FWD_KERNEL(ff_flash_fwd_d256_kernel, 256)
FLASH_FWD_KERNEL(ff_flash_fwd_p64_kernel, 64)
FLASH_FWD_KERNEL(ff_flash_fwd_p192_kernel, 192)
FLASH_FWD_KERNEL(ff_flash_fwd_bhsd_p192_kernel, 192)
FLASH_FWD_KERNEL(ff_flash_fwd_bhsd_d256_kernel, 256)

// Every delta kernel runs one body; each reads its operands through the
// Layouts it is given.
#define FLASH_DELTA_KERNEL(NAME, D)                                                        \
  extern "C" __global__ void __launch_bounds__(DELTA_THREADS) NAME(                        \
      const bf16* __restrict__ dout, Layout od, const bf16* __restrict__ o, Layout ol,     \
      float* __restrict__ delta, int S, int H, int d) {                                    \
    delta_body<D>(dout, od, o, ol, delta, S, H, d);                                        \
  }

FLASH_DELTA_KERNEL(ff_flash_delta_kernel, 128)
FLASH_DELTA_KERNEL(ff_flash_delta_d64_kernel, 64)
FLASH_DELTA_KERNEL(ff_flash_delta_bhsd_kernel, 128)
FLASH_DELTA_KERNEL(ff_flash_delta_bhsd_d64_kernel, 64)
FLASH_DELTA_KERNEL(ff_flash_delta_d256_kernel, 256)
FLASH_DELTA_KERNEL(ff_flash_delta_p64_kernel, 64)
FLASH_DELTA_KERNEL(ff_flash_delta_p192_kernel, 192)
FLASH_DELTA_KERNEL(ff_flash_delta_bhsd_p192_kernel, 192)
FLASH_DELTA_KERNEL(ff_flash_delta_bhsd_d256_kernel, 256)

#define FLASH_BWD_KERNELS(DKV, DQ, D)                                                      \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) DKV(                        \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,     \
      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk, \
      bf16* __restrict__ dv, Layout grad, int S, int H, int causal, float scale, int d,    \
      int per) {                                                                           \
    dkv_body<D>(&tq, &tk, &tv, &tdo, lse, delta, dk, dv, grad, S, H, causal, scale, d, per); \
  }                                                                                        \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) DQ(                         \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,     \
      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, \
      Layout grad, int S, int H, int causal, float scale, int d, int per) {                \
    dq_body<D>(&tq, &tk, &tv, &tdo, lse, delta, dq, grad, S, H, causal, scale, d, per);    \
  }

FLASH_BWD_KERNELS(ff_flash_bwd_dkv_kernel, ff_flash_bwd_dq_kernel, 128)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_d64_kernel, ff_flash_bwd_dq_d64_kernel, 64)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_kernel, ff_flash_bwd_dq_bhsd_kernel, 128)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_d64_kernel, ff_flash_bwd_dq_bhsd_d64_kernel, 64)

FLASH_BWD_KERNELS(ff_flash_bwd_dkv_d256_kernel, ff_flash_bwd_dq_d256_kernel, 256)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_p64_kernel, ff_flash_bwd_dq_p64_kernel, 64)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_p192_kernel, ff_flash_bwd_dq_p192_kernel, 192)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_p192_kernel, ff_flash_bwd_dq_bhsd_p192_kernel, 192)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_d256_kernel, ff_flash_bwd_dq_bhsd_d256_kernel, 256)

// ---------------------------------------------------------------------------
// C interface (ctypes). lse and delta are contiguous [B, H, S] f32; S is a
// multiple of 64; d is a head dim the kernels take (narrow_dim_ok: d % 8 == 0,
// 8 <= d <= 256), else an entry returns cudaErrorInvalidValue. The seq-major
// entries (ff_flash_fwd, _delta, _bwd) take contiguous
// [B, S, H*d] bf16 operands. The d=64 pair's entries read q/k/v (and write
// the gradients) at rows `ld` apart with 128-lane groups `group` apart,
// while o and dout are contiguous [B, S, H*64]. The _bhsd entries take
// per-head [B, H, S, d] operands, each given by its row, head and batch
// strides in elements (unit stride along d); q, k and v share one set, as
// do dq, dk and dv. The caller checks all of this, including 16-byte
// alignment of every row.
// ---------------------------------------------------------------------------

// The kernels of one kind share one signature whatever their width.
typedef decltype(&ff_flash_fwd_kernel) FwdKernel;
typedef decltype(&ff_flash_delta_kernel) DeltaKernel;
typedef decltype(&ff_flash_bwd_dkv_kernel) DkvKernel;
typedef decltype(&ff_flash_bwd_dq_kernel) DqKernel;

// Of four kernels of padded widths 64, 128, 192 and 256, head dim d's.
template <typename K>
static K by_width(int d, const K (&kernels)[4]) {
  const int i = padded_dim(d) / 64 - 1;  // clamped: the launch refuses a d outside [8, 256]
  return kernels[i < 0 ? 0 : i > 3 ? 3 : i];
}

// The forward of q, k, v (Layout in) into o (Layout out) and lse.
template <int D, typename K>
static int launch_fwd(K kernel, int d, const void* q, const void* k, const void* v, Layout in,
                      void* o, Layout out, void* lse, int B, int S, int H, int causal,
                      cudaStream_t stream) {
  if (!narrow_dim_ok(d) || padded_dim(d) != D) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[3];
  cudaError_t err = fwd_tensor_maps<D>(maps, d, q, in, S, k, in, v, in, S, H, B);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kernel, FwdTiles<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_grid(S, H, B), FWD_THREADS, FwdTiles<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (bf16*)o, out, (float*)lse, S, H, causal, softmax_scale(d), d,
      in.per);
  return (int)cudaGetLastError();
}

// The forward at head dim d through the kernel of its padded width.
static int fwd_by_width(int d, const void* q, const void* k, const void* v, Layout in, void* o,
                        Layout out, void* lse, int B, int S, int H, int causal, cudaStream_t s,
                        const FwdKernel (&kernels)[4]) {
  if (!narrow_dim_ok(d)) return (int)cudaErrorInvalidValue;
  const FwdKernel kernel = by_width(d, kernels);
  switch (padded_dim(d)) {
    case 64: return launch_fwd<64>(kernel, d, q, k, v, in, o, out, lse, B, S, H, causal, s);
    case 128: return launch_fwd<128>(kernel, d, q, k, v, in, o, out, lse, B, S, H, causal, s);
    case 192: return launch_fwd<192>(kernel, d, q, k, v, in, o, out, lse, B, S, H, causal, s);
    default: return launch_fwd<256>(kernel, d, q, k, v, in, o, out, lse, B, S, H, causal, s);
  }
}

extern "C" int ff_flash_fwd(int d, const void* q, const void* k, const void* v, void* o,
                            void* lse, int B, int S, int H, int causal, void* stream) {
  static const FwdKernel kernels[4] = {ff_flash_fwd_p64_kernel, ff_flash_fwd_kernel,
                                       ff_flash_fwd_p192_kernel, ff_flash_fwd_d256_kernel};
  const Layout l = dense(d, S, H);
  return fwd_by_width(d, q, k, v, l, o, l, lse, B, S, H, causal, (cudaStream_t)stream, kernels);
}

extern "C" int ff_flash_fwd_d64(const void* q, const void* k, const void* v, int ld, int group,
                                void* o, void* lse, int B, int S, int H, int causal,
                                void* stream) {
  return launch_fwd<64>(ff_flash_fwd_d64_kernel, 64, q, k, v, lane_grouped(ld, group, S), o,
                        dense(64, S, H), lse, B, S, H, causal, (cudaStream_t)stream);
}

extern "C" int ff_flash_fwd_bhsd(int d, const void* q, const void* k, const void* v, int ld,
                                 int head, int batch, void* o, int o_ld, int o_head,
                                 int o_batch, void* lse, int B, int S, int H, int causal,
                                 void* stream) {
  static const FwdKernel kernels[4] = {ff_flash_fwd_bhsd_d64_kernel, ff_flash_fwd_bhsd_kernel,
                                       ff_flash_fwd_bhsd_p192_kernel, ff_flash_fwd_bhsd_d256_kernel};
  return fwd_by_width(d, q, k, v, per_head(ld, head, batch), o, per_head(o_ld, o_head, o_batch),
                      lse, B, S, H, causal, (cudaStream_t)stream, kernels);
}

// delta of dout (Layout od) and o (Layout ol), head dim d, into contiguous
// [B, H, S] f32.
static int launch_delta(DeltaKernel kernel, int d, const void* dout, Layout od, const void* o,
                        Layout ol, void* delta, int B, int S, int H, cudaStream_t stream) {
  if (!narrow_dim_ok(d)) return (int)cudaErrorInvalidValue;
  kernel<<<delta_grid(B, S, H), DELTA_THREADS, 0, stream>>>((const bf16*)dout, od, (const bf16*)o,
                                                            ol, (float*)delta, S, H, d);
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_delta(int d, const void* dout, const void* o, void* delta, int B, int S,
                              int H, void* stream) {
  static const DeltaKernel kernels[4] = {ff_flash_delta_p64_kernel, ff_flash_delta_kernel,
                                         ff_flash_delta_p192_kernel, ff_flash_delta_d256_kernel};
  const Layout l = dense(d, S, H);
  return launch_delta(by_width(d, kernels), d, dout, l, o, l, delta, B, S, H,
                      (cudaStream_t)stream);
}

extern "C" int ff_flash_delta_d64(const void* dout, const void* o, void* delta, int B, int S,
                                  int H, void* stream) {
  const Layout l = dense(64, S, H);
  return launch_delta(ff_flash_delta_d64_kernel, 64, dout, l, o, l, delta, B, S, H,
                      (cudaStream_t)stream);
}

extern "C" int ff_flash_delta_bhsd(int d, const void* dout, int ld, int head, int batch,
                                   const void* o, int o_ld, int o_head, int o_batch, void* delta,
                                   int B, int S, int H, void* stream) {
  static const DeltaKernel kernels[4] = {
      ff_flash_delta_bhsd_d64_kernel, ff_flash_delta_bhsd_kernel, ff_flash_delta_bhsd_p192_kernel,
      ff_flash_delta_bhsd_d256_kernel};
  return launch_delta(by_width(d, kernels), d, dout, per_head(ld, head, batch), o,
                      per_head(o_ld, o_head, o_batch), delta, B, S, H, (cudaStream_t)stream);
}

// The backward pair of q, k, v (Layout in) and dout (Layout od) into dq,
// dk and dv (Layout grad): dK/dV, then dQ, on one stream.
template <int D, typename KDKV, typename KDQ>
static int launch_bwd(KDKV dkv, KDQ dqk, int d, const void* q, const void* k, const void* v,
                      Layout in, const void* dout, Layout od, const void* lse, const void* delta,
                      void* dq, void* dk, void* dv, Layout grad, int B, int S, int H, int causal,
                      cudaStream_t s) {
  // the mainloops give every map the same head coordinates: one grouping
  if (!narrow_dim_ok(d) || padded_dim(d) != D || od.per != in.per) return (int)cudaErrorInvalidValue;
  CUtensorMap maps[4];
  if (!bwd_tensor_maps(maps, d, q, in, k, in, v, in, dout, od, S, S, H, B))
    return (int)cudaErrorInvalidValue;
  const size_t dkv_smem = bwd_smem_bytes<D>(true), dq_smem = bwd_smem_bytes<D>(false);
  const dim3 grid = bwd_grid_of<D>(S, H, B);
  cudaError_t err = allow_smem(dkv, dkv_smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dqk, dq_smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = softmax_scale(d);
  dkv<<<grid, BWD_THREADS, dkv_smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, grad, S, H, causal, scale, d, in.per);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<grid, BWD_THREADS, dq_smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dq, grad,
      S, H, causal, scale, d, in.per);
  return (int)cudaGetLastError();
}

// The backward pair at head dim d through the kernels of its padded width.
static int bwd_by_width(int d, const void* q, const void* k, const void* v, Layout in,
                        const void* dout, Layout od, const void* lse, const void* delta, void* dq,
                        void* dk, void* dv, Layout grad, int B, int S, int H, int causal,
                        cudaStream_t s, const DkvKernel (&dkv)[4], const DqKernel (&dqk)[4]) {
  if (!narrow_dim_ok(d)) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 64:
      return launch_bwd<64>(dkv[0], dqk[0], d, q, k, v, in, dout, od, lse, delta, dq, dk, dv,
                            grad, B, S, H, causal, s);
    case 128:
      return launch_bwd<128>(dkv[1], dqk[1], d, q, k, v, in, dout, od, lse, delta, dq, dk, dv,
                             grad, B, S, H, causal, s);
    case 192:
      return launch_bwd<192>(dkv[2], dqk[2], d, q, k, v, in, dout, od, lse, delta, dq, dk, dv,
                             grad, B, S, H, causal, s);
    default:
      return launch_bwd<256>(dkv[3], dqk[3], d, q, k, v, in, dout, od, lse, delta, dq, dk, dv,
                             grad, B, S, H, causal, s);
  }
}

extern "C" int ff_flash_bwd(int d, const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int S, int H, int causal, void* stream) {
  static const DkvKernel dkv[4] = {ff_flash_bwd_dkv_p64_kernel, ff_flash_bwd_dkv_kernel,
                                   ff_flash_bwd_dkv_p192_kernel, ff_flash_bwd_dkv_d256_kernel};
  static const DqKernel dqk[4] = {ff_flash_bwd_dq_p64_kernel, ff_flash_bwd_dq_kernel,
                                  ff_flash_bwd_dq_p192_kernel, ff_flash_bwd_dq_d256_kernel};
  const Layout l = dense(d, S, H);
  return bwd_by_width(d, q, k, v, l, dout, l, lse, delta, dq, dk, dv, l, B, S, H, causal,
                      (cudaStream_t)stream, dkv, dqk);
}

extern "C" int ff_flash_bwd_d64(const void* q, const void* k, const void* v, int ld, int group,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                void* dk, void* dv, int grad_ld, int grad_group, int B, int S,
                                int H, int causal, void* stream) {
  // dout, contiguous [B, S, H*64], read in the same 128-lane groups of two
  // heads as q, k and v
  return launch_bwd<64>(ff_flash_bwd_dkv_d64_kernel, ff_flash_bwd_dq_d64_kernel, 64, q, k, v,
                        lane_grouped(ld, group, S), dout, lane_grouped(H * 64, LANES, S), lse,
                        delta, dq, dk, dv, lane_grouped(grad_ld, grad_group, S), B, S, H, causal,
                        (cudaStream_t)stream);
}

extern "C" int ff_flash_bwd_bhsd(int d, const void* q, const void* k, const void* v, int ld,
                                 int head, int batch, const void* dout, int o_ld, int o_head,
                                 int o_batch, const void* lse, const void* delta, void* dq,
                                 void* dk, void* dv, int g_ld, int g_head, int g_batch, int B,
                                 int S, int H, int causal, void* stream) {
  static const DkvKernel dkv[4] = {ff_flash_bwd_dkv_bhsd_d64_kernel, ff_flash_bwd_dkv_bhsd_kernel,
                                   ff_flash_bwd_dkv_bhsd_p192_kernel,
                                   ff_flash_bwd_dkv_bhsd_d256_kernel};
  static const DqKernel dqk[4] = {ff_flash_bwd_dq_bhsd_d64_kernel, ff_flash_bwd_dq_bhsd_kernel,
                                  ff_flash_bwd_dq_bhsd_p192_kernel,
                                  ff_flash_bwd_dq_bhsd_d256_kernel};
  return bwd_by_width(d, q, k, v, per_head(ld, head, batch), dout,
                      per_head(o_ld, o_head, o_batch), lse, delta, dq, dk, dv,
                      per_head(g_ld, g_head, g_batch), B, S, H, causal, (cudaStream_t)stream, dkv,
                      dqk);
}

// Dynamic shared memory of each kernel, for the build report: 0-2 the
// fwd, dkv and dq kernels at padded width 128, 3-5 at 64, 6-8 at 256 and
// 9-11 at 192 (every kernel of a width uses the same, the ring's too).
extern "C" int ff_flash_smem_bytes(int which) {
  switch (which) {
    case 0: return (int)FwdTiles<128>::SMEM;
    case 1: return (int)bwd_smem_bytes<128>(true);
    case 2: return (int)bwd_smem_bytes<128>(false);
    case 3: return (int)FwdTiles<64>::SMEM;
    case 4: return (int)bwd_smem_bytes<64>(true);
    case 5: return (int)bwd_smem_bytes<64>(false);
    case 6: return (int)FwdTiles<256>::SMEM;
    case 7: return (int)bwd_smem_bytes<256>(true);
    case 8: return (int)bwd_smem_bytes<256>(false);
    case 9: return (int)FwdTiles<192>::SMEM;
    case 10: return (int)bwd_smem_bytes<192>(true);
    case 11: return (int)bwd_smem_bytes<192>(false);
    default: return 0;
  }
}
