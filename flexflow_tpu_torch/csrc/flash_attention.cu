// Flash attention on seq-major bf16 operands for Hopper (sm_90a), at head
// dims 128, 64 and 256.
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
//   why d=256 needs them; the delta runs delta_body)
//
// What bounds them on an H100. The forward does 4*b*h*s^2*d flops: at the
// flagship's b=64, s=512, h*d=1024 that is 6.9e10 on ~270 MB, the ridge,
// bound by bytes (0.080 ms); at the seq-2048 flagship's b=16, s=2048 it is
// 2.7e11 on the same bytes, bound by operations (0.278 ms). The backward
// pair's 14*b*h*s^2*d flops on ~470 MB lie near the ridge at s=512 and are
// bound by operations at s=2048; delta is a pure read of dO and O and is
// bound by bytes.
//
// Delta design (the four delta kernels, rows 2 and 10 and row 7's delta):
// one body, delta_body, reads dO and O through their Layouts with 16-byte
// loads, several rows a thread in flight, a block a tile of (one b, 64
// consecutive s, up to 16 heads), and stores each head's run of sums
// contiguously into [b, h, s] from shared memory. Where the one-warp-a-row
// kernels it replaced made 4-byte loads, launched a block for every 8 rows
// and (bshf) scattered 4-byte stores S*4 bytes apart, it keeps enough bytes
// in flight to run at the card's memory rate. Its note has the details.
//
// Forward design (the five _fwd kernels, rows 1, 6 and 9 of the port's
// kernel table, row 1 at d=128 and 256): fwd_body is the Hopper mainloop of
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
// the port's kernel table, row 3 at d=128 and 256): dkv_body and dq_body are
// the two Hopper mainloops of flash_bwd_sm90.cuh with the flash epilogue (at
// d=256 the head-split pair, which owns 64 rows a block). The TPU kernels
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
// starts at element b * batch + (h / PER) * group + (h % PER) * sub, with
// PER = 128 / D heads to a group (one at d=256, whose head is its own
// group: group = sub = 256), and its rows lie ld elements apart. At
// d=128 the bshf operands are contiguous [b, s, h*128] (ld = h*128,
// group = sub = 128, batch = s*h*128). At d=64 the same kernel reads
// either separate q/k/v [b, s, h*64] (ld = h*64, group = 128, sub = 64) or
// the interleaved projection [b, s, 3*h*64] whose pair-group g holds
// [q_pair | k_pair | v_pair] in 384 lanes (q, k, v at +0, +128, +256;
// ld = 3*h*64, group = 384, sub = 64), and the backward writes dq/dk/dv
// into one dqkv of the same interleave. The per-head entries read
// [b, h, s, d] operands by their strides: contiguous ones have ld = d,
// sub = s*d, group = PER*s*d, batch = h*s*d, and the per-head projection
// einsum's output (a [b, s, h, d] buffer viewed as [b, h, s, d]) has
// ld = h*d, sub = d, group = PER*d, batch = s*h*d, the bshf numbers, so it
// is read in place. Every row starts at a multiple of 8 elements, so the
// TMA boxes stay aligned (the wrappers check it); the forward and the
// backward turn the Layout into 5-D tensor maps (fwd_tensor_map).
//
// The Layout lives in flash_tiles.cuh, the forward's mainloop in
// flash_fwd_sm90.cuh and the backward's in flash_bwd_sm90.cuh (ring_flash.cu
// shares all three). Each exported C function
// launches on the given stream and returns cudaGetLastError() (0 on
// success).

#include "flash_bwd_sm90.cuh"

namespace {

// o and lse[b, h, s] (natural log) of softmax(scale * q k^T) v: the Hopper
// forward mainloop of flash_fwd_sm90.cuh with the flash epilogue. Grid
// fwd_grid(S, H, B); q, k and v come as tensor maps, o goes out through `out`.
template <int D>
__device__ __forceinline__ void fwd_body(const CUtensorMap* tq, const CUtensorMap* tk,
                                         const CUtensorMap* tv, bf16* __restrict__ o, Layout out,
                                         float* __restrict__ lse, int S, int H, int causal,
                                         float scale) {
  fwd_mainloop<D>(tq, tk, tv, FlashEpilogue<D>{o, out, lse},
                  FwdShape{S, S, H, 0, 0, causal, scale});
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
                                         int causal, float scale) {
  const FwdShape sh{S, S, H, 0, 0, causal, scale};
  if constexpr (D == 256)
    dkv_mainloop_d256(tq, tk, tv, tdo, lse, delta, dk, dv, grad, sh);
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
                                        Layout grad, int S, int H, int causal, float scale) {
  const FwdShape sh{S, S, H, 0, 0, causal, scale};
  if constexpr (D == 256)
    dq_mainloop_d256(tq, tk, tv, tdo, lse, delta, dq, grad, sh);
  else
    dq_mainloop<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>{dq, grad}, sh);
}

// Delta: delta[b, h, s] = sum_d dO * O, the bf16 products summed in f32.
//
// Replaces _delta_kernel (flexflow_tpu/kernels/flash_attention.py:1203) via
// _delta_bshf (:1222) and _delta_rows (:433), and the delta that
// _bwd_pair_core (:1105) computes inline; all four delta kernels of this
// file run delta_body. The port's backward pair needs every row's delta
// before its dK/dV mainloop streams, so delta stays a pass of its own.
//
// What bounds it on an H100: bytes. It reads 2*b*s*h*d*2 bytes, writes
// b*h*s*4 and does 2*b*s*h*d flops: at the flagship's attention shape
// 136 MB in 41 us at 3.35 TB/s against 67 MFLOP in 1 us at 67 TFLOP/s f32.
// So it is fast exactly when the card has enough bytes in flight and every
// sector it touches is used whole. The design:
// - 16-byte loads: a thread loads 8 bf16 of dO and 8 of O with one
//   16-byte load each, through the read-only path and not kept in L1, so
//   a row of D values is D/8 neighbouring lanes (8 at d=64, 16 at d=128)
//   and a warp covers 256/D rows at once; every load instruction reads
//   whole 128-byte lines.
// - Several rows a thread: each thread issues the loads of DELTA_ROWS rows
//   before any arithmetic (2*DELTA_ROWS loads, 128 bytes, in flight), then
//   reduces each row's partial sums within its lane group in log2(D/8)
//   xor shuffles.
// - Few blocks, each with a large tile: a block owns (one b, DELTA_S_TILE
//   consecutive s, up to DELTA_HEAD_TILE heads), at most 1024 rows, 128 KB
//   (d=64) or 256 KB (d=128) of operands, and walks it in passes of
//   DELTA_THREADS * DELTA_ROWS / (D/8) rows. At the train paths' shapes that
//   is 512 blocks of 256 threads, which the card holds in one wave, and
//   some 16 MB in flight at once. A persistent grid would add a loop over
//   tiles and change nothing at these shapes, so the grid is one block a
//   tile.
// - Coalesced stores: the block stages its sums in shared memory as
//   [head][s] and writes each head's run of DELTA_S_TILE floats as 16-byte
//   stores into [b, h, s], whether the rows came in (b, s, h) order (bshf,
//   and the per-head einsum view) or in (b, h, s) order (contiguous
//   per-head operands). Only the load walk follows the layout: heads
//   fastest where heads of one row lie closer than rows of one head, so a
//   pass reads the tile's memory in order.
// - Tails are masked, not padded: s is a multiple of 64 = DELTA_S_TILE, so
//   no tile has a ragged s; a last head tile of fewer heads (H > 16, no
//   multiple of 16) and a pass past the tile's rows (d=64 with an odd head
//   count in the tile) load nothing and store nothing.
// Every output is written by one thread, with no atomics, so results repeat
// bitwise. Every 16-byte load is aligned because every operand starts
// 16-byte aligned and all its strides are multiples of 8 elements (the
// wrappers check both).
constexpr int DELTA_THREADS = 256;
constexpr int DELTA_ROWS = 4;        // rows a thread has in flight
constexpr int DELTA_S_TILE = 64;     // consecutive s a block owns
constexpr int DELTA_HEAD_TILE = 16;  // heads a block owns, at most
constexpr int DELTA_SUMS_LD = DELTA_S_TILE + 4;  // padded: no bank conflicts, 16-byte rows

template <int D>
struct DeltaTile {
  static constexpr int LANES_PER_ROW = D / 8;               // 8 bf16, 16 bytes, a lane
  static constexpr int SLOTS = DELTA_THREADS / LANES_PER_ROW;  // rows a block covers at once
  static constexpr int PASS = SLOTS * DELTA_ROWS;            // rows a pass of the block
  static_assert(32 % LANES_PER_ROW == 0, "a row's lanes lie within one warp");
};

__host__ __device__ __forceinline__ int delta_head_tile(int H) {
  return H < DELTA_HEAD_TILE ? H : DELTA_HEAD_TILE;
}

// One block a (s tile, head tile, batch) triple, s tiles fastest.
static inline dim3 delta_grid(int B, int S, int H) {
  const int ht = delta_head_tile(H);
  return dim3((unsigned)((long)B * (S / DELTA_S_TILE) * ((H + ht - 1) / ht)));
}

// acc + the 8 products of two 16-byte words of bf16 pairs, in f32 (each
// product of two bf16 values is exact in f32).
__device__ __forceinline__ float dot8(const uint4& a, const uint4& b, float acc) {
  const uint32_t x[4] = {a.x, a.y, a.z, a.w}, y[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(x[i] << 16), __uint_as_float(y[i] << 16), acc);
    acc = fmaf(__uint_as_float(x[i] & 0xffff0000u), __uint_as_float(y[i] & 0xffff0000u), acc);
  }
  return acc;
}

// 16 bytes at p (16-byte aligned) through the read-only path, not kept in
// L1: delta reads every byte once.
__device__ __forceinline__ uint4 ld_once16(const bf16* p) {
  uint4 r;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(r.x), "=r"(r.y), "=r"(r.z), "=r"(r.w)
      : "l"(p));
  return r;
}

// delta[b, h, s] of one tile, dO and O each read through its own layout.
// Grid delta_grid(B, S, H), DELTA_THREADS threads.
template <int D>
__device__ __forceinline__ void delta_body(const bf16* __restrict__ dout, Layout od,
                                           const bf16* __restrict__ o, Layout ol,
                                           float* __restrict__ delta, int S, int H) {
  using T = DeltaTile<D>;
  __shared__ __align__(16) float sums[DELTA_HEAD_TILE * DELTA_SUMS_LD];
  const int ht = delta_head_tile(H);
  const int s_tiles = S / DELTA_S_TILE, h_tiles = (H + ht - 1) / ht;
  const int s0 = (blockIdx.x % s_tiles) * DELTA_S_TILE;
  const int h0 = (blockIdx.x / s_tiles % h_tiles) * ht;
  const int b = blockIdx.x / s_tiles / h_tiles;
  const int heads = min(ht, H - h0);
  const int rows = heads * DELTA_S_TILE;
  const bool heads_fastest = od.sub < od.ld;  // walk the rows in memory order
  const int lane = threadIdx.x % T::LANES_PER_ROW, slot = threadIdx.x / T::LANES_PER_ROW;
  const int col = lane * 8;

  for (int pass = 0; pass < rows; pass += T::PASS) {
    uint4 x[DELTA_ROWS], y[DELTA_ROWS];
    int at[DELTA_ROWS];  // where each row's sum goes in `sums`, or -1 past the tile
#pragma unroll
    for (int r = 0; r < DELTA_ROWS; ++r) {
      const int t = pass + r * T::SLOTS + slot;  // uniform across the row's lanes
      x[r] = y[r] = make_uint4(0u, 0u, 0u, 0u);
      at[r] = -1;
      if (t < rows) {
        const int hl = heads_fastest ? t % heads : t / DELTA_S_TILE;
        const int sl = heads_fastest ? t / heads : t % DELTA_S_TILE;
        const int h = h0 + hl, s = s0 + sl;
        x[r] = ld_once16(dout + head_base<D>(od, b, h) + (size_t)s * od.ld + col);
        y[r] = ld_once16(o + head_base<D>(ol, b, h) + (size_t)s * ol.ld + col);
        at[r] = hl * DELTA_SUMS_LD + sl;
      }
    }
#pragma unroll
    for (int r = 0; r < DELTA_ROWS; ++r) {
      float acc = dot8(x[r], y[r], 0.f);
#pragma unroll
      for (int off = T::LANES_PER_ROW / 2; off > 0; off >>= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (lane == 0 && at[r] >= 0) sums[at[r]] = acc;
    }
  }
  __syncthreads();

  constexpr int VECS = DELTA_S_TILE / 4;  // float4s a head's run
  for (int i = threadIdx.x; i < heads * VECS; i += DELTA_THREADS) {
    const int hl = i / VECS, v = i % VECS;
    float4* out = reinterpret_cast<float4*>(delta + ((size_t)b * H + h0 + hl) * S + s0);
    out[v] = *reinterpret_cast<const float4*>(&sums[hl * DELTA_SUMS_LD + 4 * v]);
  }
}

// The layout of contiguous [b, s, h*D] operands.
template <int D>
__host__ __device__ __forceinline__ Layout dense(int S, int H) {
  return Layout{H * D, group_heads<D>() * D, D, S * H * D};
}

// The layout of lane-group operands (rows `ld` apart, 128-lane groups
// `group` apart, rows packed by batch).
template <int D>
__host__ __device__ __forceinline__ Layout lane_grouped(int ld, int group, int S) {
  return Layout{ld, group, D, S * ld};
}

}  // namespace

// ---------------------------------------------------------------------------
// Kernels: head dims 128 and 256 on contiguous [b, s, h*d] operands; head
// dim 64 on lane-group operands (the gradients and dout of theirs); and, at
// head dims 64 and 128, per-head [b, h, s, d] operands of any row, head and
// batch strides (the _bhsd kernels). The forward and backward kernels read
// their layout from the tensor maps and the Layout arguments, so the bshf and
// _bhsd kernels of one head dim have the same body: they are instantiated
// under separate names only so that a profile and the kernel table keep
// one row per entry point.
// ---------------------------------------------------------------------------

#define FLASH_FWD_KERNEL(NAME, D)                                                          \
  extern "C" __global__ void __launch_bounds__(FWD_THREADS, 1) NAME(                       \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o, Layout out,            \
      float* __restrict__ lse, int S, int H, int causal, float scale) {                    \
    fwd_body<D>(&tq, &tk, &tv, o, out, lse, S, H, causal, scale);                          \
  }

FLASH_FWD_KERNEL(ff_flash_fwd_kernel, 128)
FLASH_FWD_KERNEL(ff_flash_fwd_d64_kernel, 64)
FLASH_FWD_KERNEL(ff_flash_fwd_bhsd_kernel, 128)
FLASH_FWD_KERNEL(ff_flash_fwd_bhsd_d64_kernel, 64)
FLASH_FWD_KERNEL(ff_flash_fwd_d256_kernel, 256)

// The four delta kernels run one body; a bshf kernel reads its operands
// through dense<D>, a per-head one through the per-head Layouts it is given.
#define FLASH_DELTA_KERNEL(NAME, D)                                                        \
  extern "C" __global__ void __launch_bounds__(DELTA_THREADS) NAME(                        \
      const bf16* __restrict__ dout, Layout od, const bf16* __restrict__ o, Layout ol,     \
      float* __restrict__ delta, int S, int H) {                                           \
    delta_body<D>(dout, od, o, ol, delta, S, H);                                           \
  }

FLASH_DELTA_KERNEL(ff_flash_delta_kernel, 128)
FLASH_DELTA_KERNEL(ff_flash_delta_d64_kernel, 64)
FLASH_DELTA_KERNEL(ff_flash_delta_bhsd_kernel, 128)
FLASH_DELTA_KERNEL(ff_flash_delta_bhsd_d64_kernel, 64)
FLASH_DELTA_KERNEL(ff_flash_delta_d256_kernel, 256)

#define FLASH_BWD_KERNELS(DKV, DQ, D)                                                      \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) DKV(                        \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,     \
      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dk, \
      bf16* __restrict__ dv, Layout grad, int S, int H, int causal, float scale) {         \
    dkv_body<D>(&tq, &tk, &tv, &tdo, lse, delta, dk, dv, grad, S, H, causal, scale);       \
  }                                                                                        \
  extern "C" __global__ void __launch_bounds__(BWD_THREADS, 1) DQ(                         \
      const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,      \
      const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,     \
      const float* __restrict__ lse, const float* __restrict__ delta, bf16* __restrict__ dq, \
      Layout grad, int S, int H, int causal, float scale) {                                \
    dq_body<D>(&tq, &tk, &tv, &tdo, lse, delta, dq, grad, S, H, causal, scale);            \
  }

FLASH_BWD_KERNELS(ff_flash_bwd_dkv_kernel, ff_flash_bwd_dq_kernel, 128)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_d64_kernel, ff_flash_bwd_dq_d64_kernel, 64)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_kernel, ff_flash_bwd_dq_bhsd_kernel, 128)
FLASH_BWD_KERNELS(ff_flash_bwd_dkv_bhsd_d64_kernel, ff_flash_bwd_dq_bhsd_d64_kernel, 64)

FLASH_BWD_KERNELS(ff_flash_bwd_dkv_d256_kernel, ff_flash_bwd_dq_d256_kernel, 256)

// ---------------------------------------------------------------------------
// C interface (ctypes). lse and delta are contiguous [B, H, S] f32; S is a
// multiple of 64. At d=128 and 256 every other operand of the bshf entries
// is a contiguous [B, S, H*d] bf16. At d=64, q/k/v (and the gradients) are
// read (and written) at rows `ld` apart with 128-lane groups `group` apart,
// while o and dout are contiguous [B, S, H*64]. The _bhsd entries take
// d = 64 or 128 and per-head [B, H, S, d] operands, each given by its row,
// head and batch strides in elements (unit stride along d); q, k and v
// share one set, as do dq, dk and dv. The caller checks all of this,
// including 16-byte alignment of every row.
// ---------------------------------------------------------------------------

// The forward of q, k, v (Layout in) into o (Layout out) and lse.
template <int D, typename K>
static int launch_fwd(K kernel, const void* q, const void* k, const void* v, Layout in, void* o,
                      Layout out, void* lse, int B, int S, int H, int causal,
                      cudaStream_t stream) {
  CUtensorMap maps[3];
  cudaError_t err = fwd_tensor_maps<D>(maps, q, in, S, k, in, v, in, S, H, B);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(kernel, FwdTiles<D>::SMEM);
  if (err != cudaSuccess) return (int)err;
  kernel<<<fwd_grid(S, H, B), FWD_THREADS, FwdTiles<D>::SMEM, stream>>>(
      maps[0], maps[1], maps[2], (bf16*)o, out, (float*)lse, S, H, causal, softmax_scale<D>());
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int S, int H, int causal, void* stream) {
  const Layout l = dense<128>(S, H);
  return launch_fwd<128>(ff_flash_fwd_kernel, q, k, v, l, o, l, lse, B, S, H, causal,
                         (cudaStream_t)stream);
}

extern "C" int ff_flash_fwd_d64(const void* q, const void* k, const void* v, int ld, int group,
                                void* o, void* lse, int B, int S, int H, int causal,
                                void* stream) {
  return launch_fwd<64>(ff_flash_fwd_d64_kernel, q, k, v, lane_grouped<64>(ld, group, S), o,
                        dense<64>(S, H), lse, B, S, H, causal, (cudaStream_t)stream);
}

extern "C" int ff_flash_fwd_bhsd(int d, const void* q, const void* k, const void* v, int ld,
                                 int head, int batch, void* o, int o_ld, int o_head,
                                 int o_batch, void* lse, int B, int S, int H, int causal,
                                 void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_fwd<128>(ff_flash_fwd_bhsd_kernel, q, k, v, per_head<128>(ld, head, batch), o,
                           per_head<128>(o_ld, o_head, o_batch), lse, B, S, H, causal, s);
  if (d == 64)
    return launch_fwd<64>(ff_flash_fwd_bhsd_d64_kernel, q, k, v, per_head<64>(ld, head, batch), o,
                          per_head<64>(o_ld, o_head, o_batch), lse, B, S, H, causal, s);
  return (int)cudaErrorInvalidValue;
}

// delta of dout (Layout od) and o (Layout ol) into contiguous [B, H, S] f32.
template <typename K>
static int launch_delta(K kernel, const void* dout, Layout od, const void* o, Layout ol,
                        void* delta, int B, int S, int H, cudaStream_t stream) {
  kernel<<<delta_grid(B, S, H), DELTA_THREADS, 0, stream>>>((const bf16*)dout, od, (const bf16*)o,
                                                            ol, (float*)delta, S, H);
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_delta(const void* dout, const void* o, void* delta, int B, int S, int H,
                              void* stream) {
  const Layout l = dense<128>(S, H);
  return launch_delta(ff_flash_delta_kernel, dout, l, o, l, delta, B, S, H, (cudaStream_t)stream);
}

extern "C" int ff_flash_delta_d64(const void* dout, const void* o, void* delta, int B, int S,
                                  int H, void* stream) {
  const Layout l = dense<64>(S, H);
  return launch_delta(ff_flash_delta_d64_kernel, dout, l, o, l, delta, B, S, H,
                      (cudaStream_t)stream);
}

extern "C" int ff_flash_delta_bhsd(int d, const void* dout, int ld, int head, int batch,
                                   const void* o, int o_ld, int o_head, int o_batch, void* delta,
                                   int B, int S, int H, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_delta(ff_flash_delta_bhsd_kernel, dout, per_head<128>(ld, head, batch), o,
                        per_head<128>(o_ld, o_head, o_batch), delta, B, S, H, s);
  if (d == 64)
    return launch_delta(ff_flash_delta_bhsd_d64_kernel, dout, per_head<64>(ld, head, batch), o,
                        per_head<64>(o_ld, o_head, o_batch), delta, B, S, H, s);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of the dK/dV (dkv) or dQ kernel at head dim D: the
// mainloops of 128-row blocks, or at D = 256 the head-split ones.
template <int D>
static constexpr size_t bwd_smem_bytes(bool dkv) {
  if constexpr (D == 256) return dkv ? SplitTiles::DKV_SMEM : SplitTiles::DQ_SMEM;
  else return dkv ? BwdTiles<D>::DKV_SMEM : BwdTiles<D>::DQ_SMEM;
}

// The backward pair of q, k, v (Layout in) and dout (Layout od) into dq,
// dk and dv (Layout grad): dK/dV, then dQ, on one stream.
template <int D, typename KDKV, typename KDQ>
static int launch_bwd(KDKV dkv, KDQ dqk, const void* q, const void* k, const void* v, Layout in,
                      const void* dout, Layout od, const void* lse, const void* delta, void* dq,
                      void* dk, void* dv, Layout grad, int B, int S, int H, int causal,
                      cudaStream_t s) {
  CUtensorMap maps[4];
  if (!bwd_tensor_maps<D>(maps, q, in, k, in, v, in, dout, od, S, S, H, B))
    return (int)cudaErrorInvalidValue;
  const size_t dkv_smem = bwd_smem_bytes<D>(true), dq_smem = bwd_smem_bytes<D>(false);
  const dim3 grid = D == 256 ? split_grid(S, H, B) : bwd_grid(S, H, B);
  cudaError_t err = allow_smem(dkv, dkv_smem);
  if (err != cudaSuccess) return (int)err;
  err = allow_smem(dqk, dq_smem);
  if (err != cudaSuccess) return (int)err;
  dkv<<<grid, BWD_THREADS, dkv_smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dk,
      (bf16*)dv, grad, S, H, causal, softmax_scale<D>());
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dqk<<<grid, BWD_THREADS, dq_smem, s>>>(
      maps[0], maps[1], maps[2], maps[3], (const float*)lse, (const float*)delta, (bf16*)dq, grad,
      S, H, causal, softmax_scale<D>());
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int S, int H, int causal, void* stream) {
  const Layout l = dense<128>(S, H);
  return launch_bwd<128>(ff_flash_bwd_dkv_kernel, ff_flash_bwd_dq_kernel, q, k, v, l, dout, l,
                         lse, delta, dq, dk, dv, l, B, S, H, causal, (cudaStream_t)stream);
}

extern "C" int ff_flash_bwd_d64(const void* q, const void* k, const void* v, int ld, int group,
                                const void* dout, const void* lse, const void* delta, void* dq,
                                void* dk, void* dv, int grad_ld, int grad_group, int B, int S,
                                int H, int causal, void* stream) {
  return launch_bwd<64>(ff_flash_bwd_dkv_d64_kernel, ff_flash_bwd_dq_d64_kernel, q, k, v,
                        lane_grouped<64>(ld, group, S), dout, dense<64>(S, H), lse, delta, dq, dk,
                        dv, lane_grouped<64>(grad_ld, grad_group, S), B, S, H, causal,
                        (cudaStream_t)stream);
}

extern "C" int ff_flash_bwd_bhsd(int d, const void* q, const void* k, const void* v, int ld,
                                 int head, int batch, const void* dout, int o_ld, int o_head,
                                 int o_batch, const void* lse, const void* delta, void* dq,
                                 void* dk, void* dv, int g_ld, int g_head, int g_batch, int B,
                                 int S, int H, int causal, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (d == 128)
    return launch_bwd<128>(ff_flash_bwd_dkv_bhsd_kernel, ff_flash_bwd_dq_bhsd_kernel, q, k, v,
                           per_head<128>(ld, head, batch), dout,
                           per_head<128>(o_ld, o_head, o_batch), lse, delta, dq, dk, dv,
                           per_head<128>(g_ld, g_head, g_batch), B, S, H, causal, s);
  if (d == 64)
    return launch_bwd<64>(ff_flash_bwd_dkv_bhsd_d64_kernel, ff_flash_bwd_dq_bhsd_d64_kernel, q, k,
                          v, per_head<64>(ld, head, batch), dout,
                          per_head<64>(o_ld, o_head, o_batch), lse, delta, dq, dk, dv,
                          per_head<64>(g_ld, g_head, g_batch), B, S, H, causal, s);
  return (int)cudaErrorInvalidValue;
}

// Head dim 256, contiguous [B, S, H*256] operands: the forward, the delta,
// and the backward pair (dK/dV, then dQ, on one stream).
extern "C" int ff_flash_fwd_d256(const void* q, const void* k, const void* v, void* o, void* lse,
                                 int B, int S, int H, int causal, void* stream) {
  const Layout l = dense<256>(S, H);
  return launch_fwd<256>(ff_flash_fwd_d256_kernel, q, k, v, l, o, l, lse, B, S, H, causal,
                         (cudaStream_t)stream);
}

extern "C" int ff_flash_delta_d256(const void* dout, const void* o, void* delta, int B, int S,
                                   int H, void* stream) {
  const Layout l = dense<256>(S, H);
  return launch_delta(ff_flash_delta_d256_kernel, dout, l, o, l, delta, B, S, H,
                      (cudaStream_t)stream);
}

extern "C" int ff_flash_bwd_d256(const void* q, const void* k, const void* v, const void* dout,
                                 const void* lse, const void* delta, void* dq, void* dk, void* dv,
                                 int B, int S, int H, int causal, void* stream) {
  const Layout l = dense<256>(S, H);
  return launch_bwd<256>(ff_flash_bwd_dkv_d256_kernel, ff_flash_bwd_dq_d256_kernel, q, k, v, l,
                         dout, l, lse, delta, dq, dk, dv, l, B, S, H, causal,
                         (cudaStream_t)stream);
}

// Dynamic shared memory of each kernel, for the build report: 0-2 the
// d=128 fwd, dkv and dq kernels, 3-5 the d=64 ones (the _bhsd kernels of
// each head dim use the same), 6-8 the d=256 ones.
extern "C" int ff_flash_smem_bytes(int which) {
  switch (which) {
    case 0: return (int)FwdTiles<128>::SMEM;
    case 1: return (int)BwdTiles<128>::DKV_SMEM;
    case 2: return (int)BwdTiles<128>::DQ_SMEM;
    case 3: return (int)FwdTiles<64>::SMEM;
    case 4: return (int)BwdTiles<64>::DKV_SMEM;
    case 5: return (int)BwdTiles<64>::DQ_SMEM;
    case 6: return (int)FwdTiles<256>::SMEM;
    case 7: return (int)SplitTiles::DKV_SMEM;
    case 8: return (int)SplitTiles::DQ_SMEM;
    default: return 0;
  }
}
