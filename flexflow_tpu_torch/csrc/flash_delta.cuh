// The delta pass of every attention backward, narrow and wide:
// delta_body, which flash_attention.cu's delta kernels and flash_wide.cu's
// run.

#pragma once

#include "flash_tiles.cuh"

namespace {

// Delta: delta[b, h, s] = sum_d dO * O, the bf16 products summed in f32.
//
// Replaces _delta_kernel (flexflow_tpu/kernels/flash_attention.py:1203) via
// _delta_bshf (:1222) and _delta_rows (:433), and the delta that
// _bwd_pair_core (:1105) computes inline; every delta kernel of
// flash_attention.cu and flash_wide.cu runs delta_body. The port's backward pair needs every row's delta
// before its dK/dV mainloop streams, so delta stays a pass of its own.
//
// What bounds it on an H100: bytes. It reads 2*b*s*h*d*2 bytes, writes
// b*h*s*4 and does 2*b*s*h*d flops: at the flagship's attention shape
// 136 MB in 41 us at 3.35 TB/s against 67 MFLOP in 1 us at 67 TFLOP/s f32.
// So it is fast exactly when the card has enough bytes in flight and every
// sector it touches is used whole. The design:
// - 16-byte loads: a thread loads 8 bf16 of dO and 8 of O with one
//   16-byte load each, through the read-only path and not kept in L1, so
//   a row is a power-of-two group of neighbouring lanes, 8 at padded width
//   64, 16 at 128 and 32 at 192 and 256 (192/8 = 24 lanes would not divide
//   a warp), and a warp covers 32/lanes rows at once; the lanes whose 8
//   columns lie at or past d load nothing and add 0. Past d = 256 (the
//   wide instance, D = 0) a row stays 32 lanes, and each lane loads 16
//   bytes of every 256 columns: ceil(d / 256) loads of each operand, the
//   first pass's in flight for all rows as below, the rest a pass of 256
//   columns at a time.
// - Several rows a thread: each thread issues the loads of DELTA_ROWS rows
//   before any arithmetic (2*DELTA_ROWS loads, 128 bytes, in flight), then
//   reduces each row's partial sums within its lane group in log2(lanes)
//   xor shuffles.
// - Few blocks, each with a large tile: a block owns (one b, DELTA_S_TILE
//   consecutive s, up to DELTA_HEAD_TILE heads), at most 1024 rows, 128 KB
//   (d=64) or 256 KB (d=128) of operands, and walks it in passes of
//   DELTA_THREADS * DELTA_ROWS / lanes rows. At the train paths' shapes that
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

// D: the padded width (64, 128, 192 or 256), or 0 for every d past 256.
template <int D>
struct DeltaTile {
  static constexpr bool WIDE = D == 0;
  static constexpr int LANES_PER_ROW = WIDE ? 32 : D <= 64 ? 8 : D <= 128 ? 16 : 32;  // 16 bytes a lane
  static constexpr int SLOTS = DELTA_THREADS / LANES_PER_ROW;  // rows a block covers at once
  static constexpr int PASS = SLOTS * DELTA_ROWS;            // rows a pass of the block
  static constexpr int COLS = 8 * LANES_PER_ROW;               // columns of one load a lane
  static_assert(32 % LANES_PER_ROW == 0 && (WIDE || COLS >= D),
                "a row's lanes lie within one warp and cover the padded width");
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

// delta[b, h, s] of one tile, dO and O each read through its own layout,
// head dim d (D: its padded width, or 0 past 256). Grid delta_grid(B, S,
// H), DELTA_THREADS threads.
template <int D>
__device__ __forceinline__ void delta_body(const bf16* __restrict__ dout, Layout od,
                                           const bf16* __restrict__ o, Layout ol,
                                           float* __restrict__ delta, int S, int H, int d) {
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
    if constexpr (T::WIDE) {
      // past d = 256: each row's lanes load 256 columns a round, the rows'
      // loads of a round in flight together, and sum over the rounds
      float acc[DELTA_ROWS];
      int at[DELTA_ROWS];  // where each row's sum goes in `sums`, or -1 past the tile
      const bf16* xr[DELTA_ROWS];  // the rows' column 0
      const bf16* yr[DELTA_ROWS];
#pragma unroll
      for (int r = 0; r < DELTA_ROWS; ++r) {
        const int t = pass + r * T::SLOTS + slot;  // uniform across the row's lanes
        acc[r] = 0.f;
        at[r] = -1;
        if (t < rows) {
          const int hl = heads_fastest ? t % heads : t / DELTA_S_TILE;
          const int sl = heads_fastest ? t / heads : t % DELTA_S_TILE;
          const int h = h0 + hl, s = s0 + sl;
          xr[r] = dout + head_base(od, b, h) + (size_t)s * od.ld;
          yr[r] = o + head_base(ol, b, h) + (size_t)s * ol.ld;
          at[r] = hl * DELTA_SUMS_LD + sl;
        }
      }
      for (int c0 = 0; c0 < d; c0 += T::COLS) {
        uint4 x[DELTA_ROWS], y[DELTA_ROWS];
#pragma unroll
        for (int r = 0; r < DELTA_ROWS; ++r) {
          x[r] = y[r] = make_uint4(0u, 0u, 0u, 0u);
          if (at[r] >= 0 && c0 + col < d) {
            x[r] = ld_once16(xr[r] + c0 + col);
            y[r] = ld_once16(yr[r] + c0 + col);
          }
        }
#pragma unroll
        for (int r = 0; r < DELTA_ROWS; ++r) acc[r] = dot8(x[r], y[r], acc[r]);
      }
#pragma unroll
      for (int r = 0; r < DELTA_ROWS; ++r) {
#pragma unroll
        for (int off = T::LANES_PER_ROW / 2; off > 0; off >>= 1)
          acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        if (lane == 0 && at[r] >= 0) sums[at[r]] = acc[r];
      }
    } else {
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
          if (col < d) {
            x[r] = ld_once16(dout + head_base(od, b, h) + (size_t)s * od.ld + col);
            y[r] = ld_once16(o + head_base(ol, b, h) + (size_t)s * ol.ld + col);
          }
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
  }
  __syncthreads();

  constexpr int VECS = DELTA_S_TILE / 4;  // float4s a head's run
  for (int i = threadIdx.x; i < heads * VECS; i += DELTA_THREADS) {
    const int hl = i / VECS, v = i % VECS;
    float4* out = reinterpret_cast<float4*>(delta + ((size_t)b * H + h0 + hl) * S + s0);
    out[v] = *reinterpret_cast<const float4*>(&sums[hl * DELTA_SUMS_LD + 4 * v]);
  }
}

}  // namespace
