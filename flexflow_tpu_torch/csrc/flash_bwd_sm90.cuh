// The attention backward for Hopper (sm_90a): two mainloops that rebuild P
// from the saved lse, one for dK/dV (a block owns key rows and streams the
// query tiles) and one for dQ (a block owns query rows and streams the key
// tiles). Each writes every output row from exactly one block, with no
// atomics, so results repeat bitwise; the pair does 14 s*t*d products per
// (batch, head) (8 in dK/dV, 6 in dQ) where one fused kernel would do 10
// and need atomics or a dQ scratch. Their epilogue is the caller's: the
// flash epilogue writes the gradients as bf16 through a Layout
// (flash_attention.cu: ff_flash_bwd_{dkv,dq}[_d64|_bhsd|_bhsd_d64]_kernel);
// the ring epilogue adds them into the f32 accumulators that a ring step
// carries (ring_flash.cu: ff_ring_{dq,dkv}_step[_d64]_kernel). At padded
// widths 192 and 256 (ff_flash_bwd_{dkv,dq}_{p192,d256}_kernel and their
// per-head and ring kernels) the pair is the head-split mainloops at the end
// of this file, with the same epilogues. Head dims below the padded width
// load as zeros past d (flash_fwd_sm90.cuh's note), so every product is
// exact and the epilogues store only the columns below d.
//
// Replaces, through those kernels, the Pallas kernels _bwd_fused_kernel_b
// (:976), _bwd_onepass_kernel (:1286), _bwd_dq_kernel (:324),
// _bwd_dkv_kernel (:375) and _bwd_pair_core (:1105) of
// flexflow_tpu/kernels/flash_attention.py, and _ring_dq_step_kernel (:121)
// and _ring_dkv_step_kernel (:177) of flexflow_tpu/kernels/ring_flash.py.
//
// What bounds it on an H100: 14*d flops per unmasked (query, key) pair on
// bf16 tensor cores against q, k, v, dO, dq, dk, dv and lse/delta read or
// written once. At s=512 (b=64, h=8, d=128) that is 2.4e11 flops on
// ~0.47 GB: 0.24 ms of products against 0.14 ms of bytes, near the ridge.
// At s=2048 (b=16, h=8) it is bound by operations (0.97 ms at 989 TFLOP/s;
// the chip_smoke bound counts the fused kernel's 10*d, 0.69 ms), and so is
// the ring step at 4x8x8192x128 causal (1.95 ms), where the f32
// accumulators' read and write add ~0.8 GB, and BERT-base's d=256 attention
// at b=64, h=12, s=512 (7.2e11 flops, 0.73 ms; 10*d: 0.52 ms).
//
// Design. A block owns BWD_BM = 128 rows of one (batch, head) as two
// consumer warpgroups of 64 rows (wgmma's M) plus one producer warpgroup,
// and streams tiles of BWD_BN = 64 rows. What each piece does about the
// shared-tile design it replaced (products through an f32 shared
// tile, serial row-by-row softmax passes, synchronous tile loads, fragments
// reloaded from shared memory, outputs staged through shared memory):
// - Products on wgmma. dK/dV: S^T = K Q^T and dP^T = V dO^T are SS
//   m64n64k16 (K or V as A, the Q or dO tile as the K-major B); dV += P^T dO
//   and dK += dS^T Q are RS m64nDk16 with P^T or dS^T as the register A
//   operand and the dO or Q tile as the MN-major B (transpose bit set, as
//   the forward's P V). dQ: S = Q K^T and dP = dO V^T are SS m64n64k16 and
//   dQ += dS K is RS with the K tile MN-major.
// - Registers, not shared memory, hold S, P, dP, dS and the accumulators.
//   The element-wise passes run on the accumulator fragment, each thread
//   on its own 32 values (no shuffles: lse and delta are per column in
//   dK/dV, read from the stage, and per row in dQ, read once); P and dS are
//   rounded to bf16 in registers straight into the A fragments. dK/dV
//   (D/2 + D/2 f32 a thread) and dQ (D/2) stay in registers for the whole
//   loop. In dK/dV, dP^T reuses S^T's registers once P^T is packed, and
//   dS^T overwrites P^T's packed registers, so at d=128 a consumer holds
//   128 accumulator + 32 score + 16 packed registers. In dQ, S and dP are
//   issued together and P is computed while dP is still on the tensor cores.
// - Asynchronous tile loads. One producer thread loads the block's own
//   operands once (K and V, or Q and dO) by TMA and keeps a ring of
//   BwdTiles<D>::STAGES stages of streamed tiles full (Q and dO with their
//   64 lse and delta values by a bulk copy, or K and V), each guarded by a
//   full barrier that counts its bytes and an empty barrier that counts the
//   eight consumer warps after their wgmma on it retired. The tensor maps
//   are the forward's (fwd_tensor_map, boxes of 64 rows).
// - Outputs go from the accumulator registers to global memory once,
//   through the epilogue: bf16 pairs (flash), or f32 pairs added into the
//   carried rows (ring).
// - Occupancy. One block a SM (up to ~166 KB of shared memory at d=128);
//   setmaxnreg gives the consumers 232 registers and the producer 40. With
//   dP^T in S^T's registers and dS^T in P^T's, ptxas reports 0 spill bytes
//   for every backward kernel, flash and ring, so the 32-row
//   query tiles that would halve the score registers are not needed.
// Masking and edges. Every loop bound follows 64-row warpgroups: in dK/dV a
// warpgroup's first query tile is the first that reaches its key rows, in
// dQ its last key tile is the last its query rows reach (the diagonal one),
// so a warpgroup may skip a tile of the block's stream; it still waits for
// and releases the stage, so the producer's barrier counts stay right. A
// block with no tile to stream returns before touching memory, and a
// warpgroup that ran no tile stores nothing: in a ring step, rows that see
// no key (dQ) or that no query reaches (dK/dV) keep their accumulators
// bitwise, and a fully masked step writes nothing.
// Only tiles that cross the diagonal are masked, by global positions
// (q_off + row >= k_off + col), and so are streamed tiles that would pass
// the end of the sequence (none do while S and T are multiples of 64);
// masked entries give p = 0 outright. Where S % 128 == 64 the last block's
// second warpgroup has no rows (its loop bound is then no tile): the
// producer loads only the rows that exist, and that warpgroup computes and
// stores nothing, so no store reaches the next head or batch, and no store
// covers more than its own head's D lanes (the d=64 interleave's dq, dk
// and dv are disjoint lanes of one buffer).

#pragma once

#include "flash_fwd_sm90.cuh"

namespace {

constexpr int BWD_WG_ROWS = 64;          // rows of a consumer warpgroup: wgmma's M
constexpr int BWD_BM = 2 * BWD_WG_ROWS;  // rows a block owns: keys in dK/dV, queries in dQ
constexpr int BWD_BN = 64;               // rows of a streamed tile: the scores are wgmma's N = 64
constexpr int BWD_THREADS = 3 * 128;     // two consumer warpgroups, then the producer

// Shared memory of head dim D: the block's two operands [BWD_BM x D], then
// STAGES stages of two streamed tiles [BWD_BN x D], each as D/64 panels of
// [rows x 64], 1024-byte aligned; in dK/dV the stages' lse and delta
// (BWD_BN f32 each); then the barriers.
template <int D>
struct BwdTiles {
  static_assert(D == 64 || D == 128, "padded width 64 or 128 (wider: SplitTiles)");
  static constexpr int PANELS = D / PANEL;
  static constexpr int STAGES = 3;
  static constexpr uint32_t BLOCK_PANEL = BWD_BM * ROW_BYTES;
  static constexpr uint32_t TILE_PANEL = BWD_BN * ROW_BYTES;
  static constexpr uint32_t BLOCK_BYTES = PANELS * BLOCK_PANEL;  // one of the block's operands
  static constexpr uint32_t TILE_BYTES = PANELS * TILE_PANEL;    // one of a stage's tiles
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr uint32_t ROWS_BYTES = BWD_BN * 4;  // lse or delta of a query tile
  static constexpr uint32_t BARS = 8 * (2 * STAGES + 1);
  static constexpr size_t DQ_SMEM = 1024 + 2 * BLOCK_BYTES + STAGES * STAGE_BYTES + BARS;
  static constexpr size_t DKV_SMEM = DQ_SMEM + STAGES * 2 * ROWS_BYTES;
};

// The first query tile that reaches the key rows [r0, r0 + 64): 0, or under
// the causal mask floor((k_off + r0 - q_off) / BWD_BN) clamped to [0,
// tiles]; `tiles` (none) for rows past T.
__device__ __forceinline__ int bwd_first_q_tile(const FwdShape& sh, int r0) {
  const int tiles = (sh.S + BWD_BN - 1) / BWD_BN;
  if (r0 >= sh.T) return tiles;
  if (!sh.causal) return 0;
  const int x = sh.k_off + r0 - sh.q_off;
  return x <= 0 ? 0 : min(x / BWD_BN, tiles);
}

// -- epilogues ---------------------------------------------------------------------
// load() sets a thread's accumulator rows before the loop and store() writes
// them, times mul, after it; row is the thread's first row of the block.
// store() writes the accumulator's W columns from column col0 (all D at
// once, or a head-split warpgroup's part), those below the head dim only,
// and runs only in a warpgroup that ran at least one tile.

template <int D>
struct FlashGradEpilogue {
  bf16* g;
  Layout grad;

  __device__ __forceinline__ void load(const FwdShape&, int, int, int, float (&acc)[D / 2]) const {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  }

  template <int W = D>
  __device__ __forceinline__ void store(const FwdShape& sh, int bi, int hi, int row,
                                        const float (&acc)[W / 2], float mul, int col0 = 0) const {
    const float both[2] = {mul, mul};
    store_bf16_rows<W>(g + head_base(grad, bi, hi) + col0, grad.ld, row, acc, both, sh.d - col0);
  }
};

// A ring step: g is a contiguous f32 accumulator [b, h, rows, d] (dq: S
// rows; dk, dv: T rows). The registers start at 0 and store() adds mul
// times them into the thread's rows: the carried values are read once and
// never divided by the scale.
template <int D>
struct RingGradEpilogue {
  float* g;
  int rows;

  __device__ __forceinline__ void load(const FwdShape&, int, int, int, float (&acc)[D / 2]) const {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  }

  template <int W = D>
  __device__ __forceinline__ void store(const FwdShape& sh, int bi, int hi, int row,
                                        const float (&acc)[W / 2], float mul, int col0 = 0) const {
    const int c = (threadIdx.x % 4) * 2;
    const size_t r = ((size_t)bi * sh.H + hi) * rows + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = g + (r + 8 * h) * sh.d + col0 + c;
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        if (col0 + 8 * j >= sh.d) continue;
        float2 x = *reinterpret_cast<const float2*>(dst + 8 * j);
        x.x += mul * acc[4 * j + 2 * h];
        x.y += mul * acc[4 * j + 2 * h + 1];
        *reinterpret_cast<float2*>(dst + 8 * j) = x;
      }
    }
  }
};

// -- dK/dV -------------------------------------------------------------------------
// Grid bwd_grid(T, H, B), BWD_THREADS threads, BwdTiles<D>::DKV_SMEM bytes
// of dynamic shared memory; tq, tk, tv and tdo are tensor maps of 64-row
// boxes; lse and delta contiguous [B, H, S] f32 (lse in natural log).
// dK is stored times sh.scale.
template <int D, class Epi>
__device__ __forceinline__ void dkv_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const CUtensorMap* tdo,
                                             const float* __restrict__ lse,
                                             const float* __restrict__ delta, const Epi& dk_epi,
                                             const Epi& dv_epi, const FwdShape& sh) {
  typedef BwdTiles<D> F;
  const int k0 = blockIdx.x * BWD_BM;  // causal: the first blocks see the most query tiles
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int tiles = (sh.S + BWD_BN - 1) / BWD_BN;
  const int f0 = bwd_first_q_tile(sh, k0), f1 = bwd_first_q_tile(sh, k0 + BWD_WG_ROWS);
  const int nq = tiles - f0;  // the block streams query tiles [f0, tiles); f1 >= f0
  if (nq == 0) return;        // no query reaches the block's key rows
  const int kv_boxes = min(BWD_BM, sh.T - k0) / BWD_WG_ROWS;  // 64-row boxes that exist

  extern __shared__ unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024u - (smem_u32(bwd_smem) & 1023u)) & 1023u);
  const uint32_t sK = smem_u32(base), sV = sK + F::BLOCK_BYTES;
  const uint32_t sT = sV + F::BLOCK_BYTES;                 // stage s: Q, then dO
  const uint32_t rows_off = 2 * F::BLOCK_BYTES + F::STAGES * F::STAGE_BYTES;
  const float* rows_s = reinterpret_cast<const float*>(base + rows_off);  // stage s: lse, delta
  const uint32_t sR = sK + rows_off;
  const uint32_t bars = sR + F::STAGES * 2 * F::ROWS_BYTES;
  const uint32_t kv_bar = bars + 16 * F::STAGES;
  init_stages(bars, F::STAGES, kv_bar);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread loads K and V once and keeps the stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      const size_t rows = ((size_t)bi * sh.H + hi) * sh.S;
      mbar_expect_tx(kv_bar, 2 * kv_boxes * F::PANELS * F::TILE_PANEL);
#pragma unroll
      for (int p = 0; p < F::PANELS; ++p)
        for (int x = 0; x < kv_boxes; ++x) {
          const uint32_t off = p * F::BLOCK_PANEL + x * F::TILE_PANEL;
          tma_load(sK + off, tk, kv_bar, p * PANEL, k0 + x * BWD_WG_ROWS, hs, hg, bi);
          tma_load(sV + off, tv, kv_bar, p * PANEL, k0 + x * BWD_WG_ROWS, hs, hg, bi);
        }
      for (int i = 0; i < nq; ++i) {
        const int s = i % F::STAGES, q0 = (f0 + i) * BWD_BN;
        mbar_wait(bars + 8 * (F::STAGES + s), ((i / F::STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, sQ = sT + s * F::STAGE_BYTES;
        mbar_expect_tx(full, F::STAGE_BYTES + 2 * F::ROWS_BYTES);
#pragma unroll
        for (int p = 0; p < F::PANELS; ++p) {
          tma_load(sQ + p * F::TILE_PANEL, tq, full, p * PANEL, q0, hs, hg, bi);
          tma_load(sQ + F::TILE_BYTES + p * F::TILE_PANEL, tdo, full, p * PANEL, q0, hs, hg, bi);
        }
        const uint32_t sr = sR + s * 2 * F::ROWS_BYTES;
        bulk_load(sr, lse + rows + q0, F::ROWS_BYTES, full);
        bulk_load(sr + F::ROWS_BYTES, delta + rows + q0, F::ROWS_BYTES, full);
      }
    }
  } else {
    // consumer warpgroup wg: key rows [r0, r0 + 64) of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = k0 + wg * BWD_WG_ROWS;
    const int first = wg == 0 ? f0 : f1;  // `tiles` for rows past T
    const int row = r0 + (t / 32) * 16 + lane / 4;  // the thread's key rows: row and row + 8
    const int c = (lane % 4) * 2;
    const uint32_t wrows = wg * F::TILE_PANEL;  // the warpgroup's rows in the K and V panels
    const float scale2 = sh.scale * LOG2E;
    float dk[D / 2], dv[D / 2];
    dk_epi.load(sh, bi, hi, row, dk);
    dv_epi.load(sh, bi, hi, row, dv);
    mbar_wait(kv_bar, 0);

    for (int i = 0; i < nq; ++i) {
      const int s = i % F::STAGES, qt = f0 + i, q0 = qt * BWD_BN;
      mbar_wait(bars + 8 * s, (i / F::STAGES) & 1);
      if (qt >= first) {
        const uint32_t sQ = sT + s * F::STAGE_BYTES, sdO = sQ + F::TILE_BYTES;
        const float* lse_s = rows_s + s * 2 * BWD_BN;
        const float* delta_s = lse_s + BWD_BN;
        // S^T = K Q^T, in registers: key rows by query columns
        float st[BWD_BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, kmajor(sK, F::BLOCK_PANEL, wrows, kk), kmajor(sQ, F::TILE_PANEL, 0, kk),
                       kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        hold(st);
        // P^T = exp(S^T scale - lse[col]); masked entries p = 0
        const bool masked = (sh.causal && sh.k_off + r0 + BWD_WG_ROWS - 1 > sh.q_off + q0) ||
                            q0 + BWD_BN > sh.S;
#pragma unroll
        for (int j = 0; j < BWD_BN / 8; ++j) {
          const float2 l = *reinterpret_cast<const float2*>(lse_s + 8 * j + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i2 = 4 * j + e, col = 8 * j + c + (e & 1);
            float p = ex2(st[i2] * scale2 - ((e & 1) ? l.y : l.x) * LOG2E);
            if (masked) {
              const int key = row + 8 * (e >> 1), query = q0 + col;
              if (query >= sh.S || (sh.causal && sh.q_off + query < sh.k_off + key)) p = 0.f;
            }
            st[i2] = p;
          }
        }
        uint32_t pa[BWD_BN / 16][4];
        pack_a<BWD_BN>(pa, st);
        // dV += P^T dO; dP^T = V dO^T into S^T's registers
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BWD_BN / 16; ++kb)
          wgmma_rs<D>(dv, pa[kb], mnmajor(sdO, F::TILE_PANEL, kb));
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(st, kmajor(sV, F::BLOCK_PANEL, wrows, kk), kmajor(sdO, F::TILE_PANEL, 0, kk),
                       kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        hold(dv);
        hold(st);
        hold(pa);
        // dS^T = P^T (dP^T - delta[col]), into P^T's packed registers
#pragma unroll
        for (int kb = 0; kb < BWD_BN / 16; ++kb)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int i2 = 8 * kb + 2 * j;  // columns 16 kb + 8 (j / 2) + c, + 1
            const float2 dl = *reinterpret_cast<const float2*>(delta_s + 16 * kb + 8 * (j / 2) + c);
            const float2 p = unpack_bf16(pa[kb][j]);
            pa[kb][j] = pack_bf16(p.x * (st[i2] - dl.x), p.y * (st[i2 + 1] - dl.y));
          }
        // dK += dS^T Q
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BWD_BN / 16; ++kb)
          wgmma_rs<D>(dk, pa[kb], mnmajor(sQ, F::TILE_PANEL, kb));
        wgmma_commit();
        wgmma_wait_all();
        hold(dk);
        hold(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (F::STAGES + s));  // this warp is done with stage s
    }
    if (first < tiles) {  // it ran a tile: its rows lie before T and a query reaches them
      dk_epi.store(sh, bi, hi, row, dk, sh.scale);
      dv_epi.store(sh, bi, hi, row, dv, 1.f);
    }
  }
}

// -- dQ ------------------------------------------------------------------------------
// Grid bwd_grid(S, H, B), BWD_THREADS threads, BwdTiles<D>::DQ_SMEM bytes
// of dynamic shared memory; maps and lse/delta as dkv_mainloop's. dQ is
// stored times sh.scale.
template <int D, class Epi>
__device__ __forceinline__ void dq_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                            const CUtensorMap* tv, const CUtensorMap* tdo,
                                            const float* __restrict__ lse,
                                            const float* __restrict__ delta, const Epi& epi,
                                            const FwdShape& sh) {
  typedef BwdTiles<D> F;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BWD_BM;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  static_assert(BWD_WG_ROWS == FWD_WG_ROWS, "fwd_k_tiles counts for 64-row warpgroups");
  const int n0 = fwd_k_tiles<BWD_BN>(sh, q0);
  const int n1 = fwd_k_tiles<BWD_BN>(sh, q0 + BWD_WG_ROWS);
  const int nk = max(n0, n1);
  if (nk == 0) return;  // no query row of the block sees a key
  const int q_boxes = min(BWD_BM, sh.S - q0) / BWD_WG_ROWS;  // 64-row boxes that exist

  extern __shared__ unsigned char bwd_smem[];
  const uint32_t sQ = (smem_u32(bwd_smem) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + F::BLOCK_BYTES;
  const uint32_t sT = sdO + F::BLOCK_BYTES;  // stage s: K, then V
  const uint32_t bars = sT + F::STAGES * F::STAGE_BYTES;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  init_stages(bars, F::STAGES, q_bar);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread loads Q and dO once and keeps the stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      mbar_expect_tx(q_bar, 2 * q_boxes * F::PANELS * F::TILE_PANEL);
#pragma unroll
      for (int p = 0; p < F::PANELS; ++p)
        for (int x = 0; x < q_boxes; ++x) {
          const uint32_t off = p * F::BLOCK_PANEL + x * F::TILE_PANEL;
          tma_load(sQ + off, tq, q_bar, p * PANEL, q0 + x * BWD_WG_ROWS, hs, hg, bi);
          tma_load(sdO + off, tdo, q_bar, p * PANEL, q0 + x * BWD_WG_ROWS, hs, hg, bi);
        }
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % F::STAGES;
        mbar_wait(bars + 8 * (F::STAGES + s), ((kt / F::STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, sK = sT + s * F::STAGE_BYTES;
        mbar_expect_tx(full, F::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < F::PANELS; ++p) {
          tma_load(sK + p * F::TILE_PANEL, tk, full, p * PANEL, kt * BWD_BN, hs, hg, bi);
          tma_load(sK + F::TILE_BYTES + p * F::TILE_PANEL, tv, full, p * PANEL, kt * BWD_BN, hs,
                   hg, bi);
        }
      }
    }
  } else {
    // consumer warpgroup wg: query rows [r0, r0 + 64) of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = q0 + wg * BWD_WG_ROWS;
    const int n_mine = wg == 0 ? n0 : n1;
    const int row = r0 + (t / 32) * 16 + lane / 4;  // the thread's query rows: row and row + 8
    const int c = (lane % 4) * 2;
    const uint32_t wrows = wg * F::TILE_PANEL;
    const float scale2 = sh.scale * LOG2E;
    float dq[D / 2], lse2[2], dl[2];
    epi.load(sh, bi, hi, row, dq);
    if (n_mine > 0) {
      const size_t rows = ((size_t)bi * sh.H + hi) * sh.S + row;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        lse2[h] = lse[rows + 8 * h] * LOG2E;
        dl[h] = delta[rows + 8 * h];
      }
    }
    mbar_wait(q_bar, 0);

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % F::STAGES;
      mbar_wait(bars + 8 * s, (kt / F::STAGES) & 1);
      if (kt < n_mine) {
        const uint32_t sK = sT + s * F::STAGE_BYTES, sV = sK + F::TILE_BYTES;
        const int k0 = kt * BWD_BN;
        // S = Q K^T and dP = dO V^T, in registers; P while dP is in flight
        float sc[BWD_BN / 2], dp[BWD_BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(sc, kmajor(sQ, F::BLOCK_PANEL, wrows, kk), kmajor(sK, F::TILE_PANEL, 0, kk),
                       kk > 0);
        wgmma_commit();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64(dp, kmajor(sdO, F::BLOCK_PANEL, wrows, kk), kmajor(sV, F::TILE_PANEL, 0, kk),
                       kk > 0);
        wgmma_commit();
        wgmma_wait_one();
        hold(sc);
        const bool masked = (sh.causal && sh.k_off + k0 + BWD_BN - 1 > sh.q_off + r0) ||
                            k0 + BWD_BN > sh.T;
#pragma unroll
        for (int i = 0; i < BWD_BN / 2; ++i) {
          const int h = (i >> 1) & 1;
          float p = ex2(sc[i] * scale2 - lse2[h]);
          if (masked) {
            const int key = k0 + (i / 4) * 8 + c + (i & 1);
            if (key >= sh.T || (sh.causal && sh.q_off + row + 8 * h < sh.k_off + key)) p = 0.f;
          }
          sc[i] = p;
        }
        wgmma_wait_all();
        hold(dp);
        // dS = P (dP - delta[row]), as the A fragments of dQ += dS K
#pragma unroll
        for (int i = 0; i < BWD_BN / 2; ++i) sc[i] *= dp[i] - dl[(i >> 1) & 1];
        uint32_t da[BWD_BN / 16][4];
        pack_a<BWD_BN>(da, sc);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BWD_BN / 16; ++kb)
          wgmma_rs<D>(dq, da[kb], mnmajor(sK, F::TILE_PANEL, kb));
        wgmma_commit();
        wgmma_wait_all();
        hold(dq);
        hold(da);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (F::STAGES + s));  // this warp is done with stage s
    }
    if (n_mine > 0) epi.store(sh, bi, hi, row, dq, sh.scale);  // rows before S that see a key
  }
}

// -- padded widths 192 and 256: the head dim split between the warpgroups --------
// At D > 128 the mainloops above break: a warpgroup would hold dK and dV of
// 64 rows over all of d, 192 or 256 f32 a thread, beside its scores. So a
// block owns SPLIT_ROWS = 64 rows and streams tiles of 64 rows, and its two
// consumer warpgroups split the head dim: warpgroup 0 accumulates output
// columns [0, 128) of all 64 rows, warpgroup 1 columns [128, D) (128 at
// D=256, 64 at D=192: the panel boundary, so each warpgroup's B operand
// starts on a panel). They split a streamed tile's scores too: w computes
// the tile's score columns [32 w, 32 w + 32) over all of d (SS m64n32k16:
// S^T = K Q^T and dP^T = V dO^T in dK/dV, S = Q K^T and dP = dO V^T in dQ),
// forms its part of P^T and dS^T (or of dS) in registers and stores it,
// rounded to bf16, into a 128-byte-swizzled K-major [64 x 64] tile in shared
// memory. A named barrier joins the two; then each runs its columns of
// dV += P^T dO and dK += dS^T Q (or dQ += dS K) as SS m64n128k16 (or
// m64n64k16) with the whole score tile as A and the streamed operand's
// panels of its columns as the MN-major B. Every product is computed once,
// so the pair does 14 s*t*D flops per (b, h) as at D <= 128; a second
// barrier before the next stores keeps a warpgroup from overwriting the
// tile while the other's products still read it. Loads, barriers, masking,
// the epilogues (flash: bf16 stores; ring: adds into the f32 accumulators)
// and the bitwise repeat are as in the mainloops above.
// What holds it back is the consumers, not the loads: the exchange keeps the
// two warpgroups in step, so both run their element-wise passes, stores
// and barriers at once with no product in flight, and each m64n32k16 reads
// 3 KB of shared memory in its 16 clocks. Keeping a tile's products in
// flight across the next tile's exchange would need a third stage, which
// the 227 KB do not hold at D=256.

constexpr int SPLIT_ROWS = 64;   // rows a block owns and rows of a streamed tile
constexpr int SPLIT_COLS = 32;   // a warpgroup's columns of a streamed tile's scores
constexpr int SPLIT_HALF = 128;  // warpgroup 0's columns of the outputs (1's: D - 128)

// Shared memory at padded width D: the block's two operands [64 x D], STAGES
// stages of two streamed tiles [64 x D], each as D/64 panels of [64 x 64];
// the score tiles (dK/dV: P^T and dS^T; dQ: dS), [64 x 64] bf16 each; in
// dK/dV the stages' lse and delta; then the barriers.
template <int DP>
struct SplitTiles {
  static_assert(DP == 192 || DP == 256, "the head-split mainloops take padded widths 192 and 256");
  static constexpr int D = DP;
  static constexpr int PANELS = D / PANEL;
  static constexpr int STAGES = 2;
  static constexpr uint32_t TILE_PANEL = SPLIT_ROWS * ROW_BYTES;
  static constexpr uint32_t TILE_BYTES = PANELS * TILE_PANEL;  // one [64 x D] operand
  static constexpr uint32_t STAGE_BYTES = 2 * TILE_BYTES;
  static constexpr uint32_t SCORE_BYTES = SPLIT_ROWS * ROW_BYTES;  // one bf16 [64 x 64] tile
  static constexpr uint32_t ROWS_BYTES = SPLIT_ROWS * 4;  // lse or delta of a query tile
  static constexpr uint32_t BARS = 8 * (2 * STAGES + 1);
  static constexpr uint32_t OPERANDS = 2 * TILE_BYTES + STAGES * STAGE_BYTES;
  static constexpr size_t DKV_SMEM =
      1024 + OPERANDS + 2 * SCORE_BYTES + STAGES * 2 * ROWS_BYTES + BARS;
  static constexpr size_t DQ_SMEM = 1024 + OPERANDS + SCORE_BYTES + BARS;
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "a block's shared memory");
};
static_assert(SPLIT_ROWS == BWD_BN && SPLIT_ROWS == FWD_WG_ROWS,
              "bwd_first_q_tile and fwd_k_tiles count 64-row tiles and warpgroups");

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A and B from shared memory (K-major).
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// The first 64 columns of a 128-column accumulator: warpgroup 1's at D=192.
__device__ __forceinline__ float (&low_cols(float (&acc)[SPLIT_HALF / 2]))[32] {
  return *reinterpret_cast<float(*)[32]>(&acc[0]);
}

// The two consumer warpgroups (256 threads) meet at named barrier 1.
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Order this thread's shared-memory stores before later wgmma reads of them
// (wgmma reads through the async proxy).
__device__ __forceinline__ void fence_to_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

// The thread's part of a warpgroup's [64 x 32] score fragment x (columns
// [col0, col0 + 32) of a [64 x 64] tile), rounded to bf16, into the tile at
// shared address dst (1024-byte aligned) as a K-major wgmma operand with
// the 128-byte swizzle, the layout TMA writes: row r's 16-byte chunk j lies
// at r * 128 + 16 * (j ^ (r % 8)). The eight rows of a store fall on
// distinct chunks, so a warp's stores are free of bank conflicts.
__device__ __forceinline__ void store_scores(uint32_t dst, const float (&x)[16], int col0) {
  const int t = threadIdx.x % 128, lane = t % 32;
  const int r = (t / 32) * 16 + lane / 4, c = (lane % 4) * 2;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rr = r + 8 * h, chunk = col0 / 8 + j;
      st_shared_u32(dst + rr * ROW_BYTES + ((chunk ^ (rr & 7)) << 4) + 2 * c,
                    pack_bf16(x[4 * j + 2 * h], x[4 * j + 2 * h + 1]));
    }
}

// dK and dV of 64 key rows at padded width D > 128. Grid split_grid(T, H,
// B), BWD_THREADS threads, SplitTiles<D>::DKV_SMEM bytes of dynamic shared
// memory; tq, tk, tv and tdo are tensor maps of 64-row boxes; lse and delta
// contiguous [B, H, S] f32 (lse in natural log). dK goes out times
// sh.scale, each warpgroup's columns through the epilogues.
template <int D, class Epi>
__device__ __forceinline__ void dkv_mainloop_split(const CUtensorMap* tq, const CUtensorMap* tk,
                                                   const CUtensorMap* tv, const CUtensorMap* tdo,
                                                   const float* __restrict__ lse,
                                                   const float* __restrict__ delta,
                                                   const Epi& dk_epi, const Epi& dv_epi,
                                                   const FwdShape& sh) {
  typedef SplitTiles<D> F;
  const int k0 = blockIdx.x * SPLIT_ROWS;  // causal: the first blocks see the most query tiles
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int tiles = (sh.S + SPLIT_ROWS - 1) / SPLIT_ROWS;
  const int f0 = bwd_first_q_tile(sh, k0);
  const int nq = tiles - f0;  // the block streams query tiles [f0, tiles)
  if (nq == 0) return;        // no query reaches the block's key rows

  extern __shared__ unsigned char bwd_smem[];
  unsigned char* base = bwd_smem + ((1024u - (smem_u32(bwd_smem) & 1023u)) & 1023u);
  const uint32_t sK = smem_u32(base), sV = sK + F::TILE_BYTES;
  const uint32_t sT = sV + F::TILE_BYTES;  // stage s: Q, then dO
  const uint32_t sP = sK + F::OPERANDS, sdS = sP + F::SCORE_BYTES;  // P^T and dS^T
  const uint32_t rows_off = F::OPERANDS + 2 * F::SCORE_BYTES;
  const float* rows_s = reinterpret_cast<const float*>(base + rows_off);  // stage s: lse, delta
  const uint32_t sR = sK + rows_off;
  const uint32_t bars = sR + F::STAGES * 2 * F::ROWS_BYTES;
  const uint32_t kv_bar = bars + 16 * F::STAGES;
  init_stages(bars, F::STAGES, kv_bar);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread loads K and V once and keeps the stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      const size_t rows = ((size_t)bi * sh.H + hi) * sh.S;
      mbar_expect_tx(kv_bar, 2 * F::TILE_BYTES);
#pragma unroll
      for (int p = 0; p < F::PANELS; ++p) {
        tma_load(sK + p * F::TILE_PANEL, tk, kv_bar, p * PANEL, k0, hs, hg, bi);
        tma_load(sV + p * F::TILE_PANEL, tv, kv_bar, p * PANEL, k0, hs, hg, bi);
      }
      for (int i = 0; i < nq; ++i) {
        const int s = i % F::STAGES, q0 = (f0 + i) * SPLIT_ROWS;
        mbar_wait(bars + 8 * (F::STAGES + s), ((i / F::STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, sQ = sT + s * F::STAGE_BYTES;
        mbar_expect_tx(full, F::STAGE_BYTES + 2 * F::ROWS_BYTES);
#pragma unroll
        for (int p = 0; p < F::PANELS; ++p) {
          tma_load(sQ + p * F::TILE_PANEL, tq, full, p * PANEL, q0, hs, hg, bi);
          tma_load(sQ + F::TILE_BYTES + p * F::TILE_PANEL, tdo, full, p * PANEL, q0, hs, hg, bi);
        }
        const uint32_t sr = sR + s * 2 * F::ROWS_BYTES;
        bulk_load(sr, lse + rows + q0, F::ROWS_BYTES, full);
        bulk_load(sr + F::ROWS_BYTES, delta + rows + q0, F::ROWS_BYTES, full);
      }
    }
  } else {
    // consumer warpgroup wg: output columns [128 wg, 128 wg + width) of the
    // block's 64 key rows, score columns [32 wg, 32 wg + 32) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = k0 + (t / 32) * 16 + lane / 4;  // the thread's key rows: row and row + 8
    const int c = (lane % 4) * 2;
    const int col0 = wg * SPLIT_COLS;
    const bool wide = wg == 0 || D == 256;            // 128 output columns, else 64
    const uint32_t cols = col0 * ROW_BYTES;           // those query rows in the tile's panels
    const uint32_t half = wg * 2 * F::TILE_PANEL;     // the panels of its output columns
    const float scale2 = sh.scale * LOG2E;
    float dk_acc[SPLIT_HALF / 2], dv_acc[SPLIT_HALF / 2];
#pragma unroll
    for (int i = 0; i < SPLIT_HALF / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
    mbar_wait(kv_bar, 0);

    for (int i = 0; i < nq; ++i) {
      const int s = i % F::STAGES, q0 = (f0 + i) * SPLIT_ROWS;
      mbar_wait(bars + 8 * s, (i / F::STAGES) & 1);
      const uint32_t sQ = sT + s * F::STAGE_BYTES, sdO = sQ + F::TILE_BYTES;
      const float* lse_s = rows_s + s * 2 * SPLIT_ROWS;
      const float* delta_s = lse_s + SPLIT_ROWS;
      // S^T = K Q^T and dP^T = V dO^T on the warpgroup's 32 query columns
      float st[SPLIT_COLS / 2], dpt[SPLIT_COLS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::D / 16; ++kk)
        wgmma_ss_n32(st, kmajor(sK, F::TILE_PANEL, 0, kk), kmajor(sQ, F::TILE_PANEL, cols, kk),
                     kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < F::D / 16; ++kk)
        wgmma_ss_n32(dpt, kmajor(sV, F::TILE_PANEL, 0, kk), kmajor(sdO, F::TILE_PANEL, cols, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_one();
      hold(st);
      // P^T = exp(S^T scale - lse[col]) while dP^T is in flight; masked entries p = 0
      const bool masked =
          (sh.causal && sh.k_off + k0 + SPLIT_ROWS - 1 > sh.q_off + q0 + col0) ||
          q0 + SPLIT_ROWS > sh.S;
#pragma unroll
      for (int j = 0; j < SPLIT_COLS / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(lse_s + col0 + 8 * j + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(st[4 * j + e] * scale2 - ((e & 1) ? l.y : l.x) * LOG2E);
          if (masked) {
            const int key = row + 8 * (e >> 1), query = q0 + col0 + 8 * j + c + (e & 1);
            if (query >= sh.S || (sh.causal && sh.q_off + query < sh.k_off + key)) p = 0.f;
          }
          st[4 * j + e] = p;
        }
      }
      wgmma_wait_all();
      hold(dpt);
      // dS^T = P^T (dP^T - delta[col])
#pragma unroll
      for (int j = 0; j < SPLIT_COLS / 8; ++j) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col0 + 8 * j + c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - ((e & 1) ? dl.y : dl.x));
      }
      consumers_sync();  // both warpgroups' products of the last tile have retired
      store_scores(sP, st, col0);
      store_scores(sdS, dpt, col0);
      fence_to_wgmma();
      consumers_sync();  // P^T and dS^T are whole
      // dV[:, cols] += P^T dO[:, cols]; dK[:, cols] += dS^T Q[:, cols]
      wgmma_fence();
      if (wide) {
#pragma unroll
        for (int kb = 0; kb < SPLIT_ROWS / 16; ++kb)
          wgmma_ss_n128<1>(dv_acc, kmajor(sP, F::SCORE_BYTES, 0, kb),
                           mnmajor(sdO + half, F::TILE_PANEL, kb), 1);
#pragma unroll
        for (int kb = 0; kb < SPLIT_ROWS / 16; ++kb)
          wgmma_ss_n128<1>(dk_acc, kmajor(sdS, F::SCORE_BYTES, 0, kb),
                           mnmajor(sQ + half, F::TILE_PANEL, kb), 1);
      } else {
#pragma unroll
        for (int kb = 0; kb < SPLIT_ROWS / 16; ++kb)
          wgmma_ss_n64<1>(low_cols(dv_acc), kmajor(sP, F::SCORE_BYTES, 0, kb),
                          mnmajor(sdO + half, F::TILE_PANEL, kb), 1);
#pragma unroll
        for (int kb = 0; kb < SPLIT_ROWS / 16; ++kb)
          wgmma_ss_n64<1>(low_cols(dk_acc), kmajor(sdS, F::SCORE_BYTES, 0, kb),
                          mnmajor(sQ + half, F::TILE_PANEL, kb), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(dv_acc);
      hold(dk_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (F::STAGES + s));  // this warp is done with stage s
    }
    dk_epi.template store<SPLIT_HALF>(sh, bi, hi, row, dk_acc, sh.scale, wg * SPLIT_HALF);
    dv_epi.template store<SPLIT_HALF>(sh, bi, hi, row, dv_acc, 1.f, wg * SPLIT_HALF);
  }
}

// dQ of 64 query rows at padded width D > 128. Grid split_grid(S, H, B),
// BWD_THREADS threads, SplitTiles<D>::DQ_SMEM bytes of dynamic shared
// memory; maps and lse/delta as dkv_mainloop_split's. dQ goes out times
// sh.scale, each warpgroup's columns through the epilogue.
template <int D, class Epi>
__device__ __forceinline__ void dq_mainloop_split(const CUtensorMap* tq, const CUtensorMap* tk,
                                                  const CUtensorMap* tv, const CUtensorMap* tdo,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta, const Epi& epi,
                                                  const FwdShape& sh) {
  typedef SplitTiles<D> F;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * SPLIT_ROWS;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int nk = fwd_k_tiles<SPLIT_ROWS>(sh, q0);
  if (nk == 0) return;  // no query row of the block sees a key

  extern __shared__ unsigned char bwd_smem[];
  const uint32_t sQ = (smem_u32(bwd_smem) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + F::TILE_BYTES;
  const uint32_t sT = sdO + F::TILE_BYTES;  // stage s: K, then V
  const uint32_t sdS = sQ + F::OPERANDS;
  const uint32_t bars = sdS + F::SCORE_BYTES;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  init_stages(bars, F::STAGES, q_bar);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread loads Q and dO once and keeps the stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      mbar_expect_tx(q_bar, 2 * F::TILE_BYTES);
#pragma unroll
      for (int p = 0; p < F::PANELS; ++p) {
        tma_load(sQ + p * F::TILE_PANEL, tq, q_bar, p * PANEL, q0, hs, hg, bi);
        tma_load(sdO + p * F::TILE_PANEL, tdo, q_bar, p * PANEL, q0, hs, hg, bi);
      }
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % F::STAGES;
        mbar_wait(bars + 8 * (F::STAGES + s), ((kt / F::STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, sK = sT + s * F::STAGE_BYTES;
        mbar_expect_tx(full, F::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < F::PANELS; ++p) {
          tma_load(sK + p * F::TILE_PANEL, tk, full, p * PANEL, kt * SPLIT_ROWS, hs, hg, bi);
          tma_load(sK + F::TILE_BYTES + p * F::TILE_PANEL, tv, full, p * PANEL, kt * SPLIT_ROWS,
                   hs, hg, bi);
        }
      }
    }
  } else {
    // consumer warpgroup wg: output columns [128 wg, 128 wg + width) of the
    // block's 64 query rows, score columns [32 wg, 32 wg + 32) of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = q0 + (t / 32) * 16 + lane / 4;  // the thread's query rows: row and row + 8
    const int c = (lane % 4) * 2;
    const int col0 = wg * SPLIT_COLS;
    const bool wide = wg == 0 || D == 256;         // 128 output columns, else 64
    const uint32_t cols = col0 * ROW_BYTES;        // those key rows in the tile's panels
    const uint32_t half = wg * 2 * F::TILE_PANEL;  // the panels of its output columns
    const float scale2 = sh.scale * LOG2E;
    float dq_acc[SPLIT_HALF / 2], lse2[2], dl[2];
#pragma unroll
    for (int i = 0; i < SPLIT_HALF / 2; ++i) dq_acc[i] = 0.f;
    const size_t rows = ((size_t)bi * sh.H + hi) * sh.S + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = lse[rows + 8 * h] * LOG2E;
      dl[h] = delta[rows + 8 * h];
    }
    mbar_wait(q_bar, 0);

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % F::STAGES;
      mbar_wait(bars + 8 * s, (kt / F::STAGES) & 1);
      const uint32_t sK = sT + s * F::STAGE_BYTES, sV = sK + F::TILE_BYTES;
      const int k0 = kt * SPLIT_ROWS;
      // S = Q K^T and dP = dO V^T on the warpgroup's 32 key columns
      float sc[SPLIT_COLS / 2], dp[SPLIT_COLS / 2];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < F::D / 16; ++kk)
        wgmma_ss_n32(sc, kmajor(sQ, F::TILE_PANEL, 0, kk), kmajor(sK, F::TILE_PANEL, cols, kk),
                     kk > 0);
      wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < F::D / 16; ++kk)
        wgmma_ss_n32(dp, kmajor(sdO, F::TILE_PANEL, 0, kk), kmajor(sV, F::TILE_PANEL, cols, kk),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_one();
      hold(sc);
      // P = exp(S scale - lse[row]) while dP is in flight; masked entries p = 0
      const bool masked =
          (sh.causal && sh.k_off + k0 + col0 + SPLIT_COLS - 1 > sh.q_off + q0) ||
          k0 + SPLIT_ROWS > sh.T;
#pragma unroll
      for (int i = 0; i < SPLIT_COLS / 2; ++i) {
        const int h = (i >> 1) & 1;
        float p = ex2(sc[i] * scale2 - lse2[h]);
        if (masked) {
          const int key = k0 + col0 + (i / 4) * 8 + c + (i & 1);
          if (key >= sh.T || (sh.causal && sh.q_off + row + 8 * h < sh.k_off + key)) p = 0.f;
        }
        sc[i] = p;
      }
      wgmma_wait_all();
      hold(dp);
      // dS = P (dP - delta[row])
#pragma unroll
      for (int i = 0; i < SPLIT_COLS / 2; ++i) sc[i] *= dp[i] - dl[(i >> 1) & 1];
      consumers_sync();  // both warpgroups' products of the last tile have retired
      store_scores(sdS, sc, col0);
      fence_to_wgmma();
      consumers_sync();  // dS is whole
      // dQ[:, cols] += dS K[:, cols]
      wgmma_fence();
      if (wide) {
#pragma unroll
        for (int kb = 0; kb < SPLIT_ROWS / 16; ++kb)
          wgmma_ss_n128<1>(dq_acc, kmajor(sdS, F::SCORE_BYTES, 0, kb),
                           mnmajor(sK + half, F::TILE_PANEL, kb), 1);
      } else {
#pragma unroll
        for (int kb = 0; kb < SPLIT_ROWS / 16; ++kb)
          wgmma_ss_n64<1>(low_cols(dq_acc), kmajor(sdS, F::SCORE_BYTES, 0, kb),
                          mnmajor(sK + half, F::TILE_PANEL, kb), 1);
      }
      wgmma_commit();
      wgmma_wait_all();
      hold(dq_acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (F::STAGES + s));  // this warp is done with stage s
    }
    epi.template store<SPLIT_HALF>(sh, bi, hi, row, dq_acc, sh.scale, wg * SPLIT_HALF);
  }
}

}  // namespace

// -- host --------------------------------------------------------------------------

static inline dim3 bwd_grid(int rows, int H, int B) {
  return dim3((rows + BWD_BM - 1) / BWD_BM, H, B);
}

// The grid of the head-split mainloops: one block a 64-row block.
static inline dim3 split_grid(int rows, int H, int B) {
  return dim3((rows + SPLIT_ROWS - 1) / SPLIT_ROWS, H, B);
}

// The grid of the dK/dV or dQ kernel at padded width D over `rows` rows
// (T or S): the 128-row mainloops', or at D > 128 the head-split ones'.
template <int D>
static inline dim3 bwd_grid_of(int rows, int H, int B) {
  return D > 128 ? split_grid(rows, H, B) : bwd_grid(rows, H, B);
}

// Dynamic shared memory of the dK/dV (dkv) or dQ kernel at padded width D.
template <int D>
static constexpr size_t bwd_smem_bytes(bool dkv) {
  if constexpr (D > 128) return dkv ? SplitTiles<D>::DKV_SMEM : SplitTiles<D>::DQ_SMEM;
  else return dkv ? BwdTiles<D>::DKV_SMEM : BwdTiles<D>::DQ_SMEM;
}

// The tensor maps of q and dout (S rows) and of k and v (T rows), head dim
// d, in the backward's 64-row boxes.
static bool bwd_tensor_maps(CUtensorMap (&maps)[4], int d, const void* q, Layout lq,
                            const void* k, Layout lk, const void* v, Layout lv, const void* dout,
                            Layout lo, int S, int T, int H, int B) {
  return fwd_tensor_map(&maps[0], q, lq, d, S, H, B, BWD_BN) &&
         fwd_tensor_map(&maps[1], k, lk, d, T, H, B, BWD_BN) &&
         fwd_tensor_map(&maps[2], v, lv, d, T, H, B, BWD_BN) &&
         fwd_tensor_map(&maps[3], dout, lo, d, S, H, B, BWD_BN);
}
