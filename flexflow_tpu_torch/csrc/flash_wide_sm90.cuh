// The attention mainloops for Hopper (sm_90a) at head dims past 256: the
// forward, dK/dV and dQ of flash_wide.cu's kernels, flash and ring alike,
// each with the epilogues the narrow mainloops take (FlashEpilogue and
// RingEpilogue of flash_fwd_sm90.cuh, FlashGradEpilogue and
// RingGradEpilogue of flash_bwd_sm90.cuh).
//
// Replaces, through those kernels, the Pallas kernels _fwd_kernel_b (:674),
// _fwd_kernel (:164), _bwd_fused_kernel_b (:976), _bwd_onepass_kernel
// (:1286), _bwd_dq_kernel (:324) and _bwd_dkv_kernel (:375) of
// flexflow_tpu/kernels/flash_attention.py, and _ring_fwd_step_kernel (:58),
// _ring_dq_step_kernel (:121) and _ring_dkv_step_kernel (:177) of
// flexflow_tpu/kernels/ring_flash.py, at every d % 8 == 0 past 256 (their
// range has no upper bound).
//
// Why the narrow mainloops stop at 256: a block keeps its own rows' operands
// over the whole head dim in shared memory and its outputs' D/2 f32 a thread
// in registers. At a padded width of 320 the forward's Q tile and two K/V
// stages, or the head-split backward's operands, pass the 232448 bytes of
// shared memory a block has, and at d=512 the forward's O would be 256
// registers a thread, past the consumers' 232.
//
// Design: the output's columns are split. A block owns a chunk of WIDE_DC =
// 256 output columns of its rows (the grid's x axis runs over row tiles and
// chunks, the chunks of one row tile side by side); every block computes the
// whole score tile over all of d, and applies it to its own chunk only.
// - Scores over panels. The head dim is streamed through shared memory in
//   64-column panels (128-byte swizzled, by TMA, the narrow kernels' tensor
//   maps): a ring of panel stages, each the panel of every operand the
//   scores need, so no operand has to fit whole (Q of 128 rows at d=1024 is
//   256 KB). S = Q K^T (and dP = dO V^T in the backward) accumulate panel by
//   panel on wgmma in registers; a panel's stage is released once the
//   product on it has retired, one product kept in flight.
// - The chunk's products. The forward applies P to its chunk of V (a stage
//   of four V panels, O += P V as at d=256: two m64n128k16 on register P);
//   the backward stores P^T and dS^T (dQ: dS) as bf16 score tiles in shared
//   memory, as the head-split mainloops do, and each consumer warpgroup runs
//   its 128 columns of dV += P^T dO and dK += dS^T Q (dQ += dS K) on a chunk
//   stage holding those operands' four panels of the chunk.
// - Registers as at d=256: the forward's consumers hold O's 128 f32, S's 32
//   and P's 16 packed (64-row warpgroups, 64-key tiles); the backward's
//   their 64 + 64 accumulator and 16 + 16 score values (64-row blocks, 32
//   score columns a warpgroup).
// - Tails. A panel or chunk past d loads nothing: the tensor maps' column
//   extent is d, so a panel across d loads zeros past it, chunk panels that
//   lie wholly past d are not loaded (their stale columns reach only output
//   columns past d), and the epilogues store only the columns below d.
// - Row state. Every chunk of a forward row computes the same (m, l) from
//   the same products in the same order; chunk 0 alone writes lse, or the
//   ring's (m, l). The ring step reads (m, l) from one buffer and writes
//   them to another (RingWideEpilogue): a chunk's block may run after chunk
//   0 has written its rows, so an update in place would race. Rows that see
//   no key in a step have their (m, l) copied across, and keep acc.
// - Causal masks, loop bounds, the early return of a block with nothing to
//   do, and bitwise repeat (no atomics, one block a written element) are
//   the narrow mainloops'.
// What this costs: the score products once per chunk. Per unmasked (query,
// key) pair the forward does 2*d*ceil(d/256) + 2*256*ceil(d/256) flops
// (against 4*d: 1.5x at d=512 and 1024, 2x at d=384, 3x at d=264) and the
// backward pair 4*d*ceil(d/256) (dK/dV) + 4*d*ceil(d/256) (dQ) + 6*256*
// ceil(d/256) (against 10*d); the panels are re-read per key or query tile
// from L2. A simple layout that is right: making it faster is later work.

#pragma once

#include "flash_bwd_sm90.cuh"

namespace {

constexpr int WIDE_DC = 256;                     // output columns of a block: its chunk
constexpr int WIDE_ROWS = 64;                    // rows of a streamed tile, and of a backward block
constexpr int WIDE_HALF = 128;                   // output columns of a backward consumer warpgroup
constexpr int WIDE_CHUNK_PANELS = WIDE_DC / PANEL;
constexpr uint32_t WIDE_PANEL = WIDE_ROWS * ROW_BYTES;  // one [64 x 64] bf16 panel

__host__ __device__ __forceinline__ int wide_chunks(int d) {
  return (d + WIDE_DC - 1) / WIDE_DC;
}

__host__ __device__ __forceinline__ int wide_panels(int d) {
  return (d + PANEL - 1) / PANEL;
}

// Forward shared memory: QK_STAGES stages of a Q panel [128 x 64] and a K
// panel [64 x 64], V_STAGES stages of a chunk of V [64 x 256] as four
// panels; then the barriers of both rings.
struct WideFwdTiles {
  static constexpr int QK_STAGES = 4, V_STAGES = 2;
  static constexpr uint32_t Q_PANEL = FWD_BM * ROW_BYTES;
  static constexpr uint32_t QK_STAGE = Q_PANEL + WIDE_PANEL;
  static constexpr uint32_t V_STAGE = WIDE_CHUNK_PANELS * WIDE_PANEL;
  static constexpr uint32_t BARS = 8 * 2 * (QK_STAGES + V_STAGES);
  static constexpr size_t SMEM = 1024 + QK_STAGES * QK_STAGE + V_STAGES * V_STAGE + BARS;
  static_assert(SMEM <= 232448, "a block's shared memory");
};

// Backward shared memory: STAGES panel stages of four [64 x 64] panels
// (dK/dV: K, V, Q, dO; dQ: Q, dO, K, V), one chunk stage (dK/dV: Q's and
// dO's four panels of the chunk, then the tile's lse and delta; dQ: K's),
// the bf16 score tiles (dK/dV: P^T and dS^T; dQ: dS), then the barriers.
struct WideBwdTiles {
  static constexpr int STAGES = 3;
  static constexpr uint32_t PANEL_STAGE = 4 * WIDE_PANEL;
  static constexpr uint32_t CHUNK = WIDE_CHUNK_PANELS * WIDE_PANEL;  // one operand's chunk
  static constexpr uint32_t SCORE_BYTES = WIDE_ROWS * ROW_BYTES;
  static constexpr uint32_t ROWS_BYTES = WIDE_ROWS * 4;  // lse or delta of a query tile
  static constexpr uint32_t BARS = 8 * 2 * (STAGES + 1);
  static constexpr size_t DKV_SMEM =
      1024 + STAGES * PANEL_STAGE + 2 * CHUNK + 2 * SCORE_BYTES + 2 * ROWS_BYTES + BARS;
  static constexpr size_t DQ_SMEM = 1024 + STAGES * PANEL_STAGE + CHUNK + SCORE_BYTES + BARS;
  static_assert(DKV_SMEM <= 232448 && DQ_SMEM <= 232448, "a block's shared memory");
};
static_assert(WIDE_ROWS == FWD_WG_ROWS && WIDE_ROWS == BWD_BN && WIDE_ROWS == SPLIT_ROWS,
              "fwd_k_tiles, bwd_first_q_tile and store_scores count 64-row tiles");

// Two rings of stages, at bars_a (na stages) and bars_b (nb): each stage's
// full barrier (one arrival: the producer's) at bars + 8 s and its empty
// barrier (eight: each warp of both consumer warpgroups) at
// bars + 8 (n + s); then the block syncs.
__device__ __forceinline__ void init_rings(uint32_t bars_a, int na, uint32_t bars_b, int nb) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < na; ++s) {
      mbar_init(bars_a + 8 * s, 1);
      mbar_init(bars_a + 8 * (na + s), 8);
    }
    for (int s = 0; s < nb; ++s) {
      mbar_init(bars_b + 8 * s, 1);
      mbar_init(bars_b + 8 * (nb + s), 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The use `i` of a ring of n stages at bars: wait for its stage to fill
// (consumer) or to empty (producer); release it (a consumer warp, after its
// products on it retired).
__device__ __forceinline__ void wait_full(uint32_t bars, int n, int i) {
  mbar_wait(bars + 8 * (i % n), (i / n) & 1);
}

__device__ __forceinline__ void wait_empty(uint32_t bars, int n, int i) {
  mbar_wait(bars + 8 * (n + i % n), ((i / n) & 1) ^ 1);
}

__device__ __forceinline__ void release(uint32_t bars, int n, int i) {
  __syncwarp();
  if (threadIdx.x % 32 == 0) mbar_arrive(bars + 8 * (n + i % n));
}

// A ring step's epilogue at a column chunk: acc is updated in place (the
// chunks' columns are disjoint), (m, l) are read from m_in, l_in and
// written, by chunk 0, to m_out, l_out.
template <int W>
struct RingWideEpilogue {
  float* acc;
  const float* m_in;
  const float* l_in;
  float* m_out;
  float* l_out;

  __device__ __forceinline__ void load(const FwdShape& sh, int bi, int hi, int row,
                                       float (&a)[W / 2], float (&mr)[2], float (&lr)[2],
                                       int col0) const {
    RingEpilogue<W>{acc, const_cast<float*>(m_in), const_cast<float*>(l_in)}.load(
        sh, bi, hi, row, a, mr, lr, col0);
  }

  __device__ __forceinline__ void store(const FwdShape& sh, int bi, int hi, int row,
                                        const float (&a)[W / 2], const float (&mr)[2],
                                        const float (&lr)[2], int col0) const {
    RingEpilogue<W>{acc, m_out, l_out}.store(sh, bi, hi, row, a, mr, lr, col0);
  }

  // rows that see no key keep their state: (m, l) copied across
  __device__ __forceinline__ void keep(const FwdShape& sh, int bi, int hi, int row,
                                       int col0) const {
    if (col0 != 0 || threadIdx.x % 4 != 0) return;
    const size_t rows = ((size_t)bi * sh.H + hi) * sh.S + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      m_out[rows + 8 * h] = m_in[rows + 8 * h];
      l_out[rows + 8 * h] = l_in[rows + 8 * h];
    }
  }
};

// -- the forward -------------------------------------------------------------------
// Grid wide_fwd_grid(S, H, B, d), FWD_THREADS threads, WideFwdTiles::SMEM
// bytes of dynamic shared memory. tq is a tensor map of FWD_BM-row boxes, tk
// and tv of WIDE_ROWS-row boxes (fwd_tensor_map).
template <class Epi>
__device__ __forceinline__ void wide_fwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                                  const CUtensorMap* tv, const Epi& epi,
                                                  const FwdShape& sh) {
  typedef WideFwdTiles F;
  constexpr int BN = WIDE_ROWS;
  const int nc = wide_chunks(sh.d);
  const int c0 = blockIdx.x % nc * WIDE_DC;                   // the block's chunk
  const int q0 = (gridDim.x / nc - 1 - blockIdx.x / nc) * FWD_BM;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int n0 = fwd_k_tiles<BN>(sh, q0), n1 = fwd_k_tiles<BN>(sh, q0 + FWD_WG_ROWS);
  const int nk = max(n0, n1);
  const int wg = threadIdx.x / 128;
  if (nk == 0) {  // no row of the block sees a key: each row keeps its state
    const int t = threadIdx.x % 128, r0 = q0 + wg * FWD_WG_ROWS;
    if (wg < 2 && r0 < sh.S) epi.keep(sh, bi, hi, r0 + (t / 32) * 16 + t % 32 / 4, c0);
    return;
  }
  const int np = wide_panels(sh.d);
  const int vp = min(WIDE_CHUNK_PANELS, wide_panels(sh.d - c0));  // chunk panels below d

  extern __shared__ unsigned char wide_smem[];
  const uint32_t sQK = (smem_u32(wide_smem) + 1023u) & ~1023u;
  const uint32_t sV = sQK + F::QK_STAGES * F::QK_STAGE;
  const uint32_t qk_bars = sV + F::V_STAGES * F::V_STAGE;
  const uint32_t v_bars = qk_bars + 16 * F::QK_STAGES;
  init_rings(qk_bars, F::QK_STAGES, v_bars, F::V_STAGES);

  if (wg == 2) {
    // producer: one thread keeps both rings full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      int i = 0;  // panel stages issued
      for (int kt = 0; kt < nk; ++kt) {
        for (int p = 0; p < np; ++p, ++i) {
          wait_empty(qk_bars, F::QK_STAGES, i);
          const uint32_t full = qk_bars + 8 * (i % F::QK_STAGES);
          const uint32_t dst = sQK + (i % F::QK_STAGES) * F::QK_STAGE;
          mbar_expect_tx(full, F::QK_STAGE);
          tma_load(dst, tq, full, p * PANEL, q0, hs, hg, bi);
          tma_load(dst + F::Q_PANEL, tk, full, p * PANEL, kt * BN, hs, hg, bi);
        }
        wait_empty(v_bars, F::V_STAGES, kt);
        const uint32_t full = v_bars + 8 * (kt % F::V_STAGES);
        const uint32_t dst = sV + (kt % F::V_STAGES) * F::V_STAGE;
        mbar_expect_tx(full, vp * WIDE_PANEL);
        for (int p = 0; p < vp; ++p)
          tma_load(dst + p * WIDE_PANEL, tv, full, c0 + p * PANEL, kt * BN, hs, hg, bi);
      }
    }
  } else {
    // consumer warpgroup wg: rows [r0, r0 + 64) of the block, the chunk's columns
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = q0 + wg * FWD_WG_ROWS;
    const int n_mine = wg == 0 ? n0 : n1;
    const int row = r0 + (t / 32) * 16 + lane / 4;  // the thread's rows: row and row + 8
    const int c = (lane % 4) * 2;
    const uint32_t wrows = wg * FWD_WG_ROWS * ROW_BYTES;  // the warpgroup's rows in a Q panel
    float o[WIDE_DC / 2], m[2], l[2];
    if (n_mine > 0) epi.load(sh, bi, hi, row, o, m, l, c0);

    int i = 0;  // panel stages consumed
    for (int kt = 0; kt < nk; ++kt) {
      const bool mine = kt < n_mine;
      const int k0 = kt * BN;
      // S = Q K^T over the head dim's panels, in registers
      float sc[BN / 2];
      for (int p = 0; p < np; ++p, ++i) {
        wait_full(qk_bars, F::QK_STAGES, i);
        if (!mine) {
          release(qk_bars, F::QK_STAGES, i);
          continue;
        }
        const uint32_t sq = sQK + (i % F::QK_STAGES) * F::QK_STAGE, sk = sq + F::Q_PANEL;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PANEL / 16; ++kk)
          wgmma_ss<BN>(sc, kmajor(sq, F::Q_PANEL, wrows, kk), kmajor(sk, WIDE_PANEL, 0, kk),
                       p > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_one();  // the last panel's product has retired: release its stage
        if (p > 0) release(qk_bars, F::QK_STAGES, i - 1);
      }
      if (mine) {
        wgmma_wait_all();
        hold(sc);
        release(qk_bars, F::QK_STAGES, i - 1);
        const bool masked = (sh.causal && sh.k_off + k0 + BN - 1 > sh.q_off + r0) ||
                            k0 + BN > sh.T;
        if (masked) online_softmax<true, WIDE_DC, BN>(sc, o, m, l, sh, row, k0, c);
        else online_softmax<false, WIDE_DC, BN>(sc, o, m, l, sh, row, k0, c);
      }
      wait_full(v_bars, F::V_STAGES, kt);
      if (mine) {
        // O[:, chunk] += P V[:, chunk], P in bf16 as the A fragments: 16 keys each
        const uint32_t sv = sV + (kt % F::V_STAGES) * F::V_STAGE;
        uint32_t pa[BN / 16][4];
        pack_a<BN>(pa, sc);
        hold(o);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BN / 16; ++kb)
          wgmma_rs<WIDE_DC>(o, pa[kb], mnmajor(sv, WIDE_PANEL, kb), 2 * WIDE_PANEL);
        wgmma_commit();
        wgmma_wait_all();
        hold(o);
        hold(pa);
      }
      release(v_bars, F::V_STAGES, kt);
    }
    if (n_mine > 0) epi.store(sh, bi, hi, row, o, m, l, c0);
    else if (r0 < sh.S) epi.keep(sh, bi, hi, row, c0);
  }
}

// -- dK/dV -------------------------------------------------------------------------
// Grid wide_bwd_grid(T, H, B, d), BWD_THREADS threads, WideBwdTiles::DKV_SMEM
// bytes of dynamic shared memory; tq, tk, tv and tdo are tensor maps of
// 64-row boxes; lse and delta contiguous [B, H, S] f32 (lse in natural log).
// A block owns 64 key rows and a chunk; its warpgroup w computes score
// columns [32 w, 32 w + 32) of each query tile over all of d and output
// columns [c0 + 128 w, c0 + 128 w + 128). dK goes out times sh.scale.
template <class Epi>
__device__ __forceinline__ void wide_dkv_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                                  const CUtensorMap* tv, const CUtensorMap* tdo,
                                                  const float* __restrict__ lse,
                                                  const float* __restrict__ delta,
                                                  const Epi& dk_epi, const Epi& dv_epi,
                                                  const FwdShape& sh) {
  typedef WideBwdTiles F;
  const int nc = wide_chunks(sh.d);
  const int c0 = blockIdx.x % nc * WIDE_DC;
  const int k0 = blockIdx.x / nc * WIDE_ROWS;  // causal: the first blocks see the most query tiles
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int tiles = (sh.S + WIDE_ROWS - 1) / WIDE_ROWS;
  const int f0 = bwd_first_q_tile(sh, k0);
  const int nq = tiles - f0;  // the block streams query tiles [f0, tiles)
  if (nq == 0) return;        // no query reaches the block's key rows
  const int np = wide_panels(sh.d);
  const int cp = min(WIDE_CHUNK_PANELS, wide_panels(sh.d - c0));  // chunk panels below d

  extern __shared__ unsigned char wide_smem[];
  unsigned char* base = wide_smem + ((1024u - (smem_u32(wide_smem) & 1023u)) & 1023u);
  const uint32_t sP0 = smem_u32(base);  // panel stage s: K, V, Q, dO
  const uint32_t sQc = sP0 + F::STAGES * F::PANEL_STAGE, sdOc = sQc + F::CHUNK;
  const uint32_t sP = sdOc + F::CHUNK, sdS = sP + F::SCORE_BYTES;  // P^T and dS^T
  const uint32_t rows_off = sdS + F::SCORE_BYTES - sP0;
  const float* lse_s = reinterpret_cast<const float*>(base + rows_off);
  const float* delta_s = lse_s + WIDE_ROWS;
  const uint32_t sR = sP0 + rows_off;
  const uint32_t bars = sR + 2 * F::ROWS_BYTES, c_bars = bars + 16 * F::STAGES;
  init_rings(bars, F::STAGES, c_bars, 1);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the panel stages and the chunk stage full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      const size_t rows = ((size_t)bi * sh.H + hi) * sh.S;
      int j = 0;  // panel stages issued
      for (int i = 0; i < nq; ++i) {
        const int q0 = (f0 + i) * WIDE_ROWS;
        for (int p = 0; p < np; ++p, ++j) {
          wait_empty(bars, F::STAGES, j);
          const uint32_t full = bars + 8 * (j % F::STAGES);
          const uint32_t dst = sP0 + (j % F::STAGES) * F::PANEL_STAGE;
          mbar_expect_tx(full, F::PANEL_STAGE);
          tma_load(dst, tk, full, p * PANEL, k0, hs, hg, bi);
          tma_load(dst + WIDE_PANEL, tv, full, p * PANEL, k0, hs, hg, bi);
          tma_load(dst + 2 * WIDE_PANEL, tq, full, p * PANEL, q0, hs, hg, bi);
          tma_load(dst + 3 * WIDE_PANEL, tdo, full, p * PANEL, q0, hs, hg, bi);
        }
        wait_empty(c_bars, 1, i);
        mbar_expect_tx(c_bars, 2 * cp * WIDE_PANEL + 2 * F::ROWS_BYTES);
        for (int p = 0; p < cp; ++p) {
          tma_load(sQc + p * WIDE_PANEL, tq, c_bars, c0 + p * PANEL, q0, hs, hg, bi);
          tma_load(sdOc + p * WIDE_PANEL, tdo, c_bars, c0 + p * PANEL, q0, hs, hg, bi);
        }
        bulk_load(sR, lse + rows + q0, F::ROWS_BYTES, c_bars);
        bulk_load(sR + F::ROWS_BYTES, delta + rows + q0, F::ROWS_BYTES, c_bars);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = k0 + (t / 32) * 16 + lane / 4;  // the thread's key rows: row and row + 8
    const int c = (lane % 4) * 2;
    const int col0 = wg * SPLIT_COLS;              // its score columns of a tile
    const uint32_t cols = col0 * ROW_BYTES;        // those query rows in a tile's panel
    const uint32_t half = wg * 2 * WIDE_PANEL;     // the chunk panels of its output columns
    const float scale2 = sh.scale * LOG2E;
    float dk_acc[WIDE_HALF / 2], dv_acc[WIDE_HALF / 2];
#pragma unroll
    for (int x = 0; x < WIDE_HALF / 2; ++x) dk_acc[x] = dv_acc[x] = 0.f;

    int j = 0;  // panel stages consumed
    for (int i = 0; i < nq; ++i) {
      const int q0 = (f0 + i) * WIDE_ROWS;
      // S^T = K Q^T and dP^T = V dO^T on the warpgroup's 32 query columns,
      // over the head dim's panels
      float st[SPLIT_COLS / 2], dpt[SPLIT_COLS / 2];
      for (int p = 0; p < np; ++p, ++j) {
        wait_full(bars, F::STAGES, j);
        const uint32_t sk = sP0 + (j % F::STAGES) * F::PANEL_STAGE, sv = sk + WIDE_PANEL;
        const uint32_t sq = sv + WIDE_PANEL, sdo = sq + WIDE_PANEL;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PANEL / 16; ++kk)
          wgmma_ss_n32(st, kmajor(sk, WIDE_PANEL, 0, kk), kmajor(sq, WIDE_PANEL, cols, kk),
                       p > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < PANEL / 16; ++kk)
          wgmma_ss_n32(dpt, kmajor(sv, WIDE_PANEL, 0, kk), kmajor(sdo, WIDE_PANEL, cols, kk),
                       p > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_one();
        if (p > 0) release(bars, F::STAGES, j - 1);
      }
      wgmma_wait_all();
      hold(st);
      hold(dpt);
      release(bars, F::STAGES, j - 1);
      wait_full(c_bars, 1, i);  // the tile's chunk, lse and delta
      // P^T = exp(S^T scale - lse[col]); masked entries p = 0
      const bool masked = (sh.causal && sh.k_off + k0 + WIDE_ROWS - 1 > sh.q_off + q0 + col0) ||
                          q0 + WIDE_ROWS > sh.S;
#pragma unroll
      for (int x = 0; x < SPLIT_COLS / 8; ++x) {
        const float2 lv = *reinterpret_cast<const float2*>(lse_s + col0 + 8 * x + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = ex2(st[4 * x + e] * scale2 - ((e & 1) ? lv.y : lv.x) * LOG2E);
          if (masked) {
            const int key = row + 8 * (e >> 1), query = q0 + col0 + 8 * x + c + (e & 1);
            if (query >= sh.S || (sh.causal && sh.q_off + query < sh.k_off + key)) p = 0.f;
          }
          st[4 * x + e] = p;
        }
      }
      // dS^T = P^T (dP^T - delta[col])
#pragma unroll
      for (int x = 0; x < SPLIT_COLS / 8; ++x) {
        const float2 dl = *reinterpret_cast<const float2*>(delta_s + col0 + 8 * x + c);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[4 * x + e] = st[4 * x + e] * (dpt[4 * x + e] - ((e & 1) ? dl.y : dl.x));
      }
      consumers_sync();  // both warpgroups' products of the last tile have retired
      store_scores(sP, st, col0);
      store_scores(sdS, dpt, col0);
      fence_to_wgmma();
      consumers_sync();  // P^T and dS^T are whole
      // dV[:, cols] += P^T dO[:, cols]; dK[:, cols] += dS^T Q[:, cols]
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < WIDE_ROWS / 16; ++kb)
        wgmma_ss_n128<1>(dv_acc, kmajor(sP, F::SCORE_BYTES, 0, kb),
                         mnmajor(sdOc + half, WIDE_PANEL, kb), 1);
#pragma unroll
      for (int kb = 0; kb < WIDE_ROWS / 16; ++kb)
        wgmma_ss_n128<1>(dk_acc, kmajor(sdS, F::SCORE_BYTES, 0, kb),
                         mnmajor(sQc + half, WIDE_PANEL, kb), 1);
      wgmma_commit();
      wgmma_wait_all();
      hold(dv_acc);
      hold(dk_acc);
      release(c_bars, 1, i);
    }
    const int out0 = c0 + wg * WIDE_HALF;
    dk_epi.template store<WIDE_HALF>(sh, bi, hi, row, dk_acc, sh.scale, out0);
    dv_epi.template store<WIDE_HALF>(sh, bi, hi, row, dv_acc, 1.f, out0);
  }
}

// -- dQ ------------------------------------------------------------------------------
// Grid wide_bwd_grid(S, H, B, d), BWD_THREADS threads, WideBwdTiles::DQ_SMEM
// bytes of dynamic shared memory; maps and lse/delta as wide_dkv_mainloop's.
// A block owns 64 query rows and a chunk; warpgroup w computes score
// columns [32 w, 32 w + 32) of each key tile and output columns
// [c0 + 128 w, c0 + 128 w + 128). dQ goes out times sh.scale.
template <class Epi>
__device__ __forceinline__ void wide_dq_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                                 const CUtensorMap* tv, const CUtensorMap* tdo,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta, const Epi& epi,
                                                 const FwdShape& sh) {
  typedef WideBwdTiles F;
  const int nc = wide_chunks(sh.d);
  const int c0 = blockIdx.x % nc * WIDE_DC;
  const int q0 = (gridDim.x / nc - 1 - blockIdx.x / nc) * WIDE_ROWS;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int nk = fwd_k_tiles<WIDE_ROWS>(sh, q0);
  if (nk == 0) return;  // no query row of the block sees a key
  const int np = wide_panels(sh.d);
  const int cp = min(WIDE_CHUNK_PANELS, wide_panels(sh.d - c0));

  extern __shared__ unsigned char wide_smem[];
  const uint32_t sP0 = (smem_u32(wide_smem) + 1023u) & ~1023u;  // panel stage s: Q, dO, K, V
  const uint32_t sKc = sP0 + F::STAGES * F::PANEL_STAGE;
  const uint32_t sdS = sKc + F::CHUNK;
  const uint32_t bars = sdS + F::SCORE_BYTES, c_bars = bars + 16 * F::STAGES;
  init_rings(bars, F::STAGES, c_bars, 1);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      int j = 0;
      for (int kt = 0; kt < nk; ++kt) {
        const int k0 = kt * WIDE_ROWS;
        for (int p = 0; p < np; ++p, ++j) {
          wait_empty(bars, F::STAGES, j);
          const uint32_t full = bars + 8 * (j % F::STAGES);
          const uint32_t dst = sP0 + (j % F::STAGES) * F::PANEL_STAGE;
          mbar_expect_tx(full, F::PANEL_STAGE);
          tma_load(dst, tq, full, p * PANEL, q0, hs, hg, bi);
          tma_load(dst + WIDE_PANEL, tdo, full, p * PANEL, q0, hs, hg, bi);
          tma_load(dst + 2 * WIDE_PANEL, tk, full, p * PANEL, k0, hs, hg, bi);
          tma_load(dst + 3 * WIDE_PANEL, tv, full, p * PANEL, k0, hs, hg, bi);
        }
        wait_empty(c_bars, 1, kt);
        mbar_expect_tx(c_bars, cp * WIDE_PANEL);
        for (int p = 0; p < cp; ++p)
          tma_load(sKc + p * WIDE_PANEL, tk, c_bars, c0 + p * PANEL, k0, hs, hg, bi);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int row = q0 + (t / 32) * 16 + lane / 4;  // the thread's query rows: row and row + 8
    const int c = (lane % 4) * 2;
    const int col0 = wg * SPLIT_COLS;
    const uint32_t cols = col0 * ROW_BYTES;
    const uint32_t half = wg * 2 * WIDE_PANEL;
    const float scale2 = sh.scale * LOG2E;
    float dq_acc[WIDE_HALF / 2], lse2[2], dl[2];
#pragma unroll
    for (int x = 0; x < WIDE_HALF / 2; ++x) dq_acc[x] = 0.f;
    const size_t rows = ((size_t)bi * sh.H + hi) * sh.S + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = lse[rows + 8 * h] * LOG2E;
      dl[h] = delta[rows + 8 * h];
    }

    int j = 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int k0 = kt * WIDE_ROWS;
      // S = Q K^T and dP = dO V^T on the warpgroup's 32 key columns, over
      // the head dim's panels
      float sc[SPLIT_COLS / 2], dp[SPLIT_COLS / 2];
      for (int p = 0; p < np; ++p, ++j) {
        wait_full(bars, F::STAGES, j);
        const uint32_t sq = sP0 + (j % F::STAGES) * F::PANEL_STAGE, sdo = sq + WIDE_PANEL;
        const uint32_t sk = sdo + WIDE_PANEL, sv = sk + WIDE_PANEL;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < PANEL / 16; ++kk)
          wgmma_ss_n32(sc, kmajor(sq, WIDE_PANEL, 0, kk), kmajor(sk, WIDE_PANEL, cols, kk),
                       p > 0 || kk > 0);
#pragma unroll
        for (int kk = 0; kk < PANEL / 16; ++kk)
          wgmma_ss_n32(dp, kmajor(sdo, WIDE_PANEL, 0, kk), kmajor(sv, WIDE_PANEL, cols, kk),
                       p > 0 || kk > 0);
        wgmma_commit();
        wgmma_wait_one();
        if (p > 0) release(bars, F::STAGES, j - 1);
      }
      wgmma_wait_all();
      hold(sc);
      hold(dp);
      release(bars, F::STAGES, j - 1);
      // P = exp(S scale - lse[row]); masked entries p = 0; dS = P (dP - delta[row])
      const bool masked = (sh.causal && sh.k_off + k0 + col0 + SPLIT_COLS - 1 > sh.q_off + q0) ||
                          k0 + WIDE_ROWS > sh.T;
#pragma unroll
      for (int x = 0; x < SPLIT_COLS / 2; ++x) {
        const int h = (x >> 1) & 1;
        float p = ex2(sc[x] * scale2 - lse2[h]);
        if (masked) {
          const int key = k0 + col0 + (x / 4) * 8 + c + (x & 1);
          if (key >= sh.T || (sh.causal && sh.q_off + row + 8 * h < sh.k_off + key)) p = 0.f;
        }
        sc[x] = p * (dp[x] - dl[h]);
      }
      wait_full(c_bars, 1, kt);  // the key tile's chunk
      consumers_sync();  // both warpgroups' products of the last tile have retired
      store_scores(sdS, sc, col0);
      fence_to_wgmma();
      consumers_sync();  // dS is whole
      // dQ[:, cols] += dS K[:, cols]
      wgmma_fence();
#pragma unroll
      for (int kb = 0; kb < WIDE_ROWS / 16; ++kb)
        wgmma_ss_n128<1>(dq_acc, kmajor(sdS, F::SCORE_BYTES, 0, kb),
                         mnmajor(sKc + half, WIDE_PANEL, kb), 1);
      wgmma_commit();
      wgmma_wait_all();
      hold(dq_acc);
      release(c_bars, 1, kt);
    }
    epi.template store<WIDE_HALF>(sh, bi, hi, row, dq_acc, sh.scale, c0 + wg * WIDE_HALF);
  }
}

}  // namespace

// -- host ------------------------------------------------------------------------------

// One block a (row tile, chunk): FWD_BM-row tiles in the forward, 64-row
// blocks in the backward.
static inline dim3 wide_fwd_grid(int S, int H, int B, int d) {
  return dim3((S + FWD_BM - 1) / FWD_BM * wide_chunks(d), H, B);
}

static inline dim3 wide_bwd_grid(int rows, int H, int B, int d) {
  return dim3((rows + WIDE_ROWS - 1) / WIDE_ROWS * wide_chunks(d), H, B);
}

// The forward's maps: q (S rows) in FWD_BM-row boxes, k and v (T rows) in
// WIDE_ROWS-row boxes, head dim d.
static bool wide_fwd_tensor_maps(CUtensorMap (&maps)[3], int d, const void* q, Layout lq, int S,
                                 const void* k, Layout lk, const void* v, Layout lv, int T,
                                 int H, int B) {
  return fwd_tensor_map(&maps[0], q, lq, d, S, H, B, FWD_BM) &&
         fwd_tensor_map(&maps[1], k, lk, d, T, H, B, WIDE_ROWS) &&
         fwd_tensor_map(&maps[2], v, lv, d, T, H, B, WIDE_ROWS);
}
