// The attention forward for Hopper (sm_90a): one mainloop over streamed
// key/value tiles with two epilogues. The flash epilogue writes o (bf16,
// normalised by 1/l) through an output Layout and lse in natural log
// (flash_attention.cu: ff_flash_fwd[_d64|_bhsd|_bhsd_d64|_d256]_kernel).
// The ring epilogue reads the carried f32 (acc, m, l) of its rows into
// registers before the loop and writes them back after it (ring_flash.cu:
// ff_ring_fwd_step[_d64]_kernel).
//
// Replaces, through those kernels, the Pallas kernels _fwd_kernel_b (:674),
// _fwd_kernel (:164) and _fwd_kernel_pair (:1032) of
// flexflow_tpu/kernels/flash_attention.py and _ring_fwd_step_kernel (:58) of
// flexflow_tpu/kernels/ring_flash.py.
//
// What bounds it on an H100: 4*d flops per unmasked (query, key) pair on
// bf16 tensor cores against q, k, v and o read or written once. At s=512
// (b=64, h=8, d=128) that is 6.9e10 flops on 268 MB: the ridge, bound by
// bytes (0.080 ms). At s=2048 (b=16, h=8) and at the ring step's
// 4x8x8192x128 causal shape it is bound by operations (0.278 and 0.556 ms at
// 989 TFLOP/s). At d=256, BERT-base's b=64, h=12, s=512 does 2.1e11 flops on
// 805 MB: 0.208 ms of products against 0.241 ms of bytes.
//
// Head dims. The body is a template on a padded width D of 64, 128, 192 or
// 256 (every head dim d with d % 8 == 0 up to 256, the Pallas kernels'
// range, rounds up to one): a head is kept as D/64 panels of 64 columns,
// and the tensor maps give the column extent as the real d, so the panel
// columns at d and beyond load as zeros. Q K^T over the padded columns is
// exact, P V's padded columns are zero, and the epilogues store only the
// columns below d; the scale is 1/sqrt(d). Below D the padded columns cost
// products: d=32 does half its tensor-core work on zeros.
//
// Design. A block owns FWD_BM = 128 query rows of one (batch, head) and runs
// three warpgroups: two consumers of 64 rows each (wgmma's M) and one
// producer. What each piece does about the shared-tile design it replaced:
// - Products on wgmma. S = Q K^T is wgmma m64nBNk16 (BN = 128 key rows a
//   tile, 64 at d=256) with Q and the K tile read from shared memory through
//   descriptors over 128-byte-swizzled panels (64 columns of 128 bytes
//   each); O += P V is m64nDk16 (at D=256 two m64n128k16 on V's column
//   halves, each over two of V's four panels; at D=192 an m64n128k16 on
//   V's first two panels and an m64n64k16 on its third) with P as the register A
//   operand and V from shared memory as the MN-major B operand (transpose
//   bit set).
// - Registers, not shared memory, hold S, P and O. The score tile stays in
//   the wgmma accumulator; the online softmax runs on that fragment, a
//   row's max and sum being a pass over the thread's values plus two
//   shuffles across the quad of threads that holds the row; P is rounded
//   to bf16 in registers straight into the A fragments; O (D/2 f32 a
//   thread) is rescaled in registers and stays there for the whole key
//   loop. Nothing of S, P or O passes through shared memory.
// - Asynchronous tile loads. One thread of the producer warpgroup issues
//   TMA loads (cp.async.bulk.tensor, 5-D: column, row, head in its group,
//   group, batch) of Q once and of K/V tiles into a ring of
//   FwdTiles<D>::STAGES stages (2 at d=128 and 256, 3 at d=64) guarded by
//   mbarriers: a stage's full barrier counts its bytes, its
//   empty barrier the four warps of each consumer warpgroup after their
//   wgmma on it has retired. Loads of the next tiles run under the products
//   of this one. The tensor maps are built on the host from the kernel's
//   Layout (every layout the wrappers take is such a strided box with rows a
//   multiple of 16 bytes apart) through cudaGetDriverEntryPoint, so the
//   library links only the runtime, and they reach the kernel as
//   __grid_constant__ parameters.
// - Occupancy. Shared memory: Q (128 x D) plus the stages' K and V tiles
//   (193 KB at d=256), 1 block a SM; setmaxnreg gives the consumers 232
//   registers (at d=256 O's 128 f32, S's 32 and P's 16 packed) and the
//   producer 40.
// Causal and ring semantics: only tiles that cross the diagonal (or the end
// of the key block, where s % BN == 64) are masked, by global positions
// (q_off + row >= k_off + col); each consumer warpgroup's loop bound skips
// the tiles wholly masked for its rows; masked entries give p = 0; a block
// whose rows see no key returns before touching memory, and a warpgroup
// whose rows see none (or lie past S) leaves its rows untouched. No atomics
// and no split over keys: results repeat bitwise.

#pragma once

#include <cuda.h>  // CUtensorMap and the driver's enums only: no driver symbol is linked

#include "flash_tiles.cuh"

namespace {

constexpr int FWD_WG_ROWS = 64;          // rows of a consumer warpgroup: wgmma's M
constexpr int FWD_BM = 2 * FWD_WG_ROWS;  // query rows of a block
constexpr int FWD_THREADS = 3 * 128;     // two consumer warpgroups, then the producer
constexpr int PANEL = 64;                // bf16 columns of a 128-byte swizzled panel
constexpr uint32_t ROW_BYTES = 128;      // one panel row
constexpr uint32_t SWIZZLE_ATOM = 8 * ROW_BYTES;
constexpr int CONSUMER_REGS = 232, PRODUCER_REGS = 40;

// Shared memory of padded width D: Q [FWD_BM x D] and STAGES stages of K
// and V [BN x D], each as D/64 panels of [rows x 64], 1024-byte aligned;
// then the barriers. A key tile is BN = 128 rows (S is wgmma's N = 128),
// but 64 at D > 128, where S and P for 128 keys beside O's 96 or 128 f32 a
// thread would pass the consumers' registers, and two 128-row stages of K
// and V (192 or 256 KB) beside Q would pass the 227 KB a block can have.
template <int D>
struct FwdTiles {
  static_assert(D == 64 || D == 128 || D == 192 || D == 256, "padded width 64, 128, 192 or 256");
  static constexpr int BN = D > 128 ? 64 : 128;  // key rows of a streamed tile
  static constexpr int PANELS = D / PANEL;
  static constexpr int STAGES = D == 64 ? 3 : 2;
  static constexpr uint32_t Q_PANEL = FWD_BM * ROW_BYTES;
  static constexpr uint32_t KV_PANEL = BN * ROW_BYTES;
  static constexpr uint32_t Q_BYTES = PANELS * Q_PANEL;
  static constexpr uint32_t KV_BYTES = PANELS * KV_PANEL;  // one of K or V
  static constexpr uint32_t STAGE_BYTES = 2 * KV_BYTES;
  static constexpr size_t SMEM = 1024 + Q_BYTES + STAGES * STAGE_BYTES + 8 * (2 * STAGES + 1);
};

struct FwdShape {
  int S, T, H;       // query rows, key rows, heads
  int q_off, k_off;  // global positions of query row 0 and key row 0
  int causal;
  float scale;       // 1/sqrt(d)
  int d;             // head dim: the columns below it are real, the rest padding
  int per;           // heads in a group of the operands' Layout (the maps' head coordinates)
};

// Key tiles of BN rows that the rows [r0, r0 + FWD_WG_ROWS) of the query
// block may attend: every tile, or under the causal mask
// ceil((q_off + r0 + 64 - k_off) / BN) clamped to [0, ceil(T / BN)]; none
// for rows past S.
template <int BN>
__device__ __forceinline__ int fwd_k_tiles(const FwdShape& sh, int r0) {
  if (r0 >= sh.S) return 0;
  const int all = (sh.T + BN - 1) / BN;
  if (!sh.causal) return all;
  const int cols = sh.q_off + r0 + FWD_WG_ROWS - sh.k_off;
  return cols <= 0 ? 0 : min((cols + BN - 1) / BN, all);
}

// -- barriers, TMA and wgmma (flash_bwd_sm90.cuh uses them too) ---------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// The full (one arrival: the producer's) and empty (eight: each warp of
// both consumer warpgroups) barriers of `stages` stages, at bars + 8 s and
// bars + 8 (stages + s), and one barrier of one arrival at `once` for the
// block's own operands; then the block syncs.
__device__ __forceinline__ void init_stages(uint32_t bars, int stages, uint32_t once) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (stages + s), 8);
    }
    mbar_init(once, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// One box of `map` at (c0, c1, c2, c3, c4) into shared memory at dst; the
// bytes count towards the barrier's transaction.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar, int c0,
                                         int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// `bytes` of global memory at src into shared memory at dst (both 16-byte
// aligned); the bytes count towards the barrier's transaction.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// The wgmma descriptor of a 128-byte-swizzled operand at shared address
// addr: lbo and sbo are the byte strides between swizzle atoms along the
// leading (MN for an MN-major operand; unused for K-major) and the
// strided dimension (8-row groups).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Wait until at most one committed wgmma group is still in flight.
__device__ __forceinline__ void wgmma_wait_one() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// The K-major descriptor of the 16 columns kk of a bf16 operand kept as
// 128-byte-swizzled panels of 64 columns, `panel` bytes apart, from the
// row at byte offset `rows` of each panel.
__device__ __forceinline__ uint64_t kmajor(uint32_t base, uint32_t panel, uint32_t rows, int kk) {
  return sw128_desc(base + (kk / 4) * panel + rows + (kk % 4) * 32, 16, SWIZZLE_ATOM);
}

// The 16 rows kb of a tile as the MN-major B operand (N = D across the
// tile's panels, `panel` bytes apart).
__device__ __forceinline__ uint64_t mnmajor(uint32_t base, uint32_t panel, int kb) {
  return sw128_desc(base + kb * 16 * ROW_BYTES, panel, SWIZZLE_ATOM);
}

// Keep the compiler from moving reads or writes of wgmma operands across
// the asynchronous product (their values belong to the tensor cores until
// the wait).
template <int N>
__device__ __forceinline__ void hold(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void hold(uint32_t (&a)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers, B from shared memory (MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A and B from shared memory: A
// K-major, B K-major or, with TRANS_B, MN-major.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A and B from shared memory: A
// K-major, B K-major or, with TRANS_B, MN-major.
template <int TRANS_B = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate), "n"(TRANS_B));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers, B from shared memory (MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// D[64 x N] += A[64 x 16] B[16 x N], A from registers, B from shared memory
// (MN-major, descriptor b). N = 256 is two m64n128k16 on B's column halves,
// N = 192 an m64n128k16 on its first two panels and an m64n64k16 on its
// third; the second product's columns start `half` bytes past the first's.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b,
                                         uint32_t half = 0) {
  if constexpr (N == 256) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, b);
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[64]), a, b + (half >> 4));
  } else if constexpr (N == 192) {
    wgmma_rs_n128(*reinterpret_cast<float(*)[64]>(&d[0]), a, b);
    wgmma_rs_n64(*reinterpret_cast<float(*)[32]>(&d[64]), a, b + (half >> 4));
  } else if constexpr (N == 128) {
    wgmma_rs_n128(d, a, b);
  } else {
    wgmma_rs_n64(d, a, b);
  }
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B from shared memory (K-major).
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int accumulate) {
  if constexpr (N == 128) wgmma_ss_n128(d, a, b, accumulate);
  else wgmma_ss_n64(d, a, b, accumulate);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u));
}

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// -- the online softmax on the accumulator fragment ----------------------------
// Thread t of a consumer warpgroup holds rows row and row + 8 of its
// warpgroup (row = 16 * warp + lane / 4) and, of each 8-column block j,
// columns 8j + c and 8j + c + 1 (c = 2 * (lane % 4)): fragment element i is
// row + 8 * ((i >> 1) & 1), column 8 * (i / 4) + c + (i & 1).

// A score tile of N columns as the A fragments of a product over those
// columns: 16 columns each.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[N / 16][4], const float (&x)[N / 2]) {
#pragma unroll
  for (int kb = 0; kb < N / 16; ++kb)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kb][j] = pack_bf16(x[8 * kb + 2 * j], x[8 * kb + 2 * j + 1]);
}

// The thread's rows row and row + 8 of an accumulator of D columns, times
// mul[0] and mul[1], as bf16 pairs into dst (row 0 of a head, rows ld
// elements apart); only the columns below `cols` (a multiple of 8: a
// pair's two columns lie on one side of it) are stored.
template <int D>
__device__ __forceinline__ void store_bf16_rows(bf16* dst, int ld, int row,
                                                const float (&acc)[D / 2], const float (&mul)[2],
                                                int cols) {
  const int c = (threadIdx.x % 4) * 2;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* r = dst + (size_t)(row + 8 * h) * ld + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      if (8 * j < cols)
        *reinterpret_cast<__nv_bfloat162*>(r + 8 * j) =
            __floats2bfloat162_rn(acc[4 * j + 2 * h] * mul[h], acc[4 * j + 2 * h + 1] * mul[h]);
  }
}

// Scale and (MASK) mask the score tile sc of BN keys in place into p;
// update the row state m, l and rescale the output rows o. k0 is the
// tile's first key of the block, qrow the thread's first row of the block.
template <bool MASK, int D, int BN>
__device__ __forceinline__ void online_softmax(float (&sc)[BN / 2], float (&o)[D / 2],
                                               float (&m)[2], float (&l)[2], const FwdShape& sh,
                                               int qrow, int k0, int c) {
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    float x = sc[i] * sh.scale;
    if (MASK) {
      const int col = k0 + (i / 4) * 8 + c + (i & 1);
      const bool ok = col < sh.T && (!sh.causal || sh.q_off + qrow + 8 * h >= sh.k_off + col);
      if (!ok) x = NEG_INF;
    }
    sc[i] = x;
    mx[h] = fmaxf(mx[h], x);
  }
  float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
    mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    const float m_new = fmaxf(m[h], mx[h]);
    alpha[h] = __expf(m[h] - m_new);
    m[h] = m_new;
  }
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int h = (i >> 1) & 1;
    float p = __expf(sc[i] - m[h]);
    if (MASK && sc[i] == NEG_INF) p = 0.f;  // masked: p = 0 outright
    sc[i] = p;
    sum[h] += p;
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
    sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
    l[h] = l[h] * alpha[h] + sum[h];
  }
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
}

// -- epilogues -----------------------------------------------------------------
// load() sets a thread's rows' (o, m, l) before the key loop and store()
// writes them after it; rows are the thread's first row of the q block.

// col0 is the first of the D columns the registers hold: 0, or in the wide
// kernels (flash_wide_sm90.cuh) the block's column chunk, whose row state
// (m, l) every chunk computes alike and chunk 0 alone writes. keep() runs
// for a thread's rows that see no key in a block that computes their
// chunk.

// Self-attention: the state starts empty; o (bf16, o / l) goes out through
// `out` and lse[b, h, s] = m + log l.
template <int D>
struct FlashEpilogue {
  bf16* o;
  Layout out;
  float* lse;

  __device__ __forceinline__ void load(const FwdShape&, int, int, int, float (&acc)[D / 2],
                                       float (&m)[2], float (&l)[2], int = 0) const {
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
  }

  __device__ __forceinline__ void store(const FwdShape& sh, int bi, int hi, int row,
                                        const float (&acc)[D / 2], const float (&m)[2],
                                        const float (&l)[2], int col0 = 0) const {
    const float inv[2] = {1.f / l[0], 1.f / l[1]};
    store_bf16_rows<D>(o + head_base(out, bi, hi) + col0, out.ld, row, acc, inv, sh.d - col0);
    if (col0 == 0 && threadIdx.x % 4 == 0)
      for (int h = 0; h < 2; ++h) lse[((size_t)bi * sh.H + hi) * sh.S + row + 8 * h] = m[h] + logf(l[h]);
  }

  // every row of self-attention sees its own key: nothing to keep
  __device__ __forceinline__ void keep(const FwdShape&, int, int, int, int) const {}
};

// A ring step: the f32 state acc [b, h, S, d], m and l [b, h, S] is read
// before the loop and written back after it; the padded columns start at 0
// and are not written.
template <int D>
struct RingEpilogue {
  float* acc;
  float* m;
  float* l;

  __device__ __forceinline__ void load(const FwdShape& sh, int bi, int hi, int row,
                                       float (&a)[D / 2], float (&mr)[2], float (&lr)[2],
                                       int col0 = 0) const {
    const int c = (threadIdx.x % 4) * 2;
    const size_t rows = ((size_t)bi * sh.H + hi) * sh.S + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float* src = acc + (rows + 8 * h) * sh.d + col0 + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const float2 x = col0 + 8 * j < sh.d ? *reinterpret_cast<const float2*>(src + 8 * j)
                                             : make_float2(0.f, 0.f);
        a[4 * j + 2 * h] = x.x;
        a[4 * j + 2 * h + 1] = x.y;
      }
      mr[h] = m[rows + 8 * h];
      lr[h] = l[rows + 8 * h];
    }
  }

  __device__ __forceinline__ void store(const FwdShape& sh, int bi, int hi, int row,
                                        const float (&a)[D / 2], const float (&mr)[2],
                                        const float (&lr)[2], int col0 = 0) const {
    const int c = (threadIdx.x % 4) * 2;
    const size_t rows = ((size_t)bi * sh.H + hi) * sh.S + row;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float* dst = acc + (rows + 8 * h) * sh.d + col0 + c;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        if (col0 + 8 * j < sh.d)
          *reinterpret_cast<float2*>(dst + 8 * j) =
              make_float2(a[4 * j + 2 * h], a[4 * j + 2 * h + 1]);
      if (c == 0 && col0 == 0) {
        m[rows + 8 * h] = mr[h];
        l[rows + 8 * h] = lr[h];
      }
    }
  }
};

// -- the mainloop ----------------------------------------------------------------
// Grid (ceil(S / FWD_BM), H, B), FWD_THREADS threads, FwdTiles<D>::SMEM
// bytes of dynamic shared memory. tq, tk and tv are the operands' tensor
// maps (fwd_tensor_map).
template <int D, class Epi>
__device__ __forceinline__ void fwd_mainloop(const CUtensorMap* tq, const CUtensorMap* tk,
                                             const CUtensorMap* tv, const Epi& epi,
                                             const FwdShape& sh) {
  typedef FwdTiles<D> F;
  constexpr int BN = F::BN;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * FWD_BM;  // the longest causal rows first
  const int hi = blockIdx.y, bi = blockIdx.z;
  const int n0 = fwd_k_tiles<BN>(sh, q0), n1 = fwd_k_tiles<BN>(sh, q0 + FWD_WG_ROWS);
  const int nk = max(n0, n1);
  if (nk == 0) return;  // no row of the block sees a key

  extern __shared__ unsigned char fwd_smem[];
  const uint32_t sQ = (smem_u32(fwd_smem) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + F::Q_BYTES;
  const uint32_t bars = sKV + F::STAGES * F::STAGE_BYTES;
  const uint32_t q_bar = bars + 16 * F::STAGES;
  init_stages(bars, F::STAGES, q_bar);

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the stages full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 256) {
      const int hs = hi % sh.per, hg = hi / sh.per;
      mbar_expect_tx(q_bar, F::Q_BYTES);
#pragma unroll
      for (int p = 0; p < F::PANELS; ++p)
        tma_load(sQ + p * F::Q_PANEL, tq, q_bar, p * PANEL, q0, hs, hg, bi);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % F::STAGES;
        mbar_wait(bars + 8 * (F::STAGES + s), ((kt / F::STAGES) & 1) ^ 1);
        const uint32_t full = bars + 8 * s, sK = sKV + s * F::STAGE_BYTES;
        mbar_expect_tx(full, F::STAGE_BYTES);
#pragma unroll
        for (int p = 0; p < F::PANELS; ++p) {
          tma_load(sK + p * F::KV_PANEL, tk, full, p * PANEL, kt * BN, hs, hg, bi);
          tma_load(sK + F::KV_BYTES + p * F::KV_PANEL, tv, full, p * PANEL, kt * BN, hs, hg, bi);
        }
      }
    }
  } else {
    // consumer warpgroup wg: rows [r0, r0 + 64) of the block
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = q0 + wg * FWD_WG_ROWS;
    const int n_mine = wg == 0 ? n0 : n1;
    const int row = r0 + (t / 32) * 16 + lane / 4;  // the thread's rows: row and row + 8
    const int c = (lane % 4) * 2;
    const uint32_t wrows = wg * FWD_WG_ROWS * ROW_BYTES;  // the warpgroup's rows in the Q panels
    float o[D / 2], m[2], l[2];
    if (n_mine > 0) epi.load(sh, bi, hi, row, o, m, l);
    mbar_wait(q_bar, 0);

    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % F::STAGES;
      mbar_wait(bars + 8 * s, (kt / F::STAGES) & 1);
      if (kt < n_mine) {
        const uint32_t sK = sKV + s * F::STAGE_BYTES, sV = sK + F::KV_BYTES;
        const int k0 = kt * BN;
        // S = Q K^T, in registers
        float sc[BN / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<BN>(sc, kmajor(sQ, F::Q_PANEL, wrows, kk), kmajor(sK, F::KV_PANEL, 0, kk),
                       kk > 0);
        wgmma_commit();
        wgmma_wait_all();
        hold(sc);
        const bool masked = (sh.causal && sh.k_off + k0 + BN - 1 > sh.q_off + r0) ||
                            k0 + BN > sh.T;
        if (masked) online_softmax<true, D, BN>(sc, o, m, l, sh, row, k0, c);
        else online_softmax<false, D, BN>(sc, o, m, l, sh, row, k0, c);
        // P in bf16 as the A fragments of O += P V: 16 keys each
        uint32_t pa[BN / 16][4];
        pack_a<BN>(pa, sc);
        hold(o);
        wgmma_fence();
#pragma unroll
        for (int kb = 0; kb < BN / 16; ++kb)
          wgmma_rs<D>(o, pa[kb], mnmajor(sV, F::KV_PANEL, kb), 2 * F::KV_PANEL);
        wgmma_commit();
        wgmma_wait_all();
        hold(o);
        hold(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (F::STAGES + s));  // this warp is done with stage s
    }
    if (n_mine > 0) epi.store(sh, bi, hi, row, o, m, l);
  }
}

}  // namespace

// -- host: tensor maps -------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, found through the runtime.
static EncodeTiled tensor_map_encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found) ==
            cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The tensor map of a bf16 operand of Layout l, head dim d and `rows` rows
// per head: 5-D (column, row, head in its group, group, batch), boxes of 64
// columns by box_rows rows (the forward's FWD_BM for Q and FwdTiles<D>::BN
// for K and V; the backward's 64), 128-byte swizzle; columns past d and
// rows past `rows` read as zeros.
static bool fwd_tensor_map(CUtensorMap* map, const void* base, Layout l, int d, int rows, int H,
                           int B, int box_rows) {
  EncodeTiled encode = tensor_map_encoder();
  if (encode == nullptr) return false;
  const int per = l.per;
  const cuuint64_t dims[5] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)per,
                              (cuuint64_t)((H + per - 1) / per), (cuuint64_t)B};
  const long long el[4] = {l.ld, l.sub, l.group, l.batch};
  cuuint64_t strides[4];
  for (int i = 0; i < 4; ++i)  // a stride of 0 (a dim of one) is not a valid map stride
    strides[i] = (cuuint64_t)(el[i] > 0 ? el[i] * 2 : 16);
  const cuuint32_t box[5] = {(cuuint32_t)PANEL, (cuuint32_t)box_rows, 1, 1, 1};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The maps of q (S rows) and of k and v (T rows), head dim d.
template <int D>
static cudaError_t fwd_tensor_maps(CUtensorMap (&maps)[3], int d, const void* q, Layout lq, int S,
                                   const void* k, Layout lk, const void* v, Layout lv, int T, int H,
                                   int B) {
  constexpr int BN = FwdTiles<D>::BN;
  const bool ok = fwd_tensor_map(&maps[0], q, lq, d, S, H, B, FWD_BM) &&
                  fwd_tensor_map(&maps[1], k, lk, d, T, H, B, BN) &&
                  fwd_tensor_map(&maps[2], v, lv, d, T, H, B, BN);
  return ok ? cudaSuccess : cudaErrorInvalidValue;
}

static inline dim3 fwd_grid(int S, int H, int B) {
  return dim3((S + FWD_BM - 1) / FWD_BM, H, B);
}
