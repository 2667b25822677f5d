// Tile helpers shared by the port's attention kernels (flash_attention.cu
// and ring_flash.cu): the operand Layout and the host-side launch helpers;
// and, for ring_flash.cu's backward step kernels, their shared-memory tile
// shapes of head dim D, 16-byte tile loads and the wmma products over
// 64-row tiles. Every such kernel runs NWARPS warps per block, each owning
// 16 rows of the block's 64-row tile. The forward's mainloop is
// flash_fwd_sm90.cuh, the flash backward's flash_bwd_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

struct Layout {
  int ld;     // elements between consecutive rows
  int group;  // elements between consecutive groups of 128 / D heads
  int sub;    // elements between consecutive heads of one group
  int batch;  // elements between consecutive batch entries
};

namespace {

constexpr int LANES = 128;       // width of a lane group
constexpr int BM = 64;           // rows of the tile a block owns
constexpr int BN = 64;           // rows of the tiles it streams
constexpr int NWARPS = 4;        // each warp owns 16 rows of the tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDS = BN + 4;      // pitch of an f32 [rows][64] tile
constexpr int LDP = BN + 8;      // pitch of a bf16 [rows][64] tile
constexpr float NEG_INF = -1e30f;

constexpr size_t TILE_S = sizeof(float) * BM * LDS;  // 17408 B
constexpr size_t TILE_P = sizeof(bf16) * BM * LDP;   // 9216 B
constexpr size_t ROWS_F = sizeof(float) * BM;        // 256 B

// Shared-memory shapes that follow the head dim D.
template <int D>
struct Tiles {
  static_assert(D == 64 || D == 128, "head dim 64 or 128");
  static constexpr int LDH = D + 8;  // pitch of a bf16 [rows][D] tile
  static constexpr size_t H = sizeof(bf16) * BM * LDH;   // 17408 B at 128, 9216 B at 64
  static constexpr size_t DKV_SMEM = 4 * H + TILE_S + 2 * TILE_P + 2 * ROWS_F;
  static constexpr size_t DQ_SMEM = 4 * H + TILE_S + TILE_P + 2 * ROWS_F;
};

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
// B = X^T for a row-major X in shared memory: X's rows are B's columns
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Offset of row 0 of head h of batch b in an operand of layout l.
template <int D>
__device__ __forceinline__ size_t head_base(const Layout& l, int b, int h) {
  constexpr int PER = LANES / D;
  return (size_t)b * l.batch + (size_t)(h / PER) * l.group + (size_t)(h % PER) * l.sub;
}

// Copy rows [0, 64) x cols [0, D) of a row-major global tile with row
// stride `ld` into shared memory at pitch LDH, 16 bytes per thread per step.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(dst + r * Tiles<D>::LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// 64 floats of a [b, h, s] row vector (lse or delta) into shared memory.
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
  if (threadIdx.x < BM) dst[threadIdx.x] = src[threadIdx.x];
}

// out[16 x 64] (f32, pitch LDS) = A[16 x D] * B where B's 64 columns are the
// rows of X[64 x D]: i.e. A X^T, both operands bf16 at pitch LDH.
template <int D>
__device__ __forceinline__ void gemm_abt(float* out, const bf16* a, const bf16* x) {
  constexpr int LDH = Tiles<D>::LDH;
#pragma unroll
  for (int j = 0; j < BN / 16; ++j) {
    FragC acc;
    wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      FragA fa;
      FragBt fb;
      wmma::load_matrix_sync(fa, a + kk * 16, LDH);
      wmma::load_matrix_sync(fb, x + j * 16 * LDH + kk * 16, LDH);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(out + j * 16, acc, LDS, wmma::mem_row_major);
  }
}

// acc[j] (16 x D in D/16 fragments) += A[16 x 64] (bf16, pitch LDP) *
// X[64 x D] (bf16, pitch LDH).
template <int D>
__device__ __forceinline__ void gemm_acc(FragC (&acc)[D / 16], const bf16* a, const bf16* x) {
  constexpr int LDH = Tiles<D>::LDH;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
    FragA fa;
    wmma::load_matrix_sync(fa, a + kk * 16, LDP);
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragB fb;
      wmma::load_matrix_sync(fb, x + kk * 16 * LDH + j * 16, LDH);
      wmma::mma_sync(acc[j], fa, fb, acc[j]);
    }
  }
}

// The layout of a per-head [b, h, s, D] operand with unit stride along D
// and the given row, head and batch strides (contiguous: D, S*D, H*S*D).
template <int D>
__host__ __device__ __forceinline__ Layout per_head(int ld, int head, int batch) {
  return Layout{ld, (LANES / D) * head, head, batch};
}

}  // namespace

template <int D>
static inline float softmax_scale() {
  return 1.0f / sqrtf((float)D);
}

template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Each library builds from one .cu, so each defines this once.
extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

