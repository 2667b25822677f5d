// Flash attention on seq-major [b, s, h*d] bf16 tensors for Hopper (sm_90a).
//
// Replaces three Pallas kernels of flexflow_tpu/kernels/flash_attention.py:
//   ff_flash_fwd_kernel      <- _fwd_kernel_b (via _fwd_bshf), single-k-block
//                               and online-softmax paths alike
//   ff_flash_delta_kernel    <- _delta_kernel (via _delta_bshf)
//   ff_flash_bwd_dkv_kernel  <- _bwd_fused_kernel_b (via _bwd_bshf_fused),
//   ff_flash_bwd_dq_kernel      split in two
//
// What bounds them on an H100 (b=64, h=8, s=512, d=128): the forward and the
// backward do 4*b*h*s^2*d and 10*b*h*s^2*d flops on ~270 MB and ~470 MB, so
// at full tensor-core rate they sit near the ridge (forward) and above it
// (backward); delta is a pure read of dO and O and is bound by bytes.
//
// Design. Each block owns one 64-row tile of one (batch, head) and reads its
// tiles straight from [b, s, h*d] by stride: no transpose anywhere. Four
// warps each own 16 rows of the tile; products run on the tensor cores
// through nvcuda::wmma (bf16 in, f32 accumulate), and the softmax runs in
// f32 on the rows a warp owns, so the only block-wide barriers are around
// the shared K/V (or Q/dO) tile loads. The TPU kernel holds the whole
// [s, s] f32 score tile of a (b, h) in VMEM; at s=512 that is 1 MB, far
// beyond the 227 KB of shared memory a block gets, so the backward is two
// kernels that both rebuild P from the saved lse: one block per k tile for
// dK/dV (looping over q tiles) and one block per q tile for dQ (looping over
// k tiles). No atomics: every output element is written by one block, so
// results repeat bitwise. lse is kept in natural log.
//
// Each exported C function launches on the given stream and returns
// cudaGetLastError() (0 on success).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;
typedef __nv_bfloat16 bf16;

namespace {

constexpr int D = 128;           // head dim
constexpr int BM = 64;           // rows of the tile a block owns
constexpr int BN = 64;           // rows of the tiles it streams
constexpr int NWARPS = 4;        // each warp owns 16 rows of the tile
constexpr int NTHREADS = NWARPS * 32;
constexpr int LDH = D + 8;       // pitch of a bf16 [rows][D] tile
constexpr int LDS = BN + 4;      // pitch of an f32 [rows][64] tile
constexpr int LDP = BN + 8;      // pitch of a bf16 [rows][64] tile
constexpr int LDO = D + 4;       // pitch of the f32 [rows][D] output tile
constexpr float NEG_INF = -1e30f;

constexpr size_t TILE_H = sizeof(bf16) * BM * LDH;   // 17408 B
constexpr size_t TILE_S = sizeof(float) * BM * LDS;  // 17408 B
constexpr size_t TILE_P = sizeof(bf16) * BM * LDP;   // 9216 B
constexpr size_t TILE_O = sizeof(float) * BM * LDO;  // 33792 B
constexpr size_t ROWS_F = sizeof(float) * BM;        // 256 B

constexpr size_t FWD_SMEM = 3 * TILE_H + TILE_S + TILE_P + TILE_O + 2 * ROWS_F;
constexpr size_t DKV_SMEM = 4 * TILE_H + TILE_S + 2 * TILE_P + 2 * ROWS_F;
constexpr size_t DQ_SMEM = 4 * TILE_H + TILE_S + TILE_P + 2 * ROWS_F;

typedef wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> FragA;
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> FragB;
// B = X^T for a row-major X in shared memory: X's rows are B's columns
typedef wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> FragBt;
typedef wmma::fragment<wmma::accumulator, 16, 16, 16, float> FragC;

// Copy rows [0, 64) x cols [0, D) of a row-major global tile with row
// stride `ld` into shared memory at pitch LDH, 16 bytes per thread per step.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, int ld) {
  constexpr int CHUNKS = D / 8;
  for (int i = threadIdx.x; i < BM * CHUNKS; i += NTHREADS) {
    const int r = i / CHUNKS, c = (i % CHUNKS) * 8;
    *reinterpret_cast<uint4*>(dst + r * LDH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * ld + c);
  }
}

// 64 floats of a [b, h, s] row vector (lse or delta) into shared memory.
__device__ __forceinline__ void load_rows(float* dst, const float* src) {
  if (threadIdx.x < BM) dst[threadIdx.x] = src[threadIdx.x];
}

// out[16 x 64] (f32, pitch LDS) = A[16 x D] * B where B's 64 columns are the
// rows of X[64 x D]: i.e. A X^T, both operands bf16 at pitch LDH.
__device__ __forceinline__ void gemm_abt(float* out, const bf16* a, const bf16* x) {
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

// acc[j] (16 x D in 8 fragments) += A[16 x 64] (bf16, pitch LDP) * X[64 x D]
// (bf16, pitch LDH).
__device__ __forceinline__ void gemm_acc(FragC (&acc)[D / 16], const bf16* a, const bf16* x) {
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

// Write a warp's 16 x D accumulator rows, times `mul`, as bf16 to global
// rows `dst` (row stride ld), staging through the warp's own 16 x 64 strip
// of an f32 tile at pitch LDS.
__device__ __forceinline__ void store_rows(bf16* dst, int ld, FragC (&acc)[D / 16],
                                           float* stage, float mul) {
  const int lane = threadIdx.x % 32;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
      wmma::store_matrix_sync(stage + j * 16, acc[half * 4 + j], LDS, wmma::mem_row_major);
    __syncwarp();
    for (int r = 0; r < 16; ++r) {
      bf16* row = dst + (size_t)r * ld + half * 64;
      row[lane] = __float2bfloat16(stage[r * LDS + lane] * mul);
      row[lane + 32] = __float2bfloat16(stage[r * LDS + lane + 32] * mul);
    }
    __syncwarp();
  }
}

}  // namespace

// o[b, s, h*D] and lse[b, h, s] (natural log) of softmax(scale * q k^T) v.
// Grid (s/BM, h, b); one block per (q tile, head, batch).
extern "C" __global__ void __launch_bounds__(NTHREADS)
ff_flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int H, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = reinterpret_cast<bf16*>(smem + TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 2 * TILE_H);
  float* sS = reinterpret_cast<float*>(smem + 3 * TILE_H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 3 * TILE_H + TILE_S);
  float* sO = reinterpret_cast<float*>(smem + 3 * TILE_H + TILE_S + TILE_P);
  float* sM = reinterpret_cast<float*>(smem + 3 * TILE_H + TILE_S + TILE_P + TILE_O);
  float* sL = sM + BM;

  const int q0 = blockIdx.x * BM, hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;
  const int ld = H * D;
  const size_t base = (size_t)bi * S * ld + (size_t)hi * D;

  load_tile(sQ, q + base + (size_t)q0 * ld, ld);
  for (int i = threadIdx.x; i < BM * LDO; i += NTHREADS) sO[i] = 0.f;
  if (threadIdx.x < BM) {
    sM[threadIdx.x] = NEG_INF;
    sL[threadIdx.x] = 0.f;
  }

  const int nk = causal ? (q0 + BM - 1) / BN + 1 : S / BN;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // every warp is done with the previous K/V tiles
    load_tile(sK, k + base + (size_t)k0 * ld, ld);
    load_tile(sV, v + base + (size_t)k0 * ld, ld);
    __syncthreads();

    gemm_abt(sS + r0 * LDS, sQ + r0 * LDH, sK);
    __syncwarp();
    // online softmax over this warp's rows; lane owns columns lane, lane+32
    for (int r = r0; r < r0 + 16; ++r) {
      const int qi = q0 + r;
      float s0 = sS[r * LDS + lane] * scale;
      float s1 = sS[r * LDS + lane + 32] * scale;
      if (causal) {
        if (k0 + lane > qi) s0 = NEG_INF;
        if (k0 + lane + 32 > qi) s1 = NEG_INF;
      }
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = sM[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = __expf(s0 - m_new), p1 = __expf(s1 - m_new);
      sP[r * LDP + lane] = __float2bfloat16(p0);
      sP[r * LDP + lane + 32] = __float2bfloat16(p1);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float alpha = __expf(m_old - m_new);
      for (int c = lane; c < D; c += 32) sO[r * LDO + c] *= alpha;
      __syncwarp();  // every lane has read sM[r]
      if (lane == 0) {
        sM[r] = m_new;
        sL[r] = sL[r] * alpha + sum;
      }
    }
    __syncwarp();
    // O[rows] += P V, accumulating through the f32 tile rescaled above
#pragma unroll
    for (int j = 0; j < D / 16; ++j) {
      FragC acc;
      wmma::load_matrix_sync(acc, sO + r0 * LDO + j * 16, LDO, wmma::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        FragA fa;
        FragB fb;
        wmma::load_matrix_sync(fa, sP + r0 * LDP + kk * 16, LDP);
        wmma::load_matrix_sync(fb, sV + kk * 16 * LDH + j * 16, LDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
      wmma::store_matrix_sync(sO + r0 * LDO + j * 16, acc, LDO, wmma::mem_row_major);
    }
    __syncwarp();
  }

  for (int r = r0; r < r0 + 16; ++r) {
    const float inv = 1.f / sL[r];
    bf16* row = o + base + (size_t)(q0 + r) * ld;
    for (int c = lane; c < D; c += 32) row[c] = __float2bfloat16(sO[r * LDO + c] * inv);
    if (lane == 0) lse[((size_t)bi * H + hi) * S + q0 + r] = sM[r] + logf(sL[r]);
  }
}

// delta[b, h, s] = sum_d dO * O in f32, one warp per (b, s, h) row of D values.
extern "C" __global__ void ff_flash_delta_kernel(const bf16* __restrict__ dout,
                                                 const bf16* __restrict__ o,
                                                 float* __restrict__ delta, int B, int S,
                                                 int H) {
  const int row = blockIdx.x * (blockDim.x / 32) + threadIdx.x / 32;  // over (b, s, h)
  const int lane = threadIdx.x % 32;
  if (row >= B * S * H) return;  // uniform across the warp
  const size_t off = (size_t)row * D + lane * 4;
  const __nv_bfloat162* a = reinterpret_cast<const __nv_bfloat162*>(dout + off);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(o + off);
  const float2 a0 = __bfloat1622float2(a[0]), a1 = __bfloat1622float2(a[1]);
  const float2 b0 = __bfloat1622float2(b[0]), b1 = __bfloat1622float2(b[1]);
  float acc = a0.x * b0.x + a0.y * b0.y + a1.x * b1.x + a1.y * b1.y;
#pragma unroll
  for (int off2 = 16; off2 > 0; off2 >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off2);
  if (lane == 0) {
    const int hi = row % H, si = (row / H) % S, bi = row / (H * S);
    delta[((size_t)bi * H + hi) * S + si] = acc;
  }
}

// dK, dV for one k tile, looping over the q tiles that see it.
// Grid (s/BN, h, b). Works on transposed scores: ST[k, q] = K Q^T.
extern "C" __global__ void __launch_bounds__(NTHREADS)
ff_flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int H,
                        int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = reinterpret_cast<bf16*>(smem + TILE_H);
  bf16* sQ = reinterpret_cast<bf16*>(smem + 2 * TILE_H);
  bf16* sdO = reinterpret_cast<bf16*>(smem + 3 * TILE_H);
  float* sS = reinterpret_cast<float*>(smem + 4 * TILE_H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * TILE_H + TILE_S);
  bf16* sdS = reinterpret_cast<bf16*>(smem + 4 * TILE_H + TILE_S + TILE_P);
  float* sLse = reinterpret_cast<float*>(smem + 4 * TILE_H + TILE_S + 2 * TILE_P);
  float* sDelta = sLse + BM;

  const int k0 = blockIdx.x * BN, hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's k rows
  const int ld = H * D;
  const size_t base = (size_t)bi * S * ld + (size_t)hi * D;
  const size_t rows = ((size_t)bi * H + hi) * S;

  load_tile(sK, k + base + (size_t)k0 * ld, ld);
  load_tile(sV, v + base + (size_t)k0 * ld, ld);
  FragC dk_acc[D / 16], dv_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) {
    wmma::fill_fragment(dk_acc[j], 0.f);
    wmma::fill_fragment(dv_acc[j], 0.f);
  }

  const int qt0 = causal ? k0 / BM : 0;  // q tiles wholly above the diagonal see no k here
  for (int qt = qt0; qt < S / BM; ++qt) {
    const int q0 = qt * BM;
    __syncthreads();
    load_tile(sQ, q + base + (size_t)q0 * ld, ld);
    load_tile(sdO, dout + base + (size_t)q0 * ld, ld);
    load_rows(sLse, lse + rows + q0);
    load_rows(sDelta, delta + rows + q0);
    __syncthreads();

    gemm_abt(sS + r0 * LDS, sK + r0 * LDH, sQ);  // ST = K Q^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      for (int c = lane; c < BM; c += 32) {
        float p = __expf(sS[r * LDS + c] * scale - sLse[c]);
        if (causal && k0 + r > q0 + c) p = 0.f;
        sP[r * LDP + c] = __float2bfloat16(p);
      }
    }
    __syncwarp();
    gemm_abt(sS + r0 * LDS, sV + r0 * LDH, sdO);  // dPT = V dO^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      for (int c = lane; c < BM; c += 32) {
        const float p = __bfloat162float(sP[r * LDP + c]);
        sdS[r * LDP + c] = __float2bfloat16(p * (sS[r * LDS + c] - sDelta[c]));
      }
    }
    __syncwarp();
    gemm_acc(dv_acc, sP + r0 * LDP, sdO);  // dV += PT dO
    gemm_acc(dk_acc, sdS + r0 * LDP, sQ);  // dK += dST Q
  }

  store_rows(dk + base + (size_t)(k0 + r0) * ld, ld, dk_acc, sS + r0 * LDS, scale);
  store_rows(dv + base + (size_t)(k0 + r0) * ld, ld, dv_acc, sS + r0 * LDS, 1.f);
}

// dQ for one q tile, looping over the k tiles it sees. Grid (s/BM, h, b).
extern "C" __global__ void __launch_bounds__(NTHREADS)
ff_flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dout,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       bf16* __restrict__ dq, int S, int H, int causal, float scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sdO = reinterpret_cast<bf16*>(smem + TILE_H);
  bf16* sK = reinterpret_cast<bf16*>(smem + 2 * TILE_H);
  bf16* sV = reinterpret_cast<bf16*>(smem + 3 * TILE_H);
  float* sS = reinterpret_cast<float*>(smem + 4 * TILE_H);
  bf16* sP = reinterpret_cast<bf16*>(smem + 4 * TILE_H + TILE_S);
  float* sLse = reinterpret_cast<float*>(smem + 4 * TILE_H + TILE_S + TILE_P);
  float* sDelta = sLse + BM;

  const int q0 = blockIdx.x * BM, hi = blockIdx.y, bi = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16;  // this warp's q rows
  const int ld = H * D;
  const size_t base = (size_t)bi * S * ld + (size_t)hi * D;
  const size_t rows = ((size_t)bi * H + hi) * S;

  load_tile(sQ, q + base + (size_t)q0 * ld, ld);
  load_tile(sdO, dout + base + (size_t)q0 * ld, ld);
  load_rows(sLse, lse + rows + q0);
  load_rows(sDelta, delta + rows + q0);
  FragC dq_acc[D / 16];
#pragma unroll
  for (int j = 0; j < D / 16; ++j) wmma::fill_fragment(dq_acc[j], 0.f);

  const int nk = causal ? (q0 + BM - 1) / BN + 1 : S / BN;
  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile(sK, k + base + (size_t)k0 * ld, ld);
    load_tile(sV, v + base + (size_t)k0 * ld, ld);
    __syncthreads();

    gemm_abt(sS + r0 * LDS, sQ + r0 * LDH, sK);  // S = Q K^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const float l = sLse[r];
      for (int c = lane; c < BN; c += 32) {
        float p = __expf(sS[r * LDS + c] * scale - l);
        if (causal && k0 + c > q0 + r) p = 0.f;
        sP[r * LDP + c] = __float2bfloat16(p);
      }
    }
    __syncwarp();
    gemm_abt(sS + r0 * LDS, sdO + r0 * LDH, sV);  // dP = dO V^T
    __syncwarp();
    for (int r = r0; r < r0 + 16; ++r) {
      const float dl = sDelta[r];
      for (int c = lane; c < BN; c += 32) {
        const float p = __bfloat162float(sP[r * LDP + c]);
        sP[r * LDP + c] = __float2bfloat16(p * (sS[r * LDS + c] - dl));  // dS, in place
      }
    }
    __syncwarp();
    gemm_acc(dq_acc, sP + r0 * LDP, sK);  // dQ += dS K
  }

  store_rows(dq + base + (size_t)(q0 + r0) * ld, ld, dq_acc, sS + r0 * LDS, scale);
}

// ---------------------------------------------------------------------------
// C interface (ctypes). Shapes: q, k, v, o, dout, dq, dk, dv are contiguous
// [B, S, H*128] bf16; lse and delta are contiguous [B, H, S] f32; S is a
// multiple of 64. The caller checks all of this.
// ---------------------------------------------------------------------------

static float softmax_scale() { return 1.0f / sqrtf((float)D); }

extern "C" int ff_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                            int B, int S, int H, int causal, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ff_flash_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)FWD_SMEM);
  if (err != cudaSuccess) return (int)err;
  ff_flash_fwd_kernel<<<dim3(S / BM, H, B), NTHREADS, FWD_SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, S, H, causal,
      softmax_scale());
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_delta(const void* dout, const void* o, void* delta, int B, int S, int H,
                              void* stream) {
  constexpr int WARPS = 8;
  const long rows = (long)B * S * H;
  const int blocks = (int)((rows + WARPS - 1) / WARPS);
  ff_flash_delta_kernel<<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const bf16*)dout, (const bf16*)o, (float*)delta, B, S, H);
  return (int)cudaGetLastError();
}

extern "C" int ff_flash_bwd(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dq, void* dk, void* dv,
                            int B, int S, int H, int causal, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ff_flash_bwd_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DKV_SMEM);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      ff_flash_bwd_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)DQ_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  ff_flash_bwd_dkv_kernel<<<dim3(S / BN, H, B), NTHREADS, DKV_SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dk, (bf16*)dv, S, H, causal, softmax_scale());
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ff_flash_bwd_dq_kernel<<<dim3(S / BM, H, B), NTHREADS, DQ_SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dout, (const float*)lse,
      (const float*)delta, (bf16*)dq, S, H, causal, softmax_scale());
  return (int)cudaGetLastError();
}

extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

// Dynamic shared memory of each kernel, for the build report.
extern "C" int ff_flash_smem_bytes(int which) {
  switch (which) {
    case 0: return (int)FWD_SMEM;
    case 1: return (int)DKV_SMEM;
    case 2: return (int)DQ_SMEM;
    default: return 0;
  }
}
