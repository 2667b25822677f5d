// What the port's attention kernels (flash_attention.cu and ring_flash.cu)
// share beneath their Hopper mainloops: the operand Layout, the head offsets
// it gives, and the host-side launch helpers. Every kernel's products and
// tile loads live in the mainloops: the forward's in flash_fwd_sm90.cuh,
// the backward's in flash_bwd_sm90.cuh.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

struct Layout {
  int ld;     // elements between consecutive rows
  int group;  // elements between consecutive groups of 128 / D heads
  int sub;    // elements between consecutive heads of one group
  int batch;  // elements between consecutive batch entries
};

namespace {

constexpr int LANES = 128;  // width of a lane group
constexpr float NEG_INF = -1e30f;

// Heads of dim D in one 128-lane group: a head of D > 128 spans groups and
// is a group of its own.
template <int D>
__host__ __device__ constexpr int group_heads() {
  return D > LANES ? 1 : LANES / D;
}

// Offset of row 0 of head h of batch b in an operand of layout l. A head
// of D > 128 spans groups: its heads lie `sub` apart and `group` is unused.
template <int D>
__device__ __forceinline__ size_t head_base(const Layout& l, int b, int h) {
  if constexpr (D > LANES) {
    return (size_t)b * l.batch + (size_t)h * l.sub;
  } else {
    constexpr int PER = group_heads<D>();
    return (size_t)b * l.batch + (size_t)(h / PER) * l.group + (size_t)(h % PER) * l.sub;
  }
}

// The layout of a per-head [b, h, s, D] operand with unit stride along D
// and the given row, head and batch strides (contiguous: D, S*D, H*S*D).
template <int D>
__host__ __device__ __forceinline__ Layout per_head(int ld, int head, int batch) {
  return Layout{ld, group_heads<D>() * head, head, batch};
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
