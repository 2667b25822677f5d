// What the port's attention kernels (flash_attention.cu, ring_flash.cu and
// flash_wide.cu) share beneath their Hopper mainloops: the operand Layout,
// the head offsets it gives, the head dims each route takes, and the
// host-side launch helpers. Every kernel's products and
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
  int group;  // elements between consecutive groups of `per` heads
  int sub;    // elements between consecutive heads of one group
  int batch;  // elements between consecutive batch entries
  int per;    // heads in a group: two in the d=64 pair's 128-lane groups, else one
};

namespace {

constexpr int LANES = 128;  // width of the d=64 pair's lane groups: two heads each
constexpr float NEG_INF = -1e30f;

// Offset of row 0 of head h of batch b in an operand of layout l.
__device__ __forceinline__ size_t head_base(const Layout& l, int b, int h) {
  return (size_t)b * l.batch + (size_t)(h / l.per) * l.group + (size_t)(h % l.per) * l.sub;
}

// The layout of a per-head [b, h, s, d] operand with unit stride along d
// and the given row, head and batch strides (contiguous: d, S*d, H*S*d).
__host__ __device__ __forceinline__ Layout per_head(int ld, int head, int batch) {
  return Layout{ld, head, head, batch, 1};
}

// The layout of contiguous [b, s, h*d] operands.
__host__ __device__ __forceinline__ Layout dense(int d, int S, int H) {
  return Layout{H * d, d, d, S * H * d, 1};
}

// The layout of the d=64 pair's lane-group operands (rows `ld` apart,
// 128-lane groups of two heads `group` apart, rows packed by batch).
__host__ __device__ __forceinline__ Layout lane_grouped(int ld, int group, int S) {
  return Layout{ld, group, 64, S * ld, 2};
}

// The padded width of head dim d (d % 8 == 0): the kernels keep a head as
// 64-column panels, so d is padded to a multiple of 64 (64, 128, 192 or 256
// for the narrow kernels); the panels' columns at d and beyond load as
// zeros and are never stored.
__host__ __device__ __forceinline__ int padded_dim(int d) {
  return (d + 63) / 64 * 64;
}

// Every head dim a route takes: the Pallas kernels' d % 8 == 0.
__host__ __device__ __forceinline__ bool head_dim_ok(int d) {
  return d >= 8 && d % 8 == 0;
}

// The narrow kernels (flash_attention.cu, ring_flash.cu) take head dims up
// to NARROW_MAX, each at its padded width; past it the wide kernels
// (flash_wide.cu) take every head dim, in column chunks.
constexpr int NARROW_MAX = 256;

__host__ __device__ __forceinline__ bool narrow_dim_ok(int d) {
  return head_dim_ok(d) && d <= NARROW_MAX;
}

__host__ __device__ __forceinline__ bool wide_dim_ok(int d) {
  return head_dim_ok(d) && d > NARROW_MAX;
}

}  // namespace

static inline float softmax_scale(int d) {
  return 1.0f / sqrtf((float)d);
}

template <typename K>
static inline cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// Each library builds from one .cu, so each defines this once.
extern "C" const char* ff_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
