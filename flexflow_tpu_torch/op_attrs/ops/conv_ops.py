"""Conv2D, Pool2D, Flat and BatchNorm attrs, NCHW (copy of
flexflow_tpu/op_attrs/ops/conv_ops.py: the sequential and the parallel
shape rules and the weight shapes).

Parallel rules (reference conv_2d.cc:100-140): the sample degree passes,
partitioned in-channels yield partial sums, replication partitions the
out-channels; spatial dims stay unsharded."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from math import prod
from typing import Optional

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


def _whole_spatial(input: ParallelTensorShape) -> None:
    if input.shard_dim_at(2).degree != 1 or input.shard_dim_at(3).degree != 1:
        raise ValueError(f"spatial sharding is not supported: {input}")


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


@dataclass(frozen=True)
class Conv2DAttrs:
    out_channels: int
    kernel_h: int
    kernel_w: int
    stride_h: int = 1
    stride_w: int = 1
    padding_h: int = 0
    padding_w: int = 0
    groups: int = 1
    activation: Optional[Activation] = None
    use_bias: bool = True

    def output_shape(self, input: TensorShape) -> TensorShape:
        n, c, h, w = input.dims
        if c % self.groups:
            raise ValueError(f"conv2d: {c} input channels do not divide into {self.groups} groups")
        return TensorShape(
            (
                n,
                self.out_channels,
                _conv_out(h, self.kernel_h, self.stride_h, self.padding_h),
                _conv_out(w, self.kernel_w, self.stride_w, self.padding_w),
            ),
            input.dtype,
        )

    def kernel_shape(self, input: TensorShape) -> TensorShape:
        c = input.dims[1]
        return TensorShape(
            (self.out_channels, c // self.groups, self.kernel_h, self.kernel_w), input.dtype
        )

    def bias_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((self.out_channels,), input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        _whole_spatial(input)
        n_dim, c_dim = input.dims.shard_dims[:2]
        unpar = self.output_shape(get_reduced_shape(input))
        return lift_to_parallel_with_degrees(
            unpar, input.sum_degree * c_dim.degree, 1,
            (n_dim.degree, input.discard_copy_degree, 1, 1),
        )

    def parallel_kernel_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        n_dim, c_dim = input.dims.shard_dims[:2]
        unpar = self.kernel_shape(get_reduced_shape(input))
        return lift_to_parallel_with_degrees(
            unpar, 1, n_dim.degree * input.sum_degree,
            (input.discard_copy_degree, c_dim.degree, 1, 1),
        )

    def parallel_bias_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        n_dim, c_dim = input.dims.shard_dims[:2]
        unpar = self.bias_shape(get_reduced_shape(input))
        return lift_to_parallel_with_degrees(
            unpar, input.sum_degree * c_dim.degree, n_dim.degree,
            (input.discard_copy_degree,),
        )


class PoolOp(enum.Enum):
    MAX = "max"
    AVG = "avg"


@dataclass(frozen=True)
class Pool2DAttrs:
    kernel_h: int
    kernel_w: int
    stride_h: int = 1
    stride_w: int = 1
    padding_h: int = 0
    padding_w: int = 0
    pool_type: PoolOp = PoolOp.MAX
    activation: Optional[Activation] = None

    def output_shape(self, input: TensorShape) -> TensorShape:
        n, c, h, w = input.dims
        return TensorShape(
            (
                n,
                c,
                _conv_out(h, self.kernel_h, self.stride_h, self.padding_h),
                _conv_out(w, self.kernel_w, self.stride_w, self.padding_w),
            ),
            input.dtype,
        )

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        _whole_spatial(input)
        if input.sum_degree != 1 and self.pool_type != PoolOp.AVG:
            raise ValueError(f"max pooling over partial sums: {input}")
        n_dim, c_dim = input.dims.shard_dims[:2]
        unpar = self.output_shape(get_reduced_shape(input))
        return lift_to_parallel_with_degrees(
            unpar, input.sum_degree, input.discard_copy_degree,
            (n_dim.degree, c_dim.degree, 1, 1),
        )


@dataclass(frozen=True)
class FlatAttrs:
    """[n, c, h, w] -> [n, c*h*w]."""

    def output_shape(self, input: TensorShape) -> TensorShape:
        n, c, h, w = input.dims
        return TensorShape((n, c * h * w), input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if any(d.degree != 1 for d in input.dims.shard_dims[1:]):
            raise ValueError(f"flat needs unsharded c/h/w: {input}")
        unpar = self.output_shape(get_reduced_shape(input))
        return lift_to_parallel_with_degrees(
            unpar, input.sum_degree, input.discard_copy_degree,
            (input.shard_dim_at(0).degree, 1),
        )


@dataclass(frozen=True)
class BatchNormAttrs:
    relu: bool = False
    affine: bool = True
    eps: float = 1e-5
    momentum: float = 0.1

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def gamma_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((input.dims[1],), input.dtype)

    def beta_shape(self, input: TensorShape) -> TensorShape:
        return self.gamma_shape(input)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if input.sum_degree != 1:
            raise ValueError("batchnorm over partial sums is invalid")
        return input

    def parallel_gamma_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        dims = input.dims.shard_dims
        unpar = self.gamma_shape(get_reduced_shape(input))
        discard = prod(d.degree for i, d in enumerate(dims) if i != 1)
        return lift_to_parallel_with_degrees(
            unpar, 1, discard * input.discard_copy_degree, (dims[1].degree,)
        )
