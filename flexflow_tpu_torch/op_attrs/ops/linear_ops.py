"""Linear attrs (trimmed copy of flexflow_tpu/op_attrs/ops/linear_ops.py:
the sequential and the parallel shape rules).

Parallel rule (reference linear.cc:120-141):
  input      [.. batch dims .., in_c/dc], sum=si, copy=ri
  output     [.. batch dims .., out_c/ri], sum=si*dc, copy=1
  projection [in_c/dc, out_c/ri], sum=1, copy=si*prod(batch degrees)
  bias       [out_c/ri], sum=si*dc, copy=prod(batch degrees)
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Optional

from flexflow_tpu_torch.op_attrs.activation import Activation, Regularizer
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class LinearAttrs:
    out_channels: int
    use_bias: bool = True
    dtype: DataType = DataType.FLOAT
    activation: Optional[Activation] = None
    regularizer: Optional[Regularizer] = None

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input.with_dim(-1, self.out_channels)

    def projection_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((input.dims[-1], self.out_channels), input.dtype)

    def bias_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((self.out_channels,), input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        unpar = self.output_shape(get_reduced_shape(input))
        in_degrees = input.shard_degrees()
        sum_degree = input.sum_degree * in_degrees[-1]
        out_degrees = in_degrees[:-1] + (input.discard_copy_degree,)
        return lift_to_parallel_with_degrees(unpar, sum_degree, 1, out_degrees)

    def parallel_projection_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        unpar = self.projection_shape(get_reduced_shape(input))
        in_degrees = input.shard_degrees()
        discard = input.sum_degree * prod(in_degrees[:-1])
        return lift_to_parallel_with_degrees(
            unpar, 1, discard, (in_degrees[-1], input.discard_copy_degree)
        )

    def parallel_bias_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        unpar = self.bias_shape(get_reduced_shape(input))
        in_degrees = input.shard_degrees()
        sum_degree = input.sum_degree * in_degrees[-1]
        return lift_to_parallel_with_degrees(
            unpar, sum_degree, prod(in_degrees[:-1]), (input.discard_copy_degree,)
        )
