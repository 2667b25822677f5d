"""Linear, BatchMatmul and Embedding attrs (trimmed copy of
flexflow_tpu/op_attrs/ops/linear_ops.py: the sequential and the parallel
shape rules; BatchMatmul is attrs only, named by the search's rules).

Parallel rule (reference linear.cc:120-141):
  input      [.. batch dims .., in_c/dc], sum=si, copy=ri
  output     [.. batch dims .., out_c/ri], sum=si*dc, copy=1
  projection [in_c/dc, out_c/ri], sum=1, copy=si*prod(batch degrees)
  bias       [out_c/ri], sum=si*dc, copy=prod(batch degrees)
"""

from __future__ import annotations

import enum
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


class AggregateSpec(enum.Enum):
    """Embedding aggregation (reference: op-attrs/ops/embedding.h AggregateOp)."""

    NONE = "none"
    SUM = "sum"
    AVG = "avg"


@dataclass(frozen=True)
class BatchMatmulAttrs:
    """out[b, n, p] = lhs[b, n, m] @ rhs[b, m, p]; rank 2 is a plain matmul.
    The sequence-length dims are carried for parity with the reference and
    unused by the shape rules."""

    a_seq_length_dim: int = -1
    b_seq_length_dim: int = -1

    def output_shape(self, lhs: TensorShape, rhs: TensorShape) -> TensorShape:
        if not lhs.num_dims == rhs.num_dims >= 2:
            raise ValueError(f"batch matmul ranks: {lhs} x {rhs}")
        if lhs.dims[:-2] != rhs.dims[:-2]:
            raise ValueError(f"batch dims must match: {lhs} x {rhs}")
        if lhs.dims[-1] != rhs.dims[-2]:
            raise ValueError(f"contraction mismatch {lhs} x {rhs}")
        return TensorShape(lhs.dims[:-1] + (rhs.dims[-1],), lhs.dtype)

    def parallel_output_shape(
        self, lhs: ParallelTensorShape, rhs: ParallelTensorShape
    ) -> ParallelTensorShape:
        """Contraction partitioning yields partial sums; the n and p dims
        keep the degrees of their operands."""
        unpar = self.output_shape(get_reduced_shape(lhs), get_reduced_shape(rhs))
        ld, rd = lhs.shard_degrees(), rhs.shard_degrees()
        if ld[:-2] != rd[:-2] or ld[-1] != rd[-2]:
            raise ValueError(f"batch matmul degrees disagree: {lhs} x {rhs}")
        if not (lhs.sum_degree == rhs.sum_degree == 1 or ld[-1] == 1):
            raise ValueError(f"batch matmul of partial sums: {lhs} x {rhs}")
        sum_degree = lhs.sum_degree * rhs.sum_degree * ld[-1]
        return lift_to_parallel_with_degrees(unpar, sum_degree, 1, ld[:-1] + (rd[-1],))


@dataclass(frozen=True)
class EmbeddingAttrs:
    num_entries: int
    out_channels: int
    aggr: AggregateSpec = AggregateSpec.NONE
    dtype: DataType = DataType.FLOAT

    def output_shape(self, input: TensorShape) -> TensorShape:
        """input [.., seq] of ints -> output [.., seq, out_channels] (aggr NONE)
        or [.., out_channels] (SUM/AVG over the last input dim)."""
        if input.dtype.is_floating:
            raise ValueError("embedding input must be integral")
        if self.aggr == AggregateSpec.NONE:
            return TensorShape(input.dims + (self.out_channels,), self.dtype)
        return TensorShape(input.dims[:-1] + (self.out_channels,), self.dtype)

    def weight_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((self.num_entries, self.out_channels), self.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        """Reference embedding.cc:60-85: the out_channels dim inherits the
        input's discard-copy degree; aggregation needs an unsharded last dim."""
        unpar = self.output_shape(get_reduced_shape(input))
        in_degrees = input.shard_degrees()
        if self.aggr == AggregateSpec.NONE:
            out_degrees = in_degrees + (input.discard_copy_degree,)
        else:
            if in_degrees[-1] != 1:
                raise ValueError("cannot aggregate over a sharded dim")
            out_degrees = in_degrees[:-1] + (input.discard_copy_degree,)
        return lift_to_parallel_with_degrees(unpar, input.sum_degree, 1, out_degrees)

    def parallel_weight_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        """weight [vocab/1, out_c/ri], replicated across the input's shard dims
        (reference embedding.cc:88-111)."""
        unpar = self.weight_shape(get_reduced_shape(input))
        return lift_to_parallel_with_degrees(
            unpar, 1, prod(input.shard_degrees()), (1, input.discard_copy_degree)
        )
