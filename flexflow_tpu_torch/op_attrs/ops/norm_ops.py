"""LayerNorm, Softmax and Dropout attrs (trimmed copy of
flexflow_tpu/op_attrs/ops/norm_ops.py: the sequential and the parallel
shape rules)."""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Tuple

from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class LayerNormAttrs:
    axes: Tuple[int, ...]  # normalized axes (non-negative indices)
    elementwise_affine: bool = True
    eps: float = 1e-5

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def gamma_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape(tuple(input.dims[a] for a in self.axes), input.dtype)

    def beta_shape(self, input: TensorShape) -> TensorShape:
        return self.gamma_shape(input)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if input.sum_degree != 1 or any(input.shard_dim_at(a).degree != 1 for a in self.axes):
            raise ValueError(f"layer norm needs whole sums and unsharded normalized axes: {input}")
        return input

    def parallel_gamma_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        unpar = self.gamma_shape(get_reduced_shape(input))
        others = prod(d.degree for i, d in enumerate(input.dims.shard_dims) if i not in self.axes)
        return lift_to_parallel_with_degrees(
            unpar, 1, others * input.discard_copy_degree, (1,) * len(self.axes)
        )


@dataclass(frozen=True)
class SoftmaxAttrs:
    dim: int = -1

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if input.sum_degree != 1 or input.shard_dim_at(self.dim % input.num_dims).degree != 1:
            raise ValueError(f"softmax needs whole sums and an unsharded softmax dim: {input}")
        return input


@dataclass(frozen=True)
class DropoutAttrs:
    rate: float
    seed: int = 0

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if input.sum_degree != 1:
            raise ValueError(f"dropout over partial sums: {input}")
        return input
