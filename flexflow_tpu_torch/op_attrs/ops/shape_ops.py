"""Concat, Split and Reshape attrs (trimmed copy of
flexflow_tpu/op_attrs/ops/shape_ops.py: the shape ops of the example zoo,
with their sequential shape rules; the other shape ops wait, A2)."""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Tuple

from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class ConcatAttrs:
    axis: int

    def output_shape(self, *inputs: TensorShape) -> TensorShape:
        if not inputs:
            raise ValueError("concat needs at least one input")
        base = inputs[0]
        a = self.axis % base.num_dims
        total = 0
        for s in inputs:
            if s.num_dims != base.num_dims or any(
                s.dims[i] != base.dims[i] for i in range(base.num_dims) if i != a
            ):
                raise ValueError(f"concat mismatch off axis {a}: {s} vs {base}")
            total += s.dims[a]
        return base.with_dim(a, total)


@dataclass(frozen=True)
class SplitAttrs:
    sizes: Tuple[int, ...]
    axis: int

    def output_shapes(self, input: TensorShape) -> Tuple[TensorShape, ...]:
        a = self.axis % input.num_dims
        if sum(self.sizes) != input.dims[a]:
            raise ValueError(f"split sizes {self.sizes} do not sum to dim {a} of {input}")
        return tuple(input.with_dim(a, s) for s in self.sizes)


@dataclass(frozen=True)
class ReshapeAttrs:
    shape: Tuple[int, ...]

    def output_shape(self, input: TensorShape) -> TensorShape:
        if prod(self.shape) != prod(input.dims):
            raise ValueError(f"reshape {input.dims} -> {self.shape}")
        return TensorShape(self.shape, input.dtype)
