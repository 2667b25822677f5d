"""ElementUnary / ElementBinary / Cast / Broadcast attrs (copy of
flexflow_tpu/op_attrs/ops/elementwise.py: the sequential and the parallel
shape rules).

Elementwise ops keep shard degrees. A sum degree passes only through ops
that are linear in their input; nonlinear ops need it to be 1."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional, Tuple

from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims,
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


class ElementUnaryOpType(enum.Enum):
    EXP = "exp"
    LOG = "log"
    SIN = "sin"
    COS = "cos"
    IDENTITY = "identity"
    SCALAR_MULTIPLY = "scalar_multiply"
    SCALAR_ADD = "scalar_add"
    SCALAR_SUB = "scalar_sub"
    SCALAR_TRUE_DIV = "scalar_true_div"
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"
    ELU = "elu"
    RSQRT = "rsqrt"
    POW = "pow"
    SQRT = "sqrt"

    @property
    def is_linear(self) -> bool:
        """Linear ops commute with summation, so sum_degree passes through."""
        return self in (
            ElementUnaryOpType.IDENTITY,
            ElementUnaryOpType.SCALAR_MULTIPLY,
            ElementUnaryOpType.SCALAR_TRUE_DIV,
        )


class ElementBinaryOpType(enum.Enum):
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MAX = "max"
    MIN = "min"
    POW = "pow"

    @property
    def is_linear(self) -> bool:
        return self in (ElementBinaryOpType.ADD, ElementBinaryOpType.SUB)


@dataclass(frozen=True)
class ElementUnaryAttrs:
    op_type: ElementUnaryOpType
    scalar: Optional[float] = None

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if not self.op_type.is_linear and input.sum_degree != 1:
            raise ValueError(f"nonlinear unary op {self.op_type} over partial sums")
        return input


@dataclass(frozen=True)
class ElementBinaryAttrs:
    op_type: ElementBinaryOpType

    def output_shape(self, lhs: TensorShape, rhs: TensorShape) -> TensorShape:
        if lhs.dims != rhs.dims:
            raise ValueError(f"elementwise shape mismatch: {lhs} vs {rhs}")
        return lhs

    def parallel_output_shape(
        self, lhs: ParallelTensorShape, rhs: ParallelTensorShape
    ) -> ParallelTensorShape:
        if lhs.sizes() != rhs.sizes() or lhs.shard_degrees() != rhs.shard_degrees():
            raise ValueError(f"elementwise binary needs matching shapes and degrees: {lhs} vs {rhs}")
        if self.op_type.is_linear:
            if lhs.sum_degree != rhs.sum_degree:
                raise ValueError(f"{self.op_type} of differing sum degrees: {lhs} vs {rhs}")
        elif lhs.sum_degree != 1 or rhs.sum_degree != 1:
            raise ValueError(f"nonlinear binary op {self.op_type} over partial sums")
        return ParallelTensorShape(
            ParallelTensorDims(
                lhs.dims.shard_dims,
                lhs.sum_degree,
                min(lhs.discard_copy_degree, rhs.discard_copy_degree),
            ),
            lhs.dtype,
        )


@dataclass(frozen=True)
class CastAttrs:
    dtype: DataType

    def output_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape(input.dims, self.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        return ParallelTensorShape(input.dims, self.dtype)


@dataclass(frozen=True)
class BroadcastAttrs:
    """Broadcast input to target_dims (numpy semantics, trailing-aligned)."""

    target_dims: Tuple[int, ...]

    def output_shape(self, input: TensorShape) -> TensorShape:
        in_dims, t = input.dims, self.target_dims
        if len(t) < len(in_dims) or any(
            d not in (t[len(t) - 1 - i], 1) for i, d in enumerate(reversed(in_dims))
        ):
            raise ValueError(f"cannot broadcast {in_dims} to {t}")
        return TensorShape(t, input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        out = self.output_shape(get_reduced_shape(input))
        pairs = list(zip(input.shard_degrees(), input.sizes()))
        if any(size == 1 and deg != 1 for deg, size in pairs):
            raise ValueError(f"broadcast of a sharded unit dim: {input}")
        out_degrees = (1,) * (len(self.target_dims) - input.num_dims) + tuple(
            deg if size != 1 else 1 for deg, size in pairs
        )
        return lift_to_parallel_with_degrees(
            out, input.sum_degree, input.discard_copy_degree, out_degrees
        )
