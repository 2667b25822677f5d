"""ElementUnary / ElementBinary attrs (trimmed copy of
flexflow_tpu/op_attrs/ops/elementwise.py: the sequential shape rules only)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

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


class ElementBinaryOpType(enum.Enum):
    ADD = "add"
    SUB = "sub"
    MUL = "mul"
    DIV = "div"
    MAX = "max"
    MIN = "min"
    POW = "pow"


@dataclass(frozen=True)
class ElementUnaryAttrs:
    op_type: ElementUnaryOpType
    scalar: Optional[float] = None

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input


@dataclass(frozen=True)
class ElementBinaryAttrs:
    op_type: ElementBinaryOpType

    def output_shape(self, lhs: TensorShape, rhs: TensorShape) -> TensorShape:
        if lhs.dims != rhs.dims:
            raise ValueError(f"elementwise shape mismatch: {lhs} vs {rhs}")
        return lhs
