"""Linear attrs (trimmed copy of flexflow_tpu/op_attrs/ops/linear_ops.py:
the sequential shape rules only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from flexflow_tpu_torch.op_attrs.activation import Activation, Regularizer
from flexflow_tpu_torch.op_attrs.datatype import DataType
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
