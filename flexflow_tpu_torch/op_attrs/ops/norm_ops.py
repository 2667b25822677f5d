"""LayerNorm attrs (trimmed copy of flexflow_tpu/op_attrs/ops/norm_ops.py:
the sequential shape rules only)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

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
