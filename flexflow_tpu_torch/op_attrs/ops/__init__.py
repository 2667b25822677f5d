"""Operator attrs of the slice: Input, Weight, Linear, MultiHeadAttention,
ElementUnary, ElementBinary, LayerNorm, and the loss attrs."""

from flexflow_tpu_torch.op_attrs.ops.attention import MultiHeadAttentionAttrs
from flexflow_tpu_torch.op_attrs.ops.elementwise import (
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
)
from flexflow_tpu_torch.op_attrs.ops.io import InputAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.ops.linear_ops import LinearAttrs
from flexflow_tpu_torch.op_attrs.ops.loss_functions import (
    LossAttrs,
    LossFunction,
    NonconfigurableLossAttrs,
    SparseCategoricalCrossEntropyLossAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.norm_ops import LayerNormAttrs

__all__ = [
    "ElementBinaryAttrs",
    "ElementBinaryOpType",
    "ElementUnaryAttrs",
    "ElementUnaryOpType",
    "InputAttrs",
    "LayerNormAttrs",
    "LinearAttrs",
    "LossAttrs",
    "LossFunction",
    "MultiHeadAttentionAttrs",
    "NonconfigurableLossAttrs",
    "SparseCategoricalCrossEntropyLossAttrs",
    "WeightAttrs",
]
