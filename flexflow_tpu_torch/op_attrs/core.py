"""Uniform shape-inference dispatch over the slice's op attrs (trimmed copy
of flexflow_tpu/op_attrs/core.py: sequential rules only).

  get_output_shapes(attrs, inputs)  -> [TensorShape]
  get_weight_shapes(attrs, inputs)  -> [TensorShape]
  get_incoming_tensor_roles(attrs)  -> [IncomingTensorRole] in slot order
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Union

from flexflow_tpu_torch.op_attrs.ops import (
    ElementBinaryAttrs,
    ElementUnaryAttrs,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    MultiHeadAttentionAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


class IncomingTensorRole(enum.Enum):
    INPUT = "input"
    WEIGHT = "weight"


OpAttrs = Union[
    InputAttrs, WeightAttrs, ElementUnaryAttrs, ElementBinaryAttrs,
    LinearAttrs, LayerNormAttrs, MultiHeadAttentionAttrs,
]


def get_incoming_tensor_roles(attrs: OpAttrs) -> List[IncomingTensorRole]:
    """Role (INPUT vs WEIGHT) of each incoming tensor, in slot order."""
    I, W = IncomingTensorRole.INPUT, IncomingTensorRole.WEIGHT
    if isinstance(attrs, LinearAttrs):
        return [I, W, W] if attrs.use_bias else [I, W]
    if isinstance(attrs, MultiHeadAttentionAttrs):
        return [I, I, I, W] + ([W, W] if attrs.bias else [])
    if isinstance(attrs, LayerNormAttrs):
        return [I, W, W] if attrs.elementwise_affine else [I]
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return []
    if isinstance(attrs, ElementBinaryAttrs):
        return [I, I]
    return [I]


def get_output_shapes(
    attrs: OpAttrs, inputs: Sequence[TensorShape]
) -> List[TensorShape]:
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return [attrs.output_shape()]
    return [attrs.output_shape(*inputs)]


def get_weight_shapes(
    attrs: OpAttrs, inputs: Sequence[TensorShape]
) -> List[TensorShape]:
    """Weight shapes in slot order (after the data inputs)."""
    inputs = list(inputs)
    if isinstance(attrs, LinearAttrs):
        ws = [attrs.projection_shape(inputs[0])]
        if attrs.use_bias:
            ws.append(attrs.bias_shape(inputs[0]))
        return ws
    if isinstance(attrs, MultiHeadAttentionAttrs):
        q, k, v = inputs
        ws = [attrs.weights_shape(q, k, v)]
        if attrs.bias:
            ws += [attrs.input_bias_shape(q, k, v), attrs.output_bias_shape(q, k, v)]
        return ws
    if isinstance(attrs, LayerNormAttrs) and attrs.elementwise_affine:
        return [attrs.gamma_shape(inputs[0]), attrs.beta_shape(inputs[0])]
    return []


def get_default_weight_initializers(attrs: OpAttrs, num_weights: int):
    """Per-weight-slot default initializers (None = the builder's generic
    default: glorot for matrices, zero for vectors). LayerNorm's gamma
    starts at one and its beta at zero."""
    from flexflow_tpu_torch.pcg.initializer import (
        ConstantInitializerAttrs,
        ZeroInitializerAttrs,
    )

    if isinstance(attrs, LayerNormAttrs):
        return [ConstantInitializerAttrs(1.0), ZeroInitializerAttrs()][:num_weights]
    return [None] * num_weights
