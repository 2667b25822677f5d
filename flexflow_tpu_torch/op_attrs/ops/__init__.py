"""Operator attrs of the slices: Input, Weight, Linear, Embedding,
MultiHeadAttention, RingAttention, ElementUnary, ElementBinary, LayerNorm,
Softmax, Dropout, the four parallel ops, and the loss attrs."""

from flexflow_tpu_torch.op_attrs.ops.attention import MultiHeadAttentionAttrs
from flexflow_tpu_torch.op_attrs.ops.elementwise import (
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
)
from flexflow_tpu_torch.op_attrs.ops.io import InputAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.ops.linear_ops import AggregateSpec, EmbeddingAttrs, LinearAttrs
from flexflow_tpu_torch.op_attrs.ops.loss_functions import (
    LossAttrs,
    LossFunction,
    NonconfigurableLossAttrs,
    SparseCategoricalCrossEntropyLossAttrs,
    loss_attrs_for,
)
from flexflow_tpu_torch.op_attrs.ops.norm_ops import DropoutAttrs, LayerNormAttrs, SoftmaxAttrs
from flexflow_tpu_torch.op_attrs.ops.parallel_ops import (
    CombineAttrs,
    ReductionAttrs,
    RepartitionAttrs,
    ReplicateAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.ring_attention import RingAttentionAttrs

__all__ = [
    "AggregateSpec",
    "CombineAttrs",
    "DropoutAttrs",
    "ElementBinaryAttrs",
    "ElementBinaryOpType",
    "ElementUnaryAttrs",
    "ElementUnaryOpType",
    "EmbeddingAttrs",
    "InputAttrs",
    "LayerNormAttrs",
    "LinearAttrs",
    "LossAttrs",
    "LossFunction",
    "MultiHeadAttentionAttrs",
    "NonconfigurableLossAttrs",
    "ReductionAttrs",
    "RepartitionAttrs",
    "ReplicateAttrs",
    "RingAttentionAttrs",
    "SoftmaxAttrs",
    "SparseCategoricalCrossEntropyLossAttrs",
    "WeightAttrs",
    "loss_attrs_for",
]
