"""Operator attrs of the slices: Input, Weight, Linear, Embedding,
MultiHeadAttention, RingAttention, ElementUnary, ElementBinary, LayerNorm,
Softmax, Dropout, the example zoo's Conv2D, Pool2D, Flat, BatchNorm, Concat,
Split and Reshape, the four parallel ops, and the loss attrs."""

from flexflow_tpu_torch.op_attrs.ops.attention import MultiHeadAttentionAttrs
from flexflow_tpu_torch.op_attrs.ops.conv_ops import (
    BatchNormAttrs,
    Conv2DAttrs,
    FlatAttrs,
    Pool2DAttrs,
    PoolOp,
)
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
from flexflow_tpu_torch.op_attrs.ops.shape_ops import ConcatAttrs, ReshapeAttrs, SplitAttrs

__all__ = [
    "AggregateSpec",
    "BatchNormAttrs",
    "CombineAttrs",
    "ConcatAttrs",
    "Conv2DAttrs",
    "DropoutAttrs",
    "ElementBinaryAttrs",
    "ElementBinaryOpType",
    "ElementUnaryAttrs",
    "ElementUnaryOpType",
    "EmbeddingAttrs",
    "FlatAttrs",
    "InputAttrs",
    "LayerNormAttrs",
    "LinearAttrs",
    "LossAttrs",
    "LossFunction",
    "MultiHeadAttentionAttrs",
    "NonconfigurableLossAttrs",
    "Pool2DAttrs",
    "PoolOp",
    "ReductionAttrs",
    "RepartitionAttrs",
    "ReplicateAttrs",
    "ReshapeAttrs",
    "RingAttentionAttrs",
    "SoftmaxAttrs",
    "SparseCategoricalCrossEntropyLossAttrs",
    "SplitAttrs",
    "WeightAttrs",
    "loss_attrs_for",
]
