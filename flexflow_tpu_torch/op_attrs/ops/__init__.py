"""Operator attrs of the slices: Input, Weight, Noop, Linear, Embedding,
MultiHeadAttention, RingAttention, ElementUnary, ElementBinary, LayerNorm,
Softmax, Dropout, the example zoo's Conv2D, Pool2D, Flat, BatchNorm, Concat,
Split and Reshape, the four parallel ops and the two pipeline-stage ops, the loss attrs, and the attrs the
search's rules name without a kernel in the port (UlyssesAttention,
BatchMatmul, Broadcast, Reduce, Experts)."""

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
    BroadcastAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.io import InputAttrs, NoopAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.ops.linear_ops import (
    AggregateSpec,
    BatchMatmulAttrs,
    EmbeddingAttrs,
    LinearAttrs,
)
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
    StageMergeAttrs,
    StagePartitionAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.ring_attention import RingAttentionAttrs
from flexflow_tpu_torch.op_attrs.ops.moe import ExpertsAttrs
from flexflow_tpu_torch.op_attrs.ops.shape_ops import (
    ConcatAttrs,
    ReduceAttrs,
    ReduceOpType,
    ReshapeAttrs,
    SplitAttrs,
    StackAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.ulysses_attention import UlyssesAttentionAttrs

__all__ = [
    "AggregateSpec",
    "BatchMatmulAttrs",
    "BatchNormAttrs",
    "BroadcastAttrs",
    "CombineAttrs",
    "ConcatAttrs",
    "Conv2DAttrs",
    "DropoutAttrs",
    "ElementBinaryAttrs",
    "ElementBinaryOpType",
    "ElementUnaryAttrs",
    "ElementUnaryOpType",
    "EmbeddingAttrs",
    "ExpertsAttrs",
    "FlatAttrs",
    "InputAttrs",
    "LayerNormAttrs",
    "LinearAttrs",
    "LossAttrs",
    "LossFunction",
    "MultiHeadAttentionAttrs",
    "NonconfigurableLossAttrs",
    "NoopAttrs",
    "Pool2DAttrs",
    "PoolOp",
    "ReduceAttrs",
    "ReduceOpType",
    "ReductionAttrs",
    "StageMergeAttrs",
    "StagePartitionAttrs",
    "RepartitionAttrs",
    "ReplicateAttrs",
    "ReshapeAttrs",
    "RingAttentionAttrs",
    "SoftmaxAttrs",
    "SparseCategoricalCrossEntropyLossAttrs",
    "SplitAttrs",
    "StackAttrs",
    "UlyssesAttentionAttrs",
    "WeightAttrs",
    "loss_attrs_for",
]
