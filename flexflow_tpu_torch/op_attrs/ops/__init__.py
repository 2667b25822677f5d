"""Operator attrs of the port: Input, Weight, Noop, Linear, BatchMatmul,
Embedding, MultiHeadAttention, RingAttention, UlyssesAttention,
ElementUnary, ElementBinary, Cast, Broadcast, LayerNorm, Softmax, Dropout,
Conv2D, Pool2D, Flat, BatchNorm, Concat, Stack, Split, Reshape, Transpose,
Reverse, Gather, TopK, Reduce, GroupBy, Aggregate, Experts, the four
parallel ops, the two pipeline-stage ops and the loss attrs."""

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
    CastAttrs,
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
from flexflow_tpu_torch.op_attrs.ops.moe import (
    AggregateAttrs,
    ExpertsAttrs,
    GroupByAttrs,
    expert_capacity,
)
from flexflow_tpu_torch.op_attrs.ops.shape_ops import (
    ConcatAttrs,
    GatherAttrs,
    ReduceAttrs,
    ReduceOpType,
    ReshapeAttrs,
    ReverseAttrs,
    SplitAttrs,
    StackAttrs,
    TopKAttrs,
    TransposeAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.ulysses_attention import UlyssesAttentionAttrs

__all__ = [
    "AggregateAttrs",
    "AggregateSpec",
    "BatchMatmulAttrs",
    "BatchNormAttrs",
    "BroadcastAttrs",
    "CastAttrs",
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
    "GatherAttrs",
    "GroupByAttrs",
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
    "ReverseAttrs",
    "RingAttentionAttrs",
    "SoftmaxAttrs",
    "SparseCategoricalCrossEntropyLossAttrs",
    "SplitAttrs",
    "StackAttrs",
    "TopKAttrs",
    "TransposeAttrs",
    "UlyssesAttentionAttrs",
    "WeightAttrs",
    "expert_capacity",
    "loss_attrs_for",
]
