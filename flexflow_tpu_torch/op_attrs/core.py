"""Operator types and uniform shape-inference dispatch over the op attrs
(copy of flexflow_tpu/op_attrs/core.py).

  get_output_shapes(attrs, inputs)           -> [TensorShape]
  get_weight_shapes(attrs, inputs)           -> [TensorShape]
  get_parallel_output_shapes(attrs, inputs)  -> [ParallelTensorShape]
  get_parallel_weight_shapes(attrs, inputs)  -> [ParallelTensorShape]
  get_incoming_tensor_roles(attrs)           -> [IncomingTensorRole] in slot order
"""

from __future__ import annotations

import enum
from typing import List, Sequence, Union

from flexflow_tpu_torch.op_attrs.ops import (
    AggregateAttrs,
    BatchMatmulAttrs,
    BatchNormAttrs,
    BroadcastAttrs,
    CastAttrs,
    CombineAttrs,
    ConcatAttrs,
    StackAttrs,
    Conv2DAttrs,
    DropoutAttrs,
    ElementBinaryAttrs,
    ElementUnaryAttrs,
    EmbeddingAttrs,
    ExpertsAttrs,
    FlatAttrs,
    GatherAttrs,
    GroupByAttrs,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    MultiHeadAttentionAttrs,
    NoopAttrs,
    Pool2DAttrs,
    ReduceAttrs,
    ReductionAttrs,
    RepartitionAttrs,
    ReplicateAttrs,
    ReshapeAttrs,
    ReverseAttrs,
    RingAttentionAttrs,
    SoftmaxAttrs,
    SplitAttrs,
    StageMergeAttrs,
    StagePartitionAttrs,
    TopKAttrs,
    TransposeAttrs,
    UlyssesAttentionAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


class OperatorType(enum.Enum):
    INPUT = "input"
    WEIGHT = "weight"
    NOOP = "noop"
    ELEMENT_UNARY = "element_unary"
    ELEMENT_BINARY = "element_binary"
    CAST = "cast"
    BROADCAST = "broadcast"
    LINEAR = "linear"
    BATCH_MATMUL = "batch_matmul"
    EMBEDDING = "embedding"
    LAYER_NORM = "layer_norm"
    SOFTMAX = "softmax"
    DROPOUT = "dropout"
    MULTIHEAD_ATTENTION = "multihead_attention"
    RING_ATTENTION = "ring_attention"
    ULYSSES_ATTENTION = "ulysses_attention"
    CONV2D = "conv2d"
    POOL2D = "pool2d"
    FLAT = "flat"
    BATCH_NORM = "batch_norm"
    CONCAT = "concat"
    STACK = "stack"  # branch-stacking entry (shape_ops.StackAttrs)
    SPLIT = "split"
    RESHAPE = "reshape"
    TRANSPOSE = "transpose"
    REVERSE = "reverse"
    GATHER = "gather"
    TOPK = "topk"
    REDUCE = "reduce"
    GROUP_BY = "group_by"
    AGGREGATE = "aggregate"
    EXPERTS = "experts"
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"
    # pipeline-stage boundaries: a schedule, not a layout, so not members of
    # PARALLEL_OP_TYPES (the chain canonicalizers must not cancel them)
    STAGE_PARTITION = "stage_partition"
    STAGE_MERGE = "stage_merge"


class IncomingTensorRole(enum.Enum):
    INPUT = "input"
    WEIGHT = "weight"


OpAttrs = Union[
    InputAttrs, WeightAttrs, NoopAttrs, ElementUnaryAttrs, ElementBinaryAttrs,
    CastAttrs, BroadcastAttrs, LinearAttrs, BatchMatmulAttrs, EmbeddingAttrs,
    LayerNormAttrs, SoftmaxAttrs, DropoutAttrs,
    MultiHeadAttentionAttrs, RingAttentionAttrs, UlyssesAttentionAttrs,
    Conv2DAttrs, Pool2DAttrs, FlatAttrs, BatchNormAttrs,
    ConcatAttrs, StackAttrs, SplitAttrs, ReshapeAttrs, TransposeAttrs, ReverseAttrs,
    GatherAttrs, TopKAttrs, ReduceAttrs, GroupByAttrs, AggregateAttrs, ExpertsAttrs,
    RepartitionAttrs, CombineAttrs, ReplicateAttrs, ReductionAttrs,
    StagePartitionAttrs, StageMergeAttrs,
]

_OP_TYPE_BY_ATTRS = {
    InputAttrs: OperatorType.INPUT,
    WeightAttrs: OperatorType.WEIGHT,
    NoopAttrs: OperatorType.NOOP,
    ElementUnaryAttrs: OperatorType.ELEMENT_UNARY,
    ElementBinaryAttrs: OperatorType.ELEMENT_BINARY,
    CastAttrs: OperatorType.CAST,
    BroadcastAttrs: OperatorType.BROADCAST,
    LinearAttrs: OperatorType.LINEAR,
    BatchMatmulAttrs: OperatorType.BATCH_MATMUL,
    EmbeddingAttrs: OperatorType.EMBEDDING,
    LayerNormAttrs: OperatorType.LAYER_NORM,
    SoftmaxAttrs: OperatorType.SOFTMAX,
    DropoutAttrs: OperatorType.DROPOUT,
    MultiHeadAttentionAttrs: OperatorType.MULTIHEAD_ATTENTION,
    RingAttentionAttrs: OperatorType.RING_ATTENTION,
    UlyssesAttentionAttrs: OperatorType.ULYSSES_ATTENTION,
    Conv2DAttrs: OperatorType.CONV2D,
    Pool2DAttrs: OperatorType.POOL2D,
    FlatAttrs: OperatorType.FLAT,
    BatchNormAttrs: OperatorType.BATCH_NORM,
    ConcatAttrs: OperatorType.CONCAT,
    StackAttrs: OperatorType.STACK,
    SplitAttrs: OperatorType.SPLIT,
    ReshapeAttrs: OperatorType.RESHAPE,
    TransposeAttrs: OperatorType.TRANSPOSE,
    ReverseAttrs: OperatorType.REVERSE,
    GatherAttrs: OperatorType.GATHER,
    TopKAttrs: OperatorType.TOPK,
    ReduceAttrs: OperatorType.REDUCE,
    GroupByAttrs: OperatorType.GROUP_BY,
    AggregateAttrs: OperatorType.AGGREGATE,
    ExpertsAttrs: OperatorType.EXPERTS,
    RepartitionAttrs: OperatorType.REPARTITION,
    CombineAttrs: OperatorType.COMBINE,
    ReplicateAttrs: OperatorType.REPLICATE,
    ReductionAttrs: OperatorType.REDUCTION,
    StagePartitionAttrs: OperatorType.STAGE_PARTITION,
    StageMergeAttrs: OperatorType.STAGE_MERGE,
}

PARALLEL_OP_TYPES = frozenset({
    OperatorType.REPARTITION, OperatorType.COMBINE, OperatorType.REPLICATE,
    OperatorType.REDUCTION,
})


STAGE_OP_TYPES = frozenset({OperatorType.STAGE_PARTITION, OperatorType.STAGE_MERGE})


def op_type_of(attrs: OpAttrs) -> OperatorType:
    return _OP_TYPE_BY_ATTRS[type(attrs)]


def is_parallel_op(attrs: OpAttrs) -> bool:
    return op_type_of(attrs) in PARALLEL_OP_TYPES


def is_stage_op(attrs: OpAttrs) -> bool:
    """Pipeline-stage boundary op? Kept out of is_parallel_op: the reshard
    chain normalizations must never merge a stage boundary away."""
    return op_type_of(attrs) in STAGE_OP_TYPES


def get_incoming_tensor_roles(attrs: OpAttrs) -> List[IncomingTensorRole]:
    """Role (INPUT vs WEIGHT) of each incoming tensor, in slot order."""
    I, W = IncomingTensorRole.INPUT, IncomingTensorRole.WEIGHT
    if isinstance(attrs, (LinearAttrs, Conv2DAttrs)):
        return [I, W, W] if attrs.use_bias else [I, W]
    if isinstance(attrs, EmbeddingAttrs):
        return [I, W]
    if isinstance(attrs, MultiHeadAttentionAttrs):
        return [I, I, I, W] + ([W, W] if attrs.bias else [])
    if isinstance(attrs, BatchNormAttrs):
        return [I, W, W] if attrs.affine else [I]
    if isinstance(attrs, LayerNormAttrs):
        return [I, W, W] if attrs.elementwise_affine else [I]
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return []
    if isinstance(attrs, ExpertsAttrs):
        return [I, W, W, W, W, W] if attrs.use_bias else [I, W, W, W]
    return [I] * num_data_inputs(attrs)


def num_data_inputs(attrs: OpAttrs) -> int:
    """Data (non-weight) inputs of the op; -1 for variadic ones."""
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return 0
    if isinstance(attrs, (ElementBinaryAttrs, BatchMatmulAttrs, GatherAttrs, GroupByAttrs)):
        return 2
    if isinstance(attrs, AggregateAttrs):
        return 2 + attrs.n
    if isinstance(attrs, MultiHeadAttentionAttrs):
        return 3
    if isinstance(attrs, (ConcatAttrs, StackAttrs)):
        return -1
    return 1


def num_outputs(attrs: OpAttrs, inputs: Sequence[TensorShape] = ()) -> int:
    if isinstance(attrs, SplitAttrs):
        return len(attrs.sizes)
    if isinstance(attrs, TopKAttrs):
        return 2
    if isinstance(attrs, GroupByAttrs):
        return attrs.n_experts
    if isinstance(attrs, ExpertsAttrs):
        return 2 if attrs.lambda_bal > 0 else 1
    return 1


def get_output_shapes(
    attrs: OpAttrs, inputs: Sequence[TensorShape]
) -> List[TensorShape]:
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return [attrs.output_shape()]
    if isinstance(attrs, (SplitAttrs, TopKAttrs, ExpertsAttrs)):
        return list(attrs.output_shapes(inputs[0]))
    if isinstance(attrs, GroupByAttrs):
        return list(attrs.output_shapes(inputs[0], inputs[1]))
    if isinstance(attrs, (RepartitionAttrs, CombineAttrs, ReplicateAttrs, ReductionAttrs)):
        # parallel ops are the identity on sequential shapes
        return [inputs[0]]
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
    if isinstance(attrs, Conv2DAttrs):
        ws = [attrs.kernel_shape(inputs[0])]
        if attrs.use_bias:
            ws.append(attrs.bias_shape(inputs[0]))
        return ws
    if isinstance(attrs, EmbeddingAttrs):
        return [attrs.weight_shape(inputs[0])]
    if isinstance(attrs, MultiHeadAttentionAttrs):
        q, k, v = inputs
        ws = [attrs.weights_shape(q, k, v)]
        if attrs.bias:
            ws += [attrs.input_bias_shape(q, k, v), attrs.output_bias_shape(q, k, v)]
        return ws
    if isinstance(attrs, BatchNormAttrs) and attrs.affine:
        return [attrs.gamma_shape(inputs[0]), attrs.beta_shape(inputs[0])]
    if isinstance(attrs, LayerNormAttrs) and attrs.elementwise_affine:
        return [attrs.gamma_shape(inputs[0]), attrs.beta_shape(inputs[0])]
    if isinstance(attrs, ExpertsAttrs):
        return list(attrs.weight_shapes(inputs[0]))
    return []


def get_parallel_output_shapes(
    attrs: OpAttrs, inputs: Sequence[ParallelTensorShape]
) -> List[ParallelTensorShape]:
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return [attrs.parallel_output_shape()]
    if isinstance(attrs, (SplitAttrs, TopKAttrs, ExpertsAttrs)):
        return list(attrs.parallel_output_shapes(inputs[0]))
    if isinstance(attrs, GroupByAttrs):
        return list(attrs.parallel_output_shapes(inputs[0], inputs[1]))
    return [attrs.parallel_output_shape(*inputs)]


def get_parallel_weight_shapes(
    attrs: OpAttrs, inputs: Sequence[ParallelTensorShape]
) -> List[ParallelTensorShape]:
    """Parallel weight shapes in slot order (after the data inputs)."""
    inputs = list(inputs)
    if isinstance(attrs, LinearAttrs):
        ws = [attrs.parallel_projection_shape(inputs[0])]
        if attrs.use_bias:
            ws.append(attrs.parallel_bias_shape(inputs[0]))
        return ws
    if isinstance(attrs, Conv2DAttrs):
        ws = [attrs.parallel_kernel_shape(inputs[0])]
        if attrs.use_bias:
            ws.append(attrs.parallel_bias_shape(inputs[0]))
        return ws
    if isinstance(attrs, EmbeddingAttrs):
        return [attrs.parallel_weight_shape(inputs[0])]
    if isinstance(attrs, MultiHeadAttentionAttrs):
        ws = [attrs.parallel_weights_shape(*inputs)]
        if attrs.bias:
            reduced = [get_reduced_shape(s) for s in inputs]
            ws += [lift_to_parallel(attrs.input_bias_shape(*reduced)),
                   lift_to_parallel(attrs.output_bias_shape(*reduced))]
        return ws
    if isinstance(attrs, (BatchNormAttrs, LayerNormAttrs)) and (
        attrs.affine if isinstance(attrs, BatchNormAttrs) else attrs.elementwise_affine
    ):
        g = attrs.parallel_gamma_shape(inputs[0])
        return [g, g]
    if isinstance(attrs, ExpertsAttrs):
        return list(attrs.parallel_weight_shapes(inputs[0]))
    return []


def get_default_weight_initializers(attrs: OpAttrs, num_weights: int):
    """Per-weight-slot default initializers (None = the builder's generic
    default: glorot for matrices, zero for vectors). LayerNorm's and
    BatchNorm's gamma start at one and their beta at zero; the embedding table takes the
    generic glorot, as in the JAX package."""
    from flexflow_tpu_torch.pcg.initializer import (
        ConstantInitializerAttrs,
        ZeroInitializerAttrs,
    )

    if isinstance(attrs, (BatchNormAttrs, LayerNormAttrs)):
        return [ConstantInitializerAttrs(1.0), ZeroInitializerAttrs()][:num_weights]
    return [None] * num_weights
