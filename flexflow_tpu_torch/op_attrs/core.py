"""Operator types and uniform shape-inference dispatch over the slices' op
attrs (trimmed copy of flexflow_tpu/op_attrs/core.py).

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
    BatchNormAttrs,
    CombineAttrs,
    ConcatAttrs,
    Conv2DAttrs,
    DropoutAttrs,
    ElementBinaryAttrs,
    ElementUnaryAttrs,
    EmbeddingAttrs,
    FlatAttrs,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    MultiHeadAttentionAttrs,
    Pool2DAttrs,
    ReductionAttrs,
    RepartitionAttrs,
    ReplicateAttrs,
    ReshapeAttrs,
    RingAttentionAttrs,
    SoftmaxAttrs,
    SplitAttrs,
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
    ELEMENT_UNARY = "element_unary"
    ELEMENT_BINARY = "element_binary"
    LINEAR = "linear"
    EMBEDDING = "embedding"
    LAYER_NORM = "layer_norm"
    SOFTMAX = "softmax"
    DROPOUT = "dropout"
    MULTIHEAD_ATTENTION = "multihead_attention"
    RING_ATTENTION = "ring_attention"
    CONV2D = "conv2d"
    POOL2D = "pool2d"
    FLAT = "flat"
    BATCH_NORM = "batch_norm"
    CONCAT = "concat"
    SPLIT = "split"
    RESHAPE = "reshape"
    REPARTITION = "repartition"
    COMBINE = "combine"
    REPLICATE = "replicate"
    REDUCTION = "reduction"


class IncomingTensorRole(enum.Enum):
    INPUT = "input"
    WEIGHT = "weight"


OpAttrs = Union[
    InputAttrs, WeightAttrs, ElementUnaryAttrs, ElementBinaryAttrs,
    LinearAttrs, EmbeddingAttrs, LayerNormAttrs, SoftmaxAttrs, DropoutAttrs,
    MultiHeadAttentionAttrs, RingAttentionAttrs,
    Conv2DAttrs, Pool2DAttrs, FlatAttrs, BatchNormAttrs,
    ConcatAttrs, SplitAttrs, ReshapeAttrs,
    RepartitionAttrs, CombineAttrs, ReplicateAttrs, ReductionAttrs,
]

_OP_TYPE_BY_ATTRS = {
    InputAttrs: OperatorType.INPUT,
    WeightAttrs: OperatorType.WEIGHT,
    ElementUnaryAttrs: OperatorType.ELEMENT_UNARY,
    ElementBinaryAttrs: OperatorType.ELEMENT_BINARY,
    LinearAttrs: OperatorType.LINEAR,
    EmbeddingAttrs: OperatorType.EMBEDDING,
    LayerNormAttrs: OperatorType.LAYER_NORM,
    SoftmaxAttrs: OperatorType.SOFTMAX,
    DropoutAttrs: OperatorType.DROPOUT,
    MultiHeadAttentionAttrs: OperatorType.MULTIHEAD_ATTENTION,
    RingAttentionAttrs: OperatorType.RING_ATTENTION,
    Conv2DAttrs: OperatorType.CONV2D,
    Pool2DAttrs: OperatorType.POOL2D,
    FlatAttrs: OperatorType.FLAT,
    BatchNormAttrs: OperatorType.BATCH_NORM,
    ConcatAttrs: OperatorType.CONCAT,
    SplitAttrs: OperatorType.SPLIT,
    ReshapeAttrs: OperatorType.RESHAPE,
    RepartitionAttrs: OperatorType.REPARTITION,
    CombineAttrs: OperatorType.COMBINE,
    ReplicateAttrs: OperatorType.REPLICATE,
    ReductionAttrs: OperatorType.REDUCTION,
}

PARALLEL_OP_TYPES = frozenset({
    OperatorType.REPARTITION, OperatorType.COMBINE, OperatorType.REPLICATE,
    OperatorType.REDUCTION,
})


def op_type_of(attrs: OpAttrs) -> OperatorType:
    return _OP_TYPE_BY_ATTRS[type(attrs)]


def is_parallel_op(attrs: OpAttrs) -> bool:
    return op_type_of(attrs) in PARALLEL_OP_TYPES


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
    if isinstance(attrs, ElementBinaryAttrs):
        return [I, I]
    return [I]


def get_output_shapes(
    attrs: OpAttrs, inputs: Sequence[TensorShape]
) -> List[TensorShape]:
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return [attrs.output_shape()]
    if isinstance(attrs, SplitAttrs):
        return list(attrs.output_shapes(inputs[0]))
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
    return []


def get_parallel_output_shapes(
    attrs: OpAttrs, inputs: Sequence[ParallelTensorShape]
) -> List[ParallelTensorShape]:
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        return [attrs.parallel_output_shape()]
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
    if isinstance(attrs, EmbeddingAttrs):
        return [attrs.parallel_weight_shape(inputs[0])]
    if isinstance(attrs, MultiHeadAttentionAttrs):
        ws = [attrs.parallel_weights_shape(*inputs)]
        if attrs.bias:
            reduced = [get_reduced_shape(s) for s in inputs]
            ws += [lift_to_parallel(attrs.input_bias_shape(*reduced)),
                   lift_to_parallel(attrs.output_bias_shape(*reduced))]
        return ws
    if isinstance(attrs, LayerNormAttrs) and attrs.elementwise_affine:
        g = attrs.parallel_gamma_shape(inputs[0])
        return [g, g]
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
