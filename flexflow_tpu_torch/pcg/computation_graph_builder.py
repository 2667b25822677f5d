"""Eager ComputationGraph builder with automatic weight creation (trimmed
copy of flexflow_tpu/pcg/computation_graph_builder.py).

Covers create_input, create_weight, dense, embedding, multihead_attention,
conv2d, pool2d, flat, batch_norm, layer_norm, softmax, dropout, the
element-wise unary, scalar and binary ops (a binary op on operands of
different shapes gets the Broadcast ops the JAX builder inserts), cast,
the shape ops, top_k, and the mixture-of-experts ops: group_by, aggregate,
experts and moe (which records its load-balance output in
`aux_loss_tensors`); `weight_log` and `reuse_weights` give the Keras
frontend its shared layers. Each op creates its weight nodes first and then
the op node, in the JAX builder's order, so that parameter keys `n{idx}`
name the same weights in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.core import (
    OpAttrs,
    get_default_weight_initializers,
    get_output_shapes,
    get_weight_shapes,
)
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.ops import (
    AggregateSpec,
    BatchNormAttrs,
    ConcatAttrs,
    Conv2DAttrs,
    DropoutAttrs,
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
    EmbeddingAttrs,
    FlatAttrs,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    MultiHeadAttentionAttrs,
    Pool2DAttrs,
    PoolOp,
    ReshapeAttrs,
    SoftmaxAttrs,
    SplitAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.pcg.computation_graph import (
    ComputationGraph,
    LayerAttrs,
    TensorAttrs,
)
from flexflow_tpu_torch.pcg.initializer import (
    GlorotUniformAttrs,
    InitializerAttrs,
    ZeroInitializerAttrs,
)
from flexflow_tpu_torch.utils.graph import DataflowOutput

Tensor = DataflowOutput


class ComputationGraphBuilder:
    def __init__(self) -> None:
        self.graph = ComputationGraph()
        # outputs whose sums join the training loss (moe's load balance)
        self.aux_loss_tensors: List[Tensor] = []
        # every weight tensor created, in creation order: a frontend slices
        # it to find the weights one layer's build made, which
        # reuse_weights binds again at the layer's next call site
        self.weight_log: List[Tensor] = []
        self._reuse_queue: Optional[List[Tensor]] = None

    def reuse_weights(self, weights: Sequence[Tensor]):
        """Context manager: the ops built inside bind the given weight
        tensors, in order, instead of creating new ones (the Keras shared-
        layer contract: a layer applied at several call sites owns one set
        of parameters, and the gradients of its uses add up through the
        weight node's fan-out)."""
        import contextlib

        @contextlib.contextmanager
        def scope():
            assert self._reuse_queue is None, "reuse_weights scopes nest"
            self._reuse_queue = list(weights)
            try:
                yield
                assert not self._reuse_queue, (
                    f"{len(self._reuse_queue)} shared weight(s) left unbound"
                )
            finally:
                self._reuse_queue = None

        return scope()

    def add_layer(
        self,
        attrs: OpAttrs,
        inputs: Sequence[Tensor],
        weight_initializers: Sequence[Optional[InitializerAttrs]] = (),
        name: Optional[str] = None,
    ) -> List[Tensor]:
        """Create weight nodes for the op (if any), then the op node. Inside
        a reuse_weights scope the weight tensors come from the scope."""
        input_shapes = [self.graph.tensor_shape(t) for t in inputs]
        weight_shapes = get_weight_shapes(attrs, input_shapes)
        op_defaults = get_default_weight_initializers(attrs, len(weight_shapes))
        weight_tensors: List[Tensor] = []
        for i, ws in enumerate(weight_shapes):
            if self._reuse_queue is not None:
                assert self._reuse_queue, "shared-weight queue exhausted"
                w = self._reuse_queue.pop(0)
                have = self.graph.tensor_shape(w)
                assert have.dims == ws.dims, (
                    f"shared weight {i} has shape {have.dims}, op needs "
                    f"{ws.dims}: a layer can only be reused on inputs of "
                    "the same shape"
                )
                weight_tensors.append(w)
                continue
            init = (
                weight_initializers[i]
                if i < len(weight_initializers) and weight_initializers[i] is not None
                else op_defaults[i]
                or (GlorotUniformAttrs() if len(ws.dims) > 1 else ZeroInitializerAttrs())
            )
            wname = f"{name}.weight{i}" if name else None
            _, (w,) = self.graph.add_node(
                LayerAttrs(WeightAttrs(ws), wname),
                [],
                [TensorAttrs(ws, create_grad=True, initializer=init)],
            )
            weight_tensors.append(w)
            self.weight_log.append(w)
        out_shapes = get_output_shapes(attrs, input_shapes)
        _, outs = self.graph.add_node(
            LayerAttrs(attrs, name),
            list(inputs) + weight_tensors,
            [TensorAttrs(s) for s in out_shapes],
        )
        return outs

    def create_input(
        self,
        dims: Sequence[int],
        dtype: DataType = DataType.FLOAT,
        name: Optional[str] = None,
    ) -> Tensor:
        shape = TensorShape(tuple(dims), dtype)
        _, (t,) = self.graph.add_node(
            LayerAttrs(InputAttrs(shape), name),
            [],
            [TensorAttrs(shape, create_grad=False)],
        )
        return t

    def create_weight(
        self,
        dims: Sequence[int],
        dtype: DataType = DataType.FLOAT,
        initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        shape = TensorShape(tuple(dims), dtype)
        _, (t,) = self.graph.add_node(
            LayerAttrs(WeightAttrs(shape), name),
            [],
            [TensorAttrs(shape, create_grad=True, initializer=initializer or GlorotUniformAttrs())],
        )
        return t

    def dense(
        self,
        input: Tensor,
        out_channels: int,
        activation: Optional[Activation] = None,
        use_bias: bool = True,
        dtype: Optional[DataType] = None,
        kernel_initializer: Optional[InitializerAttrs] = None,
        bias_initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        attrs = LinearAttrs(
            out_channels=out_channels,
            use_bias=use_bias,
            dtype=dtype or self.graph.tensor_shape(input).dtype,
            activation=activation,
        )
        (out,) = self.add_layer(
            attrs, [input], [kernel_initializer, bias_initializer], name
        )
        return out

    def embedding(
        self,
        input: Tensor,
        num_entries: int,
        out_channels: int,
        aggr: AggregateSpec = AggregateSpec.NONE,
        dtype: DataType = DataType.FLOAT,
        kernel_initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        attrs = EmbeddingAttrs(num_entries, out_channels, aggr, dtype)
        (out,) = self.add_layer(attrs, [input], [kernel_initializer], name)
        return out

    def multihead_attention(
        self,
        query: Tensor,
        key: Tensor,
        value: Tensor,
        embed_dim: int,
        num_heads: int,
        kdim: int = 0,
        vdim: int = 0,
        dropout: float = 0.0,
        bias: bool = False,
        add_bias_kv: bool = False,
        add_zero_attn: bool = False,
        initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        attrs = MultiHeadAttentionAttrs(
            embed_dim, num_heads, kdim, vdim, dropout, bias, add_bias_kv, add_zero_attn
        )
        (out,) = self.add_layer(attrs, [query, key, value], [initializer], name)
        return out

    def conv2d(
        self,
        input: Tensor,
        out_channels: int,
        kernel: Tuple[int, int],
        stride: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0),
        groups: int = 1,
        activation: Optional[Activation] = None,
        use_bias: bool = True,
        kernel_initializer: Optional[InitializerAttrs] = None,
        bias_initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        attrs = Conv2DAttrs(
            out_channels, kernel[0], kernel[1], stride[0], stride[1],
            padding[0], padding[1], groups, activation, use_bias,
        )
        (out,) = self.add_layer(attrs, [input], [kernel_initializer, bias_initializer], name)
        return out

    def pool2d(
        self,
        input: Tensor,
        kernel: Tuple[int, int],
        stride: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0),
        pool_type: PoolOp = PoolOp.MAX,
        activation: Optional[Activation] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        attrs = Pool2DAttrs(
            kernel[0], kernel[1], stride[0], stride[1], padding[0], padding[1],
            pool_type, activation,
        )
        (out,) = self.add_layer(attrs, [input], [], name)
        return out

    def flat(self, input: Tensor, name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(FlatAttrs(), [input], [], name)
        return out

    def batch_norm(
        self, input: Tensor, relu: bool = False, affine: bool = True,
        eps: float = 1e-5, momentum: float = 0.1, name: Optional[str] = None,
    ) -> Tensor:
        """gamma (ones) and beta (zeros) are weight nodes made before the op
        node when `affine`, as the JAX builder makes them."""
        (out,) = self.add_layer(BatchNormAttrs(relu, affine, eps, momentum), [input], [], name)
        return out

    def layer_norm(
        self,
        input: Tensor,
        axes: Sequence[int],
        elementwise_affine: bool = True,
        eps: float = 1e-5,
        name: Optional[str] = None,
    ) -> Tensor:
        nd = self.graph.tensor_shape(input).num_dims
        attrs = LayerNormAttrs(tuple(a % nd for a in axes), elementwise_affine, eps)
        (out,) = self.add_layer(attrs, [input], [], name)
        return out

    def softmax(self, input: Tensor, dim: int = -1, name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(SoftmaxAttrs(dim), [input], [], name)
        return out

    def dropout(self, input: Tensor, rate: float, seed: int = 0,
                name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(DropoutAttrs(rate, seed), [input], [], name)
        return out

    # -- elementwise ------------------------------------------------------

    def _unary(self, op: ElementUnaryOpType, input: Tensor, scalar=None, name=None) -> Tensor:
        (out,) = self.add_layer(ElementUnaryAttrs(op, scalar), [input], [], name)
        return out

    def exp(self, x, name=None):
        return self._unary(ElementUnaryOpType.EXP, x, name=name)

    def log(self, x, name=None):
        return self._unary(ElementUnaryOpType.LOG, x, name=name)

    def sin(self, x, name=None):
        return self._unary(ElementUnaryOpType.SIN, x, name=name)

    def cos(self, x, name=None):
        return self._unary(ElementUnaryOpType.COS, x, name=name)

    def relu(self, x, name=None):
        return self._unary(ElementUnaryOpType.RELU, x, name=name)

    def sigmoid(self, x, name=None):
        return self._unary(ElementUnaryOpType.SIGMOID, x, name=name)

    def tanh(self, x, name=None):
        return self._unary(ElementUnaryOpType.TANH, x, name=name)

    def gelu(self, x, name=None):
        return self._unary(ElementUnaryOpType.GELU, x, name=name)

    def elu(self, x, name=None):
        return self._unary(ElementUnaryOpType.ELU, x, name=name)

    def rsqrt(self, x, name=None):
        return self._unary(ElementUnaryOpType.RSQRT, x, name=name)

    def sqrt(self, x, name=None):
        return self._unary(ElementUnaryOpType.SQRT, x, name=name)

    def identity(self, x, name=None):
        return self._unary(ElementUnaryOpType.IDENTITY, x, name=name)

    def scalar_multiply(self, x, scalar: float, name=None):
        return self._unary(ElementUnaryOpType.SCALAR_MULTIPLY, x, scalar, name)

    def scalar_add(self, x, scalar: float, name=None):
        return self._unary(ElementUnaryOpType.SCALAR_ADD, x, scalar, name)

    def scalar_sub(self, x, scalar: float, name=None):
        return self._unary(ElementUnaryOpType.SCALAR_SUB, x, scalar, name)

    def scalar_truediv(self, x, scalar: float, name=None):
        return self._unary(ElementUnaryOpType.SCALAR_TRUE_DIV, x, scalar, name)

    def pow(self, x, exponent: float, name=None):
        return self._unary(ElementUnaryOpType.POW, x, exponent, name)

    def _binary(self, op: ElementBinaryOpType, a: Tensor, b: Tensor, name=None) -> Tensor:
        a, b = self._broadcast_align(a, b)
        (out,) = self.add_layer(ElementBinaryAttrs(op), [a, b], [], name)
        return out

    def _broadcast_align(self, a: Tensor, b: Tensor) -> Tuple[Tensor, Tensor]:
        """Broadcast ops before a binary op whose operands' shapes differ
        (numpy's rules), as the JAX builder inserts them."""
        sa, sb = self.graph.tensor_shape(a), self.graph.tensor_shape(b)
        if sa.dims == sb.dims:
            return a, b
        target = tuple(int(d) for d in np.broadcast_shapes(sa.dims, sb.dims))
        if sa.dims != target:
            a = self.broadcast(a, target)
        if sb.dims != target:
            b = self.broadcast(b, target)
        return a, b

    def add(self, a, b, name=None):
        return self._binary(ElementBinaryOpType.ADD, a, b, name)

    def subtract(self, a, b, name=None):
        return self._binary(ElementBinaryOpType.SUB, a, b, name)

    def multiply(self, a, b, name=None):
        return self._binary(ElementBinaryOpType.MUL, a, b, name)

    def divide(self, a, b, name=None):
        return self._binary(ElementBinaryOpType.DIV, a, b, name)

    def max(self, a, b, name=None):
        return self._binary(ElementBinaryOpType.MAX, a, b, name)

    def min(self, a, b, name=None):
        return self._binary(ElementBinaryOpType.MIN, a, b, name)

    # -- shape ops ------------------------------------------------------------

    def cast(self, input: Tensor, dtype: DataType, name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import CastAttrs

        (out,) = self.add_layer(CastAttrs(dtype), [input], [], name)
        return out

    def transpose(self, input: Tensor, perm: Sequence[int], name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import TransposeAttrs

        (out,) = self.add_layer(TransposeAttrs(tuple(perm)), [input], [], name)
        return out

    def reverse(self, input: Tensor, axis: int, name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import ReverseAttrs

        (out,) = self.add_layer(ReverseAttrs(axis), [input], [], name)
        return out

    def gather(self, input: Tensor, index: Tensor, dim: int, name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import GatherAttrs

        (out,) = self.add_layer(GatherAttrs(dim), [input, index], [], name)
        return out

    def top_k(self, input: Tensor, k: int, sorted: bool = True, name=None
              ) -> Tuple[Tensor, Tensor]:
        from flexflow_tpu_torch.op_attrs.ops import TopKAttrs

        values, indices = self.add_layer(TopKAttrs(k, sorted), [input], [], name)
        return values, indices

    def concat(self, tensors: Sequence[Tensor], axis: int, name=None) -> Tensor:
        (out,) = self.add_layer(ConcatAttrs(axis), list(tensors), [], name)
        return out

    def stack(self, tensors: Sequence[Tensor], name=None) -> Tensor:
        """Stack same-shaped tensors along a new leading axis (the branch
        stacking entry; see compiler/branch_stacking.py)."""
        from flexflow_tpu_torch.op_attrs.ops import StackAttrs

        (out,) = self.add_layer(StackAttrs(), list(tensors), [], name)
        return out

    def broadcast(self, input: Tensor, target_dims: Sequence[int], name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import BroadcastAttrs

        (out,) = self.add_layer(BroadcastAttrs(tuple(target_dims)), [input], [], name)
        return out

    def reduce_sum(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                   name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import ReduceAttrs, ReduceOpType

        (out,) = self.add_layer(ReduceAttrs(ReduceOpType.SUM, tuple(axes), keepdims),
                                [input], [], name)
        return out

    def reduce_mean(self, input: Tensor, axes: Sequence[int], keepdims: bool = False,
                    name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import ReduceAttrs, ReduceOpType

        (out,) = self.add_layer(ReduceAttrs(ReduceOpType.MEAN, tuple(axes), keepdims),
                                [input], [], name)
        return out

    def split(self, input: Tensor, sizes: Sequence[int], axis: int, name=None) -> List[Tensor]:
        return self.add_layer(SplitAttrs(tuple(sizes), axis), [input], [], name)

    def reshape(self, input: Tensor, shape: Sequence[int], name=None) -> Tensor:
        (out,) = self.add_layer(ReshapeAttrs(tuple(shape)), [input], [], name)
        return out

    # -- mixture of experts (the legacy examples/cpp/mixture_of_experts) -----

    def group_by(self, data: Tensor, assign: Tensor, n_experts: int, alpha: float = 1.0,
                 name=None) -> List[Tensor]:
        from flexflow_tpu_torch.op_attrs.ops import GroupByAttrs

        return self.add_layer(GroupByAttrs(n_experts, alpha), [data, assign], [], name)

    def aggregate(self, gate_preds: Tensor, gate_assign: Tensor, exp_preds: Sequence[Tensor],
                  name=None) -> Tensor:
        from flexflow_tpu_torch.op_attrs.ops import AggregateAttrs

        (out,) = self.add_layer(AggregateAttrs(len(exp_preds)),
                                [gate_preds, gate_assign, *exp_preds], [], name)
        return out

    def experts(self, input: Tensor, num_experts: int, num_select: int, hidden_size: int,
                out_channels: Optional[int] = None,
                activation: Optional[Activation] = Activation.RELU,
                capacity_factor: float = 2.0, use_bias: bool = True, lambda_bal: float = 0.0,
                name=None) -> List[Tensor]:
        """The fused MoE FFN; returns [out] or [out, aux_loss]."""
        from flexflow_tpu_torch.op_attrs.ops import ExpertsAttrs

        attrs = ExpertsAttrs(num_experts, num_select, hidden_size, out_channels, activation,
                             capacity_factor, use_bias, lambda_bal)
        return self.add_layer(attrs, [input], [], name)

    def moe(self, input: Tensor, num_exp: int, num_select: int, hidden_size: int,
            alpha: float = 2.0, lambda_bal: float = 0.0, name=None) -> Tensor:
        """The legacy FFModel::moe signature over the fused Experts op; its
        load-balance output (lambda_bal > 0) is recorded in
        aux_loss_tensors for the training instance to add to the loss."""
        outs = self.experts(input, num_exp, num_select, hidden_size, capacity_factor=alpha,
                            lambda_bal=lambda_bal, name=name)
        if len(outs) > 1:
            self.aux_loss_tensors.append(outs[1])
        return outs[0]
