"""Eager ParallelComputationGraph builder (trimmed copy of
flexflow_tpu/pcg/parallel_computation_graph_builder.py).

Covers create_input_tensor, create_weight_tensor, the parallel ops
parallel_partition / parallel_combine / parallel_replicate /
parallel_reduce, dense, experts, multihead_attention, ring_attention,
gelu, layer_norm and add. Each op creates its weight nodes first and then the op
node, in the JAX builder's order, so that parameter keys `n{idx}` name the
same weights in both packages.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.core import (
    OpAttrs,
    get_default_weight_initializers,
    get_parallel_output_shapes,
    get_parallel_weight_shapes,
)
from flexflow_tpu_torch.op_attrs.ops import (
    CombineAttrs,
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    MultiHeadAttentionAttrs,
    ReductionAttrs,
    RepartitionAttrs,
    ReplicateAttrs,
    RingAttentionAttrs,
    StageMergeAttrs,
    StagePartitionAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
)
from flexflow_tpu_torch.pcg.initializer import (
    GlorotUniformAttrs,
    InitializerAttrs,
    ZeroInitializerAttrs,
)
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    ParallelLayerAttrs,
    ParallelTensorAttrs,
)
from flexflow_tpu_torch.utils.graph import DataflowOutput

Tensor = DataflowOutput


class ParallelComputationGraphBuilder:
    def __init__(self) -> None:
        self.graph = ParallelComputationGraph()

    def add_layer(
        self,
        attrs: OpAttrs,
        inputs: Sequence[Tensor],
        weight_initializers: Sequence[Optional[InitializerAttrs]] = (),
        name: Optional[str] = None,
    ) -> List[Tensor]:
        """Create weight nodes for the op (if any), then the op node."""
        input_shapes = [self.graph.tensor_shape(t) for t in inputs]
        weight_shapes = get_parallel_weight_shapes(attrs, input_shapes)
        op_defaults = get_default_weight_initializers(attrs, len(weight_shapes))
        weight_tensors: List[Tensor] = []
        for i, ws in enumerate(weight_shapes):
            init = (
                weight_initializers[i]
                if i < len(weight_initializers) and weight_initializers[i] is not None
                else op_defaults[i]
                or (GlorotUniformAttrs() if ws.num_dims > 1 else ZeroInitializerAttrs())
            )
            wname = f"{name}.weight{i}" if name else None
            _, (w,) = self.graph.add_node(
                ParallelLayerAttrs(WeightAttrs(get_reduced_shape(ws)), wname),
                [],
                [ParallelTensorAttrs(ws, create_grad=True, initializer=init)],
            )
            weight_tensors.append(w)
        out_shapes = get_parallel_output_shapes(attrs, input_shapes)
        _, outs = self.graph.add_node(
            ParallelLayerAttrs(attrs, name),
            list(inputs) + weight_tensors,
            [ParallelTensorAttrs(s) for s in out_shapes],
        )
        return outs

    def create_input_tensor(
        self, shape: ParallelTensorShape, create_grad: bool = False, name: Optional[str] = None
    ) -> Tensor:
        _, (t,) = self.graph.add_node(
            ParallelLayerAttrs(InputAttrs(get_reduced_shape(shape)), name),
            [],
            [ParallelTensorAttrs(shape, create_grad=create_grad)],
        )
        return t

    def create_weight_tensor(
        self,
        shape: ParallelTensorShape,
        initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        _, (t,) = self.graph.add_node(
            ParallelLayerAttrs(WeightAttrs(get_reduced_shape(shape)), name),
            [],
            [ParallelTensorAttrs(shape, create_grad=True,
                                 initializer=initializer or GlorotUniformAttrs())],
        )
        return t

    # -- the four parallel ops --------------------------------------------

    def parallel_partition(self, input: Tensor, dim: int, degree: int,
                           name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(RepartitionAttrs(dim, degree), [input], [], name)
        return out

    def parallel_combine(self, input: Tensor, dim: int, degree: int,
                         name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(CombineAttrs(dim, degree), [input], [], name)
        return out

    def parallel_replicate(self, input: Tensor, degree: int, name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(ReplicateAttrs(degree), [input], [], name)
        return out

    def parallel_reduce(self, input: Tensor, degree: int, name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(ReductionAttrs(degree), [input], [], name)
        return out

    # -- the pipeline-stage ops -------------------------------------------

    def parallel_stage_partition(self, input: Tensor, num_stages: int, num_microbatches: int,
                                 stage_index: int = 0, name: Optional[str] = None) -> Tensor:
        """The pipeline region's entry (stage_index=0) or its stage_index-th
        boundary between stages. The identity on the value; the 1F1B
        executor and the machine-mapping DP act on the annotation."""
        (out,) = self.add_layer(
            StagePartitionAttrs(num_stages, num_microbatches, stage_index), [input], [], name)
        return out

    def parallel_stage_merge(self, input: Tensor, num_stages: int, num_microbatches: int,
                             name: Optional[str] = None) -> Tensor:
        """The pipeline region's exit: the microbatch outputs form the batch."""
        (out,) = self.add_layer(StageMergeAttrs(num_stages, num_microbatches), [input], [], name)
        return out

    # -- compute ops ------------------------------------------------------

    def dense(
        self,
        input: Tensor,
        out_channels: int,
        activation: Optional[Activation] = None,
        use_bias: bool = True,
        kernel_initializer: Optional[InitializerAttrs] = None,
        bias_initializer: Optional[InitializerAttrs] = None,
        name: Optional[str] = None,
    ) -> Tensor:
        attrs = LinearAttrs(
            out_channels=out_channels,
            use_bias=use_bias,
            dtype=self.graph.tensor_shape(input).dtype,
            activation=activation,
        )
        (out,) = self.add_layer(attrs, [input], [kernel_initializer, bias_initializer], name)
        return out

    def experts(self, input: Tensor, num_experts: int, num_select: int, hidden_size: int,
                out_channels: Optional[int] = None,
                activation: Optional[Activation] = Activation.RELU,
                capacity_factor: float = 2.0, use_bias: bool = True, lambda_bal: float = 0.0,
                name: Optional[str] = None) -> List[Tensor]:
        """The fused MoE FFN. Expert parallelism: parallel_replicate the
        input to degree ep first (the op then shards its expert weights over
        the replica axes and gives a sum_degree = ep output for
        parallel_reduce)."""
        from flexflow_tpu_torch.op_attrs.ops import ExpertsAttrs

        attrs = ExpertsAttrs(num_experts, num_select, hidden_size, out_channels, activation,
                             capacity_factor, use_bias, lambda_bal)
        return self.add_layer(attrs, [input], [], name)

    def multihead_attention(self, query: Tensor, key: Tensor, value: Tensor, embed_dim: int,
                            num_heads: int, name: Optional[str] = None) -> Tensor:
        attrs = MultiHeadAttentionAttrs(embed_dim, num_heads)
        (out,) = self.add_layer(attrs, [query, key, value], [], name)
        return out

    def ring_attention(self, query: Tensor, key: Tensor, value: Tensor, embed_dim: int,
                       num_heads: int, causal: bool = False, name: Optional[str] = None) -> Tensor:
        """Sequence-parallel attention: the inputs may carry a sequence shard
        degree (op_attrs/ops/ring_attention.py)."""
        attrs = RingAttentionAttrs(embed_dim, num_heads, causal=causal)
        (out,) = self.add_layer(attrs, [query, key, value], [], name)
        return out

    def gelu(self, x: Tensor, name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(ElementUnaryAttrs(ElementUnaryOpType.GELU), [x], [], name)
        return out

    def layer_norm(self, x: Tensor, axes: Sequence[int], elementwise_affine: bool = True,
                   eps: float = 1e-5, name: Optional[str] = None) -> Tensor:
        nd = self.graph.tensor_shape(x).num_dims
        attrs = LayerNormAttrs(tuple(a % nd for a in axes), elementwise_affine, eps)
        (out,) = self.add_layer(attrs, [x], [], name)
        return out

    def add(self, a: Tensor, b: Tensor, name: Optional[str] = None) -> Tensor:
        (out,) = self.add_layer(ElementBinaryAttrs(ElementBinaryOpType.ADD), [a, b], [], name)
        return out
