"""Mixture-of-Experts attrs (copy of flexflow_tpu/op_attrs/ops/moe.py):
the GroupBy and Aggregate ops of the legacy composition, and the fused
Experts op with its sequential and parallel shape rules, named by the
search's expert-parallel rules. Their forwards are kernels/moe.py.

Expert parallelism: the input is replicated over the expert axes
(discard_copy_degree = ep) while the expert weights are sharded on their
leading expert dim; each expert group contributes a partial sum, so the
output carries sum_degree = ep.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from math import prod
from typing import List, Optional

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


def expert_capacity(num_tokens: int, num_experts: int, num_select: int, alpha: float) -> int:
    """Static per-expert token capacity."""
    return max(1, math.ceil(alpha * num_select * num_tokens / num_experts))


@dataclass(frozen=True)
class GroupByAttrs:
    """Route tokens to per-expert buffers (the legacy Group_by op).

    inputs: data [B, D] float, assign [B, k] int (expert indices from TopK);
    outputs: n_experts tensors [capacity, D], capacity = ceil(alpha*k*B/E)."""

    n_experts: int
    alpha: float = 1.0

    def capacity(self, data: TensorShape, assign: TensorShape) -> int:
        return expert_capacity(data.dims[0], self.n_experts, assign.dims[-1], self.alpha)

    def output_shapes(self, data: TensorShape, assign: TensorShape) -> List[TensorShape]:
        if data.num_dims != 2 or assign.num_dims != 2 or data.dims[0] != assign.dims[0]:
            raise ValueError(f"group_by takes data [B, D] and assign [B, k]: {data}, {assign}")
        if assign.dtype.is_floating:
            raise ValueError("group_by's assignment must be integral")
        cap = self.capacity(data, assign)
        return [TensorShape((cap, data.dims[1]), data.dtype) for _ in range(self.n_experts)]

    def parallel_output_shapes(self, data: ParallelTensorShape, assign: ParallelTensorShape
                               ) -> List[ParallelTensorShape]:
        """Dispatch positions are a cumsum over every token, so the op takes
        unsharded inputs (expert parallelism goes through Experts)."""
        if any(d != 1 for d in data.shard_degrees() + assign.shard_degrees()) or data.sum_degree != 1:
            raise ValueError(f"group_by takes unsharded inputs: {data}, {assign}")
        outs = self.output_shapes(get_reduced_shape(data), get_reduced_shape(assign))
        return [lift_to_parallel_with_degrees(o, 1, data.discard_copy_degree, (1,) * o.num_dims)
                for o in outs]


@dataclass(frozen=True)
class AggregateAttrs:
    """Combine per-expert outputs back into token order, weighted by the
    gate values (the legacy Aggregate op's data-bearing slots).

    inputs: gate_preds [B, k], gate_assign [B, k] int, then n exp_preds
    [capacity, D]; output [B, D]."""

    n: int

    def output_shape(self, *inputs: TensorShape) -> TensorShape:
        gate_preds, gate_assign, exp_preds = inputs[0], inputs[1], inputs[2:]
        if len(exp_preds) != self.n or gate_preds.dims != gate_assign.dims:
            raise ValueError(f"aggregate of {self.n} experts: {inputs}")
        return TensorShape((gate_preds.dims[0], exp_preds[0].dims[-1]), exp_preds[0].dtype)

    def parallel_output_shape(self, *inputs: ParallelTensorShape) -> ParallelTensorShape:
        for s in inputs:
            if any(d != 1 for d in s.shard_degrees()) or s.sum_degree != 1:
                raise ValueError(f"aggregate takes unsharded inputs: {s}")
        unpar = self.output_shape(*[get_reduced_shape(s) for s in inputs])
        return lift_to_parallel_with_degrees(unpar, 1, inputs[0].discard_copy_degree, (1, 1))


@dataclass(frozen=True)
class ExpertsAttrs:
    """Fused MoE FFN: gate -> top-k -> dispatch -> two-layer expert MLP ->
    combine (+ an optional load-balance aux loss).

    weights (slot order): gate [D, E]; w1 [E, D, H]; b1 [E, H];
    w2 [E, H, out]; b2 [E, out] (biases present iff use_bias).
    outputs: [.., out] and, when lambda_bal > 0, an aux-loss scalar [1]."""

    num_experts: int
    num_select: int
    hidden_size: int
    out_channels: Optional[int] = None
    activation: Optional[Activation] = Activation.RELU
    capacity_factor: float = 2.0
    use_bias: bool = True
    lambda_bal: float = 0.0

    def _out_dim(self, input: TensorShape) -> int:
        return self.out_channels or input.dims[-1]

    def capacity(self, input: TensorShape) -> int:
        return expert_capacity(
            prod(input.dims[:-1]), self.num_experts, self.num_select, self.capacity_factor
        )

    def output_shapes(self, input: TensorShape) -> List[TensorShape]:
        out = TensorShape(input.dims[:-1] + (self._out_dim(input),), input.dtype)
        if self.lambda_bal > 0:
            return [out, TensorShape((1,), input.dtype)]
        return [out]

    def weight_shapes(self, input: TensorShape) -> List[TensorShape]:
        d = input.dims[-1]
        e, h, o = self.num_experts, self.hidden_size, self._out_dim(input)
        ws = [TensorShape((d, e), input.dtype), TensorShape((e, d, h), input.dtype)]
        if self.use_bias:
            ws.append(TensorShape((e, h), input.dtype))
        ws.append(TensorShape((e, h, o), input.dtype))
        if self.use_bias:
            ws.append(TensorShape((e, o), input.dtype))
        return ws

    def parallel_output_shapes(self, input: ParallelTensorShape) -> List[ParallelTensorShape]:
        if input.shard_degrees()[-1] != 1 or input.sum_degree != 1:
            raise ValueError(f"experts need a whole feature dim and whole sums: {input}")
        ep = input.discard_copy_degree
        unpars = self.output_shapes(get_reduced_shape(input))
        in_degrees = input.shard_degrees()
        out = lift_to_parallel_with_degrees(unpars[0], ep, 1, in_degrees)
        if self.lambda_bal > 0:
            aux = lift_to_parallel_with_degrees(unpars[1], prod(in_degrees), ep, (1,))
            return [out, aux]
        return [out]

    def parallel_weight_shapes(self, input: ParallelTensorShape) -> List[ParallelTensorShape]:
        ep = input.discard_copy_degree
        batch = prod(input.shard_degrees())
        out: List[ParallelTensorShape] = []
        for i, w in enumerate(self.weight_shapes(get_reduced_shape(input))):
            if i == 0:  # the gate: replicated everywhere
                out.append(lift_to_parallel_with_degrees(w, 1, ep * batch, (1,) * w.num_dims))
            else:  # the expert tensors: shard the expert dim over the ep axes
                out.append(lift_to_parallel_with_degrees(
                    w, 1, batch, (ep,) + (1,) * (w.num_dims - 1)))
        return out
