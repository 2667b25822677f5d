"""Single-device training: the graph interpreter and the train step (port
of flexflow_tpu/local_execution/training_backing.py:101-163, 241-436).

The JAX package composes forward, loss, backward and update into one jitted
program with donated buffers. Here the step runs eagerly: the interpreter
walks the graph, autograd produces the gradients (through the flash
kernels' own backward for attention), and the optimizer updates the
parameters in place.

Mixed precision works as in the JAX package: parameters and optimizer
state stay f32; parameters and float inputs are cast to `compute_dtype`
for the forward; loss math is f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.kernels import (
    apply_optimizer_,
    forward as kernel_forward,
    loss_forward,
    make_optimizer_state,
)
from flexflow_tpu_torch.kernels.precision import cast_for_compute
from flexflow_tpu_torch.op_attrs.core import (
    IncomingTensorRole,
    OpAttrs,
    get_incoming_tensor_roles,
)
from flexflow_tpu_torch.op_attrs.ops import InputAttrs, LossAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.initializer import initialize
from flexflow_tpu_torch.pcg.optimizer import OptimizerAttrs
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node

# Parameters are keyed by weight-node index ("n3"), as in the JAX package.
ParamKey = str


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another. Without a card and without an explicit device this raises; it
    never falls back to the CPU on its own."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def param_key(n: Node) -> ParamKey:
    return f"n{n.idx}"


def slot_roles(attrs: OpAttrs, n_slots: int) -> List[IncomingTensorRole]:
    """Effective per-slot roles for an op with n_slots wired inputs: the
    op's declared IncomingTensorRole order, or all-INPUT when the counts
    differ. The one definition behind split_slot_values and the serving
    cache's weight-slot lookups."""
    roles = get_incoming_tensor_roles(attrs)
    if len(roles) != n_slots:
        return [IncomingTensorRole.INPUT] * n_slots
    return list(roles)


def split_slot_values(attrs: OpAttrs, slot_values: List) -> Tuple[List, List]:
    """Split an op node's input-slot values into (data inputs, weights) by
    the op's IncomingTensorRole order (all inputs when the counts differ)."""
    roles = slot_roles(attrs, len(slot_values))
    inputs = [v for v, r in zip(slot_values, roles) if r == IncomingTensorRole.INPUT]
    weights = [v for v, r in zip(slot_values, roles) if r == IncomingTensorRole.WEIGHT]
    return inputs, weights


def weight_nodes(cg: ComputationGraph) -> List[Node]:
    return [n for n in cg.topological_ordering() if isinstance(cg.op_attrs(n), WeightAttrs)]


def weight_shape(graph, n: Node) -> TensorShape:
    """The global shape of weight node n's value; a PCG's tensors carry
    parallel degrees beside it."""
    (out,) = graph.outputs_of(n)
    shape = graph.tensor_shape(out)
    return get_reduced_shape(shape) if isinstance(shape, ParallelTensorShape) else shape


def init_params(cg: ComputationGraph, seed: int, device) -> Dict[ParamKey, torch.Tensor]:
    """Materialize every weight node of a CG or a PCG from its initializer
    attrs, at its global shape. Each weight draws from its own CPU generator
    seeded from (seed, node index), so the values do not depend on the
    device or on the order of creation."""
    params: Dict[ParamKey, torch.Tensor] = {}
    for n in weight_nodes(cg):
        (out,) = cg.outputs_of(n)
        ta = cg.tensor_attrs(out)
        if ta.initializer is None:
            raise ValueError(f"weight node {n} has no initializer")
        gen = torch.Generator().manual_seed(seed * 1_000_003 + n.idx)
        shape = weight_shape(cg, n)
        value = initialize(ta.initializer, gen, shape.dims, shape.dtype.to_torch())
        params[param_key(n)] = value.to(device)
    return params


def forward_interpreter(
    cg: ComputationGraph,
    params: Dict[ParamKey, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
) -> Dict[DataflowOutput, torch.Tensor]:
    """Evaluate the graph: every tensor value keyed by DataflowOutput.
    inputs: keyed by input-layer name (or param_key of the input node)."""
    env: Dict[DataflowOutput, torch.Tensor] = {}
    for n in cg.topological_ordering():
        la = cg.layer_attrs(n)
        outs = cg.outputs_of(n)
        if isinstance(la.attrs, InputAttrs):
            key = la.name if la.name is not None and la.name in inputs else param_key(n)
            if key not in inputs:
                raise KeyError(f"missing input binding for {la.name or key}")
            env[outs[0]] = inputs[key]
        elif isinstance(la.attrs, WeightAttrs):
            env[outs[0]] = params[param_key(n)]
        else:
            slot_vals = [env[v] for v in cg.inputs_of(n)]
            data_vals, weight_vals = split_slot_values(la.attrs, slot_vals)
            for o, r in zip(outs, kernel_forward(la.attrs, data_vals, weight_vals)):
                env[o] = r
    return env


class ModelTrainingInstance:
    """Graph + loss + optimizer -> a train step on one device."""

    def __init__(
        self,
        cg: ComputationGraph,
        logit_tensor: DataflowOutput,
        loss_attrs: LossAttrs,
        optimizer_attrs: OptimizerAttrs,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> None:
        """compute_dtype: params and optimizer state stay f32, and the
        forward/backward run in this dtype (None = the params' dtype).
        device: CUDA unless given; see resolve_device."""
        self.cg = cg
        self.logit_tensor = logit_tensor
        self.loss_attrs = loss_attrs
        self.optimizer_attrs = optimizer_attrs
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

    def initialize(self, seed: int = 0):
        params = init_params(self.cg, seed, self.device)
        return params, make_optimizer_state(self.optimizer_attrs, params)

    def _to_device(self, batch_inputs) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch_inputs.items()}

    def loss_fn(self, params, batch_inputs, label):
        env = forward_interpreter(
            self.cg,
            cast_for_compute(params, self.compute_dtype),
            cast_for_compute(self._to_device(batch_inputs), self.compute_dtype),
        )
        logit = env[self.logit_tensor]
        loss = loss_forward(self.loss_attrs, logit, torch.as_tensor(label, device=self.device))
        return loss, logit

    def loss_and_grads(self, params, batch_inputs, label):
        """(loss, {key: f32 gradient}) at `params`, which are not modified."""
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss, _ = self.loss_fn(leaves, batch_inputs, label)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        return loss.detach(), {
            k: torch.zeros_like(leaves[k]) if g is None else g for k, g in zip(leaves, grads)
        }

    def train_step(self, params, opt_state, batch_inputs, label):
        """One forward, backward and update. Updates params and opt_state in
        place and returns (params, opt_state, loss, metrics); the metrics
        dict is empty in this port so far."""
        loss, grads = self.loss_and_grads(params, batch_inputs, label)
        apply_optimizer_(self.optimizer_attrs, params, grads, opt_state)
        return params, opt_state, loss, {}

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """Logits at `params`, in the params' dtype (as the JAX package's
        forward, which applies no compute_dtype)."""
        env = forward_interpreter(self.cg, params, self._to_device(batch_inputs))
        return env[self.logit_tensor]
