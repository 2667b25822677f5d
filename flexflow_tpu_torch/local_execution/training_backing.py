"""Single-device training: the graph interpreter, the train step, the fused
K-step window and the stepped per-op execution (port of
flexflow_tpu/local_execution/training_backing.py:101-560).

The JAX package composes forward, loss, backward and update into one jitted
program with donated buffers. Here the step runs eagerly: the interpreter
walks the graph, autograd produces the gradients (through the flash
kernels' own backward for attention), and the optimizer updates the
parameters in place.

Mixed precision works as in the JAX package: parameters and optimizer
state stay f32; parameters and float inputs are cast to `compute_dtype`
for the forward; loss math is f32.

The fused window (`steps_per_dispatch > 1`) runs K train steps as one
call: on a CUDA device one captured CUDA graph of the K steps, replayed with
one launch (runtime/cuda_graph.py), where the JAX package jits a donated
`lax.scan` of them; on the CPU the same K steps run eagerly.

LocalTrainingBacking is the reference's stepped API (execute_init, forward,
backward, update), one op at a time. The JAX package recomputes each op
under jax.vjp in its backward; here the forward runs each op on detached
leaves of its inputs with autograd on and keeps the op's graph, and the
backward asks autograd for each op's input gradients in reverse
topological order. Nothing is recomputed, so a flash-attention op launches
its forward kernel once per forward and its delta and backward kernels
once per backward. The price is memory: each op holds what autograd saves
for it, and every op's output, from the forward until the next forward
(as one autograd graph of the whole step would until its backward).
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import torch

from flexflow_tpu_torch.kernels import (
    apply_optimizer_,
    forward as kernel_forward,
    loss_forward,
    make_optimizer_state,
)
from flexflow_tpu_torch.kernels.metrics import compute_metrics
from flexflow_tpu_torch.kernels.ops import apply_dropout_mask, dropout_keep_mask
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
from flexflow_tpu_torch.runtime.cuda_graph import CapturedGraphs, layout_key, shape_key
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


def input_binding(cg: ComputationGraph, n: Node, inputs: Dict[str, torch.Tensor]):
    """The value bound to input node n: by its layer name, else by its
    param_key."""
    la = cg.layer_attrs(n)
    key = la.name if la.name is not None and la.name in inputs else param_key(n)
    if key not in inputs:
        raise KeyError(f"missing input binding for {la.name or key}")
    return inputs[key]


def dropout_order(graph) -> List[Node]:
    """The order in which a step draws the Dropout masks of a CG or a PCG
    (ops at rate 0 draw nothing): by each op's key, which a plan's PCG
    shares with the CG it was searched from: a named op's layer name (the
    substitutions keep names), the named before the unnamed, then the op's
    ordinal in topological order among the Dropouts of its name. Unnamed
    ops thus draw in topological order, which a plan must keep for them."""
    from flexflow_tpu_torch.op_attrs.ops import DropoutAttrs

    keyed, seen = [], Counter()
    for n in graph.topological_ordering():
        attrs = graph.op_attrs(n)
        if isinstance(attrs, DropoutAttrs) and attrs.rate > 0:
            name = graph.layer_attrs(n).name
            keyed.append(((name is None, name or "", seen[name]), n))
            seen[name] += 1
    return [n for _, n in sorted(keyed, key=lambda kn: kn[0])]


def dropout_masks(graph, rng: torch.Generator, device) -> Dict[Node, torch.Tensor]:
    """Every Dropout's keep mask for one step at the op's global shape,
    drawn from `rng` in `dropout_order`: the same masks for the same
    generator state whatever the plan, so each rank of a plan keeps its
    piece of the masks the single-device trainer draws."""
    out = {}
    for n in dropout_order(graph):
        (o,) = graph.outputs_of(n)
        shape = graph.tensor_shape(o)
        if isinstance(shape, ParallelTensorShape):
            shape = get_reduced_shape(shape)
        out[n] = dropout_keep_mask(shape.dims, graph.op_attrs(n).rate, rng, device)
    return out


def forward_interpreter(
    cg: ComputationGraph,
    params: Dict[ParamKey, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    train: bool = False,
    rng: Optional[torch.Generator] = None,
    masks: Optional[Dict[Node, torch.Tensor]] = None,
) -> Dict[DataflowOutput, torch.Tensor]:
    """Evaluate the graph: every tensor value keyed by DataflowOutput.
    inputs: keyed by input-layer name (or param_key of the input node).
    train and rng reach the stochastic ops (Dropout): the step's masks are
    drawn from rng first, in dropout_order, unless `masks` gives them."""
    if masks is None:
        masks = dropout_masks(cg, rng, rng.device) if train and rng is not None else {}
    env: Dict[DataflowOutput, torch.Tensor] = {}
    for n in cg.topological_ordering():
        la = cg.layer_attrs(n)
        outs = cg.outputs_of(n)
        if isinstance(la.attrs, InputAttrs):
            env[outs[0]] = input_binding(cg, n, inputs)
        elif isinstance(la.attrs, WeightAttrs):
            env[outs[0]] = params[param_key(n)]
        else:
            slot_vals = [env[v] for v in cg.inputs_of(n)]
            data_vals, weight_vals = split_slot_values(la.attrs, slot_vals)
            if n in masks:
                results = [apply_dropout_mask(data_vals[0], masks[n], la.attrs.rate)]
            else:
                results = kernel_forward(la.attrs, data_vals, weight_vals, train=train, rng=rng)
            for o, r in zip(outs, results):
                env[o] = r
    return env


def fused_multi_step(instance, params, opt_state, batch_stack, label_stack, rng):
    """K training steps over a stacked window: batch_stack maps each input
    name to a [k, ...] tensor, label_stack is [k, ...]. Step i trains on
    row i through instance.train_step, drawing Dropout from `rng`, so K
    steps here end bitwise where K train_step calls on the same batches and
    generator end. Updates params and opt_state in place.

    Returns (params, opt_state, rng, losses [k], mvals): mvals are the
    window's metric values left-folded in step order, the f32 and int
    device adds of the per-step loop. The JAX package's version also
    returns the window's run-health stat stacks; they belong to the health
    monitor, which is not ported (A9)."""
    k = next(iter(batch_stack.values())).shape[0]
    losses = []
    mvals = None
    for i in range(k):
        batch = {name: t[i] for name, t in batch_stack.items()}
        label = None if label_stack is None else label_stack[i]
        params, opt_state, loss, step_mvals = instance.train_step(
            params, opt_state, batch, label, rng)
        losses.append(loss)
        mvals = step_mvals if mvals is None else {
            key: mvals[key] + v for key, v in step_mvals.items()}
    return params, opt_state, rng, torch.stack(losses), mvals


def _state_tensors(params, opt_state) -> List[torch.Tensor]:
    """Every tensor a step writes in place: the parameters, the optimizer's
    slots and its step count."""
    out = list(params.values())
    for key in sorted(opt_state):
        v = opt_state[key]
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


class ModelTrainingInstance:
    """Graph + loss + optimizer + metrics -> a train step on one device."""

    def __init__(
        self,
        cg: ComputationGraph,
        logit_tensor: DataflowOutput,
        loss_attrs: LossAttrs,
        optimizer_attrs: OptimizerAttrs,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        metrics: FrozenSet[str] = frozenset(),
        aux_loss_tensors: Sequence[DataflowOutput] = (),
    ) -> None:
        """compute_dtype: params and optimizer state stay f32, and the
        forward/backward run in this dtype (None = the params' dtype).
        device: CUDA unless given; see resolve_device. metrics: the names
        compute_metrics evaluates on each step's logits. aux_loss_tensors:
        graph outputs whose sums join the loss."""
        self.cg = cg
        self.logit_tensor = logit_tensor
        self.loss_attrs = loss_attrs
        self.optimizer_attrs = optimizer_attrs
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.metrics = frozenset(metrics)
        self.aux_loss_tensors = tuple(aux_loss_tensors)
        # the fused windows' CUDA graphs, one per window length and state
        self.graphs = CapturedGraphs(self.device)
        # the last multi_train_step's window: its steps, and whether it ran
        # as a captured graph
        self.last_window: Optional[Dict[str, object]] = None

    def initialize(self, seed: int = 0):
        params = init_params(self.cg, seed, self.device)
        return params, make_optimizer_state(self.optimizer_attrs, params)

    def _to_device(self, batch_inputs) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch_inputs.items()}

    def loss_fn(self, params, batch_inputs, label, rng=None):
        """(f32 loss, logits) of a training forward; rng feeds Dropout."""
        env = forward_interpreter(
            self.cg,
            cast_for_compute(params, self.compute_dtype),
            cast_for_compute(self._to_device(batch_inputs), self.compute_dtype),
            train=True,
            rng=rng,
            masks=self._dropout_masks(rng),
        )
        logit = env[self.logit_tensor]
        loss = loss_forward(self.loss_attrs, logit, torch.as_tensor(label, device=self.device))
        for t in self.aux_loss_tensors:
            loss = loss + env[t].to(loss.dtype).sum()
        return loss, logit

    def _dropout_masks(self, rng):
        """The step's Dropout masks as loss_fn applies them, or None for
        forward_interpreter to draw them (here: the graph's own)."""
        return None

    def _feed(self, batch_inputs, label):
        """(inputs, label) as loss_fn takes them: here the batch as given and
        the label on the device; the parallel trainers keep their rank's
        piece of each."""
        return batch_inputs, torch.as_tensor(label, device=self.device)

    def _metric_values(self, logit, label):
        """compute_metrics of this rank's logits; the parallel trainers
        take the class-sharded ones across their ranks."""
        return compute_metrics(self.metrics, logit, label)

    def _gradient_reducer(self, leaves):
        """What sums the gradients over ranks as the backward produces them
        (the parallel trainers' collectives.BucketedBackward), or None."""
        return None

    def _step_scalars(self, loss, grads, mvals):
        """(the step's loss, its metric values) from this rank's, once its
        gradients are final: here as they are."""
        return loss, mvals

    def loss_and_grads(self, params, batch_inputs, label, rng=None, metrics=None):
        """(loss, {key: f32 gradient}) at `params`, which are not modified.
        metrics: a dict that receives compute_metrics of the logits, taken
        between the forward and the backward. Over ranks, `_feed`,
        `_gradient_reducer` and `_step_scalars` say what each rank takes
        and what is summed."""
        batch_inputs, label = self._feed(batch_inputs, label)
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss, logit = self.loss_fn(leaves, batch_inputs, label, rng)
        mvals = {}
        if metrics is not None:
            mvals = self._metric_values(logit.detach(), label)
        del logit
        reducer = self._gradient_reducer(leaves)
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        if reducer is None:
            grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                     for k, g in zip(leaves, grads)}
        else:
            summed = reducer.finish()
            grads = {k: summed[k] for k in leaves}
        loss, mvals = self._step_scalars(loss.detach(), grads, mvals)
        if metrics is not None:
            metrics.update(mvals)
        return loss, grads

    def train_step(self, params, opt_state, batch_inputs, label, rng=None):
        """One forward, backward and update. Updates params and opt_state in
        place and returns (params, opt_state, loss, metrics): the metric
        values of this step's logits, on the device. Without an rng,
        Dropout draws from a generator seeded 0, as the JAX package's
        default key."""
        if rng is None:
            rng = torch.Generator(device=self.device).manual_seed(0)
        mvals: Dict = {}
        loss, grads = self.loss_and_grads(params, batch_inputs, label, rng=rng, metrics=mvals)
        apply_optimizer_(self.optimizer_attrs, params, grads, opt_state)
        return params, opt_state, loss, mvals

    def multi_train_step(self, params, opt_state, batch_stack, label_stack, rng):
        """K fused steps in one dispatch (fused_multi_step's contract): on a
        CUDA device whose collectives a graph can hold (`_capturable`; the
        others run the K steps eagerly in one call) the replay of one CUDA
        graph of the K steps, captured at
        the first window of each length over these parameter and state
        tensors and this generator, which it registers, so each replay
        draws the Dropout masks K train_step calls would. Whoever changes
        what a graph baked in (the optimizer's hyperparameters, a tensor
        replaced rather than written in place) calls graphs.invalidate().
        The losses and metric values returned are the caller's own."""
        if rng is None:
            raise ValueError("multi_train_step needs the generator the steps draw from")
        k = next(iter(batch_stack.values())).shape[0]
        captured = self.device.type == "cuda" and self._capturable()
        self.last_window = {"steps": k, "captured": captured}
        if self.device.type == "cuda" and not captured:
            # collectives no graph can hold: the K steps in one call, eagerly
            return fused_multi_step(self, params, opt_state, batch_stack, label_stack, rng)
        inputs = {f"input:{name}": t for name, t in batch_stack.items()}
        if label_stack is not None:
            inputs["label"] = label_stack
        names = list(batch_stack)
        state = _state_tensors(params, opt_state)

        def body(window):
            return fused_multi_step(self, params, opt_state,
                                    {name: window[f"input:{name}"] for name in names},
                                    window.get("label"), rng)

        key = (shape_key(inputs), layout_key(state), id(rng))
        out = self.graphs.run(key, body, inputs, state=state, generators=(rng,))
        losses, mvals = out[3], out[4]
        return params, opt_state, rng, losses.clone(), {
            name: v.clone() if isinstance(v, torch.Tensor) else v for name, v in mvals.items()}

    def _capturable(self) -> bool:
        """Whether a window of this trainer's steps can be one CUDA graph:
        on one device, always; the parallel trainers say where their
        collectives allow it."""
        return True

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """Logits at `params`, in the params' dtype (as the JAX package's
        forward, which applies no compute_dtype), Dropout off."""
        env = forward_interpreter(self.cg, params, self._to_device(batch_inputs))
        return env[self.logit_tensor]


PerLayerElapsedTime = Dict[Node, float]


class LocalTrainingBacking:
    """Stepped per-op execution with per-layer timing (the reference's
    execute_init/forward/backward/update). See the module docstring for how
    the backward reuses each op's forward graph.

    compute_dtype: as ModelTrainingInstance's. The JAX package's stepped
    path runs at the parameters' dtype; the port's runs at the compiled
    compute dtype (the same thing in f32), so that a bf16 model's stepped
    attention reaches the flash kernels. Weight gradients stay in the
    parameters' dtype."""

    def __init__(self, cg: ComputationGraph, profiling: bool = False,
                 compute_dtype: Optional[torch.dtype] = None, device=None) -> None:
        self.cg = cg
        self.profiling = profiling
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)
        self.params: Dict[ParamKey, torch.Tensor] = {}
        self.env: Dict[DataflowOutput, torch.Tensor] = {}
        self.grad_env: Dict[DataflowOutput, torch.Tensor] = {}
        self.param_grads: Dict[ParamKey, torch.Tensor] = {}
        self.fwd_elapsed: PerLayerElapsedTime = {}
        self.bwd_elapsed: PerLayerElapsedTime = {}
        # per op node: (a leaf per distinct input value, the op's outputs)
        self._graphs: Dict[Node, Tuple[Dict[DataflowOutput, torch.Tensor],
                                       List[torch.Tensor]]] = {}

    def execute_init(self, seed: int = 0) -> None:
        self.params = init_params(self.cg, seed, self.device)

    def _timed(self, node: Node, table: PerLayerElapsedTime, fn):
        """fn(), and with profiling its ms into table[node]: by CUDA events
        on the card, by the host clock on the CPU."""
        if not self.profiling:
            return fn()
        if self.device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            end.synchronize()
            table[node] = start.elapsed_time(end)
            return out
        t0 = time.perf_counter()
        out = fn()
        table[node] = (time.perf_counter() - t0) * 1e3
        return out

    def _compute_dtype(self, t: torch.Tensor) -> torch.dtype:
        return self.compute_dtype if t.is_floating_point() and self.compute_dtype else t.dtype

    def execute_forward(self, inputs: Dict[str, torch.Tensor]) -> None:
        """Every op on detached leaves of its inputs, with autograd on. A
        weight's value is a copy at the compute dtype, so an update before
        the backward does not change what the backward differentiates (the
        JAX package's arrays are immutable)."""
        self.env, self._graphs = {}, {}
        for n in self.cg.topological_ordering():
            la = self.cg.layer_attrs(n)
            outs = self.cg.outputs_of(n)
            if isinstance(la.attrs, InputAttrs):
                x = torch.as_tensor(input_binding(self.cg, n, inputs), device=self.device)
                self.env[outs[0]] = x.to(self._compute_dtype(x))
            elif isinstance(la.attrs, WeightAttrs):
                p = self.params[param_key(n)].detach()
                self.env[outs[0]] = p.to(self._compute_dtype(p), copy=True)
            else:
                # one leaf per distinct input value (self-attention's q, k
                # and v are one tensor, as in the whole-graph step)
                leaves = {v: self.env[v].detach().requires_grad_(self.env[v].is_floating_point())
                          for v in dict.fromkeys(self.cg.inputs_of(n))}
                data, weights = split_slot_values(
                    la.attrs, [leaves[v] for v in self.cg.inputs_of(n)])

                def run(a=la.attrs, data=data, weights=weights):
                    with torch.enable_grad():
                        return kernel_forward(a, data, weights)

                results = self._timed(n, self.fwd_elapsed, run)
                self._graphs[n] = (leaves, results)
                for o, r in zip(outs, results):
                    self.env[o] = r

    def execute_backward(self, output_grads: Dict[DataflowOutput, torch.Tensor]) -> None:
        """Reverse-topological per-op gradients from each op's forward graph.
        Weight gradients accumulate across calls until zeroed (the
        reference's zero_gradients semantics); the activation gradients are
        per call. The graphs are kept, so backward may run again on the same
        forward, as the JAX package's recomputing backward may."""
        self.grad_env = dict(output_grads)
        for n in reversed(self.cg.topological_ordering()):
            attrs = self.cg.op_attrs(n)
            if isinstance(attrs, InputAttrs):
                continue
            outs = self.cg.outputs_of(n)
            if isinstance(attrs, WeightAttrs):
                if outs[0] in self.grad_env:
                    k = param_key(n)
                    g = self.grad_env[outs[0]].to(self.params[k].dtype)
                    self.param_grads[k] = self.param_grads[k] + g if k in self.param_grads else g
                continue
            leaves, results = self._graphs[n]
            wanted = [v for v, leaf in leaves.items() if leaf.requires_grad]
            out_grads = [self.grad_env.get(o, torch.zeros_like(r)) for o, r in zip(outs, results)]

            def run(leaves=leaves, results=results, wanted=wanted, out_grads=out_grads):
                return torch.autograd.grad(results, [leaves[v] for v in wanted], out_grads,
                                           retain_graph=True, allow_unused=True)

            in_grads = self._timed(n, self.bwd_elapsed, run)
            for v, g in zip(wanted, in_grads):
                if g is not None:
                    self.grad_env[v] = self.grad_env[v] + g if v in self.grad_env else g

    @torch.no_grad()
    def execute_update(self, optimizer_attrs: OptimizerAttrs, opt_state=None):
        """The optimizer step on the accumulated gradients (zero where a
        parameter has none), in place on the parameters and the state,
        which it returns."""
        if opt_state is None:
            opt_state = make_optimizer_state(optimizer_attrs, self.params)
        grads = {k: self.param_grads.get(k, torch.zeros_like(v)) for k, v in self.params.items()}
        apply_optimizer_(optimizer_attrs, self.params, grads, opt_state)
        return opt_state
