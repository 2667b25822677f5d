"""Training over a searched PCG on a mesh of ranks (port of
flexflow_tpu/parallel/executor.py: _pre_reshard_value,
pcg_forward_interpreter and DistributedTrainingInstance).

The JAX package traces one global-view program: values are global arrays,
the four parallel ops are identities under sharding constraints, and GSPMD
partitions the ops and inserts every collective. Here each rank is one
process on one device and holds its own piece of every tensor, sharded as
parallel/sharding.py says (the JAX package's axis assignment), and the
interpreter makes the pieces and their gradients add up to what GSPMD
computes:

- the parallel ops are collectives (parallel/collectives.py): Repartition
  narrows, Combine all-gathers, Replicate is the identity, Reduction
  all-reduces the partial sums;
- a compute op runs on the rank's pieces. Where an operand's axes differ
  from what the op's output needs (the JAX package's assignment places
  each tensor on its own, and GSPMD moves data where they disagree), the
  operand is resharded first; where ranks do different work on one operand
  piece (the copies of a Replicate, a weight used on different rows), its
  gradient is summed over those axes (`sum_grad`). A weight's sum is
  deferred to one bucket per set of axes after the backward;
- attention runs the rank's local heads (the weight piece's head count)
  through the per-head [b, h, s, d] kernels, as the JAX package's
  _try_sharded_flash_mha does, and RingAttention rotates key/value blocks
  over the axes of its sequence dim;
- a bias on a partial sum (a contraction-sharded Linear, a head-parallel
  attention's output bias) is added on the ranks at sum index 0 only;
- BatchNorm takes its statistics over the axes of its batch dims;
- the loss consumes the logits before any trailing Combine or Repartition
  of a non-class dim (`_pre_reshard_value`), so no rank gathers the whole
  batch's logits: each rank's loss is the mean over its block scaled by the
  block's share of the global tokens, so that its gradient is the full one;
  the reported loss and the metrics count each distinct block once.

Every rank then applies the optimizer to its own pieces, so the ranks that
hold one piece stay bitwise equal. The fused step window of this trainer
raises (A7 item 9).
"""

from __future__ import annotations

import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.kernels import forward as kernel_forward
from flexflow_tpu_torch.kernels import loss_forward, make_optimizer_state
from flexflow_tpu_torch.kernels.flash_attention import (
    sharded_flash_attention,
    sharded_flash_supported,
)
from flexflow_tpu_torch.kernels.metrics import compute_metrics
from flexflow_tpu_torch.kernels.ops import _dense_context, batch_stats_group, mha_project_qkv
from flexflow_tpu_torch.kernels.precision import cast_for_compute
from flexflow_tpu_torch.kernels.ring_attention import ring_mha_forward
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    ParamKey,
    init_params,
    param_key,
    slot_roles,
)
from flexflow_tpu_torch.op_attrs.core import IncomingTensorRole, is_parallel_op
from flexflow_tpu_torch.op_attrs.ops import (
    BatchNormAttrs,
    CombineAttrs,
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
    LossAttrs,
    MultiHeadAttentionAttrs,
    Pool2DAttrs,
    RepartitionAttrs,
    ReshapeAttrs,
    RingAttentionAttrs,
    SoftmaxAttrs,
    SplitAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.parallel import collectives as C
from flexflow_tpu_torch.parallel.data_parallel import _rank_device
from flexflow_tpu_torch.parallel.mesh import Axes, MachineMesh
from flexflow_tpu_torch.parallel.sharding import (
    TensorSharding,
    local_block,
    pcg_shardings,
)
from flexflow_tpu_torch.pcg.machine_view import MachineView
from flexflow_tpu_torch.pcg.optimizer import OptimizerAttrs
from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node

# unary ops linear in their input: they may act on partial sums
_LINEAR_UNARY = frozenset({ElementUnaryOpType.IDENTITY, ElementUnaryOpType.SCALAR_MULTIPLY,
                           ElementUnaryOpType.SCALAR_TRUE_DIV})


def _pre_reshard_value(pcg: ParallelComputationGraph, t: DataflowOutput) -> DataflowOutput:
    """Walk back through Combines and Repartitions (layout moves only); stop
    at any other op, and at a reshard of the last (class) dim."""
    while True:
        attrs = pcg.op_attrs(t.node)
        if isinstance(attrs, CombineAttrs):
            dim = attrs.combine_dim
        elif isinstance(attrs, RepartitionAttrs):
            dim = attrs.repartition_dim
        else:
            return t
        (src,) = pcg.inputs_of(t.node)
        rank = pcg.tensor_shape(src).num_dims
        if dim % rank == rank - 1:
            return t
        t = src


def _like(v, total: torch.Tensor):
    """A metric summed in f32 back in the type compute_metrics gave it:
    counts are exact below 2**24."""
    if isinstance(v, int):
        return int(round(float(total)))
    if not v.is_floating_point():
        return total.round().to(v.dtype)
    return total


def _block_axes(s: TensorSharding) -> frozenset:
    """The axes along which ranks hold different blocks of a tensor's
    value (its partial sums summed)."""
    return frozenset(a for axes in s.dims for a in axes)


def _whole(rank: int) -> Tuple[Axes, ...]:
    return ((),) * rank


def _refuse(n: Node, attrs, why: str) -> NotImplementedError:
    return NotImplementedError(
        f"node {n.idx} ({type(attrs).__name__[:-len('Attrs')]}): {why} (A7 item 3)")


@dataclasses.dataclass
class _NodePlan:
    """How one compute node runs on this rank's pieces."""

    need: List[TensorSharding]  # per input slot, the sharding the op needs
    sum_grad: Dict[int, Axes]  # slot -> axes its gradient is summed over here
    bias_axes: Axes = ()  # a bias on a partial sum: added at index 0 of these
    stats_axes: Axes = ()  # BatchNorm: the axes of its batch dims
    ring_axes: Axes = ()  # RingAttention: the axes of its sequence dim


def _requirements(pcg, n, attrs, shardings, mesh):
    """(what each input slot must be sharded as, bias axes, BatchNorm batch
    axes, ring axes) for compute node n to produce its outputs' shardings
    from the rank's pieces alone."""
    ins, outs = pcg.inputs_of(n), pcg.outputs_of(n)
    o = shardings[outs[0]]
    roles = slot_roles(attrs, len(ins))
    data = [i for i, r in enumerate(roles) if r == IncomingTensorRole.INPUT]
    weights = [i for i, r in enumerate(roles) if r == IncomingTensorRole.WEIGHT]
    need: List[Optional[TensorSharding]] = [None] * len(ins)
    bias_axes = stats_axes = ring_axes = ()

    def like_out(i, total=()):
        need[i] = TensorSharding(o.dims, total)

    def whole_at(dims):
        for d in dims:
            if o.dims[d]:
                raise _refuse(n, attrs, f"its output's dim {d} is sharded")

    if isinstance(attrs, LinearAttrs):
        if o.sum and attrs.activation is not None:
            raise _refuse(n, attrs, "an activation on a partial sum")
        need[data[0]] = TensorSharding(o.dims[:-1] + (o.sum,))
        need[weights[0]] = TensorSharding((o.sum, o.dims[-1]))
        if attrs.use_bias:
            need[weights[1]] = TensorSharding((o.dims[-1],))
            bias_axes = o.sum
    elif isinstance(attrs, MultiHeadAttentionAttrs):
        ring = isinstance(attrs, RingAttentionAttrs)
        whole_at([2] if ring else [1, 2])
        for i in data:
            need[i] = TensorSharding((o.dims[0], o.dims[1], ()))
        need[weights[0]] = TensorSharding(((), o.sum))
        for i in weights[1:]:
            need[i] = TensorSharding(((),))
        bias_axes = o.sum if attrs.bias else ()
        ring_axes = o.dims[1] if ring else ()
    elif isinstance(attrs, EmbeddingAttrs):
        if o.sum:
            raise _refuse(n, attrs, "a partial-sum output")
        need[data[0]] = TensorSharding(o.dims[:-1])
        need[weights[0]] = TensorSharding(((), o.dims[-1]))
    elif isinstance(attrs, Conv2DAttrs):
        whole_at([2, 3])
        if o.sum and attrs.groups != 1:
            raise _refuse(n, attrs, "a channel-sharded grouped convolution")
        need[data[0]] = TensorSharding((o.dims[0], o.sum, (), ()))
        need[weights[0]] = TensorSharding((o.dims[1], o.sum, (), ()))
        if attrs.use_bias:
            need[weights[1]] = TensorSharding((o.dims[1],))
            bias_axes = o.sum
    elif isinstance(attrs, Pool2DAttrs):
        whole_at([2, 3])
        like_out(data[0])
    elif isinstance(attrs, FlatAttrs):
        whole_at([1])
        rank = pcg.tensor_shape(ins[0]).num_dims
        need[data[0]] = TensorSharding((o.dims[0],) + _whole(rank - 1))
    elif isinstance(attrs, ReshapeAttrs):
        src = pcg.tensor_shape(ins[0])
        whole_at(range(1, len(o.dims)))
        if o.dims[0] and src.sizes()[0] != pcg.tensor_shape(outs[0]).sizes()[0]:
            raise _refuse(n, attrs, "a reshape of the sharded batch dim")
        need[data[0]] = TensorSharding((o.dims[0],) + _whole(src.num_dims - 1))
    elif isinstance(attrs, BatchNormAttrs):
        like_out(data[0])
        for i in weights:
            need[i] = TensorSharding((o.dims[1],))
        stats_axes = C.mesh_order(mesh, [a for d, axes in enumerate(o.dims) if d != 1
                                         for a in axes])
    elif isinstance(attrs, LayerNormAttrs):
        axes = [a % len(o.dims) for a in attrs.axes]
        whole_at(axes)
        like_out(data[0])
        for i in weights:
            need[i] = TensorSharding(tuple(o.dims[a] for a in axes))
    elif isinstance(attrs, SoftmaxAttrs):
        whole_at([attrs.dim % len(o.dims)])
        like_out(data[0])
    elif isinstance(attrs, (ElementUnaryAttrs, DropoutAttrs)):
        if isinstance(attrs, DropoutAttrs) and attrs.rate > 0:
            raise _refuse(n, attrs, "dropout masks drawn per piece are not ported")
        if o.sum and not (isinstance(attrs, ElementUnaryAttrs) and attrs.op_type in _LINEAR_UNARY):
            raise _refuse(n, attrs, "a nonlinear op on a partial sum")
        like_out(data[0], o.sum)
    elif isinstance(attrs, ElementBinaryAttrs):
        if o.sum and attrs.op_type not in (ElementBinaryOpType.ADD, ElementBinaryOpType.SUB):
            raise _refuse(n, attrs, "a nonlinear op on partial sums")
        for i in data:
            like_out(i, o.sum)
    elif isinstance(attrs, (ConcatAttrs, SplitAttrs)):
        whole_at([attrs.axis % len(o.dims)])
        for i in data:
            like_out(i)
    else:
        # an op without a rule runs only where nothing around it is sharded
        if any(shardings[t].placed() for t in list(ins) + list(outs)):
            raise _refuse(n, attrs, "no rule places this op's pieces")
        for i, t in enumerate(ins):
            need[i] = shardings[t]
    for i in range(len(ins)):
        if need[i] is None:
            raise _refuse(n, attrs, f"input slot {i} has no placement rule")
    return need, bias_axes, stats_axes, ring_axes


def _same(a: TensorSharding, b: TensorSharding) -> bool:
    return a.dims == b.dims and set(a.sum) == set(b.sum)


class DistributedPlan:
    """The static lowering of a PCG on a mesh: the shardings, each compute
    node's plan, which values are a weight's piece as it rests, and the axes
    each weight's gradient is summed over after the backward."""

    def __init__(self, pcg: ParallelComputationGraph, mesh: MachineMesh,
                 mapping: Optional[Dict[Node, MachineView]] = None) -> None:
        self.pcg, self.mesh = pcg, mesh
        self.shardings = pcg_shardings(pcg, mesh, mapping)
        S = self.shardings
        self.nodes: Dict[Node, _NodePlan] = {}
        # value -> the param whose piece it is unchanged (through identities)
        alias: Dict[DataflowOutput, ParamKey] = {}
        uses: Dict[ParamKey, List[Tuple[Node, int, Axes]]] = {}
        for n in pcg.topological_ordering():
            attrs = pcg.op_attrs(n)
            outs = pcg.outputs_of(n)
            if isinstance(attrs, WeightAttrs):
                alias[outs[0]] = param_key(n)
                uses[param_key(n)] = []
                continue
            if isinstance(attrs, InputAttrs):
                continue
            ins = pcg.inputs_of(n)
            if is_parallel_op(attrs):
                if ins[0] in alias and _same(S[ins[0]], S[outs[0]]):
                    alias[outs[0]] = alias[ins[0]]
                continue
            need, bias_axes, stats_axes, ring_axes = _requirements(pcg, n, attrs, S, mesh)
            work = C.placed_axes(need) | C.placed_axes([S[o] for o in outs])
            sum_grad = {}
            for i, t in enumerate(ins):
                axes = C.mesh_order(mesh, work - need[i].placed())
                if t in alias and _same(S[t], need[i]):
                    # deferred to the weight's bucket
                    uses[alias[t]].append((n, i, axes))
                elif axes:
                    sum_grad[i] = axes
            self.nodes[n] = _NodePlan(need, sum_grad, bias_axes, stats_axes, ring_axes)
        # a weight whose uses agree on their axes sums once, in its bucket;
        # otherwise each use sums its own share where the op runs
        self.grad_axes: Dict[ParamKey, Axes] = {}
        for key, us in uses.items():
            kinds = {axes for _, _, axes in us}
            if len(kinds) <= 1:
                self.grad_axes[key] = next(iter(kinds), ())
            else:
                self.grad_axes[key] = ()
                for n, i, axes in us:
                    if axes:
                        self.nodes[n].sum_grad[i] = axes

    def step_collectives(self, target: DataflowOutput) -> "Counter":
        """The collectives one loss_and_grads issues where the loss takes
        `target`, by kind, read off the plan: each parallel op's and each
        operand's reshard (forward, and backward where the value depends on
        a weight), each gradient sum at an operand, BatchNorm's statistics,
        and one bucket per set of weight-gradient axes, the loss's and the
        metrics' joining the bucket over every axis where blocks differ."""
        pcg, mesh, S = self.pcg, self.mesh, self.shardings
        needed = _ancestors(pcg, [target])
        grad = set()
        out = Counter()
        for n in pcg.topological_ordering():
            if n not in needed:
                continue
            attrs = pcg.op_attrs(n)
            ins, outs = pcg.inputs_of(n), pcg.outputs_of(n)
            if isinstance(attrs, WeightAttrs) or any(t in grad for t in ins):
                grad.update(outs)
            if is_parallel_op(attrs):
                out.update(C.reshard_collectives(S[ins[0]], S[outs[0]], mesh, ins[0] in grad))
            elif n in self.nodes:
                p = self.nodes[n]
                seen = set()
                for i, t in enumerate(ins):
                    key = (t, p.need[i], p.sum_grad.get(i))
                    if key in seen:
                        continue
                    seen.add(key)
                    if not _same(S[t], p.need[i]):
                        out.update(C.reshard_collectives(S[t], p.need[i], mesh, t in grad))
                    if i in p.sum_grad and t in grad:
                        out["all_reduce"] += 1
                if isinstance(attrs, BatchNormAttrs) and mesh.size(p.stats_axes) > 1:
                    out["all_reduce"] += 2 * (2 if ins[0] in grad else 1)
        if S[target].sum and mesh.size(S[target].sum) > 1:
            out["all_reduce"] += 1  # the loss sums pending partials of its logits
        sets = {a for a in self.grad_axes.values() if mesh.size(a) > 1}
        if _block_axes(S[target]):
            sets.add(mesh.names)
        out["all_reduce"] += len(sets)
        return +out

    def axis_sets(self):
        """Every set of axes a collective of this plan runs over."""
        sets = set(self.grad_axes.values())
        for s in self.shardings.values():
            sets.update(a for a in s.dims if a)
            if s.sum:
                sets.add(s.sum)
        for p in self.nodes.values():
            sets.update(p.sum_grad.values())
            sets.update(a for a in (p.stats_axes, p.ring_axes) if a)
            for s in p.need:
                sets.update(a for a in s.dims if a)
        sets.add(self.mesh.names)
        return sets


def _ancestors(pcg: ParallelComputationGraph, targets) -> set:
    """The nodes the target tensors depend on, themselves included."""
    seen, stack = set(), [t.node for t in targets]
    while stack:
        n = stack.pop()
        if n not in seen:
            seen.add(n)
            stack.extend(v.node for v in pcg.inputs_of(n))
    return seen


def pcg_forward_interpreter(
    plan: DistributedPlan,
    params: Dict[ParamKey, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    targets: Optional[List[DataflowOutput]] = None,
) -> Dict[DataflowOutput, torch.Tensor]:
    """Evaluate the PCG on this rank's pieces: every tensor's piece keyed by
    DataflowOutput (only what `targets` depend on, where given). inputs:
    this rank's pieces, keyed by input-layer name (or param_key of the
    input node)."""
    pcg, mesh, S = plan.pcg, plan.mesh, plan.shardings
    needed = _ancestors(pcg, targets) if targets is not None else None
    env: Dict[DataflowOutput, torch.Tensor] = {}
    for n in pcg.topological_ordering():
        if needed is not None and n not in needed:
            continue
        la = pcg.layer_attrs(n)
        attrs = la.attrs
        outs = pcg.outputs_of(n)
        if isinstance(attrs, InputAttrs):
            key = la.name if la.name is not None and la.name in inputs else param_key(n)
            if key not in inputs:
                raise KeyError(f"missing input binding for {la.name or key}")
            env[outs[0]] = inputs[key]
            continue
        if isinstance(attrs, WeightAttrs):
            env[outs[0]] = params[param_key(n)]
            continue
        ins = pcg.inputs_of(n)
        if is_parallel_op(attrs):
            env[outs[0]] = C.reshard(env[ins[0]], S[ins[0]], S[outs[0]], mesh)
            continue
        p = plan.nodes[n]
        slots: Dict[tuple, torch.Tensor] = {}
        vals = []
        for i, t in enumerate(ins):
            # one piece per distinct value (self-attention's q, k, v)
            key = (t, p.need[i], p.sum_grad.get(i))
            if key not in slots:
                v = env[t]
                if not _same(S[t], p.need[i]):
                    v = C.reshard(v, S[t], p.need[i], mesh)
                if i in p.sum_grad:
                    v = C.sum_grad(v, mesh, p.sum_grad[i])
                slots[key] = v
            vals.append(slots[key])
        results = _run(attrs, vals, p, mesh)
        for o, r in zip(outs, results):
            env[o] = r
    return env


def _run(attrs, vals, p: _NodePlan, mesh: MachineMesh) -> List[torch.Tensor]:
    roles = slot_roles(attrs, len(vals))
    data = [v for v, r in zip(vals, roles) if r == IncomingTensorRole.INPUT]
    weights = [v for v, r in zip(vals, roles) if r == IncomingTensorRole.WEIGHT]
    bias_on = C.sum_group_zero(mesh, p.bias_axes)
    if isinstance(attrs, MultiHeadAttentionAttrs):
        return [_attention(attrs, data, weights, mesh, p.ring_axes, bias_on)]
    if p.bias_axes and not bias_on:
        # the bias of a partial sum joins it once: at sum index 0
        weights = weights[:1]
        attrs = dataclasses.replace(attrs, use_bias=False)
    if isinstance(attrs, BatchNormAttrs) and p.stats_axes:
        group = mesh.group_of(p.stats_axes)[0]
        with batch_stats_group(lambda t: C.all_reduce_sum(t, group, mesh.counts)):
            return kernel_forward(attrs, data, weights)
    return kernel_forward(attrs, data, weights)


def _attention(attrs: MultiHeadAttentionAttrs, data, weights, mesh: MachineMesh,
               ring_axes: Axes, bias_on: bool) -> torch.Tensor:
    """Attention of the rank's local heads (the weight piece's count): the
    per-head [b, h, s, d] kernels where they take the block, else the dense
    path; RingAttention rotates over the ring of its sequence axes."""
    q, k, v = data
    w = weights[0]
    heads = w.shape[1]
    if heads != attrs.num_heads:
        attrs = dataclasses.replace(attrs, num_heads=heads, kdim=attrs.q_proj_size,
                                    vdim=attrs.v_proj_size)
    input_bias = weights[1] if attrs.bias else None
    if isinstance(attrs, RingAttentionAttrs):
        out = ring_mha_forward(attrs, q, k, v, w, mesh.ring(ring_axes), input_bias=input_bias,
                               output_bias=torch.zeros_like(weights[2]) if attrs.bias else None)
    else:
        qp, kp, vp, wo = mha_project_qkv(attrs, q, k, v, w, input_bias)
        if sharded_flash_supported(qp.shape, kp.shape, vp.shape, qp.dtype, qp.device):
            ctx = sharded_flash_attention(qp, kp, vp)
        else:
            ctx = _dense_context(qp, kp, vp)
        out = torch.einsum("bhsv,veh->bse", ctx, wo)
    if attrs.bias and bias_on:
        out = out + weights[2]
    return out


class DistributedTrainingInstance(ModelTrainingInstance):
    """PCG + loss + optimizer on a mesh of ranks: each rank trains its
    pieces. `mapping`: the searched machine views, which choose the axes
    (as the JAX package's)."""

    def __init__(
        self,
        pcg: ParallelComputationGraph,
        logit_tensor: DataflowOutput,
        loss_attrs: LossAttrs,
        optimizer_attrs: OptimizerAttrs,
        machine_mesh: MachineMesh,
        mapping: Optional[Dict[Node, MachineView]] = None,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        metrics=frozenset(),
    ) -> None:
        """device: cuda:<local rank> unless given; see resolve_device."""
        import torch.distributed as dist

        self.pcg = pcg
        self.machine_mesh = machine_mesh
        self.mapping = dict(mapping) if mapping else None
        self.plan = DistributedPlan(pcg, machine_mesh, mapping)
        self.shardings = self.plan.shardings
        machine_mesh.open_groups(self.plan.axis_sets())
        self.loss_logit_tensor = _pre_reshard_value(pcg, logit_tensor)
        if self.shardings[self.loss_logit_tensor].dims[-1]:
            raise NotImplementedError(
                f"the loss takes logits sharded over their classes "
                f"({self.shardings[self.loss_logit_tensor]}); a class-sharded loss is not "
                "ported (A7 item 3)")
        self._inputs = {}
        for n in pcg.topological_ordering():
            la = pcg.layer_attrs(n)
            if isinstance(la.attrs, InputAttrs):
                self._inputs[la.name or param_key(n)] = pcg.outputs_of(n)[0]
        super().__init__(pcg, logit_tensor, loss_attrs, optimizer_attrs,
                         compute_dtype=compute_dtype, device=_rank_device(device, dist.get_rank()),
                         metrics=metrics)

    @property
    def collectives(self):
        """The collectives issued over the mesh so far, by kind."""
        return self.machine_mesh.counts

    @property
    def all_reduces(self) -> int:
        return self.machine_mesh.counts["all_reduce"]

    def step_collectives(self) -> Counter:
        """The collectives a train step issues, by kind, as the plan implies
        them (DistributedPlan.step_collectives)."""
        return self.plan.step_collectives(self.loss_logit_tensor)

    def weight_sharding(self, key: ParamKey) -> TensorSharding:
        (out,) = self.pcg.outputs_of(Node(int(key[1:])))
        return self.shardings[out]

    def initialize(self, seed: int = 0):
        """Parameters and optimizer state of this rank's pieces: every rank
        draws the global values from `seed` (as the single-device trainer)
        and keeps its own piece."""
        full = init_params(self.pcg, seed, "cpu")
        params = {k: local_block(v, self.weight_sharding(k), self.machine_mesh, k)
                  .contiguous().to(self.device) for k, v in full.items()}
        return params, make_optimizer_state(self.optimizer_attrs, params)

    def _whole(self, x, tensor: DataflowOutput) -> torch.Tensor:
        """x, a piece of `tensor`, with its pending partial sums summed."""
        s = self.shardings[tensor]
        return C.reshard(x, s, dataclasses.replace(s, sum=()), self.machine_mesh) if s.sum else x

    def _local(self, x, tensor: DataflowOutput, what: str) -> torch.Tensor:
        """This rank's piece of the global value x of `tensor`."""
        return local_block(torch.as_tensor(x, device=self.device), self.shardings[tensor],
                           self.machine_mesh, what)

    def _local_inputs(self, batch_inputs) -> Dict[str, torch.Tensor]:
        return {k: self._local(v, self._inputs[k], f"input {k!r}") for k, v in batch_inputs.items()}

    def _local_label(self, label):
        """Labels shard like the loss's logits, without the class dim."""
        s = self.shardings[self.loss_logit_tensor]
        label = torch.as_tensor(label, device=self.device)
        return label, local_block(label, s.with_dims(s.dims[:label.dim()]), self.machine_mesh,
                                  "label")

    def loss_fn(self, params, batch_inputs, label, rng=None):
        """(this rank's loss: the mean over its block of the logits times the
        block's share of the global tokens, its block of the logits). rng is
        unused: the interpreter refuses dropout."""
        full, label = self._local_label(label)
        local = self._local_inputs(batch_inputs)
        env = pcg_forward_interpreter(
            self.plan, cast_for_compute(params, self.compute_dtype),
            cast_for_compute(local, self.compute_dtype), [self.loss_logit_tensor])
        logit = self._whole(env[self.loss_logit_tensor], self.loss_logit_tensor)
        share = label.numel() / full.numel()
        return loss_forward(self.loss_attrs, logit, label) * share, logit

    def multi_train_step(self, params, opt_state, batch_stack, label_stack, rng):
        """The fused K-step window of the distributed trainer is not ported yet."""
        raise NotImplementedError(
            "multi_train_step of the distributed trainer is not ported yet (A7 item 9)")

    def loss_and_grads(self, params, batch_inputs, label, rng=None, metrics=None):
        """(global mean loss, {key: f32 gradient of this rank's piece}) from
        the global batch; `params` are not modified. The gradients of each
        set of axes go in one bucket, the loss and the metrics of the
        distinct blocks in the bucket over every axis."""
        mesh = self.machine_mesh
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        loss, logit = self.loss_fn(leaves, batch_inputs, label, rng)
        # where blocks differ, the rank at index 0 of every axis its block
        # is duplicated over speaks for it, in the bucket over every axis
        s = self.shardings[self.loss_logit_tensor]
        mvals = {}
        if metrics is not None:
            mvals = compute_metrics(self.metrics, logit.detach(), self._local_label(label)[1])
        del logit
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                 for k, g in zip(leaves, grads)}
        buckets: Dict[Axes, List[torch.Tensor]] = {}
        for k, g in grads.items():
            buckets.setdefault(self.plan.grad_axes[k], []).append(g)
        scalars = [loss.detach().float()] + [
            torch.as_tensor(v, device=self.device).float() for v in mvals.values()]
        block = _block_axes(s)
        world = mesh.names if block else ()
        if world:
            speaks = C.sum_group_zero(mesh, [a for a in mesh.names if a not in block])
            buckets.setdefault(world, []).extend(t if speaks else torch.zeros_like(t)
                                                 for t in scalars)
        reduced = C.bucket_all_reduce(mesh, buckets)
        out, taken = {}, {}
        for k in grads:
            axes = self.plan.grad_axes[k]
            out[k] = reduced[axes][taken.get(axes, 0)]
            taken[axes] = taken.get(axes, 0) + 1
        if world:
            scalars = reduced[world][taken.get(world, 0):]
        if metrics is not None:
            metrics.update({name: _like(v, t) for (name, v), t in zip(mvals.items(), scalars[1:])})
        return scalars[0], out

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """This rank's piece of the logits at `params` (pending partial sums
        summed), in the params' dtype."""
        env = pcg_forward_interpreter(self.plan, params, self._local_inputs(batch_inputs),
                                      [self.logit_tensor])
        return self._whole(env[self.logit_tensor], self.logit_tensor)

