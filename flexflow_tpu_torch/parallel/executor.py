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
  deferred to its set of axes' gradient buckets, which the backward issues
  as it produces them (parallel/collectives.py, `BucketedBackward`);
- attention runs the rank's local heads (the weight piece's head count)
  through the per-head [b, h, s, d] kernels, as the JAX package's
  _try_sharded_flash_mha does; RingAttention rotates key/value blocks over
  the axes of its sequence dim, and UlyssesAttention (a subclass, taken
  first, as the JAX executor dispatches it) all-to-alls heads for sequence
  over those axes instead (kernels/ulysses_attention.py): four all-to-alls
  forward and four backward a node, no ring step;
- the Experts op gates every expert on every rank and runs the experts of
  its piece of the expert dim, whose axes make its output a partial sum
  (the plan's Reduction sums it); over a batch cut into blocks it routes
  the global batch (kernels/moe.py `batch_routing`: positions, capacity
  and the load-balance loss of the whole batch, as the JAX package's
  global-view op computes them). Its aux loss enters each rank's loss so
  that the loss reported counts it once and the gate's gradient takes it
  once (DistributedTrainingInstance.loss_fn);
- a bias on a partial sum (a contraction-sharded Linear, a head-parallel
  attention's output bias) is added on the ranks at sum index 0 only;
- BatchNorm takes its statistics over the axes of its batch dims;
- the loss consumes the logits before any trailing Combine or Repartition
  of a non-class dim (`_pre_reshard_value`), so no rank gathers the whole
  batch's logits: each rank's loss is the mean over its block scaled by the
  block's share of the global tokens, so that its gradient is the full one;
  the reported loss and the metrics count each distinct block once. Logits
  that reach the loss cut over their classes take it vocab parallel
  (kernels/loss.py `class_sharded_loss`, kernels/metrics.py
  `class_sharded_metrics`: the row max, the sum of exponentials and the
  target's logit reduced over the class axes, in f32; the argmax across
  shards);
- Dropout draws, on every rank, each op's global mask from the step's
  generator (training_backing.dropout_masks, keyed by the op's layer name,
  so a plan draws the single-device trainer's masks) and keeps its piece;
- an op no rule places (an activation or a nonlinear op on partial sums,
  a partial-sum Embedding, a channel-sharded grouped convolution, a
  reshape of the sharded batch dim, a dim sharded where the op cannot
  take it, an op type with no rule) runs the whole-tensor lowering: its
  operands' partial sums are reduced and their dims gathered
  (collectives.reshard, which carries the gradients), the op runs on whole
  values on every rank, and its outputs are cut to the plan's shardings (a
  partial-sum output held at sum index 0). It is a named state of the plan
  (`DistributedPlan.whole_nodes`, node -> why), not a silent fallback.

Every rank then applies the optimizer to its own pieces, so the ranks that
hold one piece stay bitwise equal. Each rank is fed the global batch (and
keeps its piece) or, as FFModel feeds it, only its own rows
(`feed_blocks`; `is_rank_block` tells the two apart, as in the
data-parallel trainer). The fused step window is one captured CUDA graph where
NCCL carries every collective, and K eager steps in one call under gloo
(`last_window`, as in the data-parallel trainer).

With the overlap lowering on (`overlap=True`, or FF_TPU_OVERLAP;
FF_TPU_OVERLAP_BASELINE=1 reverts it), the sites `collect_overlap_sites`
matches run the collective matmuls of kernels/collective_matmul.py: a
Linear fed by a Combine over a non-contraction dim gathers its input
around a ring while it multiplies the chunks (the Combine's all-gather is
not run), and a bias- and activation-free Linear whose partial sums feed a
matching Reduction reduce-scatters them around a ring while it computes
them, chunk by chunk, then all-gathers the reduced chunks (the Reduction's
all-reduce is not run). A site the lowering cannot take as it stands (an
operand that would need another reshard first) lowers serially, as the
JAX package's re-verification falls back; `fused_sites` lists the sites
that run fused.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import Counter
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.kernels import collective_matmul as CM
from flexflow_tpu_torch.kernels import forward as kernel_forward
from flexflow_tpu_torch.kernels import loss_forward, make_optimizer_state
from flexflow_tpu_torch.kernels.loss import class_sharded_loss
from flexflow_tpu_torch.kernels.metrics import class_sharded_metrics
from flexflow_tpu_torch.kernels import moe as MOE
from flexflow_tpu_torch.kernels.flash_attention import (
    sharded_flash_attention,
    sharded_flash_supported,
)
from flexflow_tpu_torch.kernels.ops import (
    _dense_context,
    apply_dropout_mask,
    batch_stats_group,
    mha_project_qkv,
)
from flexflow_tpu_torch.kernels.precision import cast_for_compute
from flexflow_tpu_torch.kernels.ring_attention import ring_mha_forward
from flexflow_tpu_torch.kernels.ulysses_attention import ulysses_mha_forward
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    ParamKey,
    dropout_masks,
    init_params,
    param_key,
    slot_roles,
)
from flexflow_tpu_torch.op_attrs.core import IncomingTensorRole, is_parallel_op
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape
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
    ExpertsAttrs,
    FlatAttrs,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    LossAttrs,
    MultiHeadAttentionAttrs,
    Pool2DAttrs,
    RepartitionAttrs,
    ReshapeAttrs,
    ReductionAttrs,
    RingAttentionAttrs,
    SoftmaxAttrs,
    SplitAttrs,
    UlyssesAttentionAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.parallel import census
from flexflow_tpu_torch.parallel import collectives as C
from flexflow_tpu_torch.parallel.data_parallel import _rank_device
from flexflow_tpu_torch.parallel.mesh import Axes, MachineMesh
from flexflow_tpu_torch.parallel.sharding import (
    TensorSharding,
    is_rank_block,
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


def overlap_lowering_active(flag: Optional[bool] = None) -> bool:
    """Is the fused collective-matmul lowering on? FF_TPU_OVERLAP_BASELINE=1
    force-reverts it; otherwise an explicit flag wins, else the
    FF_TPU_OVERLAP env var (the JAX package's switches)."""
    if os.environ.get("FF_TPU_OVERLAP_BASELINE"):
        return False
    if flag is not None:
        return bool(flag)
    return os.environ.get("FF_TPU_OVERLAP", "") not in ("", "0")


def collect_overlap_sites(pcg: ParallelComputationGraph,
                          shardings: Dict[DataflowOutput, TensorSharding],
                          mesh) -> Dict[Node, str]:
    """The JAX package's static pattern match of the fused collective-matmul
    sites, node -> kind, on the port's shardings:

    - "ag_matmul": a Linear whose data input is a Combine over a
      non-contraction dim (its only use) of a producer sharded there, the
      gather axes sharding neither the weight nor the output;
    - "matmul_rs": a bias-free, activation-free Linear whose partial-sum
      output feeds a Reduction of the same degree (its only use), whose
      input's local leading dim divides over the contraction axes."""
    sites: Dict[Node, str] = {}
    if mesh is None or mesh.world_size <= 1:
        return sites
    for n in pcg.topological_ordering():
        attrs = pcg.op_attrs(n)
        if not isinstance(attrs, LinearAttrs):
            continue
        outs, ins = pcg.outputs_of(n), pcg.inputs_of(n)
        if ins and len(ins) >= 2:
            x_t = ins[0]
            pa = pcg.op_attrs(x_t.node)
            if isinstance(pa, CombineAttrs) and len(pcg.uses_of(x_t)) == 1:
                (src,) = pcg.inputs_of(x_t.node)
                src_pts = pcg.tensor_shape(src)
                rank = src_pts.num_dims
                g = pa.combine_dim % rank
                if g != rank - 1:
                    gather = shardings[src].dims[g]
                    reused = {a for axes in shardings[ins[1]].dims for a in axes}
                    if outs:
                        reused |= {a for axes in shardings[outs[0]].dims for a in axes}
                    if (mesh.size(gather) > 1
                            and src_pts.dims.shard_dims[g].size % mesh.size(gather) == 0
                            and not shardings[ins[1]].dims[0]
                            and not reused & set(gather)):
                        sites[n] = "ag_matmul"
        if not outs or attrs.use_bias or attrs.activation is not None:
            continue
        out_pts = pcg.tensor_shape(outs[0])
        uses = pcg.uses_of(outs[0])
        if (out_pts.sum_degree <= 1 or len(uses) != 1
                or not isinstance(pcg.op_attrs(uses[0].node), ReductionAttrs)
                or pcg.op_attrs(uses[0].node).reduction_degree != out_pts.sum_degree
                or not ins):
            continue
        x_pts = pcg.tensor_shape(ins[0])
        sp = mesh.size(shardings[ins[0]].dims[-1])
        lead = x_pts.dims.shard_dims[0]
        if sp > 1 and (lead.size // max(lead.degree, 1)) % sp == 0:
            sites[n] = "matmul_rs"
    return sites


def _count_of(v, blocks: int, total: torch.Tensor):
    """A metric summed in f32 back in the type compute_metrics gave it. A
    Python int is a count fixed by the shape, the same on every block: the
    sum over `blocks` distinct blocks is that many times it, with no read
    of the device. Integer tensors are exact below 2**24."""
    if isinstance(v, int):
        return blocks * v
    if not v.is_floating_point():
        return total.round().to(v.dtype)
    return total


def _block_axes(s: TensorSharding) -> frozenset:
    """The axes along which ranks hold different blocks of a tensor's
    value (its partial sums summed)."""
    return frozenset(a for axes in s.dims for a in axes)


def _whole(rank: int) -> Tuple[Axes, ...]:
    return ((),) * rank


class _WholeTensor(Exception):
    """No rule places this node's pieces: it runs on whole values."""


def _no_rule(n: Node, attrs, why: str) -> _WholeTensor:
    return _WholeTensor(f"node {n.idx} ({type(attrs).__name__[:-len('Attrs')]}): {why}")


@dataclasses.dataclass
class _NodePlan:
    """How one compute node runs on this rank's pieces."""

    need: List[TensorSharding]  # per input slot, the sharding the op needs
    sum_grad: Dict[int, Axes]  # slot -> axes its gradient is summed over here
    bias_axes: Axes = ()  # a bias on a partial sum: added at index 0 of these
    stats_axes: Axes = ()  # BatchNorm: the axes of its batch dims
    ring_axes: Axes = ()  # RingAttention: the axes of its sequence dim
    a2a_axes: Axes = ()  # UlyssesAttention: the axes its all-to-alls run over
    expert_axes: Axes = ()  # Experts: the axes of its expert dim (a partial sum)
    routing_axes: Axes = ()  # Experts: the axes of its batch blocks
    fused: str = ""  # a collective-matmul site lowered fused: its kind
    fused_axes: Axes = ()  # the ring's axes
    fused_dim: int = 0  # ag_matmul: the dim the ring gathers
    fused_source: Optional[DataflowOutput] = None  # ag_matmul: the Combine's input
    whole: str = ""  # run on whole values (the whole-tensor lowering): why


def _requirements(pcg, n, attrs, shardings, mesh):
    """(what each input slot must be sharded as, the node plan's other
    fields: bias axes, BatchNorm's batch axes, the ring's or the
    all-to-all's axes, the Experts op's expert and batch axes) for compute
    node n to produce its outputs' shardings from the rank's pieces alone;
    raises _WholeTensor where no rule does."""
    ins, outs = pcg.inputs_of(n), pcg.outputs_of(n)
    o = shardings[outs[0]]
    roles = slot_roles(attrs, len(ins))
    data = [i for i, r in enumerate(roles) if r == IncomingTensorRole.INPUT]
    weights = [i for i, r in enumerate(roles) if r == IncomingTensorRole.WEIGHT]
    need: List[Optional[TensorSharding]] = [None] * len(ins)
    extra: Dict[str, Axes] = {}

    def like_out(i, total=()):
        need[i] = TensorSharding(o.dims, total)

    def whole_at(dims):
        for d in dims:
            if o.dims[d]:
                raise _no_rule(n, attrs, f"its output's dim {d} is sharded")

    if isinstance(attrs, LinearAttrs):
        if o.sum and attrs.activation is not None:
            raise _no_rule(n, attrs, "an activation on a partial sum")
        need[data[0]] = TensorSharding(o.dims[:-1] + (o.sum,))
        need[weights[0]] = TensorSharding((o.sum, o.dims[-1]))
        if attrs.use_bias:
            need[weights[1]] = TensorSharding((o.dims[-1],))
            extra["bias_axes"] = o.sum
    elif isinstance(attrs, MultiHeadAttentionAttrs):
        seq = isinstance(attrs, RingAttentionAttrs)
        whole_at([2] if seq else [1, 2])
        for i in data:
            need[i] = TensorSharding((o.dims[0], o.dims[1], ()))
        need[weights[0]] = TensorSharding(((), o.sum))
        for i in weights[1:]:
            need[i] = TensorSharding(((),))
        if attrs.bias:
            extra["bias_axes"] = o.sum
        if isinstance(attrs, UlyssesAttentionAttrs):
            if (attrs.num_heads // mesh.size(o.sum)) % mesh.size(o.dims[1]):
                raise _no_rule(n, attrs, "its local heads do not split over the sequence ranks")
            extra["a2a_axes"] = o.dims[1]
        elif seq:
            extra["ring_axes"] = o.dims[1]
    elif isinstance(attrs, ExpertsAttrs):
        # the tokens' blocks: dim 0 only, so a block is a run of the global
        # batch's rows (kernels/moe.py routes them in that order)
        whole_at(range(1, len(o.dims)))
        if attrs.num_experts % mesh.size(o.sum):
            raise _no_rule(n, attrs, "its experts do not divide over the expert ranks")
        need[data[0]] = TensorSharding(o.dims)
        need[weights[0]] = TensorSharding(((), ()))
        for i in weights[1:]:
            need[i] = TensorSharding((o.sum,) + _whole(pcg.tensor_shape(ins[i]).num_dims - 1))
        extra.update(expert_axes=o.sum, routing_axes=o.dims[0])
    elif isinstance(attrs, EmbeddingAttrs):
        if o.sum:
            raise _no_rule(n, attrs, "a partial-sum output")
        need[data[0]] = TensorSharding(o.dims[:-1])
        need[weights[0]] = TensorSharding(((), o.dims[-1]))
    elif isinstance(attrs, Conv2DAttrs):
        whole_at([2, 3])
        if o.sum and attrs.groups != 1:
            raise _no_rule(n, attrs, "a channel-sharded grouped convolution")
        need[data[0]] = TensorSharding((o.dims[0], o.sum, (), ()))
        need[weights[0]] = TensorSharding((o.dims[1], o.sum, (), ()))
        if attrs.use_bias:
            need[weights[1]] = TensorSharding((o.dims[1],))
            extra["bias_axes"] = o.sum
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
            raise _no_rule(n, attrs, "a reshape of the sharded batch dim")
        need[data[0]] = TensorSharding((o.dims[0],) + _whole(src.num_dims - 1))
    elif isinstance(attrs, BatchNormAttrs):
        like_out(data[0])
        for i in weights:
            need[i] = TensorSharding((o.dims[1],))
        extra["stats_axes"] = C.mesh_order(mesh, [a for d, axes in enumerate(o.dims) if d != 1
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
        # Dropout is linear in its input for a given mask: it may act on
        # partial sums, each rank applying its piece of the global mask
        if o.sum and not (isinstance(attrs, DropoutAttrs) or attrs.op_type in _LINEAR_UNARY):
            raise _no_rule(n, attrs, "a nonlinear op on a partial sum")
        like_out(data[0], o.sum)
    elif isinstance(attrs, ElementBinaryAttrs):
        if o.sum and attrs.op_type not in (ElementBinaryOpType.ADD, ElementBinaryOpType.SUB):
            raise _no_rule(n, attrs, "a nonlinear op on partial sums")
        for i in data:
            like_out(i, o.sum)
    elif isinstance(attrs, (ConcatAttrs, SplitAttrs)):
        whole_at([attrs.axis % len(o.dims)])
        for i in data:
            like_out(i)
    else:
        # an op without a rule runs only where nothing around it is sharded
        if any(shardings[t].placed() for t in list(ins) + list(outs)):
            raise _no_rule(n, attrs, "no rule places this op's pieces")
        for i, t in enumerate(ins):
            need[i] = shardings[t]
    for i in range(len(ins)):
        if need[i] is None:
            raise _no_rule(n, attrs, f"input slot {i} has no placement rule")
    return need, extra


def _same(a: TensorSharding, b: TensorSharding) -> bool:
    return a.dims == b.dims and set(a.sum) == set(b.sum)


class DistributedPlan:
    """The static lowering of a PCG on a mesh: the shardings, each compute
    node's plan, which values are a weight's piece as it rests, and the axes
    each weight's gradient is summed over after the backward."""

    def __init__(self, pcg: ParallelComputationGraph, mesh: MachineMesh,
                 mapping: Optional[Dict[Node, MachineView]] = None,
                 overlap: bool = False) -> None:
        """overlap: lower fused the collective-matmul sites of these
        shardings (`overlap_sites`, the JAX package's static map) that this
        lowering can take (`fused_sites`; see the module docstring)."""
        self.pcg, self.mesh = pcg, mesh
        self.shardings = pcg_shardings(pcg, mesh, mapping)
        S = self.shardings
        self.overlap_sites: Dict[Node, str] = (
            collect_overlap_sites(pcg, S, mesh) if overlap else {})
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
            try:
                need, extra = _requirements(pcg, n, attrs, S, mesh)
                # the Experts op's aux output is no piece of the plan's: every
                # rank holds the global value
                placed_outs = outs[:1] if isinstance(attrs, ExpertsAttrs) else outs
                work = C.placed_axes(need) | C.placed_axes([S[o] for o in placed_outs])
                whole = ""
            except _WholeTensor as e:
                # every rank runs the op on whole operands, then keeps its
                # piece of the output: the same work everywhere, so no
                # operand's gradient is summed
                need = [TensorSharding(_whole(pcg.tensor_shape(t).num_dims)) for t in ins]
                extra, work, whole = {}, frozenset(), str(e)
            sum_grad = {}
            for i, t in enumerate(ins):
                axes = C.mesh_order(mesh, work - need[i].placed())
                if t in alias and _same(S[t], need[i]):
                    # deferred to the weight's bucket
                    uses[alias[t]].append((n, i, axes))
                elif axes:
                    sum_grad[i] = axes
            self.nodes[n] = _NodePlan(need, sum_grad, whole=whole, **extra)
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
        self.buckets = self._bucket_plan()
        # parallel-op nodes a fused site takes the place of
        self.skip: Dict[Node, Node] = {}
        for n, kind in self.overlap_sites.items():
            self._fuse(n, kind)

    def _bucket_plan(self) -> List[Tuple[Axes, List[ParamKey]]]:
        """The gradient buckets, in issue order: each set of axes's weights
        (those over more than one rank) cut by collectives.bucket_plan, the
        buckets ordered by when the backward completes them (the position,
        in reverse first use, of the member the forward uses first); the
        weights summed nowhere last, as one bucket of no collective."""
        pcg, mesh, S = self.pcg, self.mesh, self.shardings
        numel = {}
        for n in pcg.topological_ordering():
            if isinstance(pcg.op_attrs(n), WeightAttrs):
                out = pcg.outputs_of(n)[0]
                dims = get_reduced_shape(pcg.tensor_shape(out)).dims
                numel[param_key(n)] = math.prod(
                    d // mesh.size(a) for d, a in zip(dims, S[out].dims))
        order = C.first_use_order(pcg, list(self.grad_axes), param_key)
        rank = {k: i for i, k in enumerate(reversed(order))}
        buckets, local = [], []
        for axes in sorted({a for a in self.grad_axes.values()}, key=lambda a: (len(a), a)):
            keys = [k for k in order if self.grad_axes[k] == axes]
            if mesh.size(axes) == 1:
                local.extend(keys)
                continue
            buckets.extend((axes, b) for b in C.bucket_plan(keys, numel))
        buckets.sort(key=lambda ab: max(rank[k] for k in ab[1]))
        if local:
            buckets.append(((), [k for k in order if k in set(local)]))
        return buckets

    def _fuse(self, n: Node, kind: str) -> None:
        """Lower site n fused where its operands need no other reshard."""
        pcg, mesh, S = self.pcg, self.mesh, self.shardings
        p = self.nodes.get(n)
        ins, outs = pcg.inputs_of(n), pcg.outputs_of(n)
        if p is None:
            return
        if kind == "ag_matmul":
            x_t = ins[0]
            attrs = pcg.op_attrs(x_t.node)
            (src,) = pcg.inputs_of(x_t.node)
            g = attrs.combine_dim % len(S[src].dims)
            gathered = S[src].with_dims(S[src].dims[:g] + ((),) + S[src].dims[g + 1:])
            if (S[src].sum or not _same(gathered, S[x_t]) or not _same(S[x_t], p.need[0])):
                return
            p.fused, p.fused_axes, p.fused_dim, p.fused_source = kind, S[src].dims[g], g, src
            self.skip[x_t.node] = n
        elif kind == "matmul_rs":
            (use,) = pcg.uses_of(outs[0])
            red_out = pcg.outputs_of(use.node)[0]
            o = S[outs[0]]
            if not _same(S[red_out], TensorSharding(o.dims, ())) or p.need[0].dims[-1] != o.sum:
                return
            p.fused, p.fused_axes = kind, o.sum
            self.skip[use.node] = n

    @property
    def fused_sites(self) -> Dict[Node, str]:
        """The sites that lower fused, node -> kind."""
        return {n: p.fused for n, p in self.nodes.items() if p.fused}

    @property
    def fused_edges(self) -> Dict[Node, str]:
        """The movement edges the fused sites absorb (the all-gather's
        Combine, the reduce-scatter's Reduction), edge node -> kind."""
        return {e: self.nodes[site].fused for e, site in self.skip.items()
                if self.nodes[site].fused}

    @property
    def whole_nodes(self) -> Dict[Node, str]:
        """The nodes of the whole-tensor lowering, node -> why no rule
        places their pieces."""
        return {n: p.whole for n, p in self.nodes.items() if p.whole}

    def step_collectives(self, target: DataflowOutput) -> "Counter":
        """The collectives one loss_and_grads issues where the loss takes
        `target`, by kind, read off the plan: each parallel op's and each
        operand's reshard (forward, and backward where the value depends on
        a weight), each gradient sum at an operand, BatchNorm's statistics,
        the gradient buckets of the weights, and the bucket of the loss and
        the metrics over every axis where blocks differ, a whole-tensor
        node's cut of its outputs; a fused site's ring steps (and the
        all-gather of matmul_rs's reduced chunks) in place of the
        collective it fuses. A class-sharded loss's own reductions, which
        depend on the loss and the metrics, are not counted."""
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
            if n in self.skip:
                continue  # a fused site's collectives take its place
            if is_parallel_op(attrs):
                out.update(C.reshard_collectives(S[ins[0]], S[outs[0]], mesh, ins[0] in grad))
            elif n in self.nodes:
                p = self.nodes[n]
                if p.fused:
                    out["ring_step"] += mesh.size(p.fused_axes) - 1
                    if p.fused == "matmul_rs":
                        out["all_gather"] += 1  # the reduced chunks
                seen = set()
                for i, t in enumerate(ins):
                    key = (t, p.need[i], p.sum_grad.get(i))
                    if key in seen:
                        continue
                    seen.add(key)
                    if p.fused == "ag_matmul" and i == 0:
                        if 0 in p.sum_grad and p.fused_source in grad:
                            out["all_reduce"] += 1
                        continue
                    if not _same(S[t], p.need[i]):
                        out.update(C.reshard_collectives(S[t], p.need[i], mesh, t in grad))
                    if i in p.sum_grad and t in grad:
                        out["all_reduce"] += 1
                if isinstance(attrs, BatchNormAttrs) and mesh.size(p.stats_axes) > 1:
                    out["all_reduce"] += 2 * (2 if ins[0] in grad else 1)
                if mesh.size(p.a2a_axes) > 1:
                    # q, k and v in, the context out; their gradients back
                    out["all_to_all"] += 4 * (2 if outs[0] in grad else 1)
                if mesh.size(p.routing_axes) > 1:
                    out["all_gather"] += 1  # the blocks' decision counts
                    if attrs.lambda_bal > 0:
                        out["all_reduce"] += 1  # the aux loss's probability sums
                if p.whole:
                    for o in self._placed_outputs(n):
                        out.update(C.reshard_collectives(
                            TensorSharding(_whole(len(S[o].dims))), S[o], mesh, o in grad))
        if S[target].sum and mesh.size(S[target].sum) > 1:
            out["all_reduce"] += 1  # the loss sums pending partials of its logits
        # a bucket each of gradients, and one of the loss and the metrics
        out["all_reduce"] += sum(1 for axes, _ in self.buckets if mesh.size(axes) > 1)
        if _block_axes(S[target]):
            out["all_reduce"] += 1
        return +out

    def _placed_outputs(self, n: Node) -> List[DataflowOutput]:
        """n's outputs that are pieces of the plan's shardings (all but an
        Experts op's aux loss, which every rank holds whole)."""
        outs = self.pcg.outputs_of(n)
        return outs[:1] if isinstance(self.pcg.op_attrs(n), ExpertsAttrs) else outs

    def aux_weight(self, aux: DataflowOutput) -> float:
        """What an Experts op's aux loss `aux` enters this rank's loss with
        for its gradient: 1 over its batch blocks (the backward of the
        routing's all-reduce gathers every block's share) at index 0 of its
        expert axes (whose ranks gate the same tokens), 0 elsewhere; 1 where
        the node runs on whole values."""
        p = self.nodes[aux.node]
        if not C.sum_group_zero(self.mesh, p.expert_axes):
            return 0.0
        return 1.0 / self.mesh.size(p.routing_axes)

    def axis_sets(self):
        """Every set of axes a collective of this plan runs over."""
        sets = set(self.grad_axes.values())
        for s in self.shardings.values():
            sets.update(a for a in s.dims if a)
            if s.sum:
                sets.add(s.sum)
        for p in self.nodes.values():
            sets.update(p.sum_grad.values())
            sets.update(a for a in (p.stats_axes, p.ring_axes, p.a2a_axes, p.expert_axes,
                                    p.routing_axes) if a)
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
    masks: Optional[Dict[Node, torch.Tensor]] = None,
) -> Dict[DataflowOutput, torch.Tensor]:
    """Evaluate the PCG on this rank's pieces: every tensor's piece keyed by
    DataflowOutput (only what `targets` depend on, where given). inputs:
    this rank's pieces, keyed by input-layer name (or param_key of the
    input node). masks: each Dropout's global keep mask
    (training_backing.dropout_masks); without them Dropout is the
    identity."""
    pcg = plan.pcg
    needed = _ancestors(pcg, targets) if targets is not None else None
    env: Dict[DataflowOutput, torch.Tensor] = {}
    for n in pcg.topological_ordering():
        if needed is not None and n not in needed:
            continue
        la = pcg.layer_attrs(n)
        outs = pcg.outputs_of(n)
        if isinstance(la.attrs, InputAttrs):
            key = la.name if la.name is not None and la.name in inputs else param_key(n)
            if key not in inputs:
                raise KeyError(f"missing input binding for {la.name or key}")
            env[outs[0]] = inputs[key]
            continue
        if isinstance(la.attrs, WeightAttrs):
            env[outs[0]] = params[param_key(n)]
            continue
        eval_node(plan, n, env, masks)
    return env


def eval_node(plan: DistributedPlan, n: Node, env, masks=None, run=None) -> None:
    """Run compute or parallel-op node n on this rank's pieces of its
    operands in `env`, and put its outputs' pieces there: a parallel op
    reshards, a compute op reshards its operands to what it needs, runs
    (`run(attrs, operands, node plan)`, else `_run`), and under the
    whole-tensor lowering cuts its whole outputs to the plan's shardings.
    The collectives it issues are counted as node n's (parallel/census.py)."""
    with census.node_scope(n.idx):
        _eval_node(plan, n, env, masks, run)


def _eval_node(plan: DistributedPlan, n: Node, env, masks, run) -> None:
    pcg, mesh, S = plan.pcg, plan.mesh, plan.shardings
    attrs = pcg.op_attrs(n)
    outs = pcg.outputs_of(n)
    if n in plan.skip:
        site = plan.nodes[plan.skip[n]]
        if site.fused == "matmul_rs":  # the fused site's output is the sum
            env[outs[0]] = env[pcg.inputs_of(n)[0]]
        return
    ins = pcg.inputs_of(n)
    if is_parallel_op(attrs):
        env[outs[0]] = C.reshard(env[ins[0]], S[ins[0]], S[outs[0]], mesh)
        return
    p = plan.nodes[n]
    slots: Dict[tuple, torch.Tensor] = {}
    vals = []
    for i, t in enumerate(ins):
        # one piece per distinct value (self-attention's q, k, v)
        key = (t, p.need[i], p.sum_grad.get(i))
        if p.fused == "ag_matmul" and i == 0:
            v = env[p.fused_source]  # the Combine's input: the ring gathers it
            if 0 in p.sum_grad:
                v = C.sum_grad(v, mesh, p.sum_grad[0])
            vals.append(v)
            continue
        if key not in slots:
            v = env[t]
            if not _same(S[t], p.need[i]):
                v = C.reshard(v, S[t], p.need[i], mesh)
            if i in p.sum_grad:
                v = C.sum_grad(v, mesh, p.sum_grad[i])
            slots[key] = v
        vals.append(slots[key])
    if isinstance(attrs, DropoutAttrs) and attrs.rate > 0 and masks is not None:
        # this rank's piece of the op's global mask
        mask = local_block(masks[n], TensorSharding(p.need[0].dims), mesh, "dropout mask")
        results = [apply_dropout_mask(vals[0], mask, attrs.rate)]
    else:
        results = (run or _run)(attrs, vals, p, mesh)
    placed = plan._placed_outputs(n)
    for o, r in zip(outs, results):
        if p.whole and o in placed:
            r = C.reshard(r, TensorSharding(_whole(len(S[o].dims))), S[o], mesh)
        env[o] = r


def _run(attrs, vals, p: _NodePlan, mesh: MachineMesh) -> List[torch.Tensor]:
    roles = slot_roles(attrs, len(vals))
    data = [v for v, r in zip(vals, roles) if r == IncomingTensorRole.INPUT]
    weights = [v for v, r in zip(vals, roles) if r == IncomingTensorRole.WEIGHT]
    if p.fused == "ag_matmul":
        return [CM.all_gather_matmul(
            data[0], weights[0], mesh, p.fused_axes, p.fused_dim,
            bias=weights[1] if attrs.use_bias else None, activation=attrs.activation)]
    if p.fused == "matmul_rs":
        return [CM.matmul_reduce_scatter(data[0], weights[0], mesh, p.fused_axes)]
    bias_on = C.sum_group_zero(mesh, p.bias_axes)
    if isinstance(attrs, MultiHeadAttentionAttrs):
        return [_attention(attrs, data, weights, mesh, p, bias_on)]
    if isinstance(attrs, ExpertsAttrs):
        first = mesh.index(p.expert_axes) * (attrs.num_experts // mesh.size(p.expert_axes))
        with MOE.batch_routing(_routing(mesh, p.routing_axes)):
            return MOE.experts_forward(attrs, data[0], weights, first_expert=first)
    if p.bias_axes and not bias_on:
        # the bias of a partial sum joins it once: at sum index 0
        weights = weights[:1]
        attrs = dataclasses.replace(attrs, use_bias=False)
    if isinstance(attrs, BatchNormAttrs) and p.stats_axes:
        group = mesh.group_of(p.stats_axes)[0]
        with batch_stats_group(lambda t: C.all_reduce_sum(t, group, mesh.counts)):
            return kernel_forward(attrs, data, weights)
    return kernel_forward(attrs, data, weights)


def _routing(mesh: MachineMesh, axes: Axes) -> Optional[MOE.BatchRouting]:
    """The Experts op's batch blocks over `axes` (None over one rank)."""
    if mesh.size(axes) == 1:
        return None
    group = mesh.group_of(axes)[0]

    def gather(t):
        mesh.counts["all_gather"] += 1
        return mesh.all_gather(t[None], 0, axes)

    return MOE.BatchRouting(mesh.index(axes), mesh.size(axes), gather,
                            lambda t: C.all_reduce_sum(t, group, mesh.counts))


def _attention(attrs: MultiHeadAttentionAttrs, data, weights, mesh: MachineMesh,
               p: _NodePlan, bias_on: bool) -> torch.Tensor:
    """Attention of the rank's local heads (the weight piece's count): the
    per-head [b, h, s, d] kernels where they take the block, else the dense
    path; UlyssesAttention all-to-alls over its sequence axes,
    RingAttention rotates over the ring of them."""
    q, k, v = data
    w = weights[0]
    heads = w.shape[1]
    if heads != attrs.num_heads:
        attrs = dataclasses.replace(attrs, num_heads=heads, kdim=attrs.q_proj_size,
                                    vdim=attrs.v_proj_size)
    input_bias = weights[1] if attrs.bias else None
    if isinstance(attrs, UlyssesAttentionAttrs):
        out = ulysses_mha_forward(attrs, q, k, v, w, mesh, p.a2a_axes, input_bias=input_bias,
                                  output_bias=torch.zeros_like(weights[2]) if attrs.bias else None)
    elif isinstance(attrs, RingAttentionAttrs):
        out = ring_mha_forward(attrs, q, k, v, w, mesh.ring(p.ring_axes), input_bias=input_bias,
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
    (as the JAX package's). `overlap`: the collective-matmul lowering
    (overlap_lowering_active decides, with its env switches)."""

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
        overlap: Optional[bool] = None,
        aux_loss_tensors=(),
        collect_step_stats: bool = False,
        guard_nonfinite_updates: bool = False,
    ) -> None:
        """device: cuda:<local rank> unless given; see resolve_device.
        aux_loss_tensors: Experts aux-loss outputs that join the loss (once:
        loss_fn). collect_step_stats / guard_nonfinite_updates: as
        ModelTrainingInstance's; the norms are global (`_stat_reducer`)."""
        import torch.distributed as dist

        self.pcg = pcg
        self.machine_mesh = machine_mesh
        self.mapping = dict(mapping) if mapping else None
        self.plan = DistributedPlan(pcg, machine_mesh, mapping, overlap_lowering_active(overlap))
        self.shardings = self.plan.shardings
        machine_mesh.open_groups(self.plan.axis_sets())
        self.loss_logit_tensor = _pre_reshard_value(pcg, logit_tensor)
        # logits that reach the loss cut over their classes: the loss and
        # the metrics run vocab parallel over these axes
        self.class_axes: Axes = self.shardings[self.loss_logit_tensor].dims[-1]
        self._inputs = {}
        for n in pcg.topological_ordering():
            la = pcg.layer_attrs(n)
            if isinstance(la.attrs, InputAttrs):
                self._inputs[la.name or param_key(n)] = pcg.outputs_of(n)[0]
        # the global batch: dim 0 of the first input
        self.batch_size = (get_reduced_shape(pcg.tensor_shape(
            next(iter(self._inputs.values())))).dims[0] if self._inputs else 0)
        super().__init__(pcg, logit_tensor, loss_attrs, optimizer_attrs,
                         compute_dtype=compute_dtype, device=_rank_device(device, dist.get_rank()),
                         metrics=metrics, aux_loss_tensors=aux_loss_tensors,
                         collect_step_stats=collect_step_stats,
                         guard_nonfinite_updates=guard_nonfinite_updates)
        for t in self.aux_loss_tensors:
            if not isinstance(pcg.op_attrs(t.node), ExpertsAttrs):
                raise ValueError(f"an aux loss over ranks must be an Experts op's, got {t}")
        # per step: (collective buckets issued, of them before the
        # backward's last gradient)
        self.bucket_log: List[Tuple[int, int]] = []

    @property
    def collectives(self):
        """The collectives issued over the mesh so far, by kind."""
        return self.machine_mesh.counts

    @property
    def all_reduces(self) -> int:
        return self.machine_mesh.counts["all_reduce"]

    def step_collectives(self) -> Counter:
        """The collectives a train step issues, by kind, as the plan implies
        them (DistributedPlan.step_collectives), and with collect_step_stats
        one all-reduce of the statistics' parts per set of weight axes
        (`_stat_reducer`)."""
        out = self.plan.step_collectives(self.loss_logit_tensor)
        for t in self.aux_loss_tensors:
            p = self.plan.nodes[t.node]
            if self.machine_mesh.size(p.routing_axes) > 1 and self.plan.aux_weight(t):
                out["all_reduce"] += 1  # the backward of its probability sums
        if self.collect_step_stats:
            mesh = self.machine_mesh
            out["all_reduce"] += sum(1 for axes in self._stat_axes() if mesh.size(axes) > 1)
        return out

    def _stat_axes(self) -> Dict[Axes, List[ParamKey]]:
        """The parameters by the axes their pieces differ over."""
        out: Dict[Axes, List[ParamKey]] = {}
        for n in self.pcg.topological_ordering():
            if isinstance(self.pcg.op_attrs(n), WeightAttrs):
                key = param_key(n)
                axes = C.mesh_order(self.machine_mesh, self.weight_sharding(key).placed())
                out.setdefault(axes, []).append(key)
        return out

    def _stat_reducer(self):
        """The global sums of the statistics' per-parameter parts: each set
        of weight axes's parts summed over its pieces, one all-reduce over
        those axes (a piece duplicated on the other axes counts once), then
        the sets added. The JAX package's norms are global by GSPMD."""
        mesh = self.machine_mesh
        axes_of = {key: axes for axes, keys in self._stat_axes().items() for key in keys}

        def reduce(keys, parts):
            groups: Dict[Axes, List[int]] = {}
            for i, key in enumerate(keys):
                groups.setdefault(axes_of[key], []).append(i)
            sums = C.bucket_all_reduce(mesh, {
                axes: [parts[:, idx].sum(dim=1)] for axes, idx in groups.items()})
            return torch.stack([v[0] for v in sums.values()]).sum(dim=0)

        return reduce

    def _span_args(self) -> Dict[str, object]:
        return {"mesh": str(dict(zip(self.machine_mesh.names, self.machine_mesh.shape))),
                "fused_edges": len(self.overlap_sites)}

    @property
    def overlap_sites(self) -> Dict[Node, str]:
        return self.plan.overlap_sites

    @property
    def fused_sites(self) -> Dict[Node, str]:
        return self.plan.fused_sites

    @property
    def fused_edges(self) -> Dict[Node, str]:
        return self.plan.fused_edges

    def step_flops(self) -> int:
        """A train step's flops of the model's own work, as MFU counts it
        (kernels.ops.graph_step_flops over the PCG)."""
        from flexflow_tpu_torch.kernels.ops import graph_step_flops

        return graph_step_flops(self.pcg)

    def _capturable(self) -> bool:
        import torch.distributed as dist

        return dist.get_backend(self.machine_mesh.group) == "nccl"

    def _rows(self, tensor: DataflowOutput) -> Tuple[int, int]:
        """(start, stop) of this rank's rows of `tensor`'s dim 0."""
        mesh, s = self.machine_mesh, self.shardings[tensor]
        size = get_reduced_shape(self.pcg.tensor_shape(tensor)).dims[0]
        axes = s.dims[0] if s.dims else ()
        n = size // mesh.size(axes)
        return mesh.index(axes) * n, (mesh.index(axes) + 1) * n

    def feed_blocks(self):
        """(rows per input name, rows of the label): the (start, stop) of
        this rank's block of each within a global batch, which is all it
        needs fed (the JAX package's device_put_global)."""
        return ({name: self._rows(t) for name, t in self._inputs.items()},
                self._rows(self.loss_logit_tensor))

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

    def _cut(self, x, s: TensorSharding, sizes, what: str) -> torch.Tensor:
        """This rank's piece of x: the global value, or (as FFModel feeds
        it) only this rank's rows of it, which are cut in the other dims."""
        x = torch.as_tensor(x)
        n0 = self.machine_mesh.size(s.dims[0]) if s.dims else 1
        if x.dim() and is_rank_block(x.shape[0], sizes[0], n0):
            s = s.with_dims(((),) + tuple(s.dims[1:]))
        return local_block(x, s, self.machine_mesh, what).to(self.device)

    def _local(self, x, tensor: DataflowOutput, what: str) -> torch.Tensor:
        """This rank's piece of the global value x of `tensor`."""
        sizes = get_reduced_shape(self.pcg.tensor_shape(tensor)).dims
        return self._cut(x, self.shardings[tensor], sizes, what)

    def _local_inputs(self, batch_inputs) -> Dict[str, torch.Tensor]:
        return {k: self._local(v, self._inputs[k], f"input {k!r}") for k, v in batch_inputs.items()}

    def _local_label(self, label) -> torch.Tensor:
        """This rank's piece of the label: labels shard like the loss's
        logits, without the class dim."""
        s = self.shardings[self.loss_logit_tensor]
        label = torch.as_tensor(label)
        sizes = get_reduced_shape(self.pcg.tensor_shape(self.loss_logit_tensor)).dims
        return self._cut(label, s.with_dims(s.dims[:label.dim()]), sizes[:label.dim()], "label")

    def _feed(self, batch_inputs, label):
        """This rank's pieces of the inputs and of the label."""
        return self._local_inputs(batch_inputs), self._local_label(label)

    def loss_fn(self, params, batch_inputs, label, rng=None):
        """(this rank's loss: the mean over its block of the logits times the
        block's share of the global tokens, its block of the logits) from
        its pieces of the inputs and the label (`_feed`). rng: the
        generator the step's Dropout masks are drawn from, each rank
        drawing the global masks (training_backing.dropout_masks) and
        keeping its pieces. Logits cut over their classes take the
        class-sharded loss over `class_axes`."""
        masks = dropout_masks(self.pcg, rng, rng.device) if rng is not None else None
        env = pcg_forward_interpreter(
            self.plan, cast_for_compute(params, self.compute_dtype),
            cast_for_compute(batch_inputs, self.compute_dtype),
            [self.loss_logit_tensor, *self.aux_loss_tensors], masks)
        logit = self._whole(env[self.loss_logit_tensor], self.loss_logit_tensor)
        sizes = get_reduced_shape(self.pcg.tensor_shape(self.loss_logit_tensor)).dims
        if self.class_axes:
            share = math.prod(logit.shape[:-1]) / math.prod(sizes[:-1])
            loss = class_sharded_loss(self.loss_attrs, logit, label, self._class_offset(logit),
                                      sizes[-1], *self._class_reducers()[:2])
            return self._with_aux(loss * share, env), logit
        share = label.numel() / math.prod(sizes[:label.dim()])
        return self._with_aux(loss_forward(self.loss_attrs, logit, label) * share, env), logit

    def _with_aux(self, loss, env):
        """The loss with each aux loss (the global value on every rank)
        added so that the ranks whose losses `_step_scalars` sums (one per
        distinct block of the logits) add it once in all, and its gradient
        reaches the gate once (DistributedPlan.aux_weight)."""
        speakers = self.machine_mesh.size(
            _block_axes(self.shardings[self.loss_logit_tensor]) - set(self.class_axes))
        for t in self.aux_loss_tensors:
            aux = env[t].to(loss.dtype).sum()
            value = aux.detach()
            loss = loss + value / speakers
            weight = self.plan.aux_weight(t)
            if weight:
                loss = loss + weight * (aux - value)
        return loss

    def _class_offset(self, logit) -> int:
        """The first class of this rank's block of the logits."""
        return self.machine_mesh.index(self.class_axes) * logit.shape[-1]

    def _class_reducers(self):
        """(sum, max, min) over the class axes: the sum differentiable with
        the identity backward (collectives.sum_partials)."""
        mesh, axes = self.machine_mesh, self.class_axes
        return (lambda x: C.sum_partials(x, mesh, axes),
                lambda x: C.all_reduce_extreme(x, mesh, axes, largest=True),
                lambda x: C.all_reduce_extreme(x, mesh, axes, largest=False))

    def _metric_values(self, logit, label):
        if not self.class_axes:
            return super()._metric_values(logit, label)
        return class_sharded_metrics(self.metrics, logit, label, self._class_offset(logit),
                                     *self._class_reducers())

    def _gradient_reducer(self, leaves):
        """The plan's buckets, issued as the backward produces them."""
        mesh = self.machine_mesh
        return C.BucketedBackward(
            [(mesh.group_of(axes)[0] if mesh.size(axes) > 1 else False, keys)
             for axes, keys in self.plan.buckets], leaves, mesh.counts, self.bucket_log)

    def _step_scalars(self, loss, grads, mvals):
        """(global mean loss, metric sums): the loss and the metrics of the
        distinct blocks in a bucket of their own over every axis."""
        mesh = self.machine_mesh
        # where blocks differ, the rank at index 0 of every axis its block
        # is duplicated over speaks for it, in the bucket over every axis;
        # the class ranks of a row block hold its whole loss and metrics
        block = _block_axes(self.shardings[self.loss_logit_tensor]) - set(self.class_axes)
        tensors = {k: v for k, v in mvals.items() if not isinstance(v, int)}
        scalars = [loss.float()] + [
            torch.as_tensor(v, device=self.device).float() for v in tensors.values()]
        if block:
            world = mesh.names
            speaks = C.sum_group_zero(mesh, [a for a in mesh.names if a not in block])
            scalars = C.bucket_all_reduce(mesh, {world: [
                t if speaks else torch.zeros_like(t) for t in scalars]})[world]
        sums = dict(zip(tensors, scalars[1:]))
        blocks = mesh.size(block)
        return scalars[0], {name: _count_of(v, blocks, sums.get(name))
                            for name, v in mvals.items()}

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """This rank's piece of the logits at `params` (pending partial sums
        summed), in the params' dtype."""
        env = pcg_forward_interpreter(self.plan, params, self._local_inputs(batch_inputs),
                                      [self.logit_tensor])
        return self._whole(env[self.logit_tensor], self.logit_tensor)

