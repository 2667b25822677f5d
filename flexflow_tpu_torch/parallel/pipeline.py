"""1F1B pipelined training of a stage-partitioned PCG over ranks (port of
flexflow_tpu/parallel/pipeline.py).

The JAX package lowers the schedule to one program: a `lax.scan` over the
static 1F1B action table (`pcg.pipeline.one_f_one_b_schedule`) inside one
`shard_map` over a (stage, data) mesh, each tick moving activations up and
gradients down by `ppermute`. Here each rank is one process on one device,
and the ranks of a (stage x data) mesh walk the same table tick by tick:

- rank r is stage r // dp, data index r % dp (the JAX package's
  `devices.reshape(S, dp)`); stage s's parameters live only on its ranks,
  keyed by the template (stage 0) weight's key, as the JAX package stacks
  them [S, ...] under that key;
- at the start of each tick every rank exchanges with its neighbours what
  the previous tick produced: one microbatch's activation up to stage s+1
  and one gradient down to stage s-1, point to point between the ranks of
  the same data index (NCCL: one batch_isend_irecv a tick; gloo: staged
  through pinned host memory where the tensors are on a card, as
  `MachineMesh.ring_start` does);
- arrivals are stashed in min(S, M) modular slots; a backward unit
  recomputes the stage's forward under autograd from the stashed stage
  input and pulls back (dy, 0) inside the pipeline or (0, 1) at the last
  stage (gradient of its own local-mean loss), the JAX package's
  `_stage_unit_vjp`;
- gradients accumulate over the microbatches, are summed over the stage's
  data group and scaled by 1/(M dp), the JAX package's scale; each stage
  then applies the optimizer to its own parameters.

`FF_TPU_PIPELINE_BASELINE=1` runs the same per-unit functions under
`sequential_microbatch_schedule` (one unit a tick globally): the 1F1B step
is bitwise equal to it by construction, Dropout included. Dropout masks are
drawn on every rank from the step's generator for every (microbatch,
Dropout op) at the microbatch's global shape, in microbatch order and then
in `dropout_order` (training_backing), each rank keeping its rows, so the
draws do not depend on the schedule. A window of K steps (`multi_train_step`)
runs them eagerly in one call (no graph holds the point-to-point steps of
gloo, and a captured pipelined window over cards waits for a host with
several).

Executability (PipelineUnsupported otherwise; the flat executor stays the
always-correct path, since stage ops are the identity on values), as the
JAX package checks it: isomorphic stages, one boundary shape, batch
sharding only inside a stage, nothing but the Input layer before the
region and reshards after it. One check more: every value a stage reads
is its entry value or made inside the stage. The JAX extraction admits a
region whose entry's source also feeds a stage op directly (a pre-LN
residual) and then fails in its stage function; the port refuses it here.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from flexflow_tpu_torch.parallel import census

from flexflow_tpu_torch.kernels import apply_optimizer_, forward as kernel_forward
from flexflow_tpu_torch.kernels import loss_forward, make_optimizer_state
from flexflow_tpu_torch.kernels.metrics import compute_metrics
from flexflow_tpu_torch.kernels.ops import apply_dropout_mask, dropout_keep_mask
from flexflow_tpu_torch.kernels.precision import cast_for_compute
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    dropout_order,
    init_params,
    param_key,
    split_slot_values,
)
from flexflow_tpu_torch.observability.metrics import finalize_step
from flexflow_tpu_torch.op_attrs.core import is_parallel_op
from flexflow_tpu_torch.op_attrs.ops import (
    CombineAttrs,
    InputAttrs,
    LossAttrs,
    ReductionAttrs,
    RepartitionAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape
from flexflow_tpu_torch.pcg.optimizer import OptimizerAttrs
from flexflow_tpu_torch.pcg.pipeline import (
    analyze_pipeline,
    one_f_one_b_schedule,
    sequential_microbatch_schedule,
)
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node


class PipelineUnsupported(ValueError):
    """The PCG's stage structure cannot run on the 1F1B executor (the flat
    executor stays correct: stage ops are the identity on values)."""


# ---------------------------------------------------------------------------
# Structure extraction (the JAX package's checks, and the entry check)
# ---------------------------------------------------------------------------


@dataclass
class ExecutablePipeline:
    """A stage-partitioned PCG validated for 1F1B execution."""

    num_stages: int
    num_microbatches: int
    # per stage, its nodes in topological order (stage ops excluded)
    stage_nodes: List[List[Node]]
    # per stage, the value the stage consumes (the StagePartition output)
    entry_values: List[DataflowOutput]
    # per stage, the value it produces (the next boundary's or merge's input)
    exit_values: List[DataflowOutput]
    # per stage, its weight nodes in topological order; stage s's k-th
    # weight corresponds to the template's (stage 0's) k-th
    weight_nodes: List[List[Node]]
    input_node: Node  # the single Input layer feeding the region


def _stage_signature(pcg, nodes: Sequence[Node], binding: Dict) -> tuple:
    """Structural signature of one stage: op attrs, wiring (relative to the
    stage's own node list) and shapes. Equal signatures across stages:
    the parameters stack."""
    pos = {n: i for i, n in enumerate(nodes)}
    sig = []
    for n in nodes:
        attrs = pcg.op_attrs(n)
        ins = []
        for v in pcg.inputs_of(n):
            if v.node in pos:
                ins.append(("n", pos[v.node], v.idx))
            else:
                ins.append(("x", binding.get(v, "entry")))
        shapes = tuple(pcg.tensor_shape(o) for o in pcg.outputs_of(n))
        sig.append((type(attrs).__name__, attrs, tuple(ins), shapes))
    return tuple(sig)


def extract_executable_pipeline(pcg) -> ExecutablePipeline:
    """Validate and extract the stage structure (see the module docstring)."""
    region = analyze_pipeline(pcg)
    if region is None:
        raise PipelineUnsupported("PCG carries no stage ops")
    if not region.ok:
        raise PipelineUnsupported(f"malformed stage structure: {region.issues}")
    S, M = region.num_stages, region.num_microbatches
    if S < 2:
        raise PipelineUnsupported("need at least 2 stages")

    sp_nodes = region.partition_nodes
    merge = region.merge_node
    entry_values = [pcg.outputs_of(n)[0] for n in sp_nodes]
    exit_values = [pcg.inputs_of(n)[0] for n in sp_nodes[1:]] + [pcg.inputs_of(merge)[0]]

    # one boundary shape and dtype: the carry between stages is one buffer
    shapes = {(get_reduced_shape(pcg.tensor_shape(v)).dims, pcg.tensor_shape(v).dtype)
              for v in entry_values + exit_values}
    if len(shapes) != 1:
        raise PipelineUnsupported(
            f"stage boundary values disagree on shape/dtype: {sorted(shapes, key=repr)}")

    stage_nodes: List[List[Node]] = [[] for _ in range(S)]
    boundary = set(sp_nodes) | {merge}
    for n in pcg.topological_ordering():
        s = region.stage_of.get(n)
        if s is None or n in boundary:
            continue
        attrs = pcg.op_attrs(n)
        if isinstance(attrs, ReductionAttrs):
            raise PipelineUnsupported(
                "in-stage Reduction (tensor parallelism inside a stage) is not supported by the "
                "1F1B executor")
        if isinstance(attrs, (RepartitionAttrs, CombineAttrs)):
            d = attrs.repartition_dim if isinstance(attrs, RepartitionAttrs) else attrs.combine_dim
            rank = pcg.tensor_shape(pcg.inputs_of(n)[0]).num_dims
            if d % rank != 0 and not _feeds_from_weight(pcg, n):
                raise PipelineUnsupported(
                    "in-stage activation resharding on a non-batch dim is not supported by the "
                    "1F1B executor")
        stage_nodes[s].append(n)

    # everything outside the region must be the input feed (the Input layer
    # and reshard wrappers before the entry) or trailing reshards of the merge
    outside = [n for n in pcg.topological_ordering()
               if n not in region.stage_of and n not in boundary]
    input_node = None
    trailing = _reshard_descendants(pcg, pcg.outputs_of(merge)[0])
    for n in outside:
        attrs = pcg.op_attrs(n)
        if isinstance(attrs, InputAttrs):
            if input_node is not None:
                raise PipelineUnsupported("multiple Input layers feed the pipeline region")
            input_node = n
        elif is_parallel_op(attrs) and (n in trailing or _feeds_from_input(pcg, n)):
            continue  # an input-feed wrapper or a trailing reshard: the identity
        else:
            raise PipelineUnsupported(
                f"op outside the pipeline region: {type(attrs).__name__} (node {n.idx})")
    if input_node is None:
        raise PipelineUnsupported("no Input layer feeds the pipeline region")

    # every value a stage reads is its entry value or made inside the stage
    # (a pre-LN block's residual read of the region's source is neither)
    for s in range(S):
        inside = set(stage_nodes[s])
        for n in stage_nodes[s]:
            for v in pcg.inputs_of(n):
                if v != entry_values[s] and v.node not in inside:
                    raise PipelineUnsupported(
                        f"stage {s}: {type(pcg.op_attrs(n)).__name__} (node {n.idx}) reads "
                        f"node {v.node.idx}'s value from outside the stage, not through its entry "
                        "value (an entry value with a consumer outside the entry slot)")

    # stage isomorphism: equal signatures, so the parameters stack [S, ...]
    weight_nodes = []
    sigs = []
    for s in range(S):
        sigs.append(_stage_signature(pcg, stage_nodes[s], {entry_values[s]: "entry"}))
        weight_nodes.append([n for n in stage_nodes[s]
                             if isinstance(pcg.op_attrs(n), WeightAttrs)])
    for s in range(1, S):
        if sigs[s] != sigs[0]:
            raise PipelineUnsupported(
                f"stage {s} is not isomorphic to stage 0: parameters cannot stack along the "
                "stage axis")
    return ExecutablePipeline(S, M, stage_nodes, entry_values, exit_values, weight_nodes,
                              input_node)


def _feeds_from_weight(pcg, n) -> bool:
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _from_weight

    ins = pcg.inputs_of(n)
    return bool(ins) and all(_from_weight(pcg, v) for v in ins)


def _feeds_from_input(pcg, n) -> bool:
    while True:
        attrs = pcg.op_attrs(n)
        if isinstance(attrs, InputAttrs):
            return True
        if not is_parallel_op(attrs):
            return False
        ins = pcg.inputs_of(n)
        if len(ins) != 1:
            return False
        n = ins[0].node


def _reshard_descendants(pcg, value) -> set:
    out = set()
    frontier = [value]
    while frontier:
        v = frontier.pop()
        for u in pcg.uses_of(v):
            if is_parallel_op(pcg.op_attrs(u.node)):
                out.add(u.node)
                frontier.extend(pcg.outputs_of(u.node))
    return out


def measured_bubble_fraction(num_stages: int, num_microbatches: int, pipe_ms: float,
                             seq_ms: float) -> Optional[float]:
    """The bubble a run shows, as the JAX package's `bench.py --pipeline`
    reads it: with T = 2(M+S-1) ticks of 1F1B and 2MS of the sequential
    schedule over the same W = 2MS units, solve the per-tick overhead o and
    the per-unit work u from the two step times (t = T o + W u), then
    integrate the idle stages over the executed 1F1B table: tick t with
    a_t active stages lasts o + a_t u and leaves S - a_t stages idle.

    None where the two times fit no such model (o or u would be negative:
    the 1F1B step slower than the sequential one, or slower than its ticks'
    overhead allows), rather than a reading of the table alone."""
    S, M = int(num_stages), int(num_microbatches)
    fwd, bwd = one_f_one_b_schedule(S, M)
    act = ((fwd >= 0) | (bwd >= 0)).sum(axis=1)
    ticks, work, ticks_seq = int(fwd.shape[0]), int(act.sum()), 2 * M * S
    o = (seq_ms - pipe_ms) / (ticks_seq - ticks) if ticks_seq > ticks else 0.0
    u = (pipe_ms - ticks * o) / work
    if o < 0.0 or u < 0.0:
        return None
    tau = o + act * u
    return float(((S - act) * tau).sum() / max(S * tau.sum(), 1e-12))


# ---------------------------------------------------------------------------
# Point-to-point transfers between the neighbouring stages
# ---------------------------------------------------------------------------


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().reshape(-1).view(torch.uint8)


class _P2P:
    """One tick's transfers: `exchange(sends, recvs)` with sends (tensor,
    global rank, tag) and recvs (shape, dtype, global rank, tag); returns
    the received tensors on `device`. NCCL takes device tensors in one
    batch_isend_irecv; gloo's send and recv take host tensors, so a card's
    tensors are staged through pinned host memory. Tensors cross as bytes,
    whatever their dtype."""

    def __init__(self, device: torch.device) -> None:
        self.device = device
        self.nccl = dist.get_backend() == "nccl"
        self.staged = not self.nccl and device.type == "cuda"
        self.count = 0  # transfers made, each direction of a pair counted once

    def exchange(self, sends, recvs) -> List[torch.Tensor]:
        if not sends and not recvs:
            return []
        self.count += len(sends)
        for t, _, _ in sends:  # each stage transfer is one point-to-point hop
            census.note("collective-permute", census.tensor_bytes(t), 2)
        nbytes = [int(np.prod(shape)) * torch.empty((), dtype=dt).element_size()
                  for shape, dt, _, _ in recvs]
        if self.nccl:
            bufs = [torch.empty(n, dtype=torch.uint8, device=self.device) for n in nbytes]
            ops = [dist.P2POp(dist.irecv, b, peer, tag=tag)
                   for b, (_, _, peer, tag) in zip(bufs, recvs)]
            ops += [dist.P2POp(dist.isend, _as_bytes(t), peer, tag=tag) for t, peer, tag in sends]
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        else:
            pin = self.staged
            with census.transport():
                bufs = [torch.empty(n, dtype=torch.uint8, pin_memory=pin) for n in nbytes]
                works = [dist.irecv(b, peer, tag=tag)
                         for b, (_, _, peer, tag) in zip(bufs, recvs)]
                for t, peer, tag in sends:
                    out = _as_bytes(t)
                    if pin:
                        out = torch.empty(out.numel(), dtype=torch.uint8,
                                          pin_memory=True).copy_(out)
                    works.append(dist.isend(out, peer, tag=tag))
                for w in works:
                    w.wait()
                bufs = [b.to(self.device, non_blocking=pin) for b in bufs]
        return [b.view(dt).reshape(shape) for b, (shape, dt, _, _) in zip(bufs, recvs)]


# ---------------------------------------------------------------------------
# The training instance
# ---------------------------------------------------------------------------


class PipelinedTrainingInstance(ModelTrainingInstance):
    """Stage-partitioned PCG + loss + optimizer -> a 1F1B train step over
    the ranks of the default process group (S x dp of them).

    The training-instance surface of the other trainers (`initialize`,
    `train_step`, `multi_train_step`, `forward`, the run-health statistics),
    so FFModel's fit loop, its windows and its checkpoints drive it. Its
    state is this rank's stage: parameters keyed by the template weights'
    keys; `stacked_state` gathers the JAX package's stacked [S, ...] layout
    and `load_stacked_state` takes this stage's slice of it."""

    def __init__(
        self,
        pcg,
        logit_tensor: DataflowOutput,
        loss_attrs: LossAttrs,
        optimizer_attrs: OptimizerAttrs,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        metrics: FrozenSet[str] = frozenset(),
        collect_step_stats: bool = False,
        guard_nonfinite_updates: bool = False,
    ) -> None:
        """device: cuda:<local rank> unless given; see resolve_device."""
        from flexflow_tpu_torch.parallel.data_parallel import _rank_device, new_subgroup

        self.structure = extract_executable_pipeline(pcg)
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group is initialized: open one first (e.g. parallel.init_file_group)")
        S, M = self.structure.num_stages, self.structure.num_microbatches
        world = dist.get_world_size()
        if world % S:
            raise PipelineUnsupported(f"{S} stages do not divide {world} ranks")
        self.pcg = pcg
        self.dp = world // S
        self.rank = dist.get_rank()
        self.stage, self.data_index = divmod(self.rank, self.dp)
        super().__init__(pcg, logit_tensor, loss_attrs, optimizer_attrs,
                         compute_dtype=compute_dtype, device=_rank_device(device, self.rank),
                         metrics=metrics, collect_step_stats=collect_step_stats,
                         guard_nonfinite_updates=guard_nonfinite_updates)
        # the loss reads the region's exit (before any trailing reshard)
        self.loss_logit_tensor = self.structure.exit_values[-1]
        self.mesh_shape = {"stage": S, "data": self.dp}
        la = pcg.layer_attrs(self.structure.input_node)
        self.input_name = la.name or param_key(self.structure.input_node)
        self.batch_size = get_reduced_shape(
            pcg.tensor_shape(pcg.outputs_of(self.structure.input_node)[0])).dims[0]
        if self.batch_size % (M * self.dp):
            raise PipelineUnsupported(
                f"batch {self.batch_size} does not split into {M} microbatches over {self.dp} "
                "data-parallel ranks")
        # every rank opens every group, in the same order: the data groups
        # (a stage's ranks) and the stage groups (one data index's ranks)
        self.data_group = self.stage_group = None
        for s in range(S):
            g = new_subgroup([s * self.dp + j for j in range(self.dp)])
            if s == self.stage:
                self.data_group = g
        for j in range(self.dp):
            g = new_subgroup([s * self.dp + j for s in range(S)])
            if j == self.data_index:
                self.stage_group = g
        self.template_keys = [param_key(n) for n in self.structure.weight_nodes[0]]
        # this stage's weight nodes by template key, and the reverse
        self.stage_weights = dict(zip(self.template_keys,
                                      self.structure.weight_nodes[self.stage]))
        self._key_of = {n: k for k, n in self.stage_weights.items()}
        self.schedule = one_f_one_b_schedule(S, M)
        self.sequential_schedule = sequential_microbatch_schedule(S, M)
        self.p2p = _P2P(self.device)
        region = set().union(*map(set, self.structure.stage_nodes))
        self._dropouts = [n for n in dropout_order(pcg) if n in region]
        # the schedule every step walks: "1f1b", or "sequential" under
        # FF_TPU_PIPELINE_BASELINE=1 (read here once; callers may set it)
        self.schedule_name = ("sequential" if os.environ.get("FF_TPU_PIPELINE_BASELINE")
                              not in (None, "", "0") else "1f1b")

    # -- setup -------------------------------------------------------------

    def peer(self, stage: int) -> int:
        """The global rank of `stage` at this rank's data index."""
        return stage * self.dp + self.data_index

    def initialize(self, seed: int = 0):
        """This stage's parameters, each from its own weight node's
        initializer (as the flat trainers initialize the same PCG), keyed
        by the template's key, and their optimizer state."""
        full = init_params(self.pcg, seed, "cpu")
        params = {k: full[param_key(n)].to(self.device) for k, n in self.stage_weights.items()}
        return params, make_optimizer_state(self.optimizer_attrs, params)

    def _span_args(self) -> Dict[str, object]:
        return {"mesh": str(self.mesh_shape), "pipeline_stages": self.structure.num_stages,
                "pipeline_microbatches": self.structure.num_microbatches}

    def _capturable(self) -> bool:
        return False

    # -- the per-unit functions, one for both schedules ---------------------

    def _stage_forward(self, params, x, masks, m: int, train: bool = True):
        """This stage's subgraph on a microbatch (or batch) x; `masks` keyed
        by (Dropout node, microbatch)."""
        pcg, st, s = self.pcg, self.structure, self.stage
        env = {st.entry_values[s]: x}
        for n in st.stage_nodes[s]:
            attrs = pcg.op_attrs(n)
            outs = pcg.outputs_of(n)
            if isinstance(attrs, WeightAttrs):
                env[outs[0]] = params[self._key_of[n]]
                continue
            if is_parallel_op(attrs):
                env[outs[0]] = env[pcg.inputs_of(n)[0]]
                continue
            data, weights = split_slot_values(attrs, [env[v] for v in pcg.inputs_of(n)])
            if train and (n, m) in masks:
                results = [apply_dropout_mask(data[0], masks[(n, m)], attrs.rate)]
            else:
                results = kernel_forward(attrs, data, weights, train=False)
            for o, r in zip(outs, results):
                env[o] = r
        return env[st.exit_values[s]]

    def _unit_forward(self, params, x, label, masks, m):
        """One forward unit: (y, the local-mean loss at the last stage or None)."""
        y = self._stage_forward(cast_for_compute(params, self.compute_dtype), x, masks, m)
        if self.stage == self.structure.num_stages - 1:
            return y, loss_forward(self.loss_attrs, y, label)
        return y, None

    def _unit_backward(self, params, x, label, masks, m, dy):
        """One backward unit: the stage's forward recomputed under autograd
        from its stashed input, pulled back from dy (inside the pipeline) or
        from its own loss (the last stage). Returns (dparams, dx or None)."""
        leaves = {k: p.detach().requires_grad_(True) for k, p in params.items()}
        xin = x.detach().requires_grad_(self.stage > 0)
        with torch.enable_grad():
            y, loss = self._unit_forward(leaves, xin, label, masks, m)
            wrt = list(leaves.values()) + ([xin] if self.stage > 0 else [])
            if loss is not None:
                grads = torch.autograd.grad(loss, wrt, allow_unused=True)
            else:
                grads = torch.autograd.grad(y, wrt, grad_outputs=dy, allow_unused=True)
        dparams = {k: torch.zeros_like(leaves[k]) if g is None else g
                   for k, g in zip(leaves, grads)}
        return dparams, (grads[-1] if self.stage > 0 else None)

    # -- the step ------------------------------------------------------------

    def _microbatches(self, arr) -> torch.Tensor:
        """[M, b, ...]: this data rank's rows of each microbatch of a global
        batch (the JAX package's P(None, "data") over [M, B/M, ...])."""
        M = self.structure.num_microbatches
        arr = torch.as_tensor(arr, device=self.device)
        b = arr.shape[0] // M
        n = b // self.dp
        mb = arr.reshape((M, b) + tuple(arr.shape[1:]))
        return mb[:, self.data_index * n:(self.data_index + 1) * n]

    def _masks(self, rng, mb_rows: int) -> Dict[Tuple[Node, int], torch.Tensor]:
        """Every (Dropout op, microbatch)'s keep mask at the microbatch's
        global shape, drawn on every rank in one order, this rank keeping
        its rows of its own stage's."""
        out = {}
        if rng is None or not self._dropouts:
            return out
        mine = set(self.structure.stage_nodes[self.stage])
        n = mb_rows // self.dp
        for m in range(self.structure.num_microbatches):
            for node in self._dropouts:
                shape = get_reduced_shape(self.pcg.tensor_shape(self.pcg.outputs_of(node)[0]))
                rows = (mb_rows,) + tuple(shape.dims[1:])
                mask = dropout_keep_mask(rows, self.pcg.op_attrs(node).rate, rng, rng.device)
                if node in mine:
                    out[(node, m)] = mask[self.data_index * n:(self.data_index + 1) * n]
        return out

    def pipeline_grads(self, params, batch_inputs, label, rng=None):
        """(f32 grads of this stage, the step's mean loss, this rank's
        metric values) of one step through the 1F1B schedule, or the
        sequential one where `schedule_name` is "sequential"."""
        S, M = self.structure.num_stages, self.structure.num_microbatches
        s = self.stage
        last = s == S - 1
        sequential = self.schedule_name == "sequential"
        fwd, bwd = self.sequential_schedule if sequential else self.schedule
        B = max(min(S, M), 1)
        x = batch_inputs[self.input_name] if isinstance(batch_inputs, dict) else batch_inputs
        x_mb = cast_for_compute({"x": self._microbatches(x)}, self.compute_dtype)["x"]
        y_mb = self._microbatches(label)
        masks = self._masks(rng, torch.as_tensor(x).shape[0] // M)
        bshape, bdtype = tuple(x_mb.shape[1:]), x_mb.dtype
        stash: List[Optional[torch.Tensor]] = [None] * B
        dybuf: List[Optional[torch.Tensor]] = [None] * B
        grad_acc = {k: torch.zeros_like(p) for k, p in params.items()}
        loss_acc = torch.zeros((), dtype=torch.float32, device=self.device)
        logits: List[Optional[torch.Tensor]] = [None] * M
        y_send = dx_send = None
        for t in range(fwd.shape[0]):
            # what the neighbours produced last tick arrives now
            sends, recvs, slots = [], [], []
            if t > 0:
                pf, pb = fwd[t - 1], bwd[t - 1]
                if s < S - 1 and pf[s] >= 0:
                    sends.append((y_send, self.peer(s + 1), 0))
                if s > 0 and pb[s] >= 0:
                    sends.append((dx_send, self.peer(s - 1), 1))
                if s > 0 and pf[s - 1] >= 0:
                    recvs.append((bshape, bdtype, self.peer(s - 1), 0))
                    slots.append((stash, int(pf[s - 1]) % B))
                if s < S - 1 and pb[s + 1] >= 0:
                    recvs.append((bshape, bdtype, self.peer(s + 1), 1))
                    slots.append((dybuf, int(pb[s + 1]) % B))
            for (buf, slot), got in zip(slots, self.p2p.exchange(sends, recvs)):
                buf[slot] = got
            y_send = dx_send = None
            m = int(fwd[t, s])
            if m >= 0:
                x_f = x_mb[m] if s == 0 else stash[m % B]
                with torch.no_grad():
                    y, loss = self._unit_forward(params, x_f, y_mb[m], masks, m)
                if last:
                    loss_acc = loss_acc + loss.float()
                    logits[m] = y
                y_send = y
            m = int(bwd[t, s])
            if m >= 0:
                x_b = x_mb[m] if s == 0 else stash[m % B]
                dparams, dx = self._unit_backward(params, x_b, y_mb[m], masks, m,
                                                  None if last else dybuf[m % B])
                for k, g in dparams.items():
                    grad_acc[k] += g
                dx_send = dx
        scale = 1.0 / (M * self.dp)
        if self.dp > 1:
            flat = torch.cat([g.reshape(-1) for g in grad_acc.values()])
            census.note("all-reduce", census.tensor_bytes(flat), self.dp,
                        parts=[(None, census.tensor_bytes(g)) for g in grad_acc.values()])
            dist.all_reduce(flat, group=self.data_group)
            i = 0
            for k, g in grad_acc.items():
                g.copy_(flat[i:i + g.numel()].view_as(g))
                i += g.numel()
        for g in grad_acc.values():
            g.mul_(scale)  # in place: the accumulators become the step's gradients
        grads = grad_acc
        # the loss and the metric sums of the whole batch: the last stage's
        # ranks hold them, one all-reduce over every rank
        if last:
            flat_logits = torch.cat(logits).float()
            mvals = compute_metrics(self.metrics, flat_logits, y_mb.reshape(
                (-1,) + tuple(y_mb.shape[2:])))
        else:
            # the other stages contribute zeros of the same keys
            shape = (1,) + tuple(get_reduced_shape(
                self.pcg.tensor_shape(self.loss_logit_tensor)).dims[1:])
            mvals = compute_metrics(self.metrics, torch.zeros(shape, device=self.device),
                                    torch.zeros(shape[:-1], dtype=torch.long,
                                                device=self.device))
        tensors = {k: v for k, v in mvals.items() if not isinstance(v, int)}
        bucket = torch.stack([loss_acc] + [
            (v if last else torch.zeros_like(v)).float().reshape(()) for v in tensors.values()])
        census.note("all-reduce", census.tensor_bytes(bucket), dist.get_world_size())
        dist.all_reduce(bucket)
        loss = bucket[0] * scale
        out = {}
        for i, (k, v) in enumerate(tensors.items()):
            total = bucket[1 + i]
            out[k] = total if v.is_floating_point() else total.round().to(v.dtype)
        out["train_all"] = self.batch_size if "train_all" in mvals else None
        return grads, loss, {k: v for k, v in out.items() if v is not None}

    def _stat_reducer(self):
        """The statistics' per-parameter parts summed over the stages (a
        stage's data ranks hold the same parameters), one all-reduce over
        the stage group."""
        def reduce(keys, parts):
            total = parts.sum(dim=1)
            dist.all_reduce(total, group=self.stage_group)
            return total

        return reduce

    def _step(self, params, opt_state, batch_inputs, label, rng, live=None):
        grads, loss, mvals = self.pipeline_grads(params, batch_inputs, label, rng)
        stats = finalize_step(
            self.collect_step_stats, self.guard_nonfinite_updates or live is not None,
            params, opt_state, grads, loss,
            lambda: apply_optimizer_(self.optimizer_attrs, params, grads, opt_state),
            live=live, reduce=self._stat_reducer())
        return params, opt_state, loss, mvals, stats

    # -- inference -----------------------------------------------------------

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """The logits of a whole batch on every rank, in the params' dtype:
        the stages in turn over the batch (no schedule), each stage's ranks
        passing their result up, the last stage's first rank broadcasting."""
        S, s = self.structure.num_stages, self.stage
        x = batch_inputs[self.input_name] if isinstance(batch_inputs, dict) else batch_inputs
        x = torch.as_tensor(x, device=self.device)
        dims = get_reduced_shape(self.pcg.tensor_shape(self.loss_logit_tensor)).dims
        shape, dtype = (x.shape[0],) + tuple(dims[1:]), next(iter(params.values())).dtype
        if s > 0:
            (x,) = self.p2p.exchange([], [(shape, dtype, self.peer(s - 1), 0)])
        y = self._stage_forward(params, x, {}, 0, train=False)
        if s < S - 1:
            self.p2p.exchange([(y, self.peer(s + 1), 0)], [])
            y = torch.empty(shape, dtype=dtype, device=self.device)
        src = (S - 1) * self.dp
        if self.p2p.staged:
            host = y.cpu()
            dist.broadcast(host, src)
            return host.to(self.device)
        dist.broadcast(y, src)
        return y

    # -- the state in the JAX package's stacked layout -----------------------

    def _gather_stages(self, t: torch.Tensor) -> np.ndarray:
        """[S, ...]: every stage's tensor of one key, gathered over this
        rank's stage group (a collective)."""
        t = t.detach().contiguous()
        if dist.get_backend() != "nccl":
            t = t.cpu()
        parts = [torch.empty_like(t) for _ in range(self.structure.num_stages)]
        dist.all_gather(parts, t, group=self.stage_group)
        return torch.stack(parts).float().cpu().numpy()

    def stacked_state(self, params, opt_state=None) -> dict:
        """{"params": {template key: [S, ...]}, "opt_state": {"m", "v":
        likewise, "step"}} as numpy, the JAX PipelinedTrainingInstance's
        layout; every rank calls it (a collective)."""
        out = {"params": {k: self._gather_stages(params[k]) for k in self.template_keys}}
        if opt_state is not None:
            opt = {"step": np.asarray(int(opt_state["step"]), dtype=np.int32)}
            for slot in ("m", "v"):
                if slot in opt_state:
                    opt[slot] = {k: self._gather_stages(opt_state[slot][k])
                                 for k in self.template_keys}
            out["opt_state"] = opt
        return out

    def load_stacked_state(self, params, opt_state, stacked_params, stacked_opt=None) -> None:
        """Copy this stage's slice of stacked numpy state into the tensors
        in place; keys and shapes are checked."""
        s = self.stage

        def copy(dst: Dict[str, torch.Tensor], src: Dict[str, np.ndarray], what: str):
            if set(src) != set(dst):
                raise ValueError(f"{what}: keys {sorted(src)} differ from the plan's "
                                 f"{sorted(dst)}")
            for k, t in dst.items():
                v = np.asarray(src[k])
                if v.shape != (self.structure.num_stages,) + tuple(t.shape):
                    raise ValueError(f"{what} {k}: shape {v.shape}, the plan's "
                                     f"{(self.structure.num_stages,) + tuple(t.shape)}")
                with torch.no_grad():
                    t.copy_(torch.as_tensor(v[s]))

        copy(params, stacked_params, "params")
        if stacked_opt is not None and opt_state is not None:
            with torch.no_grad():
                opt_state["step"].fill_(int(np.asarray(stacked_opt["step"])))
            for slot in ("m", "v"):
                if slot in opt_state:
                    copy(opt_state[slot], stacked_opt[slot], f"opt_state/{slot}")

    def pcg_params(self, stacked_params: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        """The stacked parameters keyed by every PCG weight node (the flat
        executor's keys): stage s's k-th weight is the k-th template key's
        slice s."""
        out = {}
        for s, nodes in enumerate(self.structure.weight_nodes):
            for k, n in zip(self.template_keys, nodes):
                out[param_key(n)] = np.asarray(stacked_params[k][s])
        return out

