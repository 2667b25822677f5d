"""Cost estimator interface + GPU implementations (copy of
flexflow_tpu/compiler/machine_mapping/cost_estimator.py).

Reference: lib/compiler/include/compiler/cost_estimator/cost_estimator.h:13-43
(abstract op cost + movement cost), tensor_set_movement.struct.toml.

Two implementations:
- GPUCostEstimator (the JAX TPUCostEstimator): measured op cost
  (LocalCostEstimator times the op's piece shapes on the card with CUDA
  events, the reference's cudaEvent discipline) + analytic comm cost from
  the machine spec's bandwidths: NVLink/NVSwitch within a node (INTRA),
  InfiniBand across nodes (INTER).
- AnalyticGPUCostEstimator (the JAX AnalyticTPUCostEstimator): a roofline on
  the per-task piece shapes, from the card's calibrated matmul FLOP/s and
  HBM GB/s, with the same comm model.

Both price a leaf's forward and backward for training, or its forward
alone for serving (`forward_only=True` on the analytic one; a
`LocalCostEstimator(forward_only=True)` under the measured one).

With a `calibration` (compiler/calibration.py), both price the parallel
ops from the measured all-reduce constants, as the JAX package does; with
`emulated_mesh` (ranks that share one device: several ranks on one card or
on one host's CPU, the port's counterpart of the JAX package's virtual CPU
mesh) a compute leaf is priced at the wall time the shared device takes
for every rank's piece (`_scale_for_emulated_shards`). Without a
calibration the parallel ops take the bandwidth model and the placeholder
latencies below.

With a `cost_store` (compiler/cost_store.py) a stored leaf measurement is
preferred by both (the analytic one corrects a miss by the store's fitted
per-class factor); with a `movement_store` (or the cost store) a parallel
op's collective is priced from a past audit's measurement on the same link
class (`movement_link_class`: `nvlink` or `ib`); a `comm_model`
(compiler/machine_model.MachineModelCommModel) replaces the bandwidth
model's movement pricing with a topology's congested makespan.

A pipeline-stage op is priced by `stage_transfer_cost_ms` in both: its M
point-to-point microbatch hops a direction on the link its view spans.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass
from functools import lru_cache
from typing import FrozenSet, Tuple

from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import OpCostEstimateKey
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_piece_shape,
)
from flexflow_tpu_torch.pcg.machine_view import (
    MachineSpecification,
    MachineView,
    ProjectionType,
)


@dataclass(frozen=True)
class SingleTensorMovement:
    """A concretized tensor movement: parallel shape + the views holding the
    source and destination copies (reference: single_tensor_movement.struct.toml)."""

    shape: ParallelTensorShape
    src_views: FrozenSet[MachineView]
    dst_views: FrozenSet[MachineView]
    # (dst view, consumer principal-output shape) pairs — lets the movement
    # model label each view's INTER task dims with the tensor dims they
    # shard instead of bare indices (empty on hand-built test movements:
    # pricing then falls back to labeling dst views against `shape`)
    dst_view_shapes: FrozenSet = frozenset()


@dataclass(frozen=True)
class TensorSetMovement:
    movements: Tuple[SingleTensorMovement, ...]


EMPTY_MOVEMENT = TensorSetMovement(())


class CostEstimator(abc.ABC):
    @abc.abstractmethod
    def estimate_op_cost(self, key: OpCostEstimateKey) -> float:
        """Elapsed ms of one task of the op under the given machine view."""

    @abc.abstractmethod
    def estimate_movement_cost(self, movement: TensorSetMovement) -> float:
        """Elapsed ms of the communication across a series split."""


def _views_span_nodes(view: MachineView) -> bool:
    return any(d.projection == ProjectionType.INTER_NODE for d in view.dimensions)


@lru_cache(maxsize=None)
def _task_dim_labels(shape: ParallelTensorShape):
    """Shard-dim label per task dim in task_space_from_shape order, or None
    when the shape carries sum/copy degrees (not purely dim-labelable)."""
    if shape.sum_degree > 1 or shape.discard_copy_degree > 1:
        return None
    return tuple(
        ("dim", i) for i, d in enumerate(shape.shard_degrees()) if d > 1
    )


@lru_cache(maxsize=None)
def _labeled_full_sig(view: MachineView, shape: ParallelTensorShape):
    """Complete placement signature of one view: start coordinate + per task
    dim (tensor-dim label, projection, stride). Two placements are movement-
    free only when these match. None when the shape is not purely
    dim-labelable or the view's arity does not match its task space."""
    labels = _task_dim_labels(shape)
    if labels is None or len(view.dimensions) != len(labels):
        return None
    return (
        view.start,
        tuple(
            (labels[i], d.projection, d.stride)
            for i, d in enumerate(view.dimensions)
        ),
    )


@lru_cache(maxsize=None)
def _labeled_inter_sig(view: MachineView, shape: ParallelTensorShape):
    """Node-level placement signature of one view: start node + the tensor
    dims (not bare indices) its INTER_NODE task dims shard. Callers must
    have verified labelability (via _labeled_full_sig)."""
    labels = _task_dim_labels(shape)
    return (
        view.start.node_idx,
        tuple(
            labels[i]
            for i, d in enumerate(view.dimensions)
            if d.projection == ProjectionType.INTER_NODE
        ),
    )


def link_for_views(
    machine_spec: MachineSpecification,
    intra_latency_ms: float,
    inter_latency_ms: float,
    crosses_nodes: bool,
):
    """(bandwidth GB/s, latency ms) for a collective on the selected link —
    the single policy point shared by the movement and parallel-op models."""
    if crosses_nodes:
        return machine_spec.inter_node_bandwidth, inter_latency_ms
    return machine_spec.intra_node_bandwidth, intra_latency_ms


# Link latencies of the comm model of an uncalibrated search, in ms: not
# measured, the same placeholders the JAX package uses for its two link
# classes. A calibrated search prices the parallel ops from the measured
# all-reduce constants instead.
DEFAULT_INTRA_LATENCY_MS = 0.001
DEFAULT_INTER_LATENCY_MS = 0.01


@dataclass(frozen=True)
class BandwidthCommModel:
    """Analytic movement model over the NVLink (intra-node) and InfiniBand
    (inter-node) bandwidths, shared by the measured and analytic estimators
    (machine_spec bandwidths in GB/s)."""

    machine_spec: MachineSpecification
    intra_latency_ms: float = DEFAULT_INTRA_LATENCY_MS
    inter_latency_ms: float = DEFAULT_INTER_LATENCY_MS
    # NIC ports each node exposes to the inter-node fabric: concurrent
    # cross-node transfers beyond the port count serialize on them
    nic_ports_per_node: int = 4

    def movement_cost_ms(self, movement: TensorSetMovement) -> float:
        total_ms = 0.0
        for m in movement.movements:
            same_views = m.src_views == m.dst_views
            if same_views and not m.dst_view_shapes:
                continue  # same placement: no movement
            # Tensor-dim labels apply only when BOTH sides are fully
            # labelable with shard-dim labels: every view's arity matches
            # its owning shape's task space AND neither shape carries
            # sum/copy degrees. A copy-degree source is replicated (any
            # consumer reads locally — e.g. the Megatron Replicate ->
            # column-Linear boundary must stay free), a sum-degree source's
            # collective is the downstream Reduction's own priced cost, and
            # a mismatched-arity view (a leaf whose output task space
            # collapsed) cannot be dim-labeled at all. Such movements keep
            # the index-based signatures / free-when-equal behavior.
            labels_ok = False
            src_labeled = dst_labeled = ()
            if m.dst_view_shapes:
                src_labeled = [
                    _labeled_full_sig(v, m.shape) for v in m.src_views
                ]
                dst_labeled = [
                    _labeled_full_sig(v, s) for v, s in m.dst_view_shapes
                ]
                labels_ok = all(
                    x is not None for x in src_labeled + dst_labeled
                )
            if same_views:
                # same views: no movement — unless the consumer's equal view
                # provably shards DIFFERENT tensor dims
                if not labels_ok:
                    continue
                if frozenset(src_labeled) == frozenset(dst_labeled):
                    continue
            piece_bytes = get_piece_shape(m.shape).size_bytes
            # A reshard rides InfiniBand only when the inter-node PLACEMENT
            # actually changes between producer and consumer. Two views that
            # keep the same node-level structure (e.g. a dp2-across-nodes
            # Megatron chain alternating column/row sharding WITHIN each
            # node) move data over NVLink even though both views carry an
            # INTER-projected dim — charging inter-node rates for every boundary of such
            # plans made every hybrid lose to uniform seeds on two-level
            # machines regardless of shape.
            # Views speak their own LEAF's task-space language, so when dim
            # identity is available the signatures label each INTER task dim
            # with the TENSOR dim it shards (shard dim index / sum / copy,
            # from task_space_from_shape ordering): a batch-INTER producer
            # feeding a feature-INTER consumer of equal arity compares
            # unequal and is priced inter-node, while the Megatron within-node
            # alternation (both sides batch-INTER) still compares equal and
            # rides NVLink.
            if labels_ok:
                src_sig = frozenset(
                    _labeled_inter_sig(v, m.shape) for v in m.src_views
                )
                dst_sig = frozenset(
                    _labeled_inter_sig(v, s) for v, s in m.dst_view_shapes
                )
            else:
                src_sig = self._index_inter_signatures(m.src_views)
                dst_sig = self._index_inter_signatures(m.dst_views)
            arities = {len(v.dimensions) for v in (m.src_views | m.dst_views)}
            has_inter = any(dims for _, dims in src_sig | dst_sig)
            crosses_nodes = (
                src_sig != dst_sig
                or (len(arities) > 1 and has_inter)
                or self._start_nodes_differ(m)
            )
            if crosses_nodes:
                # A cross-node edge is three legs, not one flat hop: the
                # piece leaves the source node's GPU over NVLink to a NIC,
                # rides InfiniBand, and enters the destination node over
                # NVLink. Concurrent destination transfers share the node's
                # NIC ports, so beyond `nic_ports_per_node` simultaneous
                # pieces the inter-node leg serializes (ceil congestion).
                n_transfers = len(m.dst_views)
                ports = max(self.nic_ports_per_node, 1)
                congestion = -(-n_transfers // ports)  # ceil
                intra_ms = piece_bytes / (
                    self.machine_spec.intra_node_bandwidth * 1e6
                )
                inter_ms = congestion * piece_bytes / (
                    self.machine_spec.inter_node_bandwidth * 1e6
                )
                total_ms += n_transfers * (
                    2 * self.intra_latency_ms + 2 * intra_ms  # exit + entry hop
                    + self.inter_latency_ms + inter_ms
                )
            else:
                bw_gbps, latency = link_for_views(
                    self.machine_spec,
                    self.intra_latency_ms,
                    self.inter_latency_ms,
                    crosses_nodes,
                )
                # each destination view receives the full tensor's pieces
                for _ in m.dst_views:
                    total_ms += latency + piece_bytes / (bw_gbps * 1e6)
        return total_ms

    def overlap_ramp_ms(self, serial_ms: float, chunks: int) -> float:
        """The overlapped movement entry's exposed residue (see
        machine_mapping/overlap.py): the same bytes priced by
        movement_cost_ms stream over a `chunks`-step ring behind the
        adjacent matmul, leaving only the first chunk's transfer plus one
        link latency per remaining hop un-hidable."""
        k = max(chunks, 1)
        return serial_ms / k + (k - 1) * self.intra_latency_ms

    @staticmethod
    def _index_inter_signatures(views) -> FrozenSet:
        """Dim-identity-free signature: the start node plus which task dim
        INDICES project INTER_NODE (used when labeling is unavailable)."""
        return frozenset(
            (
                v.start.node_idx,
                tuple(
                    i
                    for i, d in enumerate(v.dimensions)
                    if d.projection == ProjectionType.INTER_NODE
                ),
            )
            for v in views
        )

    @staticmethod
    def _start_nodes_differ(m: SingleTensorMovement) -> bool:
        starts = {v.start.node_idx for v in (m.src_views | m.dst_views)}
        return len(starts) > 1


def _parallel_op_crosses_nodes(
    attrs, input_shapes, view: "MachineView", machine_spec
) -> bool:
    """Does THIS parallel op's collective cross nodes?

    The leaf's view assigns a projection to each nontrivial degree of the
    op's OUTPUT (positionally: shard dims, then sum, then discard —
    task_space_from_shape). When the op's own degree survives in the output
    (Repartition, Replicate), its projection answers directly. When it
    vanishes (Combine to degree 1, Reduction draining the sum), the removed
    axis's level is whatever an intra-node-first allocation gives it: within
    the node if it still fits beside the view's intra-projected degrees,
    across nodes otherwise."""
    from flexflow_tpu_torch.op_attrs.ops import (
        CombineAttrs,
        RepartitionAttrs,
        ReplicateAttrs,
        ReductionAttrs,
    )

    if view is None or not input_shapes:
        return False
    pts = input_shapes[0]
    shard = list(pts.shard_degrees())
    sum_d = pts.sum_degree
    copy_d = pts.discard_copy_degree
    if isinstance(attrs, RepartitionAttrs):
        d = attrs.repartition_dim % len(shard)
        shard[d] *= attrs.repartition_degree
        own, k = ("shard", d), attrs.repartition_degree
    elif isinstance(attrs, CombineAttrs):
        d = attrs.combine_dim % len(shard)
        shard[d] //= attrs.combine_degree
        own, k = ("shard", d), attrs.combine_degree
    elif isinstance(attrs, ReplicateAttrs):
        copy_d *= attrs.replicate_degree
        own, k = ("copy",), attrs.replicate_degree
    elif isinstance(attrs, ReductionAttrs):
        sum_d //= attrs.reduction_degree
        own, k = ("sum",), attrs.reduction_degree
    else:
        return _views_span_nodes(view)
    entries = [("shard", i) for i, dg in enumerate(shard) if dg > 1]
    degrees = [dg for dg in shard if dg > 1]
    if sum_d > 1:
        entries.append(("sum",))
        degrees.append(sum_d)
    if copy_d > 1:
        entries.append(("copy",))
        degrees.append(copy_d)
    if own in entries and len(view.dimensions) == len(entries):
        proj = view.dimensions[entries.index(own)].projection
        return proj == ProjectionType.INTER_NODE
    if len(view.dimensions) == len(entries):
        # the op's axis vanished from the output task space: it stays within the node
        # iff it fits beside the view's intra-projected degrees
        intra_used = 1
        for dg, dim in zip(degrees, view.dimensions):
            if dim.projection == ProjectionType.INTRA_NODE:
                intra_used *= dg
        return intra_used * k > machine_spec.num_devices_per_node
    return _views_span_nodes(view)


def movement_link_class(
    attrs, input_shapes, machine_view: "MachineView", machine_spec
) -> str:
    """'nvlink' | 'ib': which interconnect class this parallel op's
    collective rides, the link-class segment of the movement-edge keys
    (movement_store.movement_edge_key): an edge measured on NVLink within a
    node must never be served for the same shapes placed across nodes over
    InfiniBand, and the reverse."""
    return (
        "ib"
        if _parallel_op_crosses_nodes(attrs, input_shapes, machine_view, machine_spec)
        else "nvlink"
    )


def _stored_edge_ms(store, key: OpCostEstimateKey, machine_spec):
    """A parallel op's stored measurement on its own link class, or None."""
    if store is None:
        return None
    shapes = list(key.input_shapes)
    return store.get_edge(
        key.op_attrs, shapes, key.machine_view,
        link_class=movement_link_class(key.op_attrs, shapes, key.machine_view, machine_spec),
    )


def parallel_op_cost_ms(
    attrs,
    input_shapes,
    machine_spec: MachineSpecification,
    intra_latency_ms: float,
    inter_latency_ms: float,
    machine_view: "MachineView" = None,
    weight_resident: bool = False,
    emulated_mesh: bool = False,
    calibration=None,
) -> float:
    """Collective cost of a parallel op (repartition/combine/replicate/
    reduction). These lower to real resharding collectives; pricing them at
    zero leaves the search indifferent to redundant Combine∘Repartition
    pairs (which the movement model can't see either — both endpoints sit
    on the same representative machine view). The collective rides the link
    of the op's OWN axis — a tp all-reduce inside a dp-across-nodes plan
    moves data over NVLink even though the op's view carries an INTER dim
    (pricing every collective of such plans at inter-node rates made all two-level
    hybrids lose to half-machine uniform plans regardless of shape)."""
    crosses_nodes = _parallel_op_crosses_nodes(
        attrs, input_shapes, machine_view, machine_spec
    )
    bw_gbps, latency_ms = link_for_views(
        machine_spec, intra_latency_ms, inter_latency_ms, crosses_nodes
    )
    from flexflow_tpu_torch.op_attrs.ops import (
        CombineAttrs,
        RepartitionAttrs,
        ReplicateAttrs,
        ReductionAttrs,
    )

    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape

    if not input_shapes:
        return 0.0
    total_bytes = get_reduced_shape(input_shapes[0]).size_bytes  # global bytes
    per_ms = bw_gbps * 1e6  # GB/s -> bytes/ms
    degree = (getattr(attrs, "repartition_degree", None) or getattr(attrs, "combine_degree", None)
              or getattr(attrs, "replicate_degree", None)
              or getattr(attrs, "reduction_degree", None) or 1)
    cal = calibration.allreduce_constants(degree) if calibration is not None else None
    if cal is not None and degree > 1:
        # measured constants: the probe timed a real k-participant
        # all-reduce, so its bandwidth holds the collective's own traffic
        # and the sharing of a device. Each op in all-reduce equivalents: an
        # all-gather and re-slice pair, or a broadcast, about half of one
        ar = cal.lat_ms + total_bytes / (cal.gbps * 1e6)
        if crosses_nodes:
            # measured within a host: scaled by the spec's inter/intra ratio
            ratio = max(machine_spec.inter_node_bandwidth
                        / max(machine_spec.intra_node_bandwidth, 1e-9), 1e-3)
            ar = cal.lat_ms + total_bytes / (cal.gbps * ratio * 1e6)
        if isinstance(attrs, RepartitionAttrs):
            return 0.0 if weight_resident else 0.5 * ar
        if isinstance(attrs, CombineAttrs):
            return 0.5 * ar
        if isinstance(attrs, ReplicateAttrs):
            return ar if weight_resident else 1.5 * ar
        if isinstance(attrs, ReductionAttrs):
            return 1.5 * ar
        return 0.0
    # Training prices BOTH directions: each parallel op's backward is the
    # transpose collective (Replicate's backward is the gradient
    # all-reduce — the per-step weight-sync that makes pure DP lose to
    # weight-sharded plans in the weight-heavy regime; leaving it unpriced
    # made the search DP-blind to exactly the OSDI'22 A/B effect).
    if isinstance(attrs, RepartitionAttrs):
        k = attrs.repartition_degree
        if k <= 1:
            return 0.0
        if weight_resident:
            # sharded parameters live sharded from init and their grad
            # pieces stay local — no recurring collective
            return 0.0
        # fwd re-slice (1/k) + bwd all-gather of grad pieces ((k-1)/k)
        return 2 * latency_ms + total_bytes / per_ms
    if isinstance(attrs, CombineAttrs):
        k = attrs.combine_degree
        if k <= 1:
            return 0.0
        # fwd all-gather ((k-1)/k) + bwd re-slice (1/k)
        return 2 * latency_ms + total_bytes / per_ms
    if isinstance(attrs, ReplicateAttrs):
        k = attrs.replicate_degree
        if k <= 1:
            return 0.0
        if weight_resident:
            if emulated_mesh:
                # ranks sharing a device: all k weight replicas and their
                # gradient sum stream through one memory system
                return 2 * latency_ms + k * total_bytes / per_ms
            # replicated parameters are resident (no per-step broadcast);
            # the recurring cost is the bwd gradient all-reduce
            return 2 * latency_ms + 2 * total_bytes / per_ms
        # fwd broadcast + bwd grad all-reduce (~2x over the wire)
        return 3 * latency_ms + 3 * total_bytes / per_ms
    if isinstance(attrs, ReductionAttrs):
        k = attrs.reduction_degree
        if k <= 1:
            return 0.0
        # fwd all-reduce (~2x) + bwd broadcast
        return 3 * latency_ms + 3 * total_bytes / per_ms
    return 0.0


def stage_transfer_cost_ms(
    attrs,
    input_shapes,
    machine_spec: MachineSpecification,
    intra_latency_ms: float,
    inter_latency_ms: float,
    machine_view: "MachineView" = None,
) -> float:
    """Per-step cost of a pipeline-stage op.

    An interior StagePartition (stage_index >= 1) is the handoff between
    stages: under 1F1B each of the M microbatches crosses it once forward
    (its activation) and once backward (its gradient) as a point-to-point
    transfer between the neighbouring stages' ranks, not a collective, so
    with no k-way amplification:

        2 * M * (link latency + piece_bytes/M / bandwidth)
      = 2 * M * latency + 2 * piece_bytes / bandwidth

    The region's entry (stage_index == 0) and the StageMerge are local
    microbatch slicing and stacking, priced 0. The link is the one the op's
    view spans, as `link_for_views` picks it: the spec's intra-node rate
    (NVLink on an H100 machine) inside a node, its inter-node rate
    (InfiniBand) across nodes."""
    from flexflow_tpu_torch.op_attrs.ops import StagePartitionAttrs
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_piece_shape

    if not isinstance(attrs, StagePartitionAttrs) or attrs.stage_index < 1 or not input_shapes:
        return 0.0
    m = max(attrs.num_microbatches, 1)
    piece_bytes = get_piece_shape(input_shapes[0]).size_bytes
    crosses_nodes = machine_view is not None and _views_span_nodes(machine_view)
    bw_gbps, latency_ms = link_for_views(
        machine_spec, intra_latency_ms, inter_latency_ms, crosses_nodes)
    return 2 * m * latency_ms + 2 * piece_bytes / (bw_gbps * 1e6)


def seq_parallel_attention_comm_ms(
    attrs,
    input_shapes,
    machine_spec: MachineSpecification,
    intra_latency_ms: float,
    inter_latency_ms: float,
    machine_view=None,
) -> float:
    """Schedule-internal communication of a sequence-parallel attention op —
    what lets the search tell the ring and Ulysses strategies apart:

    - Ring: (sp-1) ppermute steps, each moving the local K and V blocks
      (2 tensors of q_bytes/sp) one neighbor hop.
    - Ulysses: 4 all-to-alls (projected q, k, v in; context out), each
      exchanging (sp-1)/sp of the local block.

    Both are zero when the sequence is unsharded (the op runs dense)."""
    from flexflow_tpu_torch.op_attrs.ops.ring_attention import RingAttentionAttrs
    from flexflow_tpu_torch.op_attrs.ops.ulysses_attention import (
        UlyssesAttentionAttrs,
    )
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape

    if not isinstance(attrs, RingAttentionAttrs) or not input_shapes:
        return 0.0
    q = input_shapes[0]
    sp = q.shard_dim_at(1).degree if q.num_dims == 3 else 1
    if sp <= 1:
        return 0.0
    crosses_nodes = machine_view is not None and _views_span_nodes(machine_view)
    bw_gbps, latency_ms = link_for_views(
        machine_spec, intra_latency_ms, inter_latency_ms, crosses_nodes
    )
    per_ms = bw_gbps * 1e6
    block_bytes = get_reduced_shape(q).size_bytes // sp  # one seq block
    if isinstance(attrs, UlyssesAttentionAttrs):
        return 4 * (latency_ms + block_bytes * (sp - 1) / sp / per_ms)
    return (sp - 1) * (latency_ms + 2 * block_bytes / per_ms)


def _scale_for_emulated_shards(piece_ms: float, estimator) -> float:
    """The wall time of a compute leaf where the ranks share one device (the
    JAX package's rule for its virtual mesh): every rank runs its piece
    (unsharded ops on every rank), and the shared device runs them with the
    measured shard speedup S, so the leaf takes piece_ms * ndev / S. A
    no-op without `emulated_mesh`, without a calibration or on one
    device."""
    cal = getattr(estimator, "calibration", None)
    if (not getattr(estimator, "emulated_mesh", False) or cal is None
            or getattr(cal, "shard_speedup", None) is None):
        return piece_ms
    ndev = estimator.machine_spec.num_devices
    if ndev <= 1:
        return piece_ms
    return piece_ms * ndev / min(float(ndev), cal.shard_speedup)


class GPUCostEstimator(CostEstimator):
    """Measured compute + analytic communication for a GPU machine spec (the
    JAX package's TPUCostEstimator). Each compute leaf's piece shapes run on
    the card through the LocalCostEstimator (CUDA events around the op's
    forward and backward) unless its `cost_store` holds them; parallel ops
    take a stored measurement of their edge where the movement store (or
    the cost store) has one, and sequence-parallel attention schedules are
    priced by the comm model."""

    def __init__(
        self,
        machine_spec: MachineSpecification,
        local_cost_estimator=None,
        intra_latency_ms: float = DEFAULT_INTRA_LATENCY_MS,
        inter_latency_ms: float = DEFAULT_INTER_LATENCY_MS,
        comm_model=None,
        emulated_mesh: bool = False,
        calibration=None,
        movement_store=None,
        cost_store=None,
    ) -> None:
        from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator

        self.machine_spec = machine_spec
        self.local = local_cost_estimator or LocalCostEstimator(cost_store=cost_store)
        self.intra_latency_ms = intra_latency_ms
        self.inter_latency_ms = inter_latency_ms
        self.emulated_mesh = emulated_mesh
        self.calibration = calibration
        # the persistent cost database: leaves measured in past sessions
        # price without running; this session's measurements are written
        # back through the wrapped LocalCostEstimator
        self.cost_store = cost_store
        if cost_store is not None and self.local.cost_store is None:
            self.local.use_cost_store(cost_store)
        # measured movement edges of past audits; the cost store serves the
        # same interface, so it backs them when no movement store is given
        self.movement_store = movement_store if movement_store is not None else cost_store
        # anything with movement_cost_ms: BandwidthCommModel, or a topology's
        # MachineModelCommModel (compiler/machine_model.py)
        self.comm = comm_model or BandwidthCommModel(
            machine_spec, intra_latency_ms, inter_latency_ms)

    def estimate_op_cost(self, key: OpCostEstimateKey) -> float:
        from flexflow_tpu_torch.op_attrs.core import is_parallel_op, is_stage_op

        if is_stage_op(key.op_attrs):
            # a pipeline-stage boundary: M point-to-point microbatch hops a
            # direction, never a timed kernel (the identity locally)
            return stage_transfer_cost_ms(
                key.op_attrs, list(key.input_shapes), self.machine_spec,
                self.intra_latency_ms, self.inter_latency_ms, machine_view=key.machine_view)
        if is_parallel_op(key.op_attrs):
            hit = _stored_edge_ms(self.movement_store, key, self.machine_spec)
            if hit is not None:
                return hit
            return parallel_op_cost_ms(
                key.op_attrs,
                list(key.input_shapes),
                self.machine_spec,
                self.intra_latency_ms,
                self.inter_latency_ms,
                machine_view=key.machine_view,
                weight_resident=bool(key.weight_inputs) and all(key.weight_inputs),
                emulated_mesh=self.emulated_mesh,
                calibration=self.calibration,
            )
        return _scale_for_emulated_shards(self.local.estimate_operator_cost_parallel(
            key.op_attrs, list(key.input_shapes), list(key.output_shapes),
        ).elapsed_ms, self) + seq_parallel_attention_comm_ms(
            key.op_attrs,
            list(key.input_shapes),
            self.machine_spec,
            self.intra_latency_ms,
            self.inter_latency_ms,
            machine_view=key.machine_view,
        )

    def estimate_movement_cost(self, movement: TensorSetMovement) -> float:
        return self.comm.movement_cost_ms(movement)


class AnalyticGPUCostEstimator(CostEstimator):
    """Pure-analytic cost model, no card needed (the JAX package's
    AnalyticTPUCostEstimator): op cost = max(compute roofline, HBM roofline)
    on the per-task piece shapes, movement cost identical to
    GPUCostEstimator's bandwidth model. `peak_flops` and `hbm_gbps` have no
    defaults: pass the card's calibrated rates (compiler/calibration.py) or
    the constants a test holds both packages to.

    With a persistent `cost_store` the roofline is the fallback of a
    three-tier fallthrough: (1) a stored measurement for the exact leaf is
    used verbatim, (2) a missed leaf is priced at roofline x the per-op-class
    correction fitted from the store's (analytic, measured) pairs, (3)
    nothing is ever run. Every hit records the raw roofline beside the
    measurement, which grows the pair set the corrections are fitted from.
    """

    def __init__(
        self,
        machine_spec: MachineSpecification,
        peak_flops: float,
        hbm_gbps: float,
        intra_latency_ms: float = DEFAULT_INTRA_LATENCY_MS,
        inter_latency_ms: float = DEFAULT_INTER_LATENCY_MS,
        comm_model=None,
        emulated_mesh: bool = False,
        calibration=None,
        movement_store=None,
        cost_store=None,
        forward_only: bool = False,
    ) -> None:
        self.machine_spec = machine_spec
        self.peak_flops = peak_flops
        self.hbm_gbps = hbm_gbps
        self.emulated_mesh = emulated_mesh
        self.calibration = calibration
        self.intra_latency_ms = intra_latency_ms
        self.inter_latency_ms = inter_latency_ms
        self.cost_store = cost_store
        # forward-only pricing (serving): the deployed program is the
        # forward pass alone, so the roofline drops the backward's flops
        # multiple and the gradients' traffic double; a store attached
        # here must carry forward-marked keys (cost_store.forward_fingerprint)
        self.forward_only = bool(forward_only)
        if self.forward_only and cost_store is not None and "fwd" not in getattr(
                cost_store, "fingerprint", ""):
            raise ValueError("forward-only analytic pricing needs a forward-marked cost store "
                             "(see cost_store.forward_fingerprint)")
        # names the roofline constants behind every analytic price: pairs
        # recorded in the store carry it, and correction fitting excludes
        # pairs of sessions searching with other constants
        self._analytic_sig = f"pf{peak_flops:.6g}|hbm{hbm_gbps:.6g}" + (
            "|fwd" if self.forward_only else "")
        # per-OpCostEstimateKey memo of the store-backed path: the store's
        # consult and its hit/miss counts run once per unique key
        self._op_cost_memo: dict = {}
        self.movement_store = movement_store if movement_store is not None else cost_store
        self.comm = comm_model or BandwidthCommModel(
            machine_spec, intra_latency_ms, inter_latency_ms)

    def estimate_op_cost(self, key: OpCostEstimateKey) -> float:
        from flexflow_tpu_torch.kernels.ops import op_forward_flops
        from flexflow_tpu_torch.local_execution.training_backing import split_slot_values
        from flexflow_tpu_torch.op_attrs.core import (
            get_output_shapes,
            get_weight_shapes,
            is_parallel_op,
            is_stage_op,
        )

        if is_stage_op(key.op_attrs):
            # a pipeline-stage boundary: the analytic and the measured model
            # agree by construction (both price the M point-to-point hops)
            return stage_transfer_cost_ms(
                key.op_attrs, list(key.input_shapes), self.machine_spec,
                self.intra_latency_ms, self.inter_latency_ms, machine_view=key.machine_view)
        if is_parallel_op(key.op_attrs):
            hit = _stored_edge_ms(self.movement_store, key, self.machine_spec)
            if hit is not None:
                return hit
            return parallel_op_cost_ms(
                key.op_attrs,
                list(key.input_shapes),
                self.machine_spec,
                self.intra_latency_ms,
                self.inter_latency_ms,
                machine_view=key.machine_view,
                weight_resident=bool(key.weight_inputs) and all(key.weight_inputs),
                emulated_mesh=self.emulated_mesh,
                calibration=self.calibration,
            )
        if self.cost_store is not None and key in self._op_cost_memo:
            return self._op_cost_memo[key]
        piece_slots = [get_piece_shape(s) for s in key.input_shapes]
        # leaf input_shapes covers all slots (data + weights); split by role
        piece_inputs, piece_weights = split_slot_values(key.op_attrs, piece_slots)
        try:
            out_shapes = get_output_shapes(key.op_attrs, piece_inputs)
            weight_shapes = piece_weights or get_weight_shapes(key.op_attrs, piece_inputs)
        except (AssertionError, IndexError, ValueError):
            # shape inference failed on these piece shapes: this mapping is
            # broken — make it infinitely expensive, never free
            if self.cost_store is not None:
                self._op_cost_memo[key] = float("inf")
            return float("inf")
        sp_degree = 1
        if key.input_shapes and key.input_shapes[0].num_dims >= 3:
            sp_degree = key.input_shapes[0].shard_dim_at(1).degree
        flops = op_forward_flops(
            key.op_attrs, piece_inputs, out_shapes,
            weight_shapes=piece_weights or None,
            seq_parallel_degree=sp_degree,
        )
        # output bytes use the TRUE parallel output pieces, not the
        # sequential re-inference (whose attrs-derived channel dims are
        # global): a column-parallel Linear writes out/k per device
        piece_outs = [get_piece_shape(s) for s in key.output_shapes]
        bytes_moved = (
            sum(s.size_bytes for s in piece_inputs)
            + sum(s.size_bytes for s in weight_shapes)
            + sum(s.size_bytes for s in (piece_outs or out_shapes))
        )
        # fwd + bwd ~= 3x fwd flops; grads roughly double the traffic
        passes = 1 if self.forward_only else 3
        compute_ms = passes * flops / self.peak_flops * 1000.0
        memory_ms = (1 if self.forward_only else 2) * bytes_moved / (self.hbm_gbps * 1e6)
        base_ms = max(compute_ms, memory_ms)
        if self.cost_store is not None:
            # a past session's measurement beats the roofline outright (and
            # the pair it forms with the raw roofline feeds the correction
            # fitting); a miss is corrected by the class's fitted factor
            ws = tuple(piece_weights) if piece_weights else None
            hit = self.cost_store.get_op(key.op_attrs, tuple(piece_inputs), ws)
            if hit is not None:
                self.cost_store.note_analytic(key.op_attrs, tuple(piece_inputs), ws, base_ms,
                                              analytic_sig=self._analytic_sig)
                base_ms = hit[0]
            else:
                base_ms *= self.cost_store.correction_for(
                    type(key.op_attrs).__name__, analytic_sig=self._analytic_sig)
        out = _scale_for_emulated_shards(base_ms, self) + seq_parallel_attention_comm_ms(
            key.op_attrs,
            list(key.input_shapes),
            self.machine_spec,
            self.intra_latency_ms,
            self.inter_latency_ms,
            machine_view=key.machine_view,
        )
        if self.cost_store is not None:
            self._op_cost_memo[key] = out
        return out

    def estimate_movement_cost(self, movement: TensorSetMovement) -> float:
        return self.comm.movement_cost_ms(movement)


def make_default_allowed_machine_views(mode: str = "projection"):
    """The standard allowed-views callback for the DP/search: enumerate views
    for the leaf's task space over the given resources.

    mode:
      "projection" (default) — one view per INTER/INTRA projection
        assignment; the only distinctions the cost models can observe, so
        the boundary-assignment product stays tractable.
      "contiguous" — aligned contiguous views (adds start enumeration).
      "full" — the reference's full strided enumeration
        (allowed_machine_views.cc parity; for tests).
      "slice" — projection-representative views restricted to node-legal
        ones: a tensor-sharded task dim (slice_axes kind "tensor") never
        projects across nodes; data, replica and stage dims keep both
        choices. (A "slice" of the JAX package's multi-slice machine is a
        node here.)
    """
    from flexflow_tpu_torch.compiler.allowed_machine_views import (
        get_allowed_machine_views,
        get_contiguous_machine_views,
        get_projection_representative_machine_views,
        get_slice_aware_machine_views,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
        task_space_of_leaf,
    )

    if mode == "slice":
        from flexflow_tpu_torch.compiler.machine_mapping.slice_axes import (
            DCN_LEGAL_KINDS,
            leaf_task_axis_kinds,
        )

        def allowed(leaf, resources):
            kinds = leaf_task_axis_kinds(leaf)
            return get_slice_aware_machine_views(
                resources, task_space_of_leaf(leaf), tuple(k in DCN_LEGAL_KINDS for k in kinds))

        return allowed
    if mode == "contiguous":
        enum_fn = get_contiguous_machine_views
    elif mode == "full":
        enum_fn = get_allowed_machine_views
    else:
        enum_fn = get_projection_representative_machine_views

    def allowed(leaf, resources):
        return enum_fn(resources, task_space_of_leaf(leaf))

    return allowed
