"""Per-movement-edge prediction export from the machine-mapping DP (copy of
flexflow_tpu/compiler/machine_mapping/movement_export.py).

The DP prices every parallel op of a candidate through one path:
`_leaf_key(pcg, n)` -> `map_unmapped_op_cost_estimate_key(leaf, view)` ->
`estimator.estimate_op_cost(key)`. This module re-walks a solved plan
through that same path and exports, per movement edge, what the search
charged: the ms, the moved bytes, the link class the charge rode (`nvlink`
within a node, `ib` across nodes), and the collectives the charge implies,
as byte-sized templates.

The byte templates mirror `parallel_op_cost_ms`'s direction accounting
(cost_estimator.py): training charges both directions, so each edge exports
a forward and a backward template. `predicted_bytes` is the materialized
output bytes the priced collectives stage (an all-gather's gathered result,
an all-reduce's reduced result), not wire traffic. Weight-resident reshard
chains are priced at ~0 recurring ms (parameters are stored post-reshard
from init), but their templates still carry the weight bytes.

Unlike the JAX package's, the export has no default estimator that guesses
the backend: the caller passes the estimator the search priced with, so
`predicted_ms` is the DP's own movement term.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# template classes: "gather" covers all-gather / broadcast-like data
# movement, "reduce" covers all-reduce / reduce-scatter; "p2p" is the
# pipeline's handoff between stages (the 1F1B executor's point-to-point
# transfers, M hops a direction a step).
GATHER = "gather"
REDUCE = "reduce"
P2P = "p2p"


@dataclass
class MovementEdgePrediction:
    """One movement edge of a solved (PCG, mapping) plan, with the DP's
    charged cost and the collective templates its lowering may realize."""

    node_idx: int
    name: str
    # CombineAttrs / RepartitionAttrs / ReplicateAttrs / ReductionAttrs, or
    # a stage op (StagePartitionAttrs / StageMergeAttrs)
    kind: str
    degree: int
    bytes_global: int  # global reduced bytes of the moved tensor
    predicted_ms: Optional[float]
    # materialized bytes the PRICED collectives stage (0 when the charge
    # is ~free, e.g. weight-resident repartition)
    predicted_bytes: int
    weight_resident: bool = False
    # the edge's value originates at an Input layer through parallel ops
    # only: its forward replication/slicing is realized by the host feed
    # (each rank is fed its rows), and inputs carry no gradient
    input_chain: bool = False
    # (class, bytes) collectives this edge's lowering may realize
    templates: Tuple[Tuple[str, int], ...] = ()
    fused_kind: Optional[str] = None  # the collective-matmul lowering, if any
    # producing node of the moved tensor — when that node is itself a
    # movement edge, the two form one reshard chain
    input_node_idx: Optional[int] = None
    # link class the DP charged this edge on: "nvlink" within a node, "ib"
    # when the mapped views route the movement across nodes
    # (cost_estimator.movement_link_class, the derivation that keys the
    # movement store)
    link_class: Optional[str] = None
    extra: Dict[str, object] = field(default_factory=dict)

    def to_json(self) -> dict:
        return {
            "node": self.node_idx,
            "name": self.name,
            "kind": self.kind,
            "degree": self.degree,
            "bytes": int(self.bytes_global),
            "predicted_ms": (
                None if self.predicted_ms is None
                else round(float(self.predicted_ms), 6)
            ),
            "predicted_bytes": int(self.predicted_bytes),
            "weight_resident": self.weight_resident,
            "input_chain": self.input_chain,
            "fused_kind": self.fused_kind,
            "link_class": self.link_class,
        }


def _edge_degree(attrs) -> int:
    for a in (
        "repartition_degree",
        "combine_degree",
        "replicate_degree",
        "reduction_degree",
    ):
        d = getattr(attrs, a, None)
        if d is not None:
            return int(d)
    return 1


def _input_chain(pcg, v) -> bool:
    """Does `v` trace back to an Input layer through single-input
    parallel-op wrappers only (the host-feed analogue of
    problem_tree._from_weight)?"""
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs

    while True:
        attrs = pcg.op_attrs(v.node)
        if isinstance(attrs, InputAttrs):
            return True
        if not is_parallel_op(attrs):
            return False
        ins = pcg.inputs_of(v.node)
        if len(ins) != 1:
            return False
        v = ins[0]


def _templates_for(
    kind: str, t_bytes: int, weight_resident: bool
) -> Tuple[Tuple[Tuple[str, int], ...], int]:
    """(templates, predicted_bytes) for one edge kind. Templates name
    every collective the lowering MAY stage; predicted_bytes counts only
    the ones the DP actually charged for (parallel_op_cost_ms)."""
    t = int(t_bytes)
    if kind == "CombineAttrs":
        # fwd all-gather materializes the full tensor; bwd is a local
        # re-slice
        return ((GATHER, t),), t
    if kind == "RepartitionAttrs":
        if weight_resident:
            # priced free (params live sharded from init), but a lowering
            # may still materialize the gathered weight per step and reduce
            # its gradient pieces back
            return ((GATHER, t), (REDUCE, t)), 0
        # fwd re-slice is local; bwd all-gathers the grad pieces
        return ((GATHER, t),), t
    if kind == "ReplicateAttrs":
        if weight_resident:
            # resident replicas; the recurring collective is the bwd
            # gradient all-reduce (the per-step DP weight sync)
            return ((REDUCE, t), (GATHER, t)), t
        # fwd broadcast (often elided when the value is already
        # replicated) + bwd gradient all-reduce
        return ((GATHER, t), (REDUCE, t)), t
    if kind == "ReductionAttrs":
        # fwd all-reduce of the partial sums; bwd broadcast (usually
        # elided — the grad is already replicated)
        return ((REDUCE, t), (GATHER, t)), t
    return (), 0


def export_movement_predictions(
    pcg,
    mapping: Optional[dict],
    estimator,
    fused_edges: Optional[Dict[int, str]] = None,
) -> List[MovementEdgePrediction]:
    """Walk a solved plan's movement edges and export the DP's charged
    predictions (see the module docstring). `estimator` is the one the
    search priced with, so `predicted_ms` is the DP's own movement term.
    A pipeline-stage op is an edge of its own kind: an interior
    StagePartition carries its M point-to-point hops a direction (one
    "p2p" template of twice the activation's bytes, forward and backward);
    the region's entry and its StageMerge are local slicing, priced 0 with
    no template."""
    from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import (
        movement_link_class,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
        _from_weight,
        _leaf_key,
        map_unmapped_op_cost_estimate_key,
    )
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op, is_stage_op
    from flexflow_tpu_torch.op_attrs.ops import StagePartitionAttrs
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape
    from flexflow_tpu_torch.pcg.pipeline import pipeline_contexts

    if estimator is None:
        raise ValueError("export_movement_predictions needs the estimator the search priced with")
    fused_edges = fused_edges or {}
    pipeline_ctx = pipeline_contexts(pcg)
    out: List[MovementEdgePrediction] = []
    for n in pcg.topological_ordering():
        attrs = pcg.op_attrs(n)
        if is_stage_op(attrs):
            ins = pcg.inputs_of(n)
            t_bytes = get_reduced_shape(pcg.tensor_shape(ins[0])).size_bytes if ins else 0
            interior = isinstance(attrs, StagePartitionAttrs) and attrs.stage_index >= 1
            view = (mapping or {}).get(n)
            key = map_unmapped_op_cost_estimate_key(_leaf_key(pcg, n, pipeline_ctx), view)
            out.append(
                MovementEdgePrediction(
                    node_idx=n.idx,
                    name=pcg.layer_attrs(n).name or f"n{n.idx}",
                    kind=type(attrs).__name__,
                    degree=int(attrs.num_microbatches),
                    bytes_global=t_bytes,
                    predicted_ms=float(estimator.estimate_op_cost(key)) if interior else 0.0,
                    predicted_bytes=2 * t_bytes if interior else 0,
                    templates=((P2P, 2 * t_bytes),) if interior else (),
                    input_node_idx=ins[0].node.idx if ins else None,
                    link_class=movement_link_class(
                        attrs, [pcg.tensor_shape(v) for v in ins], view, estimator.machine_spec),
                )
            )
            continue
        if not is_parallel_op(attrs):
            continue
        ins = pcg.inputs_of(n)
        la = pcg.layer_attrs(n)
        kind = type(attrs).__name__
        in_shapes = [pcg.tensor_shape(v) for v in ins]
        t_bytes = get_reduced_shape(in_shapes[0]).size_bytes if ins else 0
        weight_resident = bool(ins) and all(_from_weight(pcg, v) for v in ins)
        view = (mapping or {}).get(n)
        key = map_unmapped_op_cost_estimate_key(_leaf_key(pcg, n, pipeline_ctx), view)
        templates, predicted_bytes = _templates_for(kind, t_bytes, weight_resident)
        out.append(
            MovementEdgePrediction(
                node_idx=n.idx,
                name=la.name or f"n{n.idx}",
                kind=kind,
                degree=_edge_degree(attrs),
                bytes_global=t_bytes,
                predicted_ms=float(estimator.estimate_op_cost(key)),
                predicted_bytes=predicted_bytes,
                weight_resident=weight_resident,
                input_chain=bool(ins) and all(_input_chain(pcg, v) for v in ins),
                templates=templates,
                fused_kind=fused_edges.get(n.idx),
                input_node_idx=ins[0].node.idx if ins else None,
                link_class=movement_link_class(attrs, in_shapes, view, estimator.machine_spec),
            )
        )
    return out


def link_class_census(predictions: List[MovementEdgePrediction]) -> Dict[str, Dict[str, float]]:
    """{link class: {"edges", "bytes", "predicted_ms"}} over exported edges:
    how a plan's movement splits between NVLink and InfiniBand."""
    out: Dict[str, Dict[str, float]] = {}
    for p in predictions:
        c = out.setdefault(p.link_class, {"edges": 0, "bytes": 0, "predicted_ms": 0.0})
        c["edges"] += 1
        c["bytes"] += int(p.bytes_global)
        c["predicted_ms"] += float(p.predicted_ms or 0.0)
    return out
