"""Predicted-vs-measured audit of the searched plan (port of
flexflow_tpu/observability/plan_audit.py).

The one plan whose predictions matter is the winner the search hands to
the executor. This module replays that plan and compares, op by op and
movement edge by movement edge, what the cost model predicted against what
the card measures:

- compute ops: predicted ms is the estimator's leaf price under the chosen
  machine view (the number the DP summed); measured ms reruns the op's
  piece shapes through `LocalCostEstimator` on the card.
- movement edges (Combine / Repartition / Replicate / Reduction): predicted
  ms is the plan's charged collective cost; measured ms times the reshard
  the executor runs for the edge (parallel/collectives.py `reshard`, from
  the producer's sharding to the consumer's) over the rank mesh, every
  rank taking part. On a mesh of one rank nothing moves and `measured_ms`
  stays None.

Output: per-entry misprediction ratios (measured / predicted) and a
summary (geometric-mean ratio per class and combined, worst-N ops by
log-distance from 1.0).

The edges the executor lowers as collective matmuls are timed as fused
(the fused kernel's marginal over its bare matmul). With a cost store the
audit's op measurements join it (and analytic predictions their pairs);
with a movement store its standalone reshard measurements do.

A leaf's key carries its pipeline context (pcg.pipeline.pipeline_contexts),
as the search priced it. FFModel records the searched plan's collective
census beside the audit (its `comm` record: analysis/comm_analysis.py on
the compile's recorded step), and its measured peak beside the predicted
ones in search_provenance["memory"].

Recorded in `FFModel.search_provenance["plan_audit"]` under
`FFConfig(plan_audit=True)` on a searched compile.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

AUDIT_SCHEMA_VERSION = 1


def _geomean(ratios: List[float]) -> Optional[float]:
    vals = [r for r in ratios if r is not None and r > 0 and math.isfinite(r)]
    if not vals:
        return None
    return math.exp(sum(math.log(r) for r in vals) / len(vals))


def _ratio(measured: Optional[float], predicted: Optional[float]) -> Optional[float]:
    if (measured is None or predicted is None or predicted <= 0 or measured <= 0
            or not math.isfinite(predicted) or not math.isfinite(measured)):
        return None
    return measured / predicted


def _round(v: Optional[float], nd: int = 4) -> Optional[float]:
    return None if v is None else round(v, nd)


def _measure_movement_ms(shape, src_sharding, dst_sharding, mesh, settings,
                         device) -> Optional[float]:
    """Time the reshard a parallel op lowers to, from the producer's
    sharding to the consumer's, on every rank of `mesh` (a collective:
    every rank calls it for the same edge). Returns ms, or None when the
    movement cannot be timed."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.kernels.profiling import profile_eager
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape
    from flexflow_tpu_torch.parallel.collectives import reshard
    from flexflow_tpu_torch.parallel.sharding import local_block

    if src_sharding is None or dst_sharding is None:
        # an unconstrained endpoint has no defined collective to time
        return None
    ts = get_reduced_shape(shape)
    dtype = ts.dtype.to_torch() if ts.dtype.is_floating else torch.float32
    try:
        full = torch.from_numpy(np.random.default_rng(0).standard_normal(ts.dims)).to(dtype)
        x = local_block(full, src_sharding, mesh, "audited edge").contiguous().to(device)
        return profile_eager(lambda: reshard(x, src_sharding, dst_sharding, mesh), settings,
                             device)
    except Exception:
        return None


def _measure_fused_edge_ms(pcg, n, kind, shardings, mesh, settings, device) -> Optional[float]:
    """Marginal cost of the fused lowering of movement edge `n` (an overlap
    site's Combine or Reduction): the collective matmul's time on every
    rank minus a bare matmul at the same local piece shapes (the compute
    the ring performs anyway), leaving the edge's exposed communication.
    Timing the standalone reshard would measure a collective the program no
    longer contains. A collective: every rank calls it for the same edge.
    Returns ms (floored at 0: the fused ring can beat its own matmul by
    noise), or None where the edge cannot be measured so (the caller then
    times the standalone reshard, marked unfused)."""
    import numpy as np
    import torch

    from flexflow_tpu_torch.kernels import collective_matmul as CM
    from flexflow_tpu_torch.kernels.profiling import profile_eager
    from flexflow_tpu_torch.op_attrs.ops import CombineAttrs, LinearAttrs
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
        get_piece_shape,
        get_reduced_shape,
    )
    from flexflow_tpu_torch.parallel.sharding import local_block

    def block(tensor, seed):
        ts = get_reduced_shape(pcg.tensor_shape(tensor))
        full = torch.from_numpy(np.random.default_rng(seed).standard_normal(ts.dims)).float()
        return local_block(full, shardings[tensor], mesh, "audited fused edge").contiguous().to(
            device)

    def piece(tensor, seed):
        ts = get_piece_shape(pcg.tensor_shape(tensor))
        return torch.from_numpy(np.random.default_rng(seed).standard_normal(ts.dims)).float().to(
            device)

    if kind == "ag_matmul":
        attrs = pcg.op_attrs(n)
        if not isinstance(attrs, CombineAttrs):
            return None
        (xc,) = pcg.outputs_of(n)
        (use,) = pcg.uses_of(xc)
        if not isinstance(pcg.op_attrs(use.node), LinearAttrs):
            return None
        w_t = pcg.inputs_of(use.node)[1]
        (src,) = pcg.inputs_of(n)
        if src not in shardings or w_t not in shardings:
            return None
        g = attrs.combine_dim % pcg.tensor_shape(src).num_dims
        axes = shardings[src].dims[g]
        x, w = block(src, 0), block(w_t, 1)
        fused_ms = profile_eager(lambda: CM.all_gather_matmul(x, w, mesh, axes, g), settings,
                                 device)
        xp, wp = piece(xc, 0), piece(w_t, 1)
    elif kind == "matmul_rs":
        (red_in,) = pcg.inputs_of(n)
        if not isinstance(pcg.op_attrs(red_in.node), LinearAttrs):
            return None
        x_t, w_t = pcg.inputs_of(red_in.node)[:2]
        if any(t not in shardings for t in (x_t, w_t, red_in)):
            return None
        axes = shardings[red_in].sum
        x, w = block(x_t, 0), block(w_t, 1)
        fused_ms = profile_eager(lambda: CM.matmul_reduce_scatter(x, w, mesh, axes), settings,
                                 device)
        xp, wp = piece(x_t, 0), piece(w_t, 1)
    else:
        return None
    base_ms = profile_eager(lambda: xp @ wp, settings, device)
    return max(fused_ms - base_ms, 0.0)


def _emulation_scale(estimator) -> float:
    """The factor _scale_for_emulated_shards multiplies into every compute
    prediction where ranks share one card (ndev / measured shard speedup).
    The audit's measured side is one piece on one card, so predictions are
    divided back by it. 1.0 on separate cards and uncalibrated searches."""
    try:
        from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import (
            _scale_for_emulated_shards,
        )

        return float(_scale_for_emulated_shards(1.0, estimator))
    except Exception:
        return 1.0


def audit_plan(
    pcg,
    mapping: Dict,
    cost_estimator,
    machine_mesh=None,
    shardings: Optional[Dict] = None,
    settings=None,
    top_n: int = 5,
    optimizer_state_slots: int = 2,
    fused_edges: Optional[Dict[int, str]] = None,
    movement_store=None,
    cost_store=None,
    device=None,
    overlap_predictions: Optional[Dict[int, float]] = None,
) -> Dict[str, object]:
    """Replay the winning PCG against its cost-model predictions.

    pcg/mapping: the GraphOptimizeResult's graph and per-node MachineView
    dict. cost_estimator: the estimator the search priced with (so
    `predicted_ms` is the DP's leaf term), or None on a rank that only
    takes part in the movement measurements (its predictions and op
    measurements are None; rank 0's audit is the one recorded).
    machine_mesh/shardings: the executor's MachineMesh and per-tensor
    TensorShardings; with a mesh of more than one rank, movement edges are
    measured by running their reshard on every rank. device: where ops are
    measured (the card unless named). fused_edges (edge node idx -> kind)
    marks the movement edges the executor lowers as collective matmuls:
    they are measured as fused (the fused kernel's marginal cost over its
    bare matmul, `fused: True`), or, where that cannot be measured, as
    standalone reshards (`fused: False`); overlap_predictions (edge node
    idx -> ms) carries the DP's overlapped-exposure prediction for them.
    movement_store: a compiler.movement_store.MovementCostStore; every
    standalone reshard measured is recorded there, under the link class the
    edge rode (fused marginals are not: they price another lowering).
    cost_store: a compiler.cost_store.CostStore of this device kind; the
    audit's per-op measured ms flow into it through the replay's
    LocalCostEstimator (an op one audit measured is not timed again by a
    later search or audit), and where the search priced analytically each
    freshly measured op also records the prediction as the analytic half of
    a correction pair. The communication cross-check, which the JAX
    package's audit takes byte predictions for, runs in FFModel's compile
    on its recorded step (analysis/comm_analysis.py) and lands beside the
    audit as its `comm` record."""
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
        _leaf_key,
        map_unmapped_op_cost_estimate_key,
    )
    from flexflow_tpu_torch.kernels.profiling import ProfilingSettings
    from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator
    from flexflow_tpu_torch.local_execution.training_backing import param_key, resolve_device
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape

    settings = settings or ProfilingSettings(warmup_iters=1, measure_iters=3)
    device = resolve_device(device)
    local = None
    if cost_estimator is not None:
        local = LocalCostEstimator(settings, optimizer_state_slots=optimizer_state_slots,
                                   device=device, cost_store=cost_store)
    # only an analytic prediction forms a valid (analytic, measured) pair: a
    # measured estimator's prediction is a measurement itself
    record_pairs = (cost_store is not None
                    and type(cost_estimator).__name__ == "AnalyticGPUCostEstimator")
    analytic_sig = getattr(cost_estimator, "_analytic_sig", None)
    # the correction factors the search priced with, frozen before the
    # audit records pairs (note_analytic refits them live)
    corrections_at_pricing = {}
    if record_pairs:
        corrections_at_pricing = {
            cls: c["factor"]
            for cls, c in cost_store.fit_corrections(analytic_sig=analytic_sig).items()}
    if machine_mesh is not None and shardings is None:
        from flexflow_tpu_torch.parallel.sharding import pcg_shardings

        shardings = pcg_shardings(pcg, machine_mesh, mapping)
    can_measure_movement = machine_mesh is not None and machine_mesh.world_size > 1
    emulation_scale = _emulation_scale(cost_estimator) if cost_estimator is not None else 1.0

    from flexflow_tpu_torch.pcg.pipeline import pipeline_contexts

    pipe_ctx = pipeline_contexts(pcg)
    ops: List[Dict[str, object]] = []
    edges: List[Dict[str, object]] = []
    for n in pcg.topological_ordering():
        attrs = pcg.op_attrs(n)
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            continue
        la = pcg.layer_attrs(n)
        name = la.name or param_key(n)
        leaf = _leaf_key(pcg, n, pipe_ctx)
        view = (mapping or {}).get(n)
        # measured before this audit replayed it? (a store hit makes the
        # estimator's "prediction" a measurement, never an analytic half)
        pre_measured = (not is_parallel_op(attrs) and record_pairs
                        and cost_store.peek_op_parallel(attrs, list(leaf.input_shapes))
                        is not None)
        predicted = None
        if cost_estimator is not None:
            try:
                predicted = float(cost_estimator.estimate_op_cost(
                    map_unmapped_op_cost_estimate_key(leaf, view)))
            except Exception:
                predicted = None
        if is_parallel_op(attrs):
            ins = pcg.inputs_of(n)
            outs = pcg.outputs_of(n)
            bytes_moved = get_reduced_shape(pcg.tensor_shape(ins[0])).size_bytes if ins else 0
            measured = None
            fused_kind = (fused_edges or {}).get(n.idx)
            fused = False
            if can_measure_movement and ins and outs:
                if fused_kind is not None:
                    measured = _measure_fused_edge_ms(pcg, n, fused_kind, shardings or {},
                                                      machine_mesh, settings, device)
                    fused = measured is not None
                if measured is None:
                    measured = _measure_movement_ms(
                        pcg.tensor_shape(ins[0]), (shardings or {}).get(ins[0]),
                        (shardings or {}).get(outs[0]), machine_mesh, settings, device)
                    if (measured is not None and movement_store is not None
                            and cost_estimator is not None):
                        from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import (
                            movement_link_class,
                        )

                        in_shapes = [pcg.tensor_shape(v) for v in ins]
                        movement_store.put_edge(
                            attrs, in_shapes, view, measured,
                            link_class=movement_link_class(attrs, in_shapes, view,
                                                           cost_estimator.machine_spec))
            if cost_estimator is None:
                measured = None
            entry = {
                "name": name,
                "kind": type(attrs).__name__,
                "bytes": int(bytes_moved),
                "predicted_ms": _round(predicted),
                "measured_ms": _round(measured),
                "ratio": _round(_ratio(measured, predicted)),
            }
            if fused_kind is not None:
                # a fused edge compares the fused lowering's measured
                # marginal with the serial prediction (the win) and, where
                # the DP recorded one, with its overlapped prediction
                entry["fused"] = fused
                entry["fused_kind"] = fused_kind
                ov_pred = (overlap_predictions or {}).get(n.idx)
                if ov_pred is not None:
                    entry["predicted_overlapped_ms"] = _round(ov_pred)
                    entry["overlapped_ratio"] = _round(_ratio(measured, ov_pred))
            edges.append(entry)
        else:
            if predicted is not None and emulation_scale != 1.0:
                # compare model fidelity, not the shared-card scaling
                predicted = predicted / emulation_scale
            measured = None
            if local is not None:
                try:
                    measured = local.estimate_operator_cost_parallel(
                        attrs, list(leaf.input_shapes)).elapsed_ms
                    if not math.isfinite(measured):
                        measured = None
                except Exception:
                    measured = None
            if (record_pairs and not pre_measured and measured is not None
                    and predicted is not None and 0 < predicted < math.inf):
                # the analytic estimator priced a fresh leaf (correction-
                # scaled: divided back out) and the replay just measured
                # it; leaves with a schedule-internal comm term are skipped,
                # as the comm cannot be divided back out
                from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import (
                    seq_parallel_attention_comm_ms,
                )

                comm = seq_parallel_attention_comm_ms(
                    attrs, list(leaf.input_shapes), cost_estimator.machine_spec,
                    cost_estimator.intra_latency_ms, cost_estimator.inter_latency_ms,
                    machine_view=view)
                if comm == 0.0:
                    corr = corrections_at_pricing.get(type(attrs).__name__, 1.0)
                    raw = predicted / corr if corr > 0 else predicted
                    cost_store.note_analytic_parallel(attrs, list(leaf.input_shapes), raw,
                                                      analytic_sig=analytic_sig)
            ops.append({
                "name": name,
                "op_type": type(attrs).__name__,
                "predicted_ms": _round(predicted),
                "measured_ms": _round(measured),
                "ratio": _round(_ratio(measured, predicted)),
            })

    def log_dist(entry) -> float:
        r = entry.get("ratio")
        if r is None or r <= 0:
            return 0.0
        return abs(math.log(r))

    worst = sorted(ops, key=log_dist, reverse=True)[:top_n]
    op_ratios = [o["ratio"] for o in ops]
    edge_ratios = [e["ratio"] for e in edges if not e.get("fused")]
    summary = {
        "op_geomean_ratio": _round(_geomean(op_ratios)),
        "movement_geomean_ratio": _round(_geomean(edge_ratios)),
        "geomean_ratio": _round(_geomean(op_ratios + edge_ratios)),
        "worst_ops": [{"name": o["name"], "ratio": o["ratio"]}
                      for o in worst if o.get("ratio") is not None],
        "num_ops_measured": sum(1 for r in op_ratios if r is not None),
        "num_edges_measured": sum(1 for r in edge_ratios if r is not None),
        "num_fused_edges": sum(1 for e in edges if e.get("fused")),
    }
    return {
        "schema": AUDIT_SCHEMA_VERSION,
        "num_ops": len(ops),
        "num_movement_edges": len(edges),
        "movement_measured": can_measure_movement,
        "emulation_scale": _round(emulation_scale),
        "ops": ops,
        "movement_edges": edges,
        "summary": summary,
    }


def audit_by_class(audit: Dict[str, object]) -> Dict[str, Dict[str, object]]:
    """{op type: {geomean_ratio, ops}} over an audit's measured ops: which
    kind of leaf the cost model misprices, and by how much."""
    by: Dict[str, List[float]] = {}
    for o in audit.get("ops", []):
        by.setdefault(o["op_type"], []).append(o["ratio"])
    return {k: {"geomean_ratio": _round(_geomean(v)),
                "ops": sum(1 for r in v if r is not None)} for k, v in sorted(by.items())}
