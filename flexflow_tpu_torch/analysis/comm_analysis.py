"""Static communication verification of a (PCG, machine mapping) pair: the
recorded step's collective census cross-checked against the plan (the
port's copy of flexflow_tpu/analysis/comm_analysis.py, with its rule ids,
matcher and record shapes).

The search prices every movement edge; this pass checks that the
collectives the DP charged for are the collectives the step issues. The
JAX package reads them off the compiled HLO; the port records them: one
step of the plan's own executor runs under the recorder
(analysis/step_program.py), and every collective of the port's transport
notes its kind, bytes, group size and issuing PCG node
(parallel/census.py). `extract_collectives` turns that census into the
same `HloCollective` records the JAX parser yields, and the same budgeted
matcher assigns them to the plan's movement edges
(compiler/machine_mapping/movement_export.py): each edge exposes byte-sized
collective templates (gather-class, reduce-class, and the stage hops' p2p)
and a slack-scaled byte pool; each collective goes best-fit to a compatible
edge with pool left. What is left over is communication the search never
priced; a priced edge whose pool took nothing was not lowered.

Lowerings that differ from GSPMD's, each modeled the way the JAX pass
models its free lowerings:

- a gradient bucket is one all-reduce of several parameters' gradients;
  the census counts it once, as it runs, with its members' nodes and byte
  splits, and the matcher takes each member as a piece of its own (what
  GSPMD emits before its combiner), so each matches its own weight's
  templates;
- the loss and the metric sums are one small f32 all-reduce a step, below
  the bytes floor like GSPMD's scalar reductions;
- under gloo a card's tensor crosses pinned host memory around each
  collective: that is the backend's transport (`census.transport()`), not
  a host transfer of the program, and COMM004 does not see it.

The matcher's first pass prefers, for each priced edge, a collective the
census attributes to that edge's own node, before the closest in size (the
JAX pass has no node to read and takes the first of equal size, which can
hand an edge's all-gather to another edge whose templates also admit it).

Modeled free lowerings of the plan (exempt, reported with a note, never
errors): the trailing logit reshard chain the executor bypasses, host-feed
reshards (each rank is fed its rows), and weight-resident reshard chains
(no COMM002; their templates stay live for the per-step weight gathers and
gradient reductions).

Rule ids (catalogued in pcg_verify.PCG_RULE_CATALOG):

COMM001 unpredicted-collective  a collective above the bytes floor matches
                                no priced movement edge (error)
COMM002 movement-edge-dce       a priced movement edge issued no collective
                                at all: the search paid for communication
                                the program does not perform (error)
COMM003 bytes-band              a matched edge's bytes are outside the
                                acceptance band of its prediction (warning)
COMM004 host-transfer           a device-to-host read inside the step: a
                                `.item()`, `float(t)`, `.cpu()` or
                                `.tolist()` of a device tensor (error)
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.analysis.diagnostics import (
    Diagnostic,
    error,
    human_bytes as _human_bytes,
    warning,
)

COMM_RULE_IDS = ("COMM001", "COMM002", "COMM003", "COMM004")

# defaults shared by ffcheck --comm, FFModel.compile, and comm_audit
DEFAULT_BYTES_FLOOR = 4096
DEFAULT_SLACK = 2.5
DEFAULT_BAND = 4.0

COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "collective-permute",
    "all-to-all",
)

# census matching classes (movement_export.GATHER / REDUCE)
_GATHER_CLASS = frozenset({"all-gather", "all-to-all"})
_REDUCE_CLASS = frozenset({"all-reduce", "reduce-scatter"})
# a point-to-point hop: a routing hop inside either decomposition, and the
# stage transfers of a pipeline
_EITHER_CLASS = frozenset({"collective-permute"})

@dataclass
class HloCollective:
    """One collective (or host transfer) of the recorded step (the JAX
    package's record, whose fields the census fills)."""

    kind: str  # "all-gather", "all-reduce", ... or "host-transfer"
    name: str  # position in the census
    bytes: int  # per-device materialized result bytes
    group_size: int = 1  # participants (a point-to-point hop: 2)
    op_name: str = ""  # the issuing PCG node, when known
    source: str = ""
    target: str = ""  # the op of a host transfer
    # a bucket's members, (op_name, bytes) each: the matcher's pieces
    parts: Tuple[Tuple[str, int], ...] = ()

    def to_json(self) -> dict:
        d = {
            "kind": self.kind,
            "name": self.name,
            "bytes": int(self.bytes),
            "group_size": int(self.group_size),
        }
        if self.op_name:
            d["op_name"] = self.op_name
        if self.target:
            d["target"] = self.target
        if self.parts:
            d["parts"] = [[op, int(b)] for op, b in self.parts]
        return d

    def pieces(self) -> List["HloCollective"]:
        """What the matcher assigns: a bucket's members, else itself."""
        if not self.parts:
            return [self]
        return [HloCollective(kind=self.kind, name=f"{self.name}.{j}", bytes=int(b),
                              group_size=self.group_size, op_name=op)
                for j, (op, b) in enumerate(self.parts)]


def extract_collectives(program) -> List[HloCollective]:
    """The census of a recorded step (step_program.StepProgram) as
    collective records; its device-to-host reads as kind "host-transfer"."""
    def op(node) -> str:
        return "" if node is None else f"node {node}"

    out: List[HloCollective] = []
    for i, c in enumerate(program.collectives):
        out.append(HloCollective(
            kind=str(c["kind"]), name=f"c{i}", bytes=int(c["bytes"]),
            group_size=int(c["group_size"]), op_name=op(c.get("node")),
            parts=tuple((op(n), int(b)) for n, b in c.get("parts", ()))))
    for h in program.host_transfers:
        out.append(HloCollective(kind="host-transfer", name=str(h.get("name", "")),
                                 bytes=int(h.get("bytes", 0)), target=str(h.get("target", ""))))
    return out


def census_by_kind(
    collectives: Sequence[HloCollective],
) -> Dict[str, Dict[str, int]]:
    out: Dict[str, Dict[str, int]] = {}
    for c in collectives:
        e = out.setdefault(c.kind, {"count": 0, "bytes": 0})
        e["count"] += 1
        e["bytes"] += c.bytes
    return out


# ---------------------------------------------------------------------------
# cross-check: census vs priced movement edges
# ---------------------------------------------------------------------------


@dataclass
class EdgeMatch:
    """One movement edge's accounting after matching."""

    prediction: object  # MovementEdgePrediction
    pool_bytes: int = 0  # slack-scaled byte budget
    matched_bytes: int = 0
    matched_count: int = 0
    # calibration counter: assigned bytes accumulated only UNTIL the
    # prediction is satisfied — a priced k-way collective often lowers
    # as several pieces (per-projection grad reduces, permute+gather
    # chains), which should all count, while slack absorbed AFTER the
    # prediction is met (jvp replays, attention-internal reductions)
    # measures the matcher, not the byte model
    realized_bytes: int = 0
    exempt: Optional[str] = None  # "bypassed" / "host-feed" / None
    group: int = -1  # reshard-chain id (consecutive movement edges)

    def to_json(self) -> dict:
        d = self.prediction.to_json()
        d["matched_bytes"] = int(self.matched_bytes)
        d["matched_collectives"] = int(self.matched_count)
        d["realized_bytes"] = int(self.realized_bytes)
        d["exempt"] = self.exempt
        pb = d["predicted_bytes"]
        d["bytes_ratio"] = (
            round(self.realized_bytes / pb, 4)
            if pb and self.realized_bytes
            else None
        )
        return d


@dataclass
class CommAnalysis:
    collectives: List[HloCollective]
    edges: List[EdgeMatch]
    unmatched: List[HloCollective]
    host_transfers: List[HloCollective]
    bytes_floor: int = DEFAULT_BYTES_FLOOR
    slack: float = DEFAULT_SLACK
    band: float = DEFAULT_BAND
    # geomean of matched/predicted bytes over edges with both sides > 0
    bytes_geomean: Optional[float] = None
    extra: Dict[str, object] = field(default_factory=dict)


def _compatible(collective_kind: str, template_classes: frozenset) -> bool:
    from flexflow_tpu_torch.compiler.machine_mapping.movement_export import (
        GATHER,
        REDUCE,
    )

    if collective_kind in _EITHER_CLASS:
        # a permute is a routing hop inside gather/reduce decompositions
        # AND the sole realization of a p2p stage edge
        return bool(template_classes)
    if collective_kind in _GATHER_CLASS:
        return GATHER in template_classes
    if collective_kind in _REDUCE_CLASS:
        return REDUCE in template_classes
    return False


def trailing_reshard_nodes(pcg, logits=None) -> frozenset:
    """Node indices of the trailing reshard chains the executor bypasses:
    the loss consumes the pre-reshard value
    (`executor._pre_reshard_value`), and a sink nothing consumes is dead
    code, so these Combine/Repartition nodes are never run. Walks EVERY
    unconsumed non-weight output (multi-head models have several) plus
    any explicitly-given logit tensors (FFModel passes the instance's
    name-resolved logit, which may differ from the topological sink)."""
    from flexflow_tpu_torch.op_attrs.ops import WeightAttrs
    from flexflow_tpu_torch.parallel.executor import _pre_reshard_value

    sinks = list(logits or [])
    for n in pcg.topological_ordering():
        if isinstance(pcg.op_attrs(n), WeightAttrs):
            continue
        for o in pcg.outputs_of(n):
            if not pcg.uses_of(o) and o not in sinks:
                sinks.append(o)
    from flexflow_tpu_torch.op_attrs.ops import CombineAttrs, RepartitionAttrs

    bypassed = set()
    for sink in sinks:
        try:
            kept = _pre_reshard_value(pcg, sink)
        except (AssertionError, ValueError):
            continue
        t = sink
        while t != kept:
            bypassed.add(t.node.idx)
            (t,) = pcg.inputs_of(t.node)
        # `_pre_reshard_value` keeps a trailing class-dim Combine: the
        # loss consumes the combined logits, so its all-gather runs in the
        # step and is matched against the edge's prediction like any other
        # (GSPMD serves the JAX package's loss from the sharded operand and
        # elides it, which the JAX pass exempts)
    return frozenset(bypassed)


def cross_check_comm(
    predictions: Sequence,
    collectives: Sequence[HloCollective],
    bypassed_nodes: frozenset = frozenset(),
    bytes_floor: int = DEFAULT_BYTES_FLOOR,
    slack: float = DEFAULT_SLACK,
    band: float = DEFAULT_BAND,
) -> CommAnalysis:
    """Assign each recorded collective to a priced movement edge (budgeted
    best-fit pools — see module docstring) and compute the per-edge and
    aggregate accounting.

    Two passes: priced edges first claim ONE size-appropriate collective
    each (largest-need first), so a spurious COMM002 can never be caused
    by another edge's oversized pool absorbing this edge's lowering; the
    remaining collectives then distribute best-fit across all pools. A
    bucket is matched member by member (`HloCollective.pieces`)."""
    edges: List[EdgeMatch] = []
    for p in predictions:
        exempt = None
        if p.node_idx in bypassed_nodes:
            exempt = "bypassed"
        elif p.input_chain:
            exempt = "host-feed"
        pool = 0 if exempt else int(
            slack * sum(b for _, b in p.templates)
        )
        edges.append(EdgeMatch(prediction=p, pool_bytes=pool, exempt=exempt))

    # reshard chains: consecutive movement edges lower as ONE composed
    # resharding (and one exempt member makes the whole chain's lowering
    # host-realized/bypassed), so group membership is the COMM002 unit
    by_node = {e.prediction.node_idx: e for e in edges}
    group_of: Dict[int, int] = {}
    for e in edges:
        n = e.prediction.node_idx
        root = n
        seen = {n}
        while True:
            up = by_node[root].prediction.input_node_idx
            if up is None or up not in by_node or up in seen:
                break
            root = up
            seen.add(root)
        group_of[n] = group_of.get(root, root)
    for e in edges:
        e.group = group_of[e.prediction.node_idx]
    # microbatch collective-permute chains: a pipelined step's
    # 1F1B schedule lowers EVERY inter-stage edge through one ppermute
    # per tick — M repeats of microbatch-sized collective-permutes that
    # must claim against the stage edges' predictions jointly, exactly
    # like a composed reshard chain. All stage-boundary predictions of
    # the region therefore share ONE chain group (the COMM002 unit).
    stage_edges = [
        e
        for e in edges
        if e.prediction.kind in ("StagePartitionAttrs", "StageMergeAttrs")
    ]
    if stage_edges:
        rep = min(e.group for e in stage_edges)
        for e in stage_edges:
            e.group = rep
    # exemption propagates over the chain: a host-feed head means the
    # whole chain's forward is realized by the feed's device_put
    exempt_groups = {e.group: e.exempt for e in edges if e.exempt}
    for e in edges:
        if e.exempt is None and e.group in exempt_groups:
            e.exempt = exempt_groups[e.group]
            e.pool_bytes = 0

    host = [c for c in collectives if c.kind == "host-transfer"]
    real = [piece for c in collectives if c.kind != "host-transfer"
            for piece in c.pieces()]
    remaining = {id(e): e.pool_bytes for e in edges}
    assigned: set = set()

    def assign(c: HloCollective, e: EdgeMatch) -> None:
        assigned.add(id(c))
        remaining[id(e)] -= c.bytes
        if e.realized_bytes < e.prediction.predicted_bytes:
            e.realized_bytes += c.bytes
        e.matched_bytes += c.bytes
        e.matched_count += 1

    def compat(c: HloCollective, e: EdgeMatch) -> bool:
        return _compatible(
            c.kind, frozenset(cls for cls, _ in e.prediction.templates)
        )

    # pass 1: every priced edge claims its best single collective
    priced = sorted(
        (
            e
            for e in edges
            if not e.exempt and e.prediction.predicted_bytes >= bytes_floor
        ),
        key=lambda e: (-e.prediction.predicted_bytes, e.prediction.node_idx),
    )
    # the census names the node that issued each collective (HLO text does
    # not): every priced edge first claims one of its own node's
    for own in (True, False):
        for e in priced:
            if e.matched_count:
                continue
            want = e.prediction.predicted_bytes
            pick = None
            for c in real:
                if id(c) in assigned or c.bytes > remaining[id(e)]:
                    continue
                if c.bytes < bytes_floor or not compat(c, e):
                    continue
                if own and c.op_name != f"node {e.prediction.node_idx}":
                    continue
                # closest in log-size to the predicted bytes
                d = abs(math.log(max(c.bytes, 1) / max(want, 1)))
                if pick is None or d < pick[0]:
                    pick = (d, c)
            if pick is not None:
                assign(pick[1], e)

    # pass 2: distribute the rest best-fit over the remaining pools
    unmatched: List[HloCollective] = []
    for c in sorted(real, key=lambda c: -c.bytes):
        if id(c) in assigned:
            continue
        candidates = [
            e
            for e in edges
            if not e.exempt
            and remaining[id(e)] >= c.bytes
            and compat(c, e)
        ]
        if not candidates:
            unmatched.append(c)
            continue
        best = min(
            candidates,
            key=lambda e: (
                # needy pools first: an edge whose priced bytes are not
                # yet realized is the likelier owner of this piece than
                # an already-satisfied pool with slack left
                e.realized_bytes >= e.prediction.predicted_bytes,
                remaining[id(e)],
                e.prediction.node_idx,
            ),
        )
        assign(c, best)

    # the COMM003/geomean population: every edge the DP charged bytes
    # for whose priced collective found a primary realization — the
    # ratio compares the prediction against THAT collective's
    # materialized bytes (pass-2 absorption is slack accounting and
    # would measure the matcher, not the model)
    ratios = [
        e.realized_bytes / e.prediction.predicted_bytes
        for e in edges
        if not e.exempt
        and e.prediction.predicted_bytes >= bytes_floor
        and e.realized_bytes > 0
    ]
    geomean = (
        math.exp(sum(math.log(r) for r in ratios) / len(ratios))
        if ratios
        else None
    )
    return CommAnalysis(
        collectives=list(collectives),
        edges=edges,
        unmatched=unmatched,
        host_transfers=host,
        bytes_floor=int(bytes_floor),
        slack=float(slack),
        band=float(band),
        bytes_geomean=None if geomean is None else round(geomean, 4),
    )




def comm_diagnostics(analysis: CommAnalysis) -> List[Diagnostic]:
    """COMM001-COMM004 over a finished cross-check."""
    diags: List[Diagnostic] = []
    floor = analysis.bytes_floor

    # COMM001: unpredicted collectives above the bytes floor, aggregated
    # by (kind, bytes, op_name) so a replayed chain reads as one finding
    groups: Dict[Tuple[str, int, str], List[HloCollective]] = {}
    for c in analysis.unmatched:
        if c.bytes < floor:
            continue
        groups.setdefault((c.kind, c.bytes, c.op_name), []).append(c)
    for (kind, nbytes, op_name), cs in sorted(
        groups.items(), key=lambda kv: -kv[0][1]
    ):
        where = f" at {op_name}" if op_name else ""
        src = f" ({cs[0].source})" if cs[0].source else ""
        # group_size 0 is the replica_groups={} sentinel: all devices
        group = (
            f"group size {cs[0].group_size}"
            if cs[0].group_size else "group: all devices"
        )
        diags.append(
            error(
                "COMM001",
                f"{len(cs)} unpredicted {kind} of "
                f"{_human_bytes(nbytes)} each ({group}){where}{src}: "
                "the step reshards where the search priced no movement",
                tensor=cs[0].name,
                hint="the plan's shardings force a reshard no movement "
                "edge models — add the movement op the search should "
                "price, or fix the mapping that makes the executor replicate",
            )
        )

    # COMM002: a priced reshard CHAIN whose pools absorbed nothing.
    # Consecutive movement edges lower as one composed resharding, so the
    # chain is the unit — flagging each member separately would count one
    # missing collective several times.
    chains: Dict[int, List[EdgeMatch]] = {}
    for e in analysis.edges:
        chains.setdefault(e.group, []).append(e)
    for group, members in sorted(chains.items()):
        if any(e.exempt for e in members):
            continue
        if all(e.prediction.weight_resident for e in members):
            continue  # priced ~0 by design; templates only
        priced = sum(
            e.prediction.predicted_bytes
            for e in members
            if not e.prediction.weight_resident
        )
        priced_ms = sum(
            e.prediction.predicted_ms or 0.0
            for e in members
            if not e.prediction.weight_resident
        )
        if priced < floor or priced_ms <= 0:
            continue
        if any(e.matched_bytes > 0 for e in members):
            continue
        names = ", ".join(
            f"{e.prediction.name} ({e.prediction.kind}, degree "
            f"{e.prediction.degree})"
            for e in members
        )
        diags.append(
            error(
                "COMM002",
                f"movement edge chain [{names}] was priced "
                f"{priced_ms:.4f} ms for {_human_bytes(priced)} but "
                "lowered to no collective: the search overpaid for "
                "communication the program does not perform",
                node=members[0].prediction.node_idx,
                hint="the chain was DCE'd (value consumed pre-reshard or "
                "folded into an adjacent op) — the cost model should "
                "price it at zero for this consumer pattern",
            )
        )

    # COMM003: matched edges outside the per-edge acceptance band
    band = analysis.band
    for e in analysis.edges:
        p = e.prediction
        if e.exempt:
            continue  # same population as the geomean (see cross_check)
        if p.predicted_bytes < floor or e.realized_bytes <= 0:
            continue
        ratio = e.realized_bytes / p.predicted_bytes
        if ratio > band or ratio < 1.0 / band:
            diags.append(
                warning(
                    "COMM003",
                    f"movement edge {p.name} ({p.kind}) predicted "
                    f"{_human_bytes(p.predicted_bytes)} of collective "
                    f"traffic but its lowered realization stages "
                    f"{_human_bytes(e.realized_bytes)} "
                    f"({ratio:.2f}x, band {band:.1f}x)",
                    node=p.node_idx,
                    hint="the byte model for this edge kind drifted from "
                    "what the executor issues — recalibrate the movement "
                    "templates or investigate the lowering",
                )
            )

    # COMM004: host transfers inside the donated step program
    seen_targets = set()
    for c in analysis.host_transfers:
        key = (c.target, c.op_name)
        if key in seen_targets:
            continue
        seen_targets.add(key)
        diags.append(
            error(
                "COMM004",
                f"host transfer inside the step program: {c.target or c.kind}"
                + (f" at {c.op_name}" if c.op_name else "")
                + (f" ({c.source})" if c.source else ""),
                tensor=c.name,
                hint="a callback/infeed in the donated step serializes "
                "the device against the host every step — move it out "
                "of the jitted step (LINT001 finds the Python side)",
            )
        )
    return diags


def verify_comm(
    pcg,
    mapping: Optional[dict] = None,
    machine_spec=None,
    estimator=None,
    lowered=None,
    fused_edges: Optional[Dict[int, str]] = None,
    bytes_floor: int = DEFAULT_BYTES_FLOOR,
    slack: float = DEFAULT_SLACK,
    band: float = DEFAULT_BAND,
) -> Tuple[CommAnalysis, List[Diagnostic]]:
    """One-call driver: export the plan's movement predictions, record the
    plan's step (unless a recorded one is given as `lowered`) and
    cross-check. Returns (analysis, diagnostics)."""
    from flexflow_tpu_torch.compiler.machine_mapping.movement_export import (
        export_movement_predictions,
    )

    if estimator is None:
        from flexflow_tpu_torch.compiler import AnalyticGPUCostEstimator
        from flexflow_tpu_torch.pcg.machine_view import MachineSpecification

        spec = machine_spec or MachineSpecification(1, 1, 1, 25.0, 400.0)
        estimator = AnalyticGPUCostEstimator(spec, 989e12, 3350.0)
    predictions = export_movement_predictions(pcg, mapping, estimator, fused_edges=fused_edges)
    if lowered is None:
        from flexflow_tpu_torch.analysis.step_program import record_plan

        lowered = record_plan(pcg, mapping, machine_spec=machine_spec)
    analysis = cross_check_comm(
        predictions,
        extract_collectives(lowered),
        bypassed_nodes=trailing_reshard_nodes(pcg),
        bytes_floor=bytes_floor,
        slack=slack,
        band=band,
    )
    return analysis, comm_diagnostics(analysis)


# ---------------------------------------------------------------------------
# rendering (ffcheck --comm)
# ---------------------------------------------------------------------------


def format_comm_table(analysis: CommAnalysis) -> str:
    """Human-readable census + per-edge accounting (`ffcheck --comm`)."""
    lines = ["collective census:"]
    for kind, e in sorted(census_by_kind(analysis.collectives).items()):
        lines.append(
            f"  {kind:<20} x{e['count']:<4} {_human_bytes(e['bytes'])}"
        )
    if not analysis.collectives:
        lines.append("  (none)")
    lines.append(
        "edge    kind                 degree  predicted     lowered    note"
    )
    for e in analysis.edges:
        p = e.prediction
        note = e.exempt or (
            "weight-resident" if p.weight_resident else ""
        )
        if p.fused_kind:
            note = (note + " " if note else "") + f"fused:{p.fused_kind}"
        lines.append(
            f"{p.node_idx:>5}  {p.kind:<20} {p.degree:>6}  "
            f"{_human_bytes(p.predicted_bytes):>10}  "
            f"{_human_bytes(e.matched_bytes):>10}  {note}"
        )
    if analysis.unmatched:
        over = [
            c for c in analysis.unmatched if c.bytes >= analysis.bytes_floor
        ]
        lines.append(
            f"unmatched collectives: {len(analysis.unmatched)} "
            f"({len(over)} above the {_human_bytes(analysis.bytes_floor)} "
            "floor)"
        )
    if analysis.bytes_geomean is not None:
        lines.append(
            f"lowered/predicted bytes geomean: {analysis.bytes_geomean}"
        )
    return "\n".join(lines)


def comm_summary_json(analysis: CommAnalysis) -> dict:
    """The `ffcheck --comm --json` per-file summary object (one line per
    file, beside the per-diagnostic lines): stable schema v1 — the field
    tuple is pinned by tests/test_comm_analysis.py."""
    over_floor = [
        c for c in analysis.unmatched if c.bytes >= analysis.bytes_floor
    ]
    return {
        "comm": 1,  # schema version
        "bytes_floor": int(analysis.bytes_floor),
        "slack": analysis.slack,
        "band": analysis.band,
        "census": census_by_kind(analysis.collectives),
        "num_collectives": len(analysis.collectives),
        # buckets: collectives of several members (gradients), each member
        # matched on its own
        "buckets": sum(1 for c in analysis.collectives if c.parts),
        "bucket_members": sum(len(c.parts) for c in analysis.collectives),
        "num_edges": len(analysis.edges),
        "edges": [e.to_json() for e in analysis.edges],
        "matched_bytes_total": int(
            sum(e.matched_bytes for e in analysis.edges)
        ),
        "predicted_bytes_total": int(
            sum(
                e.prediction.predicted_bytes
                for e in analysis.edges
                if not e.exempt
            )
        ),
        "unmatched_collectives": len(over_floor),
        "unmatched_bytes": int(sum(c.bytes for c in over_floor)),
        "unmatched": [c.to_json() for c in over_floor[:20]],
        "host_transfers": len(analysis.host_transfers),
        "bytes_geomean": analysis.bytes_geomean,
    }
