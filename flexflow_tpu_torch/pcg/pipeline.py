"""Pipeline-stage structure of a PCG (copy of flexflow_tpu/pcg/pipeline.py).

One home for everything every layer needs to agree on about a pipelined
PCG, so the search DP, the memory and communication analyses and the 1F1B
executor cannot drift:

- `analyze_pipeline(pcg)`: find the StagePartition/StageMerge ops, assign
  every region node to its stage, and report structural problems (the
  substance of the JAX package's PCG009/PCG010 verifier rules).
- `pipeline_contexts(pcg)`: node -> PipelineLeafContext for well-formed
  regions — the annotation `_leaf_key` attaches to machine-mapping leaves
  (bubble-fraction pricing, 1F1B activation-stash memory accounting).
- `insert_pipeline_stages(pcg, S, M)`: the seed constructor — cut a series
  chain into S balanced stages and insert the stage ops (what
  `enumerate_pipeline_seeds` builds `pp{S}m{M}` candidates from).
- `one_f_one_b_schedule(S, M)`: the static per-tick action table of the
  1F1B schedule (validated: T = 2(M+S-1) ticks, per-stage in-flight
  activations <= min(S-s, M), FIFO arrival buffers collision-free) that
  `parallel/pipeline.py` runs over a (stage x data) mesh of ranks with
  point-to-point transfers.

Cost model identities used everywhere:

    bubble fraction      b(S, M) = (S-1) / (S-1+M)
    leaf cost factor     f(S, M) = (M+S-1) / (M*S)
                                 = (1/S) * 1/(1-b)   — S-way stage
                         concurrency, stretched by the 1F1B bubble
    in-flight stash at stage s   min(S-s, M) microbatches
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.op_attrs.ops import (
    InputAttrs,
    StageMergeAttrs,
    StagePartitionAttrs,
    WeightAttrs,
)


@dataclass(frozen=True)
class PipelineLeafContext:
    """The pipeline annotation a machine-mapping leaf carries: which stage
    of an S-stage, M-microbatch region the op executes in. Frozen and
    hashable: it rides UnmappedOpCostEstimateKey and the hash-consed intern
    table."""

    num_stages: int
    num_microbatches: int
    stage: int


def pipeline_bubble_fraction(num_stages: int, num_microbatches: int) -> float:
    """1F1B pipeline bubble: (S-1)/(S-1+M) of the schedule is warm-up/drain
    idle time (T = 2(M+S-1) unit ticks, 2M of them productive per stage)."""
    s, m = max(num_stages, 1), max(num_microbatches, 1)
    return (s - 1) / (s - 1 + m)


def pipeline_leaf_factor(num_stages: int, num_microbatches: int) -> float:
    """Per-leaf cost multiplier for ops inside a pipeline region: the
    region's series-sum of full-batch leaf costs C becomes a step time of
    C * (M+S-1)/(M*S) under balanced 1F1B — 1/S stage concurrency times
    the 1/(1 - bubble) stretch. Both DPs multiply in-region compute leaves
    by exactly this (the JAX package's native DP through its per-key
    k_pipe table; the port's DP is the Python one)."""
    s, m = max(num_stages, 1), max(num_microbatches, 1)
    return (m + s - 1) / (m * s)


def stage_inflight_bound(num_stages: int, stage: int, num_microbatches: int) -> int:
    """1F1B's defining memory property: stage s holds at most
    min(S - s, M) in-flight microbatch activations."""
    return max(min(num_stages - stage, num_microbatches), 1)


@dataclass
class PipelineRegion:
    """The analyzed stage structure of one PCG (or why it is malformed)."""

    num_stages: int = 0
    num_microbatches: int = 0
    # StagePartition nodes ordered by stage_index (0 = region entry)
    partition_nodes: List = field(default_factory=list)
    merge_node: Optional[object] = None
    # region node -> stage index (stage ops included: SP_s and the ops it
    # feeds are stage s; the merge belongs to the last stage)
    stage_of: Dict = field(default_factory=dict)
    # structural problems, as (rule_id, message, node_idx) triples:
    # "PCG009" stage structure and contiguity, "PCG010" microbatch
    # divisibility
    issues: List[Tuple[str, str, Optional[int]]] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return self.num_stages > 0 and not self.issues

    def context_of(self, node) -> Optional[PipelineLeafContext]:
        s = self.stage_of.get(node)
        if s is None or not self.ok:
            return None
        return PipelineLeafContext(self.num_stages, self.num_microbatches, s)


def analyze_pipeline(pcg) -> Optional[PipelineRegion]:
    """Assign every node of the pipeline region to its stage and collect
    structural issues. Returns None when the PCG carries no stage ops."""
    sps = []
    merges = []
    for n in pcg.topological_ordering():
        attrs = pcg.op_attrs(n)
        if isinstance(attrs, StagePartitionAttrs):
            sps.append(n)
        elif isinstance(attrs, StageMergeAttrs):
            merges.append(n)
    if not sps and not merges:
        return None

    region = PipelineRegion()
    sm_pairs = {
        (pcg.op_attrs(n).num_stages, pcg.op_attrs(n).num_microbatches)
        for n in sps
    } | {
        (pcg.op_attrs(n).num_stages, pcg.op_attrs(n).num_microbatches)
        for n in merges
    }
    if len(sm_pairs) != 1:
        region.issues.append(
            (
                "PCG009",
                f"stage ops disagree on (num_stages, num_microbatches): "
                f"{sorted(sm_pairs)}",
                sps[0].idx if sps else merges[0].idx,
            )
        )
        return region
    (S, M), = sm_pairs
    region.num_stages, region.num_microbatches = S, M
    by_index: Dict[int, List] = {}
    for n in sps:
        by_index.setdefault(pcg.op_attrs(n).stage_index, []).append(n)
    for s in range(S):
        if len(by_index.get(s, [])) != 1:
            region.issues.append(
                (
                    "PCG009",
                    f"expected exactly one StagePartition with stage_index="
                    f"{s}, found {len(by_index.get(s, []))}",
                    None,
                )
            )
    extra = sorted(set(by_index) - set(range(S)))
    if extra:
        region.issues.append(
            ("PCG009", f"StagePartition stage_index out of range: {extra}",
             by_index[extra[0]][0].idx)
        )
    if len(merges) != 1:
        region.issues.append(
            ("PCG009",
             f"expected exactly one StageMerge, found {len(merges)}",
             merges[0].idx if merges else None)
        )
    if region.issues:
        return region
    region.partition_nodes = [by_index[s][0] for s in range(S)]
    region.merge_node = merges[0]

    # microbatch divisibility (PCG010): the region entry's batch dim must
    # split into M microbatches; with a batch shard degree dp, each shard's
    # rows must still split M ways
    entry = region.partition_nodes[0]
    ins = pcg.inputs_of(entry)
    if ins:
        shape = pcg.tensor_shape(ins[0])
        d0 = shape.shard_dim_at(0)
        local = d0.size // max(d0.degree, 1)
        if d0.size % max(M, 1) != 0 or local % max(M, 1) != 0:
            region.issues.append(
                (
                    "PCG010",
                    f"batch dim {d0.size} (degree {d0.degree}, "
                    f"{local}/device) is not divisible into "
                    f"{M} microbatches",
                    entry.idx,
                )
            )

    # forward stage labeling: SP_s outputs start stage s; every consumer of
    # a labeled value joins that stage; the merge ends the region. A node
    # fed from two DIFFERENT stages is the contiguity violation (PCG009).
    stage_of: Dict = {}
    sp_index = {n: pcg.op_attrs(n).stage_index for n in region.partition_nodes}
    for n in pcg.topological_ordering():
        attrs = pcg.op_attrs(n)
        if n in sp_index:
            s = sp_index[n]
            if s > 0:
                # an interior boundary must be fed from the previous stage
                src_stages = {
                    stage_of.get(v.node) for v in pcg.inputs_of(n)
                }
                if src_stages - {s - 1}:
                    region.issues.append(
                        (
                            "PCG009",
                            f"StagePartition(stage_index={s}) is fed from "
                            f"stage(s) {sorted(x for x in src_stages if x is not None)}"
                            f", expected stage {s - 1}",
                            n.idx,
                        )
                    )
            stage_of[n] = s
            continue
        if isinstance(attrs, StageMergeAttrs):
            src_stages = {
                stage_of.get(v.node) for v in pcg.inputs_of(n)
            }
            if src_stages - {S - 1}:
                region.issues.append(
                    (
                        "PCG009",
                        f"StageMerge is fed from stage(s) "
                        f"{sorted(x for x in src_stages if x is not None)}, "
                        f"expected the last stage {S - 1}",
                        n.idx,
                    )
                )
            stage_of[n] = S - 1
            continue
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            continue  # sources join their consumer's stage (pass below)
        in_stages = {
            stage_of[v.node]
            for v in pcg.inputs_of(n)
            # the region ENDS at the merge: its output's consumers (the
            # trailing reshard chain / loss side) are outside
            if v.node in stage_of and v.node is not region.merge_node
        }
        if not in_stages:
            continue  # outside (before) the region
        if len(in_stages) > 1:
            region.issues.append(
                (
                    "PCG009",
                    f"op is fed from stages {sorted(in_stages)}: each stage "
                    "must be a connected series region (insert the value "
                    "through the stage boundary instead of skipping it)",
                    n.idx,
                )
            )
        stage_of[n] = max(in_stages)

    # any compute op downstream of the merge must NOT also read from inside
    # the region (that would be a region escape); values leaving through
    # the merge lose their label, which is exactly the intended exit
    # backward pass: weights (and their pure wrapper chains) join the stage
    # of their consumers
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op

    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
        _from_weight,
    )

    for n in reversed(pcg.topological_ordering()):
        if n in stage_of:
            continue
        attrs = pcg.op_attrs(n)
        # ONLY parameter-side nodes join their consumer's stage: weights
        # and their pure reshard wrappers (the 1F1B executor stacks them
        # along the stage axis). Input-feed wrappers stay OUTSIDE the
        # region — the batch is staged once, not per stage.
        if isinstance(attrs, WeightAttrs):
            weight_side = True
        elif is_parallel_op(attrs) and len(pcg.inputs_of(n)) == 1:
            weight_side = all(
                _from_weight(pcg, v) for v in pcg.inputs_of(n)
            )
        else:
            continue
        if not weight_side:
            continue
        consumer_stages = set()
        all_in_region = True
        for o in pcg.outputs_of(n):
            for u in pcg.uses_of(o):
                if u.node in stage_of:
                    consumer_stages.add(stage_of[u.node])
                else:
                    all_in_region = False
        if all_in_region and len(consumer_stages) == 1:
            stage_of[n] = consumer_stages.pop()

    region.stage_of = stage_of
    # every stage must be non-empty (a declared stage with no compute is a
    # schedule slot that does nothing but stretch the pipeline)
    populated = {
        s
        for n, s in stage_of.items()
        if n not in sp_index and n is not region.merge_node
    }
    missing = sorted(set(range(S)) - populated)
    if missing:
        region.issues.append(
            ("PCG009", f"stage(s) {missing} contain no ops", None)
        )
    return region


def pipeline_contexts(pcg) -> Dict[object, PipelineLeafContext]:
    """node -> PipelineLeafContext for a well-formed pipelined PCG; empty
    for flat PCGs AND for malformed regions (the verifier reports those —
    pricing/memory must not act on a structure the executor would
    reject)."""
    region = analyze_pipeline(pcg)
    if region is None or not region.ok:
        return {}
    return {
        n: PipelineLeafContext(
            region.num_stages, region.num_microbatches, s
        )
        for n, s in region.stage_of.items()
    }


# ---------------------------------------------------------------------------
# Seed construction: cut a series chain into S stages
# ---------------------------------------------------------------------------


def _trunk_order(pcg) -> List:
    """Non-source compute nodes in topological order (the series trunk the
    stage cuts partition). Parallel wrappers ride with their consumers."""
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op, is_stage_op

    out = []
    for n in pcg.topological_ordering():
        attrs = pcg.op_attrs(n)
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            continue
        if is_parallel_op(attrs) or is_stage_op(attrs):
            continue
        out.append(n)
    return out


def insert_pipeline_stages(pcg, num_stages: int, num_microbatches: int):
    """Rebuild `pcg` with stage ops cut into its series trunk: the
    `pp{S}m{M}` seed constructor.

    The trunk's heavy ops are split into S contiguous groups of equal
    count; a cut is legal only where exactly ONE dataflow value crosses it
    (a series point — SP graphs with residual streams expose these at
    block boundaries). Raises ValueError when no balanced legal cut
    exists, when the batch does not divide into M microbatches, or when
    the PCG already carries stage ops."""
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op, is_stage_op
    from flexflow_tpu_torch.pcg.parallel_computation_graph import (
        ParallelComputationGraph,
        ParallelLayerAttrs,
        ParallelTensorAttrs,
    )

    S, M = int(num_stages), int(num_microbatches)
    if S < 2:
        raise ValueError(f"need at least 2 stages, got {S}")
    if M < 1:
        raise ValueError(f"need at least 1 microbatch, got {M}")
    for n in pcg.nodes:
        if is_stage_op(pcg.op_attrs(n)):
            raise ValueError("PCG already carries stage ops")

    trunk = _trunk_order(pcg)
    if len(trunk) < S:
        raise ValueError(
            f"only {len(trunk)} trunk ops for {S} stages"
        )
    if len(trunk) % S != 0:
        raise ValueError(
            f"{len(trunk)} trunk ops do not split into {S} equal stages"
        )
    per_stage = len(trunk) // S
    trunk_pos = {n: i for i, n in enumerate(trunk)}

    # entry value: the single data value the first trunk op consumes
    from flexflow_tpu_torch.local_execution.training_backing import (
        split_slot_values,
    )

    first = trunk[0]
    data_vals, _ = split_slot_values(
        pcg.op_attrs(first), pcg.inputs_of(first)
    )
    if len(data_vals) != 1:
        raise ValueError("pipeline entry op must have exactly one data input")
    entry_value = data_vals[0]
    shape0 = pcg.tensor_shape(entry_value)
    d0 = shape0.shard_dim_at(0)
    local = d0.size // max(d0.degree, 1)
    if d0.size % M or local % M:
        raise ValueError(
            f"batch dim {d0.size} (degree {d0.degree}) does not divide "
            f"into {M} microbatches"
        )

    # interior cut s sits on the single value crossing from trunk group
    # s-1 to group s; validate the series point
    cut_values = {}  # value -> stage_index of the boundary it becomes
    for s in range(1, S):
        left = set(trunk[: s * per_stage])
        right = set(trunk[s * per_stage:])
        crossing = set()
        for u in left:
            for o in pcg.outputs_of(u):
                for use in pcg.uses_of(o):
                    if use.node in right:
                        crossing.add(o)
        if len(crossing) != 1:
            raise ValueError(
                f"cut {s} is not a series point: {len(crossing)} values "
                "cross it"
            )
        cut_values[crossing.pop()] = s

    exit_value = None  # last trunk op's principal output
    for o in pcg.outputs_of(trunk[-1]):
        exit_value = o
        break

    out = ParallelComputationGraph()
    value_map: Dict = {}

    def wrap(v, attrs):
        shape = out.tensor_shape(v)
        _, (nv,) = out.add_node(
            ParallelLayerAttrs(attrs, None),
            [v],
            [ParallelTensorAttrs(shape)],
        )
        return nv

    for n in pcg.topological_ordering():
        la = pcg.layer_attrs(n)
        ins = [value_map[v] for v in pcg.inputs_of(n)]
        # the entry boundary wraps the first trunk op's data input
        if n is first:
            data_idx, _ = split_slot_values(
                la.attrs, list(range(len(ins)))
            )
            slot = data_idx[0]
            ins[slot] = wrap(
                ins[slot], StagePartitionAttrs(S, M, 0)
            )
        _, outs = out.add_node(
            la, ins, [pcg.tensor_attrs(o) for o in pcg.outputs_of(n)]
        )
        for old, new in zip(pcg.outputs_of(n), outs):
            v = new
            s = cut_values.get(old)
            if s is not None:
                v = wrap(v, StagePartitionAttrs(S, M, s))
            if old == exit_value:
                v = wrap(v, StageMergeAttrs(S, M))
            value_map[old] = v
    return out


# ---------------------------------------------------------------------------
# The 1F1B schedule
# ---------------------------------------------------------------------------


def sequential_microbatch_schedule(num_stages: int, num_microbatches: int):
    """The unpipelined reference schedule: one unit of work globally per
    tick — microbatch m runs its full forward chain stage 0..S-1, then its
    full backward chain S-1..0, before m+1 starts (classic gradient
    accumulation). T = 2*M*S ticks, zero overlap.

    Same action-table format (and the same one-tick transfer semantics)
    as `one_f_one_b_schedule`, so the 1F1B executor runs both schedules
    through one tick body: the pipelined step is bitwise equal to this
    reference by construction (identical per-unit programs, different tick
    tables)."""
    import numpy as np

    S, M = int(num_stages), int(num_microbatches)
    assert S >= 1 and M >= 1, (S, M)
    rows_f: List[List[int]] = []
    rows_b: List[List[int]] = []
    for m in range(M):
        for s in range(S):
            row = [-1] * S
            row[s] = m
            rows_f.append(row)
            rows_b.append([-1] * S)
        for s in reversed(range(S)):
            row = [-1] * S
            row[s] = m
            rows_f.append([-1] * S)
            rows_b.append(row)
    assert len(rows_f) == 2 * M * S
    return (
        np.asarray(rows_f, dtype=np.int32),
        np.asarray(rows_b, dtype=np.int32),
    )


def one_f_one_b_schedule(num_stages: int, num_microbatches: int):
    """Static 1F1B action table: (fwd, bwd) numpy int32 arrays of shape
    [T, S]; entry [t, s] is the microbatch stage s forwards (resp.
    backwards) at tick t, or -1 for none. One unit of work per stage per
    tick; a value produced at tick t is consumable downstream from tick
    t+1 (the point-to-point hop).

    Validated on construction: T == 2*(M+S-1); every stage does exactly M
    forwards and M backwards in microbatch order; dependencies respect the
    one-tick transfer; in-flight activations at stage s never exceed
    min(S-s, M); and the size-min(S,M) modular arrival buffers the
    executor uses are collision-free."""
    import numpy as np

    S, M = int(num_stages), int(num_microbatches)
    assert S >= 1 and M >= 1, (S, M)
    fwd_done = [dict() for _ in range(S)]  # stage -> {mb: tick}
    bwd_done = [dict() for _ in range(S)]
    next_fwd = [0] * S
    next_bwd = [0] * S
    rows_f: List[List[int]] = []
    rows_b: List[List[int]] = []
    t = 0
    max_ticks = 4 * (M + S) + 8  # generous safety net
    while any(next_bwd[s] < M for s in range(S)):
        assert t < max_ticks, f"1F1B schedule did not converge (S={S}, M={M})"
        row_f = [-1] * S
        row_b = [-1] * S
        for s in range(S):
            m_f, m_b = next_fwd[s], next_bwd[s]
            inflight = m_f - m_b
            # a forward is admitted only while the stage's in-flight stash
            # stays under min(S-s, M) — the 1F1B memory bound — and its
            # input arrived at least one tick ago; a ready backward always
            # takes priority (it is what frees a stash slot)
            can_fwd = (
                m_f < M
                and inflight < stage_inflight_bound(S, s, M)
                and (s == 0 or fwd_done[s - 1].get(m_f, t) < t)
            )
            ready_b = (
                bwd_done[s + 1].get(m_b, t) < t
                if s < S - 1
                else fwd_done[s].get(m_b, t) < t
            )
            can_bwd = m_b < M and ready_b and fwd_done[s].get(m_b, t) < t
            if can_bwd:
                row_b[s] = m_b
                bwd_done[s][m_b] = t
                next_bwd[s] += 1
            elif can_fwd:
                row_f[s] = m_f
                fwd_done[s][m_f] = t
                next_fwd[s] += 1
        rows_f.append(row_f)
        rows_b.append(row_b)
        t += 1

    T = len(rows_f)
    assert T == 2 * (M + S - 1), (T, S, M)
    B = max(min(S, M), 1)
    for s in range(S):
        assert sorted(fwd_done[s]) == list(range(M))
        assert sorted(bwd_done[s]) == list(range(M))
        # in-flight bound: between its forward and its backward a
        # microbatch's activation is stashed at this stage
        for tt in range(T):
            live = [
                m
                for m in range(M)
                if fwd_done[s][m] <= tt < bwd_done[s][m]
            ]
            assert len(live) <= stage_inflight_bound(S, s, M), (s, tt, live)
            # modular arrival-buffer collision freedom (executor contract)
            slots = [m % B for m in live]
            assert len(slots) == len(set(slots)), (s, tt, live, B)
    import numpy as np  # noqa: F811

    return (
        np.asarray(rows_f, dtype=np.int32),
        np.asarray(rows_b, dtype=np.int32),
    )
