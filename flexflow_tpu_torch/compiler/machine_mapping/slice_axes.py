"""Node-axis classification of machine-mapping leaves (copy of
flexflow_tpu/compiler/machine_mapping/slice_axes.py; the JAX package's
"slice", an ICI torus of chips joined to others over the DCN, is a node of
GPUs here, joined to others over InfiniBand).

The machine space is (node, GPU-in-node): INTER_NODE projections place task
dims across nodes, INTRA_NODE across a node's NVLink/NVSwitch
(pcg/machine_view.py). A placement is *node-legal* when no tensor-sharded
axis straddles nodes: tensor parallelism's per-layer collectives
(all-reduce/all-gather on every matmul) cannot amortize a link an order of
magnitude slower than NVLink, while data/replica gradient sync and pipeline
stage handoffs cross it once per step by design. Every leaf's task dims get
an axis KIND, and the bitmasks the DP shares:

    kind       meaning                                  may cross nodes?
    "data"     batch-dim sharding of an activation      yes
    "tensor"   weight/feature/sequence sharding or a    no
               partial-sum axis (per-layer collectives)
    "replica"  discard-copy replication                 yes
    "stage"    pipeline-stage boundary op               yes

Task dims follow task_space_from_shape order on the leaf's principal
output: nontrivial shard degrees in tensor-dim order, then the sum
degree, then the discard-copy degree. Shard dim 0 is the batch dim of an
activation ("data") — unless the leaf IS a weight or is fed exclusively
by weights, where dim 0 shards the parameter itself ("tensor").
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

from flexflow_tpu_torch.pcg.machine_view import MachineView, ProjectionType

# kinds whose stride pattern may cross nodes (the JAX package's name)
DCN_LEGAL_KINDS = frozenset({"data", "replica", "stage"})


@lru_cache(maxsize=None)
def _axis_kinds(shape, weighty: bool, stagey: bool) -> Tuple[str, ...]:
    if stagey:
        # stage boundary ops are layout-identity point-to-point handoffs;
        # every task dim of theirs is the node-crossing-legal stage axis
        n = sum(1 for d in shape.shard_degrees() if d > 1)
        n += 1 if shape.sum_degree > 1 else 0
        n += 1 if shape.discard_copy_degree > 1 else 0
        return tuple("stage" for _ in range(max(n, 1)))
    kinds = []
    for i, d in enumerate(shape.shard_degrees()):
        if d > 1:
            kinds.append("tensor" if (i > 0 or weighty) else "data")
    if shape.sum_degree > 1:
        kinds.append("tensor")  # partial sums drain through an all-reduce
    if shape.discard_copy_degree > 1:
        kinds.append("replica")
    if not kinds:
        kinds.append("replica")  # degree-1 task space: trivially legal
    return tuple(kinds)


def leaf_task_axis_kinds(leaf) -> Tuple[str, ...]:
    """Axis kind per task dim of `leaf` (task_space_from_shape order over
    its principal output shape). Length always equals the leaf's task-space
    arity (>= 1)."""
    from flexflow_tpu_torch.op_attrs.core import is_stage_op
    from flexflow_tpu_torch.op_attrs.ops import WeightAttrs

    if not leaf.output_shapes:
        return ("replica",)
    weighty = isinstance(leaf.op_attrs, WeightAttrs) or (
        bool(leaf.weight_inputs) and all(leaf.weight_inputs)
    )
    return _axis_kinds(
        leaf.output_shapes[0], weighty, is_stage_op(leaf.op_attrs)
    )


def axis_kinds_tensor_mask(kinds: Tuple[str, ...]) -> int:
    """Bit i set iff task dim i is tensor-sharded (must stay in a node)."""
    mask = 0
    for i, k in enumerate(kinds):
        if k not in DCN_LEGAL_KINDS:
            mask |= 1 << i
    return mask


def leaf_tensor_axis_mask(leaf) -> int:
    return axis_kinds_tensor_mask(leaf_task_axis_kinds(leaf))


def view_inter_axis_mask(view: MachineView) -> int:
    """Bit i set iff the view projects task dim i across nodes."""
    mask = 0
    for i, d in enumerate(view.dimensions):
        if d.projection == ProjectionType.INTER_NODE:
            mask |= 1 << i
    return mask


def view_is_slice_legal(leaf, view: MachineView) -> bool:
    """May this view place this leaf on a machine of several nodes? A pure
    bitmask AND, the test the JAX package's DPs apply."""
    return not (view_inter_axis_mask(view) & leaf_tensor_axis_mask(leaf))
