"""Allowed machine-view enumeration (copy of
flexflow_tpu/compiler/allowed_machine_views.py; a "slice" of its
slice-aware views is a node here).

Reference: lib/compiler/src/compiler/allowed_machine_views.cc:24-120 —
candidate views = all stride vectors (bounded) x all start coordinates x all
INTER/INTRA projection assignments, filtered by the in-bounds check on the
task space's maximum coordinate. (The reference's stride bound divides by
zero when any task degree is 1; here degree-1 dims are pinned to stride 1.)
"""

from __future__ import annotations

import itertools
import math
from functools import lru_cache
from typing import FrozenSet

from flexflow_tpu_torch.pcg.machine_view import (
    DeviceType,
    MachineSpaceCoordinate,
    MachineSpecification,
    MachineView,
    MachineViewDimension,
    OperatorTaskSpace,
    ProjectionType,
    get_machine_space_coordinate,
)


def _max_stride_upper_bound(degrees, total_devices: int) -> int:
    nontrivial = [d - 1 for d in degrees if d > 1]
    if not nontrivial:
        return 1
    vol = 1
    for x in nontrivial:
        vol *= x
    return max(1, math.ceil(total_devices / vol))


def is_valid_machine_view(
    view: MachineView, task: OperatorTaskSpace, spec: MachineSpecification
) -> bool:
    """In-bounds check on the maximum task coordinate (reference
    allowed_machine_views.cc:24-31)."""
    max_coord = tuple(d - 1 for d in task.degrees)
    return get_machine_space_coordinate(task, view, max_coord, spec) is not None


@lru_cache(maxsize=4096)
def get_allowed_machine_views(
    spec: MachineSpecification,
    task: OperatorTaskSpace,
    device_type: DeviceType = DeviceType.GPU,
) -> FrozenSet[MachineView]:
    degrees = task.degrees
    n_dims = len(degrees)
    total_devices = spec.num_of_type(device_type)

    stride_bound = _max_stride_upper_bound(degrees, total_devices)
    stride_ranges = [
        range(1, 2) if d == 1 else range(1, stride_bound + 1) for d in degrees
    ]
    starts = [
        MachineSpaceCoordinate(ni, di, device_type)
        for ni in range(spec.num_nodes)
        for di in range(
            spec.num_devices_per_node
            if device_type == DeviceType.GPU
            else spec.num_cpus_per_node
        )
    ]
    projections = list(
        itertools.product(
            (ProjectionType.INTER_NODE, ProjectionType.INTRA_NODE), repeat=n_dims
        )
    )

    views = set()
    for strides in itertools.product(*stride_ranges):
        for start in starts:
            for projs in projections:
                view = MachineView(
                    start,
                    tuple(
                        MachineViewDimension(s, p)
                        for s, p in zip(strides, projs)
                    ),
                )
                if is_valid_machine_view(view, task, spec):
                    views.add(view)
    return frozenset(views)


@lru_cache(maxsize=4096)
def get_projection_representative_machine_views(
    spec: MachineSpecification,
    task: OperatorTaskSpace,
    device_type: DeviceType = DeviceType.GPU,
) -> FrozenSet[MachineView]:
    """One representative view per INTER/INTRA projection assignment.

    The cost models observe only each degree's projection axis: views
    differing in start or stride price identically. Enumerating them in the
    DP multiplies boundary assignments by the device count for zero
    cost-model resolution (the JAX package's DP hang on DLRM's
    many-embedding concat was exactly this product). Degree-1 dims are
    pinned INTRA so the trivially-serial leaf has exactly one view."""
    degrees = task.degrees
    per_node = (
        spec.num_devices_per_node
        if device_type == DeviceType.GPU
        else spec.num_cpus_per_node
    )
    choices = [
        ((ProjectionType.INTRA_NODE,) if d == 1
         else (ProjectionType.INTER_NODE, ProjectionType.INTRA_NODE))
        for d in degrees
    ]
    views = set()
    for projs in itertools.product(*choices):
        intra_extent = 1
        inter_extent = 1
        for d, p in zip(degrees, projs):
            if p == ProjectionType.INTRA_NODE:
                intra_extent *= d
            else:
                inter_extent *= d
        if intra_extent > per_node or inter_extent > spec.num_nodes:
            continue
        view = MachineView(
            MachineSpaceCoordinate(0, 0, device_type),
            tuple(MachineViewDimension(1, p) for p in projs),
        )
        if is_valid_machine_view(view, task, spec):
            views.add(view)
    return frozenset(views)


def get_slice_aware_machine_views(
    spec: MachineSpecification,
    task: OperatorTaskSpace,
    inter_allowed: tuple,
    device_type: DeviceType = DeviceType.GPU,
) -> FrozenSet[MachineView]:
    """Projection-representative views restricted to node-contiguous ones.

    `inter_allowed[i]` says whether task dim i may project INTER_NODE, that
    is stride across nodes over InfiniBand. Callers derive it from
    slice_axes.leaf_task_axis_kinds: tensor-sharded dims are pinned INTRA
    (their per-layer collectives must stay on the node's NVLink), data,
    replica and stage dims keep both choices. With every entry True this
    is get_projection_representative_machine_views; the two-level DP's
    outer level passes a mask that lets exactly one axis kind cross nodes
    per outer choice."""
    degrees = task.degrees
    if len(inter_allowed) != len(degrees):
        raise ValueError(
            f"inter_allowed arity {len(inter_allowed)} != task arity {len(degrees)}")
    per_node = (spec.num_devices_per_node if device_type == DeviceType.GPU
                else spec.num_cpus_per_node)
    choices = [
        ((ProjectionType.INTRA_NODE,) if (d == 1 or not ok)
         else (ProjectionType.INTER_NODE, ProjectionType.INTRA_NODE))
        for d, ok in zip(degrees, inter_allowed)
    ]
    views = set()
    for projs in itertools.product(*choices):
        intra_extent = 1
        inter_extent = 1
        for d, p in zip(degrees, projs):
            if p == ProjectionType.INTRA_NODE:
                intra_extent *= d
            else:
                inter_extent *= d
        if intra_extent > per_node or inter_extent > spec.num_nodes:
            continue
        view = MachineView(
            MachineSpaceCoordinate(0, 0, device_type),
            tuple(MachineViewDimension(1, p) for p in projs),
        )
        if is_valid_machine_view(view, task, spec):
            views.add(view)
    return frozenset(views)


@lru_cache(maxsize=4096)
def get_contiguous_machine_views(
    spec: MachineSpecification,
    task: OperatorTaskSpace,
    device_type: DeviceType = DeviceType.GPU,
) -> FrozenSet[MachineView]:
    """Pruned view set (the JAX get_tpu_contiguous_machine_views): stride-1
    views at task-size-aligned starts. Strided or unaligned device
    assignments only add collective hops, and enumerating them makes the
    DP's boundary-assignment product explode (the full enumeration is
    get_allowed_machine_views, kept for parity/tests). Aligned contiguous
    views keep the useful placement freedom: which node, and which aligned
    GPU block within it.
    """
    degrees = task.degrees
    n_dims = len(degrees)
    per_node = (
        spec.num_devices_per_node
        if device_type == DeviceType.GPU
        else spec.num_cpus_per_node
    )

    views = set()
    for projs in itertools.product(
        (ProjectionType.INTER_NODE, ProjectionType.INTRA_NODE), repeat=n_dims
    ):
        intra_extent = 1
        inter_extent = 1
        for d, p in zip(degrees, projs):
            if p == ProjectionType.INTRA_NODE:
                intra_extent *= d
            else:
                inter_extent *= d
        if intra_extent > per_node or inter_extent > spec.num_nodes:
            continue
        node_starts = (
            range(0, spec.num_nodes - inter_extent + 1, inter_extent)
            if inter_extent > 1
            else range(spec.num_nodes)
        )
        dev_starts = (
            range(0, per_node - intra_extent + 1, intra_extent)
            if intra_extent > 1
            else range(per_node)
        )
        for ni in node_starts:
            for di in dev_starts:
                view = MachineView(
                    MachineSpaceCoordinate(ni, di, device_type),
                    tuple(
                        MachineViewDimension(1, p) for p in projs
                    ),
                )
                if is_valid_machine_view(view, task, spec):
                    views.add(view)
    return frozenset(views)
