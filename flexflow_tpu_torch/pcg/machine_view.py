"""MachineView / MachineSpecification / OperatorTaskSpace for GPU nodes
(copy of flexflow_tpu/pcg/machine_view.py).

Reference: lib/pcg/include/pcg/machine_view.struct.toml:23-29,
machine_view_dimension.struct.toml:18-24, machine_specification.struct.toml,
operator_task_space.struct.toml, and the coordinate mapping in
lib/pcg/src/pcg/machine_view.cc:44-103 (the machine-mapping DP depends on
these exact semantics).

The machine space is the reference's (node, GPU-in-node): INTRA_NODE
projections place tasks across the GPUs of a node (NVLink/NVSwitch);
INTER_NODE projections place tasks across nodes (InfiniBand).
inter/intra_node_bandwidth are those links' bandwidths, used by the comm
cost model.

A MachineView maps an operator's parallel task grid (OperatorTaskSpace, one
degree per parallel dim) into the machine grid: per task dim a stride and a
projection axis; dims sharing an axis nest block-wise via prefix products of
(degree * stride).
"""

from __future__ import annotations

import enum
import itertools
from dataclasses import dataclass

from flexflow_tpu_torch.utils.hashing import memoized_hash
from typing import List, Optional, Tuple


class DeviceType(enum.Enum):
    GPU = "gpu"
    CPU = "cpu"

    def __hash__(self) -> int:
        # hash as the JAX package's DeviceType does (by member name, GPU
        # being its TPU): frozensets of views then iterate, and the DP's
        # equal-cost views tie-break, identically in both packages
        return hash("TPU" if self is DeviceType.GPU else self.name)


class ProjectionType(enum.Enum):
    """Which machine axis a task dim projects onto
    (reference: MachineSpecificationDimension)."""

    INTER_NODE = "inter_node"  # across nodes (InfiniBand)
    INTRA_NODE = "intra_node"  # across the GPUs of a node (NVLink)


@memoized_hash
@dataclass(frozen=True)
class MachineSpecification:
    """reference: machine_specification.struct.toml:12-31.

    Bandwidths in GB/s per GPU and direction: inter = InfiniBand across
    nodes, intra = NVLink/NVSwitch within a node.
    """

    num_nodes: int
    num_cpus_per_node: int
    num_devices_per_node: int
    inter_node_bandwidth: float
    intra_node_bandwidth: float

    @property
    def num_devices(self) -> int:
        return self.num_nodes * self.num_devices_per_node

    def num_of_type(self, device_type: DeviceType) -> int:
        per_node = (
            self.num_devices_per_node
            if device_type == DeviceType.GPU
            else self.num_cpus_per_node
        )
        return self.num_nodes * per_node


@memoized_hash
@dataclass(frozen=True)
class MachineSpaceCoordinate:
    node_idx: int
    device_idx: int
    device_type: DeviceType = DeviceType.GPU


@memoized_hash
@dataclass(frozen=True)
class MachineViewDimension:
    stride: int
    projection: ProjectionType


@memoized_hash
@dataclass(frozen=True)
class MachineView:
    start: MachineSpaceCoordinate
    dimensions: Tuple[MachineViewDimension, ...]

    @property
    def num_dims(self) -> int:
        return len(self.dimensions)

    def strides(self) -> Tuple[int, ...]:
        return tuple(d.stride for d in self.dimensions)

    def projections(self) -> Tuple[ProjectionType, ...]:
        return tuple(d.projection for d in self.dimensions)


@memoized_hash
@dataclass(frozen=True)
class OperatorTaskSpace:
    """Degrees of an operator's parallel task grid
    (reference: operator_task_space.struct.toml:22-24)."""

    degrees: Tuple[int, ...]

    @property
    def num_tasks(self) -> int:
        n = 1
        for d in self.degrees:
            n *= d
        return n

    def coordinates(self) -> List[Tuple[int, ...]]:
        return list(itertools.product(*[range(d) for d in self.degrees]))


def is_valid_machine_space_coordinate(
    spec: MachineSpecification, c: MachineSpaceCoordinate
) -> bool:
    per_node = (
        spec.num_devices_per_node
        if c.device_type == DeviceType.GPU
        else spec.num_cpus_per_node
    )
    return 0 <= c.node_idx < spec.num_nodes and 0 <= c.device_idx < per_node


def get_machine_space_coordinate(
    task: OperatorTaskSpace,
    view: MachineView,
    coord: Tuple[int, ...],
    spec: MachineSpecification,
) -> Optional[MachineSpaceCoordinate]:
    """Faithful port of reference machine_view.cc:44-103."""
    assert len(coord) == view.num_dims == len(task.degrees)

    def compute_index(start_idx: int, axis: ProjectionType) -> int:
        idxs = [i for i, d in enumerate(view.dimensions) if d.projection == axis]
        sizes = [task.degrees[i] * view.dimensions[i].stride for i in idxs]
        # coeffs = scanl(sizes, 1, *): prefix products, coeff_0 = 1
        coeffs = [1]
        for s in sizes[:-1]:
            coeffs.append(coeffs[-1] * s)
        index = start_idx
        for c_, i in zip(coeffs, idxs):
            index += c_ * coord[i] * view.dimensions[i].stride
        return index

    node_idx = compute_index(view.start.node_idx, ProjectionType.INTER_NODE)
    device_idx = compute_index(view.start.device_idx, ProjectionType.INTRA_NODE)
    ms = MachineSpaceCoordinate(node_idx, device_idx, view.start.device_type)
    if not is_valid_machine_space_coordinate(spec, ms):
        return None
    return ms


def get_machine_space_coordinates(
    task: OperatorTaskSpace, view: MachineView, spec: MachineSpecification
) -> List[MachineSpaceCoordinate]:
    out = []
    for coord in task.coordinates():
        ms = get_machine_space_coordinate(task, view, coord, spec)
        assert ms is not None, f"task coord {coord} falls outside the machine"
        out.append(ms)
    return out


def machine_view_is_valid(
    task: OperatorTaskSpace, view: MachineView, spec: MachineSpecification
) -> bool:
    """In-bounds (reference allowed_machine_views.cc filter) + injective."""
    if view.num_dims != len(task.degrees):
        return False
    seen = set()
    for coord in task.coordinates():
        ms = get_machine_space_coordinate(task, view, coord, spec)
        if ms is None or ms in seen:
            return False
        seen.add(ms)
    return True


def device_id_of(spec: MachineSpecification, c: MachineSpaceCoordinate) -> int:
    """Flat device id: node-major (reference: device_id.h)."""
    return c.node_idx * spec.num_devices_per_node + c.device_idx


def get_device_ids(
    task: OperatorTaskSpace, view: MachineView, spec: MachineSpecification
) -> List[int]:
    """Flat device ids in task-coordinate order (row-major over degrees)."""
    return [
        device_id_of(spec, ms)
        for ms in get_machine_space_coordinates(task, view, spec)
    ]


def get_basic_data_parallel_machine_view(
    spec: MachineSpecification, degree: int
) -> MachineView:
    """The DP-fallback view (reference: lib/runtime/src/model.h:38-40):
    a 1-D task space of `degree` spread over a node's GPUs first.
    """
    if degree <= spec.num_devices_per_node:
        return MachineView(
            MachineSpaceCoordinate(0, 0),
            (MachineViewDimension(1, ProjectionType.INTRA_NODE),),
        )
    assert degree % spec.num_devices_per_node == 0 and degree <= spec.num_devices, (
        f"data-parallel degree {degree} does not fit machine {spec}"
    )
    # 2-D factorization: (nodes, GPUs) — callers with a 1-D task space of
    # full-machine degree should use get_basic_data_parallel_machine_view_2d.
    raise ValueError(
        "1-D task space cannot span both machine axes; factor the degree as "
        f"({degree // spec.num_devices_per_node} x {spec.num_devices_per_node}) "
        "and use a 2-D task space"
    )
