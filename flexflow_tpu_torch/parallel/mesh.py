"""The ranks of a process group as a mesh of prime-factor axes (copy of
the JAX package's MachineMesh.from_spec, for_devices and AxisPool,
flexflow_tpu/parallel/mesh.py:25-157, over process-group ranks).

A machine of `num_nodes` x `devices_per_node` becomes one axis per prime
factor of each level: 2 nodes of 4 cards give n0=2 (across nodes) and
d0=2, d1=2 (within a node). A parallel degree that divides a level is then
a tuple of axes, which is how the JAX package places every degree of a PCG
tensor without reshaping the mesh per op. Rank r of the base group sits at
the coordinates of r unravelled over the axes' sizes in the order
(n0, ..., d0, ...), as `np.asarray(devices).reshape(shape)` places devices.

Each rank is one process. A set of axes names, for each rank, the group of
ranks that differ from it only on those axes: the group a collective over
those axes runs in. `group(axes)` opens the groups of a set on first use;
torch.distributed requires every rank to open every group in the same
order, so the trainers open the sets they use at construction, in sorted
order (`open_groups`). Collectives over a set count themselves in `counts`.

`MachineMesh(dp, sp)` is the dp x sp mesh of the earlier trainers: one node
of dp * sp ranks, with `dp_index` and `sp_index` the rank's block of a
[b/dp, s/sp, ...] tensor and `ring()` the sequence-parallel ring.
"""

from __future__ import annotations

import collections
import math
from typing import Dict, FrozenSet, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels.ring_flash import SequenceRing
from flexflow_tpu_torch.parallel import census
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification

Axes = Tuple[str, ...]


def prime_factorization(n: int) -> List[int]:
    """Prime factors of n, largest first (as the JAX package orders them)."""
    if n < 1:
        raise ValueError(f"cannot factor {n}")
    factors: List[int] = []
    d = 2
    while d * d <= n:
        while n % d == 0:
            factors.append(d)
            n //= d
        d += 1
    if n > 1:
        factors.append(n)
    return sorted(factors, reverse=True)


def _spec_for(num_devices: int, num_nodes: int = 1) -> MachineSpecification:
    if num_devices % num_nodes:
        raise ValueError(f"{num_devices} devices do not divide over {num_nodes} nodes")
    return MachineSpecification(num_nodes=num_nodes, num_cpus_per_node=1,
                                num_devices_per_node=num_devices // num_nodes,
                                inter_node_bandwidth=25.0, intra_node_bandwidth=400.0)


class MeshAxes:
    """The prime-factor axes of a machine: node axes n0, ... (across nodes)
    and device axes d0, ... (within a node), each (name, size). What the
    axis assignment of parallel/sharding.py reads; MachineMesh adds the
    ranks."""

    def __init__(self, spec: MachineSpecification) -> None:
        self.spec = spec
        node_f = prime_factorization(spec.num_nodes)
        dev_f = prime_factorization(spec.num_devices_per_node)
        self.node_axes = tuple((f"n{i}", f) for i, f in enumerate(node_f))
        self.device_axes = tuple((f"d{i}", f) for i, f in enumerate(dev_f))
        if not self.node_axes and not self.device_axes:
            self.device_axes = (("d0", 1),)
        self.sizes: Dict[str, int] = dict(self.node_axes + self.device_axes)
        self.names: Axes = tuple(self.sizes)
        self.shape = tuple(self.sizes.values())

    @property
    def world_size(self) -> int:
        return math.prod(self.shape)

    def size(self, axes: Iterable[str]) -> int:
        return math.prod(self.sizes[a] for a in axes)


class MachineMesh(MeshAxes):
    """The prime-factor axes of a machine over the ranks of a process group."""

    def __init__(self, dp: int = 1, sp: int = 1, base_group=None,
                 spec: Optional[MachineSpecification] = None) -> None:
        """The dp x sp mesh on one node, or the mesh of `spec` (then dp is
        its device count and sp 1). base_group: the process group whose
        ranks the mesh arranges (None: the default group, which must be
        initialized); its size must be the mesh's."""
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group is initialized: open one first (e.g. parallel.init_file_group)"
            )
        dp_sp = spec is None
        if dp_sp:
            spec, what = _spec_for(dp * sp), f"{dp} x {sp}"
        else:
            dp, sp = spec.num_devices, 1
            what = f"{spec.num_nodes}-node x {spec.num_devices_per_node}-device"
        world = dist.get_world_size(base_group)
        if spec.num_devices != world:
            raise ValueError(f"a {what} mesh needs {spec.num_devices} ranks, the group has {world}")
        super().__init__(spec)
        self.dp, self.sp, self.group = dp, sp, base_group
        self.rank = dist.get_rank(base_group)
        self.coords = dict(zip(self.names, np.unravel_index(self.rank, self.shape)))
        self.backend = dist.get_backend(base_group)
        self._groups: Dict[FrozenSet[str], Tuple[object, List[int]]] = {}
        # collectives issued over this mesh, by kind ("all_reduce", "all_gather")
        self.counts: collections.Counter = collections.Counter()
        pool = AxisPool(self)
        self.dp_axes, self.sp_axes = pool.allocate(dp) or (), pool.allocate(sp) or ()
        # what the ranks along a set of axes are, where the mesh says it
        self.kinds: Dict[Axes, str] = {}
        if dp_sp:
            self.kinds = {self.sp_axes: "sequence-parallel", self.dp_axes: "data-parallel"}

    @staticmethod
    def from_spec(spec: MachineSpecification, base_group=None) -> "MachineMesh":
        return MachineMesh(spec=spec, base_group=base_group)

    @staticmethod
    def for_devices(n_devices: Optional[int] = None, num_nodes: int = 1,
                    base_group=None) -> "MachineMesh":
        """All ranks of the group (or the first n_devices: then the group
        must have that many) on num_nodes nodes."""
        n = n_devices if n_devices is not None else dist.get_world_size(base_group)
        return MachineMesh(spec=_spec_for(n, num_nodes), base_group=base_group)

    def index(self, axes: Iterable[str], rank: Optional[int] = None) -> int:
        """The piece index of `rank` (default this rank) along a dim sharded
        over `axes`: its coordinates in mixed radix, the first axis major,
        as the JAX package shards a dim over a tuple of axes."""
        coords = (self.coords if rank is None
                  else dict(zip(self.names, np.unravel_index(rank, self.shape))))
        i = 0
        for a in axes:
            i = i * self.sizes[a] + int(coords[a])
        return i

    @property
    def dp_index(self) -> int:
        return self.index(self.dp_axes)

    @property
    def sp_index(self) -> int:
        return self.index(self.sp_axes)

    def _global(self, r: int) -> int:
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def members(self, axes: Sequence[str], rank: Optional[int] = None) -> List[int]:
        """The mesh ranks that differ from `rank` only on `axes`, in piece
        order over `axes`."""
        rank = self.rank if rank is None else rank
        base = np.unravel_index(rank, self.shape)
        out = []
        for idx in np.ndindex(*[self.sizes[a] for a in axes]):
            c = list(base)
            for a, i in zip(axes, idx):
                c[self.names.index(a)] = i
            out.append(int(np.ravel_multi_index(c, self.shape)))
        return out

    def open_groups(self, axis_sets: Iterable[Iterable[str]]) -> None:
        """Open the groups of every set (sets of one rank need none), in
        sorted order, so every rank opens them alike."""
        for key in sorted({tuple(sorted(s)) for s in axis_sets}, key=lambda k: (len(k), k)):
            self.group_of(key)

    def group_of(self, axes: Iterable[str]):
        """(process group, this rank's peers as global ranks in piece order
        over `axes` as given) of the ranks that differ from this one only on
        `axes`; the group is None where it would be the whole base group."""
        axes = tuple(axes)
        key = frozenset(axes)
        if key not in self._groups:
            order = tuple(a for a in self.names if a in key)
            if self.size(order) == self.world_size:
                self._groups[key] = (self.group, None)
            else:
                # every rank opens every group of the partition
                mine = None
                seen = set()
                for r in range(self.world_size):
                    ranks = tuple(sorted(self.members(order, r)))
                    if ranks in seen:
                        continue
                    seen.add(ranks)
                    g = dist.new_group([self._global(x) for x in ranks], backend=self.backend)
                    if self.rank in ranks:
                        mine = g
                self._groups[key] = (mine, None)
        group = self._groups[key][0]
        return group, [self._global(r) for r in self.members(axes)]

    def all_gather(self, x: torch.Tensor, dim: int, axes: Sequence[str]) -> torch.Tensor:
        """The pieces of x over `axes`, concatenated along dim in piece
        order (a collective of the group of `axes`)."""
        group, peers = self.group_of(axes)
        x = x.contiguous()
        census.note("all-gather", census.tensor_bytes(x) * len(peers), len(peers))
        parts = [torch.empty_like(x) for _ in peers]
        dist.all_gather(parts, x, group=group)
        order = [p if group is None else dist.get_group_rank(group, p) for p in peers]
        return torch.cat([parts[i] for i in order], dim=dim)

    def ring_start(self, x: torch.Tensor, axes: Sequence[str]) -> "RingTransfer":
        """Start one step of the ring over `axes` (the ranks in piece order):
        send x to the next rank, receive the previous rank's tensor of x's
        shape and dtype; `.wait()` returns it. Counts itself as a
        "ring_step" in `counts`."""
        return RingTransfer(self, x, tuple(axes))

    def ring(self, axes: Optional[Sequence[str]] = None) -> SequenceRing:
        """The sequence-parallel ring over `axes` (default: the sp axes of
        the dp x sp mesh): this rank's place is its piece index."""
        axes = tuple(self.sp_axes if axes is None else axes)
        n = self.size(axes)
        if n == 1:
            return SequenceRing()
        group, peers = self.group_of(axes)
        return SequenceRing(n, self.index(axes), group, tuple(peers))


class RingTransfer:
    """One ring step in flight (MachineMesh.ring_start).

    NCCL takes it as device tensors: one batch_isend_irecv, on NCCL's own
    stream, which the caller's stream waits for. Gloo's send and recv are
    meant for host tensors: a CPU tensor goes as it is, and a card's
    tensor is staged through pinned host memory explicitly, copied out on
    a side stream as the step starts, sent and received on the host in
    `wait()`, and copied back on the side stream, which the caller's
    stream then waits for. Either way the caller's stream goes on with
    its own work (a chunk's matmul) meanwhile."""

    def __init__(self, mesh: MachineMesh, x: torch.Tensor, axes: Axes) -> None:
        group, peers = mesh.group_of(axes)
        n, i = len(peers), mesh.index(axes)
        self.group, self.next, self.prev = group, peers[(i + 1) % n], peers[(i - 1) % n]
        self.x = x.contiguous()
        self.out = torch.empty_like(self.x)
        self.staged = mesh.backend != "nccl" and self.x.device.type == "cuda"
        mesh.counts["ring_step"] += 1
        census.note("collective-permute", census.tensor_bytes(self.x), 2)
        if mesh.backend == "nccl":
            self.works = dist.batch_isend_irecv([
                dist.P2POp(dist.isend, self.x, self.next, group),
                dist.P2POp(dist.irecv, self.out, self.prev, group)])
        elif not self.staged:
            self.works = [dist.isend(self.x, self.next, group=group),
                          dist.irecv(self.out, self.prev, group=group)]
        else:
            self.stream = torch.cuda.Stream(self.x.device)
            self.stream.wait_stream(torch.cuda.current_stream(self.x.device))
            self.host = torch.empty(self.x.shape, dtype=self.x.dtype, pin_memory=True)
            self.host_in = torch.empty_like(self.host, pin_memory=True)
            with torch.cuda.stream(self.stream), census.transport():
                self.host.copy_(self.x, non_blocking=True)
                self.copied = torch.cuda.Event()
                self.copied.record(self.stream)

    def wait(self) -> torch.Tensor:
        """The tensor the previous rank sent, ready on the caller's stream."""
        if not self.staged:
            for w in self.works:
                w.wait()
            return self.out
        self.copied.synchronize()
        works = [dist.isend(self.host, self.next, group=self.group),
                 dist.irecv(self.host_in, self.prev, group=self.group)]
        for w in works:
            w.wait()
        current = torch.cuda.current_stream(self.x.device)
        with torch.cuda.stream(self.stream), census.transport():
            self.out.copy_(self.host_in, non_blocking=True)
        current.wait_stream(self.stream)
        self.out.record_stream(current)
        return self.out


class AxisPool:
    """Per-tensor allocator of mesh axes for parallel degrees (copy of the
    JAX package's). Axes go in a fixed order, so tensors with the same
    degree structure land on the same axes; allocation prefers the machine
    level asked for (within or across nodes) and falls back to the other."""

    def __init__(self, mm: MeshAxes) -> None:
        self._intra: List[Tuple[str, int]] = list(mm.device_axes)
        self._inter: List[Tuple[str, int]] = list(mm.node_axes)

    def _take(self, pool: List[Tuple[str, int]], degree: int) -> Optional[Axes]:
        remaining = degree
        got: List[str] = []
        for name, size in pool:
            if remaining == 1:
                break
            if remaining % size == 0:
                got.append(name)
                remaining //= size
        if remaining != 1:
            return None
        taken = set(got)
        pool[:] = [(a, s) for a, s in pool if a not in taken]
        return tuple(got)

    def allocate(self, degree: int, prefer_inter: bool = False) -> Optional[Axes]:
        """Axes whose sizes multiply to `degree`, or None if inexpressible."""
        if degree == 1:
            return ()
        pools = (self._inter, self._intra) if prefer_inter else (self._intra, self._inter)
        for pool in pools:
            axes = self._take(pool, degree)
            if axes is not None:
                return axes
        combined = list(pools[0]) + list(pools[1])
        axes = self._take(combined, degree)
        if axes is not None:
            consumed = set(axes)
            self._intra[:] = [(a, s) for a, s in self._intra if a not in consumed]
            self._inter[:] = [(a, s) for a, s in self._inter if a not in consumed]
            return axes
        return None
