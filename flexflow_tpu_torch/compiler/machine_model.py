"""Machine models for analytic communication cost, Unity cost model v1
(copy of flexflow_tpu/compiler/machine_model.py, with its TPU reading
turned into the card's).

Reference: lib/runtime/src/simulator.h:161-714 — `SimpleMachineModel` (flat
intra/inter bandwidths), `EnhancedMachineModel` (sockets, NIC in/out ports,
congestion, segment pipelining), `NetworkedMachineModel` (explicit topology
graph + routing + topology generators), selected by `machine_model_version`
/ `machine_model_file` (config.h:97-99).

GPU reading: "intra-node" links are NVLink through the node's NVSwitch,
"inter-node" is InfiniBand between nodes. The enhanced model
(`EnhancedGPUMachineModel`, the JAX package's EnhancedTPUMachineModel)
routes a transfer within a node through the switch, over the sender's
uplink and the receiver's downlink (each `H100_NVLINK_GBPS` per GPU), and
across nodes out of one of a bounded number of NIC ports per node, over the
fabric and into the same port of the receiving node (each port
`NDR_INFINIBAND_GBPS`). Congestion is modeled by accumulating per-link byte
loads and taking the bottleneck link's time.

The version-1 file keeps the JAX package's format: `ici_link_gbps` is the
per-GPU NVLink rate, `dcn_link_gbps` the per-port InfiniBand rate,
`ici_latency_ms`/`dcn_latency_ms` the two link latencies (the names
`nvlink_gbps`, `ib_gbps`, `intra_latency_ms` and `inter_latency_ms` are
read as well); `ici_dims` describes a torus, which a switched node does not
have, and raises.
"""

from __future__ import annotations

import abc
import itertools
import json
from dataclasses import dataclass, field
from math import prod
from typing import Dict, List, Optional, Sequence, Tuple

from flexflow_tpu_torch.pcg.machine_view import (
    MachineSpecification,
    MachineView,
    OperatorTaskSpace,
    get_device_ids,
)

DEFAULT_INTRA_LATENCY_MS = 0.001
DEFAULT_INTER_LATENCY_MS = 0.01


@dataclass(frozen=True)
class CommLink:
    """A directed link in the machine network (reference: CommDevice in
    simulator.h — its MEMBUS/UPI/NIC/NVLINK kinds)."""

    kind: str  # "nvlink_up" | "nvlink_down" | "nvlink" | "ib" | "nic_out" | "nic_in" | "switch"
    src: int  # flat endpoint id (device id, node id or port id)
    dst: int
    bandwidth_gbps: float
    latency_ms: float


class MachineModel(abc.ABC):
    """reference: MachineModel base (simulator.h:161) — get_comm_path +
    congestion-aware transfer estimation."""

    @abc.abstractmethod
    def get_comm_path(self, src_dev: int, dst_dev: int) -> List[CommLink]:
        """The sequence of links a transfer src_dev -> dst_dev traverses."""

    def estimate_xfer_cost(
        self, nbytes: float, transfers: Sequence[Tuple[int, int]]
    ) -> float:
        """Makespan (ms) of `transfers` (each moving nbytes) running
        concurrently: per-link loads accumulate; the answer is the bottleneck
        link's busy time plus the longest path's latency fill (the analytic
        stand-in for the reference's segment-pipelined simulation)."""
        loads: Dict[CommLink, float] = {}
        max_path_latency = 0.0
        for s, d in transfers:
            if s == d:
                continue
            path = self.get_comm_path(s, d)
            if not path:
                continue
            for link in path:
                loads[link] = loads.get(link, 0.0) + nbytes
            max_path_latency = max(max_path_latency, sum(l.latency_ms for l in path))
        if not loads:
            return 0.0
        bottleneck = max(load / (l.bandwidth_gbps * 1e6) for l, load in loads.items())
        return max_path_latency + bottleneck


class SimpleMachineModel(MachineModel):
    """Flat intra/inter bandwidths (reference: SimpleMachineModel,
    simulator.h:228-330): one logical NVLink link per same-node pair, one
    logical InfiniBand link per node pair."""

    def __init__(
        self,
        spec: MachineSpecification,
        intra_latency_ms: float = DEFAULT_INTRA_LATENCY_MS,
        inter_latency_ms: float = DEFAULT_INTER_LATENCY_MS,
    ) -> None:
        self.spec = spec
        self.intra_latency_ms = intra_latency_ms
        self.inter_latency_ms = inter_latency_ms

    def node_of(self, dev: int) -> int:
        return dev // self.spec.num_devices_per_node

    def get_comm_path(self, src_dev: int, dst_dev: int) -> List[CommLink]:
        if src_dev == dst_dev:
            return []
        a, b = self.node_of(src_dev), self.node_of(dst_dev)
        if a == b:
            return [CommLink("nvlink", src_dev, dst_dev, self.spec.intra_node_bandwidth,
                             self.intra_latency_ms)]
        return [CommLink("ib", a, b, self.spec.inter_node_bandwidth, self.inter_latency_ms)]


class EnhancedGPUMachineModel(MachineModel):
    """Topology-aware model of GPU nodes (reference: EnhancedMachineModel,
    simulator.h:330-460, its NIC ports and congestion):

    - within a node the GPUs hang off an NVSwitch: a transfer rides the
      sender's uplink and the receiver's downlink, each `nvlink_gbps` (the
      switch itself does not block), so one GPU sending to many peers
      shares its uplink;
    - across nodes a transfer leaves through one of the node's
      `nic_ports_per_node` InfiniBand ports (chosen by hashing the pair,
      as the JAX package's model does), crosses the fabric and enters the
      receiving node through the same port; concurrent transfers through
      one port share its `ib_gbps`.
    """

    def __init__(
        self,
        spec: MachineSpecification,
        nvlink_gbps: Optional[float] = None,
        ib_gbps: Optional[float] = None,
        nic_ports_per_node: int = 4,
        intra_latency_ms: float = DEFAULT_INTRA_LATENCY_MS,
        inter_latency_ms: float = DEFAULT_INTER_LATENCY_MS,
    ) -> None:
        from flexflow_tpu_torch.compiler.calibration import (
            H100_NVLINK_GBPS,
            NDR_INFINIBAND_GBPS,
        )

        self.spec = spec
        self.nvlink_gbps = nvlink_gbps or H100_NVLINK_GBPS
        self.ib_gbps = ib_gbps or NDR_INFINIBAND_GBPS
        self.nic_ports = max(int(nic_ports_per_node), 1)
        self.intra_latency_ms = intra_latency_ms
        self.inter_latency_ms = inter_latency_ms

    def node_of(self, dev: int) -> int:
        return dev // self.spec.num_devices_per_node

    def port_of(self, src_dev: int, dst_dev: int) -> int:
        return (src_dev + dst_dev) % self.nic_ports

    def get_comm_path(self, src_dev: int, dst_dev: int) -> List[CommLink]:
        if src_dev == dst_dev:
            return []
        sn, dn = self.node_of(src_dev), self.node_of(dst_dev)
        if sn == dn:
            return [
                CommLink("nvlink_up", src_dev, -1, self.nvlink_gbps, self.intra_latency_ms),
                CommLink("nvlink_down", -1, dst_dev, self.nvlink_gbps, 0.0),
            ]
        port = self.port_of(src_dev, dst_dev)
        out_port = sn * self.nic_ports + port
        in_port = dn * self.nic_ports + port
        return [
            CommLink("nic_out", out_port, -1, self.ib_gbps, 0.0),
            CommLink("ib", out_port, in_port, self.ib_gbps, self.inter_latency_ms),
            CommLink("nic_in", -1, in_port, self.ib_gbps, 0.0),
        ]


class NetworkedMachineModel(MachineModel):
    """Explicit topology + routing (reference: NetworkedMachineModel with
    routing strategies & topology generators, simulator.h:464-556). The
    topology is a dict of directed links between flat device ids; routing is
    shortest-path (hop count, then latency) computed on demand."""

    def __init__(self, num_devices: int, links: Dict[Tuple[int, int], CommLink]) -> None:
        self.num_devices = num_devices
        self.links = links
        self._adj: Dict[int, List[int]] = {}
        for (a, b) in links:
            self._adj.setdefault(a, []).append(b)
        self._route_cache: Dict[Tuple[int, int], List[CommLink]] = {}

    def get_comm_path(self, src_dev: int, dst_dev: int) -> List[CommLink]:
        if src_dev == dst_dev:
            return []
        key = (src_dev, dst_dev)
        if key in self._route_cache:
            return self._route_cache[key]
        # BFS shortest path (deterministic: neighbors in sorted order)
        prev: Dict[int, int] = {src_dev: src_dev}
        frontier = [src_dev]
        while frontier and dst_dev not in prev:
            nxt = []
            for u in frontier:
                for v in sorted(self._adj.get(u, [])):
                    if v not in prev:
                        prev[v] = u
                        nxt.append(v)
            frontier = nxt
        if dst_dev not in prev:
            self._route_cache[key] = []
            return []
        hops: List[CommLink] = []
        cur = dst_dev
        while cur != src_dev:
            p = prev[cur]
            hops.append(self.links[(p, cur)])
            cur = p
        hops.reverse()
        self._route_cache[key] = hops
        return hops


# -- topology generators (reference: simulator.h topology generators) --------


def _near_square_factorization(n: int, max_dims: int = 3) -> Tuple[int, ...]:
    """Factor a device count into a balanced torus shape of up to
    `max_dims` axes (8 -> (2, 2, 2), 16 -> (2, 2, 4), 64 -> (4, 4, 4))."""
    if n <= 1:
        return (1,)
    dims: List[int] = []
    rem = n
    for k in range(max_dims, 1, -1):
        target = round(rem ** (1.0 / k))
        f = min((d for d in range(1, rem + 1) if rem % d == 0),
                key=lambda d: (abs(d - target), d))
        if f > 1:
            dims.append(f)
            rem //= f
    if rem > 1:
        dims.append(rem)
    return tuple(sorted(dims)) if dims else (1,)


def torus_topology(dims: Sequence[int], link_gbps: float, latency_ms: float = 0.001
                   ) -> Dict[Tuple[int, int], CommLink]:
    """N-dim torus over prod(dims) devices; bidirectional wraparound links."""
    links: Dict[Tuple[int, int], CommLink] = {}

    def flat(coord):
        x = 0
        for c, d in zip(coord, dims):
            x = x * d + c
        return x

    for coord in itertools.product(*[range(d) for d in dims]):
        for ax, size in enumerate(dims):
            if size < 2:
                continue
            nxt = list(coord)
            nxt[ax] = (coord[ax] + 1) % size
            a, b = flat(coord), flat(tuple(nxt))
            links[(a, b)] = CommLink("nvlink", a, b, link_gbps, latency_ms)
            links[(b, a)] = CommLink("nvlink", b, a, link_gbps, latency_ms)
    return links


def big_switch_topology(n: int, link_gbps: float, latency_ms: float = 0.005
                        ) -> Dict[Tuple[int, int], CommLink]:
    """Every device pair connected through a central switch: modeled as a
    direct link per ordered pair sharing the per-device bandwidth."""
    links: Dict[Tuple[int, int], CommLink] = {}
    for a in range(n):
        for b in range(n):
            if a != b:
                links[(a, b)] = CommLink("switch", a, b, link_gbps, latency_ms)
    return links


# -- movement-cost adapter + config selection ---------------------------------


@dataclass(frozen=True)
class MachineModelCommModel:
    """Adapts a MachineModel to the movement-cost interface of the cost
    estimators (drop-in for BandwidthCommModel): concretizes each view's
    device set via the moved tensor's task space, pairs sources with
    destinations round-robin, and asks the model for the congested makespan.
    Each movement is priced once: the DP asks for the same boundary
    movement under every constraint of the enclosing splits."""

    spec: MachineSpecification
    model: MachineModel
    _priced: Dict = field(default_factory=dict, init=False, repr=False, compare=False,
                          hash=False)

    def movement_cost_ms(self, movement) -> float:
        cost = self._priced.get(movement)
        if cost is None:
            cost = self._priced[movement] = self._movement_cost_ms(movement)
        return cost

    def _movement_cost_ms(self, movement) -> float:
        from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
            task_space_from_shape,
        )
        from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_piece_shape

        total = 0.0
        for m in movement.movements:
            if m.src_views == m.dst_views:
                continue
            task = task_space_from_shape(m.shape)
            piece_bytes = get_piece_shape(m.shape).size_bytes
            src_devs = self._devices(task, m.src_views)
            transfers: List[Tuple[int, int]] = []
            # MachineView defines no ordering; repr gives a deterministic one
            for dv in sorted(m.dst_views, key=repr):
                for i, d in enumerate(self._devices_of_view(task, dv)):
                    s = src_devs[i % len(src_devs)] if src_devs else d
                    transfers.append((s, d))
            total += self.model.estimate_xfer_cost(piece_bytes, transfers)
        return total

    def overlap_ramp_ms(self, serial_ms: float, chunks: int) -> float:
        """Overlapped-cost entry of the movement table (drop-in for
        BandwidthCommModel.overlap_ramp_ms): the congested-makespan serial
        cost chunked over a ring, first chunk exposed, one NVLink latency
        per remaining step."""
        k = max(chunks, 1)
        lat = getattr(self.model, "intra_latency_ms", DEFAULT_INTRA_LATENCY_MS)
        return serial_ms / k + (k - 1) * lat

    def _devices(self, task: OperatorTaskSpace, views) -> List[int]:
        out: List[int] = []
        for v in sorted(views, key=repr):
            out.extend(self._devices_of_view(task, v))
        return out

    def _devices_of_view(self, task: OperatorTaskSpace, view: MachineView) -> List[int]:
        if view.num_dims != len(task.degrees):
            # degenerate/mismatched: the view's start device
            return [view.start.node_idx * self.spec.num_devices_per_node
                    + view.start.device_idx]
        try:
            return get_device_ids(task, view, self.spec)
        except AssertionError:
            return [view.start.node_idx * self.spec.num_devices_per_node
                    + view.start.device_idx]


def _param(params: Dict, names: Sequence[str], default):
    for n in names:
        if n in params:
            return params[n]
    return default


def machine_model_from_config(
    spec: MachineSpecification,
    version: int = 0,
    config_file: str = "",
) -> MachineModel:
    """reference: machine_model_version/machine_model_file (config.h:97-99,
    src/machine_model.cc): version 0 = Simple, 1 = Enhanced (parameters from
    a JSON file when given), 2 = Networked from an explicit topology file."""
    params: Dict = {}
    if config_file:
        with open(config_file) as f:
            params = json.load(f)
    intra_lat = _param(params, ("intra_latency_ms", "ici_latency_ms"), DEFAULT_INTRA_LATENCY_MS)
    inter_lat = _param(params, ("inter_latency_ms", "dcn_latency_ms"), DEFAULT_INTER_LATENCY_MS)
    if version <= 0:
        return SimpleMachineModel(spec, intra_latency_ms=intra_lat, inter_latency_ms=inter_lat)
    if version == 1:
        if "ici_dims" in params:
            raise ValueError(
                "machine_model_file: ici_dims describes a torus of chips; a GPU node's NVSwitch "
                "has none (give nvlink_gbps / ici_link_gbps for its per-GPU rate)")
        return EnhancedGPUMachineModel(
            spec,
            nvlink_gbps=_param(params, ("nvlink_gbps", "ici_link_gbps"), None),
            ib_gbps=_param(params, ("ib_gbps", "dcn_link_gbps"), None),
            nic_ports_per_node=params.get("nic_ports_per_node", 4),
            intra_latency_ms=intra_lat,
            inter_latency_ms=inter_lat,
        )
    if version == 2:
        n = spec.num_nodes * spec.num_devices_per_node
        topo = params.get("topology", "torus")
        gbps = params.get("link_gbps", spec.intra_node_bandwidth)
        if topo == "torus":
            dims = tuple(params.get("dims") or _near_square_factorization(n))
            if prod(dims) != n:
                raise ValueError(
                    f"torus dims {dims} cover {prod(dims)} devices but the machine has {n}")
            links = torus_topology(dims, gbps, params.get("latency_ms", 0.001))
        elif topo == "big_switch":
            links = big_switch_topology(n, gbps, params.get("latency_ms", 0.005))
        else:
            raise ValueError(f"unknown topology generator {topo!r}")
        return NetworkedMachineModel(n, links)
    raise ValueError(f"unknown machine_model_version {version}")
