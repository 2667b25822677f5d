"""Which mesh axes each tensor of a PCG is sharded, summed and copied over
(copy of the JAX package's partition_spec_for_shape, _prefer_inter_flags
and pcg_shardings, flexflow_tpu/parallel/sharding.py:45-162).

Axis assignment follows the JAX package exactly. An activation's shard dims
take axes left to right, then its sum degree, then its discard-copy degree;
a weight takes its discard-copy degree first. A searched machine view's
projections choose whether each degree draws from the axes across nodes or
within one. A weight whose only consumers are a chain of Repartitions rests
at the chain's final sharding, and the whole chain takes it.

Where the JAX package leaves a tensor unconstrained for GSPMD to place, the
port cannot: each rank holds its own piece. A pending-sum activation gets
its sum axes (the ranks whose partial sums add up to it), and a degree the
mesh cannot express raises, naming the tensor and the degree.

`local_block` cuts this rank's piece out of a global value; `gather_block`
all-gathers the pieces back into it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from flexflow_tpu_torch.op_attrs.ops import RepartitionAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorShape
from flexflow_tpu_torch.parallel.mesh import Axes, AxisPool, MachineMesh, MeshAxes
from flexflow_tpu_torch.pcg.machine_view import MachineView, ProjectionType
from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node


@dataclass(frozen=True)
class TensorSharding:
    """Per dim, the axes it is sharded over (major first; () when whole);
    the axes over which ranks hold partial sums of it; the axes of its
    discard-copy degree. Axes in none of them hold duplicates."""

    dims: Tuple[Axes, ...]
    sum: Axes = ()
    copy: Axes = ()

    def spec(self) -> Tuple:
        """The JAX PartitionSpec entries: None, one axis, or a tuple."""
        return tuple(None if not a else a[0] if len(a) == 1 else a for a in self.dims)

    def placed(self) -> frozenset:
        """The axes along which ranks hold different pieces or partials."""
        return frozenset(a for axes in self.dims for a in axes) | frozenset(self.sum)

    def with_dims(self, dims) -> "TensorSharding":
        return TensorSharding(tuple(tuple(d) for d in dims), self.sum, self.copy)


def _prefer_inter_flags(pts: ParallelTensorShape, view: Optional[MachineView]):
    """Per nontrivial degree, whether the view projects it across nodes,
    positionally over [shard dims, sum, discard copy]."""
    degrees = [d for d in pts.shard_degrees() if d > 1]
    if pts.sum_degree > 1:
        degrees.append(pts.sum_degree)
    if pts.discard_copy_degree > 1:
        degrees.append(pts.discard_copy_degree)
    flags = [False] * len(degrees)
    if view is not None and len(view.dimensions) == len(degrees):
        flags = [p == ProjectionType.INTER_NODE for p in view.projections()]
    return flags


def sharding_for_shape(pts: ParallelTensorShape, mesh: MeshAxes,
                       view: Optional[MachineView] = None, is_weight: bool = False,
                       what: str = "tensor") -> TensorSharding:
    """The axes of every degree of `pts`; raises where the mesh cannot
    express one."""
    pool = AxisPool(mesh)
    flags = _prefer_inter_flags(pts, view)
    flag_it = iter(flags)

    def alloc(degree, kind, prefer=None):
        prefer_inter = next(flag_it, False) if prefer is None else prefer
        axes = pool.allocate(degree, prefer_inter=prefer_inter)
        if axes is None:
            raise NotImplementedError(
                f"{what} {pts}: its {kind} degree {degree} is no product of the free axes "
                f"of the mesh {dict(mesh.sizes)}, so no rank can hold its piece (A7 item 3: "
                f"every degree must be a product of the mesh's prime-factor axes)")
        return axes

    # a weight's sum degree (the bias of a partial sum) takes no axes: every
    # rank holds the whole bias, and the op adds it at sum index 0 only
    copy: Axes = ()
    if is_weight and pts.discard_copy_degree > 1:
        # the replica axes first; the degree's projection flag is the last
        copy = alloc(pts.discard_copy_degree, "discard-copy", flags[-1] if flags else False)
    dims = tuple(alloc(d, f"dim {i} shard") if d > 1 else ()
                 for i, d in enumerate(pts.shard_degrees()))
    total = ()
    if not is_weight and pts.sum_degree > 1:
        total = alloc(pts.sum_degree, "sum")
    if not is_weight and pts.discard_copy_degree > 1:
        copy = alloc(pts.discard_copy_degree, "discard-copy")
    return TensorSharding(dims, total, copy)


def weight_chain(pcg: ParallelComputationGraph, n: Node):
    """The tensors of weight node n's chain: its output, then each
    Repartition output while a tensor's only consumer is a Repartition."""
    (v,) = pcg.outputs_of(n)
    chain = [v]
    while True:
        uses = pcg.uses_of(v)
        if len(uses) != 1 or not isinstance(pcg.op_attrs(uses[0].node), RepartitionAttrs):
            return chain
        v = pcg.outputs_of(uses[0].node)[0]
        chain.append(v)


def pcg_shardings(pcg: ParallelComputationGraph, mesh: MeshAxes,
                  mapping: Optional[Dict[Node, MachineView]] = None
                  ) -> Dict[DataflowOutput, TensorSharding]:
    """The sharding of every tensor of the PCG on the axes of `mesh` (a
    MachineMesh, or MeshAxes alone). `mapping`: the searched per-node
    machine views (absent nodes take axes within a node first)."""
    mapping = mapping or {}
    out: Dict[DataflowOutput, TensorSharding] = {}
    for n in pcg.topological_ordering():
        is_weight = isinstance(pcg.op_attrs(n), WeightAttrs)
        name = pcg.layer_attrs(n).name or f"node {n.idx}"
        for i, o in enumerate(pcg.outputs_of(n)):
            out[o] = sharding_for_shape(pcg.tensor_shape(o), mesh, mapping.get(n), is_weight,
                                        what=f"output {i} of {name}")
    # a weight resharded only by Repartitions rests at the final sharding:
    # sharded parameters live sharded from initialization
    for n in pcg.topological_ordering():
        if isinstance(pcg.op_attrs(n), WeightAttrs):
            chain = weight_chain(pcg, n)
            for t in chain:
                out[t] = out[chain[-1]]
    return out


def _check_divides(size: int, n: int, what: str, dim: int, axes, mesh: MachineMesh) -> None:
    if size % n:
        kind = mesh.kinds.get(tuple(axes))
        raise ValueError(f"{what} dim {dim} of size {size} does not divide over {n} "
                         f"{kind + ' ' if kind else ''}ranks (mesh axes {', '.join(axes)})")


def is_rank_block(rows: int, global_rows: int, n: int) -> bool:
    """Whether a batch of `rows` rows fed to a trainer whose global batch
    has `global_rows`, split over `n` ranks, is this rank's block of it (as
    FFModel feeds it) rather than a global batch, which the trainer cuts
    itself. A global batch of exactly one block's rows reads as a block."""
    return n > 1 and rows * n == global_rows


def local_block(x, sharding: TensorSharding, mesh: MachineMesh, what: str):
    """This rank's piece of the global tensor x (its leading dims sharded as
    `sharding` says); raises where a sharded dim does not divide."""
    for dim, axes in enumerate(sharding.dims):
        if not axes or dim >= x.dim():
            continue
        n, size = mesh.size(axes), x.shape[dim]
        _check_divides(size, n, what, dim, axes, mesh)
        x = x.narrow(dim, mesh.index(axes) * (size // n), size // n)
    return x


def gather_block(piece: torch.Tensor, sharding: TensorSharding, mesh: MachineMesh) -> torch.Tensor:
    """The global value of which every rank holds its piece `piece` (no
    gradient; a copy): each sharded dim all-gathered in piece order."""
    x = piece.detach().clone()
    for dim, axes in enumerate(sharding.dims):
        if axes and mesh.size(axes) > 1:
            x = mesh.all_gather(x, dim, axes)
    return x
