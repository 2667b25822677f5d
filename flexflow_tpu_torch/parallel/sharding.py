"""Which dims of a PCG's tensors are sharded over which mesh axis
(trimmed counterpart of the JAX package's pcg_shardings,
flexflow_tpu/parallel/sharding.py:108).

An activation's shard dims take the mesh axes left to right, as the JAX
package allocates mesh axes: each dim of degree > 1 takes the first unused
axis of that size, in the order (dp, sp). So [b/dp, s/sp, e] is sharded
('dp', 'sp', None). The trainer reads the input, label and logit entries to
cut this rank's block out of a global batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorShape
from flexflow_tpu_torch.parallel.mesh import MachineMesh
from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.utils.graph import DataflowOutput

# per dim: the mesh axis ('dp' or 'sp') it is sharded over, or None
Sharding = Tuple[Optional[str], ...]


def sharding_for_shape(pts: ParallelTensorShape, mesh: MachineMesh) -> Sharding:
    """The mesh axis of each dim of `pts`; raises where a degree matches no
    free axis of the mesh."""
    free = ["dp", "sp"]
    out = []
    for degree in pts.shard_degrees():
        if degree == 1:
            out.append(None)
            continue
        axis = next((a for a in free if mesh.size(a) == degree), None)
        if axis is None:
            raise NotImplementedError(
                f"shard degree {degree} of {pts} matches no free axis of the "
                f"{mesh.dp} x {mesh.sp} mesh"
            )
        free.remove(axis)
        out.append(axis)
    return tuple(out)


def pcg_shardings(pcg: ParallelComputationGraph, mesh: MachineMesh) -> Dict[DataflowOutput, Sharding]:
    """The sharding of every tensor of the PCG."""
    return {
        o: sharding_for_shape(pcg.tensor_shape(o), mesh)
        for n in pcg.topological_ordering()
        for o in pcg.outputs_of(n)
    }


def local_block(x, sharding: Sharding, mesh: MachineMesh, what: str):
    """This rank's block of the global tensor x (its leading dims sharded
    as `sharding` says); raises where a sharded dim does not divide."""
    for dim, axis in enumerate(sharding):
        if axis is None or dim >= x.dim():
            continue
        n, size = mesh.size(axis), x.shape[dim]
        if size % n:
            raise ValueError(f"{what} dim {dim} of size {size} does not divide over {n} "
                             f"{'data' if axis == 'dp' else 'sequence'}-parallel ranks")
        i = mesh.index(axis)
        x = x.narrow(dim, i * (size // n), size // n)
    return x
