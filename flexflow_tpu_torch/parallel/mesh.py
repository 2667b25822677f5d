"""The ranks of a process group as a dp x sp grid (counterpart of the JAX
package's MachineMesh, flexflow_tpu/parallel/mesh.py:42).

dp is the data-parallel degree (batch shards) and sp the
sequence-parallel degree (sequence shards, the ring). Rank r of the base
group sits at (dp_index, sp_index) = (r // sp, r % sp): the sp ranks of
one batch shard are neighbours, as the JAX package's mesh puts the
sequence axis minor to the batch axis. The mesh opens one subgroup per
ring (the ranks of one batch shard) over the base group's backend; the
gradient all-reduce runs over the base group itself. Every rank opens
every subgroup, in the same order, as torch.distributed requires.
"""

from __future__ import annotations

from typing import Optional

import torch.distributed as dist

from flexflow_tpu_torch.kernels.ring_flash import SequenceRing


class MachineMesh:
    def __init__(self, dp: int = 1, sp: int = 1, base_group=None) -> None:
        """base_group: the process group whose ranks the mesh arranges
        (None: the default group, which must be initialized); its size
        must be dp * sp."""
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group is initialized: open one first (e.g. parallel.init_file_group)"
            )
        world = dist.get_world_size(base_group)
        if dp * sp != world:
            raise ValueError(f"a {dp} x {sp} mesh needs {dp * sp} ranks, the group has {world}")
        self.dp, self.sp, self.group = dp, sp, base_group
        self.rank = dist.get_rank(base_group)
        self.dp_index, self.sp_index = divmod(self.rank, sp)
        backend = dist.get_backend(base_group)

        def global_rank(r: int) -> int:
            return r if base_group is None else dist.get_global_rank(base_group, r)

        self.sp_group: Optional[object] = None
        for i in range(dp):
            g = dist.new_group([global_rank(i * sp + j) for j in range(sp)], backend=backend)
            if i == self.dp_index:
                self.sp_group = g

    @property
    def world_size(self) -> int:
        return self.dp * self.sp

    def ring(self) -> SequenceRing:
        """This rank's sequence-parallel ring."""
        return SequenceRing(self.sp, self.sp_index, self.sp_group)

    def index(self, axis: str) -> int:
        """This rank's index along 'dp' or 'sp'."""
        return {"dp": self.dp_index, "sp": self.sp_index}[axis]

    def size(self, axis: str) -> int:
        return {"dp": self.dp, "sp": self.sp}[axis]
