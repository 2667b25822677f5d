"""Training over several devices, one process per rank: data parallel over a
torch.distributed process group, and a PCG's searched plan (data, tensor,
sequence parallel and their mixes) over a mesh of ranks."""

from flexflow_tpu_torch.parallel.data_parallel import (
    DataParallelTrainingInstance,
    init_file_group,
)
from flexflow_tpu_torch.parallel.executor import (
    DistributedPlan,
    DistributedTrainingInstance,
    pcg_forward_interpreter,
)
from flexflow_tpu_torch.parallel.mesh import MachineMesh
from flexflow_tpu_torch.parallel.sharding import (
    TensorSharding,
    gather_block,
    local_block,
    pcg_shardings,
)

__all__ = [
    "DataParallelTrainingInstance",
    "DistributedPlan",
    "DistributedTrainingInstance",
    "MachineMesh",
    "TensorSharding",
    "gather_block",
    "init_file_group",
    "local_block",
    "pcg_forward_interpreter",
    "pcg_shardings",
]
