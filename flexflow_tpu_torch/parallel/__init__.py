"""Training over several devices: data parallel over a torch.distributed
process group, and sequence (and data) parallel over a PCG on a dp x sp
mesh of ranks."""

from flexflow_tpu_torch.parallel.data_parallel import (
    DataParallelTrainingInstance,
    init_file_group,
)
from flexflow_tpu_torch.parallel.executor import (
    DistributedTrainingInstance,
    pcg_forward_interpreter,
)
from flexflow_tpu_torch.parallel.mesh import MachineMesh

__all__ = [
    "DataParallelTrainingInstance",
    "DistributedTrainingInstance",
    "MachineMesh",
    "init_file_group",
    "pcg_forward_interpreter",
]
