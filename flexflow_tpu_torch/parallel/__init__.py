"""Training over several devices: data parallel over a torch.distributed
process group."""

from flexflow_tpu_torch.parallel.data_parallel import (
    DataParallelTrainingInstance,
    init_file_group,
)

__all__ = ["DataParallelTrainingInstance", "init_file_group"]
