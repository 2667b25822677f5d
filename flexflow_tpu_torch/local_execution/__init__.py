from flexflow_tpu_torch.local_execution.training_backing import (
    LocalTrainingBacking,
    ModelTrainingInstance,
    forward_interpreter,
    init_params,
    resolve_device,
)

__all__ = [
    "LocalTrainingBacking",
    "ModelTrainingInstance",
    "forward_interpreter",
    "init_params",
    "resolve_device",
]
