from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    forward_interpreter,
    init_params,
    resolve_device,
)

__all__ = ["ModelTrainingInstance", "forward_interpreter", "init_params", "resolve_device"]
