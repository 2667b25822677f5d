from flexflow_tpu_torch.models.flagship import (
    FLAGSHIP,
    build_flagship_cg,
    model_step_flops,
)

__all__ = ["FLAGSHIP", "build_flagship_cg", "model_step_flops"]
