from flexflow_tpu_torch.models.flagship import (
    FLAGSHIP,
    LONGCTX,
    REF_HEADS16,
    build_flagship_cg,
    model_step_flops,
)

__all__ = ["FLAGSHIP", "LONGCTX", "REF_HEADS16", "build_flagship_cg", "model_step_flops"]
