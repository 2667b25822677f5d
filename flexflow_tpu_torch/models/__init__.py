from flexflow_tpu_torch.models.flagship import (
    FLAGSHIP,
    LONGCTX,
    REF_HEADS16,
    build_flagship_cg,
    model_step_flops,
)
from flexflow_tpu_torch.models.parallel_transformer import (
    SP_LONGCTX,
    ParallelTransformerConfig,
    build_parallel_transformer,
)

__all__ = [
    "FLAGSHIP",
    "LONGCTX",
    "REF_HEADS16",
    "SP_LONGCTX",
    "ParallelTransformerConfig",
    "build_flagship_cg",
    "build_parallel_transformer",
    "model_step_flops",
]
