"""The port's models: the flagship and the parallel transformer, and the
model zoo (copies of flexflow_tpu/models/: transformer, bert, candle_uno,
inception_v3, split_test), each with its Config dataclass, its
get_default_*_config() and its get_*_computation_graph(config)."""

from flexflow_tpu_torch.models.flagship import (
    FLAGSHIP,
    LONGCTX,
    REF_HEADS16,
    build_flagship_cg,
    build_flagship_ir,
    build_flagship_pcg,
    model_step_flops,
)
from flexflow_tpu_torch.models.parallel_transformer import (
    SP_LONGCTX,
    ParallelTransformerConfig,
    build_parallel_transformer,
)
from flexflow_tpu_torch.models.transformer import (
    TransformerConfig,
    get_default_transformer_config,
    get_transformer_computation_graph,
    build_transformer,
)
from flexflow_tpu_torch.models.bert import (
    BertConfig,
    get_default_bert_config,
    get_bert_computation_graph,
    build_bert,
)
from flexflow_tpu_torch.models.candle_uno import (
    CandleUnoConfig,
    get_default_candle_uno_config,
    get_candle_uno_computation_graph,
    build_candle_uno,
)
from flexflow_tpu_torch.models.inception_v3 import (
    InceptionV3Config,
    get_default_inception_v3_training_config,
    get_inception_v3_computation_graph,
    build_inception_v3,
)
from flexflow_tpu_torch.models.split_test import (
    get_split_test_computation_graph,
    build_split_test,
)

__all__ = [
    "FLAGSHIP",
    "LONGCTX",
    "REF_HEADS16",
    "SP_LONGCTX",
    "ParallelTransformerConfig",
    "build_flagship_cg",
    "build_flagship_ir",
    "build_flagship_pcg",
    "build_parallel_transformer",
    "model_step_flops",
    "TransformerConfig",
    "get_default_transformer_config",
    "get_transformer_computation_graph",
    "build_transformer",
    "BertConfig",
    "get_default_bert_config",
    "get_bert_computation_graph",
    "build_bert",
    "CandleUnoConfig",
    "get_default_candle_uno_config",
    "get_candle_uno_computation_graph",
    "build_candle_uno",
    "InceptionV3Config",
    "get_default_inception_v3_training_config",
    "get_inception_v3_computation_graph",
    "build_inception_v3",
    "get_split_test_computation_graph",
    "build_split_test",
]
