"""Serving (port of flexflow_tpu/serving/): a KV cache priced by the serving
memory accounting, the serving LM, prefill and the decode window on one
device or over a mesh of ranks, the continuous-batching engine under
watchdog supervision, and the forward-only plan search.

Layering (each importable without the ones below it):

- `kv_cache`: the cache layers, their partition rules and allocation (a
  rank's piece over a mesh).
- `model`: the causal LM builder.
- `program`: prefill and the decode window over one graph interpreter, the
  single-device lowering or a searched plan's over ranks.
- `engine`: request queue, continuous batching at decode-window
  boundaries, watchdog and FaultChannel replica shedding (over ranks,
  rank 0's decisions), JSONL request metrics with an SLO-violation counter.
- `plan`: the serving search (`optimize_serving_plan`): prefill and decode
  planned forward-only under the ms/token objective, the KV cache in the
  memory model.
"""

from flexflow_tpu_torch.analysis.memory_accounting import ServingMemorySpec
from flexflow_tpu_torch.serving.engine import (
    RequestRecord,
    ServeRequest,
    ServingEngine,
)
from flexflow_tpu_torch.serving.kv_cache import (
    CacheLayer,
    attention_layers,
    cache_partition_rules,
    cache_shardings,
    init_cache,
    match_partition_rules,
    per_device_cache_bytes,
)
from flexflow_tpu_torch.serving.model import ServingLMConfig, build_serving_lm
from flexflow_tpu_torch.serving.plan import (
    ServingPlan,
    ServingWorkload,
    optimize_serving_plan,
    serving_rules,
    serving_search_context,
)
from flexflow_tpu_torch.serving.program import ServingProgram, init_serving_params

__all__ = [
    "CacheLayer",
    "RequestRecord",
    "ServeRequest",
    "ServingEngine",
    "ServingLMConfig",
    "ServingMemorySpec",
    "ServingPlan",
    "ServingProgram",
    "ServingWorkload",
    "attention_layers",
    "build_serving_lm",
    "cache_partition_rules",
    "cache_shardings",
    "init_cache",
    "init_serving_params",
    "match_partition_rules",
    "optimize_serving_plan",
    "per_device_cache_bytes",
    "serving_rules",
    "serving_search_context",
]
