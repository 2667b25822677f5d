"""Serving on one device (port of flexflow_tpu/serving/, the
`machine_mesh=None` lowering): a KV cache priced by the serving memory
accounting, the serving LM, prefill and the decode window, and the
continuous-batching engine under watchdog supervision.

Layering (each importable without the ones below it):

- `kv_cache`: the cache layers, their partition rules and allocation.
- `model`: the causal LM builder.
- `program`: prefill and the decode window over one graph interpreter.
- `engine`: request queue, continuous batching at decode-window
  boundaries, watchdog and FaultChannel replica shedding, JSONL request
  metrics with an SLO-violation counter.

The forward-only plan search (the JAX package's `serving/plan.py`) waits
for the port's cost model and search.
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
from flexflow_tpu_torch.serving.program import ServingProgram, init_serving_params

__all__ = [
    "CacheLayer",
    "RequestRecord",
    "ServeRequest",
    "ServingEngine",
    "ServingLMConfig",
    "ServingMemorySpec",
    "ServingProgram",
    "attention_layers",
    "build_serving_lm",
    "cache_partition_rules",
    "cache_shardings",
    "init_cache",
    "init_serving_params",
    "match_partition_rules",
    "per_device_cache_bytes",
]
