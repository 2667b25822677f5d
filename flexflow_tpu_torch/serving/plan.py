"""Serving-plan search: forward-only PCGs under a ms/token objective (copy
of flexflow_tpu/serving/plan.py).

Inference points the Unity machinery at a forward-only program with a
latency objective: the same rewrite lattice and machine-mapping DP, but

- ops priced on their forward alone (`forward_only` estimators),
- prefill and decode priced separately: two searches over the two shapes
  of the same model ([slots, prompt_len] and [slots, 1]), combined as
  ``ms/token = decode_ms + prefill_ms / gen_len``
  (each generated token pays one decode step plus its share of the
  prompt's prefill),
- the KV cache priced as residency: the `ServingMemorySpec` rides the
  MachineMappingContext, so a plan whose per-device cache and forward
  residency exceed `hbm_gb` is infeasible in the DP and rejected by
  `evaluate_pcg` with the memory verifier's MEM005 verdict
  (analysis/memory_analysis.py): a budgeted serving search never selects a
  plan the verifier rejects.

Sequence-parallel attention rules are excluded: the cached-decode runtime
does not lower a position-sharded rotating cache.

Machine constants: on the CPU the JAX package's CPU constants (so both
packages plan alike there), on the card the H100 SXM constants the port's
searched FFModel compile uses.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from flexflow_tpu_torch.analysis.memory_accounting import ServingMemorySpec

__all__ = [
    "ServingPlan",
    "ServingWorkload",
    "optimize_serving_plan",
    "serving_rules",
    "serving_search_context",
]

# rule-name substrings the serving runtime cannot lower (see module doc)
_EXCLUDED_RULE_TOKENS = ("sequence_parallel_attention",)


@dataclass(frozen=True)
class ServingWorkload:
    """The serving regime a plan is searched for."""

    prompt_len: int
    gen_len: int
    max_concurrent: int
    slo_ms_per_token: float = 0.0

    def cache_spec(
        self, max_seq_len: Optional[int] = None, kv_dtype_bytes: int = 4
    ) -> ServingMemorySpec:
        return ServingMemorySpec(
            max_concurrent_seqs=self.max_concurrent,
            max_seq_len=(
                max_seq_len
                if max_seq_len is not None
                else self.prompt_len + self.gen_len
            ),
            kv_dtype_bytes=kv_dtype_bytes,
        )


@dataclass
class ServingPlan:
    """The searched serving plan: separately-searched prefill and decode
    (PCG, mapping) pairs with the combined latency objective."""

    decode: object  # GraphOptimizeResult
    prefill: object  # GraphOptimizeResult
    workload: ServingWorkload
    cache_spec: ServingMemorySpec
    ms_per_token: float = 0.0
    decode_ms: float = 0.0
    prefill_ms: float = 0.0
    provenance: Dict[str, object] = field(default_factory=dict)


def serving_rules(machine_spec):
    """The serving search's rewrite rules: the standard parallelization
    lattice minus the sequence-parallel attention rewrites the cached
    runtime cannot lower."""
    from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules

    ndev = machine_spec.num_devices
    degrees = [d for d in range(2, ndev + 1) if ndev % d == 0]
    rules = generate_parallelization_rules(degrees)
    return [r for r in rules if not any(tok in r.name for tok in _EXCLUDED_RULE_TOKENS)]


def _emulated(device) -> bool:
    """Whether the plan's devices share one: a single process planning on
    the CPU stands for ranks that would share the host (the JAX package's
    virtual CPU mesh); across processes, whether two ranks of the default
    group share a device (runtime.distributed.ranks_share_a_device, a
    collective every rank calls)."""
    from flexflow_tpu_torch.runtime.distributed import is_multiprocess, ranks_share_a_device

    if is_multiprocess():
        return ranks_share_a_device(device)
    return device.type == "cpu"


def serving_search_context(
    machine_spec,
    cache_spec: ServingMemorySpec,
    *,
    hbm_gb: float = 0.0,
    cost_store_dir: Optional[str] = None,
    cost_model: str = "analytic",
    device=None,
    local_cost_estimator=None,
):
    """(a MachineMappingContext for serving searches, None): forward-only
    pricing and the KV cache in the memory model. `device` chooses the
    machine constants and, for the measured model, where each leaf's
    forward is timed (the card unless given); whether the plan's ranks
    share a device is `_emulated`'s rule. `local_cost_estimator` overrides
    the measured model's leaf timer (a forward-only LocalCostEstimator).
    `cost_store_dir`: a directory holding (or to hold) the persistent cost
    store, read and written under the forward-only (`-fwd`) fingerprint, so
    serving and training entries never serve each other; it must exist.
    The second value is that store (None without one): the caller saves it."""
    from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import (
        AnalyticGPUCostEstimator,
        GPUCostEstimator,
        make_default_allowed_machine_views,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
        MachineMappingContext,
    )
    from flexflow_tpu_torch.local_execution.training_backing import resolve_device

    device = resolve_device(device)
    cost_store = None
    if cost_store_dir:
        import os

        from flexflow_tpu_torch.compiler.cost_store import (
            CostStore,
            device_kind_signature,
            forward_fingerprint,
        )

        cost_store = CostStore(os.path.join(cost_store_dir, CostStore.FILENAME),
                               device_kind=device_kind_signature(device),
                               fingerprint=forward_fingerprint())
    emulated_mesh = _emulated(device)
    if device.type == "cpu":
        peak_flops, hbm_gbps = 5e10, 10.0
        intra_lat_ms, inter_lat_ms = 0.1, 0.2
    else:
        # H100 SXM: the peaks the searched FFModel compile prices with
        peak_flops, hbm_gbps = 989e12, 3350.0
        intra_lat_ms, inter_lat_ms = 0.001, 0.01
    if cost_model == "measured":
        from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator

        estimator = GPUCostEstimator(
            machine_spec,
            local_cost_estimator=local_cost_estimator or LocalCostEstimator(
                optimizer_state_slots=0, forward_only=True, serving=cache_spec,
                device=device, cost_store=cost_store),
            intra_latency_ms=intra_lat_ms,
            inter_latency_ms=inter_lat_ms,
            emulated_mesh=emulated_mesh,
            cost_store=cost_store,
        )
    elif cost_model == "analytic":
        estimator = AnalyticGPUCostEstimator(
            machine_spec,
            peak_flops=peak_flops,
            hbm_gbps=hbm_gbps,
            intra_latency_ms=intra_lat_ms,
            inter_latency_ms=inter_lat_ms,
            emulated_mesh=emulated_mesh,
            cost_store=cost_store,
            forward_only=True,
        )
    else:
        raise ValueError(f"cost_model must be 'analytic' or 'measured', got {cost_model!r}")
    return MachineMappingContext(
        estimator,
        make_default_allowed_machine_views(),
        overlap_fraction=0.5,
        memory_budget_bytes=(hbm_gb * 2**30 if hbm_gb and hbm_gb > 0 else 0.0),
        optimizer_state_slots=0,
        steps_per_dispatch=1,
        serving=cache_spec,
    ), cost_store


def optimize_serving_plan(
    model_builder,
    machine_spec,
    workload: ServingWorkload,
    *,
    hbm_gb: float = 0.0,
    budget: int = 4,
    alpha: float = 1.05,
    cost_store_dir: Optional[str] = None,
    cost_model: str = "analytic",
    max_seq_len: Optional[int] = None,
    device=None,
    local_cost_estimator=None,
) -> ServingPlan:
    """Search the serving plan. `model_builder(batch, seq_len)` returns
    the (ComputationGraph, logit tensor) of the model at one shape: it is
    called twice, for the prefill shape [max_concurrent, prompt_len] and
    the decode shape [max_concurrent, 1]. `device` and
    `local_cost_estimator`: see serving_search_context."""
    from flexflow_tpu_torch.compiler.unity_algorithm import OptimizerConfig, graph_optimize
    from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph

    cache_spec = workload.cache_spec(max_seq_len)
    context, cost_store = serving_search_context(
        machine_spec,
        cache_spec,
        hbm_gb=hbm_gb,
        cost_store_dir=cost_store_dir,
        cost_model=cost_model,
        device=device,
        local_cost_estimator=local_cost_estimator,
    )
    rules = serving_rules(machine_spec)
    cfg = OptimizerConfig(alpha=alpha, budget=budget)

    decode_cg, _ = model_builder(workload.max_concurrent, 1)
    decode = graph_optimize(
        pcg_from_computation_graph(decode_cg), context, machine_spec, rules, cfg)
    prefill_cg, _ = model_builder(workload.max_concurrent, workload.prompt_len)
    prefill = graph_optimize(
        pcg_from_computation_graph(prefill_cg), context, machine_spec, rules, cfg)
    if cost_store is not None:
        cost_store.save()

    gen = max(workload.gen_len, 1)
    decode_ms = decode.runtime
    prefill_ms = prefill.runtime
    # the latency objective: every generated token pays one decode step
    # plus its share of the prompt's prefill
    ms_per_token = decode_ms + prefill_ms / gen
    provenance: Dict[str, object] = {
        "objective": "ms_per_token",
        "ms_per_token": ms_per_token,
        "decode_ms": decode_ms,
        "prefill_ms": prefill_ms,
        "gen_len": gen,
        "forward_only": True,
        "cost_model": cost_model,
        "hbm_gb": hbm_gb or None,
        "serving": {
            "max_concurrent_seqs": cache_spec.max_concurrent_seqs,
            "max_seq_len": cache_spec.max_seq_len,
            "kv_dtype_bytes": cache_spec.kv_dtype_bytes,
        },
        "excluded_rules": list(_EXCLUDED_RULE_TOKENS),
    }
    for phase, result in (("decode", decode), ("prefill", prefill)):
        telem = result.telemetry or {}
        provenance[phase] = {
            "estimated_ms": result.runtime,
            "serial_ms": result.serial_runtime,
            "explored": result.explored,
            "evaluations": telem.get("evaluations"),
            "infeasible": telem.get("infeasible"),
            "dedup_hits": telem.get("dedup_hits"),
            "symmetry_dedup": telem.get("symmetry_dedup"),
            "signature_version": telem.get("signature_version"),
            "phase_ms": telem.get("phase_ms"),
        }
    if cost_store is not None:
        provenance["cost_db"] = cost_store.provenance()
    return ServingPlan(
        decode=decode,
        prefill=prefill,
        workload=workload,
        cache_spec=cache_spec,
        ms_per_token=ms_per_token,
        decode_ms=decode_ms,
        prefill_ms=prefill_ms,
        provenance=provenance,
    )
