"""The serving planner and the memory verifier (serving/plan.py,
analysis/memory_analysis.py, the forward-only pricing and the budgeted
search) against the JAX package's, at the JAX serving tests' sizes
(`ServingLMConfig()`, a machine of 8 devices, tests/test_serving.py's
budgets).

- `optimize_serving_plan` on the analytic estimators, unbudgeted and under
  a budget the serial plan's cache exceeds: the decode and prefill
  runtimes and serial runtimes (within 1e-9; none where the serial plan
  busts the budget), the explored counts,
  `ms_per_token`, the winners' parallel degrees and strategy documents;
  the budgeted winner passes `verify_memory` at that budget with a smaller
  cache than the serial plan's.
- `serving_rules`: the same rule names.
- `analyze_memory` (training and serving), `verify_memory`'s rule ids,
  `serving_verdict` (MEM005 both ways), `leaf_memory_infeasible` and the
  budgeted `evaluate_pcg`: equal verdicts and bytes.
- The memory-budgeted training search on the small flagship at 4 devices:
  the JAX package's winner and runtime."""

import json
import math

import numpy as np
import pytest

import bench
import flexflow_tpu.compiler as J
from flexflow_tpu.analysis.diagnostics import has_errors as j_has_errors
from flexflow_tpu.analysis.memory_analysis import analyze_memory as j_analyze
from flexflow_tpu.analysis.memory_analysis import memory_summary_json as j_summary_json
from flexflow_tpu.analysis.memory_analysis import serving_verdict as j_verdict
from flexflow_tpu.analysis.memory_analysis import verify_memory as j_verify
from flexflow_tpu.compiler.machine_mapping.get_optimal_machine_mapping import (
    leaf_memory_infeasible as j_leaf_infeasible,
)
from flexflow_tpu.compiler.machine_mapping.problem_tree import _leaf_key as j_leaf_key
from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as j_lift
from flexflow_tpu.runtime.strategy import strategy_to_doc as j_doc
from flexflow_tpu.serving import ServingLMConfig as JCfg
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_par_rules
from flexflow_tpu.serving import build_serving_lm as j_build
from flexflow_tpu.serving.plan import ServingWorkload as JWorkload
from flexflow_tpu.serving.plan import optimize_serving_plan as j_optimize
from flexflow_tpu.serving.plan import serving_rules as j_rules
from flexflow_tpu.serving.plan import serving_search_context as j_context
import flexflow_tpu_torch.compiler as T
from flexflow_tpu_torch.analysis.diagnostics import has_errors
from flexflow_tpu_torch.analysis.memory_analysis import (
    analyze_memory,
    memory_summary_json,
    serving_verdict,
    verify_memory,
)
from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
    leaf_memory_infeasible,
)
from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _leaf_key
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification as TSpec
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
from flexflow_tpu_torch.runtime.strategy import strategy_to_doc
from flexflow_tpu_torch.serving import ServingLMConfig, build_serving_lm
from flexflow_tpu_torch.serving.kv_cache import attention_layers, per_device_cache_bytes
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from flexflow_tpu_torch.serving.plan import (
    ServingWorkload,
    optimize_serving_plan,
    serving_rules,
    serving_search_context,
)

TS, JS = TSpec(1, 1, 8, 1.0, 2.0), JSpec(1, 1, 8, 1.0, 2.0)
WL = dict(prompt_len=6, gen_len=8, max_concurrent=8)
SEQ_CAP = 512


def _tb(b, s):
    return build_serving_lm(ServingLMConfig(), b, s)


def _jb(b, s):
    return j_build(JCfg(), b, s)


def _tight_gb(pcg):
    """A budget the serial plan's cache exceeds but a sharded one fits:
    the serial peak minus half the serial cache (the JAX test's)."""
    spec = ServingWorkload(**WL).cache_spec(SEQ_CAP)
    analysis, _ = verify_memory(pcg, TS, None, serving=spec)
    peak = max(d.peak_bytes for d in analysis.per_device.values())
    return (peak - per_device_cache_bytes(pcg, attention_layers(pcg), spec) // 2) / 2**30


@pytest.fixture(scope="module")
def plans():
    """(port plan, JAX plan) unbudgeted and at the tight budget."""
    tight = _tight_gb(pcg_from_computation_graph(_tb(8, 1)[0]))
    out = {"tight_gb": tight}
    for name, hbm, budget in (("free", 0.0, 2), ("tight", tight, 4)):
        out[name] = (
            optimize_serving_plan(_tb, TS, ServingWorkload(**WL), hbm_gb=hbm, budget=budget,
                                  max_seq_len=SEQ_CAP, device="cpu"),
            j_optimize(_jb, JS, JWorkload(**WL), hbm_gb=hbm, budget=budget,
                       max_seq_len=SEQ_CAP))
    return out


def _doc(doc):
    return json.loads(json.dumps(doc, sort_keys=True))


@pytest.mark.parametrize("budget", ["free", "tight"])
def test_serving_plan_is_the_jax_packages(plans, budget):
    tp, jp = plans[budget]
    for a, b in ((tp.ms_per_token, jp.ms_per_token), (tp.decode_ms, jp.decode_ms),
                 (tp.prefill_ms, jp.prefill_ms),
                 (tp.decode.serial_runtime, jp.decode.serial_runtime),
                 (tp.prefill.serial_runtime, jp.prefill.serial_runtime)):
        assert (a is None and b is None) or math.isclose(a, b, rel_tol=1e-9), (a, b)
    assert tp.ms_per_token == pytest.approx(tp.decode_ms + tp.prefill_ms / WL["gen_len"])
    for t, j in ((tp.decode, jp.decode), (tp.prefill, jp.prefill)):
        assert t.explored == j.explored
        assert T.parallel_degree_summary(t.pcg) == j_summary(j.pcg)
        assert _doc(strategy_to_doc(t.pcg, t.machine_mapping, t.runtime)) == \
            _doc(j_doc(j.pcg, j.machine_mapping, j.runtime))
    prov = tp.provenance
    assert prov["objective"] == "ms_per_token" and prov["forward_only"] is True
    assert prov["excluded_rules"] == jp.provenance["excluded_rules"]
    for phase in ("decode", "prefill"):
        assert prov[phase]["explored"] == jp.provenance[phase]["explored"]
        assert prov[phase]["evaluations"] == jp.provenance[phase]["evaluations"]


def test_budgeted_winner_passes_the_verifier_with_a_smaller_cache(plans):
    tp, _ = plans["tight"]
    tight = plans["tight_gb"]
    spec = tp.cache_spec
    serial = pcg_from_computation_graph(_tb(8, 1)[0])
    for phase in (tp.decode, tp.prefill):
        _, diags = verify_memory(phase.pcg, TS, phase.machine_mapping,
                                 hbm_bytes=tight * 2**30, serving=spec)
        assert not has_errors(diags)
    assert per_device_cache_bytes(tp.decode.pcg, attention_layers(tp.decode.pcg), spec) < \
        per_device_cache_bytes(serial, attention_layers(serial), spec)


def test_serving_rules_are_the_jax_packages():
    names = [r.name for r in serving_rules(TS)]
    assert names == [r.name for r in j_rules(JS)]
    assert names and not any("sequence_parallel_attention" in n for n in names)


def _pcgs(mapped: bool):
    """(port PCG, port mapping, JAX PCG, JAX mapping): the decode LM at 8
    slots, serial, or under the tp2 seed's plan."""
    tp, jp = pcg_from_computation_graph(_tb(8, 1)[0]), j_lift(_jb(8, 1)[0])
    if not mapped:
        return tp, None, jp, None
    from flexflow_tpu.compiler.unity_algorithm import tensor_parallel_seed as j_tp

    from flexflow_tpu_torch.compiler.unity_algorithm import tensor_parallel_seed

    return tensor_parallel_seed(tp, 2), None, j_tp(jp, 2), None


@pytest.mark.parametrize("mapped", [False, True])
@pytest.mark.parametrize("serving", [False, True])
def test_memory_analysis_is_the_jax_packages(mapped, serving):
    from flexflow_tpu.serving.kv_cache import ServingMemorySpec as JMem
    from flexflow_tpu_torch.serving.kv_cache import ServingMemorySpec

    tp, tm, jp, jm = _pcgs(mapped)
    spec = ServingMemorySpec(8, SEQ_CAP) if serving else None
    jspec = JMem(8, SEQ_CAP) if serving else None
    t, j = analyze_memory(tp, TS, tm, serving=spec), j_analyze(jp, JS, jm, serving=jspec)
    assert t.num_ticks == j.num_ticks
    assert t.peak_by_device() == j.peak_by_device()
    for d in t.per_device:
        assert t.per_device[d].peak_breakdown == j.per_device[d].peak_breakdown
    assert memory_summary_json(t, 64 * 2**20) == j_summary_json(j, 64 * 2**20)


@pytest.mark.parametrize("budget", ["roomy", "tight"])
def test_verify_memory_and_serving_verdict_are_the_jax_packages(budget):
    """MEM005 both ways: 64 MiB holds 8 sequences' cache; the JAX test's
    tight capacity (the model plus about half the cache) does not."""
    from flexflow_tpu.serving.kv_cache import ServingMemorySpec as JMem
    from flexflow_tpu_torch.serving.kv_cache import ServingMemorySpec

    tp, _, jp, _ = _pcgs(False)
    spec, jspec = ServingMemorySpec(8, SEQ_CAP), JMem(8, SEQ_CAP)
    hbm = 64 * 2**20
    if budget == "tight":
        analysis, _ = verify_memory(tp, TS, None, hbm_bytes=hbm, serving=spec)
        full = per_device_cache_bytes(tp, attention_layers(tp), spec)
        hbm = analysis.per_device[0].peak_bytes - full + full // 2
    ta, td = verify_memory(tp, TS, None, hbm_bytes=hbm, serving=spec)
    ja, jd = j_verify(jp, JS, None, hbm_bytes=hbm, serving=jspec)
    assert [d.rule_id for d in td] == [d.rule_id for d in jd]
    assert [d.message for d in td] == [d.message for d in jd]
    assert ("MEM005" in {d.rule_id for d in td}) == (budget == "tight")
    assert serving_verdict(ta, hbm).to_json() == j_verdict(ja, hbm).to_json()


def test_leaf_pruner_and_budgeted_evaluation_are_the_jax_packages(plans):
    """At the tight budget: each leaf's verdict, and the serial plan's
    evaluation (infeasible in both; feasible without the budget)."""
    from flexflow_tpu.compiler.machine_mapping.get_optimal_machine_mapping import (
        MachineMappingCache as JCache,
    )

    spec = ServingWorkload(**WL).cache_spec(SEQ_CAP)
    tight = plans["tight_gb"]
    tctx, _ = serving_search_context(TS, spec, hbm_gb=tight, device="cpu")
    jctx, _ = j_context(JS, JWorkload(**WL).cache_spec(SEQ_CAP), hbm_gb=tight)
    tp, _, jp, _ = _pcgs(False)
    verdicts = [leaf_memory_infeasible(tctx, _leaf_key(tp, n)) for n in tp.topological_ordering()]
    assert verdicts == [j_leaf_infeasible(jctx, j_leaf_key(jp, n)) for n in jp.topological_ordering()]
    assert T.evaluate_pcg(tp, tctx, TS, T.MachineMappingCache()) is None
    assert J.evaluate_pcg(jp, jctx, JS, JCache()) is None
    free, _ = serving_search_context(TS, spec, device="cpu")
    assert T.evaluate_pcg(tp, free, TS, T.MachineMappingCache()) is not None


def test_budgeted_training_search_is_the_jax_packages():
    """The memory-budgeted training search (evaluate_pcg's verifier
    branch and the leaf pruner) on the small flagship at 4 devices, under
    a budget the serial plan's step exceeds."""
    small = dict(batch=8, seq=64, embed=128, heads=4, layers=1, vocab=256)
    tp, jp = build_flagship_pcg(**small), bench.build_flagship_pcg(**small)
    ts, js = TSpec(1, 1, 4, 25.0, 400.0), JSpec(1, 1, 4, 25.0, 400.0)
    serial = max(analyze_memory(tp, ts, None).peak_by_device().values())
    budget = 0.7 * serial
    te = T.AnalyticGPUCostEstimator(ts, peak_flops=1e11, hbm_gbps=100.0,
                                    intra_latency_ms=0.001, inter_latency_ms=0.01)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=1e11, hbm_gbps=100.0,
                                    ici_latency_ms=0.001, dcn_latency_ms=0.01)
    tctx = T.MachineMappingContext(te, T.make_default_allowed_machine_views(),
                                   memory_budget_bytes=budget)
    jctx = J.MachineMappingContext(je, J.make_default_allowed_machine_views(),
                                   memory_budget_bytes=budget)
    assert T.evaluate_pcg(tp, tctx, ts, T.MachineMappingCache()) is None  # serial busts it
    tr = T.graph_optimize(tp, tctx, ts, t_rules([2, 4]),
                          T.OptimizerConfig(budget=2))
    jr = J.graph_optimize(jp, jctx, js, j_par_rules([2, 4]),
                          J.OptimizerConfig(budget=2))
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert np.isclose(tr.runtime, jr.runtime, rtol=1e-9)
    assert tr.explored == jr.explored
    _, diags = verify_memory(tr.pcg, ts, tr.machine_mapping, hbm_bytes=budget)
    assert not has_errors(diags)
    _, jdiags = j_verify(jr.pcg, js, jr.machine_mapping, hbm_bytes=budget)
    assert not j_has_errors(jdiags)


def test_forward_only_measured_leaves_match_the_jax_memory_and_run():
    """LocalCostEstimator(forward_only=True, serving=spec) on the decode
    LM's leaves under the tp2 seed: the serving residency (mem_bytes) of
    each compute leaf equals the JAX estimator's, every leaf is timed
    (its forward alone), none prices at infinity; and the measured serving
    search runs on it."""
    from flexflow_tpu.kernels.profiling import ProfilingSettings as JSettings
    from flexflow_tpu.local_execution.cost_estimator import LocalCostEstimator as JLocal
    from flexflow_tpu.serving.kv_cache import ServingMemorySpec as JMem
    from flexflow_tpu_torch.kernels.profiling import ProfilingSettings as TSettings
    from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator as TLocal
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op
    from flexflow_tpu_torch.serving.kv_cache import ServingMemorySpec

    tp, _, jp, _ = _pcgs(True)
    spec, jspec = ServingMemorySpec(8, SEQ_CAP), JMem(8, SEQ_CAP)
    tl = TLocal(TSettings(1, 2), forward_only=True, serving=spec, optimizer_state_slots=0,
                device="cpu")
    jl = JLocal(JSettings(1, 2), optimizer_state_slots=0, forward_only=True, serving=jspec)
    measured = 0
    for tn, jn in zip(tp.topological_ordering(), jp.topological_ordering()):
        tk, jk = _leaf_key(tp, tn), j_leaf_key(jp, jn)
        if is_parallel_op(tk.op_attrs) or type(tk.op_attrs).__name__ in ("InputAttrs",
                                                                          "WeightAttrs"):
            continue
        tc = tl.estimate_operator_cost_parallel(tk.op_attrs, list(tk.input_shapes),
                                                list(tk.output_shapes))
        jc = jl.estimate_operator_cost_parallel(jk.op_attrs, list(jk.input_shapes),
                                                list(jk.output_shapes))
        assert tc.mem_bytes == jc.mem_bytes, type(tk.op_attrs).__name__
        assert math.isfinite(tc.elapsed_ms) and tc.elapsed_ms > 0
        measured += 1
    assert measured >= 6 and not tl.inf_leaves
    plan = optimize_serving_plan(_tb, TSpec(1, 1, 2, 1.0, 2.0), ServingWorkload(**WL), budget=1,
                                 max_seq_len=SEQ_CAP, cost_model="measured", device="cpu",
                                 local_cost_estimator=tl)
    assert plan.provenance["cost_model"] == "measured" and math.isfinite(plan.ms_per_token)
