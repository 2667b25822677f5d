"""The port's MCMC search (flexflow_tpu_torch/compiler/mcmc_search.py) and
FFConfig(search_algorithm="mcmc") against the JAX package's
(tests/test_ffmodel_api.py's test_mcmc_searched_compile and the JAX
mcmc_optimize are the spec):

- mcmc_optimize on the small flagship and on an MLP, at several seeds,
  budgets and temperatures, priced by both analytic estimators with the
  same constants: the same random.Random stream over the same rule order
  proposes the same rewrites, so the walk is the JAX walk — the winner's
  cost within 1e-9, the same plan, the same seed runtimes, and the same
  counts (evaluations, infeasible, dedup hits, iterations, accepted);
- a walk with no rule to propose raises as the JAX walk does;
- FFConfig(search_algorithm="mcmc") on 2 gloo ranks (the shared job of
  tests/test_torch_port_overlap.py) finds the JAX FFModel's plan on 2
  virtual devices at its estimate and trains to its parameters within
  1e-5.
"""

from __future__ import annotations

import math

import pytest

import bench
import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu.compiler.mcmc_search import MCMCConfig as JConfig
from flexflow_tpu.compiler.mcmc_search import mcmc_optimize as j_mcmc
from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary
from flexflow_tpu.pcg import ComputationGraphBuilder as JBuilder
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as j_lift
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu_torch.compiler.mcmc_search import MCMCConfig as TConfig
from flexflow_tpu_torch.compiler.mcmc_search import mcmc_optimize as t_mcmc
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TBuilder
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph as t_lift
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from test_torch_port_overlap import check_job_against_jax, search_ranks

RTOL = 1e-9
SMALL = dict(batch=8, seq=64, embed=64, heads=2, layers=2, vocab=256)
PEAK_FLOPS, HBM_GBPS = 1e11, 100.0
COUNTS = ("evaluations", "infeasible", "dedup_hits", "iterations", "accepted", "budget")


def _mlp(builder, lift):
    b = builder()
    x = b.create_input([64, 256], name="x")
    b.dense(b.relu(b.dense(x, 1024, use_bias=False, name="fc1")), 16, use_bias=False,
            name="out")
    return lift(b.graph)


def _pcgs(model):
    if model == "mlp":
        return _mlp(TBuilder, t_lift), _mlp(JBuilder, j_lift)
    return build_flagship_pcg(**SMALL), bench.build_flagship_pcg(**SMALL)


def _contexts(ndev):
    ts = tmv.MachineSpecification(1, 1, ndev, 25.0, 400.0)
    js = jmv.MachineSpecification(1, 1, ndev, 25.0, 400.0)
    te = T.AnalyticGPUCostEstimator(ts, PEAK_FLOPS, HBM_GBPS, intra_latency_ms=0.001,
                                    inter_latency_ms=0.01)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=PEAK_FLOPS, hbm_gbps=HBM_GBPS,
                                    ici_latency_ms=0.001, dcn_latency_ms=0.01)
    return (ts, T.MachineMappingContext(te, T.make_default_allowed_machine_views()),
            js, J.MachineMappingContext(je, J.make_default_allowed_machine_views()))


@pytest.mark.parametrize("model,ndev,budget,seed,beta", [
    ("mlp", 4, 8, 0, 20.0), ("mlp", 8, 12, 3, 5.0), ("flagship", 4, 10, 0, 20.0),
    ("flagship", 8, 6, 7, 50.0)])
def test_the_walk_is_the_jax_walk(model, ndev, budget, seed, beta):
    tp, jp = _pcgs(model)
    ts, tctx, js, jctx = _contexts(ndev)
    degs = [d for d in range(2, ndev + 1) if ndev % d == 0]
    tr = t_mcmc(tp, tctx, ts, t_rules(degs), TConfig(budget=budget, beta=beta, rng_seed=seed))
    jr = j_mcmc(jp, jctx, js, j_rules(degs), JConfig(budget=budget, beta=beta, rng_seed=seed))
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert math.isclose(tr.serial_runtime, jr.serial_runtime, rel_tol=RTOL)
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert tr.explored == jr.explored > 0
    assert (tr.seed_runtimes or {}).keys() == (jr.seed_runtimes or {}).keys()
    for k, v in (jr.seed_runtimes or {}).items():
        assert math.isclose(tr.seed_runtimes[k], v, rel_tol=RTOL), k
    for k in COUNTS:
        assert tr.telemetry[k] == jr.telemetry[k], k
    assert tr.telemetry["algorithm"] == "mcmc"
    assert tr.runtime <= tr.serial_runtime


def test_a_walk_with_no_rule_raises_as_the_jax_walk_does():
    tp, jp = _pcgs("mlp")
    ts, tctx, js, jctx = _contexts(4)
    errors = []
    for fn, pcg, ctx, spec, cfg in ((t_mcmc, tp, tctx, ts, TConfig(budget=4, seed_jump=0.0)),
                                    (j_mcmc, jp, jctx, js, JConfig(budget=4, seed_jump=0.0))):
        with pytest.raises(ValueError) as e:
            fn(pcg, ctx, spec, [], cfg)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_ffconfig_mcmc_over_ranks_finds_and_trains_the_jax_plan(tmp_path_factory):
    runs = search_ranks(tmp_path_factory)
    check_job_against_jax(runs, "mcmc")
    for r in runs["ranks"]:
        assert r["mcmc"]["algorithm"] == "mcmc" and r["mcmc"]["telemetry_evaluations"] > 1
