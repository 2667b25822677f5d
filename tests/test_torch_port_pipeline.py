"""Pipeline parallelism in the port (A10) against the JAX package's, on the
CPU.

In one process, the port's stage ops, pcg/pipeline.py, pricing, memory
model and search against the JAX package's:

- the 1F1B and sequential action tables are array-equal for S in
  {1, 2, 3, 4, 8} x M in {1, 2, 4, 8}, and so are the bubble, leaf-factor
  and in-flight formulas;
- analyze_pipeline, pipeline_contexts and insert_pipeline_stages agree on
  tests/test_pipeline.py's `_chain_pcg` chains (by node index), and both
  raise on the same bad S and M;
- stage ops survive the file format (each package reads the other's) and
  the reshard-chain normalizations;
- the analytic Python DP prices pipelined seeds alike (stage transfers,
  leaf factors, whole plans within relative 1e-12) and exports the same
  stage edges;
- analyze_memory's per-device peaks are equal, and so is the budget at
  which every flat plan is infeasible and a pipelined one feasible
  (tests/test_pipeline.py's TestMemory), the winner verified;
- the seed labels are equal, a flat search's winner is unchanged without
  the flag, and the stage-pair rule applies;
- the unsupported structures of the JAX test's :613 raise, and so does a
  pre-LN block's region, which the JAX extraction admits.

Over gloo ranks (2 and 4 processes, each count launched once per session,
every group and join limited to 120 s):

- the executor at f32 and dropout 0 against the JAX
  PipelinedTrainingInstance on virtual devices, from the JAX instance's
  stacked initial state: pp2m4 on 2 ranks, pp2m4 x dp2 and pp4m2 on 4;
  losses and parameters after 3 steps within 1e-5;
- port against port, Dropout 0.1: the 1F1B step bitwise equal to the
  sequential schedule (FF_TPU_PIPELINE_BASELINE=1), and a K=4 window
  bitwise equal to 4 steps;
- FFModel (pipeline=True, a forced pp seed): the compile picks the 1F1B
  executor with the JAX package's provenance and audits the plan, fit
  trains with the health stream on, the step span carries the pipeline's
  args, a run killed
  mid-window and resumed ends bitwise equal to the uninterrupted one, a
  JAX pipelined checkpoint restores into the port and the port's into
  the JAX FFModel; a structure the executor refuses trains flat.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import numpy as np
import pytest

import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu.analysis.memory_analysis import analyze_memory as j_analyze_memory
from flexflow_tpu.analysis.memory_analysis import verify_memory as j_verify_memory
from flexflow_tpu.compiler.unity_algorithm import (
    enumerate_pipeline_seeds as j_pipe_seeds,
    enumerate_seeds as j_seeds,
    pipeline_seed as j_pipeline_seed,
)
from flexflow_tpu.op_attrs.activation import Activation as JAct
from flexflow_tpu.op_attrs.datatype import DataType as JDType
from flexflow_tpu.op_attrs.parallel_tensor_shape import lift_to_parallel as j_lift
from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JShape
from flexflow_tpu.pcg import pipeline as JP
from flexflow_tpu.pcg.file_format import pcg_from_json as j_from_json
from flexflow_tpu.pcg.file_format import pcg_to_json as j_to_json
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder as JBuilder,
)
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu_torch.analysis.memory_analysis import analyze_memory, verify_memory
from flexflow_tpu_torch.compiler.unity_algorithm import (
    enumerate_pipeline_seeds,
    enumerate_seeds,
    pipeline_seed,
)
from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import lift_to_parallel
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.pcg import pipeline as TP
from flexflow_tpu_torch.pcg.file_format import pcg_from_json, pcg_to_json
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder,
)
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12
TOL = 1e-5
JOIN_S = 120


def _chain(pkg: str, L=8, d=64, B=32, dropout=0.0):
    """tests/test_pipeline.py's _chain_pcg, in either package."""
    if pkg == "jax":
        b, act, shape = JBuilder(), JAct, j_lift(JShape((B, d), JDType.FLOAT))
        from flexflow_tpu.op_attrs.ops import DropoutAttrs
    else:
        b, act, shape = ParallelComputationGraphBuilder(), Activation, lift_to_parallel(
            TensorShape((B, d), DataType.FLOAT))
        from flexflow_tpu_torch.op_attrs.ops import DropoutAttrs
    h = b.create_input_tensor(shape, name="x")
    for i in range(L):
        h = b.dense(h, d, activation=act.RELU, name=f"l{i}")
        if dropout > 0:
            (h,) = b.add_layer(DropoutAttrs(dropout), [h], [], f"do{i}")
    return b.graph


def _estimators(ndev=8, budget=0.0, latency=(0.1, 0.2)):
    """Both analytic estimators and contexts on tests/test_pipeline.py's
    constants (SPEC8: 8 devices, 1 and 2 GB/s)."""
    ts, js = MachineSpecification(1, 1, ndev, 1.0, 2.0), JSpec(1, 1, ndev, 1.0, 2.0)
    te = T.AnalyticGPUCostEstimator(ts, 5e10, 10.0, intra_latency_ms=latency[0],
                                    inter_latency_ms=latency[1], emulated_mesh=True)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=5e10, hbm_gbps=10.0, ici_latency_ms=latency[0],
                                    dcn_latency_ms=latency[1], emulated_mesh=True)
    kw = dict(overlap_fraction=0.5, memory_budget_bytes=budget, optimizer_state_slots=2,
              steps_per_dispatch=1)
    return (ts, T.MachineMappingContext(te, T.make_default_allowed_machine_views(), **kw),
            js, J.MachineMappingContext(je, J.make_default_allowed_machine_views(), **kw))


@pytest.fixture
def python_dp(monkeypatch):
    """The JAX package's Python DP (its native core off)."""
    from flexflow_tpu import native_lib

    monkeypatch.setenv("FF_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native_lib, "_lib", None)


# -- schedules and formulas ----------------------------------------------------


@pytest.mark.parametrize("S", [1, 2, 3, 4, 8])
def test_schedules_and_formulas_equal(S):
    for M in (1, 2, 4, 8):
        for name in ("one_f_one_b_schedule", "sequential_microbatch_schedule"):
            for t, j in zip(getattr(TP, name)(S, M), getattr(JP, name)(S, M)):
                assert t.dtype == j.dtype and np.array_equal(t, j), (name, S, M)
        assert TP.pipeline_bubble_fraction(S, M) == JP.pipeline_bubble_fraction(S, M)
        assert TP.pipeline_leaf_factor(S, M) == JP.pipeline_leaf_factor(S, M)
        assert [TP.stage_inflight_bound(S, s, M) for s in range(S)] == [
            JP.stage_inflight_bound(S, s, M) for s in range(S)]


# -- stage ops and structure ---------------------------------------------------


def test_stage_ops_identity_and_kinds():
    import torch

    from flexflow_tpu_torch.kernels import forward
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op, is_stage_op
    from flexflow_tpu_torch.op_attrs.ops import StageMergeAttrs, StagePartitionAttrs

    shape = lift_to_parallel(TensorShape((16, 32), DataType.FLOAT))
    assert StagePartitionAttrs(2, 4, 1).parallel_output_shape(shape) == shape
    assert StageMergeAttrs(2, 4).parallel_output_shape(shape) == shape
    assert StagePartitionAttrs(2, 4, 0).output_shape(TensorShape((16, 32), DataType.FLOAT)) == \
        TensorShape((16, 32), DataType.FLOAT)
    for attrs in (StagePartitionAttrs(2, 2, 0), StageMergeAttrs(2, 2)):
        assert is_stage_op(attrs) and not is_parallel_op(attrs)
        x = torch.arange(8.0).reshape(2, 4)
        (y,) = forward(attrs, [x])
        assert torch.equal(x, y)


def _idx_region(region):
    if region is None:
        return None
    return (region.num_stages, region.num_microbatches, [n.idx for n in region.partition_nodes],
            region.merge_node.idx if region.merge_node is not None else None,
            {n.idx: s for n, s in region.stage_of.items()},
            [(rid, msg, node) for rid, msg, node in region.issues])


@pytest.mark.parametrize("L,S,M,B", [(8, 2, 4, 32), (8, 4, 8, 32), (8, 8, 16, 64),
                                     (4, 2, 4, 16)])
def test_insert_analyze_and_contexts_agree(L, S, M, B):
    tp = TP.insert_pipeline_stages(_chain("torch", L=L, B=B), S, M)
    jp = JP.insert_pipeline_stages(_chain("jax", L=L, B=B), S, M)
    assert len(tp.nodes) == len(jp.nodes)
    assert [type(tp.op_attrs(n)).__name__ for n in tp.topological_ordering()] == [
        type(jp.op_attrs(n)).__name__ for n in jp.topological_ordering()]
    assert _idx_region(TP.analyze_pipeline(tp)) == _idx_region(JP.analyze_pipeline(jp))
    tctx = {n.idx: (c.num_stages, c.num_microbatches, c.stage)
            for n, c in TP.pipeline_contexts(tp).items()}
    jctx = {n.idx: (c.num_stages, c.num_microbatches, c.stage)
            for n, c in JP.pipeline_contexts(jp).items()}
    assert tctx == jctx and {c[2] for c in tctx.values()} == set(range(S))
    assert TP.pipeline_contexts(_chain("torch", L=L, B=B)) == {}


@pytest.mark.parametrize("S,M", [(3, 4), (2, 3), (1, 4), (2, 0), (16, 2)])
def test_bad_stage_counts_raise_alike(S, M):
    with pytest.raises(ValueError):
        TP.insert_pipeline_stages(_chain("torch"), S, M)
    with pytest.raises(ValueError):
        JP.insert_pipeline_stages(_chain("jax"), S, M)


def test_already_staged_raises_alike():
    with pytest.raises(ValueError, match="already carries stage ops"):
        TP.insert_pipeline_stages(TP.insert_pipeline_stages(_chain("torch"), 2, 4), 2, 4)
    with pytest.raises(ValueError, match="already carries stage ops"):
        JP.insert_pipeline_stages(JP.insert_pipeline_stages(_chain("jax"), 2, 4), 2, 4)


def _malformed(pkg: str, kind: str):
    """The PCG009/PCG010 shapes of tests/test_pipeline.py's verifier tests."""
    b = JBuilder() if pkg == "jax" else ParallelComputationGraphBuilder()
    lift, shape = (j_lift, JShape) if pkg == "jax" else (lift_to_parallel, TensorShape)
    dt = JDType.FLOAT if pkg == "jax" else DataType.FLOAT
    rows, s1, m1 = {"missing": (8, 3, 4), "attrs": (8, 2, 4), "divide": (10, 2, 4)}[kind]
    h = b.parallel_stage_partition(b.create_input_tensor(lift(shape((rows, 16), dt)), name="x"),
                                   s1, m1, 0)
    h = b.dense(h, 16)
    h = b.parallel_stage_partition(h, s1, 8 if kind == "attrs" else m1, 1)
    h = b.dense(h, 16)
    b.parallel_stage_merge(h, s1, m1)
    return b.graph


@pytest.mark.parametrize("kind", ["missing", "attrs", "divide"])
def test_malformed_regions_report_alike(kind):
    t = TP.analyze_pipeline(_malformed("torch", kind))
    j = JP.analyze_pipeline(_malformed("jax", kind))
    assert not t.ok and _idx_region(t) == _idx_region(j)
    assert TP.pipeline_contexts(_malformed("torch", kind)) == {}


def test_file_format_round_trip_both_ways_and_normalization():
    from flexflow_tpu_torch.pcg.parallel_computation_graph import (
        canonicalize_parallel_chains,
        cse_parallel_ops,
        merge_parallel_chains,
    )

    tp = TP.insert_pipeline_stages(_chain("torch", L=4), 2, 4)
    jp = JP.insert_pipeline_stages(_chain("jax", L=4), 2, 4)
    for got in (pcg_from_json(pcg_to_json(tp)), pcg_from_json(j_to_json(jp))):
        assert _idx_region(TP.analyze_pipeline(got)) == _idx_region(TP.analyze_pipeline(tp))
    back = j_from_json(pcg_to_json(tp))
    assert _idx_region(JP.analyze_pipeline(back)) == _idx_region(JP.analyze_pipeline(jp))
    out = canonicalize_parallel_chains(merge_parallel_chains(cse_parallel_ops(
        pipeline_seed(_chain("torch", L=4), 2, 4, inner_dp=4))))
    region = TP.analyze_pipeline(out)
    assert region is not None and region.ok


# -- pricing ---------------------------------------------------------------------


def test_stage_transfer_and_leaf_factor_equal():
    from flexflow_tpu.compiler.machine_mapping.cost_estimator import (
        stage_transfer_cost_ms as j_stage_ms,
    )
    from flexflow_tpu.compiler.machine_mapping.get_optimal_machine_mapping import (
        leaf_pipeline_factor as j_factor,
    )
    from flexflow_tpu.compiler.machine_mapping.problem_tree import _leaf_key as j_leaf_key
    from flexflow_tpu.op_attrs import ops as jops
    from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import stage_transfer_cost_ms
    from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
        leaf_pipeline_factor,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _leaf_key
    from flexflow_tpu_torch.op_attrs import ops as tops

    ts, _, js, _ = _estimators()
    tshape = lift_to_parallel(TensorShape((32, 64), DataType.FLOAT))
    jshape = j_lift(JShape((32, 64), JDType.FLOAT))
    for args in ((2, 4, 1), (2, 4, 0), (4, 8, 3)):
        t = stage_transfer_cost_ms(tops.StagePartitionAttrs(*args), [tshape], ts, 0.1, 0.2)
        j = j_stage_ms(jops.StagePartitionAttrs(*args), [jshape], js, 0.1, 0.2)
        assert t == j
    assert stage_transfer_cost_ms(tops.StageMergeAttrs(2, 4), [tshape], ts, 0.1, 0.2) == 0.0
    tp = TP.insert_pipeline_stages(_chain("torch", L=4), 2, 4)
    jp = JP.insert_pipeline_stages(_chain("jax", L=4), 2, 4)
    tf = {n.idx: leaf_pipeline_factor(_leaf_key(tp, n)) for n in tp.nodes}
    jf = {n.idx: j_factor(j_leaf_key(jp, n)) for n in jp.nodes}
    assert tf == jf and TP.pipeline_leaf_factor(2, 4) in tf.values() and 1.0 in tf.values()


def test_python_dp_prices_pipelined_seeds_alike(python_dp):
    ts, tctx, js, jctx = _estimators()
    for budget in (0.0, 4 * 2 ** 20):
        ts, tctx, js, jctx = _estimators(budget=budget)
        tseeds = dict(enumerate_pipeline_seeds(_chain("torch", B=64), 8))
        jseeds = dict(j_pipe_seeds(_chain("jax", B=64), 8))
        assert list(tseeds) == list(jseeds) == ["pp2m4xdp4", "pp4m8xdp2", "pp8m16"]
        for label in tseeds:
            t = T.evaluate_pcg(tseeds[label], tctx, ts, T.MachineMappingCache())
            j = J.evaluate_pcg(jseeds[label], jctx, js, J.MachineMappingCache())
            assert (t is None) == (j is None), label
            if t is not None:
                assert math.isclose(t.runtime, j.runtime, rel_tol=RTOL), label


def test_pipelined_cost_reflects_bubble_in_both(python_dp):
    """With zero link latency the larger microbatch count is cheaper in
    both packages, by the same factor."""
    ts, tctx, js, jctx = _estimators(latency=(0.0, 0.0))
    runs = {}
    for M in (4, 16):
        t = T.evaluate_pcg(TP.insert_pipeline_stages(_chain("torch", B=64), 4, M), tctx, ts,
                           T.MachineMappingCache()).runtime
        j = J.evaluate_pcg(JP.insert_pipeline_stages(_chain("jax", B=64), 4, M), jctx, js,
                           J.MachineMappingCache()).runtime
        assert math.isclose(t, j, rel_tol=RTOL)
        runs[M] = t
    assert runs[16] < runs[4]


def test_movement_export_stage_edges_match(python_dp):
    from flexflow_tpu.compiler.machine_mapping.movement_export import (
        export_movement_predictions as j_export,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.movement_export import (
        export_movement_predictions,
    )

    ts, tctx, js, jctx = _estimators()
    tp = pipeline_seed(_chain("torch", B=64), 4, 8, inner_dp=2)
    jp = j_pipeline_seed(_chain("jax", B=64), 4, 8, inner_dp=2)
    tr = T.evaluate_pcg(tp, tctx, ts, T.MachineMappingCache())
    jr = J.evaluate_pcg(jp, jctx, js, J.MachineMappingCache())
    tmap = {n.idx: v for n, v in tr.machine_mapping.items()}
    jmap = {n.idx: v for n, v in jr.machine_mapping.items()}
    assert set(tmap) == set(jmap)
    te = [e for e in export_movement_predictions(tp, tr.machine_mapping, tctx.cost_estimator)
          if e.kind.startswith("Stage")]
    je = [e for e in j_export(jp, jr.machine_mapping, jctx.cost_estimator)
          if e.kind.startswith("Stage")]
    assert len(te) == len(je) == 4 + 1
    link = {"nvlink": "ici", "ib": "dcn"}  # the port's names of the JAX package's classes
    for t, j in zip(te, je):
        assert (t.node_idx, t.kind, t.degree, t.bytes_global, t.predicted_bytes, t.templates,
                link[t.link_class]) == (j.node_idx, j.kind, j.degree, j.bytes_global,
                                        j.predicted_bytes, j.templates, j.link_class)
        assert math.isclose(t.predicted_ms, j.predicted_ms, rel_tol=RTOL)
    assert sum(1 for e in te if e.templates and e.templates[0][0] == "p2p") == 3


# -- memory ------------------------------------------------------------------------


def _seed_peaks(pkg: str, ndev=8):
    """label -> (runtime, per-device peaks) over the flat and pipeline seeds
    of tests/test_pipeline.py's TestMemory chain."""
    ts, tctx, js, jctx = _estimators(ndev)
    if pkg == "jax":
        seeds = list(j_seeds(_chain("jax", d=128), ndev)) + list(j_pipe_seeds(_chain("jax", d=128),
                                                                              ndev))
        ev, cache, spec, ctx, mem = J.evaluate_pcg, J.MachineMappingCache, js, jctx, \
            j_analyze_memory
    else:
        seeds = list(enumerate_seeds(_chain("torch", d=128), ndev)) + list(
            enumerate_pipeline_seeds(_chain("torch", d=128), ndev))
        ev, cache, spec, ctx, mem = T.evaluate_pcg, T.MachineMappingCache, ts, tctx, \
            analyze_memory
    out = {}
    for label, seed in seeds:
        r = ev(seed, ctx, spec, cache())
        if r is not None:
            a = mem(seed, spec, r.machine_mapping)
            out[label] = (r.runtime, {d: t.peak_bytes for d, t in a.per_device.items()})
    return out


def test_memory_peaks_equal_and_stage_placement_cuts_them(python_dp):
    t, j = _seed_peaks("torch"), _seed_peaks("jax")
    assert t.keys() == j.keys() and any(k.startswith("pp") for k in t)
    for label in t:
        assert math.isclose(t[label][0], j[label][0], rel_tol=RTOL), label
        assert t[label][1] == j[label][1], label
    ts = MachineSpecification(1, 1, 8, 1.0, 2.0)
    flat = analyze_memory(_chain("torch", d=128), ts).max_peak_bytes()
    pipe = analyze_memory(TP.insert_pipeline_stages(_chain("torch", d=128), 4, 8), ts)
    assert pipe.max_peak_bytes() < 0.5 * flat


def test_leaf_stash_scaling_equal():
    from flexflow_tpu.analysis.memory_accounting import leaf_step_memory_bytes as j_leaf_bytes
    from flexflow_tpu.compiler.machine_mapping.problem_tree import _leaf_key as j_leaf_key
    from flexflow_tpu_torch.analysis.memory_accounting import leaf_step_memory_bytes
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _leaf_key

    tp = TP.insert_pipeline_stages(_chain("torch", L=4), 2, 4)
    jp = JP.insert_pipeline_stages(_chain("jax", L=4), 2, 4)
    t = {n.idx: leaf_step_memory_bytes(_leaf_key(tp, n), 2, 1) for n in tp.nodes}
    j = {n.idx: j_leaf_bytes(j_leaf_key(jp, n), 2, 1) for n in jp.nodes}
    assert t == j
    x, w = 32 * 64 * 4, 64 * 64 * 4 + 64 * 4  # the hand count of tests/test_pipeline.py
    assert w * 4 + (2 * x) // 2 + (2 * x) // 4 in t.values()


def test_budget_flat_infeasible_pipelined_feasible_alike(python_dp):
    t, j = _seed_peaks("torch"), _seed_peaks("jax")
    best = {pkg: (min(max(v[1].values()) for k, v in p.items() if k.startswith("pp")),
                  min(max(v[1].values()) for k, v in p.items() if not k.startswith("pp")))
            for pkg, p in (("torch", t), ("jax", j))}
    assert best["torch"] == best["jax"]
    pipe, flat = best["torch"]
    assert pipe < flat
    budget = (pipe + flat) / 2
    ts, tctx, js, jctx = _estimators(budget=budget)
    assert T.evaluate_pcg(_chain("torch", d=128), tctx, ts, T.MachineMappingCache()) is None
    assert J.evaluate_pcg(_chain("jax", d=128), jctx, js, J.MachineMappingCache()) is None
    tr = T.graph_optimize(_chain("torch", d=128), tctx, ts, generate_parallelization_rules(
        [2, 4, 8]), T.OptimizerConfig(budget=1, pipeline_seeds=True))
    jr = J.graph_optimize(_chain("jax", d=128), jctx, js, j_rules([2, 4, 8]),
                          J.OptimizerConfig(budget=1, pipeline_seeds=True))
    assert TP.analyze_pipeline(tr.pcg).ok and tr.serial_runtime is None
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert tr.seed_runtimes.keys() == jr.seed_runtimes.keys()
    from flexflow_tpu_torch.analysis.diagnostics import has_errors

    _, diags = verify_memory(tr.pcg, ts, tr.machine_mapping, hbm_bytes=budget)
    assert not has_errors(diags)
    _, tflat = verify_memory(_chain("torch", d=128), ts, None, hbm_bytes=budget)
    _, jflat = j_verify_memory(_chain("jax", d=128), js, None, hbm_bytes=budget)
    assert has_errors(tflat) and [d.rule_id for d in tflat] == [d.rule_id for d in jflat]


# -- search and rules ---------------------------------------------------------------


def test_seed_labels_equal_and_flat_winner_unchanged(python_dp):
    for ndev, B in ((8, 64), (4, 32)):
        tl = [label for label, _ in enumerate_pipeline_seeds(_chain("torch", B=B), ndev)]
        jl = [label for label, _ in j_pipe_seeds(_chain("jax", B=B), ndev)]
        assert tl == jl and tl and all(label.startswith("pp") for label in tl)
    ts, tctx, js, jctx = _estimators()
    off = T.graph_optimize(_chain("torch", L=4), tctx, ts, generate_parallelization_rules([2]),
                           T.OptimizerConfig(budget=1))
    assert TP.analyze_pipeline(off.pcg) is None
    assert not any(k.startswith("pp") for k in off.seed_runtimes or {})
    on = T.graph_optimize(_chain("torch", L=4), tctx, ts, generate_parallelization_rules([2]),
                          T.OptimizerConfig(budget=1, pipeline_seeds=True))
    assert any(k.startswith("pp") for k in on.seed_runtimes)
    # unbudgeted, the flat winner stays the winner
    assert math.isclose(on.runtime, off.runtime, rel_tol=RTOL)


def test_pipeline_rule_applies():
    from flexflow_tpu_torch.compiler.unity_algorithm import greedy_apply
    from flexflow_tpu_torch.substitutions.rules import pipeline_stage_pair_rule

    out = greedy_apply(_chain("torch", L=2, d=16, B=16),
                       [pipeline_stage_pair_rule(4, use_bias=True)], max_steps=4)
    region = TP.analyze_pipeline(out)
    assert region is not None and region.ok
    assert (region.num_stages, region.num_microbatches) == (2, 4)


# -- what the executor refuses --------------------------------------------------------


def _non_uniform(pkg: str):
    b = JBuilder() if pkg == "jax" else ParallelComputationGraphBuilder()
    shape = (j_lift(JShape((8, 16), JDType.FLOAT)) if pkg == "jax"
             else lift_to_parallel(TensorShape((8, 16), DataType.FLOAT)))
    h = b.parallel_stage_partition(b.create_input_tensor(shape, name="x"), 2, 4, 0)
    h = b.dense(h, 32, name="wide")
    h = b.parallel_stage_partition(h, 2, 4, 1)
    h = b.dense(h, 16, name="narrow")
    b.parallel_stage_merge(h, 2, 4)
    return b.graph


def _pre_ln(pkg: str, blocks=2, d=16, B=8):
    """Pre-LN residual blocks, x + relu(dense(layer_norm(x))): the region's
    entry value also feeds the residual add."""
    b = JBuilder() if pkg == "jax" else ParallelComputationGraphBuilder()
    shape = (j_lift(JShape((B, d), JDType.FLOAT)) if pkg == "jax"
             else lift_to_parallel(TensorShape((B, d), DataType.FLOAT)))
    act = JAct if pkg == "jax" else Activation
    h = b.create_input_tensor(shape, name="x")
    for i in range(blocks):
        y = b.dense(b.layer_norm(h, [1], name=f"ln{i}"), d, activation=act.RELU, name=f"fc{i}")
        h = b.add(h, y, name=f"res{i}")
    return b.graph


def test_unsupported_structures_raise():
    from flexflow_tpu.parallel.pipeline import extract_executable_pipeline as j_extract
    from flexflow_tpu_torch.parallel.pipeline import (
        PipelineUnsupported,
        extract_executable_pipeline,
    )

    with pytest.raises(PipelineUnsupported, match="disagree on shape"):
        extract_executable_pipeline(_non_uniform("torch"))
    with pytest.raises(Exception):
        j_extract(_non_uniform("jax"))
    with pytest.raises(PipelineUnsupported, match="no stage ops"):
        extract_executable_pipeline(_chain("torch", L=2))
    # the pre-LN region: the JAX extraction admits it (and then fails in
    # its stage function); the port refuses it at extraction
    tp = TP.insert_pipeline_stages(_pre_ln("torch"), 2, 4)
    jp = JP.insert_pipeline_stages(_pre_ln("jax"), 2, 4)
    assert TP.analyze_pipeline(tp).ok and JP.analyze_pipeline(jp).ok
    j_extract(jp)
    with pytest.raises(PipelineUnsupported, match="outside the entry slot"):
        extract_executable_pipeline(tp)


def test_measured_bubble_reads_the_tick_model():
    """bench.py --pipeline's reading: where every tick costs the same (its
    overhead alone, no unit work) the idle share is the structural bubble
    b(S, M); where the units dominate it is the table's idle work share."""
    from flexflow_tpu_torch.parallel.pipeline import measured_bubble_fraction

    for S, M in ((2, 4), (4, 8), (2, 2)):
        o, ticks, ticks_seq = 0.25, 2 * (M + S - 1), 2 * M * S
        b = measured_bubble_fraction(S, M, ticks * o, ticks_seq * o)
        assert math.isclose(b, TP.pipeline_bubble_fraction(S, M), rel_tol=1e-12)
        fwd, bwd = TP.one_f_one_b_schedule(S, M)
        act = ((fwd >= 0) | (bwd >= 0)).sum(axis=1)
        units = measured_bubble_fraction(S, M, 2 * M * S * 0.5, 2 * M * S * 0.5)
        assert math.isclose(units, float(((S - act) * act).sum() / (S * act.sum())),
                            rel_tol=1e-12)


def test_measured_bubble_refuses_times_no_tick_model_fits():
    """A 1F1B step slower than the sequential one (a negative tick overhead)
    or than its ticks' overhead alone (negative unit work) reads as no
    bubble, not as the table's idle share or b(S, M)."""
    from flexflow_tpu_torch.parallel.pipeline import measured_bubble_fraction

    assert measured_bubble_fraction(2, 4, 68.57, 59.88) is None
    # o = (16 - 8) / 6 ms a tick, so the 10 ticks alone take 13.3 ms > 8
    assert measured_bubble_fraction(2, 4, 8.0, 16.0) is None
    assert measured_bubble_fraction(2, 4, 17.15, 22.58) is not None


# -- over gloo ranks ------------------------------------------------------------------------

BATCH, DIM = 16, 16
STEPS_PER_EPOCH = 8
JAX_CASES = {2: [("pp2m4", 2, 4)], 4: [("pp2m4xdp2", 2, 4), ("pp4m2", 4, 2)]}


def ff_build(pkg, device=None, k=1, ckpt_dir="", every=0, dropout=True, seed="pp2m4",
             widths=(DIM, DIM, DIM, DIM), **cfg):
    """tests/test_pipeline.py's FFModel fixture, in either package."""
    kw = {} if device is None else dict(device=device)
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, seed=0, steps_per_dispatch=k, print_freq=0,
                                 search_budget=1, checkpoint_dir=ckpt_dir,
                                 checkpoint_every_n_steps=every, pipeline=True,
                                 force_strategy_seed=seed, **cfg), **kw)
    h = m.create_tensor([BATCH, DIM], name="x")
    for i, w in enumerate(widths):
        h = m.relu(m.dense(h, w, name=f"fc{i}"))
        if dropout:
            h = m.dropout(h, 0.1)
    m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=h)
    return m


def ff_data(seed=0):
    rs = np.random.RandomState(seed)
    return (rs.randn(BATCH * STEPS_PER_EPOCH, DIM).astype(np.float32),
            rs.randint(0, DIM, BATCH * STEPS_PER_EPOCH))


def chain_data(B=BATCH, d=DIM, seed=7):
    rs = np.random.RandomState(seed)
    return rs.randn(B, d).astype(np.float32), rs.randint(0, d, (B,)).astype(np.int32)


# One rank; argv: rank, world, work dir.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    sys.path.insert(0, os.path.join(os.getcwd(), "tests"))
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.parallel.pipeline import PipelinedTrainingInstance
    from flexflow_tpu_torch.pcg.optimizer import AdamOptimizerAttrs
    from flexflow_tpu_torch.pcg.pipeline import insert_pipeline_stages, analyze_pipeline
    from flexflow_tpu_torch.runtime.fault import SimulatedFault

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "build.py")).read())  # the test's builders
    res = {}

    def instance(S, M, dropout=0.0):
        pcg = insert_pipeline_stages(chain(L=4, d=DIM, B=BATCH, dropout=dropout), S, M)
        logit = pcg.outputs_of(analyze_pipeline(pcg).merge_node)[0]
        return PipelinedTrainingInstance(pcg, logit, SparseCategoricalCrossEntropyLossAttrs(),
                                         AdamOptimizerAttrs(alpha=1e-2), device="cpu")

    def train(inst, steps, init=None, k=1):
        p, o = inst.initialize(0)
        if init is not None:
            inst.load_stacked_state(p, o, init)
        xv, yv = chain_data()
        g = torch.Generator().manual_seed(5)
        losses = []
        if k == 1:
            for _ in range(steps):
                p, o, loss, _ = inst.train_step(p, o, {"x": xv}, yv, g)
                losses.append(float(loss))
        else:
            xs = torch.as_tensor(np.broadcast_to(xv, (k,) + xv.shape).copy())
            ys = torch.as_tensor(np.broadcast_to(yv, (k,) + yv.shape).copy())
            for _ in range(steps // k):
                p, o, g, lv, _ = inst.multi_train_step(p, o, {"x": xs}, ys, g)
                losses += lv.tolist()
        return losses, inst.stacked_state(p, o)

    def save(name, state):
        if rank == 0:
            np.savez(os.path.join(work, name + ".npz"),
                     **{"params/" + k: v for k, v in state["params"].items()},
                     **{"m/" + k: v for k, v in state["opt_state"]["m"].items()},
                     **{"v/" + k: v for k, v in state["opt_state"]["v"].items()})

    # the executor against the JAX instance, from its initial state
    for label, S, M in JAX_CASES[world]:
        z = np.load(os.path.join(work, f"jax_{label}_init.npz"))
        losses, state = train(instance(S, M), 3, init={k: z[k] for k in z.files})
        res[label] = losses
        save(f"port_{label}", state)

    # 1F1B against the sequential schedule, and a window against its steps
    S = 2
    M = 4
    one, s_one = train(instance(S, M, dropout=0.1), 4)
    os.environ["FF_TPU_PIPELINE_BASELINE"] = "1"
    inst = instance(S, M, dropout=0.1)
    seq, s_seq = train(inst, 4)
    res["baseline_schedule"] = inst.schedule_name
    del os.environ["FF_TPU_PIPELINE_BASELINE"]
    win, s_win = train(instance(S, M, dropout=0.1), 4, k=4)

    def same(a, b):
        return all(np.array_equal(a["params"][k], b["params"][k])
                   and np.array_equal(a["opt_state"]["m"][k], b["opt_state"]["m"][k])
                   and np.array_equal(a["opt_state"]["v"][k], b["opt_state"]["v"][k])
                   for k in a["params"])

    res["bitwise"] = dict(losses_seq=one == seq, state_seq=same(s_one, s_seq),
                          losses_win=one == win, state_win=same(s_one, s_win),
                          moved=not np.array_equal(s_one["params"][sorted(s_one["params"])[0]],
                                                   s_seq["params"][sorted(s_seq["params"])[0]] * 0))

    if world == 2:
        from flexflow_tpu_torch.observability.metrics import read_events
        from flexflow_tpu_torch.observability.trace import TraceRecorder, set_recorder

        x, y = ff_data()
        events = os.path.join(work, f"events{rank}")
        m = ff_build(core, device="cpu", dropout=False, metrics_dir=events, plan_audit=True)
        audit = m.search_provenance["plan_audit"]
        res["ffmodel"] = dict(kind=type(m.instance).__name__,
                              pipeline=m.search_provenance["pipeline"],
                              audit=[audit.get("error"), audit.get("num_ops"),
                                     sorted({e["op_type"] for e in audit.get("ops", [])
                                             if e["op_type"].startswith("Stage")})])
        perf = m.fit(x, y, epochs=1, verbose=False)
        res["ffmodel"]["fit"] = [float(perf.train_all), bool(np.isfinite(float(m.instance.forward(
            m.params, {"x": x[:BATCH]}).sum())))]
        ev = m.eval(x, y)
        res["ffmodel"]["eval_all"] = float(ev.train_all)
        steps = [e for e in read_events(events) if "step" in e] if rank == 0 else []
        res["ffmodel"]["events"] = [len(steps), all(np.isfinite(e["grad_norm"]) for e in steps)]
        rec = TraceRecorder()
        set_recorder(rec)
        m.instance.train_step(m.params, m.opt_state, {"x": x[:BATCH]}, y[:BATCH])
        set_recorder(None)
        span = rec.spans_named("step")[0].args
        res["ffmodel"]["span"] = [span["pipeline_stages"], span["pipeline_microbatches"]]

        def losses_of(m):
            out, multi = {}, m.instance.multi_train_step

            def recorded(*a, **k):
                r = multi(*a, **k)
                for i, v in enumerate(r[3].tolist()):
                    out[m._step_count + i + 1] = v
                return r

            m.instance.multi_train_step = recorded
            return out

        def run(cdir, **fit):
            m = ff_build(core, device="cpu", k=4, ckpt_dir=cdir, every=8)
            losses = losses_of(m)
            try:
                m.fit(x, y, epochs=2, shuffle=True, verbose=False, **fit)
                outcome = "completed"
            except SimulatedFault:
                outcome = "SimulatedFault"
            return m, losses, outcome

        ref, ref_losses, _ = run(os.path.join(work, "ref"))
        os.environ["FF_TPU_FAULT_STEP"] = "10"
        _, first, outcome = run(os.path.join(work, "killed"))
        del os.environ["FF_TPU_FAULT_STEP"]
        resumed, second, _ = run(os.path.join(work, "killed"), resume=True)
        a = ref._checkpoint_state()
        b = resumed._checkpoint_state()
        res["resume"] = dict(outcome=outcome, ref=ref_losses, first=first, second=second,
                             state=same(a, b))
        resumed.save_checkpoint(os.path.join(work, "port_ckpt"))
        save("port_ckpt_state", b)

        # the JAX FFModel's pipelined checkpoint, restored by the port
        m = ff_build(core, device="cpu")
        step = m.load_checkpoint(os.path.join(work, "jax_ckpt"))
        save("port_from_jax", m._checkpoint_state())
        res["from_jax_step"] = step

        # a structure the 1F1B executor refuses trains flat
        m = ff_build(core, device="cpu", dropout=False, widths=(32, DIM, DIM, DIM))
        res["fallback"] = dict(kind=type(m.instance).__name__,
                               pipeline=m.search_provenance["pipeline"])
        m.fit(x, y, epochs=1, verbose=False)
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()
    """
)


def _jax_references(work: Path, world: int) -> dict:
    """The JAX PipelinedTrainingInstance's cases of this rank count on
    virtual devices: initial stacked state (written for the ranks), losses
    and stacked state after 3 steps; for 2 ranks also the JAX FFModel's
    pipelined checkpoint."""
    import jax.numpy as jnp

    from flexflow_tpu.op_attrs.ops.loss_functions import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu.parallel.pipeline import PipelinedTrainingInstance
    from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs

    out = {}
    xv, yv = chain_data()
    for label, S, M in JAX_CASES[world]:
        pcg = JP.insert_pipeline_stages(_chain("jax", L=4, d=DIM, B=BATCH), S, M)
        logit = pcg.outputs_of(JP.analyze_pipeline(pcg).merge_node)[0]
        inst = PipelinedTrainingInstance(pcg, logit, SparseCategoricalCrossEntropyLossAttrs(),
                                         AdamOptimizerAttrs(alpha=1e-2),
                                         devices=jax.devices()[:world])
        params, opt = inst.initialize(seed=0)
        np.savez(work / f"jax_{label}_init.npz", **{k: np.asarray(v) for k, v in params.items()})
        rng = jax.random.PRNGKey(7)
        losses = []
        for _ in range(3):
            rng, srng = jax.random.split(rng)
            params, opt, loss, _ = inst.train_step(params, opt, {"x": jnp.asarray(xv)},
                                                   jnp.asarray(yv), srng)
            losses.append(float(loss))
        out[label] = dict(losses=losses, params={k: np.asarray(v) for k, v in params.items()},
                          mesh=dict(inst.mesh.shape))
    if world == 2:
        from flexflow_tpu import core as jcore

        m = ff_build(jcore, max_devices=2)
        x, y = ff_data(1)
        m.fit(x, y, epochs=1, verbose=False)
        # the JAX package picks orbax where installed; as on a host without
        # it, its npz layout, which both packages read
        saved = sys.modules.get("orbax.checkpoint", False)
        sys.modules["orbax.checkpoint"] = None
        try:
            m.save_checkpoint(str(work / "jax_ckpt"))
        finally:
            if saved is False:
                del sys.modules["orbax.checkpoint"]
            else:
                sys.modules["orbax.checkpoint"] = saved
        out["jax_ckpt_params"] = {k: np.asarray(v) for k, v in m.params.items()}
        out["jax_ckpt_kind"] = type(m.instance).__name__
    return out


def _runs(work: Path, world: int) -> dict:
    import inspect

    ref = _jax_references(work, world)
    src = "".join(inspect.getsource(f) for f in (ff_build, ff_data, chain_data))
    chain_src = textwrap.dedent('''
        def chain(L, d, B, dropout=0.0):
            from flexflow_tpu_torch.op_attrs.activation import Activation
            from flexflow_tpu_torch.op_attrs.datatype import DataType
            from flexflow_tpu_torch.op_attrs.ops import DropoutAttrs
            from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import lift_to_parallel
            from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
            from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
                ParallelComputationGraphBuilder)
            b = ParallelComputationGraphBuilder()
            h = b.create_input_tensor(lift_to_parallel(TensorShape((B, d), DataType.FLOAT)),
                                      name="x")
            for i in range(L):
                h = b.dense(h, d, activation=Activation.RELU, name=f"l{i}")
                if dropout > 0:
                    (h,) = b.add_layer(DropoutAttrs(dropout), [h], [], f"do{i}")
            return b.graph
        ''')
    (work / "build.py").write_text(
        f"BATCH = {BATCH}\nDIM = {DIM}\nSTEPS_PER_EPOCH = {STEPS_PER_EPOCH}\n"
        f"JAX_CASES = {JAX_CASES!r}\n" + src + chain_src)
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "FF_TPU_FAULT_STEP", "FF_TPU_FAULT_SPEC",
                        "FF_TPU_PIPELINE_BASELINE", "FF_TPU_PIPELINE")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=JOIN_S)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        if p.returncode != 0:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    ranks = [json.loads((work / f"rank{r}.json").read_text()) for r in range(world)]
    npz = {f.stem: dict(np.load(f)) for f in work.glob("port_*.npz")}
    out = dict(ref=ref, ranks=ranks, npz=npz)
    if world == 2:
        from flexflow_tpu import core as jcore
        from flexflow_tpu_torch.runtime.checkpoint import _flatten

        jm = ff_build(jcore, max_devices=2)
        out["jax_from_port_step"] = jm.load_checkpoint(str(work / "port_ckpt"))
        out["jax_from_port"] = {k: np.asarray(v) for k, v in _flatten(
            {"params": jax.tree_util.tree_map(np.asarray, jm.params)}).items()}
    return out


@pytest.fixture(scope="module")
def ranks2(tmp_path_factory):
    return once_per_session(tmp_path_factory, "pipeline_ranks2", lambda w: _runs(w, 2))


@pytest.fixture(scope="module")
def ranks4(tmp_path_factory):
    return once_per_session(tmp_path_factory, "pipeline_ranks4", lambda w: _runs(w, 4))


@pytest.mark.parametrize("world,label", [(2, "pp2m4"), (4, "pp2m4xdp2"), (4, "pp4m2")])
def test_executor_matches_jax(ranks2, ranks4, world, label):
    runs = ranks2 if world == 2 else ranks4
    ref = runs["ref"][label]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank[label], ref["losses"], rtol=TOL, atol=TOL)
    got = runs["npz"][f"port_{label}"]
    for k, v in ref["params"].items():
        np.testing.assert_allclose(got[f"params/{k}"], v, rtol=TOL, atol=TOL, err_msg=k)
    S, M = (4, 2) if label == "pp4m2" else (2, 4)
    assert ref["mesh"] == {"stage": S, "data": world // S}


@pytest.mark.parametrize("world", [2, 4])
def test_one_f_one_b_is_bitwise_the_sequential_schedule_and_windows(ranks2, ranks4, world):
    runs = ranks2 if world == 2 else ranks4
    for rank in runs["ranks"]:
        assert rank["baseline_schedule"] == "sequential"
        assert rank["bitwise"] == dict(losses_seq=True, state_seq=True, losses_win=True,
                                       state_win=True, moved=True)


def test_ffmodel_compiles_the_1f1b_executor_and_fits(ranks2):
    for rank in ranks2["ranks"]:
        ff = rank["ffmodel"]
        assert ff["kind"] == "PipelinedTrainingInstance"
        assert ff["pipeline"] == {"num_stages": 2, "num_microbatches": 4,
                                  "mesh": {"stage": 2, "data": 1}, "executor": "1f1b"}
        assert ff["fit"] == [BATCH * STEPS_PER_EPOCH, True]
        assert ff["eval_all"] == BATCH * STEPS_PER_EPOCH
        assert ff["span"] == [2, 4]  # the step span's pipeline args, as the JAX package's
        # the plan audit replays the pipelined plan, its stage ops among its leaves
        error, num_ops, stage_kinds = ff["audit"]
        assert error is None and num_ops > 0
        assert stage_kinds == ["StageMergeAttrs", "StagePartitionAttrs"]
    # the health stream: rank 0 writes one event a step, with global norms
    assert ranks2["ranks"][0]["ffmodel"]["events"] == [STEPS_PER_EPOCH, True]


def test_ffmodel_kill_mid_window_resume_is_bitwise(ranks2):
    for rank in ranks2["ranks"]:
        r = rank["resume"]
        ref = {int(k): v for k, v in r["ref"].items()}
        first = {int(k): v for k, v in r["first"].items()}
        second = {int(k): v for k, v in r["second"].items()}
        assert r["outcome"] == "SimulatedFault" and r["state"]
        assert sorted(ref) == list(range(1, 2 * STEPS_PER_EPOCH + 1))
        assert max(first) == 12 and sorted(second) == list(range(9, 2 * STEPS_PER_EPOCH + 1))
        assert {**first, **second} == ref
    assert ranks2["ranks"][0]["resume"]["ref"] == ranks2["ranks"][1]["resume"]["ref"]


def test_pipelined_checkpoints_cross_between_the_packages(ranks2):
    """The stacked [S, ...] layout under the template's keys: the JAX
    FFModel's checkpoint restores into the port's ranks, and the port's
    into the JAX FFModel, bitwise."""
    ref = ranks2["ref"]
    assert ref["jax_ckpt_kind"] == "PipelinedTrainingInstance"
    assert all(rank["from_jax_step"] == STEPS_PER_EPOCH for rank in ranks2["ranks"])
    got = ranks2["npz"]["port_from_jax"]
    for k, v in ref["jax_ckpt_params"].items():
        assert np.array_equal(got[f"params/{k}"], v), k
    assert ranks2["jax_from_port_step"] == 2 * STEPS_PER_EPOCH
    port = ranks2["npz"]["port_ckpt_state"]
    for k, v in ranks2["jax_from_port"].items():
        assert np.array_equal(port[k], v), k


def test_a_structure_the_executor_refuses_trains_flat(ranks2):
    for rank in ranks2["ranks"]:
        fb = rank["fallback"]
        assert fb["kind"] == "DistributedTrainingInstance"
        assert fb["pipeline"]["executor"] == "flat-fallback"
        assert "not isomorphic" in fb["pipeline"]["reason"]
