"""The port's fusion rules, legacy TASO rules, branch stacking and the Stack
op (flexflow_tpu_torch/substitutions/fusion_rules.py, legacy_rules.py,
compiler/branch_stacking.py, models/branchy.py, kernels/ops.py) against the
JAX package's (tests/test_fusion_rules.py, test_legacy_rules.py and
test_branch_stacking.py are the spec):

- the fusion rule set's names and order, each rule's matches and the
  graph each first application makes, equal the JAX package's; the fused
  graphs compute what the unfused ones do;
- the legacy loader reads a rule corpus given as text or as a path (rule
  text written by the test), converts the same rules, skips the same, and
  each converted rule matches and rewrites as the JAX one;
- graph_optimize with the fusion rules, or with a legacy rule file, on the
  analytic estimators with the same constants finds the JAX winner within
  1e-9;
- branch stacking finds the same groups and writes the same stacked graph;
  the stacked graph computes the unstacked one's logits; on the branchy
  towers the search over the stacked graph finds the JAX winner within 1e-9
  and beats every seed;
- Stack, Reduce and Broadcast: forward and vjp against the JAX ops within
  1e-6 (f32);
- over 2 gloo ranks (the shared job of tests/test_torch_port_overlap.py):
  a searched compile with perform_fusion and a legacy rule file, and a
  branch-stacked compile of the branchy towers, find the JAX FFModel's plan
  at its estimate on 2 virtual devices and train to its parameters within
  1e-5.
"""

from __future__ import annotations

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu.compiler.branch_stacking import (
    find_stackable_groups as j_groups,
    stack_isomorphic_branches as j_stack,
)
from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary
from flexflow_tpu.kernels import ops as j_kernels
from flexflow_tpu.op_attrs import ops as j_ops
from flexflow_tpu.op_attrs.activation import Activation as JAct
from flexflow_tpu.op_attrs.core import op_type_of as j_op_type
from flexflow_tpu.pcg import ComputationGraphBuilder as JBuilder
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as j_lift
from flexflow_tpu.substitutions import legacy_rules as jleg
from flexflow_tpu.substitutions.fusion_rules import generate_fusion_rules as j_fusion
from flexflow_tpu.substitutions.pcg_pattern import find_pattern_matches as j_matches
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu.substitutions.substitution import apply_substitution as j_apply
from flexflow_tpu_torch.compiler.branch_stacking import (
    find_stackable_groups as t_groups,
    stack_isomorphic_branches as t_stack,
)
from flexflow_tpu_torch.kernels import ops as t_kernels
from flexflow_tpu_torch.local_execution.training_backing import split_slot_values
from flexflow_tpu_torch.op_attrs import ops as t_ops
from flexflow_tpu_torch.op_attrs.activation import Activation as TAct
from flexflow_tpu_torch.op_attrs.core import op_type_of as t_op_type
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TBuilder
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph as t_lift
from flexflow_tpu_torch.substitutions import legacy_rules as tleg
from flexflow_tpu_torch.substitutions.fusion_rules import generate_fusion_rules as t_fusion
from flexflow_tpu_torch.substitutions.pcg_pattern import find_pattern_matches as t_matches
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from flexflow_tpu_torch.substitutions.substitution import apply_substitution as t_apply
from test_torch_port_overlap import LEGACY_RULE, check_job_against_jax, search_ranks

RTOL = 1e-9
TOL = 1e-6


def _shapes_by_node(pcg):
    op_type = t_op_type if "torch" in type(pcg).__module__ else j_op_type
    return [(op_type(pcg.op_attrs(n)).value, pcg.layer_attrs(n).name,
             [repr(pcg.tensor_shape(o)) for o in pcg.outputs_of(n)])
            for n in pcg.topological_ordering()]


def _fusion_host(builder, lift):
    """Sibling Linears of one input, a Linear chain, and Linear + unary."""
    b = builder()
    x = b.create_input([8, 16], name="x")
    q = b.dense(x, 16, use_bias=False, name="q")
    k = b.dense(x, 16, use_bias=False, name="k")
    h = b.add(q, k)
    h = b.dense(b.dense(h, 64, use_bias=False, name="up"), 16, use_bias=False, name="down")
    h = b.relu(b.dense(h, 16, use_bias=False, name="act"))
    b.gelu(b.dense(h, 8, use_bias=False, name="act2"))
    return lift(b.graph)


def _run_pcg(pcg, bindings):
    """Every value of a sequential PCG run by the port's ops in f64, the
    inputs and weights bound by layer name."""
    env = {}
    for n in pcg.topological_ordering():
        la = pcg.layer_attrs(n)
        outs = pcg.outputs_of(n)
        if type(la.attrs).__name__ in ("InputAttrs", "WeightAttrs"):
            env[outs[0]] = torch.tensor(bindings[la.name], dtype=torch.float64)
            continue
        data, w = split_slot_values(la.attrs, [env[v] for v in pcg.inputs_of(n)])
        for o, r in zip(outs, t_kernels.forward(la.attrs, data, w)):
            env[o] = r
    return env


# -- the fusion rules ------------------------------------------------------------------


def test_fusion_rules_match_and_apply_as_the_jax_ones():
    tp, jp = _fusion_host(TBuilder, t_lift), _fusion_host(JBuilder, j_lift)
    trules, jrules = t_fusion(), j_fusion()
    assert [r.name for r in trules] == [r.name for r in jrules]
    applied = 0
    for tr, jr in zip(trules, jrules):
        tm, jm = t_matches(tr.pattern, tp), j_matches(jr.pattern, jp)
        assert [sorted((p.idx, h.idx) for p, h in m.node_assignment) for m in tm] == \
            [sorted((p.idx, h.idx) for p, h in m.node_assignment) for m in jm], tr.name
        if tm:
            assert _shapes_by_node(t_apply(tp, tr, tm[0])) == _shapes_by_node(
                j_apply(jp, jr, jm[0])), tr.name
            applied += 1
    assert applied >= 4


def test_fused_graphs_compute_the_unfused_ones():
    tp = _fusion_host(TBuilder, t_lift)
    rs = np.random.RandomState(0)
    bindings = {}
    for n in tp.topological_ordering():
        la = tp.layer_attrs(n)
        if type(la.attrs).__name__ in ("InputAttrs", "WeightAttrs"):
            bindings[la.name] = rs.randn(*tp.tensor_shape(tp.outputs_of(n)[0]).sizes())
    base = _run_pcg(tp, bindings)
    sink = lambda g, env: env[g.outputs_of(g.topological_ordering()[-1])[0]]  # noqa: E731
    for rule in t_fusion():
        for match in t_matches(rule.pattern, tp):
            try:
                new = t_apply(tp, rule, match)
            except (AssertionError, KeyError, ValueError):
                continue
            got = sink(new, _run_pcg(new, bindings))
            np.testing.assert_allclose(got.numpy(), sink(tp, base).numpy(), rtol=1e-10,
                                       err_msg=rule.name)


def _contexts(ndev):
    ts = tmv.MachineSpecification(1, 1, ndev, 1.0, 2.0)
    js = jmv.MachineSpecification(1, 1, ndev, 1.0, 2.0)
    te = T.AnalyticGPUCostEstimator(ts, 5e10, 10.0, intra_latency_ms=0.1, inter_latency_ms=0.2)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=5e10, hbm_gbps=10.0, ici_latency_ms=0.1,
                                    dcn_latency_ms=0.2)
    return (ts, T.MachineMappingContext(te, T.make_default_allowed_machine_views(),
                                        overlap_fraction=0.5),
            js, J.MachineMappingContext(je, J.make_default_allowed_machine_views(),
                                        overlap_fraction=0.5))


@pytest.mark.parametrize("extra", ["fusion", "legacy"])
def test_searches_with_the_extra_rules_find_the_jax_winner(tmp_path, extra):
    ts, tctx, js, jctx = _contexts(2)
    trules, jrules = list(t_rules([2])), list(j_rules([2]))
    if extra == "fusion":
        trules += t_fusion()
        jrules += j_fusion()
    else:
        path = tmp_path / "rules.json"
        path.write_text(json.dumps(LEGACY_RULE))
        trules += tleg.load_legacy_substitutions(str(path))[0]
        jrules += jleg.load_legacy_substitutions(str(path))[0]
    tr = T.graph_optimize(_fusion_host(TBuilder, t_lift), tctx, ts, trules,
                          T.OptimizerConfig(alpha=1.2, budget=6))
    jr = J.graph_optimize(_fusion_host(JBuilder, j_lift), jctx, js, jrules,
                          J.OptimizerConfig(alpha=1.2, budget=6))
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert _shapes_by_node(tr.pcg) == _shapes_by_node(jr.pcg)
    assert tr.explored == jr.explored


# -- the legacy rules -------------------------------------------------------------------


def _corpus():
    """LEGACY_RULE plus rules the converter must skip or convert: a Linear
    data-parallel rule, a relu pair, and one with an op outside the
    vocabulary."""
    rules = list(LEGACY_RULE["rule"])

    def t(op, ts=0):
        return {"_t": "Tensor", "opId": op, "tsId": ts}

    def p(key, value):
        return {"_t": "Parameter", "key": key, "value": value}

    rules.append({"name": "linear_dp", "srcOp": [
        {"type": "OP_LINEAR", "input": [t(-1), t(-2)], "para": [p("PM_ACTI", "AC_MODE_NONE")]}],
        "dstOp": [
            {"type": "OP_PARTITION", "input": [t(-1)],
             "para": [p("PM_PARALLEL_DIM", 0), p("PM_PARALLEL_DEGREE", 2)]},
            {"type": "OP_REPLICATE", "input": [t(-2)], "para": [p("PM_PARALLEL_DEGREE", 2)]},
            {"type": "OP_LINEAR", "input": [t(0), t(1)], "para": [p("PM_ACTI", 0)]},
            {"type": "OP_COMBINE", "input": [t(2)],
             "para": [p("PM_PARALLEL_DIM", 0), p("PM_PARALLEL_DEGREE", 2)]}],
        "mappedOutput": [{"dstOpId": 3, "dstTsId": 0, "srcOpId": 0, "srcTsId": 0}]})
    rules.append({"name": "relu_partition", "srcOp": [
        {"type": "OP_RELU", "input": [t(-1)], "para": []}],
        "dstOp": [
            {"type": "OP_PARTITION", "input": [t(-1)],
             "para": [p("PM_PARALLEL_DIM", 0), p("PM_PARALLEL_DEGREE", 2)]},
            {"type": "OP_RELU", "input": [t(0)], "para": []},
            {"type": "OP_COMBINE", "input": [t(1)],
             "para": [p("PM_PARALLEL_DIM", 0), p("PM_PARALLEL_DEGREE", 2)]}],
        "mappedOutput": [{"dstOpId": 2, "dstTsId": 0, "srcOpId": 0, "srcTsId": 0}]})
    rules.append({"name": "split_unknown", "srcOp": [
        {"type": "OP_SPLIT", "input": [t(-1)], "para": [p("PM_AXIS", 1)]}],
        "dstOp": [{"type": "OP_SPLIT", "input": [t(-1)], "para": [p("PM_AXIS", 1)]}],
        "mappedOutput": [{"dstOpId": 0, "dstTsId": 0, "srcOpId": 0, "srcTsId": 0}]})
    return {"_t": "RuleCollection", "rule": rules}


@pytest.mark.parametrize("given", ["path", "text"])
def test_the_legacy_loader_converts_the_jax_rules(tmp_path, given):
    path = tmp_path / "corpus.json"
    text = json.dumps(_corpus())
    path.write_text(text)
    tsubs, tskipped = tleg.load_legacy_substitutions(str(path) if given == "path" else text)
    jsubs, jskipped = jleg.load_legacy_substitutions(str(path))
    assert (len(tsubs), tskipped) == (len(jsubs), jskipped) == (3, 1)
    assert [s.name for s in tsubs] == [s.name for s in jsubs]
    col = tleg.load_rule_collection(text)
    assert [r.name for r in col.rules] == [r.name for r in jleg.load_rule_collection(text).rules]
    tp, jp = _fusion_host(TBuilder, t_lift), _fusion_host(JBuilder, j_lift)
    applied = 0
    for ts, js in zip(tsubs, jsubs):
        tm, jm = t_matches(ts.pattern, tp), j_matches(js.pattern, jp)
        assert len(tm) == len(jm), ts.name
        if tm:
            assert _shapes_by_node(t_apply(tp, ts, tm[0])) == _shapes_by_node(
                j_apply(jp, js, jm[0])), ts.name
            applied += 1
    assert applied == 3


# -- branch stacking -----------------------------------------------------------------------


def _split_test(builder, lift, use_bias=True, act=None):
    b = builder()
    x = b.create_input([8, 32], name="x")
    t = b.dense(x, 32, activation=act[0] if act else None, name="fc0")
    a1, a2 = b.split(t, [16, 16], axis=1)
    y = b.add(b.dense(a1, 32, use_bias=use_bias, activation=act[1] if act else None,
                      name="br0"),
              b.dense(a2, 32, use_bias=use_bias, activation=act[1] if act else None,
                      name="br1"), name="merge")
    b.dense(y, 4, name="head")
    return lift(b.graph)


@pytest.mark.parametrize("use_bias,act", [(True, False), (False, True)])
def test_branch_stacking_writes_the_jax_graph(use_bias, act):
    tp = _split_test(TBuilder, t_lift, use_bias, (TAct.RELU, TAct.RELU) if act else None)
    jp = _split_test(JBuilder, j_lift, use_bias, (JAct.RELU, JAct.RELU) if act else None)
    tg, jg = t_groups(tp), j_groups(jp)
    assert [(g.merge.idx, [[l.node.idx for l in c] for c in g.chains]) for g in tg] == \
        [(g.merge.idx, [[l.node.idx for l in c] for c in g.chains]) for g in jg]
    assert len(tg) == 1
    (ts, tmap), (js, jmap) = t_stack(tp), j_stack(jp)
    assert _shapes_by_node(ts) == _shapes_by_node(js)
    assert sorted((k.node.idx, k.idx, v.node.idx, v.idx) for k, v in tmap.items()) == \
        sorted((k.node.idx, k.idx, v.node.idx, v.idx) for k, v in jmap.items())
    # no branches: the identity
    b = TBuilder()
    b.dense(b.create_input([8, 32], name="x"), 4, name="head")
    g = t_lift(b.graph)
    assert t_stack(g)[0] is g


def test_the_stacked_graph_computes_the_unstacked_logits():
    tp = _split_test(TBuilder, t_lift)
    sp, _ = t_stack(tp)
    rs = np.random.RandomState(3)
    bindings = {}
    for n in tp.topological_ordering():
        la = tp.layer_attrs(n)
        if type(la.attrs).__name__ in ("InputAttrs", "WeightAttrs"):
            bindings[la.name] = rs.randn(*tp.tensor_shape(tp.outputs_of(n)[0]).sizes())
    for kind in ("weight0", "weight1"):
        key = "w0" if kind == "weight0" else "b0"
        parts = [bindings[f"br{i}.{kind}"] for i in range(2)]
        stacked = np.stack(parts)
        bindings[f"branchstack.merge.{key}"] = (stacked if kind == "weight0"
                                               else stacked.reshape(2, 1, -1))
    sink = lambda g: g.outputs_of(g.topological_ordering()[-1])[0]  # noqa: E731
    want = _run_pcg(tp, bindings)[sink(tp)]
    got = _run_pcg(sp, bindings)[sink(sp)]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-12)


def test_the_branchy_search_finds_the_jax_winner_and_beats_every_seed():
    from flexflow_tpu.models.branchy import add_branchy_towers as j_towers
    from flexflow_tpu_torch.models.branchy import add_branchy_towers as t_towers

    class _B:
        """The FFModel calls add_branchy_towers makes, on a builder."""

        def __init__(self, b):
            self.b = b

        def create_tensor(self, dims, name=None):
            return self.b.create_input(dims, name=name)

        def __getattr__(self, k):
            return getattr(self.b, k)

    pcgs = []
    for towers, builder, lift in ((t_towers, TBuilder, t_lift), (j_towers, JBuilder, j_lift)):
        b = builder()
        towers(_B(b), 64, 1024)
        pcgs.append(lift(b.graph))
    ts, tctx, js, jctx = _contexts(8)
    tsp, jsp = t_stack(pcgs[0])[0], j_stack(pcgs[1])[0]
    tr = T.graph_optimize(tsp, tctx, ts, t_rules([2, 4, 8]), T.OptimizerConfig(budget=8))
    jr = J.graph_optimize(jsp, jctx, js, j_rules([2, 4, 8]), J.OptimizerConfig(budget=8))
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert tr.seed_runtimes.keys() == jr.seed_runtimes.keys()
    assert tr.runtime < min(tr.seed_runtimes.values())


# -- the Stack, Reduce and Broadcast ops ---------------------------------------------------------


def _reduce(m, op, axes, keep=False):
    import sys

    kind = getattr(sys.modules[m.ReduceAttrs.__module__].ReduceOpType, op)
    return m.ReduceAttrs(kind, axes, keep)


OPS = {
    "stack": (lambda m: m.StackAttrs(), [(4, 6), (4, 6), (4, 6)]),
    "reduce_sum": (lambda m: _reduce(m, "SUM", (0,)), [(3, 4, 5)]),
    "reduce_mean_keep": (lambda m: _reduce(m, "MEAN", (1, 2), True), [(3, 4, 5)]),
    "reduce_max": (lambda m: _reduce(m, "MAX", (-1,)), [(3, 4, 5)]),
    "reduce_prod": (lambda m: _reduce(m, "PROD", (0, 2)), [(3, 4, 5)]),
    "broadcast": (lambda m: m.BroadcastAttrs((2, 4, 6)), [(1, 6)]),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_forward_and_vjp_match_the_jax_op(name):
    make, shapes = OPS[name]
    rs = np.random.RandomState(5)
    xs = [rs.uniform(0.5, 1.5, s).astype(np.float32) for s in shapes]
    jouts, jvjp = jax.vjp(lambda *a: j_kernels.forward(make(j_ops), list(a), [])[0],
                          *[jnp.asarray(x) for x in xs])
    tins = [torch.tensor(x, requires_grad=True) for x in xs]
    touts = t_kernels.forward(make(t_ops), tins, [])[0]
    np.testing.assert_allclose(touts.detach().numpy(), np.asarray(jouts), rtol=TOL, atol=TOL)
    g = rs.randn(*touts.shape).astype(np.float32)
    tgrads = torch.autograd.grad(touts, tins, torch.tensor(g))
    for tg, jg in zip(tgrads, jvjp(jnp.asarray(g))):
        np.testing.assert_allclose(tg.numpy(), np.asarray(jg), rtol=TOL, atol=TOL)
    # the op's shape rule is the JAX one
    from flexflow_tpu.op_attrs.core import get_output_shapes as j_shapes
    from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JShape
    from flexflow_tpu_torch.op_attrs.core import get_output_shapes as t_shapes
    from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape as TShape

    assert repr(t_shapes(make(t_ops), [TShape(s) for s in shapes])) == repr(
        j_shapes(make(j_ops), [JShape(s) for s in shapes]))


# -- over ranks ------------------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["rules", "branchy"])
def test_the_compile_over_ranks_finds_and_trains_the_jax_plan(tmp_path_factory, name):
    runs = search_ranks(tmp_path_factory)
    check_job_against_jax(runs, name)
    if name == "branchy":
        for r in runs["ranks"]:
            assert any(k.startswith("branchstack.") for k in r[name]["weights"])
