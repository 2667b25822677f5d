"""The port's Unity search (flexflow_tpu_torch.compiler, .substitutions and
the graph utilities under them) against the JAX package's.

Both packages build the same small flagship (2 layers, hidden 64, 2 heads of
32, seq 64, vocab 256, batch 8; node indices follow insertion order in both)
and the split_test diamond, and must agree on:

- the series-parallel decomposition, compared through node indices and
  layer names;
- the rule set of generate_parallelization_rules: count, names, order;
- every rule's matches on the flagship and on its dp-2 seed, and the
  per-node parallel shapes after applying each rule's first match;
- the machine-mapping DP on the dp-4 seed's problem tree, priced by both
  analytic estimators on identical constants (runtime within relative
  1e-12, the same view per layer), the JAX side with and without its native
  core;
- graph_optimize end to end at 8 and 4 devices and budgets 2 and 4
  (runtime, serial_runtime and every seed runtime within relative 1e-9;
  explored and parallel_degree_summary equal);
- op_forward_flops at non-default weight_shapes and seq_parallel_degree;
- the measured LocalCostEstimator on the CPU: mem_bytes exactly equal for
  every op of the dp, tp and sp seeds, the port's elapsed finite and > 0,
  memoized leaves, inf where shape inference fails, and a kernel error that
  propagates instead of pricing inf.
"""

from __future__ import annotations

import math

import pytest
import torch

import bench
import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu.compiler.machine_mapping.problem_tree import _leaf_key as j_leaf_key
from flexflow_tpu.compiler.unity_algorithm import (
    data_parallel_seed as j_dp_seed,
    sequence_parallel_seed as j_sp_seed,
    tensor_parallel_seed as j_tp_seed,
)
from flexflow_tpu.kernels.ops import op_forward_flops as j_flops
from flexflow_tpu.local_execution.cost_estimator import LocalCostEstimator as JLocal
from flexflow_tpu.kernels.profiling import ProfilingSettings as JSettings
from flexflow_tpu.models.split_test import build_split_test as j_split_test
from flexflow_tpu.op_attrs import ops as j_ops
from flexflow_tpu.op_attrs.core import op_type_of as j_op_type_of
from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JShape
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu.pcg.parallel_computation_graph import (
    pcg_from_computation_graph as j_lift,
)
from flexflow_tpu.substitutions.pcg_pattern import find_pattern_matches as j_matches
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu.substitutions.substitution import apply_substitution as j_apply
from flexflow_tpu.utils.graph import Node as JNode
from flexflow_tpu.utils.graph.series_parallel import (
    ParallelSplit as JParallel,
    SeriesSplit as JSeries,
    get_series_parallel_decomposition as j_sp_decomp,
)
from flexflow_tpu.utils.graph.algorithms import get_transitive_reduction as j_tr
from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _leaf_key as t_leaf_key
from flexflow_tpu_torch.compiler.unity_algorithm import (
    data_parallel_seed as t_dp_seed,
    sequence_parallel_seed as t_sp_seed,
    tensor_parallel_seed as t_tp_seed,
)
from flexflow_tpu_torch.core import FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.kernels import ops as t_kernel_ops
from flexflow_tpu_torch.kernels.ops import op_forward_flops as t_flops
from flexflow_tpu_torch.kernels.profiling import ProfilingSettings as TSettings
from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator as TLocal
from flexflow_tpu_torch.models import build_flagship_pcg as t_flagship_pcg
from flexflow_tpu_torch.models.split_test import build_split_test as t_split_test
from flexflow_tpu_torch.op_attrs import ops as t_ops
from flexflow_tpu_torch.op_attrs.core import op_type_of as t_op_type_of
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape as TShape
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification as TSpec
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    pcg_from_computation_graph as t_lift,
)
from flexflow_tpu_torch.substitutions.pcg_pattern import find_pattern_matches as t_matches
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from flexflow_tpu_torch.substitutions.substitution import apply_substitution as t_apply
from flexflow_tpu_torch.utils.graph import Node as TNode
from flexflow_tpu_torch.utils.graph.algorithms import get_transitive_reduction as t_tr
from flexflow_tpu_torch.utils.graph.series_parallel import (
    ParallelSplit as TParallel,
    SeriesSplit as TSeries,
    get_series_parallel_decomposition as t_sp_decomp,
)

SMALL = dict(batch=8, seq=64, embed=64, heads=2, layers=2, vocab=256)
# identical constants for both analytic estimators (slow enough that the
# search parallelizes the small model); bandwidths GB/s, latencies ms
PEAK_FLOPS, HBM_GBPS = 1e11, 100.0
INTER_GBPS, INTRA_GBPS = 25.0, 400.0
LAT_INTRA, LAT_INTER = 0.001, 0.01
RUNTIME_RTOL = 1e-9  # graph_optimize: runtime, serial_runtime, seed runtimes
DP_RTOL = 1e-12  # the machine-mapping DP alone


def _pcgs():
    return t_flagship_pcg(**SMALL), bench.build_flagship_pcg(**SMALL)


def _view_key(v):
    return (v.start.node_idx, v.start.device_idx,
            tuple((d.stride, d.projection.value) for d in v.dimensions))


def _shapes_by_node(pcg):
    """Per node in topological order: its op type and its outputs' parallel
    shapes (the two packages' reprs are the same format)."""
    op_type = t_op_type_of if isinstance(next(iter(pcg.nodes)), TNode) else j_op_type_of
    return [(op_type(pcg.op_attrs(n)).value, pcg.layer_attrs(n).name,
             [repr(pcg.tensor_shape(o)) for o in pcg.outputs_of(n)])
            for n in pcg.topological_ordering()]


# -- series-parallel decomposition ------------------------------------------


def _sp_tree(sp, pcg):
    if sp is None:  # not series-parallel as it stands
        return None
    if isinstance(sp, (TSeries, JSeries)):
        return ("S", tuple(_sp_tree(c, pcg) for c in sp.children))
    if isinstance(sp, (TParallel, JParallel)):
        return ("P", frozenset(_sp_tree(c, pcg) for c in sp.children))
    assert isinstance(sp, (TNode, JNode))
    return (sp.idx, pcg.layer_attrs(sp).name)


@pytest.mark.parametrize("model", ["flagship", "split_test"])
def test_series_parallel_decomposition(model):
    if model == "flagship":
        tp, jp = _pcgs()
    else:
        tp = t_lift(t_split_test(8)[0])
        jp = j_lift(j_split_test(8)[0])
    tsp = t_sp_decomp(t_tr(tp.digraph()))
    jsp = j_sp_decomp(j_tr(jp.digraph()))
    assert _sp_tree(tsp, tp) == _sp_tree(jsp, jp)
    # the problem trees (the diamond's only after its weight sources are
    # collapsed into one parallel stage) put every node at the same path
    ttree, tpaths = T.get_machine_mapping_problem_tree(tp)
    jtree, jpaths = J.get_machine_mapping_problem_tree(jp)
    tnamed = {(n.idx, tp.layer_attrs(n).name): p for n, p in tpaths.items()}
    assert tnamed == {(n.idx, jp.layer_attrs(n).name): p for n, p in jpaths.items()}
    assert len(tnamed) == len(tp.nodes)


# -- rules and matches -------------------------------------------------------


@pytest.mark.parametrize("flags", [dict(), dict(enable_parameter_parallel=False,
                                                enable_attribute_parallel=False)])
def test_rules_same_names_and_order(flags):
    tnames = [r.name for r in t_rules([2, 4, 8], **flags)]
    jnames = [r.name for r in j_rules([2, 4, 8], **flags)]
    assert tnames == jnames
    if not flags:
        assert len(tnames) == 159


def test_pipeline_rules_raise_naming_a10():
    """The pipeline-stage rules no longer raise (A10 is ported): with
    enable_pipeline both packages generate the same rules, in the same
    order, the stage-pair rules last (tests/test_torch_port_pipeline.py
    applies them)."""
    for micro in (0, 8):
        tnames = [r.name for r in t_rules([2], enable_pipeline=True, pipeline_microbatches=micro)]
        jnames = [r.name for r in j_rules([2], enable_pipeline=True, pipeline_microbatches=micro)]
        assert tnames == jnames
        assert any(n.startswith("pipeline_stage_pair_") for n in tnames)


@pytest.mark.parametrize("host", ["flagship", "dp2_seed"])
def test_rule_matches_and_first_application(host):
    tp, jp = _pcgs()
    if host == "dp2_seed":
        tp, jp = t_dp_seed(tp, 2), j_dp_seed(jp, 2)
    assert _shapes_by_node(tp) == _shapes_by_node(jp)
    applied = 0
    for tr, jr in zip(t_rules([2, 4]), j_rules([2, 4])):
        tm, jm = t_matches(tr.pattern, tp), j_matches(jr.pattern, jp)
        assert len(tm) == len(jm), tr.name
        if not tm:
            continue
        assert [sorted((p.idx, h.idx) for p, h in m.node_assignment) for m in tm] == \
            [sorted((p.idx, h.idx) for p, h in m.node_assignment) for m in jm], tr.name
        try:
            jnew = j_apply(jp, jr, jm[0])
        except (AssertionError, KeyError, ValueError):
            with pytest.raises((AssertionError, KeyError, ValueError)):
                t_apply(tp, tr, tm[0])
            continue
        assert _shapes_by_node(t_apply(tp, tr, tm[0])) == _shapes_by_node(jnew), tr.name
        applied += 1
    assert applied > 0


# -- the machine-mapping DP --------------------------------------------------


def _estimators(ndev):
    ts, js = TSpec(1, 1, ndev, INTER_GBPS, INTRA_GBPS), JSpec(1, 1, ndev, INTER_GBPS, INTRA_GBPS)
    te = T.AnalyticGPUCostEstimator(ts, peak_flops=PEAK_FLOPS, hbm_gbps=HBM_GBPS,
                                    intra_latency_ms=LAT_INTRA, inter_latency_ms=LAT_INTER)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=PEAK_FLOPS, hbm_gbps=HBM_GBPS,
                                    ici_latency_ms=LAT_INTRA, dcn_latency_ms=LAT_INTER)
    return (ts, T.MachineMappingContext(te, T.make_default_allowed_machine_views()),
            js, J.MachineMappingContext(je, J.make_default_allowed_machine_views()))


@pytest.mark.parametrize("native", [False, True])
def test_machine_mapping_dp_on_dp4_seed(native, monkeypatch):
    from flexflow_tpu import native_lib

    if not native:
        monkeypatch.setenv("FF_TPU_NO_NATIVE", "1")
        monkeypatch.setattr(native_lib, "_lib", None)
    elif not native_lib.native_available():
        pytest.skip("the JAX package's native core does not build here")
    tp, jp = _pcgs()
    tp, jp = t_dp_seed(tp, 4), j_dp_seed(jp, 4)
    ts, tctx, js, jctx = _estimators(4)
    ttree, tpaths = T.get_machine_mapping_problem_tree(tp)
    jtree, jpaths = J.get_machine_mapping_problem_tree(jp)
    tres = T.get_optimal_machine_mapping(T.MachineMappingCache(), tctx, ttree, ts)
    jres = J.get_optimal_machine_mapping(J.MachineMappingCache(), jctx, jtree, js)
    assert math.isclose(tres.runtime, jres.runtime, rel_tol=DP_RTOL)
    tviews = {tpaths_inv: _view_key(v) for tpaths_inv, v in tres.mapping_dict().items()}
    jviews = {p: _view_key(v) for p, v in jres.mapping_dict().items()}
    tname = {p: tp.layer_attrs(n).name or n.idx for n, p in tpaths.items()}
    jname = {p: jp.layer_attrs(n).name or n.idx for n, p in jpaths.items()}
    assert {tname[p]: v for p, v in tviews.items()} == {jname[p]: v for p, v in jviews.items()}


# -- graph_optimize ----------------------------------------------------------


@pytest.mark.parametrize("ndev,budget", [(8, 2), (8, 4), (4, 2), (4, 4)])
def test_graph_optimize_matches_jax(ndev, budget):
    tp, jp = _pcgs()
    ts, tctx, js, jctx = _estimators(ndev)
    tr = T.graph_optimize(tp, tctx, ts, t_rules([2, 4, 8]),
                          T.OptimizerConfig(alpha=1.2, budget=budget))
    jr = J.graph_optimize(jp, jctx, js, j_rules([2, 4, 8]),
                          J.OptimizerConfig(alpha=1.2, budget=budget))
    from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary

    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RUNTIME_RTOL)
    assert math.isclose(tr.serial_runtime, jr.serial_runtime, rel_tol=RUNTIME_RTOL)
    assert tr.runtime < tr.serial_runtime  # the search parallelized
    assert tr.seed_runtimes.keys() == jr.seed_runtimes.keys()
    for label, ms in jr.seed_runtimes.items():
        assert math.isclose(tr.seed_runtimes[label], ms, rel_tol=RUNTIME_RTOL), label
    assert tr.explored == jr.explored > 0
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert _shapes_by_node(tr.pcg) == _shapes_by_node(jr.pcg)
    assert set(tr.telemetry["phase_ms"]) >= {"tree_build", "dp", "leaf_cost", "seed_build"}


def test_search_options_not_ported_raise(tmp_path):
    """Every search option is ported now: the pipeline seeds (A10,
    tests/test_torch_port_pipeline.py), the serving search's cost store,
    the overlap pricing and the analytic estimator's store (A6 part 2):
    tests/test_torch_port_cost_store.py and test_torch_port_overlap.py hold
    them against the JAX package."""
    ts, tctx, _, _ = _estimators(4)
    cfg = T.OptimizerConfig(pipeline_seeds=True, pipeline_microbatches=4)
    assert cfg.pipeline_seeds and cfg.pipeline_microbatches == 4
    from flexflow_tpu_torch.compiler.cost_store import CostStore
    from flexflow_tpu_torch.serving.kv_cache import ServingMemorySpec
    from flexflow_tpu_torch.serving.plan import serving_search_context

    ctx, store = serving_search_context(ts, ServingMemorySpec(4, 16),
                                        cost_store_dir=str(tmp_path), device="cpu")
    assert store.fingerprint.endswith("-fwd") and ctx.cost_estimator.cost_store is store
    with pytest.raises(FileNotFoundError):  # a missing store directory never searches cold
        serving_search_context(ts, ServingMemorySpec(4, 16),
                               cost_store_dir=str(tmp_path / "missing"), device="cpu")
    ctx = T.MachineMappingContext(tctx.cost_estimator, tctx.allowed_machine_views,
                                  overlap_lowering=True)
    assert ctx.overlap_lowering
    est = T.AnalyticGPUCostEstimator(ts, PEAK_FLOPS, HBM_GBPS,
                                     cost_store=CostStore(str(tmp_path)))
    assert est.movement_store is est.cost_store


def test_searched_ffmodel_compile_names_a7():
    m = FFModel(FFConfig(batch_size=8, max_devices=4, search_budget=2), device="cpu")
    x = m.create_tensor([8, 16], name="x")
    m.dense(x, 4, name="out")
    m._device_count = lambda: 4  # a 4-card machine, as the multi-device compile sees it
    # the plan's parallel ops lower (tests/test_torch_port_ffmodel_ranks.py);
    # a compile over several devices needs their ranks' process group
    with pytest.raises(RuntimeError, match=r"init_file_group.*\(A7 item 4\)"):
        m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")


# -- op_forward_flops --------------------------------------------------------


def test_op_forward_flops_sharded_pieces():
    cases = [
        # column-parallel linear piece: [in, out/4]
        ("LinearAttrs", dict(out_channels=256, use_bias=False), [(8, 64, 64)], [(64, 64)], 1),
        # head-parallel attention piece: 1 of 4 heads, seq-sharded ring by 2
        ("MultiHeadAttentionAttrs", dict(embed_dim=64, num_heads=4), [(8, 32, 64)] * 3,
         [(4 * 16 * 64, 1)], 1),
        ("RingAttentionAttrs", dict(embed_dim=64, num_heads=4), [(8, 32, 64)] * 3,
         [(4 * 16 * 64, 4)], 2),
        ("Conv2DAttrs", dict(out_channels=16, kernel_h=3, kernel_w=3), [(2, 8, 10, 10)],
         [(4, 8, 3, 3)], 1),
    ]
    from flexflow_tpu.op_attrs.core import get_output_shapes as j_out
    from flexflow_tpu_torch.op_attrs.core import get_output_shapes as t_out

    for cls, kw, ins, ws, sp in cases:
        ta, ja = getattr(t_ops, cls)(**kw), getattr(j_ops, cls)(**kw)
        tin, jin = [TShape(s) for s in ins], [JShape(s) for s in ins]
        tw, jw = [TShape(s) for s in ws], [JShape(s) for s in ws]
        tf = t_flops(ta, tin, t_out(ta, tin), weight_shapes=tw, seq_parallel_degree=sp)
        jf = j_flops(ja, jin, j_out(ja, jin), weight_shapes=jw, seq_parallel_degree=sp)
        assert tf == jf, cls
        assert tf != t_flops(ta, tin, t_out(ta, tin)), cls  # the piece really counts less


# -- the measured LocalCostEstimator on the CPU -----------------------------

SEEDS = {
    "dp": (lambda p: t_dp_seed(p, 2), lambda p: j_dp_seed(p, 2)),
    "tp": (lambda p: t_tp_seed(p, 2), lambda p: j_tp_seed(p, 2)),
    "sp": (lambda p: t_sp_seed(p, 2), lambda p: j_sp_seed(p, 2)),
}


@pytest.mark.parametrize("seed", sorted(SEEDS))
def test_local_cost_estimator_memory_matches_jax(seed):
    tseed, jseed = SEEDS[seed]
    tp = tseed(t_flagship_pcg(**dict(SMALL, layers=1)))
    jp = jseed(bench.build_flagship_pcg(**dict(SMALL, layers=1)))
    tl = TLocal(TSettings(1, 2), device="cpu")
    jl = JLocal(JSettings(1, 2))
    measured = 0
    for tn, jn in zip(tp.topological_ordering(), jp.topological_ordering()):
        tk, jk = t_leaf_key(tp, tn), j_leaf_key(jp, jn)
        assert type(tk.op_attrs).__name__ == type(jk.op_attrs).__name__
        if tk.op_attrs.__class__.__name__ in ("RepartitionAttrs", "CombineAttrs",
                                              "ReplicateAttrs", "ReductionAttrs"):
            continue
        tc = tl.estimate_operator_cost_parallel(tk.op_attrs, list(tk.input_shapes),
                                                list(tk.output_shapes))
        jc = jl.estimate_operator_cost_parallel(jk.op_attrs, list(jk.input_shapes),
                                                list(jk.output_shapes))
        assert tc.mem_bytes == jc.mem_bytes, type(tk.op_attrs).__name__
        if math.isfinite(jc.elapsed_ms) and jc.elapsed_ms > 0:
            assert math.isfinite(tc.elapsed_ms) and tc.elapsed_ms > 0
            measured += 1
    assert measured >= 5 and not tl.inf_leaves
    calls = tl.profile_calls
    tk = t_leaf_key(tp, tp.topological_ordering()[-1])
    tl.estimate_operator_cost_parallel(tk.op_attrs, list(tk.input_shapes), list(tk.output_shapes))
    assert tl.profile_calls == calls  # memoized: no second run of a leaf


def test_shape_inference_failure_prices_inf_in_both():
    # a LayerNorm over an axis the input does not have: its weight shapes
    # cannot be inferred
    ta = t_ops.LayerNormAttrs(axes=(5,))
    ja = j_ops.LayerNormAttrs(axes=(5,))
    tl = TLocal(TSettings(1, 2), device="cpu")
    jl = JLocal(JSettings(1, 2))
    tc = tl.estimate_operator_cost(ta, [TShape((8, 64, 64))])
    jc = jl.estimate_operator_cost(ja, [JShape((8, 64, 64))])
    assert tc.elapsed_ms == jc.elapsed_ms == float("inf")
    assert tl.profile_calls == 0 and len(tl.inf_leaves) == 1


def test_kernel_error_propagates_instead_of_pricing_inf(monkeypatch):
    """Attention at a shape the flash path takes (2 heads of 64, seq 64):
    a wrapper that raises at launch must surface, never become inf."""
    attrs = t_ops.MultiHeadAttentionAttrs(embed_dim=128, num_heads=2)
    q = TShape((2, 64, 128))
    tl = TLocal(TSettings(1, 2), device="cpu")
    assert math.isfinite(tl.estimate_operator_cost(attrs, [q, q, q]).elapsed_ms)

    def broken(*args, **kwargs):
        raise ValueError("flash_fwd: launch failed")

    monkeypatch.setattr(t_kernel_ops, "flash_attention_bshf", broken)
    fresh = TLocal(TSettings(1, 2), device="cpu")
    with pytest.raises(ValueError, match="launch failed"):
        fresh.estimate_operator_cost(attrs, [q, q, q])


def test_meta_run_error_propagates_instead_of_pricing_inf(monkeypatch):
    """The meta dry run decides between weight candidates on shape errors
    only: an op that reads a value on the host (a RuntimeError on the meta
    device) must surface, never become inf."""
    real = t_kernel_ops.forward

    def host_read(attrs, inputs, weights, *args, **kwargs):
        inputs[0].sum().item()
        return real(attrs, inputs, weights, *args, **kwargs)

    monkeypatch.setattr(t_kernel_ops, "forward", host_read)
    tl = TLocal(TSettings(1, 2), device="cpu")
    with pytest.raises(RuntimeError, match="meta"):
        tl.estimate_operator_cost(t_ops.LayerNormAttrs(axes=(2,)), [TShape((8, 64, 64))])
    assert not tl.inf_leaves


def test_op_without_kernel_raises_naming_a2():
    """Every op the rules name has its kernel now (A2 closed: Reduce for
    branch stacking, Experts with A11): measuring one prices it, whole or
    as an expert-parallel piece, and nothing is priced inf."""
    tl = TLocal(TSettings(1, 2), device="cpu")
    experts = t_ops.ExpertsAttrs(4, 2, 8)
    whole = tl.estimate_operator_cost(experts, [TShape((2, 8, 4))])
    piece = tl.estimate_operator_cost(
        experts, [TShape((2, 8, 4))],
        [TShape((4, 4)), TShape((2, 4, 8)), TShape((2, 8)), TShape((2, 8, 4)), TShape((2, 4))])
    assert 0 < whole.elapsed_ms < float("inf") and 0 < piece.elapsed_ms < float("inf")
    reduce_cost = tl.estimate_operator_cost(t_ops.ReduceAttrs(t_ops.ReduceOpType.SUM, (1,)),
                                            [TShape((2, 8, 4))])
    assert 0 < reduce_cost.elapsed_ms < float("inf")


def test_card_entry_points_default_to_cuda():
    from flexflow_tpu_torch.compiler.calibration import calibrate

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TLocal()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        calibrate()
    cal = calibrate(device="cpu")
    assert cal.peak_flops > 0 and cal.hbm_gbps > 0 and cal.backend == "cpu"
    # over several devices calibrate is a collective of the ranks' group
    # (tests/test_torch_port_calibration.py runs it on 2 ranks)
    with pytest.raises(RuntimeError, match="collective call on the 2 ranks"):
        calibrate(device="cpu", num_devices=2)
