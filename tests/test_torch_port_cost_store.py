"""The port's persistent cost and movement stores (flexflow_tpu_torch/
compiler/cost_store.py, movement_store.py) and their wiring, against the
JAX package's (tests/test_cost_store.py is the spec):

- op keys equal the JAX package's for the same op and shapes on the CPU;
  movement keys equal after mapping the link classes (`ici`/`dcn` to
  `nvlink`/`ib`) and the accelerator's device-type member (`TPU` to `GPU`);
- a store written by either package's measured search under `cpu:cpu`
  prices the other's search with zero profile calls and the same winner;
  both analytic estimators over one store file find one winner (within
  1e-9) with the same hits, misses and fitted corrections;
- the device-kind fence: entries of another device kind are never served,
  and an estimator handed a store of another device kind raises; a missing
  store directory raises;
- merge-on-save across instances of both packages, last writer wins per
  key; the correction fits and `live_scale`; the v1/v2 movement files'
  read-side migration;
- the audit feeds its measurements (and analytic pairs) into the store;
  the serving search's store holds forward-only (`-fwd`) entries and warm
  prices with zero profile calls; the drift repricer re-searches under the
  store's live scale as the JAX compile's does, and a searched compile over
  a group of one rank wires it into FFModel.
"""

from __future__ import annotations

import json
import math

import pytest

import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu.compiler import cost_store as jcs
from flexflow_tpu.compiler import movement_store as jms
from flexflow_tpu.kernels.profiling import ProfilingSettings as JSettings
from flexflow_tpu.local_execution.cost_estimator import LocalCostEstimator as JLocal
from flexflow_tpu.op_attrs import ops as j_ops
from flexflow_tpu.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as JDims,
    ParallelTensorShape as JPShape,
    ShardParallelDim as JShard,
)
from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JShape
from flexflow_tpu.pcg import ComputationGraphBuilder as JBuilder
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as j_lift
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu_torch.compiler import cost_store as tcs
from flexflow_tpu_torch.compiler import movement_store as tms
from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _leaf_key as t_leaf_key
from flexflow_tpu_torch.compiler.unity_algorithm import parallel_degree_summary as t_summary
from flexflow_tpu_torch.kernels.profiling import ProfilingSettings as TSettings
from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator as TLocal
from flexflow_tpu_torch.op_attrs import ops as t_ops
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as TDims,
    ParallelTensorShape as TPShape,
    ShardParallelDim as TShard,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape as TShape
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TBuilder
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph as t_lift
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary

CPU = "cpu:cpu"
H100 = "cuda:NVIDIA H100 80GB HBM3"
PEAK_FLOPS, HBM_GBPS = 1e11, 100.0
INTER_GBPS, INTRA_GBPS = 25.0, 400.0
LAT_INTRA, LAT_INTER = 0.001, 0.01
RTOL = 1e-9


def _mlp(builder_cls, lift, batch=16, hidden=32, out=8):
    b = builder_cls()
    x = b.create_input([batch, hidden], name="x")
    h = b.relu(b.dense(x, hidden, use_bias=False, name="fc1"))
    b.dense(h, out, use_bias=False, name="fc2")
    return lift(b.graph)


def _pts(pkg, sizes, degrees=None, sum_degree=1, copy=1):
    dims, shard, shape = (TDims, TShard, TPShape) if pkg == "t" else (JDims, JShard, JPShape)
    degrees = degrees or [1] * len(sizes)
    return shape(dims(tuple(shard(s, d) for s, d in zip(sizes, degrees)), sum_degree, copy),
                 t_ops.LinearAttrs(1).dtype if pkg == "t" else j_ops.LinearAttrs(1).dtype)


def _view(mv, proj="INTRA_NODE"):
    return mv.MachineView(mv.MachineSpaceCoordinate(0, 0),
                          (mv.MachineViewDimension(1, getattr(mv.ProjectionType, proj)),))


def _no_native(monkeypatch):
    from flexflow_tpu import native_lib

    monkeypatch.setenv("FF_TPU_NO_NATIVE", "1")
    monkeypatch.setattr(native_lib, "_lib", None)


def _measured(pkg, ndev, store):
    if pkg == "t":
        spec = tmv.MachineSpecification(1, 1, ndev, INTER_GBPS, INTRA_GBPS)
        local = TLocal(TSettings(1, 2), device="cpu", cost_store=store)
        est = T.GPUCostEstimator(spec, local_cost_estimator=local, intra_latency_ms=LAT_INTRA,
                                 inter_latency_ms=LAT_INTER, cost_store=store)
        return spec, T.MachineMappingContext(est, T.make_default_allowed_machine_views()), local
    spec = jmv.MachineSpecification(1, 1, ndev, INTER_GBPS, INTRA_GBPS)
    local = JLocal(JSettings(1, 2), cost_store=store)
    est = J.TPUCostEstimator(spec, local_cost_estimator=local, ici_latency_ms=LAT_INTRA,
                             dcn_latency_ms=LAT_INTER, cost_store=store)
    return spec, J.MachineMappingContext(est, J.make_default_allowed_machine_views()), local


def _analytic(pkg, ndev, store):
    if pkg == "t":
        spec = tmv.MachineSpecification(1, 1, ndev, INTER_GBPS, INTRA_GBPS)
        est = T.AnalyticGPUCostEstimator(spec, PEAK_FLOPS, HBM_GBPS, intra_latency_ms=LAT_INTRA,
                                         inter_latency_ms=LAT_INTER, cost_store=store)
        return spec, T.MachineMappingContext(est, T.make_default_allowed_machine_views())
    spec = jmv.MachineSpecification(1, 1, ndev, INTER_GBPS, INTRA_GBPS)
    est = J.AnalyticTPUCostEstimator(spec, peak_flops=PEAK_FLOPS, hbm_gbps=HBM_GBPS,
                                     ici_latency_ms=LAT_INTRA, dcn_latency_ms=LAT_INTER,
                                     cost_store=store)
    return spec, J.MachineMappingContext(est, J.make_default_allowed_machine_views())


def _search(pkg, ctx, spec, budget=1):
    if pkg == "t":
        return T.graph_optimize(_mlp(TBuilder, t_lift), ctx, spec, t_rules([2, 4]),
                                T.OptimizerConfig(alpha=1.2, budget=budget))
    return J.graph_optimize(_mlp(JBuilder, j_lift), ctx, spec, j_rules([2, 4]),
                            J.OptimizerConfig(alpha=1.2, budget=budget))


# -- keys ---------------------------------------------------------------------


def test_op_keys_are_the_jax_packages_on_the_cpu():
    tp, jp = _mlp(TBuilder, t_lift), _mlp(JBuilder, j_lift)
    tp, jp = T.unity_algorithm.data_parallel_seed(tp, 2), J.unity_algorithm.data_parallel_seed(jp, 2)
    from flexflow_tpu.compiler.machine_mapping.problem_tree import _leaf_key as j_leaf_key

    keys = 0
    for tn, jn in zip(tp.topological_ordering(), jp.topological_ordering()):
        tk, jk = t_leaf_key(tp, tn), j_leaf_key(jp, jn)
        for fp in (tcs.MEASUREMENT_SEMANTICS, tcs.forward_fingerprint()):
            assert tcs.op_leaf_key_parallel(tk.op_attrs, tk.input_shapes, CPU, fp) == \
                jcs.op_leaf_key_parallel(jk.op_attrs, jk.input_shapes, CPU, fp)
            keys += 1
    assert keys >= 16
    assert tcs.forward_fingerprint() == jcs.forward_fingerprint()
    assert tcs.measurement_fingerprint(object()) == jcs.measurement_fingerprint(object())


@pytest.mark.parametrize("attrs,proj", [("combine", "INTRA_NODE"), ("replicate", "INTER_NODE"),
                                        ("repartition", "INTRA_NODE")])
def test_movement_keys_equal_after_mapping_the_link_classes(attrs, proj):
    make = {"combine": lambda m: m.CombineAttrs(0, 2), "replicate": lambda m: m.ReplicateAttrs(2),
            "repartition": lambda m: m.RepartitionAttrs(1, 2)}[attrs]
    tshape = [_pts("t", (8, 16), (2, 1))]
    jshape = [_pts("j", (8, 16), (2, 1))]
    for tlink, jlink in (("nvlink", "ici"), ("ib", "dcn")):
        tk = tms.movement_edge_key(make(t_ops), tshape, _view(tmv, proj), CPU, link_class=tlink)
        jk = jms.movement_edge_key(make(j_ops), jshape, _view(jmv, proj), CPU, link_class=jlink)
        mapped = (jk.replace("<DeviceType.TPU: 'tpu'>", "<DeviceType.GPU: 'gpu'>")
                  .rsplit("|", 1)[0] + "|" + {"ici": "nvlink", "dcn": "ib"}[jlink])
        assert tk == mapped
    with pytest.raises(ValueError, match="link class"):
        tms.movement_edge_key(make(t_ops), tshape, _view(tmv, proj), CPU, link_class="ici")


def test_link_class_of_a_parallel_op_follows_its_axis():
    from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import movement_link_class
    from flexflow_tpu.compiler.machine_mapping.cost_estimator import (
        movement_link_class as j_link,
    )

    ts = tmv.MachineSpecification(2, 1, 4, INTER_GBPS, INTRA_GBPS)
    js = jmv.MachineSpecification(2, 1, 4, INTER_GBPS, INTRA_GBPS)
    for proj in ("INTRA_NODE", "INTER_NODE"):
        t = movement_link_class(t_ops.ReplicateAttrs(2), [_pts("t", (8, 16))], _view(tmv, proj),
                                ts)
        j = j_link(j_ops.ReplicateAttrs(2), [_pts("j", (8, 16))], _view(jmv, proj), js)
        assert {"nvlink": "ici", "ib": "dcn"}[t] == j
        assert t == ("ib" if proj == "INTER_NODE" else "nvlink")


# -- both packages over one store -------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_written_by_either_package_prices_the_others_search(tmp_path, monkeypatch,
                                                                    writer):
    """The writer's measured search times every leaf and saves; the other
    package's measured search over the same file then times none, and finds
    the writer's winner at the writer's cost."""
    import flexflow_tpu.local_execution.cost_estimator as jlce

    _no_native(monkeypatch)
    w, r = ("j", "t") if writer == "jax" else ("t", "j")
    store_cls = {"t": tcs.CostStore, "j": jcs.CostStore}
    wstore = store_cls[w](str(tmp_path), device_kind=CPU)
    spec, ctx, _ = _measured(w, 4, wstore)
    cold = _search(w, ctx, spec)
    assert wstore.op_misses > 0 and len(wstore) > 0
    wstore.save()

    jcalls = []
    orig = jlce.profile_fn
    monkeypatch.setattr(jlce, "profile_fn", lambda *a, **k: jcalls.append(1) or orig(*a, **k))
    rstore = store_cls[r](str(tmp_path), device_kind=CPU)
    spec, ctx, local = _measured(r, 4, rstore)
    warm = _search(r, ctx, spec)
    if r == "t":
        assert local.profile_calls == 0
    else:
        assert jcalls == []
    assert rstore.op_misses == 0 and rstore.op_hits > 0
    assert math.isclose(warm.runtime, cold.runtime, rel_tol=RTOL)
    summary = {"t": t_summary, "j": j_summary}
    assert summary[r](warm.pcg) == summary[w](cold.pcg)


def test_both_analytic_estimators_over_one_store_find_one_winner(tmp_path, monkeypatch):
    """A store with measured leaves (the port's measured search wrote it):
    each package's analytic search prices hits from it and corrects misses
    by the same fitted factors, to the same winner."""
    _no_native(monkeypatch)
    store = tcs.CostStore(str(tmp_path), device_kind=CPU)
    spec, ctx, _ = _measured("t", 2, store)
    _search("t", ctx, spec)
    store.save()
    results = {}
    for pkg, cls in (("t", tcs.CostStore), ("j", jcs.CostStore)):
        s = cls(str(tmp_path), device_kind=CPU)
        spec, ctx = _analytic(pkg, 4, s)
        results[pkg] = (_search(pkg, ctx, spec, budget=2), s)
    (tr, ts), (jr, js) = results["t"], results["j"]
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert t_summary(tr.pcg) == j_summary(jr.pcg)
    assert (ts.op_hits, ts.op_misses) == (js.op_hits, js.op_misses)
    assert ts.op_hits > 0
    sig = f"pf{PEAK_FLOPS:.6g}|hbm{HBM_GBPS:.6g}"
    assert ts.fit_corrections(analytic_sig=sig) == js.fit_corrections(analytic_sig=sig)


# -- the fence ----------------------------------------------------------------------


def test_device_kind_signature_names_the_card_or_the_host(monkeypatch):
    import torch

    assert tcs.device_kind_signature("cpu") == CPU
    if not torch.cuda.is_available():
        assert tcs.device_kind_signature() == CPU
    monkeypatch.setattr(tcs, "_DEVICE_KIND_CACHE", {})
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda i=0: "NVIDIA H100 80GB HBM3")
    assert tcs.device_kind_signature("cuda") == H100


def test_a_measurement_of_another_device_kind_is_never_served(tmp_path):
    card = tcs.CostStore(str(tmp_path), device_kind=H100)
    attrs, ins = t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),)
    card.put_op(attrs, ins, None, 1.25, 64)
    card.put("edge", 0.5)
    card.save()
    host = tcs.CostStore(str(tmp_path))  # this session: the CPU
    assert host.device_kind == CPU and len(host) == 2
    assert host.get_op(attrs, ins, None) is None and host.op_misses == 1
    assert tcs.CostStore(str(tmp_path), device_kind=H100).get_op(attrs, ins, None) == (1.25, 64)
    # an estimator measuring on the host refuses the card's store outright
    with pytest.raises(ValueError, match="device kind"):
        TLocal(device="cpu", cost_store=tcs.CostStore(str(tmp_path), device_kind=H100))
    spec = tmv.MachineSpecification(1, 1, 2, INTER_GBPS, INTRA_GBPS)
    with pytest.raises(ValueError, match="device kind"):
        T.GPUCostEstimator(spec, local_cost_estimator=TLocal(device="cpu"),
                           cost_store=tcs.CostStore(str(tmp_path), device_kind=H100))
    # the JAX package, reading the same file on its CPU session, skips it too
    assert jcs.CostStore(str(tmp_path), device_kind=CPU).get_op(
        j_ops.LinearAttrs(8, use_bias=False), (JShape((4, 16)),), None) is None
    # the analytic fit never mixes device kinds
    assert host.fit_corrections(min_pairs=1) == {}


def test_a_missing_store_directory_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        tcs.CostStore(str(tmp_path / "nowhere" / "cost_db.json"))
    with pytest.raises(FileNotFoundError):
        tms.MovementCostStore(str(tmp_path / "nowhere" / "movement.json"))


def test_forward_only_estimators_need_the_forward_family(tmp_path):
    with pytest.raises(ValueError, match="forward-marked"):
        TLocal(device="cpu", forward_only=True, cost_store=tcs.CostStore(str(tmp_path)))
    spec = tmv.MachineSpecification(1, 1, 2, INTER_GBPS, INTRA_GBPS)
    with pytest.raises(ValueError, match="forward-marked"):
        T.AnalyticGPUCostEstimator(spec, PEAK_FLOPS, HBM_GBPS, forward_only=True,
                                   cost_store=tcs.CostStore(str(tmp_path)))
    TLocal(device="cpu", forward_only=True,
           cost_store=tcs.CostStore(str(tmp_path), fingerprint=tcs.forward_fingerprint()))


# -- the file -------------------------------------------------------------------------


def test_merge_on_save_across_both_packages(tmp_path):
    a = tcs.CostStore(str(tmp_path), device_kind=CPU)
    b = jcs.CostStore(str(tmp_path), device_kind=CPU)
    a.put_op(t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),), None, 1.0)
    b.put_op(j_ops.LinearAttrs(16, use_bias=False), (JShape((4, 16)),), None, 2.0)
    a.save()
    b.save()  # re-reads the disk: a's entry survives
    c = tcs.CostStore(str(tmp_path), device_kind=CPU)
    assert c.get_op(t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),), None)[0] == 1.0
    assert c.get_op(t_ops.LinearAttrs(16, use_bias=False), (TShape((4, 16)),), None)[0] == 2.0
    # last writer wins per key; keys this instance never wrote follow the disk
    c.put_op(t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),), None, 3.0)
    a.put_op(t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),), None, 4.0)
    c.save()
    a.save()
    d = jcs.CostStore(str(tmp_path), device_kind=CPU)
    assert d.get_op(j_ops.LinearAttrs(8, use_bias=False), (JShape((4, 16)),), None)[0] == 4.0
    assert d.get_op(j_ops.LinearAttrs(16, use_bias=False), (JShape((4, 16)),), None)[0] == 2.0
    assert json.loads((tmp_path / "cost_db.json").read_text())["schema"] == \
        tcs.COST_DB_SCHEMA_VERSION == jcs.COST_DB_SCHEMA_VERSION


def test_screens_and_unrunnable_verdicts_are_the_jax_packages(tmp_path):
    for sub, ops, shape, cls in (("t", t_ops, TShape, tcs.CostStore),
                                 ("j", j_ops, JShape, jcs.CostStore)):
        (tmp_path / sub).mkdir()
        s = cls(str(tmp_path / sub), device_kind=CPU)
        lin = ops.LinearAttrs(8, use_bias=False)
        s.put_op(lin, (shape((4, 16)),), None, float("nan"))
        s.put_op(lin, (shape((4, 8)),), None, -1.0)
        s.put_op(lin, (shape((4, 4)),), None, float("inf"), 8)
        assert len(s) == 1 and s.get_op(lin, (shape((4, 4)),), None) == (float("inf"), 8)
        s.save()
    t = json.loads((tmp_path / "t" / "cost_db.json").read_text())
    j = json.loads((tmp_path / "j" / "cost_db.json").read_text())
    assert t == j


def test_correction_fits_and_live_scale_are_the_jax_packages(tmp_path):
    stores = {}
    for pkg, ops, shape, cls in (("t", t_ops, TShape, tcs.CostStore),
                                 ("j", j_ops, JShape, jcs.CostStore)):
        (tmp_path / pkg).mkdir()
        s = cls(str(tmp_path / pkg), device_kind=CPU)
        for i, (ms, an) in enumerate([(2.0, 1.0), (8.0, 2.0), (0.5, 5.0)]):
            attrs = ops.LinearAttrs(8 * (i + 1), use_bias=False)
            s.put_op(attrs, (shape((4, 16)),), None, ms)
            s.note_analytic(attrs, (shape((4, 16)),), None, an, analytic_sig="sig")
        s.put_op(ops.ReplicateAttrs(2), (shape((4, 16)),), None, 1.0)
        s.note_analytic(ops.ReplicateAttrs(2), (shape((4, 16)),), None, 0.1, analytic_sig="x")
        stores[pkg] = s
    t, j = stores["t"], stores["j"]
    for sig in (None, "sig", "x"):
        for min_pairs in (1, 2):
            assert t.fit_corrections(min_pairs, sig) == j.fit_corrections(min_pairs, sig)
    assert t.correction_for("LinearAttrs", "sig") == j.correction_for("LinearAttrs", "sig")
    for scale in (2.5, {"LinearAttrs": 3.0, "*": 0.5}):
        t.live_scale = j.live_scale = scale
        attrs = (t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),), None)
        jattrs = (j_ops.LinearAttrs(8, use_bias=False), (JShape((4, 16)),), None)
        assert t.get_op(*attrs) == j.get_op(*jattrs)
        assert t.correction_for("LinearAttrs", "sig") == j.correction_for("LinearAttrs", "sig")
        assert t.correction_for("Other") == j.correction_for("Other")
    assert t.stats()["by_op_class"] == j.stats()["by_op_class"]


def test_no_environment_variable_scales_the_store_or_turns_on_the_two_level_dp(
        tmp_path, monkeypatch):
    """live_scale is set by the drift repricer alone, and the two-level DP
    over nodes by FFConfig.multislice alone: the JAX package's
    FF_TPU_COST_SCALE and FF_TPU_MULTISLICE change nothing in the port."""
    from flexflow_tpu_torch.compiler.machine_mapping import hierarchical
    from flexflow_tpu_torch.core import FFConfig

    monkeypatch.setenv("FF_TPU_COST_SCALE", "2.5")
    monkeypatch.setenv("FF_TPU_MULTISLICE", "1")
    s = tcs.CostStore(str(tmp_path), device_kind=CPU)
    assert s.live_scale is None
    attrs = (t_ops.LinearAttrs(8, use_bias=False), (TShape((4, 16)),), None)
    s.put_op(*attrs, 2.0)
    assert s.get_op(*attrs)[0] == 2.0
    assert FFConfig().multislice is None
    assert not hasattr(hierarchical, "multislice_search_active")


@pytest.mark.parametrize("schema", [1, 2])
def test_older_movement_files_migrate_and_are_never_served(tmp_path, schema):
    path = tmp_path / "movement.json"
    key = "CombineAttrs|512|shape|view|" + ("cpu:cpu" if schema == 2 else "")
    path.write_text(json.dumps({"schema": schema, "entries": {key: 1.5}}))
    t, j = tms.MovementCostStore(str(path)), jms.MovementCostStore(str(path))
    assert t._table == j._table
    prefix = tms.LEGACY_V1_PREFIX if schema == 1 else tms.LEGACY_V2_PREFIX
    assert list(t._table) == [prefix + key] and t.get(key) is None
    t.put("fresh", 0.25)
    t.save()
    doc = json.loads(path.read_text())
    assert doc["schema"] == tms.STORE_SCHEMA_VERSION == jms.STORE_SCHEMA_VERSION
    assert doc["entries"] == {prefix + key: 1.5, "fresh": 0.25}


def test_stored_edges_price_the_parallel_ops_on_their_link_class(tmp_path):
    """A movement store's measurement replaces the analytic collective, on
    the edge's own link class only."""
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import OpCostEstimateKey

    spec = tmv.MachineSpecification(2, 1, 4, INTER_GBPS, INTRA_GBPS)
    mstore = tms.MovementCostStore(str(tmp_path / "movement.json"))
    est = T.AnalyticGPUCostEstimator(spec, PEAK_FLOPS, HBM_GBPS, movement_store=mstore)
    attrs, shapes = t_ops.ReplicateAttrs(2), (_pts("t", (8, 16)),)
    out = (_pts("t", (8, 16), copy=2),)
    keys = {p: OpCostEstimateKey(attrs, shapes, out, _view(tmv, p), (False,))
            for p in ("INTRA_NODE", "INTER_NODE")}
    analytic = {p: est.estimate_op_cost(k) for p, k in keys.items()}
    mstore.put_edge(attrs, list(shapes), _view(tmv, "INTRA_NODE"), 7.0, link_class="nvlink")
    assert est.estimate_op_cost(keys["INTRA_NODE"]) == 7.0
    assert est.estimate_op_cost(keys["INTER_NODE"]) == analytic["INTER_NODE"]


# -- the estimators' store wiring -----------------------------------------------------------


def test_local_estimator_times_only_misses_and_writes_them_back(tmp_path):
    store = tcs.CostStore(str(tmp_path))
    local = TLocal(TSettings(1, 2), device="cpu", cost_store=store)
    attrs = t_ops.LinearAttrs(8, use_bias=False)
    first = local.estimate_operator_cost(attrs, [TShape((4, 16))])
    assert local.profile_calls == 1 and store.op_misses == 1 and store.dirty
    store.save()
    again = TLocal(TSettings(1, 2), device="cpu", cost_store=tcs.CostStore(str(tmp_path)))
    second = again.estimate_operator_cost(attrs, [TShape((4, 16))])
    assert again.profile_calls == 0 and second == first


def test_the_audit_feeds_its_measurements_and_pairs_into_the_store(tmp_path, monkeypatch):
    """The audit of the analytic winner writes the JAX audit's entries: the
    same op keys, each with its analytic half (the values are each
    package's own timings); a later estimator times none of them."""
    from flexflow_tpu.observability.plan_audit import audit_plan as j_audit
    from flexflow_tpu_torch.observability.plan_audit import audit_plan

    _no_native(monkeypatch)
    (tmp_path / "jax").mkdir()
    stores, results = {}, {}
    for pkg, cls, audit_fn, d in (("t", tcs.CostStore, audit_plan, tmp_path),
                                  ("j", jcs.CostStore, j_audit, tmp_path / "jax")):
        store = cls(str(d), device_kind=CPU)
        spec, ctx = _analytic(pkg, 2, store)
        result = _search(pkg, ctx, spec)
        kw = {"device": "cpu"} if pkg == "t" else {}
        audit = audit_fn(result.pcg, result.machine_mapping, ctx.cost_estimator,
                         cost_store=store, **kw)
        assert audit["summary"]["num_ops_measured"] > 0
        stats = store.stats()
        assert stats["by_kind"]["op"] == audit["summary"]["num_ops_measured"]
        stores[pkg], results[pkg] = store, result
    keys = {pkg: {k: "analytic_ms" in e for k, e in st._table.items()}
            for pkg, st in stores.items()}
    assert keys["t"] == keys["j"] and any(keys["t"].values())
    store, result = stores["t"], results["t"]
    store.save()
    warm = TLocal(TSettings(1, 2), device="cpu", cost_store=tcs.CostStore(str(tmp_path)))
    for n in result.pcg.topological_ordering():
        leaf = t_leaf_key(result.pcg, n)
        if type(leaf.op_attrs).__name__ in ("LinearAttrs", "ElementUnaryAttrs"):
            warm.estimate_operator_cost_parallel(leaf.op_attrs, list(leaf.input_shapes))
    assert warm.profile_calls == 0


def test_the_serving_search_keeps_its_own_forward_family(tmp_path):
    from flexflow_tpu_torch.serving import ServingLMConfig, build_serving_lm
    from flexflow_tpu_torch.serving.plan import ServingWorkload, optimize_serving_plan

    def builder(b, s):
        return build_serving_lm(ServingLMConfig(), b, s)

    spec = tmv.MachineSpecification(1, 1, 2, 1.0, 2.0)
    wl = ServingWorkload(prompt_len=4, gen_len=4, max_concurrent=4)
    plans, locals_ = [], []
    for _ in range(2):
        plan = optimize_serving_plan(builder, spec, wl, budget=1, max_seq_len=64,
                                     cost_model="measured", device="cpu",
                                     cost_store_dir=str(tmp_path))
        plans.append(plan)
        locals_.append(plan.provenance["cost_db"])
    cold, warm = locals_
    assert cold["op_misses"] > 0 and warm["op_misses"] == 0 and warm["op_hits"] > 0
    assert plans[0].ms_per_token == plans[1].ms_per_token
    keys = json.loads((tmp_path / "cost_db.json").read_text())["entries"]
    assert keys and all(f"|{tcs.forward_fingerprint()}|" in k for k in keys if k.startswith("op|"))


def test_the_drift_repricer_is_the_jax_compiles(tmp_path, monkeypatch):
    """The warm re-search under the store's live scale: the port's repricer
    and the JAX compile's recipe (set live_scale, search with a fresh
    context, put the scale back) give one estimate, and the scale is put
    back."""
    from flexflow_tpu_torch.core.ffmodel import _make_drift_research

    _no_native(monkeypatch)
    store = tcs.CostStore(str(tmp_path), device_kind=CPU)
    spec, ctx, _ = _measured("t", 2, store)
    _search("t", ctx, spec)
    store.save()

    class Cfg:
        search_alpha, search_budget = 1.2, 1

    tstore = tcs.CostStore(str(tmp_path), device_kind=CPU)
    research = _make_drift_research(
        tstore, lambda: _analytic("t", 4, tstore), _mlp(TBuilder, t_lift),
        tmv.MachineSpecification(1, 1, 4, INTER_GBPS, INTRA_GBPS), t_rules([2, 4]), Cfg)
    jstore = jcs.CostStore(str(tmp_path), device_kind=CPU)
    for scale in (1.0, 3.0):
        got = research(scale)
        assert tstore.live_scale is None
        jstore.live_scale = scale
        jspec, jctx = _analytic("j", 4, jstore)
        want = _search("j", jctx, jspec)
        jstore.live_scale = None
        assert math.isclose(got["estimated_ms"], want.runtime, rel_tol=RTOL)
        assert got["parallel_degrees"] == j_summary(want.pcg)


def test_a_searched_compile_wires_the_store_and_the_repricer(tmp_path):
    """FFConfig.cost_store on a searched compile (a group of one rank,
    measured on the host): the provenance's cost_db block, a saved store
    that a second compile reads without timing a leaf, and the drift
    monitor's repricer."""
    import torch.distributed as dist

    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.parallel import init_file_group

    init_file_group(str(tmp_path / "group"), 0, 1, device="cpu")
    try:
        provs = []
        for _ in range(2):
            m = core.FFModel(core.FFConfig(batch_size=6, search_budget=2, cost_model="measured",
                                           cost_store=str(tmp_path)), device="cpu")
            x = m.create_tensor([6, 32], name="x")
            m.dense(m.relu(m.dense(x, 16, use_bias=False, name="fc1")), 4, use_bias=False,
                    name="out")
            m._compile_searched(m._last_output, 1, None)
            provs.append(m.search_provenance["cost_db"])
            assert callable(m._drift_research)
            assert m._drift_research(2.0)["estimated_ms"] > 0
        assert provs[0]["op_misses"] > 0 and provs[1]["op_misses"] == 0
        assert provs[1]["op_hits"] == provs[0]["op_misses"]
    finally:
        dist.destroy_process_group()
