"""The port's machine models (flexflow_tpu_torch/compiler/machine_model.py),
node-axis classification (machine_mapping/slice_axes.py), the two-level DP
over nodes (machine_mapping/hierarchical.py) and the movement export
(machine_mapping/movement_export.py), against the JAX package's
(tests/test_machine_model.py and tests/test_multislice.py are the spec):

- SimpleMachineModel and NetworkedMachineModel (torus and big-switch
  topologies) price every transfer set as the JAX models do, within 1e-12,
  and the port's SimpleMachineModel and a big-switch NetworkedMachineModel
  of the same links agree with each other within 1e-12;
- EnhancedGPUMachineModel (the JAX EnhancedTPUMachineModel read for the
  card: NVSwitch within a node, InfiniBand ports across nodes) against
  costs worked out by hand; machine_model_from_config's versions and file
  format;
- the movement model over a machine model prices the JAX package's;
- every leaf's axis kinds, tensor mask and the node-aware views equal the
  JAX package's; the two-level DP (FFConfig.multislice) and the flat DP on
  2 nodes x 4 GPUs find the JAX winner at its cost within 1e-9, with the
  same outer-level choices; price_mapped_plan re-prices as the JAX one;
- export_movement_predictions of the winner equals the JAX export edge by
  edge, with the link classes named for the card;
- a searched compile over 2 gloo ranks as 2 nodes with multislice and a
  machine-model file (the shared job of tests/test_torch_port_overlap.py)
  finds the JAX plan at its estimate and trains to its parameters.
"""

from __future__ import annotations

import json
import math

import pytest

import bench
import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu.compiler import machine_model as jmm
from flexflow_tpu.compiler.machine_mapping import slice_axes as jsa
from flexflow_tpu.compiler.machine_mapping.movement_export import (
    export_movement_predictions as j_export,
)
from flexflow_tpu.compiler.machine_mapping.problem_tree import _leaf_key as j_leaf_key
from flexflow_tpu.compiler.unity_algorithm import (
    data_parallel_seed as j_dp_seed,
    parallel_degree_summary as j_summary,
    price_mapped_plan as j_price,
    tensor_parallel_seed as j_tp_seed,
)
from flexflow_tpu.compiler.allowed_machine_views import get_slice_aware_machine_views as j_views
from flexflow_tpu.compiler.machine_mapping.problem_tree import task_space_of_leaf as j_task
from flexflow_tpu.pcg import ComputationGraphBuilder as JBuilder
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as j_lift
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu_torch.compiler import machine_model as tmm
from flexflow_tpu_torch.compiler.allowed_machine_views import (
    get_slice_aware_machine_views as t_views,
)
from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
from flexflow_tpu_torch.compiler.machine_mapping import slice_axes as tsa
from flexflow_tpu_torch.compiler.machine_mapping.movement_export import (
    export_movement_predictions as t_export,
    link_class_census,
)
from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import _leaf_key as t_leaf_key
from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import task_space_of_leaf as t_task
from flexflow_tpu_torch.compiler.unity_algorithm import (
    data_parallel_seed as t_dp_seed,
    price_mapped_plan as t_price,
    tensor_parallel_seed as t_tp_seed,
)
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TBuilder
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph as t_lift
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from test_torch_port_overlap import check_job_against_jax, search_ranks

RTOL = 1e-9
SMALL = dict(batch=8, seq=64, embed=64, heads=2, layers=2, vocab=256)
TRANSFERS = [
    [(0, 1)], [(0, 1), (0, 2), (0, 3)], [(0, 4), (1, 5), (2, 6), (3, 7)],
    [(0, 7), (7, 0), (3, 4)], [(0, 4), (4, 0), (1, 4), (5, 0)],
    [(i, (i + 3) % 8) for i in range(8)], [(2, 2)],
]


def _specs(nodes, per_node, inter=0.2, intra=2.0):
    return (tmv.MachineSpecification(nodes, 1, per_node, inter, intra),
            jmv.MachineSpecification(nodes, 1, per_node, inter, intra))


# -- the machine models ------------------------------------------------------------


@pytest.mark.parametrize("nodes,per_node", [(1, 8), (2, 4), (4, 2)])
def test_simple_model_prices_as_the_jax_one(nodes, per_node):
    ts, js = _specs(nodes, per_node)
    t = tmm.SimpleMachineModel(ts, intra_latency_ms=0.003, inter_latency_ms=0.02)
    j = jmm.SimpleMachineModel(js, ici_latency_ms=0.003, dcn_latency_ms=0.02)
    for xfers in TRANSFERS:
        for nbytes in (1.0, 4096.0, 3.3e7):
            assert math.isclose(t.estimate_xfer_cost(nbytes, xfers),
                                j.estimate_xfer_cost(nbytes, xfers), rel_tol=1e-12, abs_tol=0)


@pytest.mark.parametrize("topology", ["torus", "big_switch"])
def test_networked_model_prices_as_the_jax_one(topology):
    if topology == "torus":
        tl, jl = tmm.torus_topology((2, 4), 40.0, 0.002), jmm.torus_topology((2, 4), 40.0, 0.002)
    else:
        tl, jl = tmm.big_switch_topology(8, 40.0, 0.004), jmm.big_switch_topology(8, 40.0, 0.004)
    t, j = tmm.NetworkedMachineModel(8, tl), jmm.NetworkedMachineModel(8, jl)
    for xfers in TRANSFERS:
        for nbytes in (1.0, 4096.0, 3.3e7):
            assert math.isclose(t.estimate_xfer_cost(nbytes, xfers),
                                j.estimate_xfer_cost(nbytes, xfers), rel_tol=1e-12, abs_tol=0)
        for s, d in xfers:
            assert len(t.get_comm_path(s, d)) == len(j.get_comm_path(s, d))


def test_simple_and_networked_agree_on_one_topology():
    """One node's per-pair NVLink links, once as the flat model and once
    as an explicit big-switch topology of the same links."""
    ts, _ = _specs(1, 8, intra=450.0)
    simple = tmm.SimpleMachineModel(ts, intra_latency_ms=0.004)
    net = tmm.NetworkedMachineModel(8, tmm.big_switch_topology(8, 450.0, 0.004))
    for xfers in TRANSFERS:
        for nbytes in (1.0, 4096.0, 3.3e7):
            assert math.isclose(simple.estimate_xfer_cost(nbytes, xfers),
                                net.estimate_xfer_cost(nbytes, xfers), rel_tol=1e-12, abs_tol=0)


def test_enhanced_gpu_model_against_costs_worked_by_hand():
    ts, _ = _specs(2, 8)
    m = tmm.EnhancedGPUMachineModel(ts, nic_ports_per_node=4, intra_latency_ms=0.001,
                                    inter_latency_ms=0.01)
    assert (m.nvlink_gbps, m.ib_gbps) == (H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS) == (450.0, 50.0)
    nb = 9e6  # 9 MB
    nv = nb / (450.0 * 1e6)  # ms over one NVLink direction
    ib = nb / (50.0 * 1e6)  # ms over one InfiniBand port
    # one transfer within a node: the sender's uplink, the receiver's downlink
    assert math.isclose(m.estimate_xfer_cost(nb, [(0, 1)]), 0.001 + nv, rel_tol=1e-12)
    # one GPU sending to three peers shares its uplink: three times its bytes
    assert math.isclose(m.estimate_xfer_cost(nb, [(0, 1), (0, 2), (0, 3)]), 0.001 + 3 * nv,
                        rel_tol=1e-12)
    # disjoint pairs through the switch do not block each other
    assert math.isclose(m.estimate_xfer_cost(nb, [(0, 1), (2, 3), (4, 5)]), 0.001 + nv,
                        rel_tol=1e-12)
    # across nodes: ports (0+8)%4 = 0 and (1+9)%4 = 2, disjoint
    assert m.port_of(0, 8) == 0 and m.port_of(1, 9) == 2
    assert math.isclose(m.estimate_xfer_cost(nb, [(0, 8), (1, 9)]), 0.01 + ib, rel_tol=1e-12)
    # (0, 8) and (4, 12) hash to port 0 alike: they share it
    assert m.port_of(4, 12) == 0
    assert math.isclose(m.estimate_xfer_cost(nb, [(0, 8), (4, 12)]), 0.01 + 2 * ib,
                        rel_tol=1e-12)
    # a node pair's traffic over all four ports
    xfers = [(i, 8 + i) for i in range(8)]
    loads = {}
    for s, d in xfers:
        loads[m.port_of(s, d)] = loads.get(m.port_of(s, d), 0) + 1
    assert math.isclose(m.estimate_xfer_cost(nb, xfers), 0.01 + max(loads.values()) * ib,
                        rel_tol=1e-12)
    # mixed: the slowest link (here the shared port) bounds the makespan,
    # the longest path's latency fills it
    assert math.isclose(m.estimate_xfer_cost(nb, [(0, 1), (0, 8), (4, 12)]), 0.01 + 2 * ib,
                        rel_tol=1e-12)
    assert m.estimate_xfer_cost(nb, [(3, 3)]) == 0.0


def test_machine_model_from_config(tmp_path):
    ts, _ = _specs(2, 4, inter=50.0, intra=450.0)
    assert isinstance(tmm.machine_model_from_config(ts), tmm.SimpleMachineModel)
    path = tmp_path / "machine.json"
    path.write_text(json.dumps({"ici_link_gbps": 300.0, "dcn_link_gbps": 25.0,
                                "nic_ports_per_node": 2, "ici_latency_ms": 0.002,
                                "dcn_latency_ms": 0.03}))
    m = tmm.machine_model_from_config(ts, 1, str(path))
    assert isinstance(m, tmm.EnhancedGPUMachineModel)
    assert (m.nvlink_gbps, m.ib_gbps, m.nic_ports, m.intra_latency_ms, m.inter_latency_ms) == (
        300.0, 25.0, 2, 0.002, 0.03)
    path.write_text(json.dumps({"nvlink_gbps": 200.0, "ib_gbps": 12.5}))
    m = tmm.machine_model_from_config(ts, 1, str(path))
    assert (m.nvlink_gbps, m.ib_gbps, m.nic_ports) == (200.0, 12.5, 4)
    path.write_text(json.dumps({"ici_dims": [2, 2]}))
    with pytest.raises(ValueError, match="torus"):
        tmm.machine_model_from_config(ts, 1, str(path))
    # version 2: the JAX file format, priced as the JAX model prices it
    _, js = _specs(2, 4, inter=50.0, intra=450.0)
    for doc in ({"topology": "torus", "dims": [2, 4], "link_gbps": 40.0},
                {"topology": "big_switch", "link_gbps": 40.0}):
        path.write_text(json.dumps(doc))
        t = tmm.machine_model_from_config(ts, 2, str(path))
        j = jmm.machine_model_from_config(js, 2, str(path))
        for xfers in TRANSFERS:
            assert math.isclose(t.estimate_xfer_cost(1e6, xfers), j.estimate_xfer_cost(1e6, xfers),
                                rel_tol=1e-12)
    path.write_text(json.dumps({"topology": "torus", "dims": [3, 3]}))
    with pytest.raises(ValueError, match="cover"):
        tmm.machine_model_from_config(ts, 2, str(path))
    with pytest.raises(ValueError, match="machine_model_version"):
        tmm.machine_model_from_config(ts, 3)


def _mlp(builder, lift, hidden=64, batch=32):
    b = builder()
    x = b.create_input([batch, hidden], name="x")
    b.dense(b.relu(b.dense(x, hidden, use_bias=False, name="fc1")), hidden, use_bias=False,
            name="fc2")
    return lift(b.graph)


def test_machine_model_movement_pricing_is_the_jax_packages():
    """The comm model over a SimpleMachineModel prices the search's
    movements as the JAX one does: graph_optimize on 2 nodes x 4."""
    ts, js = _specs(2, 4)
    tcomm = tmm.MachineModelCommModel(ts, tmm.SimpleMachineModel(ts, 0.1, 0.2))
    jcomm = jmm.MachineModelCommModel(js, jmm.SimpleMachineModel(js, 0.1, 0.2))
    te = T.AnalyticGPUCostEstimator(ts, 5e10, 10.0, intra_latency_ms=0.1, inter_latency_ms=0.2,
                                    comm_model=tcomm)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=5e10, hbm_gbps=10.0, ici_latency_ms=0.1,
                                    dcn_latency_ms=0.2, comm_model=jcomm)
    tr = T.graph_optimize(_mlp(TBuilder, t_lift), T.MachineMappingContext(
        te, T.make_default_allowed_machine_views()), ts, t_rules([2, 4, 8]),
        T.OptimizerConfig(alpha=1.2, budget=2))
    jr = J.graph_optimize(_mlp(JBuilder, j_lift), J.MachineMappingContext(
        je, J.make_default_allowed_machine_views()), js, j_rules([2, 4, 8]),
        J.OptimizerConfig(alpha=1.2, budget=2))
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert tcomm.overlap_ramp_ms(4.0, 4) == jcomm.overlap_ramp_ms(4.0, 4)


# -- node-axis kinds and the two-level DP --------------------------------------------


@pytest.mark.parametrize("seed", ["dp", "tp"])
def test_axis_kinds_masks_and_views_are_the_jax_packages(seed):
    tp, jp = build_flagship_pcg(**SMALL), bench.build_flagship_pcg(**SMALL)
    tseed, jseed = (t_dp_seed, j_dp_seed) if seed == "dp" else (t_tp_seed, j_tp_seed)
    tp, jp = tseed(tp, 4), jseed(jp, 4)
    ts, js = _specs(2, 4)
    for tn, jn in zip(tp.topological_ordering(), jp.topological_ordering()):
        tl, jl = t_leaf_key(tp, tn), j_leaf_key(jp, jn)
        kinds = tsa.leaf_task_axis_kinds(tl)
        assert kinds == jsa.leaf_task_axis_kinds(jl)
        assert tsa.leaf_tensor_axis_mask(tl) == jsa.leaf_tensor_axis_mask(jl)
        mask = tuple(k in tsa.DCN_LEGAL_KINDS for k in kinds)
        tv = t_views(ts, t_task(tl), mask)
        jv = j_views(js, j_task(jl), mask)
        key = lambda v: (v.start.node_idx, v.start.device_idx,  # noqa: E731
                         tuple((d.stride, d.projection.value) for d in v.dimensions))
        assert sorted(map(key, tv)) == sorted(map(key, jv))
        for v, w in zip(sorted(tv, key=key), sorted(jv, key=key)):
            assert tsa.view_is_slice_legal(tl, v) == jsa.view_is_slice_legal(jl, w)


def _ms_contexts(spec_pair, slice_aware, hierarchy, gap_flat=False):
    ts, js = spec_pair
    te = T.AnalyticGPUCostEstimator(ts, 5e10, 10.0, intra_latency_ms=0.1,
                                    inter_latency_ms=0.1 if gap_flat else 0.2)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=5e10, hbm_gbps=10.0, ici_latency_ms=0.1,
                                    dcn_latency_ms=0.1 if gap_flat else 0.2)
    return (T.MachineMappingContext(te, T.make_default_allowed_machine_views(),
                                    overlap_fraction=0.5, slice_aware=slice_aware,
                                    slice_hierarchy=hierarchy),
            J.MachineMappingContext(je, J.make_default_allowed_machine_views(),
                                    overlap_fraction=0.5, slice_aware=slice_aware,
                                    slice_hierarchy=hierarchy))


def _proxy(builder, lift, layers=3, d=256, batch=128):
    b = builder()
    h = b.create_input([batch, d], name="x")
    for i in range(layers):
        h = b.relu(b.dense(h, d, use_bias=False, name=f"l{i}"))
    return lift(b.graph)


@pytest.fixture(scope="module")
def two_level(request):
    """The two-level and the flat searches of both packages on 2 nodes x 4
    GPUs with InfiniBand 10x slower than NVLink."""
    specs = _specs(2, 4, inter=0.2, intra=2.0)
    out = {}
    for name, (aware, hier) in {"hier": (True, True), "aware": (True, False),
                                "flat": (False, False)}.items():
        tctx, jctx = _ms_contexts(specs, aware, hier)
        tr = T.graph_optimize(_proxy(TBuilder, t_lift), tctx, specs[0], t_rules([2, 4, 8]),
                              T.OptimizerConfig(alpha=1.2, budget=2))
        jr = J.graph_optimize(_proxy(JBuilder, j_lift), jctx, specs[1], j_rules([2, 4, 8]),
                              J.OptimizerConfig(alpha=1.2, budget=2))
        out[name] = (tr, jr, tctx, jctx)
    return specs, out


@pytest.mark.parametrize("name", ["hier", "aware", "flat"])
def test_the_two_level_and_flat_dps_find_the_jax_winner(two_level, name):
    _, out = two_level
    tr, jr, _, _ = out[name]
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert tr.telemetry["hierarchical"] == (name == "hier")
    if name == "hier":
        assert tr.hierarchical["winner"] == jr.hierarchical["winner"]
        assert tr.hierarchical["choices"].keys() == jr.hierarchical["choices"].keys()
        for k, v in jr.hierarchical["choices"].items():
            got = tr.hierarchical["choices"][k]
            assert (got is None) == (v is None) and (v is None or math.isclose(got, v,
                                                                               rel_tol=RTOL)), k
    else:
        assert tr.hierarchical is None


def test_price_mapped_plan_is_the_jax_packages(two_level):
    """The flat winner re-priced under the node-aware two-level model."""
    specs, out = two_level
    tflat, jflat, _, _ = out["flat"]
    _, _, thier_ctx, jhier_ctx = out["hier"]
    t = t_price(tflat.pcg, tflat.machine_mapping, thier_ctx, specs[0])
    j = j_price(jflat.pcg, jflat.machine_mapping, jhier_ctx, specs[1])
    assert (t is None) == (j is None)
    if t is not None:
        assert math.isclose(t, j, rel_tol=RTOL)
    _, _, taware, jaware = out["aware"]
    t = t_price(tflat.pcg, tflat.machine_mapping, taware, specs[0])
    j = j_price(jflat.pcg, jflat.machine_mapping, jaware, specs[1])
    assert (t is None) == (j is None)


@pytest.mark.parametrize("name", ["hier", "flat"])
def test_movement_export_is_the_jax_packages(two_level, name):
    _, out = two_level
    tr, jr, tctx, jctx = out[name]
    tp = t_export(tr.pcg, tr.machine_mapping, tctx.cost_estimator)
    jp = j_export(jr.pcg, jr.machine_mapping, jctx.cost_estimator)
    assert len(tp) == len(jp) > 0
    link = {"ici": "nvlink", "dcn": "ib"}
    for t, j in zip(tp, jp):
        tj, jj = t.to_json(), j.to_json()
        assert tj.pop("link_class") == link[jj.pop("link_class")]
        assert tj == jj
        assert t.templates == j.templates
    census = link_class_census(tp)
    assert sum(c["edges"] for c in census.values()) == len(tp)
    assert set(census) <= {"nvlink", "ib"}
    with pytest.raises(ValueError, match="estimator"):
        t_export(tr.pcg, tr.machine_mapping, None)


def test_ffconfig_multislice_over_ranks_finds_and_trains_the_jax_plan(tmp_path_factory):
    runs = search_ranks(tmp_path_factory)
    check_job_against_jax(runs, "nodes")
