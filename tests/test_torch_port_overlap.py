"""The overlap pricing of the collective matmuls (flexflow_tpu_torch/
compiler/machine_mapping/overlap.py) and FFConfig.overlap in a search,
against the JAX package's (tests/test_collective_matmul.py's search
cases are the spec):

- each series split's eligibility (kind, ring length, adjacent op, its
  roofline class and ceiling) on the two site shapes and the small
  flagship's tp plan equals the JAX package's;
- graph_optimize with overlap_lowering on the analytic estimators with the
  same constants: the winner's cost within 1e-9 and every overlap edge of
  the winner's solve (serial and overlapped exposures, chosen) equal; the
  re-walk reproduces the winner's cost;
- one job of 2 gloo ranks (launched once a session, tests/
  test_torch_port_once.py, and shared with test_torch_port_mcmc.py and
  test_torch_port_rules.py) against the JAX FFModel on 2 virtual devices:
  a searched compile with overlap=True prices the fused edges as the JAX
  search does (estimate within 1e-9, the same plan) and trains through
  the collective matmuls to the JAX run's parameters within 1e-5 (f32),
  and to its own serial lowering's within 1e-5; its audit times the fused
  edges as fused.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

import bench
import flexflow_tpu.compiler as J
import flexflow_tpu_torch.compiler as T
from flexflow_tpu import core as jcore
from flexflow_tpu.compiler.machine_mapping.overlap import series_split_overlap as j_eligible
from flexflow_tpu.compiler.unity_algorithm import tensor_parallel_seed as j_tp_seed
from flexflow_tpu.pcg import ComputationGraphBuilder as JBuilder
from flexflow_tpu.pcg import machine_view as jmv
from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as j_lift
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu_torch.compiler.machine_mapping.overlap import (
    series_split_overlap as t_eligible,
)
from flexflow_tpu_torch.compiler.unity_algorithm import tensor_parallel_seed as t_tp_seed
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.pcg import machine_view as tmv
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TBuilder
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph as t_lift
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-9
TOL = 1e-5
SMALL = dict(batch=8, seq=64, embed=64, heads=2, layers=2, vocab=256)
# (peak FLOP/s, HBM GB/s, overlap_fraction): the FFModel's CPU constants,
# and a slower compute with fully exposed serial comm
CONSTANTS = {"cpu": (5e10, 10.0, 0.5), "slow": (2e8, 10.0, 0.0)}


def _mlp(builder, lift, batch=64, d=256, h=2048, o=16):
    b = builder()
    x = b.create_input([batch, d], name="x")
    t = b.relu(b.dense(x, h, use_bias=False, name="fc1"))
    b.dense(t, o, use_bias=False, name="out")
    return lift(b.graph)


def _contexts(ndev, constants, overlap=True):
    peak, hbm, fraction = CONSTANTS[constants]
    ts, js = tmv.MachineSpecification(1, 1, ndev, 1.0, 2.0), jmv.MachineSpecification(
        1, 1, ndev, 1.0, 2.0)
    te = T.AnalyticGPUCostEstimator(ts, peak, hbm, intra_latency_ms=0.1, inter_latency_ms=0.2)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=peak, hbm_gbps=hbm, ici_latency_ms=0.1,
                                    dcn_latency_ms=0.2)
    return (ts, T.MachineMappingContext(te, T.make_default_allowed_machine_views(),
                                        overlap_fraction=fraction, overlap_lowering=overlap),
            js, J.MachineMappingContext(je, J.make_default_allowed_machine_views(),
                                        overlap_fraction=fraction, overlap_lowering=overlap))


def _pcgs(model):
    if model == "mlp":
        return _mlp(TBuilder, t_lift), _mlp(JBuilder, j_lift)
    return build_flagship_pcg(**SMALL), bench.build_flagship_pcg(**SMALL)


def _splits(tree):
    out = []

    def walk(t):
        if hasattr(t, "tensor_set_movement"):
            out.append(t)
        for c in (getattr(t, "left", None), getattr(t, "right", None)):
            if c is not None:
                walk(c)

    walk(tree)
    return out


def _info(i):
    if i is None:
        return None
    return (i.kind, i.chunks, i.adjacent_op, i.roofline_class, round(i.adjacent_ms, 12),
            i.edge_op, i.src_path, i.dst_path)


@pytest.mark.parametrize("model,deg", [("mlp", 2), ("mlp", 4), ("flagship", 2)])
def test_split_eligibility_is_the_jax_packages(model, deg):
    tp, jp = _pcgs(model)
    tp, jp = t_tp_seed(tp, deg), j_tp_seed(jp, deg)
    _, tctx, _, jctx = _contexts(deg, "cpu")
    ttree, _ = T.get_machine_mapping_problem_tree(tp)
    jtree, _ = J.get_machine_mapping_problem_tree(jp)
    tinfo = [_info(t_eligible(s, tctx)) for s in _splits(ttree)]
    jinfo = [_info(j_eligible(s, jctx)) for s in _splits(jtree)]
    assert tinfo == jinfo
    assert any(i is not None for i in tinfo)
    # without the switch no split is eligible
    _, tctx0, _, _ = _contexts(deg, "cpu", overlap=False)
    assert all(t_eligible(s, tctx0) is None for s in _splits(ttree))


@pytest.mark.parametrize("model,ndev", [("mlp", 2), ("mlp", 4), ("flagship", 4)])
@pytest.mark.parametrize("constants", sorted(CONSTANTS))
def test_overlap_priced_search_is_the_jax_packages(model, ndev, constants):
    tp, jp = _pcgs(model)
    ts, tctx, js, jctx = _contexts(ndev, constants)
    degs = [d for d in range(2, ndev + 1) if ndev % d == 0]
    tr = T.graph_optimize(tp, tctx, ts, t_rules(degs), T.OptimizerConfig(alpha=1.2, budget=2))
    jr = J.graph_optimize(jp, jctx, js, j_rules(degs), J.OptimizerConfig(alpha=1.2, budget=2))
    assert math.isclose(tr.runtime, jr.runtime, rel_tol=RTOL)
    assert T.parallel_degree_summary(tr.pcg) == J.unity_algorithm.parallel_degree_summary(jr.pcg)
    assert len(tr.overlap_edges) == len(jr.overlap_edges)
    for te, je in zip(tr.overlap_edges, jr.overlap_edges):
        assert te.keys() == je.keys()
        for k, v in je.items():
            if isinstance(v, float):
                assert math.isclose(te[k], v, rel_tol=RTOL, abs_tol=1e-12), k
            else:
                assert te[k] == v, k
        # the re-walk prices the winner the DP priced
        assert math.isclose(te["recomputed_root_ms"], te["winner_root_ms"], rel_tol=1e-6)
    if model == "mlp":
        assert tr.overlap_edges


# -- the job of 2 gloo ranks (shared with test_torch_port_mcmc.py and
# test_torch_port_rules.py) -------------------------------------------------------

# a legacy TASO rule (tests/test_legacy_rules.py's EXAMPLE): an elementwise
# add partitioned along dim 1
LEGACY_RULE = {"_t": "RuleCollection", "rule": [{
    "_t": "Rule", "name": "example_subst",
    "srcOp": [{"_t": "Operator", "type": "OP_EW_ADD", "para": [],
               "input": [{"_t": "Tensor", "opId": -1, "tsId": 0},
                         {"_t": "Tensor", "opId": -2, "tsId": 0}]}],
    "dstOp": [
        {"_t": "Operator", "type": "OP_PARTITION",
         "input": [{"_t": "Tensor", "opId": -1, "tsId": 0}],
         "para": [{"_t": "Parameter", "key": "PM_PARALLEL_DIM", "value": 1},
                  {"_t": "Parameter", "key": "PM_PARALLEL_DEGREE", "value": 2}]},
        {"_t": "Operator", "type": "OP_PARTITION",
         "input": [{"_t": "Tensor", "opId": -2, "tsId": 0}],
         "para": [{"_t": "Parameter", "key": "PM_PARALLEL_DIM", "value": 1},
                  {"_t": "Parameter", "key": "PM_PARALLEL_DEGREE", "value": 2}]},
        {"_t": "Operator", "type": "OP_EW_ADD", "para": [],
         "input": [{"_t": "Tensor", "opId": 0, "tsId": 0},
                   {"_t": "Tensor", "opId": 1, "tsId": 0}]},
        {"_t": "Operator", "type": "OP_COMBINE",
         "input": [{"_t": "Tensor", "opId": 2, "tsId": 0}],
         "para": [{"_t": "Parameter", "key": "PM_PARALLEL_DIM", "value": 1},
                  {"_t": "Parameter", "key": "PM_PARALLEL_DEGREE", "value": 2}]}],
    "mappedOutput": [{"_t": "MapOutput", "dstOpId": 3, "dstTsId": 0, "srcOpId": 0,
                      "srcTsId": 0}]}]}

# name -> (FFConfig fields, model, samples); rule files are filled in per run
JOBS = {
    "serial": dict(cfg=dict(batch_size=64, search_budget=2), model="wide", samples=128),
    "overlap": dict(cfg=dict(batch_size=64, search_budget=2, overlap=True, plan_audit=True),
                    model="wide", samples=128),
    "mcmc": dict(cfg=dict(batch_size=16, search_budget=2, search_algorithm="mcmc"),
                 model="small", samples=32),
    "rules": dict(cfg=dict(batch_size=8, search_budget=10, perform_fusion=True),
                  model="siblings", samples=16),
    # the two ranks as two nodes of one GPU, searched by the two-level DP
    # over a machine model read from a file
    "nodes": dict(cfg=dict(batch_size=16, search_budget=2, num_nodes=2, multislice=True),
                  model="small", samples=32),
    # fat isomorphic towers, stacked before the search (models/branchy.py)
    "branchy": dict(cfg=dict(batch_size=16, search_budget=4, branch_stacking=True),
                    model="branchy", samples=32),
}
# the machine-model file of the "nodes" job: a SimpleMachineModel
# (version 0) with the latencies both packages' CPU searches use
MACHINE_MODEL = {"ici_latency_ms": 0.1, "dcn_latency_ms": 0.2}


def build_job_model(pkg, cfg, model, device=None):
    """The job's models, built alike in both packages."""
    m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
    if model == "wide":
        x = m.create_tensor([cfg["batch_size"], 256], name="x")
        logits = m.dense(m.relu(m.dense(x, 2048, use_bias=False, name="fc1")), 16,
                         use_bias=False, name="out")
    elif model == "small":
        x = m.create_tensor([cfg["batch_size"], 32], name="x")
        logits = m.dense(m.relu(m.dense(x, 16, use_bias=False, name="fc1")), 4,
                         use_bias=False, name="out")
    elif model == "branchy":
        import importlib

        towers = importlib.import_module(pkg.__name__.split(".")[0] + ".models.branchy")
        logits = towers.add_branchy_towers(m, cfg["batch_size"], 64)
    else:  # two sibling Linears of one input (the fusion rules' QKV shape) and an add
        x = m.create_tensor([cfg["batch_size"], 16], name="x")
        q = m.dense(x, 16, use_bias=False, name="q")
        k = m.dense(x, 16, use_bias=False, name="k")
        logits = m.dense(m.add(q, k), 4, name="head")
    m.compile(pkg.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy",
              metrics=["sparse_categorical_crossentropy"], logit_tensor=logits)
    return m


def _weights(m):
    g = getattr(m.instance, "pcg", m.cg)
    return [g.layer_attrs(n).name for n in g.topological_ordering()
            if type(g.op_attrs(n)).__name__ == "WeightAttrs" and g.layer_attrs(n).name]


WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, pcg_params_to_numpy
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.utils.graph import Node

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "build.py")).read())
    out = {}
    for name, job in json.load(open(os.path.join(work, "jobs.json"))).items():
        data = np.load(os.path.join(work, f"{name}.npz"))
        m = build_job_model(core, dict(job["cfg"], print_freq=0, max_devices=2), job["model"],
                            device="cpu")
        ffmodel_state_from_numpy(m, {k: data[k] for k in data.files if k.startswith("n")})
        perf = m.fit(x=data["xs"], y=data["ys"], epochs=2, shuffle=False, verbose=False)
        sp = m.search_provenance
        inst = m.instance
        full = pcg_params_to_numpy(inst.pcg, inst.shardings, inst.machine_mesh, m.params)
        by_name = {inst.pcg.layer_attrs(Node(int(k[1:]))).name: v for k, v in full.items()}
        out[name] = dict(
            kind=type(m.instance).__name__, loss=float(perf.sparse_cce_loss),
            estimated_ms=sp.get("estimated_ms"), degrees=sp.get("parallel_degrees"),
            algorithm=sp.get("search_algorithm"), telemetry_evaluations=sp.get("evaluations"),
            overlap=sp.get("overlap"), audit=sp.get("plan_audit"),
            fused=sorted(m.instance.fused_sites.values()),
            weights={n: by_name[n].tolist() for n in job["weights"]})
    json.dump(out, open(os.path.join(work, f"rank{rank}.json"), "w"))
    dist.destroy_process_group()
    """
)


def _run_search_ranks(work: Path):
    import inspect

    rule_path = work / "legacy_rules.json"
    rule_path.write_text(json.dumps(LEGACY_RULE))
    model_path = work / "machine_model.json"
    model_path.write_text(json.dumps(MACHINE_MODEL))
    files = {"rules": {"substitution_json_path": str(rule_path)},
             "nodes": {"machine_model_file": str(model_path)}}
    jobs = {name: dict(job, cfg=dict(job["cfg"], **files.get(name, {})))
            for name, job in JOBS.items()}
    ref = {}
    for name, job in jobs.items():
        cfg = dict(job["cfg"], print_freq=0, max_devices=2)
        cfg.pop("plan_audit", None)  # the JAX audit times on its own devices: not compared
        m = build_job_model(jcore, cfg, job["model"])
        init = {k: np.array(v) for k, v in m.params.items()}
        rs = np.random.RandomState(7)
        width = {"wide": 256, "small": 32, "siblings": 16, "branchy": 64}[job["model"]]
        classes = {"wide": 16, "small": 4, "siblings": 4, "branchy": 16}[job["model"]]
        xs = rs.randn(job["samples"], width).astype(np.float32)
        ys = rs.randint(0, classes, job["samples"])
        perf = m.fit(x=xs, y=ys, epochs=2, shuffle=False, verbose=False)
        names = _weights(m)
        g = getattr(m.instance, "pcg", m.cg)
        weights = {g.layer_attrs(n).name: np.asarray(m.params[f"n{n.idx}"])
                   for n in g.topological_ordering() if g.layer_attrs(n).name in names}
        sp = m.search_provenance
        ref[name] = dict(loss=float(perf.sparse_cce_loss), estimated_ms=sp["estimated_ms"],
                         degrees=sp["parallel_degrees"], overlap=sp.get("overlap"),
                         weights=weights)
        jobs[name]["weights"] = names
        np.savez(work / f"{name}.npz", xs=xs, ys=ys, **init)
    (work / "jobs.json").write_text(json.dumps(jobs))
    (work / "build.py").write_text(inspect.getsource(build_job_model))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    return dict(ref=ref, ranks=[json.loads((work / f"rank{r}.json").read_text())
                                for r in range(2)])


def search_ranks(tmp_path_factory):
    """The shared job's results: {"ref": the JAX runs, "ranks": each rank's}."""
    return once_per_session(tmp_path_factory, "search_ranks", _run_search_ranks)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return search_ranks(tmp_path_factory)


def check_job_against_jax(runs, name):
    """A job's compile on both ranks found the JAX plan at the JAX estimate
    and trained to the JAX parameters."""
    want = runs["ref"][name]
    for r in runs["ranks"]:
        got = r[name]
        assert got["kind"] == "DistributedTrainingInstance"
        assert math.isclose(got["estimated_ms"], want["estimated_ms"], rel_tol=RTOL)
        assert got["degrees"] == want["degrees"]
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=TOL)
        assert got["weights"].keys() == want["weights"].keys() and got["weights"]
        for key, w in want["weights"].items():
            np.testing.assert_allclose(np.asarray(got["weights"][key]), w, rtol=TOL, atol=TOL,
                                       err_msg=f"{name} {key}")


@pytest.mark.parametrize("name", ["serial", "overlap"])
def test_searched_overlap_compile_trains_as_the_jax_run(ranks, name):
    check_job_against_jax(ranks, name)


def test_the_overlap_search_prices_the_fused_edges_as_the_jax_search(ranks):
    want = ranks["ref"]["overlap"]["overlap"]
    for r in ranks["ranks"]:
        got = r["overlap"]["overlap"]
        assert got["priced"] and got["enabled"]
        assert got["eligible"] == want["eligible"] > 0 and got["chosen"] == want["chosen"]
        for ge, we in zip(got["edges"], want["edges"]):
            for k in ("kind", "chosen", "edge_op", "adjacent_op", "chunks", "src_node",
                      "dst_node", "src_name", "dst_name"):
                assert ge[k] == we[k], k
            for k in ("serial_exposed_ms", "overlapped_exposed_ms", "comm_ms"):
                assert math.isclose(ge[k], we[k], rel_tol=RTOL, abs_tol=1e-12), k


def test_the_fused_lowering_trains_to_the_serial_lowerings_parameters(ranks):
    for r in ranks["ranks"]:
        serial, fused = r["serial"], r["overlap"]
        assert serial["fused"] == [] and fused["fused"]
        assert serial["degrees"] == fused["degrees"]
        np.testing.assert_allclose(fused["loss"], serial["loss"], rtol=TOL)
        for key, w in serial["weights"].items():
            np.testing.assert_allclose(np.asarray(fused["weights"][key]), np.asarray(w),
                                       rtol=TOL, atol=TOL, err_msg=key)


def test_the_audit_times_the_fused_edges_as_fused(ranks):
    audits = [r["overlap"]["audit"] for r in ranks["ranks"]]
    assert audits[0] == audits[1]  # rank 0's audit, recorded on every rank
    audit = audits[0]
    assert "error" not in audit, audit
    fused = [e for e in audit["movement_edges"] if "fused_kind" in e]
    assert fused and all(e["fused"] for e in fused)
    assert audit["summary"]["num_fused_edges"] == len(fused)
    for e in fused:
        assert e["measured_ms"] is not None and e["measured_ms"] >= 0
        assert "predicted_overlapped_ms" in e
