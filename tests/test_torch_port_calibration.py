"""Calibration over ranks (flexflow_tpu_torch/compiler/calibration.py) and
the pricing it feeds (compiler/machine_mapping/cost_estimator.py), against
the JAX package's, with tests/test_calibration.py as the spec:

- MachineCalibration's as_dict and allreduce_constants (the log-log
  interpolation) on the same constants, rank_inversions on the same pairs,
  and the two-payload fit of the all-reduce from given times (the JAX
  calibrate's, its probes replaced by those times);
- _scale_for_emulated_shards, the parallel ops' prices (measured constants,
  weight-resident, emulated mesh, on one node and on two) and an op leaf's
  cost under a calibration, against AnalyticTPUCostEstimator on the same
  constants;
- graph_optimize on the small flagship with one injected calibration and
  an emulated mesh: the same winner, runtime within 1e-9;
- one live calibrate over 2 gloo processes: every rank holds one equal
  calibration, its constants positive and finite, 1 <= shard_speedup <= 2,
  memoized per (backend, device count), and the ranks found sharing a
  device.

Every comparison of numbers is within 1e-12 relative unless said."""

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

import bench
import flexflow_tpu.compiler as J
import flexflow_tpu.compiler.calibration as jcal
import flexflow_tpu_torch.compiler as T
import flexflow_tpu_torch.compiler.calibration as tcal
from flexflow_tpu.compiler.machine_mapping import cost_estimator as jce
from flexflow_tpu.op_attrs import ops as j_ops
from flexflow_tpu.op_attrs.datatype import DataType as JDT
from flexflow_tpu.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as JDims,
    ParallelTensorShape as JPShape,
    ShardParallelDim as JShard,
)
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
from flexflow_tpu_torch.compiler.machine_mapping import cost_estimator as tce
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.op_attrs import ops as t_ops
from flexflow_tpu_torch.op_attrs.datatype import DataType as TDT
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as TDims,
    ParallelTensorShape as TPShape,
    ShardParallelDim as TShard,
)
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification as TSpec
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules

REPO = Path(__file__).resolve().parent.parent
RTOL = 1e-12
SEARCH_RTOL = 1e-9
ALLREDUCE = {2: (0.05, 4.0), 8: (0.2, 0.5)}


def _cals(shard_speedup=1.0, overlap=0.86, allreduce=ALLREDUCE, n=8):
    """The same calibration in both packages."""
    return tuple(
        mod.MachineCalibration(
            backend="cpu", num_devices=n, peak_flops=1e11, hbm_gbps=8.0,
            allreduce={k: mod.CollectiveConstants(*v) for k, v in allreduce.items()},
            overlap=overlap, shard_speedup=shard_speedup)
        for mod in (tcal, jcal))


def _close(a, b, rtol=RTOL):
    return math.isclose(a, b, rel_tol=rtol, abs_tol=0.0)


def test_as_dict_matches():
    t, j = _cals()
    assert t.as_dict() == j.as_dict()
    t, j = _cals(shard_speedup=None, overlap=None)
    assert t.as_dict() == j.as_dict()


@pytest.mark.parametrize("k", [1, 2, 3, 4, 6, 8, 16])
def test_allreduce_interpolation_matches(k):
    t, j = _cals()
    tc, jc = t.allreduce_constants(k), j.allreduce_constants(k)
    if jc is None:
        assert tc is None
        return
    assert _close(tc.lat_ms, jc.lat_ms) and _close(tc.gbps, jc.gbps)


@pytest.mark.parametrize("pairs", [[(10.0, 100.0), (20.0, 50.0)], [(100.0, 500.0), (103.0, 400.0)],
                                   [(10.0, 50.0), (20.0, 100.0), (40.0, 300.0)],
                                   [(5.0, 1.0), (5.1, 3.0), (9.0, 2.0), (2.0, 8.0)]])
def test_rank_inversions_match(pairs):
    assert tcal.rank_inversions(pairs) == jcal.rank_inversions(pairs)
    assert tcal.rank_inversions(pairs, 0.2) == jcal.rank_inversions(pairs, 0.2)


@pytest.mark.parametrize("times", [{2: (0.3, 1.9), 4: (0.5, 3.1)},  # a clean slope
                                   {2: (0.9, 0.8), 4: (0.5, 0.5)}])  # noise: no positive slope
def test_two_payload_fit_matches(times, monkeypatch):
    """The JAX calibrate on 4 virtual devices with its probes replaced by
    given times, and the port's fit of the same times."""
    payloads = (1 << 20, 8 << 20)
    seen = []

    def fake_allreduce(devs, k, payload, settings):
        seen.append(k)
        return times[k][payloads.index(payload)]

    monkeypatch.setattr(jcal, "_measure_compute", lambda s: 1e11)
    monkeypatch.setattr(jcal, "_measure_hbm", lambda s: 8.0)
    monkeypatch.setattr(jcal, "_measure_allreduce", fake_allreduce)
    monkeypatch.setattr(jcal, "_measure_overlap", lambda d, p, s: 0.5)
    monkeypatch.setattr(jcal, "_measure_shard_speedup", lambda d, s: 1.0)
    want = jcal.calibrate(jax.devices()[:4], payloads).allreduce
    assert sorted(want) == sorted(set(seen)) == [2, 4]
    for k, (t_s, t_l) in times.items():
        got = tcal.fit_allreduce(*payloads, t_s, t_l)
        assert _close(got.lat_ms, want[k].lat_ms) and _close(got.gbps, want[k].gbps), k


class _Est:
    def __init__(self, emulated, cal, ndev=8):
        self.emulated_mesh, self.calibration = emulated, cal
        self.machine_spec = (TSpec if isinstance(cal, tcal.MachineCalibration) else JSpec)(
            1, 1, ndev, 25.0, 400.0)


@pytest.mark.parametrize("case", [dict(emulated=True, speedup=1.0),
                                  dict(emulated=True, speedup=8.0),
                                  dict(emulated=True, speedup=3.0, ndev=4),
                                  dict(emulated=False, speedup=1.0),
                                  dict(emulated=True, speedup=None),
                                  dict(emulated=True, speedup=1.0, ndev=1),
                                  dict(emulated=True, speedup=1.0, cal=False)])
def test_scale_for_emulated_shards_matches(case):
    t, j = _cals(shard_speedup=case["speedup"])
    if case.get("cal") is False:
        t = j = None
    ndev = case.get("ndev", 8)
    te, je = _Est(case["emulated"], t, ndev), _Est(case["emulated"], j, ndev)
    if t is None:
        te.machine_spec = TSpec(1, 1, ndev, 25.0, 400.0)
        je.machine_spec = JSpec(1, 1, ndev, 25.0, 400.0)
    assert _close(tce._scale_for_emulated_shards(2.5, te),
                  jce._scale_for_emulated_shards(2.5, je))


def _pshape(mod, sizes, degrees, sum_degree=1, copy=1):
    dims, shard, dt = (TDims, TShard, TDT) if mod == "t" else (JDims, JShard, JDT)
    cls = TPShape if mod == "t" else JPShape
    return cls(dims(tuple(shard(s, d) for s, d in zip(sizes, degrees)), sum_degree, copy),
               dt.FLOAT)


PARALLEL_OPS = [("RepartitionAttrs", (0, 4)), ("CombineAttrs", (0, 4)), ("ReplicateAttrs", (4,)),
                ("ReductionAttrs", (4,)), ("ReplicateAttrs", (2,)), ("CombineAttrs", (1, 8))]


@pytest.mark.parametrize("op,args", PARALLEL_OPS)
@pytest.mark.parametrize("calibrated", [False, True])
@pytest.mark.parametrize("resident", [False, True])
@pytest.mark.parametrize("emulated", [False, True])
@pytest.mark.parametrize("nodes", [1, 2])
def test_parallel_op_prices_match(op, args, calibrated, resident, emulated, nodes):
    t_cal, j_cal = _cals() if calibrated else (None, None)
    degree = args[-1]
    # the op's input: sharded where a Combine gathers, summed where a
    # Reduction sums, whole otherwise
    degrees = [1, 1]
    sum_degree = 1
    if op == "CombineAttrs":
        degrees[args[0]] = degree
    if op == "ReductionAttrs":
        sum_degree = degree
    prices = []
    for mod, ops, spec in (("t", t_ops, TSpec), ("j", j_ops, JSpec)):
        attrs = getattr(ops, op)(*args)
        shape = _pshape(mod, (64, 512), degrees, sum_degree)
        machine = spec(nodes, 1, 8 // nodes, 25.0, 400.0)
        kw = dict(weight_resident=resident, emulated_mesh=emulated,
                  calibration=t_cal if mod == "t" else j_cal)
        fn = tce.parallel_op_cost_ms if mod == "t" else jce.parallel_op_cost_ms
        prices.append(fn(attrs, [shape], machine, 0.001, 0.01, machine_view=None, **kw))
    assert _close(*prices), prices


@pytest.mark.parametrize("speedup", [1.0, 2.0, None])
def test_op_cost_under_a_calibration_matches(speedup):
    """A dp8 Linear leaf and a Replicate priced by the calibrated estimator
    on an emulated mesh, in both packages."""
    from flexflow_tpu.compiler.machine_mapping.problem_tree import OpCostEstimateKey as JKey
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import OpCostEstimateKey as TKey

    t_cal, j_cal = _cals(shard_speedup=speedup)
    costs = []
    for mod, ops, key_cls, est in (
            ("t", t_ops, TKey, lambda c: T.AnalyticGPUCostEstimator(
                TSpec(1, 1, 8, 25.0, 400.0), 1e11, 8.0, emulated_mesh=True, calibration=c)),
            ("j", j_ops, JKey, lambda c: J.AnalyticTPUCostEstimator(
                JSpec(1, 1, 8, 25.0, 400.0), peak_flops=1e11, hbm_gbps=8.0, emulated_mesh=True,
                calibration=c))):
        cal = t_cal if mod == "t" else j_cal
        x = _pshape(mod, (32, 64), [8, 1])
        w = _pshape(mod, (64, 64), [1, 1], copy=8)
        y = _pshape(mod, (32, 64), [8, 1])
        linear = key_cls(ops.LinearAttrs(out_channels=64, use_bias=False), (x, w), (y,), None)
        rep = key_cls(ops.ReplicateAttrs(8), (_pshape(mod, (64, 64), [1, 1]),),
                      (_pshape(mod, (64, 64), [1, 1], copy=8),), None, weight_inputs=(True,))
        e = est(cal)
        costs.append((e.estimate_op_cost(linear), e.estimate_op_cost(rep)))
    for a, b in zip(*costs):
        assert _close(a, b), costs


def test_graph_optimize_with_an_injected_calibration_matches():
    """The small flagship searched at 4 devices on an emulated mesh with one
    calibration: the overlap fraction its measured overlap, the parallel
    ops priced from its all-reduce constants, compute scaled by its shard
    speedup."""
    from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary as j_summary

    small = dict(batch=8, seq=64, embed=64, heads=2, layers=2, vocab=256)
    t_cal, j_cal = _cals(shard_speedup=1.5, overlap=0.3,
                         allreduce={2: (0.02, 6.0), 4: (0.04, 3.0)}, n=4)
    ts, js = TSpec(1, 1, 4, 25.0, 400.0), JSpec(1, 1, 4, 25.0, 400.0)
    te = T.AnalyticGPUCostEstimator(ts, 1e11, 100.0, intra_latency_ms=0.001,
                                    inter_latency_ms=0.01, emulated_mesh=True, calibration=t_cal)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=1e11, hbm_gbps=100.0, ici_latency_ms=0.001,
                                    dcn_latency_ms=0.01, emulated_mesh=True, calibration=j_cal)
    tctx = T.MachineMappingContext(te, T.make_default_allowed_machine_views(),
                                   overlap_fraction=t_cal.overlap)
    jctx = J.MachineMappingContext(je, J.make_default_allowed_machine_views(),
                                   overlap_fraction=j_cal.overlap)
    tr = T.graph_optimize(build_flagship_pcg(**small), tctx, ts, t_rules([2, 4]),
                          T.OptimizerConfig(alpha=1.2, budget=2))
    jr = J.graph_optimize(bench.build_flagship_pcg(**small), jctx, js, j_rules([2, 4]),
                          J.OptimizerConfig(alpha=1.2, budget=2))
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert _close(tr.runtime, jr.runtime, SEARCH_RTOL)
    assert _close(tr.serial_runtime, jr.serial_runtime, SEARCH_RTOL)
    for label, ms in jr.seed_runtimes.items():
        assert _close(tr.seed_runtimes[label], ms, SEARCH_RTOL), label


# One rank of the live calibration; argv: rank, world, work dir.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.compiler.calibration import calibrate, get_calibration
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.runtime.distributed import ranks_share_a_device

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu")
    cal = get_calibration("cpu")
    again = get_calibration("cpu", world)
    shared = ranks_share_a_device("cpu")
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(dict(cal=cal.as_dict(), raw=dict(peak=cal.peak_flops, hbm=cal.hbm_gbps,
                                                  overlap=cal.overlap, speedup=cal.shard_speedup,
                                                  allreduce={k: [c.lat_ms, c.gbps] for k, c
                                                             in cal.allreduce.items()}),
                       memoized=again is cal, shared=shared), f)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def live(tmp_path_factory):
    work = tmp_path_factory.mktemp("calibration_ranks")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), "2", str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    return [json.loads((work / f"rank{r}.json").read_text()) for r in range(2)]


def test_live_calibration_over_two_ranks(live):
    first = live[0]
    assert all(r["cal"] == first["cal"] and r["raw"] == first["raw"] for r in live)
    raw = first["raw"]
    assert first["cal"]["num_devices"] == 2 and first["cal"]["backend"] == "cpu/gloo"
    assert list(raw["allreduce"]) == ["2"]
    for v in [raw["peak"], raw["hbm"], *raw["allreduce"]["2"]]:
        assert np.isfinite(v) and v >= 0
    assert raw["allreduce"]["2"][1] > 0 and raw["peak"] > 0 and raw["hbm"] > 0
    assert 0.0 <= raw["overlap"] <= 1.0
    assert 1.0 <= raw["speedup"] <= 2.0
    assert all(r["memoized"] for r in live)
    # two CPU ranks on one host share its device: an emulated mesh
    assert all(r["shared"] for r in live)
