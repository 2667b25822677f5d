"""The port's communication verification (flexflow_tpu_torch/analysis/
comm_analysis.py, COMM001-COMM004) on gloo ranks: the dp2 and tp2 plans of
the small flagship on 2 ranks and dp2 x tp2 on 4, one recorded step each
(analysis/step_program.py, the census of parallel/census.py), cross-checked
against the movement predictions the plan exports.

- The predictions are the JAX package's (movement_export on the same
  PCG: node, kind, degree, bytes, predicted bytes, templates, exemptions;
  the ms differ by estimator and are not compared).
- The census matches with no COMM001 or COMM002 and no host transfer
  (COMM004), every collective above the bytes floor attributed to a PCG
  node.
- Where the port lowers an edge GSPMD elides: the trailing class-dim
  Combine of the tp plans' logits. The port's loss consumes the combined
  logits, so its all-gather runs and is matched against the edge's
  prediction; the JAX pass exempts the edge as bypassed (GSPMD serves the
  loss from the sharded operand). The port's exemption set is therefore the
  JAX one less that Combine.
- A gradient bucket is one all-reduce of several gradients; the census
  counts it once, as the step issues it (its all-reduces are the step's
  `dist.all_reduce` calls), with each gradient's node and bytes, and the
  matcher takes each gradient as a piece of its own, as GSPMD emits them.

Rank jobs run once a module, each rank joined within 120 s."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import bench
from flexflow_tpu.analysis.comm_analysis import trailing_reshard_nodes as j_trailing
from flexflow_tpu.compiler import AnalyticTPUCostEstimator
from flexflow_tpu.compiler.machine_mapping.movement_export import (
    export_movement_predictions as j_export,
)
from flexflow_tpu.compiler.unity_algorithm import data_parallel_seed as j_dp
from flexflow_tpu.compiler.unity_algorithm import tensor_parallel_seed as j_tp
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, tensor_parallel_seed
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.runtime.strategy import save_strategy

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(batch=8, seq=128, embed=256, heads=4, layers=2, vocab=512)
PLANS = {"dp2": 2, "tp2": 2, "dp2xtp2": 4}

WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.analysis.comm_analysis import (comm_summary_json,
                                                           trailing_reshard_nodes, verify_comm)
    from flexflow_tpu_torch.analysis.step_program import record_plan
    from flexflow_tpu_torch.parallel import census, init_file_group
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.runtime.strategy import load_strategy

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, f"store{world}"), rank, world, device="cpu",
                    timeout_s=120)
    issued = [0]
    all_reduce = dist.all_reduce

    def counted(*a, **k):  # the all-reduces the recorded step issues
        issued[0] += census._LOG is not None
        return all_reduce(*a, **k)

    dist.all_reduce = counted
    for plan in json.load(open(os.path.join(work, f"plans{world}.json"))):
        issued[0] = 0
        pcg, mapping, _ = load_strategy(os.path.join(work, plan + ".json"))
        spec = MachineSpecification(1, 1, world, 25.0, 400.0)
        prog = record_plan(pcg, mapping, machine_spec=spec, device="cpu")
        analysis, diags = verify_comm(pcg, mapping, machine_spec=spec, lowered=prog)
        if rank == 0:
            out = dict(summary=comm_summary_json(analysis),
                       diags=[d.to_json() for d in diags],
                       census=prog.collectives, host=prog.host_transfers,
                       all_reduces_issued=issued[0],
                       bypassed=sorted(trailing_reshard_nodes(pcg)))
            json.dump(out, open(os.path.join(work, plan + "_out.json"), "w"))
    dist.destroy_process_group()
    """
)


def _plans(pkg_build, dp, tp, name):
    p = pkg_build(**SMALL)
    if "tp2" in name:
        p = tp(p, 2)
    if "dp2" in name:
        p = dp(p, 2)
    return p


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("comm_ranks")
    for name in PLANS:
        save_strategy(str(work / f"{name}.json"),
                      _plans(build_flagship_pcg, data_parallel_seed, tensor_parallel_seed, name),
                      None)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = []
    for world in (2, 4):
        (work / f"plans{world}.json").write_text(
            json.dumps([p for p, n in PLANS.items() if n == world]))
        procs += [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(work)],
                                   cwd=REPO, env=env, stdout=subprocess.PIPE,
                                   stderr=subprocess.PIPE, text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    return {name: json.loads((work / f"{name}_out.json").read_text()) for name in PLANS}


def _jax_predictions(name):
    pcg = _plans(bench.build_flagship_pcg, j_dp, j_tp, name)
    spec = JSpec(1, 1, PLANS[name], 25.0, 400.0)
    preds = j_export(pcg, None, estimator=AnalyticTPUCostEstimator(spec), machine_spec=spec)
    return preds, j_trailing(pcg)


_FIELDS = ("node", "name", "kind", "degree", "bytes", "predicted_bytes", "weight_resident",
           "input_chain", "fused_kind", "link_class")


@pytest.mark.parametrize("name", sorted(PLANS))
def test_predictions_are_the_jax_packages(runs, name):
    want, _ = _jax_predictions(name)
    got = runs[name]["summary"]["edges"]
    assert [{k: e[k] for k in _FIELDS if k != "link_class"} for e in got] == \
        [{k: p.to_json()[k] for k in _FIELDS if k != "link_class"} for p in want]


@pytest.mark.parametrize("name", sorted(PLANS))
def test_census_matches_with_no_comm001_comm002_or_comm004(runs, name):
    out = runs[name]
    assert [d["rule_id"] for d in out["diags"]] == []
    assert out["summary"]["unmatched_collectives"] == 0 and out["host"] == []
    # each collective above the bytes floor names its node (below it: the
    # loss and metric sums, a reduction of no PCG node)
    assert out["census"] and all(
        c["node"] is not None if "parts" not in c else all(n is not None for n, _ in c["parts"])
        for c in out["census"] if c["bytes"] >= out["summary"]["bytes_floor"])
    assert out["summary"]["bytes_geomean"] is not None


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_census_counts_a_bucket_as_the_one_all_reduce_it_is(runs, name):
    out = runs[name]
    summary = out["summary"]
    assert summary["census"]["all-reduce"]["count"] == out["all_reduces_issued"] > 0
    buckets = [c for c in out["census"] if "parts" in c]
    # the gradient buckets of the data-parallel axis (tp2 replicates no weight)
    assert summary["buckets"] == len(buckets) and bool(buckets) == ("dp2" in name)
    assert summary["bucket_members"] == sum(len(c["parts"]) for c in buckets) >= len(buckets)
    assert summary["bucket_members"] > len(buckets) or not buckets
    assert all(c["bytes"] == sum(b for _, b in c["parts"]) for c in buckets)


@pytest.mark.parametrize("name", sorted(PLANS))
def test_the_exempt_edges_are_the_jax_ones_less_the_executed_class_combine(runs, name):
    _, jax_bypassed = _jax_predictions(name)
    got = set(runs[name]["bypassed"])
    assert got <= set(jax_bypassed)
    for node in set(jax_bypassed) - got:
        edge = next(e for e in runs[name]["summary"]["edges"] if e["node"] == node)
        assert edge["kind"] == "CombineAttrs" and edge["matched_bytes"] > 0
    assert ("tp2" in name) == bool(set(jax_bypassed) - got)
