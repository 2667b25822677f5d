"""The plan audit of the port (flexflow_tpu_torch/observability/
plan_audit.py, FFConfig.plan_audit) against the JAX package's, on the CPU:

- the summary math (geometric means, ratios, the worst ops) is the JAX
  module's on the same numbers;
- a searched compile with plan_audit=True and a forced tensor-parallel
  seed on 2 gloo ranks records, on both ranks, rank 0's audit: the JAX
  audit's rows (the same ops and movement edges, names, kinds and bytes)
  and the same predicted_ms on the analytic estimator (within 1e-9), every
  op measured and every movement edge timed as its reshard over the ranks;
- a compile that ran no search says so and records nothing; an imported
  plan records why it was not audited."""

import inspect
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from flexflow_tpu import core as jcore
from flexflow_tpu.observability import plan_audit as jpa
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.observability import plan_audit as tpa

REPO = Path(__file__).resolve().parent.parent
CFG = dict(batch_size=64, print_freq=0, max_devices=2, search_budget=2, plan_audit=True,
           force_strategy_seed="dp1xtp2xsp1")


def _build(pkg, cfg: dict, device=None):
    m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
    x = m.create_tensor([cfg["batch_size"], 256], name="x")
    t = m.relu(m.dense(x, 2048, use_bias=False, name="fc1"))
    m.dense(t, 16, use_bias=False, name="out")
    m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
    return m


WORKER = textwrap.dedent(
    """
    import json, os, sys
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "build.py")).read())
    m = _build(core, json.load(open(os.path.join(work, "cfg.json"))), device="cpu")
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(m.search_provenance, f)
    dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def audits(tmp_path_factory):
    work = tmp_path_factory.mktemp("plan_audit")
    want = _build(jcore, CFG).search_provenance["plan_audit"]
    (work / "cfg.json").write_text(json.dumps(CFG))
    (work / "build.py").write_text(inspect.getsource(_build))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    got = [json.loads((work / f"rank{r}.json").read_text())["plan_audit"] for r in range(2)]
    return want, got


def test_the_audit_has_the_jax_audits_rows_and_predictions(audits):
    want, (got, other) = audits
    assert got == other  # rank 0's audit, recorded on every rank
    assert "error" not in got, got
    for key in ("schema", "num_ops", "num_movement_edges", "movement_measured",
                "emulation_scale"):
        assert got[key] == want[key], key
    assert got["num_movement_edges"] > 0 and got["movement_measured"] is True
    for g, w in zip(got["ops"], want["ops"]):
        assert (g["name"], g["op_type"]) == (w["name"], w["op_type"])
        assert g["predicted_ms"] == pytest.approx(w["predicted_ms"], rel=1e-9)
        assert g["measured_ms"] is not None and g["measured_ms"] > 0
    for g, w in zip(got["movement_edges"], want["movement_edges"]):
        assert (g["name"], g["kind"], g["bytes"]) == (w["name"], w["kind"], w["bytes"])
        assert g["predicted_ms"] == pytest.approx(w["predicted_ms"], rel=1e-9)
        assert g["measured_ms"] is not None and g["measured_ms"] > 0
    s = got["summary"]
    assert s["num_ops_measured"] == got["num_ops"]
    # every edge the model charges is timed (the JAX audit leaves the
    # Reduction's partial-sum reshard, which it cannot express as a
    # sharded identity, unmeasured)
    assert s["num_edges_measured"] == sum(1 for e in got["movement_edges"] if e["predicted_ms"])
    assert set(s) == set(want["summary"])


def test_the_summary_math_is_the_jax_modules():
    ratios = [0.5, 2.0, None, 4.0, float("inf"), -1.0, 1.0]
    assert tpa._geomean(ratios) == jpa._geomean(ratios)
    for m, p in ((1.0, 2.0), (None, 1.0), (1.0, 0.0), (3.0, float("nan")), (2.0, 0.5)):
        assert tpa._ratio(m, p) == jpa._ratio(m, p)
    audit = {"ops": [{"op_type": "LinearAttrs", "ratio": 2.0},
                     {"op_type": "LinearAttrs", "ratio": 0.5},
                     {"op_type": "ElementUnaryAttrs", "ratio": None}]}
    assert tpa.audit_by_class(audit) == {
        "ElementUnaryAttrs": {"geomean_ratio": None, "ops": 0},
        "LinearAttrs": {"geomean_ratio": 1.0, "ops": 2}}


def test_a_compile_without_a_search_records_no_audit(capsys):
    m = _build(tcore, dict(batch_size=64, print_freq=0, plan_audit=True), device="cpu")
    assert m.search_provenance is None
    assert "plan_audit: this compile ran no Unity search" in capsys.readouterr().out
