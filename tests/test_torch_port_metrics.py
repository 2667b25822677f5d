"""The run-health metrics of the port (flexflow_tpu_torch/observability/
metrics.py) against the JAX package's (flexflow_tpu/observability/
metrics.py), on the CPU, the counterpart of tests/test_run_health.py's
TestMetricsRegistry, TestStepStatistics and TestEventSchema:

- step_statistics on the same numpy trees gives the JAX values (rtol 1e-6),
  and trips `ok` on a NaN loss, a NaN gradient and an overflowing update;
- finalize_step's guard keeps the pre-step parameters and optimizer state
  (the step count too) where the step went non-finite, and commits the
  update bitwise where it did not;
- the event schema is the JAX package's, frozen: either package's reader
  reads the other's `events.jsonl` (step events, run events, the torn-line
  tail), and the provenance snapshot reads across;
- the registry's counters, gauges and histogram summaries match."""

import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.observability import metrics as jm
from flexflow_tpu_torch.observability import metrics as tm


def _tree(seed, shapes=((4, 3), (7,), (2, 5, 3))):
    rs = np.random.RandomState(seed)
    return {f"n{i}": rs.randn(*s).astype(np.float32) for i, s in enumerate(shapes)}


def _stats_pair(old, new, grads, loss):
    j = jm.step_statistics({k: jnp.asarray(v) for k, v in old.items()},
                           {k: jnp.asarray(v) for k, v in new.items()},
                           {k: jnp.asarray(v) for k, v in grads.items()}, jnp.float32(loss))
    t = tm.step_statistics({k: torch.from_numpy(v) for k, v in old.items()},
                           {k: torch.from_numpy(v) for k, v in new.items()},
                           {k: torch.from_numpy(v) for k, v in grads.items()},
                           torch.tensor(loss, dtype=torch.float32))
    return j, t


def test_step_statistics_are_the_jax_packages():
    old, grads = _tree(0), _tree(1)
    new = {k: v - 0.01 * grads[k] for k, v in old.items()}
    j, t = _stats_pair(old, new, grads, 2.5)
    assert set(t) == set(j) == {"grad_norm", "param_norm", "update_ratio", "ok"}
    for k in ("grad_norm", "param_norm", "update_ratio"):
        np.testing.assert_allclose(float(t[k]), float(j[k]), rtol=1e-6, err_msg=k)
        assert t[k].dtype == torch.float32 and t[k].dim() == 0
    assert bool(t["ok"]) and bool(j["ok"])
    tree = {k: torch.from_numpy(v) for k, v in old.items()}
    np.testing.assert_allclose(float(tm.global_norm(tree)),
                               float(jm.global_norm({k: jnp.asarray(v) for k, v in old.items()})),
                               rtol=1e-6)


@pytest.mark.parametrize("case", ["nan_loss", "nan_grad", "overflowing_update"])
def test_the_ok_flag_trips_as_the_jax_packages(case):
    old, grads = _tree(0), _tree(1)
    new = dict(old)
    loss = 1.0
    if case == "nan_loss":
        loss = float("nan")
    elif case == "nan_grad":
        grads = dict(grads, n1=np.full_like(grads["n1"], np.nan))
    else:  # finite loss and gradients, an update that overflowed
        new = dict(old, n0=np.full_like(old["n0"], np.inf))
    j, t = _stats_pair(old, new, grads, loss)
    assert not bool(t["ok"]) and not bool(j["ok"])


@pytest.mark.parametrize("ok", [True, False])
def test_the_guard_keeps_the_pre_step_state_where_the_step_went_nonfinite(ok):
    rs = np.random.RandomState(3)
    params = {"n1": torch.from_numpy(rs.randn(6, 4).astype(np.float32))}
    opt = {"m": {"n1": torch.zeros(6, 4)}, "step": torch.zeros((), dtype=torch.int32)}
    grads = {"n1": torch.from_numpy(rs.randn(6, 4).astype(np.float32))}
    if not ok:
        grads["n1"][0, 0] = float("nan")
    before = {k: v.clone() for k, v in params.items()}

    def update():
        opt["step"].add_(1)
        opt["m"]["n1"].mul_(0.9).add_(grads["n1"])
        params["n1"].sub_(0.1 * opt["m"]["n1"])

    stats = tm.finalize_step(False, True, params, opt, grads, torch.tensor(1.0), update)
    assert bool(stats["ok"]) == ok
    want = before["n1"] - 0.1 * grads["n1"]
    if ok:
        assert torch.equal(params["n1"], want) and int(opt["step"]) == 1
    else:
        assert torch.equal(params["n1"], before["n1"]) and int(opt["step"]) == 0
        assert torch.equal(opt["m"]["n1"], torch.zeros(6, 4))


def test_a_fused_windows_stacks_split_and_read_back_in_one_transfer():
    per_step = [{"ok": torch.tensor(i != 1), "grad_norm": torch.tensor(float(i))}
                for i in range(3)]
    stacks = tm.stack_stats(per_step)
    host = tm.stats_to_host(stacks)
    assert host["ok"].dtype == bool and host["ok"].tolist() == [True, False, True]
    split = tm.split_window_stats(host, 3)
    assert [float(s["grad_norm"]) for s in split] == [0.0, 1.0, 2.0]
    assert tm.split_window_stats(None, 2) == jm.split_window_stats(None, 2) == [None, None]


def test_the_event_schema_is_the_jax_packages():
    assert tm.EVENT_SCHEMA_VERSION == jm.EVENT_SCHEMA_VERSION == 1
    assert tm.STEP_EVENT_FIELDS == jm.STEP_EVENT_FIELDS


def _emit(log, n=3):
    for i in range(n):
        log.emit(step=i + 1, loss=float("nan") if i == 1 else 1.0 / (i + 1),
                 wallclock_ms=10.0 + i, tokens_per_s=100.0, grad_norm=0.5, param_norm=2.0,
                 update_ratio=1e-3, skipped=i == 1, nonfinite=i == 1)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_either_packages_reader_reads_the_others_stream(tmp_path, writer):
    w, r = (tm, jm) if writer == "port" else (jm, tm)
    d = str(tmp_path)
    log = w.StepEventLog(d)
    _emit(log)
    w.append_run_event(d, "checkpoint_fallback", quarantined=[8])
    log.close()
    events = r.read_events(d)
    assert events == w.read_events(d)
    assert [e["step"] for e in events if "step" in e] == [1, 2, 3]
    assert events[1]["loss"] == "nan" and events[1]["skipped"] is True
    assert tuple(events[0]) == jm.STEP_EVENT_FIELDS
    assert r.read_run_events(d, "checkpoint_fallback") == [
        {"schema": 1, "event": "checkpoint_fallback", "quarantined": [8]}]
    snap = json.loads((tmp_path / "metrics.json").read_text())
    assert snap["counters"] == {"steps_total": 3, "steps_skipped": 1, "nonfinite_steps": 1}
    # the incremental tail: a torn last line stays for the next call
    with open(tmp_path / "events.jsonl", "a") as f:
        f.write('{"schema": 1, "step": 4')
    got, cursor = r.tail_events(d, 0)
    want, want_cursor = w.tail_events(d, 0)
    assert got == want and cursor == want_cursor and len(got) == 4
    with open(tmp_path / "events.jsonl", "a") as f:
        f.write("}\n")
    assert r.tail_events(d, cursor)[0] == [{"schema": 1, "step": 4}]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_the_provenance_snapshot_reads_across(tmp_path, writer):
    w, r = (tm, jm) if writer == "port" else (jm, tm)
    doc = {"estimated_ms": 1.5, "bad": float("inf"), "nested": {"k": (1, 2)}, "obj": object}
    w.write_provenance(str(tmp_path), doc)
    assert r.read_provenance(str(tmp_path)) == jm.read_provenance(str(tmp_path))
    assert r.read_provenance(str(tmp_path))["bad"] == "inf"
    assert r.read_provenance(str(tmp_path / "missing")) is None


def test_the_registry_is_the_jax_packages():
    rt, rj = tm.MetricsRegistry(), jm.MetricsRegistry()
    for reg in (rt, rj):
        reg.counter("steps").inc(3)
        reg.gauge("loss").set(0.25)
        for v in (5.0, 1.0, 3.0, 2.0):
            reg.histogram("ms").observe(v)
    assert rt.snapshot() == rj.snapshot()
    for q in (0, 25, 50, 95, 100):
        assert tm.nearest_rank_percentile([1, 2, 3, 4], q) == jm.nearest_rank_percentile(
            [1, 2, 3, 4], q)
    h = tm.Histogram(reservoir=4)
    for v in range(100):
        h.observe(v)
    assert h.count == 100 and len(h._samples) == 4 and h.min == 0 and h.max == 99
    assert math.isclose(h.summary()["mean"], 49.5)
