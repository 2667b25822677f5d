"""The drift monitor of the port (flexflow_tpu_torch/observability/drift.py)
against the JAX package's, on the CPU, the counterpart of
tests/test_drift.py's TestWindowAggregator, TestDriftDetector and
TestDriftMonitor:

- the same event lists give the same windows, the same triggers and the
  same advisories (the arithmetic fallback: no repricer, no transition
  verifier), and the same `drift` events in events.jsonl, which either
  package reads;
- the monitor's thread tails a live file, drains it on close, and posts a
  crash to the fault channel."""

import json
import time

import pytest

from flexflow_tpu.observability import drift as jd
from flexflow_tpu.observability.metrics import read_run_events as jax_read_run_events
from flexflow_tpu_torch.observability import drift as td
from flexflow_tpu_torch.observability.metrics import read_run_events
from flexflow_tpu_torch.runtime.supervisor import FaultChannel

SLOW = [90.0] * 2 + [12.0] * 4 + [40.0] * 8  # warm-up, baseline, drift
SPEEDUP = [90.0] * 2 + [40.0] * 4 + [12.0] * 8
GROWTH = [90.0] * 2 + [12.0] * 4 + [40.0] * 8
HEALTHY = [90.0] * 2 + [12.0] * 12
STREAMS = {"slowdown": (SLOW, None), "speedup": (SPEEDUP, None), "growth": (GROWTH, "grow"),
           "healthy": (HEALTHY, None)}


def _events(mss, tokens=None):
    out = []
    for j, ms in enumerate(mss):
        e = {"schema": 1, "step": j + 1, "wallclock_ms": ms}
        if tokens == "grow":
            # the work per step grows with its wall-clock: batch growth
            e["tokens_per_s"] = (1000.0 if ms < 20 else 4000.0) / ms * 1000.0
        out.append(e)
    return out


def _monitor(mod, mdir, **kw):
    kw = dict(dict(window_steps=2, run_length=2, warmup_windows=1, baseline_windows=2,
                   cooldown_windows=3, seed_runtimes={"dp_only": 8.0, "tp_heavy": 30.0}), **kw)
    return mod.DriftMonitor(mdir, 10.0, **kw)


def test_the_drift_schema_is_the_jax_packages():
    assert td.DRIFT_SCHEMA_VERSION == jd.DRIFT_SCHEMA_VERSION
    assert td.DRIFT_EVENT_FIELDS == jd.DRIFT_EVENT_FIELDS


@pytest.mark.parametrize("stream", sorted(STREAMS))
def test_the_same_events_give_the_jax_packages_advisories(tmp_path, stream):
    mss, tokens = STREAMS[stream]
    events = _events(mss, tokens)
    for d in ("jax", "port"):
        (tmp_path / d).mkdir()
        (tmp_path / d / "events.jsonl").touch()
    want = _monitor(jd, str(tmp_path / "jax"))
    got = _monitor(td, str(tmp_path / "port"))
    assert [a.to_dict() for a in got.feed(events)] == [a.to_dict() for a in want.feed(events)]
    assert got.report() == want.report()
    if stream != "healthy":
        assert got.advisories and got.advisories[0].cause == want.advisories[0].cause
    assert read_run_events(str(tmp_path / "port"), "drift") == jax_read_run_events(
        str(tmp_path / "jax"), "drift")


def test_windows_and_triggers_are_the_jax_packages():
    for mss in (SLOW, SPEEDUP, HEALTHY):
        ja, ta = jd.WindowAggregator(2), td.WindowAggregator(2)
        jdet = jd.DriftDetector(10.0, run_length=2, cooldown_windows=3)
        tdet = td.DriftDetector(10.0, run_length=2, cooldown_windows=3)
        for e in _events(mss) + [{"schema": 1, "event": "hang"}]:
            jw, tw = ja.add(e), ta.add(e)
            assert (tw is None) == (jw is None)
            if tw is not None:
                assert vars(tw) == vars(jw)
                jt, tt = jdet.observe(jw), tdet.observe(tw)
                assert (tt is None) == (jt is None)
                if tt is not None:
                    assert (tt.cause, tt.ratio, tt.drift, tt.trajectory) == (
                        jt.cause, jt.ratio, jt.drift, jt.trajectory)


def _append(path, events):
    with open(path / "events.jsonl", "a") as f:
        f.write("".join(json.dumps(e) + "\n" for e in events))


def test_the_thread_tails_a_live_file_and_close_drains_it(tmp_path):
    mon = _monitor(td, str(tmp_path), poll_interval_s=0.01).start()
    events = _events(SLOW)
    _append(tmp_path, events[:6])
    deadline = time.time() + 5.0
    while mon.aggregator.windows_completed < 3 and time.time() < deadline:
        time.sleep(0.01)
    assert mon.aggregator.windows_completed == 3 and not mon.advisories
    _append(tmp_path, events[6:])
    mon.close()
    assert len(mon.advisories) == 1 and mon.advisories[0].cause == "slowdown"
    (event,) = read_run_events(str(tmp_path), "drift")
    assert tuple(event) == td.DRIFT_EVENT_FIELDS and event["cause"] == "slowdown"


def test_a_crashed_thread_posts_to_the_fault_channel(tmp_path):
    chan = FaultChannel()
    mon = _monitor(td, str(tmp_path), channel=chan, poll_interval_s=0.01)

    def boom():
        raise RuntimeError("monitor died")

    mon.poll_once = boom
    mon.start()
    deadline = time.time() + 5.0
    while not chan.history and time.time() < deadline:
        time.sleep(0.01)
    mon._stop.set()
    mon._thread.join(timeout=5.0)
    assert chan.history and chan.history[0][0] == td.DriftMonitor.SITE
