"""The span trace of the port's fit (flexflow_tpu_torch/observability/
trace.py, FFConfig.profile_trace_dir) against the JAX package's, on the
CPU: the same fit writes `flexflow_trace.json` in both packages with the
same span names, counts and nesting (step > dispatch / device_sync;
host_to_device on the input pipeline's thread under fused windows;
checkpoint spans of the sync writer), per step and in windows of 4.
Times are not compared. The port also writes its torch.profiler trace
beside it, and the recorder's Chrome-trace layout is the JAX package's."""

import collections
import json
import os

import numpy as np
import pytest

from flexflow_tpu import core as jcore
from flexflow_tpu.observability import trace as jtrace
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.observability import trace as ttrace

BATCH, STEPS = 16, 8


def _fit(pkg, tmp, k):
    kw = {"device": "cpu"} if pkg is tcore else {}
    m = pkg.FFModel(pkg.FFConfig(
        batch_size=BATCH, seed=0, steps_per_dispatch=k, print_freq=0,
        profile_trace_dir=str(tmp / "trace"), checkpoint_dir=str(tmp / "ckpt"),
        checkpoint_every_n_steps=4, checkpoint_sync=True,
        **(dict(checkpoint_backend="npz") if pkg is jcore else {})), **kw)
    x = m.create_tensor([BATCH, 32], name="x")
    m.dense(m.relu(m.dense(x, 32, name="fc1")), 10, name="head")
    m.compile(pkg.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy")
    rs = np.random.RandomState(0)
    m.fit(rs.randn(BATCH * STEPS, 32).astype(np.float32), rs.randint(0, 10, BATCH * STEPS),
          epochs=1, shuffle=False, verbose=False)
    with open(tmp / "trace" / "flexflow_trace.json") as f:
        return json.load(f)["traceEvents"], sorted(os.listdir(tmp / "trace"))


def _shape(events):
    """(name counts, the parent name of each span by (name, parent)), from
    the nesting of the X events per thread."""
    spans = [e for e in events if e["ph"] == "X"]
    names = collections.Counter(e["name"] for e in spans)
    nested = collections.Counter()
    for e in spans:
        parents = [p for p in spans if p is not e and p["tid"] == e["tid"]
                   and p["ts"] <= e["ts"] and e["ts"] + e["dur"] <= p["ts"] + p["dur"]
                   and p["name"] != e["name"]]
        parent = max(parents, key=lambda p: p["ts"])["name"] if parents else None
        nested[(e["name"], parent)] += 1
    return names, nested


@pytest.mark.parametrize("k", [1, 4])
def test_a_fits_spans_are_the_jax_packages(tmp_path, k):
    jevents, _ = _fit(jcore, tmp_path / "jax", k)
    tevents, files = _fit(tcore, tmp_path / "port", k)
    assert _shape(tevents) == _shape(jevents)
    names, nested = _shape(tevents)
    assert names["step"] == STEPS // k and names["checkpoint"] == 2
    assert nested[("dispatch", "step")] == nested[("device_sync", "step")] == STEPS // k
    assert names["host_to_device"] == (2 if k == 4 else 0)
    steps = [e for e in tevents if e["name"] == "step"]
    assert all(e["args"].get("fused_steps") == (k if k > 1 else None) for e in steps)
    assert all(e["args"]["backend"] == "ModelTrainingInstance" for e in steps)
    assert files == ["flexflow_trace.json", "torch_trace.json"]


def test_the_recorder_exports_the_jax_layout():
    got, want = ttrace.TraceRecorder(), jtrace.TraceRecorder()
    for rec, mod in ((got, ttrace), (want, jtrace)):
        prev = mod.set_recorder(rec)
        try:
            with mod.record_span("step", backend="b"):
                with mod.record_span("dispatch"):
                    rec.instant("mark", n=1)
        finally:
            mod.set_recorder(prev)
    strip = lambda d: [{k: v for k, v in e.items() if k not in ("ts", "dur", "pid", "tid")}  # noqa
                       for e in d["traceEvents"]]
    assert strip(got.to_chrome_trace()) == strip(want.to_chrome_trace())
    assert [s.depth for s in got.spans] == [s.depth for s in want.spans] == [0, 1]
    assert got.children_of(got.spans[0]) == [got.spans[1]]
    with ttrace.record_span("nothing") as r:  # no recorder: a null context
        assert r is None and ttrace.active_recorder() is None
