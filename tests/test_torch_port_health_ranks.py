"""The step statistics and the health policy over ranks: the port's
FFModel on 2 gloo processes over a `file://` store against the JAX FFModel
compiled for 2 virtual CPU devices (whose GSPMD norms are global by
construction), the same initial parameters and batches, half of step 2's
batch poisoned with NaN (rank 1's rows), skip_step:

- data parallel (only_data_parallel) and the searched tensor-parallel plan
  of tests/test_torch_port_ffmodel_ranks.py: rank 0's event stream equals
  the JAX stream within 1e-5 (loss, gradient and parameter global norms,
  update ratio) with the same flags; the norms are global, so both ranks
  trip on step 2 although only rank 1's rows hold the NaN, and both skip;
- rank 0 alone writes the stream; the final parameters are the JAX ones
  within 1e-5 on both ranks;
- the localizer over ranks: under skip_step and under raise, every rank's
  monitor names the first bad op the JAX run names, and under raise every
  rank's NonFiniteError names it at the JAX run's step (rank 0 replays the
  whole batch gathered from the ranks, and a searched plan's PCG on its
  gathered parameters)."""

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
from flexflow_tpu.observability import health as jh
from flexflow_tpu.observability.metrics import read_events

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
TOL = 1e-5
CASES = {
    "dp": dict(cfg=dict(batch_size=16, print_freq=0, max_devices=2, only_data_parallel=True),
               searched=False, samples=(64, 32, 4)),
    "tp": dict(cfg=dict(batch_size=64, print_freq=0, max_devices=2, search_budget=2),
               searched=True, samples=(256, 256, 16)),
}


def _build(pkg, cfg: dict, searched: bool, device=None):
    m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
    if searched:
        x = m.create_tensor([cfg["batch_size"], 256], name="x")
        t = m.relu(m.dense(x, 2048, use_bias=False, name="fc1"))
        m.dense(t, 16, use_bias=False, name="out")
    else:
        x = m.create_tensor([16, 32], name="x")
        t = m.relu(m.dense(x, 16, name="fc1"))
        m.dense(t, 4, name="out")
    m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
    return m


WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "build.py")).read())
    for name, case in json.load(open(os.path.join(work, "cases.json"))).items():
        data = np.load(os.path.join(work, f"{name}.npz"))
        cfg = dict(case["cfg"], metrics_dir=os.path.join(work, f"port_{name}"),
                   health_policy="skip_step")
        m = _build(core, cfg, case["searched"], device="cpu")
        ffmodel_state_from_numpy(m, {k: data[k] for k in data.files if k.startswith("n")})
        m.fit(x=data["xs"], y=data["ys"], epochs=1, shuffle=False, verbose=False)
        names = [m.cg.layer_attrs(n).name for n in m.cg.topological_ordering()
                 if m.cg.layer_attrs(n).name and ".weight" in m.cg.layer_attrs(n).name]
        params = {n: m.get_parameter_by_name(n).get_weights(m) for n in names}
        np.savez(os.path.join(work, f"{name}_rank{rank}.npz"), kind=type(m.instance).__name__,
                 health=json.dumps(m.health_monitor.summary()),
                 stats=json.dumps({k: float(v) for k, v in m.instance.last_step_stats.items()}),
                 **params)
        cfg = dict(case["cfg"], health_policy="raise")
        m = _build(core, cfg, case["searched"], device="cpu")
        ffmodel_state_from_numpy(m, {k: data[k] for k in data.files if k.startswith("n")})
        try:
            m.fit(x=data["xs"], y=data["ys"], epochs=1, shuffle=False, verbose=False)
            err = None
        except Exception as e:
            err = dict(type=type(e).__name__, op=getattr(getattr(e, "report", None), "op_name", None),
                       phase=getattr(getattr(e, "report", None), "phase", None), msg=str(e))
        json.dump(dict(err=err, steps=m._step_count, health=m.health_monitor.summary()),
                  open(os.path.join(work, f"{name}_raise_rank{rank}.json"), "w"))
    dist.destroy_process_group()
    """
)


def _poisoned(n, f, classes, batch):
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(n, f).astype(np.float32), rs.randint(0, classes, n)
    xs[batch + batch // 2:2 * batch] = np.nan  # step 2, rank 1's rows
    return xs, ys


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    work = tmp_path_factory.mktemp("health_ranks")
    jax_runs = {}
    for name, case in CASES.items():
        cfg = dict(case["cfg"], metrics_dir=str(work / f"jax_{name}"), health_policy="skip_step")
        m = _build(jcore, cfg, case["searched"])
        init = {k: np.array(v) for k, v in m.params.items()}
        xs, ys = _poisoned(*case["samples"], case["cfg"]["batch_size"])
        m.fit(x=xs, y=ys, epochs=1, shuffle=False, verbose=False)
        g = getattr(m.instance, "pcg", m.cg)
        weights = {g.layer_attrs(n).name: np.asarray(m.params[f"n{n.idx}"])
                   for n in g.topological_ordering()
                   if g.layer_attrs(n).name and ".weight" in g.layer_attrs(n).name}
        np.savez(work / f"{name}.npz", xs=xs, ys=ys, **init)
        jax_runs[name] = dict(events=read_events(str(work / f"jax_{name}")), weights=weights,
                              health=m.health_monitor.summary())
        m = _build(jcore, dict(case["cfg"], health_policy="raise"), case["searched"])
        assert all(np.array_equal(np.array(v), init[k]) for k, v in m.params.items())
        try:
            m.fit(x=xs, y=ys, epochs=1, shuffle=False, verbose=False)
            err = None
        except jh.NonFiniteError as e:
            err = dict(op=e.report.op_name, phase=e.report.phase, msg=str(e))
        jax_runs[name]["raise"] = dict(err=err, steps=m._step_count,
                                       health=m.health_monitor.summary())
    (work / "cases.json").write_text(json.dumps(CASES))
    (work / "build.py").write_text(inspect.getsource(_build))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    port = {}
    for name in CASES:
        ranks = []
        for r in range(RANKS):
            z = dict(np.load(work / f"{name}_rank{r}.npz"))
            ranks.append(dict(kind=str(z.pop("kind")), health=json.loads(str(z.pop("health"))),
                              stats=json.loads(str(z.pop("stats"))), weights=z))
        port[name] = dict(ranks=ranks, events=read_events(str(work / f"port_{name}")),
                          raise_=[json.loads((work / f"{name}_raise_rank{r}.json").read_text())
                                  for r in range(RANKS)])
    return dict(jax=jax_runs, port=port)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rank_zeros_stream_is_the_jax_stream(runs, name):
    want, got = runs["jax"][name]["events"], runs["port"][name]["events"]
    steps = CASES[name]["samples"][0] // CASES[name]["cfg"]["batch_size"]
    assert [e["step"] for e in got] == [e["step"] for e in want] == list(range(1, steps + 1))
    for w, g in zip(want, got):
        assert (g["skipped"], g["nonfinite"]) == (w["skipped"], w["nonfinite"]) == (
            g["step"] == 2, g["step"] == 2)
        for key in ("loss", "grad_norm", "param_norm", "update_ratio"):
            np.testing.assert_allclose(float(g[key]), float(w[key]), rtol=TOL,
                                       err_msg=f"{name} step {g['step']} {key}")


@pytest.mark.parametrize("name", sorted(CASES))
def test_every_rank_skips_the_step_and_ends_at_the_jax_parameters(runs, name):
    kinds = {"dp": "DataParallelTrainingInstance", "tp": "DistributedTrainingInstance"}
    ranks = runs["port"][name]["ranks"]
    assert ranks[0]["stats"] == ranks[1]["stats"]  # global norms: one value on every rank
    for r in ranks:
        assert r["kind"] == kinds[name]
        assert r["health"]["skipped_steps"] == r["health"]["nonfinite_steps"] == 1
        assert r["health"]["skipped_steps"] == runs["jax"][name]["health"]["skipped_steps"]
        for key, w in runs["jax"][name]["weights"].items():
            assert np.all(np.isfinite(r["weights"][key]))
            assert np.linalg.norm(r["weights"][key] - w) <= TOL * np.linalg.norm(w), key


@pytest.mark.parametrize("name", sorted(CASES))
def test_skip_step_names_the_jax_first_bad_op_on_every_rank(runs, name):
    want = runs["jax"][name]["health"]["first_bad_op"]
    assert want is not None
    for r in runs["port"][name]["ranks"]:
        assert r["health"]["first_bad_op"] == want


@pytest.mark.parametrize("name", sorted(CASES))
def test_raise_names_the_jax_op_and_step_on_every_rank(runs, name):
    want = runs["jax"][name]["raise"]
    assert want["err"] is not None and want["steps"] == 2
    for r in runs["port"][name]["raise_"]:
        assert r["err"]["type"] == "NonFiniteError", r["err"]
        assert (r["err"]["op"], r["err"]["phase"]) == (want["err"]["op"], want["err"]["phase"])
        assert f"at step {want['steps']}" in r["err"]["msg"] and want["err"]["op"] in r["err"]["msg"]
        assert r["steps"] == want["steps"]
        assert r["health"]["first_bad_op"] == want["health"]["first_bad_op"] == want["err"]["op"]
