"""Recompiles and degraded-grid recovery on the port (flexflow_tpu_torch/
runtime/recompile.py, FFModel.recompile, fit(recompile_state=...)) against
the JAX package's:

- batch growth mid-fit (8 -> 16 at step 2, tests/test_recompile.py's), per
  step and in fused windows of 2: the port's losses by step within 1e-5 of
  the JAX FFModel's (f32, SGD, the same initial parameters), its final
  parameters within 1e-5 relative, one recompile, the batch grown;
- the parameters and optimizer state a recompile carries are bitwise those
  before, the step count kept, the transition verified first (TRN003
  recorded for the batch change);
- degraded-grid recovery (tests/test_elastic.py::TestDegradedGridRecovery):
  4 gloo ranks fit one epoch of the searched MLP with checkpoints, then
  recover to 2: ranks 0-1 open a new group, search again, restore the
  checkpoint onto the new plan and fit another epoch; ranks 2-3 drop out
  (their fit trains nothing and returns) and nothing hangs. The JAX
  FFModel runs the same from 4 virtual devices to 2: the same recovery
  record fields, the same restored step, and losses by step within 1e-5.

The rank job runs once a module; each rank is joined within 120 s."""

import json
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import flexflow_tpu.core as jcore
from flexflow_tpu.observability.metrics import read_events as j_read_events
from flexflow_tpu.runtime.recompile import RecompileState as JState
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
from flexflow_tpu_torch.observability.metrics import read_events
from flexflow_tpu_torch.runtime.recompile import RecompileState

REPO = Path(__file__).resolve().parent.parent
TOL = 1e-5


def _model(pkg, batch=8, k=1, metrics_dir=""):
    cfg = pkg.FFConfig(batch_size=batch, epochs=1, seed=0, print_freq=0, steps_per_dispatch=k,
                       metrics_dir=metrics_dir)
    m = pkg.FFModel(cfg, **({"device": "cpu"} if pkg is tcore else {}))
    x = m.create_tensor([batch, 16], name="x")
    t = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    m.dense(t, 4, use_bias=False, name="out")
    m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=["accuracy"])
    return m


def _grow(state_cls):
    return state_cls(trigger_func=lambda ff: ff._step_count >= 2 and ff.config.batch_size == 8,
                     alter_func=lambda ff: setattr(ff.config, "batch_size", 16))


@pytest.mark.parametrize("k", [1, 2])
def test_batch_growth_fit_follows_the_jax_ffmodel(k, tmp_path):
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(64, 16).astype(np.float32), rs.randint(0, 4, 64).astype(np.int32)
    runs = []
    for pkg, state_cls, reader in ((jcore, JState, j_read_events),
                                   (tcore, RecompileState, read_events)):
        mdir = str(tmp_path / pkg.__name__)
        m = _model(pkg, k=k, metrics_dir=mdir)
        if pkg is tcore:
            ffmodel_state_from_numpy(m, runs[0]["init"])
        init = {key: np.array(v) for key, v in m.params.items()}
        state = _grow(state_cls)
        perf = m.fit(xs, ys, epochs=2, shuffle=False, verbose=False, recompile_state=state)
        losses = {e["step"]: e["loss"] for e in reader(mdir) if "step" in e}
        runs.append(dict(init=init, losses=losses, perf=perf, state=state, m=m,
                         params={key: np.array(v) for key, v in m.params.items()}))
    j, t = runs
    assert t["state"].recompilations == j["state"].recompilations == 1
    assert t["m"].config.batch_size == 16 and t["m"]._step_count == j["m"]._step_count
    assert t["perf"].train_all == j["perf"].train_all
    assert sorted(t["losses"]) == sorted(j["losses"])
    for step, loss in j["losses"].items():
        assert abs(t["losses"][step] - loss) <= TOL * max(1.0, abs(loss)), step
    for key, w in j["params"].items():
        assert np.linalg.norm(t["params"][key] - w) <= TOL * np.linalg.norm(w), key
    assert t["m"].search_provenance["transition"]["rules_tripped"] == ["TRN003"]


def test_a_recompile_carries_the_state_bitwise():
    m = _model(tcore)
    rs = np.random.RandomState(1)
    m.fit(rs.randn(32, 16).astype(np.float32), rs.randint(0, 4, 32), epochs=1, verbose=False)
    params = {key: v.clone() for key, v in m.params.items()}
    opt = {key: v.clone() for key, v in m.opt_state.items() if isinstance(v, torch.Tensor)}
    m.config.batch_size = 16
    m.recompile()
    assert m._step_count == 4
    assert all(torch.equal(params[key], m.params[key]) for key in params)
    assert all(torch.equal(opt[key], m.opt_state[key]) for key in opt)
    assert m.search_provenance["transition"]["contract_new"]["batch_schedule"] == {"x": [16, 16]}


# -- degraded-grid recovery over ranks ------------------------------------------

BATCH, STEPS = 16, 8
BUILD = textwrap.dedent(
    """
    def _build(pkg, cfg, device=None):
        m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
        x = m.create_tensor([16, 32], name="x")
        h = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
        logits = m.dense(h, 10, use_bias=False, name="head")
        m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
                  metrics=["accuracy"], logit_tensor=logits)
        return m
    """
)
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
    from flexflow_tpu_torch.observability.metrics import read_events
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.runtime.recompile import active_num_devices, recover_from_grid_change

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store4"), rank, 4, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "build.py")).read())
    cfg = json.load(open(os.path.join(work, "cfg.json")))
    data = np.load(os.path.join(work, "data.npz"))
    m = _build(core, cfg, device="cpu")
    ffmodel_state_from_numpy(m, {k: data[k] for k in data.files if k.startswith("n")})
    m.fit(data["xs"], data["ys"], epochs=1, shuffle=False, verbose=False)
    before = active_num_devices(m)
    rec = recover_from_grid_change(m, 2, checkpoint_dir=cfg["checkpoint_dir"],
                                   reason="simulated_device_failure",
                                   init_method="file://" + os.path.join(work, "store2"))
    transition = (m.search_provenance or {}).get("transition")
    perf = m.fit(data["xs"], data["ys"], epochs=1, shuffle=False, verbose=False,
                 epoch_offset=1)
    out = dict(rec=rec, before=before, after=active_num_devices(m), steps=m._step_count,
               train_all=perf.train_all, inactive=m.inactive,
               verify=(m.search_provenance or {}).get("verify"), transition=transition)
    if rank == 0:
        out["losses"] = {e["step"]: e["loss"] for e in read_events(cfg["metrics_dir"])
                         if "step" in e}
    json.dump(out, open(os.path.join(work, f"out{rank}.json"), "w"), default=str)
    if dist.is_initialized():
        dist.destroy_process_group()
    """
)


@pytest.fixture(scope="module")
def degraded(tmp_path_factory):
    exec(BUILD, globals())
    work = tmp_path_factory.mktemp("degraded")
    rs = np.random.RandomState(0)
    xs = rs.randn(BATCH * STEPS, 32).astype(np.float32)
    ys = rs.randint(0, 10, BATCH * STEPS).astype(np.int32)
    jdir, jck = tempfile.mkdtemp(), tempfile.mkdtemp()
    jcfg = dict(batch_size=BATCH, seed=0, print_freq=0, search_budget=2, max_devices=4,
                metrics_dir=jdir, checkpoint_dir=jck, checkpoint_every_n_steps=4,
                checkpoint_backend="npz")
    jm = _build(jcore, jcfg)  # noqa: F821 (defined by BUILD)
    init = {k: np.array(v) for k, v in jm.params.items()}
    jm.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
    from flexflow_tpu.runtime.recompile import recover_from_grid_change as j_recover

    jrec = j_recover(jm, 2, checkpoint_dir=jck, reason="simulated_device_failure")
    jtransition = jm.search_provenance["transition"]
    jm.fit(xs, ys, epochs=1, shuffle=False, verbose=False, epoch_offset=1)
    jlosses = {e["step"]: e["loss"] for e in j_read_events(jdir) if "step" in e}
    np.savez(work / "data.npz", xs=xs, ys=ys, **init)
    cfg = dict(jcfg, metrics_dir=str(work / "metrics"), checkpoint_dir=str(work / "ckpt"))
    (work / "build.py").write_text(BUILD)
    (work / "cfg.json").write_text(json.dumps(cfg))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(4)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    ranks = [json.loads((work / f"out{r}.json").read_text()) for r in range(4)]
    return dict(jrec=jrec, jtransition=jtransition, jlosses=jlosses, jsteps=jm._step_count,
                ranks=ranks)


def test_the_kept_ranks_search_again_restore_and_continue(degraded):
    jrec = degraded["jrec"]
    for r in degraded["ranks"][:2]:
        rec = r["rec"]
        assert (r["before"], r["after"]) == (4, 2) and not r["inactive"]
        for key in ("old_grid", "new_grid", "re_searched", "restored_step", "reason"):
            assert rec[key] == jrec[key], key
        assert r["steps"] == degraded["jsteps"] == 2 * STEPS
        assert r["verify"]["clean"]


def _comparable(rec, links, rng):
    """A transition record with what names each package's hardware and
    generator checked and set aside: the movement-store keys end in the
    link class (JAX "|ici", the port "|nvlink"), and carry_remap's RNG line
    names JAX's threefry key or the port's torch.Generator."""
    rec = json.loads(json.dumps(rec))
    for leaf in rec["per_leaf"]:
        key = leaf.pop("movement_key")
        assert key is None or key.endswith("|" + links), key
    if "rng" in rec["carry_remap"]:
        assert rec["carry_remap"].pop("rng").startswith(rng)
    return rec


def test_the_kept_ranks_verify_the_transition_as_the_jax_recovery(degraded):
    """The old plan is taken before the old group closes, so the 4 -> 2
    transition is verified (TRN001-TRN004) before the state carries over,
    and recorded as the JAX recovery records it."""
    want = _comparable(degraded["jtransition"], "ici", "threefry key")
    for r in degraded["ranks"][:2]:
        assert r["transition"] is not None
        assert _comparable(r["transition"], "nvlink", "torch.Generator state") == want
    assert not set(want["rules_tripped"]) & {"TRN001", "TRN002"}


def test_the_dropped_ranks_neither_hang_nor_train(degraded):
    for r in degraded["ranks"][2:]:
        assert r["inactive"] and r["rec"]["active"] is False
        assert r["after"] == 0 and r["train_all"] in (0, None)


def test_the_losses_follow_the_jax_recovery(degraded):
    got, want = degraded["ranks"][0]["losses"], degraded["jlosses"]
    assert sorted(map(int, got)) == sorted(want)
    for step, loss in want.items():
        assert abs(got[str(step)] - loss) <= TOL * max(1.0, abs(loss)), step
