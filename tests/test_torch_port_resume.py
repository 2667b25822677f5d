"""Fit-loop checkpointing and bitwise resume on the port's FFModel (CPU),
the counterpart of tests/test_elastic.py's TestChaosResume and
TestResumeSemantics and of tests/test_checkpoint_integrity.py's
TestFallbackInFit:

- a run killed by FF_TPU_FAULT_STEP and resumed from its last snapshot by a
  new FFModel ends bitwise equal to the uninterrupted run, port against
  port (the ROADMAP's RNG rule): every step's loss, the parameters and both
  Adam moments, with Dropout, per step (K=1) and in windows (K=4), through
  the async writer and the sync path;
- a resumed run does not replay committed steps; the interval is a
  crossing; a restore copies into the model's tensors in place;
- the refusals (resume without a directory, a weights-only checkpoint, a
  mismatched epoch_offset), the cold start, no writer thread leaked by a
  failed resume, fit's keyword arguments over FFConfig's, and a truncated
  latest snapshot falling back on resume;
- without Dropout the port's uninterrupted and resumed trajectories equal
  the JAX fit's within tests/test_torch_port_fused.py's f32 tolerance;
- recompiles (A8 part 2): recompile() keeps the step and the state;
- the `nonfinite` and `slow` fault sites in a fit, per step and in
  windows, get their reactions: a skipped step under skip_step, a slept
  step in the events' `wallclock_ms`."""

import os
import threading

import jax
import numpy as np
import pytest
import torch

from flexflow_tpu import core as jcore
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
from flexflow_tpu_torch.observability.metrics import read_events
from flexflow_tpu_torch.runtime import fault
from flexflow_tpu_torch.runtime.chaos import final_state, states_bitwise
from flexflow_tpu_torch.runtime.checkpoint import CheckpointError, CheckpointManager
from flexflow_tpu_torch.runtime.fault import FaultSchedule, SimulatedFault

BATCH = 16
STEPS_PER_EPOCH = 8
EPOCHS = 2
TOTAL = EPOCHS * STEPS_PER_EPOCH
EVERY = 4
FAULT_STEP = "10"
RTOL, ATOL = 1e-5, 1e-6


def _data(seed=0):
    rs = np.random.RandomState(seed)
    n = BATCH * STEPS_PER_EPOCH
    return rs.randn(n, 32).astype(np.float32), rs.randint(0, 10, n)


def _build(pkg=tcore, k=1, ckpt_dir="", every=EVERY, dropout=True, sync=False, **cfg):
    """tests/test_elastic.py's model: 32 -> 32 relu (-> Dropout 0.1) -> 10,
    Adam(1e-2)."""
    kw = {"device": "cpu"} if pkg is tcore else {}
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, seed=0, steps_per_dispatch=k, print_freq=0,
                                 max_devices=1, checkpoint_dir=ckpt_dir,
                                 checkpoint_every_n_steps=every, checkpoint_sync=sync,
                                 **(dict(checkpoint_backend="npz") if pkg is jcore else {}),
                                 **cfg), **kw)
    x = m.create_tensor([BATCH, 32], name="x")
    h = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    if dropout:
        h = m.dropout(h, 0.1)
    logits = m.dense(h, 10, use_bias=False, name="head")
    m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)
    return m


def _record_losses(m):
    """Every step's loss by step number, from the per-step or the fused
    calls (the port's window calls train_step: counted once)."""
    losses = {}
    step, multi = m.instance.train_step, m.instance.multi_train_step
    in_window = []

    def train_step(*a, **kw):
        out = step(*a, **kw)
        if not in_window:
            losses[m._step_count + 1] = float(out[2])
        return out

    def multi_train_step(*a, **kw):
        in_window.append(True)
        try:
            out = multi(*a, **kw)
        finally:
            in_window.pop()
        for i, v in enumerate(np.asarray(out[3]).tolist()):
            losses[m._step_count + i + 1] = v
        return out

    m.instance.train_step, m.instance.multi_train_step = train_step, multi_train_step
    return losses


def _kill_and_resume(monkeypatch, tmp_path, k, sync=False, **kw):
    """(the faulted model's losses, the resumed model and its losses)."""
    xv, yv = _data()
    cdir = str(tmp_path / "ckpt")
    monkeypatch.setenv("FF_TPU_FAULT_STEP", FAULT_STEP)
    m = _build(k=k, ckpt_dir=cdir, sync=sync, **kw)
    first = _record_losses(m)
    with pytest.raises(SimulatedFault):
        m.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False)
    monkeypatch.delenv("FF_TPU_FAULT_STEP")
    m2 = _build(k=k, ckpt_dir=cdir, sync=sync, **kw)
    second = _record_losses(m2)
    m2.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False, resume=True)
    return first, m2, second


@pytest.fixture(scope="module")
def reference():
    """The uninterrupted runs at K=1 and K=4 (Dropout on): (losses by step,
    final state)."""
    xv, yv = _data()
    out = {}
    for k in (1, 4):
        m = _build(k=k)
        losses = _record_losses(m)
        m.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False)
        out[k] = (losses, final_state(m))
    return out


@pytest.mark.parametrize("k,sync", [(1, False), (4, False), (1, True), (4, True)],
                         ids=["k1-async", "k4-async", "k1-sync", "k4-sync"])
def test_kill_and_resume_is_bitwise(monkeypatch, tmp_path, reference, k, sync):
    ref_losses, ref_state = reference[k]
    first, m2, second = _kill_and_resume(monkeypatch, tmp_path, k, sync=sync)
    # the fault crossed step 10: after it (K=1) or after its window (K=4)
    killed_at = 10 if k == 1 else 12
    assert max(first) == killed_at
    snapshot = CheckpointManager(str(tmp_path / "ckpt")).all_steps()
    assert m2._step_count == TOTAL and snapshot[-1] == TOTAL
    resumed_from = (killed_at // EVERY) * EVERY
    assert min(second) == resumed_from + 1
    for s in range(1, TOTAL + 1):
        got = first[s] if s <= resumed_from else second[s]
        assert got == ref_losses[s], s
    assert states_bitwise(final_state(m2), ref_state) == (True, True)


def test_resumed_run_does_not_replay_committed_steps(monkeypatch, tmp_path):
    _, m2, second = _kill_and_resume(monkeypatch, tmp_path, 1)
    assert sorted(second) == list(range(9, TOTAL + 1))
    assert int(m2.opt_state["step"]) == TOTAL


def test_the_interval_is_a_crossing(tmp_path):
    """Windows of 4 against an interval of 6: the windows ending at steps 8
    and 12 cross 6 and 12 and snapshot; those ending at 4 and 16 cross
    none."""
    m = _build(k=4, ckpt_dir=str(tmp_path), every=6, checkpoint_max_to_keep=10)
    m.fit(*_data(), epochs=EPOCHS, shuffle=True, verbose=False)
    assert CheckpointManager(str(tmp_path)).all_steps() == [8, 12]
    assert [s["step"] for s in m.checkpointer.stats] == [8, 12]


def test_a_restore_copies_into_the_models_tensors(tmp_path):
    """load_checkpoint and resume write the state in place: the tensors a
    captured window holds by address stay the ones trained."""
    m = _build(k=4, ckpt_dir=str(tmp_path))
    m.fit(*_data(), epochs=1, shuffle=True, verbose=False)
    m2 = _build(k=4)
    ids = {k: (id(t), t.data_ptr()) for k, t in m2.params.items()}
    ids["step"] = (id(m2.opt_state["step"]), m2.opt_state["step"].data_ptr())
    assert m2.load_checkpoint(str(tmp_path)) == STEPS_PER_EPOCH
    assert {k: (id(t), t.data_ptr()) for k, t in m2.params.items()} == {
        k: v for k, v in ids.items() if k != "step"}
    assert (id(m2.opt_state["step"]), m2.opt_state["step"].data_ptr()) == ids["step"]
    assert states_bitwise(final_state(m2), final_state(m)) == (True, True)


# --- resume semantics -----------------------------------------------------------


def test_resume_without_checkpoint_dir_rejected():
    m = _build()
    with pytest.raises(ValueError, match="checkpoint_dir"):
        m.fit(*_data(), epochs=1, verbose=False, resume=True)


def test_resume_on_empty_directory_cold_starts(tmp_path, reference):
    m = _build(ckpt_dir=str(tmp_path))
    m.fit(*_data(), epochs=EPOCHS, shuffle=True, verbose=False, resume=True)
    assert m._step_count == TOTAL
    assert states_bitwise(final_state(m), reference[1][1]) == (True, True)


def test_resume_from_weights_only_checkpoint_rejected(tmp_path):
    m = _build()
    m.fit(*_data(), epochs=1, verbose=False)
    m.save_checkpoint(str(tmp_path))
    m2 = _build(ckpt_dir=str(tmp_path))
    with pytest.raises(CheckpointError, match="no resume metadata"):
        m2.fit(*_data(), epochs=1, verbose=False, resume=True)


def test_resume_with_mismatched_epoch_offset_rejected(monkeypatch, tmp_path):
    cdir = str(tmp_path)
    monkeypatch.setenv("FF_TPU_FAULT_STEP", "6")
    with pytest.raises(SimulatedFault):
        _build(ckpt_dir=cdir).fit(*_data(), epochs=EPOCHS, verbose=False)
    monkeypatch.delenv("FF_TPU_FAULT_STEP")
    with pytest.raises(CheckpointError, match="epoch_offset"):
        _build(ckpt_dir=cdir).fit(*_data(), epochs=EPOCHS, verbose=False, resume=True,
                                  epoch_offset=3)


def test_failed_resume_does_not_leak_writer_thread(tmp_path):
    m = _build()
    m.fit(*_data(), epochs=1, verbose=False)
    m.save_checkpoint(str(tmp_path))

    def writers():
        return sum(t.name == "ff-checkpoint-writer" and t.is_alive()
                   for t in threading.enumerate())

    before = writers()
    for _ in range(3):
        with pytest.raises(CheckpointError):
            _build(ckpt_dir=str(tmp_path)).fit(*_data(), epochs=1, verbose=False, resume=True)
    assert writers() == before


def test_fit_kwargs_override_config(tmp_path):
    cfg_dir, kw_dir = tmp_path / "cfg", tmp_path / "kw"
    m = _build(ckpt_dir=str(cfg_dir), every=100)
    m.fit(*_data(), epochs=1, verbose=False, checkpoint_dir=str(kw_dir),
          checkpoint_every_n_steps=4)
    assert CheckpointManager(str(kw_dir)).all_steps() == [4, 8]
    assert not cfg_dir.exists() or not os.listdir(cfg_dir)


def test_truncated_checkpoint_falls_back_on_resume(tmp_path):
    xv, yv = _data()
    cdir = str(tmp_path)
    m = _build(k=4, ckpt_dir=cdir)
    m.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False)
    newest = CheckpointManager(cdir).latest_step()
    assert newest == TOTAL
    with open(os.path.join(cdir, f"step_{newest}", "arr_0.npy"), "w"):
        pass  # truncate
    m2 = _build(k=4, ckpt_dir=cdir)
    steps = _record_losses(m2)
    m2.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False, resume=True)
    fb = m2.search_provenance["recovery"]["checkpoint_fallback"]
    assert fb["restored_step"] == 12 and [q["step"] for q in fb["quarantined"]] == [TOTAL]
    assert os.path.isdir(os.path.join(cdir, f"step_{TOTAL}.corrupt"))
    assert sorted(steps) == [13, 14, 15, 16] and m2._step_count == TOTAL
    assert states_bitwise(final_state(m2), final_state(m)) == (True, True)


# --- against the JAX fit (Dropout off) -------------------------------------------


def _jax_run(k):
    jm = _build(jcore, k=k, dropout=False)
    init = (jax.tree_util.tree_map(np.asarray, jm.params),
            jax.tree_util.tree_map(np.asarray, jm.opt_state))
    losses = {}
    step, multi = jm.instance.train_step, getattr(jm.instance, "multi_train_step", None)

    def train_step(*a, **kw):
        out = step(*a, **kw)
        losses[jm._step_count + 1] = float(out[2])
        return out

    def multi_train_step(*a, **kw):
        out = multi(*a, **kw)
        for i, v in enumerate(np.asarray(out[3]).tolist()):
            losses[jm._step_count + i + 1] = v
        return out

    jm.instance.train_step, jm.instance.multi_train_step = train_step, multi_train_step
    jm.fit(*_data(), epochs=EPOCHS, shuffle=True, verbose=False)
    tree = lambda t: {k: np.asarray(v) for k, v in t.items()}  # noqa: E731
    return init, losses, (tree(jm.params), tree(jm.opt_state["m"]), tree(jm.opt_state["v"]))


@pytest.mark.parametrize("k", [1, 4])
def test_uninterrupted_and_resumed_runs_follow_the_jax_fit(monkeypatch, tmp_path, k):
    init, jlosses, (jp, jm_, jv) = _jax_run(k)
    xv, yv = _data()
    runs = {}
    m = _build(k=k, dropout=False, ckpt_dir=str(tmp_path / "whole"))
    ffmodel_state_from_numpy(m, *init)
    runs["whole"] = (_record_losses(m), m)
    m.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False)
    cdir = str(tmp_path / "killed")
    monkeypatch.setenv("FF_TPU_FAULT_STEP", FAULT_STEP)
    killed = _build(k=k, dropout=False, ckpt_dir=cdir)
    ffmodel_state_from_numpy(killed, *init)
    first = _record_losses(killed)
    with pytest.raises(SimulatedFault):
        killed.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False)
    monkeypatch.delenv("FF_TPU_FAULT_STEP")
    m2 = _build(k=k, dropout=False, ckpt_dir=cdir)
    second = _record_losses(m2)
    m2.fit(xv, yv, epochs=EPOCHS, shuffle=True, verbose=False, resume=True)
    runs["resumed"] = ({**first, **second}, m2)
    for name, (losses, model) in runs.items():
        assert sorted(losses) == sorted(jlosses) == list(range(1, TOTAL + 1)), name
        np.testing.assert_allclose([losses[s] for s in sorted(losses)],
                                   [jlosses[s] for s in sorted(jlosses)], rtol=RTOL, atol=ATOL)
        got = (model.params, model.opt_state["m"], model.opt_state["v"])
        for g, want in zip(got, (jp, jm_, jv)):
            for key in want:
                np.testing.assert_allclose(g[key].numpy(), want[key], rtol=RTOL, atol=ATOL,
                                           err_msg=f"{name} {key}")


# --- what waits raises, naming its item -------------------------------------------


def test_recompiles_raise_naming_a8_part_2():
    """Recompiles are ported (runtime/recompile.py): recompile() keeps the
    step count and carries the state bitwise, and a fit with a
    RecompileState whose trigger never fires trains as one without."""
    from flexflow_tpu_torch.runtime.recompile import RecompileState

    m = _build()
    m.fit(*_data(), epochs=1, verbose=False)
    steps = m._step_count
    before = {k: v.clone() for k, v in m.params.items()}
    m.recompile()
    assert m._step_count == steps
    assert all(torch.equal(before[k], m.params[k]) for k in before)
    never = RecompileState(lambda ff: False, lambda ff: None)
    m.fit(*_data(), epochs=1, verbose=False, recompile_state=never)
    assert never.recompilations == 0 and m._step_count == 2 * steps


SLOW_MS = 150.0


@pytest.mark.parametrize("site", ["nonfinite", "slow"])
@pytest.mark.parametrize("k", [1, 4])
def test_observability_fault_sites_raise_naming_a9(site, k, tmp_path, monkeypatch):
    """The sites fire in the fit and get their reactions (the name is the
    one of the refusal it replaced): `nonfinite` poisons the firing steps'
    batches, which skip_step skips (flags in the events, Adam's step count
    short by them, the parameters finite); `slow` sleeps inside the firing
    steps, which the events' wall-clock carries."""
    monkeypatch.setenv(fault.SLOW_MS_ENV, str(SLOW_MS))
    metrics = str(tmp_path)
    m = _build(k=k, metrics_dir=metrics, health_policy="skip_step")
    schedule = FaultSchedule(seed=0, sites=frozenset({site}), rate=0.5)
    fault.install_schedule(schedule)
    try:
        m.fit(*_data(), epochs=1, verbose=False)
    finally:
        fault.install_schedule(None)
    fired = [step for s, step in schedule.fired_log if s == site]
    assert fired and m._step_count == STEPS_PER_EPOCH
    events = [e for e in read_events(metrics) if "step" in e]
    assert [e["step"] for e in events] == list(range(1, STEPS_PER_EPOCH + 1))
    if site == "nonfinite":
        assert [e["step"] for e in events if e["skipped"] and e["nonfinite"]] == fired
        assert not any(e["skipped"] for e in events if e["step"] not in fired)
        assert int(m.opt_state["step"]) == STEPS_PER_EPOCH - len(fired)
        assert all(torch.isfinite(p).all() for p in m.params.values())
    else:
        assert not any(e["skipped"] or e["nonfinite"] for e in events)
        assert sum(e["wallclock_ms"] for e in events) >= SLOW_MS * len(fired)
        if k == 1:
            assert all(e["wallclock_ms"] >= SLOW_MS for e in events if e["step"] in fired)
