"""The seeded fault-schedule soak on the port (flexflow_tpu_torch/runtime/
chaos.py, fault.py, supervisor.py), the counterpart of
tests/test_chaos_soak.py, on the CPU:

- each of the sites `ckpt_write`, `h2d`, `hang` and `kill` under its seeded
  schedule, in windows of 4 (K=4) and per step (K=1; the `h2d` site lives
  in the windowed input pipeline's producer, so it soaks only there),
  either completes (the fault absorbed) or dies with its structured error
  and, after fit(resume=True), ends bitwise equal to the fault-free run
  (parameters and both Adam moments, Dropout on);
- the schedules are the JAX package's: FaultSchedule.fire_steps,
  find_seed and schedule_for_site give the same steps and seeds;
- the `h2d` producer fault surfaces through the fault channel as a
  BackgroundFault; the watchdog armed by FFConfig.watchdog_factor or
  FF_TPU_WATCHDOG fires on an injected hang with its diagnostic, at the
  serving tests' 1000 ms floor; FF_TPU_FAULT_STEP is a crossing."""

import numpy as np
import pytest

from flexflow_tpu.runtime import chaos as jchaos
from flexflow_tpu.runtime import fault as jfault
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.core.dataloader import BatchIterator, WindowedBatchIterator
from flexflow_tpu_torch.runtime import chaos, fault
from flexflow_tpu_torch.runtime.chaos import final_state, schedule_for_site, soak_schedule
from flexflow_tpu_torch.runtime.fault import FaultSchedule, SimulatedFault
from flexflow_tpu_torch.runtime.supervisor import BackgroundFault, FaultChannel, WindowHangError

BATCH = 16
STEPS_PER_EPOCH = 8
EPOCHS = 2
TOTAL = EPOCHS * STEPS_PER_EPOCH
EVERY = 4
WATCHDOG_FACTOR = 50.0  # a budget of max(1000 ms, 50 x the window estimate)

# each site's outcome before recovery: the detection half of the contract
EXPECTED_OUTCOMES = {
    "ckpt_write": "completed",        # a transient the retry backoff absorbs
    "h2d": "BackgroundFault",         # the producer's death, through the channel
    "hang": "WindowHangError",        # the watchdog's deadline
    "kill": "SimulatedFault",         # a preemption between windows
}


def _data():
    rs = np.random.RandomState(0)
    n = BATCH * STEPS_PER_EPOCH
    return rs.randn(n, 32).astype(np.float32), rs.randint(0, 10, n)


def _builder(k):
    def build(checkpoint_dir, watchdog=False):
        m = tcore.FFModel(tcore.FFConfig(
            batch_size=BATCH, seed=0, steps_per_dispatch=k, print_freq=0,
            checkpoint_dir=checkpoint_dir, checkpoint_every_n_steps=EVERY,
            watchdog_factor=WATCHDOG_FACTOR if watchdog else 0.0), device="cpu")
        x = m.create_tensor([BATCH, 32], name="x")
        h = m.dropout(m.relu(m.dense(x, 32, use_bias=False, name="fc1")), 0.1)
        m.dense(h, 10, use_bias=False, name="head")
        m.compile(tcore.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        return m

    return build


@pytest.fixture(scope="module")
def references(tmp_path_factory):
    out = {}
    for k in (1, 4):
        m = _builder(k)(str(tmp_path_factory.mktemp(f"reference{k}")))
        m.fit(*_data(), epochs=EPOCHS, shuffle=True, verbose=False)
        out[k] = final_state(m)
    return out


SOAKS = [(site, 4) for site in chaos.SOAK_SITES] + [
    (site, 1) for site in chaos.SOAK_SITES if site != "h2d"]


@pytest.mark.parametrize("site,k", SOAKS, ids=[f"{s}-k{k}" for s, k in SOAKS])
def test_every_site_recovers_bitwise(tmp_path, references, site, k):
    schedule = schedule_for_site(site, TOTAL, EVERY)
    record = soak_schedule(schedule, _builder(k), *_data(), references[k], epochs=EPOCHS,
                           checkpoint_dir=str(tmp_path))
    assert record["fired"] and record["fired"][0][0] == site, record
    assert record["outcome"] == EXPECTED_OUTCOMES[site], record
    assert record["resumed"] == (EXPECTED_OUTCOMES[site] != "completed")
    assert record["bitwise_params"] and record["bitwise_opt_state"], record


def test_soak_sites_runs_the_whole_matrix():
    result = chaos.soak_sites(_builder(4), *_data(), total_steps=TOTAL, checkpoint_every=EVERY,
                              epochs=EPOCHS, sites=("ckpt_write", "kill"))
    assert (result["n_schedules"], result["n_fired"], result["n_bitwise"]) == (2, 2, 2)


# --- the schedules are the JAX package's ------------------------------------------

SPECS = ["seed=7;sites=ckpt_write,h2d,hang,kill;rate=0.02", "seed=0;sites=kill;rate=0.08",
         "seed=123;sites=h2d,hang;rate=0.3", "sites=nonfinite,slow;seed=5;rate=1.0"]


@pytest.mark.parametrize("spec", SPECS)
def test_fire_steps_are_the_jax_packages(spec):
    ours, theirs = FaultSchedule.parse(spec), jfault.FaultSchedule.parse(spec)
    assert ours.canonical_spec() == theirs.canonical_spec()
    for site in fault.FAULT_SITES + fault.SOFT_SITES:
        assert ours.fire_steps(site, 1, 500) == theirs.fire_steps(site, 1, 500), site


@pytest.mark.parametrize("site", chaos.SOAK_SITES)
def test_find_seed_and_schedule_for_site_are_the_jax_packages(site):
    assert fault.find_seed(site, 0.08, 5, 15) == jfault.find_seed(site, 0.08, 5, 15)
    ours, theirs = schedule_for_site(site, TOTAL, EVERY), jchaos.schedule_for_site(
        site, TOTAL, EVERY)
    assert ours.canonical_spec() == theirs.canonical_spec()


# --- the sites' detection -----------------------------------------------------------


def test_an_h2d_producer_fault_surfaces_as_background_fault():
    rs = np.random.RandomState(0)
    it = BatchIterator({"x": rs.randn(64, 4).astype(np.float32)}, rs.randint(0, 3, 64), 8,
                       device="cpu")
    schedule = FaultSchedule(seed=fault.find_seed("h2d", 0.2, 5, 8), sites=frozenset({"h2d"}),
                             rate=0.2)
    step = schedule.fire_steps("h2d", 1, 8)[0]
    channel = FaultChannel()
    windows = WindowedBatchIterator(it, 4, fault_channel=channel, step_base=0)
    fault.install_schedule(schedule)
    try:
        with pytest.raises(BackgroundFault, match="h2d_producer") as ei:
            for _ in windows:
                pass
    finally:
        fault.install_schedule(None)
        windows.close()
    assert isinstance(ei.value.original, fault.InjectedFault)
    assert ei.value.original.step == step and channel.pending() == 0
    assert channel.history[0][0] == "h2d_producer"


@pytest.mark.parametrize("how", ["config", "env"])
def test_the_watchdog_in_fit_fires_on_an_injected_hang(monkeypatch, tmp_path, how):
    build = _builder(4)
    if how == "env":
        monkeypatch.setenv("FF_TPU_WATCHDOG", str(WATCHDOG_FACTOR))
    m = build(str(tmp_path), watchdog=how == "config")
    schedule = schedule_for_site("hang", TOTAL, EVERY)
    fault.install_schedule(schedule)
    try:
        with pytest.raises(WindowHangError) as ei:
            m.fit(*_data(), epochs=EPOCHS, shuffle=True, verbose=False)
    finally:
        fault.install_schedule(None)
    diag = ei.value.diagnostic
    assert diag is not None and diag.budget_ms >= 1000.0 and diag.device_kind
    fired = schedule.fired_log[0][1]
    assert diag.window_base_step <= fired < diag.window_base_step + diag.window_steps
    assert diag.last_completed_step == diag.window_base_step - 1


def test_a_hang_without_a_watchdog_says_so(tmp_path):
    m = _builder(1)(str(tmp_path))
    fault.install_schedule(schedule_for_site("hang", TOTAL, EVERY))
    try:
        with pytest.raises(RuntimeError, match="no watchdog is armed"):
            m.fit(*_data(), epochs=EPOCHS, shuffle=True, verbose=False)
    finally:
        fault.install_schedule(None)


def test_fault_step_is_a_crossing(monkeypatch):
    monkeypatch.setenv("FF_TPU_FAULT_STEP", "10")
    fault.maybe_inject_fault(4, 8)
    with pytest.raises(SimulatedFault):
        fault.maybe_inject_fault(8, 12)
    fault.maybe_inject_fault(10, 14)  # a resumed run past the step never raises again
    kill = FaultSchedule(seed=fault.find_seed("kill", 0.3, 3, 6), sites=frozenset({"kill"}),
                         rate=0.3)
    first = kill.fire_steps("kill", 1, 6)[0]
    with pytest.raises(SimulatedFault):
        fault.inject_boundary_faults(kill, first - 1, first)
    fault.inject_boundary_faults(kill, first - 1, first)  # once per (site, step)
