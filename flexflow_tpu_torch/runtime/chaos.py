"""Seeded fault-schedule soak (port of flexflow_tpu/runtime/chaos.py).

The contract soaked: under every seeded `FaultSchedule` (a checkpoint-write
I/O fault, a producer-thread death, a simulated hang, a kill), the run
either completes, the fault absorbed, or dies with a structured error and,
after `fit(resume=True)`, ends with final parameters and optimizer state
bitwise equal to the fault-free run's.

The harness is model-agnostic: callers hand it a `build(checkpoint_dir,
watchdog=bool)` factory returning a compiled port FFModel (the JAX
package's also takes a metrics directory, which comes with A9). Seeds are
found with `fault.find_seed`, so every process derives the same schedules.
"""

from __future__ import annotations

import tempfile
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from flexflow_tpu_torch.runtime import fault as fault_mod
from flexflow_tpu_torch.runtime.fault import FaultSchedule

#: the sites a fit can soak (nonfinite's reaction is A9's)
SOAK_SITES = ("ckpt_write", "h2d", "hang", "kill")

State = Tuple[Dict[str, np.ndarray], List[np.ndarray]]


def final_state(model) -> State:
    """Host copies of (params by key, optimizer-state leaves in key order):
    the bitwise comparison's payload. A searched plan's are its global
    values, gathered (a collective)."""
    from flexflow_tpu_torch.runtime.checkpoint import _flatten, host_array

    state = {k: np.array(host_array(v)) for k, v in _flatten(model._checkpoint_state()).items()}
    params = {k.split("/", 1)[1]: v for k, v in state.items() if k.startswith("params/")}
    opt = [state[k] for k in sorted(state) if k.startswith("opt_state/")]
    return params, opt


def states_bitwise(a: State, b: State) -> Tuple[bool, bool]:
    """(params bitwise equal, optimizer state bitwise equal)."""
    pa, oa = a
    pb, ob = b
    params_ok = set(pa) == set(pb) and all(np.array_equal(pa[k], pb[k]) for k in pa)
    opt_ok = len(oa) == len(ob) and all(np.array_equal(x, y) for x, y in zip(oa, ob))
    return params_ok, opt_ok


def schedule_for_site(site: str, total_steps: int, checkpoint_every: int,
                      rate: float = 0.08) -> FaultSchedule:
    """A single-site schedule whose first firing lands where the soak can
    prove recovery: after the first checkpoint exists and before the run
    ends (for `ckpt_write`, on a checkpoint boundary that is not the first;
    for `hang`, after a completed window, so the watchdog has an
    estimate)."""
    lo = checkpoint_every + 1
    hi = max(total_steps - 1, lo)
    candidates = None
    if site == "ckpt_write":
        candidates = [s for s in range(checkpoint_every, total_steps, checkpoint_every)
                      if s > checkpoint_every] or [checkpoint_every]
        lo = 1
    seed = fault_mod.find_seed(site, rate, lo, hi, candidates=candidates)
    return FaultSchedule(seed=seed, sites=frozenset({site}), rate=rate)


def soak_schedule(schedule: FaultSchedule, build: Callable, x, y, reference: State,
                  epochs: int = 2, checkpoint_dir: Optional[str] = None) -> Dict[str, object]:
    """One faulted-then-recovered run under `schedule`, its final state
    compared bitwise with `reference` (the fault-free run's final_state).
    The watchdog is asked for only where the schedule has `hang` (an
    always-on tight budget could trip on a busy host). Returns the soak
    record (JSON-safe)."""
    cdir = checkpoint_dir or tempfile.mkdtemp()
    model = build(cdir, watchdog="hang" in schedule.sites)
    fault_mod.install_schedule(schedule)
    outcome, error_repr = "completed", None
    try:
        model.fit(x, y, epochs=epochs, shuffle=True, verbose=False)
    except Exception as e:
        outcome = type(e).__name__
        error_repr = f"{type(e).__name__}: {e}"[:200]
    finally:
        fault_mod.install_schedule(None)
    fired = [list(f) for f in schedule.fired_log]
    resumed = False
    if outcome != "completed":
        # a fresh model resumes from the last durable snapshot, the schedule
        # cleared (a real fault does not recur deterministically either)
        model = build(cdir, watchdog=False)
        model.fit(x, y, epochs=epochs, shuffle=True, verbose=False, resume=True)
        resumed = True
    params_ok, opt_ok = states_bitwise(final_state(model), reference)
    return {
        "spec": schedule.canonical_spec(),
        "sites": sorted(schedule.sites),
        "fired": fired,
        "outcome": outcome,
        "error": error_repr,
        "resumed": resumed,
        "bitwise_params": bool(params_ok),
        "bitwise_opt_state": bool(opt_ok),
        "recovered_bitwise": bool(params_ok and opt_ok),
    }


def soak_sites(build: Callable, x, y, total_steps: int, checkpoint_every: int, epochs: int = 2,
               sites: Tuple[str, ...] = SOAK_SITES) -> Dict[str, object]:
    """The whole soak: a fault-free reference run, then one seeded schedule
    per site, each required to recover bitwise. Its checkpoint directories
    live in one temporary directory, removed at the end. Returns
    {"schedules": [...], "n_schedules", "n_fired", "n_bitwise"}."""
    with tempfile.TemporaryDirectory() as work:
        ref_model = build(f"{work}/reference", watchdog=False)
        ref_model.fit(x, y, epochs=epochs, shuffle=True, verbose=False)
        reference = final_state(ref_model)
        del ref_model
        records = []
        for site in sites:
            schedule = schedule_for_site(site, total_steps, checkpoint_every)
            records.append(soak_schedule(schedule, build, x, y, reference, epochs=epochs,
                                         checkpoint_dir=f"{work}/{site}"))
    return {
        "schedules": records,
        "n_schedules": len(records),
        "n_fired": sum(1 for r in records if r["fired"]),
        "n_bitwise": sum(1 for r in records if r["recovered_bitwise"]),
    }


__all__ = [
    "SOAK_SITES",
    "final_state",
    "schedule_for_site",
    "soak_schedule",
    "soak_sites",
    "states_bitwise",
]
