"""Fault injection for the fit loop and the serving engine (copy of
flexflow_tpu/runtime/fault.py).

Two triggers, both active:

1. `FF_TPU_FAULT_STEP=N`: raise `SimulatedFault` as soon as training
   progress crosses step N, after that step's (or window's) update and its
   checkpoint hook, as a preemption that kills the process between
   dispatches would. The trigger is a crossing (prev_step < N <= step),
   not a threshold, so a resumed run restarting below N does not raise
   again forever.

2. `FF_TPU_FAULT_SPEC`: a seeded schedule of faults at named sites, e.g.::

       FF_TPU_FAULT_SPEC="seed=7;sites=ckpt_write,h2d,hang,kill;rate=0.02"

   Each (site, step) decision is a pure hash of (seed, site, step), the
   JAX package's own, so the same spec fires at the same steps in both
   packages, in every process, every run: that is what lets the chaos soak
   (runtime/chaos.py) require a faulted-then-recovered run to end bitwise
   equal to the fault-free one. Sites:

   - `ckpt_write`  one transient `InjectedFault` (an OSError) on the
                   checkpoint commit rename, absorbed by the
                   runtime/retry.py backoff;
   - `h2d`         the windowed input pipeline's producer thread dies with
                   an InjectedFault while building a window; the fit loop
                   sees it through the FaultChannel as a BackgroundFault;
   - `hang`        the step or window blocks like a hung dispatch until the
                   watchdog deadline fires (WindowWatchdog.simulate_hang),
                   in the fit loop and in the serving engine's decode
                   windows; it needs an armed watchdog;
   - `kill`        SimulatedFault at the boundary, after the checkpoint
                   hook (the FF_TPU_FAULT_STEP preemption, from the
                   schedule);
   - `nonfinite`   a NaN in the firing step's batch before it reaches the
                   card (the windowed input pipeline's producer poisons its
                   host window, the per-step loop its batch), whose
                   reaction is the run-health policy;
   - `slow`        (soft) a sleep inside the step's timed region
                   (`inject_slow_fault`, FF_TPU_FAULT_SLOW_MS, default
                   50 ms), whose reaction is the drift monitor.

   Faults fire at most once per (site, step) per schedule object
   (`fire_once`), so a retry of the same step sees one transient, not a
   permanent outage. Tests clear the schedule before resuming: a real
   fault does not recur deterministically either.
"""

from __future__ import annotations

import os
import zlib
from typing import FrozenSet, List, Optional, Set, Tuple

FAULT_STEP_ENV = "FF_TPU_FAULT_STEP"
FAULT_SPEC_ENV = "FF_TPU_FAULT_SPEC"
SLOW_MS_ENV = "FF_TPU_FAULT_SLOW_MS"

#: The injectable fault sites and the soft perturbation sites, as in the
#: JAX package (a spec naming any other site is refused).
FAULT_SITES = ("ckpt_write", "h2d", "nonfinite", "hang", "kill")
SOFT_SITES = ("slow",)


class SimulatedFault(RuntimeError):
    """The injected preemption (FF_TPU_FAULT_STEP or schedule site `kill`)."""

    def __init__(self, step: int) -> None:
        super().__init__(f"simulated preemption after step {step} ({FAULT_STEP_ENV})")
        self.step = step


class InjectedFault(OSError):
    """A schedule-injected I/O-shaped fault (sites `ckpt_write`, `h2d`). An
    OSError on purpose: the retry backoff (runtime/retry.py) must treat it
    as the flaky filesystem it simulates."""

    def __init__(self, site: str, step: int) -> None:
        super().__init__(f"injected {site!r} fault at step {step} ({FAULT_SPEC_ENV})")
        self.site = site
        self.step = step


class FaultSchedule:
    """A seeded, deterministic schedule of faults at named sites: the
    per-(site, step) decision hashes (seed, site, step) into [0, 1) and
    fires below `rate`. `fired_log` records every fault injected."""

    def __init__(
        self,
        seed: int = 0,
        sites: FrozenSet[str] = frozenset(),
        rate: float = 0.01,
        spec: str = "",
    ) -> None:
        unknown = sorted(set(sites) - set(FAULT_SITES) - set(SOFT_SITES))
        if unknown:
            raise ValueError(
                f"unknown fault sites {unknown}; known sites: "
                f"{list(FAULT_SITES) + list(SOFT_SITES)}"
            )
        if not 0.0 < rate <= 1.0:
            raise ValueError(f"fault rate must be in (0, 1], got {rate}")
        self.seed = int(seed)
        self.sites = frozenset(sites)
        self.rate = float(rate)
        self.spec = spec or self.canonical_spec()
        self.fired_log: List[Tuple[str, int]] = []
        self._once: Set[Tuple[str, int]] = set()

    def canonical_spec(self) -> str:
        return (
            f"seed={self.seed};sites={','.join(sorted(self.sites))};"
            f"rate={self.rate}"
        )

    @classmethod
    def parse(cls, spec: str) -> "FaultSchedule":
        """Parse `seed=7;sites=a,b;rate=0.02` (order-insensitive; unknown
        keys are refused, so a mistyped spec never runs fault-free)."""
        seed, sites, rate = 0, frozenset(), 0.01
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            if "=" not in part:
                raise ValueError(f"malformed fault-spec field {part!r}")
            k, v = part.split("=", 1)
            k = k.strip()
            if k == "seed":
                seed = int(v)
            elif k == "sites":
                sites = frozenset(s.strip() for s in v.split(",") if s.strip())
            elif k == "rate":
                rate = float(v)
            else:
                raise ValueError(
                    f"unknown fault-spec key {k!r} (known: seed, sites, rate)"
                )
        return cls(seed=seed, sites=sites, rate=rate, spec=spec)

    def should_fire(self, site: str, step: int) -> bool:
        if site not in self.sites:
            return False
        h = zlib.crc32(f"{self.seed}:{site}:{step}".encode("utf-8"))
        return (h & 0xFFFFFFFF) / 2.0**32 < self.rate

    def fire_once(self, site: str, step: int) -> bool:
        """True exactly the first time a firing (site, step) is asked, so a
        retry of the same step sees one transient fault."""
        if not self.should_fire(site, step):
            return False
        key = (site, int(step))
        if key in self._once:
            return False
        self._once.add(key)
        self.fired_log.append(key)
        return True

    def fire_steps(self, site: str, lo: int, hi: int) -> List[int]:
        """All steps in [lo, hi] where `site` fires."""
        return [s for s in range(lo, hi + 1) if self.should_fire(site, s)]


def find_seed(
    site: str,
    rate: float,
    lo: int,
    hi: int,
    max_seed: int = 100000,
    candidates=None,
) -> int:
    """The smallest seed whose first `site` firing lands inside [lo, hi]
    (and none before lo): the soak pins each schedule's fault to a step
    range where a checkpoint already exists, without stored magic seeds.
    `candidates` further restricts to steps where the site is consulted
    (`ckpt_write` runs only at checkpoint commits)."""
    for seed in range(max_seed):
        s = FaultSchedule(seed=seed, sites=frozenset({site}), rate=rate)
        fired = s.fire_steps(site, 1, hi)
        if not fired or fired[0] < lo:
            continue
        if candidates is not None and not any(f in candidates for f in fired):
            continue
        return seed
    raise ValueError(
        f"no seed < {max_seed} fires {site!r} first inside [{lo}, {hi}] at rate {rate}"
    )


_INSTALLED: Optional[FaultSchedule] = None
_ENV_CACHE: Tuple[str, Optional[FaultSchedule]] = ("", None)


def install_schedule(schedule: Optional[FaultSchedule]) -> None:
    """Install (or clear, with None) a schedule; it takes precedence over
    FF_TPU_FAULT_SPEC."""
    global _INSTALLED
    _INSTALLED = schedule


def active_schedule() -> Optional[FaultSchedule]:
    """The installed schedule, else the FF_TPU_FAULT_SPEC one (parsed once
    per distinct spec string, so its fire-once state survives repeated
    lookups), else None."""
    global _ENV_CACHE
    if _INSTALLED is not None:
        return _INSTALLED
    spec = os.environ.get(FAULT_SPEC_ENV, "")
    if not spec:
        return None
    if _ENV_CACHE[0] != spec:
        _ENV_CACHE = (spec, FaultSchedule.parse(spec))
    return _ENV_CACHE[1]


# -- boundary hooks (the fit loops) -----------------------------------------


def fault_step() -> Optional[int]:
    v = os.environ.get(FAULT_STEP_ENV, "")
    return int(v) if v else None


def maybe_inject_fault(prev_step: int, step: int) -> None:
    """Raise SimulatedFault when [prev_step, step] crossed the configured
    fault step. The fit loops call it after each step or window, after the
    checkpoint hook, so a due checkpoint survives the fault."""
    n = fault_step()
    if n is not None and prev_step < n <= step:
        raise SimulatedFault(step)


def inject_hang_fault(
    schedule: Optional[FaultSchedule],
    prev_step: int,
    step: int,
    watchdog=None,
) -> None:
    """Site `hang` for the window that computed steps (prev_step, step].
    The fit loops call it inside the armed window, before disarming: a hung
    dispatch never reaches the boundary, so its checkpoint snapshot does
    not happen. Blocks in the watchdog's cooperative simulation and raises
    WindowHangError when the deadline fires."""
    if schedule is None:
        return
    for s in range(prev_step + 1, step + 1):
        if schedule.fire_once("hang", s):
            if watchdog is None:
                raise RuntimeError(
                    "fault site 'hang' fired but no watchdog is armed "
                    "(set watchdog_factor / FF_TPU_WATCHDOG so the hang "
                    "is detectable)"
                )
            watchdog.simulate_hang()  # raises WindowHangError


def inject_slow_fault(schedule: Optional[FaultSchedule], prev_step: int, step: int,
                      slow_ms: Optional[float] = None) -> float:
    """Soft site `slow` for the steps (prev_step, step]: sleep
    FF_TPU_FAULT_SLOW_MS (default 50) ms per firing step. The fit loops
    call it inside the step's timed region (after the dispatch, before the
    health readback), so the injected latency lands in the event stream's
    `wallclock_ms` as a throttled card's would: the drift monitor's
    signal, not a fault. Returns the ms slept."""
    if schedule is None:
        return 0.0
    import time

    if slow_ms is None:
        slow_ms = float(os.environ.get(SLOW_MS_ENV, "") or 50.0)
    slept = 0.0
    for s in range(prev_step + 1, step + 1):
        if schedule.fire_once("slow", s):
            time.sleep(slow_ms / 1000.0)
            slept += slow_ms
    return slept


def poison_nonfinite(schedule: Optional[FaultSchedule], step: int, arrays) -> bool:
    """Site `nonfinite` for `step`: where it fires, the first element of
    every floating array of `arrays` (numpy arrays or tensors, written in
    place) becomes NaN. Returns whether it fired."""
    if schedule is None or not schedule.fire_once("nonfinite", step):
        return False
    import numpy as np

    for a in arrays:
        if isinstance(a, np.ndarray):
            if np.issubdtype(a.dtype, np.floating):
                a.reshape(-1)[0] = np.nan
        elif a.is_floating_point():
            a.view(-1)[0] = float("nan")
    return True


def inject_kill_fault(schedule: Optional[FaultSchedule], prev_step: int, step: int) -> None:
    """Site `kill` at the boundary. Like maybe_inject_fault, it runs after
    the checkpoint hook, so a due snapshot is durable before the
    preemption propagates."""
    if schedule is None:
        return
    for s in range(prev_step + 1, step + 1):
        if schedule.fire_once("kill", s):
            raise SimulatedFault(s)


def inject_boundary_faults(
    schedule: Optional[FaultSchedule],
    prev_step: int,
    step: int,
    watchdog=None,
) -> None:
    """Both boundary sites in one call (hang, then kill), for a harness of
    its own; the fit loops call the two halves apart, the hang inside the
    armed window and the kill after the checkpoint hook."""
    inject_hang_fault(schedule, prev_step, step, watchdog=watchdog)
    inject_kill_fault(schedule, prev_step, step)


__all__ = [
    "FAULT_SITES",
    "FAULT_SPEC_ENV",
    "FAULT_STEP_ENV",
    "SLOW_MS_ENV",
    "SOFT_SITES",
    "FaultSchedule",
    "InjectedFault",
    "SimulatedFault",
    "active_schedule",
    "fault_step",
    "find_seed",
    "inject_boundary_faults",
    "inject_hang_fault",
    "inject_kill_fault",
    "inject_slow_fault",
    "install_schedule",
    "maybe_inject_fault",
    "poison_nonfinite",
]
