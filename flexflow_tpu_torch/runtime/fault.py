"""Seeded fault schedules (trimmed copy of flexflow_tpu/runtime/fault.py).

`FF_TPU_FAULT_SPEC` names a seeded schedule of faults at named sites, e.g.::

    FF_TPU_FAULT_SPEC="seed=7;sites=hang;rate=0.05"

Each (site, step) decision is a pure hash of (seed, site, step), the JAX
package's own, so the same spec fires at the same steps in both packages,
in every process, every run. The serving engine consults site `hang` at
each armed decode window: the window blocks like a hung dispatch until the
watchdog deadline fires (`runtime.supervisor.WindowWatchdog.simulate_hang`).
"""

from __future__ import annotations

import os
import zlib
from typing import FrozenSet, List, Optional, Set, Tuple

FAULT_SPEC_ENV = "FF_TPU_FAULT_SPEC"

#: The injectable fault sites and the soft perturbation sites, as in the
#: JAX package (a spec naming any other site is refused).
FAULT_SITES = ("ckpt_write", "h2d", "nonfinite", "hang", "kill")
SOFT_SITES = ("slow",)


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
