"""Search-phase attribution: where the search's wall-clock goes (copy of
flexflow_tpu/observability/search_phases.py without its trace spans; the
port's trace recorder is A9).

The search installs a per-search accumulator (collect_search_phases), and
the hot call sites mark their work with
search_phase("tree_build" | "dp" | "leaf_cost" | "match" | "seed_build"),
which the search telemetry reports as `phase_ms`.

Phases NEST (leaf_cost runs inside dp, both inside an evaluation): each
name accumulates independently, so phase_ms is per-phase attribution, not
a partition of wall time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Iterator, Optional

_ACTIVE: Optional[Dict[str, float]] = None


@contextlib.contextmanager
def collect_search_phases() -> Iterator[Dict[str, float]]:
    """Install a fresh phase accumulator for the body; yields the dict the
    enclosed search_phase calls accumulate into (name -> milliseconds)."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = acc = {}
    try:
        yield acc
    finally:
        _ACTIVE = prev


@contextlib.contextmanager
def search_phase(name: str):
    """Attribute the body to `name` in the active collector (if any)."""
    acc = _ACTIVE
    if acc is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        acc[name] = acc.get(name, 0.0) + (time.perf_counter() - t0) * 1000.0
