"""Run-health telemetry: the step statistics, the metrics registry and the
JSONL event stream (port of flexflow_tpu/observability/metrics.py).

The step statistics are the JAX package's: the gradient and parameter
global norms, the update-to-parameter ratio and the finiteness flag the
health policies key off. The JAX package computes them inside its jitted
step; here they are torch reductions on the device, enqueued after the
update (and captured with it in a fused window's CUDA graph), each norm
accumulated in f32. Nothing of them reads the device back: the host pays
one readback a step (a window, under steps_per_dispatch) and only when an
event log or a health monitor is installed.

The port's optimizer updates in place, where the JAX package's returns new
arrays and keeps the old ones. `finalize_step` therefore snapshots what the
step writes before the update (the parameters for the update ratio, and
under the skip_step / raise guard the optimizer's slots and step count as
well) and, under the guard, puts the snapshot back where the step went
non-finite (`guard_nonfinite`: torch.where on the device, in place).

Events go to `<metrics_dir>/events.jsonl`, one JSON object a line, with
the JAX package's frozen STEP_EVENT_FIELDS and EVENT_SCHEMA_VERSION, so
either package's reader reads the other's stream.
"""

from __future__ import annotations

import json
import math
import os
import threading
from typing import Callable, Dict, List, Optional, Sequence

import torch

# ---------------------------------------------------------------------------
# step event schema
# ---------------------------------------------------------------------------

EVENT_SCHEMA_VERSION = 1

# Every step event carries exactly these keys (the JAX package's; bump
# EVENT_SCHEMA_VERSION when it changes so consumers can dispatch).
STEP_EVENT_FIELDS = (
    "schema",          # EVENT_SCHEMA_VERSION
    "step",            # global step index (FFModel._step_count)
    "loss",            # scalar training loss (may be non-finite)
    "wallclock_ms",    # host wall-clock of this step incl. dispatch+sync
    "tokens_per_s",    # label elements per second at this step's wallclock
    "grad_norm",       # global L2 norm over all parameter gradients
    "param_norm",      # global L2 norm over all parameters (post-update)
    "update_ratio",    # ||param_new - param_old|| / (||param_old|| + eps)
    "skipped",         # True when the skip_step policy dropped the update
    "nonfinite",       # True when loss or grad_norm was non-finite
)

# ---------------------------------------------------------------------------
# step statistics (on the device)
# ---------------------------------------------------------------------------


def square_sums(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """[n] f32: each tensor's sum of squares, accumulated in f32."""
    tensors = list(tensors)
    if not tensors:
        return torch.zeros(0, dtype=torch.float32)
    norms = torch._foreach_norm([t.float() if t.dtype != torch.float32 else t for t in tensors])
    return torch.stack(norms).float().square()


def global_norm(tensors) -> torch.Tensor:
    """Global L2 norm over a dict or a list of tensors (sum of per-tensor
    square sums, sqrt once), in f32."""
    values = list(tensors.values()) if isinstance(tensors, dict) else list(tensors)
    if not values:
        return torch.zeros((), dtype=torch.float32)
    return square_sums(values).sum().sqrt()


def update_square_sums(new_params: Dict[str, torch.Tensor],
                       old_params: Dict[str, torch.Tensor]) -> torch.Tensor:
    """[n] f32: each parameter's sum of squares of (new - old), in f32, one
    parameter's difference at a time."""
    out = [torch.linalg.vector_norm(torch.sub(new_params[k].float(), old_params[k].float()))
           .square() for k in new_params]
    if not out:
        return torch.zeros(0, dtype=torch.float32)
    return torch.stack(out)


# reduce(keys, parts [4, n]) -> [4]: the global sums of each statistic's
# per-parameter parts (the parallel trainers' sum over the ranks' pieces)
PartsReducer = Callable[[List[str], torch.Tensor], torch.Tensor]


def step_statistics(old_params, new_params, grads, loss,
                    reduce: Optional[PartsReducer] = None) -> Dict[str, torch.Tensor]:
    """The per-step health scalars, on the device: gradient and parameter
    global norms, update-to-param ratio, and the finiteness flag the
    health policies key off. `reduce` sums the per-parameter parts over
    the ranks that hold different pieces (None: the parameters here are
    whole). Returns a dict of 0-d tensors."""
    keys = list(new_params)
    parts = torch.stack([
        square_sums([grads[k] for k in keys]),
        square_sums([new_params[k] for k in keys]),
        update_square_sums(new_params, old_params),
        square_sums([old_params[k] for k in keys]),
    ]) if keys else torch.zeros((4, 0), dtype=torch.float32, device=loss.device)
    sums = parts.sum(dim=1) if reduce is None else reduce(keys, parts)
    grad_norm, param_norm, update_norm, old_norm = sums.sqrt().unbind(0)
    update_ratio = update_norm / (old_norm + 1e-12)
    # param_norm is over the POST-update params: an optimizer-math overflow
    # (finite grads, non-finite update) must trip `ok` too, or the guard
    # would commit the poisoned params and stall a skip_step run for good
    ok = (torch.isfinite(loss.float()) & torch.isfinite(grad_norm)
          & torch.isfinite(param_norm))
    return {"grad_norm": grad_norm, "param_norm": param_norm,
            "update_ratio": update_ratio, "ok": ok}


def state_tensors(params, opt_state=None) -> List[torch.Tensor]:
    """Every tensor an update writes in place: the parameters, then the
    optimizer's slots and its step count (in key order)."""
    out = list(params.values())
    for key in sorted(opt_state or {}):
        v = opt_state[key]
        out.extend(v.values() if isinstance(v, dict) else [v])
    return out


def guard_nonfinite(ok: torch.Tensor, tensors: Sequence[torch.Tensor],
                    old: Sequence[torch.Tensor]) -> None:
    """Keep `old` wherever the step went non-finite (the skip_step / raise
    policies: a NaN update must never reach the parameters): each tensor
    takes where(ok, itself, its old value), in place, on the device."""
    for t, o in zip(tensors, old):
        torch.where(ok, t, o, out=t)


def finalize_step(collect: bool, guard: bool, params, opt_state, grads, loss,
                  update: Callable[[], None], live: Optional[torch.Tensor] = None,
                  reduce: Optional[PartsReducer] = None):
    """The shared tail of every trainer's step (ModelTrainingInstance and
    the parallel trainers, one definition): run `update()` (the in-place
    optimizer step) and, when collecting, compute the step statistics
    around it; under the skip_step / raise guard, put back the pre-step
    parameters and optimizer state where the step went non-finite, or
    where `live` (a fused window's not-yet-halted flag) is false. Returns
    the stats dict or None.

    guard implies collect (the guard needs the `ok` flag)."""
    collect = collect or guard
    if not collect:
        update()
        return None
    with torch.no_grad():
        old_params = {k: p.clone() for k, p in params.items()}
        written = state_tensors(params, opt_state) if guard else []
        saved = ([*old_params.values(), *(t.clone() for t in written[len(params):])]
                 if guard else [])
        update()
        stats = step_statistics(old_params, params, grads, loss, reduce)
        if guard:
            commit = stats["ok"] if live is None else stats["ok"] & live
            guard_nonfinite(commit, written, saved)
    return stats


def stack_stats(per_step: Sequence[Optional[Dict[str, torch.Tensor]]]):
    """{name: [k]} stacks of a window's per-step stats (None when the
    window carried none)."""
    if not per_step or per_step[0] is None:
        return None
    return {name: torch.stack([s[name] for s in per_step]) for name in per_step[0]}


def split_window_stats(stat_stacks, k: int) -> List[Optional[Dict[str, object]]]:
    """Per-step stat dicts from a fused window's stacked stat vectors (the
    window is read back in one transfer; this reshapes {name: [k]} into k
    per-step {name: scalar} dicts so the event log and health monitor keep
    their per-step contract). Returns [None]*k when the window carried no
    stats."""
    if stat_stacks is None:
        return [None] * k
    return [{name: vec[i] for name, vec in stat_stacks.items()} for i in range(k)]


def stats_to_host(stats):
    """A stats dict (or {name: [k]} stacks) read back in one transfer:
    the values packed into one f32 vector on the device, copied once, and
    unpacked on the host (`ok` as bool)."""
    if stats is None:
        return None
    names = list(stats)
    packed = torch.stack([stats[n].float() for n in names]).cpu()
    out = {}
    for n, v in zip(names, packed):
        v = v.numpy()
        out[n] = v.astype(bool) if n == "ok" else v
    return out


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class Counter:
    """Monotonic event count (steps, skipped steps, nonfinite trips)."""

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-observed scalar (current loss, current grad norm)."""

    def __init__(self) -> None:
        self.value: Optional[float] = None

    def set(self, v: float) -> None:
        self.value = float(v)


def nearest_rank_percentile(sorted_samples, q: float) -> Optional[float]:
    """Nearest-rank percentile over pre-sorted samples: ceil(q/100 * n) - 1
    (the JAX package's one percentile convention)."""
    n = len(sorted_samples)
    if not n:
        return None
    return sorted_samples[min(n - 1, max(math.ceil(q / 100.0 * n) - 1, 0))]


class Histogram:
    """Streaming scalar distribution: count/sum/min/max + reservoir for
    percentile summaries (bounded memory over long runs)."""

    def __init__(self, reservoir: int = 512) -> None:
        self.count = 0
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._reservoir_size = reservoir
        self._samples: List[float] = []

    def observe(self, v: float) -> None:
        import random

        v = float(v)
        self.count += 1
        self.sum += v
        self.min = v if self.min is None else min(self.min, v)
        self.max = v if self.max is None else max(self.max, v)
        if len(self._samples) < self._reservoir_size:
            self._samples.append(v)
        else:
            # reservoir sampling keeps a uniform sample of the stream
            j = random.randrange(self.count)
            if j < self._reservoir_size:
                self._samples[j] = v

    def percentile(self, q: float) -> Optional[float]:
        return nearest_rank_percentile(sorted(self._samples), q)

    def summary(self) -> Dict[str, Optional[float]]:
        return {
            "count": self.count,
            "sum": self.sum,
            "mean": self.sum / self.count if self.count else None,
            "min": self.min,
            "max": self.max,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
        }


class MetricsRegistry:
    """Named counters/gauges/histograms with a JSON-serializable snapshot.
    Get-or-create semantics so emitters never coordinate registration."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        with self._lock:
            return self.counters.setdefault(name, Counter())

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            return self.gauges.setdefault(name, Gauge())

    def histogram(self, name: str) -> Histogram:
        with self._lock:
            return self.histograms.setdefault(name, Histogram())

    def snapshot(self) -> Dict[str, object]:
        with self._lock:
            return {
                "counters": {k: c.value for k, c in self.counters.items()},
                "gauges": {k: g.value for k, g in self.gauges.items()},
                "histograms": {k: h.summary() for k, h in self.histograms.items()},
            }


# ---------------------------------------------------------------------------
# step event log
# ---------------------------------------------------------------------------


def _scalar(v) -> Optional[float]:
    """Host float of a tensor/np scalar; None stays None."""
    if v is None:
        return None
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


def _json_safe(f):
    """Non-finite floats serialize as their repr ("nan"/"inf"/"-inf"):
    JSON has no literal for them, and they are what the log records."""
    if isinstance(f, float) and not math.isfinite(f):
        return repr(f)
    return f


class StepEventLog:
    """Append-only JSONL step event stream under `metrics_dir`.

    One `emit()` per training step; the registry keeps run-level aggregates
    (steps/skipped/nonfinite counters, loss/grad-norm histograms) which
    `close()` writes as `<metrics_dir>/metrics.json` next to the events."""

    def __init__(self, metrics_dir: str, registry: Optional[MetricsRegistry] = None) -> None:
        os.makedirs(metrics_dir, exist_ok=True)
        self.metrics_dir = metrics_dir
        self.path = os.path.join(metrics_dir, "events.jsonl")
        self.registry = registry or MetricsRegistry()
        self._f = open(self.path, "a")

    def emit(
        self,
        step: int,
        loss,
        wallclock_ms: float,
        tokens_per_s: Optional[float] = None,
        grad_norm=None,
        param_norm=None,
        update_ratio=None,
        skipped: bool = False,
        nonfinite: bool = False,
    ) -> Dict[str, object]:
        event = {
            "schema": EVENT_SCHEMA_VERSION,
            "step": int(step),
            "loss": _scalar(loss),
            "wallclock_ms": _scalar(wallclock_ms),
            "tokens_per_s": _scalar(tokens_per_s),
            "grad_norm": _scalar(grad_norm),
            "param_norm": _scalar(param_norm),
            "update_ratio": _scalar(update_ratio),
            "skipped": bool(skipped),
            "nonfinite": bool(nonfinite),
        }
        assert tuple(event) == STEP_EVENT_FIELDS
        reg = self.registry
        reg.counter("steps_total").inc()
        if skipped:
            reg.counter("steps_skipped").inc()
        if nonfinite:
            reg.counter("nonfinite_steps").inc()
        if event["loss"] is not None and math.isfinite(event["loss"]):
            reg.gauge("loss").set(event["loss"])
            reg.histogram("loss").observe(event["loss"])
        if event["grad_norm"] is not None and math.isfinite(event["grad_norm"]):
            reg.gauge("grad_norm").set(event["grad_norm"])
            reg.histogram("grad_norm").observe(event["grad_norm"])
        if event["wallclock_ms"] is not None:
            reg.histogram("step_ms").observe(event["wallclock_ms"])
        self._f.write(json.dumps({k: _json_safe(v) for k, v in event.items()}) + "\n")
        self._f.flush()  # tail-able while the run is live
        return event

    def close(self) -> None:
        if self._f.closed:
            return
        self._f.close()
        with open(os.path.join(self.metrics_dir, "metrics.json"), "w") as f:
            json.dump(self.registry.snapshot(), f, indent=2)


def read_events(metrics_dir: str) -> List[Dict[str, object]]:
    """Parse `<metrics_dir>/events.jsonl`."""
    path = os.path.join(metrics_dir, "events.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def tail_events(metrics_dir: str, cursor: int = 0) -> "tuple[List[Dict[str, object]], int]":
    """Incremental read of `<metrics_dir>/events.jsonl`: the events
    appended at or after byte offset `cursor`, and the next cursor. A
    trailing line with no newline yet (a write in flight) is left for the
    next call; a complete line that fails to parse is skipped; a missing
    file is an empty stream."""
    path = os.path.join(metrics_dir, "events.jsonl")
    events: List[Dict[str, object]] = []
    try:
        # idle polls are the common case for a live monitor: one stat
        if cursor and os.stat(path).st_size == cursor:
            return events, cursor
        f = open(path, "rb")
    except OSError:
        return events, cursor
    with f:
        f.seek(0, os.SEEK_END)
        size = f.tell()
        if cursor > size:  # stream was truncated/rotated: start over
            cursor = 0
        f.seek(cursor)
        buf = f.read()
    next_cursor = cursor
    for raw in buf.split(b"\n"):
        if next_cursor + len(raw) >= cursor + len(buf):
            break  # no trailing newline: torn write, leave for next call
        next_cursor += len(raw) + 1
        line = raw.strip()
        if not line:
            continue
        try:
            events.append(json.loads(line.decode("utf-8")))
        except (ValueError, UnicodeDecodeError):
            continue  # corrupt but complete line: skip, don't wedge
    return events, next_cursor


def append_run_event(metrics_dir: str, kind: str, **payload) -> Dict[str, object]:
    """Append one run event of `kind` to `<metrics_dir>/events.jsonl`,
    marked by an `event` key instead of `step`."""
    os.makedirs(metrics_dir, exist_ok=True)
    event = {"schema": EVENT_SCHEMA_VERSION, "event": str(kind), **payload}
    with open(os.path.join(metrics_dir, "events.jsonl"), "a") as f:
        f.write(json.dumps(event) + "\n")
    return event


def read_run_events(metrics_dir: str, kind: Optional[str] = None) -> List[Dict[str, object]]:
    """The run events of a metrics stream (optionally one kind)."""
    return [e for e in read_events(metrics_dir)
            if "event" in e and (kind is None or e["event"] == kind)]


def _sanitize_doc(obj):
    """Recursively JSON-safe copy: non-finite floats become their repr
    strings, unknown objects their str."""
    if isinstance(obj, dict):
        return {str(k): _sanitize_doc(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize_doc(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return repr(obj)
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    return str(obj)


def write_provenance(metrics_dir: str, doc: Dict[str, object]) -> str:
    """Snapshot the model's `search_provenance` beside the event stream as
    `<metrics_dir>/provenance.json` (atomic replace)."""
    os.makedirs(metrics_dir, exist_ok=True)
    path = os.path.join(metrics_dir, "provenance.json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(_sanitize_doc(doc), f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return path


def read_provenance(metrics_dir: str) -> Optional[Dict[str, object]]:
    """The provenance snapshot of a metrics dir, or None when the run never
    wrote one."""
    try:
        with open(os.path.join(metrics_dir, "provenance.json")) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None
