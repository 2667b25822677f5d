"""Live plan-fidelity drift telemetry (port of
flexflow_tpu/observability/drift.py).

Every fidelity check of the plan (the plan audit, the search's estimates)
runs at compile time, while a run drifts: a throttled card, a batch that
grows, data-dependent costs. This module watches the live run:

- `WindowAggregator` buckets the per-step events the fit loop already
  emits (schema v1, `metrics.py`) into fixed windows of mean step
  wall-clock.
- `DriftDetector` compares each window against the searched winner's
  predicted cost (`search_provenance["estimated_ms"]`). The first healthy
  windows fit a *baseline* measured/predicted ratio, and drift is a
  departure from that baseline: the EMA-smoothed ratio leaving a band for
  N consecutive windows.
- On a trigger the monitor builds a `ReplanAdvisory` (cause, ratio
  trajectory, candidate plan, predicted savings), appended to
  `search_provenance["drift"]` and emitted as a versioned `drift` event
  into `events.jsonl`. Advisory only: nothing swaps the running plan. The
  candidate comes from the `repricer`, the warm re-search under
  `CostStore.live_scale`, which FFModel passes where the compile searched
  with a cost store; without one the advisory takes the arithmetic
  fallback, the recorded seed predictions scaled by the live correction.
  A searched compile's FFModel passes its transition verifier: each
  candidate gets the static TRN verdict for swapping the live plan onto
  it (analysis/transition_analysis.py), and a blocked one is recorded
  `swap_blocked`, never actionable.
- `DriftMonitor` runs the above as a daemon thread tailing `events.jsonl`
  via `tail_events`, supervised through the fit's `FaultChannel`: a crash
  posts to the channel and surfaces at the next window boundary as a
  `BackgroundFault`; no window ever waits on the monitor.

The detection core (`WindowAggregator`/`DriftDetector`/`feed`) is pure and
clock-free; only the `start()`ed thread polls wall-clock.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

from flexflow_tpu_torch.observability.metrics import (
    EVENT_SCHEMA_VERSION,
    append_run_event,
    tail_events,
)

DRIFT_SCHEMA_VERSION = 2  # v2: + transition verdict, actionable

# Every `drift` lifecycle event carries exactly these keys, in order
# (tests pin the set; bump DRIFT_SCHEMA_VERSION when it changes so
# consumers can dispatch).
DRIFT_EVENT_FIELDS = (
    "schema",               # events.jsonl EVENT_SCHEMA_VERSION
    "event",                # "drift"
    "drift_schema",         # DRIFT_SCHEMA_VERSION
    "cause",                # "slowdown" | "speedup" | "batch_growth"
    "step",                 # last step of the triggering window
    "window_ms",            # triggering window's mean step wall-clock
    "predicted_ms",         # searched winner's predicted step cost
    "ratio",                # window_ms / predicted_ms
    "ema_ratio",            # EMA-smoothed ratio at trigger
    "baseline_ratio",       # ratio fitted from the first healthy windows
    "drift",                # ema_ratio / baseline_ratio (the band test)
    "ratio_trajectory",     # recent window ratios, oldest first
    "band",                 # configured tolerance band
    "run_length",           # consecutive out-of-band windows required
    "candidate",            # cheapest re-priced plan's name
    "candidate_ms",         # its re-priced step ms
    "current_ms",           # the running plan's re-priced step ms
    "predicted_savings_ms",  # current_ms - candidate_ms (<= 0: keep plan)
    "repriced",             # True when the warm re-search ran
    "transition",           # static TRN verdict record for the candidate
    "actionable",           # savings > 0 AND the swap is not TRN-blocked
)


@dataclass
class WindowStat:
    """One completed aggregation window of per-step events."""

    index: int
    first_step: int
    last_step: int
    mean_ms: float
    mean_tokens_per_step: Optional[float]
    samples: int


class WindowAggregator:
    """Buckets per-step events (schema v1 dicts) into fixed windows of
    `window_steps` samples and yields each completed window's mean step
    wall-clock + mean tokens-per-step (the cause classifier's signal).

    Steps without a wall-clock are ignored; skipped/nonfinite steps still
    count — a run thrashing on skip_step IS slower, and the health layer
    already reports why."""

    def __init__(self, window_steps: int = 8) -> None:
        assert window_steps >= 1
        self.window_steps = int(window_steps)
        self.windows_completed = 0
        self._ms: List[float] = []
        self._tokens: List[float] = []
        self._first_step: Optional[int] = None
        self._last_step = 0

    def add(self, event: Dict[str, object]) -> Optional[WindowStat]:
        """Feed one step event; returns the completed WindowStat when this
        event closes a window, else None."""
        if "step" not in event:
            return None  # lifecycle event, not a step
        ms = event.get("wallclock_ms")
        if not isinstance(ms, (int, float)):
            return None
        step = int(event["step"])  # type: ignore[arg-type]
        if self._first_step is None:
            self._first_step = step
        self._last_step = step
        self._ms.append(float(ms))
        tps = event.get("tokens_per_s")
        if isinstance(tps, (int, float)):
            self._tokens.append(float(tps) * float(ms) / 1000.0)
        if len(self._ms) < self.window_steps:
            return None
        stat = WindowStat(
            index=self.windows_completed,
            first_step=self._first_step,
            last_step=self._last_step,
            mean_ms=sum(self._ms) / len(self._ms),
            mean_tokens_per_step=(
                sum(self._tokens) / len(self._tokens)
                if self._tokens
                else None
            ),
            samples=len(self._ms),
        )
        self.windows_completed += 1
        self._ms = []
        self._tokens = []
        self._first_step = None
        return stat


@dataclass
class ReplanAdvisory:
    """One drift trigger's structured verdict: what drifted, by how much,
    and what a warm re-search would run instead. Advisory only — the
    consumer decides whether to act (the hot-swap executor is the
    follow-up ROADMAP item)."""

    cause: str
    step: int
    window_ms: float
    predicted_ms: float
    ratio: float
    ema_ratio: float
    baseline_ratio: float
    drift: float
    ratio_trajectory: List[float]
    band: float
    run_length: int
    candidate: str
    candidate_ms: Optional[float]
    current_ms: Optional[float]
    predicted_savings_ms: Optional[float]
    repriced: bool
    # the static plan-transition verdict for `candidate`
    # (analysis/transition_analysis.py): a candidate the verifier
    # rejects is recorded `swap_blocked` and the advisory is NEVER
    # actionable
    transition: Optional[dict] = None
    actionable: bool = False
    seed_runtimes: Dict[str, float] = field(default_factory=dict)
    parallel_degrees: Optional[dict] = None
    research_seconds: Optional[float] = None

    def to_dict(self) -> dict:
        return {
            "drift_schema": DRIFT_SCHEMA_VERSION,
            "cause": self.cause,
            "step": int(self.step),
            "window_ms": round(float(self.window_ms), 4),
            "predicted_ms": round(float(self.predicted_ms), 4),
            "ratio": round(float(self.ratio), 4),
            "ema_ratio": round(float(self.ema_ratio), 4),
            "baseline_ratio": round(float(self.baseline_ratio), 4),
            "drift": round(float(self.drift), 4),
            "ratio_trajectory": [
                round(float(r), 4) for r in self.ratio_trajectory
            ],
            "band": float(self.band),
            "run_length": int(self.run_length),
            "candidate": self.candidate,
            "candidate_ms": (
                None if self.candidate_ms is None
                else round(float(self.candidate_ms), 4)
            ),
            "current_ms": (
                None if self.current_ms is None
                else round(float(self.current_ms), 4)
            ),
            "predicted_savings_ms": (
                None if self.predicted_savings_ms is None
                else round(float(self.predicted_savings_ms), 4)
            ),
            "repriced": bool(self.repriced),
            "transition": self.transition,
            "actionable": bool(self.actionable),
            "seed_runtimes": {
                k: round(float(v), 4)
                for k, v in sorted(self.seed_runtimes.items())
            },
            "parallel_degrees": self.parallel_degrees,
            "research_seconds": self.research_seconds,
        }

    def to_event(self) -> dict:
        """The frozen `drift` lifecycle-event payload (DRIFT_EVENT_FIELDS
        minus the outer schema/event keys append_run_event supplies)."""
        d = self.to_dict()
        return {k: d[k] for k in DRIFT_EVENT_FIELDS[2:]}


@dataclass
class _Trigger:
    """What the detector knew at trigger time (pre-repricing)."""

    cause: str
    window: WindowStat
    ratio: float
    ema_ratio: float
    baseline_ratio: float
    drift: float
    trajectory: List[float]


class DriftDetector:
    """Band + run-length drift detection over completed windows.

    Warmup windows (graph capture and first launches dominate the first) are discarded;
    the next `baseline_windows` fit the baseline measured/predicted ratio
    (their min — inflation-robust) — the live correction factor a
    compile-time prediction always needs on an emulated or throttled
    machine. After that, each window updates
    an EMA of the ratio; `drift = ema / baseline` outside
    [1/(1+band), 1+band] for `run_length` CONSECUTIVE windows triggers.
    A trigger re-arms only after `cooldown_windows` more windows, so one
    sustained drift produces one advisory, not one per window.

    Cause classification uses the tokens-per-step trend: when the work
    per step grew along with its wall-clock (>= half the drift excess),
    the cause is `batch_growth` — the plan is stale, not the machine;
    otherwise `slowdown`/`speedup` by direction.
    """

    def __init__(
        self,
        predicted_ms: float,
        band: float = 0.25,
        run_length: int = 3,
        ema_alpha: float = 0.5,
        warmup_windows: int = 1,
        baseline_windows: int = 2,
        cooldown_windows: int = 6,
        trajectory_len: int = 8,
    ) -> None:
        assert predicted_ms > 0, "drift needs a finite predicted step cost"
        assert band > 0 and run_length >= 1
        self.predicted_ms = float(predicted_ms)
        self.band = float(band)
        self.run_length = int(run_length)
        self.ema_alpha = float(ema_alpha)
        self.warmup_windows = int(warmup_windows)
        self.baseline_windows = max(1, int(baseline_windows))
        self.cooldown_windows = int(cooldown_windows)
        self.trajectory_len = int(trajectory_len)
        self.baseline_ratio: Optional[float] = None
        self.ema_ratio: Optional[float] = None
        self.windows_seen = 0
        self.out_of_band_run = 0
        self.triggers = 0
        self._baseline_acc: List[float] = []
        self._cooldown = 0
        self._trajectory: List[float] = []
        self._baseline_tokens: Optional[float] = None

    def observe(self, w: WindowStat) -> Optional[_Trigger]:
        """Feed one completed window; returns a _Trigger when the drift
        band/run-length condition fires. Pure and clock-free."""
        self.windows_seen += 1
        if self.windows_seen <= self.warmup_windows:
            return None
        ratio = w.mean_ms / self.predicted_ms
        self._trajectory.append(ratio)
        del self._trajectory[: -self.trajectory_len]
        if self.baseline_ratio is None:
            self._baseline_acc.append(ratio)
            if w.mean_tokens_per_step is not None:
                self._baseline_tokens = (
                    w.mean_tokens_per_step
                    if self._baseline_tokens is None
                    else (self._baseline_tokens + w.mean_tokens_per_step) / 2
                )
            if len(self._baseline_acc) >= self.baseline_windows:
                # min, not mean: capture and host contention only ever
                # INFLATE a window (the min-of-reps discipline), so the
                # smallest calibration ratio is the plan's healthy pace —
                # a mean poisoned by one compile-heavy window would make
                # every later healthy window read as a huge "speedup"
                self.baseline_ratio = min(self._baseline_acc)
                self.ema_ratio = self.baseline_ratio
            return None
        self.ema_ratio = (
            ratio
            if self.ema_ratio is None
            else (1 - self.ema_alpha) * self.ema_ratio
            + self.ema_alpha * ratio
        )
        if self._cooldown > 0:
            self._cooldown -= 1
            return None
        drift = self.ema_ratio / self.baseline_ratio
        if 1.0 / (1.0 + self.band) < drift < 1.0 + self.band:
            self.out_of_band_run = 0
            return None
        self.out_of_band_run += 1
        if self.out_of_band_run < self.run_length:
            return None
        self.out_of_band_run = 0
        self._cooldown = self.cooldown_windows
        self.triggers += 1
        trig = _Trigger(
            cause=self._classify(w, drift),
            window=w,
            ratio=ratio,
            ema_ratio=self.ema_ratio,
            baseline_ratio=self.baseline_ratio,
            drift=drift,
            trajectory=list(self._trajectory),
        )
        if trig.cause == "speedup":
            # the plan is beating its calibration, so the calibration was
            # pessimistic: advise once, then adopt the new pace — a stale
            # baseline would re-fire "speedup" every cooldown forever.
            # Both baseline AND ema re-anchor to the trigger window's raw
            # ratio (the EMA still lags the old pace; anchoring to it
            # leaves a gap a second phantom trigger can fall through).
            # Slowdowns deliberately do NOT re-anchor: persistent
            # degradation should keep re-advising until someone acts.
            self.baseline_ratio = self.ema_ratio = trig.ratio
        return trig

    def _classify(self, w: WindowStat, drift: float) -> str:
        if drift < 1.0:
            return "speedup"
        if (
            w.mean_tokens_per_step is not None
            and self._baseline_tokens not in (None, 0.0)
        ):
            tokens_growth = w.mean_tokens_per_step / self._baseline_tokens
            # the step got slower AND proportionally bigger: the workload
            # grew out from under the plan, the machine is fine
            if tokens_growth - 1.0 >= 0.5 * (drift - 1.0):
                return "batch_growth"
        return "slowdown"


class DriftMonitor:
    """Streaming drift monitor over a live metrics dir.

    `repricer(scale)` — injected by FFModel — re-runs the warm search
    with `CostStore.live_scale` set to the fitted live correction and
    returns {"estimated_ms", "seed_runtimes", "parallel_degrees",
    "research_seconds"}; with no repricer the advisory falls back to
    arithmetic re-pricing of the recorded seed table (uniform drift
    preserves the ranking, so the fallback's candidate is the plan the
    search already picked — still the honest answer for a uniform
    slowdown). Repricing failures degrade to the fallback and are posted
    to the fault channel; detection keeps running.

    Thread discipline: `poll_once()` is the entire work loop and is safe
    to call synchronously (tests, `close()`'s final drain); `start()`
    runs it on a daemon thread whose crash posts to `channel` under site
    "drift_monitor" — the fit loop's existing `raise_pending()` at window
    boundaries surfaces it, and nothing ever blocks on this thread except
    the bounded join in `close()`."""

    SITE = "drift_monitor"

    def __init__(
        self,
        metrics_dir: str,
        predicted_ms: float,
        *,
        seed_runtimes: Optional[Dict[str, float]] = None,
        band: float = 0.25,
        window_steps: int = 8,
        run_length: int = 3,
        ema_alpha: float = 0.5,
        warmup_windows: int = 1,
        baseline_windows: int = 2,
        cooldown_windows: int = 6,
        repricer: Optional[Callable[[float], dict]] = None,
        transition_verifier: Optional[
            Callable[[str], Optional[dict]]
        ] = None,
        channel=None,
        poll_interval_s: float = 0.25,
        emit_events: bool = True,
    ) -> None:
        self.metrics_dir = metrics_dir
        self.predicted_ms = float(predicted_ms)
        self.seed_runtimes = dict(seed_runtimes or {})
        self.repricer = repricer
        # candidate label -> transition verdict record dict:
        # the static TRN verification of swapping the RUNNING plan onto
        # the advised candidate. Same injection pattern as `repricer` —
        # FFModel installs it for searched plans; None degrades to
        # unverified advisories (transition=None, actionable judged on
        # savings alone)
        self.transition_verifier = transition_verifier
        self.transition_errors = 0
        self.channel = channel
        self.poll_interval_s = float(poll_interval_s)
        self.emit_events = bool(emit_events)
        self.aggregator = WindowAggregator(window_steps)
        self.detector = DriftDetector(
            predicted_ms,
            band=band,
            run_length=run_length,
            ema_alpha=ema_alpha,
            warmup_windows=warmup_windows,
            baseline_windows=baseline_windows,
            cooldown_windows=cooldown_windows,
        )
        self.advisories: List[ReplanAdvisory] = []
        self.reprice_errors = 0
        self._cursor = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- deterministic core -------------------------------------------------

    def feed(self, events) -> List[ReplanAdvisory]:
        """Run aggregation + detection + advisory construction over the
        given step events (no file, no clock — the unit-test surface and
        the body of poll_once)."""
        out = []
        for e in events:
            w = self.aggregator.add(e)
            if w is None:
                continue
            trig = self.detector.observe(w)
            if trig is None:
                continue
            adv = self._advise(trig)
            self.advisories.append(adv)
            out.append(adv)
            if self.emit_events:
                payload = adv.to_event()
                event = append_run_event(
                    self.metrics_dir, "drift", **payload
                )
                assert tuple(event) == DRIFT_EVENT_FIELDS, (
                    "drift event schema drifted — bump "
                    "DRIFT_SCHEMA_VERSION and update DRIFT_EVENT_FIELDS"
                )
                assert event["schema"] == EVENT_SCHEMA_VERSION
        return out

    def poll_once(self) -> List[ReplanAdvisory]:
        """Tail any new events since the last poll and process them."""
        events, self._cursor = tail_events(self.metrics_dir, self._cursor)
        return self.feed(events)

    def _advise(self, trig: _Trigger) -> ReplanAdvisory:
        # the live correction: what measured step-ms actually is relative
        # to the search's prediction, EMA-smoothed (uniform per-op-class
        # attribution — a whole-step scalar identifies nothing finer)
        scale = trig.ema_ratio
        repriced = False
        research_seconds = None
        parallel_degrees = None
        if self.repricer is not None:
            try:
                r = self.repricer(scale)
                current_ms = r["estimated_ms"]
                seeds = {
                    str(k): float(v)
                    for k, v in (r.get("seed_runtimes") or {}).items()
                    if v is not None
                }
                parallel_degrees = r.get("parallel_degrees")
                research_seconds = r.get("research_seconds")
                repriced = True
            except Exception as exc:  # degraded advisory, not a dead run
                self.reprice_errors += 1
                if self.channel is not None:
                    self.channel.post(self.SITE, exc)
                current_ms, seeds = None, {}
        else:
            current_ms, seeds = None, {}
        if current_ms is None:
            # arithmetic fallback: the recorded predictions scaled by the
            # live correction; ranking is preserved under a uniform scale
            current_ms = self.predicted_ms * scale
            seeds = {
                k: float(v) * scale
                for k, v in self.seed_runtimes.items()
                if v is not None
            }
        candidates = dict(seeds)
        candidates["searched"] = float(current_ms)
        best = min(candidates, key=lambda k: candidates[k])
        # the static swap verdict: an advisory whose candidate the
        # verifier rejects is recorded swap_blocked and is NEVER actionable
        transition = None
        if self.transition_verifier is not None:
            try:
                transition = self.transition_verifier(best)
            except Exception as exc:  # unverified advisory, not a dead run
                self.transition_errors += 1
                if self.channel is not None:
                    self.channel.post(self.SITE, exc)
        savings = float(current_ms) - candidates[best]
        actionable = savings > 0 and not (
            transition is not None
            and transition.get("verdict") != "swappable"
        )
        return ReplanAdvisory(
            cause=trig.cause,
            step=trig.window.last_step,
            window_ms=trig.window.mean_ms,
            predicted_ms=self.predicted_ms,
            ratio=trig.ratio,
            ema_ratio=trig.ema_ratio,
            baseline_ratio=trig.baseline_ratio,
            drift=trig.drift,
            ratio_trajectory=trig.trajectory,
            band=self.detector.band,
            run_length=self.detector.run_length,
            candidate=best,
            candidate_ms=candidates[best],
            current_ms=float(current_ms),
            predicted_savings_ms=float(current_ms) - candidates[best],
            repriced=repriced,
            transition=transition,
            actionable=actionable,
            seed_runtimes=candidates,
            parallel_degrees=parallel_degrees,
            research_seconds=research_seconds,
        )

    # -- supervised thread --------------------------------------------------

    def start(self) -> "DriftMonitor":
        assert self._thread is None, "monitor already started"
        self._thread = threading.Thread(
            target=self._run, name="ff-drift", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        try:
            while not self._stop.wait(self.poll_interval_s):
                self.poll_once()
        except Exception as exc:
            # the supervision contract: a dead monitor names itself on
            # the channel and surfaces at the next window boundary —
            # never silently, never by blocking a window
            if self.channel is not None:
                self.channel.post(self.SITE, exc)

    def close(self) -> None:
        """Stop the thread (bounded join — a wedged monitor cannot hang
        teardown) and drain whatever the stream still holds on the
        calling thread, so runs shorter than one poll interval still get
        their verdict."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        try:
            self.poll_once()
        except Exception as exc:
            if self.channel is not None:
                self.channel.post(self.SITE, exc)

    def report(self) -> dict:
        """The `search_provenance["drift"]` block."""
        return {
            "drift_schema": DRIFT_SCHEMA_VERSION,
            "predicted_ms": self.predicted_ms,
            "band": self.detector.band,
            "window_steps": self.aggregator.window_steps,
            "run_length": self.detector.run_length,
            "windows": self.detector.windows_seen,
            "baseline_ratio": self.detector.baseline_ratio,
            "ema_ratio": self.detector.ema_ratio,
            "advisories": [a.to_dict() for a in self.advisories],
            "reprice_errors": self.reprice_errors,
        }


__all__ = [
    "DRIFT_EVENT_FIELDS",
    "DRIFT_SCHEMA_VERSION",
    "DriftDetector",
    "DriftMonitor",
    "ReplanAdvisory",
    "WindowAggregator",
    "WindowStat",
]
