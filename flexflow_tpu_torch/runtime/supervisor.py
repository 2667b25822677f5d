"""Window supervision: the fault channel and the window watchdog (copy of
flexflow_tpu/runtime/supervisor.py).

- `FaultChannel`: the mailbox background threads (the async checkpoint
  writer, the windowed input pipeline's producer) post their exceptions
  into; the fit loop and the serving engine drain it at every window
  boundary, so a background failure surfaces within one window as a
  `BackgroundFault` naming its site.
- `WindowWatchdog`: a monitor thread arming a deadline around each fit
  step or window and each decode window. The budget is max(min_budget_ms,
  estimate x factor), the estimate an EMA of completed windows; until one
  window has completed there is no deadline. On expiry it records a
  `HangDiagnostic`, hands it to `on_hang`, and raises `WindowHangError` on
  the watched thread: cooperatively when the hang is the injected one
  (`simulate_hang`), otherwise best-effort through
  `PyThreadState_SetAsyncExc`.
- `FitSupervision`: one fit call's bundle of the two and the active fault
  schedule.

Pure Python threads: nothing here touches a device.
"""

from __future__ import annotations

import sys
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple


class BackgroundFault(RuntimeError):
    """The exception a background thread died with, re-raised on the
    training or serving thread with the fault site named (`original`,
    `__cause__`)."""

    def __init__(self, site: str, original: BaseException) -> None:
        super().__init__(
            f"background thread fault at site {site!r}: "
            f"{type(original).__name__}: {original}"
        )
        self.site = site
        self.original = original


class FaultChannel:
    """Thread-safe mailbox from background threads to the window loop:
    `post(site, exc)` from any thread, `raise_pending()` at a boundary.
    `history` keeps a repr of everything ever posted."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pending: deque = deque()
        self.history: List[Tuple[str, str]] = []

    def post(self, site: str, exc: BaseException) -> None:
        with self._lock:
            self._pending.append((site, exc))
            self.history.append((site, f"{type(exc).__name__}: {exc}"))

    def pending(self, site: Optional[str] = None) -> int:
        with self._lock:
            if site is None:
                return len(self._pending)
            return sum(1 for s, _ in self._pending if s == site)

    def take(self) -> Optional[Tuple[str, BaseException]]:
        """The oldest pending (site, exception), removed; None when nothing
        is pending."""
        with self._lock:
            return self._pending.popleft() if self._pending else None

    def raise_pending(self, site: Optional[str] = None) -> None:
        """Raise the oldest pending fault (optionally only from `site`) as
        a BackgroundFault; no-op when nothing is pending."""
        with self._lock:
            found = None
            for i, (s, exc) in enumerate(self._pending):
                if site is None or s == site:
                    found = (i, s, exc)
                    break
            if found is None:
                return
            i, s, exc = found
            del self._pending[i]
        raise BackgroundFault(s, exc) from exc


@dataclass
class HangDiagnostic:
    """What the watchdog knew when the deadline expired."""

    last_completed_step: int
    window_base_step: int
    window_steps: int
    budget_ms: float
    elapsed_ms: float
    device_kind: str
    trace_spans: List[str] = field(default_factory=list)
    thread_name: str = ""

    def to_dict(self) -> dict:
        return {
            "last_completed_step": int(self.last_completed_step),
            "window_base_step": int(self.window_base_step),
            "window_steps": int(self.window_steps),
            "budget_ms": round(float(self.budget_ms), 3),
            "elapsed_ms": round(float(self.elapsed_ms), 3),
            "device_kind": self.device_kind,
            "trace_spans": list(self.trace_spans),
            "thread_name": self.thread_name,
        }


class WindowHangError(RuntimeError):
    """A window exceeded its watchdog budget. `diagnostic` is the
    HangDiagnostic recorded at expiry (None when the error was injected
    asynchronously: read `watchdog.last_diagnostic` then)."""

    def __init__(self, diagnostic: Optional[HangDiagnostic] = None) -> None:
        if diagnostic is None:
            msg = "dispatch window exceeded its watchdog budget"
        else:
            msg = (
                "dispatch window exceeded its watchdog budget: window at "
                f"step {diagnostic.window_base_step} (+{diagnostic.window_steps} steps) "
                f"ran {diagnostic.elapsed_ms:.0f} ms against a "
                f"{diagnostic.budget_ms:.0f} ms budget "
                f"(last completed step {diagnostic.last_completed_step})"
            )
        super().__init__(msg)
        self.diagnostic = diagnostic


def _async_raise(tid: int, exc_type) -> None:
    """Best-effort asynchronous exception into thread `tid` (CPython only),
    raised at the thread's next bytecode boundary."""
    import ctypes

    set_exc = ctypes.pythonapi.PyThreadState_SetAsyncExc
    res = set_exc(ctypes.c_ulong(tid), ctypes.py_object(exc_type))
    if res > 1:  # multiple threads affected: undo (stale id)
        set_exc(ctypes.c_ulong(tid), None)


_POLL_S = 0.02  # the monitor thread's wake-up interval while a deadline is armed
_EMA_ALPHA = 0.3  # weight of the newest window in the rolling estimate


def _device_kind() -> str:
    import torch

    return torch.cuda.get_device_name(0) if torch.cuda.is_available() else "cpu"


class WindowWatchdog:
    """Deadline monitor around windows.

    `begin_window(step, k)` arms a deadline of max(min_budget_ms,
    estimate_ms * factor); `end_window(step)` disarms and feeds the
    estimate. Until the first armed window completes there is no estimate
    and therefore no deadline. It fires at most once.
    """

    def __init__(
        self,
        factor: float,
        min_budget_ms: float = 1000.0,
        on_hang: Optional[Callable[[HangDiagnostic], None]] = None,
        interrupt: bool = True,
    ) -> None:
        """interrupt: raise WindowHangError into the watched thread when a
        real hang fires; without it the firing is only recorded (`fired`),
        for a caller that must end the window in step with other ranks."""
        if not factor > 0:
            raise ValueError("watchdog factor must be positive (0 = disabled)")
        self.factor = float(factor)
        self.min_budget_ms = float(min_budget_ms)
        self.on_hang = on_hang
        self.interrupt = interrupt
        self.estimate_ms: Optional[float] = None
        self.last_diagnostic: Optional[HangDiagnostic] = None
        self.fired = False
        self._cv = threading.Condition()
        self._cancel = threading.Event()
        self._closed = False
        self._deadline: Optional[float] = None
        self._t0: Optional[float] = None
        self._budget_ms: Optional[float] = None
        self._window: Tuple[int, int] = (0, 0)
        self._last_step = 0
        self._watched_tid: Optional[int] = None
        self._watched_name = ""
        self._cooperative = False
        self._thread = threading.Thread(target=self._run, name="ff-watchdog", daemon=True)
        self._thread.start()

    def budget_ms(self) -> Optional[float]:
        """The budget the NEXT window would get (None until the rolling
        estimate exists)."""
        if self.estimate_ms is None:
            return None
        return max(self.min_budget_ms, self.estimate_ms * self.factor)

    def begin_window(self, base_step: int, steps: int = 1) -> None:
        """Arm around the window whose first step is `base_step`; the
        calling thread becomes the watched thread."""
        with self._cv:
            self._window = (int(base_step), int(steps))
            self._watched_tid = threading.get_ident()
            self._watched_name = threading.current_thread().name
            self._t0 = time.monotonic()
            b = self.budget_ms()
            self._budget_ms = b
            self._deadline = None if b is None else self._t0 + b / 1000.0
            self._cv.notify_all()

    def end_window(self, completed_step: int) -> None:
        """Disarm and feed the rolling estimate with the completed window's
        wall-clock (skipped after a fire)."""
        with self._cv:
            if self._t0 is not None and not self.fired:
                dur = (time.monotonic() - self._t0) * 1000.0
                self.estimate_ms = (
                    dur
                    if self.estimate_ms is None
                    else (1 - _EMA_ALPHA) * self.estimate_ms + _EMA_ALPHA * dur
                )
            self._last_step = int(completed_step)
            self._deadline = None
            self._t0 = None
            self._cv.notify_all()

    def simulate_hang(self) -> None:
        """The injected hang (fault site "hang"): block the calling thread
        until the watchdog deadline fires, then raise WindowHangError with
        the diagnostic. Requires an armed deadline."""
        with self._cv:
            if self._deadline is None:
                raise RuntimeError(
                    "simulated hang requires an armed watchdog deadline "
                    "(schedule the hang after at least one completed window)"
                )
            self._cooperative = True
        try:
            self._cancel.wait()
        finally:
            with self._cv:
                self._cooperative = False
        raise WindowHangError(self.last_diagnostic)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._deadline = None
            self._cv.notify_all()
        self._thread.join(timeout=5.0)

    def _run(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                deadline = None if self.fired else self._deadline
                now = time.monotonic()
                if deadline is not None and now >= deadline:
                    self._fire_locked(now)
                    continue
                if deadline is None:
                    self._cv.wait()
                else:
                    self._cv.wait(min(_POLL_S, max(deadline - now, 0.0)))

    @staticmethod
    def _live_spans(tid: int) -> List[str]:
        """The watched thread's open trace spans, outermost first (what it
        was doing when the deadline fired), from the active recorder."""
        try:
            from flexflow_tpu_torch.observability.trace import active_recorder

            rec = active_recorder()
            return [] if rec is None else rec.open_span_names(tid)
        except Exception:
            return []

    def _fire_locked(self, now: float) -> None:
        """Build and publish the diagnostic (called with self._cv held)."""
        self.fired = True
        base, steps = self._window
        tid = self._watched_tid
        try:
            device_kind = _device_kind()
        except Exception:
            device_kind = "unknown"
        diag = HangDiagnostic(
            last_completed_step=self._last_step,
            window_base_step=base,
            window_steps=steps,
            budget_ms=self._budget_ms or 0.0,
            elapsed_ms=(now - (self._t0 or now)) * 1000.0,
            device_kind=device_kind,
            trace_spans=self._live_spans(tid) if tid is not None else [],
            thread_name=self._watched_name,
        )
        self.last_diagnostic = diag
        cooperative = self._cooperative
        if self.on_hang is not None:
            try:
                self.on_hang(diag)
            except Exception:
                import traceback

                traceback.print_exc(file=sys.stderr)
        print(f"[flexflow_tpu_torch] watchdog: {WindowHangError(diag)}", file=sys.stderr)
        self._cancel.set()
        if not cooperative and tid is not None and self.interrupt:
            _async_raise(tid, WindowHangError)


@dataclass
class FitSupervision:
    """One fit call's supervision bundle: the shared fault channel, the
    watchdog (None unless a factor is configured) and the active seeded
    fault schedule (None unless FF_TPU_FAULT_SPEC or install_schedule set
    one)."""

    channel: FaultChannel
    watchdog: Optional[WindowWatchdog] = None
    schedule: Optional[object] = None  # runtime.fault.FaultSchedule

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.close()


__all__ = [
    "BackgroundFault",
    "FaultChannel",
    "FitSupervision",
    "HangDiagnostic",
    "WindowHangError",
    "WindowWatchdog",
]
