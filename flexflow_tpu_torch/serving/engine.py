"""The serving engine: request queue, continuous batching, supervision
(port of flexflow_tpu/serving/engine.py).

One engine drives one or more REPLICAS (each a ServingProgram with its own
KV cache and slot state) from a single FIFO request queue:

- **continuous batching** (default): at every decode-window boundary the
  engine evicts finished sequences and admits queued requests into the
  freed slots (one batched prefill per replica per boundary).
- **static batching** (the A/B baseline): a replica admits only when ALL
  of its slots are free, then runs the whole batch to completion.
- **admission control**: `max_concurrent` caps the sequences admitted per
  replica below its slot count (the cache is allocated at the full slot
  count regardless).
- **supervision**: a per-replica `WindowWatchdog` arms a deadline around
  each decode window whose step count it has seen before, and a shared
  `FaultChannel` surfaces background faults at window boundaries. A
  replica whose window hangs (or that a fault is posted for) SHEDS: it is
  marked unhealthy, its in-flight requests return to the front of the
  queue, and the remaining replicas keep serving. The seeded schedule
  (`FF_TPU_FAULT_SPEC`, site "hang") injects through
  `watchdog.simulate_hang`.
- **metrics**: one JSONL `serve_request` event per completed request
  (queue / prefill / decode ms, tokens, ms/token, SLO flag), plus
  `serve_hang` and `replica_shed` events and an SLO-violation counter.

The engine is cooperative (no scheduler thread): `run()` loops window
boundaries until the queue drains. Admission and eviction depend only on
queue order and slot state, so a seeded request trace replays
deterministically. Device results cross to the host once per prefill and
once per window, as explicit `.cpu().numpy()` copies.

**Over ranks** (programs lowered over a mesh of more than one rank), every
rank runs the same engine over the same requests, as every process of the
JAX package's multi-process runtime runs the same program: admission,
eviction and window lengths read only replicated values (tokens, lengths,
request sizes), so they agree by construction. The one decision taken
from a clock, the shed, is rank 0's: only rank 0 arms watchdogs (which
record a real hang rather than interrupt a window the other ranks are in)
and drains the fault channel, and it broadcasts at each window boundary
whether a fault is pending, before each window whether the injected hang
fires, and after it whether its watchdog fired
(runtime.distributed.broadcast_json), so every rank sheds the same replica
at the same window. Rank 0 alone writes the metrics events.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional

import numpy as np

from flexflow_tpu_torch.observability.metrics import (
    append_run_event,
    nearest_rank_percentile,
)
from flexflow_tpu_torch.runtime.fault import active_schedule
from flexflow_tpu_torch.runtime.supervisor import (
    BackgroundFault,
    FaultChannel,
    WindowHangError,
    WindowWatchdog,
)

__all__ = ["REQUEST_EVENT_FIELDS", "RequestRecord", "ServeRequest", "ServingEngine"]

# frozen field tuple of the per-request JSONL event (schema-stability test)
REQUEST_EVENT_FIELDS = (
    "rid",
    "replica",
    "queue_ms",
    "prefill_ms",
    "decode_ms",
    "total_ms",
    "tokens",
    "ms_per_token",
    "slo_ms_per_token",
    "slo_violated",
    "resubmitted",
)


@dataclass
class ServeRequest:
    """One inference request: a token-id prompt and a generation budget."""

    rid: str
    prompt: np.ndarray  # int32 [prompt_len]
    max_new_tokens: int
    slo_ms_per_token: Optional[float] = None


@dataclass
class RequestRecord:
    """Completion record of one request (what the JSONL event carries)."""

    rid: str
    replica: int
    queue_ms: float
    prefill_ms: float
    decode_ms: float
    tokens: List[int]
    slo_ms_per_token: Optional[float]
    resubmitted: int = 0

    @property
    def total_ms(self) -> float:
        return self.queue_ms + self.prefill_ms + self.decode_ms

    @property
    def ms_per_token(self) -> float:
        return self.total_ms / max(len(self.tokens), 1)

    @property
    def slo_violated(self) -> bool:
        return (
            self.slo_ms_per_token is not None
            and self.ms_per_token > self.slo_ms_per_token
        )

    def to_event(self) -> Dict[str, object]:
        return {
            "rid": self.rid,
            "replica": self.replica,
            "queue_ms": round(self.queue_ms, 3),
            "prefill_ms": round(self.prefill_ms, 3),
            "decode_ms": round(self.decode_ms, 3),
            "total_ms": round(self.total_ms, 3),
            "tokens": len(self.tokens),
            "ms_per_token": round(self.ms_per_token, 4),
            "slo_ms_per_token": self.slo_ms_per_token,
            "slo_violated": bool(self.slo_violated),
            "resubmitted": self.resubmitted,
        }


@dataclass
class _Slot:
    request: Optional[ServeRequest] = None
    generated: List[int] = field(default_factory=list)
    submit_t: float = 0.0
    admit_t: float = 0.0
    prefill_ms: float = 0.0
    resubmitted: int = 0


class _Replica:
    """One program + cache + slot state + (optional) watchdog. Slot
    arrays always match the program's slot count; `admission_cap` limits
    how many may be OCCUPIED."""

    def __init__(
        self, idx: int, program, admission_cap: int, watchdog=None
    ) -> None:
        n_slots = program.serving.max_concurrent_seqs
        self.idx = idx
        self.program = program
        self.cache = program.init_cache()
        self.slots = [_Slot() for _ in range(n_slots)]
        self.admission_cap = min(admission_cap, n_slots)
        self.lengths = np.zeros(n_slots, np.int32)
        self.token = np.zeros(n_slots, np.int32)
        self.watchdog = watchdog
        self.shed = False
        # step counts this replica has already run a window of: the first
        # window of a count is never timed (on the JAX package it holds the
        # compile; here the first launches of its shapes), so the watchdog
        # arms only on counts seen before
        self.seen_steps: set = set()

    def active_mask(self) -> np.ndarray:
        return np.array(
            [s.request is not None for s in self.slots], bool
        )

    def close(self) -> None:
        if self.watchdog is not None:
            self.watchdog.close()


class ServingEngine:
    """See module docstring. `programs` is one ServingProgram per replica
    (they may share parameters); `max_concurrent` caps admitted sequences
    per replica. The cache is allocated at the program's FULL slot count;
    the cap alone does not shrink it."""

    def __init__(
        self,
        programs,
        *,
        mode: str = "continuous",
        window_steps: int = 4,
        max_concurrent: Optional[int] = None,
        metrics_dir: Optional[str] = None,
        watchdog_factor: float = 0.0,
        watchdog_min_budget_ms: float = 1000.0,
    ) -> None:
        if not isinstance(programs, (list, tuple)):
            programs = [programs]
        if mode not in ("continuous", "static"):
            raise ValueError(f"mode must be 'continuous' or 'static', got {mode!r}")
        self.mode = mode
        self.window_steps = int(window_steps)
        self.watchdog_factor = watchdog_factor
        self.metrics_dir = metrics_dir
        self.clock = time.perf_counter
        self.channel = FaultChannel()
        self.schedule = active_schedule()
        self.queue: Deque[ServeRequest] = deque()
        self.completed: List[RequestRecord] = []
        self.slo_violations = 0
        self.replica_sheds = 0
        self.windows = 0
        self.max_observed_concurrent = 0
        self._t0 = self.clock()
        self._submit_t: Dict[str, float] = {}
        self._resubmits: Dict[str, int] = {}
        # programs over a mesh of several ranks: rank 0 takes the sheds
        self.ranked = any(getattr(p, "machine_mesh", None) is not None
                          and p.machine_mesh.world_size > 1 for p in programs)
        self.rank0 = True
        if self.ranked:
            import torch.distributed as dist

            self.rank0 = dist.get_rank() == 0
        self.replicas: List[_Replica] = []
        for i, program in enumerate(programs):
            cap = program.serving.max_concurrent_seqs
            if max_concurrent is not None:
                cap = min(cap, int(max_concurrent))
            if cap < 1:
                raise ValueError("max_concurrent is 0: no sequence may be admitted")
            watchdog = None
            if watchdog_factor > 0 and self.rank0:
                watchdog = WindowWatchdog(
                    watchdog_factor,
                    min_budget_ms=watchdog_min_budget_ms,
                    on_hang=self._on_hang,
                    interrupt=not self.ranked,
                )
            self.replicas.append(_Replica(i, program, cap, watchdog))

    # -- submission --------------------------------------------------------

    def submit(self, request: ServeRequest) -> None:
        cap = min(
            r.program.serving.max_seq_len for r in self.replicas
        )
        need = len(request.prompt) + request.max_new_tokens
        if need > cap:
            raise ValueError(
                f"request {request.rid!r} needs {need} cache positions "
                f"(prompt + max_new_tokens) but the program's max_seq_len is "
                f"{cap}, the cache positions allocated per slot"
            )
        self._submit_t.setdefault(request.rid, self.clock())
        self.queue.append(request)

    def _resubmit(self, request: ServeRequest) -> None:
        """A shed replica's in-flight request: back to the FRONT of the
        queue (it has waited longest), generation restarted from the
        prompt on a healthy replica."""
        self._resubmits[request.rid] = self._resubmits.get(request.rid, 0) + 1
        self.queue.appendleft(request)

    # -- supervision -------------------------------------------------------

    def _on_hang(self, diagnostic) -> None:
        self._emit_event("serve_hang", **diagnostic.to_dict())

    def _emit_event(self, kind: str, **payload) -> None:
        if self.metrics_dir is None or not self.rank0:
            return
        append_run_event(self.metrics_dir, kind, **payload)

    def _shed(self, replica: _Replica, reason: BaseException) -> None:
        replica.shed = True
        self.replica_sheds += 1
        requeued = []
        for slot in replica.slots:
            if slot.request is not None:
                requeued.append(slot.request.rid)
                self._resubmit(slot.request)
                slot.request = None
                slot.generated = []
        replica.close()
        self._emit_event(
            "replica_shed",
            replica=replica.idx,
            reason=f"{type(reason).__name__}: {reason}",
            requeued=requeued,
        )
        if not any(not r.shed for r in self.replicas):
            raise RuntimeError(
                "every serving replica has shed — no capacity left"
            ) from reason

    # -- the window loop ---------------------------------------------------

    def run(self, max_windows: int = 100000) -> List[RequestRecord]:
        """Drive window boundaries until the queue drains and every slot
        is idle. Returns (and accumulates) completion records."""
        done_before = len(self.completed)
        for _ in range(max_windows):
            if not self.queue and not any(
                r.active_mask().any() for r in self.replicas if not r.shed
            ):
                break
            self._window()
        return self.completed[done_before:]

    def _window(self) -> None:
        self.windows += 1
        for replica in self.replicas:
            if replica.shed:
                continue
            try:
                self._raise_pending_fault()
                self._evict_and_admit(replica)
                active_now = int(replica.active_mask().sum())
                self.max_observed_concurrent = max(
                    self.max_observed_concurrent, active_now
                )
                if active_now:
                    self._decode_window(replica)
            except (WindowHangError, BackgroundFault) as e:
                self._shed(replica, e)

    def _agree(self, decision: Dict[str, object]) -> Dict[str, object]:
        """Rank 0's `decision` on every rank (as it is, on one process)."""
        if not self.ranked:
            return decision
        from flexflow_tpu_torch.runtime.distributed import broadcast_json

        return broadcast_json(decision if self.rank0 else None)

    def _raise_pending_fault(self) -> None:
        """At a window boundary: raise the oldest pending background fault
        as a BackgroundFault (over ranks, rank 0's, on every rank)."""
        if not self.ranked:
            self.channel.raise_pending()
            return
        pending = self.channel.take() if self.rank0 else None
        fault = None if pending is None else [pending[0], f"{type(pending[1]).__name__}: "
                                              f"{pending[1]}"]
        fault = self._agree({"fault": fault})["fault"]
        if fault is not None:
            site, message = fault
            exc = pending[1] if pending is not None else RuntimeError(message)
            raise BackgroundFault(site, exc) from exc

    def _evict_and_admit(self, replica: _Replica) -> None:
        program = replica.program
        max_len = program.serving.max_seq_len
        for i, slot in enumerate(replica.slots):
            req = slot.request
            if req is None:
                continue
            if (
                len(slot.generated) >= req.max_new_tokens
                or replica.lengths[i] >= max_len
            ):
                self._complete(replica, i)
        if self.mode == "static" and any(
            s.request is not None for s in replica.slots
        ):
            return  # static batching: no admission until the batch drains
        occupied = sum(1 for s in replica.slots if s.request is not None)
        room = replica.admission_cap - occupied
        free = [
            i for i, s in enumerate(replica.slots) if s.request is None
        ][: max(room, 0)]
        if not free or not self.queue:
            return
        admitted = []
        now = self.clock()
        for i in free:
            if not self.queue:
                break
            req = self.queue.popleft()
            slot = replica.slots[i]
            slot.request = req
            slot.generated = []
            slot.submit_t = self._submit_t.get(req.rid, now)
            slot.admit_t = now
            slot.resubmitted = self._resubmits.get(req.rid, 0)
            admitted.append(i)
        if admitted:
            self._prefill(replica, admitted)

    def _prefill(self, replica: _Replica, admitted: List[int]) -> None:
        program = replica.program
        n_slots = len(replica.slots)
        prompt_cap = max(
            len(replica.slots[i].request.prompt) for i in admitted
        )
        tokens = np.zeros((n_slots, prompt_cap), np.int32)
        lengths = np.array(replica.lengths)
        fresh = np.zeros(n_slots, bool)
        for i in admitted:
            p = np.asarray(replica.slots[i].request.prompt, np.int32)
            tokens[i, : len(p)] = p
            lengths[i] = len(p)
            fresh[i] = True
        t0 = self.clock()
        cache, nxt, _ = program.prefill(
            replica.cache, tokens, lengths, fresh
        )
        replica.cache = cache
        nxt = nxt.cpu().numpy()
        prefill_ms = (self.clock() - t0) * 1000.0
        per_slot_ms = prefill_ms / max(len(admitted), 1)
        for i in admitted:
            replica.lengths[i] = lengths[i]
            replica.token[i] = nxt[i]
            slot = replica.slots[i]
            slot.generated = [int(nxt[i])]
            slot.prefill_ms = per_slot_ms

    def _decode_window(self, replica: _Replica) -> None:
        program = replica.program
        active = replica.active_mask()
        # clamp the window to the largest remaining token budget: when
        # every active slot needs fewer than window_steps tokens, the
        # surplus steps would be pure discarded work (at most window_steps
        # distinct step counts ever run)
        budgets = [
            s.request.max_new_tokens - len(s.generated)
            for s in replica.slots
            if s.request is not None
        ]
        steps = max(min(self.window_steps, max(budgets, default=0)), 1)
        wd = replica.watchdog
        first_window = steps not in replica.seen_steps
        replica.seen_steps.add(steps)
        # the injected-hang site (runtime/fault.py site "hang") fires
        # INSIDE an ARMED window; first windows of a count are unarmed, so
        # the site never consumes its firing there
        hang = (
            self.schedule is not None
            and not first_window
            and replica.watchdog is not None
            and replica.watchdog.budget_ms() is not None
            and self.schedule.fire_once("hang", self.windows)
        )
        if self.schedule is not None:
            hang = self._agree({"hang": bool(hang)})["hang"]
        if wd is not None and not first_window:
            wd.begin_window(self.windows, steps)
        try:
            if hang:
                if wd is None:  # rank 0 times the hang; the others shed with it
                    raise WindowHangError()
                wd.simulate_hang()
            cache, token, lengths, toks = program.decode_window(
                replica.cache,
                replica.token.copy(),
                replica.lengths.copy(),
                active,
                steps,
            )
            toks = toks.cpu().numpy()
        finally:
            if wd is not None and not first_window and not wd.fired:
                wd.end_window(self.windows)
        if (self.ranked and self.watchdog_factor > 0
                and self._agree({"fired": wd is not None and wd.fired})["fired"]):
            # a real hang rank 0's watchdog recorded: shed on every rank
            raise WindowHangError(wd.last_diagnostic if wd is not None else None)
        replica.cache = cache
        replica.token = token.cpu().numpy().astype(np.int32)
        replica.lengths = lengths.cpu().numpy().astype(np.int32)
        for i, slot in enumerate(replica.slots):
            if slot.request is None:
                continue
            budget = slot.request.max_new_tokens - len(slot.generated)
            slot.generated.extend(
                int(t) for t in toks[i, : max(min(budget, steps), 0)]
            )

    def _complete(self, replica: _Replica, slot_idx: int) -> None:
        slot = replica.slots[slot_idx]
        req = slot.request
        now = self.clock()
        record = RequestRecord(
            rid=req.rid,
            replica=replica.idx,
            queue_ms=(slot.admit_t - slot.submit_t) * 1000.0,
            prefill_ms=slot.prefill_ms,
            decode_ms=(now - slot.admit_t) * 1000.0 - slot.prefill_ms,
            tokens=list(slot.generated[: req.max_new_tokens]),
            slo_ms_per_token=req.slo_ms_per_token,
            resubmitted=slot.resubmitted,
        )
        self.completed.append(record)
        if record.slo_violated:
            self.slo_violations += 1
        self._emit_event("serve_request", **record.to_event())
        slot.request = None
        slot.generated = []
        replica.lengths[slot_idx] = 0

    # -- reporting ---------------------------------------------------------

    def summary(self) -> Dict[str, object]:
        elapsed_s = max(self.clock() - self._t0, 1e-9)
        mpt = sorted(r.ms_per_token for r in self.completed)

        def pct(p):
            # one repo-wide nearest-rank convention, shared with Histogram
            return nearest_rank_percentile(mpt, p)

        return {
            "mode": self.mode,
            "completed": len(self.completed),
            "windows": self.windows,
            "elapsed_s": elapsed_s,
            "sustained_requests_per_s": len(self.completed) / elapsed_s,
            "tokens_generated": sum(len(r.tokens) for r in self.completed),
            "p50_ms_per_token": pct(50),
            "p99_ms_per_token": pct(99),
            "slo_violations": self.slo_violations,
            "replica_sheds": self.replica_sheds,
            # per-replica sequences ever concurrently admitted
            "max_observed_concurrent": self.max_observed_concurrent,
        }

    def close(self) -> None:
        for r in self.replicas:
            r.close()
