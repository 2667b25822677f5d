"""Host-side data loading (trimmed copy of flexflow_tpu/core/dataloader.py:
SingleDataLoader, BatchIterator and WindowedBatchIterator).

The full dataset lives in host memory and each batch is copied to the
device as it is drawn, where the JAX package `device_put`s it with the
input's sharding. Shuffling draws the same `np.random.RandomState(seed)`
permutation per epoch, so a shuffled run sees the JAX package's batches in
the JAX package's order. The per-step copy is a plain `torch.as_tensor`
from pageable memory, which blocks the host. The windowed iterator of the
fused step windows instead gathers on a producer thread into pinned
buffers and copies on a side stream. Over several ranks each rank is fed
only its own rows of every batch (`blocks`, from the trainer's
`feed_blocks`): the counterpart of the JAX package's device_put_global and
window sharding, `P(None, "data")`. A resumed fit repositions the
iterator with `advance_epochs` and `set_resume_skip` (the dataloader half of
runtime/checkpoint.py's ResumeState), drawing every permutation in full.
"""

from __future__ import annotations

import itertools
import queue
import threading
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from flexflow_tpu_torch.local_execution.training_backing import resolve_device
from flexflow_tpu_torch.runtime.supervisor import BackgroundFault


class SingleDataLoader:
    """Full-dataset host buffer -> per-batch device tensors for ONE tensor.

    device: the batches' device; None takes the model's, else CUDA (see
    resolve_device). rows: (start, stop) within each batch, the only rows
    drawn (one rank's block); None draws the whole batch."""

    def __init__(
        self,
        ffmodel,
        full_array: np.ndarray,
        batch_size: int,
        device=None,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
        rows: Optional[Tuple[int, int]] = None,
    ) -> None:
        self.ffmodel = ffmodel
        self.data = np.asarray(full_array)
        self.batch_size = int(batch_size)
        if device is None and ffmodel is not None:
            device = ffmodel.device
        self.device = resolve_device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.rows = rows
        self._rs = np.random.RandomState(seed)
        self.num_samples = self.data.shape[0]
        if drop_last:
            self.num_batches = self.num_samples // self.batch_size
        else:
            self.num_batches = -(-self.num_samples // self.batch_size)
        self.reset()

    def reset(self) -> None:
        self._next = 0
        self._order = np.arange(self.num_samples)
        if self.shuffle:
            self._rs.shuffle(self._order)

    def next_batch_host(self) -> np.ndarray:
        """Host array for the next batch (wraps around at epoch end)."""
        if self._next >= self.num_batches:
            self.reset()
        i = self._next * self.batch_size
        idx = self._order[i : i + self.batch_size]
        if self.rows is not None:
            idx = idx[self.rows[0]:self.rows[1]]
        self._next += 1
        return self.data[idx]

    def next_batch(self) -> torch.Tensor:
        """Device tensor for the next batch (wraps around at epoch end)."""
        return torch.as_tensor(self.next_batch_host(), device=self.device)

    def __iter__(self) -> Iterator[torch.Tensor]:
        self.reset()
        for _ in range(self.num_batches):
            yield self.next_batch()


class BatchIterator:
    """Zips named arrays into per-step (inputs_dict, label) batches on
    `device`; every tensor advances in lockstep, through one shared
    permutation per epoch. blocks: per input name, and for the label under
    `label_block`, the (start, stop) rows of each batch this rank draws
    (None: whole batches)."""

    def __init__(
        self,
        inputs: Dict[str, np.ndarray],
        label: Optional[np.ndarray],
        batch_size: int,
        device=None,
        shuffle: bool = False,
        seed: int = 0,
        blocks: Optional[Dict[str, Tuple[int, int]]] = None,
        label_block: Optional[Tuple[int, int]] = None,
    ) -> None:
        ns = {a.shape[0] for a in inputs.values()}
        if label is not None:
            ns.add(label.shape[0])
        if len(ns) != 1:
            raise ValueError(f"inconsistent sample counts: {ns}")
        self.num_samples = ns.pop()
        self.batch_size = int(batch_size)
        self.num_batches = self.num_samples // self.batch_size
        self.device = resolve_device(device)
        blocks = blocks or {}
        self.loaders = {
            k: SingleDataLoader(None, v, batch_size, device=self.device, seed=seed,
                                rows=blocks.get(k))
            for k, v in inputs.items()
        }
        self.label_loader = (
            SingleDataLoader(None, label, batch_size, device=self.device, rows=label_block)
            if label is not None
            else None
        )
        self.shuffle = shuffle
        self._rs = np.random.RandomState(seed)
        # one-shot mid-epoch resume cursor: the next epoch skips its first
        # _resume_skip batches
        self._resume_skip = 0

    def reset(self) -> None:
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rs.shuffle(order)
        self._order = order
        for dl in [*self.loaders.values(), self.label_loader]:
            if dl is not None:
                dl.reset()
                dl._order = order

    # -- deterministic resume (runtime/checkpoint.py ResumeState) ----------

    def advance_epochs(self, n: int) -> None:
        """Burn `n` completed epochs' permutations: the shared RandomState
        advances as `n` epochs would have advanced it, so a resumed run's
        epoch-`n` permutation is the uninterrupted run's."""
        for _ in range(int(n)):
            self.reset()

    def set_resume_skip(self, n: int) -> None:
        """Skip the first `n` batches of the next epoch (one shot). The
        epoch's permutation is drawn in full first, so the order stays that
        of a run that consumed those batches."""
        self._resume_skip = int(n)

    def _begin_epoch(self) -> int:
        self.reset()
        skip = min(self._resume_skip, self.num_batches)
        self._resume_skip = 0
        for dl in [*self.loaders.values(), self.label_loader]:
            if dl is not None:
                dl._next = skip
        return skip

    def __iter__(self):
        skip = self._begin_epoch()
        for _ in range(self.num_batches - skip):
            batch = {k: dl.next_batch() for k, dl in self.loaders.items()}
            label = self.label_loader.next_batch() if self.label_loader is not None else None
            yield batch, label

    def iter_rows(self) -> Iterator[np.ndarray]:
        """The row indices of each batch of one new epoch, in __iter__'s
        order, the resume skip included (the windowed iterator gathers
        them itself)."""
        skip = self._begin_epoch()
        b = self.batch_size
        for i in range(skip, self.num_batches):
            yield self._order[i * b:(i + 1) * b]


class _ProducerError:
    def __init__(self, exc: BaseException) -> None:
        self.exc = exc


_PRODUCER_DONE = object()
_LABEL = object()  # the label's key among a window's tensors


class HostWindow:
    """One window's host batches, gathered again from the dataset on
    demand: `batch(i)` is step i's (inputs by name, label or None), numpy,
    the `nonfinite` fault site's poison applied where it fired."""

    def __init__(self, windows: "WindowedBatchIterator", rows: List[np.ndarray],
                 poisoned: List[int]) -> None:
        self._sources, self._blocks = windows._sources, windows._rows
        self.rows, self.poisoned = rows, set(poisoned)

    def __len__(self) -> int:
        return len(self.rows)

    def batch(self, i: int):
        out = {}
        for name, src in self._sources.items():
            r, block = self.rows[i], self._blocks[name]
            a = np.take(src, r if block is None else r[block[0]:block[1]], axis=0, mode="clip")
            if i in self.poisoned and name is not _LABEL and np.issubdtype(a.dtype, np.floating):
                a.reshape(-1)[0] = np.nan
            out[name] = a
        return out, out.pop(_LABEL, None)


class WindowedBatchIterator:
    """Windows of `window` consecutive batches of a BatchIterator, stacked
    [k, ...] per tensor: the fused step window's input pipeline.

    One iteration is one epoch: the BatchIterator's batches in its order,
    grouped into windows; the epoch's tail (num_batches % window) comes out
    as one smaller window, so a window never spans a reshuffle. With
    `prefetch`, a producer thread builds window n+1 while the consumer
    trains on window n (a queue of one: one window in flight beyond the
    one executing).

    On a CUDA device the producer gathers a window's rows (np.take, which
    releases the interpreter lock) into one of two pinned host buffers,
    allocated at first use and reused for the iterator's life (one fit),
    and copies it to the card on a side stream, recording an event; the
    consumer's stream waits on that event before the window is used. On
    the CPU each window is gathered into a new array.

    Over several ranks the windows hold only the rank's rows of each batch
    (the BatchIterator's blocks: the JAX package's `window_sharding`,
    leading window dim whole, batch dim sharded). With `keep_host`,
    `host_window` is the window last yielded as a `HostWindow`, which
    gathers one step's host batch again on demand (the health localizer's
    replay input, wanted only when a step trips): a copy of every window
    would cost the producer a pass over its bytes. The producer
    records a `host_to_device` span (observability/trace.py) around each
    window's gather and copy, on its own thread's timeline row.

    Supervision: a producer that dies posts its exception to
    `fault_channel` (site `h2d_producer`), and the consumer raises it from
    there as a BackgroundFault. `step_base` is the global step of the first
    batch the next epoch yields (the fit loop sets it before each epoch):
    the fault schedule's `h2d` and `nonfinite` sites key on global steps,
    so one spec fires at the same data in a fresh and in a resumed run
    (`nonfinite` poisons the firing step's host inputs before the copy).

    Yields (inputs_stack, label_stack or None, k)."""

    def __init__(self, it: BatchIterator, window: int, prefetch: bool = True,
                 fault_channel=None, step_base: int = 0, keep_host: bool = False) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.it = it
        self.window = int(window)
        self.prefetch = prefetch
        self.keep_host = keep_host
        self.host_window: Optional[HostWindow] = None
        self.fault_channel = fault_channel
        self.step_base = int(step_base)
        self.device = it.device
        self._stop = threading.Event()
        self._queue: Optional[queue.Queue] = None
        self._thread: Optional[threading.Thread] = None
        self._sources = {name: dl.data for name, dl in it.loaders.items()}
        self._rows = {name: dl.rows for name, dl in it.loaders.items()}
        if it.label_loader is not None:
            self._sources[_LABEL] = it.label_loader.data
            self._rows[_LABEL] = it.label_loader.rows
        # CUDA only: the two pinned host buffers, the copy stream, and the
        # event of the last copy out of each buffer
        self._pinned: List[Dict[str, torch.Tensor]] = []
        self._stream = None
        self._copied: List[Optional[torch.cuda.Event]] = [None, None]

    def _host_window(self, slot: int, k: int) -> Dict[str, torch.Tensor]:
        """Host tensors [k, batch, ...] to gather a window into."""
        def b(name):
            rows = self._rows[name]
            return self.it.batch_size if rows is None else rows[1] - rows[0]

        if self.device.type != "cuda":
            return {name: torch.from_numpy(np.empty((k, b(name), *src.shape[1:]), src.dtype))
                    for name, src in self._sources.items()}
        if not self._pinned:
            self._pinned = [
                {name: torch.empty((self.window, b(name), *src.shape[1:]),
                                   dtype=torch.from_numpy(src[:0]).dtype, pin_memory=True)
                 for name, src in self._sources.items()}
                for _ in range(2)
            ]
        if self._copied[slot] is not None:
            self._copied[slot].synchronize()  # its last window has left it
        return {name: buf[:k] for name, buf in self._pinned[slot].items()}

    def _windows(self):
        """(stacks by name, the event the copy to the device recorded or
        None, k, the host copy or None) per window of one epoch."""
        from flexflow_tpu_torch.observability.trace import record_span
        from flexflow_tpu_torch.runtime.fault import (
            InjectedFault,
            active_schedule,
            poison_nonfinite,
        )

        schedule = active_schedule()
        rows_iter = self.it.iter_rows()
        slot = 0
        built = 0
        while not self._stop.is_set():
            rows = list(itertools.islice(rows_iter, self.window))
            if not rows:
                return
            k = len(rows)
            first = self.step_base + built + 1
            if schedule is not None:
                # the producer dies while building this window
                for step in range(first, first + k):
                    if schedule.fire_once("h2d", step):
                        raise InjectedFault("h2d", step)
            built += k
            with record_span("host_to_device", steps=k):
                host = self._host_window(slot, k)
                for name, src in self._sources.items():
                    out = host[name].numpy()
                    block = self._rows[name]
                    for j, r in enumerate(rows):
                        if block is not None:
                            r = r[block[0]:block[1]]
                        np.take(src, r, axis=0, out=out[j], mode="clip")
                poisoned = []
                if schedule is not None:
                    inputs = [host[name].numpy() for name in self._sources if name is not _LABEL]
                    poisoned = [j for j in range(k)
                                if poison_nonfinite(schedule, first + j, [a[j] for a in inputs])]
                kept = HostWindow(self, rows, poisoned) if self.keep_host else None
                if self.device.type != "cuda":
                    stacks, event = host, None
                else:
                    if self._stream is None:
                        self._stream = torch.cuda.Stream(self.device)
                    with torch.cuda.stream(self._stream):
                        stacks = {name: t.to(self.device, non_blocking=True)
                                  for name, t in host.items()}
                        event = torch.cuda.Event()
                        event.record(self._stream)
                    self._copied[slot] = event
                    slot ^= 1
            yield stacks, event, k, kept

    def _ready(self, item):
        """The consumer's side of a window: its stream waits for the copy,
        and the copy's memory is kept until that stream is done with it."""
        stacks, event, k, kept = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for t in stacks.values():
                t.record_stream(stream)
        label = stacks.pop(_LABEL, None)
        if kept is not None:
            self.host_window = kept
        return stacks, label, k

    def _producer(self) -> None:
        try:
            for item in self._windows():
                while not self._stop.is_set():
                    try:
                        self._queue.put(item, timeout=0.05)
                        break
                    except queue.Full:
                        continue
                if self._stop.is_set():
                    return
            self._queue.put(_PRODUCER_DONE)
        except BaseException as e:  # surfaces in the consumer
            # the channel first (it survives a full queue and a gone
            # consumer), then the queue, so a waiting consumer wakes now
            if self.fault_channel is not None:
                self.fault_channel.post("h2d_producer", e)
            try:
                self._queue.put(_ProducerError(e), timeout=5.0)
            except queue.Full:
                pass  # the consumer is gone or stalled; the channel has it

    def __iter__(self):
        self._stop.clear()
        if not self.prefetch:
            for item in self._windows():
                yield self._ready(item)
            return
        self._queue = queue.Queue(maxsize=1)
        t = self._thread = threading.Thread(
            target=self._producer, name="ff-input-pipeline", daemon=True)
        t.start()
        try:
            while True:
                try:
                    item = self._queue.get(timeout=0.5)
                except queue.Empty:
                    # a producer that died without posting (a hard kill, an
                    # error while building the error item) would leave this
                    # get() waiting forever
                    if not t.is_alive():
                        if self.fault_channel is not None:
                            self.fault_channel.raise_pending(site="h2d_producer")
                        raise BackgroundFault("h2d_producer", RuntimeError(
                            "input-pipeline producer thread died without posting a result"))
                    continue
                if item is _PRODUCER_DONE:
                    return
                if isinstance(item, _ProducerError):
                    if self.fault_channel is not None:
                        self.fault_channel.raise_pending(site="h2d_producer")
                    raise item.exc
                yield self._ready(item)
        finally:
            self.close()

    def close(self) -> None:
        """Unblock and retire the producer (on an early exit of the
        consumer, or at the epoch's end)."""
        self._stop.set()
        q = self._queue
        if q is not None:
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        t = self._thread
        if t is not None and t is not threading.current_thread():
            t.join(timeout=5.0)
