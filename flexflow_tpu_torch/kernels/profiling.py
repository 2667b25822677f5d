"""Measured timing harness (copy of flexflow_tpu/kernels/profiling.py;
reference lib/kernels/include/kernels/profiling.h:10-49, cudaEvent timing
with warm-up and measured iterations).

On the card: `warmup_iters` calls on a side stream, one more call captured
into a CUDA graph, then one pair of CUDA events around `measure_iters`
replays of it, giving ms per call of device time. The graph is what keeps
the host out of the number: timed eagerly, a small op's call measures how
fast Python launches its kernels (and that moves with the host's state),
where the JAX package times a compiled program and cancels its fixed
dispatch latency. On the CPU: the JAX package's two-point host timing (the
slope between a short and a long run).

`profile_eager` times a call that no CUDA graph can hold (a collective
that gloo stages through host memory) eagerly: one pair of CUDA events
around `measure_iters` calls on the card, the two-point host timing on the
CPU.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Iterable

import torch


@dataclass(frozen=True)
class ProfilingSettings:
    """reference: profiling_settings.struct.toml."""

    warmup_iters: int = 2
    measure_iters: int = 5


def _tensors(xs) -> Iterable[torch.Tensor]:
    for x in xs:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, (list, tuple)):
            yield from _tensors(x)


def _on_cuda(args) -> bool:
    return any(t.is_cuda for t in _tensors(args))


def force_sync(out) -> None:
    """Wait for the work that produces `out` (tensors, nested in lists,
    tuples or dicts): synchronize each CUDA device among them; CPU tensors
    are ready when they exist."""
    def leaves(x):
        if isinstance(x, dict):
            x = list(x.values())
        if isinstance(x, (list, tuple)):
            for v in x:
                yield from leaves(v)
        elif isinstance(x, torch.Tensor):
            yield x

    devices = {t.device for t in leaves(out) if t.is_cuda}
    for d in devices:
        torch.cuda.synchronize(d)


def _timed_run(fn, iters, args, kwargs) -> float:
    start = time.perf_counter()
    for _ in range(iters):
        fn(*args, **kwargs)
    return time.perf_counter() - start


def _event_ms(run, iters: int) -> float:
    """Milliseconds per call of run() over `iters` calls, between a pair of
    CUDA events on the card."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _host_ms(fn, settings: ProfilingSettings, args, kwargs) -> float:
    """Milliseconds per call of fn(*args, **kwargs) after the warm-up, from
    the two-point host timing (the slope between a short and a long run)."""
    for _ in range(settings.warmup_iters):
        fn(*args, **kwargs)
    n1 = max(1, settings.measure_iters // 4)
    n2 = max(n1 + 1, settings.measure_iters)
    t1 = _timed_run(fn, n1, args, kwargs)
    t2 = _timed_run(fn, n2, args, kwargs)
    per_iter = (t2 - t1) / (n2 - n1)
    if per_iter <= 0:
        per_iter = t2 / n2  # noisy fallback
    return per_iter * 1000.0


def profile_eager(fn: Callable, settings: ProfilingSettings, device) -> float:
    """Milliseconds per call of fn() after the warm-up, run eagerly (see the
    module docstring); `device` is where its work runs."""
    if torch.device(device).type != "cuda":
        return _host_ms(fn, settings, (), {})
    for _ in range(settings.warmup_iters):
        fn()
    return _event_ms(fn, max(settings.measure_iters, 1))


def profile_fn(fn: Callable, settings: ProfilingSettings, *args, **kwargs) -> float:
    """Milliseconds per call of fn(*args, **kwargs) after the warm-up; on
    the card fn must be capturable into a CUDA graph (no host reads)."""
    if not _on_cuda(args):
        return _host_ms(fn, settings, args, kwargs)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(settings.warmup_iters):
            fn(*args, **kwargs)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn(*args, **kwargs)
    return _event_ms(graph.replay, max(settings.measure_iters, 1))
