"""Measured machine constants for the search cost models (port of
flexflow_tpu/compiler/calibration.py).

The reference search never consumes hand-set constants: the legacy
Simulator caches cudaEvent measurements per op
(lib/runtime/src/simulator.h:161-228). This module probes the machine the
port runs on for

  - compute roofline: effective matmul FLOP/s (bf16 through torch.matmul on
    the card: a calibration input, not a kernel of the port),
  - memory roofline: effective elementwise bytes/s,
  - over several ranks, the collective constants: all-reduce time against
    participant count and payload, fitted to
    time(k, bytes) = lat(k) + bytes / gbps(k); the fraction of an
    all-reduce hidden behind an independent matmul (`overlap`); and the
    speedup of compute sharded over the ranks (`shard_speedup`),

each timed with CUDA events on the card (kernels/profiling.py). They feed
the estimators in place of datasheet numbers: the two rates the roofline,
the all-reduce constants the parallel ops' prices, `overlap` the search's
overlap fraction, `shard_speedup` the emulated-mesh scaling
(machine_mapping/cost_estimator.py).

Over ranks `calibrate(num_devices=N)` is a collective call on all N ranks
of the default process group: rank 0 times the two rates alone (the
others wait, so ranks sharing a card do not halve it), each rank times
its own collective probes, the all-reduce probe of k participants runs on
the subgroup of the first k ranks, and rank 0's result reaches every
rank, so all hold one equal MachineCalibration. Ranks that share one card
(over gloo, which stages every collective through host memory) measure
gloo and that card: such a calibration is no NVLink or NCCL figure.

The links between cards of a planned node that no rank runs on cannot be
timed: the machine spec takes the datasheet figures below. Calibrations
are memoized per (backend, device count) (`get_calibration`).
"""

from __future__ import annotations

import math
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels.profiling import ProfilingSettings, profile_eager, profile_fn
from flexflow_tpu_torch.local_execution.training_backing import resolve_device

# Datasheet figures, not measurements (GB/s per GPU and direction):
# NVLink 4 on the H100 SXM (900 GB/s bidirectional per GPU), and one
# 400 Gb/s NDR InfiniBand port per GPU between nodes.
H100_NVLINK_GBPS = 450.0
NDR_INFINIBAND_GBPS = 50.0

_CACHE: Dict[Tuple[str, int], "MachineCalibration"] = {}


@dataclass(frozen=True)
class CollectiveConstants:
    """Fitted all-reduce constants for one participant count."""

    lat_ms: float
    gbps: float  # effective all-reduce bandwidth (payload bytes / time)


@dataclass(frozen=True)
class MachineCalibration:
    backend: str
    num_devices: int
    peak_flops: float  # measured matmul FLOP/s
    hbm_gbps: float  # measured elementwise GB/s
    # all-reduce constants by participant count (empty for one device)
    allreduce: Dict[int, CollectiveConstants] = field(default_factory=dict)
    # the fraction of the shorter of an all-reduce and an independent
    # matmul hidden behind the longer, run together ((t_mm + t_ar -
    # t_both) / min(t_mm, t_ar), clamped to [0, 1]); None for one device
    overlap: Optional[float] = None
    # t(matmul of the whole work on one rank) / t(the work split over the
    # ranks, run at once): ~k on k cards, ~1 for ranks sharing one card;
    # None for one device
    shard_speedup: Optional[float] = None

    def allreduce_constants(self, k: int) -> Optional[CollectiveConstants]:
        """Constants for a k-participant all-reduce: the measured entry, or
        the nearest measured counts' with the bandwidth interpolated
        log-log between them (the JAX package's rule)."""
        if not self.allreduce or k <= 1:
            return None
        if k in self.allreduce:
            return self.allreduce[k]
        ks = sorted(self.allreduce)
        lo = max((m for m in ks if m < k), default=ks[0])
        hi = min((m for m in ks if m > k), default=ks[-1])
        a, b = self.allreduce[lo], self.allreduce[hi]
        if lo == hi:
            return a
        t = (math.log(k) - math.log(lo)) / (math.log(hi) - math.log(lo))
        gbps = math.exp((1 - t) * math.log(max(a.gbps, 1e-9)) + t * math.log(max(b.gbps, 1e-9)))
        return CollectiveConstants((1 - t) * a.lat_ms + t * b.lat_ms, gbps)

    def as_dict(self) -> dict:
        return {
            "backend": self.backend,
            "num_devices": self.num_devices,
            "peak_flops": self.peak_flops,
            "hbm_gbps": round(self.hbm_gbps, 3),
            "allreduce": {str(k): {"lat_ms": round(c.lat_ms, 4), "gbps": round(c.gbps, 4)}
                          for k, c in sorted(self.allreduce.items())},
            "overlap_measured": None if self.overlap is None else round(self.overlap, 4),
            "shard_speedup_measured": (None if self.shard_speedup is None
                                       else round(self.shard_speedup, 3)),
        }


def rank_inversions(pairs, tie_band: float = 0.05) -> dict:
    """Rank quality of (estimated, measured) pairs: does the cost model
    order plans the way the machine does? A pair whose estimates are
    within the tie band is reported as a tie, not an inversion."""
    inversions = ties = 0
    for i in range(len(pairs)):
        for j in range(i + 1, len(pairs)):
            e1, m1 = pairs[i]
            e2, m2 = pairs[j]
            if abs(e1 - e2) <= tie_band * max(e1, e2):
                ties += 1
            elif (e1 - e2) * (m1 - m2) < 0:
                inversions += 1
    return {
        "count": inversions,
        "tied_pairs": ties,
        "tie_band": tie_band,
        "pairs_compared": len(pairs) * (len(pairs) - 1) // 2,
        "measured_scale": "ranking-only",
    }


def fit_allreduce(small: int, large: int, t_small: float, t_large: float) -> CollectiveConstants:
    """Latency and bandwidth from the times of two payloads (bytes, ms):
    the slope between them, or where noise makes it no positive slope, the
    large payload's time alone."""
    slope = (t_large - t_small) / (large - small)  # ms per byte
    if slope <= 0:
        slope = t_large / large
    return CollectiveConstants(max(0.0, t_small - slope * small), 1e-6 / slope)


def _compute_size(device: torch.device) -> Tuple[int, torch.dtype]:
    return (512, torch.float32) if device.type == "cpu" else (2048, torch.bfloat16)


def _measure_compute(settings: ProfilingSettings, device: torch.device) -> float:
    """Effective matmul FLOP/s of the device: bf16 at 8192^3 on the card,
    f32 at 512^3 on the CPU."""
    on_cpu = device.type == "cpu"
    n = 512 if on_cpu else 8192
    dtype = torch.float32 if on_cpu else torch.bfloat16
    a = torch.ones((n, n), dtype=dtype, device=device)
    b = torch.ones((n, n), dtype=dtype, device=device)
    out = torch.empty((n, n), dtype=dtype, device=device)
    ms = profile_fn(lambda a, b: torch.matmul(a, b, out=out), settings, a, b)
    return 2 * n**3 / (ms / 1000.0)


def _measure_hbm(settings: ProfilingSettings, device: torch.device) -> float:
    """Effective elementwise GB/s of the device (one read + one write of
    f32: 1 GiB each way on the card, far past its L2; 8 MiB on the CPU)."""
    n = (8 if device.type == "cpu" else 1024) * 1024 * 1024 // 4
    x = torch.ones((n,), dtype=torch.float32, device=device)
    y = torch.empty_like(x)
    ms = profile_fn(lambda x: torch.mul(x, 1.0001, out=y), settings, x)
    return 2 * n * 4 / (ms / 1000.0) / 1e9


def _agree(value: float, device: torch.device) -> float:
    """The largest of every rank's `value`, on every rank (so that the
    ranks take one decision)."""
    t = torch.tensor([value], dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return float(t.item())


def _measure_allreduce(group, payload_bytes: int, settings, device) -> float:
    """ms of one all-reduce of payload_bytes of f32 over `group` (every
    member calls it): the least of three timings, since contention (ranks
    sharing a host or a card) only ever adds time."""
    x = torch.ones(max(1, payload_bytes // 4), dtype=torch.float32, device=device)
    return min(profile_eager(lambda: dist.all_reduce(x, group=group), settings, device)
               for _ in range(3))


def _measure_overlap(payload_bytes: int, settings, device) -> Optional[float]:
    """The concurrency of compute and a collective on the default group: an
    async all-reduce of payload_bytes run beside an independent matmul on
    the compute stream, the matmul grown (by powers of two, up to 4096)
    until it takes as long as the all-reduce alone; (t_mm + t_ar - t_both)
    / min(t_mm, t_ar), clamped to [0, 1]."""
    size, dtype = _compute_size(device)
    w = torch.ones(max(1, payload_bytes // 4), dtype=torch.float32, device=device)

    def timed(fn):
        return min(profile_eager(fn, settings, device) for _ in range(3))

    def both(a):
        work = dist.all_reduce(w, async_op=True)
        a @ a
        work.wait()

    t_ar = _agree(timed(lambda: dist.all_reduce(w)), device)
    n = 256
    a = torch.ones((n, n), dtype=dtype, device=device)
    t_mm = _agree(timed(lambda: a @ a), device)
    while t_mm < t_ar and n < 4096:
        n *= 2
        a = torch.ones((n, n), dtype=dtype, device=device)
        t_mm = _agree(timed(lambda: a @ a), device)
    t_both = timed(lambda: both(a))
    shorter = min(t_mm, t_ar)
    if shorter <= 0:
        return None
    return max(0.0, min(1.0, (t_mm + t_ar - t_both) / shorter))


def _measure_shard_speedup(settings, device) -> Optional[float]:
    """t(rank 0 multiplies the whole [k, n, n] @ [n, n] batch) / t(each of
    the k ranks multiplies its [1, n, n] piece, all at once), each the wall
    time between two barriers of the group, per call: the machine's real
    speedup for compute sharded over the ranks, clamped to [1, k]."""
    k = dist.get_world_size()
    size, dtype = _compute_size(device)
    a = torch.ones((k, size, size), dtype=dtype, device=device)
    w = torch.ones((size, size), dtype=dtype, device=device)
    iters = max(settings.measure_iters, 1)

    def wall(fn) -> float:
        fn()  # warm-up
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        best = float("inf")
        for _ in range(3):
            dist.barrier()
            start = time.perf_counter()
            for _ in range(iters):
                fn()
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            dist.barrier()
            best = min(best, (time.perf_counter() - start) * 1e3 / iters)
        return best

    rank = dist.get_rank()
    t_serial = wall(lambda: a @ w if rank == 0 else None)
    t_sharded = wall(lambda: a[rank:rank + 1] @ w)
    if t_sharded <= 0:
        return None
    return max(1.0, min(float(k), t_serial / t_sharded))


def calibrate(device=None, num_devices: int = 1,
              payloads: Tuple[int, int] = (1 << 20, 8 << 20)) -> MachineCalibration:
    """Measure the machine: the device's matmul FLOP/s and memory GB/s, and
    with num_devices > 1 the collective constants, overlap and shard
    speedup over the ranks of the default process group, which must have
    num_devices ranks, every one of them calling this (see the module
    docstring). On the card unless the caller names another device
    (without a card this raises unless device="cpu")."""
    device = resolve_device(device)
    n = int(num_devices)
    if n > 1:
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"calibrate(num_devices={n}) is a collective call on the {n} ranks of the "
                "default process group: open it first (runtime.distributed.initialize or "
                "parallel.init_file_group)")
        if dist.get_world_size() != n:
            raise ValueError(f"calibrate(num_devices={n}) on a process group of "
                             f"{dist.get_world_size()} ranks")
    settings = ProfilingSettings(warmup_iters=1, measure_iters=4)
    rank = dist.get_rank() if n > 1 else 0
    peak_flops = hbm_gbps = 0.0  # rank 0's reach every rank
    if n > 1:  # nothing of another rank still runs on a shared card while rank 0 times
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()
    if rank == 0:
        peak_flops = _measure_compute(settings, device)
        hbm_gbps = _measure_hbm(settings, device)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if n == 1:
        return MachineCalibration(device.type, 1, peak_flops, hbm_gbps)
    dist.barrier()
    counts = sorted({2, n} | {k for k in (4,) if 2 < k < n and n % k == 0})
    # every rank opens every subgroup, in one order
    groups = {k: None if k == n else dist.new_group(list(range(k))) for k in counts}
    allreduce: Dict[int, CollectiveConstants] = {}
    small, large = payloads
    for k in counts:
        if rank < k:
            t_s = _measure_allreduce(groups[k], small, settings, device)
            t_l = _measure_allreduce(groups[k], large, settings, device)
            allreduce[k] = fit_allreduce(small, large, t_s, t_l)
        dist.barrier()
    overlap = _measure_overlap(large, settings, device)
    shard_speedup = _measure_shard_speedup(settings, device)
    box = [MachineCalibration(f"{device.type}/{dist.get_backend()}", n, peak_flops, hbm_gbps,
                              allreduce, overlap, shard_speedup)]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def get_calibration(device=None, num_devices: Optional[int] = None) -> MachineCalibration:
    """The process's calibration of this machine, measured at the first
    call for each (backend, device count); over several ranks a collective
    call, as calibrate. num_devices: default the default group's size."""
    device = resolve_device(device)
    if num_devices is None:
        num_devices = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    backend = device.type if num_devices == 1 else f"{device.type}/{dist.get_backend()}"
    key = (backend, int(num_devices))
    if key not in _CACHE:
        _CACHE[key] = calibrate(device, num_devices)
    return _CACHE[key]
