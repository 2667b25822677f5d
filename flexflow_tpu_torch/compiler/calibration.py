"""Measured machine constants for the search cost models (the single-device
part of flexflow_tpu/compiler/calibration.py).

The reference search never consumes hand-set compute constants: the legacy
Simulator caches cudaEvent measurements per op
(lib/runtime/src/simulator.h:161-228). This module probes the card for the
two rates the analytic estimator's roofline needs:

  - compute roofline: effective bf16 matmul FLOP/s (cuBLAS through
    torch.matmul: a calibration input, not a kernel of the port),
  - memory roofline: effective elementwise bytes/s,

each timed with CUDA events (kernels/profiling.py); they feed
AnalyticGPUCostEstimator's `peak_flops` and `hbm_gbps`. The JAX module's
all-reduce, overlap and shard-speedup probes over several cards are ROADMAP
A7 item 5: this one returns the two rates alone.

The links between cards cannot be timed with one card either: the machine
spec of a planned node takes the datasheet figures below.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from flexflow_tpu_torch.kernels.profiling import ProfilingSettings, profile_fn
from flexflow_tpu_torch.local_execution.training_backing import resolve_device

# Datasheet figures, not measurements (GB/s per GPU and direction):
# NVLink 4 on the H100 SXM (900 GB/s bidirectional per GPU), and one
# 400 Gb/s NDR InfiniBand port per GPU between nodes.
H100_NVLINK_GBPS = 450.0
NDR_INFINIBAND_GBPS = 50.0


@dataclass(frozen=True)
class MachineCalibration:
    backend: str
    peak_flops: float  # measured matmul FLOP/s
    hbm_gbps: float  # measured elementwise GB/s

    def as_dict(self) -> dict:
        return {"backend": self.backend, "peak_flops": self.peak_flops,
                "hbm_gbps": self.hbm_gbps}


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


def calibrate(device=None, num_devices: int = 1) -> MachineCalibration:
    """Measure the device's matmul FLOP/s and memory GB/s: on the card
    unless the caller names another device (without a card this raises
    unless device="cpu")."""
    if num_devices > 1:
        raise NotImplementedError(
            "the all-reduce, overlap and shard-speedup probes over several "
            "cards are not ported yet (ROADMAP A7 item 5)"
        )
    device = resolve_device(device)
    settings = ProfilingSettings(warmup_iters=1, measure_iters=4)
    peak_flops = _measure_compute(settings, device)
    hbm_gbps = _measure_hbm(settings, device)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return MachineCalibration(device.type, peak_flops, hbm_gbps)
