"""Roofline reporter: classify each attributed op against the machine's
constants and report per-op + whole-step MFU (port of
flexflow_tpu/observability/roofline.py).

Classification of one op given its attributed flops/bytes/ms and the
machine's peak_flops (FLOP/s) and hbm_gbps (GB/s):

- compute_ms = train_factor * flops / peak_flops      (the tensor-core roofline)
- memory_ms  = traffic_factor * bytes / hbm bandwidth (the HBM roofline)
- "mxu"       when the compute roofline dominates and the op runs within
  `efficiency_floor` of it (the JAX package's name for the matrix-unit
  bound, kept so either package's reports read alike);
- "bandwidth" when the memory roofline dominates likewise;
- "dispatch"  when the measured time is more than 1/efficiency_floor above
  BOTH rooflines (or below the latency floor): the op's milliseconds are
  overhead (kernel launch, layout change), not an arithmetic or bandwidth
  ceiling.

Machine constants: an H100 SXM's, H100_PEAK_FLOPS (989 TFLOP/s dense bf16)
and H100_HBM_GBPS (3.35 TB/s), or the measured ones of
`compiler/calibration.py` where a calibration exists (`machine_constants`).
Per-op times come from `cost_attribution.StepAttribution`.
"""

from __future__ import annotations

from typing import Dict, Optional

from flexflow_tpu_torch.observability.cost_attribution import StepAttribution

# an H100 SXM's dense bf16 tensor-core peak and HBM3 rate (datasheet)
H100_PEAK_FLOPS = 989e12
H100_HBM_GBPS = 3350.0

# fwd+bwd+update over forward-only analytic counts (same 3x the analytic
# cost model and bench.py MFU accounting use)
TRAIN_FLOPS_FACTOR = 3.0
# fwd reads+writes, bwd roughly doubles the traffic
TRAIN_BYTES_FACTOR = 2.0


def machine_constants(calibration=None) -> Dict[str, object]:
    """{peak_flops, hbm_gbps, source}: a calibration's measured constants
    (compiler/calibration.py MachineCalibration) where one is given, else
    the H100's datasheet peaks."""
    if calibration is not None and calibration.peak_flops > 0 and calibration.hbm_gbps > 0:
        return {"peak_flops": float(calibration.peak_flops),
                "hbm_gbps": float(calibration.hbm_gbps), "source": "calibration"}
    return {"peak_flops": H100_PEAK_FLOPS, "hbm_gbps": H100_HBM_GBPS, "source": "h100_datasheet"}


def classify_op(
    flops: float,
    nbytes: float,
    measured_ms: float,
    peak_flops: float,
    hbm_gbps: float,
    *,
    train_flops_factor: float = TRAIN_FLOPS_FACTOR,
    train_bytes_factor: float = TRAIN_BYTES_FACTOR,
    efficiency_floor: float = 0.2,
    latency_floor_ms: float = 1e-4,
) -> str:
    """"mxu" | "bandwidth" | "dispatch" for one op (see module docstring)."""
    compute_ms = train_flops_factor * flops / max(peak_flops, 1e-9) * 1e3
    memory_ms = train_bytes_factor * nbytes / max(hbm_gbps * 1e6, 1e-9)
    ceiling_ms = max(compute_ms, memory_ms)
    if measured_ms <= latency_floor_ms or ceiling_ms <= 0:
        return "dispatch"
    if measured_ms > ceiling_ms / efficiency_floor:
        # even the binding roofline explains < efficiency_floor of the time
        return "dispatch"
    return "mxu" if compute_ms >= memory_ms else "bandwidth"


def roofline_report(
    attribution: StepAttribution,
    peak_flops: float,
    hbm_gbps: float,
    *,
    train_flops_factor: Optional[float] = None,
    train_bytes_factor: Optional[float] = None,
    efficiency_floor: float = 0.2,
    top_n: Optional[int] = None,
    extra: Optional[Dict[str, object]] = None,
) -> dict:
    """The `roofline` artifact block: per-op {flops, bytes, measured_ms,
    bound, mfu} plus whole-step MFU and a per-bound time summary.

    The train factors default PER QUANTITY by the attribution's source
    tags: analytic counts are FORWARD-only, so the 3x/2x training
    multipliers apply; "hlo" counts were already rescaled to a program's
    fwd+bwd+update totals, so the factor is 1. The two resolve
    independently.

    `top_n` keeps only the N most expensive ops in the per-op list (the
    bound_summary and totals always cover every op); `extra` fields are
    merged into the block (shapes, backend, subject labels)."""
    if train_flops_factor is None:
        train_flops_factor = (
            1.0 if attribution.flops_source == "hlo" else TRAIN_FLOPS_FACTOR
        )
    if train_bytes_factor is None:
        train_bytes_factor = (
            1.0 if attribution.bytes_source == "hlo" else TRAIN_BYTES_FACTOR
        )
    step_s = attribution.step_ms / 1e3
    total_flops = attribution.total_flops()
    step_mfu = (
        train_flops_factor * total_flops / step_s / peak_flops
        if step_s > 0
        else 0.0
    )
    ops = []
    bound_ms: Dict[str, float] = {"mxu": 0.0, "bandwidth": 0.0, "dispatch": 0.0}
    for o in attribution.ops:
        ms = o.measured_ms or 0.0
        bound = classify_op(
            o.flops,
            o.bytes,
            ms,
            peak_flops,
            hbm_gbps,
            train_flops_factor=train_flops_factor,
            train_bytes_factor=train_bytes_factor,
            efficiency_floor=efficiency_floor,
        )
        bound_ms[bound] += ms
        op_mfu = (
            train_flops_factor * o.flops / (ms / 1e3) / peak_flops
            if ms > 0
            else 0.0
        )
        ops.append(
            {
                "name": o.name,
                "op_type": o.op_type,
                "flops": round(o.flops),
                "bytes": round(o.bytes),
                "measured_ms": round(ms, 4),
                "bound": bound,
                "mfu": round(op_mfu, 4),
                "fraction_of_step": round(
                    ms / attribution.step_ms if attribution.step_ms else 0.0, 4
                ),
            }
        )
    ops.sort(key=lambda d: -d["measured_ms"])
    shown = ops if top_n is None else ops[:top_n]
    block = {
        "step_ms": round(attribution.step_ms, 3),
        "mfu": round(step_mfu, 4),
        "train_flops_factor": train_flops_factor,
        "train_bytes_factor": train_bytes_factor,
        "peak_flops": peak_flops,
        "hbm_gbps": round(hbm_gbps, 3),
        "flops_bytes_source": attribution.source,
        "flops_source": attribution.flops_source,
        "bytes_source": attribution.bytes_source,
        "ms_source": attribution.ms_source,
        "attributed_ms": round(attribution.attributed_ms, 3),
        # fused step vs stepped per-op execution (only meaningful for
        # measured per-op ms): < 1 means the fused program beats the sum of
        # its parts — the fusion win the attribution scaled out
        "attribution_scale": round(attribution.scale, 4),
        "bound_ms": {k: round(v, 3) for k, v in bound_ms.items()},
        "num_ops": len(ops),
        "ops": shown,
    }
    if extra:
        block.update(extra)
    return block
