"""Per-op cost attribution: flops/bytes per graph op, joined with measured
per-op milliseconds (port of flexflow_tpu/observability/cost_attribution.py).

Sources of the flops and bytes, in order of trust:

1. A program's whole-step totals, distributed over the graph by each op's
   analytic share. The JAX package asks XLA's `cost_analysis()` of the
   jitted step for them; the port runs no compiled program to ask, so
   `step_cost_analysis` returns None, the JAX module's own "no backend
   analysis" answer, and a caller may still pass totals it has.
2. The analytic counts (`kernels/ops.op_forward_flops` and the tensor
   shapes), standing as they are. Source tag: "analytic".

Measured milliseconds come from `LocalTrainingBacking(profiling=True)`:
each op's forward and backward timed by CUDA events on the card, by the
host clock on the CPU. The per-op runs lose the whole step's overlap and
batching, so their SUM differs from the real step; attribution scales each
op's measured ms by `step_ms / sum(per-op ms)` and records the scale.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from flexflow_tpu_torch.utils.graph import Node


@dataclass
class OpCost:
    """One graph op's attributed cost. flops/bytes are FORWARD counts at the
    op's full tensor shapes; measured_ms is the op's share of the measured
    train step (fwd+bwd+update), raw_ms its standalone stepped measurement."""

    key: str  # param-key-style node id ("n3")
    name: str  # layer name (or key when unnamed)
    op_type: str
    flops: float
    bytes: float
    raw_ms: Optional[float] = None
    measured_ms: Optional[float] = None


@dataclass
class StepAttribution:
    ops: List[OpCost]
    step_ms: float
    attributed_ms: float  # sum of per-op measured_ms
    raw_total_ms: float  # sum of standalone per-op measurements
    scale: float  # step_ms / raw_total_ms — the step's fusion factor
    source: str  # "hlo" | "analytic" (hlo when EITHER quantity rescaled)
    program: Optional[Dict[str, float]] = None  # cost_analysis totals
    ms_source: str = "measured"  # "measured" | "analytic"
    # per-quantity tags: a backend can expose only one of flops/bytes, and
    # the roofline's training multipliers must follow each independently
    flops_source: str = "analytic"
    bytes_source: str = "analytic"

    def total_flops(self) -> float:
        return sum(o.flops for o in self.ops)

    def total_bytes(self) -> float:
        return sum(o.bytes for o in self.ops)


def _op_records(cg) -> List[tuple]:
    """(node, key, name, op_type, flops, bytes) per compute op of the CG,
    from op_attrs shape inference — the analytic layer every attribution
    mode is distributed over."""
    from flexflow_tpu_torch.kernels.ops import op_forward_flops
    from flexflow_tpu_torch.local_execution.training_backing import (
        param_key,
        split_slot_values,
    )
    from flexflow_tpu_torch.op_attrs.core import op_type_of
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs

    out = []
    for n in cg.topological_ordering():
        attrs = cg.op_attrs(n)
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            continue
        in_shapes = [cg.tensor_shape(t) for t in cg.inputs_of(n)]
        out_shapes = [cg.tensor_shape(t) for t in cg.outputs_of(n)]
        data, weights = split_slot_values(attrs, in_shapes)
        try:
            flops = op_forward_flops(
                attrs, data, out_shapes, weight_shapes=weights or None
            )
        except (AssertionError, IndexError, TypeError, ValueError):
            flops = 0
        nbytes = sum(s.size_bytes for s in in_shapes) + sum(
            s.size_bytes for s in out_shapes
        )
        name = cg.layer_attrs(n).name or param_key(n)
        out.append((n, param_key(n), name, op_type_of(attrs).value, flops, nbytes))
    return out


def analytic_op_costs(cg) -> List[OpCost]:
    """Per-op forward flops/bytes from op_attrs shapes alone."""
    return [
        OpCost(key=k, name=nm, op_type=ot, flops=float(f), bytes=float(b))
        for _, k, nm, ot, f, b in _op_records(cg)
    ]


def step_cost_analysis(fn, *args, **kwargs) -> Optional[Dict[str, float]]:
    """Whole-program {flops, bytes_accessed} of a compiled step: the JAX
    package reads XLA's cost analysis; the port compiles no program to ask,
    so this is None, and the analytic path engages."""
    return None


def measure_per_op_ms(
    cg, inputs: Dict[str, object], logit, seed: int = 0,
    compute_dtype=None, device=None,
) -> Dict[Node, float]:
    """Standalone per-op fwd+bwd milliseconds via the stepped backing
    (LocalTrainingBacking profiling, the reference's PerLayerElapsedTime):
    CUDA events around each op's forward and backward on the card. The
    backward is seeded with ones on the logit tensor; the optimizer update
    is not included (it is per weight, not per op). `compute_dtype`: the
    dtype the ops run in (the trainer's; None: the parameters'). `device`:
    the card unless the caller names another.

    Each op is timed on its own, launched from Python, so small ops carry
    their launch latency and the sum exceeds a step that overlaps them;
    attribute_costs scales it to the step and records the scale."""
    import torch

    from flexflow_tpu_torch.local_execution.training_backing import LocalTrainingBacking

    backing = LocalTrainingBacking(cg, profiling=True, compute_dtype=compute_dtype,
                                   device=device)
    backing.execute_init(seed=seed)
    backing.execute_forward(inputs)
    backing.execute_backward({logit: torch.ones_like(backing.env[logit])})
    totals: Dict[Node, float] = {}
    for table in (backing.fwd_elapsed, backing.bwd_elapsed):
        for n, ms in table.items():
            totals[n] = totals.get(n, 0.0) + ms
    return totals


def attribute_costs(
    cg,
    step_ms: float,
    per_op_ms: Optional[Dict[Node, float]] = None,
    program: Optional[Dict[str, float]] = None,
) -> StepAttribution:
    """Join per-op flops/bytes with measured time.

    - flops/bytes: analytic per-op counts, rescaled so their totals match
      the XLA program totals when `program` (step_cost_analysis output) is
      given — program totals cover fwd+bwd+update, so the rescale folds the
      training multiplier in; without it the raw forward counts stand.
    - measured_ms: per_op_ms scaled by step_ms/sum(per_op_ms) so the
      attribution totals the real step (the scale — the fused step's
      advantage over stepped per-op execution — is recorded). Without
      per_op_ms, step_ms is distributed by each op's analytic weight
      (flops + bytes share), tagged ms_source="analytic".
    """
    recs = _op_records(cg)
    ops = [
        OpCost(key=k, name=nm, op_type=ot, flops=float(f), bytes=float(b))
        for _, k, nm, ot, f, b in recs
    ]
    flops_source = bytes_source = "analytic"
    if program:
        tot_f = sum(o.flops for o in ops)
        tot_b = sum(o.bytes for o in ops)
        pf = program.get("flops")
        pb = program.get("bytes_accessed")
        if pf and tot_f > 0:
            for o in ops:
                o.flops *= pf / tot_f
            flops_source = "hlo"
        if pb and tot_b > 0:
            for o in ops:
                o.bytes *= pb / tot_b
            bytes_source = "hlo"
    source = (
        "hlo" if "hlo" in (flops_source, bytes_source) else "analytic"
    )

    ms_source = "measured" if per_op_ms else "analytic"
    if per_op_ms:
        raw = [float(per_op_ms.get(n, 0.0)) for n, *_ in recs]
    else:
        # analytic weights: a roofline-ish mix of compute and traffic.
        # Units cancel in the normalization, so the relative constants only
        # set the compute/memory balance (240 flop/byte, the JAX package's
        # constant, kept so both packages attribute alike)
        raw = [o.flops / 240.0 + o.bytes for o in ops]
    raw_total = sum(raw)
    scale = (step_ms / raw_total) if raw_total > 0 else 0.0
    for o, r in zip(ops, raw):
        o.raw_ms = r if per_op_ms else None
        o.measured_ms = r * scale
    attributed = sum(o.measured_ms for o in ops)
    return StepAttribution(
        ops=ops,
        step_ms=step_ms,
        attributed_ms=attributed,
        raw_total_ms=raw_total if per_op_ms else 0.0,
        scale=scale if per_op_ms else 1.0,
        source=source,
        program=program,
        ms_source=ms_source,
        flops_source=flops_source,
        bytes_source=bytes_source,
    )
