"""Observability (port of flexflow_tpu/observability/): structured step
tracing, per-op cost attribution and roofline reports, the run-health
stream and its policies, the plan audit and the drift monitor.

- `trace`       -- span/event recorder with device-sync boundaries
                   (kernels/profiling.force_sync), emitting Chrome-trace
                   JSON beside the torch.profiler trace in
                   `profile_trace_dir`.
- `cost_attribution` -- per-op flops/bytes (analytic, from the graph's
                   shapes) joined with per-op milliseconds measured on the
                   card.
- `roofline`    -- classify each op compute-bound / bandwidth-bound /
                   dispatch-bound against the H100's constants (or a
                   calibration's) and report per-op and whole-step MFU.
- `search_phases` -- per-phase wall-clock of the Unity search, as spans
                   and as `phase_ms` in the search telemetry.
- `metrics`     -- run-health telemetry: counter/gauge/histogram registry
                   plus the per-step JSONL event stream (loss, wallclock,
                   tokens/s, grad/param global norms, update ratio) under
                   `metrics_dir`, the norms computed on the device in the
                   step (and in a fused window's CUDA graph).
- `health`      -- nonfinite-grad/loss monitor with warn | skip_step |
                   raise policies and a first-bad-op localizer that
                   replays the step op by op.
- `plan_audit`  -- predicted-vs-measured audit of the searched plan.
- `drift`       -- the streaming drift monitor over the event stream.
"""

from flexflow_tpu_torch.observability.trace import (
    TraceRecorder,
    active_recorder,
    record_span,
    set_recorder,
    trace_session,
)
from flexflow_tpu_torch.observability.cost_attribution import (
    OpCost,
    StepAttribution,
    analytic_op_costs,
    attribute_costs,
    measure_per_op_ms,
    step_cost_analysis,
)
from flexflow_tpu_torch.observability.roofline import (
    classify_op,
    roofline_report,
)
from flexflow_tpu_torch.observability.search_phases import (
    collect_search_phases,
    search_phase,
)
from flexflow_tpu_torch.observability.metrics import (
    EVENT_SCHEMA_VERSION,
    STEP_EVENT_FIELDS,
    MetricsRegistry,
    StepEventLog,
    finalize_step,
    global_norm,
    guard_nonfinite,
    read_events,
    step_statistics,
)
from flexflow_tpu_torch.observability.health import (
    HEALTH_POLICIES,
    HealthMonitor,
    NonFiniteError,
    NonFiniteReport,
    localize_first_nonfinite,
    record_step_health,
)
from flexflow_tpu_torch.observability.plan_audit import (
    AUDIT_SCHEMA_VERSION,
    audit_plan,
)

__all__ = [
    "TraceRecorder",
    "active_recorder",
    "record_span",
    "set_recorder",
    "trace_session",
    "OpCost",
    "StepAttribution",
    "analytic_op_costs",
    "attribute_costs",
    "measure_per_op_ms",
    "step_cost_analysis",
    "classify_op",
    "roofline_report",
    "collect_search_phases",
    "search_phase",
    "EVENT_SCHEMA_VERSION",
    "STEP_EVENT_FIELDS",
    "MetricsRegistry",
    "StepEventLog",
    "finalize_step",
    "global_norm",
    "guard_nonfinite",
    "read_events",
    "step_statistics",
    "HEALTH_POLICIES",
    "HealthMonitor",
    "NonFiniteError",
    "NonFiniteReport",
    "localize_first_nonfinite",
    "record_step_health",
    "AUDIT_SCHEMA_VERSION",
    "audit_plan",
]
