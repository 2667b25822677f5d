"""Run-health monitoring: nonfinite detection, policies, first-bad-op blame
(port of flexflow_tpu/observability/health.py).

A training run has three sane reactions to a non-finite loss or gradient:

- ``warn``      — log and keep going (the run is disposable).
- ``skip_step`` — drop the poisoned update and continue on the previous
                  parameters. The guard happens on the device, inside the
                  step (metrics.finalize_step), so the skipped update never
                  reaches the parameters or the optimizer state.
- ``raise``     — stop with the name of the first op whose output went
                  non-finite.

The localizer replays the failing step one op at a time in the graph's
topological order (forward, then the loss, then the backward walk, each op
differentiated by autograd on its own) and names the earliest op whose
output holds a NaN or an Inf. The replay draws the tripped step's Dropout
masks from a generator put back at that step's position, so it computes
the function the step computed.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch

HEALTH_POLICIES = ("off", "warn", "skip_step", "raise")


class NonFiniteError(RuntimeError):
    """Raised by the `raise` policy; carries the localizer's blame report."""

    def __init__(self, message: str, report: Optional["NonFiniteReport"] = None):
        super().__init__(message)
        self.report = report


@dataclass
class NonFiniteReport:
    """Where the step first went non-finite."""

    phase: str            # "forward" | "loss" | "backward" | "unknown"
    op_name: Optional[str]  # layer name (or "n<idx>") of the first bad op
    op_type: Optional[str] = None
    detail: str = ""

    def describe(self) -> str:
        if self.op_name is None:
            return f"non-finite values in {self.phase} (op not localized)"
        return (f"first non-finite output at {self.phase} op "
                f"{self.op_name!r} ({self.op_type}){self.detail}")


def _finite(x) -> bool:
    if not isinstance(x, torch.Tensor) or not x.is_floating_point():
        return True
    return bool(torch.isfinite(x).all())


def localize_first_nonfinite(
    graph,
    params: Dict[str, torch.Tensor],
    inputs: Dict[str, object],
    logit_tensor=None,
    label=None,
    loss_attrs=None,
    compute_dtype: Optional[torch.dtype] = None,
    rng: Optional[torch.Generator] = None,
) -> NonFiniteReport:
    """Replay one step op by op and name the earliest non-finite producer.

    `graph` may be the ComputationGraph or a PCG (parallel ops interpret as
    identity, on whole values); `params` the whole parameters keyed by
    param_key, `inputs` the batch that tripped the monitor. When
    `logit_tensor`/`label`/`loss_attrs` are given and the forward is clean,
    the loss and the reverse-topological per-op backward are checked too.
    `compute_dtype` is the trainer's: the replay runs at the step's
    precision. `rng` is a generator at the tripped step's position: the
    replay then runs train-mode and draws the step's Dropout masks from it
    (training_backing.dropout_masks); without it ops run in eval mode."""
    from flexflow_tpu_torch.kernels import forward as kernel_forward, loss_forward
    from flexflow_tpu_torch.kernels.ops import apply_dropout_mask
    from flexflow_tpu_torch.kernels.precision import cast_for_compute
    from flexflow_tpu_torch.local_execution.training_backing import (
        dropout_masks,
        param_key,
        split_slot_values,
    )
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs

    device = next(iter(params.values())).device if params else torch.device("cpu")
    params = cast_for_compute({k: v.detach() for k, v in params.items()}, compute_dtype)
    inputs = cast_for_compute(
        {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}, compute_dtype)
    train = rng is not None
    masks = dropout_masks(graph, rng, device) if train else {}

    def describe(n):
        la = graph.layer_attrs(n)
        return la.name or param_key(n), type(la.attrs).__name__

    def run(n, attrs, vals):
        data, w = split_slot_values(attrs, list(vals))
        if n in masks:
            return [apply_dropout_mask(data[0], masks[n], attrs.rate)]
        return kernel_forward(attrs, data, w, train=train, rng=rng)

    # -- forward, one op at a time ------------------------------------------
    env: Dict = {}
    order = graph.topological_ordering()
    with torch.no_grad():
        for n in order:
            la = graph.layer_attrs(n)
            attrs = la.attrs
            outs = graph.outputs_of(n)
            if isinstance(attrs, InputAttrs):
                key = la.name if la.name in inputs else param_key(n)
                if key not in inputs:
                    return NonFiniteReport("unknown", None, detail=f" (missing input {key!r})")
                env[outs[0]] = inputs[key]
            elif isinstance(attrs, WeightAttrs):
                if param_key(n) not in params:
                    return NonFiniteReport(
                        "unknown", None, detail=f" (missing param {param_key(n)!r})")
                env[outs[0]] = params[param_key(n)]
                if not _finite(env[outs[0]]):
                    name, ot = describe(n)
                    return NonFiniteReport("forward", name, ot, " (parameter value)")
            elif is_parallel_op(attrs):
                (src,) = graph.inputs_of(n)
                env[outs[0]] = env[src]
            else:
                results = run(n, attrs, [env[v] for v in graph.inputs_of(n)])
                for o, r in zip(outs, results):
                    env[o] = r
                if any(not _finite(r) for r in results):
                    name, ot = describe(n)
                    return NonFiniteReport("forward", name, ot)

    if logit_tensor is None or label is None or loss_attrs is None:
        return NonFiniteReport("unknown", None, detail=" (forward pass clean)")

    # -- loss ---------------------------------------------------------------
    logit = env.get(logit_tensor)
    if logit is None:
        return NonFiniteReport("unknown", None, detail=" (logit not materialized)")
    lbl = torch.as_tensor(label, device=device)
    leaf = logit.detach().requires_grad_(True)
    with torch.enable_grad():
        loss = loss_forward(loss_attrs, leaf, lbl)
    if not _finite(loss.detach()):
        return NonFiniteReport("loss", "loss", type(loss_attrs).__name__)

    # -- backward: reverse-topological per-op gradients -----------------------
    (dlogit,) = torch.autograd.grad(loss, [leaf])
    grad_env: Dict = {logit_tensor: dlogit}
    if not _finite(dlogit):
        return NonFiniteReport("backward", "loss", type(loss_attrs).__name__)
    for n in reversed(order):
        attrs = graph.op_attrs(n)
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            continue
        outs = graph.outputs_of(n)
        if not any(o in grad_env for o in outs):
            continue
        in_tensors = graph.inputs_of(n)
        if is_parallel_op(attrs):
            in_grads = [grad_env[outs[0]]]
        else:
            leaves = {v: env[v].detach().requires_grad_(env[v].is_floating_point())
                      for v in dict.fromkeys(in_tensors)}
            with torch.enable_grad():
                results = run(n, attrs, [leaves[v] for v in in_tensors])
            wanted = [v for v, t in leaves.items() if t.requires_grad]
            out_grads = [grad_env.get(o, torch.zeros_like(r)) for o, r in zip(outs, results)]
            got = torch.autograd.grad(results, [leaves[v] for v in wanted], out_grads,
                                      allow_unused=True)
            by_value = {v: g for v, g in zip(wanted, got) if g is not None}
            in_tensors = list(by_value)
            in_grads = [by_value[v] for v in in_tensors]
        bad = any(not _finite(g) for g in in_grads)
        for v, g in zip(in_tensors, in_grads):
            grad_env[v] = grad_env[v] + g if v in grad_env else g
        if bad:
            name, ot = describe(n)
            return NonFiniteReport("backward", name, ot)
    return NonFiniteReport("unknown", None, detail=" (replay stayed finite)")


@dataclass
class HealthMonitor:
    """Per-step health policy enforcement over the step statistics.

    `observe()` is called once per step with the stats the step produced
    (metrics.step_statistics), on the device or read back already. Reading
    the `ok` flag is the one host sync the monitor costs. The localizer is
    a callable (batch, label) -> NonFiniteReport installed by the owner
    (FFModel.fit wires it to the live graph and parameters).

    The monitor keeps its own trip counters; the registry's skipped and
    nonfinite counts belong to StepEventLog.emit (one counter family per
    fact)."""

    policy: str = "off"
    localizer: Optional[Callable] = None
    nonfinite_steps: int = 0
    skipped_steps: int = 0
    last_report: Optional[NonFiniteReport] = None

    def __post_init__(self):
        assert self.policy in HEALTH_POLICIES, (
            f"health policy {self.policy!r} not in {HEALTH_POLICIES}")

    @property
    def active(self) -> bool:
        return self.policy != "off"

    def observe(self, step: int, loss, stats, batch=None, label=None) -> bool:
        """Returns the step's finiteness. Applies the policy on a trip."""
        if not self.active or stats is None:
            return True
        ok = bool(stats["ok"])  # the one host readback
        if ok:
            return True
        self.nonfinite_steps += 1
        report = None
        # Blame the first trip (and every `raise`): the replay is
        # expensive, and a run that keeps tripping trips on the same op.
        # Localization needs the PRE-step parameters, which only the
        # guarded policies keep — under `warn` the update is applied.
        if (self.localizer is not None and self.policy in ("skip_step", "raise")
                and (self.policy == "raise" or self.last_report is None)):
            try:
                report = self.localizer(batch, label)
            except Exception as e:  # blame must never mask the trip itself
                report = NonFiniteReport("unknown", None, detail=f" (localizer failed: {e})")
            self.last_report = report
        where = f": {report.describe()}" if report is not None else ""
        if not where and self.policy == "warn" and self.localizer is not None:
            where = (" (first-bad-op localization needs the skip_step/raise "
                     "guard; under warn the poisoned update is already applied)")
        msg = (f"non-finite loss/gradient at step {step} "
               f"(loss={float(loss)!r}, grad_norm={float(stats['grad_norm'])!r}){where}")
        if self.policy == "raise":
            raise NonFiniteError(msg, report)
        if self.policy == "skip_step":
            # params and optimizer state were already guarded on the device
            self.skipped_steps += 1
            print(f"[flexflow_tpu_torch][health] SKIPPED {msg}")
        else:
            print(f"[flexflow_tpu_torch][health] WARN {msg}")
        return False

    def summary(self) -> Dict[str, object]:
        return {
            "policy": self.policy,
            "nonfinite_steps": self.nonfinite_steps,
            "skipped_steps": self.skipped_steps,
            "first_bad_op": self.last_report.op_name if self.last_report else None,
        }


def record_step_health(
    event_log,
    monitor: Optional[HealthMonitor],
    step: int,
    loss,
    stats,
    *,
    batch=None,
    label=None,
    tokens: Optional[int] = None,
    step_t0: Optional[float] = None,
    wallclock_ms: Optional[float] = None,
) -> bool:
    """The per-step telemetry shared by FFModel.fit and instance-level
    training loops (examples/mlp.py): read the step's statistics, enforce
    the health policy, emit the JSONL event. Returns the step's finiteness.

    `wallclock_ms` is the caller-attributed step time where it is not
    directly observable (a fused window's time apportioned over its
    steps); otherwise it runs from `step_t0` to the first host sync.
    The wall-clock is taken before any policy action, so a tripped step's
    event records the step's time, not the localizer's replay; under
    `raise` the event is emitted and the log closed before the error
    propagates."""
    import time

    ok = True
    if stats is not None and (monitor is not None or event_log is not None):
        ok = bool(stats["ok"])  # the step's one host sync
    wall_ms = (time.perf_counter() - step_t0) * 1000.0 if step_t0 is not None else wallclock_ms
    health_err = None
    skipped = False
    if monitor is not None:
        try:
            ok = monitor.observe(step, loss, stats, batch=batch, label=label)
        except NonFiniteError as e:
            ok = False
            health_err = e
        skipped = (not ok) and monitor.policy == "skip_step"
    if event_log is not None:
        event_log.emit(
            step=step,
            loss=loss,
            wallclock_ms=wall_ms,
            tokens_per_s=(tokens / max(wall_ms / 1000.0, 1e-9)
                          if tokens is not None and wall_ms is not None else None),
            grad_norm=stats.get("grad_norm") if stats else None,
            param_norm=stats.get("param_norm") if stats else None,
            update_ratio=stats.get("update_ratio") if stats else None,
            skipped=skipped,
            nonfinite=not ok,
        )
    if health_err is not None:
        if event_log is not None:
            event_log.close()
        raise health_err
    return ok
