"""MLP training example, the minimal end-to-end app (port of examples/mlp.py;
reference examples/cpp/MLP_Unify/mlp.cc:23-88): N dense layers, SGD,
synthetic data, ELAPSED TIME / THROUGHPUT after a synchronize.

Run: python -m flexflow_tpu_torch.examples.mlp -e 1 -b 64 --steps 30
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np
import torch

from flexflow_tpu_torch.examples import example_parser
from flexflow_tpu_torch.kernels.metrics import METRIC_ACCURACY
from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.local_execution.config import FFConfig
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder
from flexflow_tpu_torch.pcg.optimizer import SGDOptimizerAttrs


def build_mlp_cg(batch_size: int, in_dim: int, hidden: int, num_hidden: int, classes: int):
    """reference mlp.cc:35-52: input -> N x dense(hidden, relu) -> dense(classes)."""
    b = ComputationGraphBuilder()
    x = b.create_input([batch_size, in_dim], name="x")
    h = x
    for i in range(num_hidden):
        h = b.dense(h, hidden, name=f"fc{i}")
        h = b.relu(h)
    logits = b.dense(h, classes, name="out")
    return b.graph, logits


def main(argv=None):
    p = example_parser()
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--in-dim", type=int, default=1024)
    p.add_argument("--hidden", type=int, default=1024)
    p.add_argument("--num-hidden", type=int, default=4)
    p.add_argument("--classes", type=int, default=10)
    args = p.parse_args(argv)
    cfg = FFConfig.from_args(args)
    # the loop below emits one JSONL event per step and applies the health
    # policy (observability/{metrics,health}.py, the wiring FFModel.fit uses)
    health_on = cfg.health_policy not in ("", "off")
    if cfg.steps_per_dispatch > 1:
        print("[mlp] --steps-per-dispatch applies to the FFModel.fit loop; this "
              "instance-level example steps one dispatch at a time")

    cg, logits = build_mlp_cg(cfg.batch_size, args.in_dim, args.hidden, args.num_hidden,
                              args.classes)
    inst = ModelTrainingInstance(
        cg, logits, SparseCategoricalCrossEntropyLossAttrs(),
        SGDOptimizerAttrs(lr=cfg.learning_rate, weight_decay=cfg.weight_decay),
        device=args.device, metrics=frozenset({METRIC_ACCURACY}),
        collect_step_stats=bool(cfg.metrics_dir) or health_on,
        guard_nonfinite_updates=cfg.health_policy in ("skip_step", "raise"),
    )
    params, opt_state = inst.initialize(seed=cfg.seed)

    event_log = monitor = None
    if cfg.metrics_dir:
        from flexflow_tpu_torch.observability.metrics import StepEventLog

        event_log = StepEventLog(cfg.metrics_dir)
    if health_on:
        from flexflow_tpu_torch.observability.health import (
            HealthMonitor,
            localize_first_nonfinite,
        )

        def _localize(batch, label):
            return localize_first_nonfinite(cg, params, batch, logit_tensor=logits, label=label,
                                            loss_attrs=inst.loss_attrs)

        monitor = HealthMonitor(cfg.health_policy, localizer=_localize)

    rs = np.random.RandomState(cfg.seed)
    x = torch.as_tensor(rs.randn(cfg.batch_size, args.in_dim).astype(np.float32),
                        device=inst.device)
    y = torch.as_tensor(rs.randint(0, args.classes, cfg.batch_size).astype(np.int32),
                        device=inst.device)

    def sync():
        if inst.device.type == "cuda":
            torch.cuda.synchronize(inst.device)

    # warm-up step (the reference's init_operators + first iteration)
    params, opt_state, loss, _ = inst.train_step(params, opt_state, {"x": x}, y)
    sync()

    # --profile-trace-dir: the measured loop's span timeline (step >
    # dispatch / device_sync) in Chrome-trace format
    span_ctx = contextlib.nullcontext()
    if cfg.profile_trace_dir:
        from flexflow_tpu_torch.observability.trace import trace_session

        span_ctx = trace_session(cfg.profile_trace_dir)
    with span_ctx:
        start = time.perf_counter()
        for step in range(args.steps):
            step_t0 = time.perf_counter() if event_log is not None or monitor is not None else None
            params, opt_state, loss, _ = inst.train_step(params, opt_state, {"x": x}, y)
            if step_t0 is not None:
                from flexflow_tpu_torch.observability.health import record_step_health

                record_step_health(event_log, monitor, step + 1, loss, inst.last_step_stats,
                                   batch={"x": x}, label=y, tokens=cfg.batch_size,
                                   step_t0=step_t0)
            if cfg.print_freq and step % cfg.print_freq == 0:
                print(f"step {step}: loss {float(loss):.4f}")
        sync()
        # timed inside the session: writing the trace is no step time
        elapsed = time.perf_counter() - start
    num_samples = args.steps * cfg.batch_size
    print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = {num_samples / elapsed:.2f} samples/s")
    if event_log is not None:
        event_log.close()
        print(f"run-health events: {event_log.path}")
    if monitor is not None and monitor.nonfinite_steps:
        print(f"run-health summary: {monitor.summary()}")

    # --roofline: per-op cost attribution of the measured step against the
    # device's calibrated constants (observability/roofline.py)
    if cfg.roofline:
        from flexflow_tpu_torch.compiler.calibration import get_calibration
        from flexflow_tpu_torch.observability import (
            attribute_costs,
            measure_per_op_ms,
            roofline_report,
        )
        from flexflow_tpu_torch.observability.roofline import machine_constants

        per_op = measure_per_op_ms(cg, {"x": x}, logits, seed=cfg.seed, device=inst.device)
        att = attribute_costs(cg, elapsed / args.steps * 1000.0, per_op_ms=per_op)
        consts = machine_constants(get_calibration(inst.device, 1))
        extra = {"subject": "mlp", "device": str(inst.device), "constants": consts["source"]}
        if cfg.profile_trace_dir:
            # the loop ran traced (a device sync a step): its step_ms is for
            # comparing phases, not a headline number
            extra["trace_file"] = os.path.join(cfg.profile_trace_dir, "flexflow_trace.json")
        block = roofline_report(att, consts["peak_flops"], consts["hbm_gbps"], extra=extra)
        print(json.dumps({"roofline": block}))


if __name__ == "__main__":
    main()
