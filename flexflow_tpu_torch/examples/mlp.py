"""MLP training example, the minimal end-to-end app (port of examples/mlp.py;
reference examples/cpp/MLP_Unify/mlp.cc:23-88): N dense layers, SGD,
synthetic data, ELAPSED TIME / THROUGHPUT after a synchronize.

Run: python -m flexflow_tpu_torch.examples.mlp -e 1 -b 64 --steps 30
"""

from __future__ import annotations

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
    # the run-health telemetry, traces and the roofline block belong to A9
    for on, flag in ((bool(cfg.metrics_dir), "--metrics-dir"),
                     (cfg.health_policy not in ("", "off"), "--health-policy"),
                     (bool(cfg.profile_trace_dir), "--profile-trace-dir"),
                     (cfg.roofline, "--roofline")):
        if on:
            raise NotImplementedError(f"{flag} is not ported yet (A9)")
    if cfg.steps_per_dispatch > 1:
        print("[mlp] --steps-per-dispatch applies to the FFModel.fit loop; this "
              "instance-level example steps one dispatch at a time")

    cg, logits = build_mlp_cg(cfg.batch_size, args.in_dim, args.hidden, args.num_hidden,
                              args.classes)
    inst = ModelTrainingInstance(
        cg, logits, SparseCategoricalCrossEntropyLossAttrs(),
        SGDOptimizerAttrs(lr=cfg.learning_rate, weight_decay=cfg.weight_decay),
        device=args.device, metrics=frozenset({METRIC_ACCURACY}),
    )
    params, opt_state = inst.initialize(seed=cfg.seed)

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
    start = time.perf_counter()
    for step in range(args.steps):
        params, opt_state, loss, _ = inst.train_step(params, opt_state, {"x": x}, y)
        if cfg.print_freq and step % cfg.print_freq == 0:
            print(f"step {step}: loss {float(loss):.4f}")
    sync()
    elapsed = time.perf_counter() - start
    num_samples = args.steps * cfg.batch_size
    print(f"ELAPSED TIME = {elapsed:.4f}s, THROUGHPUT = {num_samples / elapsed:.2f} samples/s")


if __name__ == "__main__":
    main()
