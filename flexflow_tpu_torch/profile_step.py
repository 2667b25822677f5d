"""Where the flagship's training step spends its device time, on one card.

    python3 -m flexflow_tpu_torch.profile_step [--heads N] [--out FILE]

Trains the full-width flagship (bf16 compute, Adam) for two warm-up steps,
records two more under torch.profiler (CPU and CUDA activity), and prints
one JSON line: host time per step, the device time of every kernel summed
by group and by name, and the device's idle share (1 - kernel time / host
time). --heads sets the head count at the same width: 8 (heads of 128, the
default) or 16 (heads of 64, the reference-default config REF_HEADS16).
With --out the same object is also written to FILE.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

# kernel-name patterns, first match wins
GROUPS = (
    ("flash attention (port kernels)", r"^ff_flash"),
    ("matmul", r"gemm|xmma|cutlass|nvjet|cublas|sm90_"),
    ("layer norm", r"layer_norm"),
    ("loss (logsumexp, gather, scatter)", r"logsumexp|gather|scatter|index"),
    ("reduction", r"reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
    ("copy", r"copy|memcpy|memset|cat"),
)


def group_of(name: str) -> str:
    for group, pattern in GROUPS:
        if re.search(pattern, name, re.IGNORECASE):
            return group
    return "other"


def profile_flagship(heads: int = FLAGSHIP["heads"], warmup: int = 2, steps: int = 2) -> dict:
    cfg = dict(FLAGSHIP, heads=heads)
    graph, logits = build_flagship_cg(**cfg)
    inst = ModelTrainingInstance(
        graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
        AdamOptimizerAttrs(alpha=1e-4), compute_dtype=torch.bfloat16,
    )
    params, opt_state = inst.initialize(seed=0)
    gen = torch.Generator(device=inst.device).manual_seed(0)
    x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], generator=gen, device=inst.device)
    y = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=gen,
                      device=inst.device)
    for _ in range(warmup):
        inst.train_step(params, opt_state, {"x": x}, y)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(steps):
            inst.train_step(params, opt_state, {"x": x}, y)
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - start) * 1e3 / steps

    by_name, by_group = {}, {}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        ms = e.self_device_time_total / 1e3 / steps
        by_name[e.key] = {"ms_per_step": ms, "calls_per_step": e.count / steps}
        g = group_of(e.key)
        by_group[g] = by_group.get(g, 0.0) + ms
    busy = sum(by_group.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1]["ms_per_step"])[:25]
    return {
        "config": cfg, "steps": steps,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip(),
        "host_ms_per_step": host_ms, "kernel_ms_per_step": busy,
        "idle_share": (1.0 - busy / host_ms) if busy else None,
        "kernels_captured": len(by_name),
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "top_kernels": [dict(name=k, **v) for k, v in top],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--heads", type=int, default=FLAGSHIP["heads"],
                        help="attention heads at hidden 1024 (default %(default)s)")
    parser.add_argument("--out", type=Path, help="also write the JSON object here")
    args = parser.parse_args()
    result = profile_flagship(args.heads)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
