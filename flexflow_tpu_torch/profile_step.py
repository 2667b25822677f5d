"""Where the flagship's training step spends its device time, on one card.

    python3 -m flexflow_tpu_torch.profile_step [--heads N] [--dp] [--seq 2048] [--sp] [--out FILE]

Trains the full-width flagship (bf16 compute, Adam) for two warm-up steps,
records two more under torch.profiler (CPU and CUDA activity), and prints
one JSON line: host time per step, the device time of every kernel summed
by group and by name, and the device's idle share (1 - kernel time / host
time). --heads sets the head count at the same width: 8 (heads of 128, the
default) or 16 (heads of 64, the reference-default config REF_HEADS16).
--seq 2048 trains the seq-2048 flagship (LONGCTX) instead. --dp trains
through the data-parallel trainer at world size 1, in a one-rank NCCL group
over a file:// store, whose attention runs the per-head kernels; the NCCL
all-reduce then has a group of its own. --sp trains SP_LONGCTX (the
flagship's widths, causal, batch 4, seq 8192) through the sequence-parallel
trainer at world size 1, in the same kind of group, whose attention runs
the ring-flash step kernels (grouped with the other port kernels). Copy kernels are also split by the
operator that launched them: casts (aten::_to_copy) and layout copies
(everything else, e.g. the per-head projections' permutes). With --out the
same object is also written to FILE.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import subprocess
import tempfile
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.models import (
    FLAGSHIP,
    LONGCTX,
    SP_LONGCTX,
    build_flagship_cg,
    build_parallel_transformer,
)
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.parallel import (
    DataParallelTrainingInstance,
    DistributedTrainingInstance,
    MachineMesh,
    init_file_group,
)
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

# kernel-name patterns, first match wins
GROUPS = (
    ("flash attention (port kernels)", r"^ff_(flash|ring)_"),
    ("all-reduce (NCCL)", r"nccl"),
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


# copy kernels by the operator that launched them, first match wins
COPY_LAUNCHERS = (
    ("cast (aten::_to_copy)", "aten::_to_copy"),
    ("concatenation (aten::cat, e.g. the gradient bucket)", "aten::cat"),
)
LAYOUT_COPY = "layout copy (other ops)"

# torch.profiler keeps a device record only if the record's own timestamps
# fall inside the trace's capture window, and those run apart from the host's
# clock: a trace that closes right after its work's synchronize can lose the
# work's last records (`python3 -m flexflow_tpu_torch.trace_edges` counts the
# loss). So a trace idles this long after opening and before closing.
TRACE_EDGE_S = 0.5


@contextlib.contextmanager
def device_trace():
    """torch.profiler (CPU and CUDA activity) around the block, with
    TRACE_EDGE_S of idle host time at each end: the block runs after the
    first, and the card is synchronized before the second. Host times
    taken inside the block exclude both."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(TRACE_EDGE_S)
        yield prof
        torch.cuda.synchronize()
        time.sleep(TRACE_EDGE_S)


def copy_split(prof, steps: int) -> dict:
    """Device ms per step of copy kernels, by the operator that launched
    them: casts, concatenations and layout copies (the rest)."""
    out = {key: 0.0 for key, _ in COPY_LAUNCHERS}
    out[LAYOUT_COPY] = 0.0
    for e in prof.events():
        if e.device_type != DeviceType.CPU or not e.kernels:
            continue
        names, parent = {e.name}, e.cpu_parent
        while parent is not None:
            names.add(parent.name)
            parent = parent.cpu_parent
        key = next((k for k, op in COPY_LAUNCHERS if op in names), LAYOUT_COPY)
        for k in e.kernels:
            if "copy" in k.name.lower():
                out[key] += k.duration / 1e3 / steps
    return out


@contextlib.contextmanager
def _one_rank_group(dp: bool):
    if not dp:
        yield
        return
    import torch.distributed as dist

    with tempfile.TemporaryDirectory() as tmp:
        init_file_group(os.path.join(tmp, "store"))
        try:
            yield
        finally:
            dist.destroy_process_group()


def _trainer(heads: int, dp: bool, seq: int, sp: bool):
    """(instance, config, [batch, seq, embed], vocab) of the run asked for."""
    args = (SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-4))
    if sp:
        cfg = SP_LONGCTX
        inst = DistributedTrainingInstance(*build_parallel_transformer(cfg), *args,
                                           MachineMesh(1, 1), compute_dtype=torch.bfloat16)
        shape = (cfg.batch_size, cfg.sequence_length, cfg.num_features)
        return inst, dataclasses.asdict(cfg), shape, cfg.vocab_size
    cfg = dict(LONGCTX if seq == LONGCTX["seq"] else FLAGSHIP, heads=heads)
    trainer = DataParallelTrainingInstance if dp else ModelTrainingInstance
    inst = trainer(*build_flagship_cg(**cfg), *args, compute_dtype=torch.bfloat16)
    return inst, cfg, (cfg["batch"], cfg["seq"], cfg["embed"]), cfg["vocab"]


def profile_flagship(heads: int = FLAGSHIP["heads"], dp: bool = False, seq: int = 512,
                     sp: bool = False, warmup: int = 2, steps: int = 2) -> dict:
    with _one_rank_group(dp or sp):
        inst, cfg, shape, vocab = _trainer(heads, dp, seq, sp)
        params, opt_state = inst.initialize(seed=0)
        gen = torch.Generator(device=inst.device).manual_seed(0)
        x = torch.randn(*shape, generator=gen, device=inst.device)
        y = torch.randint(0, vocab, shape[:2], generator=gen, device=inst.device)
        for _ in range(warmup):
            inst.train_step(params, opt_state, {"x": x}, y)
        torch.cuda.synchronize()
        with device_trace() as prof:
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
        "config": cfg, "trainer": type(inst).__name__, "steps": steps,
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip(),
        "host_ms_per_step": host_ms, "kernel_ms_per_step": busy,
        "idle_share": (1.0 - busy / host_ms) if busy else None,
        "kernels_captured": len(by_name),
        "by_group_ms": dict(sorted(by_group.items(), key=lambda kv: -kv[1])),
        "copy_kernels_by_launcher_ms": copy_split(prof, steps),
        "top_kernels": [dict(name=k, **v) for k, v in top],
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--heads", type=int, default=FLAGSHIP["heads"],
                        help="attention heads at hidden 1024 (default %(default)s)")
    parser.add_argument("--dp", action="store_true",
                        help="train through the data-parallel trainer at world size 1")
    parser.add_argument("--seq", type=int, choices=(FLAGSHIP["seq"], LONGCTX["seq"]),
                        default=FLAGSHIP["seq"], help="512 (the flagship) or 2048 (LONGCTX)")
    parser.add_argument("--sp", action="store_true",
                        help="train SP_LONGCTX through the sequence-parallel trainer at world size 1")
    parser.add_argument("--out", type=Path, help="also write the JSON object here")
    args = parser.parse_args()
    result = profile_flagship(args.heads, args.dp, args.seq, args.sp)
    line = json.dumps(result)
    print(line)
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(line + "\n")


if __name__ == "__main__":
    main()
