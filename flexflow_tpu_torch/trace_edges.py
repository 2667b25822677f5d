"""How many device records a torch.profiler trace of the fused fit loses, on one card.

    python3 -m flexflow_tpu_torch.trace_edges [--seconds S]

Compiles the full-width flagship through FFModel with steps_per_dispatch=8
(bf16, Adam, accuracy and sparse CE; each window one CUDA graph replay, as in
chip_smoke's fit_window), fits two windows to capture and warm it, then for
about --seconds traces two-window fits in pairs: one whose trace closes right
after the fit's synchronize ("closed at the fit"), one through
profile_step.device_trace, TRACE_EDGE_S of idle host time at each end ("idle
edges"). Prints one JSON line a trace: the device records it holds; the flash
kernels' launches and whether they are whole (12 layers x 16 steps of each);
and, against the fullest trace of the run, which records it lacks, and for how
many records from its start and from its end it agrees with that trace (a
trace that lost its first records agrees with it from its start for 0 of
them, one that lost its last ones from its end for 0). The last line sums each
layout up.
"""

from __future__ import annotations

import argparse
import collections
import json
import subprocess
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from flexflow_tpu_torch.core import AdamOptimizer, FFConfig, FFModel
from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg
from flexflow_tpu_torch.profile_step import TRACE_EDGE_S, device_trace

WINDOW, WINDOWS = 8, 2  # steps a window, windows a traced fit
FLASH = ("ff_flash_fwd_kernel", "ff_flash_delta_kernel", "ff_flash_bwd_dkv_kernel",
         "ff_flash_bwd_dq_kernel")
LAYOUTS = {"closed at the fit": False, "idle edges": True}
METRICS = ["accuracy", "sparse_categorical_crossentropy"]  # fit_window's


def _traced_fit(m: FFModel, x, y, edges: bool) -> list:
    """The device records' names, in order of start, of one traced fit."""
    torch.cuda.synchronize()
    trace = device_trace() if edges else profile(
        activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    with trace as prof:
        m.fit(x, y, epochs=1, shuffle=False, verbose=False)
        torch.cuda.synchronize()
    gpu = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return [e.name for e in sorted(gpu, key=lambda e: e.time_range.start)]


def _agree(a: list, b: list) -> int:
    n = 0
    while n < min(len(a), len(b)) and a[n] == b[n]:
        n += 1
    return n


def compare(traces: list, whole: int) -> tuple:
    """(a record a trace, a summary by layout) of `traces`, (layout, the
    device records' names in order) pairs, against the one that holds the
    most records; `whole` is each flash kernel's launches in a whole trace."""
    fullest = max((seq for _, seq in traces), key=len)
    summary = {layout: {"traces": 0, "short": 0, "flash_not_whole": 0, "lost_first": 0,
                        "lost_last": 0, "most_records_lost": 0}
               for layout in dict.fromkeys(layout for layout, _ in traces)}
    records = []
    for i, (layout, seq) in enumerate(traces):
        names = collections.Counter(seq)
        flash = {k: names[k] for k in FLASH}
        lost = collections.Counter(fullest) - names
        rec = {"trace": i, "layout": layout, "records": len(seq), "flash": flash,
               "flash_whole": all(n == whole for n in flash.values()),
               "lost": {k[:80]: n for k, n in lost.items()},
               "agree_from_start": _agree(seq, fullest),
               "agree_from_end": _agree(seq[::-1], fullest[::-1])}
        records.append(rec)
        s = summary[layout]
        s["traces"] += 1
        s["short"] += len(seq) < len(fullest)
        s["flash_not_whole"] += not rec["flash_whole"]
        s["lost_first"] += bool(lost) and rec["agree_from_start"] == 0
        s["lost_last"] += bool(lost) and rec["agree_from_end"] == 0
        s["most_records_lost"] = max(s["most_records_lost"], sum(lost.values()))
    return records, summary


def trace_edges(seconds: float = 300.0) -> dict:
    cfg, b = FLAGSHIP, FLAGSHIP["batch"]
    steps = WINDOW * WINDOWS
    m = FFModel.from_computation_graph(
        *build_flagship_cg(**cfg),
        config=FFConfig(batch_size=b, seed=0, print_freq=0, steps_per_dispatch=WINDOW))
    m.compile(AdamOptimizer(alpha=1e-4), "sparse_categorical_crossentropy", metrics=METRICS,
              compute_dtype=torch.bfloat16)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((steps * b, cfg["seq"], cfg["embed"]), dtype=np.float32)
    y = rng.integers(0, cfg["vocab"], (steps * b, cfg["seq"]), dtype=np.int32)
    m.fit(x, y, epochs=1, shuffle=False, verbose=False)  # the capture, then a replay

    traces = []
    start = time.perf_counter()
    while time.perf_counter() - start < seconds:
        for layout, edges in LAYOUTS.items():
            traces.append((layout, _traced_fit(m, x, y, edges)))
    records, summary = compare(traces, cfg["layers"] * steps)
    for rec in records:
        print(json.dumps(rec), flush=True)
    return {
        "card": subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip(),
        "torch": torch.__version__, "config": cfg, "steps_per_dispatch": WINDOW,
        "steps_a_trace": steps, "edge_s": TRACE_EDGE_S,
        "fullest_records": max(r["records"] for r in records), "by_layout": summary,
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seconds", type=float, default=300.0,
                        help="how long to keep tracing pairs (default %(default)s)")
    print(json.dumps(trace_edges(parser.parse_args().seconds)))


if __name__ == "__main__":
    main()
