"""ffreport: render one training/serving run from its metrics directory
(port of tools/ffreport.py).

The observability streams (`FFConfig(metrics_dir=...)`, `--metrics-dir`;
observability/metrics.py) record everything a post-mortem needs — the
per-step JSONL event stream (events.jsonl), the registry snapshot
(metrics.json), and a provenance.json snapshot of the compile-time verdicts
plus the live drift monitor's advisories. ffreport is the read side: point
it at any metrics dir, the port's or the JAX package's (the streams are the
same), and it renders

- run health: step/skip/nonfinite counters, final loss, step wall-clock
  percentiles (nearest-rank, the shared estimator);
- the throughput trajectory: tokens/s bucketed over the run, so a
  mid-run slowdown is visible at a glance;
- the lifecycle timeline: every out-of-band event (hang, recovery,
  drift, serving admissions) in stream order;
- the drift verdict: the monitor's baseline/EMA ratios and each
  ReplanAdvisory (cause, drift factor, candidate plan, predicted
  savings) — or "unmonitored" when the run had no monitor;
- plan fidelity: the plan audit's predicted/measured geomean ratios;
- pipeline: the 1F1B stage/microbatch shape and its predicted bubble
  fraction beside the measured mean step time.

Usage:
    python -m flexflow_tpu_torch.tools.ffreport <metrics_dir>
    python -m flexflow_tpu_torch.tools.ffreport --json <metrics_dir>   # one object per line
    python -m flexflow_tpu_torch.tools.ffreport --follow <metrics_dir> # tail the live run

Exit contract (mirrors ffcheck): 0 for a readable metrics dir, 1 when
the dir is malformed — missing, no events.jsonl, no parseable event, or
a provenance.json that exists but is not valid JSON. A healthy report
over a real run always exits 0; CI can gate on it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import List, Optional

from flexflow_tpu_torch.observability.metrics import nearest_rank_percentile, tail_events
from flexflow_tpu_torch.pcg.pipeline import pipeline_bubble_fraction


# ---------------------------------------------------------------------------
# loading
# ---------------------------------------------------------------------------


class MalformedMetricsDir(ValueError):
    """The directory cannot be reported on (exit-1 condition)."""


def load_run(metrics_dir: str) -> dict:
    """Parse a metrics dir into {events, steps, lifecycle, registry,
    provenance}; raises MalformedMetricsDir on the exit-1 conditions."""
    if not os.path.isdir(metrics_dir):
        raise MalformedMetricsDir(f"not a directory: {metrics_dir!r}")
    events_path = os.path.join(metrics_dir, "events.jsonl")
    if not os.path.isfile(events_path):
        raise MalformedMetricsDir(f"no events.jsonl in {metrics_dir!r}")
    events, _ = tail_events(metrics_dir, 0)
    if not events:
        raise MalformedMetricsDir(
            f"events.jsonl in {metrics_dir!r} holds no parseable event"
        )
    registry = None
    reg_path = os.path.join(metrics_dir, "metrics.json")
    if os.path.isfile(reg_path):
        try:
            with open(reg_path) as f:
                registry = json.load(f)
        except ValueError:
            # a torn registry write is survivable — the stream rebuilds
            # every aggregate; note it rather than dying
            registry = None
    provenance = None
    prov_path = os.path.join(metrics_dir, "provenance.json")
    if os.path.isfile(prov_path):
        try:
            with open(prov_path) as f:
                provenance = json.load(f)
        except ValueError as e:
            raise MalformedMetricsDir(
                f"provenance.json in {metrics_dir!r} is not valid JSON: {e}"
            )
    return {
        "events": events,
        "steps": [e for e in events if "step" in e and "event" not in e],
        "lifecycle": [e for e in events if "event" in e],
        "registry": registry,
        "provenance": provenance,
    }


# ---------------------------------------------------------------------------
# sections (each returns a JSON-able dict; rendering is separate)
# ---------------------------------------------------------------------------


def _finite(vals) -> List[float]:
    out = []
    for v in vals:
        if isinstance(v, (int, float)) and math.isfinite(v):
            out.append(float(v))
    return out


def section_health(run: dict) -> dict:
    steps = run["steps"]
    ms = sorted(_finite(e.get("wallclock_ms") for e in steps))
    losses = _finite(e.get("loss") for e in steps)
    return {
        "section": "health",
        "steps": len(steps),
        "skipped": sum(1 for e in steps if e.get("skipped")),
        "nonfinite": sum(1 for e in steps if e.get("nonfinite")),
        "first_loss": losses[0] if losses else None,
        "last_loss": losses[-1] if losses else None,
        "step_ms": {
            "p50": nearest_rank_percentile(ms, 50),
            "p90": nearest_rank_percentile(ms, 90),
            "p99": nearest_rank_percentile(ms, 99),
            "mean": sum(ms) / len(ms) if ms else None,
        },
    }


def section_throughput(run: dict, buckets: int = 10) -> dict:
    """Tokens/s bucketed over the run, oldest first — the trajectory a
    drifting run bends."""
    steps = [
        e for e in run["steps"]
        if isinstance(e.get("tokens_per_s"), (int, float))
    ]
    traj = []
    if steps:
        n = max(1, min(buckets, len(steps)))
        size = len(steps) / n
        for i in range(n):
            chunk = steps[int(i * size): int((i + 1) * size)] or [steps[-1]]
            traj.append(
                round(
                    sum(float(e["tokens_per_s"]) for e in chunk)
                    / len(chunk),
                    2,
                )
            )
    return {
        "section": "throughput",
        "samples": len(steps),
        "tokens_per_s": traj,
    }


def section_timeline(run: dict, limit: int = 50) -> dict:
    """The out-of-band lifecycle events in stream order (hang, recovery,
    drift, serving admissions — anything append_run_event wrote)."""
    entries = []
    for e in run["lifecycle"]:
        entry = {"event": e.get("event")}
        for key in ("step", "cause", "reason", "site"):
            if key in e:
                entry[key] = e[key]
        entries.append(entry)
    return {
        "section": "timeline",
        "total": len(entries),
        "events": entries[:limit],
    }


def section_drift(run: dict) -> dict:
    """The drift monitor's verdict: provenance["drift"] when the run
    carried a monitor, cross-checked against the stream's drift events."""
    prov = run["provenance"] or {}
    report = prov.get("drift")
    stream = [e for e in run["lifecycle"] if e.get("event") == "drift"]
    if not isinstance(report, dict):
        return {
            "section": "drift",
            "verdict": "unmonitored",
            "stream_events": len(stream),
        }
    advisories = report.get("advisories") or []
    verdict = "drifting" if advisories else "healthy"
    out = {
        "section": "drift",
        "verdict": verdict,
        "predicted_ms": report.get("predicted_ms"),
        "baseline_ratio": report.get("baseline_ratio"),
        "ema_ratio": report.get("ema_ratio"),
        "windows": report.get("windows"),
        "band": report.get("band"),
        "advisories": len(advisories),
        "stream_events": len(stream),
        "reprice_errors": report.get("reprice_errors"),
    }
    if advisories:
        last = advisories[-1]
        out["last_advisory"] = {
            k: last.get(k)
            for k in (
                "cause", "step", "drift", "candidate", "candidate_ms",
                "current_ms", "predicted_savings_ms", "repriced",
            )
        }
    return out


def section_plan(run: dict) -> dict:
    """Compile-time plan fidelity: the audit's predicted/measured geomean
    ratios and the search's headline numbers."""
    prov = run["provenance"] or {}
    audit = prov.get("plan_audit") or {}
    return {
        "section": "plan",
        "estimated_ms": prov.get("estimated_ms"),
        "serial_ms": prov.get("serial_ms"),
        "search_algorithm": prov.get("search_algorithm"),
        "parallel_degrees": prov.get("parallel_degrees"),
        "audit": {
            k: audit.get(k)
            for k in (
                "op_geomean_ratio",
                "movement_geomean_ratio",
                "geomean_ratio",
                "skipped",
                "error",
            )
            if k in audit
        }
        or None,
    }


def section_pipeline(run: dict) -> Optional[dict]:
    """1F1B shape + predicted bubble beside the measured mean step —
    None (omitted) for non-pipelined runs."""
    prov = run["provenance"] or {}
    pipe = prov.get("pipeline")
    if not isinstance(pipe, dict):
        return None
    out = {"section": "pipeline"}
    out.update(pipe)
    stages = pipe.get("num_stages")
    micro = pipe.get("num_microbatches")
    if isinstance(stages, int) and isinstance(micro, int) and stages >= 1:
        out["predicted_bubble"] = round(
            pipeline_bubble_fraction(stages, micro), 4
        )
    ms = _finite(e.get("wallclock_ms") for e in run["steps"])
    out["measured_mean_step_ms"] = (
        round(sum(ms) / len(ms), 4) if ms else None
    )
    return out


def build_report(metrics_dir: str) -> List[dict]:
    run = load_run(metrics_dir)
    sections = [
        section_health(run),
        section_throughput(run),
        section_timeline(run),
        section_drift(run),
        section_plan(run),
    ]
    pipe = section_pipeline(run)
    if pipe is not None:
        sections.append(pipe)
    return sections


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------


def _fmt(v) -> str:
    if isinstance(v, float):
        return f"{v:.4g}"
    return str(v)


def render_text(sections: List[dict], out=None) -> None:
    out = out or sys.stdout
    for s in sections:
        name = s["section"]
        print(f"== {name} ==", file=out)
        if name == "timeline":
            print(f"  lifecycle events: {s['total']}", file=out)
            for e in s["events"]:
                bits = " ".join(
                    f"{k}={_fmt(v)}" for k, v in e.items() if k != "event"
                )
                print(f"  - {e['event']} {bits}".rstrip(), file=out)
            continue
        for k, v in s.items():
            if k == "section":
                continue
            if isinstance(v, dict):
                inner = " ".join(
                    f"{ik}={_fmt(iv)}" for ik, iv in v.items()
                )
                print(f"  {k}: {inner}", file=out)
            elif isinstance(v, list):
                print(
                    f"  {k}: [{', '.join(_fmt(x) for x in v)}]", file=out
                )
            else:
                print(f"  {k}: {_fmt(v)}", file=out)


def follow(metrics_dir: str, args, out=None) -> int:
    """Tail the live stream: print each new event as it lands (steps as
    one-liners, lifecycle events highlighted). `--follow-polls` bounds
    the loop (tests, batch jobs); 0 means until interrupted."""
    out = out or sys.stdout
    cursor = 0
    polls = 0
    try:
        while True:
            events, cursor = tail_events(metrics_dir, cursor)
            for e in events:
                if args.json:
                    print(json.dumps(e), file=out, flush=True)
                elif "event" in e:
                    bits = " ".join(
                        f"{k}={_fmt(v)}"
                        for k, v in e.items()
                        if k not in ("schema", "event")
                        and not isinstance(v, (dict, list))
                    )
                    print(f"[{e['event']}] {bits}", file=out, flush=True)
                else:
                    print(
                        f"step {e.get('step')}: "
                        f"loss={_fmt(e.get('loss'))} "
                        f"ms={_fmt(e.get('wallclock_ms'))}",
                        file=out,
                        flush=True,
                    )
            polls += 1
            if args.follow_polls and polls >= args.follow_polls:
                return 0
            time.sleep(args.poll_interval)
    except KeyboardInterrupt:
        return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ffreport", description=__doc__.split("\n\n")[0]
    )
    ap.add_argument("metrics_dir", help="a --metrics-dir directory")
    ap.add_argument(
        "--json", action="store_true",
        help="one JSON object per section (machine-readable)",
    )
    ap.add_argument(
        "--follow", action="store_true",
        help="tail the live event stream instead of a one-shot report",
    )
    ap.add_argument(
        "--follow-polls", type=int, default=0,
        help="stop --follow after N polls (0 = until interrupted)",
    )
    ap.add_argument(
        "--poll-interval", type=float, default=0.5,
        help="--follow poll interval in seconds",
    )
    args = ap.parse_args(argv)
    if args.follow:
        return follow(args.metrics_dir, args)
    try:
        sections = build_report(args.metrics_dir)
    except MalformedMetricsDir as e:
        if args.json:
            print(json.dumps({"section": "error", "error": str(e)}))
        else:
            print(f"ffreport: {e}", file=sys.stderr)
        return 1
    if args.json:
        for s in sections:
            print(json.dumps(s))
    else:
        render_text(sections)
    return 0


if __name__ == "__main__":
    sys.exit(main())
