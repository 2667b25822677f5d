"""The JSONL run-event stream (trimmed copy of
flexflow_tpu/observability/metrics.py).

Events are appended to `<metrics_dir>/events.jsonl`, one JSON object a
line, marked by an `event` key and the schema version, in the same layout
as the JAX package's stream, so either package's reader reads the other's.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

EVENT_SCHEMA_VERSION = 1


def nearest_rank_percentile(sorted_samples, q: float) -> Optional[float]:
    """Nearest-rank percentile over pre-sorted samples: ceil(q/100 * n) - 1
    (the JAX package's one percentile convention)."""
    n = len(sorted_samples)
    if not n:
        return None
    return sorted_samples[min(n - 1, max(math.ceil(q / 100.0 * n) - 1, 0))]


def read_events(metrics_dir: str) -> List[Dict[str, object]]:
    """Parse `<metrics_dir>/events.jsonl`."""
    path = os.path.join(metrics_dir, "events.jsonl")
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                out.append(json.loads(line))
    return out


def append_run_event(metrics_dir: str, kind: str, **payload) -> Dict[str, object]:
    """Append one run event of `kind` to `<metrics_dir>/events.jsonl`."""
    os.makedirs(metrics_dir, exist_ok=True)
    event = {"schema": EVENT_SCHEMA_VERSION, "event": str(kind), **payload}
    with open(os.path.join(metrics_dir, "events.jsonl"), "a") as f:
        f.write(json.dumps(event) + "\n")
    return event


def read_run_events(
    metrics_dir: str, kind: Optional[str] = None
) -> List[Dict[str, object]]:
    """The run events of a metrics stream (optionally one kind)."""
    return [
        e
        for e in read_events(metrics_dir)
        if "event" in e and (kind is None or e["event"] == kind)
    ]
