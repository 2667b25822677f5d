"""On-disk measured movement-edge cost table (copy of
flexflow_tpu/compiler/movement_store.py).

The plan audit (observability/plan_audit.py) times each movement edge of
the executed plan, the reshard collective between the producer's and the
consumer's shardings. This module persists those measurements in a small
JSON table keyed by

    (edge kind, moved bytes, input parallel-shape signature, machine view,
     device kind, link class)

and lets the search-side estimators prefer a stored measurement over the
analytic collective estimate (`parallel_op_cost_ms`): the key is
constructible both at audit time (pcg node + mapping view) and at search
time (`OpCostEstimateKey`), so a plan audited once prices its movement
edges from measurement after.

The key layout is the JAX package's schema v3 with the link classes named
for the card: ``nvlink`` within a node (NVLink/NVSwitch) and ``ib`` across
nodes (InfiniBand), in place of JAX's ``ici`` and ``dcn``. Older files
migrate on read as the JAX package's do: a v1 file (no device kind) keeps
its entries under ``legacy1|`` and a v2 file (no link class) under
``legacy2|``; neither is ever served, since their origin device kind or
link is unknowable.

Scope note: the analytic estimate being replaced covers fwd+bwd of the
collective while the audit times the forward reshard only; the stored
value is the audit's number, recorded verbatim. Entries are never evicted:
a stale entry goes with the file.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, Optional

STORE_SCHEMA_VERSION = 3

# read-side migration tags for entries carried over from older files
# (v1: device kind unknown; v2: link class unknown — preserved, never
# preferred)
LEGACY_V1_PREFIX = "legacy1|"
LEGACY_V2_PREFIX = "legacy2|"

# the interconnect classes a movement edge can ride: NVLink/NVSwitch within
# a node, InfiniBand across nodes
LINK_CLASSES = ("nvlink", "ib")


def movement_edge_key(
    attrs,
    input_shapes,
    machine_view,
    device_kind: Optional[str] = None,
    link_class: str = "nvlink",
) -> str:
    """Stable identity of one movement edge's collective: the parallel-op
    kind, the moved tensor's global bytes, the input's full parallel-shape
    repr (degrees + dtype), the machine view that placed it, the device
    kind it was measured on, and the link class (``nvlink``/``ib``) its
    axis rode. Two edges with equal keys lower to the same collective on the
    same machine over the same interconnect."""
    from flexflow_tpu_torch.compiler.cost_store import device_kind_signature
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape

    if link_class not in LINK_CLASSES:
        raise ValueError(
            f"unknown link class {link_class!r} (known: {LINK_CLASSES})"
        )
    dk = device_kind if device_kind is not None else device_kind_signature()
    kind = type(attrs).__name__
    if not input_shapes:
        return f"{kind}|0||{machine_view!r}|{dk}|{link_class}"
    nbytes = get_reduced_shape(input_shapes[0]).size_bytes
    return (
        f"{kind}|{nbytes}|{input_shapes[0]!r}|{machine_view!r}|{dk}"
        f"|{link_class}"
    )


class MovementCostStore:
    """JSON-backed measured movement-edge costs. Reads are in-memory;
    `put` marks dirty and `save` merges this session's writes over a
    freshly re-read on-disk table before the atomic replace (tmp +
    rename), so a crashed audit never truncates the table and two
    processes sharing a store path never drop each other's entries
    (last-writer-wins per key)."""

    def __init__(self, path: str) -> None:
        from flexflow_tpu_torch.compiler.cost_store import _require_dir

        _require_dir(path)
        self.path = path
        self._table: Dict[str, float] = self._read_disk()
        self._written: set = set()
        self.dirty = False

    def _read_disk(self) -> Dict[str, float]:
        if not os.path.exists(self.path):
            return {}
        try:
            with open(self.path) as f:
                data = json.load(f)
            schema = data.get("schema")
            entries = {
                str(k): float(v) for k, v in data.get("entries", {}).items()
            }
            if schema == STORE_SCHEMA_VERSION:
                return entries
            if schema == 2:
                # v2 keys carry no link class, so their measurements could
                # be served for an edge riding the other interconnect;
                # keep the data (another process may still
                # be on v2) but fence it off. Entries a v2 file itself
                # carried as legacy1| migrants stay under their original
                # tag.
                return {
                    k
                    if k.startswith((LEGACY_V1_PREFIX, LEGACY_V2_PREFIX))
                    else LEGACY_V2_PREFIX + k: v
                    for k, v in entries.items()
                }
            if schema == 1:
                # v1 keys carry no device kind, so their measurements
                # cannot be safely preferred on ANY device; keep the data
                # (another process may still be on v1) but fence it off
                return {
                    k if k.startswith(LEGACY_V1_PREFIX)
                    else LEGACY_V1_PREFIX + k: v
                    for k, v in entries.items()
                }
            return {}
        except (OSError, ValueError, TypeError):
            # unreadable/corrupt store: start empty rather than crash
            # the compile; the next save rewrites it whole
            return {}

    def __len__(self) -> int:
        return len(self._table)

    def get(self, key: str) -> Optional[float]:
        return self._table.get(key)

    def get_edge(
        self, attrs, input_shapes, machine_view, link_class: str = "nvlink"
    ) -> Optional[float]:
        if machine_view is None:
            return None
        return self.get(
            movement_edge_key(
                attrs, input_shapes, machine_view, link_class=link_class
            )
        )

    def put(self, key: str, ms: float) -> None:
        if ms is None or not (ms >= 0.0):
            return  # NaN/negative measurements never enter the table
        self._table[key] = float(ms)
        self._written.add(key)
        self.dirty = True

    def put_edge(
        self,
        attrs,
        input_shapes,
        machine_view,
        ms: float,
        link_class: str = "nvlink",
    ) -> None:
        if machine_view is None:
            return
        self.put(
            movement_edge_key(
                attrs, input_shapes, machine_view, link_class=link_class
            ),
            ms,
        )

    def save(self) -> None:
        if not self.dirty:
            return
        # lost-update fix: rewriting the whole table from memory dropped
        # every entry a concurrent process saved after our load — merge
        # with the CURRENT disk table, our own writes winning per key
        disk = self._read_disk()
        merged = dict(disk)
        for k in self._written:
            if k in self._table:
                merged[k] = self._table[k]
        self._table = merged
        payload = {
            "schema": STORE_SCHEMA_VERSION,
            "entries": {k: merged[k] for k in sorted(merged)},
        }
        d = os.path.dirname(os.path.abspath(self.path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, prefix=".movement_store_")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(payload, f, indent=1, sort_keys=True)
            os.replace(tmp, self.path)
        except OSError:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
        self.dirty = False
