"""Persistent cost-database maintenance CLI (port of tools/cost_db.py, over
flexflow_tpu_torch/compiler/cost_store.py and movement_store.py).

Operates on the on-disk JSON only — no torch import, so it runs anywhere the
store file does. Handles both store families:

- the cost database (``cost_db.json``, ``--cost-store-dir``): entries are
  objects {kind, op_class, device_kind, ms, mem, analytic_ms?};
- the movement-edge table (``--movement-cost-store``): entries are bare
  floats keyed ``...|<machine view>|<device kind>|<link class>`` (schema
  3, link class ``nvlink``/``ib``: the card's link classes, where the
  JAX package's tool knows ``ici``/``dcn``), with schema-1/2 migrants preserved
  under ``legacy1|``/``legacy2|`` prefixes.

Commands:

  stats PATH            entry census: per entry kind, op class, device
                        kind, link class, and measurement family —
                        ``-fwd``-fingerprinted forward-only serving
                        entries (cost_store.forward_fingerprint) are
                        counted apart from the fwd+bwd training op
                        census — plus the fitted correction factors
  verify PATH           schema + value screen (NaN/negative/inf ms, bad
                        entry shapes, v3 movement keys with an unknown
                        link class); exit 1 on any error
  prune PATH            drop entries by --device-kind / --link-class /
                        --family fwd|train and/or migrated entries older
                        than --older-than-schema N; rewrites the file
                        atomically

Examples:
  python -m flexflow_tpu_torch.tools.cost_db stats  store_dir/cost_db.json
  python -m flexflow_tpu_torch.tools.cost_db verify store_dir   # dir works too
  python -m flexflow_tpu_torch.tools.cost_db prune  store.json --device-kind cpu:cpu
  python -m flexflow_tpu_torch.tools.cost_db prune  store.json --older-than-schema 2
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import sys
import tempfile

LEGACY_PREFIX = "legacy"  # legacy<origin-schema>|<old key>

KNOWN_SCHEMAS = {1, 2, 3}

# schema-3 movement keys end ``...|<device kind>|<link class>``
# (movement_store.LINK_CLASSES — duplicated so the CLI stays torch-free)
LINK_CLASSES = ("nvlink", "ib")

# movement_edge_key shape signature: "PTShape([16, 16/2, 64], sum=4,
# copy=2, float32)" — sizes with optional /degree suffixes, optional
# replica degrees, trailing dtype name
_PTSHAPE_RE = re.compile(
    r"^PTShape\(\[(?P<dims>[^\]]*)\]"
    r"(?:, sum=\d+)?(?:, copy=\d+)?, (?P<dtype>\w+)\)$"
)

_DTYPE_BYTES = {
    "bool": 1, "int32": 4, "int64": 8, "float16": 2, "bfloat16": 2,
    "float32": 4, "float64": 8,
}


def movement_key_expected_bytes(key: str):
    """Bytes the `movement_edge_key` shape/dtype signature implies, or
    None when the key carries no parsable shape (empty-input edges,
    legacy migrants, malformed keys — the schema screen owns those).

    Key layout (movement_store.movement_edge_key):
        <Kind>|<nbytes>|<PTShape repr>|<machine view>|<device kind>
    optionally prefixed ``move|`` in the unified cost database."""
    k = key[5:] if key.startswith("move|") else key
    parts = k.split("|")
    if len(parts) < 3:
        return None
    m = _PTSHAPE_RE.match(parts[2])
    if m is None:
        return None
    dtype_bytes = _DTYPE_BYTES.get(m.group("dtype"))
    if dtype_bytes is None:
        return None
    n = 1
    for d in m.group("dims").split(","):
        d = d.strip()
        if not d:
            continue
        size = d.split("/")[0].strip()
        if not size.isdigit():
            return None
        n *= int(size)
    return n * dtype_bytes


def movement_key_recorded_bytes(key: str):
    """The bytes field the key itself records (segment 2), or None."""
    k = key[5:] if key.startswith("move|") else key
    parts = k.split("|")
    if len(parts) < 2 or not parts[1].isdigit():
        return None
    return int(parts[1])


def resolve_path(path: str) -> str:
    if os.path.isdir(path):
        return os.path.join(path, "cost_db.json")
    return path


def load(path: str):
    """(schema, entries, family) — family is "cost_db" (object entries) or
    "movement" (float entries). Raises SystemExit(1) on unreadable files."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError) as e:
        print(f"error: cannot read {path}: {e}", file=sys.stderr)
        raise SystemExit(1)
    schema = data.get("schema")
    entries = data.get("entries")
    if not isinstance(entries, dict):
        print(f"error: {path} has no entries table", file=sys.stderr)
        raise SystemExit(1)
    family = "movement"
    if any(isinstance(v, dict) for v in entries.values()):
        family = "cost_db"
    return schema, entries, family


def save(path: str, schema, entries) -> None:
    payload = {"schema": schema, "entries": {k: entries[k] for k in sorted(entries)}}
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".cost_db_cli_")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _legacy_origin(key: str):
    """Origin schema of a read-side-migrated key, or None."""
    if not key.startswith(LEGACY_PREFIX):
        return None
    head = key.split("|", 1)[0]
    digits = head[len(LEGACY_PREFIX):]
    return int(digits) if digits.isdigit() else None


def _device_kind_of(key: str, entry) -> str:
    if isinstance(entry, dict):
        return str(entry.get("device_kind", "unknown"))
    if _legacy_origin(key) is not None:
        return "unknown"
    if "|" not in key:
        return "unknown"
    # v3 movement keys end |<device kind>|<link class>; v2 end
    # |<device kind>
    tail = key.rsplit("|", 2)
    if len(tail) == 3 and tail[2] in LINK_CLASSES:
        return tail[1]
    return tail[-1]


def _link_class_of(key: str, entry):
    """Link class a live movement key records: "nvlink"/"ib" for v3 keys,
    "unknown" for v2-era keys (no trailing class), None for non-movement
    entries and legacy migrants (their class is unknowable by design)."""
    is_movement = not isinstance(entry, dict) or entry.get("kind") == "movement"
    if not is_movement or _legacy_origin(key) is not None:
        return None
    k = key[5:] if key.startswith("move|") else key
    last = k.rsplit("|", 1)[-1] if "|" in k else ""
    return last if last in LINK_CLASSES else "unknown"


def _op_family(key: str, entry):
    """Measurement family of an op entry: "fwd" for forward-only serving
    measurements (cost_store.forward_fingerprint tags the key's
    fingerprint segment ``-fwd``), "train" for fwd+bwd step timings,
    None for non-op entries. Key layout (cost_store.op_leaf_key):
    ``op|<device kind>|<fingerprint>|<op class>|...``."""
    if not isinstance(entry, dict) or entry.get("kind") != "op":
        return None
    parts = key.split("|")
    if len(parts) < 3 or parts[0] != "op":
        # pre-keyed / foreign op entry: family unknowable, count as train
        # (the fwd family is strictly opt-in via the fingerprint tag)
        return "train"
    return "fwd" if parts[2].endswith("-fwd") else "train"


def _finite_nonneg(v) -> bool:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return False
    return math.isfinite(f) and f >= 0.0


def cmd_stats(args) -> int:
    path = resolve_path(args.path)
    schema, entries, family = load(path)
    by_kind, by_class, by_device, by_link = {}, {}, {}, {}
    by_family, by_class_fwd = {}, {}
    pairs = legacy = 0
    for k, e in entries.items():
        if _legacy_origin(k) is not None:
            legacy += 1
        kind = e.get("kind", "?") if isinstance(e, dict) else "movement"
        by_kind[kind] = by_kind.get(kind, 0) + 1
        if isinstance(e, dict) and kind == "op":
            cls = e.get("op_class", "?")
            fam = _op_family(k, e)
            by_family[fam] = by_family.get(fam, 0) + 1
            # the forward-only serving family censuses apart from the
            # training ops: the two families price different quantities
            # and must never be read as one population
            if fam == "fwd":
                by_class_fwd[cls] = by_class_fwd.get(cls, 0) + 1
            else:
                by_class[cls] = by_class.get(cls, 0) + 1
            if e.get("analytic_ms") is not None:
                pairs += 1
        dk = _device_kind_of(k, e)
        by_device[dk] = by_device.get(dk, 0) + 1
        lc = _link_class_of(k, e)
        if lc is not None:
            by_link[lc] = by_link.get(lc, 0) + 1
    corrections = {}
    if family == "cost_db":
        # same fit the analytic estimator applies (per device kind)
        from collections import defaultdict

        logs = defaultdict(list)
        for e in entries.values():
            if not isinstance(e, dict) or e.get("kind") != "op":
                continue
            a, m = e.get("analytic_ms"), e.get("ms")
            if _finite_nonneg(a) and _finite_nonneg(m) and a and m:
                logs[(e.get("device_kind", "unknown"), e.get("op_class", "?"))].append(
                    math.log(float(m) / float(a))
                )
        for (dk, cls), ls in sorted(logs.items()):
            if len(ls) >= 2:
                corrections[f"{dk}/{cls}"] = {
                    "factor": round(math.exp(sum(ls) / len(ls)), 4),
                    "pairs": len(ls),
                }
    out = {
        "path": path,
        "schema": schema,
        "family": family,
        "entries": len(entries),
        "legacy_entries": legacy,
        "by_kind": dict(sorted(by_kind.items())),
        "by_op_family": dict(sorted(by_family.items())),
        "by_op_class": dict(sorted(by_class.items())),
        "by_op_class_fwd": dict(sorted(by_class_fwd.items())),
        "by_device_kind": dict(sorted(by_device.items())),
        "by_link_class": dict(sorted(by_link.items())),
        "analytic_pairs": pairs,
        "corrections": corrections,
    }
    print(json.dumps(out, indent=2 if not args.json else None))
    return 0


def verify_entries(schema, entries, family):
    """List of error strings (shared by `verify` and the tier-1 smoke
    test): unknown schema, malformed entries, NaN/negative/inf values,
    and — for movement entries — a bytes-consistency screen: the key's
    recorded bytes field must agree with the bytes its own shape/dtype
    signature derives (a disagreement means a corrupted or hand-edited
    entry whose measurement would be served for the WRONG tensor size)."""
    errors = []
    if schema not in KNOWN_SCHEMAS:
        errors.append(f"unknown schema {schema!r} (known: {sorted(KNOWN_SCHEMAS)})")
    for k, e in entries.items():
        is_movement = not isinstance(e, dict) or e.get("kind") == "movement"
        if isinstance(e, dict):
            if e.get("kind") not in ("op", "movement"):
                errors.append(f"{k}: unknown entry kind {e.get('kind')!r}")
            if not _finite_nonneg(e.get("ms")):
                errors.append(f"{k}: ms is not a finite non-negative number: {e.get('ms')!r}")
            if e.get("kind") == "op" and not e.get("op_class"):
                errors.append(f"{k}: op entry missing op_class")
            mem = e.get("mem", 0)
            if not isinstance(mem, int) or mem < 0:
                errors.append(f"{k}: mem is not a non-negative int: {mem!r}")
            a = e.get("analytic_ms")
            if a is not None and (not _finite_nonneg(a) or float(a) <= 0.0):
                errors.append(f"{k}: analytic_ms is not finite-positive: {a!r}")
        else:
            if not _finite_nonneg(e):
                errors.append(f"{k}: value is not a finite non-negative number: {e!r}")
        if is_movement and _legacy_origin(k) is None:
            recorded = movement_key_recorded_bytes(k)
            derived = movement_key_expected_bytes(k)
            if recorded is not None and derived is not None and recorded != derived:
                errors.append(
                    f"{k}: recorded bytes {recorded} disagree with the "
                    f"shape/dtype-derived bytes {derived} (corrupted or "
                    "hand-edited key)"
                )
            if family == "movement" and schema == 3:
                # a live v3 key whose trailing segment is not a known
                # link class would be served for BOTH interconnects
                # (an order of magnitude apart) — the exact contamination
                # v3 exists to prevent
                if _link_class_of(k, e) not in LINK_CLASSES:
                    errors.append(
                        f"{k}: v3 movement key carries no known link "
                        f"class (known: {list(LINK_CLASSES)})"
                    )
    return errors


def cmd_verify(args) -> int:
    path = resolve_path(args.path)
    schema, entries, family = load(path)
    errors = verify_entries(schema, entries, family)
    for e in errors:
        print(f"ERROR {e}", file=sys.stderr)
    if errors:
        print(f"{path}: {len(errors)} error(s)", file=sys.stderr)
        return 1
    print(f"{path}: {len(entries)} entries verified ({family}, schema {schema})")
    return 0


def cmd_prune(args) -> int:
    if (
        not args.device_kind
        and not args.link_class
        and not args.family
        and args.older_than_schema is None
    ):
        print("error: prune needs --device-kind, --link-class, --family, "
              "and/or --older-than-schema", file=sys.stderr)
        return 2
    if args.link_class and args.link_class not in LINK_CLASSES:
        print(f"error: unknown link class {args.link_class!r} "
              f"(known: {list(LINK_CLASSES)})", file=sys.stderr)
        return 2
    path = resolve_path(args.path)
    schema, entries, family = load(path)
    keep = {}
    removed = 0
    for k, e in entries.items():
        drop = False
        if args.device_kind and _device_kind_of(k, e) == args.device_kind:
            drop = True
        if args.link_class and _link_class_of(k, e) == args.link_class:
            drop = True
        if args.family and _op_family(k, e) == args.family:
            drop = True
        origin = _legacy_origin(k)
        if (
            args.older_than_schema is not None
            and origin is not None
            and origin < args.older_than_schema
        ):
            drop = True
        if drop:
            removed += 1
        else:
            keep[k] = e
    save(path, schema, keep)
    print(f"{path}: removed {removed} of {len(entries)} entries "
          f"({len(keep)} kept)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="cmd", required=True)
    st = sub.add_parser("stats", help="entry census + fitted corrections")
    st.add_argument("path")
    st.add_argument("--json", action="store_true",
                    help="single-line JSON output")
    st.set_defaults(fn=cmd_stats)
    vf = sub.add_parser("verify", help="schema + NaN/negative screen; exit 1 on errors")
    vf.add_argument("path")
    vf.set_defaults(fn=cmd_verify)
    pr = sub.add_parser("prune", help="drop entries by device kind / migration age")
    pr.add_argument("path")
    pr.add_argument("--device-kind", default="",
                    help="drop entries measured on this device kind "
                         "(e.g. cpu:cpu)")
    pr.add_argument("--link-class", default="",
                    help="drop live movement entries measured over this "
                         "link class (nvlink or ib)")
    pr.add_argument("--family", default="", choices=("", "fwd", "train"),
                    help="drop op entries of one measurement family: fwd "
                         "(forward-only serving, -fwd fingerprints) or "
                         "train (fwd+bwd step timings)")
    pr.add_argument("--older-than-schema", type=int, default=None,
                    help="drop read-side-migrated entries whose origin "
                         "schema is older than N (e.g. 2 drops legacy1| "
                         "movement keys)")
    pr.set_defaults(fn=cmd_prune)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
