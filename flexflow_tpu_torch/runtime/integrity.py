"""Checkpoint integrity: per-leaf checksums and a dtype/shape manifest (copy
of flexflow_tpu/runtime/integrity.py, the same manifest byte for byte).

- At save, `build_manifest` makes `keys.json` a manifest object carrying,
  per leaf, a CRC32 of the raw array bytes plus the dtype and shape
  (`{"integrity": 1, "keys": [...], "leaves": {key: {"crc32", "dtype",
  "shape", "nbytes"}}}`).
- At restore, `verify_and_load_leaves` re-reads every leaf and checks file
  presence, loadability (a zero-length `.npy` is caught here, not as an
  EOFError in the training script), dtype, shape and checksum, and raises
  `IntegrityViolation` naming the first bad leaf and why.

Legacy checkpoints (a list-form `keys.json`, or the single-archive
`state.npz` from before it) carry no checksums: they load as
verified-as-legacy with one warning per directory.

CRC32 (zlib) rather than a cryptographic hash: the threat is bit rot,
truncation and torn writes, not an adversary, and zlib.crc32 runs at
memory speed with no dependency. The digest is taken over the array's
buffer, not a copy of it. The policy half, quarantining a corrupt step as
`step_N.corrupt` and falling back to the newest step that verifies, lives
in `runtime/checkpoint.py`.
"""

from __future__ import annotations

import json
import os
import sys
import zlib
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

MANIFEST_VERSION = 1


class IntegrityViolation(Exception):
    """One leaf (or the manifest itself) failed verification; checkpoint.py
    wraps it into a CheckpointCorruptError with directory and step."""

    def __init__(self, reason: str, leaf: Optional[str] = None) -> None:
        super().__init__(reason if leaf is None else f"leaf {leaf!r}: {reason}")
        self.reason = reason
        self.leaf = leaf


def leaf_digest(arr: np.ndarray) -> Dict[str, object]:
    """The verifiable identity of one host array leaf."""
    a = np.ascontiguousarray(arr)
    return {
        "crc32": zlib.crc32(a.reshape(-1).view(np.uint8)) & 0xFFFFFFFF,
        "dtype": str(a.dtype),
        "shape": [int(d) for d in a.shape],
        "nbytes": int(a.nbytes),
    }


def build_manifest(order: List[str], flat: Dict[str, np.ndarray]) -> Dict[str, object]:
    """The keys.json payload: the ordered key list and per-leaf digests."""
    return manifest_of(order, {key: leaf_digest(flat[key]) for key in order})


def manifest_of(order: List[str], digests: Dict[str, dict]) -> Dict[str, object]:
    """build_manifest from digests already taken (the writer takes them as
    it writes each leaf)."""
    return {
        "integrity": MANIFEST_VERSION,
        "keys": list(order),
        "leaves": {key: digests[key] for key in order},
    }


def parse_keys_json(payload) -> Tuple[List[str], Optional[Dict[str, dict]]]:
    """(ordered keys, leaf digests or None for the legacy list layout)
    from a keys.json payload; anything else is corrupt."""
    if isinstance(payload, list):
        return list(payload), None
    if isinstance(payload, dict) and "keys" in payload:
        keys = payload["keys"]
        leaves = payload.get("leaves")
        if not isinstance(keys, list) or not isinstance(leaves, dict):
            raise IntegrityViolation("malformed keys.json manifest")
        return list(keys), leaves
    raise IntegrityViolation("keys.json is neither a legacy key list nor a manifest object")


def _load_leaf(path: str, key: str) -> np.ndarray:
    """np.load with every truncation and garbage failure normalized to
    IntegrityViolation (a zero-length file raises EOFError, a torn header
    ValueError, a missing file OSError)."""
    if not os.path.exists(path):
        raise IntegrityViolation(f"missing array file {os.path.basename(path)}", leaf=key)
    if os.path.getsize(path) == 0:
        raise IntegrityViolation(f"zero-length array file {os.path.basename(path)}", leaf=key)
    try:
        return np.load(path, allow_pickle=False)
    except Exception as e:
        raise IntegrityViolation(
            f"unreadable array file {os.path.basename(path)}: {type(e).__name__}: {e}",
            leaf=key,
        ) from e


_LEGACY_WARNED: Set[str] = set()


def warn_legacy_once(directory: str, what: str) -> bool:
    """One warning per checkpoint directory per process for a legacy
    (checksum-less) restore. Returns True when the warning printed."""
    if directory in _LEGACY_WARNED:
        return False
    _LEGACY_WARNED.add(directory)
    print(
        f"[flexflow_tpu_torch] checkpoint {directory}: {what} carries no "
        "integrity manifest; restoring verified-as-legacy (re-save to "
        "add per-leaf checksums)",
        file=sys.stderr,
    )
    return True


def verify_and_load_leaves(step_dir: str, verify: bool = True) -> Tuple[Dict[str, np.ndarray], bool]:
    """Load the raw-.npy layout under `step_dir`, verifying each leaf
    against the manifest when there is one. Returns (flat key -> array,
    verified): verified is True only when checksums were checked (a
    manifest exists and `verify` was on). Raises IntegrityViolation on any
    mismatch."""
    keys_path = os.path.join(step_dir, "keys.json")
    if not os.path.exists(keys_path):
        raise IntegrityViolation("missing keys.json")
    try:
        with open(keys_path) as f:
            payload = json.load(f)
    except ValueError as e:
        raise IntegrityViolation(f"unparseable keys.json: {e}") from e
    order, leaves = parse_keys_json(payload)
    flat: Dict[str, np.ndarray] = {}
    for i, key in enumerate(order):
        arr = _load_leaf(os.path.join(step_dir, f"arr_{i}.npy"), key)
        if leaves is not None and verify:
            digest = leaves.get(key)
            if digest is None:
                raise IntegrityViolation("manifest lists no digest for this key", leaf=key)
            got = leaf_digest(arr)
            for field in ("dtype", "shape", "crc32"):
                if got[field] != digest.get(field):
                    raise IntegrityViolation(
                        f"{field} mismatch: stored {got[field]!r} vs manifest "
                        f"{digest.get(field)!r}",
                        leaf=key,
                    )
        flat[key] = arr
    if leaves is not None and verify:
        extra = sorted(set(leaves) - set(order))
        if extra:
            raise IntegrityViolation(f"manifest digests for keys not in the key list: {extra[:8]}")
    if leaves is None and verify:
        warn_legacy_once(os.path.dirname(step_dir), "list-form keys.json")
    return flat, leaves is not None and verify


__all__ = [
    "MANIFEST_VERSION",
    "IntegrityViolation",
    "build_manifest",
    "leaf_digest",
    "manifest_of",
    "parse_keys_json",
    "verify_and_load_leaves",
    "warn_legacy_once",
]
