"""The collective census a recorded step reads (analysis/step_program.py).

Every collective a train or serving step issues through the port's own
transport (parallel/collectives.py, the mesh's gathers and ring steps, the
pipeline's stage exchanges, the data-parallel buckets) calls `note` with
its kind, its payload bytes and its group size. Outside a recording that is
one global read. Inside `recording()` each note is appended, with the PCG
node whose evaluation issued it (`node_scope`, set by the executor around
each node and carried into the backward by the autograd functions).

Kinds are the JAX package's census names, so the communication cross-check
(analysis/comm_analysis.py) matches either package's census against one
set of predictions: "all-gather", "all-reduce", "all-to-all" and
"collective-permute" (a point-to-point hop: a ring step or a stage
transfer). Bytes are the materialized result a device holds: the gathered
whole for an all-gather, the reduced buffer for an all-reduce, the tensor
sent for a hop. A bucket (one all-reduce of several gradients, flattened
together) is one note, as it is one collective, with its members' nodes
and byte splits as `parts`.

`transport()` marks host staging that is the backend's transport and not
the program's: gloo takes host tensors, so a card's tensor crosses pinned
host memory around each gloo collective. The recorder counts no host
transfer inside it (COMM004 is about the step's own host reads).
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

_LOG: Optional[List[Dict[str, object]]] = None
_NODE: Optional[int] = None
_TRANSPORT = 0


def tensor_bytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def note(kind: str, nbytes: int, group_size: int, node: Optional[int] = None,
         parts: Optional[Sequence[Tuple[Optional[int], int]]] = None) -> None:
    """Count one collective of the step being recorded (a no-op outside a
    recording). `node`: the issuing PCG node, else the current scope's.
    `parts`: a bucket's members as (node, bytes), a None node read as the
    current scope's."""
    if _LOG is None or group_size <= 1:
        return
    entry = {"kind": kind, "bytes": int(nbytes), "group_size": int(group_size),
             "node": _NODE if node is None else int(node)}
    if parts is not None:
        entry["parts"] = [[_NODE if n is None else int(n), int(b)] for n, b in parts]
    _LOG.append(entry)


def current_node() -> Optional[int]:
    return _NODE


@contextlib.contextmanager
def node_scope(node: Optional[int]) -> Iterator[None]:
    """Attribute the collectives issued inside to PCG node `node` (an idx)."""
    global _NODE
    prev, _NODE = _NODE, node
    try:
        yield
    finally:
        _NODE = prev


@contextlib.contextmanager
def transport() -> Iterator[None]:
    """Host staging of a collective's own transport (module note)."""
    global _TRANSPORT
    _TRANSPORT += 1
    try:
        yield
    finally:
        _TRANSPORT -= 1


def transporting() -> bool:
    return _TRANSPORT > 0


@contextlib.contextmanager
def recording() -> Iterator[List[Dict[str, object]]]:
    """Collect the notes of the collectives issued inside, in order."""
    global _LOG
    prev, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = prev
