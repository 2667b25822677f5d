"""Multi-process runtime: process initialization, rank-only batch feeding,
and one search for every rank (port of flexflow_tpu/runtime/distributed.py
over torch.distributed).

The port runs one process per device. Every process runs the same program
and opens the default process group:

1. `initialize()`: explicit arguments win; otherwise FLEXFLOW_TPU_COORDINATOR
   (host:port, reached over tcp://), FLEXFLOW_TPU_NUM_PROCESSES and
   FLEXFLOW_TPU_PROCESS_ID; with neither, FLEXFLOW_TPU_AUTO_DISTRIBUTED=1
   takes torchrun's env:// (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT,
   LOCAL_RANK). Nothing configured: single process, no group. The rank's
   card is LOCAL_RANK (else the rank modulo the host's cards), and the
   backend NCCL on cards; more ranks on a host than cards raises unless the
   caller passes backend="gloo" (gloo stages CUDA tensors through host
   memory, so ranks may share a card).
2. The counterpart of device_put_global: a process copies to its card
   only its own block of rows of a global host batch. The trainers name
   the blocks (`feed_blocks`), FFModel's batch iterators draw only those
   rows (core/dataloader.py), and the trainers take them as they are.
3. `run_search_on_host_0()`: the Unity search must give one plan to every
   rank, so rank 0 searches and the strategy document (runtime/strategy.py)
   is broadcast (`broadcast_json`); every other rank deserializes it.
"""

from __future__ import annotations

import json
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist

def _card_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device=None,
) -> None:
    """Open the default process group once per process (idempotent;
    single-process when nothing is configured; see the module docstring).
    device: "cpu" runs the ranks on the host (gloo); default the card of
    LOCAL_RANK where the host has cards, else the CPU."""
    if dist.is_initialized():
        return
    coordinator_address = coordinator_address or os.environ.get("FLEXFLOW_TPU_COORDINATOR")
    if coordinator_address is None:
        if os.environ.get("FLEXFLOW_TPU_AUTO_DISTRIBUTED") != "1":
            return
        init_method = "env://"
        world = int(os.environ["WORLD_SIZE"])
        rank = int(os.environ["RANK"])
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    else:
        world = int(num_processes if num_processes is not None
                    else os.environ["FLEXFLOW_TPU_NUM_PROCESSES"])
        rank = int(process_id if process_id is not None
                   else os.environ["FLEXFLOW_TPU_PROCESS_ID"])
        address = coordinator_address
        init_method = address if "://" in address else f"tcp://{address}"
        local_rank = int(os.environ.get("LOCAL_RANK", rank))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    cards = _card_count()
    on_card = device != "cpu" and cards > 0
    if on_card:
        if backend != "gloo" and local_world > cards:
            raise RuntimeError(
                f"{local_world} ranks on this host and {cards} card(s): NCCL takes one rank "
                "per card; pass backend='gloo' to let ranks share a card")
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend or ("nccl" if on_card else "gloo"),
                            init_method=init_method, rank=rank, world_size=world)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_multiprocess() -> bool:
    return process_count() > 1


def ranks_share_a_device(device) -> bool:
    """Whether two ranks of the default group run on one device (a
    collective): each rank's (host, device index) all-gathered. Ranks
    sharing a card, or ranks on one host's CPU, are an emulated mesh for
    the cost model; one card a rank is not."""
    import socket

    if not is_multiprocess():
        return False
    device = torch.device(device)
    index = (torch.cuda.current_device() if device.index is None else device.index) \
        if device.type == "cuda" else None
    places = [None] * process_count()
    dist.all_gather_object(places, (socket.gethostname(), device.type, index))
    return len(set(places)) < len(places)


def _broadcast_bytes(payload: bytes, root: int) -> bytes:
    """`payload` of rank `root` on every rank (a host-level collective: on
    the CPU under gloo, on the rank's card under NCCL)."""
    device = (torch.device("cuda", torch.cuda.current_device()) if dist.get_backend() == "nccl"
              else torch.device("cpu"))
    n = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    dist.broadcast(n, root)
    buf = torch.zeros(int(n.item()), dtype=torch.uint8, device=device)
    if process_index() == root:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, root)
    return bytes(buf.cpu().numpy())


def broadcast_json(doc: Optional[dict], root: int = 0) -> dict:
    """A JSON document of `root` on every process (every process calls it
    at the same point; the others pass None)."""
    if not is_multiprocess():
        if doc is None:
            raise ValueError("broadcast_json on a single process needs the document")
        return doc
    payload = json.dumps(doc).encode() if process_index() == root else b""
    return json.loads(_broadcast_bytes(payload, root).decode())


# calls of the search function on this process, for the check that only
# rank 0 searches
search_calls = 0


def run_search_on_host_0(search_fn: Callable[[], tuple]):
    """`search_fn() -> (pcg, mapping, runtime)` on process 0 only; the
    strategy is broadcast so every process lowers the identical plan (cost
    measurement noise would otherwise let ranks pick different plans and
    deadlock in mismatched collectives)."""
    global search_calls
    from flexflow_tpu_torch.runtime.strategy import strategy_from_doc, strategy_to_doc

    if not is_multiprocess():
        search_calls += 1
        return search_fn()
    doc = None
    if process_index() == 0:
        search_calls += 1
        doc = strategy_to_doc(*search_fn())
    return strategy_from_doc(broadcast_json(doc, root=0))
