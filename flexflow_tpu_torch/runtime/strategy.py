"""Strategy files: a searched PCG and its machine mapping as one JSON
document (copy of flexflow_tpu/runtime/strategy.py, the same format: a
strategy exported by either package imports into the other).

{version, pcg, mapping: {node_idx: MachineView}, runtime[, machine]} with
the PCG in file format v1 (pcg/file_format.py). `FFConfig.
export_strategy_file` writes the searched compile's plan (rank 0 writes);
`FFConfig.import_strategy_file` trains a saved plan instead of searching.
"""

from __future__ import annotations

import json
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.pcg.file_format import (
    FILE_FORMAT_VERSION,
    from_jsonable,
    pcg_from_json,
    pcg_to_json,
    to_jsonable,
)
from flexflow_tpu_torch.pcg.machine_view import MachineView
from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.utils.graph import Node


def machine_grid_doc(num_nodes: int, num_devices: int) -> dict:
    """A device grid as stamped into strategy documents."""
    nodes = max(int(num_nodes), 1)
    return {"num_nodes": nodes, "devices_per_node": max(int(num_devices) // nodes, 1),
            "num_devices": int(num_devices)}


def strategy_to_doc(pcg: ParallelComputationGraph,
                    mapping: Optional[Dict[Node, MachineView]] = None,
                    runtime: Optional[float] = None, machine: Optional[dict] = None) -> dict:
    doc = {
        "version": FILE_FORMAT_VERSION,
        "pcg": json.loads(pcg_to_json(pcg)),
        "mapping": {str(n.idx): to_jsonable(v) for n, v in (mapping or {}).items()},
        "runtime": runtime,
    }
    if machine is not None:
        doc["machine"] = machine
    return doc


def strategy_from_doc(doc: dict) -> Tuple[ParallelComputationGraph, Dict[Node, MachineView],
                                          Optional[float]]:
    if doc.get("version") != FILE_FORMAT_VERSION:
        raise ValueError(f"unsupported strategy version {doc.get('version')}")
    pcg = pcg_from_json(json.dumps(doc["pcg"]))
    mapping = {Node(int(k)): from_jsonable(v) for k, v in doc["mapping"].items()}
    return pcg, mapping, doc.get("runtime")


def save_strategy(path: str, pcg: ParallelComputationGraph,
                  mapping: Optional[Dict[Node, MachineView]] = None,
                  runtime: Optional[float] = None, machine: Optional[dict] = None) -> None:
    with open(path, "w") as f:
        json.dump(strategy_to_doc(pcg, mapping, runtime, machine=machine), f)


def load_strategy(path: str) -> Tuple[ParallelComputationGraph, Dict[Node, MachineView],
                                      Optional[float]]:
    with open(path) as f:
        return strategy_from_doc(json.load(f))
