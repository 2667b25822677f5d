"""JSON (de)serialization of a CG or a PCG, file format v1 (copy of
flexflow_tpu/pcg/file_format.py; the same JSON, so a graph written by one
package reads in the other).

Attrs dataclasses are serialized generically: {"__type__": ClassName,
fields} with enums as {"__enum__": ClassName, "value": ...}; a registry of
the port's attrs classes maps the names back. Nodes are written in
topological order and refer to their inputs by that position. The one
translation: a machine view's device type GPU is written as the JAX
package's accelerator value, "tpu".
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Dict, List, Type

from flexflow_tpu_torch.op_attrs import activation as _act_mod
from flexflow_tpu_torch.op_attrs import datatype as _dt_mod
from flexflow_tpu_torch.op_attrs import ops as _ops_mod
from flexflow_tpu_torch.op_attrs import parallel_tensor_shape as _pts_mod
from flexflow_tpu_torch.op_attrs import tensor_shape as _ts_mod
from flexflow_tpu_torch.op_attrs.ops import conv_ops as _conv_mod
from flexflow_tpu_torch.op_attrs.ops import elementwise as _elem_mod
from flexflow_tpu_torch.op_attrs.ops import linear_ops as _lin_mod
from flexflow_tpu_torch.op_attrs.ops import loss_functions as _loss_mod
from flexflow_tpu_torch.op_attrs.ops import shape_ops as _shape_ops_mod
from flexflow_tpu_torch.pcg import initializer as _init_mod
from flexflow_tpu_torch.pcg import machine_view as _mv_mod
from flexflow_tpu_torch.pcg import optimizer as _opt_mod
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph, LayerAttrs, TensorAttrs
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    ParallelLayerAttrs,
    ParallelTensorAttrs,
)
from flexflow_tpu_torch.utils.graph import DataflowOutput

FILE_FORMAT_VERSION = 1

# The file format's value for the accelerator in a machine view: the JAX
# package names its accelerator DeviceType.TPU ("tpu"), and a file must
# read in both packages, so the port's DeviceType.GPU is written as that
# value and read back from it (or from "gpu").
_ACCELERATOR = "tpu"


def _build_registry() -> Dict[str, Type]:
    reg: Dict[str, Type] = {}
    for mod in (_ops_mod, _dt_mod, _act_mod, _ts_mod, _pts_mod, _shape_ops_mod, _elem_mod,
                _conv_mod, _lin_mod, _loss_mod, _init_mod, _opt_mod, _mv_mod):
        for name in dir(mod):
            obj = getattr(mod, name)
            if isinstance(obj, type) and (dataclasses.is_dataclass(obj)
                                          or issubclass(obj, enum.Enum)):
                reg[obj.__name__] = obj
    for cls in (LayerAttrs, TensorAttrs, ParallelLayerAttrs, ParallelTensorAttrs):
        reg[cls.__name__] = cls
    return reg


_REGISTRY = _build_registry()


def to_jsonable(obj: Any) -> Any:
    if obj is None or isinstance(obj, (bool, int, float, str)):
        return obj
    if obj is _mv_mod.DeviceType.GPU:
        return {"__enum__": "DeviceType", "value": _ACCELERATOR}
    if isinstance(obj, enum.Enum):
        return {"__enum__": type(obj).__name__, "value": obj.value}
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {"__type__": type(obj).__name__,
                **{f.name: to_jsonable(getattr(obj, f.name)) for f in dataclasses.fields(obj)}}
    if isinstance(obj, (list, tuple)):
        return {"__tuple__": [to_jsonable(x) for x in obj]}
    if isinstance(obj, frozenset):
        return {"__fset__": [to_jsonable(x) for x in sorted(obj, key=repr)]}
    raise TypeError(f"cannot serialize {type(obj)}: {obj!r}")


def from_jsonable(data: Any) -> Any:
    if data is None or isinstance(data, (bool, int, float, str)):
        return data
    if isinstance(data, dict):
        if "__enum__" in data:
            if data["__enum__"] == "DeviceType" and data["value"] == _ACCELERATOR:
                return _mv_mod.DeviceType.GPU
            return _REGISTRY[data["__enum__"]](data["value"])
        if "__tuple__" in data:
            return tuple(from_jsonable(x) for x in data["__tuple__"])
        if "__fset__" in data:
            return frozenset(from_jsonable(x) for x in data["__fset__"])
        if "__type__" in data:
            cls = _REGISTRY[data["__type__"]]
            return cls(**{k: from_jsonable(v) for k, v in data.items() if k != "__type__"})
    raise TypeError(f"cannot deserialize {data!r}")


def _graph_to_json(g, kind: str) -> Dict:
    topo = g.topological_ordering()
    node_idx = {n: i for i, n in enumerate(topo)}
    nodes = [{"label": to_jsonable(g.node_label(n)),
              "inputs": [{"node": node_idx[v.node], "idx": v.idx} for v in g.inputs_of(n)],
              "outputs": [to_jsonable(g.value_label(o)) for o in g.outputs_of(n)]}
             for n in topo]
    return {"version": FILE_FORMAT_VERSION, "kind": kind, "nodes": nodes}


def _graph_from_json(data: Dict, graph_cls):
    if data["version"] != FILE_FORMAT_VERSION:
        raise ValueError(f"unsupported graph file version {data['version']}")
    g = graph_cls()
    outputs_by_idx: List[List[DataflowOutput]] = []
    for nd in data["nodes"]:
        inputs = [outputs_by_idx[i["node"]][i["idx"]] for i in nd["inputs"]]
        _, outs = g.add_node(from_jsonable(nd["label"]), inputs,
                             [from_jsonable(o) for o in nd["outputs"]])
        outputs_by_idx.append(outs)
    return g


def computation_graph_to_json(cg: ComputationGraph) -> str:
    return json.dumps(_graph_to_json(cg, "computation_graph"))


def computation_graph_from_json(s: str) -> ComputationGraph:
    data = json.loads(s)
    if data["kind"] != "computation_graph":
        raise ValueError(f"not a computation graph: {data['kind']}")
    return _graph_from_json(data, ComputationGraph)


def pcg_to_json(pcg: ParallelComputationGraph) -> str:
    return json.dumps(_graph_to_json(pcg, "parallel_computation_graph"))


def pcg_from_json(s: str) -> ParallelComputationGraph:
    data = json.loads(s)
    if data["kind"] != "parallel_computation_graph":
        raise ValueError(f"not a parallel computation graph: {data['kind']}")
    return _graph_from_json(data, ParallelComputationGraph)
