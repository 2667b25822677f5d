"""ParallelComputationGraph: a dataflow graph whose tensors carry parallel
degrees (trimmed copy of flexflow_tpu/pcg/parallel_computation_graph.py).
The four parallel ops appear as nodes of their own."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

from flexflow_tpu_torch.op_attrs.core import OpAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    lift_to_parallel,
)
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.utils.graph import DataflowGraph, DataflowOutput, Node


@dataclass(frozen=True)
class ParallelLayerAttrs:
    attrs: OpAttrs
    name: Optional[str] = None


@dataclass(frozen=True)
class ParallelTensorAttrs:
    shape: ParallelTensorShape
    create_grad: bool = True
    initializer: Optional[object] = None  # InitializerAttrs, for weights


class ParallelComputationGraph(DataflowGraph):
    def layer_attrs(self, n: Node) -> ParallelLayerAttrs:
        return self.node_label(n)

    def op_attrs(self, n: Node) -> OpAttrs:
        return self.node_label(n).attrs

    def tensor_attrs(self, v: DataflowOutput) -> ParallelTensorAttrs:
        return self.value_label(v)

    def tensor_shape(self, v: DataflowOutput) -> ParallelTensorShape:
        return self.value_label(v).shape


def pcg_from_computation_graph(cg: ComputationGraph) -> ParallelComputationGraph:
    """Lift a CG into a trivially-parallel PCG (all degrees 1), node for
    node in the CG's topological order."""
    pcg = ParallelComputationGraph()
    value_map: Dict[DataflowOutput, DataflowOutput] = {}
    for n in cg.topological_ordering():
        la = cg.layer_attrs(n)
        inputs = [value_map[v] for v in cg.inputs_of(n)]
        out_labels = []
        for o in cg.outputs_of(n):
            ta = cg.tensor_attrs(o)
            out_labels.append(
                ParallelTensorAttrs(lift_to_parallel(ta.shape), ta.create_grad, ta.initializer)
            )
        _, outs = pcg.add_node(ParallelLayerAttrs(la.attrs, la.name), inputs, out_labels)
        for old, new in zip(cg.outputs_of(n), outs):
            value_map[old] = new
    return pcg
