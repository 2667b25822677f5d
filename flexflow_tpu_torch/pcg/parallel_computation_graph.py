"""ParallelComputationGraph: a dataflow graph whose tensors carry parallel
degrees (trimmed copy of flexflow_tpu/pcg/parallel_computation_graph.py).
The four parallel ops appear as nodes of their own."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from flexflow_tpu_torch.op_attrs.core import OpAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorShape
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
