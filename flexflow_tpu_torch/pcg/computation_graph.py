"""ComputationGraph: a labelled dataflow graph of operators (copy of
flexflow_tpu/pcg/computation_graph.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from flexflow_tpu_torch.op_attrs.core import OpAttrs, op_type_of
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.utils.graph import DataflowGraph, DataflowOutput, Node


@dataclass(frozen=True)
class LayerAttrs:
    """Node label: op attrs plus an optional user-facing name."""

    attrs: OpAttrs
    name: Optional[str] = None


@dataclass(frozen=True)
class TensorAttrs:
    """Value label."""

    shape: TensorShape
    create_grad: bool = True
    initializer: Optional[object] = None  # InitializerAttrs, for weights


class ComputationGraph(DataflowGraph):
    """DataflowGraph[LayerAttrs, TensorAttrs] with CG-specific queries."""

    def layer_attrs(self, n: Node) -> LayerAttrs:
        return self.node_label(n)

    def op_attrs(self, n: Node) -> OpAttrs:
        return self.node_label(n).attrs

    def tensor_attrs(self, v: DataflowOutput) -> TensorAttrs:
        return self.value_label(v)

    def tensor_shape(self, v: DataflowOutput) -> TensorShape:
        return self.value_label(v).shape

    def as_dot(self) -> str:
        """Graphviz dot export (reference: as_dot in pcg)."""
        lines = ["digraph computation_graph {"]
        for n in sorted(self.nodes):
            label = self.node_label(n)
            op = op_type_of(label.attrs).value
            name = f"\\n{label.name}" if label.name else ""
            lines.append(f'  {n.idx} [label="{op}{name}"];')
        for e in self.edges():
            lines.append(f"  {e.src.node.idx} -> {e.dst.node.idx};")
        lines.append("}")
        return "\n".join(lines)
