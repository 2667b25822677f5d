"""Output graph expressions: the RHS of a substitution (copy of
flexflow_tpu/substitutions/output_graph.py).

Reference: lib/substitutions/include/substitutions/output_graph/
(output_operator_attrs_assignment.struct.toml, output_graph_expr.struct.toml).
Node attrs in the RHS are either constants or copied from a matched pattern
node (with optional field overrides).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple, Union

from flexflow_tpu_torch.op_attrs.core import OpAttrs
from flexflow_tpu_torch.utils.graph import Node, OpenDataflowGraph


@dataclass(frozen=True)
class AttrConstant:
    """RHS node with fully specified attrs."""

    attrs: OpAttrs


@dataclass(frozen=True)
class CopyAttrsFromMatched:
    """RHS node copying the attrs of a matched pattern node, with optional
    dataclass-field overrides (reference: OutputOperatorAttrAccess)."""

    pattern_node: Node
    overrides: Tuple[Tuple[str, Any], ...] = ()

    def materialize(self, matched_attrs_by_pattern_node: Dict[Node, OpAttrs]) -> OpAttrs:
        base = matched_attrs_by_pattern_node[self.pattern_node]
        if not self.overrides:
            return base
        return dataclasses.replace(base, **dict(self.overrides))


@dataclass(frozen=True)
class ComputeAttrsFromMatched:
    """RHS node whose attrs are computed from one or SEVERAL matched nodes'
    attrs by a pure function — retyping (MultiHeadAttentionAttrs ->
    RingAttentionAttrs), or multi-node fusion attrs (a fused Linear whose
    out_channels is the sum of two matched Linears'). The generalization of
    the reference's OutputOperatorAttrAccess expression language."""

    pattern_nodes: Tuple[Node, ...]
    compute: Callable[..., OpAttrs]

    @property
    def pattern_node(self) -> Node:
        """The representative matched node (layer-name inheritance)."""
        return self.pattern_nodes[0]

    def materialize(self, matched_attrs_by_pattern_node: Dict[Node, OpAttrs]) -> OpAttrs:
        return self.compute(
            *[matched_attrs_by_pattern_node[n] for n in self.pattern_nodes]
        )


OutputOperatorAttrsAssignment = Union[
    AttrConstant,
    CopyAttrsFromMatched,
    ComputeAttrsFromMatched,
]


class OutputGraphExpr:
    """Open dataflow graph whose node labels are attr assignments; value
    labels are None (shapes are re-inferred at apply time)."""

    def __init__(self) -> None:
        self.graph: OpenDataflowGraph = OpenDataflowGraph()

    def add_input(self):
        return self.graph.add_graph_input(None)

    def add_operator(
        self,
        assignment: OutputOperatorAttrsAssignment,
        inputs,
        num_outputs: int = 1,
    ):
        return self.graph.add_node(
            assignment, list(inputs), [None] * num_outputs
        )
