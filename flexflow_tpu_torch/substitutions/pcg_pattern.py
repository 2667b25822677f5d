"""PCG pattern + subgraph matching (copy of
flexflow_tpu/substitutions/pcg_pattern.py, the Python matcher only: the JAX
package's native matcher enumerates the same matches in the same order).

Reference: lib/substitutions/include/substitutions/pcg_pattern.h:17
(find_pattern_matches) + unlabelled/find_pattern_matches.h. The reference
matches via recursive pattern splitting; here a backtracking subgraph
isomorphism over the (small) pattern gives the same match set: an injective
map pattern-node -> pcg-node consistent with slot-ordered dataflow edges, with
pattern graph inputs binding to arbitrary host values, and all attribute
constraints satisfied.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.substitutions.operator_pattern import (
    OperatorAttributePattern,
    op_attrs_satisfy_pattern,
)
from flexflow_tpu_torch.substitutions.tensor_pattern import (
    TensorAttributePattern,
    tensor_attrs_satisfy_pattern,
)
from flexflow_tpu_torch.utils.graph import (
    DataflowOutput,
    GraphInput,
    Node,
    OpenDataflowGraph,
)


class PCGPattern:
    """An open dataflow graph whose node labels are OperatorAttributePatterns
    and whose value labels are TensorAttributePatterns."""

    def __init__(self) -> None:
        self.graph: OpenDataflowGraph = OpenDataflowGraph()

    def add_input(
        self, pattern: Optional[TensorAttributePattern] = None
    ) -> GraphInput:
        return self.graph.add_graph_input(pattern or TensorAttributePattern.any())

    def add_operator(
        self,
        op_pattern: OperatorAttributePattern,
        inputs,
        num_outputs: int = 1,
        output_patterns=None,
    ) -> Tuple[Node, List[DataflowOutput]]:
        out_patterns = output_patterns or [
            TensorAttributePattern.any() for _ in range(num_outputs)
        ]
        return self.graph.add_node(op_pattern, list(inputs), out_patterns)


@dataclass(frozen=True)
class PatternMatch:
    """reference: unlabelled/pattern_matching (node assignment + input binding)."""

    node_assignment: Tuple[Tuple[Node, Node], ...]  # (pattern node, pcg node)
    input_assignment: Tuple[Tuple[GraphInput, DataflowOutput], ...]

    def node_map(self) -> Dict[Node, Node]:
        return dict(self.node_assignment)

    def input_map(self) -> Dict[GraphInput, DataflowOutput]:
        return dict(self.input_assignment)


def find_pattern_matches(
    pattern: PCGPattern, pcg: ParallelComputationGraph
) -> List[PatternMatch]:
    pg = pattern.graph
    pattern_nodes = pg.topological_ordering()
    matches: List[PatternMatch] = []

    def value_matches(
        pval, hval: DataflowOutput, node_map: Dict[Node, Node], input_map
    ) -> bool:
        """Can pattern value pval (node output or graph input) bind host value hval?"""
        if isinstance(pval, GraphInput):
            if pval in input_map:
                return input_map[pval] == hval
            # constraint check happens at bind time
            return tensor_attrs_satisfy_pattern(
                pcg.tensor_shape(hval), pg.value_label(pval)
            )
        # pattern node output: producer must already be mapped to hval's node
        mapped = node_map.get(pval.node)
        return mapped == hval.node and pval.idx == hval.idx

    def backtrack(i: int, node_map: Dict[Node, Node], input_map) -> None:
        if i == len(pattern_nodes):
            matches.append(
                PatternMatch(
                    tuple(sorted(node_map.items())),
                    tuple(sorted(input_map.items())),
                )
            )
            return
        pnode = pattern_nodes[i]
        p_inputs = pg.inputs_of(pnode)
        used = set(node_map.values())
        for hnode in sorted(pcg.nodes):
            if hnode in used:
                continue
            if not op_attrs_satisfy_pattern(pcg.op_attrs(hnode), pg.node_label(pnode)):
                continue
            h_inputs = pcg.inputs_of(hnode)
            if len(h_inputs) != len(p_inputs):
                continue
            if len(pg.outputs_of(pnode)) != len(pcg.outputs_of(hnode)):
                continue
            # check output tensor constraints
            if not all(
                tensor_attrs_satisfy_pattern(
                    pcg.tensor_shape(ho), pg.value_label(po)
                )
                for po, ho in zip(pg.outputs_of(pnode), pcg.outputs_of(hnode))
            ):
                continue
            if not all(
                value_matches(pv, hv, node_map, input_map)
                for pv, hv in zip(p_inputs, h_inputs)
            ):
                continue
            new_input_map = dict(input_map)
            ok = True
            for pv, hv in zip(p_inputs, h_inputs):
                if isinstance(pv, GraphInput):
                    if pv in new_input_map and new_input_map[pv] != hv:
                        ok = False
                        break
                    new_input_map[pv] = hv
            if not ok:
                continue
            node_map[pnode] = hnode
            backtrack(i + 1, node_map, new_input_map)
            del node_map[pnode]

    backtrack(0, {}, {})
    return matches
