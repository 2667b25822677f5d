"""Dataflow graph core of the computation graph: nodes with ordered,
indexed inputs and outputs.

Trimmed copy of flexflow_tpu/utils/graph/{digraph,dataflow}.py: only what
the ComputationGraph needs (Node, DataflowOutput, insertion, inputs_of /
outputs_of and a deterministic topological ordering). Node indices are
handed out in insertion order, exactly as in the JAX package, so parameter
keys `n{idx}` name the same weights in both packages.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Any, Dict, List, Sequence, Tuple


@dataclass(frozen=True, order=True)
class Node:
    """An opaque node id."""

    idx: int

    def __repr__(self) -> str:
        return f"n{self.idx}"

    def __hash__(self) -> int:
        return self.idx


@dataclass(frozen=True, order=True)
class DataflowOutput:
    """The idx-th output of a node."""

    node: Node
    idx: int

    def __repr__(self) -> str:
        return f"{self.node}.out{self.idx}"

    def __hash__(self) -> int:
        return self.node.idx * 1000003 + self.idx


class DataflowGraph:
    """DAG of operators with ordered inputs/outputs and labels on both.

    A node is added with all its inputs bound and a fixed number of
    outputs, which keeps the graph acyclic by construction."""

    def __init__(self) -> None:
        self._node_label: Dict[Node, Any] = {}
        self._value_label: Dict[DataflowOutput, Any] = {}
        self._inputs: Dict[Node, List[DataflowOutput]] = {}
        self._num_outputs: Dict[Node, int] = {}
        self._succ: Dict[Node, set] = {}

    def add_node(
        self,
        label: Any,
        inputs: Sequence[DataflowOutput],
        output_labels: Sequence[Any],
    ) -> Tuple[Node, List[DataflowOutput]]:
        for v in inputs:
            if v.node not in self._inputs or v.idx >= self._num_outputs[v.node]:
                raise ValueError(f"input {v} refers to no output of the graph")
        n = Node(len(self._inputs))
        self._node_label[n] = label
        self._inputs[n] = list(inputs)
        self._num_outputs[n] = len(output_labels)
        self._succ[n] = set()
        outs = [DataflowOutput(n, i) for i in range(len(output_labels))]
        for o, ol in zip(outs, output_labels):
            self._value_label[o] = ol
        for v in inputs:
            self._succ[v.node].add(n)
        return n, outs

    @property
    def nodes(self) -> List[Node]:
        return list(self._inputs)

    def node_label(self, n: Node) -> Any:
        return self._node_label[n]

    def value_label(self, v: DataflowOutput) -> Any:
        return self._value_label[v]

    def inputs_of(self, n: Node) -> List[DataflowOutput]:
        return list(self._inputs[n])

    def outputs_of(self, n: Node) -> List[DataflowOutput]:
        return [DataflowOutput(n, i) for i in range(self._num_outputs[n])]

    def topological_ordering(self) -> List[Node]:
        """Kahn's algorithm with a smallest-index tie-break, the ordering
        of the JAX package's get_topological_ordering."""
        indeg = {n: len({v.node for v in ins}) for n, ins in self._inputs.items()}
        ready = [n for n, d in indeg.items() if d == 0]
        heapq.heapify(ready)
        out: List[Node] = []
        while ready:
            n = heapq.heappop(ready)
            out.append(n)
            for s in self._succ[n]:
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        return out
