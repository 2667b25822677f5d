"""Dataflow graphs: DAGs with ordered, indexed inputs/outputs per node.

Copy of the JAX package's module; equivalent of the reference's
lib/utils/include/utils/graph/{dataflow_graph,open_dataflow_graph,
labelled_dataflow_graph}. A ComputationGraph is a labelled dataflow graph with
operator attrs on nodes and tensor attrs on values (reference:
lib/pcg/include/pcg/computation_graph.h:14); a SubParallelComputationGraph is an
*open* one -- it may have unbound graph inputs -- used during substitution
rewriting (lib/substitutions/include/substitutions/sub_parallel_computation_graph.h).

We fold the "labelled" variant directly into the classes: node labels and
value labels are stored in the graph; the unlabelled behavior is label=None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, FrozenSet, Generic, List, Sequence, Tuple, TypeVar, Union

from flexflow_tpu_torch.utils.graph.digraph import DiGraph, Node

NodeLabel = TypeVar("NodeLabel")
ValueLabel = TypeVar("ValueLabel")


@dataclass(frozen=True, order=True)
class DataflowOutput:
    """The idx-th output of a node (reference: dataflow_graph/dataflow_output.struct.toml)."""

    node: Node
    idx: int

    def __repr__(self) -> str:
        return f"{self.node}.out{self.idx}"

    def __hash__(self) -> int:
        # hot in graph rebuilds: avoid the default tuple-allocating hash
        return self.node.idx * 1000003 + self.idx


@dataclass(frozen=True, order=True)
class DataflowInput:
    """The idx-th input slot of a node."""

    node: Node
    idx: int

    def __repr__(self) -> str:
        return f"{self.node}.in{self.idx}"

    def __hash__(self) -> int:
        return self.node.idx * 1000003 + self.idx + 0x9E3779B9


@dataclass(frozen=True, order=True)
class GraphInput:
    """An unbound graph input of an open dataflow graph."""

    idx: int

    def __repr__(self) -> str:
        return f"gi{self.idx}"


# A value flowing through an open dataflow graph: either some node's output or
# an unbound graph input (reference: open_dataflow_graph/open_dataflow_value.variant.toml).
OpenDataflowValue = Union[DataflowOutput, GraphInput]


@dataclass(frozen=True, order=True)
class DataflowEdge:
    src: DataflowOutput
    dst: DataflowInput


class DataflowGraph(Generic[NodeLabel, ValueLabel]):
    """DAG of operators with ordered inputs/outputs, with labels.

    Nodes are added atomically with all their inputs bound and a fixed number
    of outputs (operator style); this keeps the graph acyclic by construction.
    """

    def __init__(self) -> None:
        self._g = DiGraph()  # node-level connectivity
        self._node_label: Dict[Node, Any] = {}
        self._value_label: Dict[DataflowOutput, Any] = {}
        self._inputs: Dict[Node, List[DataflowOutput]] = {}
        self._num_outputs: Dict[Node, int] = {}
        self._uses: Dict[DataflowOutput, List[DataflowInput]] = {}

    # -- construction -----------------------------------------------------

    def add_node(
        self,
        label: NodeLabel,
        inputs: Sequence[DataflowOutput],
        output_labels: Sequence[ValueLabel],
    ) -> Tuple[Node, List[DataflowOutput]]:
        for v in inputs:
            # has_node, not the `nodes` property: the property allocates a
            # frozenset of ALL nodes, turning every graph rebuild quadratic
            assert self._g.has_node(v.node), f"input {v} refers to unknown node"
            assert v.idx < self._num_outputs[v.node], f"input {v} out of range"
        n = self._g.add_node()
        self._node_label[n] = label
        self._inputs[n] = list(inputs)
        self._num_outputs[n] = len(output_labels)
        outs = [DataflowOutput(n, i) for i in range(len(output_labels))]
        for o, ol in zip(outs, output_labels):
            self._value_label[o] = ol
        for i, v in enumerate(inputs):
            self._uses.setdefault(v, []).append(DataflowInput(n, i))
            if not self._g.has_edge(v.node, n):
                self._g.add_edge(v.node, n)
        return n, outs

    # -- queries ----------------------------------------------------------

    @property
    def nodes(self) -> FrozenSet[Node]:
        return self._g.nodes

    def node_label(self, n: Node) -> NodeLabel:
        return self._node_label[n]

    def set_node_label(self, n: Node, label: NodeLabel) -> None:
        self._node_label[n] = label

    def value_label(self, v: DataflowOutput) -> ValueLabel:
        return self._value_label[v]

    def set_value_label(self, v: DataflowOutput, label: ValueLabel) -> None:
        assert v in self._value_label
        self._value_label[v] = label

    def inputs_of(self, n: Node) -> List[DataflowOutput]:
        return list(self._inputs[n])

    def outputs_of(self, n: Node) -> List[DataflowOutput]:
        return [DataflowOutput(n, i) for i in range(self._num_outputs[n])]

    def all_values(self) -> List[DataflowOutput]:
        return sorted(self._value_label.keys())

    def edges(self) -> List[DataflowEdge]:
        out: List[DataflowEdge] = []
        for n in sorted(self._g.nodes):
            for i, v in enumerate(self._inputs[n]):
                out.append(DataflowEdge(v, DataflowInput(n, i)))
        return out

    def uses_of(self, v: DataflowOutput) -> List[DataflowInput]:
        """All input slots this value feeds."""
        return list(self._uses.get(v, []))

    def digraph(self) -> DiGraph:
        """Node-level connectivity as an independent copy (safe to mutate)."""
        return self._g.copy()

    def topological_ordering(self) -> List[Node]:
        from flexflow_tpu_torch.utils.graph.algorithms import get_topological_ordering

        return get_topological_ordering(self._g)

    def sinks(self) -> List[Node]:
        return self._g.sinks()

    def sources(self) -> List[Node]:
        return self._g.sources()

    def successors(self, n: Node) -> FrozenSet[Node]:
        return self._g.successors(n)

    def predecessors(self, n: Node) -> FrozenSet[Node]:
        return self._g.predecessors(n)

    def copy(self) -> "DataflowGraph[NodeLabel, ValueLabel]":
        g: DataflowGraph = DataflowGraph()
        g._g = self._g.copy()
        g._node_label = dict(self._node_label)
        g._value_label = dict(self._value_label)
        g._inputs = {n: list(v) for n, v in self._inputs.items()}
        g._num_outputs = dict(self._num_outputs)
        g._uses = {v: list(u) for v, u in self._uses.items()}
        return g

    def map_labels(
        self,
        node_f: Callable[[Node, NodeLabel], Any],
        value_f: Callable[[DataflowOutput, ValueLabel], Any],
    ) -> "DataflowGraph":
        g = self.copy()
        g._node_label = {n: node_f(n, l) for n, l in self._node_label.items()}
        g._value_label = {v: value_f(v, l) for v, l in self._value_label.items()}
        return g

    def __len__(self) -> int:
        return len(self._g.nodes)


class OpenDataflowGraph(Generic[NodeLabel, ValueLabel]):
    """Dataflow graph with unbound graph inputs.

    Node inputs are OpenDataflowValue: either another node's output or a
    GraphInput. Used as the substrate for substitution patterns and
    SubParallelComputationGraphs.
    """

    def __init__(self) -> None:
        self._g = DiGraph()
        self._node_label: Dict[Node, Any] = {}
        self._value_label: Dict[DataflowOutput, Any] = {}
        self._input_label: Dict[GraphInput, Any] = {}
        self._inputs: Dict[Node, List[OpenDataflowValue]] = {}
        self._num_outputs: Dict[Node, int] = {}
        self._graph_inputs: List[GraphInput] = []
        self._uses: Dict[OpenDataflowValue, List[DataflowInput]] = {}

    def add_graph_input(self, label: ValueLabel = None) -> GraphInput:
        gi = GraphInput(len(self._graph_inputs))
        self._graph_inputs.append(gi)
        self._input_label[gi] = label
        return gi

    def add_node(
        self,
        label: NodeLabel,
        inputs: Sequence[OpenDataflowValue],
        output_labels: Sequence[ValueLabel],
    ) -> Tuple[Node, List[DataflowOutput]]:
        for v in inputs:
            if isinstance(v, DataflowOutput):
                assert self._g.has_node(v.node)
            else:
                assert v in self._input_label
        n = self._g.add_node()
        self._node_label[n] = label
        self._inputs[n] = list(inputs)
        self._num_outputs[n] = len(output_labels)
        outs = [DataflowOutput(n, i) for i in range(len(output_labels))]
        for o, ol in zip(outs, output_labels):
            self._value_label[o] = ol
        for i, v in enumerate(inputs):
            self._uses.setdefault(v, []).append(DataflowInput(n, i))
            if isinstance(v, DataflowOutput) and not self._g.has_edge(v.node, n):
                self._g.add_edge(v.node, n)
        return n, outs

    @property
    def nodes(self) -> FrozenSet[Node]:
        return self._g.nodes

    @property
    def graph_inputs(self) -> List[GraphInput]:
        return list(self._graph_inputs)

    def node_label(self, n: Node) -> NodeLabel:
        return self._node_label[n]

    def value_label(self, v: OpenDataflowValue) -> ValueLabel:
        if isinstance(v, GraphInput):
            return self._input_label[v]
        return self._value_label[v]

    def set_value_label(self, v: OpenDataflowValue, label: ValueLabel) -> None:
        if isinstance(v, GraphInput):
            assert v in self._input_label
            self._input_label[v] = label
        else:
            assert v in self._value_label
            self._value_label[v] = label

    def inputs_of(self, n: Node) -> List[OpenDataflowValue]:
        return list(self._inputs[n])

    def outputs_of(self, n: Node) -> List[DataflowOutput]:
        return [DataflowOutput(n, i) for i in range(self._num_outputs[n])]

    def uses_of(self, v: OpenDataflowValue) -> List[DataflowInput]:
        return list(self._uses.get(v, []))

    def digraph(self) -> DiGraph:
        return self._g.copy()

    def topological_ordering(self) -> List[Node]:
        from flexflow_tpu_torch.utils.graph.algorithms import get_topological_ordering

        return get_topological_ordering(self._g)

    def copy(self) -> "OpenDataflowGraph[NodeLabel, ValueLabel]":
        g: OpenDataflowGraph = OpenDataflowGraph()
        g._g = self._g.copy()
        g._node_label = dict(self._node_label)
        g._value_label = dict(self._value_label)
        g._input_label = dict(self._input_label)
        g._inputs = {n: list(v) for n, v in self._inputs.items()}
        g._num_outputs = dict(self._num_outputs)
        g._graph_inputs = list(self._graph_inputs)
        g._uses = {v: list(u) for v, u in self._uses.items()}
        return g
