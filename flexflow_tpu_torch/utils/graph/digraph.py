"""Directed graph core: Node, DiGraph, MultiDiGraph.

Copy of the JAX package's module; equivalent of the reference's lib/utils/include/utils/graph/{node,
digraph,multidigraph}. The reference uses value-semantic views with
copy-on-write pointers and query-based reads; here we keep a plain mutable
Python core with cheap copies -- the algorithms layer treats graphs as values.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterable, Iterator, List, Set, Tuple


@dataclass(frozen=True, order=True)
class Node:
    """An opaque node id (reference: lib/utils/include/utils/graph/node/node.struct.toml)."""

    idx: int

    def __repr__(self) -> str:
        return f"n{self.idx}"

    def __hash__(self) -> int:
        # graph rebuilds hash nodes tens of millions of times; the
        # dataclass default allocates a (idx,) tuple per call
        return self.idx


@dataclass(frozen=True, order=True)
class DirectedEdge:
    src: Node
    dst: Node

    def __repr__(self) -> str:
        return f"({self.src}->{self.dst})"


@dataclass(frozen=True, order=True)
class MultiDiEdge:
    """Edge in a multidigraph: (src, dst, key) so parallel edges are distinct."""

    src: Node
    dst: Node
    key: int

    def __repr__(self) -> str:
        return f"({self.src}->{self.dst}#{self.key})"


class DiGraph:
    """Simple directed graph (at most one edge per (src, dst) pair)."""

    def __init__(self) -> None:
        self._nodes: Set[Node] = set()
        self._succ: Dict[Node, Set[Node]] = {}
        self._pred: Dict[Node, Set[Node]] = {}
        self._next_idx = 0

    # -- construction -----------------------------------------------------

    def add_node(self) -> Node:
        n = Node(self._next_idx)
        self._next_idx += 1
        self._add_existing_node(n)
        return n

    def _add_existing_node(self, n: Node) -> None:
        if n in self._nodes:
            return
        self._nodes.add(n)
        self._succ[n] = set()
        self._pred[n] = set()
        if n.idx >= self._next_idx:
            self._next_idx = n.idx + 1

    def add_nodes(self, count: int) -> List[Node]:
        return [self.add_node() for _ in range(count)]

    def add_edge(self, src: Node, dst: Node) -> DirectedEdge:
        assert src in self._nodes and dst in self._nodes
        self._succ[src].add(dst)
        self._pred[dst].add(src)
        return DirectedEdge(src, dst)

    def remove_edge(self, src: Node, dst: Node) -> None:
        self._succ[src].discard(dst)
        self._pred[dst].discard(src)

    def remove_node(self, n: Node) -> None:
        for s in list(self._succ[n]):
            self.remove_edge(n, s)
        for p in list(self._pred[n]):
            self.remove_edge(p, n)
        self._nodes.discard(n)
        del self._succ[n]
        del self._pred[n]

    # -- queries ----------------------------------------------------------

    @property
    def nodes(self) -> FrozenSet[Node]:
        return frozenset(self._nodes)

    def has_node(self, n: Node) -> bool:
        """O(1) membership — the `nodes` property allocates a frozenset per
        access, which made per-node membership checks in graph-rebuild hot
        loops accidentally O(V)."""
        return n in self._nodes

    def has_edge(self, src: Node, dst: Node) -> bool:
        return dst in self._succ.get(src, ())

    def edges(self) -> Iterator[DirectedEdge]:
        for src in sorted(self._nodes):
            for dst in sorted(self._succ[src]):
                yield DirectedEdge(src, dst)

    def successors(self, n: Node) -> FrozenSet[Node]:
        return frozenset(self._succ[n])

    def predecessors(self, n: Node) -> FrozenSet[Node]:
        return frozenset(self._pred[n])

    def in_degree(self, n: Node) -> int:
        return len(self._pred[n])

    def out_degree(self, n: Node) -> int:
        return len(self._succ[n])

    def sources(self) -> List[Node]:
        return sorted(n for n in self._nodes if not self._pred[n])

    def sinks(self) -> List[Node]:
        return sorted(n for n in self._nodes if not self._succ[n])

    def copy(self) -> "DiGraph":
        g = DiGraph()
        g._nodes = set(self._nodes)
        g._succ = {n: set(s) for n, s in self._succ.items()}
        g._pred = {n: set(p) for n, p in self._pred.items()}
        g._next_idx = self._next_idx
        return g

    def reversed(self) -> "DiGraph":
        g = DiGraph()
        g._nodes = set(self._nodes)
        g._succ = {n: set(p) for n, p in self._pred.items()}
        g._pred = {n: set(s) for n, s in self._succ.items()}
        g._next_idx = self._next_idx
        return g

    def subgraph(self, keep: Iterable[Node]) -> "DiGraph":
        keep_set = set(keep)
        g = DiGraph()
        for n in keep_set:
            g._add_existing_node(n)
        for n in keep_set:
            for s in self._succ[n]:
                if s in keep_set:
                    g.add_edge(n, s)
        return g

    @staticmethod
    def from_edges(nodes: Iterable[Node], edges: Iterable[Tuple[Node, Node]]) -> "DiGraph":
        g = DiGraph()
        for n in nodes:
            g._add_existing_node(n)
        for s, d in edges:
            g.add_edge(s, d)
        return g

    def __repr__(self) -> str:
        return f"DiGraph(nodes={sorted(self._nodes)}, edges={list(self.edges())})"


class MultiDiGraph:
    """Directed multigraph: multiple distinct edges per (src, dst) pair.

    Used by the series-parallel machinery, where parallel edges are the whole
    point (reference: lib/utils/include/utils/graph/multidigraph/).
    """

    def __init__(self) -> None:
        self._nodes: Set[Node] = set()
        self._edges: Set[MultiDiEdge] = set()
        self._succ: Dict[Node, Set[MultiDiEdge]] = {}
        self._pred: Dict[Node, Set[MultiDiEdge]] = {}
        self._next_idx = 0
        self._next_key = 0

    def add_node(self) -> Node:
        n = Node(self._next_idx)
        self._next_idx += 1
        self._add_existing_node(n)
        return n

    def _add_existing_node(self, n: Node) -> None:
        if n in self._nodes:
            return
        self._nodes.add(n)
        self._succ[n] = set()
        self._pred[n] = set()
        if n.idx >= self._next_idx:
            self._next_idx = n.idx + 1

    def add_edge(self, src: Node, dst: Node) -> MultiDiEdge:
        assert src in self._nodes and dst in self._nodes
        e = MultiDiEdge(src, dst, self._next_key)
        self._next_key += 1
        self._edges.add(e)
        self._succ[src].add(e)
        self._pred[dst].add(e)
        return e

    def remove_edge(self, e: MultiDiEdge) -> None:
        self._edges.discard(e)
        self._succ[e.src].discard(e)
        self._pred[e.dst].discard(e)

    def remove_node(self, n: Node) -> None:
        for e in list(self._succ[n]) + list(self._pred[n]):
            self.remove_edge(e)
        self._nodes.discard(n)
        del self._succ[n]
        del self._pred[n]

    @property
    def nodes(self) -> FrozenSet[Node]:
        return frozenset(self._nodes)

    @property
    def edges(self) -> FrozenSet[MultiDiEdge]:
        return frozenset(self._edges)

    def out_edges(self, n: Node) -> FrozenSet[MultiDiEdge]:
        return frozenset(self._succ[n])

    def in_edges(self, n: Node) -> FrozenSet[MultiDiEdge]:
        return frozenset(self._pred[n])

    def in_degree(self, n: Node) -> int:
        return len(self._pred[n])

    def out_degree(self, n: Node) -> int:
        return len(self._succ[n])

    def successors(self, n: Node) -> Set[Node]:
        return {e.dst for e in self._succ[n]}

    def predecessors(self, n: Node) -> Set[Node]:
        return {e.src for e in self._pred[n]}

    def sources(self) -> List[Node]:
        return sorted(n for n in self._nodes if not self._pred[n])

    def sinks(self) -> List[Node]:
        return sorted(n for n in self._nodes if not self._succ[n])

    def copy(self) -> "MultiDiGraph":
        g = MultiDiGraph()
        g._nodes = set(self._nodes)
        g._edges = set(self._edges)
        g._succ = {n: set(s) for n, s in self._succ.items()}
        g._pred = {n: set(p) for n, p in self._pred.items()}
        g._next_idx = self._next_idx
        g._next_key = self._next_key
        return g

    def to_digraph(self) -> DiGraph:
        return DiGraph.from_edges(self._nodes, {(e.src, e.dst) for e in self._edges})

    @staticmethod
    def from_digraph(g: DiGraph) -> "MultiDiGraph":
        mg = MultiDiGraph()
        for n in g.nodes:
            mg._add_existing_node(n)
        for e in g.edges():
            mg.add_edge(e.src, e.dst)
        return mg
