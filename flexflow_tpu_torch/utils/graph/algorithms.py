"""Digraph algorithms: topo order, dominators, transitive closure/reduction,
WCC (copy of flexflow_tpu/utils/graph/algorithms.py, the pure-Python path
only: the JAX package routes large graphs to its native core and pins the
two paths to equal results)."""

from __future__ import annotations

import heapq
from collections import deque
from typing import Dict, FrozenSet, List, Optional, Set

from flexflow_tpu_torch.utils.graph.digraph import DiGraph, Node


def get_topological_ordering(g: DiGraph) -> List[Node]:
    """Kahn's algorithm; deterministic (heap tie-break). Raises on cycles."""
    indeg = {n: g.in_degree(n) for n in g.nodes}
    ready = [n for n, d in indeg.items() if d == 0]
    out: List[Node] = []
    heapq.heapify(ready)
    while ready:
        n = heapq.heappop(ready)
        out.append(n)
        for s in g.successors(n):
            indeg[s] -= 1
            if indeg[s] == 0:
                heapq.heappush(ready, s)
    if len(out) != len(g.nodes):
        raise ValueError("graph has a cycle; no topological ordering exists")
    return out


def is_acyclic(g: DiGraph) -> bool:
    try:
        get_topological_ordering(g)
        return True
    except ValueError:
        return False


def get_predecessors(g: DiGraph, n: Node) -> FrozenSet[Node]:
    return g.predecessors(n)


def get_successors(g: DiGraph, n: Node) -> FrozenSet[Node]:
    return g.successors(n)


def get_descendants(g: DiGraph, n: Node) -> FrozenSet[Node]:
    """All nodes reachable from n (excluding n itself unless on a cycle)."""
    seen: Set[Node] = set()
    stack = list(g.successors(n))
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(g.successors(cur))
    return frozenset(seen)


def get_ancestors(g: DiGraph, n: Node) -> FrozenSet[Node]:
    seen: Set[Node] = set()
    stack = list(g.predecessors(n))
    while stack:
        cur = stack.pop()
        if cur in seen:
            continue
        seen.add(cur)
        stack.extend(g.predecessors(cur))
    return frozenset(seen)


def get_dominators(g: DiGraph) -> Dict[Node, FrozenSet[Node]]:
    """dom(n) = set of nodes on every path from any source to n (including n).

    Reference: lib/utils/include/utils/graph/digraph/algorithms/get_dominators.h.
    Iterative dataflow over topological order (graphs here are DAGs).
    """
    order = get_topological_ordering(g)
    all_nodes = frozenset(g.nodes)
    dom: Dict[Node, FrozenSet[Node]] = {}
    for n in order:
        preds = g.predecessors(n)
        if not preds:
            dom[n] = frozenset({n})
        else:
            inter: Optional[FrozenSet[Node]] = None
            for p in preds:
                inter = dom[p] if inter is None else inter & dom[p]
            dom[n] = (inter or frozenset()) | {n}
    return dom


def get_post_dominators(g: DiGraph) -> Dict[Node, FrozenSet[Node]]:
    return get_dominators(g.reversed())


def _reachability(g: DiGraph) -> Dict[Node, Set[Node]]:
    """reach[n] = all nodes reachable from n via >=1 edge (DAG only)."""
    order = get_topological_ordering(g)
    reach: Dict[Node, Set[Node]] = {n: set() for n in g.nodes}
    for n in reversed(order):
        for s in g.successors(n):
            reach[n].add(s)
            reach[n] |= reach[s]
    return reach


def get_transitive_closure(g: DiGraph) -> DiGraph:
    """Edge (a, b) in result iff b reachable from a in g."""
    reach = _reachability(g)
    result = DiGraph.from_edges(g.nodes, [])
    for n, rs in reach.items():
        for r in rs:
            result.add_edge(n, r)
    return result


def get_transitive_reduction(g: DiGraph) -> DiGraph:
    """Minimal subgraph of the DAG with the same reachability.

    Reference: lib/utils/include/utils/graph/digraph/algorithms/transitive_reduction.h.
    Used to find the tensors that actually cross an SP split
    (lib/compiler/src/.../transitive_reduced_pcg.cc).

    Edge (a, b) is redundant iff b is reachable from a via a path of length >= 2.
    """
    reach = _reachability(g)
    result = DiGraph.from_edges(g.nodes, [])
    for n in g.nodes:
        for s in g.successors(n):
            # redundant if some other successor reaches s
            if not any(s in reach[t] for t in g.successors(n) if t != s):
                result.add_edge(n, s)
    return result


def get_weakly_connected_components(g: DiGraph) -> List[FrozenSet[Node]]:
    seen: Set[Node] = set()
    comps: List[FrozenSet[Node]] = []
    for start in sorted(g.nodes):
        if start in seen:
            continue
        comp: Set[Node] = set()
        q = deque([start])
        while q:
            n = q.popleft()
            if n in comp:
                continue
            comp.add(n)
            q.extend(g.successors(n) | g.predecessors(n))
        seen |= comp
        comps.append(frozenset(comp))
    return comps
