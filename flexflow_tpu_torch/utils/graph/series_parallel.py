"""Series-parallel decomposition of DAGs + binary SP trees (copy of
flexflow_tpu/utils/graph/series_parallel.py, the pure-Python reduction only).

Equivalent of reference lib/utils/include/utils/graph/series_parallel/
(series_reduction.h, parallel_reduction.h, get_series_parallel_decomposition.h,
binary_sp_decomposition_tree/). Consumed by the machine-mapping DP
(lib/compiler/src/compiler/machine_mapping/get_optimal_machine_mapping.cc),
where SERIES splits introduce communication boundaries and PARALLEL splits
introduce resource splits.

Algorithm: Valdes-Tarjan-Lawler style reduction. Add a virtual source/sink,
then repeatedly apply
  - parallel reductions: merge parallel edges (same endpoints), and
  - series reductions: splice out a node with in-degree 1 and out-degree 1,
tracking, per edge, the SP tree of real nodes "absorbed" into it. The DAG is
(two-terminal) series-parallel iff this terminates with the single edge
source->sink; its label is the decomposition.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple, Union

from flexflow_tpu_torch.utils.graph.digraph import DiGraph, MultiDiEdge, MultiDiGraph, Node

# ---------------------------------------------------------------------------
# N-ary decomposition trees
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SeriesSplit:
    """Ordered children executed one after another."""

    children: Tuple["SeriesParallelDecomposition", ...]

    def __repr__(self) -> str:
        return "S(" + ", ".join(map(repr, self.children)) + ")"


@dataclass(frozen=True)
class ParallelSplit:
    """Unordered children with no dependencies between them."""

    children: FrozenSet["SeriesParallelDecomposition"]

    def __repr__(self) -> str:
        return "P{" + ", ".join(
            map(repr, sorted(self.children, key=sp_tree_sort_key))
        ) + "}"


SeriesParallelDecomposition = Union[Node, SeriesSplit, ParallelSplit]


def sp_tree_sort_key(t: "SeriesParallelDecomposition") -> int:
    """Deterministic ordering key for unordered parallel children: the
    minimum node index in the subtree. O(subtree) once, unlike sorting by
    repr — whose recursive string build is quadratic-to-exponential on deep
    trees (a 12-layer transformer's decomposition hung for minutes on it)."""
    if isinstance(t, Node):
        return t.idx
    return min(sp_tree_sort_key(c) for c in t.children)


def sp_nodes(sp: SeriesParallelDecomposition) -> FrozenSet[Node]:
    if isinstance(sp, Node):
        return frozenset({sp})
    out: FrozenSet[Node] = frozenset()
    for c in sp.children:
        out |= sp_nodes(c)
    return out


def _normalize(sp: SeriesParallelDecomposition) -> SeriesParallelDecomposition:
    """Flatten nested same-kind splits and collapse singleton splits."""
    if isinstance(sp, Node):
        return sp
    children = [_normalize(c) for c in sp.children]
    flat: List[SeriesParallelDecomposition] = []
    for c in children:
        if isinstance(c, type(sp)):
            flat.extend(c.children)
        else:
            flat.append(c)
    if len(flat) == 1:
        return flat[0]
    if isinstance(sp, SeriesSplit):
        return SeriesSplit(tuple(flat))
    return ParallelSplit(frozenset(flat))


# ---------------------------------------------------------------------------
# Decomposition algorithm
# ---------------------------------------------------------------------------

# During reduction, each multigraph edge carries an ordered list of SP items
# already absorbed into it (a "series chain" between its endpoints).
_EdgeLabel = Tuple[SeriesParallelDecomposition, ...]


def _join(kind, items) -> SeriesParallelDecomposition:
    """_normalize of a `kind` split whose items are normalized already (every
    label item is a node or a joined split): flattening one level gives the
    same tree without walking the items' subtrees again, which made the
    reduction quadratic in the graph's depth."""
    flat: List[SeriesParallelDecomposition] = []
    for c in items:
        if isinstance(c, kind):
            flat.extend(c.children)
        else:
            flat.append(c)
    if len(flat) == 1:
        return flat[0]
    return SeriesSplit(tuple(flat)) if kind is SeriesSplit else ParallelSplit(frozenset(flat))


def _wrap_series(items: _EdgeLabel) -> Optional[SeriesParallelDecomposition]:
    if len(items) == 0:
        return None
    if len(items) == 1:
        return items[0]
    return _join(SeriesSplit, items)


def get_series_parallel_decomposition(
    g: DiGraph,
) -> Optional[SeriesParallelDecomposition]:
    """SP decomposition of a (multi-source, multi-sink) DAG, or None if not SP.

    Mirrors reference get_series_parallel_decomposition.h semantics: the
    decomposition covers the *nodes* of g. Two passes: the TTSP edge
    reduction (chains, diamonds, nested splits), then — because node-series
    composition of parallel stages produces complete-bipartite edge sets
    that edge-TTSP cannot reduce (e.g. two sibling Linears reading the same
    tensor: Inception towers, DLRM embedding banks, QKV branches) — a
    parallel-module contraction: nodes with identical predecessor AND
    successor sets form an independent module, are contracted to one
    representative, and re-expanded as a ParallelSplit in the result
    (the node-SP semantics of the reference's bipartite-composite handling).
    """
    sp = _ttsp_decomposition(g)
    if sp is not None:
        return sp
    return _decompose_with_module_contraction(g)


def _decompose_with_module_contraction(
    g: DiGraph,
) -> Optional[SeriesParallelDecomposition]:
    groups: Dict[Tuple[FrozenSet[Node], FrozenSet[Node]], List[Node]] = {}
    for n in g.nodes:
        key = (frozenset(g.predecessors(n)), frozenset(g.successors(n)))
        groups.setdefault(key, []).append(n)
    if all(len(ns) == 1 for ns in groups.values()):
        return None  # nothing to contract; genuinely not SP
    # members of a group share preds/succs, so (no self-loops) they cannot
    # have edges among themselves: a valid parallel module
    rep_of: Dict[Node, Node] = {}
    members_of: Dict[Node, List[Node]] = {}
    for ns in groups.values():
        r = min(ns, key=lambda n: n.idx)
        members_of[r] = ns
        for n in ns:
            rep_of[n] = r
    cg = DiGraph()
    for r in members_of:
        cg._add_existing_node(r)
    for n in g.nodes:
        for succ in g.successors(n):
            a, b = rep_of[n], rep_of[succ]
            if a != b and not cg.has_edge(a, b):
                cg.add_edge(a, b)
    sub = get_series_parallel_decomposition(cg)  # may contract further
    if sub is None:
        return None

    def expand(t: SeriesParallelDecomposition) -> SeriesParallelDecomposition:
        if isinstance(t, Node):
            ms = members_of[t]
            if len(ms) == 1:
                return ms[0]
            return ParallelSplit(frozenset(ms))
        if isinstance(t, SeriesSplit):
            return SeriesSplit(tuple(expand(c) for c in t.children))
        return ParallelSplit(frozenset(expand(c) for c in t.children))

    return _normalize(expand(sub))


def _ttsp_decomposition(
    g: DiGraph,
) -> Optional[SeriesParallelDecomposition]:
    """Valdes-Tarjan-Lawler edge reduction on the two-terminal multigraph."""
    if not g.nodes:
        return None
    if len(g.nodes) == 1:
        return next(iter(g.nodes))

    mg = MultiDiGraph.from_digraph(g)
    labels: Dict[MultiDiEdge, _EdgeLabel] = {e: () for e in mg.edges}

    # Virtual source/sink.
    s = mg.add_node()
    t = mg.add_node()
    for src in [n for n in g.nodes if not g.predecessors(n)]:
        e = mg.add_edge(s, src)
        labels[e] = ()
    for snk in [n for n in g.nodes if not g.successors(n)]:
        e = mg.add_edge(snk, t)
        labels[e] = ()

    changed = True
    while changed:
        changed = False

        # Parallel reductions: merge all edge groups with identical endpoints.
        by_pair: Dict[Tuple[Node, Node], List[MultiDiEdge]] = {}
        for e in mg.edges:
            by_pair.setdefault((e.src, e.dst), []).append(e)
        for (u, v), es in by_pair.items():
            if len(es) > 1:
                branches = []
                for e in es:
                    w = _wrap_series(labels[e])
                    if w is not None:
                        branches.append(w)
                    mg.remove_edge(e)
                    del labels[e]
                ne = mg.add_edge(u, v)
                if len(branches) == 0:
                    labels[ne] = ()
                elif len(branches) == 1:
                    # Degenerate: some branch was empty (redundant edge), keep
                    # the non-empty chain. Only sound because an empty branch
                    # means a direct redundant edge; matches transitive-reduced
                    # usage.
                    labels[ne] = (branches[0],)
                else:
                    labels[ne] = (_join(ParallelSplit, branches),)
                changed = True

        # Series reductions: splice out v with in-degree 1 and out-degree 1.
        for v in sorted(mg.nodes):
            if v in (s, t):
                continue
            if mg.in_degree(v) == 1 and mg.out_degree(v) == 1:
                e1 = next(iter(mg.in_edges(v)))
                e2 = next(iter(mg.out_edges(v)))
                if e1.src == v or e2.dst == v:
                    continue  # self loop; not a DAG, bail
                new_label = labels[e1] + (v,) + labels[e2]
                mg.remove_edge(e1)
                mg.remove_edge(e2)
                del labels[e1]
                del labels[e2]
                mg.remove_node(v)
                ne = mg.add_edge(e1.src, e2.dst)
                labels[ne] = new_label
                changed = True

    remaining = mg.edges
    if len(remaining) == 1:
        e = next(iter(remaining))
        if e.src == s and e.dst == t:
            return _wrap_series(labels[e])
    return None


def is_series_parallel(g: DiGraph) -> bool:
    return get_series_parallel_decomposition(g) is not None


# ---------------------------------------------------------------------------
# Binary SP trees (reference: series_parallel/binary_sp_decomposition_tree/)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class BinarySeriesSplit:
    left: "BinarySPDecompositionTree"
    right: "BinarySPDecompositionTree"

    def __repr__(self) -> str:
        return f"S({self.left!r}, {self.right!r})"


@dataclass(frozen=True)
class BinaryParallelSplit:
    left: "BinarySPDecompositionTree"
    right: "BinarySPDecompositionTree"

    def __repr__(self) -> str:
        return f"P({self.left!r}, {self.right!r})"


BinarySPDecompositionTree = Union[Node, BinarySeriesSplit, BinaryParallelSplit]


def binary_sp_tree_nodes(t: BinarySPDecompositionTree) -> FrozenSet[Node]:
    if isinstance(t, Node):
        return frozenset({t})
    return binary_sp_tree_nodes(t.left) | binary_sp_tree_nodes(t.right)


def left_associative_binary_sp_tree_from_nary(
    children: List[BinarySPDecompositionTree], series: bool
) -> BinarySPDecompositionTree:
    assert children
    acc = children[0]
    for c in children[1:]:
        acc = BinarySeriesSplit(acc, c) if series else BinaryParallelSplit(acc, c)
    return acc


def sp_decomposition_to_binary(
    sp: SeriesParallelDecomposition,
) -> BinarySPDecompositionTree:
    """Left-associative binarization (reference:
    left_associative_binary_sp_tree_from_nary.h)."""
    if isinstance(sp, Node):
        return sp
    if isinstance(sp, SeriesSplit):
        return left_associative_binary_sp_tree_from_nary(
            [sp_decomposition_to_binary(c) for c in sp.children], series=True
        )
    # Deterministic order for the unordered parallel children.
    kids = sorted(sp.children, key=sp_tree_sort_key)
    return left_associative_binary_sp_tree_from_nary(
        [sp_decomposition_to_binary(c) for c in kids], series=False
    )
