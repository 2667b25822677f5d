"""Two-level machine-mapping DP over nodes x GPUs per node (copy of
flexflow_tpu/compiler/machine_mapping/hierarchical.py, the JAX package's
ICI/DCN DP, whose "slice" is a node here).

On a machine of several nodes the interconnect is hierarchical: each node's
GPUs share NVLink/NVSwitch, and nodes are joined by InfiniBand through a
few NIC ports (compiler/machine_model.py). A flat DP enumerating
INTER/INTRA projections as if all links were equal either wastes candidates
on tensor-parallel-across-nodes plans or picks one where the analytic model
underprices the boundary. The two-level composition makes the hierarchy
structural:

- OUTER level: which axis KIND crosses the node boundary. Only data,
  replica and stage axes may (slice_axes.DCN_LEGAL_KINDS: their traffic
  crosses once per step by design), plus the "intra" choice that keeps the
  whole plan inside one node's sub-grid.
- INNER level: the flat DP (get_optimal_machine_mapping) per choice, with
  the allowed-views callback restricted to that choice's node-contiguous
  views and `slice_aware=True`, so even constraint-injected views are
  masked. Boundary movement is priced by the comm model's cross-node route
  (exit NVLink hop + NIC-congested InfiniBand transfer + entry hop).

Memoization: each outer choice owns one flat MachineMappingCache reused
across every candidate of the search, so a sub-problem resolves once per
(sub-problem, node shape); the "intra" choice solves on the single-node
sub-grid (num_nodes=1), and identical nodes share that one solve.

The cache subclass is the integration point: graph_optimize constructs a
HierarchicalMachineMappingCache when the context asks for
`slice_hierarchy`, and get_optimal_machine_mapping reroutes root-level
solves through `solve_hierarchical`. Constrained (interior) calls still land
in the inherited flat tables, so overlap derivation keeps working.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
    MachineMappingCache,
    MachineMappingContext,
    get_optimal_machine_mapping,
)
from flexflow_tpu_torch.compiler.machine_mapping.result import (
    INFEASIBLE,
    MachineMappingResult,
)
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification

# outer-level enumeration order (deterministic tie-break: first wins)
OUTER_CHOICES: Tuple[str, ...] = ("data", "replica", "stage", "intra")

# Task-axis kinds each outer choice lets project across nodes.
# A boundary split is ONE physical axis but manifests as different kinds
# on different leaves: a data split shards activations ("data") while the
# weight leaves riding it carry the matching replica axis ("replica") —
# masking the replica side would reject every dp-across-slices plan
# wholesale. Same for stage splits whose stage-replicated weights carry
# replica axes. All companion kinds stay within slice_axes.DCN_LEGAL_KINDS.
CHOICE_CROSS_KINDS: Dict[str, frozenset] = {
    "data": frozenset({"data", "replica"}),
    "replica": frozenset({"replica"}),
    "stage": frozenset({"stage", "replica"}),
}


def _choice_allowed_views(choice: str):
    """Allowed-views callback for one outer choice: node-contiguous
    projection-representative views where only task dims of `choice`'s
    kind may project across nodes, built once per (leaf, resources)."""
    from flexflow_tpu_torch.compiler.allowed_machine_views import (
        get_slice_aware_machine_views,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
        task_space_of_leaf,
    )
    from flexflow_tpu_torch.compiler.machine_mapping.slice_axes import (
        leaf_task_axis_kinds,
    )

    cross = CHOICE_CROSS_KINDS[choice]
    built: Dict = {}

    def allowed(leaf, resources):
        views = built.get((leaf, resources))
        if views is None:
            kinds = leaf_task_axis_kinds(leaf)
            views = built[(leaf, resources)] = get_slice_aware_machine_views(
                resources,
                task_space_of_leaf(leaf),
                tuple(k in cross for k in kinds),
            )
        return views

    return allowed


class HierarchicalMachineMappingCache(MachineMappingCache):
    """Outer-level state of the two-level DP: one flat sub-cache (and one
    derived context) per outer choice, plus per-(tree, resources) outer
    provenance. Standing in for a flat MachineMappingCache, it reroutes
    root-level solves via get_optimal_machine_mapping's
    `solve_hierarchical` hook; everything else (constrained interior
    solves, overlap tables) uses the inherited flat storage."""

    def __init__(self) -> None:
        super().__init__()
        self.choice_caches: Dict[str, MachineMappingCache] = {}
        self._choice_contexts: Dict[str, MachineMappingContext] = {}
        self._base_context: Optional[MachineMappingContext] = None
        # (tree, resources) -> {"choices": {choice: runtime|None},
        #                       "winner": choice|None}
        self._outer: Dict = {}

    def aggregate_counters(self) -> Tuple[int, int]:
        """(hits, misses) summed over the flat table and every per-choice
        sub-cache (search telemetry)."""
        h, m = self.hits, self.misses
        for sub in self.choice_caches.values():
            h += sub.hits
            m += sub.misses
        return h, m

    def _context_for(self, base: MachineMappingContext, choice: str):
        if self._base_context is not base:
            # a new context invalidates every derived one (and, per the
            # flat cache's contract, callers must not reuse this cache
            # across semantically different contexts)
            self._base_context = base
            self._choice_contexts.clear()
        ctx = self._choice_contexts.get(choice)
        if ctx is None:
            if choice == "intra":
                # whole plan inside one node: the sub-grid enumeration
                # already yields only INTRA views on a 1-node spec
                ctx = replace(
                    base, slice_aware=True, slice_hierarchy=False
                )
            else:
                ctx = replace(
                    base,
                    allowed_machine_views=_choice_allowed_views(choice),
                    slice_aware=True,
                    slice_hierarchy=False,
                )
            self._choice_contexts[choice] = ctx
        return ctx

    def solve_hierarchical(
        self,
        context: MachineMappingContext,
        tree,
        resources: MachineSpecification,
    ) -> MachineMappingResult:
        if resources.num_nodes <= 1:
            # one node: the hierarchy is trivial — flat solve on the
            # shared "intra" sub-cache
            sub = self.choice_caches.setdefault(
                "intra", MachineMappingCache()
            )
            return get_optimal_machine_mapping(
                sub, self._context_for(context, "intra"), tree, resources
            )
        per_choice: Dict[str, Optional[float]] = {}
        best: MachineMappingResult = INFEASIBLE
        winner: Optional[str] = None
        for choice in OUTER_CHOICES:
            sub = self.choice_caches.setdefault(
                choice, MachineMappingCache()
            )
            ctx = self._context_for(context, choice)
            res = (
                replace(resources, num_nodes=1)
                if choice == "intra"
                else resources
            )
            result = get_optimal_machine_mapping(sub, ctx, tree, res)
            per_choice[choice] = (
                None if result is INFEASIBLE or result is None
                else result.runtime
            )
            if result is not None and result is not INFEASIBLE:
                if best is INFEASIBLE or result.runtime < best.runtime:
                    best = result
                    winner = choice
        self._outer[(tree, resources)] = {
            "choices": dict(per_choice),
            "winner": winner,
        }
        return best

    def outer_of(self, tree, resources) -> Optional[Dict]:
        """Outer-level provenance of a prior solve: per-choice runtimes
        and the winning boundary-axis kind (None when never solved)."""
        return self._outer.get((tree, resources))
