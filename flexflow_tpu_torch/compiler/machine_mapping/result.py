"""MachineMappingResult + combinators (copy of
flexflow_tpu/compiler/machine_mapping/result.py, without the overlapped
movement entry of machine_mapping/overlap.py).

Reference: lib/compiler/src/compiler/machine_mapping/machine_mapping_result.cc:35-101
(series_combine: runtime = pre + comm + post; parallel_combine: max; plus
infeasible propagation and mapping merge with L/R path prefixes).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from flexflow_tpu_torch.pcg.machine_view import MachineView
from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import BinaryTreePath


class ParallelSplitTransformation(enum.Enum):
    """Serializing transform of a parallel split (reference:
    parallel_split_transformation.enum.toml): run both children in series on
    the full resources, left-then-right or right-then-left."""

    LthenR = "LthenR"
    RthenL = "RthenL"


# The mapping is stored as a nested pair tree mirroring the problem tree:
# a leaf is (None, view); a pair is (left_subtree, right_subtree). Combining
# two results is then O(1) (the flat path->view tuple used to be rebuilt and
# re-sorted at EVERY series/parallel combine — a top DP hotspot); the flat
# dict is materialized once by mapping_dict at the end.
MappingTree = Tuple


@dataclass(frozen=True)
class FeasibleMachineMappingResult:
    runtime: float
    machine_mapping: MappingTree

    def mapping_dict(self) -> Dict[BinaryTreePath, MachineView]:
        out: Dict[BinaryTreePath, MachineView] = {}

        def walk(t: MappingTree, prefix: BinaryTreePath) -> None:
            if t[0] is None:
                out[prefix] = t[1]
                return
            walk(t[0], prefix + ("L",))
            walk(t[1], prefix + ("R",))

        walk(self.machine_mapping, ())
        return out


# Infeasible is represented as None inside MachineMappingResult.
MachineMappingResult = Optional[FeasibleMachineMappingResult]

INFEASIBLE: MachineMappingResult = None


def make_singleton_result(cost: float, view: MachineView) -> MachineMappingResult:
    return FeasibleMachineMappingResult(cost, (None, view))


def _combine_mappings(
    lhs: FeasibleMachineMappingResult, rhs: FeasibleMachineMappingResult
) -> MappingTree:
    return (lhs.machine_mapping, rhs.machine_mapping)


def series_combine(
    comm_cost: float,
    pre: MachineMappingResult,
    post: MachineMappingResult,
    parallel_split_transformation: Optional[ParallelSplitTransformation] = None,
    overlap_fraction: float = 0.0,
    ov_cost: Optional[float] = None,
) -> MachineMappingResult:
    """runtime = pre + exposed_comm + post, where boundary communication
    hides under up to `overlap_fraction` of the downstream stage's compute;
    overlap_fraction=0 recovers the reference machine_mapping_result.cc's
    strictly additive pre + comm + post.

    ov_cost (non-None only for splits the collective matmuls can lower, see
    machine_mapping/overlap.py) is the fused entry's full exposed cost:
    max(0, comm - the adjacent op's roofline time) plus the ring ramp. The
    combiner takes whichever exposure is cheaper, which is how the DP
    chooses the overlapped lowering."""
    if pre is None or post is None:
        return INFEASIBLE
    if parallel_split_transformation == ParallelSplitTransformation.RthenL:
        mapping = _combine_mappings(post, pre)
    else:
        mapping = _combine_mappings(pre, post)
    exposed = max(0.0, comm_cost - overlap_fraction * post.runtime)
    if ov_cost is not None and ov_cost < exposed:
        exposed = ov_cost
    return FeasibleMachineMappingResult(
        pre.runtime + exposed + post.runtime, mapping
    )


def parallel_combine(
    lhs: MachineMappingResult, rhs: MachineMappingResult
) -> MachineMappingResult:
    if lhs is None or rhs is None:
        return INFEASIBLE
    return FeasibleMachineMappingResult(
        max(lhs.runtime, rhs.runtime), _combine_mappings(lhs, rhs)
    )


def minimize_runtime(
    a: MachineMappingResult, b: MachineMappingResult
) -> MachineMappingResult:
    if a is None:
        return b
    if b is None:
        return a
    return a if a.runtime <= b.runtime else b
