"""Graph library (copy of flexflow_tpu/utils/graph/, without the JAX
package's native fast paths).

Equivalent of the reference's lib/utils/include/utils/graph
(design doc: lib/utils/include/utils/graph/README.md). Provides:

- DiGraph / MultiDiGraph: directed graphs with value semantics.
- DataflowGraph: a DAG whose nodes have ordered, indexed inputs and outputs
  (operator style) -- the substrate of ComputationGraph and
  ParallelComputationGraph (reference:
  lib/pcg/include/pcg/parallel_computation_graph/parallel_computation_graph.struct.toml:12-14).
- OpenDataflowGraph: dataflow graph with unbound graph inputs, used during
  substitution rewriting (reference:
  lib/substitutions/include/substitutions/sub_parallel_computation_graph.h).
- Algorithms: topological ordering, dominators, transitive closure/reduction,
  weakly connected components (reference: lib/utils/include/utils/graph/digraph/algorithms/).
- Series-parallel decomposition + binary SP trees (reference:
  lib/utils/include/utils/graph/series_parallel/), required by the
  machine-mapping DP.
"""

from flexflow_tpu_torch.utils.graph.digraph import DiGraph, DirectedEdge, MultiDiGraph, MultiDiEdge, Node
from flexflow_tpu_torch.utils.graph.dataflow import (
    DataflowGraph,
    DataflowOutput,
    DataflowInput,
    DataflowEdge,
    GraphInput,
    OpenDataflowGraph,
    OpenDataflowValue,
)
from flexflow_tpu_torch.utils.graph.algorithms import (
    get_topological_ordering,
    get_dominators,
    get_post_dominators,
    get_transitive_closure,
    get_transitive_reduction,
    get_weakly_connected_components,
    is_acyclic,
    get_predecessors,
    get_successors,
    get_descendants,
    get_ancestors,
)
from flexflow_tpu_torch.utils.graph.series_parallel import (
    SeriesParallelDecomposition,
    SeriesSplit,
    ParallelSplit,
    get_series_parallel_decomposition,
    BinarySeriesSplit,
    BinaryParallelSplit,
    BinarySPDecompositionTree,
    left_associative_binary_sp_tree_from_nary,
    sp_decomposition_to_binary,
)
