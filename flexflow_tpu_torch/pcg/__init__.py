"""Computation graphs (sequential and parallel), their builders,
initializers and optimizer attrs."""

from flexflow_tpu_torch.pcg.computation_graph import (
    ComputationGraph,
    LayerAttrs,
    TensorAttrs,
)
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder
from flexflow_tpu_torch.pcg.optimizer import (
    AdamOptimizerAttrs,
    OptimizerAttrs,
    SGDOptimizerAttrs,
)
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    ParallelLayerAttrs,
    ParallelTensorAttrs,
    pcg_from_computation_graph,
)
from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder,
)

__all__ = [
    "AdamOptimizerAttrs",
    "ComputationGraph",
    "ComputationGraphBuilder",
    "LayerAttrs",
    "OptimizerAttrs",
    "ParallelComputationGraph",
    "ParallelComputationGraphBuilder",
    "ParallelLayerAttrs",
    "ParallelTensorAttrs",
    "SGDOptimizerAttrs",
    "TensorAttrs",
    "pcg_from_computation_graph",
]
