"""Computation graph, its builder, initializers and optimizer attrs."""

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

__all__ = [
    "AdamOptimizerAttrs",
    "ComputationGraph",
    "ComputationGraphBuilder",
    "LayerAttrs",
    "OptimizerAttrs",
    "SGDOptimizerAttrs",
    "TensorAttrs",
]
