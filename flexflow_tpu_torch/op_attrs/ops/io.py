"""Input / Weight / Noop ops (copy of flexflow_tpu/op_attrs/ops/io.py)."""

from __future__ import annotations

from dataclasses import dataclass

from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorShape, lift_to_parallel
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class InputAttrs:
    """A graph input; carries its own shape."""

    shape: TensorShape

    def output_shape(self) -> TensorShape:
        return self.shape

    def parallel_output_shape(self) -> ParallelTensorShape:
        return lift_to_parallel(self.shape)


@dataclass(frozen=True)
class WeightAttrs:
    """A trainable weight; carries its own shape (its initializer lives on
    the tensor attrs of the graph)."""

    shape: TensorShape

    def output_shape(self) -> TensorShape:
        return self.shape

    def parallel_output_shape(self) -> ParallelTensorShape:
        return lift_to_parallel(self.shape)


@dataclass(frozen=True)
class NoopAttrs:
    """Identity; passes its single input through unchanged."""

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        return input
