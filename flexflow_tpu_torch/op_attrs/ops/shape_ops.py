"""Concat, Stack, Split, Reshape, Transpose, Reverse, Gather, TopK and
Reduce attrs (copy of flexflow_tpu/op_attrs/ops/shape_ops.py, with their
sequential and parallel shape rules)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from math import prod
from typing import Tuple

from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class ConcatAttrs:
    axis: int

    def output_shape(self, *inputs: TensorShape) -> TensorShape:
        if not inputs:
            raise ValueError("concat needs at least one input")
        base = inputs[0]
        a = self.axis % base.num_dims
        total = 0
        for s in inputs:
            if s.num_dims != base.num_dims or any(
                s.dims[i] != base.dims[i] for i in range(base.num_dims) if i != a
            ):
                raise ValueError(f"concat mismatch off axis {a}: {s} vs {base}")
            total += s.dims[a]
        return base.with_dim(a, total)

    def parallel_output_shape(self, *inputs: ParallelTensorShape) -> ParallelTensorShape:
        a = self.axis % inputs[0].num_dims
        base = inputs[0]
        for s in inputs:
            if (s.shard_degrees() != base.shard_degrees() or s.sum_degree != base.sum_degree
                    or s.shard_dim_at(a).degree != 1):
                raise ValueError(f"concat needs equal degrees and a whole axis: {s} vs {base}")
        unpar = self.output_shape(*map(get_reduced_shape, inputs))
        return lift_to_parallel_with_degrees(
            unpar, base.sum_degree, min(s.discard_copy_degree for s in inputs),
            base.shard_degrees(),
        )


@dataclass(frozen=True)
class StackAttrs:
    """Stack k same-shaped tensors along a NEW leading axis -> [k, *dims].

    No reference counterpart: this is the entry op of branch stacking
    (compiler/branch_stacking.py), the realization of the reference's
    disjoint-device operator placement (mapper.h:82-126) as a sharding:
    sharding the new leading axis over the ranks places each branch's
    compute on a disjoint set of devices."""

    def output_shape(self, *inputs: TensorShape) -> TensorShape:
        assert len(inputs) >= 1
        base = inputs[0]
        for s in inputs:
            assert s.dims == base.dims, f"stack shape mismatch: {s} vs {base}"
        return TensorShape((len(inputs),) + base.dims, base.dtype)

    def parallel_output_shape(self, *inputs: ParallelTensorShape) -> ParallelTensorShape:
        base = inputs[0]
        for s in inputs:
            assert s.shard_degrees() == base.shard_degrees()
            assert s.sum_degree == base.sum_degree
        unpar = self.output_shape(*[get_reduced_shape(s) for s in inputs])
        return lift_to_parallel_with_degrees(
            unpar,
            base.sum_degree,
            min(s.discard_copy_degree for s in inputs),
            (1,) + base.shard_degrees(),
        )


@dataclass(frozen=True)
class SplitAttrs:
    sizes: Tuple[int, ...]
    axis: int

    def output_shapes(self, input: TensorShape) -> Tuple[TensorShape, ...]:
        a = self.axis % input.num_dims
        if sum(self.sizes) != input.dims[a]:
            raise ValueError(f"split sizes {self.sizes} do not sum to dim {a} of {input}")
        return tuple(input.with_dim(a, s) for s in self.sizes)

    def parallel_output_shapes(
        self, input: ParallelTensorShape
    ) -> Tuple[ParallelTensorShape, ...]:
        a = self.axis % input.num_dims
        if input.shard_dim_at(a).degree != 1:
            raise ValueError(f"split axis must be unsharded: {input}")
        return tuple(
            lift_to_parallel_with_degrees(
                o, input.sum_degree, input.discard_copy_degree, input.shard_degrees()
            )
            for o in self.output_shapes(get_reduced_shape(input))
        )


@dataclass(frozen=True)
class ReshapeAttrs:
    shape: Tuple[int, ...]

    def output_shape(self, input: TensorShape) -> TensorShape:
        if prod(self.shape) != prod(input.dims):
            raise ValueError(f"reshape {input.dims} -> {self.shape}")
        return TensorShape(self.shape, input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        """A leading prefix of dims kept verbatim keeps its shard degrees;
        every dim actually reshaped must be unsharded."""
        unpar = self.output_shape(get_reduced_shape(input))
        in_sizes, out_sizes = input.sizes(), self.shape
        in_deg = input.shard_degrees()
        prefix = 0
        while (prefix < min(len(in_sizes), len(out_sizes))
               and in_sizes[prefix] == out_sizes[prefix]):
            prefix += 1
        if any(d != 1 for d in in_deg[prefix:]):
            raise ValueError(f"reshaped dims of {input} must be unsharded")
        out_degrees = in_deg[:prefix] + (1,) * (len(out_sizes) - prefix)
        return lift_to_parallel_with_degrees(
            unpar, input.sum_degree, input.discard_copy_degree, out_degrees
        )


@dataclass(frozen=True)
class TransposeAttrs:
    perm: Tuple[int, ...]

    def output_shape(self, input: TensorShape) -> TensorShape:
        if sorted(self.perm) != list(range(input.num_dims)):
            raise ValueError(f"perm {self.perm} is no permutation of {input}")
        return TensorShape(tuple(input.dims[p] for p in self.perm), input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        """The degrees permute with the dims."""
        unpar = self.output_shape(get_reduced_shape(input))
        out_degrees = tuple(input.shard_degrees()[p] for p in self.perm)
        return lift_to_parallel_with_degrees(
            unpar, input.sum_degree, input.discard_copy_degree, out_degrees)


@dataclass(frozen=True)
class ReverseAttrs:
    axis: int

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        """The reversed axis must be unsharded."""
        if input.shard_dim_at(self.axis % input.num_dims).degree != 1:
            raise ValueError(f"reverse of a sharded axis {self.axis}: {input}")
        return input


@dataclass(frozen=True)
class GatherAttrs:
    dim: int

    def output_shape(self, input: TensorShape, index: TensorShape) -> TensorShape:
        """torch.gather's semantics: the output has the index's shape."""
        if input.num_dims != index.num_dims:
            raise ValueError(f"gather of {input} at {index}: ranks differ")
        return TensorShape(index.dims, input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape,
                              index: ParallelTensorShape) -> ParallelTensorShape:
        """The gathered dim must be unsharded; the index's degrees carry to
        the output."""
        d = self.dim % input.num_dims
        if input.shard_dim_at(d).degree != 1 or input.sum_degree != 1:
            raise ValueError(f"gather along a sharded or partial dim {d}: {input}")
        unpar = self.output_shape(get_reduced_shape(input), get_reduced_shape(index))
        return lift_to_parallel_with_degrees(
            unpar, 1, min(input.discard_copy_degree, index.discard_copy_degree),
            index.shard_degrees())


@dataclass(frozen=True)
class TopKAttrs:
    k: int
    sorted: bool = True

    def output_shapes(self, input: TensorShape) -> Tuple[TensorShape, TensorShape]:
        from flexflow_tpu_torch.op_attrs.datatype import DataType

        out = input.with_dim(-1, self.k)
        return out, TensorShape(out.dims, DataType.INT32)

    def parallel_output_shapes(self, input: ParallelTensorShape
                               ) -> Tuple[ParallelTensorShape, ParallelTensorShape]:
        if input.shard_dim_at(-1).degree != 1 or input.sum_degree != 1:
            raise ValueError(f"top_k's dim must be whole: {input}")
        values, indices = self.output_shapes(get_reduced_shape(input))
        degs = input.shard_degrees()
        return (lift_to_parallel_with_degrees(values, 1, input.discard_copy_degree, degs),
                lift_to_parallel_with_degrees(indices, 1, input.discard_copy_degree, degs))


class ReduceOpType(enum.Enum):
    SUM = "sum"
    MEAN = "mean"
    MAX = "max"
    MIN = "min"
    PROD = "prod"


@dataclass(frozen=True)
class ReduceAttrs:
    op_type: ReduceOpType
    axes: Tuple[int, ...]
    keepdims: bool = False

    def output_shape(self, input: TensorShape) -> TensorShape:
        axes = {a % input.num_dims for a in self.axes}
        if self.keepdims:
            return TensorShape(
                tuple(1 if i in axes else d for i, d in enumerate(input.dims)), input.dtype
            )
        dims = tuple(d for i, d in enumerate(input.dims) if i not in axes)
        return TensorShape(dims if dims else (1,), input.dtype)

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        """SUM over a sharded axis turns its shard degree into a sum degree;
        the other reductions (MEAN too) need their axes unsharded."""
        axes = {a % input.num_dims for a in self.axes}
        sum_degree = input.sum_degree
        for a in axes:
            deg = input.shard_dim_at(a).degree
            if self.op_type == ReduceOpType.SUM:
                sum_degree *= deg
            elif deg != 1:
                raise ValueError(f"{self.op_type} over sharded axis {a}")
        unpar = self.output_shape(get_reduced_shape(input))
        shard_dims = input.dims.shard_dims
        if self.keepdims:
            out_degrees = tuple(1 if i in axes else d.degree for i, d in enumerate(shard_dims))
        else:
            out_degrees = tuple(
                d.degree for i, d in enumerate(shard_dims) if i not in axes
            ) or (1,)
        return lift_to_parallel_with_degrees(
            unpar, sum_degree, input.discard_copy_degree, out_degrees
        )
