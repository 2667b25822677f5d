"""ParallelTensorShape: a tensor's global shape with its parallel degrees
(copy of flexflow_tpu/op_attrs/parallel_tensor_shape.py).

- Each shard dim carries its GLOBAL size and a shard degree (how many ways
  it is partitioned); the size divides by the degree.
- sum_degree: the tensor exists as this many partial values that sum to
  the logical tensor.
- discard_copy_degree: this many identical copies.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Tuple

from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.utils.hashing import memoized_hash


@memoized_hash
@dataclass(frozen=True, order=True)
class ShardParallelDim:
    """(global size, shard degree) of one tensor dim."""

    size: int
    degree: int = 1

    def __post_init__(self) -> None:
        if self.size < 1 or self.degree < 1 or self.size % self.degree:
            raise ValueError(f"dim size {self.size} does not divide by shard degree {self.degree}")

    @property
    def piece_size(self) -> int:
        return self.size // self.degree


@memoized_hash
@dataclass(frozen=True, order=True)
class ParallelTensorDims:
    shard_dims: Tuple[ShardParallelDim, ...]
    sum_degree: int = 1
    discard_copy_degree: int = 1

    def __post_init__(self) -> None:
        if self.sum_degree < 1 or self.discard_copy_degree < 1:
            raise ValueError(f"replica degrees must be positive: {self}")


@memoized_hash
@dataclass(frozen=True, order=True)
class ParallelTensorShape:
    dims: ParallelTensorDims
    dtype: DataType = DataType.FLOAT

    @property
    def num_dims(self) -> int:
        return len(self.dims.shard_dims)

    def shard_dim_at(self, idx: int) -> ShardParallelDim:
        return self.dims.shard_dims[idx]

    @property
    def sum_degree(self) -> int:
        return self.dims.sum_degree

    @property
    def discard_copy_degree(self) -> int:
        return self.dims.discard_copy_degree

    def shard_degrees(self) -> Tuple[int, ...]:
        return tuple(d.degree for d in self.dims.shard_dims)

    def sizes(self) -> Tuple[int, ...]:
        return tuple(d.size for d in self.dims.shard_dims)

    def __repr__(self) -> str:
        dims = ", ".join(
            f"{d.size}" + (f"/{d.degree}" if d.degree != 1 else "")
            for d in self.dims.shard_dims
        )
        extra = ""
        if self.sum_degree != 1:
            extra += f", sum={self.sum_degree}"
        if self.discard_copy_degree != 1:
            extra += f", copy={self.discard_copy_degree}"
        return f"PTShape([{dims}]{extra}, {self.dtype.value})"


def lift_to_parallel(ts: TensorShape) -> ParallelTensorShape:
    """Trivially parallel: every degree 1."""
    return lift_to_parallel_with_degrees(ts, 1, 1, (1,) * ts.num_dims)


def lift_to_parallel_with_degrees(
    ts: TensorShape,
    sum_degree: int,
    discard_copy_degree: int,
    shard_degrees: Sequence[int],
) -> ParallelTensorShape:
    if len(shard_degrees) != ts.num_dims:
        raise ValueError(f"{len(shard_degrees)} shard degrees for {ts}")
    return ParallelTensorShape(
        ParallelTensorDims(
            tuple(ShardParallelDim(s, d) for s, d in zip(ts.dims, shard_degrees)),
            sum_degree,
            discard_copy_degree,
        ),
        ts.dtype,
    )


def get_reduced_shape(pts: ParallelTensorShape) -> TensorShape:
    """Global sizes, without the degrees."""
    return TensorShape(pts.sizes(), pts.dtype)


def get_piece_shape(pts: ParallelTensorShape) -> TensorShape:
    """Per-device piece shape: size/degree per dim."""
    return TensorShape(tuple(d.piece_size for d in pts.dims.shard_dims), pts.dtype)


def total_parallel_degree(pts: ParallelTensorShape) -> int:
    n = pts.sum_degree * pts.discard_copy_degree
    for d in pts.dims.shard_dims:
        n *= d.degree
    return n


def get_piece_num_elements(pts: ParallelTensorShape) -> int:
    return get_piece_shape(pts).num_elements


def with_shard_degree(pts: ParallelTensorShape, idx: int, degree: int) -> ParallelTensorShape:
    sd = list(pts.dims.shard_dims)
    sd[idx] = ShardParallelDim(sd[idx].size, degree)
    return ParallelTensorShape(
        ParallelTensorDims(tuple(sd), pts.sum_degree, pts.discard_copy_degree), pts.dtype
    )


def with_sum_degree(pts: ParallelTensorShape, sum_degree: int) -> ParallelTensorShape:
    return ParallelTensorShape(
        ParallelTensorDims(pts.dims.shard_dims, sum_degree, pts.discard_copy_degree), pts.dtype
    )


def with_discard_copy_degree(pts: ParallelTensorShape, dc: int) -> ParallelTensorShape:
    return ParallelTensorShape(
        ParallelTensorDims(pts.dims.shard_dims, pts.sum_degree, dc), pts.dtype
    )
