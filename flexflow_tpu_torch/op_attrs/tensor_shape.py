"""TensorShape (copy of flexflow_tpu/op_attrs/tensor_shape.py).

Dims are order-major: index 0 is the outermost dim; negative indices count
from the last dim."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from flexflow_tpu_torch.op_attrs.datatype import DataType

TensorDims = Tuple[int, ...]


@dataclass(frozen=True, order=True)
class TensorShape:
    dims: TensorDims
    dtype: DataType = DataType.FLOAT

    def __post_init__(self) -> None:
        if not all(isinstance(d, int) and d >= 1 for d in self.dims):
            raise ValueError(f"tensor dims must be positive ints: {self.dims}")

    @property
    def num_dims(self) -> int:
        return len(self.dims)

    def dim_at(self, idx: int) -> int:
        return self.dims[idx]

    @property
    def num_elements(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    @property
    def size_bytes(self) -> int:
        return self.num_elements * self.dtype.size_bytes

    def with_dim(self, idx: int, size: int) -> "TensorShape":
        dims = list(self.dims)
        dims[idx] = size
        return TensorShape(tuple(dims), self.dtype)

    def __repr__(self) -> str:
        return f"TensorShape({list(self.dims)}, {self.dtype.value})"
