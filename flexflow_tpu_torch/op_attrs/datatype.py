"""Data types (copy of flexflow_tpu/op_attrs/datatype.py; `to_jnp` becomes
`to_torch`)."""

from __future__ import annotations

import enum

import torch


class DataType(enum.Enum):
    BOOL = "bool"
    INT32 = "int32"
    INT64 = "int64"
    HALF = "float16"
    BFLOAT16 = "bfloat16"
    FLOAT = "float32"
    DOUBLE = "float64"

    def to_torch(self) -> torch.dtype:
        return {
            DataType.BOOL: torch.bool,
            DataType.INT32: torch.int32,
            DataType.INT64: torch.int64,
            DataType.HALF: torch.float16,
            DataType.BFLOAT16: torch.bfloat16,
            DataType.FLOAT: torch.float32,
            DataType.DOUBLE: torch.float64,
        }[self]

    @property
    def size_bytes(self) -> int:
        return {
            DataType.BOOL: 1,
            DataType.INT32: 4,
            DataType.INT64: 8,
            DataType.HALF: 2,
            DataType.BFLOAT16: 2,
            DataType.FLOAT: 4,
            DataType.DOUBLE: 8,
        }[self]

    @property
    def is_floating(self) -> bool:
        return self in (DataType.HALF, DataType.BFLOAT16, DataType.FLOAT, DataType.DOUBLE)
