"""Operator attrs and shape inference for the slice's ops."""

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape

__all__ = ["Activation", "DataType", "TensorShape"]
