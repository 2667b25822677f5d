"""Conv2D, Pool2D, Flat and BatchNorm attrs, NCHW (trimmed copy of
flexflow_tpu/op_attrs/ops/conv_ops.py: the sequential shape rules and the
weight shapes; the parallel rules wait for a multi-device compile)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Optional

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


def _conv_out(size: int, kernel: int, stride: int, pad: int) -> int:
    return (size + 2 * pad - kernel) // stride + 1


@dataclass(frozen=True)
class Conv2DAttrs:
    out_channels: int
    kernel_h: int
    kernel_w: int
    stride_h: int = 1
    stride_w: int = 1
    padding_h: int = 0
    padding_w: int = 0
    groups: int = 1
    activation: Optional[Activation] = None
    use_bias: bool = True

    def output_shape(self, input: TensorShape) -> TensorShape:
        n, c, h, w = input.dims
        if c % self.groups:
            raise ValueError(f"conv2d: {c} input channels do not divide into {self.groups} groups")
        return TensorShape(
            (
                n,
                self.out_channels,
                _conv_out(h, self.kernel_h, self.stride_h, self.padding_h),
                _conv_out(w, self.kernel_w, self.stride_w, self.padding_w),
            ),
            input.dtype,
        )

    def kernel_shape(self, input: TensorShape) -> TensorShape:
        c = input.dims[1]
        return TensorShape(
            (self.out_channels, c // self.groups, self.kernel_h, self.kernel_w), input.dtype
        )

    def bias_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((self.out_channels,), input.dtype)


class PoolOp(enum.Enum):
    MAX = "max"
    AVG = "avg"


@dataclass(frozen=True)
class Pool2DAttrs:
    kernel_h: int
    kernel_w: int
    stride_h: int = 1
    stride_w: int = 1
    padding_h: int = 0
    padding_w: int = 0
    pool_type: PoolOp = PoolOp.MAX
    activation: Optional[Activation] = None

    def output_shape(self, input: TensorShape) -> TensorShape:
        n, c, h, w = input.dims
        return TensorShape(
            (
                n,
                c,
                _conv_out(h, self.kernel_h, self.stride_h, self.padding_h),
                _conv_out(w, self.kernel_w, self.stride_w, self.padding_w),
            ),
            input.dtype,
        )


@dataclass(frozen=True)
class FlatAttrs:
    """[n, c, h, w] -> [n, c*h*w]."""

    def output_shape(self, input: TensorShape) -> TensorShape:
        n, c, h, w = input.dims
        return TensorShape((n, c * h * w), input.dtype)


@dataclass(frozen=True)
class BatchNormAttrs:
    relu: bool = False
    affine: bool = True
    eps: float = 1e-5
    momentum: float = 0.1

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input

    def gamma_shape(self, input: TensorShape) -> TensorShape:
        return TensorShape((input.dims[1],), input.dtype)

    def beta_shape(self, input: TensorShape) -> TensorShape:
        return self.gamma_shape(input)
