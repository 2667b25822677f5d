"""Activation / regularizer attrs (copy of flexflow_tpu/op_attrs/activation.py).

GELU is the tanh approximation: the JAX package applies `jax.nn.gelu`,
whose default is `approximate=True`."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union

import torch
import torch.nn.functional as F


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


class _ReLU(torch.autograd.Function):
    """ReLU with the JAX package's gradient, `where(x > 0, g, 0)`, taken on
    the saved output (y > 0 exactly where x > 0): a NaN input gets a zero
    gradient, where torch.relu's backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x):
        y = torch.relu(x)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        return torch.where(y > 0, g, 0)


def relu(x: torch.Tensor) -> torch.Tensor:
    return _ReLU.apply(x)


class Activation(enum.Enum):
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return {
            Activation.RELU: relu,
            Activation.SIGMOID: torch.sigmoid,
            Activation.TANH: torch.tanh,
            Activation.GELU: gelu,
        }[self](x)


@dataclass(frozen=True)
class L1Regularizer:
    coeff: float


@dataclass(frozen=True)
class L2Regularizer:
    coeff: float


Regularizer = Union[L1Regularizer, L2Regularizer]
