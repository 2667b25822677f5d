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


class Activation(enum.Enum):
    RELU = "relu"
    SIGMOID = "sigmoid"
    TANH = "tanh"
    GELU = "gelu"

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        return {
            Activation.RELU: torch.relu,
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
