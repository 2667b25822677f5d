"""Optimizer attrs (copy of flexflow_tpu/pcg/optimizer.py)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Union


@dataclass(frozen=True)
class SGDOptimizerAttrs:
    lr: float
    momentum: float = 0.0
    nesterov: bool = False
    weight_decay: float = 0.0


@dataclass(frozen=True)
class AdamOptimizerAttrs:
    alpha: float  # learning rate
    beta1: float = 0.9
    beta2: float = 0.999
    weight_decay: float = 0.0
    epsilon: float = 1e-8


OptimizerAttrs = Union[SGDOptimizerAttrs, AdamOptimizerAttrs]
