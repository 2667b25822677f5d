"""Initializer attrs and their PyTorch implementations (trimmed copy of
flexflow_tpu/pcg/initializer.py: the initializers the slice's builder
creates).

Draws come from an explicit `torch.Generator`. They are not the JAX
package's `jax.random` draws: tests that compare the two packages carry
parameters across as numpy arrays (see interop.py)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence, Union

import torch


@dataclass(frozen=True)
class GlorotUniformAttrs:
    seed: int = 0


@dataclass(frozen=True)
class ZeroInitializerAttrs:
    pass


@dataclass(frozen=True)
class ConstantInitializerAttrs:
    value: float = 0.0


InitializerAttrs = Union[
    GlorotUniformAttrs, ZeroInitializerAttrs, ConstantInitializerAttrs
]


def _fan_in_out(shape: Sequence[int]) -> tuple:
    # The JAX package's convention: the last two dims of a matrix are
    # (fan_in, fan_out), so the flat MHA weight [per_head_params, H] has
    # fan_in = rows and fan_out = H; higher ranks use receptive-field scaling.
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = math.prod(shape[2:])
    return shape[1] * receptive, shape[0] * receptive


def initialize(
    attrs: InitializerAttrs,
    generator: torch.Generator,
    shape: Sequence[int],
    dtype: torch.dtype,
) -> torch.Tensor:
    """A tensor of `shape` on the generator's device, drawn per `attrs`."""
    device = generator.device
    shape = tuple(shape)
    if isinstance(attrs, ZeroInitializerAttrs):
        return torch.zeros(shape, dtype=dtype, device=device)
    if isinstance(attrs, ConstantInitializerAttrs):
        return torch.full(shape, attrs.value, dtype=dtype, device=device)
    if isinstance(attrs, GlorotUniformAttrs):
        fan_in, fan_out = _fan_in_out(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        out = torch.empty(shape, dtype=dtype, device=device)
        return out.uniform_(-limit, limit, generator=generator)
    raise TypeError(f"unknown initializer {attrs!r}")
