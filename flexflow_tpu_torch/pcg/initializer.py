"""Initializer attrs and their PyTorch implementations (trimmed copy of
flexflow_tpu/pcg/initializer.py, with the branch-stacked initializer of
compiler/branch_stacking.py).

Draws come from an explicit `torch.Generator`. They are not the JAX
package's `jax.random` draws: tests that compare the two packages carry
parameters across as numpy arrays (see interop.py)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional, Sequence, Union

import torch


@dataclass(frozen=True)
class GlorotUniformAttrs:
    seed: int = 0


@dataclass(frozen=True)
class GlorotNormalAttrs:
    seed: int = 0


@dataclass(frozen=True)
class ZeroInitializerAttrs:
    pass


@dataclass(frozen=True)
class UniformInitializerAttrs:
    seed: int = 0
    min_val: float = -0.05
    max_val: float = 0.05


@dataclass(frozen=True)
class NormInitializerAttrs:
    seed: int = 0
    mean: float = 0.0
    stddev: float = 0.05


@dataclass(frozen=True)
class TruncatedNormalInitializerAttrs:
    """Absolute min/max cutoffs; None means 2 standard deviations."""

    seed: int = 0
    mean: float = 0.0
    stddev: float = 0.05
    min_cutoff: Optional[float] = None
    max_cutoff: Optional[float] = None


@dataclass(frozen=True)
class ConstantInitializerAttrs:
    value: float = 0.0


@dataclass(frozen=True)
class StackedInitializerAttrs:
    """Initializer of a branch-stacked weight [k, *inner] (see
    compiler/branch_stacking.py): each of the k slices is drawn with
    `inner` on the inner shape, so each branch keeps its own statistics
    (glorot fans computed on the inner shape, not the stacked one)."""

    inner: "InitializerAttrs"
    count: int


InitializerAttrs = Union[
    GlorotUniformAttrs,
    GlorotNormalAttrs,
    ZeroInitializerAttrs,
    UniformInitializerAttrs,
    NormInitializerAttrs,
    TruncatedNormalInitializerAttrs,
    ConstantInitializerAttrs,
    StackedInitializerAttrs,
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
    if isinstance(attrs, StackedInitializerAttrs):
        assert shape[0] == attrs.count, (shape, attrs.count)
        return torch.stack([initialize(attrs.inner, generator, shape[1:], dtype)
                            for _ in range(attrs.count)])
    if isinstance(attrs, ZeroInitializerAttrs):
        return torch.zeros(shape, dtype=dtype, device=device)
    if isinstance(attrs, ConstantInitializerAttrs):
        return torch.full(shape, attrs.value, dtype=dtype, device=device)
    out = torch.empty(shape, dtype=dtype, device=device)
    if isinstance(attrs, GlorotUniformAttrs):
        fan_in, fan_out = _fan_in_out(shape)
        limit = math.sqrt(6.0 / (fan_in + fan_out))
        return out.uniform_(-limit, limit, generator=generator)
    if isinstance(attrs, GlorotNormalAttrs):
        fan_in, fan_out = _fan_in_out(shape)
        return out.normal_(0.0, math.sqrt(2.0 / (fan_in + fan_out)), generator=generator)
    if isinstance(attrs, UniformInitializerAttrs):
        return out.uniform_(attrs.min_val, attrs.max_val, generator=generator)
    if isinstance(attrs, NormInitializerAttrs):
        return out.normal_(attrs.mean, attrs.stddev, generator=generator)
    if isinstance(attrs, TruncatedNormalInitializerAttrs):
        return _truncated_normal(attrs, out, generator)
    raise TypeError(f"unknown initializer {attrs!r}")


def _truncated_normal(attrs: TruncatedNormalInitializerAttrs, out: torch.Tensor,
                      generator: torch.Generator) -> torch.Tensor:
    """mean + stddev * z, z a standard normal truncated to the cutoffs (in
    standard units), drawn by inverting the normal CDF of a uniform draw
    between the cutoffs' CDF values."""
    if attrs.stddev == 0.0:
        return out.fill_(attrs.mean)
    lo = (attrs.min_cutoff - attrs.mean) / attrs.stddev if attrs.min_cutoff is not None else -2.0
    hi = (attrs.max_cutoff - attrs.mean) / attrs.stddev if attrs.max_cutoff is not None else 2.0
    cdf = lambda z: 0.5 * (1.0 + math.erf(z / math.sqrt(2.0)))  # noqa: E731
    u = torch.empty(out.shape, dtype=torch.float64, device=out.device)
    u.uniform_(cdf(lo), cdf(hi), generator=generator)
    z = (math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)).clamp_(lo, hi)
    return out.copy_(attrs.mean + attrs.stddev * z)
