"""User-facing initializer aliases (copy of flexflow_tpu/core/initializers.py).

Reference: python/flexflow/core/flexflow_cffi.py:2328-2387
(GlorotUniformInitializer/ZeroInitializer/UniformInitializer/NormInitializer)
— the names the legacy Python API exposes, mapped to the pcg initializer
attrs (lib/pcg/include/pcg/initializers/).
"""

from flexflow_tpu_torch.pcg.initializer import (
    ConstantInitializerAttrs,
    GlorotNormalAttrs,
    GlorotUniformAttrs,
    NormInitializerAttrs,
    TruncatedNormalInitializerAttrs,
    UniformInitializerAttrs,
    ZeroInitializerAttrs,
)


def GlorotUniformInitializer(seed: int = 0) -> GlorotUniformAttrs:
    return GlorotUniformAttrs(seed=seed)


def GlorotNormalInitializer(seed: int = 0) -> GlorotNormalAttrs:
    return GlorotNormalAttrs(seed=seed)


def ZeroInitializer() -> ZeroInitializerAttrs:
    return ZeroInitializerAttrs()


def UniformInitializer(
    seed: int = 0, min_val: float = -0.05, max_val: float = 0.05
) -> UniformInitializerAttrs:
    return UniformInitializerAttrs(seed=seed, min_val=min_val, max_val=max_val)


def NormInitializer(
    seed: int = 0, mean: float = 0.0, stddev: float = 0.05
) -> NormInitializerAttrs:
    return NormInitializerAttrs(seed=seed, mean=mean, stddev=stddev)


def TruncatedNormalInitializer(
    seed: int = 0, mean: float = 0.0, stddev: float = 0.05
) -> TruncatedNormalInitializerAttrs:
    return TruncatedNormalInitializerAttrs(seed=seed, mean=mean, stddev=stddev)


def ConstantInitializer(value: float = 0.0) -> ConstantInitializerAttrs:
    return ConstantInitializerAttrs(value=value)
