"""User-facing optimizer wrappers (copy of flexflow_tpu/core/optimizers.py).

Reference: python/flexflow/core/flexflow_cffi.py:2303 (SGDOptimizer) and
:2316 (AdamOptimizer) — thin handles the user passes to FFModel.compile,
mapping onto the optimizer attrs consumed by the kernels
(lib/pcg optimizer attrs; sgd_optimizer_attrs.struct.toml:12-29).
"""

from __future__ import annotations

from typing import Optional

from flexflow_tpu_torch.pcg.optimizer import AdamOptimizerAttrs, SGDOptimizerAttrs


class SGDOptimizer:
    """SGD with momentum/nesterov/weight-decay (reference flexflow_cffi.py:2303)."""

    def __init__(
        self,
        ffmodel=None,
        lr: float = 0.01,
        momentum: float = 0.0,
        nesterov: bool = False,
        weight_decay: float = 0.0,
    ) -> None:
        self.ffmodel = ffmodel
        self.attrs = SGDOptimizerAttrs(
            lr=lr, momentum=momentum, nesterov=nesterov, weight_decay=weight_decay
        )

    def set_learning_rate(self, lr: float) -> None:
        self.attrs = SGDOptimizerAttrs(
            lr=lr,
            momentum=self.attrs.momentum,
            nesterov=self.attrs.nesterov,
            weight_decay=self.attrs.weight_decay,
        )


class AdamOptimizer:
    """Adam (reference flexflow_cffi.py:2316)."""

    def __init__(
        self,
        ffmodel=None,
        alpha: float = 0.001,
        beta1: float = 0.9,
        beta2: float = 0.999,
        weight_decay: float = 0.0,
        epsilon: float = 1e-8,
    ) -> None:
        self.ffmodel = ffmodel
        self.attrs = AdamOptimizerAttrs(
            alpha=alpha,
            beta1=beta1,
            beta2=beta2,
            weight_decay=weight_decay,
            epsilon=epsilon,
        )

    def set_learning_rate(self, alpha: float) -> None:
        self.attrs = AdamOptimizerAttrs(
            alpha=alpha,
            beta1=self.attrs.beta1,
            beta2=self.attrs.beta2,
            weight_decay=self.attrs.weight_decay,
            epsilon=self.attrs.epsilon,
        )


Optimizer = object  # duck-typed: anything with .attrs


def optimizer_attrs_of(opt) -> Optional[object]:
    """Accepts an SGDOptimizer/AdamOptimizer wrapper or raw attrs."""
    if opt is None:
        return None
    if isinstance(opt, (SGDOptimizerAttrs, AdamOptimizerAttrs)):
        return opt
    if hasattr(opt, "attrs"):
        return opt.attrs
    raise TypeError(f"not an optimizer: {opt!r}")
