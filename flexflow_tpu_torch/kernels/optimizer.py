"""Optimizer updates (port of flexflow_tpu/kernels/optimizer.py).

Updates run in place on the parameter and state tensors, where the JAX
package returns new arrays (and donates the old ones). Adam is the JAX
package's formula, not torch.optim.Adam's: L2 weight decay joins the
gradient before the moments, and the bias correction folds into the step
size, alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t), with eps added
to sqrt(v) uncorrected. `barrier_grads`, an XLA fusion hint, has no
counterpart here.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from flexflow_tpu_torch.pcg.optimizer import (
    AdamOptimizerAttrs,
    OptimizerAttrs,
    SGDOptimizerAttrs,
)


def sgd_update_(attrs: SGDOptimizerAttrs, w, g, v) -> None:
    """Weight decay, momentum, nesterov; updates w (and v) in place."""
    if attrs.weight_decay:
        g = g + attrs.weight_decay * w
    if attrs.momentum > 0.0:
        v.mul_(attrs.momentum).add_(g)
        g = g + attrs.momentum * v if attrs.nesterov else v
    w.sub_(attrs.lr * g)


def adam_update_(attrs: AdamOptimizerAttrs, w, g, m, v, step: int) -> None:
    """Bias-corrected Adam at step count `step` (>= 1); updates w, m, v in
    place."""
    if attrs.weight_decay:
        g = g + attrs.weight_decay * w
    m.mul_(attrs.beta1).add_(g, alpha=1.0 - attrs.beta1)
    v.mul_(attrs.beta2).addcmul_(g, g, value=1.0 - attrs.beta2)
    alpha_t = attrs.alpha * math.sqrt(1.0 - attrs.beta2**step) / (1.0 - attrs.beta1**step)
    w.sub_(alpha_t * m / (v.sqrt() + attrs.epsilon))


def make_optimizer_state(attrs: OptimizerAttrs, params: Dict[str, torch.Tensor]) -> Dict:
    """Optimizer slots per parameter, plus the step count."""
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    if isinstance(attrs, SGDOptimizerAttrs):
        return {"v": zeros(), "step": 0} if attrs.momentum > 0.0 else {"step": 0}
    if isinstance(attrs, AdamOptimizerAttrs):
        return {"m": zeros(), "v": zeros(), "step": 0}
    raise TypeError(f"unknown optimizer {attrs!r}")


@torch.no_grad()
def apply_optimizer_(attrs: OptimizerAttrs, params: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor], state: Dict) -> None:
    """One update of every parameter, in place on params and state."""
    state["step"] += 1
    for k, w in params.items():
        if isinstance(attrs, SGDOptimizerAttrs):
            sgd_update_(attrs, w, grads[k], state["v"][k] if "v" in state else None)
        elif isinstance(attrs, AdamOptimizerAttrs):
            adam_update_(attrs, w, grads[k], state["m"][k], state["v"][k], state["step"])
        else:
            raise TypeError(f"unknown optimizer {attrs!r}")
