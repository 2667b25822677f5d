"""Optimizer updates (port of flexflow_tpu/kernels/optimizer.py).

Updates run in place on the parameter and state tensors, where the JAX
package returns new arrays (and donates the old ones). Adam is the JAX
package's formula, not torch.optim.Adam's: L2 weight decay joins the
gradient before the moments, and the bias correction folds into the step
size, alpha_t = alpha * sqrt(1 - beta2^t) / (1 - beta1^t), with eps added
to sqrt(v) uncorrected. `barrier_grads`, an XLA fusion hint, has no
counterpart here.

The step count is a 0-d int32 tensor on the parameters' device, incremented
in place, and alpha_t is computed from it on the device in f32, as the JAX
package computes it from its int32 step. Nothing of the update reads the
device back, so a captured CUDA graph of the step (runtime/cuda_graph.py)
applies each replay's own bias correction. The hyperparameters stay Python
constants: a graph bakes them in, and whoever changes them drops the graph.
"""

from __future__ import annotations

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


def adam_step_size(attrs: AdamOptimizerAttrs, step: torch.Tensor) -> torch.Tensor:
    """alpha_t at the int32 step count `step` (>= 1), a 0-d f32 tensor on
    its device: the JAX package's formula in f32."""
    t = step.to(torch.float32)
    return (attrs.alpha * torch.sqrt(1.0 - torch.pow(attrs.beta2, t))
            / (1.0 - torch.pow(attrs.beta1, t)))


def adam_update_(attrs: AdamOptimizerAttrs, w, g, m, v, step) -> None:
    """Bias-corrected Adam at step count `step` (>= 1; an int32 tensor or
    an int); updates w, m, v in place."""
    _adam_apply_(attrs, w, g, m, v,
                 adam_step_size(attrs, torch.as_tensor(step, dtype=torch.int32, device=w.device)))


def _adam_apply_(attrs: AdamOptimizerAttrs, w, g, m, v, alpha_t: torch.Tensor) -> None:
    """adam_update_ with its step size already computed (once a step, for
    every parameter)."""
    if attrs.weight_decay:
        g = g + attrs.weight_decay * w
    m.mul_(attrs.beta1).add_(g, alpha=1.0 - attrs.beta1)
    v.mul_(attrs.beta2).addcmul_(g, g, value=1.0 - attrs.beta2)
    w.sub_(alpha_t * m / (v.sqrt() + attrs.epsilon))


def make_optimizer_state(attrs: OptimizerAttrs, params: Dict[str, torch.Tensor]) -> Dict:
    """Optimizer slots per parameter, plus the step count on the
    parameters' device."""
    zeros = lambda: {k: torch.zeros_like(p) for k, p in params.items()}  # noqa: E731
    device = next(iter(params.values())).device if params else "cpu"
    step = torch.zeros((), dtype=torch.int32, device=device)
    if isinstance(attrs, SGDOptimizerAttrs):
        return {"v": zeros(), "step": step} if attrs.momentum > 0.0 else {"step": step}
    if isinstance(attrs, AdamOptimizerAttrs):
        return {"m": zeros(), "v": zeros(), "step": step}
    raise TypeError(f"unknown optimizer {attrs!r}")


@torch.no_grad()
def apply_optimizer_(attrs: OptimizerAttrs, params: Dict[str, torch.Tensor],
                     grads: Dict[str, torch.Tensor], state: Dict) -> None:
    """One update of every parameter, in place on params and state."""
    state["step"].add_(1)
    if isinstance(attrs, AdamOptimizerAttrs):
        alpha_t = adam_step_size(attrs, state["step"])
    for k, w in params.items():
        if isinstance(attrs, SGDOptimizerAttrs):
            sgd_update_(attrs, w, grads[k], state["v"][k] if "v" in state else None)
        elif isinstance(attrs, AdamOptimizerAttrs):
            _adam_apply_(attrs, w, grads[k], state["m"][k], state["v"][k], alpha_t)
        else:
            raise TypeError(f"unknown optimizer {attrs!r}")
