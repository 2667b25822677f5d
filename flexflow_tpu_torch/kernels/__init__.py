"""Per-op functions, the flash-attention and ring-flash kernels, loss and
optimizer updates."""

from flexflow_tpu_torch.kernels.loss import loss_forward
from flexflow_tpu_torch.kernels.ops import forward
from flexflow_tpu_torch.kernels.optimizer import apply_optimizer_, make_optimizer_state
from flexflow_tpu_torch.kernels import ring_flash  # noqa: F401  (registers its wrappers)

__all__ = ["apply_optimizer_", "forward", "loss_forward", "make_optimizer_state"]
