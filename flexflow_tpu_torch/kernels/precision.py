"""Mixed-precision policy (copy of flexflow_tpu/kernels/precision.py):
params and optimizer state stay f32; forward and backward compute run in a
lower dtype; loss math stays f32 (kernels/loss.py)."""

from __future__ import annotations

from typing import Dict, Optional

import torch


def cast_for_compute(
    tree: Dict[str, torch.Tensor], compute_dtype: Optional[torch.dtype]
) -> Dict[str, torch.Tensor]:
    """Cast every floating tensor of the dict to compute_dtype (None = no-op)."""
    if compute_dtype is None:
        return tree
    return {
        k: v.to(compute_dtype) if v.is_floating_point() else v for k, v in tree.items()
    }
