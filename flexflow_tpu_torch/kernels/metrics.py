"""Metrics (port of flexflow_tpu/kernels/metrics.py).

PerfMetrics accumulates on the host; compute_metrics returns one batch's
values as tensors on the logits' device (train_all, a count fixed by the
shape, as a Python int), so a training loop can sum them there and read
them once. The sparse cross-entropy metric is sum(lse - logit[label]) over
row chunks in f32, as the fused loss walks them: the JAX package's
log_softmax + take_along_axis is the same sum, which XLA fuses, and which
here would otherwise build a [rows, classes] array (4.2 GB in f32 at the
flagship's LM head). On bf16 logits the port's sum is f32 roundoff from
the exact one; the JAX package's log_softmax runs in bf16, so the two
agree within bf16's relative precision, 2**-8.

`class_sharded_metrics` takes the same values from logits cut over their
classes, with the caller's collectives over the class ranks; its argmax
(`sharded_argmax`) breaks ties toward the lowest class, as torch.argmax
and jnp.argmax do.
"""

from __future__ import annotations

from dataclasses import dataclass
from math import prod
from typing import Dict, FrozenSet, Union

import torch

from flexflow_tpu_torch.kernels.loss import _row_chunks

METRIC_ACCURACY = "accuracy"
METRIC_CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
METRIC_SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
METRIC_MEAN_SQUARED_ERROR = "mean_squared_error"
METRIC_ROOT_MEAN_SQUARED_ERROR = "root_mean_squared_error"
METRIC_MEAN_ABSOLUTE_ERROR = "mean_absolute_error"


@dataclass
class PerfMetrics:
    """Accumulated training metrics (reference: perf_metrics.h)."""

    train_all: int = 0
    train_correct: int = 0
    cce_loss: float = 0.0
    sparse_cce_loss: float = 0.0
    mse_loss: float = 0.0
    rmse_loss: float = 0.0
    mae_loss: float = 0.0

    def update(self, other: "PerfMetrics") -> None:
        self.train_all += other.train_all
        self.train_correct += other.train_correct
        self.cce_loss += other.cce_loss
        self.sparse_cce_loss += other.sparse_cce_loss
        self.mse_loss += other.mse_loss
        self.rmse_loss += other.rmse_loss
        self.mae_loss += other.mae_loss

    @property
    def accuracy(self) -> float:
        return self.train_correct / max(self.train_all, 1)


def sparse_cce_sum(logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """-sum over rows of log_softmax(logit)[label], in f32, walking the
    rows in chunks so no [rows, classes] f32 array exists."""
    classes = logit.shape[-1]
    flat = logit.reshape(-1, classes)
    label = label.reshape(-1).long()
    total = torch.zeros((), dtype=torch.float32, device=logit.device)
    for r0, r1 in _row_chunks(flat.shape[0], classes):
        rows = flat[r0:r1].float()
        picked = rows.gather(1, label[r0:r1, None])[:, 0]
        total += (torch.logsumexp(rows, dim=-1) - picked).sum()
    return total


@torch.no_grad()
def compute_metrics(
    metrics: FrozenSet[str], logit: torch.Tensor, label: torch.Tensor
) -> Dict[str, Union[int, torch.Tensor]]:
    """One batch's metric values; one prediction per non-class position
    (sequence tasks predict batch * seq tokens)."""
    out: Dict[str, Union[int, torch.Tensor]] = {
        "train_all": prod(logit.shape[:-1]) if logit.ndim >= 2 else logit.shape[0]
    }
    if METRIC_ACCURACY in metrics:
        pred = logit.argmax(dim=-1)
        lbl = label if label.ndim == pred.ndim else label.argmax(dim=-1)
        out["train_correct"] = (pred == lbl.to(pred.dtype)).sum()
    if METRIC_SPARSE_CATEGORICAL_CROSSENTROPY in metrics:
        out["sparse_cce_loss"] = sparse_cce_sum(logit, label)
    if METRIC_CATEGORICAL_CROSSENTROPY in metrics:
        out["cce_loss"] = -(label * torch.log_softmax(logit.float(), dim=-1)).sum()
    if METRIC_MEAN_SQUARED_ERROR in metrics:
        out["mse_loss"] = (logit.float() - label).square().sum()
    if METRIC_MEAN_ABSOLUTE_ERROR in metrics:
        out["mae_loss"] = (logit.float() - label).abs().sum()
    return out


def sharded_argmax(x: torch.Tensor, offset: int, peak, least) -> torch.Tensor:
    """The argmax over the last dim of a tensor whose last dim is cut over
    ranks, this rank holding [offset, offset + x.shape[-1]): each rank's
    first maximum, the max over ranks (`peak`), then the least global
    index among the ranks that hold it (`least`)."""
    value, index = x.max(dim=-1)
    best = peak(value)
    never = torch.iinfo(torch.int64).max
    cand = torch.where(value == best, index.long() + offset, torch.full_like(index.long(), never))
    return least(cand)


@torch.no_grad()
def class_sharded_metrics(metrics: FrozenSet[str], logit: torch.Tensor, label: torch.Tensor,
                          offset: int, total, peak, least) -> Dict[str, Union[int, torch.Tensor]]:
    """compute_metrics of logits cut over their classes (see
    kernels/loss.class_sharded_loss for `offset`, `total` and `peak`;
    `least` is the min over the class ranks): every value is the whole
    rows', the same on each class rank."""
    out: Dict[str, Union[int, torch.Tensor]] = {
        "train_all": prod(logit.shape[:-1]) if logit.ndim >= 2 else logit.shape[0]
    }
    x = logit.float()
    if METRIC_ACCURACY in metrics:
        pred = sharded_argmax(logit, offset, peak, least)
        lbl = (label.long() if label.ndim == pred.ndim
               else sharded_argmax(label, offset, peak, least))
        out["train_correct"] = (pred == lbl).sum()
    lse = None
    if metrics & {METRIC_SPARSE_CATEGORICAL_CROSSENTROPY, METRIC_CATEGORICAL_CROSSENTROPY}:
        m = peak(x.amax(dim=-1))
        lse = torch.log(total(torch.exp(x - m[..., None]).sum(dim=-1))) + m
    if METRIC_SPARSE_CATEGORICAL_CROSSENTROPY in metrics:
        local = label.long() - offset
        own = (local >= 0) & (local < x.shape[-1])
        picked = x.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        out["sparse_cce_loss"] = (lse - total(torch.where(own, picked, 0.0))).sum()
    if METRIC_CATEGORICAL_CROSSENTROPY in metrics:
        y = label.float()
        out["cce_loss"] = (lse * total(y.sum(dim=-1)) - total((y * x).sum(dim=-1))).sum()
    if METRIC_MEAN_SQUARED_ERROR in metrics:
        out["mse_loss"] = total((x - label).square().sum(dim=-1)).sum()
    if METRIC_MEAN_ABSOLUTE_ERROR in metrics:
        out["mae_loss"] = total((x - label).abs().sum(dim=-1)).sum()
    return out
