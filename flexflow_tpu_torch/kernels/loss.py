"""Loss functions (port of flexflow_tpu/kernels/loss.py).

Every loss is a scalar f32 function of the logits whatever their dtype;
autograd gives the reference's gradients (mean over the batch: 1/batch,
and 2/volume for MSE, as loss_grad_scale says). The fused SCCE never keeps a [rows, classes] f32 array: the forward saves
only the per-row logsumexp (f32) and returns the mean over all rows; the
backward emits (softmax - onehot) * g/N in the logit dtype. Both walk the
rows in chunks so the f32 temporaries stay bounded.

`class_sharded_loss` is every loss on logits whose classes are cut over
ranks (vocab parallel): each rank holds a block of the classes, and the
row reductions over the classes (the max, the sum of exponentials, the
target's logit, a row's sum) are summed or maximized over the class ranks
by the caller's collectives. It runs in f32, and autograd gives each rank
its own classes' gradient (softmax - onehot for the cross entropies)."""

from __future__ import annotations

import torch

from flexflow_tpu_torch.op_attrs.ops.loss_functions import LossAttrs, LossFunction

_CHUNK_ELEMENTS = 1 << 27  # f32 temporaries of at most 512 MB


def _row_chunks(rows: int, classes: int):
    step = max(1, _CHUNK_ELEMENTS // classes)
    for r0 in range(0, rows, step):
        yield r0, min(rows, r0 + step)


class FusedSparseCrossEntropy(torch.autograd.Function):
    """mean over rows of lse(logit) - logit[label], in f32."""

    @staticmethod
    def forward(ctx, logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        classes = logit.shape[-1]
        flat = logit.reshape(-1, classes)
        lse = torch.empty(flat.shape[0], dtype=torch.float32, device=logit.device)
        for r0, r1 in _row_chunks(flat.shape[0], classes):
            lse[r0:r1] = torch.logsumexp(flat[r0:r1].float(), dim=-1)
        label = label.reshape(-1).long()
        # gathered from the logits as stored: the picked values are exact in
        # the storage dtype and the subtraction happens in f32
        picked = flat.gather(1, label[:, None])[:, 0].float()
        ctx.save_for_backward(logit, label, lse)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logit, label, lse = ctx.saved_tensors
        classes = logit.shape[-1]
        flat = logit.reshape(-1, classes)
        dlogit = torch.empty_like(flat)
        scale = (g / lse.numel()).to(logit.dtype)
        for r0, r1 in _row_chunks(flat.shape[0], classes):
            p = torch.exp((flat[r0:r1].float() - lse[r0:r1, None]).to(logit.dtype))
            rows = torch.arange(r1 - r0, device=logit.device)
            p[rows, label[r0:r1]] -= 1
            dlogit[r0:r1] = p * scale
        return dlogit.reshape(logit.shape), None


def loss_forward(attrs: LossAttrs, logit: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Scalar f32 loss. logit: [batch..., classes] (any shape for MSE, MAE
    and identity); label: int [batch...] for SCCE, one-hot or dense for
    the others."""
    fn = attrs.loss_type
    if fn == LossFunction.SPARSE_CATEGORICAL_CROSSENTROPY:
        return FusedSparseCrossEntropy.apply(logit, label)
    if logit.is_floating_point():
        logit = logit.float()
    if fn == LossFunction.CATEGORICAL_CROSSENTROPY:
        return -(label * torch.log_softmax(logit, dim=-1)).sum(dim=-1).mean()
    if fn == LossFunction.MEAN_SQUARED_ERROR:
        return (logit - label).square().mean()
    if fn == LossFunction.MEAN_ABSOLUTE_ERROR:
        return (logit - label).abs().mean()
    if fn == LossFunction.IDENTITY:
        return logit.mean()
    raise ValueError(f"unknown loss {fn}")


def loss_grad_scale(attrs: LossAttrs, batch_size: int, volume: int) -> float:
    """The scale the reference applies in its loss backward: 1/batch, or
    2/volume for MSE."""
    if attrs.loss_type == LossFunction.MEAN_SQUARED_ERROR:
        return 2.0 / volume
    return 1.0 / batch_size


def class_sharded_loss(attrs: LossAttrs, logit: torch.Tensor, label: torch.Tensor,
                       offset: int, classes: int, total, peak) -> torch.Tensor:
    """Scalar f32 loss of logits cut over their classes. logit: this rank's
    classes [offset, offset + logit.shape[-1]) of `classes`; label: int
    [batch...] for SCCE, else this rank's classes of the label.
    total(x): x summed over the class ranks (differentiable: its backward
    is the identity, every rank's share of the sum having the sum's
    gradient); peak(x): the max over the class ranks, no gradient."""
    fn = attrs.loss_type
    x = logit.float()
    if fn in (LossFunction.SPARSE_CATEGORICAL_CROSSENTROPY,
              LossFunction.CATEGORICAL_CROSSENTROPY):
        m = peak(x.detach().amax(dim=-1))
        lse = torch.log(total(torch.exp(x - m[..., None]).sum(dim=-1))) + m
        if fn == LossFunction.CATEGORICAL_CROSSENTROPY:
            y = label.float()
            return (lse * total(y.sum(dim=-1)) - total((y * x).sum(dim=-1))).mean()
        local = label.long() - offset
        own = (local >= 0) & (local < x.shape[-1])
        picked = x.gather(-1, local.clamp(0, x.shape[-1] - 1)[..., None])[..., 0]
        return (lse - total(torch.where(own, picked, torch.zeros_like(picked)))).mean()
    if fn == LossFunction.MEAN_SQUARED_ERROR:
        rows = (x - label).square().sum(dim=-1)
    elif fn == LossFunction.MEAN_ABSOLUTE_ERROR:
        rows = (x - label).abs().sum(dim=-1)
    elif fn == LossFunction.IDENTITY:
        rows = x.sum(dim=-1)
    else:
        raise NotImplementedError(
            f"the class-sharded form of the loss {fn} is not ported (A7 item 13)")
    return total(rows).mean() / classes
