"""Per-op forward functions on tensors, for the slice's ops (trimmed copy of
flexflow_tpu/kernels/ops.py). The backward comes from autograd, and through
the flash-attention Functions' hand-written kernels for attention.

Uniform signature:
    forward(attrs, inputs, weights, train=False, rng=None) -> [outputs]
inputs/weights: lists of tensors in slot order (roles from
op_attrs.core.get_incoming_tensor_roles). `train` and `rng` (a
torch.Generator on the inputs' device) reach Dropout only.

The example zoo's ops follow the JAX package's semantics, not PyTorch's
defaults: Conv2D is NCHW x OIHW (F.conv2d, as the JAX package leaves it to
lax.conv_general_dilated, outside any Pallas kernel); max pooling pads with
-inf and average pooling divides by the whole window, padding included, at
any padding; BatchNorm normalizes by the batch's own mean and biased
variance in training and evaluation alike (no running statistics), the
whole batch's where ranks split it (`batch_stats_group`).

BatchMatmul is torch.matmul, as the JAX package's is jnp.matmul outside
any Pallas kernel. TopK returns int32 indices in lax.top_k's order (ties
to the lower index); GroupBy, Aggregate and the fused Experts op are
kernels/moe.py's index forms of the JAX package's one-hot einsums.

`op_forward_flops` is the JAX package's analytic forward count, which MFU
divides by; `graph_step_flops` sums it over a graph's step.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.kernels import moe
from flexflow_tpu_torch.kernels.flash_attention import (
    current_flash_mesh,
    flash_attention_bshf,
    flash_attention_bshf_qkv,
    flash_attention_bshf_supported,
    sharded_flash_attention,
    sharded_flash_supported,
)
from flexflow_tpu_torch.op_attrs.activation import gelu, relu
from flexflow_tpu_torch.op_attrs.core import OpAttrs
from flexflow_tpu_torch.op_attrs.ops import (
    AggregateSpec,
    BatchMatmulAttrs,
    BatchNormAttrs,
    AggregateAttrs,
    BroadcastAttrs,
    CastAttrs,
    ConcatAttrs,
    Conv2DAttrs,
    DropoutAttrs,
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
    EmbeddingAttrs,
    ExpertsAttrs,
    FlatAttrs,
    GatherAttrs,
    GroupByAttrs,
    InputAttrs,
    LayerNormAttrs,
    LinearAttrs,
    MultiHeadAttentionAttrs,
    NoopAttrs,
    Pool2DAttrs,
    PoolOp,
    ReduceAttrs,
    ReduceOpType,
    ReshapeAttrs,
    ReverseAttrs,
    RingAttentionAttrs,
    SoftmaxAttrs,
    SplitAttrs,
    StackAttrs,
    StageMergeAttrs,
    StagePartitionAttrs,
    TopKAttrs,
    TransposeAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.moe import expert_capacity

_UNARY_FNS = {
    ElementUnaryOpType.EXP: torch.exp,
    ElementUnaryOpType.LOG: torch.log,
    ElementUnaryOpType.SIN: torch.sin,
    ElementUnaryOpType.COS: torch.cos,
    ElementUnaryOpType.IDENTITY: lambda x: x,
    ElementUnaryOpType.RELU: relu,
    ElementUnaryOpType.SIGMOID: torch.sigmoid,
    ElementUnaryOpType.TANH: torch.tanh,
    ElementUnaryOpType.GELU: gelu,
    ElementUnaryOpType.ELU: F.elu,
    ElementUnaryOpType.RSQRT: torch.rsqrt,
    ElementUnaryOpType.SQRT: torch.sqrt,
}

_SCALAR_FNS = {
    ElementUnaryOpType.SCALAR_MULTIPLY: lambda x, c: x * c,
    ElementUnaryOpType.SCALAR_ADD: lambda x, c: x + c,
    ElementUnaryOpType.SCALAR_SUB: lambda x, c: x - c,
    ElementUnaryOpType.SCALAR_TRUE_DIV: lambda x, c: x / c,
    ElementUnaryOpType.POW: torch.pow,
}

_BINARY_FNS = {
    ElementBinaryOpType.ADD: torch.add,
    ElementBinaryOpType.SUB: torch.sub,
    ElementBinaryOpType.MUL: torch.mul,
    ElementBinaryOpType.DIV: torch.div,
    ElementBinaryOpType.MAX: torch.maximum,
    ElementBinaryOpType.MIN: torch.minimum,
    ElementBinaryOpType.POW: torch.pow,
}


def unpack_mha_weights(
    attrs: MultiHeadAttentionAttrs, qsize: int, ksize: int, vsize: int, weight
):
    """Split the flat weight [per_head_params, num_heads] (wq|wk|wv|wo
    concatenated per head) into wq [q, kd, H], wk [k, kd, H], wv [v, vd, H]
    and wo [vd, e, H]."""
    H = attrs.num_heads
    kd, vd, e = attrs.q_proj_size, attrs.v_proj_size, attrs.embed_dim
    sizes = [qsize * kd, ksize * kd, vsize * vd, vd * e]
    if tuple(weight.shape) != (sum(sizes), H):
        # e.g. a head-parallel piece: this op takes its sizes from the attrs
        raise ValueError(
            f"attention weight {tuple(weight.shape)} does not match the attrs' "
            f"{(sum(sizes), H)}"
        )
    offs = [0]
    for s in sizes:
        offs.append(offs[-1] + s)
    wq = weight[offs[0]:offs[1], :].reshape(qsize, kd, H)
    wk = weight[offs[1]:offs[2], :].reshape(ksize, kd, H)
    wv = weight[offs[2]:offs[3], :].reshape(vsize, vd, H)
    wo = weight[offs[3]:offs[4], :].reshape(vd, e, H)
    return wq, wk, wv, wo


def mha_project_qkv(attrs: MultiHeadAttentionAttrs, q, k, v, weight, input_bias=None):
    """q/k/v projections -> per-head tensors [b, h, s, d] plus wo."""
    wq, wk, wv, wo = unpack_mha_weights(attrs, q.shape[-1], k.shape[-1], v.shape[-1], weight)
    qp = torch.einsum("bsq,qkh->bhsk", q, wq)
    kp = torch.einsum("btq,qkh->bhtk", k, wk)
    vp = torch.einsum("btq,qvh->bhtv", v, wv)
    if input_bias is not None:
        kd = attrs.q_proj_size
        qp = qp + input_bias[:kd]
        kp = kp + input_bias[kd:2 * kd]
        vp = vp + input_bias[2 * kd:]
    return qp, kp, vp, wo


def _bshf_weights(attrs: MultiHeadAttentionAttrs, qsize, ksize, vsize, weight):
    """Per-projection weights [e, h*d] with head-major columns, plus wo as
    [h*v, e]: the lane order the bshf flash kernels index into."""
    wq, wk, wv, wo = unpack_mha_weights(attrs, qsize, ksize, vsize, weight)
    H = attrs.num_heads
    kd, vd, e = attrs.q_proj_size, attrs.v_proj_size, attrs.embed_dim
    wq2 = wq.transpose(1, 2).reshape(qsize, H * kd)
    wk2 = wk.transpose(1, 2).reshape(ksize, H * kd)
    wv2 = wv.transpose(1, 2).reshape(vsize, H * vd)
    wo2 = wo.permute(2, 0, 1).reshape(H * vd, e)
    return wq2, wk2, wv2, wo2


def mha_project_qkv_bshf(attrs: MultiHeadAttentionAttrs, q, k, v, weight, input_bias=None):
    """q/k/v projections -> seq-major fused-head tensors [b, s, h*d] plus wo
    as [h*v, e]: every projection is one plain matmul whose output is the
    flash kernels' operand layout."""
    wq2, wk2, wv2, wo2 = _bshf_weights(attrs, q.shape[-1], k.shape[-1], v.shape[-1], weight)
    H, kd = attrs.num_heads, attrs.q_proj_size
    qp, kp, vp = q @ wq2, k @ wk2, v @ wv2
    if input_bias is not None:
        qp = qp + input_bias[:kd].repeat(H)
        kp = kp + input_bias[kd:2 * kd].repeat(H)
        vp = vp + input_bias[2 * kd:].repeat(H)
    return qp, kp, vp, wo2


def mha_project_qkv_bshf_fused(attrs: MultiHeadAttentionAttrs, x, weight, input_bias=None):
    """Self-attention projections as one matmul into the head-pair
    interleaved layout: qkv [b, s, 3f] whose pair-group g holds
    [q_pair(128) | k_pair(128) | v_pair(128)], the operand layout of
    flash_attention_bshf_qkv. Returns (qkv, wo2)."""
    e = x.shape[-1]
    wq2, wk2, wv2, wo2 = _bshf_weights(attrs, e, e, e, weight)
    H, kd, vd = attrs.num_heads, attrs.q_proj_size, attrs.v_proj_size
    if kd != vd or (H * kd) % 128 or H % 2:
        raise ValueError(f"fused QKV projection needs kd == vd, h*kd % 128 == 0 and h even; "
                         f"got h={H}, kd={kd}, vd={vd}")
    f = H * kd
    wf = torch.stack([w.reshape(e, f // 128, 128) for w in (wq2, wk2, wv2)], dim=2)
    qkv = x @ wf.reshape(e, 3 * f)
    if input_bias is not None:
        group = torch.cat([input_bias[i * kd:(i + 1) * kd].repeat(128 // kd) for i in range(3)])
        qkv = qkv + group.repeat(f // 128)
    return qkv, wo2


def _dense_context(qp, kp, vp, causal=False):
    """softmax(qp kp^T / sqrt(d)) vp on per-head tensors, through a
    materialized [s, t] softmax in the operands' dtype. `calls` counts its
    runs, so a run on the card can show that no attention the flash
    kernels take ran dense."""
    _dense_context.calls += 1
    scores = torch.einsum("bhsk,bhtk->bhst", qp, kp) / math.sqrt(qp.shape[-1])
    if causal:
        s, t = scores.shape[-2:]
        mask = torch.ones(s, t, dtype=torch.bool, device=scores.device).tril()
        scores = torch.where(mask, scores, torch.full_like(scores, -1e30))
    return torch.einsum("bhst,bhtv->bhsv", torch.softmax(scores, dim=-1), vp)


_dense_context.calls = 0


def dense_attention(attrs: MultiHeadAttentionAttrs, q, k, v, weight, input_bias=None,
                    causal=False):
    """Attention through the per-head projections and a materialized [s, t]
    softmax, in the operands' dtype."""
    qp, kp, vp, wo = mha_project_qkv(attrs, q, k, v, weight, input_bias)
    return torch.einsum("bhsv,veh->bse", _dense_context(qp, kp, vp, causal), wo)


def _mha_forward(attrs: MultiHeadAttentionAttrs, q, k, v, weight, input_bias=None,
                 causal=False):
    """Under a flash_mesh (the data-parallel trainer), as in the JAX
    package, the per-head projections feed sharded_flash_attention on the
    rank's own block (at every head dim the kernels take), or the dense
    path where the kernels do not take the shapes. Otherwise
    self-attention-shaped operands the kernels take ride the seq-major
    flash path, at every head dim they take, and everything else the dense
    path. At d=64 with an even head count and q, k and v one tensor, one
    fused projection feeds the interleaved-QKV entry and one dqkv flows
    back.

    This routing differs from the JAX package's off a mesh in two places.
    The JAX package takes its per-head [b, h, s, d] entry at every d with
    d % 128 != 0 but the d=64 pair (its seq-major blocks must be 128-lane
    aligned); the port's seq-major kernels read any d through their tensor
    maps, so every d rides them and no transposes are paid. And at d=64
    with s > 1024 the JAX package's pair path, whose backward fits one
    block, yields to the per-head entry; the port's pair kernels stream
    any s. Either way the function computed is the same."""
    if current_flash_mesh() is not None:
        qp, kp, vp, wo = mha_project_qkv(attrs, q, k, v, weight, input_bias)
        if sharded_flash_supported(qp.shape, kp.shape, vp.shape, qp.dtype, qp.device):
            ctx = sharded_flash_attention(qp, kp, vp, causal)
        else:
            ctx = _dense_context(qp, kp, vp, causal)
        return torch.einsum("bhsv,veh->bse", ctx, wo)
    kd, vd, H = attrs.q_proj_size, attrs.v_proj_size, attrs.num_heads
    proj_shape = (q.shape[0], q.shape[1], H * kd)
    if (
        kd == vd
        and q.shape == k.shape == v.shape
        and flash_attention_bshf_supported(proj_shape, H, q.dtype, q.device)
    ):
        if kd == 64 and H % 2 == 0 and q is k and k is v:
            qkv, wo2 = mha_project_qkv_bshf_fused(attrs, q, weight, input_bias)
            return flash_attention_bshf_qkv(qkv, H, causal) @ wo2
        qp, kp, vp, wo2 = mha_project_qkv_bshf(attrs, q, k, v, weight, input_bias)
        return flash_attention_bshf(qp, kp, vp, H, causal) @ wo2
    return dense_attention(attrs, q, k, v, weight, input_bias, causal)


def _activate(activation, x):
    return activation.apply(x) if activation else x


def _conv2d(attrs: Conv2DAttrs, x, weights):
    """NCHW input, OIHW kernel, symmetric padding per spatial dim."""
    out = F.conv2d(x, weights[0], stride=(attrs.stride_h, attrs.stride_w),
                   padding=(attrs.padding_h, attrs.padding_w), groups=attrs.groups)
    if attrs.use_bias:
        out = out + weights[1][None, :, None, None]
    return _activate(attrs.activation, out)


def _pool2d(attrs: Pool2DAttrs, x):
    """lax.reduce_window's pooling: max pads with -inf, avg sums a window of
    the zero-padded input and divides by kernel_h * kernel_w. PyTorch's pools
    take at most half the kernel as padding, so wider padding is applied
    explicitly first (the same values either way)."""
    kernel, stride = (attrs.kernel_h, attrs.kernel_w), (attrs.stride_h, attrs.stride_w)
    padding = (attrs.padding_h, attrs.padding_w)
    is_max = attrs.pool_type == PoolOp.MAX
    if any(2 * p > k for p, k in zip(padding, kernel)):
        fill = float("-inf") if is_max else 0.0
        x = F.pad(x, (padding[1], padding[1], padding[0], padding[0]), value=fill)
        padding = (0, 0)
    if is_max:
        out = F.max_pool2d(x, kernel, stride, padding)
    else:
        out = F.avg_pool2d(x, kernel, stride, padding, count_include_pad=True)
    return _activate(attrs.activation, out)


_batch_tls = threading.local()


@contextlib.contextmanager
def batch_stats_group(all_reduce):
    """Declare that the batch is split over ranks: within, BatchNorm takes
    its statistics over the whole batch, summing its per-channel sums and
    row counts with `all_reduce(t)` (the sum of t over the ranks that share
    the batch, differentiable), as GSPMD normalizes a sharded batch."""
    prev = getattr(_batch_tls, "all_reduce", None)
    _batch_tls.all_reduce = all_reduce
    try:
        yield
    finally:
        _batch_tls.all_reduce = prev


def _reshape(attrs: ReshapeAttrs, x):
    """x reshaped to the attrs' shape. Under a batch_stats_group x is a
    rank's block of the batch, so a target whose dim 0 is the whole batch's
    and whose other dims hold a row of x keeps the block's rows (the
    data-parallel trainer runs the graph's global shapes on each block)."""
    shape = tuple(attrs.shape)
    if (getattr(_batch_tls, "all_reduce", None) is not None and x.ndim and shape
            and x.shape[0] != shape[0] and math.prod(x.shape[1:]) == math.prod(shape[1:])):
        shape = (x.shape[0], *shape[1:])
    return x.reshape(shape)


def _batch_norm(attrs: BatchNormAttrs, x, weights):
    """Normalize by the batch's mean and biased variance over every axis but
    the channels (axis 1), then the affine, then an optional ReLU. Under a
    batch_stats_group the mean and the variance are the whole batch's: its
    sums over the ranks (two passes, as the single-device mean and
    variance)."""
    axes = (0, 2, 3) if x.ndim == 4 else (0,)
    all_reduce = getattr(_batch_tls, "all_reduce", None)
    if all_reduce is None:
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
    else:
        f32 = torch.float32
        rows = torch.full((1,), x.numel() // x.shape[1], dtype=f32, device=x.device)
        total = all_reduce(torch.cat([x.sum(dim=axes, dtype=f32), rows]))
        shape = (1, -1) + (1,) * (x.ndim - 2)
        mean = (total[:-1] / total[-1]).to(x.dtype).reshape(shape)
        sq = all_reduce((x - mean).square().sum(dim=axes, dtype=f32))
        var = (sq / total[-1]).to(x.dtype).reshape(shape)
    out = (x - mean) * torch.rsqrt(var + attrs.eps)
    if attrs.affine:
        shape = (1, -1) + (1,) * (x.ndim - 2)
        out = out * weights[0].reshape(shape) + weights[1].reshape(shape)
    return relu(out) if attrs.relu else out


def _layer_norm(attrs: LayerNormAttrs, x, weights):
    axes = tuple(attrs.axes)
    gamma, beta = (weights[0], weights[1]) if attrs.elementwise_affine else (None, None)
    if axes == tuple(range(x.ndim - len(axes), x.ndim)):
        return F.layer_norm(x, x.shape[x.ndim - len(axes):], gamma, beta, attrs.eps)
    mean = x.mean(dim=axes, keepdim=True)
    var = x.var(dim=axes, keepdim=True, unbiased=False)
    out = (x - mean) * torch.rsqrt(var + attrs.eps)
    if attrs.elementwise_affine:
        bshape = tuple(x.shape[i] if i in axes else 1 for i in range(x.ndim))
        out = out * gamma.reshape(bshape) + beta.reshape(bshape)
    return out


def embedding_lookup(idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Rows of `table` at `idx`, as the JAX package's `jnp.take(table, idx,
    axis=0)` in its default fill mode: ids in [-V, V) are taken (negative
    ids wrap), every other id gives a NaN row and sends no gradient to the
    table. The index is wrapped and clamped, the rows gathered, and the
    rows of out-of-range ids replaced, with no read on the host."""
    rows = table.shape[0]
    idx = idx.long()
    valid = (idx >= -rows) & (idx < rows)
    safe = torch.where(idx < 0, idx + rows, idx).clamp(0, rows - 1)
    out = F.embedding(safe, table)
    nan = torch.full((), float("nan"), dtype=out.dtype, device=out.device)
    return torch.where(valid[..., None], out, nan)


def dropout(x: torch.Tensor, rate: float, train: bool,
            rng: Optional[torch.Generator]) -> torch.Tensor:
    """Inverted dropout: the identity outside training or at rate 0; else
    each element kept with probability 1 - rate (a uniform draw from `rng`
    below it, as jax.random.bernoulli draws) and scaled by 1 / (1 - rate)."""
    if not train or rate == 0.0:
        return x
    if rng is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    return apply_dropout_mask(x, dropout_keep_mask(x.shape, rate, rng, x.device), rate)


def dropout_keep_mask(shape, rate: float, rng: torch.Generator, device) -> torch.Tensor:
    """The keep mask of one dropout draw: a uniform draw from `rng` below
    1 - rate."""
    return torch.rand(tuple(shape), generator=rng, device=device) < 1.0 - rate


def apply_dropout_mask(x: torch.Tensor, mask: torch.Tensor, rate: float) -> torch.Tensor:
    """Inverted dropout under a given keep mask: kept elements scaled by
    1 / (1 - rate), the others zero."""
    keep = 1.0 - rate
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _reduce(attrs: ReduceAttrs, x: torch.Tensor) -> torch.Tensor:
    axes = tuple(sorted({a % x.ndim for a in attrs.axes}))
    keep = attrs.keepdims
    if attrs.op_type == ReduceOpType.SUM:
        return x.sum(dim=axes, keepdim=keep)
    if attrs.op_type == ReduceOpType.MEAN:
        return x.mean(dim=axes, keepdim=keep)
    if attrs.op_type == ReduceOpType.MAX:
        return x.amax(dim=axes, keepdim=keep)
    if attrs.op_type == ReduceOpType.MIN:
        return x.amin(dim=axes, keepdim=keep)
    out = x
    for a in reversed(axes):  # PROD takes one dim at a time
        out = out.prod(dim=a, keepdim=keep)
    return out


def forward(attrs: OpAttrs, inputs: Sequence[torch.Tensor],
            weights: Sequence[torch.Tensor] = (), train: bool = False,
            rng: Optional[torch.Generator] = None) -> List[torch.Tensor]:
    inputs, weights = list(inputs), list(weights)
    if isinstance(attrs, (InputAttrs, WeightAttrs)):
        raise ValueError("input/weight nodes have no kernel; bind their values")
    if isinstance(attrs, NoopAttrs):
        return [inputs[0]]
    if isinstance(attrs, ElementUnaryAttrs):
        if attrs.op_type in _SCALAR_FNS:
            return [_SCALAR_FNS[attrs.op_type](inputs[0], attrs.scalar)]
        return [_UNARY_FNS[attrs.op_type](inputs[0])]
    if isinstance(attrs, ElementBinaryAttrs):
        return [_BINARY_FNS[attrs.op_type](inputs[0], inputs[1])]
    if isinstance(attrs, CastAttrs):
        return [inputs[0].to(attrs.dtype.to_torch())]
    if isinstance(attrs, LinearAttrs):
        out = inputs[0] @ weights[0]
        if attrs.use_bias:
            out = out + weights[1]
        return [attrs.activation.apply(out) if attrs.activation else out]
    if isinstance(attrs, BatchMatmulAttrs):
        # the JAX package computes it outside any Pallas kernel (jnp.matmul)
        return [torch.matmul(inputs[0], inputs[1])]
    if isinstance(attrs, EmbeddingAttrs):
        out = embedding_lookup(inputs[0], weights[0])
        if attrs.aggr == AggregateSpec.SUM:
            out = out.sum(dim=-2)
        elif attrs.aggr == AggregateSpec.AVG:
            out = out.mean(dim=-2)
        return [out]
    if isinstance(attrs, Conv2DAttrs):
        return [_conv2d(attrs, inputs[0], weights)]
    if isinstance(attrs, Pool2DAttrs):
        return [_pool2d(attrs, inputs[0])]
    if isinstance(attrs, FlatAttrs):
        return [inputs[0].reshape(inputs[0].shape[0], -1)]
    if isinstance(attrs, BatchNormAttrs):
        return [_batch_norm(attrs, inputs[0], weights)]
    if isinstance(attrs, LayerNormAttrs):
        return [_layer_norm(attrs, inputs[0], weights)]
    if isinstance(attrs, SoftmaxAttrs):
        return [torch.softmax(inputs[0], dim=attrs.dim)]
    if isinstance(attrs, DropoutAttrs):
        return [dropout(inputs[0], attrs.rate, train, rng)]
    if isinstance(attrs, MultiHeadAttentionAttrs):
        # RingAttention and Ulysses subclass MHA: off a mesh this is the
        # single-device attention, masked as the op says, as in the JAX
        # package; their sharded schedules (the ring, the all-to-alls) are
        # the parallel executor's
        q, k, v = inputs
        input_bias = weights[1] if attrs.bias else None
        causal = isinstance(attrs, RingAttentionAttrs) and attrs.causal
        out = _mha_forward(attrs, q, k, v, weights[0], input_bias, causal=causal)
        if attrs.bias:
            out = out + weights[2]
        return [out]
    if isinstance(attrs, ConcatAttrs):
        return [torch.cat(inputs, dim=attrs.axis)]
    if isinstance(attrs, StackAttrs):
        return [torch.stack(inputs, dim=0)]
    if isinstance(attrs, BroadcastAttrs):
        return [torch.broadcast_to(inputs[0], tuple(attrs.target_dims))]
    if isinstance(attrs, ReduceAttrs):
        return [_reduce(attrs, inputs[0])]
    if isinstance(attrs, SplitAttrs):
        return list(torch.split(inputs[0], list(attrs.sizes), dim=attrs.axis))
    if isinstance(attrs, ReshapeAttrs):
        return [_reshape(attrs, inputs[0])]
    if isinstance(attrs, TransposeAttrs):
        return [inputs[0].permute(*attrs.perm)]
    if isinstance(attrs, ReverseAttrs):
        return [torch.flip(inputs[0], dims=(attrs.axis % inputs[0].ndim,))]
    if isinstance(attrs, GatherAttrs):
        return [torch.gather(inputs[0], attrs.dim % inputs[0].ndim, inputs[1].long())]
    if isinstance(attrs, TopKAttrs):
        values, indices = moe.top_k(inputs[0], attrs.k)
        return [values, indices.to(torch.int32)]
    if isinstance(attrs, GroupByAttrs):
        return moe.group_by_forward(attrs, inputs[0], inputs[1])
    if isinstance(attrs, AggregateAttrs):
        return [moe.aggregate_forward(attrs, inputs[0], inputs[1], inputs[2:])]
    if isinstance(attrs, ExpertsAttrs):
        return moe.experts_forward(attrs, inputs[0], weights)
    if isinstance(attrs, (StagePartitionAttrs, StageMergeAttrs)):
        # the identity on values: the microbatch schedule is a lowering
        # choice (parallel/pipeline.py), so a flat run of a pipelined PCG
        # stays correct
        return [inputs[0]]
    raise TypeError(f"no kernel for {type(attrs).__name__}")


def op_forward_flops(
    attrs: OpAttrs,
    input_shapes,
    output_shapes,
    weight_shapes=None,
    seq_parallel_degree: int = 1,
) -> int:
    """Analytic forward FLOPs of one op (copy of the JAX package's, for MFU
    and the analytic cost model): matmul-class ops count 2*M*N*K, every
    other op one flop per output element. `weight_shapes` (per-device
    weight PIECE shapes) credits parameter-sharded pieces: a column-parallel
    Linear, a channel-parallel Conv2D, a head-parallel attention or an
    expert-parallel Experts op does proportionally less local compute than
    its attrs (which describe the GLOBAL op) imply; omitted = unsharded
    weights (MFU's global count). `seq_parallel_degree`: a ring or Ulysses
    attention piece attends all k key/value blocks, k times the piece's own
    score work."""
    def nelem(shape):
        return math.prod(shape.dims)

    if isinstance(attrs, LinearAttrs):
        x = input_shapes[0]
        batch = nelem(x) // x.dims[-1]
        out_ch = attrs.out_channels
        if weight_shapes:  # [in, out/k] piece of a column-parallel linear
            out_ch = weight_shapes[0].dims[1]
        return 2 * batch * x.dims[-1] * out_ch
    if isinstance(attrs, BatchMatmulAttrs):
        a, b = input_shapes[0], input_shapes[1]
        return 2 * math.prod(a.dims[:-2]) * a.dims[-2] * a.dims[-1] * b.dims[-1]
    if isinstance(attrs, Conv2DAttrs):
        cin = input_shapes[0].dims[1]
        window = (cin // attrs.groups) * attrs.kernel_h * attrs.kernel_w
        flops = 2 * nelem(output_shapes[0]) * window
        if weight_shapes:  # [out/k, in/g, kh, kw] channel-parallel piece
            flops = flops * weight_shapes[0].dims[0] // attrs.out_channels
        return flops
    if isinstance(attrs, MultiHeadAttentionAttrs):
        b, s, e = input_shapes[0].dims
        kd, vd, H = attrs.q_proj_size, attrs.v_proj_size, attrs.num_heads
        if weight_shapes:  # [per-head params, H/k] head-parallel piece
            H = weight_shapes[0].dims[1]
        proj = 2 * b * s * e * (kd + kd + vd) * H + 2 * b * s * vd * attrs.embed_dim * H
        scores = 2 * b * H * s * s * kd + 2 * b * H * s * s * vd
        if isinstance(attrs, RingAttentionAttrs) and seq_parallel_degree > 1:
            scores *= seq_parallel_degree
        return proj + scores
    if isinstance(attrs, EmbeddingAttrs):
        return 0
    if isinstance(attrs, ExpertsAttrs):
        x = input_shapes[0]
        d = x.dims[-1]
        n = nelem(x) // d
        e, h = attrs.num_experts, attrs.hidden_size
        o = attrs.out_channels or d
        # capacity is per GLOBAL expert; local compute covers e_local experts
        cap = expert_capacity(n, e, attrs.num_select, attrs.capacity_factor)
        e_local = e
        if weight_shapes and len(weight_shapes) > 1:
            e_local = weight_shapes[1].dims[0]
        gate = 2 * n * d * e
        dispatch = 2 * n * e_local * cap * (d + o)
        mlp = 2 * e_local * cap * (d * h + h * o)
        return gate + dispatch + mlp
    return sum(nelem(s) for s in output_shapes)


def graph_step_flops(graph) -> int:
    """A train step's flops of the model's own work: 3 x op_forward_flops
    over the compute ops of a computation graph, or of a PCG at its
    tensors' global shapes (its parallel ops skipped, so work a plan
    duplicates over ranks counts once). The numerator of the multi-device
    MFU: flops / (step seconds x ranks x the card's peak)."""
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
        ParallelTensorShape,
        get_reduced_shape,
    )

    def shape(t):
        s = graph.tensor_shape(t)
        return get_reduced_shape(s) if isinstance(s, ParallelTensorShape) else s

    total = 0
    for n in graph.topological_ordering():
        attrs = graph.op_attrs(n)
        if isinstance(attrs, (InputAttrs, WeightAttrs)) or is_parallel_op(attrs):
            continue
        total += op_forward_flops(attrs, [shape(t) for t in graph.inputs_of(n)],
                                  [shape(t) for t in graph.outputs_of(n)])
    return 3 * total
