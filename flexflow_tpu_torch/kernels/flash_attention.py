"""Flash attention on seq-major [b, s, h*d] tensors: hand-written CUDA
kernels for Hopper, their plain PyTorch versions, and the autograd Function
that ties them together.

Replaces the bshf Pallas path of flexflow_tpu/kernels/flash_attention.py:

- flash_fwd   <- _fwd_kernel_b via _fwd_bshf (the single-k-block path the
                 flagship takes at s=512, and the online-softmax loop)
- flash_delta <- _delta_kernel via _delta_bshf
- flash_bwd   <- _bwd_fused_kernel_b via _bwd_bshf_fused, split into a dK/dV
                 and a dQ kernel (csrc/flash_attention.cu says why)

Each wrapper runs its plain version for tensors on the CPU, and launches its
kernel for tensors on a CUDA device, or raises: there is no fallback. The
kernels take bf16, head dim 128 and a sequence that is a multiple of 64;
`flash_attention_supported` is the gate callers use. What bounds each
kernel on the card, and what its design does about it, is in the note at
the top of csrc/flash_attention.cu.

lse is kept in natural log ([b, h, s], f32); the TPU kernels keep it in
base 2 ([b, h, 1, s]), which is lse·log2(e).
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from flexflow_tpu_torch.kernels import build

HEAD_DIM = 128  # the kernels' head dim
TILE = 64  # the kernels' sequence tile
_SOURCE = "flash_attention.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ff_flash_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ff_flash_delta": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "ff_flash_bwd": ([_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ff_flash_smem_bytes": ([_I], _I),
    "ff_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use."""
    return build.load(_SOURCE, _SIGNATURES)


def _launch(name: str, *args) -> None:
    lib = library()
    code = getattr(lib, name)(*args)
    if code != 0:
        raise RuntimeError(
            f"{name} failed: CUDA error {code} ({lib.ff_error_string(code).decode()})"
        )


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def flash_attention_supported(shape, num_heads: int, dtype: torch.dtype, device) -> bool:
    """Can the flash path take self-attention operands of this [b, s, h*d]
    shape? On a CUDA device the kernels need bf16, d == 128 and s a multiple
    of the 64-row tile; on the CPU the plain versions take the same shapes
    in any float dtype."""
    if len(shape) != 3 or shape[2] != num_heads * HEAD_DIM or shape[1] % TILE:
        return False
    if torch.device(device).type == "cuda":
        return dtype == torch.bfloat16
    return dtype.is_floating_point


def _check_cuda(name: str, num_heads: int, *tensors: torch.Tensor) -> Tuple[int, int, int]:
    """Raise unless every tensor is a contiguous bf16 [b, s, h*128] on the
    CUDA device of the first; return (b, s, h)."""
    b, s, f = tensors[0].shape
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got {dev}")
    if f != num_heads * HEAD_DIM or s % TILE:
        raise ValueError(
            f"{name}: kernel takes [b, s, h*{HEAD_DIM}] with s a multiple of {TILE}, "
            f"got {tuple(tensors[0].shape)} with {num_heads} heads"
        )
    for t in tensors:
        if t.shape != (b, s, f) or t.dtype != torch.bfloat16 or t.device != dev:
            raise ValueError(f"{name}: operands must be bf16 {(b, s, f)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
    return b, s, num_heads


def _check_rows(name: str, t: torch.Tensor, b: int, h: int, s: int, dev) -> None:
    if t.shape != (b, h, s) or t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous f32 {(b, h, s)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


# -- plain versions ---------------------------------------------------------


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """[b, s, h*d] -> [b, h, s, d] in f32."""
    b, s, f = x.shape
    return x.reshape(b, s, num_heads, f // num_heads).transpose(1, 2).float()


def _bshf(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """[b, h, s, d] -> [b, s, h*d] in `dtype`."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d).to(dtype)


def _scores(q4: torch.Tensor, k4: torch.Tensor, causal: bool) -> torch.Tensor:
    scores = (q4 @ k4.transpose(-1, -2)) * (1.0 / math.sqrt(q4.shape[-1]))
    if causal:
        s, t = scores.shape[-2:]
        mask = torch.ones(s, t, dtype=torch.bool, device=scores.device).triu(1)
        scores = scores.masked_fill(mask, float("-inf"))
    return scores


def flash_fwd_plain(q, k, v, num_heads: int, causal: bool = False):
    """(o [b, s, h*d] in q's dtype, lse [b, h, s] f32), computed in f32."""
    scores = _scores(_heads(q, num_heads), _heads(k, num_heads), causal)
    lse = torch.logsumexp(scores, dim=-1)
    p = torch.exp(scores - lse[..., None])
    return _bshf(p @ _heads(v, num_heads), q.dtype), lse


def flash_delta_plain(do, o, num_heads: int):
    """delta [b, h, s] = sum over d of dO*O per head, in f32."""
    return (_heads(do, num_heads) * _heads(o, num_heads)).sum(-1)


def flash_bwd_plain(q, k, v, do, lse, delta, num_heads: int, causal: bool = False):
    """(dq, dk, dv) in the operands' dtypes, computed in f32 with P rebuilt
    from lse."""
    q4, k4, v4, do4 = (_heads(t, num_heads) for t in (q, k, v, do))
    scale = 1.0 / math.sqrt(q4.shape[-1])
    p = torch.exp(_scores(q4, k4, causal) - lse[..., None])
    dv = p.transpose(-1, -2) @ do4
    ds = p * (do4 @ v4.transpose(-1, -2) - delta[..., None])
    dq = (ds @ k4) * scale
    dk = (ds.transpose(-1, -2) @ q4) * scale
    return _bshf(dq, q.dtype), _bshf(dk, k.dtype), _bshf(dv, v.dtype)


# -- wrappers ---------------------------------------------------------------


def flash_fwd(q, k, v, num_heads: int, causal: bool = False):
    """(o, lse) of softmax(q k^T / sqrt(d)) v per head."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads, causal)
    b, s, h = _check_cuda("flash_fwd", num_heads, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("ff_flash_fwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, int(causal), _stream(q))
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_delta(do, o, num_heads: int):
    """delta [b, h, s] f32 = rowsum(dO * O) per head."""
    if do.device.type == "cpu":
        return flash_delta_plain(do, o, num_heads)
    b, s, h = _check_cuda("flash_delta", num_heads, do, o)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    _launch("ff_flash_delta", do.data_ptr(), o.data_ptr(), delta.data_ptr(), b, s, h,
            _stream(do))
    flash_delta.launches += 1
    return delta


flash_delta.launches = 0


def flash_bwd(q, k, v, do, lse, delta, num_heads: int, causal: bool = False):
    """(dq, dk, dv) from the saved forward and delta."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, num_heads, causal)
    b, s, h = _check_cuda("flash_bwd", num_heads, q, k, v, do)
    _check_rows("flash_bwd lse", lse, b, h, s, q.device)
    _check_rows("flash_bwd delta", delta, b, h, s, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("ff_flash_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, int(causal), _stream(q))
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0

KERNEL_WRAPPERS = (flash_fwd, flash_delta, flash_bwd)


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


class FlashAttentionBSHF(torch.autograd.Function):
    """Attention on [b, s, h*d] operands whose gradient runs the delta and
    backward kernels. The forward saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, causal: bool = False):
        o, lse = flash_fwd(q, k, v, num_heads, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.causal = num_heads, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta(do, o, ctx.num_heads)
        dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, ctx.num_heads, ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_bshf(q, k, v, num_heads: int, causal: bool = False):
    """Self-attention on seq-major [b, s, h*d] tensors; returns [b, s, h*d]."""
    return FlashAttentionBSHF.apply(q, k, v, num_heads, causal)
