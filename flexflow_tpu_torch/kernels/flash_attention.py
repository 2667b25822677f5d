"""Flash attention on seq-major [b, s, h*d] and on per-head [b, h, s, d]
tensors: hand-written CUDA kernels for Hopper, their plain PyTorch
versions, and the autograd Functions that tie them together.

Replaces the bshf Pallas path of flexflow_tpu/kernels/flash_attention.py:

- flash_fwd       <- _fwd_kernel_b via _fwd_bshf (the single-k-block path the
                     flagship takes at s=512, and the online-softmax loop)
- flash_delta     <- _delta_kernel via _delta_bshf
- flash_bwd       <- _bwd_fused_kernel_b via _bwd_bshf_fused, split into a
                     dK/dV and a dQ kernel (csrc/flash_attention.cu says why);
                     the same two kernels take any s that is a multiple of 64,
                     so they also compute what _bwd_onepass_kernel and
                     _bwd_dq_kernel/_bwd_dkv_kernel compute for s > block
                     (these three take every head dim the kernels take)
- flash_fwd_d64   <- _fwd_kernel_pair via _fwd_bshf_pair and _fwd_bshf_pair_qkv
- flash_delta_d64 <- the delta _bwd_pair_core computes inline
- flash_bwd_d64   <- _bwd_pair_core via _bwd_bshf_pair_fused and
                     _bwd_bshf_pair_fused_qkv, split as flash_bwd is

(at head dim 256, BERT's heads with kdim = 3072 / 12, flash_fwd, flash_delta
and flash_bwd launch the kernels of width 256, where the JAX package runs
the same three Pallas kernels; past 256 they hand over to flash_fwd_wide,
flash_delta_wide and flash_bwd_wide, the kernels of csrc/flash_wide.cu)

and the per-head path (`flash_attention`, the counterpart of the JAX
package's entry of that name), at every head dim the kernels take:

- flash_fwd_bhsd   <- _fwd_kernel_b (batch-folded) and _fwd_kernel (the
                      online-softmax loop) via _fwd
- flash_delta_bhsd <- _delta_kernel via _delta_rows
- flash_bwd_bhsd   <- _bwd_fused_kernel_b via _bwd_rows_fused (s <= block)
                      and _bwd_dq_kernel/_bwd_dkv_kernel via _bwd (s >
                      block), split as flash_bwd is

(past 256 they hand over to flash_fwd_bhsd_wide, flash_delta_bhsd_wide and
flash_bwd_bhsd_wide).

Head dims. The kernels take every head dim d with d % 8 == 0 from 8 up,
the range of the JAX per-head and ring kernels (`head_dim_supported`; the
JAX seq-major entry takes 384 and 512 past 256). Up to 256 (NARROW_MAX)
the kernels of csrc/flash_attention.cu run at a padded width of 64, 128,
192 or 256 (`padded_dim`) whose columns past d load as zeros and are never
stored (csrc/flash_fwd_sm90.cuh's note). Past 256 the wide kernels of
csrc/flash_wide.cu take every such d: a block owns a chunk of 256 output
columns and streams the head dim in 64-column panels
(csrc/flash_wide_sm90.cuh's note). Each wrapper above hands a head dim past
256 over to its `_wide` counterpart, which counts its own launches; no
attention the gates admit runs dense.

flash_fwd, flash_delta and flash_bwd take contiguous [b, s, h*d] operands.
The d=64 ones (the head pair, an even head count) take q, k and v (and
write dq, dk and dv) as lane-group views
[b, s, h/2, 128] with free row and group strides: `lane_groups` of separate
[b, s, h*64] tensors, or `qkv_views` of the interleaved projection
[b, s, 3*h*64] that `ops.mha_project_qkv_bshf_fused` makes, whose pair-group
g holds [q_pair | k_pair | v_pair] in 384 lanes. So one kernel serves both
layouts and the fused projection needs no slicing copy, and its gradient
no concat.

The per-head wrappers take [b, h, s, d] operands by their strides (unit
stride along d, rows 16-byte aligned): contiguous tensors, and the view
that the per-head projection einsum returns, which lies in memory as
[b, s, h, d]. `FlashAttentionBHSD` makes one contiguous copy of an operand
only when the kernels cannot read it as it is.

Each wrapper runs its plain version for tensors on the CPU, and launches its
kernel for tensors on a CUDA device, or raises: there is no fallback. The
kernels take bf16, a head dim `head_dim_supported` admits, and a sequence
that is a multiple of 64; `flash_attention_bshf_supported` and
`flash_attention_supported` are the gates callers use. What bounds each
kernel on the card, and what its design does about it, is in the note at
the top of csrc/flash_attention.cu and of the mainloops it names.

`flash_mesh(group)` declares that the code traced within runs on one rank
of a data-parallel process group (the port's copy of the JAX package's
SPMD context); `kernels/ops.py` then routes attention through
`sharded_flash_attention`.

lse is kept in natural log ([b, h, s], f32); the TPU kernels keep it in
base 2 ([b, h, 1, s]), which is lse·log2(e).
"""

from __future__ import annotations

import contextlib
import ctypes
import math
import threading
from typing import Tuple

import torch

from flexflow_tpu_torch.kernels import build

HEAD_DIM_STEP = 8  # the kernels take every head dim that is a multiple of 8
NARROW_MAX = 256  # up to it the narrow kernels take a head dim, past it the wide ones
PADDED_WIDTHS = (64, 128, 192, 256)  # the narrow kernels' widths: d rounds up to one
LANES = 128  # width of the lane groups the d=64 pair kernels read (two heads each)
TILE = 64  # the kernels' sequence tile
_SOURCE = "flash_attention.cu"
_WIDE_SOURCE = "flash_wide.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "ff_flash_fwd": ([_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ff_flash_delta": ([_I, _P, _P, _P, _I, _I, _I, _P], _I),
    "ff_flash_bwd": ([_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P], _I),
    "ff_flash_fwd_d64": ([_P, _P, _P, _I, _I, _P, _P, _I, _I, _I, _I, _P], _I),
    "ff_flash_delta_d64": ([_P, _P, _P, _I, _I, _I, _P], _I),
    "ff_flash_bwd_d64": (
        [_P, _P, _P, _I, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P], _I
    ),
    "ff_flash_fwd_bhsd": ([_I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I, _P], _I),
    "ff_flash_delta_bhsd": ([_I, _P, _I, _I, _I, _P, _I, _I, _I, _P, _I, _I, _I, _P], _I),
    "ff_flash_bwd_bhsd": (
        [_I, _P, _P, _P, _I, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I,
         _I, _I, _I, _I, _P], _I
    ),
    "ff_flash_smem_bytes": ([_I], _I),
    "ff_error_string": ([_I], ctypes.c_char_p),
}
# the wide library's entries take the narrow ones' arguments
_WIDE_SIGNATURES = {
    "ff_flash_wide_fwd": _SIGNATURES["ff_flash_fwd"],
    "ff_flash_wide_delta": _SIGNATURES["ff_flash_delta"],
    "ff_flash_wide_bwd": _SIGNATURES["ff_flash_bwd"],
    "ff_flash_wide_fwd_bhsd": _SIGNATURES["ff_flash_fwd_bhsd"],
    "ff_flash_wide_delta_bhsd": _SIGNATURES["ff_flash_delta_bhsd"],
    "ff_flash_wide_bwd_bhsd": _SIGNATURES["ff_flash_bwd_bhsd"],
    "ff_ring_wide_fwd_step": ([_I] + 3 * [_P, _I, _I, _I] + 5 * [_P] + 7 * [_I] + [_P], _I),
    "ff_ring_wide_dq_step": ([_I] + 4 * [_P, _I, _I, _I] + 3 * [_P] + 7 * [_I] + [_P], _I),
    "ff_ring_wide_dkv_step": ([_I] + 4 * [_P, _I, _I, _I] + 4 * [_P] + 7 * [_I] + [_P], _I),
    "ff_wide_smem_bytes": ([_I], _I),
    "ff_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The kernels' library, built at first use."""
    return build.load(_SOURCE, _SIGNATURES)


def wide_library() -> ctypes.CDLL:
    """The wide kernels' library (head dims past 256), built at first use."""
    return build.load(_WIDE_SOURCE, _WIDE_SIGNATURES)


def _launch(name: str, *args) -> None:
    build.launch(library(), name, *args)


def _launch_wide(name: str, *args) -> None:
    build.launch(wide_library(), name, *args)


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _dtype_ok(dtype: torch.dtype, device) -> bool:
    """bf16 for the kernels on a CUDA device; any float dtype for the plain
    versions on the CPU; nothing elsewhere (a `meta` dry run of an op's
    shapes takes the dense path and never reaches a wrapper)."""
    kind = torch.device(device).type
    if kind == "cuda":
        return dtype == torch.bfloat16
    return kind == "cpu" and dtype.is_floating_point


def head_dim_supported(d: int) -> bool:
    """Do the kernels take head dim d? Every multiple of 8, the range of the
    JAX per-head and ring kernels' d % 8 == 0 test: the narrow kernels up
    to 256, the wide ones past it."""
    return d >= HEAD_DIM_STEP and d % HEAD_DIM_STEP == 0


def wide_head_dim(d: int) -> bool:
    """Does head dim d run on the wide kernels (csrc/flash_wide.cu)?"""
    return d > NARROW_MAX


def padded_dim(d: int) -> int:
    """The width (of PADDED_WIDTHS) of the narrow kernels that take head dim
    d; past 256, the multiple of 64 that the wide kernels' panels pad d to."""
    return -(-d // 64) * 64


def flash_attention_bshf_supported(shape, num_heads: int, dtype: torch.dtype, device) -> bool:
    """Can the seq-major flash path take self-attention operands of this
    [b, s, h*d] shape? The kernels need a head dim head_dim_supported
    admits (d % 8 == 0, d >= 8; any head count) and s a multiple of the
    64-row tile, in bf16 on a CUDA device."""
    if len(shape) != 3 or shape[1] % TILE or shape[2] % num_heads:
        return False
    if not head_dim_supported(shape[2] // num_heads):
        return False
    return _dtype_ok(dtype, device)


def flash_attention_supported(q_shape, k_shape, v_shape, dtype: torch.dtype, device) -> bool:
    """Can the per-head flash path take q, k and v of these [b, h, s, d]
    shapes? The kernels need one shape for all three, a head dim
    head_dim_supported admits (d % 8 == 0, d >= 8) and s a multiple of the
    64-row tile, in bf16 on a CUDA device."""
    q_shape = tuple(q_shape)
    if len(q_shape) != 4 or tuple(k_shape) != q_shape or tuple(v_shape) != q_shape:
        return False
    if not head_dim_supported(q_shape[3]) or q_shape[2] % TILE:
        return False
    return _dtype_ok(dtype, device)


def _check_cuda(name: str, num_heads: int, d: int, *tensors: torch.Tensor) -> Tuple[int, int, int]:
    """Raise unless every tensor is a contiguous bf16 [b, s, h*d] on the
    CUDA device of the first, starting 16-byte aligned (tile and delta
    loads of 16 bytes), with d a head dim the kernels take; return
    (b, s, h)."""
    b, s, f = tensors[0].shape
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got {dev}")
    if f != num_heads * d or s % TILE or not head_dim_supported(d):
        raise ValueError(
            f"{name}: kernel takes [b, s, h*{d}] with s a multiple of {TILE} and d % "
            f"{HEAD_DIM_STEP} == 0, d >= {HEAD_DIM_STEP}, got {tuple(tensors[0].shape)} with "
            f"{num_heads} heads"
        )
    for t in tensors:
        if t.shape != (b, s, f) or t.dtype != torch.bfloat16 or t.device != dev:
            raise ValueError(f"{name}: operands must be bf16 {(b, s, f)} on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must start 16-byte aligned")
    return b, s, num_heads


def _check_groups(name: str, num_heads: int, *views: torch.Tensor) -> Tuple[int, int]:
    """Raise unless the views are bf16 lane groups [b, s, h/2, 128] on the
    CUDA device of the first, sharing one row stride and one group stride,
    with every head starting 16-byte aligned; return (row stride, group
    stride) in elements."""
    b, s = views[0].shape[:2]
    dev = views[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got {dev}")
    if num_heads % 2 or s % TILE:
        raise ValueError(f"{name}: kernel takes an even head count and s a multiple of "
                         f"{TILE}, got {num_heads} heads and s={s}")
    want = (b, s, num_heads // 2, LANES)
    ld, group = views[0].stride(1), views[0].stride(2)
    for t in views:
        if t.shape != want or t.dtype != torch.bfloat16 or t.device != dev:
            raise ValueError(f"{name}: operands must be bf16 {want} lane groups on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
        if t.stride() != (s * ld, ld, group, 1):
            raise ValueError(f"{name}: operands must share row stride {ld} and group stride "
                             f"{group} with rows packed by batch, got strides {t.stride()}")
        # 16-byte tile loads: every head starts at a multiple of 64 elements
        if ld % 8 or group % 8 or t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must start 16-byte aligned with strides a "
                             f"multiple of 8, got strides {t.stride()}")
    return ld, group


def _readable_strides(strides) -> bool:
    """Unit stride along d; row, head and batch strides multiples of 8
    elements (16-byte tile loads) that fit the kernels' int."""
    return strides[3] == 1 and all(x % 8 == 0 and 0 <= x < 2**31 for x in strides[:3])


def bhsd_readable(t: torch.Tensor) -> bool:
    """Can the per-head kernels read this [b, h, s, d] tensor in place?"""
    return t.dim() == 4 and _readable_strides(t.stride()) and t.data_ptr() % 16 == 0


def _check_bhsd(name: str, shape, *tensors: torch.Tensor) -> Tuple[int, int, int]:
    """Raise unless the tensors are bf16 [b, h, s, d] of `shape` with d a
    head dim the kernels take and s a multiple of the tile, readable in
    place, sharing one set of strides, on the CUDA device of the first;
    return its (row, head, batch) strides in elements."""
    if not head_dim_supported(shape[3]) or shape[2] % TILE:
        raise ValueError(f"{name}: kernel takes [b, h, s, d] with d in the multiples of "
                         f"{HEAD_DIM_STEP} from {HEAD_DIM_STEP} and s a multiple of {TILE}, "
                         f"got {tuple(shape)}")
    strides = tensors[0].stride()
    for t in tensors:
        if tuple(t.shape) != tuple(shape) or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: operands must be bf16 {tuple(shape)}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.stride() != strides or not _readable_strides(strides):
            raise ValueError(f"{name}: operands must share strides with unit stride along d and "
                             f"the others multiples of 8, got {[x.stride() for x in tensors]}")
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got "
                             f"{t.device}")
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: operands must start 16-byte aligned")
    return strides[2], strides[1], strides[0]


def _check_rows(name: str, t: torch.Tensor, b: int, h: int, s: int, dev) -> None:
    """Raise unless t is a contiguous f32 [b, h, s] on dev starting 16-byte
    aligned (the backward copies its rows in bulk)."""
    if t.shape != (b, h, s) or t.dtype != torch.float32 or t.device != dev or not t.is_contiguous():
        raise ValueError(f"{name}: expected contiguous f32 {(b, h, s)} on {dev}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: rows must start 16-byte aligned")


# -- layouts ----------------------------------------------------------------


def lane_groups(x: torch.Tensor) -> torch.Tensor:
    """[b, s, f] -> the view [b, s, f/128, 128]."""
    b, s, f = x.shape
    return x.view(b, s, f // LANES, LANES)


def qkv_views(qkv: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The q, k and v lane-group views [b, s, f/128, 128] of an interleaved
    [b, s, 3f] projection (pair-group g: [q_pair | k_pair | v_pair])."""
    b, s, f3 = qkv.shape
    return qkv.view(b, s, f3 // (3 * LANES), 3, LANES).unbind(3)


def _ungroup(x: torch.Tensor) -> torch.Tensor:
    """Lane groups [b, s, g, 128] -> [b, s, g*128] (a copy if strided)."""
    return x.reshape(x.shape[0], x.shape[1], -1)


def interleave_qkv(q, k, v) -> torch.Tensor:
    """Three [b, s, f] tensors -> the interleaved [b, s, 3f] layout."""
    b, s, f = q.shape
    groups = [x.reshape(b, s, f // LANES, LANES) for x in (q, k, v)]
    return torch.stack(groups, dim=3).reshape(b, s, 3 * f)


def split_qkv(qkv):
    """The interleaved [b, s, 3f] layout -> three contiguous [b, s, f]."""
    return tuple(map(_ungroup, qkv_views(qkv)))


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


def _attend(q4, k4, v4, causal: bool):
    """(o, lse) of f32 [b, h, s, d] operands."""
    scores = _scores(q4, k4, causal)
    lse = torch.logsumexp(scores, dim=-1)
    return torch.exp(scores - lse[..., None]) @ v4, lse


def _attend_bwd(q4, k4, v4, do4, lse, delta, causal: bool):
    """(dq, dk, dv) of f32 [b, h, s, d] operands, with P rebuilt from lse."""
    scale = 1.0 / math.sqrt(q4.shape[-1])
    p = torch.exp(_scores(q4, k4, causal) - lse[..., None])
    dv = p.transpose(-1, -2) @ do4
    ds = p * (do4 @ v4.transpose(-1, -2) - delta[..., None])
    return (ds @ k4) * scale, (ds.transpose(-1, -2) @ q4) * scale, dv


def flash_fwd_plain(q, k, v, num_heads: int, causal: bool = False):
    """(o [b, s, h*d] in q's dtype, lse [b, h, s] f32), computed in f32."""
    o, lse = _attend(*(_heads(t, num_heads) for t in (q, k, v)), causal)
    return _bshf(o, q.dtype), lse


def flash_delta_plain(do, o, num_heads: int):
    """delta [b, h, s] = sum over d of dO*O per head, in f32."""
    return (_heads(do, num_heads) * _heads(o, num_heads)).sum(-1)


def flash_bwd_plain(q, k, v, do, lse, delta, num_heads: int, causal: bool = False):
    """(dq, dk, dv) in the operands' dtypes, computed in f32 with P rebuilt
    from lse."""
    grads = _attend_bwd(*(_heads(t, num_heads) for t in (q, k, v, do)), lse, delta, causal)
    return tuple(_bshf(g, t.dtype) for g, t in zip(grads, (q, k, v)))


def flash_fwd_bhsd_plain(q, k, v, causal: bool = False):
    """(o [b, h, s, d] in q's dtype, lse [b, h, s] f32) of per-head
    operands, computed in f32."""
    o, lse = _attend(q.float(), k.float(), v.float(), causal)
    return o.to(q.dtype), lse


def flash_delta_bhsd_plain(do, o):
    """delta [b, h, s] = sum over d of dO*O of per-head operands, in f32."""
    return (do.float() * o.float()).sum(-1)


def flash_bwd_bhsd_plain(q, k, v, do, lse, delta, causal: bool = False):
    """(dq, dk, dv) of per-head operands in their dtypes, computed in f32."""
    grads = _attend_bwd(q.float(), k.float(), v.float(), do.float(), lse, delta, causal)
    return tuple(g.to(t.dtype) for g, t in zip(grads, (q, k, v)))


def flash_fwd_qkv_plain(qkv, num_heads: int, causal: bool = False):
    """(o, lse) of attention over the interleaved [b, s, 3f] projection."""
    return flash_fwd_plain(*split_qkv(qkv), num_heads, causal)


def flash_bwd_qkv_plain(qkv, do, lse, delta, num_heads: int, causal: bool = False):
    """dqkv [b, s, 3f] in the interleaved layout of qkv."""
    return interleave_qkv(*flash_bwd_plain(*split_qkv(qkv), do, lse, delta, num_heads, causal))


# -- wrappers ---------------------------------------------------------------


def _head_dim(x: torch.Tensor, num_heads: int) -> int:
    return x.shape[-1] // num_heads


def _check_wide(name: str, d: int) -> None:
    if not wide_head_dim(d):
        raise ValueError(f"{name}: the wide kernels take head dims past {NARROW_MAX}, got {d}")


def flash_fwd(q, k, v, num_heads: int, causal: bool = False):
    """(o, lse) of softmax(q k^T / sqrt(d)) v per head, at any head dim the
    kernels take (head_dim_supported); past 256 through flash_fwd_wide."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads, causal)
    d = _head_dim(q, num_heads)
    if wide_head_dim(d):
        return flash_fwd_wide(q, k, v, num_heads, causal)
    b, s, h = _check_cuda("flash_fwd", num_heads, d, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("ff_flash_fwd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), b, s, h, int(causal), _stream(q))
    flash_fwd.launches += 1
    return o, lse


flash_fwd.launches = 0


def flash_delta(do, o, num_heads: int):
    """delta [b, h, s] f32 = rowsum(dO * O) per head, at any head dim the
    kernels take; past 256 through flash_delta_wide."""
    if do.device.type == "cpu":
        return flash_delta_plain(do, o, num_heads)
    d = _head_dim(do, num_heads)
    if wide_head_dim(d):
        return flash_delta_wide(do, o, num_heads)
    b, s, h = _check_cuda("flash_delta", num_heads, d, do, o)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    _launch("ff_flash_delta", d, do.data_ptr(), o.data_ptr(), delta.data_ptr(), b, s, h,
            _stream(do))
    flash_delta.launches += 1
    return delta


flash_delta.launches = 0


def flash_bwd(q, k, v, do, lse, delta, num_heads: int, causal: bool = False):
    """(dq, dk, dv) from the saved forward and delta, at any head dim the
    kernels take; past 256 through flash_bwd_wide."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, num_heads, causal)
    d = _head_dim(q, num_heads)
    if wide_head_dim(d):
        return flash_bwd_wide(q, k, v, do, lse, delta, num_heads, causal)
    b, s, h = _check_cuda("flash_bwd", num_heads, d, q, k, v, do)
    _check_rows("flash_bwd lse", lse, b, h, s, q.device)
    _check_rows("flash_bwd delta", delta, b, h, s, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("ff_flash_bwd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            b, s, h, int(causal), _stream(q))
    flash_bwd.launches += 1
    return dq, dk, dv


flash_bwd.launches = 0


def flash_fwd_wide(q, k, v, num_heads: int, causal: bool = False):
    """flash_fwd at a head dim past 256: the wide forward kernel."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, num_heads, causal)
    d = _head_dim(q, num_heads)
    _check_wide("flash_fwd_wide", d)
    b, s, h = _check_cuda("flash_fwd_wide", num_heads, d, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch_wide("ff_flash_wide_fwd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), b, s, h, int(causal), _stream(q))
    flash_fwd_wide.launches += 1
    return o, lse


flash_fwd_wide.launches = 0


def flash_delta_wide(do, o, num_heads: int):
    """flash_delta at a head dim past 256: delta_body's wide instance."""
    if do.device.type == "cpu":
        return flash_delta_plain(do, o, num_heads)
    d = _head_dim(do, num_heads)
    _check_wide("flash_delta_wide", d)
    b, s, h = _check_cuda("flash_delta_wide", num_heads, d, do, o)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    _launch_wide("ff_flash_wide_delta", d, do.data_ptr(), o.data_ptr(), delta.data_ptr(), b, s, h,
                 _stream(do))
    flash_delta_wide.launches += 1
    return delta


flash_delta_wide.launches = 0


def flash_bwd_wide(q, k, v, do, lse, delta, num_heads: int, causal: bool = False):
    """flash_bwd at a head dim past 256: the wide dK/dV and dQ kernels."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, do, lse, delta, num_heads, causal)
    d = _head_dim(q, num_heads)
    _check_wide("flash_bwd_wide", d)
    b, s, h = _check_cuda("flash_bwd_wide", num_heads, d, q, k, v, do)
    _check_rows("flash_bwd_wide lse", lse, b, h, s, q.device)
    _check_rows("flash_bwd_wide delta", delta, b, h, s, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_wide("ff_flash_wide_bwd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, s, h, int(causal), _stream(q))
    flash_bwd_wide.launches += 1
    return dq, dk, dv


flash_bwd_wide.launches = 0


def flash_fwd_d64(q, k, v, num_heads: int, causal: bool = False):
    """(o [b, s, h*64] contiguous, lse) from q, k, v given as lane-group
    views [b, s, h/2, 128] (`lane_groups` or `qkv_views`)."""
    if q.device.type == "cpu":
        return flash_fwd_plain(*map(_ungroup, (q, k, v)), num_heads, causal)
    ld, group = _check_groups("flash_fwd_d64", num_heads, q, k, v)
    b, s = q.shape[:2]
    o = torch.empty((b, s, num_heads * 64), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, num_heads, s), dtype=torch.float32, device=q.device)
    _launch("ff_flash_fwd_d64", q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, group,
            o.data_ptr(), lse.data_ptr(), b, s, num_heads, int(causal), _stream(q))
    flash_fwd_d64.launches += 1
    return o, lse


flash_fwd_d64.launches = 0


def flash_delta_d64(do, o, num_heads: int):
    """delta [b, h, s] f32 = rowsum(dO * O) per head of contiguous
    [b, s, h*64] operands."""
    if do.device.type == "cpu":
        return flash_delta_plain(do, o, num_heads)
    b, s, h = _check_cuda("flash_delta_d64", num_heads, 64, do, o)
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    _launch("ff_flash_delta_d64", do.data_ptr(), o.data_ptr(), delta.data_ptr(), b, s, h,
            _stream(do))
    flash_delta_d64.launches += 1
    return delta


flash_delta_d64.launches = 0


def flash_bwd_d64(q, k, v, do, lse, delta, dq, dk, dv, num_heads: int, causal: bool = False):
    """Write the gradients of the saved forward into dq, dk and dv, which,
    like q, k and v, are lane-group views [b, s, h/2, 128] of the caller's
    buffers; do is a contiguous [b, s, h*64]."""
    if q.device.type == "cpu":
        grads = flash_bwd_plain(*map(_ungroup, (q, k, v)), do, lse, delta, num_heads, causal)
        for out, g in zip((dq, dk, dv), grads):
            out.copy_(lane_groups(g))
        return
    ld, group = _check_groups("flash_bwd_d64", num_heads, q, k, v)
    grad_ld, grad_group = _check_groups("flash_bwd_d64 gradients", num_heads, dq, dk, dv)
    b, s, h = _check_cuda("flash_bwd_d64 do", num_heads, 64, do)
    if q.shape[:2] != (b, s) or do.device != q.device:
        raise ValueError(f"flash_bwd_d64: do {tuple(do.shape)} does not match q {tuple(q.shape)}")
    _check_rows("flash_bwd_d64 lse", lse, b, h, s, q.device)
    _check_rows("flash_bwd_d64 delta", delta, b, h, s, q.device)
    _launch("ff_flash_bwd_d64", q.data_ptr(), k.data_ptr(), v.data_ptr(), ld, group,
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), grad_ld, grad_group, b, s, h, int(causal), _stream(q))
    flash_bwd_d64.launches += 1


flash_bwd_d64.launches = 0


def _strides(t: torch.Tensor) -> Tuple[int, int, int]:
    """(row, head, batch) strides of a [b, h, s, d] tensor."""
    return t.stride(2), t.stride(1), t.stride(0)


def flash_fwd_bhsd(q, k, v, causal: bool = False):
    """(o, lse [b, h, s] f32) of softmax(q k^T / sqrt(d)) v on per-head
    [b, h, s, d] operands sharing one set of strides; o takes q's."""
    if q.device.type == "cpu":
        return flash_fwd_bhsd_plain(q, k, v, causal)
    b, h, s, d = q.shape
    if wide_head_dim(d):
        return flash_fwd_bhsd_wide(q, k, v, causal)
    layout = _check_bhsd("flash_fwd_bhsd", q.shape, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch("ff_flash_fwd_bhsd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), *layout,
            o.data_ptr(), *_strides(o), lse.data_ptr(), b, s, h, int(causal), _stream(q))
    flash_fwd_bhsd.launches += 1
    return o, lse


flash_fwd_bhsd.launches = 0


def flash_delta_bhsd(do, o):
    """delta [b, h, s] f32 = rowsum(dO * O) of per-head [b, h, s, d]
    operands, each read by its own strides."""
    if do.device.type == "cpu":
        return flash_delta_bhsd_plain(do, o)
    b, h, s, d = do.shape
    if wide_head_dim(d):
        return flash_delta_bhsd_wide(do, o)
    do_layout = _check_bhsd("flash_delta_bhsd do", do.shape, do)
    o_layout = _check_bhsd("flash_delta_bhsd o", do.shape, o)
    if o.device != do.device:
        raise ValueError(f"flash_delta_bhsd: do on {do.device}, o on {o.device}")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    _launch("ff_flash_delta_bhsd", d, do.data_ptr(), *do_layout, o.data_ptr(), *o_layout,
            delta.data_ptr(), b, s, h, _stream(do))
    flash_delta_bhsd.launches += 1
    return delta


flash_delta_bhsd.launches = 0


def flash_bwd_bhsd(q, k, v, do, lse, delta, causal: bool = False):
    """(dq, dk, dv), each with its operand's strides, from the saved
    forward and delta; q, k and v share one set of strides, do has its
    own."""
    if q.device.type == "cpu":
        return flash_bwd_bhsd_plain(q, k, v, do, lse, delta, causal)
    b, h, s, d = q.shape
    if wide_head_dim(d):
        return flash_bwd_bhsd_wide(q, k, v, do, lse, delta, causal)
    layout = _check_bhsd("flash_bwd_bhsd", q.shape, q, k, v)
    do_layout = _check_bhsd("flash_bwd_bhsd do", q.shape, do)
    if do.device != q.device:
        raise ValueError(f"flash_bwd_bhsd: do on {do.device}, q on {q.device}")
    _check_rows("flash_bwd_bhsd lse", lse, b, h, s, q.device)
    _check_rows("flash_bwd_bhsd delta", delta, b, h, s, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch("ff_flash_bwd_bhsd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), *layout,
            do.data_ptr(), *do_layout, lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), *_strides(dq), b, s, h, int(causal), _stream(q))
    flash_bwd_bhsd.launches += 1
    return dq, dk, dv


flash_bwd_bhsd.launches = 0


def flash_fwd_bhsd_wide(q, k, v, causal: bool = False):
    """flash_fwd_bhsd at a head dim past 256: the wide forward kernel."""
    if q.device.type == "cpu":
        return flash_fwd_bhsd_plain(q, k, v, causal)
    b, h, s, d = q.shape
    _check_wide("flash_fwd_bhsd_wide", d)
    layout = _check_bhsd("flash_fwd_bhsd_wide", q.shape, q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    _launch_wide("ff_flash_wide_fwd_bhsd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), *layout,
                 o.data_ptr(), *_strides(o), lse.data_ptr(), b, s, h, int(causal), _stream(q))
    flash_fwd_bhsd_wide.launches += 1
    return o, lse


flash_fwd_bhsd_wide.launches = 0


def flash_delta_bhsd_wide(do, o):
    """flash_delta_bhsd at a head dim past 256: delta_body's wide instance."""
    if do.device.type == "cpu":
        return flash_delta_bhsd_plain(do, o)
    b, h, s, d = do.shape
    _check_wide("flash_delta_bhsd_wide", d)
    do_layout = _check_bhsd("flash_delta_bhsd_wide do", do.shape, do)
    o_layout = _check_bhsd("flash_delta_bhsd_wide o", do.shape, o)
    if o.device != do.device:
        raise ValueError(f"flash_delta_bhsd_wide: do on {do.device}, o on {o.device}")
    delta = torch.empty((b, h, s), dtype=torch.float32, device=do.device)
    _launch_wide("ff_flash_wide_delta_bhsd", d, do.data_ptr(), *do_layout, o.data_ptr(),
                 *o_layout, delta.data_ptr(), b, s, h, _stream(do))
    flash_delta_bhsd_wide.launches += 1
    return delta


flash_delta_bhsd_wide.launches = 0


def flash_bwd_bhsd_wide(q, k, v, do, lse, delta, causal: bool = False):
    """flash_bwd_bhsd at a head dim past 256: the wide dK/dV and dQ kernels."""
    if q.device.type == "cpu":
        return flash_bwd_bhsd_plain(q, k, v, do, lse, delta, causal)
    b, h, s, d = q.shape
    _check_wide("flash_bwd_bhsd_wide", d)
    layout = _check_bhsd("flash_bwd_bhsd_wide", q.shape, q, k, v)
    do_layout = _check_bhsd("flash_bwd_bhsd_wide do", q.shape, do)
    if do.device != q.device:
        raise ValueError(f"flash_bwd_bhsd_wide: do on {do.device}, q on {q.device}")
    _check_rows("flash_bwd_bhsd_wide lse", lse, b, h, s, q.device)
    _check_rows("flash_bwd_bhsd_wide delta", delta, b, h, s, q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    _launch_wide("ff_flash_wide_bwd_bhsd", d, q.data_ptr(), k.data_ptr(), v.data_ptr(), *layout,
                 do.data_ptr(), *do_layout, lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
                 dk.data_ptr(), dv.data_ptr(), *_strides(dq), b, s, h, int(causal), _stream(q))
    flash_bwd_bhsd_wide.launches += 1
    return dq, dk, dv


flash_bwd_bhsd_wide.launches = 0

# Every kernel wrapper of the port, each with its launch count: these, and
# the ring-flash step wrappers, which kernels/ring_flash.py registers.
KERNEL_WRAPPERS = (flash_fwd, flash_delta, flash_bwd, flash_fwd_d64, flash_delta_d64, flash_bwd_d64,
                   flash_fwd_bhsd, flash_delta_bhsd, flash_bwd_bhsd, flash_fwd_wide,
                   flash_delta_wide, flash_bwd_wide, flash_fwd_bhsd_wide, flash_delta_bhsd_wide,
                   flash_bwd_bhsd_wide)


def register_wrappers(*fns) -> None:
    global KERNEL_WRAPPERS
    KERNEL_WRAPPERS += fns


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS:
        fn.launches = 0


# -- autograd ---------------------------------------------------------------


def _pairs_heads(d: int, num_heads: int) -> bool:
    """Does the d=64 head pair (two heads to a 128-lane group) take these heads?"""
    return d == 64 and num_heads % 2 == 0


class FlashAttentionBSHF(torch.autograd.Function):
    """Attention on separate [b, s, h*d] operands (any head dim the kernels
    take) whose gradient runs the delta and backward kernels: the d=64 head
    pair's at d=64 with an even head count, flash_fwd, flash_delta and
    flash_bwd otherwise. The forward saves (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, num_heads: int, causal: bool = False):
        d = q.shape[-1] // num_heads
        if not _pairs_heads(d, num_heads):
            o, lse = flash_fwd(q, k, v, num_heads, causal)
        else:
            o, lse = flash_fwd_d64(*map(lane_groups, (q, k, v)), num_heads, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.num_heads, ctx.causal = num_heads, causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        h, causal = ctx.num_heads, ctx.causal
        do = do.contiguous()
        d = q.shape[-1] // h
        if not _pairs_heads(d, h):
            delta = flash_delta(do, o, h)
            dq, dk, dv = flash_bwd(q, k, v, do, lse, delta, h, causal)
        else:
            delta = flash_delta_d64(do, o, h)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            flash_bwd_d64(*map(lane_groups, (q, k, v)), do, lse, delta,
                          *map(lane_groups, (dq, dk, dv)), h, causal)
        return dq, dk, dv, None, None


class FlashAttentionQKV(torch.autograd.Function):
    """Attention (d = 64) on one interleaved [b, s, 3f] projection; the
    backward returns one dqkv in the same interleave (counterpart of the JAX
    package's _flash_bshf_qkv). The forward saves (qkv, o, lse)."""

    @staticmethod
    def forward(ctx, qkv, num_heads: int, causal: bool = False):
        o, lse = flash_fwd_d64(*qkv_views(qkv), num_heads, causal)
        ctx.save_for_backward(qkv, o, lse)
        ctx.num_heads, ctx.causal = num_heads, causal
        return o

    @staticmethod
    def backward(ctx, do):
        qkv, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = flash_delta_d64(do, o, ctx.num_heads)
        dqkv = torch.empty_like(qkv)
        flash_bwd_d64(*qkv_views(qkv), do, lse, delta, *qkv_views(dqkv), ctx.num_heads,
                      ctx.causal)
        return dqkv, None, None


def flash_attention_bshf(q, k, v, num_heads: int, causal: bool = False):
    """Self-attention on seq-major [b, s, h*d] tensors; returns [b, s, h*d]."""
    return FlashAttentionBSHF.apply(q, k, v, num_heads, causal)


def flash_attention_bshf_qkv(qkv, num_heads: int, causal: bool = False):
    """Self-attention (d = 64, an even head count) on one interleaved
    [b, s, 3*h*64] projection; returns [b, s, h*64]."""
    if qkv.shape[-1] != 3 * 64 * num_heads or num_heads % 2:
        raise ValueError(f"flash_attention_bshf_qkv: takes [b, s, 3*h*64] with h even, got "
                         f"{tuple(qkv.shape)} with {num_heads} heads")
    return FlashAttentionQKV.apply(qkv, num_heads, causal)


class FlashAttentionBHSD(torch.autograd.Function):
    """Attention on per-head [b, h, s, d] operands (any head dim the kernels
    take) whose gradient runs the delta and backward kernels. On a CUDA device an
    operand the kernels cannot read in place (`bhsd_readable`), or q, k and
    v of differing strides, costs one contiguous copy. The forward saves
    (q, k, v, o, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = False):
        if q.device.type == "cuda" and not (
            all(map(bhsd_readable, (q, k, v))) and q.stride() == k.stride() == v.stride()
        ):
            q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        o, lse = flash_fwd_bhsd(q, k, v, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.causal = causal
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.device.type == "cuda" and not bhsd_readable(do):
            do = do.contiguous()
        delta = flash_delta_bhsd(do, o)
        dq, dk, dv = flash_bwd_bhsd(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False):
    """Self-attention on per-head [b, h, s, d] tensors; returns [b, h, s, d]
    (the counterpart of the JAX package's flash_attention)."""
    return FlashAttentionBHSD.apply(q, k, v, causal)


# -- data-parallel context --------------------------------------------------

_tls = threading.local()


@contextlib.contextmanager
def flash_mesh(group):
    """Declare that attention traced within runs on one rank of the
    data-parallel process group `group` (None: the default group), on the
    rank's own block of the batch: `kernels/ops.py` then routes it through
    sharded_flash_attention."""
    prev = getattr(_tls, "group", None)
    _tls.group = (group,)
    try:
        yield
    finally:
        _tls.group = prev


def current_flash_mesh():
    """The `(group,)` of the innermost flash_mesh, or None outside one."""
    return getattr(_tls, "group", None)


def sharded_flash_supported(q_shape, k_shape, v_shape, dtype: torch.dtype, device) -> bool:
    """The gate of sharded_flash_attention. Each rank already holds its
    local block of the batch, so the local shape is the shape it is given;
    the per-head kernels take it as flash_attention_supported says."""
    return flash_attention_supported(q_shape, k_shape, v_shape, dtype, device)


def sharded_flash_attention(q, k, v, causal: bool = False):
    """Attention on this rank's [b/N, h, s, d] block. Attention is parallel
    over batch and heads, so no collective is needed, as on the TPU."""
    return flash_attention(q, k, v, causal)
