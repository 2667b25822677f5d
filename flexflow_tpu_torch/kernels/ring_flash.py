"""Flash-streaming ring attention: one rank of a sequence-parallel ring
carries the online-softmax state (acc, m, l) of its query block across ring
steps while the key/value blocks travel around the ring (port of
flexflow_tpu/kernels/ring_flash.py).

Replaces the Pallas kernels of that module:

- ring_fwd_step <- _ring_fwd_step_kernel via _ring_fwd_step
- ring_dq_step  <- _ring_dq_step_kernel via _ring_dq_step
- ring_dkv_step <- _ring_dkv_step_kernel via _ring_dkv_step

each a hand-written CUDA kernel in csrc/ring_flash.cu (whose note says what
bounds it on the card) beside a plain PyTorch version, and past head dim
256 ring_fwd_step_wide, ring_dq_step_wide and ring_dkv_step_wide, the wide
step kernels of csrc/flash_wide.cu. A wrapper runs its plain version for
tensors on the CPU, and launches its kernel for tensors on a CUDA device,
or raises. The kernels take bf16 per-head [b, h, rows, d] operands by their
strides (any head dim d with d % 8 == 0: up to 256 at the padded width of
kernels/flash_attention.py's `padded_dim`, past it in 256-column chunks;
rows a multiple of 64) and f32 contiguous state; `ring_flash_supported` is
the gate.

The wide forward step reads the carried (m, l) from one pair of buffers and
writes them to another: each of a row tile's column chunks runs in a block
of its own and rescales its acc columns by the old m, so an update in place
would race. The ring's driver ping-pongs the pair (`_fwd_step`);
ring_fwd_step keeps its in-place contract at every head dim by copying the
new pair back.

Where the JAX package returns fresh per-step dq, dk and dv and adds them in
XLA, the port's dq and dk/dv steps add into the caller's f32 accumulators in
place: one block owns each row, so the add costs no atomics and no extra
pass. Masked entries contribute p = 0 outright, so a row that sees no key
in a step keeps its state, whatever the tiling.

The driver (`_RingFlash`, the counterpart of the JAX package's `_ring_flash`
custom VJP) runs the ring: the forward folds one key/value block per step
into the state and rotates the block to the next rank; the backward replays
the ring with the delta kernel of kernels/flash_attention.py, the dq and dk/dv
steps, and dk/dv accumulators that travel with their key/value block, so
after the full cycle every block's gradient is home holding every shard's
contribution. A ring of one rank is one step with no rotation.

lse and m are kept in natural log; the TPU kernels keep them in base 2,
which is the natural value times log2(e).
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels.flash_attention import (
    HEAD_DIM_STEP,
    NARROW_MAX,
    TILE,
    _dtype_ok,
    _launch_wide,
    _stream,
    bhsd_readable,
    flash_delta_bhsd,
    head_dim_supported,
    register_wrappers,
    wide_head_dim,
)

NEG_INF = -1e30
_SOURCE = "ring_flash.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
_OPERAND = [_P, _I, _I, _I]  # pointer, then row, head and batch strides
_SIGNATURES = {
    "ff_ring_fwd_step": ([_I] + 3 * _OPERAND + [_P, _P, _P] + 7 * [_I] + [_P], _I),
    "ff_ring_dq_step": ([_I] + 4 * _OPERAND + [_P, _P, _P] + 7 * [_I] + [_P], _I),
    "ff_ring_dkv_step": ([_I] + 4 * _OPERAND + [_P, _P, _P, _P] + 7 * [_I] + [_P], _I),
    "ff_error_string": ([_I], ctypes.c_char_p),
}


def library() -> ctypes.CDLL:
    """The ring kernels' library, built at first use."""
    return build.load(_SOURCE, _SIGNATURES)


def _operand(t: torch.Tensor):
    """A per-head operand as the kernels take it: pointer, row, head and
    batch strides."""
    return t.data_ptr(), t.stride(2), t.stride(1), t.stride(0)


def _check_operands(name: str, q, k, v, do=None, wide: bool = False) -> None:
    """Raise unless q (and do) are bf16 [b, h, S, d] and k, v bf16 [b, h, T, d]
    on one CUDA device, readable in place, with d a head dim the kernels
    take (head_dim_supported; `wide` kernels: past 256, else up to it) and
    S, T multiples of the tile."""
    b, h, s, d = q.shape
    t = k.shape[2]
    if not head_dim_supported(d) or wide_head_dim(d) != wide or s % TILE or t % TILE:
        span = f"past {NARROW_MAX}" if wide else f"up to {NARROW_MAX}"
        raise ValueError(f"{name}: kernel takes d % {HEAD_DIM_STEP} == 0 {span} and blocks a "
                         f"multiple of {TILE} rows, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    dev = q.device
    named = [("q", q, s), ("k", k, t), ("v", v, t)] + ([("do", do, s)] if do is not None else [])
    for label, x, rows in named:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name}: tensors must lie on the CPU or a CUDA device, got "
                             f"{label} on {x.device}")
        if tuple(x.shape) != (b, h, rows, d) or x.dtype != torch.bfloat16:
            raise ValueError(f"{name}: {label} must be bf16 {(b, h, rows, d)}, got {x.dtype} "
                             f"{tuple(x.shape)}")
        if not bhsd_readable(x):
            raise ValueError(f"{name}: {label} must have unit stride along d, the other strides "
                             f"multiples of 8 and a 16-byte aligned start, got {x.stride()}")


def _check_f32(name: str, t: torch.Tensor, shape, dev) -> None:
    """Raise unless `t` is a contiguous f32 of `shape` on `dev` whose start
    is 32-byte aligned: the dK/dV step bulk-copies lse and delta in 64-row
    pieces, which needs 16 bytes, and the kernels read and write the state
    and accumulator rows as float2."""
    if (tuple(t.shape) != tuple(shape) or t.dtype != torch.float32 or t.device != dev
            or not t.is_contiguous() or t.data_ptr() % 32):
        raise ValueError(f"{name}: expected a contiguous, 32-byte aligned f32 {tuple(shape)} on "
                         f"{dev}, got {t.dtype} {tuple(t.shape)} on {t.device}")


def _scores(q, k, q_off: int, k_off: int, causal: bool):
    """(scale * q k^T in f32 with masked entries NEG_INF, the [S, T] mask or
    None) of one batch entry: q [h, S, d], k [h, T, d]. The causal mask lets
    global row q_off + i attend global key k_off + j where i + q_off >=
    j + k_off."""
    s = (q.float() @ k.float().transpose(-1, -2)) * (1.0 / math.sqrt(q.shape[-1]))
    if not causal:
        return s, None
    rows = q_off + torch.arange(s.shape[1], device=s.device)
    cols = k_off + torch.arange(s.shape[2], device=s.device)
    mask = rows[:, None] >= cols[None, :]
    return s.masked_fill(~mask, NEG_INF), mask


def _probs(s, mask, rowmax):
    """exp(s - rowmax) with masked entries 0."""
    p = torch.exp(s - rowmax[..., None])
    return p if mask is None else p.masked_fill(~mask, 0.0)


# -- plain versions ---------------------------------------------------------
# In f32, one batch entry at a time (a [h, S, T] score block each).


def ring_fwd_step_plain(q, k, v, acc, m, l, q_off: int, k_off: int, causal: bool = False):
    """Fold the keys of block [k_off, k_off + T) into the online-softmax
    state (acc [b, h, S, d], m, l [b, h, S]; f32) of the queries
    [q_off, q_off + S), in place."""
    for i in range(q.shape[0]):
        s, mask = _scores(q[i], k[i], q_off, k_off, causal)
        m_new = torch.maximum(m[i], s.amax(-1))
        p = _probs(s, mask, m_new)
        alpha = torch.exp(m[i] - m_new)
        l[i].mul_(alpha).add_(p.sum(-1))
        acc[i].mul_(alpha[..., None]).add_(p @ v[i].float())
        m[i].copy_(m_new)


def _ds(q, k, v, do, lse, delta, q_off, k_off, causal):
    """(P, dS) of one batch entry in f32, P rebuilt from lse and
    dS = P * (dO V^T - delta) * scale."""
    s, mask = _scores(q, k, q_off, k_off, causal)
    p = _probs(s, mask, lse)
    dp = do.float() @ v.float().transpose(-1, -2)
    return p, p * (dp - delta[..., None]) * (1.0 / math.sqrt(q.shape[-1]))


def ring_dq_step_plain(q, k, v, do, lse, delta, dq, q_off: int, k_off: int, causal: bool = False):
    """Add this step's dQ (of the keys [k_off, k_off + T)) into dq
    [b, h, S, d] f32, in place."""
    for i in range(q.shape[0]):
        _, ds = _ds(q[i], k[i], v[i], do[i], lse[i], delta[i], q_off, k_off, causal)
        dq[i].add_(ds @ k[i].float())


def ring_dkv_step_plain(q, k, v, do, lse, delta, dk, dv, q_off: int, k_off: int,
                        causal: bool = False):
    """Add this step's dK and dV (from the queries [q_off, q_off + S)) into
    dk, dv [b, h, T, d] f32, in place."""
    for i in range(q.shape[0]):
        p, ds = _ds(q[i], k[i], v[i], do[i], lse[i], delta[i], q_off, k_off, causal)
        dv[i].add_(p.transpose(-1, -2) @ do[i].float())
        dk[i].add_(ds.transpose(-1, -2) @ q[i].float())


# -- wrappers ---------------------------------------------------------------


def ring_fwd_step(q, k, v, acc, m, l, q_off: int, k_off: int, causal: bool = False):
    """One ring step of the flash forward, in place on (acc, m, l); see
    ring_fwd_step_plain."""
    if q.device.type == "cpu":
        return ring_fwd_step_plain(q, k, v, acc, m, l, q_off, k_off, causal)
    b, h, s, d = q.shape
    if wide_head_dim(d):
        # the wide step writes the new (m, l) elsewhere: copy them back
        m_out, l_out = torch.empty_like(m), torch.empty_like(l)
        ring_fwd_step_wide(q, k, v, acc, m, l, m_out, l_out, q_off, k_off, causal)
        m.copy_(m_out)
        l.copy_(l_out)
        return
    _check_operands("ring_fwd_step", q, k, v)
    _check_f32("ring_fwd_step acc", acc, (b, h, s, d), q.device)
    _check_f32("ring_fwd_step m", m, (b, h, s), q.device)
    _check_f32("ring_fwd_step l", l, (b, h, s), q.device)
    build.launch(library(), "ff_ring_fwd_step", d, *_operand(q), *_operand(k), *_operand(v),
                 acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, s, k.shape[2], h, q_off, k_off,
                 int(causal), _stream(q))
    ring_fwd_step.launches += 1


ring_fwd_step.launches = 0


def ring_dq_step(q, k, v, do, lse, delta, dq, q_off: int, k_off: int, causal: bool = False):
    """One ring step of dQ, added into dq in place; see ring_dq_step_plain."""
    if q.device.type == "cpu":
        return ring_dq_step_plain(q, k, v, do, lse, delta, dq, q_off, k_off, causal)
    b, h, s, d = q.shape
    if wide_head_dim(d):
        return ring_dq_step_wide(q, k, v, do, lse, delta, dq, q_off, k_off, causal)
    _check_operands("ring_dq_step", q, k, v, do)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_f32(f"ring_dq_step {name}", t, (b, h, s), q.device)
    _check_f32("ring_dq_step dq", dq, (b, h, s, d), q.device)
    build.launch(library(), "ff_ring_dq_step", d, *_operand(q), *_operand(k), *_operand(v),
                 *_operand(do), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s, k.shape[2],
                 h, q_off, k_off, int(causal), _stream(q))
    ring_dq_step.launches += 1


ring_dq_step.launches = 0


def ring_dkv_step(q, k, v, do, lse, delta, dk, dv, q_off: int, k_off: int, causal: bool = False):
    """One ring step of dK and dV, added into dk and dv in place; see
    ring_dkv_step_plain."""
    if q.device.type == "cpu":
        return ring_dkv_step_plain(q, k, v, do, lse, delta, dk, dv, q_off, k_off, causal)
    b, h, s, d = q.shape
    if wide_head_dim(d):
        return ring_dkv_step_wide(q, k, v, do, lse, delta, dk, dv, q_off, k_off, causal)
    t = k.shape[2]
    _check_operands("ring_dkv_step", q, k, v, do)
    for name, x in (("lse", lse), ("delta", delta)):
        _check_f32(f"ring_dkv_step {name}", x, (b, h, s), q.device)
    for name, x in (("dk", dk), ("dv", dv)):
        _check_f32(f"ring_dkv_step {name}", x, (b, h, t, d), q.device)
    build.launch(library(), "ff_ring_dkv_step", d, *_operand(q), *_operand(k), *_operand(v),
                 *_operand(do), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, s, t, h, q_off, k_off, int(causal), _stream(q))
    ring_dkv_step.launches += 1


ring_dkv_step.launches = 0


def ring_fwd_step_wide(q, k, v, acc, m, l, m_out, l_out, q_off: int, k_off: int,
                       causal: bool = False):
    """One ring step of the flash forward at a head dim past 256: acc in
    place, the carried (m, l) read from m, l and written to m_out, l_out
    (which must be other buffers); see ring_fwd_step_plain."""
    if q.device.type == "cpu":
        m_out.copy_(m)
        l_out.copy_(l)
        return ring_fwd_step_plain(q, k, v, acc, m_out, l_out, q_off, k_off, causal)
    b, h, s, d = q.shape
    _check_operands("ring_fwd_step_wide", q, k, v, wide=True)
    _check_f32("ring_fwd_step_wide acc", acc, (b, h, s, d), q.device)
    for name, x in (("m", m), ("l", l), ("m_out", m_out), ("l_out", l_out)):
        _check_f32(f"ring_fwd_step_wide {name}", x, (b, h, s), q.device)
    if {m_out.data_ptr(), l_out.data_ptr()} & {m.data_ptr(), l.data_ptr()}:
        raise ValueError("ring_fwd_step_wide: m_out and l_out must be other buffers than m and l")
    _launch_wide("ff_ring_wide_fwd_step", d, *_operand(q), *_operand(k), *_operand(v),
                 acc.data_ptr(), m.data_ptr(), l.data_ptr(), m_out.data_ptr(), l_out.data_ptr(),
                 b, s, k.shape[2], h, q_off, k_off, int(causal), _stream(q))
    ring_fwd_step_wide.launches += 1


ring_fwd_step_wide.launches = 0


def ring_dq_step_wide(q, k, v, do, lse, delta, dq, q_off: int, k_off: int,
                      causal: bool = False):
    """ring_dq_step at a head dim past 256: the wide dQ step kernel."""
    if q.device.type == "cpu":
        return ring_dq_step_plain(q, k, v, do, lse, delta, dq, q_off, k_off, causal)
    b, h, s, d = q.shape
    _check_operands("ring_dq_step_wide", q, k, v, do, wide=True)
    for name, t in (("lse", lse), ("delta", delta)):
        _check_f32(f"ring_dq_step_wide {name}", t, (b, h, s), q.device)
    _check_f32("ring_dq_step_wide dq", dq, (b, h, s, d), q.device)
    _launch_wide("ff_ring_wide_dq_step", d, *_operand(q), *_operand(k), *_operand(v),
                 *_operand(do), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, s,
                 k.shape[2], h, q_off, k_off, int(causal), _stream(q))
    ring_dq_step_wide.launches += 1


ring_dq_step_wide.launches = 0


def ring_dkv_step_wide(q, k, v, do, lse, delta, dk, dv, q_off: int, k_off: int,
                       causal: bool = False):
    """ring_dkv_step at a head dim past 256: the wide dK/dV step kernel."""
    if q.device.type == "cpu":
        return ring_dkv_step_plain(q, k, v, do, lse, delta, dk, dv, q_off, k_off, causal)
    b, h, s, d = q.shape
    t = k.shape[2]
    _check_operands("ring_dkv_step_wide", q, k, v, do, wide=True)
    for name, x in (("lse", lse), ("delta", delta)):
        _check_f32(f"ring_dkv_step_wide {name}", x, (b, h, s), q.device)
    for name, x in (("dk", dk), ("dv", dv)):
        _check_f32(f"ring_dkv_step_wide {name}", x, (b, h, t, d), q.device)
    _launch_wide("ff_ring_wide_dkv_step", d, *_operand(q), *_operand(k), *_operand(v),
                 *_operand(do), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 b, s, t, h, q_off, k_off, int(causal), _stream(q))
    ring_dkv_step_wide.launches += 1


ring_dkv_step_wide.launches = 0

register_wrappers(ring_fwd_step, ring_dq_step, ring_dkv_step, ring_fwd_step_wide,
                  ring_dq_step_wide, ring_dkv_step_wide)


def _fwd_step(q, k, v, acc, state, spare, q_off: int, k_off: int, causal: bool):
    """One forward step of the ring's driver on the carried (acc, state =
    (m, l)): in place up to head dim 256; past it the wide step writes the
    new (m, l) into `spare` and the two pairs swap. Returns (state, spare)."""
    if spare is None:
        ring_fwd_step(q, k, v, acc, *state, q_off, k_off, causal)
        return state, spare
    ring_fwd_step_wide(q, k, v, acc, *state, *spare, q_off, k_off, causal)
    return spare, state


def _spare(d: int, m, l):
    """The second (m, l) pair of a ring's forward at head dim d past 256,
    else None."""
    return (torch.empty_like(m), torch.empty_like(l)) if wide_head_dim(d) else None


def ring_flash_supported(qp_shape, kp_shape, vp_shape, dtype: torch.dtype, device) -> bool:
    """Can the ring steps take these per-rank [b, h, rows, d] blocks? The
    kernels need k and v of one shape, the head dim of q, a head dim
    head_dim_supported admits (d % 8 == 0, d >= 8) and blocks a multiple of
    the 64-row tile, in bf16; the plain versions take the same shapes in
    any float dtype on the CPU."""
    qp_shape, kp_shape = tuple(qp_shape), tuple(kp_shape)
    if len(qp_shape) != 4 or len(kp_shape) != 4 or tuple(vp_shape) != kp_shape:
        return False
    b, h, s_blk, d = qp_shape
    if kp_shape[:2] != (b, h) or kp_shape[3] != d:
        return False
    if not head_dim_supported(d) or s_blk % TILE or kp_shape[2] % TILE:
        return False
    return _dtype_ok(dtype, device)


# -- the ring ---------------------------------------------------------------


@dataclass(frozen=True)
class SequenceRing:
    """The ranks that hold consecutive blocks of one sequence: this rank is
    `rank` of `size`, over the process group `group` (None for a ring of
    one). `peers`: the global ranks in ring order, where they are not the
    group's own rank order."""

    size: int = 1
    rank: int = 0
    group: Optional[object] = None
    peers: Optional[Tuple[int, ...]] = None

    def _peer(self, ring_rank: int) -> int:
        r = ring_rank % self.size
        if self.peers is not None:
            return self.peers[r]
        return r if self.group is None else dist.get_global_rank(self.group, r)

    def rotate(self, x: torch.Tensor, reverse: bool = False) -> torch.Tensor:
        """Send x to the next rank and return what the previous one sent
        (the other way round with `reverse`). The identity on a ring of
        one, with no collective."""
        if self.size == 1:
            return x
        step = -1 if reverse else 1
        x = x.contiguous()
        out = torch.empty_like(x)
        from flexflow_tpu_torch.parallel import census

        census.note("collective-permute", census.tensor_bytes(x), 2)
        ops = [dist.P2POp(dist.isend, x, self._peer(self.rank + step), self.group),
               dist.P2POp(dist.irecv, out, self._peer(self.rank - step), self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out


def _next_kv(ring: SequenceRing, kv, k, v):
    """The key/value block of the next step: the rotated pair. The first
    rotation packs k and v into one contiguous buffer (the einsum's views
    cannot be sent as they are); later ones send that buffer on."""
    kv = ring.rotate(torch.stack((k, v)) if kv is None else kv)
    return kv, kv[0], kv[1]


def _ring_flash_fwd_impl(qp, kp, vp, ring: SequenceRing, causal: bool):
    """(o [b, h, S, d] in qp's dtype, lse [b, h, S] f32) of this rank's
    query block against every rank's key/value block."""
    b, h, s_blk, d = qp.shape
    t_blk = kp.shape[2]
    acc = torch.zeros((b, h, s_blk, d), dtype=torch.float32, device=qp.device)
    m = torch.full((b, h, s_blk), NEG_INF, dtype=torch.float32, device=qp.device)
    l = torch.zeros((b, h, s_blk), dtype=torch.float32, device=qp.device)
    state, spare = (m, l), _spare(d, m, l)
    q_off = ring.rank * s_blk
    kv, k_c, v_c = None, kp, vp
    for i in range(ring.size):
        src = (ring.rank - i) % ring.size
        state, spare = _fwd_step(qp, k_c, v_c, acc, state, spare, q_off, src * t_blk, causal)
        if i + 1 < ring.size:
            kv, k_c, v_c = _next_kv(ring, kv, k_c, v_c)
    m, l = state
    o = (acc / l[..., None]).to(qp.dtype)
    return o, m + torch.log(l)


def _ring_flash_bwd(ring: SequenceRing, causal: bool, qp, kp, vp, o, lse, do):
    """(dq, dk, dv) of this rank's blocks, in their dtypes."""
    if do.device.type == "cuda" and not bhsd_readable(do):
        do = do.contiguous()
    delta = flash_delta_bhsd(do, o)
    b, h, s_blk, d = qp.shape
    t_blk = kp.shape[2]
    q_off = ring.rank * s_blk
    dq = torch.zeros((b, h, s_blk, d), dtype=torch.float32, device=qp.device)
    dkv = torch.zeros((2, b, h, t_blk, d), dtype=torch.float32, device=qp.device)
    kv, k_c, v_c = None, kp, vp
    for i in range(ring.size):
        k_off = (ring.rank - i) % ring.size * t_blk
        ring_dq_step(qp, k_c, v_c, do, lse, delta, dq, q_off, k_off, causal)
        ring_dkv_step(qp, k_c, v_c, do, lse, delta, dkv[0], dkv[1], q_off, k_off, causal)
        # the accumulators travel with their key/value block, so after the
        # full cycle every block is home, holding every shard's contribution
        dkv = ring.rotate(dkv)
        if i + 1 < ring.size:
            kv, k_c, v_c = _next_kv(ring, kv, k_c, v_c)
    return dq.to(qp.dtype), dkv[0].to(kp.dtype), dkv[1].to(vp.dtype)


class _RingFlash(torch.autograd.Function):
    """Ring attention of this rank's [b, h, rows, d] blocks whose gradient
    replays the ring (counterpart of the JAX package's _ring_flash). The
    forward saves (qp, kp, vp, o, lse); every rank of the ring must run the
    forward and the backward of its layers in the same order."""

    @staticmethod
    def forward(ctx, qp, kp, vp, ring: SequenceRing, causal: bool):
        o, lse = _ring_flash_fwd_impl(qp, kp, vp, ring, causal)
        ctx.save_for_backward(qp, kp, vp, o, lse)
        ctx.ring, ctx.causal = ring, causal
        return o

    @staticmethod
    def backward(ctx, do):
        return (*_ring_flash_bwd(ctx.ring, ctx.causal, *ctx.saved_tensors, do), None, None)


def ring_flash_attention_block(qp, kp, vp, ring: SequenceRing, causal: bool):
    """This rank's context block [b, h, S, d] from its per-head blocks qp,
    kp, vp (the drop-in for kernels/ring_attention.ring_attention_block with
    flash memory behaviour)."""
    return _RingFlash.apply(qp, kp, vp, ring, causal)


def replay_ring(q, k, v, do, sp: int, causal: bool):
    """Run on one device, through the step wrappers, what a ring of `sp`
    ranks computes for whole-sequence per-head tensors q, k, v and the
    output gradient do ([b, h, S, d]): rank r holds rows
    [r*S/sp, (r+1)*S/sp), and at step i the key/value block of rank
    (r - i) % sp, at its global offset. Steps run in the ring's order, so
    each accumulator sums in the order it would on the ring. Returns
    (o, dq, dk, dv) over the whole sequence in q's dtype."""
    b, h, s, d = q.shape
    blk = s // sp
    f32 = dict(dtype=torch.float32, device=q.device)

    def shard(x, r):
        return x[:, :, r * blk:(r + 1) * blk]

    acc = [torch.zeros((b, h, blk, d), **f32) for _ in range(sp)]
    state = [(torch.full((b, h, blk), NEG_INF, **f32), torch.zeros((b, h, blk), **f32))
             for _ in range(sp)]
    spare = [_spare(d, *st) for st in state]
    for i in range(sp):
        for r in range(sp):
            src = (r - i) % sp
            state[r], spare[r] = _fwd_step(shard(q, r), shard(k, src), shard(v, src), acc[r],
                                           state[r], spare[r], r * blk, src * blk, causal)
    o = [(acc[r] / state[r][1][..., None]).to(q.dtype) for r in range(sp)]
    lse = [state[r][0] + torch.log(state[r][1]) for r in range(sp)]
    delta = [flash_delta_bhsd(shard(do, r), o[r]) for r in range(sp)]
    dq = [torch.zeros((b, h, blk, d), **f32) for _ in range(sp)]
    dk = [torch.zeros((b, h, blk, d), **f32) for _ in range(sp)]
    dv = [torch.zeros((b, h, blk, d), **f32) for _ in range(sp)]
    for i in range(sp):
        for r in range(sp):
            src = (r - i) % sp
            args = (shard(q, r), shard(k, src), shard(v, src), shard(do, r), lse[r], delta[r])
            ring_dq_step(*args, dq[r], r * blk, src * blk, causal)
            ring_dkv_step(*args, dk[src], dv[src], r * blk, src * blk, causal)
    return tuple(torch.cat(x, dim=2).to(q.dtype) for x in (o, dq, dk, dv))

