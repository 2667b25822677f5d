"""Ring attention: exact sequence-parallel attention over a ring of ranks
(port of flexflow_tpu/kernels/ring_attention.py).

Each rank holds one sequence block of q, k and v; the key/value blocks
travel around the ring while an online softmax (running max, sum of
exponentials and weighted-V accumulators) keeps the result exact, never
holding the whole [s, s] score matrix on one device.

The one difference from the JAX package: a RingAttention op takes the ring
at every sequence-parallel degree, 1 included, where the JAX package falls
back to dense attention when the sequence is not sharded. A ring of one
rank is one step with no rotation and computes what the dense fallback
computes (tests/test_torch_port_sp.py holds the two against each other), so
on a single device the op still runs the ring-flash step kernels.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from flexflow_tpu_torch.kernels import ring_flash
from flexflow_tpu_torch.kernels.ops import mha_project_qkv
from flexflow_tpu_torch.kernels.ring_flash import NEG_INF, SequenceRing
from flexflow_tpu_torch.op_attrs.ops import RingAttentionAttrs


class _Rotate(torch.autograd.Function):
    """SequenceRing.rotate whose gradient rotates back."""

    @staticmethod
    def forward(ctx, x, ring: SequenceRing):
        ctx.ring = ring
        return ring.rotate(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.ring.rotate(g, reverse=True), None


def ring_attention_block(qp, kp, vp, ring: SequenceRing, causal: bool):
    """This rank's output block [b, h, s_blk, vd] of ring attention on its
    projected blocks qp [b, h, s_blk, kd], kp, vp [b, h, t_blk, {kd, vd}],
    through dense per-step scores; autograd differentiates it, rotations
    included. The accumulators stay f32 whatever the compute dtype. `calls`
    counts its runs, as kernels/ops.py's _dense_context counts its own."""
    ring_attention_block.calls += 1
    b, h, s_blk, kd = qp.shape
    t_blk = kp.shape[2]
    scale = 1.0 / math.sqrt(kd)
    o = torch.zeros((b, h, s_blk, vp.shape[3]), dtype=torch.float32, device=qp.device)
    m = torch.full((b, h, s_blk), NEG_INF, dtype=torch.float32, device=qp.device)
    l = torch.zeros((b, h, s_blk), dtype=torch.float32, device=qp.device)
    k_c, v_c = kp, vp
    for i in range(ring.size):
        src = (ring.rank - i) % ring.size
        scores = torch.einsum("bhsk,bhtk->bhst", qp.float(), k_c.float()) * scale
        if causal:
            q_pos = ring.rank * s_blk + torch.arange(s_blk, device=qp.device)
            k_pos = src * t_blk + torch.arange(t_blk, device=qp.device)
            scores = scores.masked_fill(q_pos[:, None] < k_pos[None, :], NEG_INF)
        m_new = torch.maximum(m, scores.amax(-1))
        p = torch.exp(scores - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        o = o * alpha[..., None] + torch.einsum("bhst,bhtv->bhsv", p.to(v_c.dtype).float(),
                                                v_c.float())
        m = m_new
        if i + 1 < ring.size:
            k_c, v_c = _Rotate.apply(k_c, ring), _Rotate.apply(v_c, ring)
    return (o / l[..., None]).to(qp.dtype)


ring_attention_block.calls = 0


def ring_mha_forward(attrs: RingAttentionAttrs, q, k, v, weight, ring: Optional[SequenceRing] = None,
                     input_bias=None, output_bias=None):
    """RingAttention of this rank's blocks q, k, v ([b, s_blk, e]) over the
    ring (None: a ring of one; module note: there is no dense fallback).
    Each rank already holds its own blocks, so the JAX package's shard_map
    plumbing reduces to this per-rank body: the projections, ring attention
    (the ring-flash steps where ring_flash_supported takes the blocks, else
    the dense ring) and the output projection."""
    if (input_bias is None) != (output_bias is None):
        raise ValueError("MHA bias weights come in (input, output) pairs")
    ring = ring if ring is not None else SequenceRing()
    qp, kp, vp, wo = mha_project_qkv(attrs, q, k, v, weight, input_bias)
    if ring_flash.ring_flash_supported(qp.shape, kp.shape, vp.shape, qp.dtype, qp.device):
        ctx = ring_flash.ring_flash_attention_block(qp, kp, vp, ring, attrs.causal)
    else:
        ctx = ring_attention_block(qp, kp, vp, ring, attrs.causal)
    out = torch.einsum("bhsv,veh->bse", ctx, wo)
    return out if output_bias is None else out + output_bias
