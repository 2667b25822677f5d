"""Ulysses (all-to-all) sequence-parallel attention (port of
flexflow_tpu/kernels/ulysses_attention.py).

Each rank projects q, k and v of its sequence block for its local heads
([b, h_loc, s_blk, d]), all-to-alls heads for sequence, so that it holds
every position of h_loc / sp heads ([b, h_loc/sp, s, d]), attends the full
sequence on its own through the per-head [b, h, s, d] flash kernels (the
dense path where they do not take the shape), all-to-alls back and runs the
output projection. Four all-to-alls forward (q, k, v in, the context out)
and four backward, no ring step: the schedule the cost model prices
(compiler/machine_mapping/cost_estimator.py). It composes with head
parallelism as the ring does: the weight piece holds the rank's heads, and
the output projection's partial sums are summed over the head axes.

At sp = 1 the all-to-all is the identity and the values are the dense
attention's (the JAX package's unsharded fallback computes the same).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from flexflow_tpu_torch.kernels.flash_attention import (
    sharded_flash_attention,
    sharded_flash_supported,
)
from flexflow_tpu_torch.kernels.ops import _dense_context, mha_project_qkv
from flexflow_tpu_torch.op_attrs.ops import UlyssesAttentionAttrs


def attend_full_sequence(qp, kp, vp, causal: bool) -> torch.Tensor:
    """Attention on full-sequence per-head blocks [b, h, s, d]: the per-head
    flash kernels where they take the shape, the dense path otherwise."""
    if sharded_flash_supported(qp.shape, kp.shape, vp.shape, qp.dtype, qp.device):
        return sharded_flash_attention(qp, kp, vp, causal)
    return _dense_context(qp, kp, vp, causal)


def ulysses_attention_block(qp, kp, vp, mesh, seq_axes: Sequence[str], causal: bool
                            ) -> torch.Tensor:
    """This rank's context block [b, h_loc, s_blk, dv] from its projected
    blocks [b, h_loc, s_blk, d]: all-to-all to [b, h_loc/sp, s, d], attend,
    all-to-all back."""
    from flexflow_tpu_torch.parallel.collectives import all_to_all

    sp = mesh.size(seq_axes) if mesh is not None else 1
    if qp.shape[1] % sp:
        raise ValueError(f"{qp.shape[1]} local heads do not split over sp={sp}")
    if sp == 1:
        return attend_full_sequence(qp, kp, vp, causal)
    # [b, h_loc, s_blk, d] -> [b, h_loc/sp, s, d]: split the heads, join the sequence
    q, k, v = (all_to_all(t, 1, 2, mesh, seq_axes) for t in (qp, kp, vp))
    return all_to_all(attend_full_sequence(q, k, v, causal), 2, 1, mesh, seq_axes)


def ulysses_mha_forward(attrs: UlyssesAttentionAttrs, q, k, v, weight, mesh=None,
                        seq_axes: Sequence[str] = (), head_axes: Sequence[str] = (),
                        input_bias=None, output_bias=None) -> torch.Tensor:
    """UlyssesAttention of this rank's blocks q, k, v ([b, s_blk, e]) with
    its weight piece (the heads of its head-parallel block), all-to-all
    over `seq_axes`: the projections, ulysses_attention_block and the
    output projection, summed over `head_axes` where the heads are split,
    and the output bias added once, to the sum. The JAX package's
    ulysses_mha_shard_fn, per rank."""
    from flexflow_tpu_torch.parallel.collectives import sum_partials

    if (input_bias is None) != (output_bias is None):
        raise ValueError("MHA bias weights come in (input, output) pairs")
    heads = weight.shape[1]
    if heads != attrs.num_heads:
        attrs = dataclasses.replace(attrs, num_heads=heads, kdim=attrs.q_proj_size,
                                    vdim=attrs.v_proj_size)
    qp, kp, vp, wo = mha_project_qkv(attrs, q, k, v, weight, input_bias)
    ctx = ulysses_attention_block(qp, kp, vp, mesh, seq_axes, attrs.causal)
    out = torch.einsum("bhsv,veh->bse", ctx, wo)
    if head_axes:
        out = sum_partials(out, mesh, tuple(head_axes))
    return out if output_bias is None else out + output_bias
