"""Serving memory accounting (trimmed copy of
flexflow_tpu/analysis/memory_accounting.py: the serving regime's KV-cache
terms).

The KV cache is a parallel tensor [seqs, heads, max_seq_len, head_dim] per
attention op whose degrees are bound to the op's own sharding. One formula,
`kv_cache_piece_bytes`, prices it: `serving.kv_cache.per_device_cache_bytes`
sums it over the attention layers, and the engine's cache allocation is
checked against that sum, so what is allocated and what is priced cannot
drift.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from flexflow_tpu_torch.local_execution.training_backing import slot_roles
from flexflow_tpu_torch.op_attrs.core import IncomingTensorRole
from flexflow_tpu_torch.op_attrs.ops import MultiHeadAttentionAttrs


@dataclass(frozen=True)
class ServingMemorySpec:
    """The serving-side memory regime: how many sequences the engine may
    admit concurrently, how long each may grow, and the KV element width."""

    max_concurrent_seqs: int
    max_seq_len: int
    kv_dtype_bytes: int = 4

    def per_seq_cache_bytes(self, num_heads: int, k_dim: int, v_dim: int,
                            num_layers: int = 1) -> int:
        """Unsharded K+V bytes ONE sequence holds across `num_layers`
        attention layers."""
        return (
            num_layers
            * self.max_seq_len
            * num_heads
            * (k_dim + v_dim)
            * self.kv_dtype_bytes
        )


def kv_cache_piece_bytes(attrs, q_parallel_shape, w_parallel_shape,
                         serving: ServingMemorySpec) -> int:
    """Per-device KV-cache residency of ONE attention op under `serving`,
    from the op's parallel shapes: sequences shard with the op's batch
    degree (q dim 0), cache positions with its sequence degree (q dim 1),
    heads with the packed weight's head degree (w dim 1)."""
    if not isinstance(attrs, MultiHeadAttentionAttrs):
        return 0
    batch_degree = max(q_parallel_shape.shard_dim_at(0).degree, 1)
    seq_degree = 1
    if q_parallel_shape.num_dims >= 3:
        seq_degree = max(q_parallel_shape.shard_dim_at(1).degree, 1)
    head_degree = 1
    if w_parallel_shape is not None and w_parallel_shape.num_dims >= 2:
        head_degree = max(w_parallel_shape.shard_dim_at(1).degree, 1)
    seqs = math.ceil(serving.max_concurrent_seqs / batch_degree)
    positions = math.ceil(serving.max_seq_len / seq_degree)
    heads = math.ceil(attrs.num_heads / head_degree)
    return (
        seqs
        * positions
        * heads
        * (attrs.k_proj_size + attrs.v_proj_size)
        * serving.kv_dtype_bytes
    )


def _weight_slot_shape(attrs, input_parallel_shapes):
    """The first WEIGHT-role slot's parallel shape (None when the op has
    none wired): the head-degree carrier of `kv_cache_piece_bytes`."""
    shapes = list(input_parallel_shapes or ())
    for s, role in zip(shapes, slot_roles(attrs, len(shapes))):
        if role == IncomingTensorRole.WEIGHT:
            return s
    return None
