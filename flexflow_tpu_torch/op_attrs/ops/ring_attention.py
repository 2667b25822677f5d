"""RingAttention attrs (copy of flexflow_tpu/op_attrs/ops/ring_attention.py):
MultiHeadAttention whose sequence dim may be sharded. The weight layout is
MultiHeadAttention's flat [per_head_params, num_heads], so the two ops
share trained weights verbatim.

causal=True masks with GLOBAL sequence positions: each ring step knows the
offsets of the query and key blocks it holds.

Parallel rules: the output keeps q's batch and sequence degrees and carries
q's discard-copy degree as its sum degree; the weight is replicated over
the batch and sequence shards and sharded over heads.
"""

from __future__ import annotations

from dataclasses import dataclass

from flexflow_tpu_torch.op_attrs.ops.attention import MultiHeadAttentionAttrs


@dataclass(frozen=True)
class RingAttentionAttrs(MultiHeadAttentionAttrs):
    causal: bool = False

    SEQ_SHARDABLE = True
