"""UlyssesAttention attrs (copy of
flexflow_tpu/op_attrs/ops/ulysses_attention.py): the all-to-all
sequence-parallel schedule of attention, beside RingAttention. Attrs only in
the port: the search's `a2a` seeds and rules need them, and their
all-to-all execution waits (A11).

Same parallel interface as RingAttentionAttrs (the sequence dim of q/k/v may
carry a shard degree, the weights replicate over the batch and sequence
shards and shard over heads), but the all-to-all trades sequence shards for
head shards, so the local head count must split over the sequence degree.
"""

from __future__ import annotations

from dataclasses import dataclass

from flexflow_tpu_torch.op_attrs.ops.ring_attention import RingAttentionAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorShape


@dataclass(frozen=True)
class UlyssesAttentionAttrs(RingAttentionAttrs):
    def _parse_parallel(self, q: ParallelTensorShape, k: ParallelTensorShape,
                        v: ParallelTensorShape):
        batch, seq, heads = super()._parse_parallel(q, k, v)
        local_heads = self.num_heads // max(heads, 1)
        if seq != 1 and local_heads % seq:
            raise ValueError(
                f"ulysses all-to-all moves seq shards onto heads: {local_heads} "
                f"local heads do not split over seq degree {seq}"
            )
        return batch, seq, heads
