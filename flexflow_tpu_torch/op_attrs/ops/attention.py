"""MultiHeadAttention attrs (trimmed copy of
flexflow_tpu/op_attrs/ops/attention.py: the sequential and the parallel
shape rules).

Inputs q/k/v are [batch, seq, channel]. The weight is the reference's flat
per-head layout [wq+wk+wv+wo, num_heads]."""

from __future__ import annotations

from dataclasses import dataclass

from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_reduced_shape,
    lift_to_parallel_with_degrees,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class MultiHeadAttentionAttrs:
    embed_dim: int
    num_heads: int
    kdim: int = 0  # 0 -> embed_dim / num_heads
    vdim: int = 0
    dropout: float = 0.0
    bias: bool = False
    add_bias_kv: bool = False
    add_zero_attn: bool = False

    @property
    def q_proj_size(self) -> int:
        return self.kdim if self.kdim else self.embed_dim // self.num_heads

    @property
    def k_proj_size(self) -> int:
        return self.q_proj_size

    @property
    def v_proj_size(self) -> int:
        return self.vdim if self.vdim else self.embed_dim // self.num_heads

    def _check_inputs(self, q: TensorShape, k: TensorShape, v: TensorShape) -> None:
        if not q.num_dims == k.num_dims == v.num_dims == 3:
            raise ValueError("q/k/v must be [b, seq, c]")
        if not q.dims[0] == k.dims[0] == v.dims[0]:
            raise ValueError("batch mismatch")
        if k.dims[1] != v.dims[1]:
            raise ValueError("kv seq mismatch")

    def output_shape(self, q: TensorShape, k: TensorShape, v: TensorShape) -> TensorShape:
        self._check_inputs(q, k, v)
        return TensorShape((q.dims[0], q.dims[1], self.embed_dim), q.dtype)

    def weights_shape(self, q: TensorShape, k: TensorShape, v: TensorShape) -> TensorShape:
        self._check_inputs(q, k, v)
        per_head = (
            q.dims[-1] * self.q_proj_size
            + k.dims[-1] * self.k_proj_size
            + v.dims[-1] * self.v_proj_size
            + self.v_proj_size * self.embed_dim
        )
        return TensorShape((per_head, self.num_heads), q.dtype)

    def input_bias_shape(self, q: TensorShape, k: TensorShape, v: TensorShape) -> TensorShape:
        return TensorShape(
            (self.q_proj_size + self.k_proj_size + self.v_proj_size,), q.dtype
        )

    def output_bias_shape(self, q: TensorShape, k: TensorShape, v: TensorShape) -> TensorShape:
        return TensorShape((self.embed_dim,), q.dtype)

    # Only RingAttention may take a sharded sequence dim.
    SEQ_SHARDABLE = False

    def _parse_parallel(self, q: ParallelTensorShape, k: ParallelTensorShape,
                        v: ParallelTensorShape):
        """(batch degree, seq degree, head degree) of q, k and v, which must
        agree; the channel dim stays whole, and so does the sequence unless
        the op is SEQ_SHARDABLE."""
        if not q.num_dims == k.num_dims == v.num_dims == 3:
            raise ValueError("q/k/v must be [b, seq, c]")
        for s in (q, k, v):
            if s.shard_dim_at(-1).degree != 1 or s.sum_degree != 1:
                raise ValueError(f"attention needs whole channels and whole sums: {s}")
            if not self.SEQ_SHARDABLE and s.shard_dim_at(1).degree != 1:
                raise ValueError("MHA needs an unsharded sequence; use RingAttention to shard it")
        if len({(s.shard_dim_at(0).degree, s.shard_dim_at(1).degree, s.discard_copy_degree)
                for s in (q, k, v)}) != 1:
            raise ValueError(f"q/k/v parallel degrees disagree: {q}, {k}, {v}")
        return q.shard_dim_at(0).degree, q.shard_dim_at(1).degree, q.discard_copy_degree

    def parallel_output_shape(self, q: ParallelTensorShape, k: ParallelTensorShape,
                              v: ParallelTensorShape) -> ParallelTensorShape:
        batch, seq, heads = self._parse_parallel(q, k, v)
        unpar = self.output_shape(*map(get_reduced_shape, (q, k, v)))
        return lift_to_parallel_with_degrees(unpar, heads, 1, (batch, seq, 1))

    def parallel_weights_shape(self, q: ParallelTensorShape, k: ParallelTensorShape,
                               v: ParallelTensorShape) -> ParallelTensorShape:
        batch, seq, heads = self._parse_parallel(q, k, v)
        unpar = self.weights_shape(*map(get_reduced_shape, (q, k, v)))
        return lift_to_parallel_with_degrees(unpar, 1, batch * seq, (1, heads))
