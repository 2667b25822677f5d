"""GPT-style transformer as an explicitly parallel PCG (copy of
flexflow_tpu/models/parallel_transformer.py), and its long-context
configuration SP_LONGCTX.

Data parallelism is a batch shard degree; tensor parallelism wraps the
attention and the FFN in Replicate(tp) ... Reduction(tp); sequence
parallelism (or causal=True) swaps MultiHeadAttention for RingAttention,
which consumes the sequence-sharded tensor directly. The dense layers keep
their bias (the PCG builder's default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims,
    ParallelTensorShape,
    ShardParallelDim,
)
from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder,
    Tensor,
)


@dataclass(frozen=True)
class ParallelTransformerConfig:
    batch_size: int = 8
    sequence_length: int = 64
    num_features: int = 128
    num_heads: int = 8
    num_layers: int = 2
    vocab_size: int = 32
    data_parallel_degree: int = 2
    tensor_parallel_degree: int = 2
    # >1 shards the sequence dim and swaps MHA for RingAttention: the
    # long-context configuration
    sequence_parallel_degree: int = 1
    causal: bool = False

    def __post_init__(self) -> None:
        if (self.batch_size % self.data_parallel_degree
                or self.num_heads % self.tensor_parallel_degree
                or (4 * self.num_features) % self.tensor_parallel_degree
                or self.sequence_length % self.sequence_parallel_degree):
            raise ValueError(f"parallel degrees do not divide the model: {self}")


# The long-context configuration at the flagship's widths (bench.py:37):
# causal, seq 8192 (the ring's headline case, tests/test_ring_flash.py:82),
# batch 4 for the flagship's 32,768 tokens a step (bench.py:3413-3415). The
# sequence-parallel degree is the number of ranks of the ring:
# dataclasses.replace(SP_LONGCTX, sequence_parallel_degree=n) for n ranks.
SP_LONGCTX = ParallelTransformerConfig(
    batch_size=4, sequence_length=8192, num_features=1024, num_heads=8, num_layers=12,
    vocab_size=32000, data_parallel_degree=1, tensor_parallel_degree=1,
    sequence_parallel_degree=1, causal=True,
)


def _block(b: ParallelComputationGraphBuilder, cfg: ParallelTransformerConfig, x: Tensor,
           i: int) -> Tensor:
    tp = cfg.tensor_parallel_degree

    def maybe_replicate(t: Tensor, name: str) -> Tensor:
        return b.parallel_replicate(t, tp, name=name) if tp > 1 else t

    def maybe_reduce(t: Tensor, name: str) -> Tensor:
        return b.parallel_reduce(t, tp, name=name) if tp > 1 else t

    if cfg.sequence_parallel_degree > 1 or cfg.causal:
        attn = b.ring_attention(x, x, x, cfg.num_features, cfg.num_heads, causal=cfg.causal,
                                name=f"rattn{i}")
    else:
        xr = maybe_replicate(x, f"rep_attn{i}")
        attn = b.multihead_attention(xr, xr, xr, cfg.num_features, cfg.num_heads,
                                     name=f"attn{i}")
        attn = maybe_reduce(attn, f"red_attn{i}")
    h = b.layer_norm(b.add(x, attn), axes=[-1], name=f"ln1_{i}")

    hr = maybe_replicate(h, f"rep_ffn{i}")
    ff = b.dense(hr, 4 * cfg.num_features, name=f"ff1_{i}")
    ff = b.gelu(ff)
    ff = b.dense(ff, cfg.num_features, name=f"ff2_{i}")
    ff = maybe_reduce(ff, f"red_ffn{i}")
    return b.layer_norm(b.add(h, ff), axes=[-1], name=f"ln2_{i}")


def build_parallel_transformer(
    cfg: ParallelTransformerConfig,
) -> Tuple[ParallelComputationGraph, Tensor]:
    """Returns (pcg, logits [b/dp, s/sp, vocab])."""
    b = ParallelComputationGraphBuilder()
    x = b.create_input_tensor(
        ParallelTensorShape(
            ParallelTensorDims((
                ShardParallelDim(cfg.batch_size, cfg.data_parallel_degree),
                ShardParallelDim(cfg.sequence_length, cfg.sequence_parallel_degree),
                ShardParallelDim(cfg.num_features, 1),
            )),
            DataType.FLOAT,
        ),
        name="x",
    )
    h = x
    for i in range(cfg.num_layers):
        h = _block(b, cfg, h, i)
    logits = b.dense(h, cfg.vocab_size, name="head")
    return b.graph, logits


def model_step_flops(cfg: ParallelTransformerConfig) -> int:
    """Matmul FLOPs of one training step (forward + backward = 3x forward),
    as the flagship's count (models/flagship.py) with the attention's s^2
    term halved when causal: a causal mask leaves half the score matrix to
    compute."""
    batch, seq, embed = cfg.batch_size, cfg.sequence_length, cfg.num_features
    heads = cfg.num_heads
    attention = 2 * batch * heads * seq * seq * (embed // heads) * 2
    if cfg.causal:
        attention //= 2
    per_layer = (
        2 * batch * seq * embed * embed * 4
        + attention
        + 2 * batch * seq * embed * 4 * embed * 2
    )
    return 3 * (cfg.num_layers * per_layer + 2 * batch * seq * embed * cfg.vocab_size)
