"""Decoder-only causal LM builders for serving (copy of
flexflow_tpu/serving/model.py).

int32 token ids -> embedding -> N post-LayerNorm transformer blocks (causal
self-attention served through the KV cache; MHA without bias, dense layers
with bias) -> vocab logits. The same builder emits the prefill-shaped and
the decode-shaped graph; their weight sequence is identical by
construction, which is what lets `init_serving_params`' ordinal keying
share one parameter set across both.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.pcg import ComputationGraphBuilder


@dataclass(frozen=True)
class ServingLMConfig:
    """The serving model family (defaults: the JAX package's tier-1 scale)."""

    vocab_size: int = 64
    embed_dim: int = 32
    num_heads: int = 4
    num_layers: int = 2
    ffn_dim: int = 64


def build_serving_lm(cfg: ServingLMConfig, batch: int, seq_len: int) -> Tuple[object, object]:
    """(ComputationGraph, logit tensor) of the causal LM at [batch,
    seq_len]. No trailing softmax: serving samples greedily (argmax)."""
    b = ComputationGraphBuilder()
    toks = b.create_input([batch, seq_len], dtype=DataType.INT32, name="tokens")
    h = b.embedding(toks, cfg.vocab_size, cfg.embed_dim, name="embed")
    for i in range(cfg.num_layers):
        attn = b.multihead_attention(
            h, h, h, embed_dim=cfg.embed_dim, num_heads=cfg.num_heads, name=f"attn{i}",
        )
        h = b.layer_norm(b.add(h, attn), axes=[-1], name=f"ln{i}a")
        ff = b.dense(h, cfg.ffn_dim, name=f"ff{i}a")
        ff = b.gelu(ff)
        ff = b.dense(ff, cfg.embed_dim, name=f"ff{i}b")
        h = b.layer_norm(b.add(h, ff), axes=[-1], name=f"ln{i}b")
    logits = b.dense(h, cfg.vocab_size, name="lm_head")
    return b.graph, logits
