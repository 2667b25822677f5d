"""BERT encoder stack (reference: lib/models/src/models/bert/bert.cc:8-160).

Topology parity: truncated-normal projection init (stddev=initializer_range,
cutoffs ±2σ), zero bias init, per-layer MHA(bias=True) + post-layernorm
residual + GELU feedforward, final dense(vocab, act) -> softmax.

A copy of flexflow_tpu/models/bert.py: the same topology, initializers and
node order, so parameter keys `n{idx}` name the same weights in both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder, Tensor
from flexflow_tpu_torch.pcg.initializer import (
    TruncatedNormalInitializerAttrs,
    ZeroInitializerAttrs,
)


@dataclass(frozen=True)
class BertConfig:
    """reference: bert_config.struct.toml fields."""

    vocab_size: int = 30522
    hidden_size: int = 768
    num_encoder_layers: int = 12
    num_heads: int = 12
    dim_feedforward: int = 3072
    hidden_act: Activation = Activation.GELU
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    initializer_range: float = 0.02
    layer_norm_eps: float = 1e-12
    position_embedding_type: str = "absolute"
    classifier_dropout: float = 0.1
    sequence_length: int = 512
    batch_size: int = 64


def get_default_bert_config() -> BertConfig:
    return BertConfig()


def _feedforward(cgb, cfg: BertConfig, x, bias_init, proj_init):
    h = cgb.dense(
        x, cfg.dim_feedforward, activation=cfg.hidden_act, use_bias=True,
        kernel_initializer=proj_init, bias_initializer=bias_init,
    )
    h = cgb.dropout(h, cfg.hidden_dropout_prob)
    h = cgb.dense(
        h, cfg.hidden_size, use_bias=True,
        kernel_initializer=proj_init, bias_initializer=bias_init,
    )
    return cgb.dropout(h, cfg.hidden_dropout_prob)


def _encoder_layer(cgb, cfg: BertConfig, x, bias_init, proj_init):
    kdim = vdim = cfg.dim_feedforward // cfg.num_heads
    attn = cgb.multihead_attention(
        x, x, x, cfg.hidden_size, cfg.num_heads, kdim, vdim,
        dropout=cfg.attention_probs_dropout_prob, bias=True,
        initializer=proj_init,
    )
    h = cgb.layer_norm(cgb.add(attn, x), [2], True, cfg.layer_norm_eps)
    ff = _feedforward(cgb, cfg, h, bias_init, proj_init)
    return cgb.layer_norm(cgb.add(h, ff), [2], True, cfg.layer_norm_eps)


def build_bert(cfg: BertConfig) -> Tuple[ComputationGraph, Tensor]:
    if cfg.position_embedding_type != "absolute":
        raise ValueError(
            "only position_embedding_type='absolute' is supported, got "
            f"{cfg.position_embedding_type!r}"
        )
    cgb = ComputationGraphBuilder()
    proj_init = TruncatedNormalInitializerAttrs(
        seed=0,
        mean=0.0,
        stddev=cfg.initializer_range,
        min_cutoff=-2 * cfg.initializer_range,
        max_cutoff=2 * cfg.initializer_range,
    )
    bias_init = ZeroInitializerAttrs()

    x = cgb.create_input(
        [cfg.batch_size, cfg.sequence_length, cfg.hidden_size], name="input"
    )
    h = x
    for _ in range(cfg.num_encoder_layers):
        h = _encoder_layer(cgb, cfg, h, bias_init, proj_init)

    out = cgb.softmax(
        cgb.dense(
            h, cfg.vocab_size, activation=cfg.hidden_act, use_bias=True,
            kernel_initializer=proj_init, bias_initializer=bias_init,
        )
    )
    return cgb.graph, out


def get_bert_computation_graph(cfg: BertConfig) -> ComputationGraph:
    cg, _ = build_bert(cfg)
    return cg
