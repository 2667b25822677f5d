"""Encoder-decoder transformer (reference:
lib/models/src/models/transformer/transformer.cc:6-170).

Same topology: N encoder layers (self-attn -> add&norm -> ffn -> add&norm),
N decoder layers (self-attn, cross-attn over encoder output, ffn, each with
post-layernorm residuals), then dense(vocab, relu) -> softmax.

A copy of flexflow_tpu/models/transformer.py: the same topology, initializers and
node order, so parameter keys `n{idx}` name the same weights in both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder, Tensor


@dataclass(frozen=True)
class TransformerConfig:
    """reference: transformer_config.struct.toml fields."""

    num_features: int = 512
    sequence_length: int = 512
    batch_size: int = 64
    dim_feedforward: int = 2048
    num_heads: int = 8
    num_encoder_layers: int = 6
    num_decoder_layers: int = 6
    dropout: float = 0.1
    layer_norm_eps: float = 1e-5
    vocab_size: int = 64


def get_default_transformer_config() -> TransformerConfig:
    return TransformerConfig()


def _feedforward(cgb: ComputationGraphBuilder, cfg: TransformerConfig, x: Tensor) -> Tensor:
    h = cgb.dense(x, cfg.dim_feedforward, activation=Activation.RELU, use_bias=True)
    h = cgb.dropout(h, cfg.dropout)
    h = cgb.dense(h, cfg.num_features, use_bias=True)
    return cgb.dropout(h, cfg.dropout)


def _encoder_layer(cgb: ComputationGraphBuilder, cfg: TransformerConfig, x: Tensor) -> Tensor:
    kdim = vdim = cfg.dim_feedforward // cfg.num_heads
    attn = cgb.multihead_attention(
        x, x, x, cfg.num_features, cfg.num_heads, kdim, vdim,
        dropout=cfg.dropout, bias=False,
    )
    h = cgb.layer_norm(cgb.add(attn, x), [2], True, cfg.layer_norm_eps)
    ff = _feedforward(cgb, cfg, h)
    return cgb.layer_norm(cgb.add(h, ff), [2], True, cfg.layer_norm_eps)


def _decoder_layer(
    cgb: ComputationGraphBuilder, cfg: TransformerConfig, x: Tensor, enc: Tensor
) -> Tensor:
    kdim = vdim = cfg.dim_feedforward // cfg.num_heads
    self_attn = cgb.multihead_attention(
        x, x, x, cfg.num_features, cfg.num_heads, kdim, vdim,
        dropout=cfg.dropout, bias=False,
    )
    h = cgb.layer_norm(cgb.add(x, self_attn), [2], True, cfg.layer_norm_eps)
    cross = cgb.multihead_attention(
        h, enc, enc, cfg.num_features, cfg.num_heads, kdim, vdim,
        dropout=cfg.dropout, bias=False,
    )
    h2 = cgb.layer_norm(cgb.add(h, cross), [2], True, cfg.layer_norm_eps)
    ff = _feedforward(cgb, cfg, h2)
    return cgb.layer_norm(cgb.add(h2, ff), [2], True, cfg.layer_norm_eps)


def build_transformer(
    cfg: TransformerConfig,
) -> Tuple[ComputationGraph, Tensor]:
    """Returns (cg, out_prob tensor)."""
    cgb = ComputationGraphBuilder()
    dims = [cfg.batch_size, cfg.sequence_length, cfg.num_features]
    src = cgb.create_input(dims, name="input")
    tgt = cgb.create_input(dims, name="target")

    enc = src
    for _ in range(cfg.num_encoder_layers):
        enc = _encoder_layer(cgb, cfg, enc)
    dec = tgt
    for _ in range(cfg.num_decoder_layers):
        dec = _decoder_layer(cgb, cfg, dec, enc)

    out = cgb.softmax(
        cgb.dense(dec, cfg.vocab_size, activation=Activation.RELU, use_bias=True)
    )
    return cgb.graph, out


def get_transformer_computation_graph(cfg: TransformerConfig) -> ComputationGraph:
    cg, _ = build_transformer(cfg)
    return cg
