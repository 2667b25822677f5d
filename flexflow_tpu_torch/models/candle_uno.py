"""CANDLE-UNO drug-response MLP (reference:
lib/models/src/models/candle_uno/candle_uno.cc:6-123).

Seven input features; cell/drug features pass through a shared-architecture
dense tower; everything concatenates and feeds a dense trunk ending in a
1-unit regressor. Glorot-normal kernel init, no biases.

A copy of flexflow_tpu/models/candle_uno.py: the same topology, initializers and
node order, so parameter keys `n{idx}` name the same weights in both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Tuple

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder, Tensor
from flexflow_tpu_torch.pcg.initializer import GlorotNormalAttrs


@dataclass(frozen=True)
class CandleUnoConfig:
    """reference: candle_uno_config.struct.toml fields."""

    batch_size: int = 64
    dense_layers: Tuple[int, ...] = (4192,) * 4
    dense_feature_layers: Tuple[int, ...] = (4192,) * 8
    # reference candle_uno defaults (candle_uno.cc feature config); an empty
    # feature set would make the concat of encoded features ill-formed
    feature_shapes: Tuple[Tuple[str, int], ...] = (
        ("cell.rnaseq", 942),
        ("dose", 1),
        ("drug.descriptors", 5270),
        ("drug.fingerprints", 2048),
    )
    input_features: Tuple[Tuple[str, str], ...] = (
        ("cell.rnaseq", "cell.rnaseq"),
        ("dose1", "dose"),
        ("dose2", "dose"),
        ("drug1.descriptors", "drug.descriptors"),
        ("drug1.fingerprints", "drug.fingerprints"),
        ("drug2.descriptors", "drug.descriptors"),
        ("drug2.fingerprints", "drug.fingerprints"),
    )
    dropout: float = 0.1
    residual: bool = False


def get_default_candle_uno_config() -> CandleUnoConfig:
    return CandleUnoConfig()


def _feature_tower(cgb, cfg: CandleUnoConfig, x, kernel_init):
    for dim in cfg.dense_feature_layers:
        x = cgb.dense(
            x, dim, activation=Activation.RELU, use_bias=False,
            kernel_initializer=kernel_init,
        )
        if cfg.dropout > 0:
            x = cgb.dropout(x, cfg.dropout)
    return x


def build_candle_uno(cfg: CandleUnoConfig) -> Tuple[ComputationGraph, Tensor]:
    cgb = ComputationGraphBuilder()
    kernel_init = GlorotNormalAttrs(seed=0)
    feature_shapes = dict(cfg.feature_shapes)

    # cell./drug. features go through the tower (reference :67-80)
    tower_features = {
        name
        for name in feature_shapes
        if "." in name and name.split(".", 1)[0] in ("cell", "drug")
    }

    encoded: List[Tensor] = []
    for input_name, feature_name in cfg.input_features:
        shape = feature_shapes[feature_name]
        t = cgb.create_input([cfg.batch_size, shape], name=input_name)
        if feature_name in tower_features:
            t = _feature_tower(cgb, cfg, t, kernel_init)
        encoded.append(t)

    out = cgb.concat(encoded, axis=1)
    for dim in cfg.dense_layers:
        residual_input = out
        out = cgb.dense(
            out, dim, activation=Activation.RELU, use_bias=False,
            kernel_initializer=kernel_init,
        )
        if cfg.dropout > 0:
            out = cgb.dropout(out, cfg.dropout)
        if cfg.residual:
            out = cgb.add(out, residual_input)
    out = cgb.dense(out, 1, use_bias=False, kernel_initializer=kernel_init)
    return cgb.graph, out


def get_candle_uno_computation_graph(cfg: CandleUnoConfig) -> ComputationGraph:
    cg, _ = build_candle_uno(cfg)
    return cg
