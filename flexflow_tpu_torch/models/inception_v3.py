"""Inception-V3 (reference: lib/models/src/models/inception_v3/inception_v3.cc,
750 LoC; module structure per https://arxiv.org/abs/1512.00567).

Each conv block is conv2d(use_bias=False) + batch_norm(relu=True) — reference
create_conv_block (:71-97). Shape checks at module boundaries mirror the
reference's CheckShape asserts.

A copy of flexflow_tpu/models/inception_v3.py: the same topology, initializers and
node order, so parameter keys `n{idx}` name the same weights in both
packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

from flexflow_tpu_torch.op_attrs.ops import PoolOp
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder, Tensor


@dataclass(frozen=True)
class InceptionV3Config:
    """reference: inception_v3_config.struct.toml."""

    num_classes: int = 1000
    batch_size: int = 32
    aux_logits: bool = True


def get_default_inception_v3_training_config() -> InceptionV3Config:
    return InceptionV3Config()


def _conv_block(cgb, x, filters, kh, kw, sh=1, sw=1, ph=0, pw=0):
    conv = cgb.conv2d(
        x, filters, kernel=(kh, kw), stride=(sh, sw), padding=(ph, pw),
        use_bias=False,
    )
    return cgb.batch_norm(conv, relu=True, affine=True, eps=1e-5, momentum=0.1)


def _check(cgb, t, cfg, c, h=None, w=None):
    shape = cgb.graph.tensor_shape(t)
    expected = (
        (cfg.batch_size, c) if h is None else (cfg.batch_size, c, h, w)
    )
    assert shape.dims == expected, f"expected {expected}, got {shape.dims}"


def _module_a(cgb, x, pool_features):
    b1 = _conv_block(cgb, x, 64, 1, 1)
    b5 = _conv_block(cgb, x, 48, 1, 1)
    b5 = _conv_block(cgb, b5, 64, 5, 5, 1, 1, 2, 2)
    b3 = _conv_block(cgb, x, 64, 1, 1)
    b3 = _conv_block(cgb, b3, 96, 3, 3, 1, 1, 1, 1)
    b3 = _conv_block(cgb, b3, 96, 3, 3, 1, 1, 1, 1)
    bp = cgb.pool2d(x, kernel=(3, 3), stride=(1, 1), padding=(1, 1), pool_type=PoolOp.AVG)
    bp = _conv_block(cgb, bp, pool_features, 1, 1)
    return cgb.concat([b1, b5, b3, bp], axis=1)


def _module_b(cgb, x):
    b1 = _conv_block(cgb, x, 384, 3, 3, 2, 2)
    b3 = _conv_block(cgb, x, 64, 1, 1)
    b3 = _conv_block(cgb, b3, 96, 3, 3, 1, 1, 1, 1)
    b3 = _conv_block(cgb, b3, 96, 3, 3, 2, 2)
    bp = cgb.pool2d(x, kernel=(3, 3), stride=(2, 2), pool_type=PoolOp.MAX)
    return cgb.concat([b1, b3, bp], axis=1)


def _module_c(cgb, x, c7):
    b1 = _conv_block(cgb, x, 192, 1, 1)
    b7 = _conv_block(cgb, x, c7, 1, 1)
    b7 = _conv_block(cgb, b7, c7, 1, 7, 1, 1, 0, 3)
    b7 = _conv_block(cgb, b7, 192, 7, 1, 1, 1, 3, 0)
    b7d = _conv_block(cgb, x, c7, 1, 1)
    b7d = _conv_block(cgb, b7d, c7, 7, 1, 1, 1, 3, 0)
    b7d = _conv_block(cgb, b7d, c7, 1, 7, 1, 1, 0, 3)
    b7d = _conv_block(cgb, b7d, c7, 7, 1, 1, 1, 3, 0)
    b7d = _conv_block(cgb, b7d, 192, 1, 7, 1, 1, 0, 3)
    bp = cgb.pool2d(x, kernel=(3, 3), stride=(1, 1), padding=(1, 1), pool_type=PoolOp.AVG)
    bp = _conv_block(cgb, bp, 192, 1, 1)
    return cgb.concat([b1, b7, b7d, bp], axis=1)


def _module_d(cgb, x):
    b3 = _conv_block(cgb, x, 192, 1, 1)
    b3 = _conv_block(cgb, b3, 320, 3, 3, 2, 2)
    b7 = _conv_block(cgb, x, 192, 1, 1)
    b7 = _conv_block(cgb, b7, 192, 1, 7, 1, 1, 0, 3)
    b7 = _conv_block(cgb, b7, 192, 7, 1, 1, 1, 3, 0)
    b7 = _conv_block(cgb, b7, 192, 3, 3, 2, 2)
    bp = cgb.pool2d(x, kernel=(3, 3), stride=(2, 2), pool_type=PoolOp.MAX)
    return cgb.concat([b3, b7, bp], axis=1)


def _module_e(cgb, x):
    b1 = _conv_block(cgb, x, 320, 1, 1)
    b3 = _conv_block(cgb, x, 384, 1, 1)
    b3a = _conv_block(cgb, b3, 384, 1, 3, 1, 1, 0, 1)
    b3b = _conv_block(cgb, b3, 384, 3, 1, 1, 1, 1, 0)
    b3 = cgb.concat([b3a, b3b], axis=1)
    bd = _conv_block(cgb, x, 448, 1, 1)
    bd = _conv_block(cgb, bd, 384, 3, 3, 1, 1, 1, 1)
    bda = _conv_block(cgb, bd, 384, 1, 3, 1, 1, 0, 1)
    bdb = _conv_block(cgb, bd, 384, 3, 1, 1, 1, 1, 0)
    bd = cgb.concat([bda, bdb], axis=1)
    bp = cgb.pool2d(x, kernel=(3, 3), stride=(1, 1), padding=(1, 1), pool_type=PoolOp.AVG)
    bp = _conv_block(cgb, bp, 192, 1, 1)
    return cgb.concat([b1, b3, bd, bp], axis=1)


def _initial_layers(cgb, cfg, x):
    t = _conv_block(cgb, x, 32, 3, 3, 2, 2)
    t = _conv_block(cgb, t, 32, 3, 3)
    _check(cgb, t, cfg, 32, 147, 147)
    t = _conv_block(cgb, t, 64, 3, 3, 1, 1, 1, 1)
    _check(cgb, t, cfg, 64, 147, 147)
    t = cgb.pool2d(t, kernel=(3, 3), stride=(2, 2), pool_type=PoolOp.MAX)
    t = _conv_block(cgb, t, 80, 1, 1)
    t = _conv_block(cgb, t, 192, 3, 3)
    t = cgb.pool2d(t, kernel=(3, 3), stride=(2, 2), pool_type=PoolOp.MAX)
    _check(cgb, t, cfg, 192, 35, 35)
    return t


def _aux_head(cgb, cfg, x):
    # reference create_inception_aux (:610-652): at 768x17x17
    t = cgb.pool2d(x, kernel=(5, 5), stride=(3, 3), pool_type=PoolOp.AVG)
    t = _conv_block(cgb, t, 128, 1, 1)
    t = _conv_block(cgb, t, 768, 5, 5)
    _check(cgb, t, cfg, 768, 1, 1)
    t = cgb.flat(t)
    t = cgb.dense(t, cfg.num_classes)
    return t


def _final_layers(cgb, cfg, x):
    # reference create_final_layers (:571-602): global avgpool, flatten,
    # dense(num_classes), softmax (Table 1 of the paper)
    t = cgb.pool2d(x, kernel=(8, 8), stride=(1, 1), pool_type=PoolOp.AVG)
    t = cgb.flat(t)
    t = cgb.dense(t, cfg.num_classes)
    t = cgb.softmax(t)
    return t


def build_inception_v3(
    cfg: InceptionV3Config,
) -> Tuple[ComputationGraph, Tensor, Optional[Tensor]]:
    """Returns (cg, logits, aux_logits-or-None)."""
    cgb = ComputationGraphBuilder()
    x = cgb.create_input([cfg.batch_size, 3, 299, 299], name="input")

    t = _initial_layers(cgb, cfg, x)
    t = _module_a(cgb, t, 32)
    _check(cgb, t, cfg, 256, 35, 35)
    t = _module_a(cgb, t, 64)
    _check(cgb, t, cfg, 288, 35, 35)
    t = _module_a(cgb, t, 64)
    _check(cgb, t, cfg, 288, 35, 35)
    t = _module_b(cgb, t)
    _check(cgb, t, cfg, 768, 17, 17)
    for c7 in (128, 160, 160, 192):
        t = _module_c(cgb, t, c7)
        _check(cgb, t, cfg, 768, 17, 17)

    aux = _aux_head(cgb, cfg, t) if cfg.aux_logits else None

    t = _module_d(cgb, t)
    _check(cgb, t, cfg, 1280, 8, 8)
    t = _module_e(cgb, t)
    _check(cgb, t, cfg, 2048, 8, 8)
    t = _module_e(cgb, t)
    _check(cgb, t, cfg, 2048, 8, 8)
    out = _final_layers(cgb, cfg, t)
    _check(cgb, out, cfg, cfg.num_classes)
    return cgb.graph, out, aux


def get_inception_v3_computation_graph(cfg: InceptionV3Config) -> ComputationGraph:
    cg, _, _ = build_inception_v3(cfg)
    return cg
