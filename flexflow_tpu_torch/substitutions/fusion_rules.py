"""Algebraic (TASO-style) fusion rules: rewrites that merge operators rather
than introduce parallelism (copy of flexflow_tpu/substitutions/fusion_rules.py).

Reference: the TASO-era substitution corpus the reference loads through
lib/substitution-generator (legacy_rules.h:40-55; graph_subst_3_v2.json
carried fuse/merge rules alongside the parallelization ones), and the
FusedOp capability (lib/runtime/src/ops/fused.cc), whose goal is fewer,
larger device launches. The rules here are the algebra-level merges, which
change the operator graph:

- merge_sibling_linears: two Linears reading the SAME input become one wider
  Linear + Split (the classic QKV fusion: one [e, o1+o2] matmul instead of
  two, better tensor-core utilization for skinny heads).
- merge_consecutive_linears: Linear(Linear(a, w1), w2) with no bias and no
  activation in between collapses to Linear(a, w1 @ w2) — profitable when
  the hidden width exceeds in*out/(in+out).
- fuse_linear_activation: Linear + ElementUnary(relu/gelu/sigmoid/tanh)
  becomes Linear(activation=...), shrinking the searched graph.

All three preserve numerics exactly (same dots, same order up to
reassociation); the Unity search prices the rewritten graph with the same
cost model as any other candidate.
"""

from __future__ import annotations

import dataclasses
from typing import List

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.core import OperatorType
from flexflow_tpu_torch.op_attrs.ops import BatchMatmulAttrs, ConcatAttrs, SplitAttrs
from flexflow_tpu_torch.op_attrs.ops.elementwise import ElementUnaryOpType
from flexflow_tpu_torch.substitutions.output_graph import (
    AttrConstant,
    ComputeAttrsFromMatched,
    CopyAttrsFromMatched,
    OutputGraphExpr,
)
from flexflow_tpu_torch.substitutions.pcg_pattern import PCGPattern
from flexflow_tpu_torch.substitutions.rules import _attr_pattern
from flexflow_tpu_torch.substitutions.substitution import Substitution

_UNARY_TO_ACTIVATION = {
    ElementUnaryOpType.RELU: Activation.RELU,
    ElementUnaryOpType.GELU: Activation.GELU,
    ElementUnaryOpType.SIGMOID: Activation.SIGMOID,
    ElementUnaryOpType.TANH: Activation.TANH,
}


def _plain_linear_pattern() -> "OperatorAttributePattern":
    """A Linear with nothing fused yet: no bias, no activation."""
    return _attr_pattern(
        OperatorType.LINEAR, eq={"use_bias": False, "activation": None}
    )


def merge_sibling_linears_rule() -> Substitution:
    """{Linear(a, w1), Linear(a, w2)} -> Split(Linear(a, Concat_1(w1, w2))).

    The QKV-fusion shape: both matched Linears must be plain (no bias, no
    activation); the merged Linear's out_channels is the sum."""
    p = PCGPattern()
    a = p.add_input()
    w1 = p.add_input()
    w2 = p.add_input()
    n1, (y1,) = p.add_operator(_plain_linear_pattern(), [a, w1])
    n2, (y2,) = p.add_operator(_plain_linear_pattern(), [a, w2])

    og = OutputGraphExpr()
    oa = og.add_input()
    ow1 = og.add_input()
    ow2 = og.add_input()
    _, (wc,) = og.add_operator(AttrConstant(ConcatAttrs(axis=1)), [ow1, ow2])
    _, (yc,) = og.add_operator(
        ComputeAttrsFromMatched(
            (n1, n2),
            lambda a1, a2: dataclasses.replace(
                a1, out_channels=a1.out_channels + a2.out_channels
            ),
        ),
        [oa, wc],
    )
    _, (o1, o2) = og.add_operator(
        ComputeAttrsFromMatched(
            (n1, n2),
            lambda a1, a2: SplitAttrs(
                sizes=(a1.out_channels, a2.out_channels), axis=-1
            ),
        ),
        [yc],
        num_outputs=2,
    )
    return Substitution(
        "merge_sibling_linears",
        p,
        og,
        ((a, oa), (w1, ow1), (w2, ow2)),
        ((y1, o1), (y2, o2)),
    )


def merge_consecutive_linears_rule() -> Substitution:
    """Linear(Linear(a, w1), w2) -> Linear(a, Matmul(w1, w2)).

    Both Linears plain (no bias/activation); profitable when the hidden
    width is large relative to in/out — the cost model decides."""
    p = PCGPattern()
    a = p.add_input()
    w1 = p.add_input()
    w2 = p.add_input()
    n1, (h,) = p.add_operator(_plain_linear_pattern(), [a, w1])
    n2, (y,) = p.add_operator(_plain_linear_pattern(), [h, w2])

    og = OutputGraphExpr()
    oa = og.add_input()
    ow1 = og.add_input()
    ow2 = og.add_input()
    _, (wm,) = og.add_operator(AttrConstant(BatchMatmulAttrs()), [ow1, ow2])
    _, (oy,) = og.add_operator(CopyAttrsFromMatched(n2), [oa, wm])
    return Substitution(
        "merge_consecutive_linears",
        p,
        og,
        ((a, oa), (w1, ow1), (w2, ow2)),
        ((y, oy),),
    )


def fuse_linear_activation_rule(unary_op: ElementUnaryOpType) -> Substitution:
    """Linear(a, w) -> ElementUnary(act) fused into Linear(activation=act)."""
    act = _UNARY_TO_ACTIVATION[unary_op]
    p = PCGPattern()
    a = p.add_input()
    w = p.add_input()
    n1, (h,) = p.add_operator(_plain_linear_pattern(), [a, w])
    n2, (y,) = p.add_operator(
        _attr_pattern(OperatorType.ELEMENT_UNARY, eq={"op_type": unary_op}), [h]
    )

    og = OutputGraphExpr()
    oa = og.add_input()
    ow = og.add_input()
    _, (oy,) = og.add_operator(
        CopyAttrsFromMatched(n1, overrides=(("activation", act),)), [oa, ow]
    )
    return Substitution(
        f"fuse_linear_{act.value}",
        p,
        og,
        ((a, oa), (w, ow)),
        ((y, oy),),
    )


def generate_fusion_rules() -> List[Substitution]:
    """The graph-level fusion rule set (gated by FFConfig.perform_fusion,
    the search-side counterpart of the reference's FusedOp capability)."""
    rules: List[Substitution] = [
        merge_sibling_linears_rule(),
        merge_consecutive_linears_rule(),
    ]
    for uop in _UNARY_TO_ACTIVATION:
        rules.append(fuse_linear_activation_rule(uop))
    return rules
