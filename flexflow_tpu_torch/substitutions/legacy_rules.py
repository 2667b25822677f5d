"""Legacy TASO-format substitution rules, graph_subst_3_v2.json era (copy of
flexflow_tpu/substitutions/legacy_rules.py; the loader also takes the rule
text itself).

Reference: lib/substitution-generator/include/substitution-generator/
legacy_rules.h:12-55 (LegacyRule{srcOp, dstOp, mappedOutput} with
Operator{type, input[Tensor{opId, tsId}], para[Parameter{key, value}]}) and
src/.../legacy_rules.cc from_json. Tensor opId < 0 names a graph input
(-1 is the first, -2 the second, ...); opId >= 0 indexes the rule's op list.

The reference only *loads* these structs; here each rule is additionally
converted into a live `Substitution` so FFConfig.substitution_json_path
extends the Unity search space. Rules using ops or parameters outside the
convertible vocabulary (e.g. OP_SPLIT, whose piece sizes the legacy format
never records) are counted and skipped, not errors."""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.core import OperatorType
from flexflow_tpu_torch.op_attrs.ops import (
    CombineAttrs,
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
    RepartitionAttrs,
    ReplicateAttrs,
    ReductionAttrs,
)
from flexflow_tpu_torch.substitutions.operator_pattern import (
    ConstraintType,
    OperatorAttributeConstraint,
    OperatorAttributeKey,
    OperatorAttributePattern,
)
from flexflow_tpu_torch.substitutions.output_graph import (
    AttrConstant,
    CopyAttrsFromMatched,
    OutputGraphExpr,
)
from flexflow_tpu_torch.substitutions.pcg_pattern import PCGPattern
from flexflow_tpu_torch.substitutions.substitution import Substitution


@dataclass(frozen=True)
class LegacyTensor:
    opId: int
    tsId: int


@dataclass(frozen=True)
class LegacyParameter:
    key: str
    value: int


@dataclass
class LegacyOperator:
    op_type: str
    input: List[LegacyTensor]
    para: List[LegacyParameter]

    def at(self, key: str) -> Optional[int]:
        """legacy_rules.h:28 LegacyOperator::at."""
        for p in self.para:
            if p.key == key:
                return p.value
        return None


@dataclass
class LegacyMapOutput:
    dstOpId: int
    dstTsId: int
    srcOpId: int
    srcTsId: int


@dataclass
class LegacyRule:
    name: str
    srcOp: List[LegacyOperator]
    dstOp: List[LegacyOperator]
    mappedOutput: List[LegacyMapOutput]


@dataclass
class LegacyRuleCollection:
    rules: List[LegacyRule] = field(default_factory=list)


def _tensor(j) -> LegacyTensor:
    return LegacyTensor(int(j["opId"]), int(j["tsId"]))


# Canonical legacy enum name tables (reference protobuf_to_json.cc's
# NLOHMANN_JSON_SERIALIZE_ENUM maps): the names a converted rule file
# carries, mapped back by the loader below.
LEGACY_OP_TYPE_NAMES = [
    "OP_INPUT", "OP_WEIGHT", "OP_ANY", "OP_CONV2D", "OP_DROPOUT", "OP_LINEAR",
    "OP_POOL2D_MAX", "OP_POOL2D_AVG", "OP_RELU", "OP_SIGMOID", "OP_TANH",
    "OP_BATCHNORM", "OP_CONCAT", "OP_SPLIT", "OP_RESHAPE", "OP_TRANSPOSE",
    "OP_EW_ADD", "OP_EW_MUL", "OP_MATMUL", "OP_MUL", "OP_ENLARGE",
    "OP_MERGE_GCONV", "OP_CONSTANT_IMM", "OP_CONSTANT_ICONV",
    "OP_CONSTANT_ONE", "OP_CONSTANT_POOL", "OP_PARTITION", "OP_COMBINE",
    "OP_REPLICATE", "OP_REDUCE", "OP_EMBEDDING",
]

LEGACY_PARAM_NAMES = [
    "PM_OP_TYPE", "PM_NUM_INPUTS", "PM_NUM_OUTPUTS", "PM_GROUP",
    "PM_KERNEL_H", "PM_KERNEL_W", "PM_STRIDE_H", "PM_STRIDE_W", "PM_PAD",
    "PM_ACTI", "PM_NUMDIM", "PM_AXIS", "PM_PERM", "PM_OUTSHUFFLE",
    "PM_MERGE_GCONV_COUNT", "PM_PARALLEL_DIM", "PM_PARALLEL_DEGREE",
]

LEGACY_ACTIVATION_NAMES = [
    "AC_MODE_NONE", "AC_MODE_SIGMOID", "AC_MODE_RELU", "AC_MODE_TANH",
]
LEGACY_PADDING_NAMES = ["PD_MODE_SAME", "PD_MODE_VALID"]

# PM_ACTI / PM_PAD values appear by enum NAME in converter-produced JSON
_NAMED_PARAM_VALUES = {
    **{n: i for i, n in enumerate(LEGACY_ACTIVATION_NAMES)},
    **{n: i for i, n in enumerate(LEGACY_PADDING_NAMES)},
}


def _param_value(v) -> int:
    if isinstance(v, str) and v in _NAMED_PARAM_VALUES:
        return _NAMED_PARAM_VALUES[v]
    return int(v)


def _operator(j) -> LegacyOperator:
    return LegacyOperator(
        op_type=j["type"],
        input=[_tensor(t) for t in j["input"]],
        para=[
            LegacyParameter(p["key"], _param_value(p["value"]))
            for p in j["para"]
        ],
    )


def load_rule_collection(text_or_doc) -> LegacyRuleCollection:
    doc = (
        json.loads(text_or_doc)
        if isinstance(text_or_doc, (str, bytes))
        else text_or_doc
    )
    rules = [
        LegacyRule(
            name=j.get("name", f"taso_rule_{i}"),
            srcOp=[_operator(o) for o in j["srcOp"]],
            dstOp=[_operator(o) for o in j["dstOp"]],
            mappedOutput=[
                LegacyMapOutput(
                    int(m["dstOpId"]),
                    int(m["dstTsId"]),
                    int(m["srcOpId"]),
                    int(m["srcTsId"]),
                )
                for m in j["mappedOutput"]
            ],
        )
        for i, j in enumerate(doc["rule"])
    ]
    return LegacyRuleCollection(rules)


def load_rule_collection_from_path(path: str) -> LegacyRuleCollection:
    with open(path) as f:
        return load_rule_collection(json.load(f))


# ---------------------------------------------------------------------------
# conversion to live Substitutions
# ---------------------------------------------------------------------------


class UnconvertibleRule(ValueError):
    pass


# TASO-era ActiMode: NONE=0, SIGMOID=1, RELU=2, TANH=3
_LEGACY_ACTIVATION = {
    0: None,
    1: Activation.SIGMOID,
    2: Activation.RELU,
    3: Activation.TANH,
}

_COMPUTE_OP_TYPES = {
    "OP_LINEAR": OperatorType.LINEAR,
    "OP_RELU": OperatorType.ELEMENT_UNARY,
    "OP_EW_ADD": OperatorType.ELEMENT_BINARY,
    "OP_EW_MUL": OperatorType.ELEMENT_BINARY,
    "OP_CONCAT": OperatorType.CONCAT,
}


def _parallel_attrs(op: LegacyOperator):
    """AttrConstant for a legacy parallel op, or None if not a parallel op."""
    dim = op.at("PM_PARALLEL_DIM")
    deg = op.at("PM_PARALLEL_DEGREE")
    if op.op_type == "OP_PARTITION":
        return RepartitionAttrs(int(dim), int(deg))
    if op.op_type == "OP_COMBINE":
        return CombineAttrs(int(dim), int(deg))
    if op.op_type == "OP_REPLICATE":
        return ReplicateAttrs(int(deg))
    if op.op_type == "OP_REDUCE":
        return ReductionAttrs(int(deg))
    return None


def _src_pattern(op: LegacyOperator) -> OperatorAttributePattern:
    """Attribute pattern for a legacy src op."""
    cs: List[OperatorAttributeConstraint] = []

    def eq(field_name, value):
        cs.append(
            OperatorAttributeConstraint(
                OperatorAttributeKey.FIELD,
                ConstraintType.EQUAL,
                value,
                field_name=field_name,
            )
        )

    par = _parallel_attrs(op)
    if par is not None:
        ot = {
            "OP_PARTITION": OperatorType.REPARTITION,
            "OP_COMBINE": OperatorType.COMBINE,
            "OP_REPLICATE": OperatorType.REPLICATE,
            "OP_REDUCE": OperatorType.REDUCTION,
        }[op.op_type]
        cs.insert(
            0,
            OperatorAttributeConstraint(
                OperatorAttributeKey.OP_TYPE, ConstraintType.EQUAL, ot
            ),
        )
        import dataclasses

        for f in dataclasses.fields(par):
            eq(f.name, getattr(par, f.name))
        return OperatorAttributePattern(tuple(cs))

    if op.op_type not in _COMPUTE_OP_TYPES:
        raise UnconvertibleRule(op.op_type)
    cs.insert(
        0,
        OperatorAttributeConstraint(
            OperatorAttributeKey.OP_TYPE,
            ConstraintType.EQUAL,
            _COMPUTE_OP_TYPES[op.op_type],
        ),
    )
    if op.op_type == "OP_LINEAR":
        acti = op.at("PM_ACTI")
        if acti is not None:
            eq("activation", _LEGACY_ACTIVATION.get(acti))
        # legacy linear rules carry (input, weight) tensors only
        if len(op.input) == 2:
            eq("use_bias", False)
    elif op.op_type == "OP_RELU":
        eq("op_type", ElementUnaryOpType.RELU)
    elif op.op_type == "OP_EW_ADD":
        eq("op_type", ElementBinaryOpType.ADD)
    elif op.op_type == "OP_EW_MUL":
        eq("op_type", ElementBinaryOpType.MUL)
    elif op.op_type == "OP_CONCAT":
        axis = op.at("PM_AXIS")
        if axis is not None:
            eq("axis", int(axis))
    return OperatorAttributePattern(tuple(cs))


def to_substitution(rule: LegacyRule) -> Substitution:
    """Convert one legacy rule; raises UnconvertibleRule for vocabulary the
    converter cannot express (the caller counts and skips)."""
    # -- pattern (srcOp) ---------------------------------------------------
    p = PCGPattern()
    graph_inputs: Dict[int, object] = {}  # negative opId -> GraphInput

    def p_input(gid: int):
        if gid not in graph_inputs:
            graph_inputs[gid] = p.add_input()
        return graph_inputs[gid]

    src_nodes = []
    src_outs: Dict[Tuple[int, int], object] = {}
    n_outs_src = _num_outputs(rule, src=True)
    for i, op in enumerate(rule.srcOp):
        ins = []
        for t in op.input:
            if t.opId < 0:
                ins.append(p_input(t.opId))
            else:
                ins.append(src_outs[(t.opId, t.tsId)])
        node, outs = p.add_operator(
            _src_pattern(op), ins, num_outputs=n_outs_src.get(i, 1)
        )
        src_nodes.append(node)
        for ts, o in enumerate(outs):
            src_outs[(i, ts)] = o

    # -- output expr (dstOp) ----------------------------------------------
    og = OutputGraphExpr()
    og_inputs: Dict[int, object] = {}

    def og_input(gid: int):
        if gid not in og_inputs:
            og_inputs[gid] = og.add_input()
        return og_inputs[gid]

    # compute ops in dst copy attrs from the k-th src op of the same type
    src_by_type: Dict[str, List[int]] = {}
    for i, op in enumerate(rule.srcOp):
        src_by_type.setdefault(_type_key(op), []).append(i)
    used_by_type: Dict[str, int] = {}

    dst_outs: Dict[Tuple[int, int], object] = {}
    n_outs_dst = _num_outputs(rule, src=False)
    for i, op in enumerate(rule.dstOp):
        ins = []
        for t in op.input:
            if t.opId < 0:
                ins.append(og_input(t.opId))
            else:
                ins.append(dst_outs[(t.opId, t.tsId)])
        par = _parallel_attrs(op)
        if par is not None:
            assignment = AttrConstant(par)
        else:
            key = _type_key(op)
            cands = src_by_type.get(key, [])
            k = used_by_type.get(key, 0)
            if k < len(cands):
                used_by_type[key] = k + 1
                assignment = CopyAttrsFromMatched(src_nodes[cands[k]])
            else:
                # TASO fusion-style rules introduce NEW compute ops in the
                # dst (e.g. the concat joining fused matmul operands); these
                # are constructible when the para fully determine the attrs
                const = _const_compute_attrs(op)
                if const is None:
                    raise UnconvertibleRule(
                        f"dst op {op.op_type} has no src counterpart to copy"
                    )
                assignment = AttrConstant(const)
        _, outs = og.add_operator(assignment, ins, num_outputs=n_outs_dst.get(i, 1))
        for ts, o in enumerate(outs):
            dst_outs[(i, ts)] = o

    # -- interface bijections ---------------------------------------------
    missing = set(graph_inputs) ^ set(og_inputs)
    if missing:
        raise UnconvertibleRule(f"unbalanced graph inputs: {missing}")
    input_mapping = tuple(
        (graph_inputs[g], og_inputs[g]) for g in sorted(graph_inputs)
    )
    output_mapping = tuple(
        (src_outs[(m.srcOpId, m.srcTsId)], dst_outs[(m.dstOpId, m.dstTsId)])
        for m in rule.mappedOutput
    )
    return Substitution(rule.name, p, og, input_mapping, output_mapping)


def _const_compute_attrs(op: LegacyOperator):
    """Fully-parameter-determined attrs for a dst compute op, else None."""
    from flexflow_tpu_torch.op_attrs.ops import ConcatAttrs

    if op.op_type == "OP_RELU":
        return ElementUnaryAttrs(ElementUnaryOpType.RELU)
    if op.op_type == "OP_EW_ADD":
        return ElementBinaryAttrs(ElementBinaryOpType.ADD)
    if op.op_type == "OP_EW_MUL":
        return ElementBinaryAttrs(ElementBinaryOpType.MUL)
    if op.op_type == "OP_CONCAT":
        axis = op.at("PM_AXIS")
        if axis is not None:
            return ConcatAttrs(int(axis))
    return None


def _type_key(op: LegacyOperator) -> str:
    """Attr-copy matching key (EW_ADD and EW_MUL must not cross-copy)."""
    return op.op_type


def _num_outputs(rule: LegacyRule, src: bool) -> Dict[int, int]:
    """Max referenced tsId per op (+ mappedOutput refs) -> output arity."""
    n: Dict[int, int] = {}
    ops = rule.srcOp if src else rule.dstOp
    for op in ops:
        for t in op.input:
            if t.opId >= 0:
                n[t.opId] = max(n.get(t.opId, 1), t.tsId + 1)
    for m in rule.mappedOutput:
        if src:
            n[m.srcOpId] = max(n.get(m.srcOpId, 1), m.srcTsId + 1)
        else:
            n[m.dstOpId] = max(n.get(m.dstOpId, 1), m.dstTsId + 1)
    return n


def load_legacy_substitutions(path_or_text: str) -> Tuple[List[Substitution], int]:
    """(converted substitutions, skipped-rule count) for a legacy rule
    corpus: a path to its JSON file, or the JSON text itself (a string
    whose first non-blank character is `{`)."""
    if path_or_text.lstrip().startswith("{"):
        collection = load_rule_collection(path_or_text)
    else:
        collection = load_rule_collection_from_path(path_or_text)
    subs: List[Substitution] = []
    skipped = 0
    for rule in collection.rules:
        try:
            subs.append(to_substitution(rule))
        except UnconvertibleRule:
            skipped += 1
    return subs, skipped
