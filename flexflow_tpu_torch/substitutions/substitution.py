"""Substitution = pattern + output expr + interface bijections; application
splices the RHS into the PCG with fresh nodes and full shape re-inference
(copy of flexflow_tpu/substitutions/substitution.py).

Reference: lib/substitutions/include/substitutions/substitution.h:10-42 and
src/substitutions/substitution.cc:24-169 (apply_substitution), plus
substitution_internal/{evaluate_substitution_output,perform_shape_inference}.
The validity invariants the reference documents but leaves unimplemented
(is_valid_substitution, substitution.h:10-23) are enforced here by
is_valid_match_for_substitution.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, Tuple

from flexflow_tpu_torch.op_attrs.core import (
    OpAttrs,
    get_parallel_output_shapes,
)
from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    ParallelLayerAttrs,
    ParallelTensorAttrs,
)
from flexflow_tpu_torch.local_execution.training_backing import split_slot_values
from flexflow_tpu_torch.substitutions.output_graph import (
    AttrConstant,
    OutputGraphExpr,
)
from flexflow_tpu_torch.substitutions.pcg_pattern import PCGPattern, PatternMatch
from flexflow_tpu_torch.utils.graph import (
    DataflowOutput,
    GraphInput,
    Node,
)


@dataclass(frozen=True)
class Substitution:
    """pattern inputs <-> output-expr inputs via input_mapping; pattern node
    outputs that form the external interface map to output-expr values via
    output_mapping (reference: substitution.struct.toml's bijections)."""

    name: str
    pattern: PCGPattern
    output_expr: OutputGraphExpr
    input_mapping: Tuple[Tuple[GraphInput, GraphInput], ...]
    output_mapping: Tuple[Tuple[DataflowOutput, DataflowOutput], ...]


def match_interface_is_closed(
    pcg: ParallelComputationGraph, sub: Substitution, match: PatternMatch
) -> bool:
    """Invariant 1 (reference substitution.h:10-23): every matched-node output
    used outside the match is in the interface (output_mapping), so no
    dangling consumers. Cheap check — no graph rebuild."""
    node_map = match.node_map()
    matched_hosts = set(node_map.values())
    interface_pattern_outputs = {po for po, _ in sub.output_mapping}
    for pnode, hnode in node_map.items():
        for po, ho in zip(sub.pattern.graph.outputs_of(pnode), pcg.outputs_of(hnode)):
            external_uses = [
                u for u in pcg.uses_of(ho) if u.node not in matched_hosts
            ]
            if external_uses and po not in interface_pattern_outputs:
                return False
    return True


def is_valid_match_for_substitution(
    pcg: ParallelComputationGraph, sub: Substitution, match: PatternMatch
) -> bool:
    """Invariants (reference substitution.h:10-23): interface closure + RHS
    shape inference succeeds on the matched input shapes."""
    if not match_interface_is_closed(pcg, sub, match):
        return False
    try:
        apply_substitution(pcg, sub, match)
    except (AssertionError, KeyError, ValueError):
        return False
    return True


def apply_substitution(
    pcg: ParallelComputationGraph, sub: Substitution, match: PatternMatch
) -> ParallelComputationGraph:
    """Rebuild the PCG with the matched subgraph replaced by the RHS.

    Shapes are re-inferred for the RHS and, incrementally, for every op
    downstream of a value whose tensor attrs changed (dirty-value
    tracking); ops whose inputs are unchanged keep their labels verbatim
    — shape inference is a pure function of (attrs, input shapes), so the
    result equals the reference's full perform_shape_inference while
    skipping the untouched majority of a large graph.
    """
    node_map = match.node_map()  # pattern node -> host node
    input_map = match.input_map()  # pattern graph input -> host value
    matched_hosts = set(node_map.values())
    in_mapping = dict(sub.input_mapping)  # pattern gi -> output gi
    out_mapping = dict(sub.output_mapping)  # pattern value -> output value

    matched_attrs: Dict[Node, OpAttrs] = {
        pn: pcg.op_attrs(hn) for pn, hn in node_map.items()
    }

    new_pcg = ParallelComputationGraph()
    value_map: Dict[DataflowOutput, DataflowOutput] = {}  # old host -> new

    # host values replaced by RHS values: old host value -> output-expr value
    replaced: Dict[DataflowOutput, DataflowOutput] = {}
    for pval, oval in out_mapping.items():
        host_val = DataflowOutput(node_map[pval.node], pval.idx)
        replaced[host_val] = oval

    rhs_value_map: Dict[DataflowOutput, DataflowOutput] = {}  # output-expr -> new

    # Find a dependency-correct splice point: contract the matched nodes into
    # one meganode and topologically order the contracted graph. This places
    # the splice after ALL producers of RHS inputs and before all consumers of
    # interface outputs (a naive "splice at first matched node in the original
    # topo order" can hit a not-yet-copied producer for multi-node patterns).
    # A cycle through the contraction means the match is invalid.
    from flexflow_tpu_torch.utils.graph.digraph import DiGraph
    from flexflow_tpu_torch.utils.graph.algorithms import get_topological_ordering

    contracted = DiGraph()
    mega = Node(-1)
    contracted._add_existing_node(mega)
    all_nodes = pcg.nodes
    for n in all_nodes:
        if n not in matched_hosts:
            contracted._add_existing_node(n)
    # read-only adjacency walk: pcg.digraph() would copy the whole graph
    orig_succ = pcg._g._succ
    for n in all_nodes:
        src = mega if n in matched_hosts else n
        for s in orig_succ[n]:
            dst = mega if s in matched_hosts else s
            if src != dst and not contracted.has_edge(src, dst):
                contracted.add_edge(src, dst)
    order = get_topological_ordering(contracted)  # raises on invalid (cyclic) match

    def splice_rhs() -> None:
        og = sub.output_expr.graph
        # bind output-expr graph inputs to new-graph values
        gi_binding: Dict[GraphInput, DataflowOutput] = {}
        for p_gi, o_gi in in_mapping.items():
            host_val = input_map[p_gi]
            gi_binding[o_gi] = value_map[host_val]
        for onode in og.topological_ordering():
            assignment = og.node_label(onode)
            if isinstance(assignment, AttrConstant):
                attrs = assignment.attrs
                name = None
            else:
                attrs = assignment.materialize(matched_attrs)
                # the rewritten op inherits the matched op's layer name, so
                # name-based lookups (the model's logit head, debugging)
                # survive arbitrarily many substitutions; an op fused from
                # SEVERAL matched nodes gets the "+"-joined compound name
                # ("q+k") so every original name remains findable, with the
                # position encoding the output index (fusion-rule Split)
                pns = getattr(assignment, "pattern_nodes", None)
                if pns is not None and len(pns) > 1:
                    parts = [pcg.layer_attrs(node_map[p]).name for p in pns]
                    name = "+".join(p or "" for p in parts) if any(parts) else None
                else:
                    name = pcg.layer_attrs(node_map[assignment.pattern_node]).name
            inputs = []
            for v in og.inputs_of(onode):
                if isinstance(v, GraphInput):
                    inputs.append(gi_binding[v])
                else:
                    inputs.append(rhs_value_map[v])
            data, weights = split_slot_values(attrs, inputs)
            in_shapes = [new_pcg.tensor_shape(v) for v in data]
            out_shapes = get_parallel_output_shapes(attrs, in_shapes)
            if weights:
                from flexflow_tpu_torch.op_attrs.core import get_parallel_weight_shapes

                expected_w = get_parallel_weight_shapes(attrs, in_shapes)
                actual_w = [new_pcg.tensor_shape(w) for w in weights]
                assert actual_w == list(expected_w), (
                    f"substitution RHS weight shapes inconsistent for {attrs}: "
                    f"{actual_w} != {list(expected_w)}"
                )
            assert len(out_shapes) == len(og.outputs_of(onode))
            _, new_outs = new_pcg.add_node(
                ParallelLayerAttrs(attrs, name),
                inputs,
                [ParallelTensorAttrs(s) for s in out_shapes],
            )
            for ov, nv in zip(og.outputs_of(onode), new_outs):
                rhs_value_map[ov] = nv

    def resolve(old_val: DataflowOutput) -> DataflowOutput:
        if old_val in replaced:
            return rhs_value_map[replaced[old_val]]
        return value_map[old_val]

    # values whose tensor attrs differ from the old graph's counterpart:
    # only nodes consuming one need re-inference (the untouched majority of
    # a large graph keeps its labels — full re-inference per candidate was a
    # top search-generation hotspot)
    dirty: set = set()

    def mark_spliced_interface() -> None:
        for pval, oval in out_mapping.items():
            old_val = DataflowOutput(node_map[pval.node], pval.idx)
            new_val = rhs_value_map[oval]
            if new_pcg.tensor_attrs(new_val) != pcg.tensor_attrs(old_val):
                dirty.add(new_val)

    for n in order:
        if n == mega:
            splice_rhs()
            mark_spliced_interface()
            continue
        la = pcg.layer_attrs(n)
        attrs = la.attrs
        old_inputs = pcg.inputs_of(n)
        new_inputs = [resolve(v) for v in old_inputs]
        old_outputs = pcg.outputs_of(n)
        old_labels = [pcg.tensor_attrs(o) for o in old_outputs]
        if isinstance(attrs, (InputAttrs, WeightAttrs)):
            out_labels = old_labels
        elif not any(v in dirty for v in new_inputs):
            out_labels = old_labels  # no input changed: shapes are identical
        else:
            data, weights = split_slot_values(attrs, new_inputs)
            in_shapes = [new_pcg.tensor_shape(v) for v in data]
            out_shapes = get_parallel_output_shapes(attrs, in_shapes)
            out_labels = [
                ParallelTensorAttrs(s, ol.create_grad, ol.initializer)
                for s, ol in zip(out_shapes, old_labels)
            ]
        _, new_outs = new_pcg.add_node(la, new_inputs, out_labels)
        for ov, nv, ol, nl in zip(
            old_outputs, new_outs, old_labels, out_labels
        ):
            value_map[ov] = nv
            if nl is not ol and nl != ol:
                dirty.add(nv)

    if os.environ.get("FF_TPU_VERIFY") not in (None, "", "0"):
        # static-verification mode (analysis/pcg_verify.py): every candidate
        # the search produces is checked for the structural PCG invariants
        # before it can be priced; a violation raises ValueError, which the
        # search loops treat as "rewrite rejected". The winner is always
        # verified (with the SP and machine-view rules) in FFModel.compile.
        from flexflow_tpu_torch.analysis.diagnostics import errors_of, format_diagnostic
        from flexflow_tpu_torch.analysis.pcg_verify import verify_pcg_structure

        errs = errors_of(verify_pcg_structure(new_pcg))
        if errs:
            raise ValueError(
                f"FF_TPU_VERIFY: substitution {sub.name!r} produced an ill-formed PCG:\n"
                + "\n".join(format_diagnostic(d) for d in errs))

    return new_pcg
