"""Branch stacking: disjoint-device operator placement for parallel branches,
as a sharding (copy of flexflow_tpu/compiler/branch_stacking.py).

The reference maps each operator's task grid onto a specific device subset
via machine-view start coordinates and strides (lib/runtime/src/mapper.h:82-126),
and its machine-mapping DP prices parallel splits onto disjoint resource
halves (get_optimal_machine_mapping.cc, parallel case). The planned executor
runs every op over all the ranks, so it cannot place different ops on
different subsets of them; what it can express is data placement: a tensor
dim sharded over a set of ranks puts each slice's compute on a disjoint
group of devices.

So this pass rewrites ISOMORPHIC parallel branches

    a ── Linear[W0] ─┐
                     ADD ──> out
    b ── Linear[W1] ─┘

into a stacked computation over a new leading branch axis

    Stack(a, b) [k,b,c] ── BatchMatmul[W(k,c,n)] ── ReduceSum(axis 0) ──> out

Sharding the branch axis (the branch_parallel_* substitution rules in
substitutions/rules.py insert `Repartition(dim 0, k)` on both operands and a
`Reduction` after the local sum) then places branch 0 on one half of the
ranks and branch 1 on the other. The search prices the stacked plan like
any other candidate, so the DP explores only plans the executor can run.

Scope: branches must be chains of Linear ops with positionally equal attrs
(same out_channels/bias/activation/dtype) merging at a binary ADD. The
head inputs may come from anywhere (Split outputs, distinct tensors, or the
same tensor). Non-isomorphic branches keep the default lowering.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Tuple

from flexflow_tpu_torch.op_attrs.core import get_parallel_output_shapes
from flexflow_tpu_torch.op_attrs.ops import (
    BatchMatmulAttrs,
    BroadcastAttrs,
    ElementBinaryAttrs,
    ElementBinaryOpType,
    ElementUnaryAttrs,
    ElementUnaryOpType,
    LinearAttrs,
    ReduceAttrs,
    StackAttrs,
    WeightAttrs,
)
from flexflow_tpu_torch.op_attrs.ops.shape_ops import ReduceOpType
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.pcg.initializer import StackedInitializerAttrs
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    ParallelLayerAttrs,
    ParallelTensorAttrs,
)
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node


@dataclass(frozen=True)
class _ChainLink:
    """One Linear along a branch: the op node plus its weight nodes."""

    node: Node
    weight_nodes: Tuple[Node, ...]  # (projection,) or (projection, bias)


@dataclass(frozen=True)
class StackableGroup:
    """A merge node whose k input chains are isomorphic Linear chains."""

    merge: Node
    chains: Tuple[Tuple[_ChainLink, ...], ...]  # per branch, head -> tail
    head_inputs: Tuple[DataflowOutput, ...]  # per branch


def _chain_up(
    pcg: ParallelComputationGraph,
    tail: DataflowOutput,
) -> Tuple[Tuple[_ChainLink, ...], DataflowOutput]:
    """Walk up a maximal single-consumer Linear chain ending at `tail`.
    Returns (links head->tail, the chain head's data input)."""
    links: List[_ChainLink] = []
    t = tail
    while True:
        n = t.node
        attrs = pcg.op_attrs(n)
        if not isinstance(attrs, LinearAttrs):
            break
        ins = pcg.inputs_of(n)
        data_in, weight_vals = ins[0], ins[1:]
        weight_nodes = tuple(v.node for v in weight_vals)
        if not all(
            isinstance(pcg.op_attrs(w), WeightAttrs)
            and len(pcg.uses_of(pcg.outputs_of(w)[0])) == 1
            for w in weight_nodes
        ):
            break  # shared/reused weights cannot be stacked
        links.append(_ChainLink(n, weight_nodes))
        if len(pcg.uses_of(data_in)) != 1:
            # fan-out point: the chain head input
            t = data_in
            break
        t = data_in
    links.reverse()
    return tuple(links), t


def find_stackable_groups(pcg: ParallelComputationGraph) -> List[StackableGroup]:
    groups: List[StackableGroup] = []
    claimed: set = set()  # nodes already part of a found group
    for m in pcg.topological_ordering():
        ma = pcg.op_attrs(m)
        if not (
            isinstance(ma, ElementBinaryAttrs)
            and ma.op_type == ElementBinaryOpType.ADD
        ):
            continue
        ins = pcg.inputs_of(m)
        if len(ins) != 2 or ins[0] == ins[1]:
            continue
        if any(len(pcg.uses_of(v)) != 1 for v in ins):
            continue  # branch outputs must feed only the merge
        chains_heads = [_chain_up(pcg, v) for v in ins]
        chains = tuple(c for c, _ in chains_heads)
        heads = tuple(h for _, h in chains_heads)
        if any(len(c) == 0 for c in chains):
            continue
        if pcg.tensor_shape(heads[0]).num_dims != 2:
            # the stacked rewrite builds rank-3 [k, b, c] activations against
            # rank-3 [k, c, n] weights; rank-3+ branch streams (e.g. per-token
            # dense over [b, s, c]) would need a rank-4 BMM — skip them
            continue
        if len({len(c) for c in chains}) != 1:
            continue
        # positionally equal attrs and equal head-input shapes
        base = chains[0]
        if pcg.tensor_shape(heads[0]) != pcg.tensor_shape(heads[1]):
            continue
        ok = True
        for c in chains[1:]:
            for l0, l1 in zip(base, c):
                if pcg.op_attrs(l0.node) != pcg.op_attrs(l1.node):
                    ok = False
                    break
                i0 = [pcg.tensor_attrs(pcg.outputs_of(w)[0]).initializer
                      for w in l0.weight_nodes]
                i1 = [pcg.tensor_attrs(pcg.outputs_of(w)[0]).initializer
                      for w in l1.weight_nodes]
                if i0 != i1:
                    ok = False
                    break
            if not ok:
                break
        if not ok:
            continue
        # all intermediate chain tensors single-consumer (enforced by
        # _chain_up's walk) and none already claimed by another group
        nodes = {m} | {
            x for c in chains for l in c for x in (l.node, *l.weight_nodes)
        }
        if nodes & claimed:
            continue
        claimed |= nodes
        groups.append(StackableGroup(m, chains, heads))
    return groups


def stack_isomorphic_branches(
    pcg: ParallelComputationGraph,
) -> Tuple[ParallelComputationGraph, Dict[DataflowOutput, DataflowOutput]]:
    """Rewrite every stackable group; returns (new_pcg, value_map).

    value_map covers every surviving tensor (internal branch tensors are
    consumed by the rewrite and have no image; the merge output maps to the
    stacked ReduceSum output)."""
    groups = find_stackable_groups(pcg)
    if not groups:
        ident = {o: o for n in pcg.nodes for o in pcg.outputs_of(n)}
        return pcg, ident

    # node -> its group (for skipping); merge node -> group (for emitting)
    consumed: Dict[Node, StackableGroup] = {}
    for g in groups:
        for c in g.chains:
            for l in c:
                consumed[l.node] = g
                for w in l.weight_nodes:
                    consumed[w] = g
        consumed[g.merge] = g

    out = ParallelComputationGraph()
    value_map: Dict[DataflowOutput, DataflowOutput] = {}

    def add(attrs, name, ins, initializer=None, create_grad=True):
        la = ParallelLayerAttrs(attrs, name)
        in_shapes = [out.tensor_shape(v) for v in ins]
        shapes = get_parallel_output_shapes(attrs, in_shapes)
        labels = [
            ParallelTensorAttrs(s, create_grad, initializer) for s in shapes
        ]
        _, outs = out.add_node(la, ins, labels)
        return outs

    def emit_group(g: StackableGroup) -> None:
        k = len(g.chains)
        mname = pcg.layer_attrs(g.merge).name or f"m{g.merge.idx}"
        x = add(
            StackAttrs(), f"branchstack.{mname}.stack",
            [value_map[h] for h in g.head_inputs],
        )[0]
        for j, links in enumerate(zip(*g.chains)):
            l0 = links[0]
            lin: LinearAttrs = pcg.op_attrs(l0.node)
            in_c = out.tensor_shape(x).sizes()[-1]
            wts = TensorShape((k, in_c, lin.out_channels), lin.dtype)
            w_inits = [
                pcg.tensor_attrs(pcg.outputs_of(w)[0]).initializer
                for w in l0.weight_nodes
            ]
            (wv,) = add(
                WeightAttrs(wts), f"branchstack.{mname}.w{j}", [],
                initializer=StackedInitializerAttrs(w_inits[0], k),
            )
            x = add(
                BatchMatmulAttrs(), f"branchstack.{mname}.bmm{j}", [x, wv]
            )[0]
            if lin.use_bias:
                bts = TensorShape((k, 1, lin.out_channels), lin.dtype)
                (bv,) = add(
                    WeightAttrs(bts), f"branchstack.{mname}.b{j}", [],
                    initializer=StackedInitializerAttrs(w_inits[1], k),
                )
                target = tuple(out.tensor_shape(x).sizes())
                (bb,) = add(
                    BroadcastAttrs(target),
                    f"branchstack.{mname}.bcast{j}", [bv],
                )
                x = add(
                    ElementBinaryAttrs(ElementBinaryOpType.ADD),
                    f"branchstack.{mname}.bias{j}", [x, bb],
                )[0]
            if lin.activation is not None:
                x = add(
                    ElementUnaryAttrs(
                        ElementUnaryOpType(lin.activation.value)
                    ),
                    f"branchstack.{mname}.act{j}", [x],
                )[0]
        (z,) = add(
            ReduceAttrs(ReduceOpType.SUM, (0,)),
            f"branchstack.{mname}.sum", [x],
        )
        value_map[pcg.outputs_of(g.merge)[0]] = z

    for n in pcg.topological_ordering():
        g = consumed.get(n)
        if g is not None:
            if n == g.merge:
                emit_group(g)
            continue
        la = pcg.layer_attrs(n)
        ins = [value_map[v] for v in pcg.inputs_of(n)]
        _, outs = out.add_node(
            la, ins, [pcg.tensor_attrs(o) for o in pcg.outputs_of(n)]
        )
        for old, new in zip(pcg.outputs_of(n), outs):
            value_map[old] = new
    return out, value_map
