"""Non-isomorphic parallel branches on disjoint groups of ranks (port of
flexflow_tpu/parallel/submesh.py).

Isomorphic branches get disjoint placement as a sharding through branch
stacking (compiler/branch_stacking.py); this module covers the rest: a
split whose branches differ. The graph is cut into islands

    pre -> [branch_0 | branch_1 | ...] -> post (+ the loss)

The JAX package runs each island as its own jit program on its own
`jax.sharding.Mesh` and moves values between meshes with `device_put`. Here
each rank is one process: `pre` and `post` run on every rank, each on its
block of the batch's rows (rank r of n holds rows [r B/n, (r+1) B/n)), and
branch i runs on rank group i (ranks [i g, (i+1) g), g = n // branches),
each member on its block of rows; branch i's parameters exist only on its
group. At the fork and the join the rows move explicitly, point to point,
from the blocks one layout holds to the blocks the other needs, and the
gradients move back the same way. Every island is rematerialized in its
backward (its forward recomputed under autograd from its stored inputs).
Each rank's loss is the mean over its rows times their share of the batch,
so the gradients summed over the ranks that hold a parameter (all ranks
for pre and post, the group for a branch) are the whole batch's; every
island then takes its optimizer step on its own ranks.

A fused window (`multi_train_step`) runs its K steps eagerly in one call.
Dropout raises, as in the JAX package: the islands do not thread the
step's generator.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels import apply_optimizer_, forward as kernel_forward
from flexflow_tpu_torch.kernels import loss_forward, make_optimizer_state
from flexflow_tpu_torch.kernels.metrics import compute_metrics
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    init_params,
    param_key,
    split_slot_values,
)
from flexflow_tpu_torch.op_attrs.ops import DropoutAttrs, InputAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.ops.shape_ops import SplitAttrs
from flexflow_tpu_torch.parallel.pipeline import _P2P
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node


def find_branch_partition(cg):
    """Partition the CG around its first Split fork whose per-output
    consumer cones are disjoint until a join: (pre_nodes, [branch node
    sets...], post_nodes), or None when the graph has no such split
    (branches of one node each are accepted: the point is placement, not
    size)."""
    dg = cg.digraph()
    topo = cg.topological_ordering()
    order = {n: i for i, n in enumerate(topo)}

    def cone(rs: frozenset) -> Set[Node]:
        seen: Set[Node] = set(rs)
        stack = list(rs)
        while stack:
            m = stack.pop()
            for s in dg.successors(m):
                if s not in seen:
                    seen.add(s)
                    stack.append(s)
        return seen

    for n in topo:
        if not isinstance(cg.op_attrs(n), SplitAttrs):
            continue
        outs = cg.outputs_of(n)
        if len(outs) < 2:
            continue
        roots = [frozenset(u.node for u in cg.uses_of(o)) for o in outs]
        if any(not r for r in roots):
            continue
        cones = [cone(r) for r in roots]
        shared: Set[Node] = set()
        for i in range(len(cones)):
            for j in range(i + 1, len(cones)):
                shared |= cones[i] & cones[j]
        if not shared:
            continue  # the branches never join again: not the pattern
        join = min(shared, key=lambda m: order[m])
        branches = []
        for c in cones:
            body = {m for m in c if order[m] < order[join] and m not in shared}
            if not body:
                break
            branches.append(body)
        else:
            # weights and inputs consumed by exactly one island move into it
            claimed: Set[Node] = set().union(*branches)
            post = {m for m in topo if order[m] >= order[join]} - claimed
            pre = set(topo) - claimed - post
            for m in list(pre):
                if not isinstance(cg.op_attrs(m), (InputAttrs, WeightAttrs)):
                    continue
                users = {u.node for o in cg.outputs_of(m) for u in cg.uses_of(o)}
                for b in branches:
                    if users and users <= b:
                        pre.discard(m)
                        b.add(m)
                        break
            # no edge may cross between branches
            ok = all(not any(s in b for m in a for s in dg.successors(m))
                     for i, a in enumerate(branches) for j, b in enumerate(branches) if i != j)
            if ok:
                return pre, branches, post
    return None


def _island_boundaries(cg, nodes: Set[Node]):
    """(incoming values, outgoing values) of an island, in topological
    order; a graph input the island holds counts as incoming."""
    order = {n: i for i, n in enumerate(cg.topological_ordering())}
    ins: List[DataflowOutput] = []
    outs: List[DataflowOutput] = []
    for n in sorted(nodes, key=lambda m: order[m]):
        if isinstance(cg.op_attrs(n), InputAttrs):
            ins.append(cg.outputs_of(n)[0])
            continue
        for v in cg.inputs_of(n):
            if v.node not in nodes and v not in ins:
                ins.append(v)
        for v in cg.outputs_of(n):
            if any(u.node not in nodes for u in cg.uses_of(v)) and v not in outs:
                outs.append(v)
    return ins, outs


def _run_island(cg, nodes: Set[Node], params: Dict, env: Dict) -> Dict:
    """Evaluate the island's nodes into env (its incoming values bound)."""
    order = {n: i for i, n in enumerate(cg.topological_ordering())}
    for n in sorted(nodes, key=lambda m: order[m]):
        attrs = cg.op_attrs(n)
        outs = cg.outputs_of(n)
        if isinstance(attrs, InputAttrs):
            continue  # bound by the caller
        if isinstance(attrs, WeightAttrs):
            env[outs[0]] = params[param_key(n)]
            continue
        data, weights = split_slot_values(attrs, [env[v] for v in cg.inputs_of(n)])
        for o, r in zip(outs, kernel_forward(attrs, data, weights)):
            env[o] = r
    return env


Layout = List[Tuple[int, int, int]]  # (rank, first row, row past the last)


def _blocks(ranks: Sequence[int], rows: int) -> Layout:
    n = rows // len(ranks)
    return [(r, i * n, (i + 1) * n) for i, r in enumerate(ranks)]


class SubmeshBranchInstance(ModelTrainingInstance):
    """Train a Split-forked CG with each branch on its own group of ranks
    (see the module docstring): `initialize()` -> (params, opt_state), both
    {island: {key: tensor}} with only this rank's islands; `train_step`,
    `multi_train_step` and `forward` as the other trainers'."""

    def __init__(
        self,
        cg,
        logit_tensor: DataflowOutput,
        loss_attrs,
        optimizer_attrs,
        partition=None,
        device=None,
        metrics=frozenset(),
    ) -> None:
        from flexflow_tpu_torch.parallel.data_parallel import _rank_device, new_subgroup

        for n in cg.topological_ordering():
            if isinstance(cg.op_attrs(n), DropoutAttrs):
                raise ValueError(
                    "SubmeshBranchInstance does not thread the step's generator through its "
                    "islands; Dropout would train without stochasticity: use another backend")
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group is initialized: open one first (e.g. parallel.init_file_group)")
        part = partition or find_branch_partition(cg)
        if part is None:
            raise ValueError("graph has no Split-fork branch partition")
        self.pre_nodes, self.branch_nodes, self.post_nodes = part
        self.world, self.rank = dist.get_world_size(), dist.get_rank()
        nb = len(self.branch_nodes)
        if self.world < nb:
            raise ValueError(f"{nb} branches need at least {nb} ranks, the group has {self.world}")
        super().__init__(cg, logit_tensor, loss_attrs, optimizer_attrs,
                         device=_rank_device(device, self.rank), metrics=metrics)
        g = self.world // nb
        # branch i's ranks; every rank opens every group, in the same order
        self.branch_ranks = [list(range(i * g, (i + 1) * g)) for i in range(nb)]
        self.branch_groups = [new_subgroup(r) for r in self.branch_ranks]
        self.my_branch = next((i for i, r in enumerate(self.branch_ranks) if self.rank in r),
                              None)
        self.pre_in, self.pre_out = _island_boundaries(cg, self.pre_nodes)
        self.branch_bounds = [_island_boundaries(cg, b) for b in self.branch_nodes]
        self.post_in, _ = _island_boundaries(cg, self.post_nodes)
        self._island_of: Dict[Node, str] = {}
        for n in self.pre_nodes:
            self._island_of[n] = "pre"
        for i, b in enumerate(self.branch_nodes):
            for n in b:
                self._island_of[n] = f"branch{i}"
        for n in self.post_nodes:
            self._island_of[n] = "post"
        self.p2p = _P2P(self.device)

    def islands(self) -> List[str]:
        """The islands whose parameters this rank holds."""
        mine = ["pre"] + ([f"branch{self.my_branch}"] if self.my_branch is not None else [])
        return mine + ["post"]

    def island_ranks(self, island: str) -> List[int]:
        if island.startswith("branch"):
            return self.branch_ranks[int(island[len("branch"):])]
        return list(range(self.world))

    def initialize(self, seed: int = 0):
        """Per-island parameter dicts from the graph's initializers (the
        single-device trainer's values), each only on its island's ranks."""
        flat = init_params(self.cg, seed, "cpu")
        params: Dict[str, Dict[str, torch.Tensor]] = {i: {} for i in self.islands()}
        for n in self.cg.topological_ordering():
            if isinstance(self.cg.op_attrs(n), WeightAttrs) and self._island_of[n] in params:
                params[self._island_of[n]][param_key(n)] = flat[param_key(n)].to(self.device)
        opt_state = {k: make_optimizer_state(self.optimizer_attrs, v) for k, v in params.items()}
        return params, opt_state

    def _capturable(self) -> bool:
        return False

    # -- rows -----------------------------------------------------------------

    def _full(self, rows: int) -> Layout:
        return _blocks(range(self.world), rows)

    def _branch(self, i: int, rows: int) -> Layout:
        return _blocks(self.branch_ranks[i], rows)

    def _move(self, x: Optional[torch.Tensor], src: Layout, dst: Layout, shape, dtype
              ) -> Optional[torch.Tensor]:
        """Rows from the blocks of layout `src` (x: this rank's, None where
        it holds none) to those of `dst`: this rank's block under dst, or
        None. Every rank calls it, in the same order."""
        me = self.rank
        mine = next(((a, b) for r, a, b in dst if r == me), None)
        out = None if mine is None else torch.empty(
            (mine[1] - mine[0],) + tuple(shape[1:]), dtype=dtype, device=self.device)
        sends, recvs, places = [], [], []
        for rs, a, b in src:
            for rd, c, d in dst:
                lo, hi = max(a, c), min(b, d)
                if lo >= hi or (rs != me and rd != me):
                    continue
                if rs == me and rd == me:
                    out[lo - c:hi - c] = x[lo - a:hi - a]
                elif rs == me:
                    sends.append((x[lo - a:hi - a], rd, 2))
                else:
                    recvs.append(((hi - lo,) + tuple(shape[1:]), dtype, rs, 2))
                    places.append((lo - c, hi - c))
        for (lo, hi), got in zip(places, self.p2p.exchange(sends, recvs)):
            out[lo:hi] = got
        return out

    def _sum_over(self, tensors: Dict[str, torch.Tensor], island: str) -> None:
        """Sum the island's gradients over its ranks, in place."""
        if not tensors or len(self.island_ranks(island)) == 1:
            return
        group = (None if not island.startswith("branch")
                 else self.branch_groups[int(island[len("branch"):])])
        flat = torch.cat([t.reshape(-1) for t in tensors.values()])
        dist.all_reduce(flat, group=group)
        i = 0
        for t in tensors.values():
            t.copy_(flat[i:i + t.numel()].view_as(t))
            i += t.numel()

    # -- islands ----------------------------------------------------------------

    def _bind(self, batch, v: DataflowOutput, layout: Layout) -> torch.Tensor:
        """This rank's rows (under `layout`) of graph input v from the batch."""
        la = self.cg.layer_attrs(v.node)
        key = la.name if la.name is not None and la.name in batch else param_key(v.node)
        x = torch.as_tensor(batch[key], device=self.device)
        a, b = next((a, b) for r, a, b in layout if r == self.rank)
        return x[a:b]

    def _island(self, nodes, ins, outs, params, in_vals) -> Tuple[torch.Tensor, ...]:
        env = _run_island(self.cg, nodes, params, dict(zip(ins, in_vals)))
        return tuple(env[v] for v in outs)

    def _shape(self, v: DataflowOutput):
        return tuple(self.cg.tensor_shape(v).dims)

    def _dtype(self, v: DataflowOutput) -> torch.dtype:
        return self.cg.tensor_shape(v).dtype.to_torch()

    def _forward_islands(self, params, batch):
        """The forward over the islands: (pre's incoming values, pre's
        outgoing values, each branch's incoming values here, each branch's
        outgoing values here, post's incoming values), this rank's rows."""
        rows = torch.as_tensor(batch[next(iter(batch))]).shape[0]
        full = self._full(rows)
        pre_vals = tuple(self._bind(batch, v, full) for v in self.pre_in)
        with torch.no_grad():
            pre_out = self._island(self.pre_nodes, self.pre_in, self.pre_out, params["pre"],
                                   pre_vals)
        value_of = dict(zip(self.pre_out, pre_out))
        b_in, b_out = [], []
        for i, (ins, outs) in enumerate(self.branch_bounds):
            layout = self._branch(i, rows)
            moved = []
            for v in ins:
                if isinstance(self.cg.op_attrs(v.node), InputAttrs):
                    moved.append(self._bind(batch, v, layout) if i == self.my_branch else None)
                else:
                    moved.append(self._move(value_of[v], full, layout,
                                            (rows,) + self._shape(v)[1:], self._dtype(v)))
            b_in.append(tuple(moved))
            if i == self.my_branch:
                with torch.no_grad():
                    got = self._island(self.branch_nodes[i], ins, outs, params[f"branch{i}"],
                                       moved)
            else:
                got = (None,) * len(outs)
            b_out.append(got)
        for i, (_, outs) in enumerate(self.branch_bounds):
            layout = self._branch(i, rows)
            for v, x in zip(outs, b_out[i]):
                value_of[v] = self._move(x, layout, full, (rows,) + self._shape(v)[1:],
                                         self._dtype(v))
        post_vals = tuple(value_of[v] for v in self.post_in)
        return pre_vals, pre_out, b_in, b_out, post_vals, rows

    def _step(self, params, opt_state, batch_inputs, label, rng, live=None):
        """One step: the islands' forward, then their backwards in reverse,
        each recomputing its forward; the gradients summed over each
        island's ranks; each island's update on its own ranks."""
        cg = self.cg
        pre_vals, pre_out, b_in, _, post_vals, rows = self._forward_islands(params, batch_inputs)
        full = self._full(rows)
        a, b = next((a, b) for r, a, b in full if r == self.rank)
        label = torch.as_tensor(label, device=self.device)[a:b]
        share = (b - a) / rows

        # post (and the loss): the gradients of its params and incoming values
        leaves = {k: p.detach().requires_grad_(True) for k, p in params["post"].items()}
        xin = tuple(v.detach().requires_grad_(True) for v in post_vals)
        with torch.enable_grad():
            (logit,) = self._island(self.post_nodes, self.post_in, (self.logit_tensor,), leaves,
                                    xin)
            loss = loss_forward(self.loss_attrs, logit, label) * share
            got = torch.autograd.grad(loss, list(leaves.values()) + list(xin), allow_unused=True)
        grads = {"post": {k: torch.zeros_like(leaves[k]) if g is None else g
                          for k, g in zip(leaves, got[:len(leaves)])}}
        cot_of = {v: (torch.zeros_like(x) if g is None else g)
                  for v, x, g in zip(self.post_in, xin, got[len(leaves):])}
        mvals = compute_metrics(self.metrics, logit.detach(), label)

        # the branches, in reverse: the cotangents of their outputs move to
        # their groups, those of their incoming values back to every rank
        dpre_out: Dict[DataflowOutput, Optional[torch.Tensor]] = {v: None for v in self.pre_out}
        for i in reversed(range(len(self.branch_bounds))):
            ins, outs = self.branch_bounds[i]
            layout = self._branch(i, rows)
            cots = tuple(self._move(cot_of[v], full, layout, (rows,) + self._shape(v)[1:],
                                    self._dtype(v)) for v in outs)
            d_in: List[Optional[torch.Tensor]] = [None] * len(ins)
            if i == self.my_branch:
                island = f"branch{i}"
                bleaves = {k: p.detach().requires_grad_(True) for k, p in params[island].items()}
                diff = [j for j, v in enumerate(ins)
                        if not isinstance(cg.op_attrs(v.node), InputAttrs)]
                bx = [x.detach().requires_grad_(j in diff) for j, x in enumerate(b_in[i])]
                with torch.enable_grad():
                    y = self._island(self.branch_nodes[i], ins, outs, bleaves, bx)
                    got = torch.autograd.grad(y, list(bleaves.values()) + [bx[j] for j in diff],
                                              grad_outputs=cots, allow_unused=True)
                grads[island] = {k: torch.zeros_like(bleaves[k]) if g is None else g
                                 for k, g in zip(bleaves, got[:len(bleaves)])}
                for j, g in zip(diff, got[len(bleaves):]):
                    d_in[j] = torch.zeros_like(bx[j]) if g is None else g
            for v, g in zip(ins, d_in):
                if isinstance(cg.op_attrs(v.node), InputAttrs):
                    continue  # gradients of graph inputs are dropped
                back = self._move(g, layout, full, (rows,) + self._shape(v)[1:], self._dtype(v))
                dpre_out[v] = back if dpre_out[v] is None else dpre_out[v] + back
        # pre's values that post reads directly
        for v in self.pre_out:
            if v in cot_of:
                dpre_out[v] = cot_of[v] if dpre_out[v] is None else dpre_out[v] + cot_of[v]

        # pre
        pleaves = {k: p.detach().requires_grad_(True) for k, p in params["pre"].items()}
        pre_cots = tuple(torch.zeros_like(x) if dpre_out[v] is None else dpre_out[v]
                         for v, x in zip(self.pre_out, pre_out))
        if pleaves:
            with torch.enable_grad():
                y = self._island(self.pre_nodes, self.pre_in, self.pre_out, pleaves, pre_vals)
                got = torch.autograd.grad(y, list(pleaves.values()), grad_outputs=pre_cots,
                                          allow_unused=True)
            grads["pre"] = {k: torch.zeros_like(pleaves[k]) if g is None else g
                            for k, g in zip(pleaves, got)}
        else:
            grads["pre"] = {}

        # sums over each island's ranks; the loss and the metrics over all
        for island in self.islands():
            self._sum_over(grads[island], island)
        tensors = {k: v for k, v in mvals.items() if not isinstance(v, int)}
        bucket = torch.stack([loss.detach().float()] + [v.float().reshape(())
                                                        for v in tensors.values()])
        dist.all_reduce(bucket)
        out = {k: (bucket[1 + i] if v.is_floating_point() else bucket[1 + i].round().to(v.dtype))
               for i, (k, v) in enumerate(tensors.items())}
        out.update({k: v * self.world for k, v in mvals.items() if isinstance(v, int)})
        for island in self.islands():
            apply_optimizer_(self.optimizer_attrs, params[island], grads[island],
                             opt_state[island])
        return params, opt_state, bucket[0], out, None

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """The whole batch's logits on every rank."""
        _, _, _, _, post_vals, rows = self._forward_islands(params, batch_inputs)
        (logit,) = self._island(self.post_nodes, self.post_in, (self.logit_tensor,),
                                params["post"], post_vals)
        staged = self.p2p.staged
        part = logit.cpu() if staged else logit.contiguous()
        parts = [torch.empty_like(part) for _ in range(self.world)]
        dist.all_gather(parts, part)
        out = torch.cat(parts)
        return out.to(self.device) if staged else out
