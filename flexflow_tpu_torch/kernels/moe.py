"""Mixture of experts: GroupBy, Aggregate and the fused Experts forward
(port of flexflow_tpu/kernels/moe.py).

The JAX package writes dispatch and combine as one-hot einsums (the
GShard formulation): D[n, e, c] = 1 where routing decision n goes to slot c
of expert e. That tensor has N*k x E x capacity entries, and the capacity
grows with N, so it grows as N^2: at 8192 tokens, 8 experts, top-2 and a
capacity factor of 2 it is 2.1 GB of f32 a layer, nearly all zeros. The
port computes the same decisions by index instead:

- each flattened decision n (row-major over (token, select), so earlier
  tokens win capacity, as the legacy GroupBy's first-come scatter order)
  gets pos[n], the count of earlier decisions to the same expert: a cumsum
  over an [N*k, E] one-hot of integers;
- decisions with pos < capacity are kept. Dispatch writes x[token(n)] into
  slot (expert, pos): each slot has at most one writer, so it is a copy by
  index with no adds. Dropped decisions write to a spare row that is cut
  off, so no shape depends on the data and nothing reads the device from
  the host;
- the expert MLPs are two `torch.bmm` over [E, capacity, .], plain large
  products that the JAX package too computes outside any Pallas kernel;
- combine gathers each decision's slot, weights it by its renormalized
  top-k gate and sums a token's k decisions.

As in the JAX package the gate, the dispatch, both expert products and the
combine run in f32 (the card's f32 matmuls take full f32 unless the caller
enables TF32), and the output is cast back to the input's dtype. Gradients
come from autograd through the gather, the copy and the products; the
routing indices carry none, and the gate's gradient flows through the
renormalized top-k values and the aux loss's mean probability.

`dispatch_mask` and the `*_dense` functions keep the JAX package's einsum
formulas as the plain versions the tests hold the index path against.

Over ranks that split the batch (`batch_routing`), the Experts forward
routes the global batch as the JAX package's global-view op does: the
capacity counts every token, positions continue the earlier blocks' counts
(all-gathered per expert, in the global batch's row order), and the
load-balance loss is a product of global means whose sums are all-reduced,
differentiably. Under expert parallelism each rank runs the experts
[first_expert, first_expert + w1.shape[0]) and combines only their slots:
its output is a partial sum over the expert ranks.
"""

from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import torch
import torch.nn.functional as F

from flexflow_tpu_torch.op_attrs.ops.moe import (
    AggregateAttrs,
    ExpertsAttrs,
    GroupByAttrs,
    expert_capacity,
)


def top_k(x: torch.Tensor, k: int):
    """(values, int64 indices) of the k largest entries of x's last dim, in
    descending order, ties broken towards the lower index as lax.top_k
    breaks them (a stable descending sort keeps equal entries in index
    order)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


def _one_hot(assign: torch.Tensor, n_experts: int) -> torch.Tensor:
    """[N, E] int64 one-hot of the decisions; an index outside [0, E) is a
    zero row (jax.nn.one_hot's convention), so it goes nowhere. A
    comparison, not F.one_hot, which reads the indices' range back to the
    host."""
    experts = torch.arange(n_experts, device=assign.device)
    return (assign[:, None] == experts).long()


def positions(assign: torch.Tensor, n_experts: int):
    """(pos, counts): pos[n] is the number of earlier decisions of `assign`
    ([N] expert per decision) to the same expert, -1 for a decision to no
    expert; counts[e] is how many decisions went to e. The running counts
    scan each expert's row of the transposed [E, N] one-hot (a scan along
    the contiguous dim: down the N rows of [N, E] with E = 8 columns, the
    card's scan takes ~3 ms at N = 16384)."""
    onehot = _one_hot(assign.long(), n_experts)
    running = onehot.t().contiguous().cumsum(1)
    pos = (running.t() * onehot).sum(1) - 1
    return pos, running[:, -1] if assign.numel() else onehot.sum(0)


def dispatch_mask(assign: torch.Tensor, n_experts: int, capacity: int) -> torch.Tensor:
    """The JAX package's one-hot dispatch tensor D[n, e, c] (f32): 1 iff
    decision n goes to expert e at buffer slot c; decisions past capacity
    are dropped. The plain version the index path is held against."""
    onehot = _one_hot(assign.long(), n_experts)
    pos = onehot.cumsum(0) * onehot - 1
    keep = (pos >= 0) & (pos < capacity)
    d = F.one_hot(pos.clamp(0, capacity - 1), capacity)
    return (d * keep[..., None]).float()


def _slots(assign: torch.Tensor, pos: torch.Tensor, capacity: int, first: int, count: int):
    """Each decision's row in [count * capacity + 1]-row buffers of the
    experts [first, first + count): (expert - first) * capacity + pos where
    it is kept and local, else the spare last row."""
    local = (assign >= first) & (assign < first + count) & (pos >= 0) & (pos < capacity)
    return torch.where(local, (assign - first) * capacity + pos,
                       torch.full_like(pos, count * capacity))


def _dispatch(x: torch.Tensor, k: int, slots: torch.Tensor, n_slots: int) -> torch.Tensor:
    """[n_slots, D]: decision i (token i // k, row-major over (token,
    select)) copies its token's row of x [N, D] into slot slots[i] (unique
    among the kept; the others land in the spare row, which is cut off)."""
    buf = x.new_zeros((n_slots + 1, x.shape[1]))
    return buf.index_copy(0, slots, x.repeat_interleave(k, dim=0))[:n_slots]


def _combine(buffers: torch.Tensor, slots: torch.Tensor, gates: torch.Tensor, k: int):
    """[N, O]: each token's k decisions' slots of `buffers` ([n_slots, O]),
    weighted by their gates, summed (the spare row reads zero)."""
    flat = torch.cat([buffers, buffers.new_zeros((1, buffers.shape[1]))])
    vals = flat.index_select(0, slots) * gates.reshape(-1, 1)
    return vals.view(-1, k, flat.shape[1]).sum(1)


def _expert_mlp(attrs: ExpertsAttrs, expert_in, w1, b1, w2, b2) -> torch.Tensor:
    """The experts' two-layer MLPs on their buffers [E, capacity, D], in
    f32: two batched products."""
    h = torch.bmm(expert_in, w1.float())
    if b1 is not None:
        h = h + b1.float()[:, None, :]
    if attrs.activation is not None:
        h = attrs.activation.apply(h)
    y_e = torch.bmm(h, w2.float())
    return y_e if b2 is None else y_e + b2.float()[:, None, :]


def group_by_forward(attrs: GroupByAttrs, data: torch.Tensor, assign: torch.Tensor
                     ) -> List[torch.Tensor]:
    """data [B, D], assign [B, k] -> n_experts buffers [capacity, D]."""
    b, k = assign.shape
    e = attrs.n_experts
    cap = expert_capacity(data.shape[0], e, k, attrs.alpha)
    a = assign.reshape(-1).long()
    pos, _ = positions(a, e)
    grouped = _dispatch(data.float(), k, _slots(a, pos, cap, 0, e), e * cap).to(data.dtype)
    return list(grouped.view(e, cap, -1).unbind(0))


def aggregate_forward(attrs: AggregateAttrs, gate_preds: torch.Tensor,
                      gate_assign: torch.Tensor, exp_preds: Sequence[torch.Tensor]
                      ) -> torch.Tensor:
    """Weighted un-dispatch: [B, k] gates + n x [cap, D] -> [B, D]."""
    b, k = gate_assign.shape
    cap = exp_preds[0].shape[0]
    a = gate_assign.reshape(-1).long()
    pos, _ = positions(a, attrs.n)
    stacked = torch.stack(list(exp_preds)).float().reshape(attrs.n * cap, -1)
    out = _combine(stacked, _slots(a, pos, cap, 0, attrs.n), gate_preds.float(), k)
    return out.to(exp_preds[0].dtype)


def group_by_forward_dense(attrs: GroupByAttrs, data, assign) -> List[torch.Tensor]:
    """The JAX package's group_by_forward, einsums and all (plain version)."""
    b, k = assign.shape
    cap = expert_capacity(data.shape[0], attrs.n_experts, k, attrs.alpha)
    d = dispatch_mask(assign.reshape(-1), attrs.n_experts, cap)
    grouped = torch.einsum("nec,nd->ecd", d, data.repeat_interleave(k, dim=0).float())
    return list(grouped.to(data.dtype).unbind(0))


def aggregate_forward_dense(attrs: AggregateAttrs, gate_preds, gate_assign, exp_preds):
    """The JAX package's aggregate_forward (plain version)."""
    b, k = gate_assign.shape
    d = dispatch_mask(gate_assign.reshape(-1), attrs.n, exp_preds[0].shape[0])
    combine = d * gate_preds.reshape(-1)[:, None, None].float()
    out = torch.einsum("nec,ecd->nd", combine, torch.stack(list(exp_preds)).float())
    return out.reshape(b, k, -1).sum(1).to(exp_preds[0].dtype)


@dataclass
class BatchRouting:
    """The ranks that split the batch, as the Experts forward needs them:
    this rank's block `index` of `size` blocks (the global batch's rows in
    block order), `gather(t)` the blocks' tensors t stacked in block order
    (no gradient), `all_reduce(t)` their sum, differentiable (its backward
    all-reduces the gradient)."""

    index: int
    size: int
    gather: Callable[[torch.Tensor], torch.Tensor]
    all_reduce: Callable[[torch.Tensor], torch.Tensor]


_routing_tls = threading.local()


@contextlib.contextmanager
def batch_routing(routing: Optional[BatchRouting]):
    """Declare that the batch is split over ranks (as batch_stats_group does
    for BatchNorm): within, the Experts forward routes the global batch."""
    prev = getattr(_routing_tls, "routing", None)
    _routing_tls.routing = routing
    try:
        yield
    finally:
        _routing_tls.routing = prev


def current_batch_routing() -> Optional[BatchRouting]:
    return getattr(_routing_tls, "routing", None)


def _unpack(attrs: ExpertsAttrs, weights):
    if attrs.use_bias:
        return weights
    gate_w, w1, w2 = weights
    return gate_w, w1, None, w2, None


def route(attrs: ExpertsAttrs, x2: torch.Tensor, gate_w: torch.Tensor):
    """The gate of tokens x2 [N, D]: (probs [N, E] f32, renormalized top-k
    gates [N, k], top-k experts [N, k])."""
    probs = torch.softmax(x2.float() @ gate_w.float(), dim=-1)
    topv, topi = top_k(probs, attrs.num_select)
    return probs, topv / topv.sum(dim=-1, keepdim=True), topi


def experts_forward(attrs: ExpertsAttrs, x: torch.Tensor, weights: Sequence[torch.Tensor],
                    first_expert: int = 0, decisions: Optional[dict] = None
                    ) -> List[torch.Tensor]:
    """The fused MoE FFN by index (module note). x [.., D]; weights in
    ExpertsAttrs' slot order, the expert tensors those of the experts
    [first_expert, first_expert + w1.shape[0]). Returns [out] or, with
    lambda_bal > 0, [out, aux [1]]. `decisions`: a dict that receives the
    routing (topi [N, k], pos [N*k] global slot positions, capacity)."""
    gate_w, w1, b1, w2, b2 = _unpack(attrs, weights)
    routing = current_batch_routing()
    lead, dmodel = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, dmodel)
    n_local = x2.shape[0]
    blocks = routing.size if routing is not None else 1
    n = n_local * blocks
    e, k = attrs.num_experts, attrs.num_select
    cap = expert_capacity(n, e, k, attrs.capacity_factor)

    probs, gates, topi = route(attrs, x2, gate_w)
    a = topi.reshape(-1)
    pos, counts = positions(a, e)
    if routing is not None:
        # the earlier blocks' decisions come first in the global order
        per_block = routing.gather(counts)
        pos = pos + per_block[:routing.index].sum(0)[a]
        counts = per_block.sum(0)
    if decisions is not None:
        decisions.update(topi=topi, pos=pos, capacity=cap)

    local = w1.shape[0]
    slots = _slots(a, pos, cap, first_expert, local)
    expert_in = _dispatch(x2.float(), k, slots, local * cap)
    y_e = _expert_mlp(attrs, expert_in.view(local, cap, dmodel), w1, b1, w2, b2)
    y2 = _combine(y_e.reshape(local * cap, -1), slots, gates, k)
    out = y2.reshape(*lead, y2.shape[-1]).to(x.dtype)
    if attrs.lambda_bal <= 0:
        return [out]
    # Switch-transformer load balance, E * sum_e f_e * P_e, over the global
    # batch: f_e the share of all decisions routed to e, P_e the mean gate
    # probability
    frac = counts.float() / (n * k)
    prob_sum = probs.sum(0)
    if routing is not None:
        prob_sum = routing.all_reduce(prob_sum)
    aux = attrs.lambda_bal * e * torch.sum(frac * (prob_sum / n))
    return [out, aux.reshape(1).to(x.dtype)]


def experts_forward_dense(attrs: ExpertsAttrs, x: torch.Tensor,
                          weights: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The JAX package's experts_forward, one-hot einsums and all, on one
    device (the plain version; it builds the [N, E, capacity] tensors the
    index path avoids)."""
    gate_w, w1, b1, w2, b2 = _unpack(attrs, weights)
    lead, dmodel = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, dmodel)
    n = x2.shape[0]
    e, k = attrs.num_experts, attrs.num_select
    cap = expert_capacity(n, e, k, attrs.capacity_factor)
    probs, topv, topi = route(attrs, x2, gate_w)
    d = dispatch_mask(topi.reshape(-1), e, cap).reshape(n, k, e, cap)
    dispatch = d.sum(1)
    combine = (d * topv[..., None, None]).sum(1)
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x2.float())
    h = torch.einsum("ecd,edh->ech", expert_in, w1.float())
    if b1 is not None:
        h = h + b1.float()[:, None, :]
    if attrs.activation is not None:
        h = attrs.activation.apply(h)
    y_e = torch.einsum("ech,eho->eco", h, w2.float())
    if b2 is not None:
        y_e = y_e + b2.float()[:, None, :]
    y2 = torch.einsum("nec,eco->no", combine, y_e)
    out = y2.reshape(*lead, y2.shape[-1]).to(x.dtype)
    if attrs.lambda_bal <= 0:
        return [out]
    frac = F.one_hot(topi.reshape(-1), e).float().mean(0)
    aux = attrs.lambda_bal * e * torch.sum(frac * probs.mean(0))
    return [out, aux.reshape(1).to(x.dtype)]
