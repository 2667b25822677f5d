"""The four parallel ops as differentiable collectives over mesh axes, and
the grouped gradient buckets.

Each rank holds its own piece of every tensor (parallel/sharding.py). The
trainers keep one invariant: on every rank, the gradient of a piece is the
global loss's full gradient with respect to that piece. Where ranks do
different work on one piece (the copies of a Replicate, a weight used on
different batch rows), each holds only its own work's share, and
`sum_grad` adds the shares where the work meets. So:

- Repartition (`narrow`): the forward keeps the rank's slice; the backward
  all-gathers the slices' gradients.
- Combine (`all_gather`): the forward all-gathers; the backward keeps the
  rank's slice and sums nothing, since duplicates hold equal gradients.
- Replicate: the identity both ways; `sum_grad` at its consumers sums the
  copies' gradients over the axes where their work differs.
- Reduction (`sum_partials`): the forward sums the partials; the backward
  is the identity.

`all_reduce_sum` is the autograd-aware all-reduce (backward: the same
all-reduce of the gradients) for statistics a batch-coupled op takes over
the ranks that share the batch.

`all_to_all` is the tiled all-to-all of lax.all_to_all(..., tiled=True)
over a set of axes, for Ulysses attention: x is cut into as many chunks
along its split dim as the axes hold ranks, chunk j goes to the rank of
piece j, and the chunks received are concatenated along the concat dim in
piece order. Its backward is the all-to-all with the two dims swapped.
NCCL runs it as one `all_to_all_single` on the device; gloo's all-to-all
takes host tensors, so a card's tensor is staged through pinned host
memory explicitly (copied out, exchanged on the host, copied back to its
card: the result is always on the input's device).

Everything runs on the list-form `all_gather` and on `all_reduce` over the
subgroup of a set of axes, so gloo (CPU ranks, and ranks sharing one card)
and NCCL (one card per rank) both take it. Partial sums and gradients are
reduced in f32 (f64 stays f64): the sum keeps its precision whatever the
compute dtype, and gloo's bf16 support is not needed. A collective over a group of one
rank is skipped. Every collective counts itself in the mesh's `counts`.

The trainers' weight gradients travel in buckets (`bucket_plan`,
`BucketedBackward`): each set of gradient axes is cut into buckets of at
most BUCKET_CAP_BYTES of f32, filled in the reverse order of the
parameters' first use in the forward, so that the backward produces a
bucket's gradients together. A hook on each parameter's leaf counts its
gradient in; the backward's hook that completes a bucket issues its
all-reduce (`async_op=True`) there and then, while the backward goes on,
and the trainer waits on all of them before the update. Buckets are issued
in the plan's order, the same on every rank. Each step records how many
were issued before the backward produced its last gradient: the evidence
that the all-reduces overlap the backward.
"""

from __future__ import annotations

import contextlib
from collections import Counter
from typing import Dict, Hashable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from flexflow_tpu_torch.parallel import census
from flexflow_tpu_torch.parallel.mesh import Axes, MachineMesh
from flexflow_tpu_torch.parallel.sharding import TensorSharding

# The f32 bytes one gradient bucket holds at most (a tensor larger than the
# cap is a bucket of its own): torch DistributedDataParallel's default.
BUCKET_CAP_BYTES = 25 * 2**20


def _wide(dtype: torch.dtype) -> torch.dtype:
    """The dtype a sum is reduced in: f32, or the input's if wider."""
    return torch.promote_types(dtype, torch.float32)


def _reduce_f32(x: torch.Tensor, group, counts=None) -> torch.Tensor:
    """The sum of x over `group`, reduced in f32 (or wider), in x's dtype."""
    buf = x.detach().to(_wide(x.dtype), copy=True).contiguous()
    census.note("all-reduce", census.tensor_bytes(buf), dist.get_world_size(group))
    dist.all_reduce(buf, group=group)
    if counts is not None:
        counts["all_reduce"] += 1
    return buf.to(x.dtype)


def _gather(x: torch.Tensor, dim: int, mesh: MachineMesh, axes: Axes) -> torch.Tensor:
    mesh.counts["all_gather"] += 1
    return mesh.all_gather(x, dim, axes)


def _slice(x: torch.Tensor, dim: int, mesh: MachineMesh, axes: Axes) -> torch.Tensor:
    n = mesh.size(axes)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not divide over {n} ranks "
                         f"(mesh axes {', '.join(axes)})")
    step = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axes) * step, step)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, mesh: MachineMesh, axes: Axes):
        ctx.dim, ctx.mesh, ctx.axes = dim, mesh, axes
        return _gather(x, dim, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return _slice(g, ctx.dim, ctx.mesh, ctx.axes).contiguous(), None, None, None


class _Narrow(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim: int, mesh: MachineMesh, axes: Axes):
        ctx.dim, ctx.mesh, ctx.axes, ctx.node = dim, mesh, axes, census.current_node()
        return _slice(x, dim, mesh, axes).contiguous()

    @staticmethod
    def backward(ctx, g):
        with census.node_scope(ctx.node):
            return _gather(g, ctx.dim, ctx.mesh, ctx.axes), None, None, None


class _SumPartials(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: MachineMesh, axes: Axes):
        return _reduce_f32(x, mesh.group_of(axes)[0], mesh.counts)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _SumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh: MachineMesh, axes: Axes):
        ctx.mesh, ctx.axes, ctx.node = mesh, axes, census.current_node()
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        with census.node_scope(ctx.node):
            return _reduce_f32(g, ctx.mesh.group_of(ctx.axes)[0], ctx.mesh.counts), None, None


class _KeepAtZero(torch.autograd.Function):
    """A whole value as partial sums over `axes`: itself at index 0 of
    them, zero elsewhere. The backward is the identity: every partial's
    gradient is the sum's."""

    @staticmethod
    def forward(ctx, x, mesh: MachineMesh, axes: Axes):
        return x.clone() if sum_group_zero(mesh, axes) else torch.zeros_like(x)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, counts):
        ctx.group, ctx.counts, ctx.node = group, counts, census.current_node()
        return _reduce_f32(x, group, counts)

    @staticmethod
    def backward(ctx, g):
        with census.node_scope(ctx.node):
            return _reduce_f32(g, ctx.group, ctx.counts), None, None


def _exchange(x: torch.Tensor, split: int, concat: int, mesh: MachineMesh, axes: Axes
              ) -> torch.Tensor:
    n = mesh.size(axes)
    if x.shape[split] % n:
        raise ValueError(f"all-to-all: dim {split} of size {x.shape[split]} does not divide "
                         f"over {n} ranks (mesh axes {', '.join(axes)})")
    group, peers = mesh.group_of(axes)
    # group rank of each piece: all_to_all_single sends block g to group rank g
    order = [p if group is None else dist.get_group_rank(group, p) for p in peers]
    piece_of = {g: i for i, g in enumerate(order)}
    chunks = x.chunk(n, dim=split)
    send = torch.stack([chunks[piece_of[g]] for g in range(n)])
    mesh.counts["all_to_all"] += 1
    census.note("all-to-all", census.tensor_bytes(send), n)
    if mesh.backend != "nccl" and send.device.type == "cuda":
        with census.transport():
            host = torch.empty(send.shape, dtype=send.dtype, pin_memory=True)
            host.copy_(send)
            got = torch.empty_like(host, pin_memory=True)
            dist.all_to_all_single(got, host, group=group)
            recv = got.to(send.device, non_blocking=True)
    else:
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=group)
    return torch.cat([recv[order[i]] for i in range(n)], dim=concat)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, split: int, concat: int, mesh: MachineMesh, axes: Axes):
        ctx.split, ctx.concat, ctx.mesh, ctx.axes = split, concat, mesh, axes
        ctx.node = census.current_node()
        return _exchange(x, split, concat, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        with census.node_scope(ctx.node):
            return (_exchange(g, ctx.concat, ctx.split, ctx.mesh, ctx.axes),
                    None, None, None, None)


def _trivial(mesh: MachineMesh, axes: Sequence[str]) -> bool:
    return mesh.size(axes) == 1


def all_gather(x: torch.Tensor, dim: int, mesh: MachineMesh, axes: Axes) -> torch.Tensor:
    """Combine: the whole of dim from the pieces over `axes`."""
    return x if _trivial(mesh, axes) else _AllGather.apply(x, dim, mesh, tuple(axes))


def narrow(x: torch.Tensor, dim: int, mesh: MachineMesh, axes: Axes) -> torch.Tensor:
    """Repartition: this rank's slice of dim over `axes`."""
    return x if _trivial(mesh, axes) else _Narrow.apply(x, dim, mesh, tuple(axes))


def sum_partials(x: torch.Tensor, mesh: MachineMesh, axes: Axes) -> torch.Tensor:
    """Reduction: the sum of the partials over `axes`."""
    return x if _trivial(mesh, axes) else _SumPartials.apply(x, mesh, tuple(axes))


def sum_grad(x: torch.Tensor, mesh: MachineMesh, axes: Axes) -> torch.Tensor:
    """The identity, whose backward sums the gradient over `axes`: where
    ranks did different work on one piece of x."""
    return x if _trivial(mesh, axes) else _SumGrad.apply(x, mesh, tuple(axes))


def all_reduce_sum(x: torch.Tensor, group, counts=None) -> torch.Tensor:
    """The sum of x over `group`, differentiable: the backward all-reduces
    the gradient (each rank's share of the sum's gradient flows back to
    every rank's term). `counts`: a Counter the collectives add to."""
    if dist.get_world_size(group) == 1:
        return x
    return _AllReduceSum.apply(x, group, counts)


def all_to_all(x: torch.Tensor, split: int, concat: int, mesh: MachineMesh, axes: Axes
               ) -> torch.Tensor:
    """The tiled all-to-all over `axes` (module note): x's dim `split` cut
    into one chunk per piece, the chunks received joined along `concat`;
    the identity over one rank. Differentiable: the backward swaps the
    dims."""
    return x if _trivial(mesh, axes) else _AllToAll.apply(x, split, concat, mesh, tuple(axes))


def all_reduce_extreme(x: torch.Tensor, mesh: MachineMesh, axes: Axes, largest: bool
                       ) -> torch.Tensor:
    """The elementwise max (`largest`) or min of x over `axes`, with no
    gradient: the class-sharded loss's stabilizer and the cross-shard
    argmax."""
    if _trivial(mesh, axes):
        return x
    buf = x.detach().clone().contiguous()
    census.note("all-reduce", census.tensor_bytes(buf), mesh.size(tuple(axes)))
    op = dist.ReduceOp.MAX if largest else dist.ReduceOp.MIN
    dist.all_reduce(buf, op=op, group=mesh.group_of(tuple(axes))[0])
    mesh.counts["all_reduce"] += 1
    return buf


def reshard(x: torch.Tensor, src: TensorSharding, dst: TensorSharding,
            mesh: MachineMesh) -> torch.Tensor:
    """x, this rank's piece under `src`, as its piece under `dst`: the
    partial sums `dst` does not keep are summed (all of them, where `dst`
    sums over other axes), then each dim whose axes change is gathered
    whole and cut again; new sum axes then hold the whole at index 0."""
    moved = bool(set(dst.sum) - set(src.sum))
    extra = [a for a in mesh.names if a in src.sum and (moved or a not in dst.sum)]
    if extra:
        x = sum_partials(x, mesh, tuple(extra))
    changed = [d for d, (a, b) in enumerate(zip(src.dims, dst.dims)) if a != b]
    for d in changed:
        if src.dims[d]:
            x = all_gather(x, d, mesh, src.dims[d])
    for d in changed:
        if dst.dims[d]:
            x = narrow(x, d, mesh, dst.dims[d])
    if moved and not _trivial(mesh, dst.sum):
        x = _KeepAtZero.apply(x, mesh, tuple(dst.sum))
    return x


def reshard_collectives(src: TensorSharding, dst: TensorSharding, mesh: MachineMesh,
                        grad: bool) -> Counter:
    """The collectives `reshard(x, src, dst)` issues in a step: forward, and
    backward where x needs a gradient (`grad`)."""
    out = Counter()
    moved = bool(set(dst.sum) - set(src.sum))
    extra = [a for a in src.sum if moved or a not in dst.sum]
    if extra and not _trivial(mesh, extra):
        out["all_reduce"] += 1
    for a, b in zip(src.dims, dst.dims):
        if a != b:
            if a and not _trivial(mesh, a):
                out["all_gather"] += 1
            if b and not _trivial(mesh, b) and grad:
                out["all_gather"] += 1
    return out


def bucket_all_reduce(mesh: MachineMesh, buckets: Dict[Axes, List[torch.Tensor]]
                      ) -> Dict[Axes, List[torch.Tensor]]:
    """Sum each bucket's tensors over its axes with one all-reduce per
    bucket, in f32 or wider (buckets over one rank are returned as they
    are)."""
    out = {}
    for axes in sorted(buckets, key=lambda a: (len(a), a)):
        tensors = buckets[axes]
        if _trivial(mesh, axes) or not tensors:
            out[axes] = tensors
            continue
        wide = _wide(tensors[0].dtype)
        for t in tensors[1:]:
            wide = torch.promote_types(wide, t.dtype)
        flat = torch.cat([t.detach().reshape(-1).to(wide) for t in tensors])
        census.note("all-reduce", census.tensor_bytes(flat), mesh.size(axes),
                    parts=[(None, t.numel() * flat.element_size()) for t in tensors])
        dist.all_reduce(flat, group=mesh.group_of(axes)[0])
        mesh.counts["all_reduce"] += 1
        views, offset = [], 0
        for t in tensors:
            views.append(flat[offset:offset + t.numel()].view(t.shape))
            offset += t.numel()
        out[axes] = views
    return out


def _node_of_key(key) -> Optional[int]:
    """The weight node of a parameter key ("n<idx>"), for the census."""
    if isinstance(key, str) and key[:1] == "n" and key[1:].isdigit():
        return int(key[1:])
    return None


def mesh_order(mesh: MachineMesh, axes) -> Axes:
    """`axes` as a tuple in the mesh's axis order."""
    axes = set(axes)
    return tuple(a for a in mesh.names if a in axes)


def sum_group_zero(mesh: MachineMesh, axes: Axes) -> bool:
    """Whether this rank is at coordinate 0 on every one of `axes`."""
    return all(int(mesh.coords[a]) == 0 for a in axes)


def placed_axes(shardings: Sequence[Optional[TensorSharding]]) -> frozenset:
    out = frozenset()
    for s in shardings:
        if s is not None:
            out |= s.placed()
    return out



def bucket_plan(keys: Sequence[Hashable],
                numel: Dict[Hashable, int]) -> List[List[Hashable]]:
    """The gradient buckets of `keys` (the parameters in the order of their
    first use in the forward): filled in the reverse order, each at most
    BUCKET_CAP_BYTES of f32, a tensor larger than the cap alone in its
    bucket."""
    out: List[List[Hashable]] = []
    size = 0
    for k in reversed(list(keys)):
        nbytes = 4 * numel[k]
        if not out or size + nbytes > BUCKET_CAP_BYTES:
            out.append([])
            size = 0
        out[-1].append(k)
        size += nbytes
    return out


def first_use_order(graph, keys: Sequence[Hashable], key_of) -> List[Hashable]:
    """`keys` (parameters of weight nodes, `key_of(node)` naming each) in
    the order the forward first uses them: the topological position of the
    first compute op that reads the weight, through parallel ops; a weight
    no op reads comes last."""
    from flexflow_tpu_torch.op_attrs.core import is_parallel_op
    from flexflow_tpu_torch.op_attrs.ops import WeightAttrs

    first: Dict[Hashable, int] = {}
    source = {}  # tensor -> the weight key it carries (through parallel ops)
    for pos, n in enumerate(graph.topological_ordering()):
        attrs = graph.op_attrs(n)
        if isinstance(attrs, WeightAttrs):
            source[graph.outputs_of(n)[0]] = key_of(n)
            continue
        ins = graph.inputs_of(n)
        if is_parallel_op(attrs):
            if ins and ins[0] in source:
                source[graph.outputs_of(n)[0]] = source[ins[0]]
            continue
        for t in ins:
            if t in source:
                first.setdefault(source[t], pos)
    position = {k: i for i, k in enumerate(keys)}
    return sorted(keys, key=lambda k: (first.get(k, float("inf")), position[k]))


class BucketedBackward:
    """One backward's gradient buckets (see the module docstring).

    buckets: (group, keys) per bucket in issue order; group False marks a
    bucket over one rank, whose gradients are kept as they are. leaves:
    the parameters' leaves the backward differentiates. counts: the
    Counter the all-reduces count themselves in. log: the list `finish()`
    appends (collective buckets, of them issued before the backward's last
    gradient) to. Construct it before the backward starts; `finish()`
    after it returns the reduced gradients."""

    def __init__(self, buckets: Sequence[Tuple[object, List[Hashable]]],
                 leaves: Dict[Hashable, torch.Tensor], counts: Counter,
                 log: List[Tuple[int, int]]) -> None:
        self.buckets = [(g, list(keys)) for g, keys in buckets]
        self.leaves = leaves
        self.counts = counts
        self.log = log
        self._where = {k: i for i, (_, keys) in enumerate(self.buckets) for k in keys}
        self._missing = [len(keys) for _, keys in self.buckets]
        self._grads: Dict[Hashable, torch.Tensor] = {}
        self._out: List[Optional[List[torch.Tensor]]] = [None] * len(self.buckets)
        self._works: List[object] = [None] * len(self.buckets)
        self._issued_at: List[Optional[int]] = [None] * len(self.buckets)
        self._next = 0
        self.produced = 0
        device = next(iter(leaves.values())).device if leaves else torch.device("cpu")
        # the hooks run on autograd's device thread on a card: they issue on
        # the stream the backward's kernels run on, the caller's
        self._stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
        self._handles = [leaves[k].register_hook(self._hook(k)) for k in self._where]

    def _hook(self, key):
        def hook(grad):
            self._grads[key] = grad
            self.produced += 1
            self._missing[self._where[key]] -= 1
            self._issue_ready()

        return hook

    def _issue_ready(self) -> None:
        while self._next < len(self.buckets) and self._missing[self._next] == 0:
            self._issue(self._next)
            self._next += 1

    def _issue(self, i: int) -> None:
        group, keys = self.buckets[i]
        grads = [self._grads.pop(k) for k in keys]
        self._issued_at[i] = self.produced
        if group is False:
            self._out[i] = grads
            return
        wide = _wide(grads[0].dtype)
        for g in grads[1:]:
            wide = torch.promote_types(wide, g.dtype)
        stream = (torch.cuda.stream(self._stream) if self._stream is not None
                  else contextlib.nullcontext())
        with stream:
            flat = torch.cat([g.detach().reshape(-1).to(wide) for g in grads])
            census.note("all-reduce", census.tensor_bytes(flat), dist.get_world_size(group),
                        parts=[(_node_of_key(k), g.numel() * flat.element_size())
                               for k, g in zip(keys, grads)])
            self._works[i] = dist.all_reduce(flat, group=group, async_op=True)
        self.counts["all_reduce"] += 1
        views, offset = [], 0
        for g in grads:
            views.append(flat[offset:offset + g.numel()].view(g.shape))
            offset += g.numel()
        self._out[i] = views

    def finish(self) -> Dict[Hashable, torch.Tensor]:
        """After the backward: zero gradients for the parameters it did not
        reach, the buckets not issued yet issued, every all-reduce waited
        on (on the stream, where the backend allows); the summed gradients
        by key. `issued_early` then counts the collective buckets issued
        before the backward produced its last gradient."""
        for h in self._handles:
            h.remove()
        self._handles = []
        for k, i in self._where.items():
            if self._out[i] is None and k not in self._grads:
                self._grads[k] = torch.zeros_like(self.leaves[k])
                self._missing[i] -= 1
        self._issue_ready()
        for work in self._works:
            if work is not None:
                work.wait()
        self.issued_early = sum(1 for w, at in zip(self._works, self._issued_at)
                                if w is not None and at < self.produced)
        self.log.append((sum(1 for g, _ in self.buckets if g is not False), self.issued_early))
        out = {}
        for (_, keys), vals in zip(self.buckets, self._out):
            out.update(zip(keys, vals))
        return out
