"""Collective matmuls: the all-gather-then-matmul and the
matmul-then-reduce-scatter rings (port of
flexflow_tpu/kernels/collective_matmul.py).

The serial lowering of a resharding edge beside a matmul runs the
collective, materializes the moved tensor, then starts the matmul. These
two forms stream the collective chunk by chunk around a ring of the ranks
(MachineMesh.ring_start: send to the next rank, receive from the previous
one) while the matmul consumes or produces chunks, so each hop runs beside
the previous chunk's matmul:

- `all_gather_matmul`: x is sharded along a non-contraction dim over the
  ring's axes; each step multiplies the chunk in hand into its rows of the
  output while the next chunk travels. k ranks take k - 1 steps.
- `matmul_reduce_scatter`: x and w are sharded along the contraction dim,
  so x @ w is a partial sum; the partial output is computed one chunk of
  x's leading dim per step, each added (in f32) to the accumulator that
  arrives from the previous rank. After k - 1 steps each rank holds its
  chunk summed over the ring, and an all-gather of the chunks rebuilds the
  whole sum on every rank (an all-reduce whose reduce-scatter half ran
  beside the matmul).

Their gradients are the serial lowering's, with no collective: a Combine's
backward keeps the rank's slice of its gradient and a Reduction's passes
its gradient on, so the all-gather form returns the rank's rows of
dout @ w^T and the reduce-scatter form the local matmul's gradients of the
whole dout.

Numerics: the all-gather form multiplies each row once at full depth, as
the serial lowering does (a chunked matmul may round otherwise than the
whole one); the reduce-scatter form adds the partials in ring order in
f32, where the serial lowering's all-reduce adds them in the backend's
order, so the two agree to f32 roundoff before the cast back.

`fused=False`, a ring of one rank, a gather along the contraction dim or a
leading dim the ring does not divide take the serial lowering (the
parallel ops of parallel/collectives.py), as the JAX package's entries
fall back to plain XLA.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from flexflow_tpu_torch.parallel import collectives as C


def _flat2(t: torch.Tensor) -> torch.Tensor:
    return t.reshape(-1, t.shape[-1])


class _AllGatherMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_blk, w, mesh, axes, dim):
        n, my = mesh.size(axes), mesh.index(axes)
        chunks, ys = [None] * n, [None] * n
        chunk = x_blk.contiguous()
        for i in range(n):
            transfer = mesh.ring_start(chunk, axes) if i < n - 1 else None
            src = (my - i) % n  # the rank this chunk started on
            chunks[src] = chunk
            ys[src] = chunk @ w
            if transfer is not None:
                chunk = transfer.wait()
        ctx.save_for_backward(torch.cat(chunks, dim), w)
        ctx.dim, ctx.my, ctx.blk = dim, my, x_blk.shape[dim]
        return torch.cat(ys, dim)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dx = (dout @ w.t()).narrow(ctx.dim, ctx.my * ctx.blk, ctx.blk)
        dw = _flat2(x).t() @ _flat2(dout)
        return dx.contiguous(), dw, None, None, None


class _MatmulReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, mesh, axes):
        n, my = mesh.size(axes), mesh.index(axes)
        blk = x.shape[0] // n

        def partial(j):
            return (x.narrow(0, j * blk, blk) @ w).float()

        acc = partial((my - 1) % n)
        for t in range(n - 1):
            transfer = mesh.ring_start(acc, axes)
            mine = partial((my - t - 2) % n)  # computed while the hop travels
            acc = transfer.wait() + mine
        mesh.counts["all_gather"] += 1
        ctx.save_for_backward(x, w)
        return mesh.all_gather(acc, 0, axes).to(x.dtype)

    @staticmethod
    def backward(ctx, dout):
        x, w = ctx.saved_tensors
        dout = dout.to(x.dtype)
        return dout @ w.t(), _flat2(x).t() @ _flat2(dout), None, None


def all_gather_matmul(x_blk: torch.Tensor, w: torch.Tensor, mesh, axes: Sequence[str],
                      gather_dim: int, *, bias: Optional[torch.Tensor] = None,
                      activation=None, fused: bool = True) -> torch.Tensor:
    """x @ w (+ bias, then the activation), where x is gathered along
    `gather_dim` over the ring of `axes` from this rank's block x_blk; w
    is this rank's weight piece, unsharded along the contraction."""
    axes = tuple(axes)
    gather_dim %= x_blk.dim()
    if not fused or mesh.size(axes) == 1 or gather_dim == x_blk.dim() - 1:
        out = C.all_gather(x_blk, gather_dim, mesh, axes) @ w
    else:
        out = _AllGatherMatmul.apply(x_blk, w, mesh, axes, gather_dim)
    if bias is not None:
        out = out + bias
    return activation.apply(out) if activation is not None else out


def matmul_reduce_scatter(x: torch.Tensor, w: torch.Tensor, mesh, axes: Sequence[str], *,
                          fused: bool = True) -> torch.Tensor:
    """The sum over the ring of `axes` of the partial products x @ w (x and
    w this rank's contraction-sharded pieces), whole on every rank of the
    ring, in x's dtype."""
    axes = tuple(axes)
    n = mesh.size(axes)
    if not fused or n == 1 or x.shape[0] % n:
        return C.sum_partials(x @ w, mesh, axes)
    return _MatmulReduceScatter.apply(x, w, mesh, axes)
