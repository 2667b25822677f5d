"""Data-parallel training over a torch.distributed process group (port of
flexflow_tpu/parallel/data_parallel.py:30).

The JAX package jits the single-device step over a 1D device mesh with the
batch dim sharded, lets GSPMD insert the gradient all-reduce, and routes
attention through its per-head flash kernels per device (`flash_mesh`).
Here each rank is one process on one device: it takes its own block of
rows of the global batch (the global batch itself, of which it keeps its
block, or the block alone, as FFModel feeds it: `feed_blocks`), runs the
single-device forward and backward under `flash_mesh` (so attention rides
the per-head kernels on the local block) and under `batch_stats_group` (so
BatchNorm normalizes by the whole batch's statistics, as GSPMD does: their
sums are all-reduced over the group, and the all-reduce's backward carries
every rank's share of their gradient back), and averages the f32 gradients
over the group in buckets that the backward issues as it produces them
(parallel/collectives.py, `BucketedBackward`), then the loss and the
step's metric sums in one bucket of their own. Every rank then applies the
same optimizer update to the same averaged gradients, so the replicas stay
bitwise equal, and reports the metrics of the whole batch.

The fused K-step window (`multi_train_step`) is one captured CUDA graph
where NCCL carries the collectives (their all-reduces issued during the
capture);
gloo stages every collective through host memory, which no graph can
hold, so under gloo (and on the CPU) the window runs its K steps in one
call without capture, and `last_window` says `captured: False`.
"""
from __future__ import annotations

import collections
import math
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels.flash_attention import flash_mesh
from flexflow_tpu_torch.kernels.ops import batch_stats_group
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    param_key,
    resolve_device,
    weight_nodes,
)
from flexflow_tpu_torch.op_attrs.ops import BatchNormAttrs, InputAttrs, LossAttrs
from flexflow_tpu_torch.parallel import collectives as C
from flexflow_tpu_torch.parallel.sharding import is_rank_block
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.optimizer import OptimizerAttrs
from flexflow_tpu_torch.utils.graph import DataflowOutput


def _local_rank(rank: int) -> int:
    """The card of global rank `rank` on its host: LOCAL_RANK where a
    launcher sets it, else the rank modulo the host's card count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(1, torch.cuda.device_count())


def _rank_device(device, rank: int) -> torch.device:
    """`device`, or cuda:<local rank> where it names no card index."""
    dev = resolve_device(device)  # raises without a card when device is None
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_rank(rank))
    return dev


def init_file_group(store_file: str, rank: int = 0, world_size: int = 1, device=None,
                    backend: Optional[str] = None):
    """Open the default process group over a `file://` store, so no network
    port is needed: NCCL on the card (the rank's card is made current
    first, as NCCL needs), gloo when `device` is "cpu". `backend` overrides
    that: "gloo" on the card lets several ranks share one card (gloo stages
    CUDA tensors through host memory), which NCCL refuses. `store_file`
    must not exist yet, and every rank passes the same path. Returns the
    device the rank runs on; `dist.destroy_process_group()` closes the
    group."""
    dev = _rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=f"file://{os.path.abspath(store_file)}", rank=rank, world_size=world_size,
    )
    return dev


class DataParallelTrainingInstance(ModelTrainingInstance):
    """ModelTrainingInstance replicated over the ranks of a process group,
    each training on its own block of the global batch."""

    def __init__(
        self,
        cg: ComputationGraph,
        logit_tensor: DataflowOutput,
        loss_attrs: LossAttrs,
        optimizer_attrs: OptimizerAttrs,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
        group=None,
        metrics=frozenset(),
    ) -> None:
        """group: the process group (None: the default one, which must be
        initialized). device: cuda:<local rank> unless given. metrics: the
        names compute_metrics evaluates, summed over the ranks."""
        if not dist.is_initialized():
            raise RuntimeError(
                "no process group is initialized: open one first (e.g. parallel.init_file_group)"
            )
        self.group = group
        self.rank = dist.get_rank(group)
        self.world_size = dist.get_world_size(group)
        super().__init__(cg, logit_tensor, loss_attrs, optimizer_attrs,
                         compute_dtype=compute_dtype, device=_rank_device(device, dist.get_rank()),
                         metrics=metrics)
        # collectives issued by train steps so far, by kind
        self.collectives = collections.Counter()
        self.batch_size = _graph_batch(cg)
        keys = [param_key(n) for n in weight_nodes(cg)]
        numel = {param_key(n): math.prod(cg.tensor_shape(cg.outputs_of(n)[0]).dims)
                 for n in weight_nodes(cg)}
        # the gradient buckets, in issue order
        self.buckets = C.bucket_plan(C.first_use_order(cg, keys, param_key), numel)
        # per step: (buckets issued, of them before the backward's last gradient)
        self.bucket_log = []

    @property
    def all_reduces(self) -> int:
        return self.collectives["all_reduce"]

    def step_collectives(self) -> collections.Counter:
        """The collectives a train step issues, by kind: one all-reduce per
        gradient bucket of the plan (BUCKET_CAP_BYTES, the parameters'
        sizes), one of the loss and the metrics, and BatchNorm's
        statistics over several ranks."""
        out = collections.Counter(all_reduce=len(self.buckets) + 1)
        if self.world_size > 1:
            for n in self.cg.topological_ordering():
                if isinstance(self.cg.op_attrs(n), BatchNormAttrs):
                    out["all_reduce"] += 4  # mean and variance sums, forward and backward
        return out

    def step_flops(self) -> int:
        """A train step's flops of the model's own work, as MFU counts it
        (kernels.ops.graph_step_flops over the graph)."""
        from flexflow_tpu_torch.kernels.ops import graph_step_flops

        return graph_step_flops(self.cg)

    def feed_blocks(self):
        """(rows per input name, rows of the label): the (start, stop) of
        this rank's block within a global batch, which is all it needs fed
        (the counterpart of the JAX package's device_put_global)."""
        n = self.batch_size // self.world_size
        rows = (self.rank * n, (self.rank + 1) * n)
        names = [self.cg.layer_attrs(v).name or param_key(v) for v in self.cg.topological_ordering()
                 if isinstance(self.cg.op_attrs(v), InputAttrs)]
        return {name: rows for name in names}, rows

    def _capturable(self) -> bool:
        return dist.get_backend(self.group) == "nccl"

    def initialize(self, seed: int = 0):
        """Parameters and optimizer state, equal on every rank: each rank
        initializes the same values from `seed`, and rank 0's are broadcast
        over them."""
        params, opt_state = super().initialize(seed)
        src = dist.get_global_rank(self.group, 0) if self.group is not None else 0
        for p in params.values():
            dist.broadcast(p, src, group=self.group)
        return params, opt_state

    def _local_rows(self, x):
        """This rank's block of rows of a batch input: a batch of the rank's
        share of the graph's rows is its block already (is_rank_block); any
        other is a global batch, and is cut."""
        b = x.shape[0]
        if is_rank_block(b, self.batch_size, self.world_size):
            return x
        if b % self.world_size:
            raise ValueError(
                f"global batch {b} does not divide over {self.world_size} data-parallel ranks"
            )
        n = b // self.world_size
        return x[self.rank * n:(self.rank + 1) * n]

    def _feed(self, batch_inputs, label):
        """This rank's block of rows of the batch and of the label, on its
        device."""
        return ({k: torch.as_tensor(self._local_rows(v), device=self.device)
                 for k, v in batch_inputs.items()},
                torch.as_tensor(self._local_rows(label), device=self.device))

    def loss_fn(self, params, batch_inputs, label, rng=None):
        """The single-device loss of this rank's block, attention on the
        per-head kernels and BatchNorm on the whole batch's statistics."""
        from flexflow_tpu_torch.parallel.collectives import all_reduce_sum

        with flash_mesh(self.group), batch_stats_group(
                lambda t: all_reduce_sum(t, self.group, self.collectives)):
            return super().loss_fn(params, batch_inputs, label, rng)

    def _dropout_masks(self, rng):
        """The single-device trainer's masks (drawn at the global batch),
        each cut to this rank's block of rows: every rank draws them all,
        so the generators stay in step and the run is the one-device run's."""
        from flexflow_tpu_torch.local_execution.training_backing import dropout_masks

        if rng is None:
            return None
        out = {}
        for n, mask in dropout_masks(self.cg, rng, rng.device).items():
            rows = mask.shape[0] // self.world_size
            out[n] = mask[self.rank * rows:(self.rank + 1) * rows]
        return out

    def _gradient_reducer(self, leaves):
        return C.BucketedBackward([(self.group, keys) for keys in self.buckets],
                                  leaves, self.collectives, self.bucket_log)

    def _step_scalars(self, loss, grads, mvals):
        """The gradients averaged over the ranks, and (global mean loss,
        the whole batch's metric sums) in one bucket of their own."""
        for g in grads.values():
            g.div_(self.world_size)
        return all_reduce_mean(loss, self.group, self.world_size, mvals, self.collectives)


def _graph_batch(cg: ComputationGraph) -> int:
    """The batch of the graph's first input (its dim 0)."""
    for n in cg.topological_ordering():
        if isinstance(cg.op_attrs(n), InputAttrs):
            return cg.tensor_shape(cg.outputs_of(n)[0]).dims[0]
    return 0


def all_reduce_mean(loss, group, world_size: int, metrics: Optional[Dict] = None,
                    counts=None):
    """One all-reduce of the loss and the metric values over `group`, in
    one f32 bucket; returns the loss's mean over the group's `world_size`
    ranks and the metrics' sums. A count that compute_metrics gives as a
    Python int is fixed by the shape, the same on every rank: its sum is
    world_size times it, with no read of the device (so a captured window
    holds the step)."""
    metrics = metrics or {}
    tensors = {k: v for k, v in metrics.items() if not isinstance(v, int)}
    bucket = torch.cat([loss.reshape(1).float()]
                       + [v.reshape(1).float() for v in tensors.values()])
    dist.all_reduce(bucket, group=group)
    if counts is not None:
        counts["all_reduce"] += 1
    sums = {}
    for i, (name, v) in enumerate(tensors.items()):
        total = bucket[1 + i]
        sums[name] = total if v.is_floating_point() else total.round().to(v.dtype)
    sums = {name: world_size * v if isinstance(v, int) else sums[name]
            for name, v in metrics.items()}
    return bucket[0] / world_size, sums
