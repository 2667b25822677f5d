"""Data-parallel training over a torch.distributed process group (port of
flexflow_tpu/parallel/data_parallel.py:30).

The JAX package jits the single-device step over a 1D device mesh with the
batch dim sharded, lets GSPMD insert the gradient all-reduce, and routes
attention through its per-head flash kernels per device (`flash_mesh`).
Here each rank is one process on one device: it takes the global batch,
keeps its own block of rows, runs the single-device forward and backward
under `flash_mesh` (so attention rides the per-head kernels on the local
block) and under `batch_stats_group` (so BatchNorm normalizes by the whole
batch's statistics, as GSPMD does: their sums are all-reduced over the
group, and the all-reduce's backward carries every rank's share of their
gradient back), and averages the f32 gradients and the loss over the group
with one all-reduce per step: the loss, every gradient and the step's
metric sums flattened into a single f32 bucket, in parameter order. Every
rank then applies the same optimizer update to the same averaged
gradients, so the replicas stay bitwise equal, and reports the metrics of
the whole batch.
"""
from __future__ import annotations

import collections
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels.flash_attention import flash_mesh
from flexflow_tpu_torch.kernels.ops import batch_stats_group
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    ParamKey,
    resolve_device,
)
from flexflow_tpu_torch.op_attrs.ops import LossAttrs
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

    @property
    def all_reduces(self) -> int:
        return self.collectives["all_reduce"]

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
        """This rank's block of rows of a global-batch input."""
        b = x.shape[0]
        if b % self.world_size:
            raise ValueError(
                f"global batch {b} does not divide over {self.world_size} data-parallel ranks"
            )
        n = b // self.world_size
        return x[self.rank * n:(self.rank + 1) * n]

    def multi_train_step(self, params, opt_state, batch_stack, label_stack, rng):
        """The fused K-step window of the data-parallel trainer is not ported yet."""
        raise NotImplementedError(
            "multi_train_step of the data-parallel trainer is not ported yet (A7 item 9)")

    def loss_and_grads(self, params, batch_inputs, label, rng=None, metrics=None):
        """(global mean loss, {key: f32 gradient averaged over the ranks})
        from the global batch; `params` are not modified. `metrics`
        receives the whole batch's metric sums."""
        from flexflow_tpu_torch.parallel.collectives import all_reduce_sum

        local = {k: self._local_rows(v) for k, v in batch_inputs.items()}
        mvals = {} if metrics is not None else None
        with flash_mesh(self.group), batch_stats_group(
                lambda t: all_reduce_sum(t, self.group, self.collectives)):
            loss, grads = super().loss_and_grads(params, local, self._local_rows(label), rng,
                                                 metrics=mvals)
        self.collectives["all_reduce"] += 1
        loss, grads, sums = all_reduce_mean(loss, grads, self.group, self.world_size, mvals)
        if metrics is not None:
            metrics.update(sums)
        return loss, grads


def all_reduce_mean(loss, grads: Dict[ParamKey, torch.Tensor], group, world_size: int,
                    metrics: Optional[Dict] = None):
    """One all-reduce of the loss, every gradient and the metric values
    over `group`, flattened into one f32 bucket; returns the means of the
    loss and the gradients over the group's `world_size` ranks, as views of
    it, and the metrics' sums (counts back as ints, exact below 2**24)."""
    metrics = metrics or {}
    bucket = torch.cat([loss.reshape(1).float()] + [g.reshape(-1) for g in grads.values()]
                       + [torch.as_tensor(v, device=loss.device).reshape(1).float()
                          for v in metrics.values()])
    dist.all_reduce(bucket, group=group)
    out, offset = {}, 1
    for key, g in grads.items():
        out[key] = bucket[offset:offset + g.numel()].view_as(g)
        offset += g.numel()
    sums = {}
    for i, (name, v) in enumerate(metrics.items()):
        total = bucket[offset + i]
        if isinstance(v, int):
            sums[name] = int(round(float(total)))
        elif not v.is_floating_point():
            sums[name] = total.round().to(v.dtype)
        else:
            sums[name] = total
    bucket[:offset].div_(world_size)
    return bucket[0], out, sums
