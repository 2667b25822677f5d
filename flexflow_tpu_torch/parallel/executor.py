"""Training over a PCG on a dp x sp mesh of ranks (port of
flexflow_tpu/parallel/executor.py: pcg_forward_interpreter and
DistributedTrainingInstance).

The JAX package traces one global-view program over a device mesh: values
are global arrays, sharding constraints place them, GSPMD partitions the
token-wise ops and inserts the gradient all-reduce, and RingAttention runs
per shard under shard_map with K/V rotated by ppermute. Here each rank is
one process on one device and holds its own block of every activation: the
global batch is cut to the rank's block of batch (dp) and sequence (sp)
rows, the token-wise ops (dense, add, GELU, layer norm, the loss) run on
the block as they are, and RingAttention rotates key/value blocks over the
rank's sequence-parallel ring (kernels/ring_attention.py). The loss is the
mean over the rank's tokens and the gradients of the replicated weights are
partial; one all-reduce per step over all ranks averages the loss and every
gradient in one f32 bucket, which with equal blocks is the global mean the
JAX package's loss_fn takes. Every rank then applies the same optimizer
update, so the replicas stay bitwise equal.

The four parallel ops (Repartition, Combine, Replicate, Reduction: tensor
parallelism and resharding) are not lowered yet: a PCG holding one is
refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.distributed as dist

from flexflow_tpu_torch.kernels import forward as kernel_forward
from flexflow_tpu_torch.kernels import loss_forward
from flexflow_tpu_torch.kernels.precision import cast_for_compute
from flexflow_tpu_torch.kernels.ring_attention import ring_mha_forward
from flexflow_tpu_torch.kernels.ring_flash import SequenceRing
from flexflow_tpu_torch.local_execution.training_backing import (
    ModelTrainingInstance,
    ParamKey,
    param_key,
    split_slot_values,
)
from flexflow_tpu_torch.op_attrs.core import is_parallel_op
from flexflow_tpu_torch.op_attrs.ops import InputAttrs, LossAttrs, RingAttentionAttrs, WeightAttrs
from flexflow_tpu_torch.parallel.data_parallel import _rank_device, all_reduce_mean
from flexflow_tpu_torch.parallel.mesh import MachineMesh
from flexflow_tpu_torch.parallel.sharding import local_block, pcg_shardings
from flexflow_tpu_torch.pcg.optimizer import OptimizerAttrs
from flexflow_tpu_torch.pcg.parallel_computation_graph import ParallelComputationGraph
from flexflow_tpu_torch.utils.graph import DataflowOutput


def _parallel_op_error(n, attrs) -> NotImplementedError:
    return NotImplementedError(
        f"node {n} is a {type(attrs).__name__[:-len('Attrs')]} op: the port does not lower "
        f"the parallel ops (tensor parallelism, resharding) yet"
    )


def _refuse_parallel_ops(pcg: ParallelComputationGraph) -> None:
    for n in pcg.topological_ordering():
        if is_parallel_op(pcg.op_attrs(n)):
            raise _parallel_op_error(n, pcg.op_attrs(n))


def pcg_forward_interpreter(
    pcg: ParallelComputationGraph,
    params: Dict[ParamKey, torch.Tensor],
    inputs: Dict[str, torch.Tensor],
    ring: Optional[SequenceRing] = None,
) -> Dict[DataflowOutput, torch.Tensor]:
    """Evaluate the PCG on this rank's blocks: every tensor value keyed by
    DataflowOutput. inputs: keyed by input-layer name (or param_key of the
    input node). RingAttention rotates over `ring` (None: a ring of one)."""
    ring = ring if ring is not None else SequenceRing()
    env: Dict[DataflowOutput, torch.Tensor] = {}
    for n in pcg.topological_ordering():
        la = pcg.layer_attrs(n)
        attrs = la.attrs
        outs = pcg.outputs_of(n)
        if isinstance(attrs, InputAttrs):
            key = la.name if la.name is not None and la.name in inputs else param_key(n)
            if key not in inputs:
                raise KeyError(f"missing input binding for {la.name or key}")
            env[outs[0]] = inputs[key]
            continue
        if isinstance(attrs, WeightAttrs):
            env[outs[0]] = params[param_key(n)]
            continue
        if is_parallel_op(attrs):
            raise _parallel_op_error(n, attrs)
        data, weights = split_slot_values(attrs, [env[v] for v in pcg.inputs_of(n)])
        if isinstance(attrs, RingAttentionAttrs):
            bias = attrs.bias
            results = [ring_mha_forward(attrs, *data, weights[0], ring,
                                        input_bias=weights[1] if bias else None,
                                        output_bias=weights[2] if bias else None)]
        else:
            results = kernel_forward(attrs, data, weights)
        for o, r in zip(outs, results):
            env[o] = r
    return env


class DistributedTrainingInstance(ModelTrainingInstance):
    """PCG + loss + optimizer on a dp x sp mesh of ranks: each rank trains
    on its block of the global batch and sequence."""

    def __init__(
        self,
        pcg: ParallelComputationGraph,
        logit_tensor: DataflowOutput,
        loss_attrs: LossAttrs,
        optimizer_attrs: OptimizerAttrs,
        machine_mesh: MachineMesh,
        compute_dtype: Optional[torch.dtype] = None,
        device=None,
    ) -> None:
        """device: cuda:<local rank> unless given; see resolve_device."""
        _refuse_parallel_ops(pcg)
        self.pcg = pcg
        self.machine_mesh = machine_mesh
        self.shardings = pcg_shardings(pcg, machine_mesh)
        self._inputs = {}
        for n in pcg.topological_ordering():
            la = pcg.layer_attrs(n)
            if isinstance(la.attrs, InputAttrs):
                self._inputs[la.name or param_key(n)] = pcg.outputs_of(n)[0]
            elif isinstance(la.attrs, RingAttentionAttrs) and machine_mesh.sp > 1:
                seq_axis = self.shardings[pcg.inputs_of(n)[0]][1]
                if seq_axis != "sp":
                    raise ValueError(f"RingAttention node {n} takes a sequence sharded over "
                                     f"{seq_axis}, not over the mesh's {machine_mesh.sp}-rank ring")
        super().__init__(pcg, logit_tensor, loss_attrs, optimizer_attrs,
                         compute_dtype=compute_dtype, device=_rank_device(device, dist.get_rank()))
        self.all_reduces = 0  # collectives issued by train steps so far

    def initialize(self, seed: int = 0):
        """Parameters and optimizer state, equal on every rank: each rank
        initializes the same values from `seed`, and the mesh's rank 0
        broadcasts its own over them."""
        params, opt_state = super().initialize(seed)
        group = self.machine_mesh.group
        src = dist.get_global_rank(group, 0) if group is not None else 0
        for p in params.values():
            dist.broadcast(p, src, group=group)
        return params, opt_state

    def _local(self, x, tensor: DataflowOutput, what: str) -> torch.Tensor:
        """This rank's block of the global value x of `tensor`."""
        return local_block(torch.as_tensor(x, device=self.device), self.shardings[tensor],
                           self.machine_mesh, what)

    def _local_inputs(self, batch_inputs) -> Dict[str, torch.Tensor]:
        return {k: self._local(v, self._inputs[k], f"input {k!r}") for k, v in batch_inputs.items()}

    def loss_fn(self, params, batch_inputs, label, rng=None):
        """(mean loss over this rank's tokens, this rank's logits). rng is
        unused: the PCG interpreter runs no stochastic op (the parallel
        builder makes none)."""
        # labels shard like the logits, without the class dim
        label = local_block(torch.as_tensor(label, device=self.device),
                            self.shardings[self.logit_tensor][:-1], self.machine_mesh, "label")
        local = self._local_inputs(batch_inputs)
        env = pcg_forward_interpreter(
            self.pcg,
            cast_for_compute(params, self.compute_dtype),
            cast_for_compute(local, self.compute_dtype),
            self.machine_mesh.ring(),
        )
        logit = env[self.logit_tensor]
        return loss_forward(self.loss_attrs, logit, label), logit

    def multi_train_step(self, params, opt_state, batch_stack, label_stack, rng):
        """The fused K-step window of the distributed trainer is not ported yet."""
        raise NotImplementedError(
            "multi_train_step of the distributed trainer is not ported yet (A7)")

    def loss_and_grads(self, params, batch_inputs, label, rng=None, metrics=None):
        """(global mean loss, {key: f32 gradient of it}) from the global
        batch, after one all-reduce over the mesh; `params` are not
        modified. `metrics` stays empty: summing metrics over ranks waits
        for A7."""
        loss, grads = super().loss_and_grads(params, batch_inputs, label, rng)
        self.all_reduces += 1
        mesh = self.machine_mesh
        return all_reduce_mean(loss, grads, mesh.group, mesh.world_size)

    @torch.no_grad()
    def forward(self, params, batch_inputs) -> torch.Tensor:
        """This rank's block of the logits at `params`, in the params' dtype."""
        env = pcg_forward_interpreter(self.pcg, params, self._local_inputs(batch_inputs),
                                      self.machine_mesh.ring())
        return env[self.logit_tensor]
