"""The four Unity parallel operators and the two pipeline-stage operators
(copy of flexflow_tpu/op_attrs/ops/parallel_ops.py): nodes whose only
effect is on the parallel layout or on the schedule.

  Repartition(dim, degree): shard degree of dim *= degree   (scatter)
  Combine(dim, degree):     shard degree of dim /= degree   (gather)
  Replicate(degree):        discard_copy_degree *= degree   (broadcast)
  Reduction(degree):        sum_degree /= degree            (all-reduce)

The port's builders and the search create them; parallel/collectives.py
lowers them for the trainer over a mesh of ranks.

StagePartition / StageMerge denote a schedule, not a layout: the tensor's
parallel shape is unchanged, but the region between the stage_index=0
StagePartition and the StageMerge runs as S stages on disjoint groups of
ranks, each processing M microbatches under a 1F1B schedule
(parallel/pipeline.py).

  StagePartition(S, M, s=0):   the region's entry; the batch is consumed as
                               M microbatches (batch % M == 0)
  StagePartition(S, M, s>=1):  stage s-1 hands its activation to stage s:
                               M point-to-point transfers a direction a step
  StageMerge(S, M):            the region's exit; the microbatch outputs
                               form the batch again

Both are the identity on values, so the flat executor stays correct on a
pipelined PCG.
"""

from __future__ import annotations

from dataclasses import dataclass

from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    with_discard_copy_degree,
    with_shard_degree,
    with_sum_degree,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


@dataclass(frozen=True)
class RepartitionAttrs:
    repartition_dim: int
    repartition_degree: int

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        d = self.repartition_dim % input.num_dims
        return with_shard_degree(input, d, input.shard_dim_at(d).degree * self.repartition_degree)


@dataclass(frozen=True)
class CombineAttrs:
    combine_dim: int
    combine_degree: int

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        d = self.combine_dim % input.num_dims
        degree = input.shard_dim_at(d).degree
        if degree % self.combine_degree:
            raise ValueError(f"cannot combine degree {degree} by {self.combine_degree}")
        return with_shard_degree(input, d, degree // self.combine_degree)


@dataclass(frozen=True)
class ReplicateAttrs:
    replicate_degree: int

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        return with_discard_copy_degree(input, input.discard_copy_degree * self.replicate_degree)


@dataclass(frozen=True)
class ReductionAttrs:
    reduction_degree: int

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        if input.sum_degree % self.reduction_degree:
            raise ValueError(f"cannot reduce sum degree {input.sum_degree} by "
                             f"{self.reduction_degree}")
        return with_sum_degree(input, input.sum_degree // self.reduction_degree)


@dataclass(frozen=True)
class StagePartitionAttrs:
    num_stages: int
    num_microbatches: int
    stage_index: int = 0

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        assert self.num_stages >= 1 and self.num_microbatches >= 1, self
        assert 0 <= self.stage_index < self.num_stages, self
        return input

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input


@dataclass(frozen=True)
class StageMergeAttrs:
    num_stages: int
    num_microbatches: int

    def parallel_output_shape(self, input: ParallelTensorShape) -> ParallelTensorShape:
        assert self.num_stages >= 1 and self.num_microbatches >= 1, self
        return input

    def output_shape(self, input: TensorShape) -> TensorShape:
        return input
