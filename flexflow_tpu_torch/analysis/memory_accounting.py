"""Per-op step memory accounting (trimmed copy of
flexflow_tpu/analysis/memory_accounting.py: the serving regime's KV-cache
terms, one op's step residency `estimate_memory`, and the machine-mapping
DP's leaf predicate `leaf_step_memory_bytes` with the 1F1B stash scaling
of a pipeline region's leaves, `pipeline_scaled_total`).

Training: activations and outputs x2 (the value and its gradient), weights
x (2 + optimizer state slots), the input layer's stacked window of K
batches under `steps_per_dispatch=K`. Serving (a `ServingMemorySpec`):
forward-only residency, everything x1, no gradient, optimizer or window
term, plus each attention op's per-device share of the persistent KV cache.

The KV cache is a parallel tensor [seqs, heads, max_seq_len, head_dim] per
attention op whose degrees are bound to the op's own sharding. One formula,
`kv_cache_piece_bytes`, prices it: `serving.kv_cache.per_device_cache_bytes`
sums it over the attention layers, the DP's leaf predicate and the memory
verifier (analysis/memory_analysis.py) charge it, and the serving
program's allocation is checked against that sum, so what is allocated and
what is priced cannot drift.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from functools import lru_cache
from typing import Optional, Sequence

from flexflow_tpu_torch.local_execution.training_backing import slot_roles
from flexflow_tpu_torch.op_attrs.core import IncomingTensorRole
from flexflow_tpu_torch.op_attrs.ops import MultiHeadAttentionAttrs


@dataclass(frozen=True)
class ServingMemorySpec:
    """The serving-side memory regime: how many sequences the engine may
    admit concurrently, how long each may grow, and the KV element width."""

    max_concurrent_seqs: int
    max_seq_len: int
    kv_dtype_bytes: int = 4

    def per_seq_cache_bytes(self, num_heads: int, k_dim: int, v_dim: int,
                            num_layers: int = 1) -> int:
        """Unsharded K+V bytes ONE sequence holds across `num_layers`
        attention layers."""
        return (
            num_layers
            * self.max_seq_len
            * num_heads
            * (k_dim + v_dim)
            * self.kv_dtype_bytes
        )


def kv_cache_piece_bytes(attrs, q_parallel_shape, w_parallel_shape,
                         serving: ServingMemorySpec) -> int:
    """Per-device KV-cache residency of ONE attention op under `serving`,
    from the op's parallel shapes: sequences shard with the op's batch
    degree (q dim 0), cache positions with its sequence degree (q dim 1),
    heads with the packed weight's head degree (w dim 1)."""
    if not isinstance(attrs, MultiHeadAttentionAttrs):
        return 0
    batch_degree = max(q_parallel_shape.shard_dim_at(0).degree, 1)
    seq_degree = 1
    if q_parallel_shape.num_dims >= 3:
        seq_degree = max(q_parallel_shape.shard_dim_at(1).degree, 1)
    head_degree = 1
    if w_parallel_shape is not None and w_parallel_shape.num_dims >= 2:
        head_degree = max(w_parallel_shape.shard_dim_at(1).degree, 1)
    seqs = math.ceil(serving.max_concurrent_seqs / batch_degree)
    positions = math.ceil(serving.max_seq_len / seq_degree)
    heads = math.ceil(attrs.num_heads / head_degree)
    return (
        seqs
        * positions
        * heads
        * (attrs.k_proj_size + attrs.v_proj_size)
        * serving.kv_dtype_bytes
    )


def _weight_slot_shape(attrs, input_parallel_shapes):
    """The first WEIGHT-role slot's parallel shape (None when the op has
    none wired): the head-degree carrier of `kv_cache_piece_bytes`."""
    shapes = list(input_parallel_shapes or ())
    for s, role in zip(shapes, slot_roles(attrs, len(shapes))):
        if role == IncomingTensorRole.WEIGHT:
            return s
    return None


# the optimizer regime the search plans for: Adam's m and v per weight
OPTIMIZER_STATE_SLOTS = 2


@dataclass(frozen=True)
class OpStepMemory:
    """Per-category step residency of one op, in bytes (one device's
    share when built from piece shapes)."""

    activations: int = 0  # data inputs
    activation_grads: int = 0  # their gradients (live during backward)
    weights: int = 0
    weight_grads: int = 0
    optimizer_state: int = 0
    outputs: int = 0
    output_grads: int = 0
    window_buffer: int = 0  # the input layer's stacked [K, batch, ...] window
    kv_cache: int = 0  # the persistent serving KV cache (ServingMemorySpec)

    @property
    def total(self) -> int:
        return (
            self.activations
            + self.activation_grads
            + self.weights
            + self.weight_grads
            + self.optimizer_state
            + self.outputs
            + self.output_grads
            + self.window_buffer
            + self.kv_cache
        )


def estimate_memory(
    attrs,
    input_shapes: Sequence,
    weight_shapes: Optional[Sequence] = None,
    output_shapes: Optional[Sequence] = None,
    optimizer_state_slots: int = OPTIMIZER_STATE_SLOTS,
    steps_per_dispatch: int = 1,
    serving: Optional[ServingMemorySpec] = None,
    kv_cache_bytes: int = 0,
) -> OpStepMemory:
    """Step residency of one op from its (piece) TensorShapes.

    `input_shapes` carries the DATA slots only; weight slots go in
    `weight_shapes` (the split_slot_values convention). `output_shapes`
    may be omitted for Input/Weight layers (their outputs are the attrs'
    own shape). With `serving` set the regime is forward-only inference
    plus `kv_cache_bytes`, the caller's per-device cache share from
    `kv_cache_piece_bytes`."""
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs

    k = 1 if serving is not None else max(int(steps_per_dispatch), 1)
    if isinstance(attrs, InputAttrs):
        out_bytes = (
            sum(s.size_bytes for s in output_shapes)
            if output_shapes
            else attrs.shape.size_bytes
        )
        return OpStepMemory(window_buffer=k * out_bytes)
    if isinstance(attrs, WeightAttrs):
        # charged at the consuming op's weight slots
        return OpStepMemory()
    in_bytes = sum(s.size_bytes for s in input_shapes)
    w_bytes = sum(s.size_bytes for s in (weight_shapes or ()))
    out_bytes = sum(s.size_bytes for s in (output_shapes or ()))
    if serving is not None:
        return OpStepMemory(
            activations=in_bytes,
            weights=w_bytes,
            outputs=out_bytes,
            kv_cache=max(int(kv_cache_bytes), 0),
        )
    return OpStepMemory(
        activations=in_bytes,
        activation_grads=in_bytes,
        weights=w_bytes,
        weight_grads=w_bytes,
        optimizer_state=max(int(optimizer_state_slots), 0) * w_bytes,
        outputs=out_bytes,
        output_grads=out_bytes,
    )


@lru_cache(maxsize=65536)
def leaf_step_memory_bytes(
    leaf,
    optimizer_state_slots: int = OPTIMIZER_STATE_SLOTS,
    steps_per_dispatch: int = 1,
    serving: Optional[ServingMemorySpec] = None,
) -> int:
    """Per-device step residency of ONE machine-mapping leaf
    (UnmappedOpCostEstimateKey), from its piece shapes — the quantity the
    DP's feasibility pruner compares against the device capacity. View
    independent: a piece shape depends only on the degrees.

    Parallel ops on ACTIVATION values charge their collective staging (the
    source piece plus the destination piece); weight layers and weight-chain
    reshards charge zero (the parameter is accounted at the consuming op's
    weight slots). With `serving` set the residency is forward-only and
    attention leaves also charge their per-device KV-cache share."""
    from flexflow_tpu_torch.local_execution.training_backing import split_slot_values
    from flexflow_tpu_torch.op_attrs.core import (
        get_output_shapes,
        get_weight_shapes,
        is_parallel_op,
        is_stage_op,
    )
    from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs
    from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_piece_shape

    k = 1 if serving is not None else max(int(steps_per_dispatch), 1)
    out_pieces = [get_piece_shape(s) for s in leaf.output_shapes]
    out_bytes = sum(s.size_bytes for s in out_pieces)
    attrs = leaf.op_attrs
    ctx = getattr(leaf, "pipeline", None)  # pcg.pipeline.PipelineLeafContext
    if isinstance(attrs, InputAttrs):
        return k * out_bytes
    if isinstance(attrs, WeightAttrs):
        return 0
    in_pieces = [get_piece_shape(s) for s in leaf.input_shapes]
    if is_stage_op(attrs):
        # a stage boundary stages one microbatch in flight (the source and
        # the destination piece of piece_bytes/M each); the stash of
        # in-flight microbatches is charged at the consuming stage's leaves
        m = max(getattr(attrs, "num_microbatches", 1), 1)
        total = sum(s.size_bytes for s in in_pieces) + out_bytes
        return -(-total // m)  # ceil
    if is_parallel_op(attrs):
        if all(leaf.weight_inputs) and leaf.weight_inputs:
            return 0
        staging = sum(s.size_bytes for s in in_pieces) + out_bytes
        if ctx is not None and serving is None:
            # a reshard inside a pipeline region moves one microbatch at a time
            staging = -(-staging // max(ctx.num_microbatches, 1))
        return staging
    data, weights = split_slot_values(attrs, in_pieces)
    if not weights:
        try:
            weights = get_weight_shapes(attrs, list(data))
        except (AssertionError, IndexError, ValueError, TypeError):
            weights = []
    try:
        outs = out_pieces or get_output_shapes(attrs, list(data))
    except (AssertionError, IndexError, ValueError, TypeError):
        outs = []
    cache_bytes = 0
    if serving is not None:
        cache_bytes = kv_cache_piece_bytes(
            attrs,
            leaf.input_shapes[0] if leaf.input_shapes else None,
            _weight_slot_shape(attrs, leaf.input_shapes),
            serving,
        )
    mem = estimate_memory(
        attrs, data, weights, outs,
        optimizer_state_slots=optimizer_state_slots,
        steps_per_dispatch=k,
        serving=serving,
        kv_cache_bytes=cache_bytes,
    )
    if ctx is not None and serving is None:
        # 1F1B activation stashing: inside a pipeline region an op touches
        # one microbatch (piece/M) at a time, and stage s keeps at most
        # min(S-s, M) in-flight microbatch activations stashed for its
        # backward; gradient terms hold one microbatch in flight (1/M).
        # Weight-side terms are resident the whole step, unchanged.
        return pipeline_scaled_total(mem, ctx)
    return mem.total


def pipeline_scaled_total(mem: OpStepMemory, ctx) -> int:
    """The 1F1B residency scaling of one op's training accounting:
    activations and outputs x min(S-s, M)/M (the in-flight stash bound),
    their gradients x 1/M (one microbatch's backward in flight); weights,
    their gradients, the optimizer state and the window buffers unchanged."""
    s_total, m = max(ctx.num_stages, 1), max(ctx.num_microbatches, 1)
    keep = max(min(s_total - ctx.stage, m), 1)
    acts = mem.activations + mem.outputs
    grads = mem.activation_grads + mem.output_grads
    fixed = mem.total - acts - grads
    return fixed + -(-acts * keep // m) + -(-grads // m)
