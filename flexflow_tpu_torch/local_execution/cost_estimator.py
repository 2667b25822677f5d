"""Measured cost estimation, Unity cost model v2 on the card (copy of
flexflow_tpu/local_execution/cost_estimator.py).

Reference: lib/local-execution/src/local_cost_estimator.cc:29-92 — run the
op on its *piece* shapes (per-device shard sizes), forward and backward, and
return CostDetails{elapsed_ms, mem_bytes}; parallel ops cost 0 compute. The
comm side is priced analytically (compiler/machine_mapping/cost_estimator).

Each leaf runs `kernels.ops.forward` on random tensors from a seeded
torch.Generator on the estimator's device, and autograd takes the backward
of the outputs' sum (the forward alone under `forward_only`, the serving
regime), timed with CUDA events around replays of the captured
call (kernels/profiling.py), so a leaf costs its device time. On the
card, attention leaves at the flash kernels' shapes therefore run the
hand-written flash forward, delta and backward kernels. On the card,
floating inputs and weights are bf16, the regime the port's trainer runs
(the PCG's tensors are f32, and the flash gate needs bf16); elsewhere, and
under `forward_only` (serving runs in the parameters' f32, dense
attention), they keep the shapes' own dtypes. The memory term stays on the shapes' own
dtypes, one step per dispatch, under the estimator's optimizer slots (Adam's
two unless given) or its serving regime.

Only shape inference may price a leaf at infinity: the weight and output
shapes of the piece inputs (get_weight_shapes / get_output_shapes), and, to
choose between the task's piece weights and the synthesized full weights,
a dry run of the op on the `meta` device, which computes shapes and launches
nothing; of what that dry run raises, only the shape errors below count as
a verdict. Whatever else it raises, and whatever the real run raises (a
kernel's launch or build, autograd), propagates: a failing kernel must
never be priced away.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import torch

from flexflow_tpu_torch.kernels.profiling import ProfilingSettings, profile_fn
from flexflow_tpu_torch.local_execution.training_backing import resolve_device
from flexflow_tpu_torch.op_attrs.core import (
    OpAttrs,
    get_output_shapes,
    get_weight_shapes,
    is_parallel_op,
)
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorShape,
    get_piece_shape,
)
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape


def optimizer_state_slots_of(optimizer_attrs) -> int:
    """Per-weight optimizer-state tensor count of the run's optimizer (the
    JAX package's): Adam's m and v = 2, SGD with momentum = 1, plain SGD =
    0; an unknown optimizer prices as Adam."""
    from flexflow_tpu_torch.pcg.optimizer import AdamOptimizerAttrs, SGDOptimizerAttrs

    if isinstance(optimizer_attrs, AdamOptimizerAttrs):
        return 2
    if isinstance(optimizer_attrs, SGDOptimizerAttrs):
        return 1 if optimizer_attrs.momentum > 0.0 else 0
    return 2

# what shape inference raises on shapes an op cannot take
_SHAPE_ERRORS = (AssertionError, IndexError, ValueError, TypeError)


@dataclass(frozen=True)
class CostDetails:
    """reference: CostDetails{total_elapsed_time, total_mem_usage}."""

    elapsed_ms: float
    mem_bytes: int


class LocalCostEstimator:
    """Measure-by-running per-op cost on one device.

    Results are memoized on (attrs, piece input shapes, piece weight
    shapes) — the reference's cost cache keyed by OpCostEstimateKey — and,
    with a persistent `cost_store`, read from and written through it, so a
    leaf measured in any past session on this device kind is not timed
    again.
    `profile_calls` counts the leaves run, `inf_leaves` the leaves priced
    at infinity."""

    def __init__(
        self,
        settings: Optional[ProfilingSettings] = None,
        cost_store=None,
        forward_only: bool = False,
        serving=None,
        device=None,
        optimizer_state_slots: int = 2,
    ) -> None:
        """device: where leaves run; the card unless the caller names
        another (without a card this raises unless device="cpu").
        forward_only: time the op's forward alone, the regime a serving
        plan's prefill and decode run in; `serving` (a ServingMemorySpec)
        then prices the leaf's inference residency.
        optimizer_state_slots: the optimizer's per-weight state tensors in
        the memory term (Adam's m and v are 2; serving passes 0).
        cost_store: a compiler.cost_store.CostStore of this estimator's
        device kind (anything else raises: a measurement taken on one
        device kind is never served to another): a stored leaf is priced
        without running, a missed one is timed and written back. A
        forward-only estimator needs a forward-marked store
        (cost_store.forward_fingerprint), so inference timings never meet
        the training store's fwd+bwd entries."""
        self.forward_only = bool(forward_only)
        self.serving = serving
        self.optimizer_state_slots = optimizer_state_slots
        self.settings = settings or ProfilingSettings(warmup_iters=2, measure_iters=4)
        self.device = resolve_device(device)
        self.cost_store = None
        if cost_store is not None:
            self.use_cost_store(cost_store)
        # the trainer's compute dtype on the card; the shapes' own elsewhere
        # and for serving, whose programs run in the parameters' dtype
        self.compute_dtype = (torch.bfloat16 if self.device.type == "cuda" and not forward_only
                              else None)
        self._cache: Dict = {}
        self.profile_calls = 0
        self.inf_leaves: List = []

    def use_cost_store(self, cost_store) -> None:
        """Read and write `cost_store` from now on. It must hold this
        estimator's device kind (a measurement taken on one device kind is
        never served to another) and, for a forward-only estimator, the
        forward-marked family (inference timings under training keys would
        poison every later training search); anything else raises."""
        from flexflow_tpu_torch.compiler.cost_store import device_kind_signature

        if self.forward_only and "fwd" not in getattr(cost_store, "fingerprint", ""):
            raise ValueError(
                "a forward-only estimator needs a forward-marked cost store "
                "(CostStore(..., fingerprint=forward_fingerprint()))")
        measures_on = device_kind_signature(self.device)
        if cost_store.device_kind != measures_on:
            raise ValueError(
                f"the cost store holds {cost_store.device_kind!r} measurements but this "
                f"estimator measures on {measures_on!r}: a store serves its own device kind only")
        self.cost_store = cost_store

    def estimate_operator_cost(
        self,
        attrs: OpAttrs,
        piece_input_shapes: Sequence[TensorShape],
        piece_weight_shapes: Optional[Sequence[TensorShape]] = None,
    ) -> CostDetails:
        from flexflow_tpu_torch.analysis.memory_accounting import estimate_memory
        from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs

        if isinstance(attrs, InputAttrs):
            # no kernel, but real residency: the step's input batch
            mem = estimate_memory(attrs, [])
            return CostDetails(0.0, mem.total)
        if is_parallel_op(attrs) or isinstance(attrs, WeightAttrs):
            # no kernel: parallel ops are priced by the comm model, and
            # weight bytes are charged at the consuming op's weight slots
            return CostDetails(0.0, 0)
        inputs = tuple(piece_input_shapes)
        weights = tuple(piece_weight_shapes) if piece_weight_shapes else None
        key = (attrs, inputs, weights)
        if key in self._cache:
            return self._cache[key]
        if self.cost_store is not None:
            # a measurement of a past session (or a past plan audit) prices
            # the leaf without running it
            hit = self.cost_store.get_op(attrs, inputs, weights)
            if hit is not None:
                cost = CostDetails(hit[0], hit[1])
                self._cache[key] = cost
                return cost
        cost = self._measure(attrs, piece_input_shapes, piece_weight_shapes)
        if cost.elapsed_ms == float("inf"):
            self.inf_leaves.append(key)
        if self.cost_store is not None and not math.isnan(cost.elapsed_ms):
            # written back so the next session starts warm; inf (shapes the
            # op cannot take) is kept as a verdict
            self.cost_store.put_op(attrs, inputs, weights, cost.elapsed_ms, cost.mem_bytes)
        self._cache[key] = cost
        return cost

    def estimate_operator_cost_parallel(
        self,
        attrs: OpAttrs,
        parallel_input_shapes: Sequence[ParallelTensorShape],
        parallel_output_shapes: Sequence[ParallelTensorShape] = (),
    ) -> CostDetails:
        """Cost one *task* of the op: measure on piece shapes. The leaf key
        carries every incoming slot (data + weights); only the data slots
        feed shape inference. `parallel_output_shapes` matters only for
        Input leaves: their batch's residency is the OUTPUT's per-device
        piece."""
        from flexflow_tpu_torch.local_execution.training_backing import split_slot_values
        from flexflow_tpu_torch.op_attrs.ops import InputAttrs

        if isinstance(attrs, InputAttrs) and parallel_output_shapes:
            from flexflow_tpu_torch.analysis.memory_accounting import estimate_memory

            mem = estimate_memory(
                attrs, [], output_shapes=[get_piece_shape(s) for s in parallel_output_shapes]
            )
            return CostDetails(0.0, mem.total)
        pieces = [get_piece_shape(s) for s in parallel_input_shapes]
        data, weights = split_slot_values(attrs, pieces)
        return self.estimate_operator_cost(attrs, data, weights or None)

    def _measure(self, attrs: OpAttrs, input_shapes, weight_shapes=None) -> CostDetails:
        """Measure with the task's own weight piece shapes when the op takes
        them (a weight-sharded task does less compute); ops whose kernels
        derive sizes from attrs (MHA's head count) reject piece weights, so
        the synthesized full weights are the next candidate. A leaf whose
        shapes no candidate fits is priced at infinity."""
        from flexflow_tpu_torch.analysis.memory_accounting import estimate_memory

        input_shapes = list(input_shapes)
        try:
            synth = get_weight_shapes(attrs, input_shapes)
            out_shapes = get_output_shapes(attrs, input_shapes)
        except _SHAPE_ERRORS:
            return CostDetails(float("inf"), 0)
        candidates = []
        if weight_shapes is not None and list(weight_shapes) != list(synth):
            candidates.append(list(weight_shapes))
        candidates.append(list(synth))
        for ws in candidates:
            if not self._shapes_fit(attrs, input_shapes, ws):
                continue
            elapsed_ms = self._measure_with(attrs, input_shapes, ws)
            # the op's training-step residency: activations in + their
            # grads, weights + grads + optimizer slots, outputs + grads
            mem = estimate_memory(attrs, input_shapes, ws, out_shapes,
                                  optimizer_state_slots=self.optimizer_state_slots,
                                  serving=self.serving)
            return CostDetails(elapsed_ms, mem.total)
        return CostDetails(float("inf"), 0)

    def _dtype_of(self, shape: TensorShape) -> torch.dtype:
        if shape.dtype.is_floating and self.compute_dtype is not None:
            return self.compute_dtype
        return shape.dtype.to_torch()

    def _shapes_fit(self, attrs: OpAttrs, input_shapes, weight_shapes) -> bool:
        """Shape inference of the op on these operand shapes: a dry run on
        the meta device, which allocates and launches nothing. Only the
        shape errors count as a verdict (a weight the op's attrs reject
        raises ValueError, kernels/ops.unpack_mha_weights); a RuntimeError
        (a host read, a meta-less op) or an op with no kernel propagates."""
        from flexflow_tpu_torch.kernels.ops import forward

        meta = torch.device("meta")
        try:
            forward(
                attrs,
                [torch.empty(s.dims, dtype=self._dtype_of(s), device=meta) for s in input_shapes],
                [torch.empty(s.dims, dtype=self._dtype_of(s), device=meta) for s in weight_shapes],
            )
        except _SHAPE_ERRORS:
            return False
        return True

    def _make(self, shape: TensorShape, gen: torch.Generator) -> torch.Tensor:
        if shape.dtype.is_floating:
            x = torch.randn(shape.dims, generator=gen, device=self.device)
            return x.to(self._dtype_of(shape))
        return torch.randint(0, 2, shape.dims, generator=gen, device=self.device,
                             dtype=shape.dtype.to_torch())

    def _measure_with(self, attrs: OpAttrs, input_shapes, weight_shapes) -> float:
        """ms of one forward + backward of the op (forward alone when an
        operand is integral: the JAX package cannot differentiate it, and
        under `forward_only`)."""
        from flexflow_tpu_torch.kernels.ops import forward

        gen = torch.Generator(device=self.device)
        gen.manual_seed(0)
        inputs = [self._make(s, gen) for s in input_shapes]
        weights = [self._make(s, gen) for s in weight_shapes]
        operands = inputs + weights
        if not self.forward_only and all(t.is_floating_point() for t in operands):
            for t in operands:
                t.requires_grad_(True)

            def step(operands):
                outs = forward(attrs, inputs, weights)
                loss = sum(o.sum() for o in outs if o.is_floating_point())
                return torch.autograd.grad(loss, operands)
        else:
            def step(operands):
                with torch.no_grad():
                    return forward(attrs, inputs, weights)

        self.profile_calls += 1
        elapsed_ms = profile_fn(step, self.settings, operands)
        del inputs, weights, operands
        if self.device.type == "cuda":
            # between leaves only, never inside a timed span: a large leaf's
            # activations and gradients must not crowd out the next one
            torch.cuda.empty_cache()
        return elapsed_ms
