"""Forward-only serving programs over a PCG (port of
flexflow_tpu/serving/program.py): the single-device lowering
(`machine_mesh=None`) and the lowering of a searched plan over a mesh of
ranks.

One graph interpreter drives two calls, the attention ops swapped for
KV-cached causal attention:

- **prefill**: the whole prompt in one forward pass (causal-masked), its
  K/V written into the slots being admitted; the last valid position's
  logits seed generation.
- **decode window**: W single-token greedy steps in one call, the
  counterpart of the JAX package's `lax.scan` window: the cache is written
  in place, and the per-slot tokens, lengths and argmax stay on the device
  until the window ends. On a CUDA device the window is one CUDA graph per
  step count and cache, captured at its first use and replayed with one
  launch (runtime/cuda_graph.py), as the JAX package jits the scan into one
  dispatch; `decode_window_eager` is the body it captures, and what runs on
  the CPU. Over ranks whose collectives are NCCL the window is captured
  likewise; gloo collectives stage through the host and cannot be
  captured, so there the window runs its steps eagerly in one call
  (`last_window["captured"]` is False).

Over a mesh (`machine_mesh`, with the searched `mapping`), each rank is one
process holding its pieces, as in parallel/executor.py: the executor's
`DistributedPlan` places every tensor, parallel ops reshard, compute ops
run the executor's lowering (`eval_node`: operand reshards, the
whole-tensor lowering, the collective-matmul sites under `overlap`), and
attention runs `_cached_attention` on the rank's local heads and slots
over the rank's piece of the cache (kv_cache.py), its output a partial sum
over the head axes. Tokens, lengths and the active mask are replicated:
every rank is fed the whole slot batch and cuts its piece, and the greedy
tokens are gathered whole (across class shards by the cross-shard argmax).

Every other op runs `kernels.ops.forward`. The math is the JAX package's,
in the parameters' dtype (f32): serving attention is dense, as there, and
launches no flash kernel. The K/V cache is updated in place, where the JAX
package donates it.

Parameters are keyed by WEIGHT ORDINAL ("w0", "w1", ... in topological
order): the prefill- and decode-shaped graphs of one model share one
parameter set through it, and each rank of a mesh holds its pieces of the
same seeded global draw.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional

import torch

from flexflow_tpu_torch.analysis.memory_accounting import ServingMemorySpec
from flexflow_tpu_torch.kernels.ops import forward as kernel_forward
from flexflow_tpu_torch.kernels.ops import mha_project_qkv
from flexflow_tpu_torch.local_execution.training_backing import (
    resolve_device,
    split_slot_values,
)
from flexflow_tpu_torch.op_attrs.core import is_parallel_op
from flexflow_tpu_torch.op_attrs.ops import InputAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape
from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.initializer import initialize
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    pcg_from_computation_graph,
)
from flexflow_tpu_torch.runtime.cuda_graph import CapturedGraphs, layout_key, shape_key
from flexflow_tpu_torch.serving.kv_cache import (
    CacheLayer,
    attention_layers,
    bind_cache_axes,
    cache_shardings,
    init_cache,
)

__all__ = ["ServingProgram", "as_pcg", "init_serving_params", "weight_ordinals"]

BIG_NEG = -1e30  # the masked score, as in the JAX package


def weight_ordinals(pcg) -> Dict[object, str]:
    """Weight node -> its ordinal key ("w0", "w1", ...) in topological order."""
    out = {}
    for n in pcg.topological_ordering():
        if isinstance(pcg.op_attrs(n), WeightAttrs):
            out[n] = f"w{len(out)}"
    return out


def init_serving_params(pcg, seed: int, device) -> Dict[str, torch.Tensor]:
    """Weight values keyed by ordinal, each drawn from its own CPU
    generator seeded from (seed, ordinal), then placed on `device`."""
    params: Dict[str, torch.Tensor] = {}
    for i, (n, key) in enumerate(weight_ordinals(pcg).items()):
        (out,) = pcg.outputs_of(n)
        ta = pcg.tensor_attrs(out)
        if ta.initializer is None:
            raise ValueError(f"weight {n} has no initializer")
        ts = get_reduced_shape(ta.shape)
        gen = torch.Generator().manual_seed(seed * 1_000_003 + i)
        params[key] = initialize(ta.initializer, gen, ts.dims, ts.dtype.to_torch()).to(device)
    return params


def as_pcg(graph) -> ParallelComputationGraph:
    """A PCG as it is, a CG lifted to a trivially-parallel PCG."""
    if isinstance(graph, ComputationGraph):
        return pcg_from_computation_graph(graph)
    if not isinstance(graph, ParallelComputationGraph):
        raise TypeError(f"expected a (parallel) computation graph, got {type(graph).__name__}")
    return graph


def _sink_logit(pcg):
    """The plan's logit tensor: the unique value nothing consumes."""
    order = pcg.topological_ordering()
    used = {v for n in order for v in pcg.inputs_of(n)}
    sinks = [o for n in order for o in pcg.outputs_of(n) if o not in used]
    if len(sinks) != 1:
        raise ValueError(f"serving expects a single-output model, found {len(sinks)} sinks")
    return sinks[0]


def _before_layout_moves(pcg, t):
    """t, walked back through the Combines and Repartitions that produce it
    (pure layout moves of a plan's sink)."""
    from flexflow_tpu_torch.op_attrs.ops import CombineAttrs, RepartitionAttrs

    while isinstance(pcg.op_attrs(t.node), (CombineAttrs, RepartitionAttrs)):
        (t,) = pcg.inputs_of(t.node)
    return t


class ServingProgram:
    """One serving plan, lowered: prefill and the decode window over a
    shared parameter set and KV cache, on one device or, with
    `machine_mesh` (a parallel.MachineMesh over the default process group)
    and the searched `mapping`, over a mesh of ranks (see the module
    docstring). `device=None` means CUDA (see resolve_device; over a mesh
    cuda:<local rank>); `params` (global values keyed by ordinal, see
    interop.serving_params_from_numpy) override the seeded draw.
    `overlap`: the collective-matmul lowering (executor.overlap_lowering_active
    decides, with its env switches)."""

    def __init__(
        self,
        graph,
        serving: ServingMemorySpec,
        *,
        mapping: Optional[dict] = None,
        machine_mesh=None,
        overlap: Optional[bool] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,
        params_seed: int = 0,
        device=None,
    ) -> None:
        self.pcg = as_pcg(graph)
        self.serving = serving
        self.machine_mesh = machine_mesh
        self.plan = None
        if machine_mesh is None:
            self.device = resolve_device(device)
        else:
            import torch.distributed as dist

            from flexflow_tpu_torch.parallel.data_parallel import _rank_device
            from flexflow_tpu_torch.parallel.executor import (
                DistributedPlan,
                _ancestors,
                overlap_lowering_active,
            )

            self.device = _rank_device(device, dist.get_rank())
            self.plan = DistributedPlan(self.pcg, machine_mesh, mapping,
                                        overlap_lowering_active(overlap))
            machine_mesh.open_groups(self.plan.axis_sets())
        # the interpreter's walk, and the values each node is the last
        # consumer of: dropped as soon as it has run, so a pass holds only
        # live activations (the JAX package's compiled program frees them
        # likewise)
        self._order = self.pcg.topological_ordering()
        inputs = [n for n in self._order if isinstance(self.pcg.op_attrs(n), InputAttrs)]
        if len(inputs) != 1:
            raise ValueError(
                "serving expects a single-input (decoder-only) model, found "
                f"{len(inputs)} input layers"
            )
        self._input_tensor = self.pcg.outputs_of(inputs[0])[0]
        self.logit_tensor = _sink_logit(self.pcg)
        if self.plan is not None:
            # the logits before the plan's trailing layout moves: each call
            # takes the rows it needs (the last position, the greedy token)
            # from its piece and gathers only those
            self.logit_tensor = _before_layout_moves(self.pcg, self.logit_tensor)
            needed = _ancestors(self.pcg, [self.logit_tensor])
            self._order = [n for n in self._order if n in needed]
        self._free_after = self._last_uses()
        self.layers: List[CacheLayer] = attention_layers(self.pcg)
        self._layer_of = {layer.node: layer for layer in self.layers}
        bind_cache_axes(self.pcg, self.layers, self._cache_binding())
        self.cache_shardings = cache_shardings(self.layers, machine_mesh)
        self._weight_key = weight_ordinals(self.pcg)
        if machine_mesh is None:
            self.params = (
                {k: v.to(self.device) for k, v in params.items()}
                if params is not None
                else init_serving_params(self.pcg, params_seed, self.device)
            )
        else:
            from flexflow_tpu_torch.parallel.sharding import local_block

            full = params if params is not None else init_serving_params(
                self.pcg, params_seed, "cpu")
            self.params = {}
            for n, key in self._weight_key.items():
                (out,) = self.pcg.outputs_of(n)
                self.params[key] = local_block(torch.as_tensor(full[key]).cpu(),
                                               self.plan.shardings[out], machine_mesh,
                                               key).contiguous().to(self.device)
        # the decode windows' CUDA graphs, one per step count and cache
        self.graphs = CapturedGraphs(self.device)
        # the last decode window: its steps, and whether it ran as a
        # captured graph
        self.last_window: Optional[Dict[str, object]] = None

    def _last_uses(self) -> Dict[object, List]:
        """node -> the values it is the last reader of (a fused ag_matmul
        site reads its Combine's input)."""
        pos = {n: i for i, n in enumerate(self._order)}
        last_use = {}
        for n in self._order:
            reads = list(self.pcg.inputs_of(n))
            if self.plan is not None and n in self.plan.nodes and self.plan.nodes[n].fused_source:
                reads.append(self.plan.nodes[n].fused_source)
            for v in reads:
                if v not in last_use or pos[last_use[v]] < pos[n]:
                    last_use[v] = n
        free: Dict[object, List] = {}
        for v, n in last_use.items():
            free.setdefault(n, []).append(v)
        return free

    def _cache_binding(self) -> Dict:
        """The per-dim axes of each attention op's q and packed weight as
        the op receives them (its operands after the plan's reshards), for
        bind_cache_axes; empty on one device."""
        if self.plan is None:
            return {}
        binding = {}
        for layer in self.layers:
            p = self.plan.nodes[layer.node]
            if p.whole:
                raise NotImplementedError(
                    f"attention {layer.name} runs on whole values ({p.whole}): serving does not "
                    "lower a cache cut over positions or embedding")
            ins = self.pcg.inputs_of(layer.node)
            binding[ins[0]] = p.need[0].dims
            binding[ins[3]] = p.need[3].dims
        return binding

    def init_cache(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The zeroed per-layer K/V cache on this program's device: over a
        mesh, this rank's piece."""
        return init_cache(self.layers, self.serving, self.device, mesh=self.machine_mesh)

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def _mask(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.bool, device=self.device)

    def _capturable(self) -> bool:
        """Whether a decode window can be one CUDA graph: on one card,
        always; over ranks, where NCCL carries the collectives."""
        if self.device.type != "cuda":
            return False
        if self.machine_mesh is None:
            return True
        import torch.distributed as dist

        return dist.get_backend(self.machine_mesh.group) == "nccl"

    # -- the shared forward interpreter ------------------------------------

    def _slots_of(self, x: torch.Tensor, axes) -> torch.Tensor:
        """This rank's slots of a replicated per-slot tensor."""
        from flexflow_tpu_torch.parallel.sharding import TensorSharding, local_block

        if not axes:
            return x
        return local_block(x, TensorSharding((tuple(axes),)), self.machine_mesh, "slots")

    def _forward(self, params, x, cache, lengths, active, mode):
        """One forward pass of the PCG with KV-cached attention. Returns
        (logits, cache); the cache is written in place. `active` masks the
        slots this call may write (freshly admitted slots in prefill,
        generating slots in decode); every other slot keeps its bits. Over
        a mesh x, lengths and active are the whole slot batch, and the
        logits this rank's piece."""
        env: Dict = {}
        for n in self._order:
            attrs = self.pcg.op_attrs(n)
            outs = self.pcg.outputs_of(n)
            if isinstance(attrs, InputAttrs):
                env[outs[0]] = x if self.plan is None else self._local_input(x)
            elif isinstance(attrs, WeightAttrs):
                env[outs[0]] = params[self._weight_key[n]]
            elif self.plan is not None:
                from flexflow_tpu_torch.parallel.executor import eval_node

                run = None
                if n in self._layer_of:
                    run = self._attention_run(self._layer_of[n], cache, lengths, active, mode)
                eval_node(self.plan, n, env, run=run)
            elif is_parallel_op(attrs):
                (src,) = self.pcg.inputs_of(n)
                env[outs[0]] = env[src]
            else:
                slot_vals = [env[v] for v in self.pcg.inputs_of(n)]
                data_vals, weight_vals = split_slot_values(attrs, slot_vals)
                if n in self._layer_of:
                    kv = cache[self._layer_of[n].name]
                    results = [self._cached_attention(
                        attrs, data_vals, weight_vals, kv["k"], kv["v"], lengths, active, mode,
                    )]
                else:
                    results = kernel_forward(attrs, data_vals, weight_vals)
                for o, r in zip(outs, results):
                    env[o] = r
            for v in self._free_after.get(n, ()):
                env.pop(v, None)
        return env[self.logit_tensor], cache

    def _local_input(self, x: torch.Tensor) -> torch.Tensor:
        from flexflow_tpu_torch.parallel.sharding import local_block

        return local_block(x, self.plan.shardings[self._input_tensor], self.machine_mesh, "tokens")

    def _attention_run(self, layer: CacheLayer, cache, lengths, active, mode):
        """The executor's `run` for one attention node over a mesh: cached
        attention of the rank's local heads (the weight piece's count) and
        slots, the output bias added at sum index 0 of the head axes."""
        from flexflow_tpu_torch.parallel import collectives as C

        kv = cache[layer.name]
        lengths = self._slots_of(lengths, layer.batch_axes)
        active = self._slots_of(active, layer.batch_axes)

        def run(attrs, vals, p, mesh):
            data_vals, weight_vals = split_slot_values(attrs, vals)
            heads = weight_vals[0].shape[1]
            if heads != attrs.num_heads:
                attrs = dataclasses.replace(attrs, num_heads=heads, kdim=attrs.q_proj_size,
                                            vdim=attrs.v_proj_size)
            return [self._cached_attention(
                attrs, data_vals, weight_vals, kv["k"], kv["v"], lengths, active, mode,
                bias_on=C.sum_group_zero(mesh, p.bias_axes))]

        return run

    def _cached_attention(self, attrs, data_vals, weight_vals, cache_k, cache_v,
                          lengths, active, mode, bias_on: bool = True):
        """Causal attention over the persistent cache: the serving lowering
        of a MultiHeadAttention node. Prefill writes the whole padded
        prompt's K/V (zeros past it) into the active slots; decode writes
        one position per active slot, at its length, and attends over every
        position up to it. The JAX package's math: scaled scores, a -1e30
        mask, softmax, the wo einsum. `bias_on`: whether this rank adds the
        output bias (at sum index 0 where the heads are cut)."""
        q, k, v = data_vals
        input_bias = weight_vals[1] if attrs.bias else None
        qp, kp, vp, wo = mha_project_qkv(attrs, q, k, v, weight_vals[0], input_bias)
        scale = math.sqrt(attrs.q_proj_size)
        seq_cap = cache_k.shape[2]
        if mode == "prefill":
            s = qp.shape[2]
            if s > seq_cap:
                raise ValueError(f"prompt length {s} exceeds max_seq_len {seq_cap}")
            pos = torch.arange(s, device=qp.device)
            causal = pos[:, None] >= pos[None, :]
            valid_k = pos[None, :] < lengths[:, None]
            mask = causal[None, None, :, :] & valid_k[:, None, None, :]
            scores = torch.einsum("bhsk,bhtk->bhst", qp, kp) / scale
            attn = torch.softmax(torch.where(mask, scores, BIG_NEG), dim=-1)
            ctx = torch.einsum("bhst,bhtv->bhsv", attn, vp)
            write = active[:, None, None, None]
            for cache, new in ((cache_k, kp), (cache_v, vp)):
                cache[:, :, :s] = torch.where(write, new, cache[:, :, :s])
                cache[:, :, s:].masked_fill_(write, 0.0)
        else:
            # decode: write this token's K/V at each active slot's length
            # (a slot already at the cap writes nothing, as the JAX
            # one-hot blend), then attend over positions <= that length
            slots = torch.arange(qp.shape[0], device=qp.device)
            pos = lengths.long().clamp(max=seq_cap - 1)
            write = (active & (lengths < seq_cap))[:, None, None]
            for cache, new in ((cache_k, kp), (cache_v, vp)):
                cache[slots, :, pos] = torch.where(write, new[:, :, 0], cache[slots, :, pos])
            limit = torch.where(active, lengths, 0)
            valid = torch.arange(seq_cap, device=qp.device)[None, :] <= limit[:, None]
            scores = torch.einsum("bhqd,bhtd->bhqt", qp, cache_k) / scale
            attn = torch.softmax(torch.where(valid[:, None, None, :], scores, BIG_NEG), dim=-1)
            ctx = torch.einsum("bhqt,bhtv->bhqv", attn, cache_v)
        out = torch.einsum("bhsv,veh->bse", ctx, wo)
        if attrs.bias and bias_on:
            out = out + weight_vals[2]
        return out

    # -- the logits over a mesh -------------------------------------------

    def _logit_rows(self, logits):
        """(logits with their partial sums summed and their positions
        whole, the axes of their slots, the axes of their classes): on one
        device the logits as they are."""
        if self.plan is None:
            return logits, (), ()
        from flexflow_tpu_torch.parallel import collectives as C
        from flexflow_tpu_torch.parallel.sharding import TensorSharding

        s = self.plan.shardings[self.logit_tensor]
        dst = TensorSharding((s.dims[0],) + ((),) * (len(s.dims) - 2) + (s.dims[-1],))
        if s.dims != dst.dims or s.sum:
            logits = C.reshard(logits, s, dst, self.machine_mesh)
        return logits, s.dims[0], s.dims[-1]

    def _greedy(self, rows: torch.Tensor, slot_axes, class_axes) -> torch.Tensor:
        """The greedy token of every slot, whole on every rank, from this
        rank's rows [slots piece, classes piece]: across class shards the
        cross-shard argmax (ties to the lowest class)."""
        if not class_axes:
            nxt = rows.argmax(dim=-1)
        else:
            from flexflow_tpu_torch.kernels.metrics import sharded_argmax
            from flexflow_tpu_torch.parallel import collectives as C

            mesh = self.machine_mesh
            nxt = sharded_argmax(
                rows, mesh.index(class_axes) * rows.shape[-1],
                lambda x: C.all_reduce_extreme(x, mesh, class_axes, largest=True),
                lambda x: C.all_reduce_extreme(x, mesh, class_axes, largest=False))
        nxt = nxt.to(torch.int32)
        if slot_axes:
            from flexflow_tpu_torch.parallel import collectives as C

            nxt = C.all_gather(nxt, 0, self.machine_mesh, slot_axes)
        return nxt

    def _whole_rows(self, rows: torch.Tensor, slot_axes, class_axes) -> torch.Tensor:
        """[slots, classes] whole on every rank from this rank's rows."""
        from flexflow_tpu_torch.parallel import collectives as C

        for dim, axes in ((1, class_axes), (0, slot_axes)):
            if axes:
                rows = C.all_gather(rows, dim, self.machine_mesh, axes)
        return rows

    # -- the two calls -----------------------------------------------------

    @torch.no_grad()
    def prefill(self, cache, tokens, lengths, fresh):
        """Admit prompts. `tokens` is the full slot batch [slots,
        prompt_len] (stale slots carry arbitrary values), `lengths` the
        per-slot prompt lengths, `fresh` the admission mask. Returns
        (cache, first generated token per slot, last-position logits)."""
        tokens, lengths, fresh = self._ids(tokens), self._ids(lengths), self._mask(fresh)
        logits, cache = self._forward(self.params, tokens, cache, lengths, fresh, "prefill")
        logits, slot_axes, class_axes = self._logit_rows(logits)
        local = self._slots_of(lengths, slot_axes)
        idx = (local.long() - 1).clamp(0, logits.shape[1] - 1)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        nxt = self._greedy(last, slot_axes, class_axes)
        return cache, nxt, self._whole_rows(last, slot_axes, class_axes)

    def decode_window(self, cache, token, lengths, active, steps: int):
        """`steps` greedy decode steps in one call, with nothing read back
        to the host until it returns: on a CUDA device the replay of the
        graph of decode_window_eager for this step count and these cache
        tensors (captured at its first window; its warm-up runs with no
        slot active, which writes nothing), on the CPU and over gloo ranks
        that body (`last_window` says which ran). Returns
        (cache, token, lengths, generated tokens [slots, steps]), all on
        the device; the cache is written in place."""
        steps = int(steps)
        captured = self._capturable()
        self.last_window = {"steps": steps, "captured": captured}
        if self.device.type == "cuda" and not captured:
            # collectives no graph can hold: the steps in one call, eagerly
            return self.decode_window_eager(cache, token, lengths, active, steps)
        inputs = {"token": self._ids(token), "lengths": self._ids(lengths),
                  "active": self._mask(active)}
        kv = [t for layer in cache.values() for t in layer.values()]
        key = (steps, shape_key(inputs), layout_key(kv), layout_key(self.params.values()))

        def body(x):
            return self.decode_window_eager(cache, x["token"], x["lengths"], x["active"], steps)[1:]

        idle = dict(inputs, active=torch.zeros_like(inputs["active"]))
        token, lengths, toks = self.graphs.run(key, body, inputs, warmup_inputs=idle)
        return cache, token.clone(), lengths.clone(), toks.clone()

    def exec_contract(self, window_steps: int = 4):
        """The execution contract of both serving programs (the JAX
        package's ServingProgram.exec_contract): a prefill and a
        `window_steps` decode window (its eager body: a replayed graph runs
        no op a recorder sees), each recorded once on zero-filled arguments
        and a fresh cache (analysis/step_program.py), the KV cache the
        in-place state (the MEM005 verdict prices it as written in place: a
        cache handed back in new storage doubles exactly the residency the
        admission cap is computed from). Returns {"prefill": (analysis,
        diagnostics), "decode": (analysis, diagnostics)}."""
        from flexflow_tpu_torch.analysis.exec_contract import (
            analyze_step_program,
            exec_diagnostics,
        )
        from flexflow_tpu_torch.analysis.step_program import _render, record_program
        from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import get_reduced_shape

        ts = get_reduced_shape(self.pcg.tensor_shape(self._input_tensor))
        slots = ts.dims[0]
        tokens = torch.zeros(tuple(ts.dims), dtype=torch.int32, device=self.device)
        token = torch.zeros((slots,), dtype=torch.int32, device=self.device)
        lengths = torch.ones((slots,), dtype=torch.int32, device=self.device)
        mask = torch.ones((slots,), dtype=torch.bool, device=self.device)
        constants = {"program": "serving", "window_steps": int(window_steps)}

        def sig(**args):
            return [f"{k}:{_render(v)}" for k, v in args.items()]

        out = {}
        prog = record_program(
            lambda st: {"cache": self.prefill(st["cache"], tokens, lengths, mask)[0]},
            {"cache": self.init_cache()}, ("cache",), sig(tokens=tokens, lengths=lengths),
            dict(constants, call="prefill"))
        a = analyze_step_program(prog)
        out["prefill"] = (a, exec_diagnostics(a))
        prog = record_program(
            lambda st: {"cache": self.decode_window_eager(st["cache"], token, lengths, mask,
                                                          int(window_steps))[0]},
            {"cache": self.init_cache()}, ("cache",), sig(token=token, lengths=lengths),
            dict(constants, call="decode"))
        a = analyze_step_program(prog)
        out["decode"] = (a, exec_diagnostics(a))
        return out

    @torch.no_grad()
    def decode_window_eager(self, cache, token, lengths, active, steps: int):
        """decode_window's body, run as it is: `steps` forward passes, each
        writing the cache in place."""
        token, lengths, active = self._ids(token), self._ids(lengths), self._mask(active)
        toks = []
        for _ in range(steps):
            logits, cache = self._forward(
                self.params, token[:, None], cache, lengths, active, "decode"
            )
            rows, slot_axes, class_axes = self._logit_rows(logits)
            nxt = self._greedy(rows[:, -1, :], slot_axes, class_axes)
            token = torch.where(active, nxt, token)
            lengths = torch.where(active, lengths + 1, lengths)
            toks.append(nxt)
        return cache, token, lengths, torch.stack(toks, dim=1)
