"""Forward-only serving programs over a PCG (port of
flexflow_tpu/serving/program.py, the single-device lowering,
`machine_mesh=None`).

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
  the CPU.

Every other op runs `kernels.ops.forward`. The math is the JAX package's,
in the parameters' dtype (f32): serving attention is dense, as there, and
launches no flash kernel. The K/V cache is updated in place, where the JAX
package donates it.

Parameters are keyed by WEIGHT ORDINAL ("w0", "w1", ... in topological
order): the prefill- and decode-shaped graphs of one model share one
parameter set through it.
"""

from __future__ import annotations

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


class ServingProgram:
    """One serving plan, lowered on one device: prefill and the decode
    window over a shared parameter set and KV cache. `device=None` means
    CUDA (see resolve_device); `params` (keyed by ordinal, see
    interop.serving_params_from_numpy) override the seeded draw."""

    def __init__(
        self,
        graph,
        serving: ServingMemorySpec,
        *,
        params: Optional[Dict[str, torch.Tensor]] = None,
        params_seed: int = 0,
        device=None,
    ) -> None:
        self.device = resolve_device(device)
        self.pcg = as_pcg(graph)
        self.serving = serving
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
        self.logit_tensor = _sink_logit(self.pcg)
        last_use = {v: n for n in self._order for v in self.pcg.inputs_of(n)}
        self._free_after: Dict[object, List] = {}
        for v, n in last_use.items():
            self._free_after.setdefault(n, []).append(v)
        self.layers: List[CacheLayer] = attention_layers(self.pcg)
        self._layer_of = {layer.node: layer for layer in self.layers}
        bind_cache_axes(self.pcg, self.layers, {})
        self._weight_key = weight_ordinals(self.pcg)
        self.params = (
            {k: v.to(self.device) for k, v in params.items()}
            if params is not None
            else init_serving_params(self.pcg, params_seed, self.device)
        )
        # the decode windows' CUDA graphs, one per step count and cache
        self.graphs = CapturedGraphs(self.device)

    def init_cache(self) -> Dict[str, Dict[str, torch.Tensor]]:
        """The zeroed per-layer K/V cache on this program's device."""
        return init_cache(self.layers, self.serving, self.device)

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def _mask(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.bool, device=self.device)

    # -- the shared forward interpreter ------------------------------------

    def _forward(self, params, x, cache, lengths, active, mode):
        """One forward pass of the PCG with KV-cached attention. Returns
        (logits, cache); the cache is written in place. `active` masks the
        slots this call may write (freshly admitted slots in prefill,
        generating slots in decode); every other slot keeps its bits."""
        env: Dict = {}
        for n in self._order:
            attrs = self.pcg.op_attrs(n)
            outs = self.pcg.outputs_of(n)
            if isinstance(attrs, InputAttrs):
                env[outs[0]] = x
            elif isinstance(attrs, WeightAttrs):
                env[outs[0]] = params[self._weight_key[n]]
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
                del env[v]
        return env[self.logit_tensor], cache

    def _cached_attention(self, attrs, data_vals, weight_vals, cache_k, cache_v,
                          lengths, active, mode):
        """Causal attention over the persistent cache: the serving lowering
        of a MultiHeadAttention node. Prefill writes the whole padded
        prompt's K/V (zeros past it) into the active slots; decode writes
        one position per active slot, at its length, and attends over every
        position up to it. The JAX package's math: scaled scores, a -1e30
        mask, softmax, the wo einsum."""
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
        if attrs.bias:
            out = out + weight_vals[2]
        return out

    # -- the two calls -----------------------------------------------------

    @torch.no_grad()
    def prefill(self, cache, tokens, lengths, fresh):
        """Admit prompts. `tokens` is the full slot batch [slots,
        prompt_len] (stale slots carry arbitrary values), `lengths` the
        per-slot prompt lengths, `fresh` the admission mask. Returns
        (cache, first generated token per slot, last-position logits)."""
        tokens, lengths, fresh = self._ids(tokens), self._ids(lengths), self._mask(fresh)
        logits, cache = self._forward(self.params, tokens, cache, lengths, fresh, "prefill")
        idx = (lengths.long() - 1).clamp(0, logits.shape[1] - 1)
        last = logits[torch.arange(logits.shape[0], device=logits.device), idx]
        nxt = last.argmax(dim=-1).to(torch.int32)
        return cache, nxt, last

    def decode_window(self, cache, token, lengths, active, steps: int):
        """`steps` greedy decode steps in one call, with nothing read back
        to the host until it returns: on a CUDA device the replay of the
        graph of decode_window_eager for this step count and these cache
        tensors (captured at its first window; its warm-up runs with no
        slot active, which writes nothing), on the CPU that body. Returns
        (cache, token, lengths, generated tokens [slots, steps]), all on
        the device; the cache is written in place."""
        steps = int(steps)
        inputs = {"token": self._ids(token), "lengths": self._ids(lengths),
                  "active": self._mask(active)}
        kv = [t for layer in cache.values() for t in layer.values()]
        key = (steps, shape_key(inputs), layout_key(kv), layout_key(self.params.values()))

        def body(x):
            return self.decode_window_eager(cache, x["token"], x["lengths"], x["active"], steps)[1:]

        idle = dict(inputs, active=torch.zeros_like(inputs["active"]))
        token, lengths, toks = self.graphs.run(key, body, inputs, warmup_inputs=idle)
        return cache, token.clone(), lengths.clone(), toks.clone()

    @torch.no_grad()
    def decode_window_eager(self, cache, token, lengths, active, steps: int):
        """decode_window's body, run as it is: `steps` forward passes, each
        writing the cache in place."""
        token, lengths, active = self._ids(token), self._ids(lengths), self._mask(active)
        toks = []
        for _ in range(int(steps)):
            logits, cache = self._forward(
                self.params, token[:, None], cache, lengths, active, "decode"
            )
            nxt = logits[:, -1, :].argmax(dim=-1).to(torch.int32)
            token = torch.where(active, nxt, token)
            lengths = torch.where(active, lengths + 1, lengths)
            toks.append(nxt)
        return cache, token, lengths, torch.stack(toks, dim=1)
