"""The KV cache (port of flexflow_tpu/serving/kv_cache.py).

Serving keeps one persistent tensor pair per attention layer, K and V of
shape ``[slots, heads, max_seq_len, head_dim]``, alive across requests. The
cache's degrees are bound to the plan's own sharding (slots follow the
batch axes of the attention op's q operand, heads the head axes of its
packed weight, both as the op receives them) and lowered through regex
partition rules (`match_partition_rules`). Over a mesh of ranks each rank
allocates only its piece, ``[slots / batch degree, heads / head degree,
max_seq_len, head_dim]`` (`init_cache` with the mesh); without a mesh every
axis is whole.

The same degrees price the cache: `per_device_cache_bytes` sums
`analysis.memory_accounting.kv_cache_piece_bytes` over the layers, the one
formula behind both the allocation and its check.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import torch

from flexflow_tpu_torch.analysis.memory_accounting import (
    ServingMemorySpec,
    _weight_slot_shape,
    kv_cache_piece_bytes,
)
from flexflow_tpu_torch.local_execution.training_backing import slot_roles
from flexflow_tpu_torch.op_attrs.core import IncomingTensorRole
from flexflow_tpu_torch.op_attrs.ops import MultiHeadAttentionAttrs, RingAttentionAttrs

__all__ = [
    "CacheLayer",
    "ServingMemorySpec",
    "attention_layers",
    "bind_cache_axes",
    "cache_partition_rules",
    "cache_shardings",
    "init_cache",
    "match_partition_rules",
    "per_device_cache_bytes",
]

# a cache leaf's partition spec: one entry per dim of [slots, heads,
# positions, head_dim], each a tuple of mesh axes or None (unsharded)
Spec = Tuple[Optional[Tuple[str, ...]], ...]


@dataclass
class CacheLayer:
    """One attention layer's cache slice: the PCG node, its attrs, and the
    mesh axes its K/V tensors are bound to."""

    name: str  # cache key ("layer0", "layer1", ...)
    node: object  # utils.graph.Node of the MultiHeadAttentionAttrs op
    attrs: MultiHeadAttentionAttrs
    batch_axes: Optional[Tuple[str, ...]] = None  # mesh axes sharding cache slots
    head_axes: Optional[Tuple[str, ...]] = None  # mesh axes sharding cache heads


def attention_layers(graph) -> List[CacheLayer]:
    """The cache layout of a (P)CG: one CacheLayer per MultiHeadAttention
    node in topological order. Sequence-parallel attention (RingAttention)
    is refused: its K/V lives sharded by position in a rotating ring, which
    serving does not lower."""
    layers: List[CacheLayer] = []
    for n in graph.topological_ordering():
        attrs = graph.op_attrs(n)
        if isinstance(attrs, RingAttentionAttrs):
            raise NotImplementedError(
                "serving does not lower sequence-parallel attention (RingAttention)"
            )
        if isinstance(attrs, MultiHeadAttentionAttrs):
            layers.append(CacheLayer(f"layer{len(layers)}", n, attrs))
    return layers


def _entry_names(entry) -> Tuple:
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(entry)
    return (entry,)


def bind_cache_axes(pcg, layers: List[CacheLayer], shardings) -> None:
    """Bind each layer's cache axes to the plan's own sharding: slots
    follow the q input's batch axes, heads the packed weight's head axes
    (dim 1). `shardings` maps a DataflowOutput to its per-dim mesh axes
    (parallel.sharding.pcg_shardings); an empty map binds nothing."""
    for layer in layers:
        ins = pcg.inputs_of(layer.node)
        roles = slot_roles(layer.attrs, len(ins))
        q_spec = tuple(shardings.get(ins[0]) or ()) if ins else ()
        w_spec = ()
        for v, role in zip(ins, roles):
            if role == IncomingTensorRole.WEIGHT:
                w_spec = tuple(shardings.get(v) or ())
                break
        layer.batch_axes = _entry_names(q_spec[0] if len(q_spec) > 0 else None) or None
        layer.head_axes = _entry_names(w_spec[1] if len(w_spec) > 1 else None) or None


def match_partition_rules(rules, names) -> Dict[str, Spec]:
    """Map each cache leaf name through the first regex rule that matches
    it, returning name -> spec. Raises when a leaf matches no rule: a
    silently unsharded cache is the overflow the memory check prevents."""
    out = {}
    for name in names:
        for rule, spec in rules:
            if re.search(rule, name) is not None:
                out[name] = spec
                break
        else:
            raise ValueError(f"partition rule not found for cache leaf: {name}")
    return out


def cache_partition_rules(layers: List[CacheLayer]) -> List[Tuple[str, Spec]]:
    """One ``layerN/(k|v)`` rule per attention layer carrying that layer's
    bound axes (slots, heads, positions, head_dim), then a
    replicate-everything fallback."""
    rules: List[Tuple[str, Spec]] = [
        (rf"^{layer.name}/(k|v)$", (layer.batch_axes, layer.head_axes, None, None))
        for layer in layers
    ]
    rules.append((r".*", ()))
    return rules


def cache_shardings(layers: List[CacheLayer], mesh) -> Dict[str, Spec]:
    """name -> spec of every cache leaf, from `cache_partition_rules` (a
    leaf no rule matches raises); no mesh is the single device, with no
    shardings."""
    if mesh is None:
        return {}
    names = [f"{layer.name}/{kv}" for layer in layers for kv in ("k", "v")]
    return match_partition_rules(cache_partition_rules(layers), names)


def _piece(size: int, axes, mesh, what: str) -> int:
    n = mesh.size(axes) if axes and mesh is not None else 1
    if size % n:
        raise ValueError(f"the cache's {what} ({size}) do not divide over {n} ranks "
                         f"(mesh axes {', '.join(axes)})")
    return size // n


def init_cache(
    layers: List[CacheLayer],
    serving: ServingMemorySpec,
    device,
    dtype: torch.dtype = torch.float32,
    mesh=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """The zeroed cache {layerN: {"k": ..., "v": ...}} on `device`, each
    leaf ``[slots, heads, max_seq_len, head_dim]``: over a mesh
    (parallel.MachineMesh) this rank's piece, its slots and heads cut over
    the layer's bound axes."""
    cache = {}
    for layer in layers:
        a = layer.attrs
        shape = (_piece(serving.max_concurrent_seqs, layer.batch_axes, mesh, "slots"),
                 _piece(a.num_heads, layer.head_axes, mesh, "heads"), serving.max_seq_len)
        cache[layer.name] = {
            "k": torch.zeros(shape + (a.k_proj_size,), dtype=dtype, device=device),
            "v": torch.zeros(shape + (a.v_proj_size,), dtype=dtype, device=device),
        }
    return cache


def per_device_cache_bytes(pcg, layers: List[CacheLayer], serving: ServingMemorySpec) -> int:
    """Per-device cache residency of the plan: the sum of every attention
    leaf's `kv_cache_piece_bytes` share."""
    total = 0
    for layer in layers:
        ins = pcg.inputs_of(layer.node)
        total += kv_cache_piece_bytes(
            layer.attrs,
            pcg.tensor_shape(ins[0]) if ins else None,
            _weight_slot_shape(layer.attrs, [pcg.tensor_shape(v) for v in ins]),
            serving,
        )
    return total
