"""Captured CUDA graphs: one launch for a window of work (the counterpart of
the JAX package's jitted `lax.scan` windows, which it dispatches as one XLA
program each: the fused K-step train window and the serving decode window).

`CapturedGraphs` holds one owner's graphs:

- each graph is keyed by what fixes its addresses and shapes; the caller
  builds the key (the window length, `layout_key` of the tensors the body
  reads and writes in place, the inputs' shapes and dtypes);
- all of one owner's graphs share one memory pool;
- it owns each graph's static input buffers: `run` copies the call's
  inputs into them and replays; the outputs are the graph's own tensors,
  which the next replay of that graph overwrites;
- a capture first runs the body once on a side stream (the warm-up, where
  the kernels' library loads and cuBLAS makes its workspaces), then
  records it. The warm-up runs on `warmup_inputs` where the caller gives
  them, and the tensors named as `state` are restored after it, as are the
  generators, so the warm-up leaves nothing behind: the first replay
  starts from the state the call was given;
- the torch.Generators the body draws from are registered with the graph,
  so that each replay advances their Philox offset as the eager body would
  (without that, every replay would repeat one Dropout mask);
- `invalidate()` drops every graph, for when something a graph baked in
  changes: a learning rate (a Python constant in the update), or a tensor
  replaced rather than written in place.

A capture that fails raises; nothing falls back to running the body
eagerly on a CUDA device. On the CPU there is no graph: `run` calls the
body on the inputs as they are.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Hashable, Iterable, List, Optional, Sequence, Tuple

import torch

Inputs = Dict[str, torch.Tensor]


def layout_key(tensors: Iterable[torch.Tensor]) -> Tuple:
    """What fixes a graph that reads or writes `tensors` in place: each
    one's address, shape and dtype."""
    return tuple((t.data_ptr(), tuple(t.shape), t.dtype) for t in tensors)


def shape_key(inputs: Inputs) -> Tuple:
    """The names, shapes and dtypes of a graph's inputs (their addresses do
    not matter: they are copied into the graph's own buffers)."""
    return tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items())


class _Graph:
    def __init__(self, graph, static: Inputs, outputs, generators: Sequence) -> None:
        self.graph = graph
        self.static = static
        self.outputs = outputs
        # held so that no other generator can take a registered one's id()
        self.generators = tuple(generators)

    def replay(self, inputs: Inputs):
        for k, v in inputs.items():
            buf = self.static[k]
            if v.shape != buf.shape or v.dtype != buf.dtype:
                raise ValueError(f"graph input {k!r}: {tuple(v.shape)} {v.dtype}, "
                                 f"captured on {tuple(buf.shape)} {buf.dtype}")
            buf.copy_(v)
        self.graph.replay()
        return self.outputs


class CapturedGraphs:
    """One owner's CUDA graphs on `device` (see the module docstring).
    `captures` counts the captures made, `capture_ms` holds each one's host
    time (warm-up and recording, to a synchronized end)."""

    def __init__(self, device) -> None:
        self.device = torch.device(device)
        self._graphs: Dict[Hashable, _Graph] = {}
        self._pool = None
        self.captures = 0
        self.capture_ms: List[float] = []

    def __len__(self) -> int:
        return len(self._graphs)

    def invalidate(self) -> None:
        """Drop every graph, and with the last of them the shared pool."""
        self._graphs.clear()
        self._pool = None

    def run(
        self,
        key: Hashable,
        body: Callable[[Inputs], object],
        inputs: Inputs,
        *,
        warmup_inputs: Optional[Inputs] = None,
        state: Sequence[torch.Tensor] = (),
        generators: Sequence[torch.Generator] = (),
    ):
        """body(inputs), as the replay of the graph captured for `key` (at
        its first use) on a CUDA device, as a plain call on the CPU.

        body: takes a dict of tensors and enqueues its work on the current
        stream; it must not read the device back. inputs: the call's
        tensors, copied into the graph's static buffers. warmup_inputs:
        values the warm-up runs on instead of `inputs` (for a body that
        leaves its state alone on them). state: tensors the body writes in
        place; the warm-up's writes to them are undone. generators: the
        generators the body draws from."""
        if self.device.type != "cuda":
            return body(inputs)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = self._capture(
                body, inputs, warmup_inputs, state, generators)
        return graph.replay(inputs)

    def _capture(self, body, inputs: Inputs, warmup_inputs: Optional[Inputs],
                 state: Sequence[torch.Tensor], generators: Sequence[torch.Generator]) -> _Graph:
        register = getattr(torch.cuda.CUDAGraph, "register_generator_state", None)
        if generators and register is None:
            raise RuntimeError(
                f"torch {torch.__version__} cannot register a generator with a CUDA graph "
                "(CUDAGraph.register_generator_state): a captured body that draws random "
                "numbers would repeat them on every replay")
        start = time.perf_counter()
        static = {k: torch.empty(v.shape, dtype=v.dtype, device=self.device)
                  for k, v in inputs.items()}
        for k, v in (inputs if warmup_inputs is None else warmup_inputs).items():
            static[k].copy_(v)
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        # thread_local: another thread (the input pipeline's producer) may
        # allocate and copy on its own stream while this one captures
        capture = torch.cuda.graph(graph, pool=self._pool, capture_error_mode="thread_local")
        # the warm-up runs on the stream the capture records, torch's one
        # capture stream: cuBLAS keeps a workspace for every stream it has
        # run on, so a stream of its own for each warm-up would leave one
        # behind each time
        side = capture.capture_stream
        saved = [t.clone() for t in state]
        rng_states = [g.get_state() for g in generators]
        current = torch.cuda.current_stream(self.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            body(static)
        current.wait_stream(side)
        for t, s in zip(state, saved):
            t.copy_(s)
        for g, s in zip(generators, rng_states):
            g.set_state(s)
        del saved
        for g in generators:
            graph.register_generator_state(g)
        # entering synchronizes and empties the allocator's cache, so the
        # warm-up's blocks go back to the card before the pool takes its
        # own; the pool is shared by every graph of this owner
        with capture:
            outputs = body(static)
        torch.cuda.synchronize(self.device)
        self.captures += 1
        self.capture_ms.append((time.perf_counter() - start) * 1e3)
        return _Graph(graph, static, outputs, generators)
