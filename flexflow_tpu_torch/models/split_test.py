"""split_test: a tiny diamond-shaped MLP used to exercise parallel SP splits
(reference: lib/models/src/models/split_test/split_test.cc:7-37).

A copy of flexflow_tpu/models/split_test.py: the same topology, initializers and
node order, so parameter keys `n{idx}` name the same weights in both
packages.
"""

from __future__ import annotations

from typing import Tuple

from flexflow_tpu_torch.pcg.computation_graph import ComputationGraph
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder, Tensor


def build_split_test(batch_size: int) -> Tuple[ComputationGraph, Tensor]:
    cgb = ComputationGraphBuilder()
    d1, d2, d3, d4 = 256, 128, 64, 32

    t = cgb.create_input([batch_size, d1], name="input")
    t = cgb.dense(t, d2)
    t = cgb.relu(t)
    t1 = cgb.dense(t, d3)
    t2 = cgb.dense(t, d3)
    t = cgb.add(t1, t2)
    t = cgb.relu(t)
    t1 = cgb.dense(t, d4)
    t2 = cgb.dense(t, d4)
    t = cgb.add(t1, t2)
    t = cgb.relu(t)
    t = cgb.softmax(t)
    return cgb.graph, t


def get_split_test_computation_graph(batch_size: int) -> ComputationGraph:
    cg, _ = build_split_test(batch_size)
    return cg
