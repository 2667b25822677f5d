"""The port's graph builders against the JAX package's (fault C10): the
port's ParallelComputationGraphBuilder has embedding, element_unary, relu
and softmax, and its ComputationGraph layers_by_name and get_layer_by_name,
as the JAX package's do. tests/test_pcg.py's MLP is built with both
packages' builders, the computation graph and its parallel counterpart, and
every node's attrs and every tensor's shape compared; "fc1" is looked up in
each."""

import dataclasses
import enum

import pytest

from flexflow_tpu.op_attrs import DataType as JDType
from flexflow_tpu.op_attrs import ParallelTensorDims as JDims
from flexflow_tpu.op_attrs import ParallelTensorShape as JShape
from flexflow_tpu.op_attrs import ShardParallelDim as JShard
from flexflow_tpu.op_attrs.ops import AggregateSpec as JAggr
from flexflow_tpu.op_attrs.ops import ElementUnaryOpType as JUnary
from flexflow_tpu.pcg import ComputationGraphBuilder as JCGB
from flexflow_tpu.pcg import ParallelComputationGraphBuilder as JPCGB
from flexflow_tpu_torch.op_attrs import DataType as TDType
from flexflow_tpu_torch.op_attrs.ops import AggregateSpec as TAggr
from flexflow_tpu_torch.op_attrs.ops import ElementUnaryOpType as TUnary
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorDims as TDims
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ParallelTensorShape as TShape
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import ShardParallelDim as TShard
from flexflow_tpu_torch.pcg import ComputationGraphBuilder as TCGB
from flexflow_tpu_torch.pcg import ParallelComputationGraphBuilder as TPCGB


def _plain(x):
    """A package-free view of attrs and shapes: dataclasses as (class name,
    fields), enums by name."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return type(x).__name__, tuple((f.name, _plain(getattr(x, f.name)))
                                       for f in dataclasses.fields(x))
    if isinstance(x, enum.Enum):
        return type(x).__name__, x.name
    if isinstance(x, (list, tuple)):
        return tuple(_plain(v) for v in x)
    return x


def _graph(g):
    """Each node in index order: its label, and its outputs' labels."""
    return [(_plain(g.node_label(n)), [_plain(g.value_label(v)) for v in g.outputs_of(n)])
            for n in sorted(g.nodes)]


def _mlp(b):
    """tests/test_pcg.py:30-40."""
    x = b.create_input([8, 784], name="x")
    h = b.dense(x, 512, name="fc1")
    h = b.relu(h)
    h = b.dense(h, 10, name="fc2")
    return b.softmax(h)


def _parallel_mlp(b, shape, dims, shard, unary, aggr, dtype):
    """The same MLP as a parallel graph, with an embedding and an
    element_unary beside it: every builder method C10 names."""
    x = b.create_input_tensor(shape(dims((shard(8, 1), shard(784, 1)), 1, 1)), name="x")
    h = b.dense(x, 512, name="fc1")
    h = b.relu(h)
    h = b.element_unary(unary.EXP, h, name="exp")
    h = b.dense(h, 10, name="fc2")
    out = b.softmax(h, name="probs")
    ids = b.create_input_tensor(shape(dims((shard(8, 1), shard(4, 1)), 1, 1), dtype.INT32),
                                name="ids")
    emb = b.embedding(ids, 100, 16, aggr.SUM, name="emb")
    return out, emb


def test_computation_graph_builders_match_and_find_fc1():
    jb, tb = JCGB(), TCGB()
    j_out, t_out = _mlp(jb), _mlp(tb)
    assert _graph(tb.graph) == _graph(jb.graph)
    assert _plain(tb.graph.tensor_shape(t_out)) == _plain(jb.graph.tensor_shape(j_out))
    for g in (jb.graph, tb.graph):
        fc1 = g.get_layer_by_name("fc1")
        assert type(g.op_attrs(fc1)).__name__ == "LinearAttrs"
        assert {"x", "fc1", "fc2"} <= set(g.layers_by_name())  # and the named weights
        assert g.layers_by_name()["fc1"] == fc1
    assert ({k: n.idx for k, n in tb.graph.layers_by_name().items()}
            == {k: n.idx for k, n in jb.graph.layers_by_name().items()})
    assert tb.graph.get_layer_by_name("fc1").idx == jb.graph.get_layer_by_name("fc1").idx
    with pytest.raises(AssertionError, match="matched 0 nodes"):
        tb.graph.get_layer_by_name("fc3")


def test_parallel_builders_have_the_jax_builders_methods():
    jb, tb = JPCGB(), TPCGB()
    j = _parallel_mlp(jb, JShape, JDims, JShard, JUnary, JAggr, JDType)
    t = _parallel_mlp(tb, TShape, TDims, TShard, TUnary, TAggr, TDType)
    assert _graph(tb.graph) == _graph(jb.graph)
    for jv, tv in zip(j, t):
        assert _plain(tb.graph.tensor_shape(tv)) == _plain(jb.graph.tensor_shape(jv))
    ops = [type(tb.graph.node_label(n).attrs).__name__ for n in sorted(tb.graph.nodes)]
    assert ops.count("ElementUnaryAttrs") == 2 and "SoftmaxAttrs" in ops
    assert "EmbeddingAttrs" in ops
