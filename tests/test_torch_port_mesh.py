"""The port's mesh and sharding (flexflow_tpu_torch.parallel.mesh and
.sharding) against the JAX package's MachineMesh and pcg_shardings.

For the small flagship (2 layers, hidden 256, 4 heads of 64) and the small
parallel transformer, under the data-parallel, tensor-parallel, dp x tp and
dp x sp plans at 2 and 4 devices, a searched mapping on 2 nodes of 2
devices, and a weight whose Repartition chain rests it fully sharded:
every tensor's axis names and sizes must equal the JAX PartitionSpec, and
where the JAX package leaves a pending-sum tensor unconstrained, the port's
sum axes are the ones its allocation order gives (dims, then sum). A degree
the mesh cannot express raises, naming the tensor and the degree. No
process is spawned: the sharding reads the mesh's axes alone (MeshAxes)."""

import dataclasses

import jax
import numpy as np
import pytest

import bench
from flexflow_tpu.compiler import MachineMappingCache as JCache
from flexflow_tpu.compiler import MachineMappingContext as JContext
from flexflow_tpu.compiler.machine_mapping.cost_estimator import (
    AnalyticTPUCostEstimator,
    make_default_allowed_machine_views as j_views,
)
from flexflow_tpu.compiler.unity_algorithm import (
    data_parallel_seed as j_dp,
    evaluate_pcg as j_evaluate,
    sequence_parallel_seed as j_sp,
    tensor_parallel_seed as j_tp,
)
from flexflow_tpu.models.parallel_transformer import (
    ParallelTransformerConfig as JConfig,
    build_parallel_transformer as j_build,
)
from flexflow_tpu.parallel.mesh import AxisPool as JAxisPool
from flexflow_tpu.parallel.mesh import MachineMesh as JMesh
from flexflow_tpu.parallel.mesh import prime_factorization as j_factor
from flexflow_tpu.parallel.sharding import _prefer_inter_flags as j_flags
from flexflow_tpu.parallel.sharding import pcg_shardings as j_shardings
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu_torch.compiler.unity_algorithm import (
    data_parallel_seed,
    sequence_parallel_seed,
    tensor_parallel_seed,
)
from flexflow_tpu_torch.models import (
    ParallelTransformerConfig,
    build_flagship_pcg,
    build_parallel_transformer,
)
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.ops import RepartitionAttrs, WeightAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims,
    ParallelTensorShape,
    ShardParallelDim,
    lift_to_parallel,
)
from flexflow_tpu_torch.op_attrs.core import get_parallel_output_shapes
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.parallel.mesh import AxisPool, MeshAxes, prime_factorization
from flexflow_tpu_torch.parallel.sharding import pcg_shardings, sharding_for_shape
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
from flexflow_tpu_torch.pcg.parallel_computation_graph import (
    ParallelComputationGraph,
    ParallelLayerAttrs,
    ParallelTensorAttrs,
)
from flexflow_tpu_torch.utils.graph import Node

FLAGSHIP = dict(batch=8, seq=128, embed=256, heads=4, layers=2, vocab=512)
TRANSFORMER = dict(batch_size=8, sequence_length=64, num_features=128, num_heads=4,
                   num_layers=2, vocab_size=32, data_parallel_degree=1,
                   tensor_parallel_degree=1, sequence_parallel_degree=1)


def _flagship(dp, tp, sp):
    """The port's and the JAX package's flagship under a dp x tp x sp seed,
    built as enumerate_seeds builds it (tp, then sp, then dp)."""
    t, j = build_flagship_pcg(**FLAGSHIP), bench.build_flagship_pcg(**FLAGSHIP)
    if tp > 1:
        t, j = tensor_parallel_seed(t, tp), j_tp(j, tp)
    if sp > 1:
        t, j = sequence_parallel_seed(t, sp), j_sp(j, sp)
    if dp > 1:
        t, j = data_parallel_seed(t, dp), j_dp(j, dp)
    return t, j


def _transformer(dp, tp, sp):
    kw = dict(TRANSFORMER, data_parallel_degree=dp, tensor_parallel_degree=tp,
              sequence_parallel_degree=sp, causal=sp > 1)
    return (build_parallel_transformer(ParallelTransformerConfig(**kw))[0],
            j_build(JConfig(**kw))[0])


def _jax_mesh(n, nodes=1):
    spec = JSpec(nodes, 1, n // nodes, 25.0, 400.0)
    return JMesh.from_spec(spec, jax.devices()[:n])


def _entries(spec, rank):
    """PartitionSpec entries as tuples of axis names, padded to the rank."""
    out = []
    for e in tuple(spec) + (None,) * (rank - len(spec)):
        out.append(() if e is None else tuple(e) if isinstance(e, (tuple, list)) else (e,))
    return tuple(out)


def _expected_sum_tensor(pts, mm, view):
    """What the port gives a pending-sum activation the JAX package leaves
    unconstrained: its dims, then its sum degree, in the JAX allocation
    order and with the JAX view flags."""
    pool, flags = JAxisPool(mm), iter(j_flags(pts, view))
    dims = tuple(pool.allocate(d, prefer_inter=next(flags, False)) if d > 1 else ()
                 for d in pts.shard_degrees())
    return dims, pool.allocate(pts.sum_degree, prefer_inter=next(flags, False))


def _assert_same_shardings(tp, jp, n, nodes=1, t_mapping=None, j_mapping=None):
    mm = _jax_mesh(n, nodes)
    want = j_shardings(jp, mm, j_mapping)
    got = pcg_shardings(tp, MeshAxes(MachineSpecification(nodes, 1, n // nodes, 25.0, 400.0)),
                        t_mapping)
    t_topo, j_topo = tp.topological_ordering(), jp.topological_ordering()
    assert len(t_topo) == len(j_topo)
    checked_sum = 0
    for tn, jn in zip(t_topo, j_topo):
        assert tn.idx == jn.idx
        for to, jo in zip(tp.outputs_of(tn), jp.outputs_of(jn)):
            rank = tp.tensor_shape(to).num_dims
            if want[jo] is None:
                dims, total = _expected_sum_tensor(jp.tensor_shape(jo), mm,
                                                   (j_mapping or {}).get(jn))
                assert jp.tensor_shape(jo).sum_degree > 1, (tn, jo)
                assert (got[to].dims, got[to].sum) == (dims, total), tn
                checked_sum += 1
            else:
                assert got[to].dims == _entries(want[jo].spec, rank), tn
                assert got[to].sum == ()
    return checked_sum


def test_mesh_axes_are_the_prime_factors_of_each_level():
    for n in (1, 2, 4, 6, 8, 12):
        assert prime_factorization(n) == j_factor(n)
    axes = MeshAxes(MachineSpecification(2, 1, 4, 25.0, 400.0))
    mm = _jax_mesh(8, nodes=2)
    assert axes.names == mm.axis_names() == ("n0", "d0", "d1") and axes.world_size == 8
    assert (axes.node_axes, axes.device_axes) == (mm.node_axes, mm.device_axes)
    for prefer in (False, True):
        pool, jpool = AxisPool(axes), JAxisPool(mm)
        for degree in (4, 2):
            assert pool.allocate(degree, prefer) == jpool.allocate(degree, prefer)


@pytest.mark.parametrize("plan,n", [((2, 1, 1), 2), ((4, 1, 1), 4), ((1, 2, 1), 2),
                                    ((1, 4, 1), 4), ((2, 2, 1), 4), ((2, 1, 2), 4)],
                         ids=["dp2", "dp4", "tp2", "tp4", "dp2xtp2", "dp2xsp2"])
def test_flagship_plans_shard_as_jax(plan, n):
    sums = _assert_same_shardings(*_flagship(*plan), n)
    # tensor parallelism leaves its partial sums for GSPMD; the port places them
    assert (sums > 0) == (plan[1] > 1)


@pytest.mark.parametrize("plan,n", [((2, 1, 1), 2), ((1, 2, 1), 2), ((2, 2, 1), 4),
                                    ((1, 4, 1), 4), ((2, 1, 2), 4), ((1, 1, 2), 2)],
                         ids=["dp2", "tp2", "dp2xtp2", "tp4", "dp2xsp2", "sp2"])
def test_parallel_transformer_plans_shard_as_jax(plan, n):
    _assert_same_shardings(*_transformer(*plan), n)


def test_searched_mapping_on_two_nodes_shards_as_jax():
    """A mapping of the JAX machine-mapping DP on 2 nodes of 2 devices: its
    projections choose node or device axes, in both packages alike."""
    tp, jp = _flagship(2, 2, 1)
    spec = JSpec(2, 1, 2, 25.0, 400.0)
    ctx = JContext(AnalyticTPUCostEstimator(spec, peak_flops=1e11, hbm_gbps=100.0),
                   j_views())
    result = j_evaluate(jp, ctx, spec, JCache())
    j_mapping = result.machine_mapping
    assert any(p.value == "inter_node" for v in j_mapping.values() for p in v.projections())
    from flexflow_tpu_torch.pcg.file_format import from_jsonable
    from flexflow_tpu.pcg.file_format import to_jsonable as j_to_jsonable

    t_mapping = {Node(k.idx): from_jsonable(j_to_jsonable(v)) for k, v in j_mapping.items()}
    _assert_same_shardings(tp, jp, 4, nodes=2, t_mapping=t_mapping, j_mapping=j_mapping)


def test_weight_repartition_chain_rests_fully_sharded():
    """As tests/test_parallel_lowering.py's: the weight and every link of
    its Repartition chain take the chain's final sharding."""
    pcg = ParallelComputationGraph()
    wts = TensorShape((32, 16), DataType.FLOAT)
    _, (v,) = pcg.add_node(ParallelLayerAttrs(WeightAttrs(wts), "w"), [],
                           [ParallelTensorAttrs(lift_to_parallel(wts), True, None)])
    chain = [v]
    for attrs in (RepartitionAttrs(0, 2), RepartitionAttrs(1, 2)):
        (shape,) = get_parallel_output_shapes(attrs, [pcg.tensor_shape(v)])
        _, (v,) = pcg.add_node(ParallelLayerAttrs(attrs, None), [v],
                               [ParallelTensorAttrs(shape, True, None)])
        chain.append(v)
    got = pcg_shardings(pcg, MeshAxes(MachineSpecification(1, 1, 4, 25.0, 400.0)))
    assert {got[t] for t in chain} == {got[chain[-1]]}
    assert got[chain[0]].dims == (("d0",), ("d1",))


def test_an_inexpressible_degree_raises_naming_the_tensor_and_degree():
    axes = MeshAxes(MachineSpecification(1, 1, 8, 25.0, 400.0))
    pts = ParallelTensorShape(ParallelTensorDims(
        (ShardParallelDim(30, 3), ShardParallelDim(16, 1))), DataType.FLOAT)
    with pytest.raises(NotImplementedError, match=r"probe .*dim 0 shard degree 3.*A7 item 3"):
        sharding_for_shape(pts, axes, what="probe")
    # a tp2 plan on a machine of 3 devices: no axis of size 2
    tp, _ = _flagship(1, 2, 1)
    with pytest.raises(NotImplementedError, match=r"output 0 of .*degree 2"):
        pcg_shardings(tp, MeshAxes(MachineSpecification(1, 1, 3, 25.0, 400.0)))


def test_a_weight_with_copies_takes_its_replica_axes_first():
    axes = MeshAxes(MachineSpecification(1, 1, 8, 25.0, 400.0))
    pts = ParallelTensorShape(ParallelTensorDims(
        (ShardParallelDim(32, 1), ShardParallelDim(64, 2)), 1, 2), DataType.FLOAT)
    weight = sharding_for_shape(pts, axes, is_weight=True)
    act = sharding_for_shape(pts, axes)
    assert (weight.copy, weight.spec()) == (("d0",), (None, "d1"))
    assert (act.copy, act.spec()) == (("d1",), (None, "d0"))
    assert dataclasses.replace(act, copy=()).placed() == frozenset({"d0"})
    assert np.prod([axes.sizes[a] for a in weight.placed() | set(weight.copy)]) == 4
