"""The collective matmuls (kernels/collective_matmul.py) and their fused
lowering in the PCG trainer (parallel/executor.py), with
tests/test_collective_matmul.py as the spec, against the JAX package on
virtual CPU devices; the port's ranks are 2 and 4 gloo processes, each
count launched once:

- all_gather_matmul and matmul_reduce_scatter over the ring of the ranks
  against the JAX functions (fused) on as many devices, f32 and bf16, at
  the JAX spec's tolerances (ag: f32 rtol 1e-6 atol 1e-5, bf16 rtol 2e-2
  atol 1e-2; rs: f32 rtol 1e-5 atol 1e-4, bf16 rtol 1.5e-1 atol 1e-1), and
  each ring's k - 1 steps counted;
- collect_overlap_sites equal to the JAX map on build_combine_linear,
  build_row_reduction, the bias-carrying Linear (no site) and the small
  flagship's tp2 plan;
- the fused lowering of both sites in DistributedTrainingInstance(overlap=
  True): its forward and one SGD step's loss and parameters against the
  JAX DistributedTrainingInstance(overlap=True), rtol 1e-4; the fused
  sites issue k - 1 ring steps a step, in place of the Combine's
  all-gather and the Reduction's all-reduce, as step_collectives says;
- FFModel with FFConfig(overlap=True) on a forced tensor-parallel seed of
  an MLP: its row-parallel head lowers fused (matmul_rs) and fits to the
  serial lowering's parameters and loss within rtol 1e-5, its provenance
  holding the fused edge the forced seed's solve priced;
- the switches FF_TPU_OVERLAP and FF_TPU_OVERLAP_BASELINE;
- BatchMatmul's forward and its vjp against the JAX op's."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import bench
from flexflow_tpu.compiler.unity_algorithm import tensor_parallel_seed as j_tp_seed
from flexflow_tpu.kernels import ops as j_kernel_ops
from flexflow_tpu.kernels.collective_matmul import all_gather_matmul as j_agm
from flexflow_tpu.kernels.collective_matmul import matmul_reduce_scatter as j_mrs
from flexflow_tpu.op_attrs.datatype import DataType as JDT
from flexflow_tpu.op_attrs.ops import BatchMatmulAttrs as JBMM
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as JDims,
    ParallelTensorShape as JPShape,
    ShardParallelDim as JShard,
)
from flexflow_tpu.parallel import DistributedTrainingInstance as JaxDTI
from flexflow_tpu.parallel import MachineMesh as JaxMesh
from flexflow_tpu.parallel.executor import collect_overlap_sites as j_sites
from flexflow_tpu.parallel.sharding import pcg_shardings as j_shardings
from flexflow_tpu.pcg.optimizer import SGDOptimizerAttrs as JaxSGD
from flexflow_tpu.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder as JBuilder,
)
from flexflow_tpu_torch.compiler.unity_algorithm import tensor_parallel_seed
from flexflow_tpu_torch.kernels import ops as t_kernel_ops
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.op_attrs.datatype import DataType as TDT
from flexflow_tpu_torch.op_attrs.ops import BatchMatmulAttrs as TBMM
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import (
    ParallelTensorDims as TDims,
    ParallelTensorShape as TPShape,
    ShardParallelDim as TShard,
)
from flexflow_tpu_torch.parallel.executor import collect_overlap_sites as t_sites
from flexflow_tpu_torch.parallel.executor import overlap_lowering_active
from flexflow_tpu_torch.parallel.mesh import MeshAxes, _spec_for
from flexflow_tpu_torch.parallel.sharding import pcg_shardings as t_shardings
from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder as TBuilder,
)
from flexflow_tpu_torch.runtime.strategy import save_strategy
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
WORLDS = (2, 4)
TOL = {("ag", "f32"): (1e-6, 1e-5), ("ag", "bf16"): (2e-2, 1e-2),
       ("rs", "f32"): (1e-5, 1e-4), ("rs", "bf16"): (1.5e-1, 1e-1)}
FLAGSHIP = dict(batch=8, seq=64, embed=128, heads=2, layers=1, vocab=256)


def _pts(mod, sizes, degrees, sum_degree=1, copy=1):
    dims, shard, cls, dt = ((TDims, TShard, TPShape, TDT) if mod == "t"
                            else (JDims, JShard, JPShape, JDT))
    return cls(dims(tuple(shard(s, d) for s, d in zip(sizes, degrees)), sum_degree, copy),
               dt.FLOAT)


def build_combine_linear(mod, m=16, k=32, n=10, deg=4, bias=False):
    b = (TBuilder if mod == "t" else JBuilder)()
    x = b.create_input_tensor(_pts(mod, [m, k], [deg, 1]), name="x")
    xc = b.parallel_combine(x, 0, deg)
    return b.graph, b.dense(xc, n, use_bias=bias, name="head")


def build_row_reduction(mod, m=16, k=32, n=10, deg=4, bias=False):
    b = (TBuilder if mod == "t" else JBuilder)()
    x = b.create_input_tensor(_pts(mod, [m, k], [1, deg]), name="x")
    y = b.dense(x, n, use_bias=bias, name="fc")
    return b.graph, b.parallel_reduce(y, deg)


BUILDS = {"ag_matmul": build_combine_linear, "matmul_rs": build_row_reduction}


def _site_map(pcg, sites):
    return {(n.idx, pcg.layer_attrs(n).name): kind for n, kind in sites.items()}


@pytest.mark.parametrize("ndev", [2, 4, 8])
@pytest.mark.parametrize("kind", list(BUILDS))
@pytest.mark.parametrize("bias", [False, True])
def test_overlap_sites_match_jax(ndev, kind, bias):
    deg = min(ndev, 4)
    tg, _ = BUILDS[kind]("t", deg=deg, bias=bias)
    jg, _ = BUILDS[kind]("j", deg=deg, bias=bias)
    axes = MeshAxes(_spec_for(ndev))
    mm = JaxMesh.for_devices(ndev, devices=jax.devices()[:ndev])
    got = _site_map(tg, t_sites(tg, t_shardings(tg, axes), axes))
    want = _site_map(jg, j_sites(jg, j_shardings(jg, mm), mm.mesh))
    assert got == want
    # the bias-carrying Linear keeps the exactness guard: no matmul_rs site
    assert bool(got) == (kind == "ag_matmul" or not bias)


@pytest.mark.parametrize("ndev", [2, 4])
def test_overlap_sites_of_the_flagship_tp2_plan_match_jax(ndev):
    tp = tensor_parallel_seed(build_flagship_pcg(**FLAGSHIP), 2)
    jp = j_tp_seed(bench.build_flagship_pcg(**FLAGSHIP), 2)
    axes = MeshAxes(_spec_for(ndev))
    mm = JaxMesh.for_devices(ndev, devices=jax.devices()[:ndev])
    assert _site_map(tp, t_sites(tp, t_shardings(tp, axes), axes)) == \
        _site_map(jp, j_sites(jp, j_shardings(jp, mm), mm.mesh))


def test_switches(monkeypatch):
    monkeypatch.delenv("FF_TPU_OVERLAP", raising=False)
    monkeypatch.delenv("FF_TPU_OVERLAP_BASELINE", raising=False)
    assert not overlap_lowering_active() and overlap_lowering_active(True)
    monkeypatch.setenv("FF_TPU_OVERLAP", "1")
    assert overlap_lowering_active() and not overlap_lowering_active(False)
    monkeypatch.setenv("FF_TPU_OVERLAP_BASELINE", "1")
    assert not overlap_lowering_active() and not overlap_lowering_active(True)
    monkeypatch.setenv("FF_TPU_OVERLAP", "0")
    monkeypatch.delenv("FF_TPU_OVERLAP_BASELINE")
    assert not overlap_lowering_active()


@pytest.mark.parametrize("shapes", [((2, 8, 4), (2, 4, 6)), ((8, 4), (4, 6)),
                                    ((3, 2, 5, 7), (3, 2, 7, 4))])
def test_batch_matmul_forward_and_vjp_match_jax(shapes):
    rs = np.random.RandomState(4)
    a, b = (rs.randn(*s).astype(np.float32) for s in shapes)
    out_t = rs.randn(*shapes[0][:-1], shapes[1][-1]).astype(np.float32)
    (want,), vjp = jax.vjp(lambda a, b: j_kernel_ops.forward(JBMM(), [a, b], []), a, b)
    want_da, want_db = vjp([jnp.asarray(out_t)])
    ta, tb = (torch.tensor(v, requires_grad=True) for v in (a, b))
    (got,) = t_kernel_ops.forward(TBMM(), [ta, tb], [])
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-5)
    got.backward(torch.tensor(out_t))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(want_da), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(want_db), rtol=1e-6, atol=1e-5)


# One rank; argv: rank, world, work dir.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import pcg_params_from_numpy, pcg_params_to_numpy
    from flexflow_tpu_torch.kernels import collective_matmul as CM
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import (DistributedTrainingInstance, MachineMesh,
                                             init_file_group)
    from flexflow_tpu_torch.pcg import SGDOptimizerAttrs
    from flexflow_tpu_torch.runtime.strategy import load_strategy

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu")
    mesh = MachineMesh.for_devices(world)
    axes, me = mesh.names, mesh.index(mesh.names)
    data = np.load(os.path.join(work, "inputs.npz"))
    out = {}
    for dtype in ("f32", "bf16"):
        tdt = torch.float32 if dtype == "f32" else torch.bfloat16
        x, w = (torch.tensor(data[f"ag_{n}"]).to(tdt) for n in ("x", "w"))
        m = x.shape[0] // world
        before = mesh.counts["ring_step"]
        ag = CM.all_gather_matmul(x[me * m:(me + 1) * m], w, mesh, axes, 0)
        out[f"ag_{dtype}"] = ag.float().tolist()
        out[f"ag_{dtype}_steps"] = mesh.counts["ring_step"] - before
        x, w = (torch.tensor(data[f"rs_{n}"]).to(tdt) for n in ("x", "w"))
        k = x.shape[1] // world
        before = mesh.counts["ring_step"]
        rs = CM.matmul_reduce_scatter(x[:, me * k:(me + 1) * k], w[me * k:(me + 1) * k], mesh,
                                      axes)
        out[f"rs_{dtype}"] = rs.float().tolist()
        out[f"rs_{dtype}_steps"] = mesh.counts["ring_step"] - before
    for kind in ("ag_matmul", "matmul_rs"):
        pcg, _, _ = load_strategy(os.path.join(work, kind + ".json"))
        logits = pcg.outputs_of(pcg.topological_ordering()[-1])[0]
        inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                           SGDOptimizerAttrs(lr=0.1), mesh, device="cpu",
                                           overlap=True)
        z = np.load(os.path.join(work, kind + ".npz"))
        params = pcg_params_from_numpy(pcg, inst.shardings, mesh,
                                       {n: z[n] for n in z.files if n.startswith("n")})
        opt = inst.initialize(seed=0)[1]
        fwd = inst.forward(params, {"x": z["x"]})
        before = dict(mesh.counts)
        params, opt, loss, _ = inst.train_step(params, opt, {"x": z["x"]}, z["y"])
        step = {c: v - before.get(c, 0) for c, v in mesh.counts.items() if v - before.get(c, 0)}
        out[kind] = dict(
            sites=sorted(inst.overlap_sites.values()), fused=sorted(inst.fused_sites.values()),
            forward=fwd.tolist(), loss=float(loss), step=step,
            implied=dict(inst.step_collectives()),
            params={n: v.tolist() for n, v in
                    pcg_params_to_numpy(pcg, inst.shardings, mesh, params).items()})
    from flexflow_tpu_torch import core

    rs = np.random.RandomState(1)
    xs, ys = rs.randn(32, 64).astype(np.float32), rs.randint(0, 16, 32)
    for overlap in (False, True):
        m = core.FFModel(core.FFConfig(batch_size=16, seed=0, print_freq=0, search_budget=1,
                                       force_strategy_seed=f"dp1xtp{world}xsp1", overlap=overlap),
                         device="cpu")
        x = m.create_tensor([16, 64], name="x")
        m.dense(m.relu(m.dense(x, 64, use_bias=False, name="fc1")), 16, use_bias=False,
                name="out")
        m.compile(core.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  metrics=["sparse_categorical_crossentropy"])
        perf = m.fit(xs, ys, epochs=2, shuffle=False, verbose=False)
        out[f"ffmodel_{overlap}"] = dict(
            fused=sorted(m.instance.fused_sites.values()), loss=perf.sparse_cce_loss,
            overlap=m.search_provenance.get("overlap"),
            params={n: m.get_parameter_by_name(n).get_weights(m).tolist()
                    for n in ("fc1.weight0", "out.weight0")})
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()
    """
)


def _jax_executor(kind, world, xv, yv):
    pcg, logits = BUILDS[kind]("j", deg=world)
    mm = JaxMesh.for_devices(world, devices=jax.devices()[:world])
    inst = JaxDTI(pcg, logits, JaxSCCE(), JaxSGD(lr=0.1), mm, overlap=True)
    assert list(inst.overlap_sites.values()) == [kind]
    params, opt = inst.initialize(0)
    init = {k: np.array(v) for k, v in params.items()}
    fwd = np.asarray(inst.forward(params, {"x": jnp.asarray(xv)}))
    params, opt, loss, _ = inst.train_step(params, opt, {"x": jnp.asarray(xv)}, jnp.asarray(yv))
    return init, dict(forward=fwd, loss=float(loss),
                      params={k: np.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per world: the JAX references and the port's ranks, each world's
    ranks launched once (and only where a test of this worker asks)."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = once_per_session(tmp_path_factory, f"cmm_world{world}",
                                            lambda work: _run_world(work, world))
        return cache[world]

    return get


def _run_world(work, world):
    rs = np.random.RandomState(world)
    ag_x, ag_w = rs.randn(16, 24).astype(np.float32), rs.randn(24, 12).astype(np.float32)
    rs_x, rs_w = rs.randn(16, 32).astype(np.float32), rs.randn(32, 12).astype(np.float32)
    np.savez(work / "inputs.npz", ag_x=ag_x, ag_w=ag_w, rs_x=rs_x, rs_w=rs_w)
    mesh = Mesh(np.asarray(jax.devices()[:world]), ("a",))
    ref = {}
    for dtype, jdt in (("f32", jnp.float32), ("bf16", jnp.bfloat16)):
        ref[f"ag_{dtype}"] = np.asarray(j_agm(jnp.asarray(ag_x, jdt), jnp.asarray(ag_w, jdt),
                                              mesh, P("a", None), P(None, None), 0, fused=True),
                                        np.float32)
        ref[f"rs_{dtype}"] = np.asarray(j_mrs(jnp.asarray(rs_x, jdt), jnp.asarray(rs_w, jdt),
                                              mesh, P(None, "a"), P("a", None), fused=True),
                                        np.float32)
    xv = rs.randn(16, 32).astype(np.float32)
    yv = rs.randint(0, 10, 16).astype(np.int32)
    for kind in BUILDS:
        init, ref[kind] = _jax_executor(kind, world, xv, yv)
        tp, _ = BUILDS[kind]("t", deg=world)
        save_strategy(str(work / f"{kind}.json"), tp, None)
        np.savez(work / f"{kind}.npz", x=xv, y=yv, **init)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(world)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    return dict(ref=ref, ranks=[json.loads((work / f"rank{r}.json").read_text())
                                for r in range(world)])


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("fn", ["ag", "rs"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_ring_functions_match_jax(runs, world, fn, dtype):
    rtol, atol = TOL[(fn, dtype)]
    want = runs(world)["ref"][f"{fn}_{dtype}"]
    for r in runs(world)["ranks"]:
        np.testing.assert_allclose(np.asarray(r[f"{fn}_{dtype}"]), want, rtol=rtol, atol=atol)
        assert r[f"{fn}_{dtype}_steps"] == world - 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(BUILDS))
def test_fused_lowering_matches_the_jax_trainer(runs, world, kind):
    want = runs(world)["ref"][kind]
    for r in runs(world)["ranks"]:
        got = r[kind]
        assert got["sites"] == got["fused"] == [kind]
        np.testing.assert_allclose(np.asarray(got["forward"]), want["forward"], rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-4)
        assert got["params"].keys() == want["params"].keys()
        for name, w in want["params"].items():
            np.testing.assert_allclose(np.asarray(got["params"][name]), w, rtol=1e-4, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("kind", list(BUILDS))
def test_fused_sites_ring_in_place_of_the_collective(runs, world, kind):
    """A step runs the site's k - 1 ring steps (the backward needs none, as
    the serial lowering's moves nothing) and not the Combine's all-gather
    or the Reduction's all-reduce: what step_collectives implies."""
    for r in runs(world)["ranks"]:
        got = r[kind]
        assert got["step"] == got["implied"]
        assert got["step"]["ring_step"] == world - 1
        if kind == "ag_matmul":
            assert "all_gather" not in got["step"]
        else:
            assert got["step"]["all_gather"] == 1  # the reduced chunks


@pytest.mark.parametrize("world", WORLDS)
def test_ffmodel_overlap_on_a_forced_seed(runs, world):
    for r in runs(world)["ranks"]:
        serial, fused = r["ffmodel_False"], r["ffmodel_True"]
        assert serial["fused"] == [] and fused["fused"] == ["matmul_rs"]
        # the forced seed's solve prices its fused edge (overlap.py)
        ov = fused["overlap"]
        assert ov["enabled"] and ov["priced"] and ov["eligible"] == 1
        assert [e["kind"] for e in ov["edges"]] == ["matmul_rs"]
        np.testing.assert_allclose(fused["loss"], serial["loss"], rtol=1e-5)
        for name, w in serial["params"].items():
            np.testing.assert_allclose(np.asarray(fused["params"][name]), np.asarray(w),
                                       rtol=1e-5, atol=1e-6, err_msg=name)
