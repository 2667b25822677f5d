"""Mixture of experts on the port (kernels/moe.py, the MoE ops of the
builders and of FFModel, and the Experts op over ranks) against the JAX
package on the same numpy inputs and parameters, f32 on the CPU:

- the dispatch order and drops, the GroupBy/Aggregate round trip with a
  token sending two decisions to one expert, the fused Experts op's
  output, aux loss and gradients (1e-5 relative) against the JAX op, and
  the port's index path against its dense plain version (the JAX
  package's einsums);
- FFModel.moe fit on one device against the JAX FFModel's fit;
- over gloo ranks, with the load-balance weight at 0.5 (where an aux loss
  counted twice, or only a block's, is far outside the tolerance):
  a data-parallel FFModel fit of an MoE model on 2 ranks against the JAX
  FFModel on 2 virtual devices (the global batch's routing: capacity,
  positions and the aux loss); the dp2 x ep2 PCG of
  tests/test_moe.py::test_expert_parallel_training_on_mesh on 4 ranks
  against the JAX DistributedTrainingInstance on 4 virtual devices; and
  the searched compile of tests/test_moe.py::
  test_searched_moe_finds_expert_parallelism on 2 ranks, whose winner
  shards the experts and trains as the JAX FFModel's winner does.

Tolerances: losses and metric sums rtol 1e-5, parameters within 1e-5
relative (SGD); at the capacity factor 1.0 tokens are dropped, so the
routing of the whole batch matters."""

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

from flexflow_tpu.core import FFConfig as JFFConfig
from flexflow_tpu.core import FFModel as JFFModel
from flexflow_tpu.core import SGDOptimizer as JSGD
from flexflow_tpu.kernels import moe as jmoe
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu.op_attrs.activation import Activation as JAct
from flexflow_tpu_torch.kernels import moe as tmoe
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.op_attrs.activation import Activation as TAct
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
LAMBDA = 0.5


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(np.asarray(b)), 1e-30)


# --- the ops -------------------------------------------------------------------


def test_dispatch_mask_matches_the_jax_order_and_drops():
    rs = np.random.RandomState(0)
    assign = rs.randint(0, 4, 40).astype(np.int32)
    ref = np.asarray(jmoe.dispatch_mask(jnp.asarray(assign), 4, 6))
    got = tmoe.dispatch_mask(torch.from_numpy(assign), 4, 6).numpy()
    np.testing.assert_array_equal(got, ref)
    assert 0 < ref.sum() < len(assign)  # some decisions are dropped
    # the index path's slots are the mask's ones
    pos, counts = tmoe.positions(torch.from_numpy(assign), 4)
    slots = tmoe._slots(torch.from_numpy(assign).long(), pos, 6, 0, 4).numpy()
    n, e, c = np.nonzero(ref)
    kept = slots < 4 * 6
    np.testing.assert_array_equal(np.nonzero(kept)[0], n)
    np.testing.assert_array_equal(slots[kept], e * 6 + c)
    np.testing.assert_array_equal(counts.numpy(), np.bincount(assign, minlength=4))


@pytest.mark.parametrize("alpha", [4.0, 0.75])  # no drops; drops
def test_group_by_aggregate_roundtrip_with_duplicates(alpha):
    """randint assignments send some tokens' two decisions to one expert:
    each takes its own slot. Values and gradients match the JAX ops."""
    rs = np.random.RandomState(1)
    B, D, E, k = 12, 5, 4, 2
    data = rs.randn(B, D).astype(np.float32)
    assign = rs.randint(0, E, (B, k)).astype(np.int32)
    assert any(a == b for a, b in assign)
    gates = rs.rand(B, k).astype(np.float32)
    jgb, tgb = jattrs.GroupByAttrs(E, alpha), tattrs.GroupByAttrs(E, alpha)
    jag, tag = jattrs.AggregateAttrs(E), tattrs.AggregateAttrs(E)

    def jfn(d, g):
        groups = jmoe.group_by_forward(jgb, d, jnp.asarray(assign))
        return jmoe.aggregate_forward(jag, g, jnp.asarray(assign), groups), groups

    (jout, jgroups), jvjp = jax.vjp(jfn, jnp.asarray(data), jnp.asarray(gates))
    td = torch.from_numpy(data).requires_grad_(True)
    tg = torch.from_numpy(gates).requires_grad_(True)
    tgroups = tmoe.group_by_forward(tgb, td, torch.from_numpy(assign))
    tout = tmoe.aggregate_forward(tag, tg, torch.from_numpy(assign), tgroups)
    for a, b in zip(tgroups, jgroups):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
    if alpha == 4.0:  # unit gates return k times the data
        ones = torch.ones(B, k)
        np.testing.assert_allclose(
            tmoe.aggregate_forward(tag, ones, torch.from_numpy(assign), tgroups).detach().numpy(),
            k * data, rtol=1e-6)
    cot = rs.randn(B, D).astype(np.float32)
    cot_groups = [rs.randn(*g.shape).astype(np.float32) for g in jgroups]
    jgd, jgg = jvjp((jnp.asarray(cot), [jnp.asarray(c) for c in cot_groups]))
    loss = (tout * torch.from_numpy(cot)).sum() + sum(
        (g * torch.from_numpy(c)).sum() for g, c in zip(tgroups, cot_groups))
    gd, gg = torch.autograd.grad(loss, [td, tg])
    np.testing.assert_allclose(gd.numpy(), np.asarray(jgd), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(gg.numpy(), np.asarray(jgg), rtol=1e-5, atol=1e-6)
    # the port's dense plain versions give the same
    dense = tmoe.group_by_forward_dense(tgb, td.detach(), torch.from_numpy(assign))
    for a, b in zip(dense, tgroups):
        np.testing.assert_array_equal(a.numpy(), b.detach().numpy())


EXPERTS_CASES = {
    # (lead dims, D, E, k, H, alpha, lambda, use_bias, out, activation)
    "drops_aux": ((3, 8), 16, 4, 2, 24, 1.0, LAMBDA, True, None, "RELU"),
    "nobias_gelu_out": ((20,), 16, 4, 2, 12, 1.5, 0.04, False, 10, "GELU"),
    "no_aux_no_act": ((2, 6), 8, 8, 2, 16, 4.0, 0.0, True, None, None),
}


def _experts(case, seed=0):
    lead, d, e, k, h, alpha, lam, bias, out, act = EXPERTS_CASES[case]
    kw = dict(num_experts=e, num_select=k, hidden_size=h, out_channels=out,
              capacity_factor=alpha, use_bias=bias, lambda_bal=lam)
    ja = jattrs.ExpertsAttrs(activation=act and JAct[act], **kw)
    ta = tattrs.ExpertsAttrs(activation=act and TAct[act], **kw)
    rs = np.random.RandomState(seed)
    x = rs.randn(*lead, d).astype(np.float32)
    o = out or d
    shapes = [(d, e), (e, d, h)] + ([(e, h)] if bias else []) + [(e, h, o)] + (
        [(e, o)] if bias else [])
    ws = [(rs.randn(*s) * (0.5 if i == 0 else 0.2)).astype(np.float32)
          for i, s in enumerate(shapes)]
    return ja, ta, x, ws


@pytest.mark.parametrize("case", sorted(EXPERTS_CASES))
def test_experts_matches_the_jax_op(case):
    ja, ta, x, ws = _experts(case)

    def jfn(x_, *ws_):
        return jmoe.experts_forward(ja, x_, list(ws_))

    jouts, jvjp = jax.vjp(jfn, jnp.asarray(x), *[jnp.asarray(w) for w in ws])
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + ws]
    touts = tmoe.experts_forward(ta, leaves[0], leaves[1:])
    assert len(touts) == len(jouts)
    for a, b in zip(touts, jouts):
        assert _rel(a.detach().numpy(), b) < 1e-5
    rs = np.random.RandomState(3)
    cots = [rs.randn(*np.shape(j)).astype(np.float32) for j in jouts]
    jg = jvjp([jnp.asarray(c) for c in cots])
    tg = torch.autograd.grad(sum((t * torch.from_numpy(c)).sum() for t, c in zip(touts, cots)),
                             leaves)
    for a, b in zip(tg, jg):
        assert _rel(a.numpy(), b) < 1e-5, _rel(a.numpy(), b)
    assert np.abs(np.asarray(jg[1])).sum() > 0  # the gate takes a gradient


@pytest.mark.parametrize("case", sorted(EXPERTS_CASES))
def test_the_index_path_matches_the_dense_plain_version(case):
    _, ta, x, ws = _experts(case, seed=4)
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in [x] + ws]
    decisions = {}
    idx = tmoe.experts_forward(ta, leaves[0], leaves[1:], decisions=decisions)
    dense = tmoe.experts_forward_dense(ta, leaves[0], leaves[1:])
    for a, b in zip(idx, dense):
        assert _rel(a.detach().numpy(), b.detach().numpy()) < 1e-6
    gi = torch.autograd.grad(sum(o.sum() for o in idx), leaves)
    gd = torch.autograd.grad(sum(o.sum() for o in dense), leaves)
    for a, b in zip(gi, gd):
        assert _rel(a.numpy(), b.numpy()) < 1e-5
    # the routing's slots are the dense dispatch mask's ones
    cap = decisions["capacity"]
    mask = tmoe.dispatch_mask(decisions["topi"].reshape(-1), ta.num_experts, cap).numpy()
    pos = decisions["pos"].numpy()
    kept = pos < cap
    assert int(mask.sum()) == int(kept.sum())
    a = decisions["topi"].reshape(-1).numpy()
    assert mask[np.nonzero(kept)[0], a[kept], pos[kept]].all()


def test_expert_parallel_pieces_add_up_to_the_whole_op():
    """Each of 2 expert ranks runs its half of the experts: the partial
    outputs sum to the op's output, and each rank's aux is the whole's."""
    _, ta, x, ws = _experts("drops_aux", seed=5)
    t = [torch.from_numpy(a) for a in [x] + ws]
    whole = tmoe.experts_forward(ta, t[0], t[1:])
    half = ta.num_experts // 2
    parts = [tmoe.experts_forward(ta, t[0], [t[1]] + [w[i * half:(i + 1) * half] for w in t[2:]],
                                  first_expert=i * half) for i in range(2)]
    assert _rel((parts[0][0] + parts[1][0]).numpy(), whole[0].numpy()) < 1e-6
    for p in parts:
        np.testing.assert_array_equal(p[1].numpy(), whole[1].numpy())


def test_capacity_formula():
    assert tattrs.expert_capacity(64, 4, 2, 1.0) == 32
    assert tattrs.expert_capacity(64, 4, 2, 2.0) == 64
    assert tattrs.expert_capacity(1, 64, 1, 1.0) == 1
    for args in [(8192, 8, 2, 2.0), (100, 3, 2, 1.3), (7, 4, 1, 0.5)]:
        assert tattrs.expert_capacity(*args) == jattrs.expert_capacity(*args)


def test_the_shapes_and_roles_match_the_jax_package():
    from flexflow_tpu.op_attrs import core as jcore
    from flexflow_tpu.op_attrs.datatype import DataType as JDT
    from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JTS
    from flexflow_tpu_torch.op_attrs import core as tcore
    from flexflow_tpu_torch.op_attrs.datatype import DataType as TDT
    from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape as TTS

    cases = [
        (jattrs.GroupByAttrs(4, 1.5), tattrs.GroupByAttrs(4, 1.5), [((10, 6), "FLOAT"), ((10, 2), "INT32")]),
        (jattrs.AggregateAttrs(3), tattrs.AggregateAttrs(3),
         [((10, 2), "FLOAT"), ((10, 2), "INT32")] + [((7, 6), "FLOAT")] * 3),
        (jattrs.ExpertsAttrs(4, 2, 16, lambda_bal=0.1), tattrs.ExpertsAttrs(4, 2, 16, lambda_bal=0.1),
         [((6, 8), "FLOAT")]),
        (jattrs.TopKAttrs(3), tattrs.TopKAttrs(3), [((5, 9), "FLOAT")]),
    ]
    for ja, ta, ins in cases:
        jin = [JTS(d, getattr(JDT, t)) for d, t in ins]
        tin = [TTS(d, getattr(TDT, t)) for d, t in ins]
        assert [(s.dims, s.dtype.value) for s in jcore.get_output_shapes(ja, jin)] == \
            [(s.dims, s.dtype.value) for s in tcore.get_output_shapes(ta, tin)]
        assert [s.dims for s in jcore.get_weight_shapes(ja, jin)] == \
            [s.dims for s in tcore.get_weight_shapes(ta, tin)]
        assert jcore.num_outputs(ja) == tcore.num_outputs(ta)
        assert [r.value for r in jcore.get_incoming_tensor_roles(ja)] == \
            [r.value for r in tcore.get_incoming_tensor_roles(ta)]
        assert jcore.op_type_of(ja).value == tcore.op_type_of(ta).value


# --- FFModel on one device ---------------------------------------------------------

# the models of the FFModel runs, built by either package's FFModel; `pkg`
# has FFModel, FFConfig and SGDOptimizer
BUILD = textwrap.dedent(
    """
    def _build(pkg, cfg, kind, device=None):
        m = pkg.FFModel(pkg.FFConfig(**cfg), **({} if device is None else dict(device=device)))
        if kind == "searched":  # tests/test_moe.py::test_searched_moe_finds_expert_parallelism
            x = m.create_tensor([cfg["batch_size"], 128], name="x")
            t = m.moe(x, num_exp=8, num_select=2, hidden_size=256, alpha=4.0, lambda_bal=0.5)
            m.dense(t, 8, use_bias=False, name="out")
        else:  # a dense layer, the MoE layer (drops at alpha 1) and a head
            x = m.create_tensor([cfg["batch_size"], 4, 32], name="x")
            t = m.dense(x, 32, name="inp")
            t = m.moe(t, num_exp=4, num_select=2, hidden_size=32, alpha=1.0, lambda_bal=0.5,
                      name="moe")
            m.dense(t, 8, name="out")
        m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
        return m
    """
)
exec(BUILD)

CASES = {
    "one": dict(cfg=dict(batch_size=16, print_freq=0, max_devices=1), kind="encoder",
                samples=32, epochs=2),
    "dp": dict(cfg=dict(batch_size=16, print_freq=0, max_devices=2, only_data_parallel=True),
               kind="encoder", samples=32, epochs=2),
    "searched": dict(cfg=dict(batch_size=64, print_freq=0, max_devices=2, search_budget=4),
                     kind="searched", samples=64, epochs=1),
}


class _JaxPkg:
    FFModel, FFConfig, SGDOptimizer = JFFModel, JFFConfig, JSGD


def _samples(case):
    rs = np.random.RandomState(0)
    n = case["samples"]
    if case["kind"] == "searched":
        return rs.randn(n, 128).astype(np.float32), rs.randint(0, 8, n).astype(np.int32)
    return rs.randn(n, 4, 32).astype(np.float32), rs.randint(0, 8, (n, 4)).astype(np.int32)


def _jax_case(case):
    m = _build(_JaxPkg, case["cfg"], case["kind"])
    init = {k: np.array(v) for k, v in m.params.items()}
    xs, ys = _samples(case)
    perf = m.fit(x=xs, y=ys, epochs=case["epochs"], shuffle=False, verbose=False)
    final = {k: np.asarray(v) for k, v in m.params.items()}
    return dict(init=init, perf=vars(perf), final=final, kind=type(m.instance).__name__,
                prov=m.search_provenance, aux=len(getattr(m.instance, "aux_loss_tensors", ())))


def test_ffmodel_moe_fit_matches_the_jax_fit():
    from flexflow_tpu_torch import core as tcore
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy

    case = CASES["one"]
    ref = _jax_case(case)
    m = _build(tcore, case["cfg"], case["kind"], device="cpu")
    assert len(m._aux_loss_tensors) == 1
    ffmodel_state_from_numpy(m, ref["init"])
    xs, ys = _samples(case)
    perf = m.fit(x=xs, y=ys, epochs=case["epochs"], shuffle=False, verbose=False)
    _check_perf(vars(perf), ref["perf"])
    for k, v in ref["final"].items():
        assert _rel(m.params[k].detach().numpy(), v) < 1e-5, k


def _check_perf(got, want):
    for key in ("train_all", "train_correct"):
        assert got[key] == want[key], key
    np.testing.assert_allclose(got["sparse_cce_loss"], want["sparse_cce_loss"], rtol=1e-5)


# --- over ranks ----------------------------------------------------------------------

# One rank of the 2-rank job; argv: rank, work dir.
WORKER2 = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch import core
    from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, pcg_params_to_numpy
    from flexflow_tpu_torch.parallel import init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "build.py")).read())
    out = {}
    for name, case in json.load(open(os.path.join(work, "cases.json"))).items():
        data = np.load(os.path.join(work, f"{name}.npz"))
        m = _build(core, case["cfg"], case["kind"], device="cpu")
        ffmodel_state_from_numpy(m, {k: data[k] for k in data.files if k.startswith("n")})
        inst = m.instance
        perf = m.fit(x=data["xs"], y=data["ys"], epochs=case["epochs"], shuffle=False,
                     verbose=False)
        counts = getattr(inst, "machine_mesh", None)
        counts = dict(counts.counts) if counts is not None else dict(inst.collectives)
        if hasattr(inst, "shardings"):
            final = pcg_params_to_numpy(inst.pcg, inst.shardings, inst.machine_mesh, m.params)
            pcg = inst.pcg
            ep = []
            from flexflow_tpu_torch.op_attrs.ops import ExpertsAttrs, RepartitionAttrs
            for n in pcg.topological_ordering():
                if isinstance(pcg.op_attrs(n), ExpertsAttrs):
                    for v in pcg.inputs_of(n):
                        at = pcg.op_attrs(v.node)
                        if isinstance(at, RepartitionAttrs) and at.repartition_dim == 0:
                            ep.append(at.repartition_degree)
        else:
            final = {k: v.detach().numpy() for k, v in m.params.items()}
            ep = []
        steps = case["epochs"] * case["samples"] // case["cfg"]["batch_size"]
        out[name] = dict(perf=vars(perf), kind=type(inst).__name__, prov=m.search_provenance,
                         aux=len(inst.aux_loss_tensors), ep=ep, counts=counts,
                         per_step={k: int(v) for k, v in inst.step_collectives().items()},
                         steps=steps)
        np.savez(os.path.join(work, f"{name}_final_rank{rank}.npz"), **final)
    json.dump(out, open(os.path.join(work, f"rank{rank}.json"), "w"), default=float)
    dist.destroy_process_group()
    """
)

# One rank of the 4-rank dp2 x ep2 job; argv: rank, work dir.
WORKER4 = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import pcg_params_from_numpy, pcg_params_to_numpy
    from flexflow_tpu_torch.kernels import make_optimizer_state
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh, init_file_group
    from flexflow_tpu_torch.pcg import SGDOptimizerAttrs
    from flexflow_tpu_torch import pcg as P

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 4, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "build_pcg.py")).read())
    pcg, logits, aux = _build_pcg(P)
    mesh = MachineMesh.for_devices(4)
    inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       SGDOptimizerAttrs(lr=0.05), mesh, device="cpu",
                                       aux_loss_tensors=[aux])
    data = np.load(os.path.join(work, "ep.npz"))
    params = pcg_params_from_numpy(pcg, inst.shardings, mesh,
                                   {k: data[k] for k in data.files if k.startswith("n")}, "cpu")
    opt = make_optimizer_state(inst.optimizer_attrs, params)
    losses, per_step = [], []
    for _ in range(3):
        before = dict(mesh.counts)
        params, opt, loss, _ = inst.train_step(params, opt, {"x": data["x"]}, data["y"])
        losses.append(float(loss))
        per_step.append({k: v - before.get(k, 0) for k, v in mesh.counts.items()})
    final = pcg_params_to_numpy(pcg, inst.shardings, mesh, params)
    np.savez(os.path.join(work, f"ep_final_rank{rank}.npz"), **final)
    json.dump(dict(losses=losses, per_step=per_step,
                   predicted={k: int(v) for k, v in inst.step_collectives().items()}),
              open(os.path.join(work, f"ep_rank{rank}.json"), "w"))
    dist.destroy_process_group()
    """
)

# the dp2 x ep2 PCG of tests/test_moe.py::test_expert_parallel_training_on_mesh,
# with the load-balance loss and drops; `P` is either package's pcg module
BUILD_PCG = textwrap.dedent(
    """
    def _build_pcg(P):
        from importlib import import_module
        root = P.__name__.rsplit(".", 1)[0]
        shape = import_module(root + ".op_attrs.parallel_tensor_shape")
        ts = import_module(root + ".op_attrs.tensor_shape")
        dt = import_module(root + ".op_attrs.datatype")
        B, D, E, k, H, V = 8, 16, 4, 2, 32, 8
        b = import_module(root + ".pcg.parallel_computation_graph_builder").ParallelComputationGraphBuilder()
        x = b.create_input_tensor(shape.lift_to_parallel_with_degrees(
            ts.TensorShape((B, D), dt.DataType.FLOAT), 1, 1, (2, 1)), name="x")
        h = b.parallel_replicate(x, 2)
        h, aux = b.experts(h, E, k, H, capacity_factor=1.0, lambda_bal=0.5)
        h = b.parallel_reduce(h, 2)
        logits = b.dense(h, V, name="head")
        return b.graph, logits, aux
    """
)
exec(BUILD_PCG)


def _launch(script, ranks, work):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(ranks)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]


def _two_ranks(work):
    jax_runs = {}
    for name in ("dp", "searched"):
        case = CASES[name]
        jax_runs[name] = _jax_case(case)
        xs, ys = _samples(case)
        np.savez(work / f"{name}.npz", xs=xs, ys=ys, **jax_runs[name]["init"])
    (work / "build.py").write_text(BUILD)
    (work / "cases.json").write_text(json.dumps({k: CASES[k] for k in ("dp", "searched")}))
    _launch(WORKER2, 2, work)
    ranks = [json.load(open(work / f"rank{r}.json")) for r in range(2)]
    finals = [{n: dict(np.load(work / f"{n}_final_rank{r}.npz")) for n in ("dp", "searched")}
              for r in range(2)]
    return dict(jax=jax_runs, ranks=ranks, finals=finals)


def _jax_ep_run():
    from flexflow_tpu import pcg as JP
    from flexflow_tpu.op_attrs.ops.loss_functions import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu.parallel import DistributedTrainingInstance, MachineMesh
    from flexflow_tpu.pcg.optimizer import SGDOptimizerAttrs

    pcg, logits, aux = _build_pcg(JP)
    mm = MachineMesh.for_devices(4, devices=jax.devices()[:4])
    inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       SGDOptimizerAttrs(lr=0.05), mm, aux_loss_tensors=[aux])
    params, opt = inst.initialize(seed=0)
    init = {k: np.array(v) for k, v in params.items()}
    rs = np.random.RandomState(0)
    x = rs.randn(8, 16).astype(np.float32)
    y = rs.randint(0, 8, 8).astype(np.int32)
    losses = []
    for _ in range(3):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": jnp.asarray(x)}, jnp.asarray(y))
        losses.append(float(loss))
    return dict(init=init, x=x, y=y, losses=losses,
                final={k: np.asarray(v) for k, v in params.items()})


def _four_ranks(work):
    ref = _jax_ep_run()
    np.savez(work / "ep.npz", x=ref["x"], y=ref["y"], **ref["init"])
    (work / "build_pcg.py").write_text(BUILD_PCG)
    _launch(WORKER4, 4, work)
    ranks = [json.load(open(work / f"ep_rank{r}.json")) for r in range(4)]
    finals = [dict(np.load(work / f"ep_final_rank{r}.npz")) for r in range(4)]
    return dict(jax=ref, ranks=ranks, finals=finals)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return once_per_session(tmp_path_factory, "moe_two_ranks", _two_ranks)


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    return once_per_session(tmp_path_factory, "moe_four_ranks", _four_ranks)


def test_data_parallel_fit_routes_the_global_batch_as_the_jax_ffmodel(two):
    ref = two["jax"]["dp"]
    assert ref["kind"] == "DataParallelTrainingInstance"
    for r, run in enumerate(two["ranks"]):
        got = run["dp"]
        assert got["kind"] == "DataParallelTrainingInstance" and got["aux"] == 1
        _check_perf(got["perf"], ref["perf"])
        for k, v in ref["final"].items():
            assert _rel(two["finals"][r]["dp"][k], v) < 1e-5, k
        # a step: one all-gather of the decision counts, the aux loss's sums
        # forward and backward, the buckets and the loss's bucket
        assert got["counts"]["all_gather"] == got["steps"] * got["per_step"]["all_gather"] == \
            got["steps"]
        assert got["counts"]["all_reduce"] == got["steps"] * got["per_step"]["all_reduce"]


def test_the_searched_compile_finds_expert_parallelism(two):
    ref = two["jax"]["searched"]
    for r, run in enumerate(two["ranks"]):
        got = run["searched"]
        assert got["kind"] == "DistributedTrainingInstance", "the aux graph must be searched"
        assert got["aux"] == 1, "the searched instance lost the load-balance loss"
        assert got["ep"] and max(got["ep"]) > 1, got["prov"]
        assert got["prov"]["estimated_ms"] < got["prov"]["serial_ms"]
        assert got["perf"]["train_all"] == CASES["searched"]["samples"]
        assert got["prov"]["parallel_degrees"] == ref["prov"]["parallel_degrees"]
        _check_perf(got["perf"], ref["perf"])
        for k, v in ref["final"].items():
            assert _rel(two["finals"][r]["searched"][k], v) < 1e-5, k


def test_expert_parallel_training_on_ranks_matches_the_jax_mesh(four):
    ref = four["jax"]
    for r, run in enumerate(four["ranks"]):
        np.testing.assert_allclose(run["losses"], ref["losses"], rtol=1e-5)
        for k, v in ref["final"].items():
            assert _rel(four["finals"][r][k], v) < 1e-5, k
        for step in run["per_step"]:
            assert {k: v for k, v in step.items() if v} == run["predicted"]
