"""Searched multi-GPU execution as a whole: the small flagship (2 layers,
hidden 256, 4 heads of 64, seq 128, vocab 512, batch 8) trained three Adam
steps in f32 on the CPU under

- the tensor-parallel seed at 2 and 4 ranks (head-parallel attention,
  column- and row-parallel FFN and head: Replicate, Repartition, Combine
  and Reduction all lower),
- the dp2 x tp2 seed at 4 ranks (the JAX package's axis assignment puts
  the column-parallel weights' shards on the batch axis, so operands are
  resharded at their ops), and again at vocab 128, where the head is row
  parallel and the logits reach the loss as partial sums,
- the winner of the Unity search at 2 and 4 devices on the analytic
  estimators (tests/test_torch_port_search.py's constants),

and a small CNN (conv, BatchNorm, pool, dense; batch 8) under the dp2
seed, whose BatchNorm takes its statistics over the batch's ranks (fault C2
in the PCG trainer), by the JAX package's DistributedTrainingInstance on
as many virtual CPU
devices with the same mapping, and by the port's on as many gloo
processes over a `file://` store. Each plan reaches the ranks as a strategy
file the port writes (runtime/strategy.py), and the JAX parameters as
numpy arrays cut into each rank's pieces (interop.pcg_params_from_numpy).

Tolerances are those of tests/test_torch_port_dp.py: losses rtol 1e-5,
first-step gradients 1e-5 relative, parameters after three steps within
1e-3 of how far they moved, Adam's first moment within 1e-4 relative, all
compared as global values gathered from the ranks' pieces. The ranks that hold one piece hold it bitwise equal,
every step issues the collectives the plan implies, and attention runs
the per-head kernels' entry at the rank's local head count."""

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

import bench
import flexflow_tpu.compiler as J
from flexflow_tpu.compiler.unity_algorithm import (
    data_parallel_seed as j_dp_seed,
    parallel_degree_summary as j_summary,
    tensor_parallel_seed as j_tp_seed,
)
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.parallel import DistributedTrainingInstance as JaxDTI
from flexflow_tpu.parallel import MachineMesh as JaxMesh
from flexflow_tpu.parallel.executor import init_pcg_params as jax_init_pcg_params
from flexflow_tpu.pcg.machine_view import MachineSpecification as JSpec
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu.substitutions.rules import generate_parallelization_rules as j_rules
import flexflow_tpu_torch.compiler as T
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, tensor_parallel_seed
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.op_attrs.ops import WeightAttrs
from flexflow_tpu_torch.pcg.machine_view import MachineSpecification as TSpec
from flexflow_tpu_torch.runtime.strategy import save_strategy
from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules as t_rules
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(batch=8, seq=128, embed=256, heads=4, layers=2, vocab=512)
STEPS = 3
# the search of tests/test_torch_port_search.py: its analytic constants
PEAK_FLOPS, HBM_GBPS, INTER_GBPS, INTRA_GBPS = 1e11, 100.0, 25.0, 400.0
PLANS = {"tp2": 2, "searched2": 2, "cnn_dp2": 2, "tp4": 4, "dp2xtp2": 4, "searched4": 4,
         "dp2xtp2_rowhead": 4}
FLAGSHIP_PLANS = [p for p in PLANS if p != "cnn_dp2"]
# dp2xtp2_rowhead: vocab 128 < hidden 256 makes the head row-parallel, so
# the logits reach the loss as partial sums (and their Combine moves the sum
# to another axis); the loss sums them first
ROWHEAD = dict(SMALL, vocab=128)

# One rank; argv: rank, world, work dir. Trains each plan of the world in
# turn on one process group.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import (pcg_opt_state_to_numpy, pcg_params_from_numpy,
                                            pcg_params_to_numpy)
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh, executor
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
    from flexflow_tpu_torch.runtime.strategy import load_strategy

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu")
    heads = []
    flash = executor.sharded_flash_attention
    executor.sharded_flash_attention = lambda q, k, v: heads.append(q.shape[1]) or flash(q, k, v)
    for plan in json.load(open(os.path.join(work, "plans.json"))):
        pcg, mapping, _ = load_strategy(os.path.join(work, plan + ".json"))
        logits = pcg.outputs_of(pcg.topological_ordering()[-1])[0]
        mesh = MachineMesh.for_devices(world)
        inst = DistributedTrainingInstance(
            pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
            AdamOptimizerAttrs(alpha=1e-3), mesh, mapping=mapping, device="cpu")
        opt = inst.initialize(seed=0)[1]
        data = np.load(os.path.join(work, plan + ".npz"))
        params = pcg_params_from_numpy(pcg, inst.shardings, mesh,
                                       {k: data[k] for k in data.files if k.startswith("n")})
        x, y = data["x"], data["y"]
        heads.clear()
        _, grads = inst.loss_and_grads(params, {"x": x}, y)
        out = {f"grad_{k}": v for k, v in pcg_params_to_numpy(pcg, inst.shardings, mesh,
                                                              grads).items()}
        losses, per_step = [], []
        for _ in range(3):
            before = dict(inst.collectives)
            params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
            losses.append(float(loss))
            per_step.append({k: v - before.get(k, 0) for k, v in inst.collectives.items()})
        out.update({f"param_{k}": v for k, v in pcg_params_to_numpy(pcg, inst.shardings, mesh,
                                                                    params).items()})
        out.update({f"piece_{k}": v.numpy() for k, v in params.items()})
        opt_full = pcg_opt_state_to_numpy(pcg, inst.shardings, mesh, opt)
        out.update({f"adam_m_{k}": v for k, v in opt_full["m"].items()})
        placed = {k: sorted(inst.weight_sharding(k).placed()) for k in params}
        np.savez(os.path.join(work, f"{plan}_rank{rank}.npz"), losses=np.array(losses),
                 meta=json.dumps(dict(per_step=per_step, implied=dict(inst.step_collectives()),
                                      heads=heads, placed=placed,
                                      coords={a: int(c) for a, c in mesh.coords.items()})),
                 **out)
    dist.destroy_process_group()
    """
)


def _sink(pcg):
    return pcg.outputs_of(pcg.topological_ordering()[-1])[0]


def _estimators(ndev):
    ts, js = TSpec(1, 1, ndev, INTER_GBPS, INTRA_GBPS), JSpec(1, 1, ndev, INTER_GBPS, INTRA_GBPS)
    te = T.AnalyticGPUCostEstimator(ts, peak_flops=PEAK_FLOPS, hbm_gbps=HBM_GBPS,
                                    intra_latency_ms=0.001, inter_latency_ms=0.01)
    je = J.AnalyticTPUCostEstimator(js, peak_flops=PEAK_FLOPS, hbm_gbps=HBM_GBPS,
                                    ici_latency_ms=0.001, dcn_latency_ms=0.01)
    return (ts, T.MachineMappingContext(te, T.make_default_allowed_machine_views()),
            js, J.MachineMappingContext(je, J.make_default_allowed_machine_views()))


def _cnn(builder):
    """Conv (no bias: BatchNorm would cancel it), BatchNorm, max pool,
    Flat, Dense: the batch statistics taken over the data-parallel ranks."""
    b = builder()
    x = b.create_input([8, 3, 8, 8], name="x")
    h = b.batch_norm(b.conv2d(x, 4, (3, 3), (1, 1), (1, 1), use_bias=False))
    b.dense(b.flat(b.pool2d(h, (2, 2), (2, 2))), 10)
    return b.graph


def _data(name):
    rs = np.random.RandomState(0)
    if name == "cnn_dp2":  # each sample with its own mean
        x = rs.randn(8, 3, 8, 8) + np.arange(8)[:, None, None, None]
        return x.astype(np.float32), rs.randint(0, 10, 8).astype(np.int32)
    cfg = ROWHEAD if name == "dp2xtp2_rowhead" else SMALL
    x = rs.randn(cfg["batch"], cfg["seq"], cfg["embed"]).astype(np.float32)
    return x, rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"])).astype(np.int32)


def _plan(name):
    """(port PCG, port mapping, JAX PCG, JAX mapping, JAX search result)."""
    if name == "cnn_dp2":
        from flexflow_tpu.pcg.computation_graph_builder import ComputationGraphBuilder as JB
        from flexflow_tpu.pcg.parallel_computation_graph import pcg_from_computation_graph as jl
        from flexflow_tpu_torch.pcg import ComputationGraphBuilder as TB
        from flexflow_tpu_torch.pcg.parallel_computation_graph import (
            pcg_from_computation_graph as tl,
        )

        return (data_parallel_seed(tl(_cnn(TB)), 2), None, j_dp_seed(jl(_cnn(JB)), 2), None,
                None)
    tp, jp = build_flagship_pcg(**SMALL), bench.build_flagship_pcg(**SMALL)
    if name.startswith("searched"):
        n = PLANS[name]
        ts, tctx, js, jctx = _estimators(n)
        tr = T.graph_optimize(tp, tctx, ts, t_rules([2, 4]), T.OptimizerConfig(budget=2))
        jr = J.graph_optimize(jp, jctx, js, j_rules([2, 4]), J.OptimizerConfig(budget=2))
        return tr.pcg, tr.machine_mapping, jr.pcg, jr.machine_mapping, (tr, jr)
    if name == "dp2xtp2_rowhead":
        tp, jp = build_flagship_pcg(**ROWHEAD), bench.build_flagship_pcg(**ROWHEAD)
    dp, tp_deg = {"tp2": (1, 2), "tp4": (1, 4), "dp2xtp2": (2, 2), "dp2xtp2_rowhead": (2, 2)}[name]
    tp, jp = tensor_parallel_seed(tp, tp_deg), j_tp_seed(jp, tp_deg)
    if dp > 1:
        tp, jp = data_parallel_seed(tp, dp), j_dp_seed(jp, dp)
    return tp, None, jp, None, None


def _jax_run(pcg, mapping, n, init, x, y):
    mm = JaxMesh.for_devices(n, devices=jax.devices()[:n])
    inst = JaxDTI(pcg, _sink(pcg), JaxSCCE(), JaxAdam(alpha=1e-3), mm, mapping=mapping)
    placed, opt = inst.initialize(seed=0)
    params = {k: jax.device_put(jnp.asarray(init[k]), v.sharding) for k, v in placed.items()}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    with mm.mesh:
        grads = jax.jit(jax.grad(lambda p, x, y: inst.loss_fn(p, {"x": x}, y)[0]))(params, xj, yj)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
        losses.append(float(loss))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()},
                adam_m={k: np.asarray(v) for k, v in opt["m"].items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per plan: the JAX run, the port's ranks, the JAX initial parameters,
    and the plan's PCGs; each world's ranks launched once a session."""
    cache = {}

    def get(name):
        n = PLANS[name]
        if n not in cache:
            cache[n] = once_per_session(tmp_path_factory, f"tp_world{n}",
                                        lambda work: _world(work, n))
        return cache[n][name]

    return get


def _world(work, n):
    """The runs of every plan of world `n`."""
    plans = [p for p, w in PLANS.items() if w == n]
    ref = {}
    for p in plans:
        x, y = _data(p)
        tp, tmap, jp, jmap, search = _plan(p)
        init = {k: np.array(v) for k, v in
                jax_init_pcg_params(jp, jax.random.PRNGKey(0)).items()}
        save_strategy(str(work / f"{p}.json"), tp, tmap)
        np.savez(work / f"{p}.npz", x=x, y=y, **init)
        ref[p] = dict(jax=_jax_run(jp, jmap, n, init, x, y), init=init, pcg=tp,
                      search=search)
    (work / "plans.json").write_text(json.dumps(plans))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(n), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(n)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err
    for p in plans:
        ranks = []
        for r in range(n):
            z = dict(np.load(work / f"{p}_rank{r}.npz"))
            pick = lambda pre: {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}
            ranks.append(dict(losses=list(z["losses"]), grads=pick("grad_"),
                              params=pick("param_"), pieces=pick("piece_"),
                              adam_m=pick("adam_m_"),
                              **json.loads(str(z["meta"]))))
        ref[p]["ranks"] = ranks
    return ref


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("plan", PLANS)
def test_losses_match_per_step(runs, plan):
    run = runs(plan)
    for r in run["ranks"]:
        np.testing.assert_allclose(r["losses"], run["jax"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("plan", PLANS)
def test_first_step_gradients_match(runs, plan):
    run = runs(plan)
    want = run["jax"]["grads"]
    for r in run["ranks"]:
        assert r["grads"].keys() == want.keys()
        for k, g in want.items():
            assert _rel(r["grads"][k], g) < 1e-5, k


@pytest.mark.parametrize("plan", PLANS)
def test_parameters_after_three_steps_match(runs, plan):
    run = runs(plan)
    for r in run["ranks"]:
        for k, want in run["jax"]["params"].items():
            moved = np.linalg.norm(want - run["init"][k])
            assert np.linalg.norm(r["params"][k] - want) <= 1e-3 * moved, k


@pytest.mark.parametrize("plan", PLANS)
def test_adam_state_gathered_from_the_pieces_matches(runs, plan):
    """interop.pcg_opt_state_to_numpy: Adam's first moment after three
    steps, gathered from the ranks' pieces, against the JAX trainer's."""
    run = runs(plan)
    for r in run["ranks"]:
        assert r["adam_m"].keys() == run["jax"]["adam_m"].keys()
        for k, want in run["jax"]["adam_m"].items():
            assert _rel(r["adam_m"][k], want) < 1e-4, k


@pytest.mark.parametrize("plan", PLANS)
def test_ranks_holding_one_piece_hold_it_bitwise_equal(runs, plan):
    ranks = runs(plan)["ranks"]
    pairs = 0
    for i, a in enumerate(ranks):
        for b in ranks[i + 1:]:
            assert a["losses"] == b["losses"]
            for k, piece in a["pieces"].items():
                if all(a["coords"][ax] == b["coords"][ax] for ax in a["placed"][k]):
                    assert np.array_equal(piece, b["pieces"][k]), k
                    pairs += 1
    assert pairs > 0


@pytest.mark.parametrize("plan", PLANS)
def test_each_step_issues_the_collectives_the_plan_implies(runs, plan):
    run = runs(plan)
    for r in run["ranks"]:
        assert all(step == r["implied"] for step in r["per_step"]), (r["per_step"], r["implied"])
    # tensor parallelism sums partials: the plan's Reductions are all-reduces
    pcg = run["pcg"]
    reductions = sum(type(pcg.op_attrs(n)).__name__ == "ReductionAttrs" for n in pcg.nodes)
    assert run["ranks"][0]["implied"].get("all_reduce", 0) >= reductions


@pytest.mark.parametrize("plan", FLAGSHIP_PLANS)
def test_attention_runs_the_per_head_entry_at_the_local_head_count(runs, plan):
    run = runs(plan)
    pcg = run["pcg"]
    local = {pcg.tensor_shape(pcg.inputs_of(n)[3]).sizes()[1]
             // pcg.tensor_shape(pcg.inputs_of(n)[3]).shard_degrees()[1]
             for n in pcg.topological_ordering()
             if type(pcg.op_attrs(n)).__name__ == "MultiHeadAttentionAttrs"}
    want = {"tp2": 2, "tp4": 1, "dp2xtp2": 2, "dp2xtp2_rowhead": 2}.get(plan, SMALL["heads"])
    assert local == {want}
    for r in run["ranks"]:  # each layer, in the gradient call and each step
        assert r["heads"] == [want] * SMALL["layers"] * (1 + STEPS)


@pytest.mark.parametrize("n", [2, 4])
def test_searched_winner_is_the_jax_packages(runs, n):
    tr, jr = runs(f"searched{n}")["search"]
    assert T.parallel_degree_summary(tr.pcg) == j_summary(jr.pcg)
    assert T.parallel_degree_summary(tr.pcg)  # a parallel plan, not the serial one
    assert np.isclose(tr.runtime, jr.runtime, rtol=1e-9)
    weights = [n_ for n_ in tr.pcg.topological_ordering()
               if isinstance(tr.pcg.op_attrs(n_), WeightAttrs)]
    assert {f"n{w.idx}" for w in weights} == set(runs(f"searched{n}")["init"])


@pytest.mark.parametrize("plan", ["tp2", "dp2xtp2"])
def test_mfu_count_is_the_jax_piece_sum(plan):
    """The multi-device MFU's numerator: kernels.ops.graph_step_flops of the
    plan (3 x op_forward_flops over its compute ops at global shapes, the
    model's own work) equals 3 x the JAX op_forward_flops summed over every
    distinct piece of the JAX plan (each op's piece shapes, weight pieces
    and sequence degree as the JAX cost estimator passes them, times its
    output's shard and sum degrees), and the unparallelized graph's count."""
    import math

    from flexflow_tpu.kernels.ops import op_forward_flops as j_flops
    from flexflow_tpu.local_execution.training_backing import split_slot_values
    from flexflow_tpu.op_attrs.core import get_output_shapes, is_parallel_op
    from flexflow_tpu.op_attrs.ops import InputAttrs as JInput
    from flexflow_tpu.op_attrs.ops import WeightAttrs as JWeight
    from flexflow_tpu.op_attrs.parallel_tensor_shape import get_piece_shape
    from flexflow_tpu_torch.kernels.ops import graph_step_flops
    from flexflow_tpu_torch.models import build_flagship_cg

    tp, _, jp, _, _ = _plan(plan)
    pieces = 0
    for n in jp.topological_ordering():
        attrs = jp.op_attrs(n)
        if isinstance(attrs, (JInput, JWeight)) or is_parallel_op(attrs):
            continue
        ins = [jp.tensor_shape(t) for t in jp.inputs_of(n)]
        data, weights = split_slot_values(attrs, [get_piece_shape(s) for s in ins])
        sp = ins[0].shard_dim_at(1).degree if ins[0].num_dims >= 3 else 1
        flops = j_flops(attrs, data, get_output_shapes(attrs, data), weight_shapes=weights or None,
                        seq_parallel_degree=sp)
        out = jp.tensor_shape(jp.outputs_of(n)[0])
        pieces += flops * math.prod(out.shard_degrees()) * out.sum_degree
    assert graph_step_flops(tp) == 3 * pieces == graph_step_flops(build_flagship_cg(**SMALL)[0])
