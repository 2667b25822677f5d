"""Gradient buckets overlapped with the backward (parallel/collectives.py
`bucket_plan` and `BucketedBackward`): the data-parallel trainer on an MLP,
and the tp2 and dp2 plans of a small flagship (1 layer, hidden 128, 2 heads
of 64, seq 64, vocab 256, batch 8) through the PCG trainer, each on 2 gloo
processes with the bucket cap set to 64 KiB (so a plan that sums weight
gradients has several buckets; the tp2 plan sums none, its weights' work
being the same on both ranks, and has no bucket), against the JAX
package's DataParallelTrainingInstance and DistributedTrainingInstance on
2 virtual CPU devices from the same numpy parameters:

- losses of three Adam steps within rtol 1e-5, first-step gradients within
  1e-5 relative, parameters after the steps within 1e-3 of how far they
  moved (tests/test_torch_port_dp.py's tolerances);
- the gradients of the bucketed backward bitwise equal to one bucket's
  (the cap above every gradient);
- every step issues one all-reduce per bucket of the plan, which the
  parameter sizes and the cap give, plus the loss's;
- each step issues at least one bucket before the backward has produced
  its last gradient."""

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
from flexflow_tpu.compiler.unity_algorithm import data_parallel_seed as j_dp_seed
from flexflow_tpu.compiler.unity_algorithm import tensor_parallel_seed as j_tp_seed
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.parallel import DistributedTrainingInstance as JaxDTI
from flexflow_tpu.parallel import MachineMesh as JaxMesh
from flexflow_tpu.parallel.data_parallel import DataParallelTrainingInstance as JaxDP
from flexflow_tpu.parallel.executor import init_pcg_params as jax_init_pcg_params
from flexflow_tpu.pcg.computation_graph_builder import ComputationGraphBuilder as JaxBuilder
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed, tensor_parallel_seed
from flexflow_tpu_torch.models import build_flagship_pcg
from flexflow_tpu_torch.runtime.strategy import save_strategy
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
RANKS = 2
STEPS = 3
CAP = 64 * 1024
FLAGSHIP = dict(batch=8, seq=64, embed=128, heads=2, layers=1, vocab=256)


def mlp(builder_cls):
    """32 -> 256 -> 256 relu -> 16 on a batch of 8: its f32 gradients
    (344 KiB) make six buckets under CAP."""
    b = builder_cls()
    x = b.create_input([8, 32], name="x")
    h = b.dense(b.dense(x, 256, activation=None, name="fc1"), 256, name="fc2")
    return b.graph, b.dense(b.relu(h), 16, name="out")


WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import (params_from_numpy, params_to_numpy,
                                            pcg_params_from_numpy, pcg_params_to_numpy)
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import (DataParallelTrainingInstance,
                                             DistributedTrainingInstance, MachineMesh,
                                             init_file_group)
    from flexflow_tpu_torch.parallel import collectives as C
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
    from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder
    from flexflow_tpu_torch.runtime.strategy import load_strategy

    torch.set_num_threads(1)
    rank, work, cap = int(sys.argv[1]), sys.argv[2], int(sys.argv[3])
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    exec(open(os.path.join(work, "mlp.py")).read())
    loss_attrs, adam = SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-3)
    out = {}
    for mode in ("dp", "tp2", "pcg_dp2"):
        data = np.load(os.path.join(work, mode + ".npz"))
        init = {k: data[k] for k in data.files if k.startswith("n")}
        x, y = data["x"], data["y"]

        def build(bucket_cap):
            C.BUCKET_CAP_BYTES = bucket_cap
            if mode == "dp":
                graph, logits = mlp(ComputationGraphBuilder)
                inst = DataParallelTrainingInstance(graph, logits, loss_attrs, adam, device="cpu")
                to_np = params_to_numpy
                params = params_from_numpy(graph, init, "cpu")
            else:
                pcg, mapping, _ = load_strategy(os.path.join(work, mode + ".json"))
                mesh = MachineMesh.for_devices(2)
                inst = DistributedTrainingInstance(
                    pcg, pcg.outputs_of(pcg.topological_ordering()[-1])[0], loss_attrs, adam,
                    mesh, mapping=mapping, device="cpu")
                params = pcg_params_from_numpy(pcg, inst.shardings, mesh, init)
                to_np = lambda p: pcg_params_to_numpy(pcg, inst.shardings, mesh, p)
            return inst, params, to_np

        whole, params, _ = build(1 << 40)
        _, one_bucket = whole.loss_and_grads(params, {"x": x}, y)
        inst, params, to_np = build(cap)
        opt = inst.initialize(seed=0)[1]
        _, grads = inst.loss_and_grads(params, {"x": x}, y)
        same = all(torch.equal(grads[k], one_bucket[k]) for k in grads)
        res = {f"grad_{k}": v for k, v in to_np(grads).items()}
        losses, per_step = [], []
        for _ in range(3):
            before = dict(inst.collectives)
            params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
            losses.append(float(loss))
            per_step.append({k: v - before.get(k, 0) for k, v in inst.collectives.items()
                             if v - before.get(k, 0)})
        res.update({f"param_{k}": v for k, v in to_np(params).items()})
        plan = inst.buckets if mode == "dp" else [keys for _, keys in inst.plan.buckets]
        meta = dict(losses=losses, per_step=per_step, implied=dict(inst.step_collectives()),
                    bucket_log=inst.bucket_log, same_as_one_bucket=same,
                    plan=[list(b) for b in plan],
                    piece_numel={k: int(v.numel()) for k, v in params.items()})
        if mode != "dp":
            meta["axes"] = [list(a) for a, _ in inst.plan.buckets]
            meta["mesh_axes"] = {a: s for a, s in inst.machine_mesh.sizes.items()}
        np.savez(os.path.join(work, f"{mode}_rank{rank}.npz"), meta=json.dumps(meta), **res)
    dist.destroy_process_group()
    """
)


def _jax_dp(init, x, y):
    graph, logits = mlp(JaxBuilder)
    inst = JaxDP(graph, logits, JaxSCCE(), JaxAdam(alpha=1e-3), devices=jax.devices()[:RANKS])
    params, opt = inst.initialize(seed=0)
    params = {k: jnp.asarray(init[k]) for k in params}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    grads = jax.grad(lambda p: inst.loss_fn(p, {"x": xj}, yj)[0])(params)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
        losses.append(float(loss))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()})


def _jax_pcg(pcg, init, x, y):
    mm = JaxMesh.for_devices(RANKS, devices=jax.devices()[:RANKS])
    sink = pcg.outputs_of(pcg.topological_ordering()[-1])[0]
    inst = JaxDTI(pcg, sink, JaxSCCE(), JaxAdam(alpha=1e-3), mm)
    placed, opt = inst.initialize(seed=0)
    params = {k: jax.device_put(jnp.asarray(init[k]), v.sharding) for k, v in placed.items()}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    with mm.mesh:
        grads = jax.jit(jax.grad(lambda p: inst.loss_fn(p, {"x": xj}, yj)[0]))(params)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
        losses.append(float(loss))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "buckets", _runs)


def _runs(work):
    import inspect

    rs = np.random.RandomState(0)
    ref = {}
    # the data-parallel MLP
    jinst = JaxDP(*mlp(JaxBuilder), JaxSCCE(), JaxAdam(alpha=1e-3), devices=jax.devices()[:RANKS])
    init = {k: np.array(v) for k, v in jinst.initialize(seed=0)[0].items()}
    x, y = rs.randn(8, 32).astype(np.float32), rs.randint(0, 16, 8).astype(np.int32)
    np.savez(work / "dp.npz", x=x, y=y, **init)
    ref["dp"] = dict(jax=_jax_dp(init, x, y), init=init)
    # the tp2 and dp2 plans of the small flagship
    for mode, t_seed, j_seed in (("tp2", tensor_parallel_seed, j_tp_seed),
                                 ("pcg_dp2", data_parallel_seed, j_dp_seed)):
        tp = t_seed(build_flagship_pcg(**FLAGSHIP), 2)
        jp = j_seed(bench.build_flagship_pcg(**FLAGSHIP), 2)
        init = {k: np.array(v) for k, v in jax_init_pcg_params(jp, jax.random.PRNGKey(0)).items()}
        x = rs.randn(FLAGSHIP["batch"], FLAGSHIP["seq"], FLAGSHIP["embed"]).astype(np.float32)
        y = rs.randint(0, FLAGSHIP["vocab"], (FLAGSHIP["batch"], FLAGSHIP["seq"])).astype(np.int32)
        save_strategy(str(work / f"{mode}.json"), tp, None)
        np.savez(work / f"{mode}.npz", x=x, y=y, **init)
        ref[mode] = dict(jax=_jax_pcg(jp, init, x, y), init=init)
    (work / "mlp.py").write_text(inspect.getsource(mlp))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work), str(CAP)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    for mode in ref:
        ranks = []
        for r in range(RANKS):
            z = dict(np.load(work / f"{mode}_rank{r}.npz"))
            pick = lambda pre: {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}
            ranks.append(dict(grads=pick("grad_"), params=pick("param_"),
                              **json.loads(str(z["meta"]))))
        ref[mode]["ranks"] = ranks
    return ref


MODES = ["dp", "tp2", "pcg_dp2"]
BUCKETED = ["dp", "pcg_dp2"]  # the modes whose weight gradients are summed


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("mode", MODES)
def test_losses_match_the_jax_trainer(runs, mode):
    for r in runs[mode]["ranks"]:
        np.testing.assert_allclose(r["losses"], runs[mode]["jax"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_first_step_gradients_match_the_jax_trainer(runs, mode):
    want = runs[mode]["jax"]["grads"]
    for r in runs[mode]["ranks"]:
        assert r["grads"].keys() == want.keys()
        for k, g in want.items():
            assert _rel(r["grads"][k], g) < 1e-5, k


@pytest.mark.parametrize("mode", MODES)
def test_parameters_after_three_adam_steps_match(runs, mode):
    for r in runs[mode]["ranks"]:
        for k, want in runs[mode]["jax"]["params"].items():
            moved = np.linalg.norm(want - runs[mode]["init"][k])
            assert np.linalg.norm(r["params"][k] - want) <= 1e-3 * moved, k


@pytest.mark.parametrize("mode", MODES)
def test_buckets_sum_bitwise_as_one_bucket(runs, mode):
    assert all(r["same_as_one_bucket"] for r in runs[mode]["ranks"])


@pytest.mark.parametrize("mode", MODES)
def test_bucket_count_is_the_plans(runs, mode):
    """The plan cut from the parameters' f32 sizes and CAP, filled in
    reverse first use, and one all-reduce per bucket (over more than one
    rank) and one of the loss a step."""
    for r in runs[mode]["ranks"]:
        plan, numel = r["plan"], r["piece_numel"]
        summed = [b for i, b in enumerate(plan)
                  if mode == "dp" or r["axes"][i]]  # a bucket over no axis holds no collective
        if mode not in BUCKETED:
            assert summed == [] and all(log[0] == 0 for log in r["bucket_log"])
        else:
            assert len(summed) > 2
        for b in summed:
            assert len(b) == 1 or 4 * sum(numel[k] for k in b) <= CAP
        # greedy: no bucket could have taken the next one's first tensor
        for a, b in zip(summed, summed[1:]):
            assert 4 * sum(numel[k] for k in a + b[:1]) > CAP
        buckets = len(summed) + 1
        assert r["implied"]["all_reduce"] >= buckets
        assert all(s == r["implied"] for s in r["per_step"]), (r["per_step"], r["implied"])
        if mode == "dp":
            assert r["implied"] == {"all_reduce": buckets}


@pytest.mark.parametrize("mode", BUCKETED)
def test_buckets_are_issued_before_the_backward_ends(runs, mode):
    for r in runs[mode]["ranks"]:
        assert len(r["bucket_log"]) == 1 + STEPS
        for issued, early in r["bucket_log"]:
            assert issued > 2 and 1 <= early < issued
