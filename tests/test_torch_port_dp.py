"""The data-parallel slice as a whole: a small flagship trained three Adam
steps in f32 on the CPU from the same numpy parameters and global batch by
three runs,

- the JAX package's DataParallelTrainingInstance on 2 virtual CPU devices,
  whose attention runs the per-head Pallas kernels in interpret mode
  through sharded_flash_attention;
- the port's DataParallelTrainingInstance on 2 gloo processes over a
  `file://` store, each a subprocess that imports nothing of JAX;
- the port's single-device ModelTrainingInstance.

Tolerances are those of tests/test_torch_port_step.py: losses rtol 1e-5,
first-step gradients 1e-5 relative, parameters after three steps within
1e-3 of how far they moved (Adam moves every parameter by about alpha
whatever its gradient's size)."""

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
import torch.distributed as dist

from bench import build_flagship_cg as jax_build_flagship_cg
from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.parallel.data_parallel import DataParallelTrainingInstance as JaxDP
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.parallel import DataParallelTrainingInstance, init_file_group
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(batch=4, seq=128, embed=256, heads=2, layers=2, vocab=512)
STEPS = 3
RANKS = 2

# One rank of the port's data-parallel run; argv: rank, work dir, config.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
    from flexflow_tpu_torch.models import build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance, init_file_group
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    torch.set_num_threads(2)
    rank, work, cfg = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    init_file_group(os.path.join(work, "store"), rank, int(sys.argv[4]), device="cpu")
    graph, logits = build_flagship_cg(**cfg)
    inst = DataParallelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                        AdamOptimizerAttrs(alpha=1e-3), device="cpu")
    opt = inst.initialize(seed=0)[1]
    data = np.load(os.path.join(work, "inputs.npz"))
    params = params_from_numpy(graph, {k: data[k] for k in data.files if k.startswith("n")}, "cpu")
    x, y = data["x"], data["y"]
    try:
        inst.train_step(params, opt, {"x": x[:3]}, y[:3])
        refused = ""
    except ValueError as e:
        refused = str(e)
    _, grads = inst.loss_and_grads(params, {"x": x}, y)
    out = {f"grad_{k}": g.numpy() for k, g in grads.items()}
    losses = []
    for _ in range(3):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
    out.update({f"param_{k}": v for k, v in params_to_numpy(params).items()})
    np.savez(os.path.join(work, f"rank{rank}.npz"), losses=np.array(losses),
             all_reduces=inst.all_reduces, per_step=inst.step_collectives()["all_reduce"],
             buckets=len(inst.buckets), refused=refused, **out)
    dist.destroy_process_group()
    """
)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_dp(cfg, init, x, y):
    """Losses, first-step gradients and final parameters of the JAX DP
    trainer on 2 CPU devices, with the count of sharded flash calls."""
    graph, logits = jax_build_flagship_cg(**cfg)
    inst = JaxDP(graph, logits, JaxSCCE(), JaxAdam(alpha=1e-3), devices=jax.devices()[:RANKS])
    params, opt = inst.initialize(seed=0)
    params = {k: jnp.asarray(init[k]) for k in params}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_FLASH_INTERPRET", "1")
        mp.setenv("FLEXFLOW_TPU_FLASH_MIN_SEQ", str(cfg["seq"]))
        sharded = jfa.sharded_flash_attention
        mp.setattr(jfa, "sharded_flash_attention", lambda *a, **k: calls.append(1) or sharded(*a, **k))
        with jfa.flash_mesh(inst.mesh, "data", None, True):
            grads = jax.jit(
                jax.grad(lambda p, x, y: inst.loss_fn(p, {"x": x}, y)[0]),
                in_shardings=(inst.replicated, inst.batch_sharded, inst.batch_sharded),
            )(params, xj, yj)
        losses = []
        for _ in range(STEPS):
            params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
            losses.append(float(loss))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()}, sharded_calls=len(calls))


def _port_dp(work: Path, cfg):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [
        subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work), json.dumps(cfg),
                          str(RANKS)], cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
        for r in range(RANKS)
    ]
    for p in procs:
        _, err = p.communicate(timeout=240)
        assert p.returncode == 0, err
    return [dict(np.load(work / f"rank{r}.npz")) for r in range(RANKS)]


def _port_single(graph, logits, init, x, y):
    inst = ModelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                 AdamOptimizerAttrs(alpha=1e-3), device="cpu")
    params = params_from_numpy(graph, init, "cpu")
    opt = inst.initialize(seed=0)[1]
    _, grads = inst.loss_and_grads(params, {"x": x}, y)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
    return dict(losses=losses, grads={k: g.numpy() for k, g in grads.items()},
                params=params_to_numpy(params))


@pytest.fixture(scope="module", params=[2, 4], ids=["heads128", "heads64"])
def runs(request, tmp_path_factory):
    return once_per_session(tmp_path_factory, f"dp_heads{request.param}",
                            lambda work: _runs(work, request.param))


def _runs(work, heads):
    cfg = dict(SMALL, heads=heads)
    jinst = JaxDP(*jax_build_flagship_cg(**cfg), JaxSCCE(), JaxAdam(alpha=1e-3),
                  devices=jax.devices()[:RANKS])
    init = {k: np.array(v) for k, v in jinst.initialize(seed=0)[0].items()}
    rs = np.random.RandomState(0)
    x = rs.randn(cfg["batch"], cfg["seq"], cfg["embed"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"])).astype(np.int32)
    np.savez(work / "inputs.npz", x=x, y=y, **init)
    ranks = _port_dp(work, cfg)
    graph, logits = build_flagship_cg(**cfg)
    return dict(
        cfg=cfg, init=init, jax=_jax_dp(cfg, init, x, y),
        single=_port_single(graph, logits, init, x, y),
        ranks=[dict(losses=list(r["losses"]),
                    grads={k[5:]: v for k, v in r.items() if k.startswith("grad_")},
                    params={k[6:]: v for k, v in r.items() if k.startswith("param_")},
                    all_reduces=int(r["all_reduces"]), per_step=int(r["per_step"]),
                    buckets=int(r["buckets"]), refused=str(r["refused"]))
               for r in ranks],
    )


def test_jax_reference_ran_the_per_head_kernels(runs):
    # once per layer each time the gradient or the train step is traced
    calls, layers = runs["jax"]["sharded_calls"], runs["cfg"]["layers"]
    assert calls >= 2 * layers and calls % layers == 0


def test_losses_match_per_step(runs):
    want = runs["jax"]["losses"]
    for got in (runs["ranks"][0]["losses"], runs["single"]["losses"]):
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_first_step_gradients_match(runs):
    want = runs["jax"]["grads"]
    for got in (runs["ranks"][0]["grads"], runs["single"]["grads"]):
        assert got.keys() == want.keys()
        for k, g in want.items():
            assert _rel(got[k], g) < 1e-5, k


def test_parameters_after_three_steps_match(runs):
    for got in (runs["ranks"][0]["params"], runs["single"]["params"]):
        for k, want in runs["jax"]["params"].items():
            moved = np.linalg.norm(want - runs["init"][k])
            assert np.linalg.norm(got[k] - want) <= 1e-3 * moved, k


def test_ranks_hold_bitwise_equal_parameters(runs):
    first, second = runs["ranks"]
    assert first["losses"] == second["losses"]
    for k, v in first["params"].items():
        assert np.array_equal(v, second["params"][k]), k


def test_one_all_reduce_per_step_and_an_indivisible_batch_is_refused(runs):
    """One all-reduce a gradient bucket, and one of the loss and metrics, a
    step: the bucket plan of the parameters' sizes under BUCKET_CAP_BYTES
    (the small flagship's f32 gradients fit one bucket)."""
    from flexflow_tpu_torch.parallel.collectives import BUCKET_CAP_BYTES

    grad_bytes = 4 * sum(v.size for v in runs["init"].values())
    assert grad_bytes < BUCKET_CAP_BYTES
    for r in runs["ranks"]:
        assert r["buckets"] == 1 and r["per_step"] == r["buckets"] + 1
        assert r["all_reduces"] == (1 + STEPS) * r["per_step"]  # loss_and_grads, then the steps
        assert "does not divide over 2" in r["refused"]


@pytest.fixture
def one_rank_group(tmp_path):
    init_file_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def _count(monkeypatch, module, name, calls):
    fn = getattr(module, name)
    monkeypatch.setattr(module, name, lambda *a, **k: calls.append(name) or fn(*a, **k))


@pytest.mark.parametrize("heads", [2, 4])
def test_mha_takes_the_per_head_entry_only_under_data_parallel(heads, one_rank_group,
                                                                monkeypatch):
    cfg = dict(SMALL, heads=heads, batch=2, layers=1)
    graph, logits = build_flagship_cg(**cfg)
    rs = np.random.RandomState(1)
    x = rs.randn(2, cfg["seq"], cfg["embed"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab"], (2, cfg["seq"]))
    calls = []
    for name in ("sharded_flash_attention", "flash_attention_bshf", "flash_attention_bshf_qkv"):
        _count(monkeypatch, tops, name, calls)
    args = (graph, logits, SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-3))
    dp = DataParallelTrainingInstance(*args, device="cpu")
    dp.train_step(*dp.initialize(seed=0), {"x": x}, y)
    assert calls == ["sharded_flash_attention"] and tfa.current_flash_mesh() is None
    calls.clear()
    single = ModelTrainingInstance(*args, device="cpu")
    single.train_step(*single.initialize(seed=0), {"x": x}, y)
    assert calls == ["flash_attention_bshf" if heads == 2 else "flash_attention_bshf_qkv"]


def test_trainer_needs_a_process_group_and_defaults_to_cuda(tmp_path, monkeypatch):
    graph, logits = build_flagship_cg(**dict(SMALL, layers=1))
    args = (graph, logits, SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-3))
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        DataParallelTrainingInstance(*args, device="cpu")
    init_file_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DataParallelTrainingInstance(*args)
        assert DataParallelTrainingInstance(*args, device="cpu").device == torch.device("cpu")
    finally:
        dist.destroy_process_group()


def test_profile_step_splits_copy_kernels_by_their_launcher():
    """profile_step --dp reads the NCCL all-reduce and the copies from the
    trace: copy kernels are told apart by the operator above them."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from flexflow_tpu_torch import profile_step

    def op(name, parent=None, kernels=()):
        return NS(name=name, cpu_parent=parent, device_type=DeviceType.CPU,
                  kernels=[NS(name=k, duration=us) for k, us in kernels])

    copy = "void at::native::direct_copy_kernel_cuda"
    to = op("aten::_to_copy", op("aten::to"))
    events = [
        op("aten::copy_", to, [(copy, 3000.0)]),
        op("aten::cat", None, [("CatArrayBatchedCopy", 1000.0)]),
        op("aten::copy_", op("aten::clone", op("aten::reshape")), [(copy, 500.0)]),
        op("aten::mm", None, [("nvjet_tst_256x128", 9000.0)]),
        NS(name=copy, cpu_parent=None, device_type=DeviceType.CUDA, kernels=[]),
    ]
    got = profile_step.copy_split(NS(events=lambda: events), steps=2)
    assert got == {"cast (aten::_to_copy)": 1.5,
                   "concatenation (aten::cat, e.g. the gradient bucket)": 0.5,
                   "layout copy (other ops)": 0.25}
    assert profile_step.group_of("ncclDevKernel_AllReduce_Sum_f32_RING_LL") == "all-reduce (NCCL)"
    assert profile_step.group_of("ff_flash_bwd_dq_bhsd_kernel") == "flash attention (port kernels)"


# -- C2: BatchNorm over the whole batch ---------------------------------------

# One rank of the BatchNorm probe (conv 3->4, BatchNorm, Flat, Dense 10);
# argv: rank, work dir.
BN_WORKER = textwrap.dedent(
    """
    import os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance, init_file_group
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs, ComputationGraphBuilder

    torch.set_num_threads(2)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "store"), rank, 2, device="cpu")
    b = ComputationGraphBuilder()
    x = b.create_input([8, 3, 8, 8], name="x")
    h = b.flat(b.batch_norm(b.conv2d(x, 4, (3, 3), (1, 1), (1, 1))))
    logits = b.dense(h, 10)
    inst = DataParallelTrainingInstance(b.graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                        AdamOptimizerAttrs(alpha=1e-3), device="cpu",
                                        metrics=frozenset({"accuracy"}))
    opt = inst.initialize(seed=0)[1]
    data = np.load(os.path.join(work, "inputs.npz"))
    params = params_from_numpy(b.graph, {k: data[k] for k in data.files if k.startswith("n")},
                               "cpu")
    mvals = {}
    _, grads = inst.loss_and_grads(params, {"x": data["x"]}, data["y"], metrics=mvals)
    losses = []
    for _ in range(3):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": data["x"]}, data["y"])
        losses.append(float(loss))
    np.savez(os.path.join(work, f"rank{rank}.npz"), losses=np.array(losses),
             train_all=mvals["train_all"], train_correct=int(mvals["train_correct"]),
             **{f"grad_{k}": g.numpy() for k, g in grads.items()},
             **{f"param_{k}": v for k, v in params_to_numpy(params).items()})
    dist.destroy_process_group()
    """
)


def _bn_probe(builder):
    b = builder()
    x = b.create_input([8, 3, 8, 8], name="x")
    h = b.flat(b.batch_norm(b.conv2d(x, 4, (3, 3), (1, 1), (1, 1))))
    return b.graph, b.dense(h, 10)


@pytest.fixture(scope="module")
def bn_runs(tmp_path_factory):
    """The probe on the JAX DP trainer (2 virtual devices) and on the
    port's (2 gloo ranks), from the same numpy parameters and batch: 8
    samples of 3x8x8, each with its own mean."""
    from flexflow_tpu.pcg.computation_graph_builder import ComputationGraphBuilder as JBuilder

    graph, logits = _bn_probe(JBuilder)
    inst = JaxDP(graph, logits, JaxSCCE(), JaxAdam(alpha=1e-3), devices=jax.devices()[:RANKS])
    params, opt = inst.initialize(seed=0)
    init = {k: np.array(v) for k, v in params.items()}
    rs = np.random.RandomState(0)
    x = (rs.randn(8, 3, 8, 8) + np.arange(8)[:, None, None, None]).astype(np.float32)
    y = rs.randint(0, 10, 8).astype(np.int32)
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    grads = jax.jit(jax.grad(lambda p, x, y: inst.loss_fn(p, {"x": x}, y)[0]),
                    in_shardings=(inst.replicated, inst.batch_sharded, inst.batch_sharded)
                    )(params, xj, yj)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
        losses.append(float(loss))
    work = tmp_path_factory.mktemp("dp_batch_norm")
    np.savez(work / "inputs.npz", x=x, y=y, **init)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", BN_WORKER, str(r), str(work)], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(RANKS)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
    ranks = [dict(np.load(work / f"rank{r}.npz")) for r in range(RANKS)]
    # the conv bias: BatchNorm cancels it, so its gradient is about 0
    (conv,) = [n for n in graph.topological_ordering()
               if type(graph.op_attrs(n)).__name__ == "Conv2DAttrs"]
    bias = graph.inputs_of(conv)[2].node
    return dict(init=init, jax=dict(losses=losses, params={k: np.asarray(v) for k, v in
                                                           params.items()},
                                    grads={k: np.asarray(g) for k, g in grads.items()}),
                ranks=ranks, conv_bias=f"n{bias.idx}", x=x, y=y)


def test_batch_norm_takes_the_whole_batchs_statistics_across_ranks(bn_runs):
    """C2: the probe's losses on 2 ranks equal the JAX DP trainer's."""
    for r in bn_runs["ranks"]:
        np.testing.assert_allclose(r["losses"], bn_runs["jax"]["losses"], rtol=1e-5)


def test_batch_norm_gradients_match_gspmds(bn_runs):
    want, bias = bn_runs["jax"]["grads"], bn_runs["conv_bias"]
    for r in bn_runs["ranks"]:
        for k, g in want.items():
            got = r[f"grad_{k}"]
            if k == bias:
                np.testing.assert_allclose(got, g, atol=1e-6)
            else:
                assert _rel(got, g) < 1e-5, k


def test_batch_norm_parameters_after_three_steps_match(bn_runs):
    for r in bn_runs["ranks"]:
        for k, want in bn_runs["jax"]["params"].items():
            if k == bn_runs["conv_bias"]:
                # Adam scales its roundoff gradient to steps of up to alpha
                # either way: only the bound of three such steps holds
                assert np.abs(r[f"param_{k}"] - want).max() <= 2 * STEPS * 1e-3
                continue
            moved = np.linalg.norm(want - bn_runs["init"][k])
            assert np.linalg.norm(r[f"param_{k}"] - want) <= 1e-3 * moved, k


def test_metrics_are_summed_over_the_ranks(bn_runs):
    """A7 item 2: each rank reports the whole batch's metrics."""
    for r in bn_runs["ranks"]:
        assert int(r["train_all"]) == 8
    assert int(bn_runs["ranks"][0]["train_correct"]) == int(bn_runs["ranks"][1]["train_correct"])
