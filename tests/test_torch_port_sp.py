"""The sequence-parallel slice as a whole: a small causal parallel
transformer (build_parallel_transformer: 2 layers, hidden 256, batch 4, seq
256, vocab 512) trained three Adam steps in f32 on the CPU from the same
numpy parameters and global batch by

- the JAX package's DistributedTrainingInstance on 2 (sp = 2) or 4
  (dp = 2 x sp = 2) virtual CPU devices, whose RingAttention runs the
  ring-flash Pallas kernels in interpret mode through
  ring_flash_attention_block;
- the port's DistributedTrainingInstance on as many gloo processes over a
  `file://` store, each a subprocess that imports nothing of JAX.

At sp = 1 the port's ring of one (in this process, over a one-rank gloo
group) is held against the JAX package's dense fallback.

Tolerances are those of tests/test_torch_port_dp.py: losses rtol 1e-5,
first-step gradients 1e-5 relative, parameters after three steps within
1e-3 of how far they moved (Adam moves every parameter by about alpha
whatever its gradient's size)."""

import dataclasses
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

from flexflow_tpu.kernels import ring_flash as jrf
from flexflow_tpu.models.parallel_transformer import (
    ParallelTransformerConfig as JaxConfig,
    build_parallel_transformer as jax_build,
)
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.parallel import DistributedTrainingInstance as JaxDTI
from flexflow_tpu.parallel import MachineMesh as JaxMesh
from flexflow_tpu.parallel.executor import init_pcg_params as jax_init_pcg_params
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import ring_flash as trf
from flexflow_tpu_torch.models import ParallelTransformerConfig, build_parallel_transformer
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.parallel import (
    DistributedTrainingInstance,
    MachineMesh,
    init_file_group,
)
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(batch_size=4, sequence_length=256, num_features=256, num_heads=2, num_layers=2,
             vocab_size=512, data_parallel_degree=1, tensor_parallel_degree=1,
             sequence_parallel_degree=1, causal=True)
STEPS = 3

# One rank of the port's run; argv: rank, work dir, config.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
    from flexflow_tpu_torch.kernels import ring_flash
    from flexflow_tpu_torch.models import ParallelTransformerConfig, build_parallel_transformer
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh, init_file_group
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    torch.set_num_threads(2)
    rank, work, cfg = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    dp, sp = cfg["data_parallel_degree"], cfg["sequence_parallel_degree"]
    init_file_group(os.path.join(work, "store"), rank, dp * sp, device="cpu")
    pcg, logits = build_parallel_transformer(ParallelTransformerConfig(**cfg))
    inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       AdamOptimizerAttrs(alpha=1e-3), MachineMesh(dp, sp),
                                       device="cpu")
    opt = inst.initialize(seed=0)[1]
    data = np.load(os.path.join(work, "inputs.npz"))
    params = params_from_numpy(pcg, {k: data[k] for k in data.files if k.startswith("n")}, "cpu")
    x, y = data["x"], data["y"]
    refused = []
    bad = [(x[:, :255], y[:, :255])] + ([(x[:3], y[:3])] if dp > 1 else [])
    for bx, by in bad:  # refused before any collective or update
        try:
            inst.train_step(params, opt, {"x": bx}, by)
            refused.append("")
        except ValueError as e:
            refused.append(str(e))
    calls = []
    block = ring_flash.ring_flash_attention_block
    ring_flash.ring_flash_attention_block = lambda *a: calls.append(1) or block(*a)
    _, grads = inst.loss_and_grads(params, {"x": x}, y)
    out = {f"grad_{k}": g.numpy() for k, g in grads.items()}
    losses = []
    for _ in range(3):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
    out.update({f"param_{k}": v for k, v in params_to_numpy(params).items()})
    np.savez(os.path.join(work, f"rank{rank}.npz"), losses=np.array(losses),
             all_reduces=inst.all_reduces, per_step=inst.step_collectives()["all_reduce"],
             buckets=sum(1 for axes, _ in inst.plan.buckets if inst.machine_mesh.size(axes) > 1),
             refused=np.array(refused), ring_calls=len(calls), **out)
    dist.destroy_process_group()
    """
)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _jax_run(cfg, init, x, y):
    """Losses, first-step gradients and final parameters of the JAX
    DistributedTrainingInstance on dp * sp CPU devices, with the count of
    calls to ring_flash_attention_block."""
    n = cfg["data_parallel_degree"] * cfg["sequence_parallel_degree"]
    mm = JaxMesh.for_devices(n, devices=jax.devices()[:n])
    inst = JaxDTI(*jax_build(JaxConfig(**cfg)), JaxSCCE(), JaxAdam(alpha=1e-3), mm)
    placed, opt = inst.initialize(seed=0)
    params = {k: jax.device_put(jnp.asarray(init[k]), v.sharding) for k, v in placed.items()}
    xs, ys = inst.input_sharding("x"), inst.label_sharding()
    xj = jax.device_put(jnp.asarray(x), xs) if xs is not None else jnp.asarray(x)
    yj = jax.device_put(jnp.asarray(y), ys) if ys is not None else jnp.asarray(y)
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FLEXFLOW_TPU_FLASH_INTERPRET", "1")
        mp.setenv("FLEXFLOW_TPU_FLASH_MIN_SEQ", "128")
        block = jrf.ring_flash_attention_block
        mp.setattr(jrf, "ring_flash_attention_block", lambda *a, **k: calls.append(1) or block(*a, **k))
        with mm.mesh:
            grads = jax.jit(jax.grad(lambda p, x, y: inst.loss_fn(p, {"x": x}, y)[0]))(
                params, xj, yj)
        losses = []
        for _ in range(STEPS):
            params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
            losses.append(float(loss))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()}, ring_calls=len(calls))


def _data(cfg):
    """The JAX package's initial parameters (seed 0) and a global batch."""
    pcg, _ = jax_build(JaxConfig(**cfg))
    init = {k: np.array(v) for k, v in jax_init_pcg_params(pcg, jax.random.PRNGKey(0)).items()}
    rs = np.random.RandomState(0)
    x = rs.randn(cfg["batch_size"], cfg["sequence_length"], cfg["num_features"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab_size"], (cfg["batch_size"], cfg["sequence_length"])).astype(np.int32)
    return init, x, y


def _port_ranks(work: Path, cfg):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    ranks = cfg["data_parallel_degree"] * cfg["sequence_parallel_degree"]
    procs = [
        subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(work), json.dumps(cfg)],
                         cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(ranks)
    ]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err
    out = []
    for r in range(ranks):
        z = dict(np.load(work / f"rank{r}.npz"))
        out.append(dict(losses=list(z["losses"]), all_reduces=int(z["all_reduces"]),
                        per_step=int(z["per_step"]), buckets=int(z["buckets"]),
                        refused=[str(e) for e in z["refused"]], ring_calls=int(z["ring_calls"]),
                        grads={k[5:]: v for k, v in z.items() if k.startswith("grad_")},
                        params={k[6:]: v for k, v in z.items() if k.startswith("param_")}))
    return out


@pytest.fixture(scope="module", params=[(1, 2, 2), (2, 2, 4)], ids=["sp2_heads128", "dp2xsp2_heads64"])
def runs(request, tmp_path_factory):
    dp, sp, heads = request.param
    return once_per_session(tmp_path_factory, f"sp_dp{dp}_sp{sp}",
                            lambda work: _runs(work, dp, sp, heads))


def _runs(work, dp, sp, heads):
    cfg = dict(SMALL, data_parallel_degree=dp, sequence_parallel_degree=sp, num_heads=heads)
    init, x, y = _data(cfg)
    np.savez(work / "inputs.npz", x=x, y=y, **init)
    return dict(cfg=cfg, init=init, jax=_jax_run(cfg, init, x, y), ranks=_port_ranks(work, cfg))


def test_jax_reference_took_its_ring_flash_route(runs):
    # once per layer each time the gradient or the train step is traced
    calls, layers = runs["jax"]["ring_calls"], runs["cfg"]["num_layers"]
    assert calls >= 2 * layers and calls % layers == 0
    for r in runs["ranks"]:
        # the port's: one per layer in the gradient call and in each step
        assert r["ring_calls"] == layers * (1 + STEPS)


def test_losses_match_per_step(runs):
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["losses"], runs["jax"]["losses"], rtol=1e-5)


def test_first_step_gradients_match(runs):
    want = runs["jax"]["grads"]
    for r in runs["ranks"]:
        assert r["grads"].keys() == want.keys()
        for k, g in want.items():
            assert _rel(r["grads"][k], g) < 1e-5, k


def test_parameters_after_three_steps_match(runs):
    for r in runs["ranks"]:
        for k, want in runs["jax"]["params"].items():
            moved = np.linalg.norm(want - runs["init"][k])
            assert np.linalg.norm(r["params"][k] - want) <= 1e-3 * moved, k


def test_ranks_hold_bitwise_equal_parameters(runs):
    first, *others = runs["ranks"]
    for r in others:
        assert r["losses"] == first["losses"]
        for k, v in first["params"].items():
            assert np.array_equal(v, r["params"][k]), k


def test_one_all_reduce_per_step_and_indivisible_blocks_are_refused(runs):
    """A step's all-reduces: one gradient bucket (the small model's
    gradients fit one under BUCKET_CAP_BYTES) and the loss's."""
    dp = runs["cfg"]["data_parallel_degree"]
    for r in runs["ranks"]:
        assert r["buckets"] == 1 and r["per_step"] == r["buckets"] + 1
        assert r["all_reduces"] == (1 + STEPS) * r["per_step"]  # loss_and_grads, then the steps
        assert "does not divide over 2 sequence-parallel ranks" in r["refused"][0]
        if dp > 1:
            assert "does not divide over 2 data-parallel ranks" in r["refused"][1]


@pytest.fixture
def one_rank_group(tmp_path):
    init_file_group(str(tmp_path / "store"), 0, 1, device="cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_ring_of_one_matches_the_jax_dense_fallback(one_rank_group, monkeypatch):
    """At sp = 1 the port's RingAttention still runs the ring (one step, no
    rotation); the JAX package's falls back to dense attention."""
    cfg = SMALL
    init, x, y = _data(cfg)
    want = _jax_run(cfg, init, x, y)
    assert want["ring_calls"] == 0
    pcg, logits = build_parallel_transformer(ParallelTransformerConfig(**cfg))
    inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       AdamOptimizerAttrs(alpha=1e-3), MachineMesh(1, 1),
                                       device="cpu")
    calls = []
    block = trf.ring_flash_attention_block
    monkeypatch.setattr(trf, "ring_flash_attention_block", lambda *a: calls.append(1) or block(*a))
    params, opt = params_from_numpy(pcg, init, "cpu"), inst.initialize(seed=0)[1]
    _, grads = inst.loss_and_grads(params, {"x": x}, y)
    assert len(calls) == cfg["num_layers"]
    for k, g in want["grads"].items():
        assert _rel(grads[k].numpy(), g) < 1e-5, k
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
    np.testing.assert_allclose(losses, want["losses"], rtol=1e-5)
    got = params_to_numpy(params)
    for k, w in want["params"].items():
        assert np.linalg.norm(got[k] - w) <= 1e-3 * np.linalg.norm(w - init[k]), k
    assert inst.all_reduces == 0  # a ring of one issues no collective
    logits_shape = (cfg["batch_size"], cfg["sequence_length"], cfg["vocab_size"])
    assert inst.forward(params, {"x": x}).shape == logits_shape


def test_a_pcg_with_parallel_ops_is_refused(one_rank_group):
    # the parallel ops lower (tests/test_torch_port_tp.py); a degree-2 plan
    # on one rank has no axis to place its copies on
    cfg = ParallelTransformerConfig(**dict(SMALL, tensor_parallel_degree=2, causal=False))
    pcg, logits = build_parallel_transformer(cfg)
    with pytest.raises(NotImplementedError, match="rep_attn0 .* discard-copy degree 2"):
        DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                    AdamOptimizerAttrs(alpha=1e-3), MachineMesh(1, 1),
                                    device="cpu")


def test_trainer_defaults_to_cuda_and_raises_without_a_card(one_rank_group, monkeypatch):
    pcg, logits = build_parallel_transformer(ParallelTransformerConfig(**SMALL))
    args = (pcg, logits, SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-3),
            MachineMesh(1, 1))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedTrainingInstance(*args)
    assert DistributedTrainingInstance(*args, device="cpu").device == torch.device("cpu")


def test_mesh_needs_its_ranks_and_the_ring_its_sequence(one_rank_group):
    with pytest.raises(ValueError, match="a 1 x 2 mesh needs 2 ranks"):
        MachineMesh(1, 2)
    mesh = MachineMesh(1, 1)
    assert (mesh.dp_index, mesh.sp_index, mesh.ring().size) == (0, 0, 1)


def test_port_pcg_matches_the_jax_builder_node_by_node():
    """Node indices (the parameter keys n{idx}), ops, wiring and parallel
    shapes, with and without the parallel ops."""
    for kw in (dict(data_parallel_degree=2, sequence_parallel_degree=2),
               dict(tensor_parallel_degree=2, causal=False)):
        cfg = dict(SMALL, **kw)
        pcg, logits = build_parallel_transformer(ParallelTransformerConfig(**cfg))
        jpcg, jlogits = jax_build(JaxConfig(**cfg))
        assert logits.node.idx == jlogits.node.idx
        nodes, jnodes = pcg.topological_ordering(), jpcg.topological_ordering()
        assert [n.idx for n in nodes] == [n.idx for n in jnodes]
        for n, jn in zip(nodes, jnodes):
            assert type(pcg.op_attrs(n)).__name__ == type(jpcg.op_attrs(jn)).__name__
            assert [v.node.idx for v in pcg.inputs_of(n)] == [v.node.idx for v in jpcg.inputs_of(jn)]
            for o, jo in zip(pcg.outputs_of(n), jpcg.outputs_of(jn)):
                a, b = pcg.tensor_shape(o), jpcg.tensor_shape(jo)
                assert (a.sizes(), a.shard_degrees(), a.sum_degree, a.discard_copy_degree) == (
                    b.sizes(), b.shard_degrees(), b.sum_degree, b.discard_copy_degree)


def test_sp_longctx_is_the_flagship_at_seq_8192():
    from flexflow_tpu_torch.models import SP_LONGCTX
    from flexflow_tpu_torch.models.parallel_transformer import model_step_flops

    assert (SP_LONGCTX.num_features, SP_LONGCTX.num_heads, SP_LONGCTX.num_layers,
            SP_LONGCTX.vocab_size) == (1024, 8, 12, 32000)
    assert SP_LONGCTX.batch_size * SP_LONGCTX.sequence_length == 64 * 512 and SP_LONGCTX.causal
    full = model_step_flops(dataclasses.replace(SP_LONGCTX, causal=False))
    b, s, e, h = 4, 8192, 1024, 8
    assert full - model_step_flops(SP_LONGCTX) == 3 * 12 * (2 * b * h * s * s * (e // h) * 2) // 2
