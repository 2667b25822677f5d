"""Ulysses (all-to-all) sequence-parallel attention on the port
(kernels/ulysses_attention.py, parallel/collectives.py `all_to_all`, the
executor's Ulysses route) against the JAX package, f32 on the CPU:

- ulysses_mha_forward on 4 gloo ranks against the JAX ulysses_mha_forward
  on 4 virtual devices (tests/test_ulysses_attention.py's inputs): the
  sequence over 4 ranks, causal and not, and the sequence over 2 with the
  heads over 2 and both biases; outputs, and the gradients of the sum of
  squares with respect to the input, the weight and the biases (each
  rank's pieces summed where the ranks share a value) within 2e-5;
- at sp = 1 the all-to-all is the identity and the values are the dense
  attention's (the JAX package's unsharded fallback);
- the trainer: the small causal parallel transformer of
  tests/test_torch_port_sp.py with its RingAttention nodes relabelled
  UlyssesAttention (the a2a rule's op), at sp = 2 (2 ranks, heads of 128)
  and dp = 2 x sp = 2 (4 ranks, heads of 64), three Adam steps against the
  JAX DistributedTrainingInstance on as many virtual devices (losses rtol
  1e-5, first-step gradients 1e-5 relative, parameters within 1e-3 of how
  far they moved, as test_torch_port_sp.py);
- fault C7's regression: a Ulysses plan runs no ring step (no ring
  kernel, no ring transfer) and issues 4 all-to-alls a node forward and 4
  backward, as DistributedPlan.step_collectives predicts."""

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
from jax.sharding import PartitionSpec as JP

from flexflow_tpu.kernels.ops import _mha_forward as jax_mha_forward
from flexflow_tpu.kernels.ulysses_attention import ulysses_mha_forward as jax_ulysses
from flexflow_tpu.models.parallel_transformer import (
    ParallelTransformerConfig as JaxConfig,
    build_parallel_transformer as jax_build,
)
from flexflow_tpu.op_attrs.ops import UlyssesAttentionAttrs as JUlysses
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.parallel import DistributedTrainingInstance as JaxDTI
from flexflow_tpu.parallel import MachineMesh as JaxMesh
from flexflow_tpu.parallel.executor import init_pcg_params as jax_init_pcg_params
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu_torch.kernels.ulysses_attention import ulysses_mha_forward
from flexflow_tpu_torch.op_attrs.ops import UlyssesAttentionAttrs
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
SMALL = dict(batch_size=4, sequence_length=256, num_features=256, num_heads=2, num_layers=2,
             vocab_size=512, data_parallel_degree=1, tensor_parallel_degree=1,
             sequence_parallel_degree=1, causal=True)
STEPS = 3
# the kernel cases: (name, causal, sequence axes, head axes, biases)
KERNEL_CASES = [("sp4", False, ("d0", "d1"), (), False),
                ("sp4_causal", True, ("d0", "d1"), (), False),
                ("sp2xtp2_bias", False, ("d0",), ("d1",), True)]

# the parallel transformer with its RingAttention nodes relabelled
# UlyssesAttention, in either package (`pkg` its name)
RELABEL = textwrap.dedent(
    """
    def _ulysses(pcg, pkg):
        import dataclasses
        from importlib import import_module
        ops = import_module(pkg + ".op_attrs.ops")
        layer = import_module(pkg + ".pcg.parallel_computation_graph").ParallelLayerAttrs
        for n in pcg.topological_ordering():
            la = pcg.layer_attrs(n)
            if type(la.attrs) is ops.RingAttentionAttrs:
                fields = {f.name: getattr(la.attrs, f.name) for f in dataclasses.fields(la.attrs)}
                pcg.set_node_label(n, layer(ops.UlyssesAttentionAttrs(**fields), la.name))
        return pcg
    """
)
exec(RELABEL)

# One rank of the kernel job (4 ranks); argv: rank, work dir.
KERNEL_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.kernels.ulysses_attention import ulysses_mha_forward
    from flexflow_tpu_torch.op_attrs.ops import UlyssesAttentionAttrs
    from flexflow_tpu_torch.parallel import MachineMesh, init_file_group

    torch.set_num_threads(1)
    rank, work = int(sys.argv[1]), sys.argv[2]
    init_file_group(os.path.join(work, "kstore"), rank, 4, device="cpu", timeout_s=120)
    mesh = MachineMesh.for_devices(4)
    d = np.load(os.path.join(work, "kernel.npz"))
    out = {}
    for name, causal, seq_axes, head_axes, bias in json.load(open(os.path.join(work, "cases.json"))):
        x, w = d["x"], d["w"]
        sp, tp = mesh.size(seq_axes), mesh.size(head_axes)
        s, h = x.shape[1] // sp, w.shape[1] // tp
        i, j = mesh.index(seq_axes), mesh.index(head_axes)
        attrs = UlyssesAttentionAttrs(embed_dim=x.shape[2], num_heads=w.shape[1], causal=causal,
                                      bias=bias)
        leaves = [torch.tensor(x[:, i * s:(i + 1) * s]), torch.tensor(w[:, j * h:(j + 1) * h])]
        if bias:
            leaves += [torch.tensor(d["ib"]), torch.tensor(d["ob"])]
        leaves = [t.requires_grad_(True) for t in leaves]
        before = mesh.counts["all_to_all"]
        y = ulysses_mha_forward(attrs, leaves[0], leaves[0], leaves[0], leaves[1], mesh,
                                seq_axes, head_axes, *leaves[2:])
        fwd = mesh.counts["all_to_all"] - before
        grads = torch.autograd.grad((y ** 2).sum(), leaves)
        out[f"{name}_out"] = y.detach().numpy()
        out[f"{name}_a2a"] = np.array([fwd, mesh.counts["all_to_all"] - before - fwd])
        for k, g in zip(("x", "w", "ib", "ob"), grads):
            out[f"{name}_g{k}"] = g.numpy()
    np.savez(os.path.join(work, f"kernel_rank{rank}.npz"), **out)
    dist.destroy_process_group()
    """
)

# One rank of a trainer job; argv: rank, work dir, config.
TRAIN_WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
    from flexflow_tpu_torch.kernels import ring_attention, ring_flash
    from flexflow_tpu_torch.models import ParallelTransformerConfig, build_parallel_transformer
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh, init_file_group
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    torch.set_num_threads(2)
    rank, work, cfg = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
    dp, sp = cfg["data_parallel_degree"], cfg["sequence_parallel_degree"]
    init_file_group(os.path.join(work, "store"), rank, dp * sp, device="cpu", timeout_s=120)
    exec(open(os.path.join(work, "relabel.py")).read())
    pcg, logits = build_parallel_transformer(ParallelTransformerConfig(**cfg))
    pcg = _ulysses(pcg, "flexflow_tpu_torch")
    mesh = MachineMesh(dp, sp)
    inst = DistributedTrainingInstance(pcg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                       AdamOptimizerAttrs(alpha=1e-3), mesh, device="cpu")
    opt = inst.initialize(seed=0)[1]
    data = np.load(os.path.join(work, "inputs.npz"))
    params = params_from_numpy(pcg, {k: data[k] for k in data.files if k.startswith("n")}, "cpu")
    x, y = data["x"], data["y"]
    ring_calls = []
    for mod, fn in ((ring_flash, "ring_flash_attention_block"),
                    (ring_attention, "ring_attention_block")):
        real = getattr(mod, fn)
        setattr(mod, fn, lambda *a, _real=real, **k: ring_calls.append(1) or _real(*a, **k))
    _, grads = inst.loss_and_grads(params, {"x": x}, y)
    out = {f"grad_{k}": g.numpy() for k, g in grads.items()}
    losses, per_step = [], []
    for _ in range(3):
        before = dict(mesh.counts)
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
        per_step.append({k: v - before.get(k, 0) for k, v in mesh.counts.items()
                         if v - before.get(k, 0)})
    out.update({f"param_{k}": v for k, v in params_to_numpy(params).items()})
    np.savez(os.path.join(work, f"rank{rank}.npz"), losses=np.array(losses), **out)
    json.dump(dict(per_step=per_step, ring_calls=len(ring_calls),
                   ring_steps=mesh.counts["ring_step"],
                   predicted={k: int(v) for k, v in inst.step_collectives().items()},
                   a2a_nodes=sum(1 for p in inst.plan.nodes.values() if p.a2a_axes),
                   ring_nodes=sum(1 for p in inst.plan.nodes.values() if p.ring_axes)),
              open(os.path.join(work, f"rank{rank}.json"), "w"))
    dist.destroy_process_group()
    """
)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b))


def _launch(script, ranks, work, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(work), *args], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(ranks)]
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-4000:]


def _kernel_inputs():
    """tests/test_ulysses_attention.py's shapes: b 2, s 16, e 32, 8 heads."""
    rs = np.random.RandomState(3)
    e, heads = 32, 8
    kd = e // heads
    return dict(x=rs.randn(2, 16, e).astype(np.float32),
                w=(rs.randn(e * kd * 3 + kd * e, heads) * 0.1).astype(np.float32),
                ib=(rs.randn(3 * kd) * 0.1).astype(np.float32),
                ob=(rs.randn(e) * 0.1).astype(np.float32))


def _jax_kernel(inp, causal, seq_axes, head_axes, bias):
    mm = JaxMesh.for_devices(4, devices=jax.devices()[:4])
    attrs = JUlysses(embed_dim=32, num_heads=8, causal=causal, bias=bias)
    w_spec = JP(None, head_axes if len(head_axes) != 1 else head_axes[0]) if head_axes else None
    spec = JP(None, seq_axes if len(seq_axes) > 1 else seq_axes[0], None)

    def loss(x, w, ib, ob):
        out = jax_ulysses(attrs, x, x, x, w, mm.mesh, spec, w_spec=w_spec,
                          input_bias=ib if bias else None, output_bias=ob if bias else None)
        return jnp.sum(out ** 2), out

    args = [jnp.asarray(inp[k]) for k in ("x", "w", "ib", "ob")]
    (_, out), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2, 3), has_aux=True))(*args)
    return np.asarray(out), [np.asarray(g) for g in grads]


def _kernel_runs(work):
    inp = _kernel_inputs()
    np.savez(work / "kernel.npz", **inp)
    (work / "cases.json").write_text(json.dumps(KERNEL_CASES))
    ref = {c[0]: _jax_kernel(inp, *c[1:]) for c in KERNEL_CASES}
    _launch(KERNEL_WORKER, 4, work)
    return dict(ref=ref, ranks=[dict(np.load(work / f"kernel_rank{r}.npz")) for r in range(4)])


def _index(rank, axes):
    """A rank's piece index along `axes` of the 2 x 2 mesh (d0 major)."""
    coords = dict(zip(("d0", "d1"), divmod(rank, 2)))
    i = 0
    for a in axes:
        i = i * 2 + coords[a]
    return i


@pytest.fixture(scope="module")
def kernel(tmp_path_factory):
    return once_per_session(tmp_path_factory, "ulysses_kernel", _kernel_runs)


@pytest.mark.parametrize("case", KERNEL_CASES, ids=[c[0] for c in KERNEL_CASES])
def test_ulysses_matches_the_jax_all_to_all_schedule(kernel, case):
    name, _, seq_axes, head_axes, bias = case
    out_ref, (gx_ref, gw_ref, gib_ref, gob_ref) = kernel["ref"][name]
    ranks = kernel["ranks"]
    sp, tp = 2 ** len(seq_axes), 2 ** len(head_axes)
    seq_of = [_index(r, seq_axes) for r in range(4)]
    head_of = [_index(r, head_axes) for r in range(4)]
    # the output: every rank of a sequence block holds it whole
    out = np.concatenate([next(ranks[r][f"{name}_out"] for r in range(4) if seq_of[r] == i)
                          for i in range(sp)], axis=1)
    np.testing.assert_allclose(out, out_ref, rtol=2e-5, atol=2e-5)
    # the input's gradient: its block's heads' shares summed
    gx = np.concatenate([sum(ranks[r][f"{name}_gx"] for r in range(4) if seq_of[r] == i)
                         for i in range(sp)], axis=1)
    np.testing.assert_allclose(gx, gx_ref, rtol=2e-5, atol=2e-5)
    # the weight's: its head block's sequence shares summed
    gw = np.concatenate([sum(ranks[r][f"{name}_gw"] for r in range(4) if head_of[r] == j)
                         for j in range(tp)], axis=1)
    np.testing.assert_allclose(gw, gw_ref, rtol=2e-5, atol=2e-5)
    if bias:
        np.testing.assert_allclose(sum(ranks[r][f"{name}_gib"] for r in range(4)), gib_ref,
                                   rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(sum(ranks[r][f"{name}_gob"] for r in range(4)
                                       if head_of[r] == 0), gob_ref, rtol=2e-5, atol=2e-5)
    for r in range(4):
        # q, k and v in and the context out; their gradients back
        np.testing.assert_array_equal(ranks[r][f"{name}_a2a"], [4, 4])


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_unsharded_seq_is_the_dense_attention(causal):
    inp = _kernel_inputs()
    attrs = UlyssesAttentionAttrs(embed_dim=32, num_heads=8, causal=causal)
    ref = jax_ulysses(JUlysses(embed_dim=32, num_heads=8, causal=causal),
                      *(jnp.asarray(inp["x"]),) * 3, jnp.asarray(inp["w"]), None, None)
    dense = jax_mha_forward(JUlysses(embed_dim=32, num_heads=8, causal=causal),
                            *(jnp.asarray(inp["x"]),) * 3, jnp.asarray(inp["w"]), causal=causal)
    x = torch.from_numpy(inp["x"])
    got = ulysses_mha_forward(attrs, x, x, x, torch.from_numpy(inp["w"]))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(dense), rtol=1e-5, atol=1e-5)


# --- the trainer -------------------------------------------------------------------------


def _jax_train(cfg, init, x, y):
    n = cfg["data_parallel_degree"] * cfg["sequence_parallel_degree"]
    mm = JaxMesh.for_devices(n, devices=jax.devices()[:n])
    pcg, logits = jax_build(JaxConfig(**cfg))
    inst = JaxDTI(_ulysses(pcg, "flexflow_tpu"), logits, JaxSCCE(), JaxAdam(alpha=1e-3), mm)
    placed, opt = inst.initialize(seed=0)
    params = {k: jax.device_put(jnp.asarray(init[k]), v.sharding) for k, v in placed.items()}
    xs, ys = inst.input_sharding("x"), inst.label_sharding()
    xj = jax.device_put(jnp.asarray(x), xs) if xs is not None else jnp.asarray(x)
    yj = jax.device_put(jnp.asarray(y), ys) if ys is not None else jnp.asarray(y)
    with mm.mesh:
        grads = jax.jit(jax.grad(lambda p, x, y: inst.loss_fn(p, {"x": x}, y)[0]))(params, xj, yj)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": xj}, yj)
        losses.append(float(loss))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()})


def _train_runs(work, dp, sp, heads):
    cfg = dict(SMALL, data_parallel_degree=dp, sequence_parallel_degree=sp, num_heads=heads)
    pcg, _ = jax_build(JaxConfig(**cfg))
    init = {k: np.array(v) for k, v in jax_init_pcg_params(pcg, jax.random.PRNGKey(0)).items()}
    rs = np.random.RandomState(0)
    x = rs.randn(cfg["batch_size"], cfg["sequence_length"], cfg["num_features"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab_size"], (cfg["batch_size"], cfg["sequence_length"])).astype(np.int32)
    np.savez(work / "inputs.npz", x=x, y=y, **init)
    (work / "relabel.py").write_text(RELABEL)
    _launch(TRAIN_WORKER, dp * sp, work, json.dumps(cfg))
    ranks = []
    for r in range(dp * sp):
        z = dict(np.load(work / f"rank{r}.npz"))
        ranks.append(dict(json.load(open(work / f"rank{r}.json")), losses=list(z["losses"]),
                          grads={k[5:]: v for k, v in z.items() if k.startswith("grad_")},
                          params={k[6:]: v for k, v in z.items() if k.startswith("param_")}))
    return dict(cfg=cfg, init=init, jax=_jax_train(cfg, init, x, y), ranks=ranks)


@pytest.fixture(scope="module", params=[(1, 2, 2), (2, 2, 4)], ids=["sp2_heads128", "dp2xsp2_heads64"])
def runs(request, tmp_path_factory):
    dp, sp, heads = request.param
    return once_per_session(tmp_path_factory, f"ulysses_dp{dp}_sp{sp}",
                            lambda work: _train_runs(work, dp, sp, heads))


def test_the_a2a_trainer_matches_the_jax_trainer(runs):
    ref = runs["jax"]
    for rank in runs["ranks"]:
        np.testing.assert_allclose(rank["losses"], ref["losses"], rtol=1e-5)
        for k, g in ref["grads"].items():
            assert _rel(rank["grads"][k], g) < 1e-5, k
        for k, v in ref["params"].items():
            moved = np.linalg.norm(v - runs["init"][k])
            assert np.linalg.norm(rank["params"][k] - v) <= 1e-3 * moved, k


def test_a_ulysses_plan_runs_no_ring_and_four_all_to_alls_each_way(runs):
    """Fault C7: the Ulysses nodes took the ring schedule. Now each runs
    its all-to-alls, 4 forward and 4 backward, and nothing of the ring."""
    layers = runs["cfg"]["num_layers"]
    for rank in runs["ranks"]:
        assert rank["a2a_nodes"] == layers and rank["ring_nodes"] == 0
        assert rank["ring_calls"] == 0 and rank["ring_steps"] == 0
        assert rank["predicted"]["all_to_all"] == 8 * layers
        for step in rank["per_step"]:
            assert step == rank["predicted"]
