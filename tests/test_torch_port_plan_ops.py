"""The plan ops the PCG executor lowered last: the whole-tensor lowering, a
class-sharded loss and Dropout inside a plan, on 2 gloo ranks.

- `whole`: a BatchMatmul (an op no rule places) of batch-sharded operands
  and a Linear with an activation on partial sums (its input cut on the
  contraction dim). Each runs on whole values: its operands reduced and gathered, its
  outputs cut to the plan's shardings (a partial-sum output held at sum
  index 0).
- `class_sharded`: a column-parallel head whose logits reach the loss cut
  over their classes: the loss and the metrics run vocab parallel, for the
  sparse and dense cross entropies and the squared error.

Both are held against the JAX package's DistributedTrainingInstance on the
same plan on 2 virtual CPU devices (the plan reaches the JAX package as a
strategy file the port writes, the parameters as numpy arrays): losses
rtol 1e-5 per step of three Adam steps, first-step gradients 1e-5
relative, the metric sums within 1e-5 relative of numpy's on the JAX
logits.

- `dropout`: an MLP with two Dropout layers at rate 0.1 under the dp2 seed
  against the port's single-device trainer of its CG with the same seed:
  every rank's pieces of each step's masks bitwise equal to the
  single-device masks' pieces, losses rtol 1e-5, parameters after three
  steps within 1e-5 relative. (The JAX package draws from jax.random,
  which torch cannot replay, so Dropout is compared port against port.)"""

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

from flexflow_tpu.op_attrs.ops.loss_functions import LossFunction as JaxLossFunction
from flexflow_tpu.op_attrs.ops.loss_functions import NonconfigurableLossAttrs as JaxLoss
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.parallel import DistributedTrainingInstance as JaxDTI
from flexflow_tpu.parallel import MachineMesh as JaxMesh
from flexflow_tpu.parallel.executor import init_pcg_params as jax_init_pcg_params
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu.runtime.strategy import load_strategy as jax_load_strategy
from flexflow_tpu_torch.compiler.unity_algorithm import data_parallel_seed
from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.ops import BatchMatmulAttrs, ReshapeAttrs
from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import lift_to_parallel
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape
from flexflow_tpu_torch.pcg import ComputationGraphBuilder
from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
from flexflow_tpu_torch.pcg.parallel_computation_graph_builder import (
    ParallelComputationGraphBuilder,
)
from flexflow_tpu_torch.runtime.strategy import save_strategy
from test_torch_port_once import once_per_session

REPO = Path(__file__).resolve().parent.parent
STEPS = 3
BATCH, IN, CLASSES = 8, 16, 32
# (plan, loss) runs held against the JAX package
RUNS = [("whole", "sparse_categorical_crossentropy")] + [
    ("class_sharded", loss) for loss in
    ("sparse_categorical_crossentropy", "categorical_crossentropy", "mean_squared_error")]
# the metrics each loss's labels allow
METRICS = {"sparse_categorical_crossentropy": ["accuracy", "sparse_categorical_crossentropy"],
           "categorical_crossentropy": ["accuracy", "categorical_crossentropy"],
           "mean_squared_error": ["mean_squared_error"]}


def _plan(name):
    """The port PCG of plan `name`."""
    b = ParallelComputationGraphBuilder()
    if name == "class_sharded":
        x = b.create_input_tensor(lift_to_parallel(TensorShape((BATCH, IN), DataType.FLOAT)),
                                  name="x")
        h = b.dense(x, 24, activation=Activation.RELU, name="fc1")
        b.dense(b.parallel_replicate(h, 2), CLASSES, name="head")  # classes cut in 2
        return b.graph
    # a BatchMatmul of batch-sharded operands: no rule places its pieces
    x3 = b.create_input_tensor(lift_to_parallel(TensorShape((BATCH, 4, 4), DataType.FLOAT)),
                               name="x")
    xs = b.parallel_partition(x3, 0, 2)
    (h,) = b.add_layer(BatchMatmulAttrs(), [xs, xs], [], name="bmm")
    (h,) = b.add_layer(ReshapeAttrs((BATCH, IN)), [b.parallel_combine(h, 0, 2)], [],
                       name="reshape")
    # relu of the partial sums of a contraction-sharded Linear
    h = b.dense(b.parallel_partition(h, 1, 2), 24, activation=Activation.RELU, name="fc1")
    b.dense(b.parallel_reduce(h, 2), CLASSES, name="head")
    return b.graph


def _dropout_cg():
    b = ComputationGraphBuilder()
    x = b.create_input([BATCH, IN], name="x")
    h = b.dropout(b.dense(x, 24, activation=Activation.RELU, name="fc1"), 0.1, name="drop1")
    h = b.dropout(b.dense(h, 24, activation=Activation.RELU, name="fc2"), 0.1, name="drop2")
    b.dense(h, CLASSES, name="head")
    return b.graph


# One rank; argv: rank, world, work dir.
WORKER = textwrap.dedent(
    """
    import json, os, sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from flexflow_tpu_torch.interop import pcg_params_from_numpy, pcg_params_to_numpy
    from flexflow_tpu_torch.local_execution.training_backing import dropout_masks
    from flexflow_tpu_torch.op_attrs.ops import (LossFunction, NonconfigurableLossAttrs,
                                                 SparseCategoricalCrossEntropyLossAttrs)
    from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh
    from flexflow_tpu_torch.parallel import init_file_group
    from flexflow_tpu_torch.parallel.sharding import TensorSharding, local_block
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
    from flexflow_tpu_torch.runtime.strategy import load_strategy

    torch.set_num_threads(1)
    rank, world, work = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    init_file_group(os.path.join(work, "store"), rank, world, device="cpu")
    metrics_of = json.load(open(os.path.join(work, "metrics.json")))

    def loss_attrs(name):
        if name == "sparse_categorical_crossentropy":
            return SparseCategoricalCrossEntropyLossAttrs()
        return NonconfigurableLossAttrs(LossFunction(name))

    for plan, loss in json.load(open(os.path.join(work, "runs.json"))):
        pcg, mapping, _ = load_strategy(os.path.join(work, plan + ".json"))
        logits = pcg.outputs_of(pcg.topological_ordering()[-1])[0]
        mesh = MachineMesh.for_devices(world)
        inst = DistributedTrainingInstance(
            pcg, logits, loss_attrs(loss), AdamOptimizerAttrs(alpha=1e-3), mesh,
            mapping=mapping, device="cpu", metrics=frozenset(metrics_of[loss]))
        opt = inst.initialize(seed=0)[1]
        data = np.load(os.path.join(work, plan + ".npz"))
        params = pcg_params_from_numpy(pcg, inst.shardings, mesh,
                                       {k: data[k] for k in data.files if k.startswith("n")})
        x, y = data["x"], data["y_" + loss]
        mvals = {}
        _, grads = inst.loss_and_grads(params, {"x": x}, y, metrics=mvals)
        out = {f"grad_{k}": v for k, v in pcg_params_to_numpy(pcg, inst.shardings, mesh,
                                                              grads).items()}
        out.update({f"metric_{k}": np.asarray(v) for k, v in mvals.items()})
        losses, masks = [], {}
        rng = torch.Generator().manual_seed(5)
        for step in range(3):
            state = rng.get_state()
            for n, m in dropout_masks(pcg, rng, "cpu").items():
                need = inst.plan.nodes[n].need[0]
                masks[f"mask{step}_{pcg.layer_attrs(n).name}"] = local_block(
                    m, TensorSharding(need.dims), mesh, "mask").numpy()
            rng.set_state(state)
            params, opt, loss_v, _ = inst.train_step(params, opt, {"x": x}, y, rng)
            losses.append(float(loss_v))
        out.update({f"param_{k}": v for k, v in pcg_params_to_numpy(pcg, inst.shardings, mesh,
                                                                    params).items()})
        np.savez(os.path.join(work, f"{plan}_{loss}_rank{rank}.npz"), losses=np.array(losses),
                 meta=json.dumps(dict(whole={str(n.idx): why for n, why in
                                             inst.plan.whole_nodes.items()},
                                      class_axes=list(inst.class_axes),
                                      coords={a: int(c) for a, c in mesh.coords.items()})),
                 **out, **masks)
    dist.destroy_process_group()
    """
)


def _data():
    rs = np.random.RandomState(0)
    x = rs.randn(BATCH, IN).astype(np.float32)
    sparse = rs.randint(0, CLASSES, BATCH).astype(np.int32)
    return x, {"sparse_categorical_crossentropy": sparse,
               "categorical_crossentropy": np.eye(CLASSES, dtype=np.float32)[sparse],
               "mean_squared_error": rs.randn(BATCH, CLASSES).astype(np.float32)}


def _jax_loss(name):
    if name == "sparse_categorical_crossentropy":
        return JaxSCCE()
    return JaxLoss(JaxLossFunction(name))


def _jax_run(path, loss, init, x, y):
    pcg, mapping, _ = jax_load_strategy(str(path))
    sink = pcg.outputs_of(pcg.topological_ordering()[-1])[0]
    mm = JaxMesh.for_devices(2, devices=jax.devices()[:2])
    inst = JaxDTI(pcg, sink, _jax_loss(loss), JaxAdam(alpha=1e-3), mm, mapping=mapping)
    placed, opt = inst.initialize(seed=0)
    params = {k: jax.device_put(jnp.asarray(init[k]), v.sharding) for k, v in placed.items()}
    xj, yj = jnp.asarray(x), jnp.asarray(y)
    with mm.mesh:
        grads = jax.jit(jax.grad(lambda p, x, y: inst.loss_fn(p, {"x": x}, y)[0]))(params, xj, yj)
        logits = np.asarray(jax.jit(lambda p, x: inst.loss_fn(p, {"x": x}, yj)[1])(params, xj))
    losses = []
    for _ in range(STEPS):
        params, opt, loss_v, _ = inst.train_step(params, opt, {"x": xj}, yj)
        losses.append(float(loss_v))
    return dict(losses=losses, grads={k: np.asarray(g) for k, g in grads.items()},
                params={k: np.asarray(v) for k, v in params.items()}, logits=logits)


def _launch(work, world):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(r), str(world), str(work)],
                              cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    for proc in procs:
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err


def _build(work):
    x, labels = _data()
    ref = {}
    for plan in ("whole", "class_sharded"):
        pcg = _plan(plan)
        save_strategy(str(work / f"{plan}.json"), pcg, None)
        jp, _, _ = jax_load_strategy(str(work / f"{plan}.json"))
        init = {k: np.array(v) for k, v in jax_init_pcg_params(jp, jax.random.PRNGKey(0)).items()}
        xin = x.reshape(BATCH, 4, 4) if plan == "whole" else x
        np.savez(work / f"{plan}.npz", x=xin, **{f"y_{k}": v for k, v in labels.items()},
                 **init)
        ref[plan] = dict(init=init, pcg=pcg, x=xin)
    # the dropout plan: the dp2 seed of the CG, against the CG's own trainer
    cg = _dropout_cg()
    pcg = data_parallel_seed(pcg_from_computation_graph(cg), 2)
    save_strategy(str(work / "dropout.json"), pcg, None)
    drawn = _init_params(pcg)
    init = {f"n{n.idx}": drawn[f"n{n.idx}"].numpy() for n in pcg.topological_ordering()
            if f"n{n.idx}" in drawn}
    np.savez(work / "dropout.npz", x=x, **{f"y_{k}": v for k, v in labels.items()}, **init)
    ref["dropout"] = dict(init=init, pcg=pcg, single=_single_dropout(cg, init, x, labels))
    runs = RUNS + [("dropout", "sparse_categorical_crossentropy")]
    (work / "runs.json").write_text(json.dumps(runs))
    (work / "metrics.json").write_text(json.dumps(METRICS))
    _launch(work, 2)
    out = {}
    for plan, loss in runs:
        ranks = []
        for r in range(2):
            z = dict(np.load(work / f"{plan}_{loss}_rank{r}.npz"))
            pick = lambda pre: {k[len(pre):]: v for k, v in z.items() if k.startswith(pre)}
            ranks.append(dict(losses=list(z["losses"]), grads=pick("grad_"),
                              params=pick("param_"), metrics=pick("metric_"),
                              masks={k: v for k, v in z.items() if k.startswith("mask")},
                              **json.loads(str(z["meta"]))))
        run = dict(ranks=ranks, init=ref[plan]["init"], pcg=ref[plan]["pcg"])
        if plan == "dropout":
            run["single"] = ref[plan]["single"]
        else:
            run["jax"] = _jax_run(work / f"{plan}.json", loss, ref[plan]["init"],
                                  ref[plan]["x"], labels[loss])
            run["label"] = labels[loss]
        out[(plan, loss)] = run
    return out


def _init_params(pcg):
    from flexflow_tpu_torch.local_execution.training_backing import init_params

    return init_params(pcg, 0, "cpu")


def _single_dropout(cg, init, x, labels):
    """The port's single-device trainer of the CG: its losses, parameters
    after three steps, and each step's masks (keyed by layer name)."""
    import torch

    from flexflow_tpu_torch.local_execution.training_backing import (
        ModelTrainingInstance,
        dropout_masks,
    )
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    logits = cg.outputs_of(cg.topological_ordering()[-1])[0]
    inst = ModelTrainingInstance(cg, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                 AdamOptimizerAttrs(alpha=1e-3), device="cpu")
    # the CG's weights are the dp2 PCG's in topological order
    keys = [k for k in init]
    cg_keys = [f"n{n.idx}" for n in cg.topological_ordering()
               if type(cg.op_attrs(n)).__name__ == "WeightAttrs"]
    params = {ck: torch.tensor(init[k]) for ck, k in zip(cg_keys, keys)}
    opt = inst.initialize(seed=0)[1]
    rng = torch.Generator().manual_seed(5)
    losses, masks = [], {}
    for step in range(STEPS):
        state = rng.get_state()
        for n, m in dropout_masks(cg, rng, "cpu").items():
            masks[f"mask{step}_{cg.layer_attrs(n).name}"] = m.numpy()
        rng.set_state(state)
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x},
                                               labels["sparse_categorical_crossentropy"], rng)
        losses.append(float(loss))
    return dict(losses=losses, masks=masks,
                params={k: params[ck].numpy() for ck, k in zip(cg_keys, keys)})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return once_per_session(tmp_path_factory, "plan_ops", _build)


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("run", RUNS, ids=[f"{p}-{l}" for p, l in RUNS])
def test_losses_match_per_step(runs, run):
    r = runs[run]
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["losses"], r["jax"]["losses"], rtol=1e-5)


@pytest.mark.parametrize("run", RUNS, ids=[f"{p}-{l}" for p, l in RUNS])
def test_first_step_gradients_match(runs, run):
    r = runs[run]
    want = r["jax"]["grads"]
    for rank in r["ranks"]:
        assert rank["grads"].keys() == want.keys()
        for k, g in want.items():
            assert _rel(rank["grads"][k], g) < 1e-5, k


def test_whole_tensor_nodes_are_named_and_counted(runs):
    """The BatchMatmul with no rule and the activation on partial sums run
    on whole values; the plan lists them with why."""
    for rank in runs[RUNS[0]]["ranks"]:
        whys = sorted(rank["whole"].values())
        assert len(whys) == 2, whys
        assert any("an activation on a partial sum" in w for w in whys)
        assert any("no rule places this op's pieces" in w for w in whys)


@pytest.mark.parametrize("run", RUNS[1:], ids=[l for _, l in RUNS[1:]])
def test_class_sharded_metrics_are_the_whole_logits(runs, run):
    """The metrics of logits cut over their classes, summed over the class
    ranks (the argmax across shards), against numpy on the JAX logits."""
    r = runs[run]
    logits, label = r["jax"]["logits"].astype(np.float64), r["label"]
    lse = np.log(np.exp(logits - logits.max(-1, keepdims=True)).sum(-1)) + logits.max(-1)
    want = {"train_all": BATCH}
    if run[1] == "mean_squared_error":
        want["mse_loss"] = ((logits - label) ** 2).sum()
    elif label.ndim == 1:
        want["train_correct"] = (logits.argmax(-1) == label).sum()
        want["sparse_cce_loss"] = (lse - logits[np.arange(BATCH), label]).sum()
    else:
        want["train_correct"] = (logits.argmax(-1) == label.argmax(-1)).sum()
        want["cce_loss"] = (lse * label.sum(-1) - (label * logits).sum(-1)).sum()
    for rank in r["ranks"]:
        assert rank["class_axes"]
        for k, v in want.items():
            got = rank["metrics"][k]
            np.testing.assert_allclose(got, v, rtol=1e-5, err_msg=k)


def test_dropout_masks_are_the_single_devices(runs):
    """Each rank's pieces of every step's masks are the single-device
    trainer's, bitwise (the dp2 plan cuts them by rows)."""
    r = runs[("dropout", "sparse_categorical_crossentropy")]
    want = r["single"]["masks"]
    assert len(want) == 2 * STEPS
    for i, rank in enumerate(r["ranks"]):
        assert rank["masks"].keys() == want.keys()
        for k, m in want.items():
            piece = np.split(m, 2, axis=0)[rank["coords"][next(iter(rank["coords"]))]]
            assert np.array_equal(rank["masks"][k], piece), k


def test_dropout_plan_trains_as_the_single_device(runs):
    r = runs[("dropout", "sparse_categorical_crossentropy")]
    single = r["single"]
    for rank in r["ranks"]:
        np.testing.assert_allclose(rank["losses"], single["losses"], rtol=1e-5)
        for k, want in single["params"].items():
            assert _rel(rank["params"][k], want) < 1e-5, k


def test_dropout_order_keys_layers_by_name():
    """Named Dropouts draw in the order of their names, whatever the
    topological order, then the unnamed ones in topological order."""
    from flexflow_tpu_torch.local_execution.training_backing import dropout_order

    b = ComputationGraphBuilder()
    x = b.create_input([BATCH, IN], name="x")
    h = b.dropout(x, 0.1, name="b")
    h = b.dropout(h, 0.1)
    h = b.dropout(h, 0.1, name="a")
    h = b.dropout(h, 0.0, name="off")
    order = [b.graph.layer_attrs(n).name for n in dropout_order(b.graph)]
    assert order == ["a", "b", None]
