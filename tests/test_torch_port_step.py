"""The slice as a whole: the small flagship trained three Adam steps by
the JAX package and by the PyTorch port from the same parameters and batch,
in f32 on the CPU.

At head dim 128 the port's CPU run goes through FlashAttentionBSHF's plain
versions; the JAX package takes its dense attention on the CPU, so this
holds the two semantics against each other. Adam's first steps move every
parameter by about alpha whatever the gradient's size, so the parameters
after three steps are compared relative to how far they moved."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_flagship_cg as jax_build_flagship_cg
from flexflow_tpu.local_execution import ModelTrainingInstance as JaxInstance
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu_torch.interop import opt_state_from_numpy, params_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.local_execution import ModelTrainingInstance, init_params
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
from flexflow_tpu_torch.pcg.initializer import ConstantInitializerAttrs, GlorotUniformAttrs

SMALL = dict(batch=2, seq=128, embed=256, heads=2, layers=2, vocab=512)
STEPS = 3


def _rel(a, b):
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def runs():
    jgraph, jlogits = jax_build_flagship_cg(**SMALL)
    jinst = JaxInstance(jgraph, jlogits, JaxSCCE(), JaxAdam(alpha=1e-3))
    jparams, jopt = jinst.initialize(seed=0)
    init = {k: np.array(v) for k, v in jparams.items()}
    rs = np.random.RandomState(0)
    x = rs.randn(SMALL["batch"], SMALL["seq"], SMALL["embed"]).astype(np.float32)
    y = rs.randint(0, SMALL["vocab"], (SMALL["batch"], SMALL["seq"])).astype(np.int32)

    jgrads = jax.grad(lambda p: jinst.loss_fn(p, {"x": jnp.asarray(x)}, jnp.asarray(y))[0])(jparams)
    jlosses = []
    for _ in range(STEPS):
        jparams, jopt, loss, _ = jinst.train_step(jparams, jopt, {"x": jnp.asarray(x)}, jnp.asarray(y))
        jlosses.append(float(loss))

    graph, logits = build_flagship_cg(**SMALL)
    inst = ModelTrainingInstance(
        graph, logits, SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-3),
        device="cpu",
    )
    params = params_from_numpy(graph, init, "cpu")
    opt = inst.initialize(seed=0)[1]
    launches = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    _, grads = inst.loss_and_grads(params, {"x": x}, y)
    losses = []
    for _ in range(STEPS):
        params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
        losses.append(float(loss))
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == launches  # plain versions on the CPU
    return dict(
        init=init, jlosses=jlosses, losses=losses,
        jgrads={k: np.asarray(v) for k, v in jgrads.items()},
        grads={k: v.numpy() for k, v in grads.items()},
        jparams={k: np.asarray(v) for k, v in jparams.items()},
        params=params_to_numpy(params), opt_step=int(opt["step"]), jopt_step=int(jopt["step"]),
    )


def test_losses_match_per_step(runs):
    np.testing.assert_allclose(runs["losses"], runs["jlosses"], rtol=1e-5)


def test_first_step_gradients_match(runs):
    assert runs["grads"].keys() == runs["jgrads"].keys()
    for k, g in runs["jgrads"].items():
        assert _rel(runs["grads"][k], g) < 1e-5, k


def test_parameters_after_three_steps_match(runs):
    assert runs["opt_step"] == runs["jopt_step"] == STEPS
    for k, want in runs["jparams"].items():
        moved = np.linalg.norm(want - runs["init"][k])
        assert np.linalg.norm(runs["params"][k] - want) <= 1e-3 * moved, k


def test_init_params_follow_the_initializers():
    graph, _ = build_flagship_cg(**SMALL)
    params = init_params(graph, seed=0, device="cpu")
    again = init_params(graph, seed=0, device="cpu")
    other = init_params(graph, seed=1, device="cpu")
    for n in graph.nodes:
        key = f"n{n.idx}"
        if key not in params:
            continue
        init = graph.tensor_attrs(graph.outputs_of(n)[0]).initializer
        p = params[key]
        assert torch.equal(p, again[key])
        if isinstance(init, GlorotUniformAttrs):
            fan_in, fan_out = p.shape
            limit = np.sqrt(6.0 / (fan_in + fan_out))
            assert float(p.abs().max()) <= limit and float(p.std()) > limit / 3
            assert not torch.equal(p, other[key])
        elif isinstance(init, ConstantInitializerAttrs):  # LayerNorm gamma
            assert torch.all(p == 1.0)
        else:  # LayerNorm beta
            assert torch.all(p == 0.0)


def test_parameter_keys_line_up_with_the_jax_builder():
    jgraph, _ = jax_build_flagship_cg(**SMALL)
    graph, _ = build_flagship_cg(**SMALL)
    jweights = {
        f"n{n.idx}": jgraph.tensor_shape(jgraph.outputs_of(n)[0]).dims
        for n in jgraph.nodes if type(jgraph.op_attrs(n)).__name__ == "WeightAttrs"
    }
    weights = {k: tuple(v.shape) for k, v in init_params(graph, 0, "cpu").items()}
    assert weights == jweights


def test_interop_rejects_mismatched_state():
    graph, _ = build_flagship_cg(**SMALL)
    good = params_to_numpy(init_params(graph, 0, "cpu"))
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(graph, {k: v for k, v in good.items() if k != "n1"}, "cpu")
    with pytest.raises(ValueError, match="extra"):
        params_from_numpy(graph, dict(good, n999=np.zeros(1)), "cpu")
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(graph, dict(good, n1=good["n1"][:-1]), "cpu")
    state = opt_state_from_numpy(graph, {"m": good, "v": good, "step": np.int32(4)}, "cpu")
    assert int(state["step"]) == 4 and state["step"].dtype == torch.int32 and torch.equal(state["m"]["n1"], torch.from_numpy(good["n1"]))
