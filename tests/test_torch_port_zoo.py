"""The example zoo on the PyTorch port against the JAX package, in f32 on
the CPU.

- The model zoo (models.bert with heads of 256, transformer, candle_uno,
  inception_v3 at batch 1, split_test): built in both packages, the same
  op sequence and the same weight keys and shapes; the JAX parameters
  carried in with interop.params_from_numpy and one SGD step taken by each
  package's ModelTrainingInstance: loss and updated parameters within 1e-5
  relative. Inception-V3 steps in f64 in both packages: at batch 1 its
  global average pool hands every channel a constant gradient, which each
  BatchNorm's backward cancels to roundoff, so its f32 gradients differ
  from the f64 ones by up to 4% in either package alone (the first conv's);
  in f64 the two packages agree to ~3e-8.
- The CNN examples' nets (AlexNet-, ResNet- and ResNeXt-style blocks with
  batch norm at test sizes) built through both FFModels, the state carried
  with ffmodel_state_from_numpy, one batch fit: equal PerfMetrics counts
  and parameters within 1e-5.
- FFConfig.from_args of the port's add_args equal to the JAX parser's for
  every argv of tests/test_examples.py.
- Each port example's main(..., "--device", "cpu") at
  tests/test_examples.py's sizes runs and prints THROUGHPUT or a loss.
"""

import argparse
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import core as jcore
from flexflow_tpu import models as jmodels
from flexflow_tpu.local_execution import ModelTrainingInstance as JaxInstance
from flexflow_tpu.local_execution.config import FFConfig as JaxFFConfig
from flexflow_tpu.local_execution.training_backing import init_params as jax_init_params
from flexflow_tpu.local_execution.training_backing import make_optimizer_state
from flexflow_tpu.op_attrs.ops import loss_functions as jloss_attrs
from flexflow_tpu.pcg.optimizer import SGDOptimizerAttrs as JaxSGD
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch import models as tmodels
from flexflow_tpu_torch.examples import SMOKE_ARGV
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, params_from_numpy, params_to_numpy
from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.local_execution.config import FFConfig
from flexflow_tpu_torch.local_execution.training_backing import param_key, weight_nodes
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.pcg.optimizer import SGDOptimizerAttrs

LR = 0.05


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30)


# -- the model zoo -------------------------------------------------------------


def _bert(m):
    return m.build_bert(m.BertConfig(
        vocab_size=512, hidden_size=256, num_encoder_layers=2, num_heads=1,
        dim_feedforward=256, hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
        sequence_length=64, batch_size=2))


def _transformer(m):
    return m.build_transformer(m.TransformerConfig(
        num_features=64, sequence_length=16, batch_size=2, dim_feedforward=128, num_heads=2,
        num_encoder_layers=1, num_decoder_layers=1, dropout=0.0, vocab_size=32))


def _candle_uno(m):
    return m.build_candle_uno(m.CandleUnoConfig(
        batch_size=4, dense_layers=(32,) * 2, dense_feature_layers=(32,) * 2, dropout=0.0))


def _inception(m):
    return m.build_inception_v3(m.InceptionV3Config(batch_size=1, num_classes=8,
                                                    aux_logits=False))[:2]


def _split_test(m):
    return m.build_split_test(4)


ZOO = {
    # name: (builder, inputs {name: shape}, label (shape, classes) or None for MSE)
    "bert": (_bert, {"input": (2, 64, 256)}, ((2, 64), 512)),
    "transformer": (_transformer, {"input": (2, 16, 64), "target": (2, 16, 64)}, ((2, 16), 32)),
    "candle_uno": (_candle_uno, None, None),
    "inception_v3": (_inception, {"input": (1, 3, 299, 299)}, ((1,), 8)),  # in f64
    "split_test": (_split_test, {"input": (4, 256)}, ((4,), 32)),
}


def _inputs_and_label(name, cfg_inputs, label, rs):
    if name == "candle_uno":
        ucfg = tmodels.CandleUnoConfig()
        shapes = dict(ucfg.feature_shapes)
        inputs = {n: rs.randn(4, shapes[kind]).astype(np.float32)
                  for n, kind in ucfg.input_features}
        return inputs, rs.rand(4, 1).astype(np.float32)
    inputs = {n: rs.randn(*s).astype(np.float32) for n, s in cfg_inputs.items()}
    shape, classes = label
    return inputs, rs.randint(0, classes, shape).astype(np.int32)


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_model_matches_the_jax_model_after_one_sgd_step(name):
    build, cfg_inputs, label = ZOO[name]
    jcg, jout = build(jmodels)
    tcg, tout = build(tmodels)
    jnodes, tnodes = jcg.topological_ordering(), tcg.topological_ordering()
    assert [type(jcg.op_attrs(n)).__name__ for n in jnodes] == \
        [type(tcg.op_attrs(n)).__name__ for n in tnodes]
    tshapes = {param_key(n): tcg.tensor_shape(tcg.outputs_of(n)[0]).dims
               for n in weight_nodes(tcg)}

    # the JAX parameters, initialized in one jitted program
    init = jax.jit(lambda key: jax_init_params(jcg, key))(jax.random.PRNGKey(0))
    f64 = name == "inception_v3"
    dtype = np.float64 if f64 else np.float32
    init = {k: np.asarray(v).astype(dtype) for k, v in init.items()}
    assert {k: v.shape for k, v in init.items()} == tshapes

    loss = "sparse_categorical_crossentropy" if label else "mean_squared_error"
    jl = jloss_attrs.loss_attrs_for(jloss_attrs.LossFunction(loss))
    tl = tattrs.loss_attrs_for(tattrs.LossFunction(loss))
    rs = np.random.RandomState(len(name))
    inputs, y = _inputs_and_label(name, cfg_inputs, label, rs)
    inputs = {k: v.astype(dtype) for k, v in inputs.items()}

    with jax.enable_x64(f64):
        jinst = JaxInstance(jcg, jout, jl, JaxSGD(lr=LR))
        jparams = {k: jnp.asarray(v) for k, v in init.items()}
        jparams, _, jloss, _ = jinst.train_step(
            jparams, make_optimizer_state(JaxSGD(lr=LR), jparams), inputs, y)
        want = {k: np.asarray(v) for k, v in jparams.items()}
        assert all(v.dtype == dtype for v in want.values())

    tinst = ModelTrainingInstance(tcg, tout, tl, SGDOptimizerAttrs(lr=LR), device="cpu",
                                  compute_dtype=torch.float64 if f64 else None)
    tparams = {k: v.to(torch.float64 if f64 else torch.float32)
               for k, v in params_from_numpy(tcg, init, "cpu").items()}
    _, opt_state = tinst.initialize(seed=0)
    tparams, _, tloss, _ = tinst.train_step(tparams, opt_state, inputs, y)
    assert _rel(float(tloss), float(jloss)) < 1e-5
    got = params_to_numpy(tparams)
    for k in want:
        assert _rel(got[k], want[k]) < 1e-5, k


# -- the CNN examples' nets through both FFModels ---------------------------------


def _alexnet_style(pkg, m):
    act = pkg.Activation.RELU
    x = m.create_tensor([4, 3, 32, 32], name="image")
    t = m.conv2d(x, 8, 5, 5, 2, 2, 2, 2, activation=act)
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = m.conv2d(t, 16, 3, 3, 1, 1, 1, 1, activation=act)
    t = m.pool2d(t, 3, 3, 2, 2, 0, 0)
    t = m.flat(t)
    t = m.dense(t, 32, activation=act)
    return m.softmax(m.dense(t, 5))


def _resnet_style(pkg, m):
    x = m.create_tensor([4, 3, 16, 16], name="image")
    t = m.conv2d(x, 8, 7, 7, 2, 2, 3, 3)
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
    for stride, cin in ((1, 8), (2, 16)):  # bottleneck blocks, the second with a strided shortcut
        b = m.conv2d(t, 4, 1, 1, 1, 1, 0, 0)
        b = m.batch_norm(m.conv2d(b, 4, 3, 3, stride, stride, 1, 1))
        b = m.conv2d(b, 16, 1, 1, 1, 1, 0, 0)
        short = t if cin == 16 and stride == 1 else m.conv2d(t, 16, 1, 1, stride, stride, 0, 0)
        t = m.relu(m.add(short, b))
    t = m.pool2d(t, t.dims[2], t.dims[3], 1, 1, 0, 0, pool_type="avg")
    return m.dense(m.flat(t), 5)


def _resnext_style(pkg, m):
    act = pkg.Activation.RELU
    x = m.create_tensor([4, 3, 16, 16], name="image")
    t = m.conv2d(x, 16, 3, 3, 2, 2, 1, 1, activation=act)
    t = m.pool2d(t, 3, 3, 2, 2, 1, 1)
    b = m.conv2d(t, 16, 1, 1, 1, 1, 0, 0, activation=act)
    b = m.conv2d(b, 16, 3, 3, 1, 1, 1, 1, activation=act, groups=4)
    b = m.batch_norm(m.conv2d(b, 32, 1, 1, 1, 1, 0, 0), relu=False)
    s = m.conv2d(t, 32, 1, 1, 1, 1, 0, 0, activation=act)
    t = m.concat([m.relu(m.add(s, b)), t], axis=1)
    t = m.pool2d(t, t.dims[2], t.dims[3], 1, 1, 0, 0, pool_type="avg")
    return m.dense(m.flat(t), 5)


@pytest.mark.parametrize("net", [_alexnet_style, _resnet_style, _resnext_style])
def test_cnn_nets_fit_like_the_jax_ffmodel(net):
    models = []
    for pkg in (jcore, tcore):
        cfg = pkg.FFConfig(batch_size=4, epochs=1, print_freq=0, max_devices=1)
        m = pkg.FFModel(cfg, **({"device": "cpu"} if pkg is tcore else {}))
        net(pkg, m)
        m.compile(pkg.SGDOptimizer(lr=LR, momentum=0.9), "sparse_categorical_crossentropy",
                  metrics=["accuracy", "sparse_categorical_crossentropy"])
        models.append(m)
    jm, tm = models
    init = jax.tree_util.tree_map(np.asarray, jm.params)
    ffmodel_state_from_numpy(tm, init, jax.tree_util.tree_map(np.asarray, jm.opt_state))
    rs = np.random.RandomState(7)
    shape = [4] + list(tm.cg.tensor_shape(tm.cg.outputs_of(
        tm.cg.topological_ordering()[0])[0]).dims[1:])
    xs = rs.randn(*shape).astype(np.float32)
    ys = rs.randint(0, 5, 4)
    jperf = jm.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
    tperf = tm.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
    assert (tperf.train_all, tperf.train_correct) == (jperf.train_all, jperf.train_correct)
    np.testing.assert_allclose(tperf.sparse_cce_loss, jperf.sparse_cce_loss, rtol=1e-5)
    got = params_to_numpy(tm.params)
    for k, v in jax.tree_util.tree_map(np.asarray, jm.params).items():
        # atol: a conv bias right before a BatchNorm gets a gradient that is
        # zero but for roundoff (the norm removes the mean), ~1e-9 either way
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


# -- the parsers and the examples --------------------------------------------------

# the apps the port has run at tests/test_examples.py's sizes (moe.py waits
# for A11)
EXAMPLES = [(name, list(argv)) for name, argv in SMOKE_ARGV]
JAX_ONLY_ARGV = [["-b", "8", "--steps", "2"]]


def test_smoke_argv_is_the_example_tests_argv():
    """The port's table holds tests/test_examples.py's argv of every app the
    port has, read from that file's parametrize list, so the two cannot drift."""
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "test_examples.py")
    tree = ast.parse(open(path).read())
    table = next(ast.literal_eval(d.args[1]) for node in ast.walk(tree)
                 if isinstance(node, ast.FunctionDef) for d in node.decorator_list
                 if isinstance(d, ast.Call) and d.args and ast.literal_eval(d.args[0]) == "name,args")
    reference = {(name[:-len(".py")], tuple(args)) for name, args in table}
    ported = {(name, tuple(argv)) for name, argv in SMOKE_ARGV}
    assert ported <= reference
    assert reference - ported == set()


@pytest.mark.parametrize("argv", [a for _, a in EXAMPLES] + JAX_ONLY_ARGV)
def test_from_args_equals_the_jax_parser(argv):
    configs = []
    for cls in (JaxFFConfig, FFConfig):
        p = argparse.ArgumentParser()
        cls.add_args(p)
        configs.append(dataclasses.asdict(cls.from_args(p.parse_known_args(argv)[0])))
    assert configs[1] == configs[0]


def test_every_flag_parses_with_the_jax_spelling_and_default():
    flags = []
    for cls in (JaxFFConfig, FFConfig):
        p = argparse.ArgumentParser()
        cls.add_args(p)
        flags.append(sorted((a.dest, tuple(a.option_strings), repr(a.default))
                            for a in p._actions))
    assert flags[1] == flags[0]


@pytest.mark.parametrize("name,argv", EXAMPLES)
def test_port_example_runs_on_the_cpu(name, argv, capsys):
    import importlib

    module = importlib.import_module(f"flexflow_tpu_torch.examples.{name}")
    module.main([*argv, "--device", "cpu"])
    out = capsys.readouterr().out
    assert "THROUGHPUT" in out or "loss" in out, out
