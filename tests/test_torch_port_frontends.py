"""The port's model frontends (flexflow_tpu_torch.frontends) on the CPU,
against the JAX package's (flexflow_tpu.frontends): the torch.fx route and
its .ffir files, the small flagship imported from an .ffir file, the Keras
API (every case of tests/test_keras_frontend.py) and the ONNX import (every
case of tests/test_onnx_frontend.py).

Parameters go from the JAX model to the port's as numpy through
`interop.ffmodel_state_from_numpy`; where losses are compared, Dropout runs
at rate 0 and the fits do not shuffle. Bounds: the port within 1e-5 of the
JAX package, an imported forward within 1e-4 of the torch module's own.

On the CPU the JAX FFModel's attention takes its dense path: its flash gate
(`flash_attention_supported`) admits only TPU backends, and the small
flagship's seq 32 is below the Pallas kernels' 128-row blocks. The port's
flash wrappers run their plain versions on CPU tensors. The kernels
themselves are held against the Pallas kernels in interpret mode in
tests/test_torch_port_fwd.py and test_torch_port_bwd.py."""

from __future__ import annotations

import os
import pickle
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.nn as nn

from flexflow_tpu import core as jcore
from flexflow_tpu.frontends import keras_datasets as jkd
from flexflow_tpu.frontends import keras_model as jk
from flexflow_tpu.frontends import onnx_protobuf as jpb
from flexflow_tpu.frontends import torch_model as jtm
from flexflow_tpu.frontends.onnx_model import ONNXModel as JONNXModel
from flexflow_tpu.op_attrs.ops import WeightAttrs as JWeightAttrs
from flexflow_tpu.pcg.computation_graph_builder import ComputationGraphBuilder as JBuilder
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.frontends import keras_datasets as tkd
from flexflow_tpu_torch.frontends import keras_model as tk
from flexflow_tpu_torch.frontends import onnx_protobuf as tpb
from flexflow_tpu_torch.frontends import torch_model as ttm
from flexflow_tpu_torch.frontends.onnx_model import ONNXModel as TONNXModel
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.models import build_flagship_cg, build_flagship_ir
from flexflow_tpu_torch.op_attrs.core import OperatorType, op_type_of
from flexflow_tpu_torch.op_attrs.ops import WeightAttrs as TWeightAttrs
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TBuilder

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "tiny_mlp.onnx")
METRICS = ["accuracy", "sparse_categorical_crossentropy"]
PORT_TOL = 1e-5
TORCH_TOL = 1e-4


def _cfg(pkg, **kw):
    """One device in both packages (the JAX tests see 8 virtual devices)."""
    return pkg.FFConfig(**dict(dict(batch_size=8, epochs=1, print_freq=0, max_devices=1,
                                    seed=0), **kw))


def _dev(pkg):
    return {"device": "cpu"} if pkg in (tcore, tk) else {}


def _jax_numpy(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _carry(jm, tm):
    """The JAX model's parameters into the port's (both compiled)."""
    ffmodel_state_from_numpy(tm, _jax_numpy(jm.params))


def _assert_params_close(tm, jm, tol=PORT_TOL):
    got, want = params_to_numpy(tm.params), _jax_numpy(jm.params)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=tol, atol=tol, err_msg=k)


def _assert_perf_close(tp, jp, tol=PORT_TOL):
    assert tp.train_all == jp.train_all and tp.train_correct == jp.train_correct
    np.testing.assert_allclose(tp.sparse_cce_loss, jp.sparse_cce_loss, rtol=tol, atol=tol)


# --- the torch.fx route ---------------------------------------------------------


class MLP(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(16, 32)
        self.act = nn.ReLU()
        self.fc2 = nn.Linear(32, 8)

    def forward(self, x):
        return self.fc2(self.act(self.fc1(x)))


class ConvNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(3, 8, 3, stride=1, padding=1)
        self.pool = nn.MaxPool2d(2, 2)
        self.flatten = nn.Flatten()
        self.head = nn.Linear(8 * 8 * 8, 4)

    def forward(self, x):
        return self.head(self.flatten(self.pool(torch.relu(self.conv(x)))))


class ResidualNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(16, 16)
        self.ln = nn.LayerNorm(16)

    def forward(self, x):
        return self.ln(x + self.fc(x))


class AttentionBlock(nn.Module):
    """A post-LN block around nn.MultiheadAttention, which fx cannot map."""

    def __init__(self):
        super().__init__()
        self.attn = nn.MultiheadAttention(64, 4, batch_first=True)
        self.ln = nn.LayerNorm(64)

    def forward(self, x):
        out, _ = self.attn(x, x, x)
        return self.ln(x + out)


MODULES = {"mlp": (MLP, [[4, 16]]), "convnet": (ConvNet, [[2, 3, 16, 16]]),
           "residual": (ResidualNet, [[4, 16]])}


def _module(name):
    torch.manual_seed(0)
    cls, dims = MODULES[name]
    return cls().eval(), dims


def build_ff_from_torch(pkg, tm_mod, module, input_dims):
    """tests/test_torch_frontend.py's helper, in either package."""
    m = pkg.FFModel(_cfg(pkg, batch_size=input_dims[0][0]), **_dev(pkg))
    pt = tm_mod.PyTorchModel(module)
    ins = [m.create_tensor(d, name=f"in{i}") for i, d in enumerate(input_dims)]
    outs = pt.torch_to_ff(m, ins)
    m.compile(pkg.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
              logit_tensor=outs[0])
    return m, outs, pt.transfer_weights(m)


@pytest.mark.parametrize("name", MODULES)
def test_trace_to_ir_gives_the_jax_lines(name):
    module, _ = _module(name)
    got = [line.dumps() for line in ttm.trace_to_ir(module)]
    assert got == [line.dumps() for line in jtm.trace_to_ir(module)]
    if name == "mlp":
        assert [ttm.IRLine.loads(s).op for s in got] == [
            "input", "linear", "relu", "linear", "output"]


@pytest.mark.parametrize("name", MODULES)
def test_ffir_files_read_by_either_package(name, tmp_path):
    module, dims = _module(name)
    tpath, jpath = str(tmp_path / "port.ffir"), str(tmp_path / "jax.ffir")
    ttm.torch_to_flexflow(module, tpath)
    jtm.torch_to_flexflow(module, jpath)
    with open(tpath, "rb") as f, open(jpath, "rb") as g:
        assert f.read() == g.read()
    for pkg, tm_mod, path in ((tcore, ttm, jpath), (jcore, jtm, tpath)):
        m = pkg.FFModel(_cfg(pkg, batch_size=dims[0][0]), **_dev(pkg))
        x = m.create_tensor(dims[0], name="x")
        (out,) = tm_mod.PyTorchModel.from_file(path).apply_ir(m, [x])
        with torch.no_grad():
            want = module(torch.zeros(dims[0])).shape
        assert tuple(out.dims) == tuple(want)


@pytest.mark.parametrize("name", MODULES)
def test_imported_forward_matches_torch_and_the_jax_import(name):
    """tests/test_torch_frontend.py's TestAlignment on the port, and the
    port's imported forward against the JAX package's."""
    module, dims = _module(name)
    tm, _, tn = build_ff_from_torch(tcore, ttm, module, dims)
    jm, _, jn = build_ff_from_torch(jcore, jtm, module, dims)
    assert tn == jn > 0
    rs = np.random.RandomState(0)
    feeds = {f"in{i}": rs.randn(*d).astype(np.float32) for i, d in enumerate(dims)}
    with torch.no_grad():
        want = module(*[torch.from_numpy(v) for v in feeds.values()]).numpy()
    got = tm.instance.forward(tm.params, feeds).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=TORCH_TOL, atol=TORCH_TOL)
    np.testing.assert_allclose(got, np.asarray(jm.instance.forward(jm.params, feeds)),
                               rtol=PORT_TOL, atol=PORT_TOL)


def test_export_import_file_on_the_port(tmp_path):
    path = str(tmp_path / "mlp.ffir")
    ttm.torch_to_flexflow(MLP(), path)
    m = tcore.FFModel(_cfg(tcore, batch_size=4), device="cpu")
    x = m.create_tensor([4, 16], name="x")
    (out,) = ttm.PyTorchModel.from_file(path).apply_ir(m, [x])
    assert out.dims == (4, 8)


def test_fit_after_import_like_the_jax_import():
    """tests/test_torch_frontend.py's TestTrainImported, on both packages
    from the same weights."""
    torch.manual_seed(0)
    module = MLP()
    tm, _, _ = build_ff_from_torch(tcore, ttm, module, [[8, 16]])
    jm, _, _ = build_ff_from_torch(jcore, jtm, module, [[8, 16]])
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(32, 16).astype(np.float32), rs.randint(0, 8, 32)
    perfs = []
    for m in (tm, jm):
        p1 = m.fit(x=xs, y=ys, epochs=1, shuffle=False, verbose=False)
        p2 = m.fit(x=xs, y=ys, epochs=20, shuffle=False, verbose=False)
        assert p2.accuracy >= p1.accuracy
        perfs.append(p2)
    assert perfs[0].train_correct == perfs[1].train_correct
    _assert_params_close(tm, jm)


def test_transfer_weights_reads_a_module_through_the_host():
    """A module's parameters are read through .detach().cpu(): one whose
    tensors need a host copy (requires_grad, as here) transfers as well."""
    torch.manual_seed(0)
    module = ResidualNet()
    m, _, n = build_ff_from_torch(tcore, ttm, module, [[4, 16]])
    assert n == 4
    np.testing.assert_array_equal(m.get_parameter_by_name("fc.weight0").get_weights(),
                                  module.fc.weight.detach().numpy().T)
    np.testing.assert_array_equal(m.get_parameter_by_name("ln.weight1").get_weights(),
                                  module.ln.bias.detach().numpy())


@pytest.mark.parametrize("tm_mod", [jtm, ttm], ids=["jax", "port"])
def test_multihead_attention_trace_raises_getitem(tm_mod):
    """fx records the unpacking of nn.MultiheadAttention's (out, weights)
    as operator.getitem, which neither package maps."""
    with pytest.raises(ValueError, match="unsupported torch function: getitem"):
        tm_mod.trace_to_ir(AttentionBlock())


# --- the small flagship from an .ffir file ---------------------------------------------


SMALL = dict(batch=2, seq=32, embed=64, heads=4, layers=2, vocab=100)


def _ir_flagship(pkg, tm_mod, path):
    m = pkg.FFModel(_cfg(pkg, batch_size=SMALL["batch"]), **_dev(pkg))
    x = m.create_tensor([SMALL["batch"], SMALL["seq"], SMALL["embed"]], name="x")
    (logits,) = tm_mod.PyTorchModel.from_file(path).apply_ir(m, [x])
    m.compile(pkg.AdamOptimizer(alpha=1e-3), "sparse_categorical_crossentropy",
              metrics=METRICS, logit_tensor=logits)
    return m


@pytest.fixture(scope="module")
def flagship_ffir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ffir") / "flagship.ffir")
    with open(path, "w") as f:
        for line in build_flagship_ir(**SMALL):
            f.write(line.dumps() + "\n")
    return path


def test_imported_flagship_is_build_flagship_cg_up_to_names(flagship_ffir):
    m = tcore.FFModel(_cfg(tcore, batch_size=SMALL["batch"]), device="cpu")
    x = m.create_tensor([SMALL["batch"], SMALL["seq"], SMALL["embed"]], name="x")
    ttm.PyTorchModel.from_file(flagship_ffir).apply_ir(m, [x])
    got, (want, _) = m.cg, build_flagship_cg(**SMALL)
    order = got.topological_ordering()
    assert order == want.topological_ordering()
    renamed = 0
    for n in order:
        g, w = got.layer_attrs(n), want.layer_attrs(n)
        assert g.attrs == w.attrs and got.inputs_of(n) == want.inputs_of(n)
        assert [got.tensor_attrs(v) for v in got.outputs_of(n)] == [
            want.tensor_attrs(v) for v in want.outputs_of(n)]
        if g.name != w.name:
            assert w.name is None  # only the unnamed adds and GELUs get names
            renamed += 1
    assert renamed == 3 * SMALL["layers"]


def test_ir_flagship_trains_like_the_jax_import(flagship_ffir):
    """The .ffir file through both packages' frontends: logits, then two
    Adam steps' loss and parameters, from the same parameters."""
    jm = _ir_flagship(jcore, jtm, flagship_ffir)
    tm = _ir_flagship(tcore, ttm, flagship_ffir)
    _carry(jm, tm)
    rs = np.random.RandomState(0)
    b, s, e = SMALL["batch"], SMALL["seq"], SMALL["embed"]
    x = rs.randn(2 * b, s, e).astype(np.float32)
    y = rs.randint(0, SMALL["vocab"], (2 * b, s)).astype(np.int32)
    got = tm.instance.forward(tm.params, {"x": x[:b]}).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(jm.instance.forward(jm.params, {"x": x[:b]})),
                               rtol=PORT_TOL, atol=PORT_TOL)
    launches = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    jp = jm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    tp = tm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == launches  # plain versions on the CPU
    assert tp.train_all == 2 * b * s
    _assert_perf_close(tp, jp)
    assert int(tm.opt_state["step"]) == int(jm.opt_state["step"]) == 2
    _assert_params_close(tm, jm)


def test_port_ffir_flagship_read_by_the_jax_frontend(flagship_ffir):
    """The JAX package builds the port's .ffir flagship into the graph of
    bench.py's build_flagship_cg, up to the same names."""
    from bench import build_flagship_cg as jax_build_flagship_cg

    m = jcore.FFModel(_cfg(jcore, batch_size=SMALL["batch"]))
    x = m.create_tensor([SMALL["batch"], SMALL["seq"], SMALL["embed"]], name="x")
    jtm.PyTorchModel.from_file(flagship_ffir).apply_ir(m, [x])
    want, _ = jax_build_flagship_cg(**SMALL)
    order = m.cg.topological_ordering()
    assert order == want.topological_ordering()
    assert [m.cg.layer_attrs(n).attrs for n in order] == [want.layer_attrs(n).attrs
                                                          for n in order]


# --- Keras -------------------------------------------------------------------------------


def _weights(cg, weight_attrs):
    return [n for n in cg.topological_ordering()
            if isinstance(cg.layer_attrs(n).attrs, weight_attrs)]


def _keras_pair(build, batch_size, optimizer=("SGD", 0.05), metrics=METRICS):
    """The same Keras model in both packages, compiled, the port's
    parameters carried from the JAX model's."""
    models = []
    for k, pkg in ((jk, jcore), (tk, tcore)):
        model = build(k, dict(ffconfig=_cfg(pkg, batch_size=batch_size), **_dev(k)))
        model.compile(optimizer=getattr(k, optimizer[0])(optimizer[1]),
                      loss="sparse_categorical_crossentropy", metrics=metrics,
                      batch_size=batch_size)
        model._materialize()
        models.append(model)
    jmodel, tmodel = models
    _carry(jmodel.ffmodel, tmodel.ffmodel)
    return jmodel, tmodel


def _mnist_mlp(k, kw):
    return k.Sequential([
        k.Dense(64, activation="relu", input_shape=(48,)),
        k.Dense(64, activation="relu"),
        k.Dense(10, activation="softmax"),
    ], **kw)


def _mnist_cnn(rate):
    def build(k, kw):
        return k.Sequential([
            k.Input((1, 12, 12)),
            k.Conv2D(4, 3, activation="relu"),
            k.MaxPooling2D(2),
            k.Flatten(),
            k.Dropout(rate),
            k.Dense(10, activation="softmax"),
        ], **kw)
    return build


def _two_branch(k, kw):
    inp = k.Input((16,))
    a = k.Dense(8, activation="relu")(inp)
    b = k.Dense(8, activation="tanh")(inp)
    merged = k.Concatenate(axis=1)([a, b])
    return k.Model(inputs=inp, outputs=k.Dense(4)(merged), **kw)


def _add_merge(k, kw):
    inp = k.Input((8,))
    out = k.Dense(3)(k.Add()([k.Dense(8)(inp), k.Dense(8)(inp)]))
    return k.Model(inputs=inp, outputs=out, **kw)


def _functional_reuse(k, kw):
    inp = k.Input((8,))
    d = k.Dense(8)
    return k.Model(inputs=inp, outputs=k.Dense(3)(k.Add()([d(inp), d(inp)])), **kw)


def _sequential_reuse(k, kw):
    d = k.Dense(8, input_shape=(8,))
    return k.Sequential([d, d, k.Dense(3)], **kw)


def _callbacks_model(k, kw):
    return k.Sequential([k.Dense(16, activation="relu", input_shape=(8,)), k.Dense(4)], **kw)


def test_keras_mnist_mlp_like_the_jax_package():
    """TestSequentialMLP.test_mnist_mlp_shape on both packages."""
    jmodel, tmodel = _keras_pair(_mnist_mlp, 16)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(64, 48).astype(np.float32), rs.randint(0, 10, 64)
    for model in (jmodel, tmodel):
        model.p1 = model.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
        model.p2 = model.fit(xs, ys, epochs=25, shuffle=False, verbose=False)
        assert model.p2.accuracy > model.p1.accuracy
    _assert_perf_close(tmodel.p1, jmodel.p1)
    _assert_perf_close(tmodel.p2, jmodel.p2)
    _assert_params_close(tmodel.ffmodel, jmodel.ffmodel)
    ev = tmodel.evaluate(xs, ys)
    assert ev.train_all == 64 and ev.train_correct == jmodel.evaluate(xs, ys).train_correct
    preds = tmodel.predict(xs)
    assert preds.shape == (64, 10)
    np.testing.assert_allclose(preds, jmodel.predict(xs), rtol=PORT_TOL, atol=PORT_TOL)
    assert tmodel.summary() == jmodel.summary() == "Dense\nDense\nDense"


def test_keras_mnist_cnn_builds_and_fits():
    """TestSequentialMLP.test_mnist_cnn_builds on the port (Dropout 0.25,
    shuffled)."""
    model = _mnist_cnn(0.25)(tk, dict(device="cpu"))
    model.compile(optimizer=tk.Adam(0.01), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], batch_size=8)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(16, 1, 12, 12).astype(np.float32), rs.randint(0, 10, 16)
    assert model.fit(xs, ys, epochs=2, verbose=False).train_all == 32


def test_keras_mnist_cnn_like_the_jax_package():
    jmodel, tmodel = _keras_pair(_mnist_cnn(0.0), 8, optimizer=("Adam", 0.01))
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(16, 1, 12, 12).astype(np.float32), rs.randint(0, 10, 16)
    perfs = [m.fit(xs, ys, epochs=2, shuffle=False, verbose=False) for m in (jmodel, tmodel)]
    _assert_perf_close(perfs[1], perfs[0])
    _assert_params_close(tmodel.ffmodel, jmodel.ffmodel)


def test_keras_onnx_file_loads_without_package():
    with pytest.raises(FileNotFoundError):
        TONNXModel("nonexistent.onnx")


@pytest.mark.parametrize("build,batch,rows,dim,classes,seed",
                         [(_two_branch, 8, 16, 16, 4, 0), (_add_merge, 4, 8, 8, 3, 1)],
                         ids=["concatenate", "add"])
def test_keras_functional_like_the_jax_package(build, batch, rows, dim, classes, seed):
    """TestFunctionalModel's two-branch Concatenate model and Add merge."""
    jmodel, tmodel = _keras_pair(build, batch)
    rs = np.random.RandomState(seed)
    xs, ys = rs.randn(rows, dim).astype(np.float32), rs.randint(0, classes, rows)
    for model in (jmodel, tmodel):
        model.p1 = model.fit(xs, ys, epochs=1, shuffle=False, verbose=False)
        model.p2 = model.fit(xs, ys, epochs=25, shuffle=False, verbose=False)
    assert tmodel.p1.train_all == rows
    if build is _two_branch:
        assert tmodel.p2.accuracy > tmodel.p1.accuracy
    _assert_perf_close(tmodel.p1, jmodel.p1)
    _assert_perf_close(tmodel.p2, jmodel.p2)
    _assert_params_close(tmodel.ffmodel, jmodel.ffmodel)


@pytest.mark.parametrize("build,shared_uses", [(_functional_reuse, 2), (_sequential_reuse, 2)],
                         ids=["functional", "sequential"])
def test_keras_reused_layer_shares_its_weights_like_the_jax_package(build, shared_uses):
    """A layer applied at two call sites owns one set of parameters, and
    the gradients of both uses add up in it."""
    jmodel, tmodel = _keras_pair(build, 4)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(8, 8).astype(np.float32), rs.randint(0, 3, 8)
    perfs = [m.fit(xs, ys, epochs=2, shuffle=False, verbose=False) for m in (jmodel, tmodel)]
    assert perfs[1].train_all > 0 and np.isfinite(perfs[1].sparse_cce_loss)
    _assert_perf_close(perfs[1], perfs[0])
    _assert_params_close(tmodel.ffmodel, jmodel.ffmodel)
    tcg, jcg = tmodel.ffmodel.cg, jmodel.ffmodel.cg
    tw, jw = _weights(tcg, TWeightAttrs), _weights(jcg, JWeightAttrs)
    assert len(tw) == len(jw) == 4
    shared = next(n for n in tw if tuple(tcg.tensor_shape(tcg.outputs_of(n)[0]).dims) == (8, 8))
    assert len(tcg.uses_of(tcg.outputs_of(shared)[0])) == shared_uses


def _fit_callbacks(model, callbacks, epochs, seed=0):
    rs = np.random.RandomState(seed)
    xs, ys = rs.randn(16, 8).astype(np.float32), rs.randint(0, 4, 16)
    return model.fit(xs, ys, epochs=epochs, shuffle=False, verbose=False, callbacks=callbacks)


def test_keras_learning_rate_scheduler_like_the_jax_package():
    jmodel, tmodel = _keras_pair(_callbacks_model, 8, optimizer=("SGD", 0.1))
    seen = {}
    perfs = []
    for name, k, model in (("jax", jk, jmodel), ("port", tk, tmodel)):
        seen[name] = []

        def schedule(epoch, log=seen[name]):
            lr = 0.1 / (epoch + 1)
            log.append(lr)
            return lr

        perfs.append(_fit_callbacks(model, [k.LearningRateScheduler(schedule)], 3))
    assert seen["port"] == seen["jax"] == [0.1, 0.05, 0.1 / 3]
    assert abs(tmodel.ffmodel.optimizer_attrs.lr - 0.1 / 3) < 1e-12
    _assert_perf_close(perfs[1], perfs[0])
    _assert_params_close(tmodel.ffmodel, jmodel.ffmodel)


def test_keras_epoch_verify_metrics_early_stops():
    model = _callbacks_model(tk, dict(device="cpu"))
    model.compile(optimizer=tk.SGD(0.1), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], batch_size=8)
    _fit_callbacks(model, [tk.EpochVerifyMetrics(-1.0)], 50)
    assert model.get_perf_metrics().train_all == 16


def test_keras_verify_metrics_asserts():
    model = _callbacks_model(tk, dict(device="cpu"))
    model.compile(optimizer=tk.SGD(0.1), loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"], batch_size=8)
    with pytest.raises(AssertionError, match="Accuracy"):
        _fit_callbacks(model, [tk.VerifyMetrics(1.01)], 1)


def test_keras_set_learning_rate_and_optimizer_names():
    assert tk.SGD(0.5, momentum=0.9).attrs.momentum == 0.9
    assert tk.Adam(0.002).attrs.alpha == 0.002
    model = _callbacks_model(tk, dict(device="cpu"))
    model.compile(optimizer="adam", loss="sparse_categorical_crossentropy", batch_size=8)
    model.set_learning_rate(0.25)
    assert model.ffmodel.optimizer_attrs.alpha == 0.25


# --- the dataset loaders ------------------------------------------------------------------


@pytest.mark.parametrize("kd", [jkd, tkd], ids=["jax", "port"])
def test_missing_dataset_error_names_origin(kd, tmp_path, monkeypatch):
    monkeypatch.setenv("KERAS_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="img-datasets/mnist.npz"):
        kd.mnist.load_data()
    with pytest.raises(FileNotFoundError, match="cifar-10-python.tar.gz"):
        kd.cifar10.load_data()
    with pytest.raises(FileNotFoundError, match="text-datasets/reuters.npz"):
        kd.reuters.load_data()


def _fill_cache(root):
    ds = root / "datasets"
    ds.mkdir()
    rs = np.random.RandomState(0)
    np.savez(ds / "mnist.npz",
             x_train=rs.randint(0, 255, (8, 28, 28), dtype=np.uint8), y_train=rs.randint(0, 10, 8),
             x_test=rs.randint(0, 255, (2, 28, 28), dtype=np.uint8), y_test=rs.randint(0, 10, 2))
    cifar = ds / "cifar-10-batches-py"
    cifar.mkdir()
    for name in [f"data_batch_{i}" for i in range(1, 6)] + ["test_batch"]:
        with open(cifar / name, "wb") as f:
            pickle.dump({b"data": rs.randint(0, 255, (3, 3072), dtype=np.uint8),
                         b"labels": list(rs.randint(0, 10, 3))}, f)
    seqs = np.empty(10, dtype=object)
    for i in range(10):
        seqs[i] = list(rs.randint(0, 50, rs.randint(3, 9)))
    np.savez(ds / "reuters.npz", x=seqs, y=rs.randint(0, 46, 10))
    with open(ds / "reuters_word_index.json", "w") as f:
        f.write('{"the": 1, "of": 2}')


def test_dataset_loaders_read_the_cache_like_the_jax_loaders(tmp_path, monkeypatch):
    monkeypatch.setenv("KERAS_HOME", str(tmp_path))
    _fill_cache(tmp_path)
    (xt, yt), (xv, yv) = tkd.mnist.load_data()
    assert xt.shape == (8, 28, 28) and xv.shape == (2, 28, 28)
    calls = [lambda kd: kd.mnist.load_data(), lambda kd: kd.cifar10.load_data(),
             lambda kd: kd.reuters.load_data(),
             lambda kd: kd.reuters.load_data(num_words=20, oov_char=None),
             lambda kd: kd.reuters.get_word_index()]
    for call in calls:
        got, want = call(tkd), call(jkd)
        if isinstance(want, dict):
            assert got == want
            continue
        _assert_same_arrays(got, want)


def _assert_same_arrays(got, want):
    """Equal nested tuples of arrays, object arrays of lists included."""
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same_arrays(g, w)
    elif want.dtype == object:
        assert got.dtype == object and got.shape == want.shape
        assert [list(g) for g in got] == [list(w) for w in want]
    else:
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


# --- ONNX ------------------------------------------------------------------------------------


def node(op, inputs, outputs, name=None, **attrs):
    return SimpleNamespace(op_type=op, input=list(inputs), output=list(outputs),
                           name=name or outputs[0], attrs=attrs)


def init(name, arr):
    return SimpleNamespace(name=name, array=np.asarray(arr))


def make_model(nodes, initializers, inputs, outputs):
    g = SimpleNamespace(node=list(nodes), initializer=list(initializers),
                        input=[SimpleNamespace(name=n) for n in inputs],
                        output=[SimpleNamespace(name=n) for n in outputs])
    return SimpleNamespace(graph=g)


def build_ff(batch=4, in_dim=16):
    m = tcore.FFModel(_cfg(tcore, batch_size=batch), device="cpu")
    return m, m.create_tensor([batch, in_dim], name="x")


def graph_op_types(m):
    cg = m.cg
    return [op_type_of(cg.layer_attrs(n).attrs) for n in cg.topological_ordering()]


def _mlp_graph():
    return make_model(
        [node("MatMul", ["x", "w1"], ["mm"]), node("Add", ["mm", "b1"], ["h"]),
         node("Relu", ["h"], ["r"]), node("Gemm", ["r", "w2"], ["out"])],
        [init("w1", np.zeros((16, 32), np.float32)), init("b1", np.zeros((32,), np.float32)),
         init("w2", np.zeros((32, 8), np.float32))],
        ["x"], ["out"])


def test_onnx_mlp_chain_with_matmul_add_fusion():
    m, x = build_ff()
    (out,) = TONNXModel(_mlp_graph()).apply(m, [x])
    ops = graph_op_types(m)
    assert ops.count(OperatorType.LINEAR) == 2
    assert OperatorType.ELEMENT_BINARY not in ops
    assert tuple(out.dims) == (4, 8)


def test_onnx_elementwise_softmax_norms():
    model = make_model(
        [node("Gemm", ["x", "w"], ["h"]),
         node("LayerNormalization", ["h"], ["ln"], axis=-1, epsilon=1e-5),
         node("Sigmoid", ["ln"], ["s"]), node("Dropout", ["s"], ["d"], ratio=0.25),
         node("Softmax", ["d"], ["sm"], axis=-1)],
        [init("w", np.zeros((16, 8), np.float32))], ["x"], ["sm"])
    m, x = build_ff()
    TONNXModel(model).apply(m, [x])
    ops = graph_op_types(m)
    for expected in (OperatorType.LINEAR, OperatorType.LAYER_NORM, OperatorType.ELEMENT_UNARY,
                     OperatorType.DROPOUT, OperatorType.SOFTMAX):
        assert expected in ops, expected


def test_onnx_constant_feeds_reshape_and_unsqueeze():
    model = make_model(
        [node("Constant", [], ["shape"], value=np.array([4, 4, 4])),
         node("Reshape", ["x", "shape"], ["r"]), node("Unsqueeze", ["r"], ["u"], axes=[1]),
         node("Cast", ["u"], ["c"], to=1), node("Pad", ["c"], ["p"], pads=[0, 0, 0, 0])],
        [], ["x"], ["p"])
    m, x = build_ff()
    (out,) = TONNXModel(model).apply(m, [x])
    assert tuple(out.dims) == (4, 1, 4, 4)


def test_onnx_nonzero_pad_warns_and_passes_through():
    model = make_model([node("Pad", ["x"], ["p"], pads=[0, 1, 0, 1])], [], ["x"], ["p"])
    m, x = build_ff()
    with pytest.warns(UserWarning, match="Pad"):
        (out,) = TONNXModel(model).apply(m, [x])
    assert tuple(out.dims) == tuple(x.dims)


def test_onnx_scalar_add_and_range_constants():
    model = make_model(
        [node("Constant", [], ["two"], value=np.array(2.0)), node("Add", ["x", "two"], ["a"]),
         node("Range", ["z", "l", "d"], ["ids"])],
        [init("z", np.array(0.0)), init("l", np.array(4.0)), init("d", np.array(1.0))],
        ["x"], ["a"])
    m, x = build_ff()
    onnx_m = TONNXModel(model)
    (out,) = onnx_m.apply(m, [x])
    assert tuple(out.dims) == tuple(x.dims)
    np.testing.assert_array_equal(onnx_m._consts["ids"], np.arange(0.0, 4.0, 1.0))


def test_onnx_unsupported_op_raises():
    model = make_model([node("NonMaxSuppression", ["x"], ["y"])], [], ["x"], ["y"])
    m, x = build_ff()
    with pytest.raises(ValueError, match="unsupported onnx op"):
        TONNXModel(model).apply(m, [x])
    assert TONNXModel.SUPPORTED == JONNXModel.SUPPORTED


def test_onnx_scalar_operand_lowerings_match_the_jax_graph():
    """Sub with a constant minuend, the other scalar ops, GlobalAveragePool
    and Split: the same op sequence in both packages."""
    graphs = []
    for pkg, onnx_cls in ((jcore, JONNXModel), (tcore, TONNXModel)):
        model = make_model(
            [node("Constant", [], ["c"], value=np.array(3.0)),
             node("Sub", ["c", "x"], ["a"]), node("Mul", ["a", "c"], ["b"]),
             node("Div", ["b", "c"], ["d"]), node("Split", ["d"], ["s0", "s1"], axis=1,
                                                  split=[6, 10]),
             node("Concat", ["s1", "s0"], ["cat"], axis=1)],
            [], ["x"], ["cat"])
        m = pkg.FFModel(_cfg(pkg, batch_size=4), **_dev(pkg))
        x = m.create_tensor([4, 16], name="x")
        (out,) = onnx_cls(model).apply(m, [x])
        assert tuple(out.dims) == (4, 16)
        graphs.append([(type(m.cg.layer_attrs(n).attrs).__name__, m.cg.layer_attrs(n).name)
                       for n in m.cg.topological_ordering()])
    assert graphs[0] == graphs[1]


def _onnx_pair(model_or_path, batch, in_dim):
    models = []
    for pkg, onnx_cls in ((jcore, JONNXModel), (tcore, TONNXModel)):
        m = pkg.FFModel(_cfg(pkg, batch_size=batch), **_dev(pkg))
        x = m.create_tensor([batch, in_dim], name="x")
        (logits,) = onnx_cls(model_or_path).apply(m, [x])
        m.compile(pkg.SGDOptimizer(lr=0.05), "sparse_categorical_crossentropy", metrics=METRICS,
                  logit_tensor=logits)
        models.append(m)
    _carry(*models)
    return models


def test_onnx_import_trains_like_the_jax_package():
    """test_onnx_import_trains_end_to_end, from the same parameters (the
    graph's initializers are zeros; the compiles draw the weights)."""
    jm, tm = _onnx_pair(_mlp_graph(), 8, 16)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(32, 16).astype(np.float32), rs.randint(0, 8, (32,)).astype(np.int32)
    perfs = [m.fit(xs, ys, epochs=1, shuffle=False, verbose=False) for m in (jm, tm)]
    assert perfs[1].train_all == 32
    _assert_perf_close(perfs[1], perfs[0])
    _assert_params_close(tm, jm)


def _decoded(model):
    g = model.graph
    arrays = lambda ts: [(t.name, list(t.dims), t.array.dtype.str, t.array.tolist()) for t in ts]
    return (g.name, [(n.op_type, n.name, n.input, n.output, n.attrs) for n in g.node],
            arrays(g.initializer), [i.name for i in g.input], [o.name for o in g.output])


def test_onnx_fixture_decodes_as_in_the_jax_reader():
    got = _decoded(tpb.load_onnx_file(FIXTURE))
    assert got == _decoded(jpb.load_onnx_file(FIXTURE))
    assert got[0] == "tiny_mlp" and [n[0] for n in got[1]] == ["MatMul", "Add", "Relu", "MatMul"]
    assert _decoded(TONNXModel(FIXTURE).model) == got


def test_onnx_fixture_trains_like_the_jax_package():
    """test_serialized_protobuf_fixture_loads_and_trains on both packages."""
    jm, tm = _onnx_pair(FIXTURE, 4, 8)
    assert OperatorType.LINEAR in graph_op_types(tm)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(8, 8).astype(np.float32), rs.randint(0, 3, (8,)).astype(np.int32)
    perfs = [m.fit(xs, ys, epochs=1, shuffle=False, verbose=False) for m in (jm, tm)]
    assert perfs[1].train_all == 8
    _assert_perf_close(perfs[1], perfs[0])
    _assert_params_close(tm, jm)


def test_protobuf_reader_attribute_kinds():
    import struct

    def varint(v):
        out = b""
        while True:
            b7 = v & 0x7F
            v >>= 7
            if v:
                out += bytes([b7 | 0x80])
            else:
                return out + bytes([b7])

    def key(f, w):
        return varint((f << 3) | w)

    def ld(f, payload):
        return key(f, 2) + varint(len(payload)) + payload

    a_axis = ld(1, b"axis") + key(3, 0) + varint((1 << 64) - 1)
    a_eps = ld(1, b"eps") + key(2, 5) + struct.pack("<f", 0.5)
    a_perm = ld(1, b"perm") + ld(8, varint(1) + varint(2))
    a_zero = ld(1, b"zero") + key(20, 0) + varint(2)  # INT, value 0 omitted on the wire
    n = ld(4, b"Softmax") + ld(2, b"y") + ld(1, b"x")
    n += ld(5, a_axis) + ld(5, a_eps) + ld(5, a_perm) + ld(5, a_zero)
    g = ld(1, n) + ld(11, ld(1, b"x")) + ld(12, ld(1, b"y"))
    data = ld(7, g)
    (nd,) = tpb.load_onnx_bytes(data).graph.node
    assert nd.op_type == "Softmax"
    assert nd.attrs == {"axis": -1, "eps": 0.5, "perm": [1, 2], "zero": 0}
    assert _decoded(tpb.load_onnx_bytes(data)) == _decoded(jpb.load_onnx_bytes(data))
    with pytest.raises(ValueError, match="no graph field"):
        tpb.load_onnx_bytes(ld(1, b"x"))


# --- the builder's shared weights -----------------------------------------------------------


def _shared_graph(builder_cls):
    b = builder_cls()
    x = b.create_input([4, 8], name="x")
    mark = len(b.weight_log)
    h1 = b.dense(x, 8, name="shared")
    weights = list(b.weight_log[mark:])
    with b.reuse_weights(weights):
        h2 = b.dense(x, 8, name="shared_again")
    b.dense(b.add(h1, h2), 3, name="head")
    return b, weights


def test_builder_reuse_weights_as_the_jax_builder():
    (tb, tw), (jb, jw) = _shared_graph(TBuilder), _shared_graph(JBuilder)
    assert [w.node.idx for w in tb.weight_log] == [w.node.idx for w in jb.weight_log]
    assert len(tw) == len(jw) == 2
    tcg, jcg = tb.graph, jb.graph
    order = tcg.topological_ordering()
    assert [n.idx for n in order] == [n.idx for n in jcg.topological_ordering()]
    wiring = lambda cg: [[(v.node.idx, v.idx) for v in cg.inputs_of(n)]
                         for n in cg.topological_ordering()]
    assert wiring(tcg) == wiring(jcg)
    assert len(tcg.uses_of(tw[0])) == 2
    with pytest.raises(AssertionError, match="left unbound"):
        with tb.reuse_weights(tw + tw):
            tb.dense(tcg.outputs_of(order[0])[0], 8)
    with pytest.raises(AssertionError, match="same shape"):
        with tb.reuse_weights(tw):
            tb.dense(tcg.outputs_of(order[0])[0], 4)


def test_reused_weights_accumulate_both_gradients():
    """The shared Dense's weight gradient is the sum of its two uses': the
    port's fit from the JAX parameters ends where the JAX fit does."""
    models = []
    for pkg, builder_cls in ((jcore, JBuilder), (tcore, TBuilder)):
        b, _ = _shared_graph(builder_cls)
        m = pkg.FFModel.from_computation_graph(
            b.graph, b.graph.outputs_of(b.graph.topological_ordering()[-1])[0],
            config=_cfg(pkg, batch_size=4), **_dev(pkg))
        m.compile(pkg.SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=METRICS)
        models.append(m)
    jm, tm = models
    _carry(jm, tm)
    rs = np.random.RandomState(0)
    xs, ys = rs.randn(8, 8).astype(np.float32), rs.randint(0, 3, 8)
    perfs = [m.fit(xs, ys, epochs=2, shuffle=False, verbose=False) for m in (jm, tm)]
    _assert_perf_close(perfs[1], perfs[0])
    _assert_params_close(tm, jm)
