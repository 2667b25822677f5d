"""The port's FFModel (flexflow_tpu_torch.core) on the CPU: the JAX
package's FFModel spec (tests/test_ffmodel_api.py's single-device classes)
run on the port, and the port held against the JAX FFModel on the same
numpy data and state: fit, eval and the stepped forward/backward/update in
f32 within 1e-5, the batch iterator bit for bit, the losses, metrics,
softmax and dropout, and the small flagship trained three Adam steps
through both FFModels. The JAX models compile with max_devices=1, the
single-device ModelTrainingInstance the port's compile builds."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_flagship_cg as jax_build_flagship_cg
from flexflow_tpu import core as jcore
from flexflow_tpu.core.dataloader import BatchIterator as JaxBatchIterator
from flexflow_tpu.kernels import loss as jloss
from flexflow_tpu.kernels import metrics as jmetrics
from flexflow_tpu.kernels import ops as jops
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu.pcg.computation_graph_builder import ComputationGraphBuilder as JaxBuilder
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.core import Activation, AdamOptimizer, FFConfig, FFModel, SGDOptimizer
from flexflow_tpu_torch.core.dataloader import BatchIterator
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import loss as tloss
from flexflow_tpu_torch.kernels import metrics as tmetrics
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.pcg import ComputationGraphBuilder

METRICS = ["accuracy", "sparse_categorical_crossentropy"]


def _cfg(pkg, **kw):
    return pkg.FFConfig(**dict(dict(batch_size=8, epochs=1, print_freq=0, max_devices=1), **kw))


def build_mlp(cfg=None, in_dim=32, hidden=16, classes=4, pkg=tcore):
    """tests/test_ffmodel_api.py's spec MLP, in either package."""
    kw = {"device": "cpu"} if pkg is tcore else {}
    m = pkg.FFModel(cfg or _cfg(pkg), **kw)
    x = m.create_tensor([8, in_dim], name="x")
    t = m.dense(x, hidden, activation=pkg.Activation.RELU, name="fc1")
    out = m.dense(t, classes, name="out")
    return m, x, out


def _data(n, seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(n, 32).astype(np.float32), rs.randint(0, 4, n)


def _tree_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _rel(a, b):
    return np.linalg.norm(np.asarray(a) - np.asarray(b)) / max(np.linalg.norm(b), 1e-30)


# --- the spec, on the port ----------------------------------------------------


class TestBuildCompileFit:
    def test_fit_reduces_loss(self):
        m, x, out = build_mlp()
        m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy", metrics=["accuracy"])
        xs, ys = _data(64)
        first = m.fit(x=xs, y=ys, epochs=1, shuffle=False, verbose=False)
        last = m.fit(x=xs, y=ys, epochs=30, shuffle=False, verbose=False)
        assert last.accuracy >= first.accuracy
        assert last.accuracy > 0.5

    def test_eval(self):
        m, x, out = build_mlp()
        m.compile(AdamOptimizer(alpha=0.01), "sparse_categorical_crossentropy",
                  metrics=["accuracy"])
        xs, ys = _data(16)
        perf = m.eval(x=xs, y=ys, batch_size=8)
        assert perf.train_all == 16
        assert 0.0 <= perf.accuracy <= 1.0


class TestTensorRoundTrip:
    def test_get_set_weights(self):
        m, x, out = build_mlp()
        m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy")
        p = m.get_parameter_by_name("fc1.weight0")
        w = p.get_weights()
        assert w.shape == (32, 16)
        p.set_weights(m, np.zeros_like(w))
        assert np.allclose(p.get_weights(), 0.0)

    def test_tensor_dims(self):
        m, x, out = build_mlp()
        assert x.dims == (8, 32)
        assert out.dims == (8, 4)


class TestSteppedExecution:
    def test_forward_backward_update(self):
        m, x, out = build_mlp()
        m.compile(SGDOptimizer(lr=0.5), "sparse_categorical_crossentropy")
        xs, ys = _data(8)
        logits0 = m.forward({"x": xs})
        assert logits0.shape == (8, 4)
        before = m.get_parameter_by_name("fc1.weight0").get_weights()
        m.zero_gradients()
        m.backward(ys)
        m.update()
        after = m.get_parameter_by_name("fc1.weight0").get_weights()
        assert not np.allclose(before, after), "update did not change weights"

        def batch_loss():
            lg = m.forward({"x": xs})
            p = np.exp(lg - lg.max(-1, keepdims=True))
            p /= p.sum(-1, keepdims=True)
            return -np.mean(np.log(p[np.arange(8), ys] + 1e-9))

        l0 = batch_loss()
        for _ in range(10):  # backward reruns the last forward's graph, as in the JAX package
            m.zero_gradients()
            m.backward(ys)
            m.update()
        assert batch_loss() < l0


class TestGradAccumulation:
    def test_microbatch_accumulation(self):
        m, x, out = build_mlp()
        m.compile(SGDOptimizer(lr=0.0), "sparse_categorical_crossentropy")
        xs, ys = _data(8)
        m.forward({"x": xs})
        m.zero_gradients()
        m.backward(ys)
        g1 = {k: v.numpy().copy() for k, v in m._backing.param_grads.items()}
        m.forward({"x": xs})
        m.backward(ys)
        g2 = m._backing.param_grads
        for k in g1:
            assert np.allclose(g2[k].numpy(), 2 * g1[k], atol=1e-5)


# --- the port against the JAX FFModel -----------------------------------------


OPTIMIZERS = {
    "sgd_momentum": lambda pkg: pkg.SGDOptimizer(lr=0.1, momentum=0.9),
    "adam": lambda pkg: pkg.AdamOptimizer(alpha=0.01),
}


def _twins(opt, metrics=METRICS):
    """The spec MLP compiled in both packages, the port's carrying the JAX
    model's parameters and optimizer state."""
    jm, _, _ = build_mlp(pkg=jcore)
    jm.compile(OPTIMIZERS[opt](jcore), "sparse_categorical_crossentropy", metrics=metrics)
    tm, _, _ = build_mlp()
    tm.compile(OPTIMIZERS[opt](tcore), "sparse_categorical_crossentropy", metrics=metrics)
    ffmodel_state_from_numpy(tm, _tree_numpy(jm.params), _tree_numpy(jm.opt_state))
    return jm, tm


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_fit_and_eval_match_the_jax_ffmodel(opt):
    jm, tm = _twins(opt)
    xs, ys = _data(64, seed=3)
    jperf = jm.fit(xs, ys, epochs=3, shuffle=True, verbose=False)
    tperf = tm.fit(xs, ys, epochs=3, shuffle=True, verbose=False)
    assert (tperf.train_all, tperf.train_correct) == (jperf.train_all, jperf.train_correct)
    assert tperf.train_all == 3 * 64
    np.testing.assert_allclose(tperf.sparse_cce_loss, jperf.sparse_cce_loss, rtol=1e-5)
    got = params_to_numpy(tm.params)
    for k, v in _tree_numpy(jm.params).items():
        assert _rel(got[k], v) < 1e-5, k
    je, te = jm.eval(xs, ys), tm.eval(xs, ys)
    assert (te.train_all, te.train_correct) == (je.train_all, je.train_correct)
    np.testing.assert_allclose(te.sparse_cce_loss, je.sparse_cce_loss, rtol=1e-5)


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_stepped_execution_matches_the_jax_ffmodel(opt):
    jm, tm = _twins(opt)
    xs, ys = _data(8, seed=4)
    np.testing.assert_allclose(tm.forward({"x": xs}), np.asarray(jm.forward({"x": xs})),
                               rtol=1e-5, atol=1e-6)
    for m in (jm, tm):
        m.zero_gradients()
        m.backward(ys)
    g1 = {k: v.numpy().copy() for k, v in tm._backing.param_grads.items()}
    for k, v in jm._backing.param_grads.items():
        np.testing.assert_allclose(g1[k], np.asarray(v), rtol=1e-5, atol=1e-6)
    for m in (jm, tm):
        m.forward({"x": xs})
        m.backward(ys)
    for k, v in jm._backing.param_grads.items():
        got = tm._backing.param_grads[k].numpy()
        np.testing.assert_allclose(got, np.asarray(v), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got, 2 * g1[k], rtol=1e-5, atol=1e-6)
    jm.update()
    tm.update()
    got = params_to_numpy(tm.params)
    for k, v in _tree_numpy(jm.params).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6)


def test_parameter_names_and_keys_match_the_jax_ffmodel():
    jm, tm = _twins("adam")
    for name in ("fc1.weight0", "fc1.weight1", "out", "out.weight1"):
        jp, tp = jm.get_parameter_by_name(name), tm.get_parameter_by_name(name)
        assert jp.handle.node.idx == tp.handle.node.idx
        np.testing.assert_array_equal(tp.get_weights(), np.asarray(jp.get_weights()))
    assert tm.get_layers() == jm.get_layers()


def test_batch_iterator_matches_the_jax_iterator_bitwise():
    rs = np.random.RandomState(5)
    inputs = {"x": rs.randn(40, 3).astype(np.float32), "z": rs.randint(0, 9, (40, 2))}
    label = rs.randint(0, 4, 40).astype(np.int32)
    jit = JaxBatchIterator(inputs, label, 8, shuffle=True, seed=7)
    tit = BatchIterator(inputs, label, 8, device="cpu", shuffle=True, seed=7)
    for _ in range(3):
        batches = list(zip(jit, tit))
        assert len(batches) == 5
        for (jb, jl), (tb, tl) in batches:
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
            for k in inputs:
                np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))


# --- losses, metrics, softmax and dropout --------------------------------------


@pytest.mark.parametrize("fn", ["categorical_crossentropy", "mean_squared_error",
                                "mean_absolute_error", "identity"])
def test_other_losses_match_value_and_gradient(fn):
    rs = np.random.RandomState(6)
    logit = rs.randn(4, 3, 5).astype(np.float32)
    label = np.abs(rs.randn(4, 3, 5)).astype(np.float32)
    label /= label.sum(-1, keepdims=True)
    ja = jattrs.NonconfigurableLossAttrs(jattrs.LossFunction(fn))
    ta = tattrs.loss_attrs_for(tattrs.LossFunction(fn))
    ref, ref_g = jax.value_and_grad(lambda z: jloss.loss_forward(ja, z, jnp.asarray(label)))(
        jnp.asarray(logit))
    z = torch.tensor(logit, requires_grad=True)
    got = tloss.loss_forward(ta, z, torch.from_numpy(label))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(z.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)
    # a bf16 logit still gives an f32 loss
    assert tloss.loss_forward(ta, z.detach().bfloat16(), torch.from_numpy(label)).dtype == \
        torch.float32
    assert tloss.loss_grad_scale(ta, 4, 60) == jloss.loss_grad_scale(ja, 4, 60)


@pytest.mark.parametrize("chunk", [1 << 27, 26])  # one chunk; two rows a chunk
def test_compute_metrics_match(chunk, monkeypatch):
    monkeypatch.setattr(tloss, "_CHUNK_ELEMENTS", chunk)
    rs = np.random.RandomState(7)
    logit = rs.randn(3, 5, 13).astype(np.float32)
    label = rs.randint(0, 13, (3, 5))
    onehot = np.eye(13, dtype=np.float32)[label]
    names = frozenset(["accuracy", "sparse_categorical_crossentropy"])
    for lbl in (label, onehot):
        ms = names if lbl is label else frozenset(
            ["accuracy", "categorical_crossentropy", "mean_squared_error",
             "mean_absolute_error"])
        ref = jmetrics.compute_metrics(ms, jnp.asarray(logit), jnp.asarray(lbl))
        got = tmetrics.compute_metrics(ms, torch.from_numpy(logit), torch.from_numpy(lbl))
        assert set(got) == set(ref)
        assert got["train_all"] == int(ref["train_all"]) == 15
        assert int(got["train_correct"]) == int(ref["train_correct"])
        for k in set(ref) - {"train_all", "train_correct"}:
            np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=1e-5)


def test_sparse_cce_metric_chunks_give_the_unchunked_sum(monkeypatch):
    rs = np.random.RandomState(8)
    logit = torch.tensor(rs.randn(7, 13).astype(np.float32))
    label = torch.tensor(rs.randint(0, 13, (7,)))
    whole = tmetrics.sparse_cce_sum(logit, label)
    monkeypatch.setattr(tloss, "_CHUNK_ELEMENTS", 26)
    np.testing.assert_allclose(float(tmetrics.sparse_cce_sum(logit, label)), float(whole),
                               rtol=1e-6)


def test_sparse_cce_metric_on_bf16_logits():
    """On bf16 logits the port sums in f32: within f32 roundoff of the
    exact value. The JAX package takes log_softmax in bf16, so it agrees
    only within bf16's relative precision, 2**-8."""
    rs = np.random.RandomState(13)
    logit = torch.tensor(rs.randn(4, 64, 512).astype(np.float32) * 3).bfloat16()
    label = rs.randint(0, 512, (4, 64))
    z = logit.double().numpy()
    zmax = z.max(-1, keepdims=True)
    lse = (zmax + np.log(np.exp(z - zmax).sum(-1, keepdims=True)))[..., 0]
    exact = (lse - np.take_along_axis(z, label[..., None], -1)[..., 0]).sum()
    names = frozenset(["sparse_categorical_crossentropy"])
    got = float(tmetrics.compute_metrics(names, logit, torch.from_numpy(label))["sparse_cce_loss"])
    ref = float(jmetrics.compute_metrics(
        names, jnp.asarray(logit.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(label))["sparse_cce_loss"])
    np.testing.assert_allclose(got, exact, rtol=1e-5)
    np.testing.assert_allclose(ref, got, rtol=2.0 ** -8)


@pytest.mark.parametrize("dim", [-1, 1])
def test_softmax_matches(dim):
    x = np.random.RandomState(9).randn(2, 3, 4).astype(np.float32)
    ref = jops.forward(jattrs.SoftmaxAttrs(dim), [jnp.asarray(x)], [])[0]
    got = tops.forward(tattrs.SoftmaxAttrs(dim), [torch.from_numpy(x)], [])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)


def test_dropout_identity_and_mask():
    x = torch.tensor(np.random.RandomState(10).randn(64, 128).astype(np.float32)) + 5.0
    gen = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    assert tops.forward(tattrs.DropoutAttrs(0.0), [x], [], train=True, rng=gen())[0] is x
    assert tops.forward(tattrs.DropoutAttrs(0.5), [x], [], train=False)[0] is x
    a = tops.forward(tattrs.DropoutAttrs(0.5), [x], [], train=True, rng=gen())[0]
    b = tops.forward(tattrs.DropoutAttrs(0.5), [x], [], train=True, rng=gen())[0]
    assert torch.equal(a, b)
    kept = a != 0
    torch.testing.assert_close(a[kept], x[kept] / 0.5, rtol=0, atol=0)
    n = x.numel()
    assert abs(kept.sum().item() - 0.5 * n) < 3 * (0.25 * n) ** 0.5
    with pytest.raises(ValueError, match="Generator"):
        tops.forward(tattrs.DropoutAttrs(0.5), [x], [], train=True)


def test_dropout_in_fit_draws_from_the_step_stream():
    """Two fits from the same state and seed repeat bitwise; the model's
    eval (Dropout off) is deterministic."""
    finals = []
    for _ in range(2):
        m = FFModel(FFConfig(batch_size=8, print_freq=0, seed=2), device="cpu")
        x = m.create_tensor([8, 32], name="x")
        h = m.dropout(m.dense(x, 16, activation=Activation.RELU, name="fc1"), 0.5)
        m.softmax(m.dense(h, 4, name="out"))
        m.compile(SGDOptimizer(lr=0.1), "mean_squared_error")
        xs, _ = _data(32)
        m.fit(xs, np.eye(4, dtype=np.float32)[np.arange(32) % 4], epochs=2, verbose=False)
        finals.append(params_to_numpy(m.params))
    for k in finals[0]:
        np.testing.assert_array_equal(finals[0][k], finals[1][k])
    # train_step without an rng draws from a generator seeded 0, as the JAX
    # package's train_step defaults to PRNGKey(0)
    labels = np.eye(4, dtype=np.float32)[np.arange(8) % 4]
    steps = []
    for rng in (None, torch.Generator().manual_seed(0), torch.Generator().manual_seed(1)):
        params = {k: p.clone() for k, p in m.params.items()}
        opt = {"step": torch.zeros((), dtype=torch.int32)}
        steps.append(m.instance.train_step(params, opt, {"x": xs[:8]}, labels, rng)[0])
    assert all(torch.equal(steps[0][k], steps[1][k]) for k in steps[0])
    assert not all(torch.equal(steps[0][k], steps[2][k]) for k in steps[0])


# --- the slice as a whole: the small flagship through both FFModels -----------


SMALL = dict(batch=2, seq=128, embed=256, heads=2, layers=2, vocab=512)


def test_small_flagship_fits_three_steps_like_the_jax_ffmodel():
    """Three Adam steps in f32 from the same parameters and batches. The
    port's attention runs FlashAttentionBSHF's plain versions on the CPU
    (no kernel launches); the JAX package its dense attention. Adam's first
    steps move every parameter by about alpha whatever its gradient, so the
    parameters are compared relative to how far they moved."""
    rs = np.random.RandomState(0)
    x = rs.randn(3 * SMALL["batch"], SMALL["seq"], SMALL["embed"]).astype(np.float32)
    y = rs.randint(0, SMALL["vocab"], (3 * SMALL["batch"], SMALL["seq"])).astype(np.int32)
    jm = jcore.FFModel.from_computation_graph(
        *jax_build_flagship_cg(**SMALL), config=_cfg(jcore, batch_size=SMALL["batch"]))
    jm.compile(jcore.AdamOptimizer(alpha=1e-3), "sparse_categorical_crossentropy",
               metrics=METRICS)
    init = _tree_numpy(jm.params)
    tm = FFModel.from_computation_graph(
        *build_flagship_cg(**SMALL), config=_cfg(tcore, batch_size=SMALL["batch"]),
        device="cpu")
    tm.compile(AdamOptimizer(alpha=1e-3), "sparse_categorical_crossentropy", metrics=METRICS)
    ffmodel_state_from_numpy(tm, init)
    launches = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    jperf = jm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    tperf = tm.fit(x, y, epochs=1, shuffle=False, verbose=False)
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == launches
    assert tperf.train_all == jperf.train_all == 3 * SMALL["batch"] * SMALL["seq"]
    np.testing.assert_allclose(tperf.sparse_cce_loss, jperf.sparse_cce_loss, rtol=1e-5)
    assert tperf.train_correct == jperf.train_correct
    got, want = params_to_numpy(tm.params), _tree_numpy(jm.params)
    assert int(tm.opt_state["step"]) == int(jm.opt_state["step"]) == 3
    for k in want:
        moved = np.linalg.norm(want[k] - init[k])
        assert np.linalg.norm(got[k] - want[k]) <= 1e-3 * moved, k


# --- what is not ported raises, naming its slice --------------------------------


def test_unported_paths_raise_naming_their_slice():
    m, x, out = build_mlp()
    with pytest.raises(NotImplementedError, match=r"\(A2\)"):
        m.transpose(x, (1, 0))  # the example zoo's ops are ported; transpose is not
    with pytest.raises(NotImplementedError, match=r"\(A2\)"):
        m.add(x, out)  # differing shapes need the Broadcast op
    m2, _, _ = build_mlp(_cfg(tcore, metrics_dir="unused"))
    with pytest.raises(NotImplementedError, match=r"\(A9\)"):
        m2.compile(SGDOptimizer(lr=0.1))
    m3, _, _ = build_mlp(_cfg(tcore, checkpoint_backend="orbax"))
    with pytest.raises(ValueError, match="orbax"):
        m3.compile(SGDOptimizer(lr=0.1))  # a JAX library: the port writes npz only
    m.compile(SGDOptimizer(lr=0.1))
    xs, ys = _data(8)
    with pytest.raises(NotImplementedError, match=r"\(A8 part 2\)"):
        m.fit(xs, ys, recompile_state=object(), verbose=False)
    m4, _, _ = build_mlp(_cfg(tcore, compile_cache_dir="unused"))
    with pytest.raises(ValueError, match="XLA"):
        m4.compile(SGDOptimizer(lr=0.1))


@pytest.mark.parametrize("heads", [2, 4])  # head dims 128 and 64 (one fused QKV projection)
def test_stepped_flagship_gradients_match_the_whole_step(heads):
    """The stepped backward (each op's own graph, reverse order) gives the
    gradients of one autograd pass over the whole step, f32 on the CPU."""
    cfg = dict(SMALL, heads=heads, layers=1)
    m = FFModel.from_computation_graph(*build_flagship_cg(**cfg),
                                       config=_cfg(tcore, batch_size=2), device="cpu")
    m.compile(AdamOptimizer(alpha=1e-3), "sparse_categorical_crossentropy")
    rs = np.random.RandomState(11)
    x = rs.randn(2, cfg["seq"], cfg["embed"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab"], (2, cfg["seq"])).astype(np.int32)
    _, want = m.instance.loss_and_grads(m.params, {"x": x}, y)
    m.forward({"x": x})
    m.zero_gradients()
    m.backward(y)
    got = m._backing.param_grads
    assert got.keys() == want.keys()
    for k, g in want.items():
        assert _rel(got[k].numpy(), g.numpy()) < 1e-5, k


def test_aux_loss_tensors_join_the_loss_like_the_jax_ffmodel():
    """from_computation_graph(aux_loss_tensors=...): the aux output's sum
    joins the training loss in both packages."""
    models = []
    for pkg, builder in ((jcore, JaxBuilder), (tcore, ComputationGraphBuilder)):
        b = builder()
        x = b.create_input([8, 32], name="x")
        h = b.dense(x, 16, name="fc1")
        aux = b.scalar_multiply(b.sigmoid(h), 0.01)
        logits = b.dense(h, 4, name="out")
        kw = {"device": "cpu"} if pkg is tcore else {}
        m = pkg.FFModel.from_computation_graph(b.graph, logits, config=_cfg(pkg),
                                               aux_loss_tensors=[aux], **kw)
        m.compile(pkg.SGDOptimizer(lr=0.5), "sparse_categorical_crossentropy")
        models.append(m)
    jm, tm = models
    ffmodel_state_from_numpy(tm, _tree_numpy(jm.params))
    xs, ys = _data(32, seed=12)
    jm.fit(xs, ys, epochs=2, shuffle=False, verbose=False)
    tm.fit(xs, ys, epochs=2, shuffle=False, verbose=False)
    got = params_to_numpy(tm.params)
    for k, v in _tree_numpy(jm.params).items():
        assert _rel(got[k], v) < 1e-5, k


def test_profiling_times_each_layer_of_the_stepped_api():
    m, x, out = build_mlp(_cfg(tcore, profiling=True))
    m.compile(SGDOptimizer(lr=0.1))
    xs, ys = _data(8)
    m.forward({"x": xs})
    m.backward(ys)
    ops = [n for n in m.cg.topological_ordering()
           if type(m.cg.op_attrs(n)).__name__ not in ("InputAttrs", "WeightAttrs")]
    for table in (m._backing.fwd_elapsed, m._backing.bwd_elapsed):
        assert set(table) == set(ops) and all(ms >= 0 for ms in table.values())
