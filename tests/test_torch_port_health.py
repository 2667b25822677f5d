"""The run-health policies of the port (flexflow_tpu_torch/observability/
health.py, wired through FFModel.fit) against the JAX package's, on the
CPU, the counterpart of tests/test_run_health.py's TestHealthPolicies and
TestLocalizer and of tests/test_fused_dispatch.py's TestFusedTelemetry and
TestFusedHealth:

- warn, skip_step and raise through both FFModels on the same MLP, the
  same initial parameters and a NaN-poisoned batch at step 3 of 6, per
  step (K=1) and in fused windows (K=4): the events within 1e-5 (loss,
  global norms, update ratio; NaN where the JAX stream has NaN), the
  skipped/nonfinite flags equal, the final parameters within 1e-5 (under
  warn non-finite in both, at the same positions: the port's ReLU backward
  gives a NaN input a zero gradient, as JAX's does), the monitors' counts
  equal, and under raise the
  same NonFiniteError naming the same first bad op at the same step;
- the port's fused windows equal its per-step loop bitwise under skip_step
  and raise, with Dropout (the tripped step's masks reach the localizer);
- the localizer's reports on poisoned inputs, a poisoned weight and a clean
  replay are the JAX package's."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import core as jcore
from flexflow_tpu.observability import health as jh
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy
from flexflow_tpu_torch.observability import health as th
from flexflow_tpu_torch.observability.metrics import read_events

BATCH, HIDDEN, CLASSES = 16, 32, 10
STEPS, BAD_STEP = 6, 3
TOL = 1e-5


def _build(pkg, k=1, dropout=False, **cfg):
    kw = {"device": "cpu"} if pkg is tcore else {}
    m = pkg.FFModel(pkg.FFConfig(batch_size=BATCH, seed=0, steps_per_dispatch=k, print_freq=0,
                                 **cfg), **kw)
    x = m.create_tensor([BATCH, HIDDEN], name="x")
    h = m.relu(m.dense(x, HIDDEN, name="fc1"))
    if dropout:
        h = m.dropout(h, 0.1)
    logits = m.dense(h, CLASSES, name="head")
    m.compile(pkg.SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
              logit_tensor=logits)
    return m


def _data(bad_step=BAD_STEP):
    rs = np.random.RandomState(0)
    xv = rs.randn(BATCH * STEPS, HIDDEN).astype(np.float32)
    yv = rs.randint(0, CLASSES, BATCH * STEPS)
    if bad_step:
        xv[BATCH * (bad_step - 1):BATCH * bad_step] = np.nan
    return xv, yv


def _fit(m, data):
    try:
        m.fit(*data, epochs=1, shuffle=False, verbose=False)
    except (jh.NonFiniteError, th.NonFiniteError) as e:
        return e
    return None


@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("policy", ["warn", "skip_step", "raise"])
def test_policies_match_the_jax_package(tmp_path, policy, k):
    data = _data()
    jm = _build(jcore, k, metrics_dir=str(tmp_path / "jax"), health_policy=policy)
    init = {key: np.array(v) for key, v in jm.params.items()}
    tm = _build(tcore, k, metrics_dir=str(tmp_path / "port"), health_policy=policy)
    ffmodel_state_from_numpy(tm, init)
    assert tm.instance.guard_nonfinite_updates == (policy != "warn")
    assert tm.instance.halt_on_nonfinite == (policy == "raise")
    jerr, terr = _fit(jm, data), _fit(tm, data)
    assert (jerr is None) == (terr is None) == (policy != "raise")
    if policy == "raise":
        assert isinstance(terr, th.NonFiniteError)
        assert (terr.report.phase, terr.report.op_name) == (jerr.report.phase,
                                                           jerr.report.op_name) == ("forward",
                                                                                    "fc1")
    assert tm._step_count == jm._step_count == (BAD_STEP if policy == "raise" else STEPS)
    jev, tev = read_events(str(tmp_path / "jax")), read_events(str(tmp_path / "port"))
    assert [tuple(e) for e in tev] == [tuple(e) for e in jev]
    for je, te in zip(jev, tev):
        assert (te["step"], te["skipped"], te["nonfinite"]) == (
            je["step"], je["skipped"], je["nonfinite"])
        assert te["nonfinite"] == (te["step"] >= BAD_STEP if policy == "warn"
                                   else te["step"] == BAD_STEP)
        for key in ("loss", "grad_norm", "param_norm", "update_ratio"):
            np.testing.assert_allclose(float(te[key]), float(je[key]), rtol=TOL,
                                       err_msg=f"step {te['step']} {key}")
    assert tm.health_monitor.summary() == jm.health_monitor.summary()
    for key, want in jm.params.items():
        got, want = tm.params[key].numpy(), np.asarray(want)
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=key)
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=key)
    finite = all(torch.isfinite(p).all() for p in tm.params.values())
    # the poisoned update is applied under warn alone
    assert finite == (policy != "warn")


@pytest.mark.parametrize("policy", ["skip_step", "raise"])
def test_fused_windows_equal_the_per_step_loop_bitwise(tmp_path, policy):
    data = _data(bad_step=5)
    runs = {}
    for k in (1, 4):
        m = _build(tcore, k, dropout=True, metrics_dir=str(tmp_path / f"k{k}"),
                   health_policy=policy)
        err = _fit(m, data)
        runs[k] = (m, err, read_events(str(tmp_path / f"k{k}")))
    (m1, e1, ev1), (m4, e4, ev4) = runs[1], runs[4]
    assert m1._step_count == m4._step_count == (5 if policy == "raise" else STEPS)
    assert [(e["step"], e["loss"], e["grad_norm"], e["skipped"], e["nonfinite"]) for e in ev1] \
        == [(e["step"], e["loss"], e["grad_norm"], e["skipped"], e["nonfinite"]) for e in ev4]
    assert all(torch.equal(m1.params[key], m4.params[key]) for key in m1.params)
    assert int(m1.opt_state["step"]) == int(m4.opt_state["step"])
    assert m1.health_monitor.summary() == m4.health_monitor.summary()
    assert m1.health_monitor.summary()["first_bad_op"] == "fc1"
    if policy == "raise":
        assert e1.report.op_name == e4.report.op_name == "fc1"


def _localize(pkg, mod, m, inputs, with_loss=True, params=None):
    kw = {}
    if with_loss:
        kw = dict(logit_tensor=m.instance.logit_tensor, label=np.zeros(BATCH, np.int32),
                  loss_attrs=m.loss_attrs)
    return mod.localize_first_nonfinite(m.cg, params if params is not None else m.params,
                                        inputs, **kw)


@pytest.mark.parametrize("case", ["forward", "parameter", "clean"])
def test_the_localizer_reports_what_the_jax_package_reports(case):
    jm = _build(jcore)
    tm = _build(tcore)
    ffmodel_state_from_numpy(tm, {key: np.array(v) for key, v in jm.params.items()})
    x = np.zeros((BATCH, HIDDEN), np.float32)
    jp, tp = dict(jm.params), dict(tm.params)
    if case == "forward":
        x = np.full((BATCH, HIDDEN), np.nan, np.float32)
    elif case == "parameter":
        key = f"n{jm.get_parameter_by_name('head.weight0').handle.node.idx}"
        jp[key] = jnp.full(jp[key].shape, jnp.nan, jp[key].dtype)
        tp[key] = torch.full(tp[key].shape, math.nan)
    want = _localize(jcore, jh, jm, {"x": x}, with_loss=case != "parameter", params=jp)
    got = _localize(tcore, th, tm, {"x": x}, with_loss=case != "parameter", params=tp)
    assert (got.phase, got.op_name, got.op_type, got.detail) == (
        want.phase, want.op_name, want.op_type, want.detail)
    assert got.describe() == want.describe()


def test_warn_applies_the_update_and_says_so(capsys):
    m = _build(tcore, health_policy="warn")
    m.fit(*_data(bad_step=1), epochs=1, shuffle=False, verbose=False)
    assert m.health_monitor.nonfinite_steps == STEPS and m.health_monitor.skipped_steps == 0
    assert "[flexflow_tpu_torch][health] WARN" in capsys.readouterr().out
    assert not all(torch.isfinite(p).all() for p in m.params.values())


@pytest.mark.parametrize("site", ["element_unary", "linear_activation", "batch_norm"])
def test_relu_gives_a_nan_input_a_zero_gradient_as_jax_does(site):
    """The port's three ReLU sites take JAX's gradient, where(x > 0, g, 0):
    a NaN input gets 0 (torch.relu's own backward passes g through)."""
    import jax

    from flexflow_tpu.kernels import ops as j_kernels
    from flexflow_tpu.op_attrs import ops as j_ops
    from flexflow_tpu.op_attrs.activation import Activation as JAct
    from flexflow_tpu_torch.kernels import ops as t_kernels
    from flexflow_tpu_torch.op_attrs import ops as t_ops
    from flexflow_tpu_torch.op_attrs.activation import Activation as TAct

    x = np.array([[np.nan, -1.0, 2.0, 0.0], [3.0, np.nan, -0.5, 1.0]], np.float32)
    weights = []
    if site == "element_unary":
        make = lambda m, act: m.ElementUnaryAttrs(m.ElementUnaryOpType.RELU)  # noqa: E731
    elif site == "linear_activation":
        make = lambda m, act: m.LinearAttrs(4, use_bias=False, activation=act.RELU)  # noqa: E731
        weights = [np.eye(4, dtype=np.float32)]
    else:
        make = lambda m, act: m.BatchNormAttrs(relu=True, affine=False)  # noqa: E731
        x = x.reshape(2, 4, 1, 1)
    g = np.ones_like(x)
    _, vjp = jax.vjp(lambda a: j_kernels.forward(make(j_ops, JAct), [a],
                                                 [jnp.asarray(w) for w in weights])[0],
                     jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    tx = torch.tensor(x, requires_grad=True)
    out = t_kernels.forward(make(t_ops, TAct), [tx], [torch.tensor(w) for w in weights])[0]
    (got,) = torch.autograd.grad(out, tx, torch.tensor(g))
    np.testing.assert_array_equal(np.isnan(got.numpy()), np.isnan(np.asarray(want)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
