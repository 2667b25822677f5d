"""The port's fused step windows (steps_per_dispatch > 1) on the CPU, at
tests/test_fused_dispatch.py's sizes: FFModel.fit at K in {1, 3, 4, 8}
against the JAX package's fused fit on the same numpy data and state
(Dropout off, since the two packages draw different random bits), the
fused fit against the port's own per-step loop with Dropout on, bit for
bit, the windowed input pipeline against the JAX package's, its producer
thread's faults and shutdown, the config switches, and Adam's device step
count against the JAX optimizer. The JAX models compile with
max_devices=1, the single-device ModelTrainingInstance the port builds.

On the CPU a window runs its K steps eagerly; on a card it is one replayed
CUDA graph, which chip_smoke.py's fit_window and parity_fit_window hold
against the eager steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import core as jcore
from flexflow_tpu.core.dataloader import BatchIterator as JaxBatchIterator
from flexflow_tpu.core.dataloader import WindowedBatchIterator as JaxWindowedBatchIterator
from flexflow_tpu.kernels import optimizer as jopt
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdamAttrs
from flexflow_tpu_torch import core as tcore
from flexflow_tpu_torch.core.dataloader import BatchIterator, WindowedBatchIterator
from flexflow_tpu_torch.interop import ffmodel_state_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import optimizer as topt
from flexflow_tpu_torch.local_execution.training_backing import fused_multi_step
from flexflow_tpu_torch.pcg.optimizer import AdamOptimizerAttrs
from flexflow_tpu_torch.runtime.supervisor import BackgroundFault

BATCH = 16
STEPS_PER_EPOCH = 8
N = BATCH * STEPS_PER_EPOCH
EPOCHS = 2
RTOL, ATOL = 1e-5, 1e-6  # f32, the same math in another framework


def _data(seed=0):
    rs = np.random.RandomState(seed)
    return rs.randn(N, 32).astype(np.float32), rs.randint(0, 10, N)


def _build(pkg, k, dropout, seed=0):
    """test_fused_dispatch.py's model in either package."""
    kw = {"device": "cpu"} if pkg is tcore else {}
    cfg = pkg.FFConfig(batch_size=BATCH, seed=seed, steps_per_dispatch=k, print_freq=0,
                       max_devices=1)
    m = pkg.FFModel(cfg, **kw)
    x = m.create_tensor([BATCH, 32], name="x")
    h = m.relu(m.dense(x, 32, use_bias=False, name="fc1"))
    if dropout:
        h = m.dropout(h, 0.1)
    logits = m.dense(h, 10, use_bias=False, name="head")
    m.compile(pkg.AdamOptimizer(alpha=1e-2), "sparse_categorical_crossentropy",
              metrics=["accuracy"], logit_tensor=logits)
    return m


def _record_losses(m, fused_index: int, step_index: int) -> list:
    """Every step's loss, as the fit's per-step or fused calls return it."""
    losses = []
    step, multi = m.instance.train_step, m.instance.multi_train_step
    in_window = []  # the port's window calls train_step: count its steps once

    def train_step(*a, **kw):
        out = step(*a, **kw)
        if not in_window:
            losses.append(float(out[step_index]))
        return out

    def multi_train_step(*a, **kw):
        in_window.append(True)
        try:
            out = multi(*a, **kw)
        finally:
            in_window.pop()
        losses.extend(np.asarray(out[fused_index]).tolist())
        return out

    m.instance.train_step, m.instance.multi_train_step = train_step, multi_train_step
    return losses


def _state(m):
    """(params, Adam m, Adam v, step) as numpy."""
    tree = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}  # noqa: E731
    return tree(m.params), tree(m.opt_state["m"]), tree(m.opt_state["v"]), int(m.opt_state["step"])


def _jax_fit(k):
    """The JAX package's fit at window K (Dropout off): its initial
    numpy state, per-step losses and final state."""
    m = _build(jcore, k, dropout=False)
    init = (jax.tree_util.tree_map(np.asarray, m.params),
            jax.tree_util.tree_map(np.asarray, m.opt_state))
    losses = _record_losses(m, fused_index=3, step_index=2)
    xs, ys = _data()
    perf = m.fit(xs, ys, epochs=EPOCHS, shuffle=True, verbose=False)
    return init, losses, _state(m), perf


@pytest.fixture(scope="module")
def jax_fits():
    cache = {}

    def get(k):
        if k not in cache:
            cache[k] = _jax_fit(k)
        return cache[k]

    return get


# --- the fused fit against the JAX package's ---------------------------------


@pytest.mark.parametrize("k", [1, 3, 4, 8])  # 3: windows of 3 + 3 + 2, the tail
def test_fused_fit_matches_the_jax_fused_fit(jax_fits, k):
    (jparams, jopt_state), jlosses, (jp, jm, jv, jstep), jperf = jax_fits(k)
    m = _build(tcore, k, dropout=False)
    ffmodel_state_from_numpy(m, jparams, jopt_state)
    losses = _record_losses(m, fused_index=3, step_index=2)
    xs, ys = _data()
    perf = m.fit(xs, ys, epochs=EPOCHS, shuffle=True, verbose=False)
    p, mm, vv, step = _state(m)
    assert step == jstep == EPOCHS * STEPS_PER_EPOCH
    assert len(losses) == len(jlosses) == EPOCHS * STEPS_PER_EPOCH
    np.testing.assert_allclose(losses, jlosses, rtol=RTOL, atol=ATOL)
    for got, want in ((p, jp), (mm, jm), (vv, jv)):
        assert got.keys() == want.keys()
        for key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=ATOL, err_msg=key)
    assert (perf.train_all, perf.train_correct) == (jperf.train_all, jperf.train_correct)


# --- the fused fit against the port's own per-step loop, Dropout on ----------


def _port_fit(k, epochs=EPOCHS, fits=1):
    m = _build(tcore, k, dropout=True)
    losses = _record_losses(m, fused_index=3, step_index=2)
    xs, ys = _data()
    perf = [m.fit(xs, ys, epochs=epochs, shuffle=True, verbose=False, epoch_offset=i)
            for i in range(fits)]
    return m, losses, perf


@pytest.mark.parametrize("k", [3, 4, 8])
def test_fused_fit_with_dropout_is_the_per_step_loop_bitwise(k):
    """The RNG stream advances as per step: the same masks, so the same
    bits, through windows, the epoch's tail and a second fit."""
    ref, ref_losses, ref_perf = _port_fit(1, fits=2)
    fused, losses, perf = _port_fit(k, fits=2)
    assert losses == ref_losses
    for got, want in zip(_state(fused), _state(ref)):
        if isinstance(want, dict):
            for key in want:
                np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        else:
            assert got == want == 2 * EPOCHS * STEPS_PER_EPOCH
    assert [(p.train_all, p.train_correct) for p in perf] == [
        (p.train_all, p.train_correct) for p in ref_perf]


def test_multi_train_step_is_k_train_steps():
    """fused_multi_step: the losses and final state of K train_step calls
    on the window's rows and one generator, and their metric values
    left-folded in step order."""
    m = _build(tcore, 4, dropout=True)
    xs, ys = _data()
    win = {"x": torch.from_numpy(xs[:4 * BATCH].reshape(4, BATCH, 32))}
    lab = torch.from_numpy(ys[:4 * BATCH].reshape(4, BATCH).astype(np.int32))

    def fresh():
        return ({k: p.clone() for k, p in m.params.items()},
                topt.make_optimizer_state(m.optimizer_attrs, m.params))

    params, opt = fresh()
    rng = torch.Generator().manual_seed(3)
    params, opt, rng_out, losses, mvals = m.instance.multi_train_step(params, opt, win, lab, rng)
    assert rng_out is rng and losses.shape == (4,) and int(opt["step"]) == 4
    ref_params, ref_opt = fresh()
    ref_rng = torch.Generator().manual_seed(3)
    ref_losses, acc = [], None
    for i in range(4):
        ref_params, ref_opt, loss, mv = m.instance.train_step(
            ref_params, ref_opt, {"x": win["x"][i]}, lab[i], ref_rng)
        ref_losses.append(loss)
        acc = mv if acc is None else {key: acc[key] + v for key, v in mv.items()}
    assert torch.equal(losses, torch.stack(ref_losses))
    assert all(torch.equal(params[k], ref_params[k]) for k in params)
    assert mvals.keys() == acc.keys() and mvals["train_all"] == acc["train_all"] == 4 * BATCH
    assert torch.equal(mvals["train_correct"], acc["train_correct"])
    # the module-level body returns the same, before the instance's copies
    params, opt = fresh()
    out = fused_multi_step(m.instance, params, opt, win, lab, torch.Generator().manual_seed(3))
    assert torch.equal(out[3], losses)


def test_print_freq_reads_the_window_losses(capsys):
    """print_freq lines come from the window's loss vector, at the same
    steps and values as the per-step loop prints them."""
    outs = []
    for k in (1, 3):
        m = _build(tcore, k, dropout=False)
        m.config.print_freq = 2
        m.fit(*_data(), epochs=1, shuffle=False, verbose=True)
        outs.append([line for line in capsys.readouterr().out.splitlines()
                     if line.startswith("epoch")])
    assert outs[0] == outs[1] and len(outs[0]) == STEPS_PER_EPOCH // 2


# --- the windowed input pipeline ---------------------------------------------


def _iterators(seed):
    rs = np.random.RandomState(5)
    inputs = {"x": rs.randn(N, 3).astype(np.float32), "z": rs.randint(0, 9, (N, 2))}
    label = rs.randint(0, 4, N).astype(np.int32)
    return (JaxBatchIterator(inputs, label, BATCH, shuffle=True, seed=seed),
            BatchIterator(inputs, label, BATCH, device="cpu", shuffle=True, seed=seed))


@pytest.mark.parametrize("prefetch", [True, False])
def test_windows_match_the_jax_windowed_iterator_bitwise(prefetch):
    jit, tit = _iterators(seed=7)
    jw, tw = JaxWindowedBatchIterator(jit, 3, prefetch=prefetch), WindowedBatchIterator(
        tit, 3, prefetch=prefetch)
    for _ in range(2):  # two epochs: each reshuffles, and neither window spans them
        jwins, twins = list(jw), list(tw)
        assert [w[3] for w in jwins] == [w[2] for w in twins] == [3, 3, 2]
        for (jin, jlab, _, _), (tin, tlab, k) in zip(jwins, twins):
            assert tin.keys() == jin.keys() == {"x", "z"}
            np.testing.assert_array_equal(tlab.numpy(), np.asarray(jlab))
            for name in jin:
                assert tin[name].shape[:2] == (k, BATCH)
                np.testing.assert_array_equal(tin[name].numpy(), np.asarray(jin[name]))
    tw.close()


def test_a_producer_fault_surfaces_in_the_consumer_and_close_retires_it():
    _, it = _iterators(seed=1)
    rows = it.iter_rows

    def failing():
        gen = rows()
        yield next(gen)
        raise OSError("injected read fault")

    it.iter_rows = failing
    w = WindowedBatchIterator(it, 1)
    got = []
    with pytest.raises(OSError, match="injected read fault"):
        for item in w:
            got.append(item)
    assert len(got) == 1
    w._thread.join(timeout=5.0)
    assert not w._thread.is_alive()
    # an early exit: the consumer stops after one window, close() retires
    # the producer, which was blocked on the full queue
    _, it = _iterators(seed=1)
    w = WindowedBatchIterator(it, 2)
    for _ in w:
        break
    w.close()
    assert not w._thread.is_alive()


def test_a_producer_that_dies_silently_raises_background_fault():
    _, it = _iterators(seed=1)
    w = WindowedBatchIterator(it, 2)
    w._producer = lambda: None  # exits without posting a window or an error
    with pytest.raises(BackgroundFault, match="h2d_producer"):
        list(w)


# --- the config switches -----------------------------------------------------


def test_steps_per_dispatch_validated():
    with pytest.raises(ValueError, match="steps_per_dispatch"):
        _build(tcore, 0, dropout=False)
    with pytest.raises(ValueError, match="window"):
        WindowedBatchIterator(_iterators(seed=1)[1], 0)


def test_baseline_env_reverts_to_per_step(monkeypatch, capsys):
    monkeypatch.setenv("FF_TPU_FUSED_BASELINE", "1")
    m = _build(tcore, 8, dropout=True)
    calls = {"train_step": 0, "multi_train_step": 0}
    for name in calls:
        fn = getattr(m.instance, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] += 1
            return _fn(*a, **kw)

        setattr(m.instance, name, counted)
    m.fit(*_data(), epochs=1, shuffle=True, verbose=False)
    assert "FF_TPU_FUSED_BASELINE=1" in capsys.readouterr().out
    assert calls == {"train_step": STEPS_PER_EPOCH, "multi_train_step": 0}
    ref = _build(tcore, 1, dropout=True)
    ref.fit(*_data(), epochs=1, shuffle=True, verbose=False)
    for got, want in zip(_state(m)[:3], _state(ref)[:3]):
        for key in want:
            np.testing.assert_array_equal(got[key], want[key])


def test_set_learning_rate_between_fused_fits_matches_the_per_step_loop():
    finals = []
    for k in (1, 4):
        m = _build(tcore, k, dropout=True)
        m.fit(*_data(), epochs=1, shuffle=True, verbose=False)
        m.set_learning_rate(3e-3)
        m.fit(*_data(1), epochs=1, shuffle=True, verbose=False, epoch_offset=1)
        finals.append(params_to_numpy(m.params))
    for key in finals[0]:
        np.testing.assert_array_equal(finals[1][key], finals[0][key])


# --- Adam's step count on the device -----------------------------------------


@pytest.mark.parametrize("weight_decay", [0.0, 1e-2])
def test_adam_device_step_matches_the_jax_optimizer(weight_decay):
    """200 updates from the same numpy parameters and gradients: the step
    count is an int32 tensor on the parameters' device, and alpha_t is the
    JAX package's f32 formula."""
    rs = np.random.RandomState(0)
    w0 = {"a": rs.randn(64, 32).astype(np.float32), "b": rs.randn(32).astype(np.float32)}
    grads = [{k: rs.randn(*v.shape).astype(np.float32) for k, v in w0.items()}
             for _ in range(200)]
    attrs = AdamOptimizerAttrs(alpha=1e-3, weight_decay=weight_decay)
    jattrs = JaxAdamAttrs(alpha=1e-3, weight_decay=weight_decay)
    params = {k: torch.tensor(v) for k, v in w0.items()}
    state = topt.make_optimizer_state(attrs, params)
    assert state["step"].dtype == torch.int32 and state["step"].shape == ()
    jparams = {k: jnp.asarray(v) for k, v in w0.items()}
    jstate = jopt.make_optimizer_state(jattrs, jparams)
    update = jax.jit(lambda p, g, s: jopt.apply_optimizer(jattrs, p, g, s))
    for g in grads:
        topt.apply_optimizer_(attrs, params, {k: torch.tensor(v) for k, v in g.items()}, state)
        jparams, jstate = update(jparams, {k: jnp.asarray(v) for k, v in g.items()}, jstate)
    assert int(state["step"]) == int(jstate["step"]) == 200
    # within 1e-6 relative, as a whole tensor: the two frameworks round the
    # decayed gradient and the moments' sums differently (an FMA or not),
    # and 200 updates carry those ulps along
    for k in w0:
        for got, want in ((params[k], jparams[k]), (state["m"][k], jstate["m"][k]),
                          (state["v"][k], jstate["v"][k])):
            want = np.asarray(want)
            assert np.linalg.norm(got.numpy() - want) <= 1e-6 * np.linalg.norm(want), k
    alpha_t = topt.adam_step_size(attrs, state["step"])
    assert alpha_t.dtype == torch.float32 and alpha_t.shape == ()
