"""The d=64 slice of the PyTorch port against the JAX package's head-pair
Pallas kernels (run in interpret mode), its fused-QKV projection and its
training step, on the same numpy inputs in f32 on the CPU.

The port's d=64 wrappers run their plain versions on CPU tensors; the CUDA
kernels are held against those plain versions on the card by chip_smoke.py.
Tolerances are the JAX package's own bounds for these kernels
(tests/test_flash_attention.py): atol 1e-5 for o and lse, 2e-4 for the
gradients; the projection and the training step use those of
tests/test_torch_port_ops.py and tests/test_torch_port_step.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bench import build_flagship_cg as jax_build_flagship_cg
from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu.kernels import ops as jops
from flexflow_tpu.local_execution import ModelTrainingInstance as JaxInstance
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu.op_attrs.ops.loss_functions import (
    SparseCategoricalCrossEntropyLossAttrs as JaxSCCE,
)
from flexflow_tpu.pcg.optimizer import AdamOptimizerAttrs as JaxAdam
from flexflow_tpu_torch.interop import params_from_numpy, params_to_numpy
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

B, H, S, D = 2, 4, 256, 64
F = H * D
LN2 = math.log(2.0)


def _inputs(seed, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, F).astype(np.float32) for _ in range(n)]


def _interleave(q, k, v):
    """numpy [b, s, f] x3 -> the JAX package's [b, s, 3f] pair interleave."""
    return np.stack([x.reshape(B, S, F // 128, 128) for x in (q, k, v)], axis=3).reshape(B, S, 3 * F)


def _nat(lse2):
    """base-2 [b, h, 1, s] -> natural log [b, h, s]."""
    return np.asarray(lse2)[:, :, 0, :] * LN2


def _jax_fwd(q, k, v, causal):
    return jfa._fwd_bshf_pair(*map(jnp.asarray, (q, k, v)), H, causal, S, S, interpret=True)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas_pair(causal):
    q, k, v, _ = _inputs(0)
    o_ref, lse2 = _jax_fwd(q, k, v, causal)
    o, lse = tfa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), H, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _nat(lse2), atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas_pair_qkv(causal):
    qkv = _interleave(*_inputs(1, 3))
    o_ref, lse2 = jfa._fwd_bshf_pair_qkv(jnp.asarray(qkv), H, causal, S, S, interpret=True)
    o, lse = tfa.flash_fwd_qkv_plain(torch.from_numpy(qkv), H, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), _nat(lse2), atol=1e-5)
    # the wrapper on the lane-group views of the interleave is the same function
    o_w, lse_w = tfa.flash_fwd_d64(*tfa.qkv_views(torch.from_numpy(qkv)), H, causal)
    assert torch.equal(o_w, o) and torch.equal(lse_w, lse)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas_pair(causal):
    q, k, v, do = _inputs(2)
    o_j, lse2 = _jax_fwd(q, k, v, causal)
    ref = jfa._bwd_bshf_pair_fused(*map(jnp.asarray, (q, k, v)), o_j, lse2, jnp.asarray(do),
                                   H, causal, interpret=True)
    tq, tk, tv, tdo, to = map(torch.from_numpy, (q, k, v, do, np.array(o_j)))
    delta = tfa.flash_delta_plain(tdo, to, H)
    got = tfa.flash_bwd_plain(tq, tk, tv, tdo, torch.from_numpy(_nat(lse2)), delta, H, causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas_pair_qkv(causal):
    q, k, v, do = _inputs(3)
    qkv = _interleave(q, k, v)
    o_j, lse2 = jfa._fwd_bshf_pair_qkv(jnp.asarray(qkv), H, causal, S, S, interpret=True)
    ref = jfa._bwd_bshf_pair_fused_qkv(jnp.asarray(qkv), o_j, lse2, jnp.asarray(do), H, causal,
                                       interpret=True)
    tqkv, tdo, to = map(torch.from_numpy, (qkv, do, np.array(o_j)))
    lse = torch.from_numpy(_nat(lse2))
    delta = tfa.flash_delta_plain(tdo, to, H)
    got = tfa.flash_bwd_qkv_plain(tqkv, tdo, lse, delta, H, causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)
    # the wrapper writes the same gradients into the views of one dqkv
    dqkv = torch.empty_like(tqkv)
    tfa.flash_bwd_d64(*tfa.qkv_views(tqkv), tdo, lse, delta, *tfa.qkv_views(dqkv), H, causal)
    assert torch.equal(dqkv, got)


@pytest.mark.parametrize("causal", [False, True])
def test_qkv_autograd_matches_jax_grad(causal):
    q, k, v, w = _inputs(4)
    qkv = _interleave(q, k, v)

    def jloss(qkv):
        o = jfa.flash_attention_bshf_qkv(qkv, H, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    ref = jax.grad(jloss)(jnp.asarray(qkv))
    tqkv = torch.tensor(qkv, requires_grad=True)
    o = tfa.flash_attention_bshf_qkv(tqkv, H, causal)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(tqkv.grad.numpy(), np.asarray(ref), atol=2e-4)


def test_qkv_entry_refuses_shapes_the_kernels_do_not_take():
    with pytest.raises(ValueError, match="h even"):
        tfa.flash_attention_bshf_qkv(torch.zeros(1, 64, 3 * 3 * 64), 3)
    with pytest.raises(ValueError, match="3\\*h\\*64"):
        tfa.flash_attention_bshf_qkv(torch.zeros(1, 64, 3 * 512), 4)


def _mha(e, heads, bias, seed):
    args = dict(embed_dim=e, num_heads=heads, bias=bias)
    ja, ta = jattrs.MultiHeadAttentionAttrs(**args), tattrs.MultiHeadAttentionAttrs(**args)
    kd, vd = ta.q_proj_size, ta.v_proj_size
    rs = np.random.RandomState(seed)
    x = rs.randn(2, 128, e).astype(np.float32)
    w = (rs.randn(3 * e * kd + vd * e, heads) * 0.05).astype(np.float32)
    b = rs.randn(3 * kd).astype(np.float32) if bias else None
    return ja, ta, x, w, b


@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_qkv_projection_matches(with_bias):
    ja, ta, x, w, b = _mha(256, 4, with_bias, seed=5)
    ref = jops.mha_project_qkv_bshf_fused(ja, jnp.asarray(x), jnp.asarray(w),
                                          None if b is None else jnp.asarray(b))
    got = tops.mha_project_qkv_bshf_fused(ta, torch.from_numpy(x), torch.from_numpy(w),
                                          None if b is None else torch.from_numpy(b))
    for a, r in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_fused_and_separate_d64_paths_agree(causal):
    """One tensor for q, k and v takes the fused projection and the
    interleaved entry; three equal tensors take the separate one. Same
    outputs and same input and weight gradients."""
    _, ta, x, w, b = _mha(256, 4, True, seed=6)
    outs = []
    for fused in (True, False):
        tx, tw, tb = (torch.tensor(a, requires_grad=True) for a in (x, w, b))
        q, k, v = (tx, tx, tx) if fused else (tx, tx * 1, tx * 1)
        assert (q is k) is fused
        o = tops._mha_forward(ta, q, k, v, tw, tb, causal)
        (o * torch.linspace(-1, 1, o.numel()).reshape(o.shape)).sum().backward()
        outs.append((o.detach(), tx.grad, tw.grad, tb.grad))
    for a, r in zip(*outs):
        np.testing.assert_allclose(a.numpy(), r.numpy(), rtol=1e-5, atol=1e-5)


def test_d64_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    q, k, v, do = map(torch.from_numpy, _inputs(7))
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    qkv = tfa.interleave_qkv(q, k, v)
    o, lse = tfa.flash_fwd_d64(*map(tfa.lane_groups, (q, k, v)), H, True)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, H, True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = tfa.flash_delta_d64(do, o, H)
    assert torch.equal(delta, tfa.flash_delta_plain(do, o, H))
    grads = [torch.empty_like(t) for t in (q, k, v)]
    tfa.flash_bwd_d64(*map(tfa.lane_groups, (q, k, v)), do, lse, delta,
                      *map(tfa.lane_groups, grads), H, True)
    for a, b in zip(grads, tfa.flash_bwd_plain(q, k, v, do, lse, delta, H, True)):
        assert torch.equal(a, b)
    qkv.requires_grad_(True)
    tfa.flash_attention_bshf_qkv(qkv, H, True).sum().backward()
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before


SMALL16 = dict(batch=2, seq=128, embed=256, heads=4, layers=2, vocab=512)
STEPS = 3


@pytest.fixture(scope="module")
def heads16_runs():
    """A small 16-head-style flagship (heads of 64) trained three Adam
    steps by both packages from the same parameters and batch."""
    jgraph, jlogits = jax_build_flagship_cg(**SMALL16)
    jinst = JaxInstance(jgraph, jlogits, JaxSCCE(), JaxAdam(alpha=1e-3))
    jparams, jopt = jinst.initialize(seed=0)
    init = {k: np.array(v) for k, v in jparams.items()}
    rs = np.random.RandomState(0)
    x = rs.randn(SMALL16["batch"], SMALL16["seq"], SMALL16["embed"]).astype(np.float32)
    y = rs.randint(0, SMALL16["vocab"], (SMALL16["batch"], SMALL16["seq"])).astype(np.int32)
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    jgrads = jax.grad(lambda p: jinst.loss_fn(p, {"x": jx}, jy)[0])(jparams)
    jlosses = []
    for _ in range(STEPS):
        jparams, jopt, loss, _ = jinst.train_step(jparams, jopt, {"x": jx}, jy)
        jlosses.append(float(loss))

    graph, logits = build_flagship_cg(**SMALL16)
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


def test_heads16_losses_match_per_step(heads16_runs):
    np.testing.assert_allclose(heads16_runs["losses"], heads16_runs["jlosses"], rtol=1e-5)


def test_heads16_first_step_gradients_match(heads16_runs):
    r = heads16_runs
    assert r["grads"].keys() == r["jgrads"].keys()
    for k, g in r["jgrads"].items():
        assert np.linalg.norm(r["grads"][k] - g) / np.linalg.norm(g) < 1e-5, k


def test_heads16_parameters_after_three_steps_match(heads16_runs):
    r = heads16_runs
    assert r["opt_step"] == r["jopt_step"] == STEPS
    for k, want in r["jparams"].items():
        moved = np.linalg.norm(want - r["init"][k])
        assert np.linalg.norm(r["params"][k] - want) <= 1e-3 * moved, k


def test_heads16_step_takes_the_fused_qkv_path(monkeypatch):
    """The flagship's attention passes one tensor as q, k and v, so at d=64
    every layer goes through the interleaved entry, as in the JAX package."""
    calls = []
    real = tfa.FlashAttentionQKV.apply
    monkeypatch.setattr(tfa.FlashAttentionQKV, "apply",
                        lambda *a: calls.append(a[0].shape) or real(*a))
    graph, logits = build_flagship_cg(**SMALL16)
    inst = ModelTrainingInstance(
        graph, logits, SparseCategoricalCrossEntropyLossAttrs(), AdamOptimizerAttrs(alpha=1e-3),
        device="cpu",
    )
    params, opt = inst.initialize(seed=0)
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(SMALL16["batch"], SMALL16["seq"], SMALL16["embed"], generator=gen)
    y = torch.randint(0, SMALL16["vocab"], (SMALL16["batch"], SMALL16["seq"]), generator=gen)
    inst.train_step(params, opt, {"x": x}, y)
    e, b, s = SMALL16["embed"], SMALL16["batch"], SMALL16["seq"]
    assert calls == [(b, s, 3 * e)] * SMALL16["layers"]
