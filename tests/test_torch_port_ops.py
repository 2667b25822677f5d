"""Per-op parity of the PyTorch port against the JAX package on the same
numpy inputs, in f32 on the CPU: the MHA projections and dense attention,
GELU, LayerNorm, the embedding on ids in and out of range, the fused sparse
cross-entropy and the optimizer updates.
Tolerances are f32 roundoff of the same arithmetic (1e-5 relative, looser
where sums over hundreds of terms are reordered)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import loss as jloss
from flexflow_tpu.kernels import ops as jops
from flexflow_tpu.kernels import optimizer as joptim
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu.pcg import optimizer as jopt_attrs
from flexflow_tpu_torch.kernels import loss as tloss
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.kernels import optimizer as toptim
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.pcg import optimizer as topt_attrs


def _mha_attrs(e, heads, bias):
    args = dict(embed_dim=e, num_heads=heads, bias=bias)
    return jattrs.MultiHeadAttentionAttrs(**args), tattrs.MultiHeadAttentionAttrs(**args)


def _mha_inputs(e, heads, s, seed):
    ja, ta = _mha_attrs(e, heads, bias=True)
    kd, vd = ta.q_proj_size, ta.v_proj_size
    rs = np.random.RandomState(seed)
    x = rs.randn(2, s, e).astype(np.float32)
    w = (rs.randn(3 * e * kd + vd * e, heads) * 0.05).astype(np.float32)
    bias = rs.randn(3 * kd).astype(np.float32)
    return ja, ta, x, w, bias


def test_mha_project_qkv_bshf_matches():
    ja, ta, x, w, bias = _mha_inputs(64, 4, 8, seed=0)
    ref = jops.mha_project_qkv_bshf(ja, *(jnp.asarray(x),) * 3, jnp.asarray(w), jnp.asarray(bias))
    tx = torch.from_numpy(x)
    got = tops.mha_project_qkv_bshf(ta, tx, tx, tx, torch.from_numpy(w), torch.from_numpy(bias))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("e,heads,s", [(64, 4, 16), (256, 2, 128)])
def test_mha_forward_matches(e, heads, s):
    """(64, 4): d=16 takes the port's dense path; (256, 2): d=128 takes the
    seq-major flash path (plain versions on the CPU). The JAX package takes
    its dense path on the CPU in both cases."""
    ja, ta, x, w, bias = _mha_inputs(e, heads, s, seed=1)
    out_b = np.random.RandomState(2).randn(e).astype(np.float32)
    ref = jops.forward(ja, [jnp.asarray(x)] * 3, [jnp.asarray(w), jnp.asarray(bias), jnp.asarray(out_b)])
    tx = torch.from_numpy(x)
    got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in (w, bias, out_b)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)


def test_dense_attention_causal_matches_jax_mask():
    ja, ta, x, w, bias = _mha_inputs(64, 4, 16, seed=3)
    ref = jops._mha_forward(ja, *(jnp.asarray(x),) * 3, jnp.asarray(w), jnp.asarray(bias), causal=True)
    tx = torch.from_numpy(x)
    got = tops.dense_attention(ta, tx, tx, tx, torch.from_numpy(w), torch.from_numpy(bias), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-5)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-6, 6, 1001).astype(np.float32)
    ref = jops.forward(jattrs.ElementUnaryAttrs(jattrs.ElementUnaryOpType.GELU), [jnp.asarray(x)])
    got = tops.forward(tattrs.ElementUnaryAttrs(tattrs.ElementUnaryOpType.GELU), [torch.from_numpy(x)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("axes", [(2,), (1, 2), (1,)])
def test_layer_norm_matches(axes):
    rs = np.random.RandomState(4)
    x = (rs.randn(3, 8, 16) * 2 + 1).astype(np.float32)
    gshape = tuple(x.shape[a] for a in axes)
    gamma, beta = rs.randn(*gshape).astype(np.float32), rs.randn(*gshape).astype(np.float32)
    ref = jops.forward(jattrs.LayerNormAttrs(axes), [jnp.asarray(x)], [jnp.asarray(gamma), jnp.asarray(beta)])
    got = tops.forward(tattrs.LayerNormAttrs(axes), [torch.from_numpy(x)],
                       [torch.from_numpy(gamma), torch.from_numpy(beta)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("aggr", ["NONE", "SUM", "AVG"])
def test_embedding_out_of_range_ids_match_jnp_take(aggr):
    """The JAX package's jnp.take fill mode: ids in [-V, V) taken (negative
    ones wrapping), a NaN row for any other id, and no gradient to the
    table from it. Row 0 of the ids is in range (with -V and -1), row 1
    holds V, row 2 an id below -V and one above V."""
    rows, width = 6, 3
    rs = np.random.RandomState(9)
    table = rs.randn(rows, width).astype(np.float32)
    ids = np.array([[1, -rows, -1, 0], [rows, 2, 3, 1], [-rows - 1, 2, rows + 2, 0]],
                   dtype=np.int32)
    ja = jattrs.EmbeddingAttrs(rows, width, getattr(jattrs.AggregateSpec, aggr))
    ta = tattrs.EmbeddingAttrs(rows, width, getattr(tattrs.AggregateSpec, aggr))

    def jfwd(t):
        return jops.forward(ja, [jnp.asarray(ids)], [t])[0]

    ref, pull = jax.vjp(jfwd, jnp.asarray(table))
    ref = np.asarray(ref)
    tt = torch.tensor(table, requires_grad=True)
    got = tops.forward(ta, [torch.from_numpy(ids)], [tt])[0]
    np.testing.assert_array_equal(np.isnan(got.detach().numpy()), np.isnan(ref))
    assert np.isnan(ref).any() and not np.isnan(ref[0]).any()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-6, atol=1e-6)

    cot = rs.randn(*ref.shape).astype(np.float32)
    (jgrad,) = pull(jnp.asarray(cot))
    (tgrad,) = torch.autograd.grad(got, tt, torch.from_numpy(cot))
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6, atol=1e-6)
    if aggr == "NONE":  # only the ids in range carry their rows' cotangents
        valid = (ids >= -rows) & (ids < rows)
        want = np.zeros_like(table)
        np.add.at(want, ids[valid] % rows, cot[valid])
        np.testing.assert_allclose(tgrad.numpy(), want, rtol=1e-6, atol=1e-6)


def test_fused_scce_value_and_gradient_match():
    rs = np.random.RandomState(5)
    logit = (rs.randn(2, 8, 50) * 3).astype(np.float32)
    label = rs.randint(0, 50, (2, 8)).astype(np.int32)
    attrs_j = jattrs.SparseCategoricalCrossEntropyLossAttrs()
    ref, ref_g = jax.value_and_grad(lambda z: jloss.loss_forward(attrs_j, z, jnp.asarray(label)))(
        jnp.asarray(logit)
    )
    tl = torch.tensor(logit, requires_grad=True)
    got = tloss.loss_forward(tattrs.SparseCategoricalCrossEntropyLossAttrs(), tl, torch.from_numpy(label))
    got.backward()
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-5)
    np.testing.assert_allclose(tl.grad.numpy(), np.asarray(ref_g), rtol=1e-5, atol=1e-7)


def test_fused_scce_chunks_rows(monkeypatch):
    """Chunked walking of the rows gives the unchunked value and gradient."""
    rs = np.random.RandomState(6)
    logit = torch.tensor(rs.randn(7, 13).astype(np.float32))
    label = torch.tensor(rs.randint(0, 13, (7,)))
    attrs = tattrs.SparseCategoricalCrossEntropyLossAttrs()
    outs = []
    for chunk in (1 << 27, 26):  # one chunk; two rows a chunk
        monkeypatch.setattr(tloss, "_CHUNK_ELEMENTS", chunk)
        z = logit.clone().requires_grad_(True)
        loss = tloss.loss_forward(attrs, z, label)
        loss.backward()
        outs.append((loss.detach(), z.grad))
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_adam_update_matches(weight_decay):
    rs = np.random.RandomState(7)
    w, g, m, v = (rs.randn(4, 5).astype(np.float32) for _ in range(4))
    v = np.abs(v)
    args = dict(alpha=1e-2, weight_decay=weight_decay)
    ref = joptim.adam_update(jopt_attrs.AdamOptimizerAttrs(**args), *map(jnp.asarray, (w, g, m, v)),
                             jnp.asarray(3, jnp.int32))
    tw, tg, tm, tv = (torch.tensor(a) for a in (w, g, m, v))
    toptim.adam_update_(topt_attrs.AdamOptimizerAttrs(**args), tw, tg, tm, tv, 3)
    for a, b in zip((tw, tm, tv), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("momentum,nesterov", [(0.0, False), (0.9, False), (0.9, True)])
def test_sgd_update_matches(momentum, nesterov):
    rs = np.random.RandomState(8)
    w, g, v = (rs.randn(4, 5).astype(np.float32) for _ in range(3))
    args = dict(lr=0.1, momentum=momentum, nesterov=nesterov, weight_decay=0.01)
    ref_w, ref_v = joptim.sgd_update(jopt_attrs.SGDOptimizerAttrs(**args), *map(jnp.asarray, (w, g, v)))
    tw, tg, tv = (torch.tensor(a) for a in (w, g, v))
    toptim.sgd_update_(topt_attrs.SGDOptimizerAttrs(**args), tw, tg, tv if momentum else None)
    np.testing.assert_allclose(tw.numpy(), np.asarray(ref_w), rtol=1e-5, atol=1e-7)
    if momentum:
        np.testing.assert_allclose(tv.numpy(), np.asarray(ref_v), rtol=1e-5, atol=1e-7)
