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


# --- the last of A2's ops: TopK, Transpose, Reverse, Gather, Cast, Broadcast ----


def _vjp_pair(jattrs_, tattrs_, xs, cot_seed=7, n_in=1):
    """(port outputs, JAX outputs, port grads, JAX grads) of op forward on
    the numpy inputs xs (the first n_in take gradients), under a random
    cotangent on the first output."""
    jouts, jvjp = jax.vjp(lambda *a: jops.forward(jattrs_, list(a) + [jnp.asarray(x) for x in xs[n_in:]])[0],
                          *[jnp.asarray(x) for x in xs[:n_in]])
    cot = np.random.RandomState(cot_seed).randn(*jouts.shape).astype(np.float32)
    jgrads = jvjp(jnp.asarray(cot))
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in xs[:n_in]]
    touts = tops.forward(tattrs_, leaves + [torch.from_numpy(x) for x in xs[n_in:]])
    tgrads = torch.autograd.grad(touts[0], leaves, torch.from_numpy(cot))
    return touts, jouts, [g.numpy() for g in tgrads], [np.asarray(g) for g in jgrads]


def test_top_k_breaks_ties_towards_the_lower_index_as_lax_top_k():
    rs = np.random.RandomState(5)
    x = rs.randint(0, 4, (16, 12)).astype(np.float32)  # many equal entries
    ref = jops.forward(jattrs.TopKAttrs(5), [jnp.asarray(x)])
    got = tops.forward(tattrs.TopKAttrs(5), [torch.from_numpy(x)])
    assert got[1].dtype == torch.int32
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    # the values' gradient reaches the selected entries, as jax.vjp's
    touts, _, tg, jg = _vjp_pair(jattrs.TopKAttrs(3), tattrs.TopKAttrs(3),
                                 [rs.randn(6, 9).astype(np.float32)])
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", ["transpose", "reverse", "gather"])
def test_shape_ops_forward_and_gradient_match(op):
    rs = np.random.RandomState(6)
    x = rs.randn(3, 4, 5).astype(np.float32)
    if op == "transpose":
        args, xs = ((2, 0, 1),), [x]
        ja, ta = jattrs.TransposeAttrs(*args), tattrs.TransposeAttrs(*args)
    elif op == "reverse":
        xs = [x]
        ja, ta = jattrs.ReverseAttrs(1), tattrs.ReverseAttrs(1)
    else:
        xs = [x, rs.randint(0, 5, (3, 4, 7)).astype(np.int32)]  # repeated indices
        ja, ta = jattrs.GatherAttrs(-1), tattrs.GatherAttrs(-1)
    touts, jouts, tg, jg = _vjp_pair(ja, ta, xs)
    np.testing.assert_allclose(touts[0].detach().numpy(), np.asarray(jouts), rtol=0, atol=0)
    np.testing.assert_allclose(tg[0], jg[0], rtol=1e-6, atol=1e-6)


def test_cast_matches():
    from flexflow_tpu.op_attrs.datatype import DataType as JDT
    from flexflow_tpu_torch.op_attrs.datatype import DataType as TDT

    x = (np.random.RandomState(8).randn(4, 6) * 100).astype(np.float32)
    for name in ("INT32", "HALF", "BFLOAT16"):
        if not hasattr(JDT, name):
            continue
        ref = np.asarray(jops.forward(jattrs.CastAttrs(getattr(JDT, name)), [jnp.asarray(x)])[0])
        got = tops.forward(tattrs.CastAttrs(getattr(TDT, name)), [torch.from_numpy(x)])[0]
        np.testing.assert_array_equal(got.float().numpy(), ref.astype(np.float32))


def test_builder_inserts_the_broadcast_of_the_jax_builder():
    """add() of [4, 1, 6] and [5, 6]: both builders insert Broadcast ops to
    [4, 5, 6] before the add, with the same node order (so parameter keys
    agree), and the graph's values and gradients agree."""
    from flexflow_tpu.pcg import ComputationGraphBuilder as JB
    from flexflow_tpu.local_execution.training_backing import forward_interpreter as jfi
    from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder as TB
    from flexflow_tpu_torch.local_execution.training_backing import forward_interpreter as tfi

    graphs = []
    for B in (JB, TB):
        b = B()
        a = b.create_input([4, 1, 6], name="a")
        c = b.create_input([5, 6], name="c")
        out = b.add(a, c)
        graphs.append((b.graph, out))
    kinds = [[type(g.op_attrs(n)).__name__ for n in g.topological_ordering()] for g, _ in graphs]
    assert kinds[0] == kinds[1] and kinds[1].count("BroadcastAttrs") == 2
    rs = np.random.RandomState(9)
    xa, xc = rs.randn(4, 1, 6).astype(np.float32), rs.randn(5, 6).astype(np.float32)
    (jg, jout), (tg, tout) = graphs
    ref = jfi(jg, {}, {"a": jnp.asarray(xa), "c": jnp.asarray(xc)})[jout]
    ta = torch.from_numpy(xa).requires_grad_(True)
    got = tfi(tg, {}, {"a": ta, "c": torch.from_numpy(xc)})[tout]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=0, atol=0)
    (g,) = torch.autograd.grad(got.sum(), [ta])
    np.testing.assert_allclose(g.numpy(), np.full((4, 1, 6), 5.0, np.float32))
