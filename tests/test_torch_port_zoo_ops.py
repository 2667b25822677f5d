"""The example zoo's ops in the PyTorch port against the JAX package on the
same seeded numpy inputs, in f32 on the CPU: Conv2D, Pool2D, BatchNorm,
Flat, Concat, Split and Reshape. Each is compared on its output, its input
gradients and its weight gradients (jax.vjp against torch.autograd with
one cotangent), within 1e-5 relative (Conv2D 1e-4: its sums over
channels x window run in another order); each attrs' output shape
against the JAX one; and op_forward_flops against the JAX count for every
op of the zoo's models."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu import models as jmodels
from flexflow_tpu.kernels import ops as jops
from flexflow_tpu.op_attrs import core as jcore_attrs
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu.op_attrs.activation import Activation as JActivation
from flexflow_tpu.op_attrs.tensor_shape import TensorShape as JShape
from flexflow_tpu_torch import models as tmodels
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.op_attrs import core as tcore_attrs
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.op_attrs.activation import Activation as TActivation
from flexflow_tpu_torch.op_attrs.tensor_shape import TensorShape as TShape


def _pair(name, *args, **kw):
    """The same attrs in both packages; an Activation or PoolOp is named
    by its enum member name and translated for each."""
    def conv(pkg_attrs, act, value):
        if isinstance(value, tuple) and value[0] == "act":
            return getattr(act, value[1])
        if isinstance(value, tuple) and value[0] == "pool":
            return getattr(pkg_attrs.PoolOp, value[1])
        return value

    j = getattr(jattrs, name)(*[conv(jattrs, JActivation, a) for a in args],
                              **{k: conv(jattrs, JActivation, v) for k, v in kw.items()})
    t = getattr(tattrs, name)(*[conv(tattrs, TActivation, a) for a in args],
                              **{k: conv(tattrs, TActivation, v) for k, v in kw.items()})
    return j, t


def _check_vjp(jattr, tattr, inputs, weights, rtol, seed=0):
    """Outputs, input gradients and weight gradients of the op in both
    packages from the same numpy values and cotangents."""
    n_in = len(inputs)

    def jfn(*args):
        return jops.forward(jattr, list(args[:n_in]), list(args[n_in:]))

    jargs = [jnp.asarray(a) for a in (*inputs, *weights)]
    jout, vjp = jax.vjp(jfn, *jargs)
    rs = np.random.RandomState(seed + 100)
    cot = [rs.randn(*o.shape).astype(np.float32) for o in jout]
    jgrads = vjp([jnp.asarray(c) for c in cot])

    targs = [torch.tensor(a, requires_grad=True) for a in (*inputs, *weights)]
    tout = tops.forward(tattr, targs[:n_in], targs[n_in:])
    assert len(tout) == len(jout)
    torch.autograd.backward(tout, [torch.from_numpy(c) for c in cot])
    for a, b in zip(tout, jout):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=rtol, atol=rtol)
    for t, g in zip(targs, jgrads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=rtol, atol=rtol)
    return tout


def _randn(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


@pytest.mark.parametrize(
    "stride,padding,groups,bias,act",
    [
        ((1, 1), (0, 0), 1, True, None),
        ((2, 1), (1, 2), 1, False, "RELU"),  # unequal strides and paddings
        ((1, 2), (2, 0), 2, True, "SIGMOID"),  # two groups
        ((2, 2), (1, 1), 4, False, None),  # depthwise-like: a channel a group
    ],
)
def test_conv2d_matches(stride, padding, groups, bias, act):
    rs = np.random.RandomState(sum(stride) + sum(padding) + groups)
    c, o, k = 4, 8, (3, 2)
    ja, ta = _pair("Conv2DAttrs", o, k[0], k[1], stride[0], stride[1], padding[0], padding[1],
                   groups, ("act", act) if act else None, bias)
    x = _randn(rs, 2, c, 9, 7)
    w = [_randn(rs, o, c // groups, *k) * 0.3]
    if bias:
        w.append(_randn(rs, o))
    _check_vjp(ja, ta, [x], w, rtol=1e-4)


@pytest.mark.parametrize(
    "pool,kernel,stride,padding,act",
    [
        ("MAX", (3, 3), (2, 2), (1, 1), None),
        ("MAX", (2, 3), (1, 2), (2, 2), "RELU"),  # padding above kernel/2: padded with -inf
        ("AVG", (3, 3), (2, 2), (1, 1), None),  # the window's count includes the padding
        ("AVG", (2, 2), (2, 1), (2, 1), "TANH"),  # padding above kernel/2
        ("AVG", (4, 4), (1, 1), (0, 0), None),  # a global pool, as the CNN heads use
    ],
)
def test_pool2d_matches(pool, kernel, stride, padding, act):
    rs = np.random.RandomState(len(pool) + sum(kernel) + sum(padding))
    ja, ta = _pair("Pool2DAttrs", kernel[0], kernel[1], stride[0], stride[1], padding[0],
                   padding[1], ("pool", pool), ("act", act) if act else None)
    x = _randn(rs, 2, 3, 4 if kernel == (4, 4) else 7, 4 if kernel == (4, 4) else 6)
    _check_vjp(ja, ta, [x], [], rtol=1e-5)


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_batch_norm_matches(affine, relu, train):
    """The batch's own statistics in training and evaluation alike."""
    rs = np.random.RandomState(2 * affine + relu)
    ja, ta = _pair("BatchNormAttrs", relu, affine, 1e-5, 0.1)
    x = _randn(rs, 4, 3, 5, 5) * 2 + 1
    w = [_randn(rs, 3), _randn(rs, 3)] if affine else []
    jout = jops.forward(ja, [jnp.asarray(x)], [jnp.asarray(a) for a in w], train=train)
    tout = tops.forward(ta, [torch.from_numpy(x)], [torch.from_numpy(a) for a in w], train=train)
    np.testing.assert_allclose(tout[0].numpy(), np.asarray(jout[0]), rtol=1e-5, atol=1e-5)
    _check_vjp(ja, ta, [x], w, rtol=1e-5)


def test_flat_matches():
    ja, ta = _pair("FlatAttrs")
    _check_vjp(ja, ta, [_randn(np.random.RandomState(0), 2, 3, 4, 5)], [], rtol=1e-5)


@pytest.mark.parametrize("axis", [1, -1])
def test_concat_matches(axis):
    rs = np.random.RandomState(axis % 5)
    ja, ta = _pair("ConcatAttrs", axis)
    shapes = [(2, 3, 4), (2, 5, 4)] if axis == 1 else [(2, 3, 4), (2, 3, 6)]
    _check_vjp(ja, ta, [_randn(rs, *s) for s in shapes], [], rtol=1e-5)


def test_split_matches():
    ja, ta = _pair("SplitAttrs", (2, 5, 1), 1)
    outs = _check_vjp(ja, ta, [_randn(np.random.RandomState(1), 3, 8, 2)], [], rtol=1e-5)
    assert [tuple(o.shape) for o in outs] == [(3, 2, 2), (3, 5, 2), (3, 1, 2)]


def test_reshape_matches():
    ja, ta = _pair("ReshapeAttrs", (4, 6, 5))
    _check_vjp(ja, ta, [_randn(np.random.RandomState(2), 2, 3, 4, 5)], [], rtol=1e-5)


SHAPE_CASES = [
    ("Conv2DAttrs", (16, 3, 3, 2, 2, 1, 1, 2), [(4, 8, 15, 17)]),
    ("Conv2DAttrs", (6, 5, 1, 1, 3, 0, 2, 1, None, False), [(2, 3, 9, 9)]),
    ("Pool2DAttrs", (3, 3, 2, 2, 1, 1, ("pool", "AVG")), [(4, 8, 15, 17)]),
    ("Pool2DAttrs", (2, 2, 1, 1, 2, 2), [(1, 2, 5, 5)]),
    ("FlatAttrs", (), [(4, 8, 3, 3)]),
    ("BatchNormAttrs", (True, True), [(4, 8, 3, 3)]),
    ("BatchNormAttrs", (False, False), [(4, 8, 3, 3)]),
    ("ConcatAttrs", (1,), [(2, 3, 4), (2, 5, 4)]),
    ("SplitAttrs", ((3, 1), -1), [(2, 3, 4)]),
    ("ReshapeAttrs", ((6, 4),), [(2, 3, 4)]),
]


@pytest.mark.parametrize("name,args,shapes", SHAPE_CASES)
def test_output_and_weight_shapes_match(name, args, shapes):
    ja, ta = _pair(name, *args)
    jin, tin = [JShape(s) for s in shapes], [TShape(s) for s in shapes]
    assert [s.dims for s in tcore_attrs.get_output_shapes(ta, tin)] == \
        [s.dims for s in jcore_attrs.get_output_shapes(ja, jin)]
    assert [s.dims for s in tcore_attrs.get_weight_shapes(ta, tin)] == \
        [s.dims for s in jcore_attrs.get_weight_shapes(ja, jin)]
    jroles = [r.value for r in jcore_attrs.get_incoming_tensor_roles(ja)]
    if jroles:  # the JAX package declares no roles for the variadic concat
        assert [r.value for r in tcore_attrs.get_incoming_tensor_roles(ta)] == jroles


def _zoo_graphs(pkg):
    m = pkg
    return [
        m.build_bert(m.BertConfig(num_encoder_layers=2, hidden_size=256, num_heads=1,
                                  dim_feedforward=256, sequence_length=128, vocab_size=512,
                                  batch_size=2))[0],
        m.build_transformer(m.TransformerConfig(num_features=64, sequence_length=16, batch_size=2,
                                                dim_feedforward=128, num_heads=2,
                                                num_encoder_layers=1, num_decoder_layers=1))[0],
        m.build_candle_uno(m.CandleUnoConfig(dense_layers=(32,) * 2,
                                             dense_feature_layers=(32,) * 2))[0],
        m.build_inception_v3(m.InceptionV3Config(batch_size=1, num_classes=8))[0],
        m.build_split_test(4)[0],
    ]


def test_op_forward_flops_match_for_every_op_of_the_zoo():
    for jg, tg in zip(_zoo_graphs(jmodels), _zoo_graphs(tmodels)):
        jnodes, tnodes = list(jg.topological_ordering()), list(tg.topological_ordering())
        assert len(jnodes) == len(tnodes)
        for jn, tn in zip(jnodes, tnodes):
            jshapes = [jg.tensor_shape(i) for i in jg.inputs_of(jn)]
            tshapes = [tg.tensor_shape(i) for i in tg.inputs_of(tn)]
            jouts = [jg.tensor_shape(o) for o in jg.outputs_of(jn)]
            touts = [tg.tensor_shape(o) for o in tg.outputs_of(tn)]
            jattr, tattr = jg.op_attrs(jn), tg.op_attrs(tn)
            assert type(tattr).__name__ == type(jattr).__name__
            assert tops.op_forward_flops(tattr, tshapes, touts) == \
                jops.op_forward_flops(jattr, jshapes, jouts), type(tattr).__name__
