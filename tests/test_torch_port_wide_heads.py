"""The flash and ring kernels past head dim 256 (the wide kernels of
csrc/flash_wide.cu), held through their plain versions on the CPU against
the JAX package:

- The port's plain forward, delta and backward, seq-major [b, s, h*d] and
  per-head [b, h, s, d], through the wrappers and their `_wide`
  counterparts, against the JAX per-head `flash_attention` run in interpret
  mode and its gradient (and its `_fwd` lse and `_delta_rows` delta), at
  d = 264, 384, 512, 520 and 1024, 1x2x256xd (s=128 at 1024), full and
  causal, from the same numpy inputs in f32.
- The seq-major path (flash_attention_bshf and its autograd) against the JAX
  `flash_attention_bshf` in interpret mode and its jax.vjp at d = 384 and
  512, the head dims its kd % 128 gate sends there.
- The ring steps against ring_flash.py's Pallas kernels in interpret mode at
  d = 384 and 520 (test_torch_port_ring.py's cases and helpers), through the
  wide step wrappers, whose forward writes the carried (m, l) to a second
  pair of buffers; and the ring's driver, which ping-pongs the pair, against
  the per-head path.
- The routes: _mha_forward at d=512 off a mesh reaches flash_attention_bshf,
  at d=384 under flash_mesh the per-head wrappers, never _dense_context, each
  matching the JAX forward.
- The slice as a whole: a two-layer flagship at embed 1024 with 2 heads (of
  512), one Adam step through ModelTrainingInstance against the JAX trainer
  on the same numpy parameters (carried by interop.py).
- The wide wrappers: what they refuse, their C signatures, their launch
  counts (none on the CPU).

Tolerance: f32 on both sides with the same arithmetic in another order,
1e-5 (tests/test_torch_port_head_dims.py's), absolute and relative: the
gradients reach ~30 at d=1024, where f32's last bits are ~1e-5.
"""

import functools
import math
import re

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
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.kernels import ring_attention as tra
from flexflow_tpu_torch.kernels import ring_flash as trf
from flexflow_tpu_torch.local_execution import ModelTrainingInstance
from flexflow_tpu_torch.models import build_flagship_cg
from flexflow_tpu_torch.op_attrs import ops as tattrs
from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
from flexflow_tpu_torch.pcg import AdamOptimizerAttrs
from test_torch_port_ring import CASES as RING_CASES
from test_torch_port_ring import TOL as RING_TOL
from test_torch_port_ring import _inputs as ring_inputs
from test_torch_port_ring import _jax_steps

WIDE_DIMS = (264, 384, 512, 520, 1024)
B, H = 1, 2
LN2 = math.log(2.0)
ATOL = 1e-5
TOL = dict(rtol=ATOL, atol=ATOL)


def _seq(d: int) -> int:
    return 128 if d >= 1024 else 256


@functools.lru_cache(maxsize=None)
def _pallas(d: int, causal: bool):
    """Inputs, and the Pallas kernels' o, lse (natural log), delta and the
    gradients of q, k and v, per-head [B, H, S, d]."""
    s = _seq(d)
    rs = np.random.RandomState(d + 1000 * causal)
    q, k, v, do = (rs.randn(B, H, s, d).astype(np.float32) for _ in range(4))

    def attend(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, interpret=True)

    o, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    rows = lambda a: jnp.asarray(a).reshape(B * H, s, d)  # noqa: E731
    _, lse2 = jfa._fwd(rows(q), rows(k), rows(v), causal, s, s, interpret=True)
    delta = jfa._delta_rows(rows(do), rows(o), interpret=True)
    return dict(q=q, k=k, v=v, do=do, o=np.array(o),
                lse=np.array(lse2).reshape(B, H, s) * LN2,
                delta=np.array(delta).reshape(B, H, s),
                grads=[np.array(g) for g in grads])


def _bshf(x):
    """[b, h, s, d] -> [b, s, h*d]."""
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _heads(x, h):
    """[b, s, h*d] -> [b, h, s, d]."""
    b, s, f = x.shape
    return x.reshape(b, s, h, f // h).transpose(1, 2)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", WIDE_DIMS)
def test_plain_versions_match_the_pallas_kernels(d, causal):
    """Forward, delta and backward, each on the Pallas kernels' own o and
    lse, on both layouts, through the wrappers (which hand d > 256 to their
    wide counterparts on a card) and the wide wrappers themselves; on the
    CPU they take their plain versions and launch nothing."""
    ref = _pallas(d, causal)
    q, k, v, do = (torch.from_numpy(ref[n]) for n in ("q", "k", "v", "do"))
    o_ref, lse_ref = torch.from_numpy(ref["o"]), torch.from_numpy(ref["lse"])
    delta_ref = torch.from_numpy(ref["delta"])
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]

    got = []
    for fwd, dlt, bwd in ((tfa.flash_fwd_bhsd, tfa.flash_delta_bhsd, tfa.flash_bwd_bhsd),
                          (tfa.flash_fwd_bhsd_wide, tfa.flash_delta_bhsd_wide,
                           tfa.flash_bwd_bhsd_wide)):
        o, lse = fwd(q, k, v, causal)
        got.append((o, lse, dlt(do, o_ref), bwd(q, k, v, do, lse_ref, delta_ref, causal)))
    bshf = [_bshf(t) for t in (q, k, v, do, o_ref)]
    for fwd, dlt, bwd in ((tfa.flash_fwd, tfa.flash_delta, tfa.flash_bwd),
                          (tfa.flash_fwd_wide, tfa.flash_delta_wide, tfa.flash_bwd_wide)):
        o_s, lse_s = fwd(*bshf[:3], H, causal)
        grads_s = [_heads(g, H) for g in bwd(*bshf[:4], lse_ref, delta_ref, H, causal)]
        got.append((_heads(o_s, H), lse_s, dlt(bshf[3], bshf[4], H), grads_s))
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before

    for got_o, got_lse, got_delta, got_grads in got:
        np.testing.assert_allclose(got_o.numpy(), ref["o"], **TOL)
        np.testing.assert_allclose(got_lse.numpy(), ref["lse"], **TOL)
        np.testing.assert_allclose(got_delta.numpy(), ref["delta"], **TOL)
        for name, g, want in zip(("dq", "dk", "dv"), got_grads, ref["grads"]):
            np.testing.assert_allclose(g.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
@pytest.mark.parametrize("d", [384, 512])
def test_seq_major_path_matches_flash_attention_bshf(d, causal):
    """flash_attention_bshf and its autograd on [b, s, h*d] against the JAX
    seq-major entry (its _fwd_bshf, _delta_bshf and _bwd_bshf_fused) and its
    jax.vjp, which its kd % 128 == 0 gate sends these head dims to."""
    s = 256
    rs = np.random.RandomState(d + causal)
    q, k, v, w = (rs.randn(B, s, H * d).astype(np.float32) for _ in range(4))

    def jfn(q, k, v):
        return jfa.flash_attention_bshf(q, k, v, H, causal=causal, interpret=True)

    o_ref, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = tfa.flash_attention_bshf(tq, tk, tv, H, causal)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), **TOL)
    for name, t, r in zip(("dq", "dk", "dv"), (tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), err_msg=name, **TOL)


def _port_wide_steps(x, q_off, k_off, causal):
    """The wide step wrappers on the CPU: the forward reads (m, l) and writes
    the new pair to other buffers, leaving the old ones as they were."""
    t = {n: torch.tensor(a) for n, a in x.items()}
    acc, m_out, l_out = t["acc"].clone(), torch.empty_like(t["m"]), torch.empty_like(t["l"])
    trf.ring_fwd_step_wide(t["q"], t["k"], t["v"], acc, t["m"], t["l"], m_out, l_out, q_off,
                           k_off, causal)
    assert np.array_equal(t["m"].numpy(), x["m"]) and np.array_equal(t["l"].numpy(), x["l"])
    args = (t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"])
    dq, dk, dv = t["dq"].clone(), t["dk"].clone(), t["dv"].clone()
    trf.ring_dq_step_wide(*args, dq, q_off, k_off, causal)
    trf.ring_dkv_step_wide(*args, dk, dv, q_off, k_off, causal)
    return tuple(a.numpy() for a in (acc, m_out, l_out, dq, dk, dv))


@pytest.mark.parametrize("case", ["below", "diagonal", "uneven", "masked"])
@pytest.mark.parametrize("d", [384, 520])
def test_ring_steps_match_the_pallas_kernels(d, case):
    """Each wide step's plain version against its Pallas kernel, causal,
    with state carried in (below, uneven, masked) or the ring's first step
    (diagonal); a fully masked step hands the state on unchanged."""
    s_blk, t_blk, q_off, k_off, carry = RING_CASES[case]
    x = ring_inputs(d, s_blk, t_blk, carry, seed=d + 3 * list(RING_CASES).index(case))
    got = _port_wide_steps(x, q_off, k_off, True)
    want = _jax_steps(x, q_off, k_off, True)
    for name, g, w in zip(("acc", "m", "l", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **RING_TOL)
    if case == "masked":
        for name, g in zip(("acc", "m", "l", "dq", "dk", "dv"), got):
            assert np.array_equal(g, x[name]), name


@pytest.mark.parametrize("causal", [False, True], ids=["full", "causal"])
def test_ring_driver_ping_pongs_the_carried_state(causal):
    """A 4-rank ring replayed in one process and a ring of one through the
    autograd driver, at d=384, against the per-head path."""
    rs = np.random.RandomState(7 + causal)
    q, k, v, do = (torch.from_numpy(rs.randn(1, 2, 256, 384).astype(np.float32))
                   for _ in range(4))
    o, lse = tfa.flash_fwd_bhsd(q, k, v, causal)
    want = (o, *tfa.flash_bwd_bhsd(q, k, v, do, lse, tfa.flash_delta_bhsd(do, o), causal))
    for name, g, w in zip(("o", "dq", "dk", "dv"), trf.replay_ring(q, k, v, do, 4, causal), want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=name, **TOL)
    qp, kp, vp = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = trf.ring_flash_attention_block(qp, kp, vp, trf.SequenceRing(), causal)
    out.backward(do)
    np.testing.assert_allclose(out.detach().numpy(), o.numpy(), **TOL)
    for name, t, w in zip(("dq", "dk", "dv"), (qp, kp, vp), want[1:]):
        np.testing.assert_allclose(t.grad.numpy(), w.numpy(), err_msg=name, **TOL)


def _attention_case(kd: int, heads: int, seed: int):
    e, s = 64, 128
    ja = jattrs.MultiHeadAttentionAttrs(embed_dim=e, num_heads=heads, kdim=kd, vdim=kd, bias=True)
    ta = tattrs.MultiHeadAttentionAttrs(embed_dim=e, num_heads=heads, kdim=kd, vdim=kd, bias=True)
    rs = np.random.RandomState(seed)
    x = rs.randn(2, s, e).astype(np.float32)
    w = (rs.randn(3 * e * kd + kd * e, heads) * 0.05).astype(np.float32)
    bias, out_b = rs.randn(3 * kd).astype(np.float32), rs.randn(e).astype(np.float32)
    ref = jops.forward(ja, [jnp.asarray(x)] * 3, [jnp.asarray(a) for a in (w, bias, out_b)])
    return ta, x, (w, bias, out_b), np.asarray(ref[0])


def _record(monkeypatch, module, names, calls):
    for name in names:
        fn = getattr(module, name)
        monkeypatch.setattr(module, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or
                            _fn(*a, **k))


def test_mha_forward_off_a_mesh_takes_flash_attention_bshf_at_d512(monkeypatch):
    """Self-attention with heads of 512 (bench.py --heads 2's) rides
    flash_attention_bshf and the seq-major wrappers forward and backward,
    with no dense attention and no per-head transposes."""
    ta, x, weights, ref = _attention_case(512, 2, seed=5)
    calls = []
    _record(monkeypatch, tops, ("flash_attention_bshf",), calls)
    _record(monkeypatch, tfa, ("flash_fwd_plain", "flash_delta_plain", "flash_bwd_plain",
                               "flash_fwd_bhsd_plain"), calls)
    tops._dense_context.calls = tra.ring_attention_block.calls = 0
    tx = torch.tensor(x, requires_grad=True)
    got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in weights])[0]
    got.sum().backward()
    assert calls == ["flash_attention_bshf", "flash_fwd_plain", "flash_delta_plain",
                     "flash_bwd_plain"]
    assert tops._dense_context.calls == 0 and tra.ring_attention_block.calls == 0
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


def test_mha_forward_under_flash_mesh_takes_the_per_head_wrappers_at_d384(monkeypatch):
    """Under a flash_mesh (the data-parallel trainer), heads of 384 (BERT-base
    at num_heads=8) take the per-head wrappers forward and backward, and no
    dense attention."""
    ta, x, weights, ref = _attention_case(384, 2, seed=9)
    calls = []
    _record(monkeypatch, tfa, ("flash_fwd_bhsd_plain", "flash_delta_bhsd_plain",
                               "flash_bwd_bhsd_plain", "flash_fwd_plain"), calls)
    tops._dense_context.calls = 0
    tx = torch.tensor(x, requires_grad=True)
    with tfa.flash_mesh(None):
        got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in weights])[0]
        got.sum().backward()
    assert calls == ["flash_fwd_bhsd_plain", "flash_delta_bhsd_plain", "flash_bwd_bhsd_plain"]
    assert tops._dense_context.calls == 0
    np.testing.assert_allclose(got.detach().numpy(), ref, **TOL)


FLAGSHIP_WIDE = dict(batch=2, seq=128, embed=1024, heads=2, layers=2, vocab=512)


def test_flagship_with_heads_of_512_takes_one_adam_step_as_the_jax_trainer():
    """bench.py --heads 2's heads, two layers deep: one Adam step from the
    same numpy parameters and batch, the port through its flash path's plain
    versions, the JAX package through its own attention. The loss to 1e-5;
    each updated parameter to 1e-5 of the JAX one."""
    cfg = FLAGSHIP_WIDE
    jgraph, jlogits = jax_build_flagship_cg(**cfg)
    jinst = JaxInstance(jgraph, jlogits, JaxSCCE(), JaxAdam(alpha=1e-3))
    jparams, jopt = jinst.initialize(seed=0)
    init = {k: np.array(v) for k, v in jparams.items()}
    rs = np.random.RandomState(0)
    x = rs.randn(cfg["batch"], cfg["seq"], cfg["embed"]).astype(np.float32)
    y = rs.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"])).astype(np.int32)
    jparams, jopt, jloss, _ = jinst.train_step(jparams, jopt, {"x": jnp.asarray(x)},
                                               jnp.asarray(y))

    graph, logits = build_flagship_cg(**cfg)
    inst = ModelTrainingInstance(graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                                 AdamOptimizerAttrs(alpha=1e-3), device="cpu")
    params = params_from_numpy(graph, init, "cpu")
    opt = inst.initialize(seed=0)[1]
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    tops._dense_context.calls = 0
    params, opt, loss, _ = inst.train_step(params, opt, {"x": x}, y)
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before  # plain versions on the CPU
    assert tops._dense_context.calls == 0
    np.testing.assert_allclose(float(loss), float(jloss), rtol=ATOL)
    got = params_to_numpy(params)
    assert set(got) == set(jparams)
    for k, want in jparams.items():
        np.testing.assert_allclose(got[k], np.asarray(want), **TOL, err_msg=k)


def test_wide_wrappers_take_only_head_dims_past_256():
    """A wide wrapper handed a head dim up to 256, or a narrow kernel's
    entry handed one past it, raises; so does a wide forward step whose
    output (m, l) alias its input. Off the CPU there is no fallback."""
    q = torch.empty(1, 2, 64, 256, dtype=torch.bfloat16, device="meta")
    rows = torch.empty(1, 2, 64, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="past 256"):
        tfa.flash_fwd_bhsd_wide(q, q, q)
    with pytest.raises(ValueError, match="past 256"):
        tfa.flash_bwd_wide(*(q.view(1, 64, 512),) * 4, rows, rows, 2)
    st = torch.empty(1, 2, 64, 256, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="past 256"):
        trf.ring_fwd_step_wide(q, q, q, st, rows, rows, rows, rows, 0, 0)
    wide = torch.empty(1, 2, 64, 384, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        tfa.flash_fwd_bhsd(wide, wide, wide)  # handed on to the wide wrapper, which checks
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        trf.ring_dq_step(wide, wide, wide, wide, rows, rows, st, 0, 0)
    wide = {"flash_fwd_wide", "flash_delta_wide", "flash_bwd_wide", "flash_fwd_bhsd_wide",
            "flash_delta_bhsd_wide", "flash_bwd_bhsd_wide", "ring_fwd_step_wide",
            "ring_dq_step_wide", "ring_dkv_step_wide"}
    assert wide <= {fn.__name__ for fn in tfa.KERNEL_WRAPPERS}


def test_wide_source_matches_the_declared_signatures():
    """Every exported function the wide wrappers call is declared with as
    many ctypes arguments as csrc/flash_wide.cu gives it parameters; the
    library builds with the others, and each kernel runs a wide mainloop
    (the ring forward with the epilogue that writes (m, l) elsewhere)."""
    assert "flash_wide.cu" in build.SOURCES
    src = (build.CSRC_DIR / "flash_wide.cu").read_text()
    for name, (argtypes, _) in tfa._WIDE_SIGNATURES.items():
        if name == "ff_error_string":
            continue
        m = re.search(r'extern "C" [\w\s\*]+?\b' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    for kernels in ("ff_flash_fwd_wide_kernel", "ff_flash_bwd_dkv_bhsd_wide_kernel",
                    "ff_ring_fwd_step_wide_kernel", "ff_ring_dkv_step_wide_kernel"):
        assert kernels in src
    assert "RingWideEpilogue<WIDE_DC>{acc, m_in, l_in, m_out, l_out}" in src
    assert "delta_body<0>(dout, od, o, ol, delta, S, H, d);" in src
    header = (build.CSRC_DIR / "flash_wide_sm90.cuh").read_text()
    assert "constexpr int WIDE_DC = 256;" in header and "constexpr int PANEL = 64;" in (
        build.CSRC_DIR / "flash_fwd_sm90.cuh").read_text()
    assert "mma.sync" not in header and "wmma" not in header
