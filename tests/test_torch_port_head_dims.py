"""The flash and ring kernels at every head dim the Pallas kernels take
(d % 8 == 0), up to 256: each runs at a padded width of 64, 128, 192 or
256 whose columns past d load as zeros and are never stored (past 256 the
wide kernels take over: tests/test_torch_port_wide_heads.py).

- The port's plain forward, delta and backward, seq-major [b, s, h*d] and
  per-head [b, h, s, d], against the JAX package's per-head
  `flash_attention` run in interpret mode and its gradient (and its
  `_fwd` lse and `_delta_rows` delta), at d = 8, 32, 40, 96, 192 and 256,
  1x2x256xd, full and causal, from the same numpy inputs in f32.
- The ring steps against ring_flash.py's Pallas kernels in interpret mode
  at d = 96 and 256 (the cases and helpers of test_torch_port_ring.py).
- The gates: they admit exactly d % 8 == 0 with d >= 8 (d = 12 and 268
  refused; 264, 384, 512, 1024 and 2048 admitted, on the wide kernels), in
  bf16 on a CUDA device; the CUDA source's head_dim_ok, narrow_dim_ok and
  padded_dim say the same; a wrapper handed a head dim no kernel takes
  raises.
- The routes on the CPU: _mha_forward off a mesh at d = 32 and 96 reaches
  the seq-major wrappers, under flash_mesh at d=256 the per-head wrappers,
  at d=264 the seq-major wrappers too, never the dense path, and matches
  the JAX package's forward.

Tolerance: f32 on both sides with the same arithmetic in another order,
values of order one, 1e-5.
"""

import functools
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu.kernels import ops as jops
from flexflow_tpu.op_attrs import ops as jattrs
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.kernels import ring_attention as tra
from flexflow_tpu_torch.kernels import ring_flash as trf
from flexflow_tpu_torch.op_attrs import ops as tattrs
from test_torch_port_ring import CASES as RING_CASES
from test_torch_port_ring import TOL as RING_TOL
from test_torch_port_ring import _inputs as ring_inputs
from test_torch_port_ring import _jax_steps, _port_steps

HEAD_DIMS = (8, 32, 40, 96, 192, 256)
B, H, S = 1, 2, 256
LN2 = math.log(2.0)
ATOL = 1e-5


@functools.lru_cache(maxsize=None)
def _pallas(d: int, causal: bool):
    """Inputs, and the Pallas kernels' o, lse (natural log), delta and the
    gradients of q, k and v, per-head [B, H, S, d]."""
    rs = np.random.RandomState(d + 1000 * causal)
    q, k, v, do = (rs.randn(B, H, S, d).astype(np.float32) for _ in range(4))

    def attend(q, k, v):
        return jfa.flash_attention(q, k, v, causal=causal, interpret=True)

    o, vjp = jax.vjp(attend, *map(jnp.asarray, (q, k, v)))
    grads = vjp(jnp.asarray(do))
    rows = lambda a: jnp.asarray(a).reshape(B * H, S, d)  # noqa: E731
    _, lse2 = jfa._fwd(rows(q), rows(k), rows(v), causal, S, S, interpret=True)
    delta = jfa._delta_rows(rows(do), rows(o), interpret=True)
    return dict(q=q, k=k, v=v, do=do, o=np.array(o),
                lse=np.array(lse2).reshape(B, H, S) * LN2,
                delta=np.array(delta).reshape(B, H, S),
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
@pytest.mark.parametrize("d", HEAD_DIMS)
def test_plain_versions_match_the_pallas_kernels(d, causal):
    """Forward, delta and backward, each on the Pallas kernels' own o and
    lse, on both layouts; the wrappers take their plain versions on the
    CPU and launch nothing."""
    ref = _pallas(d, causal)
    q, k, v, do = (torch.from_numpy(ref[n]) for n in ("q", "k", "v", "do"))
    o_ref, lse_ref = torch.from_numpy(ref["o"]), torch.from_numpy(ref["lse"])
    delta_ref = torch.from_numpy(ref["delta"])
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]

    o, lse = tfa.flash_fwd_bhsd(q, k, v, causal)
    delta = tfa.flash_delta_bhsd(do, o_ref)
    grads = tfa.flash_bwd_bhsd(q, k, v, do, lse_ref, delta_ref, causal)
    bshf = [_bshf(t) for t in (q, k, v, do, o_ref)]
    o_s, lse_s = tfa.flash_fwd(*bshf[:3], H, causal)
    delta_s = tfa.flash_delta(bshf[3], bshf[4], H)
    grads_s = [_heads(g, H) for g in tfa.flash_bwd(*bshf[:4], lse_ref, delta_ref, H, causal)]
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before

    for got_o, got_lse, got_delta, got_grads in ((o, lse, delta, grads),
                                                 (_heads(o_s, H), lse_s, delta_s, grads_s)):
        np.testing.assert_allclose(got_o.numpy(), ref["o"], atol=ATOL)
        np.testing.assert_allclose(got_lse.numpy(), ref["lse"], atol=ATOL)
        np.testing.assert_allclose(got_delta.numpy(), ref["delta"], atol=ATOL)
        for name, g, want in zip(("dq", "dk", "dv"), got_grads, ref["grads"]):
            np.testing.assert_allclose(g.numpy(), want, atol=ATOL, err_msg=name)


@pytest.mark.parametrize("case", ["below", "diagonal", "uneven"])
@pytest.mark.parametrize("d", [96, 256])
def test_ring_steps_match_the_pallas_kernels(d, case):
    """Each step's plain version against its Pallas kernel, causal, with
    state carried in (below, uneven) or the ring's first step (diagonal)."""
    s_blk, t_blk, q_off, k_off, carry = RING_CASES[case]
    x = ring_inputs(d, s_blk, t_blk, carry, seed=d + 3 * list(RING_CASES).index(case))
    got = _port_steps(x, q_off, k_off, True)
    want = _jax_steps(x, q_off, k_off, True)
    for name, g, w in zip(("acc", "m", "l", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **RING_TOL)


@pytest.mark.parametrize("d", [8, 12, 32, 40, 64, 96, 120, 160, 192, 200, 248, 256, 264, 268, 384,
                               512, 1024, 2048])
def test_gates_admit_every_multiple_of_8(d):
    ok = d % 8 == 0 and 8 <= d
    bf16 = torch.bfloat16
    bhsd = (2, 3, 256, d)
    assert tfa.head_dim_supported(d) is ok
    assert tfa.flash_attention_bshf_supported((2, 256, 3 * d), 3, bf16, "cuda") is ok
    assert tfa.flash_attention_supported(bhsd, bhsd, bhsd, bf16, "cuda") is ok
    assert tfa.sharded_flash_supported(bhsd, bhsd, bhsd, bf16, "cuda") is ok
    assert trf.ring_flash_supported(bhsd, (2, 3, 192, d), (2, 3, 192, d), bf16, "cuda") is ok
    # the kernels take bf16 only, and a sequence of whole 64-row tiles
    assert not tfa.flash_attention_bshf_supported((2, 256, 3 * d), 3, torch.float32, "cuda")
    assert not tfa.flash_attention_supported((2, 3, 100, d), (2, 3, 100, d), (2, 3, 100, d),
                                             bf16, "cuda")
    if ok:
        assert tfa.padded_dim(d) - 64 < d <= tfa.padded_dim(d)
        assert (tfa.padded_dim(d) in tfa.PADDED_WIDTHS) is (not tfa.wide_head_dim(d))
        assert tfa.wide_head_dim(d) is (d > tfa.NARROW_MAX)


def test_cuda_source_takes_the_gates_head_dims():
    """The C entries refuse what the gates refuse and pick the width the
    Python side names: head_dim_ok, narrow_dim_ok, wide_dim_ok and
    padded_dim in csrc/flash_tiles.cuh."""
    src = (build.CSRC_DIR / "flash_tiles.cuh").read_text()
    assert f"return d >= {tfa.HEAD_DIM_STEP} && d % {tfa.HEAD_DIM_STEP} == 0;" in src
    assert f"constexpr int NARROW_MAX = {tfa.NARROW_MAX};" in src
    assert "return head_dim_ok(d) && d <= NARROW_MAX;" in src
    assert "return head_dim_ok(d) && d > NARROW_MAX;" in src
    assert "return (d + 63) / 64 * 64;" in src
    assert all(tfa.padded_dim(d) == (d + 63) // 64 * 64 for d in range(8, 257, 8))
    flash = (build.CSRC_DIR / "flash_attention.cu").read_text()
    for width in tfa.PADDED_WIDTHS:
        assert re.search(rf"FLASH_FWD_KERNEL\(ff_flash_fwd_\w*kernel, {width}\)", flash), width
    ring = (build.CSRC_DIR / "ring_flash.cu").read_text()
    for width in tfa.PADDED_WIDTHS:
        assert re.search(rf"RING_DKV_KERNEL\(ff_ring_dkv_step\w*kernel, {width}\)", ring), width
    # the narrow sources take d up to 256, the wide one past it
    assert "narrow_dim_ok(d)" in flash and "narrow_dim_ok(d)" in ring
    assert "head_dim_ok(d)" not in flash.replace("narrow_dim_ok(d)", "")
    wide = (build.CSRC_DIR / "flash_wide.cu").read_text()
    assert wide.count("if (!wide_dim_ok(d)) return (int)cudaErrorInvalidValue;") == 6


@pytest.mark.parametrize("d", [12, 268])
def test_wrappers_raise_on_a_head_dim_the_kernels_do_not_take(d):
    """On a device other than the CPU a wrapper launches its kernel or
    raises; it never falls back to its plain version."""
    q = torch.empty(1, 2, 64, d, dtype=torch.bfloat16, device="meta")
    rows = torch.empty(1, 2, 64, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="d in"):
        tfa.flash_fwd_bhsd(q, q, q)
    with pytest.raises(ValueError, match="d in"):
        tfa.flash_bwd_bhsd(q, q, q, q, rows, rows)
    x = torch.empty(1, 64, 2 * d, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError):
        tfa.flash_fwd(x, x, x, 2)
    st = torch.empty(1, 2, 64, d, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        trf.ring_fwd_step(q, q, q, st, rows, rows, 0, 0)


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


def _record(monkeypatch, names, calls):
    for name in names:
        fn = getattr(tfa, name)
        monkeypatch.setattr(tfa, name, lambda *a, _fn=fn, _n=name, **k: calls.append(_n) or
                            _fn(*a, **k))


@pytest.mark.parametrize("kd,heads", [(32, 2), (96, 2), (64, 3)])
def test_mha_forward_off_a_mesh_takes_the_seq_major_kernels(kd, heads, monkeypatch):
    """Self-attention at d = 32 and 96, and at d=64 with an odd head count
    (no head pair), rides the seq-major wrappers flash_fwd, flash_delta and
    flash_bwd (their plain versions on the CPU), forward and backward, with
    no transposes into the per-head layout and no dense attention."""
    ta, x, weights, ref = _attention_case(kd, heads, seed=kd + heads)
    calls = []
    _record(monkeypatch, ("flash_fwd_plain", "flash_delta_plain", "flash_bwd_plain",
                          "flash_fwd_bhsd_plain"), calls)
    tops._dense_context.calls = tra.ring_attention_block.calls = 0
    tx = torch.tensor(x, requires_grad=True)
    got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in weights])[0]
    got.sum().backward()
    assert calls == ["flash_fwd_plain", "flash_delta_plain", "flash_bwd_plain"]
    assert tops._dense_context.calls == 0 and tra.ring_attention_block.calls == 0
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_mha_forward_under_flash_mesh_takes_the_per_head_kernels_at_d256(monkeypatch):
    """Under a flash_mesh (the data-parallel trainer), BERT's heads of 256
    take the per-head wrappers forward and backward, and no dense
    attention."""
    ta, x, weights, ref = _attention_case(256, 2, seed=7)
    calls = []
    _record(monkeypatch, ("flash_fwd_bhsd_plain", "flash_delta_bhsd_plain",
                          "flash_bwd_bhsd_plain", "flash_fwd_plain"), calls)
    tops._dense_context.calls = 0
    tx = torch.tensor(x, requires_grad=True)
    with tfa.flash_mesh(None):
        got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in weights])[0]
        got.sum().backward()
    assert calls == ["flash_fwd_bhsd_plain", "flash_delta_bhsd_plain", "flash_bwd_bhsd_plain"]
    assert tops._dense_context.calls == 0
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)


def test_head_dims_past_256_take_the_kernels_wrappers(monkeypatch):
    """d = 264 rides the seq-major wrappers off a mesh, as every narrower d
    does (the wide kernels take it on the card), forward and backward, with
    no dense attention, and matches the JAX package's forward."""
    ta, x, weights, ref = _attention_case(264, 2, seed=11)
    calls = []
    _record(monkeypatch, ("flash_fwd_plain", "flash_delta_plain", "flash_bwd_plain",
                          "flash_fwd_bhsd_plain"), calls)
    tops._dense_context.calls = tra.ring_attention_block.calls = 0
    tx = torch.tensor(x, requires_grad=True)
    got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in weights])[0]
    got.sum().backward()
    assert calls == ["flash_fwd_plain", "flash_delta_plain", "flash_bwd_plain"]
    assert tops._dense_context.calls == 0 and tra.ring_attention_block.calls == 0
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=1e-5, atol=1e-5)
