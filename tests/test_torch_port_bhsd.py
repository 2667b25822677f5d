"""The per-head [b, h, s, d] flash-attention path of the PyTorch port
against the JAX package's Pallas kernels run in interpret mode, on the same
numpy inputs: `_fwd` (batch-folded `_fwd_kernel_b` when s fits one block,
the `_fwd_kernel` loop otherwise), `_delta_rows`, `_bwd_rows_fused` (s <=
block) and the tiled `_bwd` (s > block), and the `flash_attention` entry
under jax.grad, at head dims 128 and 64, causal and not.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
CUDA kernels are held against those plain versions on the card by
chip_smoke.py. Tolerances are the JAX package's own bounds for these
kernels (tests/test_flash_attention.py): atol 1e-5 for o, lse and delta,
2e-4 for the gradients."""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ops as tops
from flexflow_tpu_torch.op_attrs import ops as tattrs

B, H, S = 2, 2, 256
BLOCK = 64  # explicit blocks of the looped/tiled cases: four q and four k tiles
LN2 = math.log(2.0)
DIMS = pytest.mark.parametrize("d", [128, 64])
CAUSAL = pytest.mark.parametrize("causal", [False, True])


def _inputs(seed, d, n=4):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, H, S, d).astype(np.float32) for _ in range(n)]


def _rows(x):
    """[b, h, s, d] -> the JAX kernels' [b*h, s, d]."""
    return jnp.asarray(x.reshape(B * H, S, x.shape[-1]))


def _jax_fwd(q, k, v, causal, block):
    o, lse2 = jfa._fwd(_rows(q), _rows(k), _rows(v), causal, block, block, interpret=True)
    # base-2 [b*h, s] -> natural log [b, h, s]
    return o, lse2, np.array(o).reshape(q.shape), np.array(lse2).reshape(B, H, S) * LN2


@pytest.fixture
def looped(monkeypatch):
    """One (batch*head) row per program, as the seq-2048 flagship runs."""
    monkeypatch.setenv("FLEXFLOW_TPU_FLASH_BATCH_BLOCK", "1")


@DIMS
@CAUSAL
def test_forward_matches_folded_pallas(d, causal):
    """s fits one block: the batch-folded _fwd_kernel_b."""
    assert jfa._batch_block(B * H, S, S, S, d, 4) > 1
    q, k, v = _inputs(0, d, 3)
    _, _, o_ref, lse_ref = _jax_fwd(q, k, v, causal, S)
    o, lse = tfa.flash_fwd_bhsd_plain(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5)


@DIMS
@CAUSAL
def test_forward_matches_looped_pallas(d, causal, looped):
    """s > block: the online-softmax loop of _fwd_kernel."""
    assert jfa._batch_block(B * H, BLOCK, BLOCK, S, d, 4) == 1
    q, k, v = _inputs(1, d, 3)
    _, _, o_ref, lse_ref = _jax_fwd(q, k, v, causal, BLOCK)
    o, lse = tfa.flash_fwd_bhsd_plain(*map(torch.from_numpy, (q, k, v)), causal)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5)


@DIMS
@pytest.mark.parametrize("s", [S, 192])
def test_delta_matches_pallas_rows(d, s):
    """_delta_rows, at s = 192 too; at s = S o is the forward's output."""
    if s == S:
        q, k, v, do = _inputs(2, d)
        o = _jax_fwd(q, k, v, False, S)[2]
    else:
        rs = np.random.RandomState(2)
        do, o = (rs.randn(B, H, s, d).astype(np.float32) for _ in range(2))
    ref = jfa._delta_rows(*(jnp.asarray(x.reshape(B * H, s, d)) for x in (do, o)),
                          interpret=True)
    got = tfa.flash_delta_bhsd_plain(torch.from_numpy(do), torch.from_numpy(o))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref).reshape(B, H, s), atol=1e-5)


def _port_bwd(q, k, v, do, o, lse_nat, causal):
    tq, tk, tv, tdo, to = map(torch.from_numpy, (q, k, v, do, o))
    delta = tfa.flash_delta_bhsd_plain(tdo, to)
    return tfa.flash_bwd_bhsd_plain(tq, tk, tv, tdo, torch.from_numpy(lse_nat), delta, causal)


@DIMS
@CAUSAL
def test_backward_matches_fused_pallas_rows(d, causal):
    """s fits one block: _bwd_rows_fused (with _delta_rows inside)."""
    q, k, v, do = _inputs(3, d)
    o_j, lse2, o, lse_nat = _jax_fwd(q, k, v, causal, S)
    ref = jfa._bwd_rows_fused(_rows(q), _rows(k), _rows(v), o_j, lse2, _rows(do), causal,
                              interpret=True)
    for a, r in zip(_port_bwd(q, k, v, do, o, lse_nat, causal), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r).reshape(q.shape), atol=2e-4)


@DIMS
@CAUSAL
def test_backward_matches_tiled_pallas(d, causal, looped):
    """s > block: the tiled _bwd_dq_kernel and _bwd_dkv_kernel of _bwd."""
    q, k, v, do = _inputs(4, d)
    o_j, lse2, o, lse_nat = _jax_fwd(q, k, v, causal, BLOCK)
    ref = jfa._bwd(_rows(q), _rows(k), _rows(v), o_j, lse2, _rows(do), causal, BLOCK, BLOCK,
                   interpret=True)
    for a, r in zip(_port_bwd(q, k, v, do, o, lse_nat, causal), ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(r).reshape(q.shape), atol=2e-4)


@pytest.mark.parametrize("block", [None, BLOCK], ids=["fused", "tiled"])
@DIMS
@CAUSAL
def test_autograd_matches_jax_flash_attention(block, d, causal):
    q, k, v, w = _inputs(5, d)

    def jloss(q, k, v):
        o = jfa.flash_attention(q, k, v, causal=causal, block_q=block, block_k=block,
                                interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    (tfa.flash_attention(tq, tk, tv, causal) * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-4)


def test_strided_projection_view_gives_the_same_attention():
    """The per-head projection einsum returns a [b, s, h, d] buffer viewed
    as [b, h, s, d]: the kernels read it in place, and the function is the
    same as on contiguous operands."""
    rs = np.random.RandomState(6)
    x = torch.from_numpy(rs.randn(B, S, 256).astype(np.float32))
    w = torch.from_numpy(rs.randn(256, 128, H).astype(np.float32))
    view = torch.einsum("bsq,qkh->bhsk", x, w)
    assert not view.is_contiguous() and tfa.bhsd_readable(view)
    assert not tfa.bhsd_readable(view.transpose(-1, -2))
    got = tfa.flash_attention(view, view, view, True)
    want = tfa.flash_attention(*(view.contiguous() for _ in range(3)), True)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)


@CAUSAL
def test_mha_under_flash_mesh_takes_the_per_head_entry(causal, monkeypatch):
    """Under flash_mesh, _mha_forward projects per head and calls
    sharded_flash_attention; the result is the dense path's."""
    attrs = tattrs.MultiHeadAttentionAttrs(embed_dim=256, num_heads=H, kdim=128, vdim=128)
    rs = np.random.RandomState(7)
    x = torch.from_numpy(rs.randn(B, S, 256).astype(np.float32))
    weight = torch.from_numpy(rs.randn(4 * 256 * 128, H).astype(np.float32) * 0.05)
    calls = []
    monkeypatch.setattr(tops, "sharded_flash_attention",
                        lambda *a: calls.append(a) or tfa.sharded_flash_attention(*a))
    with tfa.flash_mesh(None):
        assert tfa.current_flash_mesh() == (None,)
        got = tops._mha_forward(attrs, x, x, x, weight, causal=causal)
    assert tfa.current_flash_mesh() is None and len(calls) == 1
    want = tops.dense_attention(attrs, x, x, x, weight, causal=causal)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-4)


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    q, k, v, do = map(torch.from_numpy, _inputs(8, 64))
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    o, lse = tfa.flash_fwd_bhsd(q, k, v, True)
    o_p, lse_p = tfa.flash_fwd_bhsd_plain(q, k, v, True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = tfa.flash_delta_bhsd(do, o)
    assert torch.equal(delta, tfa.flash_delta_bhsd_plain(do, o))
    for a, b in zip(tfa.flash_bwd_bhsd(q, k, v, do, lse, delta, True),
                    tfa.flash_bwd_bhsd_plain(q, k, v, do, lse, delta, True)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before


@pytest.mark.parametrize(
    "shape,dtype,device,ok",
    [
        ((2, 8, 512, 128), torch.bfloat16, "cuda", True),
        ((2, 16, 512, 64), torch.bfloat16, "cuda", True),
        ((2, 3, 512, 64), torch.bfloat16, "cuda", True),  # any head count per head
        ((2, 8, 512, 128), torch.float32, "cuda", False),  # kernels take bf16
        ((2, 8, 100, 128), torch.bfloat16, "cuda", False),  # s not a tile multiple
        ((2, 8, 512, 32), torch.bfloat16, "cuda", False),  # d=32
        ((2, 512, 1024), torch.bfloat16, "cuda", False),  # not per-head
        ((2, 8, 512, 128), torch.float32, "cpu", True),  # plain versions
    ],
)
def test_per_head_gate_follows_the_kernels(shape, dtype, device, ok):
    assert tfa.flash_attention_supported(shape, shape, shape, dtype, device) is ok
    assert tfa.sharded_flash_supported(shape, shape, shape, dtype, device) is ok


def test_per_head_gate_wants_one_shape():
    q = (2, 8, 512, 128)
    assert not tfa.flash_attention_supported(q, (2, 8, 256, 128), q, torch.bfloat16, "cuda")
    assert not tfa.flash_attention_supported(q, q, (2, 8, 512, 64), torch.bfloat16, "cuda")


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: _meta(2, 2, 128, 64).transpose(-1, -2), "unit stride"),
        (lambda: _meta(2, 2, 64, 130)[..., :128], "multiples of 8"),
        (lambda: _meta(2, 2, 64, 128, dtype=torch.float32), "bf16"),
        (lambda: _meta(2, 2, 64, 32), "d in"),
        (lambda: _meta(2, 2, 100, 128), "multiple of 64"),
        (lambda: _meta(2, 2, 64, 128), "CPU or a CUDA device"),
    ],
)
def test_wrappers_raise_on_a_layout_the_kernels_cannot_read(make, match):
    q = make()
    with pytest.raises(ValueError, match=match):
        tfa.flash_fwd_bhsd(q, q, q)
    with pytest.raises(ValueError, match=match):
        tfa.flash_delta_bhsd(q, q)
    rows = torch.empty(q.shape[:3], dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match=match):
        tfa.flash_bwd_bhsd(q, q, q, q, rows, rows)


@pytest.mark.parametrize("offset,match", [(0, None), (1, "16-byte aligned"), (4, None)])
def test_lse_and_delta_rows_must_start_16_byte_aligned(offset, match):
    """The backward copies lse and delta rows in bulk, which needs a
    16-byte-aligned start: a view at an odd f32 offset is refused."""
    rows = torch.zeros(4 + 2 * 2 * 64)[offset:offset + 2 * 2 * 64].view(2, 2, 64)
    assert rows.is_contiguous()
    if match is None:
        tfa._check_rows("lse", rows, 2, 2, 64, rows.device)
    else:
        with pytest.raises(ValueError, match=match):
            tfa._check_rows("lse", rows, 2, 2, 64, rows.device)


def test_wrappers_refuse_operands_of_differing_strides():
    q = _meta(2, 2, 64, 128)
    k = _meta(2, 64, 2, 128).transpose(1, 2)
    with pytest.raises(ValueError, match="share strides"):
        tfa.flash_fwd_bhsd(q, k, k)


def test_c_interface_matches_the_declared_signatures():
    """Every exported function the wrappers call is declared with as many
    ctypes arguments as the CUDA source (with its shared header) gives it
    parameters."""
    src = "".join((build.CSRC_DIR / f).read_text() for f in ("flash_attention.cu", "flash_tiles.cuh"))
    for name, (argtypes, _) in tfa._SIGNATURES.items():
        m = re.search(r'extern "C" [\w\s\*]+?\b' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    for d in tfa.HEAD_DIMS:
        suffix = "" if d == 128 else "_d64"
        assert f"FLASH_DELTA_KERNEL(ff_flash_delta_bhsd{suffix}_kernel, {d})" in src
