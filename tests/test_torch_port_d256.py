"""Rows 1-3 of the kernel table at head dim 256 (BERT's heads, hidden 768
over 12 heads with kdim = 3072 / 12): the port's plain flash forward,
delta and backward at d=256 against the JAX package's Pallas kernels run
in interpret mode (_fwd_bshf, _delta_bshf, _bwd_bshf_fused, and
flash_attention_bshf with its jax.vjp), non-causal and causal, at s = 256
and at s = 192 (the 64-row tile's edge). Also: on the CPU, _mha_forward
takes d=256 self-attention through the flash path's plain versions as it
does d=128, never through dense_attention; and the seq-major gate admits
d=256 on a CUDA device for bf16 only; and the d=256 kernels are the
Hopper mainloops (the forward's at 64-key tiles, the head-split backward
pair). Tolerances are
tests/test_torch_port_flash.py's: atol 1e-5 for o, lse and delta, 2e-4 for
the gradients."""

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
from flexflow_tpu_torch.op_attrs import ops as tattrs

B, H, D = 1, 2, 256
LN2 = math.log(2.0)


def _inputs(s, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, s, H * D).astype(np.float32) for _ in range(4)]


def _jax_fwd(q, k, v, s, causal):
    o, lse2 = jfa._fwd_bshf(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, causal, s, s,
                            interpret=True)
    return o, lse2


@pytest.mark.parametrize("causal", [False, True])
def test_forward_delta_backward_match_pallas(causal):
    """The three kernels one by one at s = 256, the shape the Pallas
    wrappers' single-block path takes."""
    s = 256
    q, k, v, do = _inputs(s, seed=causal)
    o_j, lse2_j = _jax_fwd(q, k, v, s, causal)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_d256(tq, tk, tv, H, causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse2_j)[:, :, 0, :] * LN2, atol=1e-5)

    to = torch.from_numpy(np.array(o_j))
    delta = tfa.flash_delta_d256(tdo, to, H)
    ref_delta = jfa._delta_bshf(jnp.asarray(do), o_j, B, s, H, D, interpret=True)
    np.testing.assert_allclose(delta.numpy(), np.asarray(ref_delta)[:, :, 0, :], atol=1e-5)

    ref = jfa._bwd_bshf_fused(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j, lse2_j,
                              jnp.asarray(do), H, causal, interpret=True)
    lse_nat = torch.from_numpy(np.asarray(lse2_j)[:, :, 0, :] * LN2)
    got = tfa.flash_bwd_d256(tq, tk, tv, tdo, lse_nat, delta, H, causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("s", [256, 192])
@pytest.mark.parametrize("causal", [False, True])
def test_autograd_matches_flash_attention_bshf_and_its_vjp(s, causal):
    q, k, v, w = _inputs(s, seed=10 + s + causal)

    def jfn(q, k, v):
        return jfa.flash_attention_bshf(q, k, v, H, causal=causal, interpret=True)

    o_ref, vjp = jax.vjp(jfn, *map(jnp.asarray, (q, k, v)))
    ref = vjp(jnp.asarray(w))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    o = tfa.flash_attention_bshf(tq, tk, tv, H, causal)
    (o * torch.from_numpy(w)).sum().backward()
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before  # plain versions on the CPU
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref), atol=1e-5)
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-4)


@pytest.mark.parametrize("kd", [128, 256])
def test_mha_forward_routes_through_the_flash_path(kd, monkeypatch):
    """Self-attention at d = 128 and 256 takes FlashAttentionBSHF (whose
    wrappers run the plain versions on the CPU), and matches the JAX
    package's forward; dense_attention is never called."""
    e, heads, s = 64, 2, 128
    ja = jattrs.MultiHeadAttentionAttrs(embed_dim=e, num_heads=heads, kdim=kd, vdim=kd, bias=True)
    ta = tattrs.MultiHeadAttentionAttrs(embed_dim=e, num_heads=heads, kdim=kd, vdim=kd, bias=True)
    rs = np.random.RandomState(kd)
    x = rs.randn(2, s, e).astype(np.float32)
    w = (rs.randn(3 * e * kd + kd * e, heads) * 0.05).astype(np.float32)
    bias, out_b = rs.randn(3 * kd).astype(np.float32), rs.randn(e).astype(np.float32)
    calls = []
    plain = tfa.flash_fwd_plain
    monkeypatch.setattr(tfa, "flash_fwd_plain", lambda *a, **k: calls.append(a[0].shape) or
                        plain(*a, **k))

    def no_dense(*args, **kwargs):
        raise AssertionError("dense_attention called")

    monkeypatch.setattr(tops, "dense_attention", no_dense)
    tx = torch.from_numpy(x)
    got = tops.forward(ta, [tx] * 3, [torch.from_numpy(a) for a in (w, bias, out_b)])
    assert calls == [(2, s, heads * kd)]
    ref = jops.forward(ja, [jnp.asarray(x)] * 3, [jnp.asarray(a) for a in (w, bias, out_b)])
    np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize(
    "shape,heads,dtype,device,ok",
    [
        ((64, 512, 3072), 12, torch.bfloat16, "cuda", True),  # BERT-base's attention
        ((64, 512, 3072), 12, torch.float32, "cuda", False),  # the kernels take bf16
        ((64, 512, 3072), 12, torch.float16, "cuda", False),
        ((2, 192, 256), 1, torch.bfloat16, "cuda", True),  # one head, s on the tile's edge
        ((2, 100, 512), 2, torch.bfloat16, "cuda", False),  # s not a tile multiple
        ((2, 128, 512), 2, torch.float32, "cpu", True),  # plain versions
    ],
)
def test_gate_admits_d256_on_cuda_for_bf16_only(shape, heads, dtype, device, ok):
    assert tfa.flash_attention_bshf_supported(shape, heads, dtype, device) is ok


def test_d256_kernels_are_the_hopper_mainloops():
    """The d=256 forward is the one forward mainloop at 64-key tiles; the
    backward pair is the head-split mainloops: 64-row blocks (the gate's
    tile), each warpgroup half of a streamed tile's 64 score columns and
    half of the 256 output columns, the scores shared through shared
    memory between two named barriers and made visible to wgmma; no
    mma.sync body is left."""
    src = "".join((build.CSRC_DIR / f).read_text()
                  for f in ("flash_attention.cu", "flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh"))
    assert not (build.CSRC_DIR / "flash_d256.cuh").exists()
    assert "FLASH_FWD_KERNEL(ff_flash_fwd_d256_kernel, 256)" in src
    assert "FLASH_BWD_KERNELS(ff_flash_bwd_dkv_d256_kernel, ff_flash_bwd_dq_d256_kernel, 256)" in src
    assert re.search(r"static constexpr int BN = D == 256 \? 64 : 128;", src)
    assert f"constexpr int SPLIT_ROWS = {tfa.TILE};" in src
    assert "constexpr int SPLIT_COLS = 32;" in src and "constexpr int SPLIT_HALF = 128;" in src
    for body, mainloop in (("dkv_body", "dkv_mainloop_d256"), ("dq_body", "dq_mainloop_d256")):
        head = src[src.index(f"__device__ __forceinline__ void {body}("):]
        assert mainloop + "(tq, tk, tv, tdo, lse, delta," in head[:head.index("\n}")], body
    for mainloop in ("dkv_mainloop_d256", "dq_mainloop_d256"):
        body = src[src.index(f"__device__ __forceinline__ void {mainloop}("):]
        body = body[:body.index("\n}\n")]
        assert body.count("consumers_sync();") == 2, mainloop
        assert body.count("fence_to_wgmma();") == 1, mainloop
        assert "atom" not in body and "mma.sync" not in body, mainloop
        assert "wgmma_ss_n32(" in body and "wgmma_ss_n128<1>(" in body, mainloop
    assert "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16" in src
    assert "bar.sync 1, 256;" in src and "fence.proxy.async.shared::cta;" in src
