"""The plain flash backwards of the PyTorch port against the JAX package's
tiled Pallas backwards run in interpret mode, at the sequence lengths whose
last 128-row block is half full (s % 128 == 64: s = 192, and s = 320 after
two full blocks), the tiling edge of the port's Hopper backward kernels.

- flash_bwd_plain (bshf, d = 128 and 64) against `_bwd_bshf` with 64-row
  q and k blocks (the tiled `_bwd_dq_kernel` and `_bwd_dkv_kernel`);
- flash_bwd_bhsd_plain (per-head [b, h, s, d]) against `_bwd`, which takes
  the same tiled kernels for s > block;
- flash_bwd_qkv_plain (the interleaved [q|k|v] projection, d = 64) against
  `_bwd_bshf_pair_fused_qkv`, whose single tile holds the whole sequence.

Both sides get the same numpy inputs, and the same o and lse (the port's
plain forward, lse handed to JAX in base 2). The CUDA kernels are held
against these plain versions on the card by chip_smoke.py at the same
sequence lengths. Tolerance: atol 2e-4, the JAX package's own bound for the
gradients (tests/test_flash_attention.py)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu_torch.kernels import flash_attention as tfa

B, F = 2, 256  # heads of 128 (2 of them) or of 64 (4)
BLOCK = 64  # the JAX tiled kernels' q and k blocks, which divide 192 and 320
LN2 = math.log(2.0)

CASES = [(entry, s, d, causal)
         for entry, dims in (("bshf", (128, 64)), ("bhsd", (128, 64)), ("qkv", (64,)))
         for s in (192, 320) for d in dims for causal in (False, True)]


def _bshf_case(s, d, causal, rs):
    h = F // d
    q, k, v, do = (rs.randn(B, s, F).astype(np.float32) for _ in range(4))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_plain(tq, tk, tv, h, causal)
    delta = tfa.flash_delta_plain(tdo, o, h)
    got = tfa.flash_bwd_plain(tq, tk, tv, tdo, lse, delta, h, causal)
    lse2 = (lse / LN2).numpy()[:, :, None, :]  # natural [b, h, s] -> base-2 [b, h, 1, s]
    ref = jfa._bwd_bshf(*map(jnp.asarray, (q, k, v, o.numpy(), lse2, do)), h, causal, BLOCK,
                        BLOCK, interpret=True)
    return got, ref


def _bhsd_case(s, d, causal, rs):
    h = F // d
    q, k, v, do = (rs.randn(B, h, s, d).astype(np.float32) for _ in range(4))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = tfa.flash_fwd_bhsd_plain(tq, tk, tv, causal)
    delta = tfa.flash_delta_bhsd_plain(tdo, o)
    got = tfa.flash_bwd_bhsd_plain(tq, tk, tv, tdo, lse, delta, causal)

    def rows(x):  # [b, h, s, d] -> the JAX kernels' [b*h, s, d]
        return jnp.asarray(x.reshape(B * h, s, x.shape[-1]))

    lse2 = (lse / LN2).numpy().reshape(B * h, s)
    ref = jfa._bwd(rows(q), rows(k), rows(v), rows(o.numpy()), jnp.asarray(lse2), rows(do),
                   causal, BLOCK, BLOCK, interpret=True)
    return got, [np.asarray(r).reshape(B, h, s, d) for r in ref]


def _qkv_case(s, d, causal, rs):
    h = F // d
    q, k, v, do = (rs.randn(B, s, F).astype(np.float32) for _ in range(4))
    qkv = tfa.interleave_qkv(*map(torch.from_numpy, (q, k, v)))
    tdo = torch.from_numpy(do)
    o, lse = tfa.flash_fwd_qkv_plain(qkv, h, causal)
    delta = tfa.flash_delta_plain(tdo, o, h)
    got = tfa.flash_bwd_qkv_plain(qkv, tdo, lse, delta, h, causal)
    lse2 = (lse / LN2).numpy()[:, :, None, :]
    ref = jfa._bwd_bshf_pair_fused_qkv(*map(jnp.asarray, (qkv.numpy(), o.numpy(), lse2, do)), h,
                                       causal, interpret=True)
    return (got,), (ref,)


@pytest.mark.parametrize("entry,s,d,causal", CASES)
def test_plain_backward_matches_tiled_pallas_at_half_blocks(entry, s, d, causal):
    assert s % 128 == BLOCK  # the last 128-row block of the Hopper kernels is half full
    rs = np.random.RandomState(s + d + causal)
    got, ref = {"bshf": _bshf_case, "bhsd": _bhsd_case, "qkv": _qkv_case}[entry](s, d, causal, rs)
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)
