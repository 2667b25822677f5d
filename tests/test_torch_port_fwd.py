"""The contract the port's one forward mainloop (csrc/flash_fwd_sm90.cuh)
relies on, checked through the plain versions of the wrappers it serves:
a ring forward step from the empty carry, finalised (o = acc / l,
lse = m + log l), is the flash forward, so `ring_fwd_step` and
`flash_fwd_bhsd` share one body and differ only in their epilogues.

Both are held against the JAX package's `_fwd` Pallas kernel in interpret
mode, from the same numpy inputs in f32, at head dims 64 and 128, causal and
not, at s = 192 (s % 128 == 64: the last 128-row block of the Hopper
kernels has one warpgroup of rows) and s = 256. A step split in two at a
tile boundary must give what one step gives, and a step whose first 64
query rows see no key must leave those rows' carried state as it was.

Tolerance: f32 on every side with the same arithmetic, summed in another
order and tiling, so o and lse of order one agree to atol 1e-5 (the JAX
package's own forward bound, tests/test_flash_attention.py) and rtol 1e-5.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flexflow_tpu.kernels import flash_attention as jfa
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ring_flash as trf

B, H = 1, 2
TOL = dict(rtol=1e-5, atol=1e-5)
LN2 = math.log(2.0)
CASES = pytest.mark.parametrize("d,causal,s", [(d, causal, s) for d in (64, 128)
                                               for causal in (False, True) for s in (192, 256)])


def _inputs(seed, s, d, t=None):
    rs = np.random.RandomState(seed)
    t = s if t is None else t
    return [rs.randn(B, H, rows, d).astype(np.float32) for rows in (s, t, t)]


def _empty(s, d):
    return (torch.zeros(B, H, s, d), torch.full((B, H, s), trf.NEG_INF), torch.zeros(B, H, s))


def _finalise(acc, m, l):
    return acc / l[..., None], m + torch.log(l)


def _jax_fwd(q, k, v, causal):
    s, d = q.shape[2:]
    rows = lambda x: jnp.asarray(x.reshape(B * H, s, d))  # noqa: E731
    o, lse2 = jfa._fwd(rows(q), rows(k), rows(v), causal, 64, 64, interpret=True)
    return np.asarray(o).reshape(q.shape), np.asarray(lse2).reshape(B, H, s) * LN2


@CASES
def test_ring_step_from_the_empty_carry_is_the_flash_forward(d, causal, s):
    q, k, v = _inputs(d + s + int(causal), s, d)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    state = _empty(s, d)
    trf.ring_fwd_step(tq, tk, tv, *state, 0, 0, causal)
    o_ring, lse_ring = _finalise(*state)
    o_flash, lse_flash = tfa.flash_fwd_bhsd(tq, tk, tv, causal)
    o_jax, lse_jax = _jax_fwd(q, k, v, causal)
    for o, lse in ((o_ring, lse_ring), (o_flash, lse_flash)):
        np.testing.assert_allclose(o.numpy(), o_jax, **TOL)
        np.testing.assert_allclose(lse.numpy(), lse_jax, **TOL)


@CASES
def test_a_step_split_at_a_key_tile_is_one_step(d, causal, s):
    """Keys [0, 128) then [128, t) fold into the state as all t keys at once:
    the mainloop's key tiles may end anywhere a 128-row tile does."""
    q, k, v = map(torch.from_numpy, _inputs(3 * d + s, s, d))
    whole = _empty(s, d)
    trf.ring_fwd_step(q, k, v, *whole, 0, 0, causal)
    split = _empty(s, d)
    trf.ring_fwd_step(q, k[:, :, :128], v[:, :, :128], *split, 0, 0, causal)
    trf.ring_fwd_step(q, k[:, :, 128:], v[:, :, 128:], *split, 0, 128, causal)
    for a, b in zip(_finalise(*whole), _finalise(*split)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("d", [64, 128])
def test_rows_that_see_no_key_keep_their_carried_state(d):
    """k_off - q_off = 64 under the causal mask: the first 64 query rows (one
    warpgroup of the Hopper kernel) see no key of this block and keep their
    carried state bitwise; the next 64 see part of it."""
    rs = np.random.RandomState(d)
    q, k, v = (torch.from_numpy(rs.randn(B, H, 128, d).astype(np.float32)) for _ in range(3))
    acc = torch.from_numpy(rs.randn(B, H, 128, d).astype(np.float32))
    m = torch.from_numpy(rs.randn(B, H, 128).astype(np.float32))
    l = torch.from_numpy(rs.uniform(1.0, 3.0, (B, H, 128)).astype(np.float32))
    carried = [x.clone() for x in (acc, m, l)]
    trf.ring_fwd_step(q, k, v, acc, m, l, 0, 64, True)
    for got, was in zip((acc, m, l), carried):
        assert torch.equal(got[:, :, :64], was[:, :, :64])
        assert not torch.equal(got[:, :, 64:], was[:, :, 64:])
