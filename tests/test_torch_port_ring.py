"""The ring-flash step kernels of the port (kernels/ring_flash.py) against
the JAX package's Pallas kernels (flexflow_tpu/kernels/ring_flash.py, in
interpret mode on the CPU), from the same numpy inputs in f32:

- each step's plain version against its Pallas kernel, at d = 64 and 128,
  causal and not, with the key block below the query block, on its
  diagonal, partly masked with another length (T > S, and S != T with both
  = 64 mod 128), and fully masked; a step that carries state adds its dq,
  dk and dv into seeded nonzero accumulators, as the kernels must;
- the ring schedule of 4 ranks replayed in one process through the step
  functions, against the JAX ring on a 4-device virtual mesh, for the
  output and the gradients of q, k and v;
- the dense ring fallback against the flash ring, and the gate.

The JAX kernels keep m and lse in base 2: m_jax = m * log2(e). Tolerance:
f32 on both sides with the same arithmetic, summed in another order and
tiling, so values of order one agree to rtol 1e-5 and atol 1e-5 (sums of a
few hundred terms).
"""

import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from flexflow_tpu.kernels import ring_flash as jrf
from flexflow_tpu.utils.shard_map_compat import shard_map_compat
from flexflow_tpu_torch.kernels import build
from flexflow_tpu_torch.kernels import flash_attention as tfa
from flexflow_tpu_torch.kernels import ring_flash as trf
from flexflow_tpu_torch.kernels.ring_attention import ring_attention_block

LOG2E = math.log2(math.e)
TOL = dict(rtol=1e-5, atol=1e-5)
B, H = 1, 2

# (s_blk, t_blk, q_off, k_off, carry) of each case; carry: state carried in
# from an earlier step (else the empty state of the ring's first step)
CASES = {
    "below": (128, 128, 256, 0, True),
    "diagonal": (128, 128, 128, 128, False),
    "partial": (128, 256, 128, 0, True),  # t_blk != s_blk, rows see part of the block
    "masked": (128, 128, 0, 128, True),  # every key in the masked future
    "uneven": (320, 192, 192, 64, True),  # s_blk != t_blk, each a half-full 128-row block
}
PARAMS = [(d, causal, case) for d in (64, 128) for causal in (True, False)
          for case in CASES if causal or case in ("diagonal", "partial", "uneven")]


def _inputs(d, s_blk, t_blk, carry, seed):
    rs = np.random.RandomState(seed)
    q = rs.randn(B, H, s_blk, d).astype(np.float32)
    k = rs.randn(B, H, t_blk, d).astype(np.float32)
    v = rs.randn(B, H, t_blk, d).astype(np.float32)
    do = rs.randn(B, H, s_blk, d).astype(np.float32)
    if carry:
        acc = rs.randn(B, H, s_blk, d).astype(np.float32)
        m = rs.randn(B, H, s_blk).astype(np.float32)
        l = rs.uniform(1.0, 3.0, (B, H, s_blk)).astype(np.float32)
    else:
        acc = np.zeros((B, H, s_blk, d), np.float32)
        m = np.full((B, H, s_blk), trf.NEG_INF, np.float32)
        l = np.zeros((B, H, s_blk), np.float32)
    # an lse at or above each row's max score keeps every probability <= 1
    scores = q @ k.transpose(0, 1, 3, 2) / math.sqrt(d)
    lse = (np.log(np.exp(scores - scores.max(-1, keepdims=True)).sum(-1))
           + scores.max(-1) + 0.5).astype(np.float32)
    delta = rs.randn(B, H, s_blk).astype(np.float32)
    x = dict(q=q, k=k, v=v, do=do, acc=acc, m=m, l=l, lse=lse, delta=delta)
    # the gradient accumulators the steps add into: earlier steps' sums, or 0
    for name, rows in (("dq", s_blk), ("dk", t_blk), ("dv", t_blk)):
        x[name] = (rs.randn(B, H, rows, d) if carry else np.zeros((B, H, rows, d))).astype(
            np.float32)
    return x


def _jax_steps(x, q_off, k_off, causal):
    """(acc, m, l, dq, dk, dv) of the Pallas step kernels, m in natural log;
    the Pallas dq and dk/dv steps return this step's part alone, so the
    carried accumulators are added to it."""
    bh = lambda a: jnp.asarray(a.reshape(B * H, *a.shape[2:]))  # noqa: E731
    rows = lambda a: jnp.asarray(a.reshape(B * H, 1, a.shape[-1]))  # noqa: E731
    q, k, v, do = (bh(x[n]) for n in ("q", "k", "v", "do"))
    args = (q_off, k_off, causal, 64, 64, True)
    acc, m, l = jrf._ring_fwd_step(q, k, v, bh(x["acc"]), rows(x["m"] * LOG2E), rows(x["l"]),
                                   *args)
    lse, delta = rows(x["lse"] * LOG2E), rows(x["delta"])
    dq = jrf._ring_dq_step(q, k, v, do, lse, delta, *args)
    dk, dv = jrf._ring_dkv_step(q, k, v, do, lse, delta, *args)
    back = lambda a: np.asarray(a).reshape(B, H, *a.shape[1:])  # noqa: E731
    return (back(acc), np.asarray(m).reshape(B, H, -1) / LOG2E, np.asarray(l).reshape(B, H, -1),
            x["dq"] + back(dq), x["dk"] + back(dk), x["dv"] + back(dv))


def _port_steps(x, q_off, k_off, causal):
    t = {n: torch.tensor(a) for n, a in x.items()}
    acc, m, l = t["acc"].clone(), t["m"].clone(), t["l"].clone()
    trf.ring_fwd_step(t["q"], t["k"], t["v"], acc, m, l, q_off, k_off, causal)
    args = (t["q"], t["k"], t["v"], t["do"], t["lse"], t["delta"])
    dq, dk, dv = t["dq"].clone(), t["dk"].clone(), t["dv"].clone()
    trf.ring_dq_step(*args, dq, q_off, k_off, causal)
    trf.ring_dkv_step(*args, dk, dv, q_off, k_off, causal)
    return tuple(a.numpy() for a in (acc, m, l, dq, dk, dv))


@pytest.mark.parametrize("d,causal,case", PARAMS)
def test_step_plain_versions_match_the_pallas_kernels(d, causal, case):
    s_blk, t_blk, q_off, k_off, carry = CASES[case]
    x = _inputs(d, s_blk, t_blk, carry, seed=d + 7 * list(CASES).index(case))
    got = _port_steps(x, q_off, k_off, causal)
    want = _jax_steps(x, q_off, k_off, causal)
    for name, g, w in zip(("acc", "m", "l", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
    if case == "masked":
        # a step that sees only masked keys leaves the state and the
        # gradient accumulators as they were
        for name, g in zip(("acc", "m", "l", "dq", "dk", "dv"), got):
            assert np.array_equal(g, x[name]), name


def _jax_ring(q, k, v, w, causal, sp):
    mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
    spec = P(None, None, "sp", None)

    def body(qb, kb, vb):
        return jrf.ring_flash_attention_block(qb, kb, vb, ("sp",), sp, causal, block_q=64,
                                              block_k=64, interpret=True)

    ring = shard_map_compat(body, mesh=mesh, in_specs=(spec,) * 3, out_specs=spec)

    def loss(q, k, v):
        place = [jax.device_put(a, NamedSharding(mesh, spec)) for a in (q, k, v)]
        return jnp.sum(ring(*place) * w), ring(*place)

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(q, k, v)
    return [np.asarray(a) for a in (out, *grads)]


@pytest.mark.parametrize("causal", [False, True])
def test_ring_replay_of_four_ranks_matches_the_jax_ring(causal):
    sp, d, s = 4, 64, 512
    rs = np.random.RandomState(11)
    q, k, v, w = (rs.randn(B, H, s, d).astype(np.float32) for _ in range(4))
    want = _jax_ring(*(jnp.asarray(a) for a in (q, k, v, w)), causal, sp)
    got = trf.replay_ring(*(torch.tensor(a) for a in (q, k, v, w)), sp, causal)
    for name, g, x in zip(("o", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), x, err_msg=name, **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_dense_ring_matches_the_flash_ring_in_a_ring_of_one(causal):
    """The dense fallback (autograd through materialized per-step scores)
    and the flash ring (the step functions' own backward) agree, forward and
    backward."""
    rs = np.random.RandomState(12)
    x = [torch.tensor(rs.randn(2, 2, 128, 64).astype(np.float32)) for _ in range(4)]
    outs = []
    for fn in (ring_attention_block, trf.ring_flash_attention_block):
        q, k, v = (t.clone().requires_grad_(True) for t in x[:3])
        o = fn(q, k, v, trf.SequenceRing(), causal)
        (o * x[3]).sum().backward()
        outs.append([o.detach(), q.grad, k.grad, v.grad])
    for name, a, b in zip(("o", "dq", "dk", "dv"), *outs):
        np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=name, **TOL)


def test_gate_follows_the_kernels():
    cpu, f32, bf16 = torch.device("cpu"), torch.float32, torch.bfloat16
    q, kv = (2, 4, 256, 128), (2, 4, 512, 128)
    assert trf.ring_flash_supported(q, kv, kv, f32, cpu)
    assert trf.ring_flash_supported(q, kv, kv, bf16, "cuda")
    assert not trf.ring_flash_supported(q, kv, kv, f32, "cuda")  # the kernels are bf16
    assert not trf.ring_flash_supported((2, 4, 256, 32), (2, 4, 256, 32), (2, 4, 256, 32), f32, cpu)
    assert not trf.ring_flash_supported((2, 4, 96, 64), (2, 4, 96, 64), (2, 4, 96, 64), f32, cpu)
    assert not trf.ring_flash_supported(q, kv, (2, 4, 512, 64), f32, cpu)  # vd != kd


def test_step_wrappers_raise_off_the_cpu_and_count_only_launches():
    q = torch.empty(1, 1, 64, 64, dtype=torch.bfloat16, device="meta")
    st = torch.empty(1, 1, 64, 64, dtype=torch.float32, device="meta")
    rows = torch.empty(1, 1, 64, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        trf.ring_fwd_step(q, q, q, st, rows, rows, 0, 0)
    with pytest.raises(ValueError, match="CPU or a CUDA device"):
        trf.ring_dkv_step(q, q, q, q, rows, rows, st, st, 0, 0)
    assert {trf.ring_fwd_step, trf.ring_dq_step, trf.ring_dkv_step} <= set(tfa.KERNEL_WRAPPERS)
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    x = [torch.randn(1, 1, 64, 64) for _ in range(3)]
    trf.replay_ring(*x, x[0], 1, True)  # plain versions on the CPU
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before


def test_profile_step_groups_the_ring_kernels_with_the_port_kernels():
    from flexflow_tpu_torch import profile_step

    for name in ("ff_ring_fwd_step_kernel", "ff_ring_dq_step_d64_kernel",
                 "ff_ring_dkv_step_kernel", "ff_flash_delta_bhsd_kernel"):
        assert profile_step.group_of(name) == "flash attention (port kernels)"


def test_c_interface_matches_the_declared_signatures():
    """Every exported function the ring wrappers call is declared with as
    many ctypes arguments as the CUDA source (with its shared headers) gives
    it parameters, and both head dims have their kernels; each step is a
    shared Hopper mainloop with a ring epilogue, fed tensor maps: the
    forward's, and the backward's dQ (a grid over the S query rows) and
    dK/dV (over the T key rows) adding into the f32 accumulators."""
    src = "".join((build.CSRC_DIR / f).read_text()
                  for f in ("ring_flash.cu", "flash_tiles.cuh", "flash_fwd_sm90.cuh",
                            "flash_bwd_sm90.cuh"))
    for name, (argtypes, _) in trf._SIGNATURES.items():
        m = re.search(r'extern "C" [\w\s\*]+?\b' + name + r"\(([^)]*)\)", src)
        assert m, name
        assert len(m.group(1).split(",")) == len(argtypes), name
    for kind in ("FWD", "DQ", "DKV"):
        for d in tfa.HEAD_DIMS:
            assert re.search(rf"RING_{kind}_KERNEL\(ff_ring_\w+, {d}\)", src), (kind, d)
    assert "fwd_mainloop<D>(tq, tk, tv, RingEpilogue<D>" in src
    assert re.search(r"RING_FWD_KERNEL\(NAME, D\)[^}]*__grid_constant__ CUtensorMap tq", src)
    assert "dq_mainloop<D>(tq, tk, tv, tdo, lse, delta, RingGradEpilogue<D>{dq, S}," in src
    assert ("dkv_mainloop<D>(tq, tk, tv, tdo, lse, delta, RingGradEpilogue<D>{dk, T},\n"
            "                  RingGradEpilogue<D>{dv, T}, FwdShape{S, T, H, q_off, k_off") in src
    for kind in ("DQ", "DKV"):
        macro = re.search(rf"#define RING_{kind}_KERNEL\(NAME, D\)(.*?)\n\n", src, re.S).group(1)
        assert "__launch_bounds__(BWD_THREADS, 1)" in macro, kind
        assert macro.count("const __grid_constant__ CUtensorMap") == 4, kind
        assert "__grid_constant__ CUtensorMap tdo" in macro, kind
    # q and dout map S rows, k and v T rows; dQ's grid covers S, dK/dV's T
    for i, operand in enumerate(("q, lq, S", "k, lk, T", "v, lv, T", "dout, lo, S")):
        assert f"fwd_tensor_map<D>(&maps[{i}], {operand}, H, B, BWD_BN)" in src
    assert src.count("bwd_tensor_maps<D>(maps, q, lq, k, lk, v, lv, dout, lo, S, T, H, B)") == 2
    assert "bwd_grid(S, H, B), BWD_THREADS, BwdTiles<D>::DQ_SMEM" in src
    assert "bwd_grid(T, H, B), BWD_THREADS, BwdTiles<D>::DKV_SMEM" in src
    assert "ring_flash.cu" in build.SOURCES
