"""Flash-attention kernel module of the PyTorch port against the JAX
package's Pallas kernels run in interpret mode, on the same numpy inputs.

The port's wrappers run their plain PyTorch versions on CPU tensors; the
CUDA kernels themselves are held against those plain versions on the card
by chip_smoke.py. Tolerances are the JAX package's own bounds for these
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
from flexflow_tpu_torch.kernels import ring_flash as trf

B, H, S, D = 2, 2, 256, 128
LN2 = math.log(2.0)


def _inputs(seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(B, S, H * D).astype(np.float32) for _ in range(4)]


def _jax_fwd(q, k, v, causal):
    o, lse2 = jfa._fwd_bshf(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), H, causal, S, S, interpret=True
    )
    # base-2 [b, h, 1, s] -> natural log [b, h, s]
    return np.array(o), np.array(lse2)[:, :, 0, :] * LN2, (o, lse2)


@pytest.mark.parametrize("causal", [False, True])
def test_forward_matches_pallas(causal):
    q, k, v, _ = _inputs(0)
    o_ref, lse_ref, _ = _jax_fwd(q, k, v, causal)
    o, lse = tfa.flash_fwd_plain(*map(torch.from_numpy, (q, k, v)), H, causal)
    np.testing.assert_allclose(o.numpy(), o_ref, atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), lse_ref, atol=1e-5)


@pytest.mark.parametrize("d,s", [(D, S), (D, 192), (64, S), (64, 192)])
def test_delta_matches_pallas(d, s):
    """_delta_bshf at both head dims (h*d = 256), at s = 192 too, which the
    card's delta tiles take as three 64-row runs; at (128, 256) o is the
    forward's output."""
    h = H * D // d
    if (d, s) == (D, S):
        q, k, v, do = _inputs(1)
        o = _jax_fwd(q, k, v, False)[0]
    else:
        rs = np.random.RandomState(1)
        do, o = (rs.randn(B, s, h * d).astype(np.float32) for _ in range(2))
    ref = jfa._delta_bshf(jnp.asarray(do), jnp.asarray(o), B, s, h, d, interpret=True)
    got = tfa.flash_delta_plain(torch.from_numpy(do), torch.from_numpy(o), h)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref)[:, :, 0, :], atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_pallas(causal):
    q, k, v, do = _inputs(2)
    o, lse_nat, (o_j, lse2_j) = _jax_fwd(q, k, v, causal)
    ref = jfa._bwd_bshf_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), o_j, lse2_j, jnp.asarray(do),
        H, causal, interpret=True,
    )
    tq, tk, tv, tdo, to = map(torch.from_numpy, (q, k, v, do, o))
    delta = tfa.flash_delta_plain(tdo, to, H)
    got = tfa.flash_bwd_plain(tq, tk, tv, tdo, torch.from_numpy(lse_nat), delta, H, causal)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_autograd_gradients_match_jax_grad(causal):
    q, k, v, w = _inputs(3)

    def jloss(q, k, v):
        o = jfa.flash_attention_bshf(q, k, v, H, causal=causal, interpret=True)
        return jnp.sum(o * jnp.asarray(w))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
    o = tfa.flash_attention_bshf(tq, tk, tv, H, causal)
    (o * torch.from_numpy(w)).sum().backward()
    for t, r in zip((tq, tk, tv), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(r), atol=2e-4)


def _jax_bwd_inputs(seed, causal):
    q, k, v, do = _inputs(seed)
    _, lse_nat, (o_j, lse2_j) = _jax_fwd(q, k, v, causal)
    tq, tk, tv, tdo, to = map(torch.from_numpy, (q, k, v, do, np.array(o_j)))
    delta = tfa.flash_delta_plain(tdo, to, H)
    got = tfa.flash_bwd_plain(tq, tk, tv, tdo, torch.from_numpy(lse_nat), delta, H, causal)
    return [jnp.asarray(x) for x in (q, k, v)] + [o_j, lse2_j, jnp.asarray(do)], got


def test_backward_matches_onepass_pallas():
    """The seq-2048 flagship's backward (_bwd_onepass_kernel, non-causal,
    nq <= 2): the port computes it with the same split kernels."""
    args, got = _jax_bwd_inputs(5, False)
    ref = jfa._bwd_bshf_onepass(*args, H, False, 128, 64, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


@pytest.mark.parametrize("causal", [False, True])
def test_backward_matches_tiled_pallas(causal):
    """The tiled dq and dk/dv kernels (_bwd_dq_kernel, _bwd_dkv_kernel),
    here with nq = 4 tiles."""
    args, got = _jax_bwd_inputs(6, causal)
    ref = jfa._bwd_bshf(*args, H, causal, 64, 64, interpret=True)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-4)


def test_wrappers_take_plain_path_on_cpu_and_count_no_launch():
    q, k, v, do = map(torch.from_numpy, _inputs(4))
    before = [fn.launches for fn in tfa.KERNEL_WRAPPERS]
    o, lse = tfa.flash_fwd(q, k, v, H, True)
    o_p, lse_p = tfa.flash_fwd_plain(q, k, v, H, True)
    assert torch.equal(o, o_p) and torch.equal(lse, lse_p)
    delta = tfa.flash_delta(do, o, H)
    assert torch.equal(delta, tfa.flash_delta_plain(do, o, H))
    for a, b in zip(tfa.flash_bwd(q, k, v, do, lse, delta, H, True),
                    tfa.flash_bwd_plain(q, k, v, do, lse, delta, H, True)):
        assert torch.equal(a, b)
    assert [fn.launches for fn in tfa.KERNEL_WRAPPERS] == before


@pytest.mark.parametrize(
    "shape,heads,dtype,device,ok",
    [
        ((2, 512, 1024), 8, torch.bfloat16, "cuda", True),
        ((2, 512, 1024), 8, torch.float32, "cuda", False),  # kernels take bf16
        ((2, 512, 1024), 16, torch.bfloat16, "cuda", True),  # d=64 kernels
        ((2, 100, 256), 2, torch.bfloat16, "cuda", False),  # s not a tile multiple
        ((2, 512, 1024), 8, torch.float32, "cpu", True),  # plain versions
        ((2, 512, 1024), 32, torch.bfloat16, "cuda", False),  # d=32
        ((2, 512, 192), 3, torch.bfloat16, "cuda", False),  # d=64, odd head count
    ],
)
def test_flash_gate_follows_the_kernels(shape, heads, dtype, device, ok):
    assert tfa.flash_attention_bshf_supported(shape, heads, dtype, device) is ok


def test_gate_constants_match_the_cuda_source():
    src = "".join((build.CSRC_DIR / f).read_text()
                  for f in ("flash_attention.cu", "flash_tiles.cuh", "flash_fwd_sm90.cuh",
                            "flash_bwd_sm90.cuh"))
    for d in tfa.HEAD_DIMS:
        assert re.search(rf"FLASH_FWD_KERNEL\(ff_flash_fwd_\w*kernel, {d}\)", src), d
        assert re.search(rf"FLASH_BWD_KERNELS\(ff_flash_bwd_dkv_\w*kernel, "
                         rf"ff_flash_bwd_dq_\w*kernel, {d}\)", src), d
        assert re.search(rf"FLASH_DELTA_KERNEL\(ff_flash_delta_\w*kernel, {d}\)", src), d
    # one delta body for all four delta kernels; its s tile is the gate's
    # tile, so no delta tile has a ragged s
    assert src.count("delta_body<D>(dout, od, o, ol, delta, S, H);") == 1
    assert "delta_rows_body" not in src
    assert f"constexpr int DELTA_S_TILE = {tfa.TILE};" in src
    # each FLASH_BWD_KERNELS pair calls the two bodies at its head dim
    assert "dkv_body<D>(&tq, &tk, &tv, &tdo," in src and "dq_body<D>(&tq, &tk, &tv, &tdo," in src
    assert "fwd_mainloop<D>(tq, tk, tv, FlashEpilogue<D>" in src
    assert "dkv_mainloop<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>" in src
    assert "dq_mainloop<D>(tq, tk, tv, tdo, lse, delta, FlashGradEpilogue<D>" in src
    assert f"constexpr int LANES = {tfa.LANES};" in src
    # every kernel of the port runs a Hopper mainloop: no source keeps the
    # warp-level tile API of the kernels they replaced
    for path in build.CSRC_DIR.glob("*.cu*"):
        text = path.read_text()
        assert "wmma" not in text and "<mma.h>" not in text, path.name
        assert "mma.sync" not in text and "ldmatrix" not in text, path.name
    # the forward's and the backward's blocks: warpgroups of TILE rows, two to
    # a block; streamed tiles a multiple of TILE whose tail (s % 128 == TILE,
    # which the gate admits) each kernel masks, and a warpgroup past the end
    # stores nothing
    for pre in ("FWD", "BWD"):
        assert f"constexpr int {pre}_WG_ROWS = {tfa.TILE};" in src
        assert f"constexpr int {pre}_BM = 2 * {pre}_WG_ROWS;" in src
    # the forward's key tile (FwdTiles<D>::BN) is 64 rows at d=256, else 128
    fwd_bn = re.search(r"static constexpr int BN = D == 256 \? (\d+) : (\d+);", src)
    bn = {"FWD_D256": int(fwd_bn.group(1)), "FWD": int(fwd_bn.group(2)),
          "BWD": int(re.search(r"constexpr int BWD_BN = (\d+);", src).group(1))}
    for pre, rows in bn.items():
        assert rows % tfa.TILE == 0, pre
    assert bn["FWD"] > tfa.TILE  # the forward's key tiles span two warpgroups' rows
    assert "k0 + BN > sh.T" in src and "col < sh.T" in src
    assert "q0 + BWD_BN > sh.S" in src and "query >= sh.S" in src  # dK/dV: query columns
    assert "k0 + BWD_BN > sh.T" in src and "key >= sh.T" in src  # dQ: key columns
    # a warpgroup stores only if it ran a tile (rows past the end run none),
    # and a block with no tile returns before touching memory
    assert "if (first < tiles) {" in src and "if (n_mine > 0) epi.store" in src
    assert "if (nq == 0) return;" in src and "if (nk == 0) return;" in src
    assert "if (r0 >= sh.T) return tiles;" in src and "if (r0 >= sh.S) return 0;" in src
    # the ring gate admits blocks of any multiple of the backward's warpgroup
    # rows, which the ring steps' mainloops bound their loops by
    wg = int(re.search(r"constexpr int BWD_WG_ROWS = (\d+);", src).group(1))
    bf16 = torch.bfloat16
    for rows, ok in ((wg, True), (3 * wg, True), (5 * wg, True), (wg + wg // 2, False)):
        assert trf.ring_flash_supported((1, 2, rows, 128), (1, 2, 2 * wg, 128),
                                        (1, 2, 2 * wg, 128), bf16, "cuda") is ok, rows
        assert trf.ring_flash_supported((1, 2, 2 * wg, 64), (1, 2, rows, 64), (1, 2, rows, 64),
                                        bf16, "cuda") is ok, rows
    assert tfa.flash_attention_bshf_supported((2, bn["FWD"] + tfa.TILE, 256), 2,
                                              torch.bfloat16, "cuda")
    assert tfa.flash_attention_bshf_supported((2, 5 * tfa.TILE, 256), 2, torch.bfloat16, "cuda")
    hashed = {p.name for p in build.CSRC_DIR.glob("*.cuh")}
    assert {"flash_fwd_sm90.cuh", "flash_bwd_sm90.cuh"} <= hashed  # in the library's hash


def test_library_name_tracks_source_and_flags():
    path = build.library_path("flash_attention.cu")
    assert path.parent == build.BUILD_DIR
    assert path.name.startswith("libflash_attention_") and path.suffix == ".so"
    assert build.library_path("flash_attention.cu") == path  # stable


def test_ptxas_report_parses_per_kernel():
    log = (
        "ptxas info    : Compiling entry function 'ff_flash_fwd_kernel' for 'sm_90a'\n"
        "ptxas info    : Function properties for ff_flash_fwd_kernel\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 168 registers, used 1 barriers, 400 bytes cmem[0]\n"
    )
    assert build.parse_ptxas(log) == {
        "ff_flash_fwd_kernel": {
            "stack_bytes": 0, "spill_store_bytes": 8, "spill_load_bytes": 4,
            "registers": 168, "static_smem_bytes": 0,
        }
    }
