#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device         the card's name and power limit (nvidia-smi) and the
                  versions;
2. build          nvcc builds every kernel from the checkout's sources; build
                  time and each kernel's registers, shared memory and spills;
3. kernels        each kernel against its plain PyTorch version on the same
                  bf16 inputs, and timed beside its plain version, its bound
                  and one PyTorch call that computes the same function (never
                  used by the port): the d=128 kernels at the flagship's
                  attention (b=64, h=8, s=512) and at the seq-2048 flagship's
                  (b=16, h=8, s=2048), the d=64 kernels at the 16-head
                  config's (b=64, h=16, s=512) on the interleaved-QKV and on
                  separate operands, plus small causal cases;
4. parity         two small flagships (heads of 128, and heads of 64) trained
                  two steps on the card (bf16, through the kernels) and on
                  the CPU (f32, plain versions) from the same parameters: the
                  losses must agree;
5. train          the full-width flagship (12 layers, hidden 1024, 8 heads of
                  128, seq 512, vocab 32000, batch 64), bf16 compute,
                  Adam(1e-4): one warm-up step, then five timed steps with
                  every launch count set to 0 just before and read just after;
6. train_heads16  the same for the 16-head config (16 heads of 64), whose
                  attention runs the d=64 kernels on the fused projection;

then, in a one-rank NCCL process group opened over a file:// store:

7. parity_dp      the two small flagships trained two steps by the
                  data-parallel trainer on the card (bf16, per-head kernels)
                  and by the single-device trainer on the CPU (f32);
8. train_dp       the flagship through the data-parallel trainer, whose
                  attention runs the per-head [b, h, s, d] kernels;
9. train_dp_seq2048  the same for the seq-2048 flagship (batch 16, seq 2048),
                  whose attention runs the same kernels at s > block.

The kernels phase also holds the per-head kernels at the attention shapes of
train_dp, of train_dp_seq2048 and of the 16-head config, on contiguous
operands and on the projection einsum's strided view. Then the kernel table
as one {"kernels": [...]} line, and last the line {"ok": true, "device":
{...}}. Any failed check raises and the script exits non-zero. Without a
CUDA device, or away from a checkout of the repository, it exits non-zero
before printing anything.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (dense): bf16 tensor cores, f32 outside them, HBM
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

REL_BOUND = 2e-2  # o, dq, dk, dv: the JAX package's own bf16 backward bound
LSE_BOUND = 1e-3  # max abs, f32 from the same bf16 inputs
DELTA_BOUND = 1e-4  # norm-relative, exact bf16 products summed in f32
PARITY_BOUND = 1e-2  # relative loss difference, bf16 card vs f32 CPU
STEPS = 5  # timed steps of each train phase

SOURCE = "flexflow_tpu_torch/csrc/flash_attention.cu"
TPU_KERNELS = "flexflow_tpu/kernels/flash_attention.py"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require_card_and_repo():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device is available")
    sys.path.insert(0, REPO)
    try:
        import flexflow_tpu_torch  # noqa: F401
    except ImportError as e:
        sys.exit(f"chip_smoke: run from a checkout of the repository ({e})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def phase_device() -> str:
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    emit({
        "phase": "device", "nvidia_smi": smi, "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(), "torch": torch.__version__,
        "cuda": torch.version.cuda, "python": sys.version.split()[0],
    })
    return smi


def phase_build() -> None:
    from flexflow_tpu_torch.kernels import build
    from flexflow_tpu_torch.kernels import flash_attention as fa

    start = time.perf_counter()
    infos = build.build()
    seconds = time.perf_counter() - start
    lib = fa.library()
    names = ("ff_flash_fwd_kernel", "ff_flash_bwd_dkv_kernel", "ff_flash_bwd_dq_kernel",
             "ff_flash_fwd_d64_kernel", "ff_flash_bwd_dkv_d64_kernel",
             "ff_flash_bwd_dq_d64_kernel")
    emit({
        "phase": "build", "seconds": seconds,
        "sources": {
            src: {"nvcc_seconds": info.seconds, "kernels": build.parse_ptxas(info.ptxas_log)}
            for src, info in infos.items()
        },
        "dynamic_smem_bytes": {name: lib.ff_flash_smem_bytes(i) for i, name in enumerate(names)},
    })


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of one call, by CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _errors(got, want) -> dict:
    g, w = got.double(), want.double()
    return {
        "rel_err": float((g - w).norm() / w.norm()),
        "max_abs_err": float((g - w).abs().max()),
    }


def _check(name: str, errs: dict, key: str, bound: float) -> dict:
    errs = dict(errs, bound_key=key, bound=bound)
    if not errs[key] < bound:
        raise AssertionError(f"{name}: {key} {errs[key]} exceeds {bound}")
    return errs


class Flash:
    """One kernel family at one layout: `x` is the tuple of operands, three
    [b, s, h*d] tensors (d=128, or d=64 separate) or one interleaved
    [b, s, 3*h*64] projection (d=64, qkv); `grads` turns what bwd returns
    into (dq, dk, dv) either way."""

    def __init__(self, h: int, d: int, interleaved: bool = False):
        from flexflow_tpu_torch.kernels import flash_attention as fa

        self.fa, self.h, self.d, self.interleaved = fa, h, d, interleaved

    def operands(self, b, s, gen):
        import torch

        shape = (b, s, 3 * self.h * self.d) if self.interleaved else (b, s, self.h * self.d)
        n = 1 if self.interleaved else 3
        return tuple(torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)
                     for _ in range(n))

    def _views(self, x):
        fa = self.fa
        return fa.qkv_views(x[0]) if self.interleaved else [fa.lane_groups(t) for t in x]

    def fwd(self, x, causal=False):
        if self.d == 128:
            return self.fa.flash_fwd(*x, self.h, causal)
        return self.fa.flash_fwd_d64(*self._views(x), self.h, causal)

    def delta(self, do, o):
        fn = self.fa.flash_delta if self.d == 128 else self.fa.flash_delta_d64
        return fn(do, o, self.h)

    def bwd(self, x, do, lse, delta, causal=False):
        import torch

        if self.d == 128:
            return self.fa.flash_bwd(*x, do, lse, delta, self.h, causal)
        out = [torch.empty_like(t) for t in x]
        self.fa.flash_bwd_d64(*self._views(x), do, lse, delta, *self._views(out), self.h, causal)
        return out

    def grads(self, out):
        """(dq, dk, dv) of what bwd or bwd_plain returned."""
        return self.fa.split_qkv(out[0]) if self.interleaved else out

    def fwd_plain(self, x, causal=False):
        if self.interleaved:
            return self.fa.flash_fwd_qkv_plain(x[0], self.h, causal)
        return self.fa.flash_fwd_plain(*x, self.h, causal)

    def delta_plain(self, do, o):
        return self.fa.flash_delta_plain(do, o, self.h)

    def bwd_plain(self, x, do, lse, delta, causal=False):
        if self.interleaved:
            return (self.fa.flash_bwd_qkv_plain(x[0], do, lse, delta, self.h, causal),)
        return self.fa.flash_bwd_plain(*x, do, lse, delta, self.h, causal)

    def grad_out(self, b, s, gen):
        import torch

        return torch.randn(b, s, self.h * self.d, generator=gen, device="cuda").to(torch.bfloat16)

    def heads(self, x, do):
        """q, k, v and dO as [b, h, s, d] views, for the library calls."""
        b, s = do.shape[:2]
        q, k, v = self.fa.split_qkv(x[0]) if self.interleaved else x
        return [t.view(b, s, self.h, self.d).transpose(1, 2) for t in (q, k, v, do)]

    EINSUM_DELTA = 'torch.einsum("bshd,bshd->bhs", dO, O)'

    def einsum_delta(self, do, o):
        import torch

        b, s = do.shape[:2]
        return torch.einsum("bshd,bshd->bhs", do.view(b, s, self.h, self.d),
                            o.view(b, s, self.h, self.d))


class FlashBHSD:
    """The per-head kernels on [b, h, s, d] operands: contiguous, or, with
    `strided`, [b, s, h, d] buffers viewed as [b, h, s, d], the layout the
    per-head projection einsum returns on the data-parallel path."""

    interleaved = False

    def __init__(self, h: int, d: int, strided: bool = False):
        from flexflow_tpu_torch.kernels import flash_attention as fa

        self.fa, self.h, self.d, self.strided = fa, h, d, strided

    def _tensor(self, b, s, gen):
        import torch

        if self.strided:
            x = torch.randn(b, s, self.h, self.d, generator=gen, device="cuda")
            return x.to(torch.bfloat16).transpose(1, 2)
        return torch.randn(b, self.h, s, self.d, generator=gen, device="cuda").to(torch.bfloat16)

    def operands(self, b, s, gen):
        return tuple(self._tensor(b, s, gen) for _ in range(3))

    def grad_out(self, b, s, gen):
        return self._tensor(b, s, gen)

    def fwd(self, x, causal=False):
        return self.fa.flash_fwd_bhsd(*x, causal)

    def delta(self, do, o):
        return self.fa.flash_delta_bhsd(do, o)

    def bwd(self, x, do, lse, delta, causal=False):
        return self.fa.flash_bwd_bhsd(*x, do, lse, delta, causal)

    def grads(self, out):
        return out

    def fwd_plain(self, x, causal=False):
        return self.fa.flash_fwd_bhsd_plain(*x, causal)

    def delta_plain(self, do, o):
        return self.fa.flash_delta_bhsd_plain(do, o)

    def bwd_plain(self, x, do, lse, delta, causal=False):
        return self.fa.flash_bwd_bhsd_plain(*x, do, lse, delta, causal)

    def heads(self, x, do):
        return [*x, do]

    EINSUM_DELTA = 'torch.einsum("bhsd,bhsd->bhs", dO, O)'

    def einsum_delta(self, do, o):
        import torch

        return torch.einsum("bhsd,bhsd->bhs", do, o)


def _compare(flash: Flash, b: int, s: int, causal: bool, seed: int):
    """Each kernel against its plain version on the same bf16 inputs."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = flash.operands(b, s, gen)
    do = flash.grad_out(b, s, gen)
    o, lse = flash.fwd(x, causal)
    o_p, lse_p = flash.fwd_plain(x, causal)
    delta = flash.delta(do, o)
    delta_p = flash.delta_plain(do, o)
    grads = flash.grads(flash.bwd(x, do, lse, delta, causal))
    grads_p = flash.grads(flash.bwd_plain(x, do, lse, delta, causal))
    torch.cuda.synchronize()
    checks = {
        "o": _check("o", _errors(o, o_p), "rel_err", REL_BOUND),
        "lse": _check("lse", _errors(lse, lse_p), "max_abs_err", LSE_BOUND),
        "delta": _check("delta", _errors(delta, delta_p), "rel_err", DELTA_BOUND),
    }
    for name, g, gp in zip(("dq", "dk", "dv"), grads, grads_p):
        checks[name] = _check(name, _errors(g, gp), "rel_err", REL_BOUND)
    for t in (o, lse, delta, *grads):
        if not bool(torch.isfinite(t).all()):
            raise AssertionError("kernel output is not finite")
    # no atomics anywhere: a second launch gives the same bits
    again = (*flash.fwd(x, causal), flash.delta(do, o),
             *flash.grads(flash.bwd(x, do, lse, delta, causal)))
    if not all(torch.equal(a, b) for a, b in zip(again, (o, lse, delta, *grads))):
        raise AssertionError("kernels do not repeat bitwise")
    checks["repeat_bitwise"] = True
    return (x, do, o, lse, delta), checks


def _bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def _grad_err(checks) -> float:
    return max(checks[g]["max_abs_err"] for g in ("dq", "dk", "dv"))


def _measure(flash, b: int, s: int, seed: int = 0, iters: int = 20, plain_iters: int = 3):
    """Compare, then time each kernel of `flash` beside its plain version,
    its bound and the library yardstick at (b, h, s, d), non-causal."""
    import torch
    import torch.nn.functional as F

    h, d = flash.h, flash.d
    (x, do, o, lse, delta), checks = _compare(flash, b, s, causal=False, seed=seed)
    ms = {
        "fwd": time_ms(lambda: flash.fwd(x), iters),
        "delta": time_ms(lambda: flash.delta(do, o), iters),
        "bwd": time_ms(lambda: flash.bwd(x, do, lse, delta), iters),
        "fwd_plain": time_ms(lambda: flash.fwd_plain(x), plain_iters, 1),
        "delta_plain": time_ms(lambda: flash.delta_plain(do, o), plain_iters, 1),
        "bwd_plain": time_ms(lambda: flash.bwd_plain(x, do, lse, delta), plain_iters, 1),
    }
    # the library yardsticks: one PyTorch call each on [b, h, s, d] views of
    # the same tensors, timed here and never used by the port
    q, k, v, do4 = flash.heads(x, do)
    ms["sdpa_fwd"] = time_ms(lambda: F.scaled_dot_product_attention(q, k, v), iters)
    ql, kl, vl = (t.detach().requires_grad_(True) for t in (q, k, v))

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl).backward(do4)

    ms["sdpa_fwd_bwd"] = time_ms(sdpa_fwd_bwd, iters)
    ms["einsum_delta"] = time_ms(lambda: flash.einsum_delta(do, o), iters)

    elems = b * s * h * d  # one [b, s, h*d] operand
    rows = b * h * s  # one lse/delta vector
    bounds = {
        "fwd": _bound_ms(4 * elems * 2 + rows * 4, 4 * b * h * s * s * d, PEAK_BF16),
        "delta": _bound_ms(2 * elems * 2 + rows * 4, 2 * elems, PEAK_F32),
        "bwd": _bound_ms(7 * elems * 2 + 2 * rows * 4, 10 * b * h * s * s * d, PEAK_BF16),
    }
    return ms, bounds, checks


_OUTPUTS = {"fwd": ("o", "lse"), "delta": ("delta",), "bwd": ("dq", "dk", "dv")}


def _numbers(ms, bounds, checks, which, library_ms) -> dict:
    """One kernel's time, plain time, bound, library time and error."""
    first = _OUTPUTS[which][0]
    err = _grad_err(checks) if which == "bwd" else checks[first]["max_abs_err"]
    return dict(ms=ms[which], plain_ms=ms[f"{which}_plain"], bound_ms=bounds[which][0],
                bound_by=bounds[which][1], library_ms=library_ms, max_abs_err=err)


def _entry(name, replaces, ms, bounds, checks, which, library_ms, library_call, **extra):
    return dict(name=name, route="cuda", source=SOURCE, replaces=f"{TPU_KERNELS}:{replaces}",
                **_numbers(ms, bounds, checks, which, library_ms), library_call=library_call,
                checks={k: checks[k] for k in _OUTPUTS[which]}, **extra)


def _side(ms, bounds, checks, which, library_ms, shape):
    """The numbers of one kernel at a second shape or layout."""
    return dict(shape=shape, **_numbers(ms, bounds, checks, which, library_ms))


def phase_kernels():
    """Compare and time the kernels at the main paths' attention shapes."""
    sdpa_f, sdpa_fb = "F.scaled_dot_product_attention forward", \
        "F.scaled_dot_product_attention forward+backward"
    einsum = Flash.EINSUM_DELTA
    causal = {
        "d128": _compare(Flash(2, 128), 2, 256, causal=True, seed=1)[1],
        "d64_separate": _compare(Flash(4, 64), 2, 256, causal=True, seed=2)[1],
        "d64_qkv": _compare(Flash(4, 64, interleaved=True), 2, 256, causal=True, seed=3)[1],
    }

    # d=128: the flagship (b=64, h=8, s=512), and the seq-2048 flagship of
    # bench.py:3431-3435 (b=16, h=8, s=2048), whose backward the JAX package
    # computes with _bwd_onepass_kernel (rows 4-5 of the kernel table)
    ms, bounds, checks = _measure(Flash(8, 128), 64, 512)
    ms2k, bounds2k, checks2k = _measure(Flash(8, 128), 16, 2048, seed=4, iters=10)
    s2k = dict(b=16, h=8, s=2048, d=128)
    kernels = [
        _entry("flash_fwd", 674, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               seq2048=_side(ms2k, bounds2k, checks2k, "fwd", ms2k["sdpa_fwd"], s2k)),
        _entry("flash_delta", 1203, ms, bounds, checks, "delta", ms["einsum_delta"], einsum),
        _entry("flash_bwd", 976, ms, bounds, checks, "bwd", ms["sdpa_fwd_bwd"], sdpa_fb,
               port_fwd_delta_bwd_ms=ms["fwd"] + ms["delta"] + ms["bwd"],
               seq2048=dict(_side(ms2k, bounds2k, checks2k, "bwd", ms2k["sdpa_fwd_bwd"], s2k),
                            replaces=[f"{TPU_KERNELS}:1286", f"{TPU_KERNELS}:324",
                                      f"{TPU_KERNELS}:375"])),
    ]

    # d=64: the 16-head config (b=64, h=16, s=512) on the interleaved-QKV
    # projection (its main path) and on separate operands
    ms, bounds, checks = _measure(Flash(16, 64, interleaved=True), 64, 512, seed=5)
    ms_sep, bounds_sep, checks_sep = _measure(Flash(16, 64), 64, 512, seed=6)
    sep = dict(b=64, h=16, s=512, d=64, layout="separate q, k, v")
    kernels += [
        _entry("flash_fwd_d64", 1032, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               layout="interleaved qkv",
               separate=_side(ms_sep, bounds_sep, checks_sep, "fwd", ms_sep["sdpa_fwd"], sep)),
        _entry("flash_delta_d64", 1134, ms, bounds, checks, "delta", ms["einsum_delta"], einsum),
        _entry("flash_bwd_d64", 1189, ms, bounds, checks, "bwd", ms["sdpa_fwd_bwd"], sdpa_fb,
               layout="interleaved qkv", port_fwd_delta_bwd_ms=ms["fwd"] + ms["delta"] + ms["bwd"],
               separate=dict(_side(ms_sep, bounds_sep, checks_sep, "bwd",
                                   ms_sep["sdpa_fwd_bwd"], sep),
                             replaces=f"{TPU_KERNELS}:1179")),
    ]
    kernels += _per_head_kernels(causal)
    emit({"phase": "kernels",
          "shapes": {"d128": {"b": 64, "h": 8, "s": 512}, "d128_seq2048": s2k,
                     "d64": {"b": 64, "h": 16, "s": 512}, "dtype": "bf16"},
          "projection_view": _projection_view(),
          "repeat_bitwise": True, "causal_checks": {"shape": {"b": 2, "s": 256}, **causal}})
    return kernels


def _projection_view() -> dict:
    """The strides of the per-head projection einsum's output on the card at
    the flagship's shape, and whether the per-head kernels read it in
    place (else FlashAttentionBHSD copies it to contiguous)."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa

    x = torch.zeros(64, 512, 1024, dtype=torch.bfloat16, device="cuda")
    w = torch.zeros(1024, 128, 8, dtype=torch.bfloat16, device="cuda")
    view = torch.einsum("bsq,qkh->bhsk", x, w)
    return {"shape": list(view.shape), "strides": list(view.stride()),
            "read_in_place": fa.bhsd_readable(view)}


def _per_head_kernels(causal: dict):
    """The per-head [b, h, s, d] kernels (rows 9-12 of the kernel table) at
    the attention shapes of train_dp (64x8x512x128), of train_dp_seq2048
    (16x8x2048x128) and of the 16-head config (64x16x512x64), on contiguous
    operands, and at train_dp's on the projection einsum's strided view,
    the layout the data-parallel path hands them; plus causal cases."""
    sdpa_f, sdpa_fb = "F.scaled_dot_product_attention forward", \
        "F.scaled_dot_product_attention forward+backward"
    einsum = FlashBHSD.EINSUM_DELTA
    causal["bhsd_d128"] = _compare(FlashBHSD(2, 128), 2, 256, causal=True, seed=7)[1]
    causal["bhsd_d64"] = _compare(FlashBHSD(4, 64), 2, 256, causal=True, seed=8)[1]
    causal["bhsd_d128_strided"] = _compare(FlashBHSD(2, 128, strided=True), 2, 256, causal=True,
                                           seed=9)[1]
    runs = {
        "main": (_measure(FlashBHSD(8, 128), 64, 512, seed=10), dict(b=64, h=8, s=512, d=128)),
        "strided": (_measure(FlashBHSD(8, 128, strided=True), 64, 512, seed=11),
                    dict(b=64, h=8, s=512, d=128, layout="einsum view of [b, s, h, d]")),
        "seq2048": (_measure(FlashBHSD(8, 128), 16, 2048, seed=12, iters=10),
                    dict(b=16, h=8, s=2048, d=128)),
        "d64": (_measure(FlashBHSD(16, 64), 64, 512, seed=13), dict(b=64, h=16, s=512, d=64)),
    }
    ms, bounds, checks = runs["main"][0]

    def sides(which, library):
        out = {}
        for key in ("strided", "seq2048", "d64"):
            (ms_k, bounds_k, checks_k), shape = runs[key]
            out[key] = _side(ms_k, bounds_k, checks_k, which, ms_k[library], shape)
        return out

    fwd_sides, bwd_sides = sides("fwd", "sdpa_fwd"), sides("bwd", "sdpa_fwd_bwd")
    fwd_sides["seq2048"]["replaces"] = f"{TPU_KERNELS}:164"  # _fwd_kernel, the loop
    bwd_sides["seq2048"]["replaces"] = [f"{TPU_KERNELS}:492", f"{TPU_KERNELS}:324",
                                        f"{TPU_KERNELS}:375"]  # _bwd, tiled
    return [
        _entry("flash_fwd_bhsd", 258, ms, bounds, checks, "fwd", ms["sdpa_fwd"], sdpa_f,
               layout="contiguous [b, h, s, d]", **fwd_sides),
        _entry("flash_delta_bhsd", 433, ms, bounds, checks, "delta", ms["einsum_delta"], einsum,
               layout="contiguous [b, h, s, d]", **sides("delta", "einsum_delta")),
        _entry("flash_bwd_bhsd", 454, ms, bounds, checks, "bwd", ms["sdpa_fwd_bwd"], sdpa_fb,
               layout="contiguous [b, h, s, d]",
               port_fwd_delta_bwd_ms=ms["fwd"] + ms["delta"] + ms["bwd"], **bwd_sides),
    ]


def _train(inst, params, opt_state, x, y, steps):
    import torch

    losses, step_ms = [], []
    for _ in range(steps):
        start = time.perf_counter()
        params, opt_state, loss, _ = inst.train_step(params, opt_state, {"x": x}, y)
        losses.append(float(loss))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - start) * 1e3)
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    return params, opt_state, losses, step_ms


def phase_parity():
    """Small flagships on the card (bf16, kernels) and on the CPU (f32,
    plain versions) from the same parameters and batch: heads of 128, and
    heads of 64 (the 16-head config's attention)."""
    import torch
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    for name, heads in (("d128", 2), ("d64", 4)):
        cfg = dict(batch=2, seq=128, embed=256, heads=heads, layers=2, vocab=512)
        graph, logits = build_flagship_cg(**cfg)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], generator=gen)
        y = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=gen)
        losses = {}
        for device, dtype in (("cpu", None), ("cuda", torch.bfloat16)):
            inst = ModelTrainingInstance(
                graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                AdamOptimizerAttrs(alpha=1e-3), compute_dtype=dtype, device=device,
            )
            params, opt_state = inst.initialize(seed=0)
            losses[device] = _train(inst, params, opt_state, x.to(device), y.to(device), 2)[2]
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda"], losses["cpu"])]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"{name}: card losses {losses['cuda']} vs CPU {losses['cpu']}")
        emit({"phase": "parity", "head_dim": 256 // heads, "config": cfg, "losses": losses,
              "rel_err": rel, "bound": PARITY_BOUND})


@contextlib.contextmanager
def dp_group():
    """A one-rank NCCL process group over a file:// store in a temporary
    directory, destroyed on the way out."""
    import torch.distributed as dist
    from flexflow_tpu_torch.parallel import init_file_group

    with tempfile.TemporaryDirectory() as tmp:
        init_file_group(os.path.join(tmp, "store"), rank=0, world_size=1)
        try:
            yield
        finally:
            dist.destroy_process_group()


BHSD_WRAPPERS = ("flash_fwd_bhsd", "flash_delta_bhsd", "flash_bwd_bhsd")


def phase_parity_dp():
    """The small flagships of phase_parity trained by the data-parallel
    trainer at world size 1 on the card (NCCL, bf16, per-head kernels) and
    by the single-device trainer on the CPU (f32, plain versions)."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    for name, heads in (("d128", 2), ("d64", 4)):
        cfg = dict(batch=2, seq=128, embed=256, heads=heads, layers=2, vocab=512)
        graph, logits = build_flagship_cg(**cfg)
        gen = torch.Generator().manual_seed(1)
        x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], generator=gen)
        y = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=gen)
        args = (graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
                AdamOptimizerAttrs(alpha=1e-3))
        cpu = ModelTrainingInstance(*args, device="cpu")
        losses = {"cpu": _train(cpu, *cpu.initialize(seed=0), x, y, 2)[2]}
        card = DataParallelTrainingInstance(*args, compute_dtype=torch.bfloat16)
        fa.reset_launch_counts()
        losses["cuda_dp"] = _train(card, *card.initialize(seed=0), x.cuda(), y.cuda(), 2)[2]
        launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
        want = {n: 2 * cfg["layers"] if n in BHSD_WRAPPERS else 0 for n in launches}
        if launches != want:
            raise AssertionError(f"parity_dp {name}: launches {launches}, expected {want}")
        rel = [abs(a - b) / abs(b) for a, b in zip(losses["cuda_dp"], losses["cpu"])]
        if not max(rel) < PARITY_BOUND:
            raise AssertionError(f"parity_dp {name}: card losses {losses['cuda_dp']} vs CPU "
                                 f"{losses['cpu']}")
        emit({"phase": "parity_dp", "head_dim": 256 // heads, "config": cfg, "world_size": 1,
              "backend": "nccl", "losses": losses, "rel_err": rel, "bound": PARITY_BOUND,
              "launches": launches})


def phase_train(smi: str, cfg: dict, phase: str, on_path, steps: int = STEPS, dp: bool = False):
    """Train `cfg` at full width, with the single-device trainer or (dp) the
    data-parallel one; the wrappers named in `on_path` must each launch once
    per layer per step, every other one never, and the data-parallel trainer
    must issue one all-reduce per step."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg, model_step_flops
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.parallel import DataParallelTrainingInstance
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    graph, logits = build_flagship_cg(**cfg)
    trainer = DataParallelTrainingInstance if dp else ModelTrainingInstance
    inst = trainer(
        graph, logits, SparseCategoricalCrossEntropyLossAttrs(),
        AdamOptimizerAttrs(alpha=1e-4), compute_dtype=torch.bfloat16,
    )
    start = time.perf_counter()
    params, opt_state = inst.initialize(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(cfg["batch"], cfg["seq"], cfg["embed"], generator=gen, device="cuda")
    y = torch.randint(0, cfg["vocab"], (cfg["batch"], cfg["seq"]), generator=gen, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - start

    params, opt_state, warm_losses, warm_ms = _train(inst, params, opt_state, x, y, 1)
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launch_counts()
    all_reduces = inst.all_reduces if dp else 0
    params, opt_state, losses, step_ms = _train(inst, params, opt_state, x, y, steps)
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    want = {name: cfg["layers"] * steps if name in on_path else 0 for name in launches}
    if launches != want:
        raise AssertionError(f"{phase}: launches {launches}, expected {want}")
    extra = {}
    if dp:
        all_reduces = inst.all_reduces - all_reduces
        if all_reduces != steps:
            raise AssertionError(f"{phase}: {all_reduces} all-reduces in {steps} steps")
        extra = {"world_size": inst.world_size, "backend": "nccl",
                 "all_reduces_per_step": all_reduces / steps,
                 "all_reduce_bytes": 4 * (1 + sum(p.numel() for p in params.values()))}

    median_ms = statistics.median(step_ms)
    flops = model_step_flops(**cfg)
    emit({
        "phase": phase, "config": cfg, "card": smi, "compute_dtype": "bf16",
        "optimizer": "adam(alpha=1e-4)", "params": sum(p.numel() for p in params.values()),
        "setup_s": setup_s, "warmup_step_ms": warm_ms[0], "warmup_loss": warm_losses[0],
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": cfg["batch"] * cfg["seq"] / (median_ms / 1e3),
        "step_flops": flops, "mfu": flops / (median_ms / 1e3) / PEAK_BF16,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step_each": cfg["layers"], **extra,
    })
    del params, opt_state
    torch.cuda.empty_cache()
    return {name: n for name, n in launches.items() if name in on_path}


def main() -> None:
    require_card_and_repo()
    import torch
    from flexflow_tpu_torch.models import FLAGSHIP, LONGCTX, REF_HEADS16

    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_parity()
    launches = {  # per train phase, the launches of each wrapper on its path
        "train": phase_train(smi, FLAGSHIP, "train", ("flash_fwd", "flash_delta", "flash_bwd")),
        "train_heads16": phase_train(smi, REF_HEADS16, "train_heads16",
                                     ("flash_fwd_d64", "flash_delta_d64", "flash_bwd_d64")),
    }
    with dp_group():
        phase_parity_dp()
        launches["train_dp"] = phase_train(smi, FLAGSHIP, "train_dp", BHSD_WRAPPERS, dp=True)
        launches["train_dp_seq2048"] = phase_train(smi, LONGCTX, "train_dp_seq2048",
                                                   BHSD_WRAPPERS, dp=True)
    for entry in kernels:
        by_phase = {p: n[entry["name"]] for p, n in launches.items() if entry["name"] in n}
        entry["launches"] = sum(by_phase.values())
        entry["launches_per_step"] = {p: n // STEPS for p, n in by_phase.items()}
    emit({"kernels": kernels, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
