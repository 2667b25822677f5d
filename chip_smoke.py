#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (flexflow_tpu_torch) on one card.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   the card's name and power limit (nvidia-smi) and the versions;
2. build    nvcc builds every kernel from the checkout's sources; build
            time and each kernel's registers, shared memory and spills;
3. kernels  at the flagship shapes in bf16 (and a small causal case), each
            kernel against its plain PyTorch version on the same inputs,
            and timed beside its plain version, its bound and one PyTorch
            call that computes the same function (never used by the port);
4. parity   a small flagship trained two steps on the card (bf16, through
            the kernels) and on the CPU (f32, plain versions) from the same
            parameters: the losses must agree;
5. train    the full-width flagship (12 layers, hidden 1024, 8 heads of 128,
            seq 512, vocab 32000, batch 64), bf16 compute, Adam(1e-4):
            one warm-up step, then five timed steps with every launch count
            set to 0 just before and read just after.

Then the kernel table as one {"kernels": [...]} line, and last the line
{"ok": true, "device": {...}}. Any failed check raises and the script exits
non-zero. Without a CUDA device, or away from a checkout of the repository,
it exits non-zero before printing anything.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
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
    emit({
        "phase": "build", "seconds": seconds,
        "sources": {
            src: {"nvcc_seconds": info.seconds, "kernels": build.parse_ptxas(info.ptxas_log)}
            for src, info in infos.items()
        },
        "dynamic_smem_bytes": {
            "ff_flash_fwd_kernel": lib.ff_flash_smem_bytes(0),
            "ff_flash_bwd_dkv_kernel": lib.ff_flash_smem_bytes(1),
            "ff_flash_bwd_dq_kernel": lib.ff_flash_smem_bytes(2),
        },
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


def _compare(b: int, h: int, s: int, causal: bool, seed: int):
    """Each kernel against its plain version on the same bf16 inputs."""
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v, do = (
        torch.randn(b, s, h * fa.HEAD_DIM, generator=gen, device="cuda").to(torch.bfloat16)
        for _ in range(4)
    )
    o, lse = fa.flash_fwd(q, k, v, h, causal)
    o_p, lse_p = fa.flash_fwd_plain(q, k, v, h, causal)
    delta = fa.flash_delta(do, o, h)
    delta_p = fa.flash_delta_plain(do, o, h)
    grads = fa.flash_bwd(q, k, v, do, lse, delta, h, causal)
    grads_p = fa.flash_bwd_plain(q, k, v, do, lse, delta, h, causal)
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
    again = (*fa.flash_fwd(q, k, v, h, causal), fa.flash_delta(do, o, h),
             *fa.flash_bwd(q, k, v, do, lse, delta, h, causal))
    if not all(torch.equal(a, b) for a, b in zip(again, (o, lse, delta, *grads))):
        raise AssertionError("kernels do not repeat bitwise")
    checks["repeat_bitwise"] = True
    return (q, k, v, do, o, lse, delta), checks


def _bound_ms(nbytes: float, ops: float, peak_ops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / peak_ops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(b=64, h=8, s=512):
    """Compare and time the kernels at the flagship's attention shapes."""
    import torch
    import torch.nn.functional as F
    from flexflow_tpu_torch.kernels import flash_attention as fa

    d = fa.HEAD_DIM
    _, causal_checks = _compare(2, 2, 256, causal=True, seed=1)
    (q, k, v, do, o, lse, delta), checks = _compare(b, h, s, causal=False, seed=0)

    iters, plain_iters = 20, 3
    fwd_ms = time_ms(lambda: fa.flash_fwd(q, k, v, h), iters)
    delta_ms = time_ms(lambda: fa.flash_delta(do, o, h), iters)
    bwd_ms = time_ms(lambda: fa.flash_bwd(q, k, v, do, lse, delta, h), iters)
    fwd_plain = time_ms(lambda: fa.flash_fwd_plain(q, k, v, h), plain_iters, 1)
    delta_plain = time_ms(lambda: fa.flash_delta_plain(do, o, h), plain_iters, 1)
    bwd_plain = time_ms(lambda: fa.flash_bwd_plain(q, k, v, do, lse, delta, h), plain_iters, 1)

    # the library yardstick: one PyTorch call, timed here and never used by the port
    heads = lambda x: x.view(b, s, h, d).transpose(1, 2)  # noqa: E731
    sdpa_fwd = time_ms(lambda: F.scaled_dot_product_attention(heads(q), heads(k), heads(v)), iters)
    ql, kl, vl = (heads(x).detach().requires_grad_(True) for x in (q, k, v))
    do4 = heads(do)

    def sdpa_fwd_bwd():
        F.scaled_dot_product_attention(ql, kl, vl).backward(do4)

    sdpa_fwd_bwd_ms = time_ms(sdpa_fwd_bwd, iters)

    elems = b * s * h * d  # one [b, s, h*d] operand
    rows = b * h * s  # one lse/delta vector
    fwd_bound = _bound_ms(4 * elems * 2 + rows * 4, 4 * b * h * s * s * d, PEAK_BF16)
    delta_bound = _bound_ms(2 * elems * 2 + rows * 4, 2 * elems, PEAK_F32)
    bwd_bound = _bound_ms(7 * elems * 2 + 2 * rows * 4, 10 * b * h * s * s * d, PEAK_BF16)
    source = "flexflow_tpu_torch/csrc/flash_attention.cu"
    kernels = [
        dict(name="flash_fwd", route="cuda", source=source,
             replaces="flexflow_tpu/kernels/flash_attention.py:674",
             max_abs_err=checks["o"]["max_abs_err"], ms=fwd_ms, plain_ms=fwd_plain,
             bound_ms=fwd_bound[0], bound_by=fwd_bound[1], library_ms=sdpa_fwd,
             library_call="F.scaled_dot_product_attention forward",
             checks={k: checks[k] for k in ("o", "lse")}),
        dict(name="flash_delta", route="cuda", source=source,
             replaces="flexflow_tpu/kernels/flash_attention.py:1203",
             max_abs_err=checks["delta"]["max_abs_err"], ms=delta_ms, plain_ms=delta_plain,
             bound_ms=delta_bound[0], bound_by=delta_bound[1], library_ms=None,
             checks={"delta": checks["delta"]}),
        dict(name="flash_bwd", route="cuda", source=source,
             replaces="flexflow_tpu/kernels/flash_attention.py:976",
             max_abs_err=max(checks[g]["max_abs_err"] for g in ("dq", "dk", "dv")),
             ms=bwd_ms, plain_ms=bwd_plain, bound_ms=bwd_bound[0], bound_by=bwd_bound[1],
             library_ms=sdpa_fwd_bwd_ms,
             library_call="F.scaled_dot_product_attention forward+backward",
             port_fwd_delta_bwd_ms=fwd_ms + delta_ms + bwd_ms,
             checks={g: checks[g] for g in ("dq", "dk", "dv")}),
    ]
    emit({"phase": "kernels", "shape": {"b": b, "h": h, "s": s, "d": d, "dtype": "bf16"},
          "repeat_bitwise": checks["repeat_bitwise"],
          "causal_check": {"shape": {"b": 2, "h": 2, "s": 256}, "checks": causal_checks}})
    return kernels


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
    """A small flagship on the card (bf16, kernels) and on the CPU (f32,
    plain versions) from the same parameters and batch."""
    import torch
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import build_flagship_cg
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    cfg = dict(batch=2, seq=128, embed=256, heads=2, layers=2, vocab=512)
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
        raise AssertionError(f"card losses {losses['cuda']} vs CPU {losses['cpu']}")
    emit({"phase": "parity", "config": cfg, "losses": losses, "rel_err": rel,
          "bound": PARITY_BOUND})


def phase_train(smi: str, steps: int = 5):
    import torch
    from flexflow_tpu_torch.kernels import flash_attention as fa
    from flexflow_tpu_torch.local_execution import ModelTrainingInstance
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_cg, model_step_flops
    from flexflow_tpu_torch.op_attrs.ops import SparseCategoricalCrossEntropyLossAttrs
    from flexflow_tpu_torch.pcg import AdamOptimizerAttrs

    cfg = FLAGSHIP
    graph, logits = build_flagship_cg(**cfg)
    inst = ModelTrainingInstance(
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
    params, opt_state, losses, step_ms = _train(inst, params, opt_state, x, y, steps)
    launches = {fn.__name__: fn.launches for fn in fa.KERNEL_WRAPPERS}
    want = cfg["layers"] * steps
    if any(n != want for n in launches.values()):
        raise AssertionError(f"launches {launches}, expected {want} of each")

    median_ms = statistics.median(step_ms)
    flops = model_step_flops(**cfg)
    emit({
        "phase": "train", "config": cfg, "card": smi, "compute_dtype": "bf16",
        "optimizer": "adam(alpha=1e-4)", "params": sum(p.numel() for p in params.values()),
        "setup_s": setup_s, "warmup_step_ms": warm_ms[0], "warmup_loss": warm_losses[0],
        "losses": losses, "step_ms": step_ms, "median_step_ms": median_ms,
        "tokens_per_s": cfg["batch"] * cfg["seq"] / (median_ms / 1e3),
        "step_flops": flops, "mfu": flops / (median_ms / 1e3) / PEAK_BF16,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "launches": launches, "launches_per_step_each": want // steps,
    })
    return launches


def main() -> None:
    require_card_and_repo()
    import torch

    smi = phase_device()
    phase_build()
    kernels = phase_kernels()
    phase_parity()
    launches = phase_train(smi)
    for entry in kernels:
        entry["launches"] = launches[entry["name"]]
    emit({"kernels": kernels, "card": smi})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
