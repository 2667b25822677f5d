"""CPU probes of the port's search and of chip_smoke.py's fit_overlap checks.
Not a test file: run by hand from the repo root, each prints JSON lines.

    python tests/torch_port_probes.py depth [--layers 2 3 4] [--timeout 1200]

  The flagship's widths (FLAGSHIP, depth cut to each --layers) planned for 2
  nodes x 8 GPUs under machine_model_version=1 with the two-level DP over
  nodes (FFConfig.multislice's search), analytic, budget 2: by the port, by
  the JAX package's pure-Python DP (FF_TPU_NO_NATIVE=1) and by its native
  DP, each in a process of its own; seconds, ms by search phase, estimate.

    python tests/torch_port_probes.py mcmc [--evaluations 40] [--noise 0.05]
                                           [--seeds 0 1 2 3 4]

  The port's MCMC against its Unity search for the flagship on 8 GPUs at
  the H100 constants, with every leaf's analytic cost scaled by a seeded
  factor in [1 - noise, 1 + noise] (seed 0: no noise), as the card's timed
  leaves vary between runs: both winners and estimates, the serial plan's.

    python tests/torch_port_probes.py overlap-fault

  chip_smoke.py's fit_overlap rank job on 2 gloo ranks of the CPU (f32),
  from this checkout and from a temporary copy of it whose reduce-scatter
  ring adds a rotated chunk: the readings fit_overlap bounds, beside the
  bounds.

    python tests/torch_port_probes.py pp-fault [--world 2] [--device cpu]

  chip_smoke.py's train_pp rank job (the MLP trunk, pp2m4 on 2 ranks,
  pp2m4 x dp2 on 4) on --device (cuda:0 on a card: bf16 there, f32 on the
  CPU), from this checkout and from a temporary copy of it whose 1F1B
  backward reads the other stash slot: the worst loss difference against
  the CPU run and the stages' parameters and Adam state against the flat
  executor, beside train_pp's bounds.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DEPTH_RUN = r"""
import json, os, sys, time
pkg, layers = sys.argv[1], int(sys.argv[2])
if pkg == "torch":
    import flexflow_tpu_torch.compiler as C
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.compiler.machine_model import (MachineModelCommModel,
                                                           machine_model_from_config)
    from flexflow_tpu_torch.compiler.unity_algorithm import parallel_degree_summary
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_pcg
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules
    spec = MachineSpecification(2, 1, 8, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    comm = MachineModelCommModel(spec, machine_model_from_config(spec, 1))
    est = C.AnalyticGPUCostEstimator(spec, 989e12, 3350.0, comm_model=comm)
else:
    import flexflow_tpu.compiler as C
    from bench import build_flagship_pcg
    from flexflow_tpu.compiler.machine_model import (MachineModelCommModel,
                                                     machine_model_from_config)
    from flexflow_tpu.compiler.unity_algorithm import parallel_degree_summary
    from flexflow_tpu.pcg.machine_view import MachineSpecification
    from flexflow_tpu.substitutions.rules import generate_parallelization_rules
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.models import FLAGSHIP
    spec = MachineSpecification(2, 1, 8, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    comm = MachineModelCommModel(spec, machine_model_from_config(spec, 1))
    est = C.AnalyticTPUCostEstimator(spec, peak_flops=989e12, hbm_gbps=3350.0, comm_model=comm)
ctx = C.MachineMappingContext(est, C.make_default_allowed_machine_views(), overlap_fraction=0.5,
                              slice_aware=True, slice_hierarchy=True)
rules = generate_parallelization_rules([d for d in range(2, 17) if 16 % d == 0])
start = time.perf_counter()
r = C.graph_optimize(build_flagship_pcg(**dict(FLAGSHIP, layers=layers)), ctx, spec, rules,
                     C.OptimizerConfig(alpha=1.2, budget=2))
print(json.dumps(dict(seconds=time.perf_counter() - start, estimated_ms=r.runtime,
                      winner=parallel_degree_summary(r.pcg),
                      evaluations=r.telemetry.get("evaluations"),
                      phase_ms=r.telemetry.get("phase_ms"))))
"""


def depth(args) -> None:
    runs = {"port": ("torch", {}), "jax_python": ("jax", {"FF_TPU_NO_NATIVE": "1"}),
            "jax_native": ("jax", {})}
    for layers in args.layers:
        for name, (pkg, env) in runs.items():
            env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO, **env)
            try:
                out = subprocess.run([sys.executable, "-c", DEPTH_RUN, pkg, str(layers)],
                                     cwd=REPO, env=env, capture_output=True, text=True,
                                     timeout=args.timeout)
                row = (json.loads(out.stdout.strip().splitlines()[-1]) if out.returncode == 0
                       else {"error": out.stderr[-2000:]})
            except subprocess.TimeoutExpired:
                row = {"seconds": f"> {args.timeout}"}
            print(json.dumps(dict(layers=layers, search=name, **row)), flush=True)


def mcmc(args) -> None:
    import random

    import flexflow_tpu_torch.compiler as C
    from flexflow_tpu_torch.compiler.calibration import H100_NVLINK_GBPS, NDR_INFINIBAND_GBPS
    from flexflow_tpu_torch.compiler.unity_algorithm import parallel_degree_summary
    from flexflow_tpu_torch.models import FLAGSHIP, build_flagship_pcg
    from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
    from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules

    spec = MachineSpecification(1, 1, 8, NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS)
    rules = generate_parallelization_rules([2, 4, 8])
    for seed in args.seeds:
        est = C.AnalyticGPUCostEstimator(spec, 989e12, 3350.0)
        if seed:
            rng, factor, priced = random.Random(seed), {}, est.estimate_op_cost

            def noisy(key, rng=rng, factor=factor, priced=priced):
                f = factor.setdefault(key, 1 + args.noise * (2 * rng.random() - 1))
                return priced(key) * f

            est.estimate_op_cost = noisy
        row = {"seed": seed, "noise": args.noise if seed else 0.0}
        for name in ("mcmc", "unity"):
            ctx = C.MachineMappingContext(est, C.make_default_allowed_machine_views())
            start = time.perf_counter()
            if name == "mcmc":
                r = C.mcmc_optimize(build_flagship_pcg(**FLAGSHIP), ctx, spec, rules,
                                    C.MCMCConfig(budget=args.evaluations))
            else:
                r = C.graph_optimize(build_flagship_pcg(**FLAGSHIP), ctx, spec, rules,
                                     C.OptimizerConfig(alpha=1.2, budget=4))
            row[name] = dict(estimated_ms=r.runtime, serial_ms=r.serial_runtime,
                             winner=parallel_degree_summary(r.pcg),
                             evaluations=r.telemetry.get("evaluations"),
                             seconds=time.perf_counter() - start)
        print(json.dumps(row), flush=True)


RING_LINE = "mine = partial((my - t - 2) % n)"
ROTATED = "mine = partial((my - t - 1) % n)"

OVERLAP_RUN = r"""
import json, os, sys, tempfile
import chip_smoke as c
tmp = tempfile.mkdtemp()
rules_file = os.path.join(tmp, "rules.json")
with open(rules_file, "w") as f:
    json.dump(c.OVERLAP_LEGACY_RULE, f)
ranks = c.run_ranks(2, dict(name="fit_overlap", mode="overlap", cfg=c.TP_PARITY, device="cpu",
                            mlp=c.OVERLAP_MLP, steps=c.OVERLAP_STEPS,
                            rules_steps=c.OVERLAP_RULES_STEPS, rules_file=rules_file), tmp)
r = ranks[0]
s, f = r["serial"], r["fused"]
read = dict(loss=max(abs(a - b) / abs(a) for a, b in zip(s["losses"], f["losses"])),
            logits=r["logits_rel_diff"], update=max(r["update_rel_diff"].values()))
bounds = dict(loss=c.OVERLAP_LOSS_BOUND, logits=c.OVERLAP_LOGITS_BOUND,
              update=c.OVERLAP_UPDATE_BOUND)
print(json.dumps(dict(plan=f["provenance"]["parallel_degrees"], fused=f["fused"],
                      readings=read, bounds=bounds,
                      fails={k: not v <= bounds[k] for k, v in read.items()})))
"""


def overlap_fault(args) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "checkout")
        os.makedirs(copy)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), copy)
        shutil.copytree(os.path.join(REPO, "flexflow_tpu_torch"),
                        os.path.join(copy, "flexflow_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        ring = os.path.join(copy, "flexflow_tpu_torch", "kernels", "collective_matmul.py")
        with open(ring) as f:
            src = f.read()
        if src.count(RING_LINE) != 1:
            raise SystemExit(f"the reduce-scatter ring's line {RING_LINE!r} moved")
        with open(ring, "w") as f:
            f.write(src.replace(RING_LINE, ROTATED))
        for name, root in (("sound", REPO), ("rotated_chunk", copy)):
            out = subprocess.run([sys.executable, "-c", OVERLAP_RUN], cwd=root,
                                 env=dict(os.environ, PYTHONPATH=root), capture_output=True,
                                 text=True, timeout=args.timeout)
            if out.returncode != 0:
                raise SystemExit(f"{name}: {out.stderr[-3000:]}")
            print(json.dumps(dict(run=name, **json.loads(out.stdout.strip().splitlines()[-1]))),
                  flush=True)


STASH_LINE = "x_b = x_mb[m] if s == 0 else stash[m % B]"
OTHER_SLOT = ("x_b = x_mb[m] if s == 0 else (stash[(m + 1) % B] if stash[(m + 1) % B] "
              "is not None else stash[m % B])")

PP_RUN = r"""
import json, sys, tempfile
import chip_smoke as c
world, device = int(sys.argv[1]), sys.argv[2]
with tempfile.TemporaryDirectory() as tmp:
    ranks = c.run_ranks(world, c.pp_job(world, c.PP_SEEDS[world], device), tmp,
                        worker=c.PP_RANK_WORKER)
pp = ranks[0]["train_pp"]
loss = max(abs(a - b) / abs(b) for a, b in zip(pp["losses"], pp["cpu_losses"]))
fails = dict(loss=not loss <= c.PP_PARITY_BOUND,
             **{k: not v <= c.PP_STATE_BOUND[k] for k, v in pp["state_rel"].items()})
print(json.dumps(dict(world=world, device=device, loss_rel=loss, state_rel=pp["state_rel"],
                      bitwise_sequential=pp["bitwise_sequential"],
                      bounds=dict(loss=c.PP_PARITY_BOUND, state=c.PP_STATE_BOUND),
                      fails=fails)))
"""


def pp_fault(args) -> None:
    with tempfile.TemporaryDirectory() as tmp:
        copy = os.path.join(tmp, "checkout")
        os.makedirs(copy)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), copy)
        shutil.copytree(os.path.join(REPO, "flexflow_tpu_torch"),
                        os.path.join(copy, "flexflow_tpu_torch"),
                        ignore=shutil.ignore_patterns("_build", "__pycache__"))
        pipe = os.path.join(copy, "flexflow_tpu_torch", "parallel", "pipeline.py")
        with open(pipe) as f:
            src = f.read()
        if src.count(STASH_LINE) != 1:
            raise SystemExit(f"the 1F1B backward's stash read {STASH_LINE!r} moved")
        with open(pipe, "w") as f:
            f.write(src.replace(STASH_LINE, OTHER_SLOT))
        for name, root in (("sound", REPO), ("other_stash_slot", copy)):
            out = subprocess.run([sys.executable, "-c", PP_RUN, str(args.world), args.device],
                                 cwd=root, env=dict(os.environ, PYTHONPATH=root),
                                 capture_output=True, text=True, timeout=args.timeout)
            if out.returncode != 0:
                raise SystemExit(f"{name}: {out.stderr[-3000:]}")
            print(json.dumps(dict(run=name, **json.loads(out.stdout.strip().splitlines()[-1]))),
                  flush=True)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="probe", required=True)
    d = sub.add_parser("depth")
    d.add_argument("--layers", type=int, nargs="+", default=[2, 3, 4])
    d.add_argument("--timeout", type=float, default=1200.0)
    m = sub.add_parser("mcmc")
    m.add_argument("--evaluations", type=int, default=40)
    m.add_argument("--noise", type=float, default=0.05)
    m.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    o = sub.add_parser("overlap-fault")
    o.add_argument("--timeout", type=float, default=900.0)
    f = sub.add_parser("pp-fault")
    f.add_argument("--world", type=int, choices=(2, 4), default=2)
    f.add_argument("--device", default="cpu")
    f.add_argument("--timeout", type=float, default=900.0)
    args = p.parse_args()
    sys.path.insert(0, REPO)
    {"depth": depth, "mcmc": mcmc, "overlap-fault": overlap_fault,
     "pp-fault": pp_fault}[args.probe](args)


if __name__ == "__main__":
    main()
