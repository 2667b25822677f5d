"""Runtime configuration (trimmed copy of
flexflow_tpu/local_execution/config.py): the FFConfig dataclass with the
JAX package's field names and defaults, so a config written for one
package reads the same in the other, and its command-line parsers
(`add_args`/`from_args`) with every flag, spelling and default of the JAX
package's, which the port's examples start from. A flag whose slice is not
ported still parses; FFModel.compile then refuses the field it set.

The port's FFModel reads the training, profiling and single-device fields;
a field whose machinery is not ported yet is refused by FFModel.compile
with the slice that brings it (see FFModel._validate_config_flags), never
ignored. The search, mesh and planner fields matter only to a compile on
more than one device (one rank each): without a search budget it trains
data parallel, with one it searches (or imports) a plan and lowers it; the
search's fields of A6 part 2, A10 and A13 raise there.
"""

from __future__ import annotations

import argparse
from dataclasses import dataclass
from typing import Optional


@dataclass
class FFConfig:
    # training (reference -e, -b, -p, -d, --lr, ...)
    epochs: int = 1
    batch_size: int = 64
    print_freq: int = 10
    dataset_path: str = ""
    learning_rate: float = 0.01
    weight_decay: float = 0.0
    # machine (reference -ll:gpu/-ll:cpu/--nodes)
    workers_per_node: int = 1
    cpus_per_node: int = 1
    num_nodes: int = 1
    # profiling=True times each layer of the stepped API (CUDA events on
    # the card, the host clock on the CPU); profile_trace_dir and roofline
    # belong to observability (A9)
    profiling: bool = False
    profile_trace_dir: str = ""
    roofline: bool = False
    # run-health telemetry and plan audit (A9)
    metrics_dir: str = ""
    health_policy: str = "off"
    plan_audit: bool = False
    # fused multi-step dispatch (A5 part 2)
    steps_per_dispatch: int = 1
    # the JAX package's persistent XLA compilation cache; the port compiles
    # no XLA program
    compile_cache_dir: str = ""
    # fit-loop checkpoints and supervision (runtime/checkpoint.py,
    # runtime/supervisor.py): checkpoint_dir enables full-resume snapshots
    # every checkpoint_every_n_steps, written by a background thread unless
    # checkpoint_sync; the port writes the npz layout only ("" or "npz":
    # orbax is a JAX library and is refused); watchdog_factor > 0 arms the
    # window watchdog
    checkpoint_dir: str = ""
    checkpoint_every_n_steps: int = 0
    checkpoint_max_to_keep: int = 3
    checkpoint_sync: bool = False
    checkpoint_backend: str = ""
    watchdog_factor: float = 0.0
    # plan-fidelity drift telemetry (A9)
    drift_monitor: bool = False
    drift_band: float = 0.25
    drift_window_steps: int = 8
    drift_run_length: int = 3
    # compile on at most this many devices when > 0
    max_devices: int = 0
    # search and planning (A6, A7, A10): read by a multi-device compile
    hbm_gb: float = 0.0
    search_budget: int = -1
    search_alpha: float = 1.2
    search_overlap_backward_update: bool = False
    export_strategy_file: str = ""
    import_strategy_file: str = ""
    search_num_nodes: int = -1
    search_num_workers: int = -1
    cost_model: str = "analytic"
    search_algorithm: str = "unity"
    only_data_parallel: bool = False
    enable_parameter_parallel: bool = True
    enable_attribute_parallel: bool = True
    enable_inplace_optimizations: bool = False
    substitution_json_path: str = ""
    machine_model_version: int = 0
    machine_model_file: str = ""
    perform_fusion: bool = False
    branch_stacking: bool = False
    submesh_branches: bool = False
    overlap: Optional[bool] = None
    pipeline: Optional[bool] = None
    pipeline_microbatches: int = 0
    multislice: Optional[bool] = None
    movement_cost_store: str = ""
    cost_store: str = ""
    force_strategy_seed: str = ""
    # seed
    seed: int = 0

    @staticmethod
    def add_args(p: argparse.ArgumentParser) -> None:
        p.add_argument("-e", "--epochs", type=int, default=1)
        p.add_argument("-b", "--batch-size", type=int, default=64)
        p.add_argument("-p", "--print-freq", type=int, default=10)
        p.add_argument("-d", "--dataset", type=str, default="")
        p.add_argument("--lr", type=float, default=0.01)
        p.add_argument("--weight-decay", type=float, default=0.0)
        p.add_argument("--workers-per-node", type=int, default=1)
        p.add_argument("--nodes", type=int, default=1)
        p.add_argument("--profiling", action="store_true")
        p.add_argument("--profile-trace-dir", type=str, default="")
        p.add_argument(
            "--roofline",
            action="store_true",
            help="emit the per-op roofline attribution block "
            "(observability/roofline.py)",
        )
        p.add_argument(
            "--metrics-dir",
            type=str,
            default="",
            help="write per-step run-health events (JSONL) and a metrics "
            "snapshot into this directory (observability/metrics.py)",
        )
        p.add_argument(
            "--health-policy",
            type=str,
            default="off",
            choices=("off", "warn", "skip_step", "raise"),
            help="reaction to a non-finite loss/gradient: warn logs, "
            "skip_step drops the poisoned update and keeps training, raise "
            "stops with the first bad op named (observability/health.py)",
        )
        p.add_argument(
            "--steps-per-dispatch",
            type=int,
            default=1,
            help="train K steps a window (one CUDA graph a window on the "
            "card; 1 = per-step loop)",
        )
        p.add_argument(
            "--compile-cache-dir",
            type=str,
            default="",
            help="the JAX package's XLA compilation cache directory; the "
            "port compiles no XLA program and keeps the field only",
        )
        p.add_argument(
            "--checkpoint-dir",
            type=str,
            default="",
            help="enable fit-loop checkpointing into this directory "
            "(async background writer; full-resume snapshots)",
        )
        p.add_argument(
            "--checkpoint-every-n-steps",
            type=int,
            default=0,
            help="snapshot interval in training steps (0 = only explicit "
            "save_checkpoint calls)",
        )
        p.add_argument(
            "--checkpoint-max-to-keep",
            type=int,
            default=3,
            help="checkpoint retention: older step dirs are GC'd",
        )
        p.add_argument(
            "--checkpoint-sync",
            action="store_true",
            help="force the blocking (synchronous) checkpoint save path "
            "instead of the background writer",
        )
        p.add_argument(
            "--checkpoint-backend",
            type=str,
            default="",
            choices=("", "npz", "orbax"),
            help="checkpoint serialization backend: npz (the default) = "
            "raw-.npy layout with the per-leaf checksum manifest "
            "(runtime/integrity.py); orbax, the JAX package's other "
            "backend, is refused (a JAX library)",
        )
        p.add_argument(
            "--watchdog-factor",
            type=float,
            default=0.0,
            help="arm a hang watchdog around every dispatch window with a "
            "budget of (rolling window-time estimate x FACTOR); expiry "
            "records a HangDiagnostic and raises WindowHangError (0 = "
            "off; FF_TPU_WATCHDOG supplies the factor when unset)",
        )
        p.add_argument(
            "--drift-monitor",
            action="store_true",
            help="watch the live metrics stream for plan-fidelity drift "
            "(measured vs searched-predicted step ms) and emit "
            "ReplanAdvisories into events.jsonl + "
            "search_provenance['drift'] — advisory only, no hot-swap; "
            "requires --metrics-dir (observability/drift.py)",
        )
        p.add_argument(
            "--drift-band",
            type=float,
            default=0.25,
            help="drift tolerance band: an EMA'd measured/predicted ratio "
            "outside [1/(1+band), 1+band] of the run's baseline counts "
            "as out-of-band",
        )
        p.add_argument(
            "--drift-window-steps",
            type=int,
            default=8,
            help="steps aggregated per drift-detection window",
        )
        p.add_argument(
            "--drift-run-length",
            type=int,
            default=3,
            help="consecutive out-of-band windows required before a "
            "ReplanAdvisory fires (run-length confirmation)",
        )
        p.add_argument(
            "--max-devices",
            type=int,
            default=0,
            help="cap the device grid compile() plans for (>0): the "
            "degraded-grid recovery path's shrunken-mesh knob",
        )
        p.add_argument(
            "--hbm-gb",
            type=float,
            default=0.0,
            help="per-device HBM capacity in GiB (> 0): OOM mappings "
            "become INFEASIBLE in the machine-mapping search and the "
            "winner is statically verified against it (MEM001-MEM004; "
            "analysis/memory_analysis.py)",
        )
        p.add_argument(
            "--plan-audit",
            action="store_true",
            help="after the Unity search, replay the winning plan measuring "
            "per-op and per-movement-edge cost against the model's "
            "predictions (observability/plan_audit.py)",
        )
        p.add_argument(
            "--overlap",
            action=argparse.BooleanOptionalAction,
            default=None,
            help="fused collective-matmul lowering of Combine/Reduction "
            "edges adjacent to dense ops + overlap-aware movement pricing "
            "in the machine-mapping DP (--overlap forces on, --no-overlap "
            "forces off; unset defers to FF_TPU_OVERLAP)",
        )
        p.add_argument(
            "--pipeline",
            action=argparse.BooleanOptionalAction,
            default=None,
            help="pipeline parallelism: seed the Unity search "
            "with StagePartition/StageMerge stage-partitioned candidates "
            "(1F1B bubble-aware stage axis in both DPs) and lower a "
            "stage-partitioned winner via the shard_map+ppermute 1F1B "
            "executor (--pipeline forces on, --no-pipeline forces off; "
            "unset defers to FF_TPU_PIPELINE)",
        )
        p.add_argument(
            "--multislice",
            action=argparse.BooleanOptionalAction,
            default=None,
            help="hierarchical multi-slice search: two-level "
            "ICI/DCN machine-mapping DP — the outer level picks which "
            "axis kind (data/replica/stage or none) crosses the slice "
            "boundary, the inner per-slice DP enumerates only "
            "slice-contiguous views (--multislice forces on, "
            "--no-multislice forces off; unset defers to "
            "FF_TPU_MULTISLICE)",
        )
        p.add_argument(
            "--pipeline-microbatches",
            type=int,
            default=0,
            help="microbatch count M for the pipeline seeds (0 = auto: "
            "the largest of {2S, S, 8, 4, 2} dividing the per-shard batch)",
        )
        p.add_argument(
            "--movement-cost-store",
            type=str,
            default="",
            help="JSON file persisting measured movement-edge costs from "
            "plan-audit runs; searches prefer these measurements over the "
            "analytic collective estimates",
        )
        p.add_argument(
            "--cost-store-dir",
            type=str,
            default="",
            help="persistent cost database directory (cost_db.json): "
            "searches fall through analytic -> cached-measured -> measure "
            "across sessions, write back new measurements, and fit "
            "per-op-class correction factors from the accumulated "
            "(analytic, measured) pairs (compiler/cost_store.py)",
        )
        p.add_argument("--search-budget", type=int, default=-1)
        p.add_argument("--search-alpha", type=float, default=1.2)
        p.add_argument("--export-strategy", type=str, default="")
        p.add_argument("--import-strategy", type=str, default="")
        p.add_argument("--only-data-parallel", action="store_true")
        p.add_argument(
            "--enable-parameter-parallel",
            action=argparse.BooleanOptionalAction,
            default=True,
        )
        p.add_argument(
            "--enable-attribute-parallel",
            action=argparse.BooleanOptionalAction,
            default=True,
        )
        p.add_argument("--substitution-json", type=str, default="")
        p.add_argument(
            "--perform-fusion",
            action="store_true",
            help="add graph-level fusion rules (sibling/consecutive linear "
            "merge, activation fusion) to the Unity search space",
        )
        p.add_argument(
            "--branch-stacking",
            action="store_true",
            help="stack isomorphic parallel branches so the search can "
            "place them on disjoint device subsets (operator placement)",
        )
        p.add_argument("--search-num-nodes", type=int, default=-1)
        p.add_argument("--search-num-workers", type=int, default=-1)
        p.add_argument(
            "--cost-model",
            type=str,
            default="analytic",
            choices=("analytic", "measured", "calibrated", "auto"),
        )
        p.add_argument(
            "--search-algorithm",
            type=str,
            default="unity",
            choices=("unity", "mcmc"),
            help="best-first (new stack) or simulated-annealing (legacy "
            "strategy_search_task) strategy search",
        )
        p.add_argument("--machine-model-version", type=int, default=0)
        p.add_argument("--machine-model-file", type=str, default="")
        p.add_argument("--seed", type=int, default=0)

    @staticmethod
    def from_args(args: argparse.Namespace) -> "FFConfig":
        return FFConfig(
            epochs=args.epochs,
            batch_size=args.batch_size,
            print_freq=args.print_freq,
            dataset_path=args.dataset,
            learning_rate=args.lr,
            weight_decay=args.weight_decay,
            workers_per_node=args.workers_per_node,
            num_nodes=args.nodes,
            profiling=args.profiling,
            profile_trace_dir=args.profile_trace_dir,
            roofline=getattr(args, "roofline", False),
            metrics_dir=getattr(args, "metrics_dir", ""),
            health_policy=getattr(args, "health_policy", "off"),
            plan_audit=getattr(args, "plan_audit", False),
            steps_per_dispatch=getattr(args, "steps_per_dispatch", 1),
            compile_cache_dir=getattr(args, "compile_cache_dir", ""),
            checkpoint_dir=getattr(args, "checkpoint_dir", ""),
            checkpoint_every_n_steps=getattr(
                args, "checkpoint_every_n_steps", 0
            ),
            checkpoint_max_to_keep=getattr(args, "checkpoint_max_to_keep", 3),
            checkpoint_sync=getattr(args, "checkpoint_sync", False),
            checkpoint_backend=getattr(args, "checkpoint_backend", ""),
            watchdog_factor=getattr(args, "watchdog_factor", 0.0),
            drift_monitor=getattr(args, "drift_monitor", False),
            drift_band=getattr(args, "drift_band", 0.25),
            drift_window_steps=getattr(args, "drift_window_steps", 8),
            drift_run_length=getattr(args, "drift_run_length", 3),
            max_devices=getattr(args, "max_devices", 0),
            hbm_gb=getattr(args, "hbm_gb", 0.0),
            overlap=getattr(args, "overlap", None),
            pipeline=getattr(args, "pipeline", None),
            pipeline_microbatches=getattr(
                args, "pipeline_microbatches", 0
            ),
            multislice=getattr(args, "multislice", None),
            movement_cost_store=getattr(args, "movement_cost_store", ""),
            cost_store=getattr(args, "cost_store_dir", ""),
            search_budget=args.search_budget,
            search_alpha=args.search_alpha,
            export_strategy_file=args.export_strategy,
            import_strategy_file=args.import_strategy,
            only_data_parallel=args.only_data_parallel,
            enable_parameter_parallel=args.enable_parameter_parallel,
            enable_attribute_parallel=args.enable_attribute_parallel,
            substitution_json_path=args.substitution_json,
            perform_fusion=args.perform_fusion,
            branch_stacking=args.branch_stacking,
            search_num_nodes=args.search_num_nodes,
            search_num_workers=args.search_num_workers,
            cost_model=args.cost_model,
            search_algorithm=args.search_algorithm,
            machine_model_version=args.machine_model_version,
            machine_model_file=args.machine_model_file,
            seed=args.seed,
        )
