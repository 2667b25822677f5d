"""Runtime configuration (trimmed copy of
flexflow_tpu/local_execution/config.py): the FFConfig dataclass with the
JAX package's field names and defaults, so a config written for one
package reads the same in the other. The command-line parsers
(`add_args`/`from_args`) come with the port's examples (A5 part 3).

The port's FFModel reads the training, profiling and single-device fields;
a field whose machinery is not ported yet is refused by FFModel.compile
with the slice that brings it (see FFModel._validate_config_flags), never
ignored. The search, mesh and planner fields matter only to a compile on
more than one device, which raises until A6/A7.
"""

from __future__ import annotations

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
    # checkpointing and supervision (A8)
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
