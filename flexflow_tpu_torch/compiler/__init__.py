"""Compiler / auto-parallelizer: machine-mapping DP + Unity joint search
(copy of flexflow_tpu/compiler).

SP decomposition of the PCG, the memoized machine-mapping DP
(reference get_optimal_machine_mapping.cc:28-254), allowed machine-view
enumeration over the node/GPU grid, the cost estimators (analytic, or each
leaf measured on the card), and the Unity best-first substitution search;
the persistent cost and movement stores (cost_store.py, movement_store.py),
the MCMC search (mcmc_search.py), the machine models (machine_model.py),
branch stacking (branch_stacking.py), the two-level DP over nodes
(machine_mapping/hierarchical.py, slice_axes.py), the overlap pricing of
the collective matmuls (machine_mapping/overlap.py) and the movement-edge
export (machine_mapping/movement_export.py).
"""

from flexflow_tpu_torch.compiler.machine_mapping.problem_tree import (
    UnmappedOpCostEstimateKey,
    OpCostEstimateKey,
    AbstractedSingleTensorMovement,
    AbstractedTensorSetMovement,
    MMProblemTreeSeriesSplit,
    MMProblemTreeParallelSplit,
    MachineMappingProblemTree,
    get_machine_mapping_problem_tree,
    operator_task_space,
)
from flexflow_tpu_torch.compiler.machine_mapping.result import (
    MachineMappingResult,
    FeasibleMachineMappingResult,
    INFEASIBLE,
    series_combine,
    parallel_combine,
    minimize_runtime,
)
from flexflow_tpu_torch.compiler.machine_mapping.cost_estimator import (
    CostEstimator,
    SingleTensorMovement,
    TensorSetMovement,
    GPUCostEstimator,
    AnalyticGPUCostEstimator,
    BandwidthCommModel,
    make_default_allowed_machine_views,
)
from flexflow_tpu_torch.compiler.unity_algorithm import (
    OptimizerConfig,
    GraphOptimizeResult,
    evaluate_pcg,
    graph_optimize,
    parallel_degree_summary,
)
from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
    MachineMappingCache,
    MachineMappingContext,
    get_optimal_machine_mapping,
    get_machine_resource_splits,
)
from flexflow_tpu_torch.compiler.allowed_machine_views import get_allowed_machine_views
from flexflow_tpu_torch.compiler.unity_algorithm import price_mapped_plan
from flexflow_tpu_torch.compiler.cost_store import CostStore, device_kind_signature
from flexflow_tpu_torch.compiler.movement_store import MovementCostStore
from flexflow_tpu_torch.compiler.mcmc_search import MCMCConfig, mcmc_optimize
