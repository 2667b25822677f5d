"""The FFModel user API: build, compile, fit, eval, and the stepped
forward/backward/update loop (port of flexflow_tpu/core/ffmodel.py).

A model author writes the same code as for the JAX package:

    m = FFModel(FFConfig(batch_size=8))
    x = m.create_tensor([8, 32], name="x")
    out = m.dense(m.dense(x, 16, activation=Activation.RELU), 4)
    m.compile(SGDOptimizer(lr=0.1), "sparse_categorical_crossentropy",
              metrics=["accuracy"])
    m.fit(xs, ys, epochs=3)

The builder is called in the JAX package's order, so weight node indices,
and with them the parameter keys `n{idx}` and names like "fc1.weight0",
name the same tensors in both packages. `compile` on one device builds the
ModelTrainingInstance the JAX package builds there (CUDA unless the model
was made with device="cpu"); `fit` drives its train_step, the same step a
direct caller drives. With `FFConfig(steps_per_dispatch=K)`, `fit` runs
windows of K steps through `multi_train_step` (on a card, one CUDA graph
replay a window), fed by the windowed input pipeline.

Over several devices the port runs one process per device: the devices of
a compile are the ranks of the default process group (opened by
`runtime.distributed.initialize`, under torchrun or from the
FLEXFLOW_TPU_* variables, or by `parallel.init_file_group`). Without a
search budget the compile trains data parallel
(DataParallelTrainingInstance); with one, rank 0 runs the Unity search (or
imports FFConfig.import_strategy_file, or builds a forced seed) and every
rank receives the plan as its strategy document
(runtime.distributed.run_search_on_host_0), and the winner trains through
DistributedTrainingInstance (FFConfig.export_strategy_file is written by
rank 0). A calibrated or measured search first calibrates the ranks
(compiler/calibration.py, a collective). Each rank's fit is fed only its
own rows of every batch, and `steps_per_dispatch` runs its windows on
either trainer.

Checkpoints (runtime/checkpoint.py): `save_checkpoint` / `load_checkpoint`
write and read the JAX package's npz layout, so either package restores
the other's; `fit(checkpoint_dir=..., checkpoint_every_n_steps=...)` takes
full-resume snapshots (async unless FFConfig.checkpoint_sync) at step or
window boundaries, and `fit(resume=True)` continues bitwise from the
latest. A restore copies into the existing tensors, so the windows' CUDA
graphs stay valid. Over several ranks rank 0 writes (a searched plan's
state gathered first, a collective) and every rank restores its pieces.
The fit loop's supervision (runtime/supervisor.py, runtime/fault.py): the
window watchdog (FFConfig.watchdog_factor or FF_TPU_WATCHDOG), the fault
channel, and the fault sites FF_TPU_FAULT_STEP and FF_TPU_FAULT_SPEC arm.

What reaches a slice that is not ported yet raises NotImplementedError
naming it, at the call: the layer methods of unported ops (A2), the
search's stores, other algorithms and its pricing of the fused collective
matmuls (A6 part 2), a searched compile's memory budget (FFConfig.hbm_gb:
the capacity detection, compile-time verification and provenance around
the budgeted search, A6 part 2 / A13; the budgeted search itself,
compiler.evaluate_pcg under a memory_budget_bytes, is ported), recompiles
(A8 part 2), telemetry, traces, plan audits and the `nonfinite` and `slow`
fault sites (A9), pipelines and sub-mesh branches (A10).
"""
from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from flexflow_tpu_torch.core.dataloader import BatchIterator, WindowedBatchIterator
from flexflow_tpu_torch.core.optimizers import optimizer_attrs_of
from flexflow_tpu_torch.kernels.loss import loss_forward
from flexflow_tpu_torch.kernels.metrics import PerfMetrics, compute_metrics
from flexflow_tpu_torch.local_execution.config import FFConfig
from flexflow_tpu_torch.parallel.data_parallel import DataParallelTrainingInstance
from flexflow_tpu_torch.local_execution.training_backing import (
    LocalTrainingBacking,
    ModelTrainingInstance,
    param_key,
    resolve_device,
)
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.ops import (
    AggregateSpec,
    InputAttrs,
    LossFunction,
    PoolOp,
    WeightAttrs,
    loss_attrs_for,
)
from flexflow_tpu_torch.pcg.computation_graph_builder import ComputationGraphBuilder
from flexflow_tpu_torch.pcg.optimizer import SGDOptimizerAttrs
from flexflow_tpu_torch.utils.graph import DataflowOutput, Node

# Loss/metric name aliases matching the legacy string API
LossType = LossFunction

HEALTH_POLICIES = ("off", "warn", "skip_step", "raise")


class CompMode(enum.Enum):
    TRAINING = 0
    INFERENCE = 1


class Tensor:
    """Handle to a dataflow tensor."""

    def __init__(self, ffmodel: "FFModel", handle: DataflowOutput) -> None:
        self.ffmodel = ffmodel
        self.handle = handle

    @property
    def dims(self) -> Tuple[int, ...]:
        return tuple(self.ffmodel.cg.tensor_shape(self.handle).dims)

    @property
    def dtype(self) -> DataType:
        return self.ffmodel.cg.tensor_shape(self.handle).dtype

    def get_tensor(self, ffmodel: Optional["FFModel"] = None) -> np.ndarray:
        """Current value: weights read from params; activations from the last
        stepped forward."""
        m = ffmodel or self.ffmodel
        return m._read_tensor(self.handle)

    def set_tensor(self, ffmodel: Optional["FFModel"], value: np.ndarray) -> None:
        m = ffmodel or self.ffmodel
        m._write_tensor(self.handle, np.asarray(value))

    def inline_map(self, ffmodel=None, ffconfig=None):  # legacy API no-op
        return self

    def inline_unmap(self, ffmodel=None, ffconfig=None):
        return self


class Parameter(Tensor):
    """A weight tensor."""

    def get_weights(self, ffmodel: Optional["FFModel"] = None) -> np.ndarray:
        return self.get_tensor(ffmodel)

    def set_weights(self, ffmodel: Optional["FFModel"], value: np.ndarray) -> None:
        self.set_tensor(ffmodel, value)


def _unported(method: str, what: str):
    """A layer method whose op is not ported yet: it raises at the call."""

    def raise_unported(self, *args, **kwargs):
        raise NotImplementedError(f"FFModel.{method}: {what} is not ported yet (A2)")

    raise_unported.__name__ = method
    return raise_unported


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (bf16 widened to f32), never a view of the tensor."""
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy())


class FFModel:
    """Computation-graph builder + trainer on one device."""

    def __init__(self, config: Optional[FFConfig] = None, device=None) -> None:
        """device: where compile places the model; CUDA unless given (see
        resolve_device: without a card and without device="cpu" this
        raises)."""
        self.config = config or FFConfig()
        self.device = resolve_device(device)
        self._builder = ComputationGraphBuilder()
        self._num_inputs = 0
        # the newest layer's output handle, not its Tensor: a Tensor refers
        # back to the model, and that cycle would hold the model's device
        # memory until the garbage collector's next full pass
        self._last_output: Optional[DataflowOutput] = None
        # set by compile():
        self.instance: Optional[ModelTrainingInstance] = None
        self.params: Optional[Dict[str, torch.Tensor]] = None
        self.opt_state = None
        self.loss_attrs = None
        self.optimizer_attrs = None
        self.metrics: frozenset = frozenset()
        self.comp_mode = CompMode.TRAINING
        self._backing: Optional[LocalTrainingBacking] = None
        self._label_dtype = np.int32
        self._step_count = 0
        self._aux_loss_tensors: List[DataflowOutput] = []
        # how a searched compile found its plan (None for any other compile)
        self.search_provenance: Optional[dict] = None
        # fit's generator, reseeded by each fit: one object, so that the
        # fused windows' CUDA graphs, which register it, outlive a fit
        self._rng: Optional[torch.Generator] = None
        # the last checkpointing fit's TrainingCheckpointer (its snapshots'
        # records), None before one
        self.checkpointer = None

    @classmethod
    def from_computation_graph(
        cls,
        cg,
        logit_tensor: Union["Tensor", DataflowOutput],
        config: Optional[FFConfig] = None,
        aux_loss_tensors=(),
        device=None,
    ) -> "FFModel":
        """Adopt a CG built elsewhere (e.g. models.build_flagship_cg) so it
        can be compiled and fit through this API. `cg` may be a bare graph
        or a ComputationGraphBuilder."""
        m = cls(config, device=device)
        m._builder.graph = cg.graph if isinstance(cg, ComputationGraphBuilder) else cg
        for t in aux_loss_tensors:
            m._aux_loss_tensors.append(t.handle if isinstance(t, Tensor) else t)
        m._wrap(logit_tensor.handle if isinstance(logit_tensor, Tensor) else logit_tensor)
        return m

    # ------------------------------------------------------------------
    # graph access
    # ------------------------------------------------------------------

    @property
    def cg(self):
        return self._builder.graph

    def _wrap(self, h: DataflowOutput) -> Tensor:
        self._last_output = h
        return Tensor(self, h)

    def _unwrap(self, t: Union[Tensor, DataflowOutput]) -> DataflowOutput:
        return t.handle if isinstance(t, Tensor) else t

    # ------------------------------------------------------------------
    # layer API
    # ------------------------------------------------------------------

    def create_tensor(
        self,
        dims: Sequence[int],
        dtype: DataType = DataType.FLOAT,
        create_grad: bool = True,
        name: Optional[str] = None,
    ) -> Tensor:
        # inputs always get a stable name, as in the JAX package
        if name is None:
            name = f"input{self._num_inputs}"
        self._num_inputs += 1
        return self._wrap(self._builder.create_input(dims, dtype, name=name))

    def create_weight(
        self, dims, dtype: DataType = DataType.FLOAT, initializer=None, name=None
    ) -> Parameter:
        return Parameter(self, self._builder.create_weight(dims, dtype, initializer, name=name))

    def dense(
        self, input, out_dim, activation=None, use_bias=True,
        kernel_initializer=None, bias_initializer=None, name=None,
    ) -> Tensor:
        return self._wrap(self._builder.dense(
            self._unwrap(input), out_dim, activation=activation,
            use_bias=use_bias, kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer, name=name,
        ))

    def embedding(
        self, input, num_entries, out_dim, aggr=None,
        kernel_initializer=None, name=None,
    ) -> Tensor:
        return self._wrap(self._builder.embedding(
            self._unwrap(input), num_entries, out_dim,
            aggr=aggr or AggregateSpec.NONE,
            kernel_initializer=kernel_initializer, name=name,
        ))

    def multihead_attention(
        self, query, key, value, embed_dim, num_heads,
        kdim=0, vdim=0, dropout=0.0, bias=False,
        add_bias_kv=False, add_zero_attn=False, initializer=None, name=None,
    ) -> Tensor:
        return self._wrap(self._builder.multihead_attention(
            self._unwrap(query), self._unwrap(key), self._unwrap(value),
            embed_dim, num_heads, kdim=kdim, vdim=vdim, dropout=dropout,
            bias=bias, add_bias_kv=add_bias_kv, add_zero_attn=add_zero_attn,
            initializer=initializer, name=name,
        ))

    def layer_norm(
        self, input, axes=(-1,), elementwise_affine=True, eps=1e-5, name=None
    ) -> Tensor:
        return self._wrap(self._builder.layer_norm(
            self._unwrap(input), axes=list(axes),
            elementwise_affine=elementwise_affine, eps=eps, name=name,
        ))

    def softmax(self, input, axis=-1, name=None) -> Tensor:
        return self._wrap(self._builder.softmax(self._unwrap(input), dim=axis, name=name))

    def dropout(self, input, rate, seed=0, name=None) -> Tensor:
        return self._wrap(self._builder.dropout(self._unwrap(input), rate, seed=seed, name=name))

    def conv2d(
        self, input, out_channels, kernel_h, kernel_w, stride_h, stride_w,
        padding_h, padding_w, activation=None, groups=1, use_bias=True,
        kernel_initializer=None, bias_initializer=None, name=None,
    ) -> Tensor:
        return self._wrap(self._builder.conv2d(
            self._unwrap(input), out_channels, (kernel_h, kernel_w),
            (stride_h, stride_w), (padding_h, padding_w), groups=groups,
            activation=activation, use_bias=use_bias,
            kernel_initializer=kernel_initializer,
            bias_initializer=bias_initializer, name=name,
        ))

    def pool2d(
        self, input, kernel_h, kernel_w, stride_h, stride_w,
        padding_h, padding_w, pool_type=None, activation=None, name=None,
    ) -> Tensor:
        """pool_type: a PoolOp or its name, "max" (the default) or "avg"."""
        if isinstance(pool_type, str):
            pool_type = PoolOp(pool_type.lower())
        return self._wrap(self._builder.pool2d(
            self._unwrap(input), (kernel_h, kernel_w), (stride_h, stride_w),
            (padding_h, padding_w), pool_type=pool_type or PoolOp.MAX,
            activation=activation, name=name,
        ))

    def batch_norm(self, input, relu=True, name=None) -> Tensor:
        return self._wrap(self._builder.batch_norm(self._unwrap(input), relu=relu, name=name))

    def flat(self, input, name=None) -> Tensor:
        return self._wrap(self._builder.flat(self._unwrap(input), name=name))

    def concat(self, tensors, axis, name=None) -> Tensor:
        return self._wrap(self._builder.concat([self._unwrap(t) for t in tensors], axis,
                                               name=name))

    def split(self, input, sizes, axis, name=None) -> List[Tensor]:
        outs = self._builder.split(self._unwrap(input), sizes, axis, name=name)
        return [self._wrap(o) for o in outs]

    def reshape(self, input, shape, name=None) -> Tensor:
        return self._wrap(self._builder.reshape(self._unwrap(input), shape, name=name))

    transpose = _unported("transpose", "Transpose")
    reverse = _unported("reverse", "Reverse")
    gather = _unported("gather", "Gather")
    top_k = _unported("top_k", "TopK")
    cast = _unported("cast", "Cast")
    broadcast = _unported("broadcast", "Broadcast")
    def batch_matmul(self, a, b, name=None) -> Tensor:
        return self._wrap(self._builder.batch_matmul(self._unwrap(a), self._unwrap(b), name=name))
    reduce_sum = _unported("reduce_sum", "ReduceSum")
    mean = _unported("mean", "ReduceMean")
    group_by = _unported("group_by", "GroupBy")
    aggregate = _unported("aggregate", "Aggregate")
    moe = _unported("moe", "the Experts op")

    # elementwise binary
    def add(self, x, y, name=None):
        return self._wrap(self._builder.add(self._unwrap(x), self._unwrap(y), name=name))

    def subtract(self, x, y, name=None):
        return self._wrap(self._builder.subtract(self._unwrap(x), self._unwrap(y), name=name))

    def multiply(self, x, y, name=None):
        return self._wrap(self._builder.multiply(self._unwrap(x), self._unwrap(y), name=name))

    def divide(self, x, y, name=None):
        return self._wrap(self._builder.divide(self._unwrap(x), self._unwrap(y), name=name))

    def max(self, x, y, name=None):
        return self._wrap(self._builder.max(self._unwrap(x), self._unwrap(y), name=name))

    def min(self, x, y, name=None):
        return self._wrap(self._builder.min(self._unwrap(x), self._unwrap(y), name=name))

    # elementwise unary
    def exp(self, x, name=None):
        return self._wrap(self._builder.exp(self._unwrap(x), name=name))

    def log(self, x, name=None):
        return self._wrap(self._builder.log(self._unwrap(x), name=name))

    def sin(self, x, name=None):
        return self._wrap(self._builder.sin(self._unwrap(x), name=name))

    def cos(self, x, name=None):
        return self._wrap(self._builder.cos(self._unwrap(x), name=name))

    def relu(self, x, name=None):
        return self._wrap(self._builder.relu(self._unwrap(x), name=name))

    def sigmoid(self, x, name=None):
        return self._wrap(self._builder.sigmoid(self._unwrap(x), name=name))

    def tanh(self, x, name=None):
        return self._wrap(self._builder.tanh(self._unwrap(x), name=name))

    def gelu(self, x, name=None):
        return self._wrap(self._builder.gelu(self._unwrap(x), name=name))

    def elu(self, x, name=None):
        return self._wrap(self._builder.elu(self._unwrap(x), name=name))

    def rsqrt(self, x, name=None):
        return self._wrap(self._builder.rsqrt(self._unwrap(x), name=name))

    def identity(self, x, name=None):
        return self._wrap(self._builder.identity(self._unwrap(x), name=name))

    def scalar_multiply(self, x, scalar, name=None):
        return self._wrap(self._builder.scalar_multiply(self._unwrap(x), scalar, name=name))

    def scalar_add(self, x, scalar, name=None):
        return self._wrap(self._builder.scalar_add(self._unwrap(x), scalar, name=name))

    def scalar_sub(self, x, scalar, name=None):
        return self._wrap(self._builder.scalar_sub(self._unwrap(x), scalar, name=name))

    def scalar_true_divide(self, x, scalar, name=None):
        return self._wrap(self._builder.scalar_truediv(self._unwrap(x), scalar, name=name))

    def pow(self, x, exponent, name=None):
        return self._wrap(self._builder.pow(self._unwrap(x), exponent, name=name))

    # ------------------------------------------------------------------
    # layer/parameter lookup
    # ------------------------------------------------------------------

    def get_layers(self) -> Dict[int, str]:
        cg = self.cg
        return {n.idx: (cg.layer_attrs(n).name or f"layer{n.idx}") for n in cg.topological_ordering()}

    def _find_weight_node(self, name: str) -> Optional[Node]:
        cg = self.cg
        for n in cg.topological_ordering():
            la = cg.layer_attrs(n)
            if isinstance(la.attrs, WeightAttrs) and la.name == name:
                return n
        return None

    def get_parameter_by_name(self, name: str) -> Parameter:
        """`name` is the layer weight name (e.g. "fc1.weight0" for a dense
        layer named "fc1"; bias is ".weight1")."""
        n = self._find_weight_node(name) or self._find_weight_node(name + ".weight0")
        if n is None:
            raise KeyError(name)
        (out,) = self.cg.outputs_of(n)
        return Parameter(self, out)

    # ------------------------------------------------------------------
    # tensor value plumbing
    # ------------------------------------------------------------------

    def _weight_node_of(self, handle: DataflowOutput) -> Optional[Node]:
        n = handle.node
        return n if isinstance(self.cg.op_attrs(n), WeightAttrs) else None

    def _searched_weight(self, n: Node):
        """(PCG parameter key, sharding) of CG weight node n in a searched
        plan: found by its layer name, which the rewrites keep."""
        inst = self.instance
        name = self.cg.layer_attrs(n).name
        hits = [w for w in inst.pcg.topological_ordering()
                if isinstance(inst.pcg.op_attrs(w), WeightAttrs)
                and inst.pcg.layer_attrs(w).name == name]
        if name is None or len(hits) != 1:
            raise KeyError(f"weight {name!r} has no unique counterpart in the searched plan")
        return param_key(hits[0]), inst.weight_sharding(param_key(hits[0]))

    def _read_tensor(self, handle: DataflowOutput) -> np.ndarray:
        n = self._weight_node_of(handle)
        if n is not None and self.params is not None and self._searched():
            # a collective: every rank reads, in the same order
            from flexflow_tpu_torch.parallel import gather_block

            key, sharding = self._searched_weight(n)
            return _to_numpy(gather_block(self.params[key], sharding, self.instance.machine_mesh))
        if n is not None and self.params is not None:
            return _to_numpy(self.params[param_key(n)])
        if self._backing is not None and handle in self._backing.env:
            return _to_numpy(self._backing.env[handle])
        raise KeyError("tensor has no materialized value; compile() and run forward first")

    def _write_tensor(self, handle: DataflowOutput, value: np.ndarray) -> None:
        """Writes in place, so the stepped backing and the optimizer state
        keep referring to the same parameter."""
        n = self._weight_node_of(handle)
        if n is None or self.params is None:
            raise KeyError("set_tensor only supported on weights after compile()")
        if self._searched():
            from flexflow_tpu_torch.parallel import local_block

            key, sharding = self._searched_weight(n)
            value = local_block(torch.as_tensor(value), sharding, self.instance.machine_mesh, key)
            n = Node(int(key[1:]))
        cur = self.params[param_key(n)]
        if tuple(cur.shape) != tuple(value.shape):
            raise ValueError(f"shape mismatch: {tuple(cur.shape)} vs {value.shape}")
        with torch.no_grad():
            cur.copy_(torch.as_tensor(value))

    # ------------------------------------------------------------------
    # compile
    # ------------------------------------------------------------------

    def compile(
        self,
        optimizer=None,
        loss_type: Union[LossFunction, str] = LossFunction.SPARSE_CATEGORICAL_CROSSENTROPY,
        metrics: Sequence[str] = (),
        comp_mode: CompMode = CompMode.TRAINING,
        logit_tensor: Optional[Tensor] = None,
        compute_dtype: Optional[torch.dtype] = None,
    ) -> None:
        """Build the train step on one device and initialize the parameters
        from config.seed. compute_dtype: a torch dtype the forward and
        backward run in (parameters and optimizer state stay f32)."""
        if isinstance(loss_type, str):
            loss_type = LossFunction(loss_type)
        if compute_dtype is not None and not isinstance(compute_dtype, torch.dtype):
            raise TypeError(f"compute_dtype must be a torch dtype, got {compute_dtype!r}")
        cfg = self.config
        self.loss_attrs = loss_attrs_for(loss_type)
        self.optimizer_attrs = optimizer_attrs_of(optimizer) or SGDOptimizerAttrs(
            lr=cfg.learning_rate, weight_decay=cfg.weight_decay)
        self._validate_config_flags()
        self.metrics = frozenset(metrics)
        self.comp_mode = comp_mode
        logit = self._unwrap(logit_tensor) if logit_tensor is not None else self._last_output
        self._label_dtype = (
            np.int32 if loss_type == LossFunction.SPARSE_CATEGORICAL_CROSSENTROPY else np.float32)
        ndev = self._device_count()
        if ndev > 1 and not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                f"a compile over {ndev} devices runs one process per device: open the default "
                "process group first (parallel.init_file_group, or torch.distributed."
                "init_process_group under torchrun), or set max_devices=1 (A7 item 4)")
        if ndev > 1 and self._aux_loss_tensors:
            raise NotImplementedError(
                "auxiliary loss tensors over several devices come with the MoE slice (A11)")
        self.invalidate_graphs()
        self.search_provenance = None
        if ndev > 1 and cfg.search_budget > 0 and not cfg.only_data_parallel:
            self.instance = self._compile_searched(logit, ndev, compute_dtype)
        elif ndev > 1:
            self.instance = DataParallelTrainingInstance(
                self.cg, logit, self.loss_attrs, self.optimizer_attrs,
                compute_dtype=compute_dtype, device=self.device, metrics=self.metrics,
            )
        else:
            self.instance = ModelTrainingInstance(
                self.cg, logit, self.loss_attrs, self.optimizer_attrs,
                compute_dtype=compute_dtype, device=self.device, metrics=self.metrics,
                aux_loss_tensors=self._aux_loss_tensors,
            )
        self.params, self.opt_state = self.instance.initialize(seed=cfg.seed)
        self._step_count = 0
        self._backing = None

    def _device_count(self) -> int:
        """The devices a compile spans, as the JAX package counts them: the
        ranks of the default process group (one process each), or without
        a group the visible cards of the model's kind; capped by
        max_devices, and cut to the largest count that divides the first
        input's batch. A group whose size is not that count raises."""
        grouped = dist.is_available() and dist.is_initialized()
        if grouped:
            world = dist.get_world_size()
        else:
            world = torch.cuda.device_count() if self.device.type == "cuda" else 1
        ndev = world
        if self.config.max_devices > 0:
            ndev = min(ndev, self.config.max_devices)
        inputs = [n for n in self.cg.topological_ordering()
                  if isinstance(self.cg.op_attrs(n), InputAttrs)]
        if inputs:
            batch = self.cg.tensor_shape(self.cg.outputs_of(inputs[0])[0]).dims[0]
            while ndev > 1 and batch % ndev:
                ndev -= 1
        if grouped and ndev != world:
            raise ValueError(
                f"this compile spans {ndev} devices (max_devices {self.config.max_devices}, "
                f"the batch's divisors) but the process group has {world} ranks: a compile "
                "runs one rank per device")
        return ndev

    def _compile_searched(self, logit: DataflowOutput, ndev: int, compute_dtype):
        """The Unity path (the JAX package's _compile_searched): lift the CG
        to a PCG, search substitutions and machine mappings for `ndev`
        devices (or import a saved strategy), and lower the winner on the
        mesh of the process group's ranks. Rank 0 searches; the plan reaches
        every rank as its strategy document, so all lower the same PCG."""
        from flexflow_tpu_torch.compiler import (
            AnalyticGPUCostEstimator,
            GPUCostEstimator,
            MachineMappingContext,
            OptimizerConfig,
            graph_optimize,
            make_default_allowed_machine_views,
            parallel_degree_summary,
        )
        from flexflow_tpu_torch.compiler.calibration import (
            H100_NVLINK_GBPS,
            NDR_INFINIBAND_GBPS,
            get_calibration,
        )
        from flexflow_tpu_torch.parallel import DistributedTrainingInstance, MachineMesh
        from flexflow_tpu_torch.parallel.executor import overlap_lowering_active
        from flexflow_tpu_torch.runtime.distributed import (
            broadcast_json,
            ranks_share_a_device,
            run_search_on_host_0,
        )
        from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
        from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph
        from flexflow_tpu_torch.runtime.strategy import load_strategy, save_strategy
        from flexflow_tpu_torch.substitutions.rules import generate_parallelization_rules

        cfg = self.config
        unported = (
            (cfg.hbm_gb > 0, "hbm_gb (a compile's memory budget: its capacity detection and "
                           "compile-time verification)", "A6 part 2 / A13"),
            (bool(cfg.cost_store or cfg.movement_cost_store), "cost_store / movement_cost_store",
             "A6 part 2 / A13"),
            (cfg.search_algorithm != "unity", f"search_algorithm={cfg.search_algorithm!r}",
             "A6 part 2"),
            (cfg.machine_model_version > 0 or bool(cfg.machine_model_file), "machine_model_*",
             "A6 part 2"),
            (bool(cfg.substitution_json_path), "substitution_json_path", "A6 part 2"),
            (cfg.perform_fusion, "perform_fusion (the fusion rules)", "A6 part 2"),
            (cfg.branch_stacking, "branch_stacking", "A6 part 2"),
            (bool(cfg.multislice), "multislice", "A6 part 2"),
            (bool(cfg.pipeline), "pipeline", "A10"),
            (cfg.force_strategy_seed.startswith("pp"), "force_strategy_seed of a pipeline",
             "A10"),
        )
        for on, what, slice_name in unported:
            if on:
                raise NotImplementedError(
                    f"FFConfig.{what} in a searched compile is not ported yet ({slice_name})")
        overlap_on = overlap_lowering_active(cfg.overlap)
        if overlap_on and not (cfg.import_strategy_file or cfg.force_strategy_seed):
            # the JAX search prices the fused edges (machine_mapping/overlap.py
            # derive_overlap_plan); searching without them would price otherwise
            raise NotImplementedError(
                "FFConfig.overlap (the collective matmuls) in a search: the search's pricing "
                "of the fused edges is not ported yet (A6 part 2 item 4); train an imported "
                "strategy or a forced seed with it")
        nodes = max(cfg.num_nodes, 1)
        if self.device.type == "cpu":
            # the JAX package's CPU constants, so both packages find one winner
            inter_bw, intra_bw, peak_flops, hbm_gbps = 1.0, 2.0, 5e10, 10.0
            intra_lat_ms, inter_lat_ms = 0.1, 0.2
        else:
            # H100 SXM: datasheet links (compiler/calibration.py) and peaks
            inter_bw, intra_bw = NDR_INFINIBAND_GBPS, H100_NVLINK_GBPS
            peak_flops, hbm_gbps = 989e12, 3350.0
            intra_lat_ms, inter_lat_ms = 0.001, 0.01
        exec_spec = MachineSpecification(nodes, max(cfg.cpus_per_node, 1),
                                         max(ndev // nodes, 1), inter_bw, intra_bw)
        search_nodes = cfg.search_num_nodes if cfg.search_num_nodes > 0 else nodes
        search_workers = (cfg.search_num_workers if cfg.search_num_workers > 0
                          else exec_spec.num_devices_per_node)
        spec = MachineSpecification(search_nodes, max(cfg.cpus_per_node, 1), search_workers,
                                    inter_bw, intra_bw)

        measured = cfg.cost_model == "measured" or (
            cfg.cost_model == "auto" and self.device.type == "cuda")
        # measured and calibrated searches price with the ranks' measured
        # constants: every rank takes part in the calibration (a
        # collective), and in the check whether ranks share a device
        calibration, emulated = None, False
        if not cfg.import_strategy_file and (measured or cfg.cost_model == "calibrated"):
            calibration = get_calibration(self.device, ndev)
            emulated = ranks_share_a_device(self.device)

        def search():
            if cfg.import_strategy_file:
                self.search_provenance = {"search_algorithm": "imported_strategy"}
                return load_strategy(cfg.import_strategy_file)
            if measured:
                from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator

                estimator = GPUCostEstimator(
                    spec, local_cost_estimator=LocalCostEstimator(device=self.device),
                    emulated_mesh=emulated, calibration=calibration)
            else:
                rates = (peak_flops, hbm_gbps)
                if calibration is not None:
                    rates = (calibration.peak_flops, calibration.hbm_gbps)
                estimator = AnalyticGPUCostEstimator(spec, *rates, intra_latency_ms=intra_lat_ms,
                                                     inter_latency_ms=inter_lat_ms,
                                                     emulated_mesh=emulated,
                                                     calibration=calibration)
            ctx = MachineMappingContext(
                estimator, make_default_allowed_machine_views(),
                # the measured compute/collective overlap where a calibration
                # measured one, else the 0.5 heuristic (the JAX package's rule)
                overlap_fraction=(calibration.overlap if calibration is not None
                                  and calibration.overlap is not None else 0.5),
                allow_resource_splits=spec != exec_spec)
            pcg0 = pcg_from_computation_graph(self.cg)
            start = time.perf_counter()
            if cfg.force_strategy_seed:
                result = _forced_seed_result(pcg0, ctx, spec, cfg.force_strategy_seed)
            else:
                degrees = [d for d in range(2, spec.num_devices + 1) if spec.num_devices % d == 0]
                rules = generate_parallelization_rules(
                    degrees, enable_parameter_parallel=cfg.enable_parameter_parallel,
                    enable_attribute_parallel=cfg.enable_attribute_parallel)
                result = graph_optimize(pcg0, ctx, spec, rules, OptimizerConfig(
                    alpha=cfg.search_alpha, budget=cfg.search_budget))
            self.search_provenance = {
                "explored": result.explored,
                "estimated_ms": result.runtime,
                "serial_ms": result.serial_runtime,
                "search_seconds": time.perf_counter() - start,
                "seed_runtimes": dict(result.seed_runtimes or {}),
                "parallel_degrees": parallel_degree_summary(result.pcg),
                "cost_model": cfg.cost_model,
                "search_algorithm": "forced_seed" if cfg.force_strategy_seed else "unity",
            }
            if calibration is not None:
                self.search_provenance.update(calibration=calibration.as_dict(),
                                              emulated_mesh=emulated)
            if overlap_on:
                # a forced seed's estimate leaves the fused edges unpriced
                self.search_provenance["overlap"] = {"enabled": True, "priced": False}
            return result.pcg, result.machine_mapping, result.runtime

        # rank 0 plans; every rank lowers the plan it sends
        pcg, mapping, runtime = run_search_on_host_0(search)
        self.search_provenance = broadcast_json(
            self.search_provenance if dist.get_rank() == 0 else None)
        if cfg.export_strategy_file and dist.get_rank() == 0:
            save_strategy(cfg.export_strategy_file, pcg, mapping, runtime)
        mesh = MachineMesh.from_spec(exec_spec)
        inst = DistributedTrainingInstance(
            pcg, self._find_searched_logit(pcg, logit), self.loss_attrs, self.optimizer_attrs,
            mesh, mapping=mapping, compute_dtype=compute_dtype, device=self.device,
            metrics=self.metrics, overlap=cfg.overlap)
        whole = inst.plan.whole_nodes
        if dist.get_rank() == 0:
            # ops no rule places run on whole values: a state of the plan
            print(f"[flexflow_tpu_torch] the plan runs {len(whole)} node(s) on whole values"
                  + "".join(f"\n  {why}" for why in whole.values()), flush=True)
        return inst

    def _find_searched_logit(self, pcg, logit: DataflowOutput) -> DataflowOutput:
        """The model output in the searched PCG (the JAX package's): layer
        names survive the rewrites, so a named logit producer is found by
        name, followed through its own degree-reducing Combine/Reduction
        chain to the whole value; an unnamed one falls back to the single
        unconsumed output of the logit's shape."""
        from flexflow_tpu_torch.op_attrs.core import is_parallel_op
        from flexflow_tpu_torch.op_attrs.parallel_tensor_shape import total_parallel_degree

        src_name = self.cg.layer_attrs(logit.node).name
        want_sizes = tuple(self.cg.tensor_shape(logit).dims)

        def resolve(node, out_idx):
            outs = pcg.outputs_of(node)
            if out_idx >= len(outs):
                return None
            val = outs[out_idx]
            while True:
                uses = pcg.uses_of(val)
                if len(uses) != 1 or not is_parallel_op(pcg.op_attrs(uses[0].node)):
                    break
                nxt = pcg.outputs_of(uses[0].node)[0]
                if total_parallel_degree(pcg.tensor_shape(nxt)) > total_parallel_degree(
                        pcg.tensor_shape(val)):
                    break
                val = nxt
            shape = pcg.tensor_shape(val)
            if (tuple(shape.sizes()) == want_sizes and all(d == 1 for d in shape.shard_degrees())
                    and shape.sum_degree == 1):
                return val
            return None

        if src_name is not None:
            op_nodes = [n for n in pcg.topological_ordering()
                        if not isinstance(pcg.op_attrs(n), (InputAttrs, WeightAttrs))]
            hits = [n for n in op_nodes if pcg.layer_attrs(n).name == src_name]
            candidates = [(hits[0], logit.idx)] if len(hits) == 1 else []
            for n in op_nodes:
                nm = pcg.layer_attrs(n).name
                if nm and "+" in nm and src_name in nm.split("+"):
                    candidates.append((n, nm.split("+").index(src_name)))
            for node, out_idx in candidates:
                val = resolve(node, out_idx)
                if val is not None:
                    return val
        if self.cg.uses_of(logit):
            raise ValueError(
                "cannot identify the model output after the Unity rewrite: the logit layer "
                f"(name={src_name!r}) could not be resolved by name and the logit tensor has "
                "downstream consumers; give the logit-producing layer a unique name")
        sink = _find_sink_output(pcg)
        if tuple(pcg.tensor_shape(sink).sizes()) != want_sizes:
            raise ValueError(
                "cannot identify the model output after the Unity rewrite: the graph sink has "
                f"shape {pcg.tensor_shape(sink).sizes()} but the logit is {want_sizes}; give "
                "the logit-producing layer a unique name")
        return sink

    def _validate_config_flags(self) -> None:
        """Flags are refused or acknowledged loudly, never silently ignored
        (the JAX package's dead-flag rule). A flag whose machinery is not
        ported yet raises with the slice that brings it."""
        cfg = self.config
        if cfg.health_policy not in HEALTH_POLICIES and cfg.health_policy:
            raise ValueError(f"health_policy {cfg.health_policy!r} not in {HEALTH_POLICIES}")
        if cfg.steps_per_dispatch < 1:
            raise ValueError(f"steps_per_dispatch must be >= 1, got {cfg.steps_per_dispatch}")
        if cfg.max_devices < 0:
            raise ValueError(f"max_devices must be >= 0, got {cfg.max_devices}")
        if cfg.checkpoint_every_n_steps < 0:
            raise ValueError(
                f"checkpoint_every_n_steps must be >= 0, got {cfg.checkpoint_every_n_steps}")
        if cfg.compile_cache_dir:
            raise ValueError(
                "compile_cache_dir configures the JAX package's persistent XLA compilation "
                "cache; the port compiles no XLA program, so unset it")
        if cfg.checkpoint_backend == "orbax":
            from flexflow_tpu_torch.runtime.checkpoint import ORBAX_REFUSED

            raise ValueError(ORBAX_REFUSED)
        if cfg.checkpoint_backend not in ("", "npz"):
            raise ValueError(f"checkpoint_backend {cfg.checkpoint_backend!r} not in ('', 'npz')")
        if cfg.watchdog_factor < 0:
            raise ValueError(f"watchdog_factor must be >= 0, got {cfg.watchdog_factor}")
        unported = (
            (bool(cfg.metrics_dir), "metrics_dir (the step event stream)", "A9"),
            (cfg.health_policy not in ("", "off"), "health_policy (the run-health monitor)",
             "A9"),
            (cfg.plan_audit, "plan_audit", "A9"),
            (bool(cfg.profile_trace_dir), "profile_trace_dir (the fit trace)", "A9"),
            (cfg.drift_monitor, "drift_monitor", "A9"),
            (cfg.submesh_branches, "submesh_branches", "A10"),
        )
        for on, what, slice_name in unported:
            if on:
                raise NotImplementedError(f"FFConfig.{what} is not ported yet ({slice_name})")
        if cfg.perform_fusion:
            print("[flexflow_tpu_torch] perform_fusion: the fusion rules extend the Unity "
                  "search, which a single-device compile does not run")
        if cfg.search_overlap_backward_update:
            print("[flexflow_tpu_torch] search_overlap_backward_update: always on — over "
                  "several ranks each gradient bucket's all-reduce is issued as the backward "
                  "produces it, beside the rest of the backward")
        if cfg.enable_inplace_optimizations:
            print("[flexflow_tpu_torch] enable_inplace_optimizations: always on — the "
                  "optimizer updates parameters and its state in place")

    # ------------------------------------------------------------------
    # training loops
    # ------------------------------------------------------------------

    def _require_compiled(self) -> None:
        if self.instance is None:
            raise RuntimeError("call compile() first")

    def _input_names(self) -> List[str]:
        cg = self.cg
        return [cg.layer_attrs(n).name or param_key(n) for n in cg.topological_ordering()
                if isinstance(cg.op_attrs(n), InputAttrs)]

    def _make_iterator(self, x, y, batch_size, shuffle=False, seed_offset: int = 0,
                       blocks: bool = False) -> BatchIterator:
        """The batches of (x, y); `blocks`: over several ranks, only this
        rank's rows of each (the trainer's feed_blocks)."""
        input_names = self._input_names()
        if isinstance(x, dict):
            inputs = {k: np.asarray(v) for k, v in x.items()}
        elif isinstance(x, (list, tuple)):
            if len(x) != len(input_names):
                raise ValueError(f"model has inputs {input_names}; got {len(x)} arrays")
            inputs = {k: np.asarray(v) for k, v in zip(input_names, x)}
        else:
            if len(input_names) != 1:
                raise ValueError(f"model has inputs {input_names}; pass a dict")
            inputs = {input_names[0]: np.asarray(x)}
        label = None if y is None else np.asarray(y).astype(self._label_dtype)
        rows, label_rows = None, None
        feed = getattr(self.instance, "feed_blocks", None)
        if blocks and feed is not None and batch_size == self.instance.batch_size:
            rows, label_rows = feed()
        return BatchIterator(inputs, label, batch_size, device=self.device, shuffle=shuffle,
                             seed=self.config.seed + seed_offset, blocks=rows,
                             label_block=label_rows)

    def fit(
        self,
        x=None,
        y=None,
        epochs: Optional[int] = None,
        batch_size: Optional[int] = None,
        shuffle: bool = True,
        verbose: bool = True,
        recompile_state=None,
        epoch_offset: int = 0,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every_n_steps: Optional[int] = None,
        resume: bool = False,
    ) -> PerfMetrics:
        """The training loop: one train_step per batch, with the JAX
        package's shuffle, batches and print_freq. The step's metric values
        stay on the device and are summed there; the loop ends in one
        synchronize, then reads them. `epoch_offset` decorrelates the
        shuffle order and the dropout stream across separate fit calls
        that form one run.

        `checkpoint_dir` / `checkpoint_every_n_steps` (else FFConfig's)
        take full-resume snapshots (the state, the generator's state, the
        dataloader's epoch and cursor) at the step or window boundaries
        that cross the interval. `resume=True` restores the latest snapshot
        (falling back past corrupt ones) and continues bitwise: the same
        permutations, the same Dropout stream, the same losses; with no
        checkpoint on disk it cold-starts. Whatever the supervision and the
        checkpointer start is retired when fit returns or raises, a due
        snapshot made durable first."""
        self._require_compiled()
        if recompile_state is not None:
            raise NotImplementedError(
                "fit(recompile_state=...): recompiles are not ported yet (A8 part 2)")
        epochs = epochs or self.config.epochs
        batch_size = batch_size or self.config.batch_size
        it = self._make_iterator(x, y, batch_size, shuffle=shuffle, seed_offset=epoch_offset,
                                 blocks=True)
        if self._rng is None:
            self._rng = torch.Generator(device=self.device)
        rng = self._rng.manual_seed(self.config.seed * 1_000_003 + epoch_offset)
        sup = self._setup_supervision()
        ckpt = None
        try:
            ckpt, start_epoch, skip = self._setup_checkpointing(
                checkpoint_dir, checkpoint_every_n_steps, resume, it, rng, epoch_offset,
                sup.channel)
            return self._fit_epochs(epochs, batch_size, verbose, it, rng, ckpt=ckpt,
                                    start_epoch=start_epoch, skip_batches=skip,
                                    epoch_offset=epoch_offset, sup=sup)
        finally:
            # the watchdog first: its deadline must not fire into the drain
            sup.close()
            if ckpt is not None:
                ckpt.finalize()

    def _setup_supervision(self):
        """One fit call's supervision (runtime/supervisor.py): the fault
        channel the background threads report into, the window watchdog
        (only where a factor is configured: FFConfig.watchdog_factor, else
        FF_TPU_WATCHDOG) and the active fault schedule. A schedule naming
        `nonfinite` or `slow` raises (A9)."""
        from flexflow_tpu_torch.runtime.fault import active_schedule, refuse_unported_fit_sites
        from flexflow_tpu_torch.runtime.supervisor import (
            FaultChannel,
            FitSupervision,
            WindowWatchdog,
        )

        schedule = active_schedule()
        refuse_unported_fit_sites(schedule)
        factor = float(self.config.watchdog_factor or 0.0)
        if factor <= 0:
            env = os.environ.get("FF_TPU_WATCHDOG", "")
            factor = float(env) if env else 0.0
        return FitSupervision(channel=FaultChannel(),
                              watchdog=WindowWatchdog(factor) if factor > 0 else None,
                              schedule=schedule)

    def _setup_checkpointing(self, checkpoint_dir, every, resume, it, rng, epoch_offset,
                             channel):
        """The fit call's TrainingCheckpointer (None when checkpointing is
        off, `self.checkpointer` otherwise) and, under resume, the latest
        snapshot restored: the state into this model's tensors, the step,
        the generator, and the dataloader's position (permutations burnt,
        a one-shot skip). A corrupt latest snapshot falls back to the
        newest that verifies, recorded in
        search_provenance["recovery"]["checkpoint_fallback"]. Returns
        (ckpt, start_epoch, skip_batches)."""
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointError, TrainingCheckpointer

        cfg = self.config
        cdir = checkpoint_dir if checkpoint_dir is not None else cfg.checkpoint_dir
        every = every if every is not None else cfg.checkpoint_every_n_steps
        if not cdir:
            if resume:
                raise ValueError("fit(resume=True) needs checkpoint_dir= (or "
                                 "config.checkpoint_dir)")
            return None, 0, 0
        ckpt = self.checkpointer = TrainingCheckpointer(
            cdir, every_n_steps=every, max_to_keep=cfg.checkpoint_max_to_keep,
            sync=cfg.checkpoint_sync, backend=cfg.checkpoint_backend or None,
            fault_channel=channel, writes=self._rank() == 0)
        if not resume:
            return ckpt, 0, 0
        try:
            template = self._restore_template()
            rs = self._restore_on_ranks(lambda s: ckpt.resume_state(template, step=s),
                                        lambda r: r.step)
            if rs is None:
                return ckpt, 0, 0
            where = dict(directory=ckpt.manager.directory, step=rs.step)
            if rs.epoch_offset != epoch_offset:
                # this call's iterator and generator were seeded with its own
                # epoch_offset: resuming under another would draw from the
                # wrong streams, never bitwise
                raise CheckpointError(
                    f"snapshot was taken under epoch_offset={rs.epoch_offset} but "
                    f"fit(resume=True) was called with epoch_offset={epoch_offset}; pass "
                    "the original epoch_offset to resume bitwise", **where)
            if rs.rng_device != rng.device.type:
                raise CheckpointError(
                    f"snapshot holds a {rs.rng_device} generator's state and this model "
                    f"draws on {rng.device.type}: the Dropout stream cannot continue", **where)
            self._assign_state(rs.params, rs.opt_state)
            self._step_count = rs.step
            rng.set_state(rs.rng)
            it.advance_epochs(rs.epoch)
            it.set_resume_skip(rs.batch_in_epoch)
            self._record_restore_fallback(rs.restore_report)
            return ckpt, rs.epoch, rs.batch_in_epoch
        except BaseException:
            # fit's finally has not seen this checkpointer: retire its writer
            ckpt.finalize()
            raise

    def _record_restore_fallback(self, report) -> None:
        """A resume that quarantined corrupt steps and fell back records it
        in search_provenance["recovery"]["checkpoint_fallback"] (its event
        in the metrics stream comes with A9)."""
        if not report or not report.get("quarantined"):
            return
        if self.search_provenance is None:
            self.search_provenance = {}
        self.search_provenance.setdefault("recovery", {})["checkpoint_fallback"] = report

    def _effective_steps_per_dispatch(self) -> int:
        """The fused window length this fit runs. FF_TPU_FUSED_BASELINE=1
        reverts to the per-step loop, and says so."""
        k = int(self.config.steps_per_dispatch)
        if k <= 1:
            return 1
        if os.environ.get("FF_TPU_FUSED_BASELINE") == "1":
            print("[flexflow_tpu_torch] FF_TPU_FUSED_BASELINE=1: steps_per_dispatch "
                  f"{k} reverted to the per-step loop")
            return 1
        return k

    def _fit_epochs(self, epochs, batch_size, verbose, it, rng, ckpt=None, start_epoch=0,
                    skip_batches=0, epoch_offset=0, sup=None) -> PerfMetrics:
        """The per-step loop, or with steps_per_dispatch = K > 1 the windowed
        one: each window of K batches (the epoch's tail a smaller one)
        trains through one multi_train_step, its input gathered and copied
        while the window before it runs. Each step or window runs inside
        the watchdog's deadline with the `hang` site; at its boundary come
        the checkpoint hook, then the `kill` site, the fault channel and
        FF_TPU_FAULT_STEP, so a due snapshot is durable before a fault
        propagates."""
        from flexflow_tpu_torch.runtime.fault import (
            inject_hang_fault,
            inject_kill_fault,
            maybe_inject_fault,
        )

        watchdog = sup.watchdog if sup is not None else None
        schedule = sup.schedule if sup is not None else None
        start = time.perf_counter()
        num_samples = 0
        loss = None
        macc: Optional[Dict[str, object]] = None
        pf = self.config.print_freq if verbose else 0
        k = self._effective_steps_per_dispatch()
        windows = (WindowedBatchIterator(it, k, fault_channel=sup.channel if sup else None)
                   if k > 1 else None)
        try:
            for epoch in range(start_epoch, epochs):
                batch_in_epoch = skip_batches if epoch == start_epoch else 0
                if windows is not None:
                    windows.step_base = self._step_count
                    units = windows
                else:
                    units = ((batch, label, 1) for batch, label in it)
                for inputs, label, kk in units:
                    prev = self._step_count
                    if watchdog is not None:
                        watchdog.begin_window(prev + 1, kk)
                    try:
                        if windows is not None:
                            loss, macc = self._run_fused_window(inputs, label, kk, rng, macc, pf,
                                                                epoch)
                        else:
                            loss, macc = self._run_step(inputs, label, rng, macc, pf, epoch)
                        # a hung dispatch never reaches the boundary
                        inject_hang_fault(schedule, prev, self._step_count, watchdog=watchdog)
                    finally:
                        # disarmed before the boundary's work: a slow but
                        # healthy checkpoint submit is no hang
                        if watchdog is not None:
                            watchdog.end_window(self._step_count)
                    batch_in_epoch += kk
                    num_samples += batch_size * kk
                    if ckpt is not None and ckpt.due(prev, self._step_count):
                        ckpt.snapshot(self._step_count, self._checkpoint_state(), rng, epoch,
                                      batch_in_epoch, epoch_offset)
                    if sup is not None:
                        inject_kill_fault(schedule, prev, self._step_count)
                        sup.channel.raise_pending()
                    maybe_inject_fault(prev, self._step_count)
        finally:
            if windows is not None:
                windows.close()
        if loss is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        elapsed = time.perf_counter() - start
        perf = _perf_from_metric_values(macc) if macc is not None else PerfMetrics()
        if verbose:
            print(f"ELAPSED TIME = {elapsed:.4f}s, "
                  f"THROUGHPUT = {num_samples / max(elapsed, 1e-9):.2f} samples/s")
        return perf

    def _run_step(self, batch, label, rng, macc, pf, epoch):
        """One train_step and its metric fold and print. Returns (its loss,
        macc)."""
        self.params, self.opt_state, loss, mvals = self.instance.train_step(
            self.params, self.opt_state, batch, label, rng)
        self._step_count += 1
        macc = mvals if macc is None else {key: macc[key] + v for key, v in mvals.items()}
        if pf and self._step_count % pf == 0:
            print(f"epoch {epoch} step {self._step_count}: loss {float(loss):.4f}")
        return loss, macc

    def _run_fused_window(self, inputs_stack, label_stack, kk, rng, macc, pf, epoch):
        """One window: its dispatch, the metric fold (one add a window), and
        the print_freq lines from the window's loss vector, read back once
        and only when a print falls in the window. Returns (the window's
        last loss, macc)."""
        self.params, self.opt_state, rng, losses, mvals = self.instance.multi_train_step(
            self.params, self.opt_state, inputs_stack, label_stack, rng)
        base_step = self._step_count
        self._step_count += kk
        macc = mvals if macc is None else {key: macc[key] + v for key, v in mvals.items()}
        if pf and base_step // pf != (base_step + kk) // pf:
            host = losses.tolist()
            for i in range(kk):
                if (base_step + i + 1) % pf == 0:
                    print(f"epoch {epoch} step {base_step + i + 1}: loss {host[i]:.4f}")
        return losses[kk - 1], macc

    def invalidate_graphs(self) -> None:
        """Drop the fused windows' CUDA graphs: they bake in the optimizer's
        hyperparameters and the addresses of the parameter and state
        tensors, so whatever changes either calls this."""
        if self.instance is not None:
            self.instance.graphs.invalidate()

    def set_learning_rate(self, lr: float) -> None:
        """Update the optimizer's learning rate mid-training; the next step
        uses it (the captured windows are dropped: they bake it in)."""
        attrs = self.optimizer_attrs
        if attrs is None:
            raise RuntimeError("compile the model before setting the lr")
        field = "lr" if hasattr(attrs, "lr") else "alpha"
        self.optimizer_attrs = dataclasses.replace(attrs, **{field: lr})
        if self.instance is not None:
            self.instance.optimizer_attrs = self.optimizer_attrs
        self.invalidate_graphs()

    def eval(self, x=None, y=None, batch_size: Optional[int] = None) -> PerfMetrics:
        """Forward-only metric evaluation."""
        self._require_compiled()
        batch_size = batch_size or self.config.batch_size
        it = self._make_iterator(x, y, batch_size, shuffle=False)
        metrics = self.metrics or frozenset({"accuracy"})
        perf = PerfMetrics()
        for batch, label in it:
            logit = self.instance.forward(self.params, batch)
            if self._searched():
                from flexflow_tpu_torch.parallel import gather_block

                inst = self.instance
                logit = gather_block(logit, inst.shardings[inst.logit_tensor], inst.machine_mesh)
            perf.update(_perf_from_metric_values(compute_metrics(metrics, logit, label)))
        return perf

    # ------------------------------------------------------------------
    # stepped execution (reference forward/backward/update/zero_gradients)
    # ------------------------------------------------------------------

    def _searched(self) -> bool:
        """Whether the compile lowered a searched plan over several ranks
        (each holding pieces of the parameters)."""
        from flexflow_tpu_torch.parallel import DistributedTrainingInstance

        return isinstance(self.instance, DistributedTrainingInstance)

    def _ensure_backing(self) -> LocalTrainingBacking:
        if self._searched():
            raise NotImplementedError(
                "the stepped forward/backward/update runs the whole graph on one device; a "
                "searched plan's ranks hold pieces of it (A7 item 4)")
        if self._backing is None:
            self._backing = LocalTrainingBacking(
                self.cg, profiling=self.config.profiling,
                compute_dtype=getattr(self.instance, "compute_dtype", None), device=self.device,
            )
            if self.params is not None:
                self._backing.params = dict(self.params)
            else:
                self._backing.execute_init(self.config.seed)
                self.params = self._backing.params
                self.invalidate_graphs()
        return self._backing

    def init_operators(self) -> None:
        self._ensure_backing()

    def forward(self, inputs: Optional[Dict[str, np.ndarray]] = None) -> np.ndarray:
        """Run the graph one op at a time on `inputs` (keyed by input name);
        returns the model output."""
        b = self._ensure_backing()
        if inputs is None:
            raise ValueError("stepped forward needs an inputs dict")
        b.execute_forward(dict(inputs))
        return _to_numpy(b.env[_find_sink_output(self.cg)])

    def zero_gradients(self) -> None:
        b = self._ensure_backing()
        b.grad_env = {}
        b.param_grads = {}

    def backward(self, label: Optional[np.ndarray] = None) -> None:
        """The loss gradient of the last forward's output (by autograd, as
        the JAX package takes it by jax.grad), then each op's backward in
        reverse topological order; weight gradients accumulate."""
        b = self._ensure_backing()
        if label is None:
            raise ValueError("stepped backward needs the label batch")
        sink = _find_sink_output(self.cg)
        logit = b.env[sink].detach().requires_grad_(True)
        lbl = torch.as_tensor(np.asarray(label).astype(self._label_dtype), device=self.device)
        (grad,) = torch.autograd.grad(loss_forward(self.loss_attrs, logit, lbl), logit)
        b.execute_backward({sink: grad})

    def update(self) -> None:
        b = self._ensure_backing()
        if self.optimizer_attrs is None:
            raise RuntimeError("call compile() first")
        self.opt_state = b.execute_update(self.optimizer_attrs, self.opt_state)
        self.params = b.params
        self.invalidate_graphs()

    # ------------------------------------------------------------------
    # checkpoint / resume
    # ------------------------------------------------------------------

    def _rank(self) -> int:
        return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0

    def _grouped(self) -> bool:
        """Whether the compile spans several ranks (one process each)."""
        return isinstance(self.instance, DataParallelTrainingInstance) or self._searched()

    def _state_template(self) -> dict:
        """The tree of this model's state tensors (a searched plan's leaves
        are this rank's pieces, keyed by the plan's PCG)."""
        if self.params is None:
            raise RuntimeError("compile() before checkpointing")
        template = {"params": self.params}
        if self.opt_state is not None:
            template["opt_state"] = self.opt_state
        return template

    def _restore_template(self) -> Optional[dict]:
        """What a restore checks a checkpoint's key paths and dtypes
        against: the model's tree; None for a searched plan, whose
        checkpoints come keyed either way (_assign_state checks them)."""
        return None if self._searched() else self._state_template()

    def _plan_to_model_keys(self) -> Optional[Dict[str, str]]:
        """A searched plan's weight keys -> the model graph's, matched by
        layer name (the rewrites keep names); None where a weight has no
        unique counterpart."""
        from flexflow_tpu_torch.local_execution.training_backing import weight_nodes

        pcg = self.instance.pcg
        by_name: Dict[str, List[str]] = {}
        for n in weight_nodes(pcg):
            by_name.setdefault(pcg.layer_attrs(n).name, []).append(param_key(n))
        out = {}
        for n in weight_nodes(self.cg):
            name = self.cg.layer_attrs(n).name
            hits = by_name.get(name, [])
            if name is None or len(hits) != 1:
                return None
            out[hits[0]] = param_key(n)
        return out if len(out) == len(self.params) else None

    def _checkpoint_state(self) -> dict:
        """{"params", "opt_state"} to checkpoint: the tensors themselves on
        one device or a data-parallel rank (the state is replicated); a
        searched plan's global values as numpy, gathered over the ranks (a
        collective: every rank calls it) and keyed by the model graph's
        weights, so that a single-device FFModel of either package restores
        them (by the plan's own keys, as the JAX package keys a searched
        model's, where a weight has no unique name)."""
        if not self._searched():
            return self._state_template()
        from flexflow_tpu_torch.interop import pcg_opt_state_to_numpy, pcg_params_to_numpy

        inst = self.instance
        args = (inst.pcg, inst.shardings, inst.machine_mesh)
        state = {"params": pcg_params_to_numpy(*args, self.params)}
        if self.opt_state is not None:
            state["opt_state"] = pcg_opt_state_to_numpy(*args, self.opt_state)
        keys = self._plan_to_model_keys()
        return state if keys is None else _rekey(state, keys)

    def _assign_state(self, params: dict, opt_state: Optional[dict]) -> None:
        """Copy restored global values (numpy trees, as the checkpoint
        holds them) into this model's tensors in place, a searched plan's
        rank taking its pieces (from a checkpoint keyed by the model graph
        or by the plan): the stepped backing, the optimizer state and the
        captured windows keep referring to the same tensors."""
        from flexflow_tpu_torch.runtime.checkpoint import _flatten

        if self._searched():
            from flexflow_tpu_torch.interop import pcg_opt_state_from_numpy, pcg_params_from_numpy

            keys = self._plan_to_model_keys()
            state = {"params": params, "opt_state": opt_state}
            if keys is not None and set(params) == set(keys.values()):
                state = _rekey(state, {model: plan for plan, model in keys.items()})
            inst = self.instance
            args = (inst.pcg, inst.shardings, inst.machine_mesh)
            params = pcg_params_from_numpy(*args, state["params"], "cpu")
            if opt_state is not None:
                opt_state = pcg_opt_state_from_numpy(*args, state["opt_state"], "cpu")
        src = _flatten({"params": params, **({} if opt_state is None else
                                             {"opt_state": opt_state})})
        dst = _flatten(self._state_template())
        if set(src) != set(dst):
            raise ValueError(f"restored state keys differ from the model's: missing "
                             f"{sorted(set(dst) - set(src))[:8]}, extra "
                             f"{sorted(set(src) - set(dst))[:8]}")
        with torch.no_grad():
            for key, t in dst.items():
                value = torch.as_tensor(src[key])
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"{key}: checkpoint shape {tuple(value.shape)}, the "
                                     f"model's {tuple(t.shape)}")
                t.copy_(value)

    def _restore_on_ranks(self, restore, step_of):
        """restore(step) -> the restored object (None for nothing to
        restore). Alone: restore(None). Over several ranks, after a barrier
        (the writer's last commit is durable): rank 0 picks the step,
        falling back past corrupt ones, and the others read that step."""
        if not self._grouped():
            return restore(None)
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointError
        from flexflow_tpu_torch.runtime.distributed import broadcast_json

        dist.barrier()
        if dist.get_rank() == 0:
            try:
                got = restore(None)
            except BaseException as e:
                broadcast_json({"error": f"{type(e).__name__}: {e}"})
                raise
            broadcast_json({"step": None if got is None else step_of(got)})
            return got
        doc = broadcast_json(None)
        if "error" in doc:
            raise CheckpointError(f"rank 0's restore failed: {doc['error']}")
        return None if doc["step"] is None else restore(doc["step"])

    def save_checkpoint(self, directory: str, max_to_keep: int = 3) -> str:
        """Params, optimizer state and step, written now in `directory`'s
        npz layout (the JAX package's load_checkpoint reads it), with
        extra {"seed": config.seed}. Over several ranks every rank calls it
        (a searched plan's state is gathered, a collective) and rank 0
        writes. Returns the step's directory."""
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

        state = self._checkpoint_state()
        mgr = CheckpointManager(directory, max_to_keep=max_to_keep,
                                backend=self.config.checkpoint_backend or None)
        if self._rank() != 0:
            return mgr._step_dir(self._step_count)
        return mgr.save(self._step_count, state["params"], state.get("opt_state"),
                        extra={"seed": self.config.seed})

    def load_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        """Params, optimizer state and step from `directory` (its latest
        verified step, or `step`), copied into this model's tensors in
        place; a checkpoint of the JAX package's npz layout restores too.
        Over several ranks every rank calls it and takes its pieces.
        Returns the step restored."""
        from flexflow_tpu_torch.runtime.checkpoint import CheckpointManager

        template = self._restore_template()
        mgr = CheckpointManager(directory)
        s, params, opt_state, _ = self._restore_on_ranks(
            lambda at: mgr.restore(step if at is None else at, template=template),
            lambda r: r[0])
        self._assign_state(params, opt_state)
        self._step_count = s
        return s

    def recompile(self, preserve_resume: bool = False) -> None:
        raise NotImplementedError("FFModel.recompile: recompiles are not ported yet (A8 part 2)")

def _forced_seed_result(pcg0, ctx, spec, seed_name: str):
    """The named strategy template, priced as is (FFConfig.
    force_strategy_seed): "serial" or a label of enumerate_seeds."""
    from flexflow_tpu_torch.compiler import MachineMappingCache, evaluate_pcg
    from flexflow_tpu_torch.compiler.unity_algorithm import enumerate_seeds

    cache = MachineMappingCache()
    serial = evaluate_pcg(pcg0, ctx, spec, cache)
    if seed_name == "serial":
        if serial is None:
            raise ValueError("serial plan is unmappable")
        serial.serial_runtime = serial.runtime
        serial.seed_runtimes = {}
        return serial
    for label, seed_pcg in enumerate_seeds(pcg0, spec.num_devices):
        if label != seed_name:
            continue
        result = evaluate_pcg(seed_pcg, ctx, spec, cache)
        if result is None:
            raise ValueError(f"seed {seed_name} is unmappable")
        result.serial_runtime = serial.runtime if serial else float("nan")
        result.seed_runtimes = {label: result.runtime}
        return result
    raise ValueError(f"unknown strategy seed {seed_name!r}")


def _rekey(state: dict, keys: Dict[str, str]) -> dict:
    """{"params", "opt_state"} with each parameter key (and each optimizer
    slot's) renamed through `keys`."""
    out = {"params": {keys[k]: v for k, v in state["params"].items()}}
    if state.get("opt_state") is not None:
        out["opt_state"] = {slot: ({keys[k]: t for k, t in v.items()} if isinstance(v, dict)
                                   else v) for slot, v in state["opt_state"].items()}
    return out


def _find_sink_output(graph) -> DataflowOutput:
    """The model output: the unique dataflow output nobody consumes (the
    Experts op's aux-loss outputs, which the JAX package excludes, are not
    ported)."""
    consumed = set()
    for n in graph.topological_ordering():
        consumed.update(graph.inputs_of(n))
    sinks = [
        o
        for n in graph.topological_ordering()
        for o in graph.outputs_of(n)
        if o not in consumed and not isinstance(graph.op_attrs(n), (InputAttrs, WeightAttrs))
    ]
    if len(sinks) != 1:
        raise ValueError(f"expected one model output, found {len(sinks)}")
    return sinks[0]


def _perf_from_metric_values(mvals: Dict[str, object]) -> PerfMetrics:
    """PerfMetrics from metric values (tensors are read on the host)."""
    p = PerfMetrics()
    for k, v in mvals.items():
        if hasattr(p, k):
            cur = getattr(p, k)
            setattr(p, k, type(cur)(cur + (int(v) if isinstance(cur, int) else float(v))))
    return p
