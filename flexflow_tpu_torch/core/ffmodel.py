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

Observability (observability/): FFConfig.metrics_dir
appends one event a step to `<metrics_dir>/events.jsonl` (loss, wall-clock,
tokens/s and the step statistics: gradient and parameter global norms and
the update ratio, computed on the card inside the step, a fused window's
stacks read back once a window); FFConfig.health_policy (warn, skip_step,
raise) reacts to a non-finite step, the update guarded on the card under
skip_step and raise, the first bad op named by an op-by-op replay;
FFConfig.profile_trace_dir writes the fit's span trace
(`flexflow_trace.json`) beside a torch.profiler device trace;
FFConfig.plan_audit audits a searched plan at compile
(search_provenance["plan_audit"]); FFConfig.drift_monitor tails the event
stream for plan-fidelity drift. Over several ranks rank 0 writes the
stream and runs the drift monitor; every rank applies the health policy
(the norms are global, so every rank sees the same flag).

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

A searched compile takes the whole of the JAX package's search options:
the persistent cost and movement stores (FFConfig.cost_store,
movement_cost_store), the MCMC search, the machine models
(machine_model_version / machine_model_file), the two-level search over
nodes (multislice), the fusion and legacy rules (perform_fusion,
substitution_json_path), branch stacking, and the pricing of the fused
collective matmuls (overlap).

A searched compile verifies its winner (analysis/pcg_verify.py, and the
MEM rules at FFConfig.hbm_gb, which also bounds the search, or else at the
card's capacity) into search_provenance["verify"] and ["memory"], and
records one step of the compiled plan (analysis/step_program.py) for its
execution contract (["exec"]), its collective census against the priced
movement edges (["comm"]) and its measured peak memory. fit writes the
contract beside its checkpoints (exec_contract.json) and checks it on
resume (DET002). recompile() and fit(recompile_state=...) verify the plan
transition (TRN001-TRN004) before the state carries over
(runtime/recompile.py).

Pipelines: FFConfig.pipeline seeds a searched
compile with stage-partitioned candidates and adds the stage rules; a
stage-partitioned winner (or a forced `pp{S}m{M}[xdp{D}]` seed) trains
through the 1F1B executor over a (stage x data) mesh of the ranks
(parallel/pipeline.py), or, where its structure cannot run there, through
the flat executor, with the reason printed and recorded in
search_provenance["pipeline"]. Sub-mesh branches: FFConfig.submesh_branches
over several ranks trains a Split-forked graph with each branch on its own
group of ranks (parallel/submesh.py).
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
    ExpertsAttrs,
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


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host copy (bf16 widened to f32), never a view of the tensor."""
    t = t.detach()
    return np.array((t.float() if t.dtype == torch.bfloat16 else t).cpu().numpy())


class FFModel:
    """Computation-graph builder + trainer on one device.

    On a card, a searched compile, and a checkpointing fit on the
    data-parallel or single-device backend (its first contract record
    after each compile), each run one recorded step
    (analysis/step_program.py), which resets the CUDA peak-memory
    statistics (`torch.cuda.reset_peak_memory_stats`) to measure the step's
    peak: a caller's own peak reading across those calls starts again."""

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
        if isinstance(cg, ComputationGraphBuilder):
            # with the aux-loss outputs the builder recorded (moe's)
            m._builder.graph = cg.graph
            m._aux_loss_tensors.extend(cg.aux_loss_tensors)
        else:
            m._builder.graph = cg
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

    def transpose(self, input, perm, name=None) -> Tensor:
        return self._wrap(self._builder.transpose(self._unwrap(input), perm, name=name))

    def reverse(self, input, axis, name=None) -> Tensor:
        return self._wrap(self._builder.reverse(self._unwrap(input), axis, name=name))

    def gather(self, input, index, dim, name=None) -> Tensor:
        return self._wrap(self._builder.gather(self._unwrap(input), self._unwrap(index), dim,
                                               name=name))

    def top_k(self, input, k, sorted=True, name=None) -> Tuple[Tensor, Tensor]:
        v, i = self._builder.top_k(self._unwrap(input), k, sorted=sorted, name=name)
        return self._wrap(v), self._wrap(i)

    def cast(self, input, dtype, name=None) -> Tensor:
        return self._wrap(self._builder.cast(self._unwrap(input), dtype, name=name))

    def broadcast(self, input, target_dims, name=None) -> Tensor:
        return self._wrap(self._builder.broadcast(self._unwrap(input), target_dims, name=name))

    def batch_matmul(self, a, b, name=None) -> Tensor:
        return self._wrap(self._builder.batch_matmul(self._unwrap(a), self._unwrap(b), name=name))

    def reduce_sum(self, input, axes, keepdims=False, name=None) -> Tensor:
        return self._wrap(self._builder.reduce_sum(self._unwrap(input), axes, keepdims=keepdims,
                                                   name=name))

    def mean(self, input, dims, keepdims=False, name=None) -> Tensor:
        return self._wrap(self._builder.reduce_mean(self._unwrap(input), dims, keepdims=keepdims,
                                                    name=name))

    # mixture of experts
    def group_by(self, data, assign, n_experts, alpha=1.0, name=None) -> List[Tensor]:
        outs = self._builder.group_by(self._unwrap(data), self._unwrap(assign), n_experts,
                                      alpha, name=name)
        return [self._wrap(o) for o in outs]

    def aggregate(self, gate_preds, gate_assign, exp_preds, name=None) -> Tensor:
        return self._wrap(self._builder.aggregate(
            self._unwrap(gate_preds), self._unwrap(gate_assign),
            [self._unwrap(t) for t in exp_preds], name=name))

    def moe(self, input, num_exp: int, num_select: int, hidden_size: int, alpha: float = 2.0,
            lambda_bal: float = 0.0, name=None) -> Tensor:
        """The legacy FFModel::moe (examples/cpp/mixture_of_experts/moe.cc:
        ff.moe(input, num_exp, num_select, hidden_size, alpha, lambda))."""
        outs = self._builder.experts(self._unwrap(input), num_exp, num_select, hidden_size,
                                     capacity_factor=alpha, lambda_bal=lambda_bal, name=name)
        if len(outs) > 1:  # the load-balance aux loss joins the training loss
            self._aux_loss_tensors.append(outs[1])
        return self._wrap(outs[0])

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

    def _plan_weight_node(self, n: Node) -> Node:
        """The PCG weight node of CG weight node n in a pipelined plan,
        found by its layer name, which the rewrites keep."""
        inst = self.instance
        name = self.cg.layer_attrs(n).name
        hits = [w for w in inst.pcg.topological_ordering()
                if isinstance(inst.pcg.op_attrs(w), WeightAttrs)
                and inst.pcg.layer_attrs(w).name == name]
        if name is None or len(hits) != 1:
            raise KeyError(f"weight {name!r} has no unique counterpart in the plan")
        return hits[0]

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
        if n is not None and self.params is not None and self._pipelined():
            # a collective: the stages' parameters gathered, found by name
            inst = self.instance
            full = inst.pcg_params(inst.stacked_state(self.params)["params"])
            return full[param_key(self._plan_weight_node(n))]
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
        if self._pipelined():
            # the stage holding the weight writes its tensor
            inst = self.instance
            node = self._plan_weight_node(n)
            key = next((k for k, w in inst.stage_weights.items() if w == node), None)
            if key is not None:
                with torch.no_grad():
                    self.params[key].copy_(torch.as_tensor(value))
            return
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
        # remembered for recompile(): the arguments, and the batch this
        # program is compiled for (the graph keeps its build-time batch, so
        # the config is the only witness a transition's TRN003 leg reads)
        self._compiled_batch_size = int(cfg.batch_size)
        self._compiled_window = max(int(cfg.steps_per_dispatch), 1)
        self.inactive = False
        self._compile_args = dict(optimizer=optimizer, loss_type=loss_type, metrics=metrics,
                                  comp_mode=comp_mode, logit_tensor=logit_tensor,
                                  compute_dtype=compute_dtype)
        # set by a searched compile: the drift monitor's transition verifier
        self._drift_transition = None
        # the contract record of a backend the compile does not record a
        # step for (made when checkpointing first asks), and the latest
        # resume-time DET002 check
        self._exec_fp_record = None
        self.exec_resume_check = None
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
        # the Experts ops' aux losses are found again structurally in the
        # searched plan (_find_aux_outputs); aux tensors given by hand have no
        # identity across the lift to a PCG and the rewrites, so such graphs
        # keep the data-parallel backend rather than train another objective
        structural_aux = set(_find_aux_outputs(self.cg))
        custom_aux = [t for t in self._aux_loss_tensors if t not in structural_aux]
        self.invalidate_graphs()
        self.search_provenance = None
        collect, guard = self._step_stats_flags()
        if ndev > 1 and cfg.submesh_branches:
            # each branch island of a Split fork on its own group of ranks,
            # rows moved explicitly at the fork and the join
            from flexflow_tpu_torch.parallel.submesh import (
                SubmeshBranchInstance,
                find_branch_partition,
            )

            if structural_aux or custom_aux:
                raise ValueError(
                    "submesh_branches cannot train models with auxiliary loss tensors (the "
                    "sub-mesh step computes the primary loss only; dropping aux terms would "
                    "change the objective)")
            part = find_branch_partition(self.cg)
            if part is None:
                raise ValueError(
                    "submesh_branches=True but the graph has no Split-fork branch partition")
            self.instance = SubmeshBranchInstance(
                self.cg, logit, self.loss_attrs, self.optimizer_attrs, partition=part,
                device=self.device, metrics=self.metrics)
            # the machine-mapping DP's disjoint-resource pricing is legal at
            # run time for this shape: price the graph with resource splits
            # and record it
            try:
                self.search_provenance = self._price_resource_splits(ndev)
            except Exception:
                self.search_provenance = None
        elif (ndev > 1 and cfg.search_budget > 0 and not cfg.only_data_parallel
              and not custom_aux):
            self.instance = self._compile_searched(logit, ndev, compute_dtype)
        elif ndev > 1:
            self.instance = DataParallelTrainingInstance(
                self.cg, logit, self.loss_attrs, self.optimizer_attrs,
                compute_dtype=compute_dtype, device=self.device, metrics=self.metrics,
                aux_loss_tensors=self._aux_loss_tensors,
                collect_step_stats=collect, guard_nonfinite_updates=guard,
            )
        else:
            self.instance = ModelTrainingInstance(
                self.cg, logit, self.loss_attrs, self.optimizer_attrs,
                compute_dtype=compute_dtype, device=self.device, metrics=self.metrics,
                aux_loss_tensors=self._aux_loss_tensors,
                collect_step_stats=collect, guard_nonfinite_updates=guard,
            )
        # fused windows under `raise` freeze after the first tripped step, so
        # the post-window state is the pre-trip state the per-step loop
        # would have stopped with (fused_multi_step)
        self.instance.halt_on_nonfinite = cfg.health_policy == "raise"
        if cfg.plan_audit and not (isinstance(self.search_provenance, dict)
                                   and "plan_audit" in self.search_provenance):
            # the audit replays a SEARCHED plan: say so where none ran
            print("[flexflow_tpu_torch] plan_audit: this compile ran no Unity search (backend: "
                  f"{type(self.instance).__name__}) — no plan audit recorded")
        self.params, self.opt_state = self.instance.initialize(seed=cfg.seed)
        self._step_count = 0
        self._backing = None
        self._compile_checks()

    def _compile_checks(self) -> None:
        """The checks of a searched winner that read one recorded step
        (analysis/step_program.py, the JAX package's one shared lowering):
        the execution contract, always (search_provenance["exec"]); the
        step's measured peak beside the predicted ones (["memory"]); its
        collective census against the priced movement edges (["comm"], and
        beside the plan audit). A check that fails records its error on
        its record and the compile goes on; but over ranks a recording that
        fails raises: the step's collectives are the group's, and a rank
        that left them part way cannot rejoin the others, so it ends its
        compile (and the others' collectives end at the group's timeout, or
        at once where its process exits). FF_TPU_NO_EXEC_CONTRACT=1 skips
        the recording, and says so on each record."""
        from flexflow_tpu_torch.analysis.memory_analysis import measured_memory_cross_check

        prov = self.search_provenance if isinstance(self.search_provenance, dict) else None
        if prov is None or not (self._searched() or self._pipelined()):
            return
        if os.environ.get("FF_TPU_NO_EXEC_CONTRACT") == "1":
            prov["exec"] = {"skipped": "FF_TPU_NO_EXEC_CONTRACT=1"}
            if isinstance(prov.get("comm"), dict):
                prov["comm"].setdefault("skipped", "FF_TPU_NO_EXEC_CONTRACT=1: no recorded step")
            return
        try:
            prog = self._record_step_program()
        except Exception as e:  # a failed recording must not kill the compile
            if self._grouped():
                raise
            msg = f"recording failed: {type(e).__name__}: {e}"[:200]
            prov["exec"] = {"error": msg}
            if isinstance(prov.get("comm"), dict):
                prov["comm"]["error"] = msg
            return
        try:
            self._exec_contract_check(prog)
        except Exception as e:
            prov["exec"] = {"error": f"{type(e).__name__}: {e}"[:200]}
        if isinstance(prov.get("memory"), dict):
            try:
                prov["memory"].update(measured_memory_cross_check(prog, prov["memory"]))
            except Exception as e:
                prov["memory"]["measured_error"] = f"{type(e).__name__}: {e}"[:200]
        if isinstance(prov.get("comm"), dict):
            self._comm_cross_check(prog)

    def _record_step_program(self):
        """One recorded step of the compiled instance, on a copy of its state."""
        from flexflow_tpu_torch.analysis.step_program import record_step

        return record_step(self.instance, self.params, self.opt_state, self.loss_attrs,
                           label_dtype=self._label_dtype,
                           steps_per_dispatch=self.config.steps_per_dispatch,
                           batch_size=self._step_batch())

    def _exec_contract_check(self, prog) -> None:
        """search_provenance["exec"]: the determinism census and the in-place
        audit of the recorded step, with its fingerprints (what DET002
        checks again on fit(resume=True) and recompile())."""
        from flexflow_tpu_torch.analysis.diagnostics import summarize
        from flexflow_tpu_torch.analysis.exec_contract import (
            analyze_step_program,
            exec_diagnostics,
            exec_summary_json,
        )

        analysis = analyze_step_program(prog)
        record = exec_summary_json(analysis)
        record.pop("exec", None)  # the CLI schema key, not provenance
        record["torch_version"] = torch.__version__
        record["kernel_launches"] = prog.kernel_route()
        record["recorded_ops"] = len(prog.lines)
        record["verify"] = summarize(exec_diagnostics(analysis))
        self.search_provenance["exec"] = record

    def _comm_cross_check(self, prog) -> None:
        """search_provenance["comm"]: rank 0's recorded collective census
        against the movement edges the search priced (COMM001-COMM004, the
        JAX package's _comm_cross_check), recorded on every rank, and
        beside the plan audit's movement measurements."""
        from flexflow_tpu_torch.analysis.comm_analysis import (
            comm_diagnostics,
            comm_summary_json,
            cross_check_comm,
            extract_collectives,
        )
        from flexflow_tpu_torch.analysis.diagnostics import summarize
        from flexflow_tpu_torch.runtime.distributed import broadcast_json

        prov = self.search_provenance
        record = None
        if self._rank() == 0:
            ctx = getattr(self, "_comm_ctx", None)
            record = dict(prov["comm"])
            if not ctx:
                record.setdefault("skipped", "no movement-prediction context to cross-check")
            else:
                try:
                    analysis = cross_check_comm(ctx["predictions"], extract_collectives(prog),
                                                bypassed_nodes=ctx["bypassed"])
                    record.update(comm_summary_json(analysis))
                    record["verify"] = summarize(comm_diagnostics(analysis))
                except Exception as e:
                    record["error"] = f"{type(e).__name__}: {e}"[:200]
        if self._grouped():
            record = broadcast_json(record)
        prov["comm"] = record
        audit = prov.get("plan_audit")
        if isinstance(audit, dict) and "error" not in audit and "census" in record:
            audit["comm"] = {key: record[key] for key in (
                "census", "num_collectives", "bytes_geomean", "unmatched_collectives",
                "host_transfers")}

    def _exec_contract_record(self) -> Dict[str, object]:
        """The persistable contract of this compiled model (the
        exec_contract.contract_record shape): a searched winner's, recorded
        at compile; any other backend's from one recorded step, made once a
        compile when checkpointing first asks for it (every rank: the step
        may hold collectives)."""
        from flexflow_tpu_torch.analysis.exec_contract import (
            CONTRACT_SCHEMA,
            step_program_fingerprint,
        )

        rec = (self.search_provenance if isinstance(self.search_provenance, dict)
               else {}).get("exec")
        if isinstance(rec, dict) and rec.get("program_fingerprint"):
            return {"schema": CONTRACT_SCHEMA,
                    "program_fingerprint": rec["program_fingerprint"],
                    "hlo_fingerprint": rec.get("hlo_fingerprint"),
                    "program_key": rec.get("program_key"),
                    "torch_version": torch.__version__}
        if self._exec_fp_record is None:
            self._exec_fp_record = step_program_fingerprint(
                self.instance, self.loss_attrs, self.params, self.opt_state,
                label_dtype=self._label_dtype,
                steps_per_dispatch=self.config.steps_per_dispatch,
                batch_size=self._step_batch())
        return self._exec_fp_record

    def _step_batch(self) -> Optional[int]:
        """The batch the compiled step runs at where it is not the graph's
        (a batch-growth recompile keeps the graph's build-time batch), for
        the recorded step; None for a plan over ranks, which runs at its
        graph's."""
        if self._searched() or self._pipelined() or self._submesh():
            return None
        return int(self._compiled_batch_size)

    def _exec_contract_sync(self, directory: str, resume: bool) -> None:
        """DET002's resume half (the JAX package's): write the step
        program's contract beside the checkpoints (`exec_contract.json`,
        rank 0), and under fit(resume=True) check the program about to run
        against the recorded one. A drifted fingerprint is reported loudly
        and recorded in `exec_resume_check` (and in
        search_provenance["exec"]); a changed program (batch growth, another
        grid) or a contract another runtime wrote re-anchors it. A contract
        failure never kills a fit on one process: it degrades to a recorded
        skip; over ranks a recording that fails raises (_compile_checks)."""
        from flexflow_tpu_torch.analysis.diagnostics import format_diagnostic
        from flexflow_tpu_torch.analysis.exec_contract import (
            compare_contract_records,
            read_contract_record,
            write_contract_record,
        )

        if os.environ.get("FF_TPU_NO_EXEC_CONTRACT") == "1":
            self.exec_resume_check = {"match": None, "reason": "FF_TPU_NO_EXEC_CONTRACT=1"}
            return
        try:
            current = self._exec_contract_record()
        except Exception as e:
            if self._grouped():
                raise
            self.exec_resume_check = {
                "match": None, "reason": f"contract unavailable: {type(e).__name__}: {e}"[:200]}
            return
        writes = self._rank() == 0
        check = None
        if resume:
            stored = read_contract_record(directory)
            check, diag = compare_contract_records(stored, current)
            if stored is None or check.get("program_changed") or "torch_version" not in stored:
                # anchor (or re-anchor) the contract to the program that runs
                try:
                    if writes:
                        write_contract_record(directory, current)
                    if stored is not None:
                        check["re_anchored"] = True
                except OSError:
                    pass
            if diag is not None:
                print("[flexflow_tpu_torch] WARNING: " + format_diagnostic(diag))
                check["diagnostic"] = diag.to_json()
        elif writes:
            try:
                write_contract_record(directory, current)
            except OSError as e:
                check = {"match": None, "reason": f"contract not written: {e}"[:200]}
        if check is not None:
            self.exec_resume_check = check
            prov = self.search_provenance if isinstance(self.search_provenance, dict) else None
            if prov is not None and isinstance(prov.get("exec"), dict):
                prov["exec"]["resume_check"] = check

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

        from flexflow_tpu_torch.local_execution.cost_estimator import optimizer_state_slots_of

        cfg = self.config
        # the memory model's parameters for this compile (the optimizer
        # compiled and the fused window K) and the per-device budget the
        # search must respect (FFConfig.hbm_gb; 0: the winner is analyzed
        # against the card's own capacity, and nothing is pruned)
        mem_slots = optimizer_state_slots_of(self.optimizer_attrs)
        mem_window_k = max(int(cfg.steps_per_dispatch), 1)
        mem_budget_bytes = cfg.hbm_gb * 2**30 if cfg.hbm_gb and cfg.hbm_gb > 0 else 0.0
        overlap_on = overlap_lowering_active(cfg.overlap)
        # pipeline parallelism: stage-partitioned seeds and rules in the
        # search, and a stage-partitioned winner on the 1F1B executor
        pipeline_on = bool(cfg.pipeline)
        # FFConfig.multislice: node legality masks every candidate view, and
        # a spec of several nodes searches through the two-level DP
        multislice_on = bool(cfg.multislice)
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
        # the persistent stores (rank 0 searches, audits and saves them):
        # measured movement edges of past audits (FFConfig.movement_cost_store),
        # and the cost database of op leaves (FFConfig.cost_store), which also
        # serves movement edges where no movement store is configured
        movement_store = cost_store = None
        if cfg.movement_cost_store:
            from flexflow_tpu_torch.compiler.movement_store import MovementCostStore

            movement_store = MovementCostStore(cfg.movement_cost_store)
        if cfg.cost_store:
            from flexflow_tpu_torch.compiler.cost_store import CostStore, device_kind_signature

            cost_store = CostStore(cfg.cost_store, device_kind=device_kind_signature(self.device))
        comm_model = None
        if cfg.machine_model_version > 0 or cfg.machine_model_file:
            from flexflow_tpu_torch.compiler.machine_model import (
                MachineModelCommModel,
                machine_model_from_config,
            )

            comm_model = MachineModelCommModel(spec, machine_model_from_config(
                spec, cfg.machine_model_version, cfg.machine_model_file))

        def build_search_ctx():
            """A fresh estimator and context (their memo tables empty: the
            drift re-search reads every leaf again, under the store's scale)."""
            if measured:
                from flexflow_tpu_torch.local_execution.cost_estimator import LocalCostEstimator

                estimator = GPUCostEstimator(
                    spec, local_cost_estimator=LocalCostEstimator(device=self.device,
                                                                  cost_store=cost_store),
                    intra_latency_ms=intra_lat_ms, inter_latency_ms=inter_lat_ms,
                    comm_model=comm_model, emulated_mesh=emulated, calibration=calibration,
                    movement_store=movement_store, cost_store=cost_store)
            else:
                rates = (peak_flops, hbm_gbps)
                if calibration is not None:
                    rates = (calibration.peak_flops, calibration.hbm_gbps)
                estimator = AnalyticGPUCostEstimator(
                    spec, *rates, intra_latency_ms=intra_lat_ms, inter_latency_ms=inter_lat_ms,
                    comm_model=comm_model, emulated_mesh=emulated, calibration=calibration,
                    movement_store=movement_store, cost_store=cost_store)
            ctx = MachineMappingContext(
                estimator, make_default_allowed_machine_views(),
                # the measured compute/collective overlap where a calibration
                # measured one, else the 0.5 heuristic (the JAX package's rule)
                overlap_fraction=(calibration.overlap if calibration is not None
                                  and calibration.overlap is not None else 0.5),
                allow_resource_splits=spec != exec_spec,
                # price the fused collective matmuls only when the executor
                # lowers them (FFConfig.overlap)
                overlap_lowering=overlap_on,
                slice_aware=multislice_on,
                slice_hierarchy=multislice_on,
                # FFConfig.hbm_gb > 0: a mapping over the budget is
                # infeasible (the DPs prune its leaves, evaluate_pcg rejects
                # a plan whose liveness peak exceeds it)
                memory_budget_bytes=mem_budget_bytes,
                optimizer_state_slots=mem_slots,
                steps_per_dispatch=mem_window_k)
            return estimator, ctx

        priced = {}  # what the search priced with (rank 0), for the audit
        searched = {}  # the lifted graph and the context builder (rank 0)

        def search():
            if cfg.import_strategy_file:
                self.search_provenance = {"search_algorithm": "imported_strategy"}
                return load_strategy(cfg.import_strategy_file)
            estimator, ctx = build_search_ctx()
            priced["estimator"] = estimator
            degrees = [d for d in range(2, spec.num_devices + 1) if spec.num_devices % d == 0]
            rules = generate_parallelization_rules(
                degrees, enable_parameter_parallel=cfg.enable_parameter_parallel,
                enable_attribute_parallel=cfg.enable_attribute_parallel,
                enable_pipeline=pipeline_on, pipeline_microbatches=cfg.pipeline_microbatches)
            if cfg.perform_fusion:
                from flexflow_tpu_torch.substitutions.fusion_rules import generate_fusion_rules

                rules = list(rules) + generate_fusion_rules()
            if cfg.substitution_json_path:
                # a legacy TASO rule corpus (reference substitution-generator
                # legacy_rules.h:40-55) extends the generated rule set
                from flexflow_tpu_torch.substitutions.legacy_rules import (
                    load_legacy_substitutions,
                )

                legacy, skipped = load_legacy_substitutions(cfg.substitution_json_path)
                print(f"[flexflow_tpu_torch] loaded {len(legacy)} legacy substitutions "
                      f"({skipped} outside the convertible vocabulary)", flush=True)
                rules = list(rules) + legacy
            pcg0 = pcg_from_computation_graph(self.cg)
            if cfg.branch_stacking:
                from flexflow_tpu_torch.compiler.branch_stacking import (
                    stack_isomorphic_branches,
                )

                pcg0, _ = stack_isomorphic_branches(pcg0)
            start = time.perf_counter()
            if cfg.force_strategy_seed:
                result = _forced_seed_result(pcg0, ctx, spec, cfg.force_strategy_seed)
            elif cfg.search_algorithm == "mcmc":
                # the legacy search mode: simulated annealing over the same
                # rewrite lattice (reference simulator.h:671)
                from flexflow_tpu_torch.compiler.mcmc_search import MCMCConfig, mcmc_optimize

                result = mcmc_optimize(pcg0, ctx, spec, rules, MCMCConfig(
                    budget=max(cfg.search_budget, 0) * 10, rng_seed=cfg.seed))
            else:
                result = graph_optimize(pcg0, ctx, spec, rules, OptimizerConfig(
                    alpha=cfg.search_alpha, budget=cfg.search_budget,
                    pipeline_seeds=pipeline_on,
                    pipeline_microbatches=cfg.pipeline_microbatches))
            telem = result.telemetry or {}
            self.search_provenance = {
                "explored": result.explored,
                "estimated_ms": result.runtime,
                "serial_ms": result.serial_runtime,
                "search_seconds": time.perf_counter() - start,
                "seed_runtimes": dict(result.seed_runtimes or {}),
                "parallel_degrees": parallel_degree_summary(result.pcg),
                "cost_model": cfg.cost_model,
                "search_algorithm": ("forced_seed" if cfg.force_strategy_seed
                                     else cfg.search_algorithm),
                "evaluations": telem.get("evaluations"),
                "phase_ms": telem.get("phase_ms"),
            }
            if calibration is not None:
                self.search_provenance.update(calibration=calibration.as_dict(),
                                              emulated_mesh=emulated)
            if multislice_on:
                # the two-level DP's per-boundary-axis-kind runtimes and the
                # winning choice for the final plan (None on one node)
                self.search_provenance["multislice"] = {
                    "enabled": True, "hierarchical": result.hierarchical,
                    "nodes": spec.num_nodes, "devices_per_node": spec.num_devices_per_node}
            if overlap_on:
                # the winner's (or the forced seed's) solve priced the fused
                # edges: each eligible edge with its serial and overlapped
                # exposures
                edges = result.overlap_edges or []
                self.search_provenance["overlap"] = {
                    "enabled": True, "priced": True, "edges": edges, "eligible": len(edges),
                    "chosen": sum(1 for e in edges if e.get("chosen"))}
            if cost_store is not None:
                cost_store.save()  # the next session starts warm
                self.search_provenance["cost_db"] = cost_store.provenance()
            if (cost_store is not None and not cfg.force_strategy_seed
                    and cfg.search_algorithm != "mcmc"):
                self._drift_research = _make_drift_research(
                    cost_store, build_search_ctx, pcg0, spec, rules, cfg,
                    pipeline_seeds=pipeline_on, pipeline_microbatches=cfg.pipeline_microbatches)
            self._verify_winner(result.pcg, result.machine_mapping, spec, mem_budget_bytes,
                                mem_slots, mem_window_k)
            searched["pcg0"], searched["build_search_ctx"] = pcg0, build_search_ctx
            return result.pcg, result.machine_mapping, result.runtime

        # rank 0 plans; every rank lowers the plan it sends
        pcg, mapping, runtime = run_search_on_host_0(search)
        self.search_provenance = broadcast_json(
            self.search_provenance if dist.get_rank() == 0 else None)
        if cfg.import_strategy_file:
            self._verify_imported(pcg, mapping, spec)
        if dist.get_rank() == 0 and searched:
            self._drift_transition = _make_drift_transition(
                pcg, mapping, searched["pcg0"], searched["build_search_ctx"], spec,
                mem_budget_bytes, mem_slots, mem_window_k)
        if cfg.export_strategy_file and dist.get_rank() == 0:
            save_strategy(cfg.export_strategy_file, pcg, mapping, runtime)
        collect, guard = self._step_stats_flags()
        searched_logit = self._find_searched_logit(pcg, logit)
        if pipeline_on:
            inst = self._compile_pipelined(pcg, searched_logit, compute_dtype)
            if inst is not None:
                self._export_comm_predictions(inst, pcg, mapping, searched_logit,
                                              priced.get("estimator"), spec)
                if cfg.plan_audit:
                    self._record_plan_audit(inst, mapping, priced.get("estimator"),
                                            movement_store=movement_store, cost_store=cost_store)
                return inst
        mesh = MachineMesh.from_spec(exec_spec)
        inst = DistributedTrainingInstance(
            pcg, searched_logit, self.loss_attrs, self.optimizer_attrs,
            mesh, mapping=mapping, compute_dtype=compute_dtype, device=self.device,
            metrics=self.metrics, overlap=cfg.overlap, aux_loss_tensors=_find_aux_outputs(pcg),
            collect_step_stats=collect, guard_nonfinite_updates=guard)
        self._export_comm_predictions(inst, pcg, mapping, searched_logit,
                                      priced.get("estimator"), spec)
        if cfg.plan_audit:
            self._record_plan_audit(inst, mapping, priced.get("estimator"),
                                    movement_store=movement_store, cost_store=cost_store)
        whole = inst.plan.whole_nodes
        if dist.get_rank() == 0:
            # ops no rule places run on whole values: a state of the plan
            print(f"[flexflow_tpu_torch] the plan runs {len(whole)} node(s) on whole values"
                  + "".join(f"\n  {why}" for why in whole.values()), flush=True)
        return inst

    def _compile_pipelined(self, pcg, logit: DataflowOutput, compute_dtype):
        """The searched (or forced) plan on the 1F1B executor where it is
        stage-partitioned and its structure runs there; None (the flat
        executor, which is correct on it: stage ops are the identity) where
        it is flat or the executor refuses it, with the reason printed and
        recorded in search_provenance["pipeline"]."""
        from flexflow_tpu_torch.parallel.pipeline import (
            PipelinedTrainingInstance,
            PipelineUnsupported,
        )
        from flexflow_tpu_torch.pcg.pipeline import analyze_pipeline

        if analyze_pipeline(pcg) is None:
            return None
        collect, guard = self._step_stats_flags()
        try:
            inst = PipelinedTrainingInstance(
                pcg, logit, self.loss_attrs, self.optimizer_attrs, compute_dtype=compute_dtype,
                device=self.device, metrics=self.metrics, collect_step_stats=collect,
                guard_nonfinite_updates=guard)
        except PipelineUnsupported as e:
            if dist.get_rank() == 0:
                print(f"[flexflow_tpu_torch] pipelined winner falls back to the flat executor: "
                      f"{e}", flush=True)
            if self.search_provenance is not None:
                self.search_provenance["pipeline"] = {"executor": "flat-fallback",
                                                      "reason": str(e)[:200]}
            return None
        if self.search_provenance is not None:
            self.search_provenance["pipeline"] = {
                "num_stages": inst.structure.num_stages,
                "num_microbatches": inst.structure.num_microbatches,
                "mesh": dict(inst.mesh_shape),
                "executor": "1f1b",
            }
        return inst

    def _verify_winner(self, pcg, mapping, spec, mem_budget_bytes, mem_slots,
                       mem_window_k) -> None:
        """The searched winner's static verification, always on (the JAX
        package's): every PCG rule and the machine views on the search's
        grid, and the MEM rules at the capacity the search was held to
        (FFConfig.hbm_gb) or else the card's own, in
        search_provenance["verify"]; its predicted per-device peaks, mapped
        and on the full mesh (what the executor runs), in ["memory"]."""
        from flexflow_tpu_torch.analysis.diagnostics import summarize
        from flexflow_tpu_torch.analysis.memory_analysis import (
            analyze_memory,
            detect_device_hbm_bytes,
            verify_memory,
        )
        from flexflow_tpu_torch.analysis.pcg_verify import verify_pcg

        diags = list(verify_pcg(pcg, machine_spec=spec, mapping=mapping))
        capacity = mem_budget_bytes or (detect_device_hbm_bytes()
                                        if self.device.type == "cuda" else None)
        mem, mem_diags = verify_memory(pcg, machine_spec=spec, mapping=mapping,
                                       hbm_bytes=capacity or None,
                                       optimizer_state_slots=mem_slots,
                                       steps_per_dispatch=mem_window_k)
        self.search_provenance["verify"] = summarize(diags + list(mem_diags))
        full_mesh = analyze_memory(pcg, spec, None, optimizer_state_slots=mem_slots,
                                   steps_per_dispatch=mem_window_k)
        self.search_provenance["memory"] = {
            "predicted_peak_bytes_per_device": {
                str(d): int(v) for d, v in mem.peak_by_device().items()},
            "predicted_peak_bytes_full_mesh": {
                str(d): int(v) for d, v in full_mesh.peak_by_device().items()},
            "capacity_bytes": int(capacity) if capacity else None,
            "hbm_gb": self.config.hbm_gb or None,
            "optimizer_state_slots": mem_slots,
            "steps_per_dispatch": mem_window_k,
        }

    def _verify_imported(self, pcg, mapping, spec) -> None:
        """An imported plan is verified like a searched winner (the JAX
        package's): structural and SP errors raise ValueError (the executor
        would crash or train another graph); machine-view findings are only
        recorded, since the views were searched for the exporting machine.
        Every rank verifies the same plan, so every rank raises alike."""
        from flexflow_tpu_torch.analysis.diagnostics import (
            errors_of,
            format_diagnostic,
            summarize,
        )
        from flexflow_tpu_torch.analysis.pcg_verify import verify_pcg

        diags = verify_pcg(pcg, machine_spec=spec, mapping=mapping)
        if self.search_provenance is None:
            self.search_provenance = {"search_algorithm": "imported_strategy"}
        self.search_provenance["verify"] = summarize(diags)
        structural = [d for d in errors_of(diags) if not d.rule_id.startswith("MV")]
        if structural:
            raise ValueError(
                f"imported strategy {self.config.import_strategy_file!r} is ill-formed:\n"
                + "\n".join(format_diagnostic(d) for d in structural))

    def _export_comm_predictions(self, inst, pcg, mapping, logit, estimator, spec) -> None:
        """The fused-overlap annotation checked against the PCG (PCG008:
        an annotation the executor cannot honor fails the compile), then the
        movement edges' predictions (movement_export), always recorded in
        search_provenance["comm"] on rank 0, which has the estimator the
        search priced with (an imported plan: the analytic one)."""
        from flexflow_tpu_torch.analysis.diagnostics import errors_of, format_diagnostic
        from flexflow_tpu_torch.analysis.pcg_verify import verify_overlap_plan

        fused = {n.idx: kind for n, kind in getattr(inst, "fused_edges", {}).items()}
        if fused:
            bad = errors_of(verify_overlap_plan(pcg, fused))
            if bad:
                raise ValueError("fused-overlap annotation failed verification:\n"
                                 + "\n".join(format_diagnostic(d) for d in bad))
            self.search_provenance.setdefault("overlap", {})["executor_fused_edges"] = {
                str(k): v for k, v in sorted(fused.items())}
        self._comm_ctx = None
        if dist.get_rank() != 0:
            self.search_provenance["comm"] = {}
            return
        try:
            from flexflow_tpu_torch.analysis.comm_analysis import trailing_reshard_nodes
            from flexflow_tpu_torch.compiler import AnalyticGPUCostEstimator
            from flexflow_tpu_torch.compiler.machine_mapping.movement_export import (
                export_movement_predictions,
            )

            if estimator is None:
                rates = (5e10, 10.0) if self.device.type == "cpu" else (989e12, 3350.0)
                estimator = AnalyticGPUCostEstimator(spec, *rates)
            predictions = export_movement_predictions(pcg, mapping, estimator,
                                                      fused_edges=fused or None)
            self._comm_ctx = {"predictions": predictions,
                              "bypassed": trailing_reshard_nodes(pcg, logits=[logit])}
            self.search_provenance["comm"] = {"num_edges": len(predictions),
                                              "edges": [p.to_json() for p in predictions]}
        except Exception as e:  # the export must not kill the compile
            self.search_provenance["comm"] = {"error": f"{type(e).__name__}: {e}"[:200]}

    def _price_resource_splits(self, ndev: int) -> dict:
        """Price the model's machine mapping with disjoint-resource splits
        enabled (the JAX package's _price_resource_splits): legal here
        because the sub-mesh runtime this model compiles to runs such
        placements. Returns the provenance recorded on search_provenance."""
        from flexflow_tpu_torch.compiler import (
            AnalyticGPUCostEstimator,
            MachineMappingCache,
            MachineMappingContext,
            evaluate_pcg,
            make_default_allowed_machine_views,
        )
        from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
        from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph

        nodes = max(self.config.num_nodes, 1)
        spec = MachineSpecification(nodes, 1, max(ndev // nodes, 1), 25.0, 400.0)
        # the analytic rates a searched compile prices with on this device
        rates = (5e10, 10.0) if self.device.type == "cpu" else (989e12, 3350.0)
        pcg = pcg_from_computation_graph(self.cg)
        runtimes = {}
        for splits in (True, False):
            # a cache is valid for one context only (the flag changes results)
            ctx = MachineMappingContext(AnalyticGPUCostEstimator(spec, *rates),
                                        make_default_allowed_machine_views(),
                                        overlap_fraction=0.5, allow_resource_splits=splits)
            r = evaluate_pcg(pcg, ctx, spec, MachineMappingCache())
            runtimes[splits] = None if r is None else r.runtime
        return {"resource_splits_priced": True, "estimated_ms": runtimes[True],
                "full_mesh_estimated_ms": runtimes[False]}

    def _record_plan_audit(self, inst, mapping, estimator, movement_store=None,
                           cost_store=None) -> None:
        """search_provenance["plan_audit"]: the searched plan replayed
        against the estimator the search priced with
        (observability/plan_audit.py). Every rank takes part (the movement
        edges are timed as collectives over the mesh, the fused ones as
        their collective matmuls); rank 0's audit, the one with the
        estimator, is recorded on every rank, and rank 0 feeds its
        measurements into the stores and saves them. An imported plan has
        no estimator and records why; a failed audit records its error, and
        the compile goes on."""
        from flexflow_tpu_torch.observability.plan_audit import audit_plan
        from flexflow_tpu_torch.pcg.optimizer import AdamOptimizerAttrs
        from flexflow_tpu_torch.runtime.distributed import broadcast_json

        cfg = self.config
        if cfg.import_strategy_file:
            audit = {"skipped": "import_strategy_file: the imported plan carries no cost "
                                "estimator to audit against"}
        else:
            attrs = self.optimizer_attrs
            slots = (2 if isinstance(attrs, AdamOptimizerAttrs)
                     else 1 if getattr(attrs, "momentum", 0.0) > 0 else 0)
            rank0 = dist.get_rank() == 0
            # the DP's overlapped prediction per fused edge: the Combine of
            # an all-gather site, the Reduction of a reduce-scatter one
            overlap_predictions = {}
            for e in ((self.search_provenance or {}).get("overlap") or {}).get("edges") or []:
                node = e.get("src_node") if e.get("kind") == "ag_matmul" else e.get("dst_node")
                if node is not None:
                    overlap_predictions[node] = e.get("overlapped_exposed_ms")
            # the 1F1B executor's stage transfers are no reshard of a
            # sharding: its ops are audited, its edges priced, none timed
            from flexflow_tpu_torch.parallel import DistributedTrainingInstance

            flat = isinstance(inst, DistributedTrainingInstance)
            try:
                audit = audit_plan(
                    inst.pcg, mapping or {}, estimator if rank0 else None,
                    machine_mesh=inst.machine_mesh if flat else None,
                    shardings=inst.shardings if flat else None,
                    optimizer_state_slots=slots,
                    fused_edges=({n.idx: kind for n, kind in inst.fused_edges.items()}
                                 if flat else {}),
                    overlap_predictions=overlap_predictions,
                    movement_store=(movement_store or cost_store) if rank0 else None,
                    cost_store=cost_store if rank0 else None,
                    device=self.device)
                if rank0:
                    for store in (movement_store, cost_store):
                        if store is not None:
                            store.save()
                    if cost_store is not None:
                        self.search_provenance["cost_db"] = cost_store.provenance()
            except Exception as e:  # an audit failure must not kill the compile
                audit = {"error": f"{type(e).__name__}: {e}"[:200]}
            audit = broadcast_json(audit if rank0 else None)
        if self.search_provenance is None:
            self.search_provenance = {}
        self.search_provenance["plan_audit"] = audit

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

    def _step_stats_flags(self) -> Tuple[bool, bool]:
        """(collect_step_stats, guard_nonfinite_updates) the run-health
        config implies: an event log or any active health policy needs the
        step statistics; skip_step and raise also guard the update."""
        cfg = self.config
        health_on = cfg.health_policy not in ("", "off")
        return bool(cfg.metrics_dir) or health_on, cfg.health_policy in ("skip_step", "raise")

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
        if cfg.submesh_branches and self._step_stats_flags()[0]:
            # the sub-mesh trainer computes no step statistics; dropping the
            # health coverage asked for would be worse than refusing
            raise ValueError("metrics_dir/health_policy are not supported with submesh_branches "
                             "(its islands compute no step statistics)")
        if cfg.perform_fusion:
            print("[flexflow_tpu_torch] perform_fusion: the fusion rules extend the Unity "
                  "search, which a single-device compile does not run")
        if cfg.branch_stacking:
            print("[flexflow_tpu_torch] branch_stacking: isomorphic branches are stacked "
                  "before the Unity search, which a single-device compile does not run")
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
        snapshot made durable first.

        FFConfig.profile_trace_dir traces the fit: the span trace
        (observability/trace.py) as `flexflow_trace.json`, and the
        torch.profiler trace of the host and the card as
        `torch_trace.json`, both in that directory."""
        import contextlib

        if getattr(self, "inactive", False):
            # a rank a degraded grid left out (recover_from_grid_change)
            # trains nothing
            return PerfMetrics()
        self._require_compiled()
        tdir = self.config.profile_trace_dir
        if not tdir:
            return self._fit(x, y, epochs, batch_size, shuffle, verbose, recompile_state,
                             epoch_offset, checkpoint_dir, checkpoint_every_n_steps, resume)
        from flexflow_tpu_torch.observability.trace import trace_session

        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        with contextlib.ExitStack() as stack:
            # unwound in reverse: the span trace saved, the profiler
            # stopped, then its trace exported
            stack.callback(lambda: prof.export_chrome_trace(
                os.path.join(tdir, f"torch_trace_rank{self._rank()}.json"
                             if self._grouped() else "torch_trace.json")))
            stack.callback(os.makedirs, tdir, exist_ok=True)
            stack.enter_context(prof)
            stack.enter_context(trace_session(
                tdir, "flexflow_trace" if not self._grouped()
                else f"flexflow_trace_rank{self._rank()}"))
            return self._fit(x, y, epochs, batch_size, shuffle, verbose, recompile_state,
                             epoch_offset, checkpoint_dir, checkpoint_every_n_steps, resume)

    def _fit(self, x, y, epochs, batch_size, shuffle, verbose, recompile_state, epoch_offset,
             checkpoint_dir, checkpoint_every_n_steps, resume) -> PerfMetrics:
        """fit's body, under the trace session where one is asked for."""
        epochs = epochs or self.config.epochs
        batch_size = batch_size or self.config.batch_size
        it = self._make_iterator(x, y, batch_size, shuffle=shuffle, seed_offset=epoch_offset,
                                 blocks=True)
        if self._rng is None:
            self._rng = torch.Generator(device=self.device)
        rng = self._rng.manual_seed(self.config.seed * 1_000_003 + epoch_offset)
        sup = self._setup_supervision()
        # everything after the supervision runs under one finally, so a
        # failure anywhere in the setup still retires what it started
        ckpt = event_log = drift = None
        try:
            ckpt, start_epoch, skip = self._setup_checkpointing(
                checkpoint_dir, checkpoint_every_n_steps, resume, it, rng, epoch_offset,
                sup.channel)
            event_log, monitor = self._setup_run_health()
            drift = self._setup_drift_monitor(sup)
            self._write_provenance()
            rebuild = None
            if recompile_state is not None:
                def rebuild(bs):
                    return self._make_iterator(x, y, bs, shuffle=shuffle,
                                               seed_offset=epoch_offset, blocks=True)
            return self._fit_epochs(epochs, batch_size, verbose, it, rng, ckpt=ckpt,
                                    start_epoch=start_epoch, skip_batches=skip,
                                    epoch_offset=epoch_offset, sup=sup, event_log=event_log,
                                    monitor=monitor, recompile=(recompile_state, rebuild))
        finally:
            # the watchdog first: its deadline must not fire into the drain
            sup.close()
            if drift is not None:
                # stop the poller and drain the stream's tail on this thread,
                # then pin the verdict into the provenance
                drift.close()
                if isinstance(self.search_provenance, dict):
                    self.search_provenance["drift"] = drift.report()
                    self._write_provenance()
            if ckpt is not None:
                ckpt.finalize()
            if event_log is not None:
                event_log.close()

    def _writes_stream(self) -> bool:
        """Whether this process writes the metrics stream: rank 0 of a
        compile over ranks, the only process otherwise."""
        return bool(self.config.metrics_dir) and self._rank() == 0

    def _write_provenance(self) -> None:
        """Snapshot search_provenance beside the event stream."""
        if self._writes_stream() and self.search_provenance:
            from flexflow_tpu_torch.observability.metrics import write_provenance

            write_provenance(self.config.metrics_dir, self.search_provenance)

    def _setup_supervision(self):
        """One fit call's supervision (runtime/supervisor.py): the fault
        channel the background threads report into, the window watchdog
        (only where a factor is configured: FFConfig.watchdog_factor, else
        FF_TPU_WATCHDOG), whose hang diagnostic lands in the metrics stream
        as an `event: "hang"` line, and the active fault schedule."""
        from flexflow_tpu_torch.runtime.fault import active_schedule
        from flexflow_tpu_torch.runtime.supervisor import (
            FaultChannel,
            FitSupervision,
            WindowWatchdog,
        )

        factor = float(self.config.watchdog_factor or 0.0)
        if factor <= 0:
            env = os.environ.get("FF_TPU_WATCHDOG", "")
            factor = float(env) if env else 0.0
        watchdog = None
        if factor > 0:
            metrics_dir = self.config.metrics_dir if self._writes_stream() else ""

            def on_hang(diag):
                if metrics_dir:
                    from flexflow_tpu_torch.observability.metrics import append_run_event

                    append_run_event(metrics_dir, "hang", **diag.to_dict())

            watchdog = WindowWatchdog(factor, on_hang=on_hang)
        return FitSupervision(channel=FaultChannel(), watchdog=watchdog,
                              schedule=active_schedule())

    def _setup_run_health(self):
        """The step event log (FFConfig.metrics_dir, rank 0 writes it) and
        the health monitor (FFConfig.health_policy, on every rank) of one
        fit call, each None unless configured, so the loop pays nothing by
        default. The registry and the monitor persist across fit calls on
        this model: events.jsonl appends, so the counts accumulate over the
        same stream."""
        cfg = self.config
        event_log = monitor = None
        if self._writes_stream():
            from flexflow_tpu_torch.observability.metrics import MetricsRegistry, StepEventLog

            if getattr(self, "_metrics_registry", None) is None:
                self._metrics_registry = MetricsRegistry()
            event_log = StepEventLog(cfg.metrics_dir, registry=self._metrics_registry)
        if cfg.health_policy not in ("", "off"):
            from flexflow_tpu_torch.observability.health import HealthMonitor

            monitor = getattr(self, "health_monitor", None)
            if monitor is None or monitor.policy != cfg.health_policy:
                monitor = HealthMonitor(
                    cfg.health_policy,
                    localizer=(self._localize_nonfinite_ranks if self._grouped()
                               else self._localize_nonfinite))
        self.health_monitor = monitor
        return event_log, monitor

    def _setup_drift_monitor(self, sup):
        """The streaming plan-fidelity drift monitor (observability/drift.py)
        of one fit call, started, or None where it cannot run: it needs
        FFConfig.drift_monitor, a metrics stream this process writes, and a
        searched plan with a finite positive predicted step cost. Its
        crashes surface through the fit's fault channel at the next
        boundary; it only ever advises. Its repricer is the warm re-search
        under the cost store's live scale, where the compile searched with
        FFConfig.cost_store (the unity search); its transition verifier
        gives each candidate the static TRN verdict for swapping the live
        plan onto it (a searched compile's, on rank 0)."""
        import math

        cfg = self.config
        if not (cfg.drift_monitor and self._writes_stream()):
            return None
        sp = self.search_provenance
        if not isinstance(sp, dict):
            return None
        try:
            predicted = float(sp.get("estimated_ms"))
        except (TypeError, ValueError):
            return None
        if not math.isfinite(predicted) or predicted <= 0:
            return None
        from flexflow_tpu_torch.observability.drift import DriftMonitor

        return DriftMonitor(
            cfg.metrics_dir, predicted, seed_runtimes=sp.get("seed_runtimes"),
            band=cfg.drift_band, window_steps=cfg.drift_window_steps,
            run_length=cfg.drift_run_length,
            repricer=getattr(self, "_drift_research", None),
            transition_verifier=getattr(self, "_drift_transition", None),
            channel=sup.channel if sup is not None else None,
        ).start()

    def _localize_nonfinite_ranks(self, batch, label):
        """The localizer over several ranks (every rank trips on the same
        step: the step statistics are global). Every rank sends its rows of
        the tripped batch to rank 0, and a searched plan's ranks gather the
        global parameters (a collective); rank 0 replays the graph the
        reference replays, the searched PCG or else the model graph, on
        the whole batch, and its report reaches every rank."""
        from flexflow_tpu_torch.interop import pcg_params_to_numpy
        from flexflow_tpu_torch.observability.health import NonFiniteReport
        from flexflow_tpu_torch.runtime.distributed import broadcast_json

        inst = self.instance
        # a pipelined plan's ranks are fed the whole batch
        rows, label_rows = inst.feed_blocks() if hasattr(inst, "feed_blocks") else ({}, None)
        mine = ({k: (rows.get(k), _to_numpy(torch.as_tensor(v))) for k, v in (batch or {}).items()},
                None if label is None else (label_rows, _to_numpy(torch.as_tensor(label))))
        parts = [None] * dist.get_world_size()
        dist.all_gather_object(parts, mine)
        searched = self._searched() or self._pipelined()
        params = None
        if self._pipelined():
            params = inst.pcg_params(inst.stacked_state(self.params)["params"])
        elif searched:
            params = pcg_params_to_numpy(inst.pcg, inst.shardings, inst.machine_mesh, self.params)
        doc = None
        if dist.get_rank() == 0:
            try:
                full = {name: _assemble_rows([p[0][name] for p in parts]) for name in parts[0][0]}
                full_label = (None if parts[0][1] is None
                              else _assemble_rows([p[1] for p in parts]))
                if searched:
                    params = {k: torch.as_tensor(v, device=self.device) for k, v in params.items()}
                    graph, logit = inst.pcg, inst.loss_logit_tensor
                else:
                    params, graph, logit = self.params, inst.cg, inst.logit_tensor
                doc = dataclasses.asdict(self._localize_on(graph, logit, params, full, full_label))
            except Exception as e:  # every rank must leave the broadcast below
                doc = dataclasses.asdict(NonFiniteReport(
                    "unknown", None, detail=f" (localizer failed: {type(e).__name__}: {e})"))
        return NonFiniteReport(**broadcast_json(doc))

    def _localize_nonfinite(self, batch, label):
        inst = self.instance
        return self._localize_on(inst.cg, inst.logit_tensor, self.params, batch, label)

    def _localize_on(self, graph, logit, params, batch, label):
        """First-bad-op blame for the health monitor: replay the tripped
        step op by op over `graph` (the model graph, or a searched plan's
        PCG with its global parameters) with the live parameters (under
        skip_step / raise the guard kept the pre-step values), its batch,
        and its Dropout masks, drawn from a generator put back where the
        step drew them (`_last_step_rng`: the generator's state before the
        window or step, and the steps of the window before it)."""
        from flexflow_tpu_torch.local_execution.training_backing import dropout_masks
        from flexflow_tpu_torch.observability.health import localize_first_nonfinite

        rng = None
        if getattr(self, "_last_step_rng", None) is not None:
            state, steps_before = self._last_step_rng
            rng = torch.Generator(device=self.device)
            rng.set_state(state)
            for _ in range(steps_before):
                dropout_masks(graph, rng, self.device)
        return localize_first_nonfinite(
            graph, params, batch, logit_tensor=logit, label=label,
            loss_attrs=self.loss_attrs, compute_dtype=self.instance.compute_dtype, rng=rng)

    def _record_run_health(self, event_log, monitor, loss, batch, label, step_t0) -> None:
        """The per-step event and policy (observability.health
        record_step_health): the step's statistics and loss read back in
        one transfer, the one host sync telemetry costs."""
        from flexflow_tpu_torch.observability.health import record_step_health
        from flexflow_tpu_torch.observability.metrics import stats_to_host

        stats = self.instance.last_step_stats
        host = stats_to_host({**(stats or {}), "loss": loss.reshape(())})
        record_step_health(
            event_log, monitor, self._step_count, host.pop("loss"), host if stats else None,
            batch=batch, label=label, tokens=_label_tokens(label, 1, self.config.batch_size),
            step_t0=step_t0)

    def _emit_window_health(self, event_log, monitor, base_step, losses, host_win, kk, win_t0,
                            tokens, pre_rng):
        """Per-step events and policy for one fused window: the loss and
        stat stacks read back in one transfer (the window's one host sync)
        and re-emitted as kk per-step events, the window's wall-clock,
        measured at that readback, apportioned equally over its steps.
        Under `raise` the window froze at its first tripped step, so the
        parameters are the pre-trip ones; the step count then stops at the
        trip, as the per-step loop would have. Returns the host losses."""
        from flexflow_tpu_torch.observability.health import NonFiniteError, record_step_health
        from flexflow_tpu_torch.observability.metrics import split_window_stats, stats_to_host

        stacks = self.instance.last_window_stats
        host = stats_to_host({**(stacks or {}), "loss": losses})
        losses_host = host.pop("loss")
        per_step_ms = (time.perf_counter() - win_t0) * 1000.0 / kk
        step_stats = split_window_stats(host if stacks else None, kk)
        for i in range(kk):
            batch_i = label_i = None
            if host_win is not None and step_stats[i] is not None and not step_stats[i]["ok"]:
                batch_i, label_i = host_win.batch(i)  # the localizer's replay input
            if monitor is not None:
                self._last_step_rng = (pre_rng, i)
            try:
                record_step_health(event_log, monitor, base_step + i + 1, losses_host[i],
                                   step_stats[i], batch=batch_i, label=label_i, tokens=tokens,
                                   wallclock_ms=per_step_ms)
            except NonFiniteError:
                self._step_count = base_step + i + 1
                raise
        return losses_host

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
        # the step program's contract beside the checkpoints; under resume,
        # DET002 against the recorded one
        self._exec_contract_sync(cdir, resume)
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
        in search_provenance["recovery"]["checkpoint_fallback"] and as an
        `event: "checkpoint_fallback"` line in the metrics stream."""
        if not report or not report.get("quarantined"):
            return
        if self.search_provenance is None:
            self.search_provenance = {}
        self.search_provenance.setdefault("recovery", {})["checkpoint_fallback"] = report
        if self._writes_stream():
            from flexflow_tpu_torch.observability.metrics import append_run_event

            append_run_event(self.config.metrics_dir, "checkpoint_fallback", **report)

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
                    skip_batches=0, epoch_offset=0, sup=None, event_log=None,
                    monitor=None, recompile=(None, None)) -> PerfMetrics:
        """The per-step loop, or with steps_per_dispatch = K > 1 the windowed
        one: each window of K batches (the epoch's tail a smaller one)
        trains through one multi_train_step, its input gathered and copied
        while the window before it runs. Each step or window runs inside
        the watchdog's deadline with the `hang` site; at its boundary come
        the checkpoint hook, then the `kill` site, the fault channel and
        FF_TPU_FAULT_STEP, so a due snapshot is durable before a fault
        propagates. With an event log or a health monitor, each step's (or
        window's) statistics are read back once, inside the armed window,
        after the `slow` site, and the policy applied (`_record_run_health`,
        `_emit_window_health`). `recompile`: (a RecompileState, the
        iterator builder at a batch size); when its trigger fires at a
        boundary the model recompiles and the epoch ends there: training
        goes on from the next epoch on the new step and batch (the JAX
        package's semantics: no batch is replayed, and a trigger that stays
        true cannot livelock the fit)."""
        from flexflow_tpu_torch.runtime.fault import (
            inject_hang_fault,
            inject_kill_fault,
            inject_slow_fault,
            maybe_inject_fault,
            poison_nonfinite,
        )
        from flexflow_tpu_torch.runtime.recompile import recompile_on_condition

        watchdog = sup.watchdog if sup is not None else None
        schedule = sup.schedule if sup is not None else None
        telem = (event_log, monitor) if event_log is not None or monitor is not None else None
        start = time.perf_counter()
        num_samples = 0
        loss = None
        macc: Optional[Dict[str, object]] = None
        pf = self.config.print_freq if verbose else 0
        k = self._effective_steps_per_dispatch()
        windows = (WindowedBatchIterator(it, k, fault_channel=sup.channel if sup else None,
                                         keep_host=monitor is not None)
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
                            loss, macc = self._run_fused_window(
                                inputs, label, kk, rng, macc, pf, epoch, telem, schedule,
                                windows.host_window)
                        else:
                            poison_nonfinite(schedule, prev + 1, list(inputs.values()))
                            loss, macc = self._run_step(inputs, label, rng, macc, pf, epoch,
                                                        telem, schedule)
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
                    if recompile[0] is not None and recompile_on_condition(self, recompile[0]):
                        if ckpt is not None:
                            # the checkpoints from here on are the new
                            # program's: so is the contract beside them
                            self._exec_contract_sync(ckpt.manager.directory, resume=False)
                        batch_size = self.config.batch_size
                        it = recompile[1](batch_size)
                        k = self._effective_steps_per_dispatch()
                        if windows is not None:
                            windows.close()
                        windows = (WindowedBatchIterator(
                            it, k, fault_channel=sup.channel if sup else None,
                            keep_host=monitor is not None) if k > 1 else None)
                        break
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

    def _run_step(self, batch, label, rng, macc, pf, epoch, telem=None, schedule=None):
        """One train_step, the `slow` site, the run health (`telem`: the
        event log and the monitor, or None), and its metric fold and
        print. Returns (its loss, macc)."""
        from flexflow_tpu_torch.runtime.fault import inject_slow_fault

        step_t0 = time.perf_counter() if telem is not None else None
        if telem is not None and telem[1] is not None:
            self._last_step_rng = (rng.get_state(), 0)  # for the localizer
        self.params, self.opt_state, loss, mvals = self.instance.train_step(
            self.params, self.opt_state, batch, label, rng)
        self._step_count += 1
        # the sleep lands inside the timed step, as a throttled card's would
        inject_slow_fault(schedule, self._step_count - 1, self._step_count)
        if telem is not None:
            self._record_run_health(*telem, loss, batch, label, step_t0)
        macc = mvals if macc is None else {key: macc[key] + v for key, v in mvals.items()}
        if pf and self._step_count % pf == 0:
            print(f"epoch {epoch} step {self._step_count}: loss {float(loss):.4f}")
        return loss, macc

    def _run_fused_window(self, inputs_stack, label_stack, kk, rng, macc, pf, epoch, telem=None,
                          schedule=None, host_win=None):
        """One window: its dispatch, the `slow` site, the window's run
        health (`telem`: one readback a window), the metric fold (one add a
        window), and the print_freq lines from the window's loss vector,
        read back once and only when a print falls in the window or the
        health readback has it. Returns (the window's last loss, macc)."""
        from flexflow_tpu_torch.runtime.fault import inject_slow_fault

        win_t0 = time.perf_counter() if telem is not None else None
        pre_rng = rng.get_state() if telem is not None and telem[1] is not None else None
        self.params, self.opt_state, rng, losses, mvals = self.instance.multi_train_step(
            self.params, self.opt_state, inputs_stack, label_stack, rng)
        base_step = self._step_count
        self._step_count += kk
        inject_slow_fault(schedule, base_step, self._step_count)
        host = None
        if telem is not None:
            tokens = (_label_tokens(label_stack, 2, self.config.batch_size)
                      if label_stack is not None else self.config.batch_size)
            host = self._emit_window_health(*telem, base_step, losses, host_win, kk, win_t0,
                                            tokens, pre_rng)
        macc = mvals if macc is None else {key: macc[key] + v for key, v in mvals.items()}
        if pf and base_step // pf != (base_step + kk) // pf:
            host = losses.tolist() if host is None else host
            for i in range(kk):
                if (base_step + i + 1) % pf == 0:
                    print(f"epoch {epoch} step {base_step + i + 1}: loss {float(host[i]):.4f}")
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

    def _pipelined(self) -> bool:
        """Whether the compile lowered a pipelined plan (each rank holding
        its stage's parameters)."""
        from flexflow_tpu_torch.parallel.pipeline import PipelinedTrainingInstance

        return isinstance(self.instance, PipelinedTrainingInstance)

    def _submesh(self) -> bool:
        from flexflow_tpu_torch.parallel.submesh import SubmeshBranchInstance

        return isinstance(self.instance, SubmeshBranchInstance)

    def _ensure_backing(self) -> LocalTrainingBacking:
        if self._searched() or self._pipelined() or self._submesh():
            raise NotImplementedError(
                "the stepped forward/backward/update runs the whole graph on one device; a "
                "plan's ranks hold pieces of it (A7 item 4)")
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
        return (isinstance(self.instance, DataParallelTrainingInstance) or self._searched()
                or self._pipelined() or self._submesh())

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
        return None if self._searched() or self._pipelined() else self._state_template()

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
        if self._pipelined():
            # the JAX package's stacked layout: [S, ...] under the template's keys
            return self.instance.stacked_state(self.params, self.opt_state)
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

        if self._pipelined():
            # this stage's slice of the stacked state
            self.instance.load_stacked_state(self.params, self.opt_state, params, opt_state)
            return
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

    def _transition_plan(self):
        """(pcg, mapping, machine spec) of the compiled plan, for the
        transition verifier: a mapped plan's, or, for the data-parallel and
        single-device backends, the serial PCG of the graph with no mapping
        (TRN001's leaf totality and TRN003's resume contract still verify;
        only the mapped movement report is empty)."""
        from flexflow_tpu_torch.pcg.machine_view import MachineSpecification
        from flexflow_tpu_torch.pcg.parallel_computation_graph import pcg_from_computation_graph

        inst = getattr(self, "instance", None)
        pcg = getattr(inst, "pcg", None)
        mm = getattr(inst, "machine_mesh", None)
        if pcg is None or mm is None:
            if inst is None:
                return None
            try:
                return pcg_from_computation_graph(self.cg), None, None
            except Exception:
                return None
        nodes = max(mm.spec.num_nodes, 1)
        spec = MachineSpecification(num_nodes=nodes, num_cpus_per_node=1,
                                    num_devices_per_node=max(mm.world_size // nodes, 1),
                                    inter_node_bandwidth=25.0, intra_node_bandwidth=400.0)
        return pcg, getattr(inst, "mapping", None), spec

    def recompile(self, preserve_resume: bool = False, carry_state=None,
                  old_plan=None) -> None:
        """Build the training step again after the config or the graph
        changed (the reference's RecompileState re-mapping): compile() again,
        the Unity search included where configured, then carry the
        parameter values (and the optimizer state whose shapes survive)
        over. The step count survives.

        The transition is verified first (TRN001-TRN004) into
        search_provenance["transition"]: one that is unsafe to carry state
        across (TRN001's reshard totality, TRN002's migration memory) raises
        TransitionError before any state moves; `preserve_resume=True`, the
        strict contract, raises on any rule. A searched plan's program is
        checked against its contract recorded at the last compile (DET002;
        a changed `program_key` is recorded as `program_changed`).
        `carry_state` and `old_plan`: the state to carry and the plan it
        leaves (`_transition_plan()`), where the caller took them before the
        old plan's group closed (recover_from_grid_change)."""
        from flexflow_tpu_torch.runtime.recompile import carry, snapshot_state

        assert getattr(self, "_compile_args", None) is not None, "recompile() before compile()"
        old_state = carry_state if carry_state is not None else snapshot_state(self)
        step_count = self._step_count
        if old_plan is None:
            old_plan = self._transition_plan()
        old_k = max(int(getattr(self, "_compiled_window", self.config.steps_per_dispatch)), 1)
        # the batch the last compile ran under: recompile_on_condition's
        # alter_func has already changed the config's
        old_b = int(getattr(self, "_compiled_batch_size", None) or self.config.batch_size)
        old_exec = None
        if isinstance(self.search_provenance, dict) and isinstance(
                self.search_provenance.get("exec"), dict):
            old_exec = dict(self.search_provenance["exec"])
        self.compile(**self._compile_args)
        self._step_count = step_count
        new_prov = self.search_provenance if isinstance(self.search_provenance, dict) else None
        if (old_exec is not None and new_prov is not None
                and isinstance(new_prov.get("exec"), dict)
                and new_prov["exec"].get("program_fingerprint")):
            from flexflow_tpu_torch.analysis.diagnostics import format_diagnostic
            from flexflow_tpu_torch.analysis.exec_contract import compare_contract_records

            check, diag = compare_contract_records(old_exec, new_prov["exec"])
            if diag is not None:
                print("[flexflow_tpu_torch] WARNING: " + format_diagnostic(diag))
                check["diagnostic"] = diag.to_json()
            new_prov["exec"]["recompile_check"] = check
        new_plan = self._transition_plan()
        if old_plan is not None and new_plan is not None:
            from flexflow_tpu_torch.analysis.diagnostics import Severity
            from flexflow_tpu_torch.analysis.transition_analysis import (
                TransitionError,
                transition_summary_json,
                verify_transition,
            )
            from flexflow_tpu_torch.local_execution.cost_estimator import (
                optimizer_state_slots_of,
            )

            cfg = self.config
            analysis, diags = verify_transition(
                old_plan[0], old_plan[1], new_plan[0], new_plan[1], machine_spec=new_plan[2],
                hbm_bytes=cfg.hbm_gb * 2**30 if cfg.hbm_gb and cfg.hbm_gb > 0 else None,
                optimizer_state_slots=optimizer_state_slots_of(self.optimizer_attrs),
                steps_per_dispatch=old_k,
                steps_per_dispatch_new=max(int(cfg.steps_per_dispatch), 1),
                batch_size=old_b, batch_size_new=int(cfg.batch_size))
            record = transition_summary_json(analysis)
            if new_prov is not None and isinstance(
                    (new_prov.get("exec") or {}).get("recompile_check"), dict):
                check = new_prov["exec"]["recompile_check"]
                record["program_changed"] = (bool(check.get("program_changed"))
                                             or check.get("match") is False)
            if self.search_provenance is None:
                self.search_provenance = {}
            self.search_provenance["transition"] = record
            fatal = [r for r in analysis.rules_tripped
                     if preserve_resume or r in ("TRN001", "TRN002")]
            if fatal:
                raise TransitionError(fatal, [d for d in diags if d.severity == Severity.ERROR
                                              and d.rule_id in fatal])
        carry(self, old_state)

def _forced_seed_result(pcg0, ctx, spec, seed_name: str):
    """The named strategy template, priced as is (FFConfig.
    force_strategy_seed): "serial", a label of enumerate_seeds, or a
    pipeline template pp{S}m{M}[xdp{D}] (pipeline_seed)."""
    import re

    from flexflow_tpu_torch.compiler import MachineMappingCache, evaluate_pcg
    from flexflow_tpu_torch.compiler.unity_algorithm import enumerate_seeds, pipeline_seed

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
    m = re.fullmatch(r"pp(\d+)m(\d+)(?:xdp(\d+))?", seed_name)
    if m:
        seed_pcg = pipeline_seed(pcg0, int(m.group(1)), int(m.group(2)),
                                 inner_dp=int(m.group(3) or 1), degree_cap=spec.num_devices)
        result = evaluate_pcg(seed_pcg, ctx, spec, cache)
        if result is None:
            raise ValueError(f"seed {seed_name} is unmappable")
        result.serial_runtime = serial.runtime if serial else float("nan")
        result.seed_runtimes = {seed_name: result.runtime}
        return result
    raise ValueError(f"unknown strategy seed {seed_name!r}")


def _assemble_rows(parts) -> np.ndarray:
    """The whole batch from every rank's (rows, array): a rank fed rows
    (start, stop) of it holds that block; a rank fed no block (rows None)
    holds the whole batch."""
    whole = [a for rows, a in parts if rows is None]
    if whole:
        return whole[0]
    stop = max(rows[1] for rows, _ in parts)
    out = np.empty((stop,) + parts[0][1].shape[1:], parts[0][1].dtype)
    for (start, end), a in parts:
        out[start:end] = a
    return out


def _make_drift_research(cost_store, build_search_ctx, pcg0, spec, rules, cfg,
                         pipeline_seeds: bool = False, pipeline_microbatches: int = 0):
    """The drift monitor's warm re-search: the full plan search again with
    every read of the cost store scaled by the live correction (a fresh
    estimator and context, so every leaf reads the warm store again and
    none is timed), the store's previous scale put back afterwards. It only
    advises: the compiled plan is untouched."""
    from flexflow_tpu_torch.compiler import OptimizerConfig, graph_optimize
    from flexflow_tpu_torch.compiler.unity_algorithm import parallel_degree_summary

    def research(scale):
        t0 = time.perf_counter()
        prev = cost_store.live_scale
        try:
            cost_store.live_scale = scale
            _, ctx = build_search_ctx()
            r = graph_optimize(pcg0, ctx, spec, rules, OptimizerConfig(
                alpha=cfg.search_alpha, budget=cfg.search_budget,
                pipeline_seeds=pipeline_seeds, pipeline_microbatches=pipeline_microbatches))
        finally:
            cost_store.live_scale = prev
        return {"estimated_ms": r.runtime, "seed_runtimes": dict(r.seed_runtimes or {}),
                "parallel_degrees": parallel_degree_summary(r.pcg),
                "research_seconds": time.perf_counter() - t0}

    return research


def _make_drift_transition(pcg, mapping, pcg0, build_search_ctx, spec, mem_budget_bytes,
                           mem_slots, mem_window_k):
    """The drift monitor's transition verifier (the JAX package's
    _drift_transition): a candidate seed's label -> the static TRN verdict
    for swapping the live plan onto it. "searched" is the identity; a seed
    is mapped again on the same machine with a fresh context (warm caches).
    The monitor records a candidate that fails as swap_blocked and never
    marks it actionable."""

    def verdict(label):
        from flexflow_tpu_torch.analysis.transition_analysis import (
            transition_verdict_record,
            verify_transition,
        )
        from flexflow_tpu_torch.compiler.machine_mapping.get_optimal_machine_mapping import (
            MachineMappingCache,
        )
        from flexflow_tpu_torch.compiler.unity_algorithm import enumerate_seeds, evaluate_pcg

        if label == "searched":
            cand_pcg, cand_mapping = pcg, mapping
        else:
            cand = dict(enumerate_seeds(pcg0, spec.num_devices)).get(label)
            if cand is None:
                return None
            _, ctx = build_search_ctx()
            r = evaluate_pcg(cand, ctx, spec, MachineMappingCache())
            if r is None:
                return None
            cand_pcg, cand_mapping = r.pcg, r.machine_mapping
        a, _ = verify_transition(pcg, mapping, cand_pcg, cand_mapping, machine_spec=spec,
                                 hbm_bytes=mem_budget_bytes or None,
                                 optimizer_state_slots=mem_slots,
                                 steps_per_dispatch=mem_window_k)
        return transition_verdict_record(a)

    return verdict


def _rekey(state: dict, keys: Dict[str, str]) -> dict:
    """{"params", "opt_state"} with each parameter key (and each optimizer
    slot's) renamed through `keys`."""
    out = {"params": {keys[k]: v for k, v in state["params"].items()}}
    if state.get("opt_state") is not None:
        out["opt_state"] = {slot: ({keys[k]: t for k, t in v.items()} if isinstance(v, dict)
                                   else v) for slot, v in state["opt_state"].items()}
    return out


def _find_aux_outputs(graph) -> List[DataflowOutput]:
    """The aux-loss outputs, found structurally (so they survive the
    rewrites that rebuild node identity): each secondary output of an
    Experts op with lambda_bal > 0 is its load-balance scalar."""
    aux = []
    for n in graph.topological_ordering():
        attrs = graph.op_attrs(n)
        if isinstance(attrs, ExpertsAttrs) and attrs.lambda_bal > 0:
            aux.extend(graph.outputs_of(n)[1:])
    return aux


def _find_sink_output(graph) -> DataflowOutput:
    """The model output: the unique dataflow output nobody consumes (the
    aux-loss outputs, which the training loss consumes, excluded)."""
    consumed = set(_find_aux_outputs(graph))
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


def _label_tokens(label, batch_dims: int, batch_size: int) -> int:
    """Label elements per step of the global batch: a label's elements per
    sample (past its `batch_dims` leading dims, a window's and the
    batch's) times the global batch (a rank holds only its rows)."""
    if label is None:
        return batch_size
    return int(np.prod(tuple(label.shape[batch_dims:]), dtype=np.int64)) * batch_size


def _perf_from_metric_values(mvals: Dict[str, object]) -> PerfMetrics:
    """PerfMetrics from metric values (tensors are read on the host)."""
    p = PerfMetrics()
    for k, v in mvals.items():
        if hasattr(p, k):
            cur = getattr(p, k)
            setattr(p, k, type(cur)(cur + (int(v) if isinstance(cur, int) else float(v))))
    return p
