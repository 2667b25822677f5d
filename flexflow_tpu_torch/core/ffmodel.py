"""The FFModel user API on one device: build, compile, fit, eval, and the
stepped forward/backward/update loop (port of flexflow_tpu/core/ffmodel.py,
its single-device part).

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
replay a window), fed by the windowed input pipeline. What reaches a slice
that is not ported yet raises NotImplementedError naming it, at the call:
the layer methods of unported ops (A2), more than one device (A7, with a
search budget too: the plan's parallel ops are not lowered yet), checkpoints, recompiles and fit-loop supervision (A8),
telemetry, traces and plan audits (A9), sub-mesh branches (A10).
"""

from __future__ import annotations

import dataclasses
import enum
import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from flexflow_tpu_torch.core.dataloader import BatchIterator, WindowedBatchIterator
from flexflow_tpu_torch.core.optimizers import optimizer_attrs_of
from flexflow_tpu_torch.kernels.loss import loss_forward
from flexflow_tpu_torch.kernels.metrics import PerfMetrics, compute_metrics
from flexflow_tpu_torch.local_execution.config import FFConfig
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
from flexflow_tpu_torch.runtime.fault import active_schedule
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
        # fit's generator, reseeded by each fit: one object, so that the
        # fused windows' CUDA graphs, which register it, outlive a fit
        self._rng: Optional[torch.Generator] = None

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
    batch_matmul = _unported("batch_matmul", "BatchMatmul")
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

    def _read_tensor(self, handle: DataflowOutput) -> np.ndarray:
        n = self._weight_node_of(handle)
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
        if ndev > 1 and cfg.search_budget > 0 and not cfg.only_data_parallel:
            # the search itself is ported (flexflow_tpu_torch.compiler); what
            # is missing is lowering its plan's parallel ops
            raise NotImplementedError(
                f"a searched compile over {ndev} devices needs the searched "
                "plan's parallel ops lowered, not ported yet (A7); "
                "set max_devices=1 to compile for one")
        if ndev > 1:
            raise NotImplementedError(
                f"a compile over {ndev} devices is not ported yet (A7); "
                "set max_devices=1 to compile for one")
        self.invalidate_graphs()
        self.instance = ModelTrainingInstance(
            self.cg, logit, self.loss_attrs, self.optimizer_attrs,
            compute_dtype=compute_dtype, device=self.device, metrics=self.metrics,
            aux_loss_tensors=self._aux_loss_tensors,
        )
        self.params, self.opt_state = self.instance.initialize(seed=cfg.seed)
        self._step_count = 0
        self._backing = None

    def _device_count(self) -> int:
        """The devices a compile would span, as the JAX package counts them:
        the visible ones of the model's kind, capped by max_devices, and cut
        to the largest count that divides the first input's batch."""
        ndev = torch.cuda.device_count() if self.device.type == "cuda" else 1
        if self.config.max_devices > 0:
            ndev = min(ndev, self.config.max_devices)
        inputs = [n for n in self.cg.topological_ordering()
                  if isinstance(self.cg.op_attrs(n), InputAttrs)]
        if inputs:
            batch = self.cg.tensor_shape(self.cg.outputs_of(inputs[0])[0]).dims[0]
            while ndev > 1 and batch % ndev:
                ndev -= 1
        return ndev

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
        unported = (
            (bool(cfg.checkpoint_dir), "checkpoint_dir (fit-loop checkpointing)", "A8"),
            (cfg.watchdog_factor > 0, "watchdog_factor (the window watchdog)", "A8"),
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
            print("[flexflow_tpu_torch] search_overlap_backward_update: off — the step runs "
                  "the backward, then the update")
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

    def _make_iterator(self, x, y, batch_size, shuffle=False, seed_offset: int = 0) -> BatchIterator:
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
        return BatchIterator(inputs, label, batch_size, device=self.device, shuffle=shuffle,
                             seed=self.config.seed + seed_offset)

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
        that form one run."""
        self._require_compiled()
        if recompile_state is not None:
            raise NotImplementedError("fit(recompile_state=...): recompiles are not ported yet (A8)")
        if checkpoint_dir or checkpoint_every_n_steps or resume:
            raise NotImplementedError("fit-loop checkpointing and resume are not ported yet (A8)")
        if os.environ.get("FF_TPU_WATCHDOG") or active_schedule() is not None:
            raise NotImplementedError(
                "FF_TPU_WATCHDOG / FF_TPU_FAULT_SPEC: the fit loop's supervision is not "
                "ported yet (A8)")
        epochs = epochs or self.config.epochs
        batch_size = batch_size or self.config.batch_size
        it = self._make_iterator(x, y, batch_size, shuffle=shuffle, seed_offset=epoch_offset)
        if self._rng is None:
            self._rng = torch.Generator(device=self.device)
        rng = self._rng.manual_seed(self.config.seed * 1_000_003 + epoch_offset)
        return self._fit_epochs(epochs, batch_size, verbose, it, rng)

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

    def _fit_epochs(self, epochs, batch_size, verbose, it, rng) -> PerfMetrics:
        """The per-step loop, or with steps_per_dispatch = K > 1 the windowed
        one: each window of K batches (the epoch's tail a smaller one)
        trains through one multi_train_step, its input gathered and copied
        while the window before it runs."""
        start = time.perf_counter()
        num_samples = 0
        loss = None
        macc: Optional[Dict[str, object]] = None
        pf = self.config.print_freq if verbose else 0
        k = self._effective_steps_per_dispatch()
        windows = WindowedBatchIterator(it, k) if k > 1 else None
        try:
            for epoch in range(epochs):
                if windows is not None:
                    for inputs_stack, label_stack, kk in windows:
                        loss, macc = self._run_fused_window(
                            inputs_stack, label_stack, kk, rng, macc, pf, epoch)
                        num_samples += batch_size * kk
                    continue
                for batch, label in it:
                    self.params, self.opt_state, loss, mvals = self.instance.train_step(
                        self.params, self.opt_state, batch, label, rng)
                    self._step_count += 1
                    num_samples += batch_size
                    macc = mvals if macc is None else {key: macc[key] + v
                                                      for key, v in mvals.items()}
                    if pf and self._step_count % pf == 0:
                        print(f"epoch {epoch} step {self._step_count}: loss {float(loss):.4f}")
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
            perf.update(_perf_from_metric_values(compute_metrics(metrics, logit, label)))
        return perf

    # ------------------------------------------------------------------
    # stepped execution (reference forward/backward/update/zero_gradients)
    # ------------------------------------------------------------------

    def _ensure_backing(self) -> LocalTrainingBacking:
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
    # checkpoint / resume (A8)
    # ------------------------------------------------------------------

    def save_checkpoint(self, directory: str, max_to_keep: int = 3) -> str:
        raise NotImplementedError("FFModel.save_checkpoint: checkpoints are not ported yet (A8)")

    def load_checkpoint(self, directory: str, step: Optional[int] = None) -> int:
        raise NotImplementedError("FFModel.load_checkpoint: checkpoints are not ported yet (A8)")

    def recompile(self, preserve_resume: bool = False) -> None:
        raise NotImplementedError("FFModel.recompile: recompiles are not ported yet (A8)")


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
