"""Keras-compatible frontend (port of flexflow_tpu/frontends/keras_model.py).

Reference: python/flexflow/keras/ — a self-contained Keras-API-compatible
layer/model family (NOT a tf.keras adapter): layer objects are declarative
specs, `Sequential`/`Model` compile them onto an FFModel, and
fit/evaluate/predict drive the training instance. Same shape here, built on
flexflow_tpu_torch.core.FFModel. A model trains on the card unless it is
given device="cpu" (`Sequential(layers, device="cpu")`).

Usage:
    model = Sequential([
        Dense(512, activation="relu", input_shape=(784,)),
        Dense(10),
    ])
    model.compile(optimizer=SGD(0.01),
                  loss="sparse_categorical_crossentropy",
                  metrics=["accuracy"])
    model.fit(x, y, epochs=2, batch_size=64)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from flexflow_tpu_torch.core import FFConfig, FFModel
from flexflow_tpu_torch.core.ffmodel import _to_numpy
from flexflow_tpu_torch.core.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.kernels.metrics import PerfMetrics
from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.datatype import DataType
from flexflow_tpu_torch.op_attrs.ops import PoolOp

_ACTIVATIONS = {
    None: None,
    "relu": Activation.RELU,
    "sigmoid": Activation.SIGMOID,
    "tanh": Activation.TANH,
    "gelu": Activation.GELU,
}


def _act_of(name):
    if isinstance(name, Activation) or name is None:
        return name
    if name == "softmax":
        return "softmax"  # handled as a trailing softmax layer
    assert name in _ACTIVATIONS, f"unknown activation {name!r}"
    return _ACTIVATIONS[name]


# ---------------------------------------------------------------------------
# layers (declarative specs; reference python/flexflow/keras/layers/)
# ---------------------------------------------------------------------------


class Layer:
    input_shape: Optional[Tuple[int, ...]] = None
    # classes whose build() creates parameters: a second call site of the
    # same instance binds them again (Sequential._build, Model._build)
    has_weights: bool = False

    def build(self, m: FFModel, t):
        raise NotImplementedError

    def __call__(self, inputs):
        """Functional API: calling a layer on symbolic tensors defers the
        application; Model(inputs=..., outputs=...) realizes the DAG."""
        return SymbolicTensor(self, _as_symbolic_list(inputs))


class Input(Layer):
    def __init__(self, shape: Sequence[int], dtype=DataType.FLOAT, name=None):
        self.shape = tuple(shape)
        self.dtype = dtype
        self.name = name


class Dense(Layer):
    has_weights = True

    def __init__(self, units, activation=None, use_bias=True,
                 input_shape=None, name=None):
        self.units = units
        self.activation = _act_of(activation)
        self.use_bias = use_bias
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def build(self, m, t):
        act = self.activation
        soft = act == "softmax"
        out = m.dense(t, self.units, activation=None if soft else act,
                      use_bias=self.use_bias, name=self.name)
        return m.softmax(out) if soft else out


class Conv2D(Layer):
    has_weights = True

    def __init__(self, filters, kernel_size, strides=(1, 1), padding="valid",
                 activation=None, use_bias=True, input_shape=None, name=None):
        self.filters = filters
        ks = (kernel_size, kernel_size) if isinstance(kernel_size, int) else tuple(kernel_size)
        st = (strides, strides) if isinstance(strides, int) else tuple(strides)
        self.kernel_size = ks
        self.strides = st
        self.padding = padding
        self.activation = _act_of(activation)
        self.use_bias = use_bias
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name

    def _pad(self):
        if self.padding == "valid":
            return (0, 0)
        assert self.padding == "same" and self.strides == (1, 1), (
            "same padding requires stride 1"
        )
        return (self.kernel_size[0] // 2, self.kernel_size[1] // 2)

    def build(self, m, t):
        ph, pw = self._pad()
        return m.conv2d(
            t, self.filters, self.kernel_size[0], self.kernel_size[1],
            self.strides[0], self.strides[1], ph, pw,
            activation=self.activation, use_bias=self.use_bias, name=self.name,
        )


class _Pool2D(Layer):
    kind = None

    def __init__(self, pool_size=(2, 2), strides=None, padding="valid",
                 name=None):
        ps = (pool_size, pool_size) if isinstance(pool_size, int) else tuple(pool_size)
        self.pool_size = ps
        self.strides = (
            ps if strides is None
            else ((strides, strides) if isinstance(strides, int) else tuple(strides))
        )
        assert padding == "valid", "only valid padding for pooling"
        self.name = name

    def build(self, m, t):
        return m.pool2d(
            t, self.pool_size[0], self.pool_size[1], self.strides[0],
            self.strides[1], 0, 0, pool_type=PoolOp[self.kind], name=self.name,
        )


class MaxPooling2D(_Pool2D):
    kind = "MAX"


class AveragePooling2D(_Pool2D):
    kind = "AVG"


class Flatten(Layer):
    def __init__(self, name=None):
        self.name = name

    def build(self, m, t):
        return m.flat(t, name=self.name)


class Dropout(Layer):
    def __init__(self, rate, name=None):
        self.rate = rate
        self.name = name

    def build(self, m, t):
        return m.dropout(t, self.rate, name=self.name)


class Embedding(Layer):
    has_weights = True

    def __init__(self, input_dim, output_dim, input_shape=None, name=None):
        self.input_dim = input_dim
        self.output_dim = output_dim
        self.input_shape = tuple(input_shape) if input_shape else None
        self.name = name
        self.dtype = DataType.INT32

    def build(self, m, t):
        return m.embedding(t, self.input_dim, self.output_dim, name=self.name)


class LayerNormalization(Layer):
    has_weights = True

    def __init__(self, epsilon=1e-5, name=None):
        self.epsilon = epsilon
        self.name = name

    def build(self, m, t):
        return m.layer_norm(t, axes=[-1], eps=self.epsilon, name=self.name)


class BatchNormalization(Layer):
    has_weights = True

    def __init__(self, name=None):
        self.name = name

    def build(self, m, t):
        return m.batch_norm(t, relu=False, name=self.name)


class ActivationLayer(Layer):
    def __init__(self, activation, name=None):
        self.activation = activation
        self.name = name

    def build(self, m, t):
        if self.activation == "softmax":
            return m.softmax(t, name=self.name)
        fn = {"relu": m.relu, "sigmoid": m.sigmoid, "tanh": m.tanh,
              "gelu": m.gelu}[self.activation]
        return fn(t, name=self.name)


# keras exports the class as Activation; keep both names usable
KerasActivation = ActivationLayer


# ---------------------------------------------------------------------------
# optimizers (keras-style names; reference python/flexflow/keras/optimizers.py)
# ---------------------------------------------------------------------------


def SGD(learning_rate=0.01, momentum=0.0, nesterov=False):
    return SGDOptimizer(lr=learning_rate, momentum=momentum, nesterov=nesterov)


def Adam(learning_rate=0.001, beta_1=0.9, beta_2=0.999, epsilon=1e-8):
    return AdamOptimizer(alpha=learning_rate, beta1=beta_1, beta2=beta_2,
                         epsilon=epsilon)


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------


class Sequential:
    """reference python/flexflow/keras/models/sequential.py."""

    def __init__(self, layers: Optional[List[Layer]] = None,
                 ffconfig: Optional[FFConfig] = None, device=None):
        self.layers: List[Layer] = []
        self.ffconfig = ffconfig or FFConfig()
        self.device = device  # FFModel's: the card unless "cpu"
        self.ffmodel: Optional[FFModel] = None
        self.stop_training = False
        self._perf_total = PerfMetrics()
        for l in layers or []:
            self.add(l)

    def add(self, layer: Layer) -> None:
        self.layers.append(layer)

    def _build(self, batch_size: int):
        m = FFModel(self.ffconfig, device=self.device)
        layers = list(self.layers)
        first = layers[0]
        if isinstance(first, Input):
            shape, dtype = first.shape, first.dtype
            layers = layers[1:]
        else:
            assert first.input_shape is not None, (
                "first layer needs input_shape= (or start with Input(...))"
            )
            shape = first.input_shape
            dtype = getattr(first, "dtype", DataType.FLOAT)
        t = m.create_tensor([batch_size, *shape], dtype=dtype, name="input")
        built_weighted = {}
        for l in layers:
            if l.has_weights and id(l) in built_weighted:
                # keras shared-weight contract: the same layer instance
                # appearing again binds its EXISTING parameters (gradients
                # accumulate through the fanned-out weight nodes)
                with m._builder.reuse_weights(built_weighted[id(l)]):
                    t = l.build(m, t)
                continue
            if l.has_weights:
                mark = len(m._builder.weight_log)
                t = l.build(m, t)
                built_weighted[id(l)] = list(m._builder.weight_log[mark:])
                continue
            t = l.build(m, t)
        self.ffmodel = m
        return t

    def compile(self, optimizer="sgd", loss="sparse_categorical_crossentropy",
                metrics=(), batch_size: Optional[int] = None):
        self._pending = (optimizer, loss, tuple(metrics))
        self._batch_size = batch_size or self.ffconfig.batch_size

    def _materialize(self):
        if self.ffmodel is None:
            optimizer, loss, metrics = self._pending
            if optimizer == "sgd":
                optimizer = SGD()
            elif optimizer == "adam":
                optimizer = Adam()
            logits = self._build(self._batch_size)
            self.ffmodel.compile(optimizer, loss, metrics=metrics,
                                 logit_tensor=logits)

    def fit(self, x, y, epochs=1, batch_size=None, shuffle=True, verbose=True,
            callbacks=None):
        if batch_size is not None:
            self._batch_size = batch_size
        self._materialize()
        if not callbacks:
            perf = self.ffmodel.fit(x=x, y=y, epochs=epochs,
                                    batch_size=self._batch_size,
                                    shuffle=shuffle, verbose=verbose)
            self._accumulate(perf)
            return perf
        # callback-driven epoch loop (reference keras fit with callbacks).
        # epoch_offset decorrelates shuffle order and the step RNG across
        # the per-epoch fit calls; run_perf matches the no-callback path's
        # all-epoch accumulation.
        self.stop_training = False
        for cb in callbacks:
            cb.set_model(self)
        for cb in callbacks:
            cb.on_train_begin()
        run_perf = PerfMetrics()
        for epoch in range(epochs):
            for cb in callbacks:
                cb.on_epoch_begin(epoch)
            perf = self.ffmodel.fit(x=x, y=y, epochs=1,
                                    batch_size=self._batch_size,
                                    shuffle=shuffle, verbose=verbose,
                                    epoch_offset=epoch)
            self._accumulate(perf)
            run_perf.update(perf)
            logs = {"accuracy": perf.accuracy}
            for cb in callbacks:
                cb.on_epoch_end(epoch, logs)
            if self.stop_training:
                break
        for cb in callbacks:
            cb.on_train_end()
        return run_perf

    def _accumulate(self, perf) -> None:
        self._perf_total.update(perf)

    def get_perf_metrics(self):
        """Cumulative metrics across fit calls (reference
        FFModel.get_perf_metrics, consumed by VerifyMetrics callbacks)."""
        return self._perf_total

    def set_learning_rate(self, lr: float) -> None:
        self._materialize()
        self.ffmodel.set_learning_rate(lr)

    def evaluate(self, x, y, batch_size=None):
        self._materialize()
        return self.ffmodel.eval(x=x, y=y,
                                 batch_size=batch_size or self._batch_size)

    def predict(self, x, batch_size=None) -> np.ndarray:
        self._materialize()
        bs = batch_size or self._batch_size
        it = self.ffmodel._make_iterator(x, None, bs, shuffle=False)
        outs = []
        for batch, _ in it:
            outs.append(_to_numpy(
                self.ffmodel.instance.forward(self.ffmodel.params, batch)
            ))
        return np.concatenate(outs, axis=0)

    def summary(self) -> str:
        return "\n".join(
            f"{type(l).__name__}" for l in self.layers
        )


# ---------------------------------------------------------------------------
# merge layers + functional API (reference python/flexflow/keras/layers/
# merge.py and keras/models/model.py)
# ---------------------------------------------------------------------------


class SymbolicTensor:
    """A deferred layer application in the functional API: calling a Layer
    on tensors records (layer, inputs); Model realizes the DAG at build."""

    def __init__(self, layer, inputs):
        self.layer = layer
        self.inputs = list(inputs)


def _as_symbolic_list(inputs):
    if isinstance(inputs, (list, tuple)):
        return list(inputs)
    return [inputs]


class _Merge(Layer):
    def build_merge(self, m, ts):
        raise NotImplementedError


class Concatenate(_Merge):
    def __init__(self, axis=1, name=None):
        self.axis = axis
        self.name = name

    def build_merge(self, m, ts):
        return m.concat(ts, self.axis, name=self.name)


class _Binary(_Merge):
    op = None

    def __init__(self, name=None):
        self.name = name

    def build_merge(self, m, ts):
        out = ts[0]
        for t in ts[1:]:
            out = getattr(m, self.op)(out, t, name=self.name)
        return out


class Add(_Binary):
    op = "add"


class Subtract(_Binary):
    op = "subtract"


class Multiply(_Binary):
    op = "multiply"


class Maximum(_Binary):
    op = "max"


def concatenate(input_tensors, axis=1):
    return Concatenate(axis=axis)(input_tensors)


def add(input_tensors):
    return Add()(input_tensors)


def subtract(input_tensors):
    return Subtract()(input_tensors)


def multiply(input_tensors):
    return Multiply()(input_tensors)


# ---------------------------------------------------------------------------
# callbacks (reference python/flexflow/keras/callbacks.py)
# ---------------------------------------------------------------------------


class Callback:
    def __init__(self):
        self.model = None
        self.params = None

    def set_params(self, params):
        self.params = params

    def set_model(self, model):
        self.model = model

    def on_epoch_begin(self, epoch, logs=None):
        pass

    def on_epoch_end(self, epoch, logs=None):
        pass

    def on_train_begin(self, logs=None):
        pass

    def on_train_end(self, logs=None):
        pass


class LearningRateScheduler(Callback):
    """reference callbacks.py:49: schedule(epoch) -> lr, applied at each
    epoch begin (here via FFModel.set_learning_rate, which drops the
    captured windows)."""

    def __init__(self, schedule):
        super().__init__()
        self.schedule = schedule

    def on_epoch_begin(self, epoch, logs=None):
        lr = self.schedule(epoch)
        if not isinstance(lr, float):
            raise ValueError(
                'The output of the "schedule" function should be float.'
            )
        self.model.set_learning_rate(lr)


def _accuracy_value(accuracy):
    return accuracy.value if hasattr(accuracy, "value") else float(accuracy)


class VerifyMetrics(Callback):
    """reference callbacks.py:64: assert final accuracy >= threshold."""

    def __init__(self, accuracy):
        super().__init__()
        self.accuracy = _accuracy_value(accuracy)

    def on_train_end(self, logs=None):
        accuracy = self.model.get_perf_metrics().accuracy
        assert accuracy >= self.accuracy, (
            f"Accuracy is wrong: {accuracy} < {self.accuracy}"
        )


class EpochVerifyMetrics(Callback):
    """reference callbacks.py:75: stop training early once the epoch
    accuracy exceeds the target."""

    def __init__(self, accuracy, early_stop=True):
        super().__init__()
        self.accuracy = _accuracy_value(accuracy)
        self.early_stop = early_stop

    def on_epoch_end(self, epoch, logs=None):
        if not self.early_stop:
            return
        if (logs or {}).get("accuracy", 0.0) > self.accuracy:
            self.model.stop_training = True


class Model(Sequential):
    """Functional-API model: Model(inputs=[Input(...)...], outputs=sym)
    (reference keras/models/model.py). Shares compile/fit/evaluate/predict
    with Sequential; only graph construction differs."""

    def __init__(self, inputs, outputs, ffconfig: Optional[FFConfig] = None,
                 device=None):
        super().__init__(ffconfig=ffconfig, device=device)
        self.inputs = _as_symbolic_list(inputs)
        assert not isinstance(outputs, (list, tuple)), (
            "multi-output functional models are not supported yet"
        )
        self.outputs = outputs
        for i in self.inputs:
            assert isinstance(i, Input), "Model inputs must be Input layers"

    def _build(self, batch_size: int):
        m = FFModel(self.ffconfig, device=self.device)
        env = {}
        built_weighted = {}  # weighted layer id -> its weight tensors
        for i, inp in enumerate(self.inputs):
            env[id(inp)] = m.create_tensor(
                [batch_size, *inp.shape], dtype=inp.dtype,
                name=inp.name or f"input{i}",
            )

        def realize(sym):
            if isinstance(sym, Input):
                return env[id(sym)]
            key = id(sym)
            if key in env:
                return env[key]
            vals = [realize(s) for s in sym.inputs]
            layer = sym.layer
            if isinstance(layer, _Merge):
                out = layer.build_merge(m, vals)
            else:
                assert len(vals) == 1, (
                    f"{type(layer).__name__} takes one input; use a merge "
                    "layer to combine tensors"
                )
                if layer.has_weights and id(layer) in built_weighted:
                    # keras shared-weight contract: a layer applied at
                    # several call sites owns ONE set of parameters;
                    # gradients accumulate through the shared weight nodes
                    with m._builder.reuse_weights(built_weighted[id(layer)]):
                        out = layer.build(m, vals[0])
                elif layer.has_weights:
                    mark = len(m._builder.weight_log)
                    out = layer.build(m, vals[0])
                    built_weighted[id(layer)] = list(
                        m._builder.weight_log[mark:]
                    )
                else:
                    out = layer.build(m, vals[0])
            env[key] = out
            return out

        logits = realize(self.outputs)
        self.ffmodel = m
        return logits
