"""The user-facing core API on one device (port of flexflow_tpu/core).

>>> from flexflow_tpu_torch.core import Activation, FFConfig, FFModel, SGDOptimizer
>>> ffmodel = FFModel(FFConfig(batch_size=64))  # device="cpu" on a host without a card
>>> x = ffmodel.create_tensor([64, 784])
>>> t = ffmodel.dense(x, 512, activation=Activation.RELU)
>>> out = ffmodel.dense(t, 10)
>>> ffmodel.compile(SGDOptimizer(lr=0.01), "sparse_categorical_crossentropy",
...                 metrics=["accuracy"])
>>> ffmodel.fit(x=images, y=labels, epochs=1)
"""

from flexflow_tpu_torch.core.dataloader import (
    BatchIterator,
    SingleDataLoader,
    WindowedBatchIterator,
)
from flexflow_tpu_torch.core.ffmodel import (
    CompMode,
    FFModel,
    LossType,
    Parameter,
    Tensor,
)
from flexflow_tpu_torch.core.initializers import (
    ConstantInitializer,
    GlorotNormalInitializer,
    GlorotUniformInitializer,
    NormInitializer,
    TruncatedNormalInitializer,
    UniformInitializer,
    ZeroInitializer,
)
from flexflow_tpu_torch.core.optimizers import AdamOptimizer, SGDOptimizer
from flexflow_tpu_torch.local_execution.config import FFConfig
from flexflow_tpu_torch.op_attrs.activation import Activation
from flexflow_tpu_torch.op_attrs.datatype import DataType

__all__ = [
    "Activation",
    "AdamOptimizer",
    "BatchIterator",
    "CompMode",
    "ConstantInitializer",
    "DataType",
    "FFConfig",
    "FFModel",
    "GlorotNormalInitializer",
    "GlorotUniformInitializer",
    "LossType",
    "NormInitializer",
    "Parameter",
    "SGDOptimizer",
    "SingleDataLoader",
    "Tensor",
    "TruncatedNormalInitializer",
    "UniformInitializer",
    "WindowedBatchIterator",
    "ZeroInitializer",
]
