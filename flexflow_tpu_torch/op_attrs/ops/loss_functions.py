"""Loss function attrs (copy of flexflow_tpu/op_attrs/ops/loss_functions.py)."""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Union


class LossFunction(enum.Enum):
    CATEGORICAL_CROSSENTROPY = "categorical_crossentropy"
    SPARSE_CATEGORICAL_CROSSENTROPY = "sparse_categorical_crossentropy"
    MEAN_SQUARED_ERROR = "mean_squared_error"
    MEAN_ABSOLUTE_ERROR = "mean_absolute_error"
    IDENTITY = "identity"


@dataclass(frozen=True)
class SparseCategoricalCrossEntropyLossAttrs:
    replace_labels: bool = False

    @property
    def loss_type(self) -> LossFunction:
        return LossFunction.SPARSE_CATEGORICAL_CROSSENTROPY


@dataclass(frozen=True)
class NonconfigurableLossAttrs:
    loss_type: LossFunction


LossAttrs = Union[SparseCategoricalCrossEntropyLossAttrs, NonconfigurableLossAttrs]


def loss_attrs_for(fn: LossFunction) -> LossAttrs:
    if fn == LossFunction.SPARSE_CATEGORICAL_CROSSENTROPY:
        return SparseCategoricalCrossEntropyLossAttrs()
    return NonconfigurableLossAttrs(fn)
