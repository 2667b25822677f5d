"""Host-side data loading (trimmed copy of flexflow_tpu/core/dataloader.py:
SingleDataLoader and BatchIterator).

The full dataset lives in host memory and each batch is copied to the
device as it is drawn, where the JAX package `device_put`s it with the
input's sharding. Shuffling draws the same `np.random.RandomState(seed)`
permutation per epoch, so a shuffled run sees the JAX package's batches in
the JAX package's order. The copy is a plain `torch.as_tensor` from
pageable memory, which blocks the host; pinned buffers on a side stream and
the windowed iterator come with the step windows (A5 part 2), resume
cursors with checkpointing (A8).
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional

import numpy as np
import torch

from flexflow_tpu_torch.local_execution.training_backing import resolve_device


class SingleDataLoader:
    """Full-dataset host buffer -> per-batch device tensors for ONE tensor.

    device: the batches' device; None takes the model's, else CUDA (see
    resolve_device)."""

    def __init__(
        self,
        ffmodel,
        full_array: np.ndarray,
        batch_size: int,
        device=None,
        shuffle: bool = False,
        drop_last: bool = True,
        seed: int = 0,
    ) -> None:
        self.ffmodel = ffmodel
        self.data = np.asarray(full_array)
        self.batch_size = int(batch_size)
        if device is None and ffmodel is not None:
            device = ffmodel.device
        self.device = resolve_device(device)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rs = np.random.RandomState(seed)
        self.num_samples = self.data.shape[0]
        if drop_last:
            self.num_batches = self.num_samples // self.batch_size
        else:
            self.num_batches = -(-self.num_samples // self.batch_size)
        self.reset()

    def reset(self) -> None:
        self._next = 0
        self._order = np.arange(self.num_samples)
        if self.shuffle:
            self._rs.shuffle(self._order)

    def next_batch_host(self) -> np.ndarray:
        """Host array for the next batch (wraps around at epoch end)."""
        if self._next >= self.num_batches:
            self.reset()
        i = self._next * self.batch_size
        batch = self.data[self._order[i : i + self.batch_size]]
        self._next += 1
        return batch

    def next_batch(self) -> torch.Tensor:
        """Device tensor for the next batch (wraps around at epoch end)."""
        return torch.as_tensor(self.next_batch_host(), device=self.device)

    def __iter__(self) -> Iterator[torch.Tensor]:
        self.reset()
        for _ in range(self.num_batches):
            yield self.next_batch()


class BatchIterator:
    """Zips named arrays into per-step (inputs_dict, label) batches on
    `device`; every tensor advances in lockstep, through one shared
    permutation per epoch."""

    def __init__(
        self,
        inputs: Dict[str, np.ndarray],
        label: Optional[np.ndarray],
        batch_size: int,
        device=None,
        shuffle: bool = False,
        seed: int = 0,
    ) -> None:
        ns = {a.shape[0] for a in inputs.values()}
        if label is not None:
            ns.add(label.shape[0])
        if len(ns) != 1:
            raise ValueError(f"inconsistent sample counts: {ns}")
        self.num_samples = ns.pop()
        self.batch_size = int(batch_size)
        self.num_batches = self.num_samples // self.batch_size
        self.device = resolve_device(device)
        self.loaders = {
            k: SingleDataLoader(None, v, batch_size, device=self.device, seed=seed)
            for k, v in inputs.items()
        }
        self.label_loader = (
            SingleDataLoader(None, label, batch_size, device=self.device)
            if label is not None
            else None
        )
        self.shuffle = shuffle
        self._rs = np.random.RandomState(seed)

    def reset(self) -> None:
        order = np.arange(self.num_samples)
        if self.shuffle:
            self._rs.shuffle(order)
        for dl in [*self.loaders.values(), self.label_loader]:
            if dl is not None:
                dl.reset()
                dl._order = order

    def __iter__(self):
        self.reset()
        for _ in range(self.num_batches):
            batch = {k: dl.next_batch() for k, dl in self.loaders.items()}
            label = self.label_loader.next_batch() if self.label_loader is not None else None
            yield batch, label
