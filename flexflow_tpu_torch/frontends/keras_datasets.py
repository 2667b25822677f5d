"""Keras-style dataset loaders (copy of
flexflow_tpu/frontends/keras_datasets.py; reference
python/flexflow/keras/datasets/: mnist.py, cifar10.py, reuters.py).

The reference downloads into ~/.keras/datasets via get_file; these loaders
never download: they read the SAME cache layout ($KERAS_HOME/datasets,
~/.keras/datasets by default) and raise a clear error naming the canonical
origin when a file is absent (drop a pre-downloaded copy into the cache to
use them).
"""

from __future__ import annotations

import json
import os
import pickle
import tarfile

import numpy as np


def _keras_cache() -> str:
    base = os.environ.get("KERAS_HOME", os.path.expanduser("~/.keras"))
    return os.path.join(base, "datasets")


def get_file(fname: str, origin: str) -> str:
    """Resolve a dataset file in the keras cache (no-download analogue of
    keras.utils.data_utils.get_file)."""
    path = os.path.join(_keras_cache(), fname)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"dataset file {path} not found, and the loaders never "
            f"download; place a copy (canonical origin: {origin}) into "
            "the cache directory"
        )
    return path


class mnist:
    @staticmethod
    def load_data(path: str = "mnist.npz"):
        """(x_train, y_train), (x_test, y_test) — reference
        keras/datasets/mnist.py."""
        path = get_file(
            path, origin="https://s3.amazonaws.com/img-datasets/mnist.npz"
        )
        with np.load(path, allow_pickle=True) as f:
            return (f["x_train"], f["y_train"]), (f["x_test"], f["y_test"])


class cifar10:
    @staticmethod
    def load_data():
        """(x_train, y_train), (x_test, y_test) in NCHW uint8 — reference
        keras/datasets/cifar10.py (cifar-10-batches-py layout, from either
        the extracted directory or the original tar.gz)."""
        origin = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
        dirname = os.path.join(_keras_cache(), "cifar-10-batches-py")
        if not os.path.isdir(dirname):
            tar = get_file("cifar-10-python.tar.gz", origin=origin)
            with tarfile.open(tar) as f:
                # filter="data": refuse path-traversal members in a crafted
                # tarball (and silence the 3.12+ DeprecationWarning)
                f.extractall(_keras_cache(), filter="data")

        def load_batch(fpath):
            with open(fpath, "rb") as f:
                d = pickle.load(f, encoding="bytes")
            data = d[b"data"].reshape(-1, 3, 32, 32)
            labels = np.asarray(d[b"labels"])
            return data, labels

        xs, ys = [], []
        for i in range(1, 6):
            x, y = load_batch(os.path.join(dirname, f"data_batch_{i}"))
            xs.append(x)
            ys.append(y)
        x_train = np.concatenate(xs)
        y_train = np.concatenate(ys)
        x_test, y_test = load_batch(os.path.join(dirname, "test_batch"))
        return (x_train, y_train), (x_test, y_test)


class reuters:
    @staticmethod
    def load_data(
        path: str = "reuters.npz",
        num_words=None,
        skip_top: int = 0,
        test_split: float = 0.2,
        seed: int = 113,
        start_char: int = 1,
        oov_char: int = 2,
        index_from: int = 3,
    ):
        """(x_train, y_train), (x_test, y_test) of word-index sequences —
        reference keras/datasets/reuters.py."""
        path = get_file(
            path,
            origin="https://s3.amazonaws.com/text-datasets/reuters.npz",
        )
        with np.load(path, allow_pickle=True) as f:
            xs, labels = f["x"], f["y"]
        rs = np.random.RandomState(seed)
        indices = np.arange(len(xs))
        rs.shuffle(indices)
        xs = xs[indices]
        labels = labels[indices]
        xs = [[start_char] + [w + index_from for w in x] for x in xs]
        if num_words is None:
            num_words = max(max(x) for x in xs)
        if oov_char is not None:
            xs = [
                [w if skip_top <= w < num_words else oov_char for w in x]
                for x in xs
            ]
        else:
            # keras semantics: with no oov marker, out-of-range words are
            # DROPPED rather than replaced
            xs = [[w for w in x if skip_top <= w < num_words] for x in xs]
        split = int(len(xs) * (1.0 - test_split))
        return (
            (np.asarray(xs[:split], dtype=object), labels[:split]),
            (np.asarray(xs[split:], dtype=object), labels[split:]),
        )

    @staticmethod
    def get_word_index(path: str = "reuters_word_index.json"):
        path = get_file(
            path,
            origin=(
                "https://s3.amazonaws.com/text-datasets/"
                "reuters_word_index.json"
            ),
        )
        with open(path) as f:
            return json.load(f)
