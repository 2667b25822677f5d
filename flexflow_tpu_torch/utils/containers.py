"""Container algorithms (trimmed copy of flexflow_tpu/utils/containers.py):
``get_all_assignments`` (reference: containers/get_all_assignments.h), which
enumerates machine-view assignments for SP-split boundary layers in the
machine-mapping DP.
"""

from __future__ import annotations

import itertools
from typing import Dict, Hashable, Iterable, Iterator, Mapping, TypeVar

K = TypeVar("K", bound=Hashable)
V = TypeVar("V")


def get_all_assignments(options: Mapping[K, Iterable[V]]) -> Iterator[Dict[K, V]]:
    """All total assignments choosing one value per key.

    get_all_assignments({a: [1,2], b: [3]}) -> {a:1,b:3}, {a:2,b:3}.
    An empty mapping yields the single empty assignment (matching the
    reference's semantics, which makes the DP's no-boundary case cost out).
    """
    keys = list(options.keys())
    value_lists = [list(options[k]) for k in keys]
    for combo in itertools.product(*value_lists):
        yield dict(zip(keys, combo))
