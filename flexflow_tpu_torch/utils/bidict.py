"""Bidirectional dictionary (copy of flexflow_tpu/utils/bidict.py; reference:
lib/utils/include/utils/bidict/)."""

from __future__ import annotations

from typing import Dict, Generic, Hashable, Iterator, Mapping, Tuple, TypeVar

L = TypeVar("L", bound=Hashable)
R = TypeVar("R", bound=Hashable)


class bidict(Generic[L, R]):
    def __init__(self, items: Mapping[L, R] = None) -> None:
        self._fwd: Dict[L, R] = {}
        self._bwd: Dict[R, L] = {}
        if items:
            for l, r in items.items():
                self.put(l, r)

    def put(self, l: L, r: R) -> None:
        if l in self._fwd or r in self._bwd:
            if l in self._fwd and self._fwd[l] == r:
                return
            raise ValueError(f"bidict conflict inserting ({l!r}, {r!r})")
        self._fwd[l] = r
        self._bwd[r] = l

    def at_l(self, l: L) -> R:
        return self._fwd[l]

    def at_r(self, r: R) -> L:
        return self._bwd[r]

    def __contains__(self, l: L) -> bool:
        return l in self._fwd

    def contains_r(self, r: R) -> bool:
        return r in self._bwd

    def __len__(self) -> int:
        return len(self._fwd)

    def __iter__(self) -> Iterator[Tuple[L, R]]:
        return iter(self._fwd.items())

    def forward(self) -> Dict[L, R]:
        return dict(self._fwd)

    def backward(self) -> Dict[R, L]:
        return dict(self._bwd)

    def inverse(self) -> "bidict[R, L]":
        b: bidict = bidict()
        b._fwd = dict(self._bwd)
        b._bwd = dict(self._fwd)
        return b

    def __eq__(self, other: object) -> bool:
        return isinstance(other, bidict) and self._fwd == other._fwd

    def __repr__(self) -> str:
        return f"bidict({self._fwd!r})"
