"""Small string-keyed component registry.

Components are wired by string (backbone names, ``rnn_type``,
``sampling_method``, ``classif_mode``) and resolved through explicit
registries, so a misspelling fails with the list of valid options.
"""

from __future__ import annotations

from typing import Dict, Generic, TypeVar

T = TypeVar("T")


class Registry(Generic[T]):
    def __init__(self, kind: str):
        self.kind = kind
        self._items: Dict[str, T] = {}

    def register(self, name: str, item: T | None = None):
        if item is not None:
            self._items[name] = item
            return item

        def deco(fn: T) -> T:
            self._items[name] = fn
            return fn

        return deco

    def get(self, name: str) -> T:
        try:
            return self._items[name]
        except KeyError:
            raise KeyError(
                f"Unknown {self.kind} '{name}'. Available: {sorted(self._items)}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._items

    def names(self):
        return sorted(self._items)
