"""Name → factory registries.

Replaces the reference's import-time factories
(ref: lib/networks/factory.py:22-51, lib/datasets/factory.py:26-120)
with explicit registries so models/datasets are constructed lazily
from config rather than at module import.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Registry:
    def __init__(self, kind: str):
        self._kind = kind
        self._entries: Dict[str, Callable[..., Any]] = {}

    def register(self, name: str, factory: Callable[..., Any] | None = None):
        if factory is not None:
            self._entries[name] = factory
            return factory

        def deco(fn):
            self._entries[name] = fn
            return fn

        return deco

    def get(self, name: str) -> Callable[..., Any]:
        if name not in self._entries:
            raise KeyError(
                f"unknown {self._kind} '{name}'; known: {sorted(self._entries)}"
            )
        return self._entries[name]

    def create(self, name: str, *args, **kwargs) -> Any:
        return self.get(name)(*args, **kwargs)

    def names(self) -> Iterable[str]:
        return sorted(self._entries)

    def __contains__(self, name: str) -> bool:
        return name in self._entries


DATASETS = Registry("dataset")
