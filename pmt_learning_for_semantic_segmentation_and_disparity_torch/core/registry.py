"""Minimal string->factory registries (a copy of the JAX package's)."""
from __future__ import annotations

from typing import Any, Callable, Dict, Iterable


class Registry:
    def __init__(self, name: str):
        self.name = name
        self._items: Dict[str, Callable[..., Any]] = {}

    def register(self, key: str) -> Callable[[Callable], Callable]:
        def deco(fn: Callable) -> Callable:
            if key in self._items:
                raise KeyError(f"{self.name}: duplicate key {key!r}")
            self._items[key] = fn
            return fn

        return deco

    def get(self, key: str) -> Callable[..., Any]:
        try:
            return self._items[key]
        except KeyError:
            raise KeyError(
                f"{self.name}: unknown key {key!r}; have {sorted(self._items)}"
            ) from None

    def __contains__(self, key: str) -> bool:
        return key in self._items

    def keys(self) -> Iterable[str]:
        return self._items.keys()


MODELS = Registry("models")
BACKBONES = Registry("backbones")
