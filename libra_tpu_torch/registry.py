"""Global name -> class registry.

The PyTorch port's copy of ``libra_tpu/registry.py``: models, dataset
builders and processors register under the string names that run
configs use. An unknown name raises at once with the registered options.
"""

from __future__ import annotations

from typing import Any, Callable, Dict


class Registry:
    def __init__(self):
        self._tables: Dict[str, Dict[str, Any]] = {
            "model": {}, "builder": {}, "processor": {}, "task": {},
        }

    def _register(self, table: str, name: str) -> Callable:
        def deco(cls):
            existing = self._tables[table].get(name)
            if existing is not None and existing is not cls:
                raise KeyError(f"{table} {name!r} already registered "
                               f"to {existing}")
            self._tables[table][name] = cls
            return cls
        return deco

    def register_model(self, name: str) -> Callable:
        return self._register("model", name)

    def register_builder(self, name: str) -> Callable:
        return self._register("builder", name)

    def register_processor(self, name: str) -> Callable:
        return self._register("processor", name)

    def _get(self, table: str, name: str):
        try:
            return self._tables[table][name]
        except KeyError:
            raise KeyError(
                f"unknown {table} {name!r}; registered: "
                f"{sorted(self._tables[table])}") from None

    def get_model_class(self, name: str):
        return self._get("model", name)

    def get_builder_class(self, name: str):
        return self._get("builder", name)

    def get_processor_class(self, name: str):
        return self._get("processor", name)

    def list(self, table: str):
        return sorted(self._tables[table])


registry = Registry()
