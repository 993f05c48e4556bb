"""Name -> class registry for models, pruners, tasks, dataset builders,
processors, LR schedules and runners (the reference's ``registry``,
LAVIS/lavis/common/registry.py). The port keeps
its own instance, so its names never collide with the JAX package's
registrations when both are loaded in one process."""

from __future__ import annotations

from typing import Any, Dict


class Registry:
    _KINDS = ("model", "pruner", "task", "builder", "processor", "lr_scheduler",
              "runner")

    def __init__(self) -> None:
        self._maps: Dict[str, Dict[str, Any]] = {k: {} for k in self._KINDS}

    def register(self, kind: str, name: str, obj: Any = None) -> Any:
        """Register ``obj`` under ``name``; without ``obj``, a decorator."""
        if kind not in self._maps:
            raise KeyError(f"unknown registry kind {kind!r}; valid: {self._KINDS}")

        def _do(o: Any) -> Any:
            self._maps[kind][name] = o
            return o

        return _do if obj is None else _do(obj)

    def get(self, kind: str, name: str) -> Any:
        if kind not in self._maps:
            raise KeyError(f"unknown registry kind {kind!r}")
        if name not in self._maps[kind]:
            known = sorted(self._maps[kind])
            raise KeyError(f"{kind} {name!r} not registered; known: {known}")
        return self._maps[kind][name]

    def list(self, kind: str) -> list:
        return sorted(self._maps[kind])

    def get_model_class(self, name: str) -> Any:
        return self.get("model", name)

    def get_pruner_class(self, name: str) -> Any:
        return self.get("pruner", name)

    def get_processor_class(self, name: str) -> Any:
        return self.get("processor", name)

    def get_lr_scheduler_class(self, name: str) -> Any:
        return self.get("lr_scheduler", name)


registry = Registry()
