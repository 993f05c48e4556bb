"""Evaluation tasks (reference lavis/tasks/__init__.py ``setup_task``): VQA
and GQA, captioning, the language-model tasks, MMLU, (zero-shot)
classification and retrieval."""

from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.tasks import (  # noqa: F401 (they register)
    captioning, classification, lm, mmlu, retrieval, vqa)


def setup_task(name: str, *args, **kwargs):
    """The task registered under ``name``, built with the given arguments
    (a task's model callable)."""
    return registry.get("task", name)(*args, **kwargs)
