"""Evaluation tasks (reference lavis/tasks/__init__.py ``setup_task``): VQA
and GQA, captioning, and the language-model tasks. Classification,
retrieval and MMLU wait for their model families."""

from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.tasks import captioning, lm, vqa  # noqa: F401 (they register)


def setup_task(name: str, *args, **kwargs):
    """The task registered under ``name``, built with the given arguments
    (a task's model callable)."""
    return registry.get("task", name)(*args, **kwargs)
