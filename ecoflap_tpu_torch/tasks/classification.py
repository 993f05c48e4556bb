"""Multimodal and zero-shot classification (accuracy); port of
``ecoflap_tpu/tasks/classification.py``, numpy only.

Reference: ``MultimodalClassificationTask``: ``model.predict`` argmax
against the label, as accuracy (LAVIS/lavis/tasks/
multimodal_classification.py:24-103); the ImageNet zero-shot evaluation of
EVA-CLIP and the CoOp zero-shot evaluation of CLIP.
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ecoflap_tpu_torch.core.registry import registry


def to_numpy(x) -> np.ndarray:
    """A tensor (any device, any float dtype) or array as a numpy array."""
    if hasattr(x, "detach"):
        x = x.detach().float().cpu().numpy()
    return np.asarray(x)


def accuracy(logits, labels) -> float:
    """Share of rows whose argmax (the first of ties) is the label."""
    pred = np.argmax(to_numpy(logits), axis=-1)
    return float((pred == to_numpy(labels)).mean())


@registry.register("task", "multimodal_classification")
class ClassificationTask:
    def __init__(self, predict_fn=None):
        self.predict_fn = predict_fn  # batch -> (B, C) logits

    def evaluation(self, batches) -> Dict[str, float]:
        correct = total = 0
        for batch in batches:
            pred = np.argmax(to_numpy(self.predict_fn(batch)), axis=-1)
            labels = to_numpy(batch["label"])
            correct += int((pred == labels).sum())
            total += len(labels)
        return {"agg_metrics": 100.0 * correct / max(total, 1)}


@registry.register("task", "image_text_pretrain")
class ImageTextPretrainTask:
    """No evaluation: the name a calibration-only project YAML carries
    (image_text_pretrain.py:20)."""

    def evaluation(self, batches) -> Dict[str, float]:
        return {}


@registry.register("task", "language_modeling")
class LanguageModelingTask(ImageTextPretrainTask):
    pass
