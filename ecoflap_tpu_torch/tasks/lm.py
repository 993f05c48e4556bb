"""Language-model evaluation: WikiText-2 perplexity (LLaMA) and the C4
prefix-LM loss (standalone T5); port of ``ecoflap_tpu/tasks/lm.py``, with
numpy only.

Reference: ``eval_ppl`` of ``LLaMA/lib/eval.py`` (LLaMA/main.py:89-90:
non-overlapping windows of 2048 tokens, token-mean NLL) and
``evaluate_t5.py``'s C4 validation loss.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from ecoflap_tpu_torch.core.registry import registry


@registry.register("task", "wikitext_ppl")
class PerplexityTask:
    def __init__(self, ppl_fn: Callable = None):
        self.ppl_fn = ppl_fn  # token_stream -> float ppl

    def evaluation(self, token_stream) -> Dict[str, float]:
        ppl = float(self.ppl_fn(token_stream))
        return {"ppl": ppl, "agg_metrics": -ppl}


@registry.register("task", "prefix_lm_loss")
class PrefixLMLossTask:
    def __init__(self, loss_fn: Callable = None):
        self.loss_fn = loss_fn  # batch -> (B,) losses

    def evaluation(self, batches) -> Dict[str, float]:
        total, n = 0.0, 0
        for batch in batches:
            losses = np.asarray(self.loss_fn(batch))
            total += float(losses.sum())
            n += losses.shape[0]
        mean = total / max(n, 1)
        return {"loss": mean, "ppl": float(np.exp(mean)), "agg_metrics": -mean}
