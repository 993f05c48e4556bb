"""MMLU 5-shot harness: FlanT5 A/B/C/D first-token scoring (the port's own
copy of ``ecoflap_tpu/tasks/mmlu.py``, numpy only).

Rebuild of ``mmlu_eval/evaluate_flan.py:44-136`` + ``categories.py`` (the
standard hendrycks/test harness): build k-shot prompts per subject, read the
decoder's FIRST-token logits at the ids of "A"/"B"/"C"/"D", argmax, report
per-subject, per-category and weighted-average accuracy.

The model plugs in as ``first_token_logits_fn(prompts: list[str]) ->
(B, vocab) array`` (numpy, or a tensor on any device), so any
encoder-decoder or decoder-only LM works.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import numpy as np

from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.tasks.classification import to_numpy

CHOICES = ["A", "B", "C", "D"]

# hendrycks/test subcategory -> category map (mmlu_eval/categories.py)
SUBCATEGORIES = {
    "abstract_algebra": "math", "anatomy": "health", "astronomy": "physics",
    "business_ethics": "business", "clinical_knowledge": "health",
    "college_biology": "biology", "college_chemistry": "chemistry",
    "college_computer_science": "computer science",
    "college_mathematics": "math", "college_medicine": "health",
    "college_physics": "physics", "computer_security": "computer science",
    "conceptual_physics": "physics", "econometrics": "economics",
    "electrical_engineering": "engineering", "elementary_mathematics": "math",
    "formal_logic": "philosophy", "global_facts": "other",
    "high_school_biology": "biology", "high_school_chemistry": "chemistry",
    "high_school_computer_science": "computer science",
    "high_school_european_history": "history",
    "high_school_geography": "geography",
    "high_school_government_and_politics": "politics",
    "high_school_macroeconomics": "economics",
    "high_school_mathematics": "math",
    "high_school_microeconomics": "economics", "high_school_physics": "physics",
    "high_school_psychology": "psychology",
    "high_school_statistics": "math", "high_school_us_history": "history",
    "high_school_world_history": "history", "human_aging": "health",
    "human_sexuality": "culture", "international_law": "law",
    "jurisprudence": "law", "logical_fallacies": "philosophy",
    "machine_learning": "computer science", "management": "business",
    "marketing": "business", "medical_genetics": "health",
    "miscellaneous": "other", "moral_disputes": "philosophy",
    "moral_scenarios": "philosophy", "nutrition": "health",
    "philosophy": "philosophy", "prehistory": "history",
    "professional_accounting": "other", "professional_law": "law",
    "professional_medicine": "health", "professional_psychology": "psychology",
    "public_relations": "politics", "security_studies": "politics",
    "sociology": "culture", "us_foreign_policy": "politics",
    "virology": "health", "world_religions": "philosophy",
}
CATEGORIES = {
    "STEM": ["physics", "chemistry", "biology", "computer science", "math",
             "engineering"],
    "humanities": ["history", "philosophy", "law"],
    "social sciences": ["politics", "culture", "economics", "geography",
                        "psychology"],
    "other (business, health, misc.)": ["other", "business", "health"],
}


def format_subject(subject: str) -> str:
    return " ".join(subject.split("_"))


def format_example(row: Sequence, include_answer: bool = True) -> str:
    """row = [question, A, B, C, D, answer_letter]."""
    prompt = row[0]
    for j, choice in enumerate(CHOICES):
        prompt += f"\n{choice}. {row[j + 1]}"
    prompt += "\nAnswer:"
    if include_answer:
        prompt += f" {row[5]}\n\n"
    return prompt


def gen_prompt(dev_rows: List[Sequence], subject: str, k: int) -> str:
    prompt = (
        "The following are multiple choice questions (with answers) about "
        f"{format_subject(subject)}.\n\n"
    )
    for row in dev_rows[:k]:
        prompt += format_example(row, include_answer=True)
    return prompt


def crop_prompt(
    subject: str,
    dev_rows: List[Sequence],
    prompt_end: str,
    k: int,
    token_len_fn: Callable[[str], int],
    max_tokens: int = 2048,
) -> str:
    """Reference shot-reduction loop (mmlu_eval/evaluate_flan.py:59-64):
    drop few-shot examples one at a time until the tokenized prompt fits
    ``max_tokens``. Floor at k=0 (instruction + question only) — the
    reference would loop forever on a question that alone exceeds the
    budget; here the k=0 prompt is returned and truncation is the
    tokenizer's problem, as in practice it is upstream too."""
    prompt = gen_prompt(dev_rows, subject, k) + prompt_end
    while k > 0 and token_len_fn(prompt) > max_tokens:
        k -= 1
        prompt = gen_prompt(dev_rows, subject, k) + prompt_end
    return prompt


def eval_subject(
    subject: str,
    dev_rows: List[Sequence],
    test_rows: List[Sequence],
    first_token_logits_fn: Callable[[List[str]], np.ndarray],
    choice_token_ids: Sequence[int],
    k: int = 5,
    batch_size: int = 8,
    token_len_fn: Optional[Callable[[str], int]] = None,
    max_tokens: int = 2048,
) -> np.ndarray:
    """-> boolean correctness array over test_rows. With ``token_len_fn``
    each prompt is independently shot-cropped to the token budget."""
    if token_len_fn is not None:
        prompts = [
            crop_prompt(subject, dev_rows,
                        format_example(r, include_answer=False), k,
                        token_len_fn, max_tokens)
            for r in test_rows
        ]
    else:
        few_shot = gen_prompt(dev_rows, subject, k)
        prompts = [few_shot + format_example(r, include_answer=False)
                   for r in test_rows]
    answers = [CHOICES.index(r[5]) for r in test_rows]
    correct = []
    for i in range(0, len(prompts), batch_size):
        logits = to_numpy(first_token_logits_fn(prompts[i : i + batch_size]))
        choice_logits = logits[:, list(choice_token_ids)]
        preds = np.argmax(choice_logits, axis=-1)
        correct.extend(preds[j] == answers[i + j] for j in range(len(preds)))
    return np.asarray(correct, bool)


def aggregate(per_subject: Dict[str, np.ndarray]) -> Dict[str, float]:
    """Per-subject accs -> category accs + weighted average
    (evaluate_flan.py:190-240 reporting)."""
    out: Dict[str, float] = {}
    cat_hits: Dict[str, list] = {c: [] for c in CATEGORIES}
    all_hits = []
    for subject, corr in per_subject.items():
        out[f"acc/{subject}"] = float(corr.mean()) if len(corr) else 0.0
        all_hits.append(corr)
        subcat = SUBCATEGORIES.get(subject)
        for cat, subcats in CATEGORIES.items():
            if subcat in subcats:
                cat_hits[cat].append(corr)
    for cat, hits in cat_hits.items():
        if hits:
            out[f"acc/category/{cat}"] = float(np.concatenate(hits).mean())
    if all_hits:
        out["agg_metrics"] = 100.0 * float(np.concatenate(all_hits).mean())
    return out


@registry.register("task", "mmlu")
class MMLUTask:
    def __init__(self, first_token_logits_fn=None, choice_token_ids=None,
                 k: int = 5, batch_size: int = 8, token_len_fn=None,
                 max_tokens: int = 2048):
        self.fn = first_token_logits_fn
        self.choice_token_ids = choice_token_ids
        self.k = k
        self.batch_size = batch_size
        self.token_len_fn = token_len_fn
        self.max_tokens = max_tokens

    def evaluation(self, data: Dict[str, Dict[str, list]]) -> Dict[str, float]:
        """data: {subject: {"dev": rows, "test": rows}}."""
        per_subject = {}
        for subject, splits in data.items():
            per_subject[subject] = eval_subject(
                subject, splits["dev"], splits["test"], self.fn,
                self.choice_token_ids, self.k, self.batch_size,
                token_len_fn=self.token_len_fn, max_tokens=self.max_tokens,
            )
        return aggregate(per_subject)
