"""VQA scoring — official VQAv2 normalization + accuracy, GQA exact match
(the port's own copy of ``ecoflap_tpu/tasks/vqa.py``).

Reimplements the standard VQAEval answer-processing algorithm the reference
vendors (LAVIS/lavis/common/vqa_tools/vqa_eval.py:29-270, itself the public
VQA API): contraction expansion, punctuation stripping, digit/article
normalization, then accuracy ``min(#matching_human_answers / 3, 1)``
averaged over the 10 leave-one-out 9-subsets. GQA uses cleaned exact match
(lavis/tasks/vqa.py:185-251).
"""

from __future__ import annotations

import re
from typing import Dict, Iterable, List, Sequence

from ecoflap_tpu_torch.core.registry import registry

CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve": "could've",
    "couldnt": "couldn't", "couldn'tve": "couldn't've",
    "couldnt've": "couldn't've", "didnt": "didn't", "doesnt": "doesn't",
    "dont": "don't", "hadnt": "hadn't", "hadnt've": "hadn't've",
    "hadn'tve": "hadn't've", "hasnt": "hasn't", "havent": "haven't",
    "hed": "he'd", "hed've": "he'd've", "he'dve": "he'd've", "hes": "he's",
    "howd": "how'd", "howll": "how'll", "hows": "how's", "Id've": "I'd've",
    "I'dve": "I'd've", "Im": "I'm", "Ive": "I've", "isnt": "isn't",
    "itd": "it'd", "itd've": "it'd've", "it'dve": "it'd've", "itll": "it'll",
    "let's": "let's", "maam": "ma'am", "mightnt": "mightn't",
    "mightnt've": "mightn't've", "mightn'tve": "mightn't've",
    "mightve": "might've", "mustnt": "mustn't", "mustve": "must've",
    "neednt": "needn't", "notve": "not've", "oclock": "o'clock",
    "oughtnt": "oughtn't", "ow's'at": "'ow's'at", "'ows'at": "'ow's'at",
    "'ow'sat": "'ow's'at", "shant": "shan't", "shed've": "she'd've",
    "she'dve": "she'd've", "she's": "she's", "shouldve": "should've",
    "shouldnt": "shouldn't", "shouldnt've": "shouldn't've",
    "shouldn'tve": "shouldn't've", "somebody'd": "somebodyd",
    "somebodyd've": "somebody'd've", "somebody'dve": "somebody'd've",
    "somebodyll": "somebody'll", "somebodys": "somebody's",
    "someoned": "someone'd", "someoned've": "someone'd've",
    "someone'dve": "someone'd've", "someonell": "someone'll",
    "someones": "someone's", "somethingd": "something'd",
    "somethingd've": "something'd've", "something'dve": "something'd've",
    "somethingll": "something'll", "thats": "that's", "thered": "there'd",
    "thered've": "there'd've", "there'dve": "there'd've",
    "therere": "there're", "theres": "there's", "theyd": "they'd",
    "theyd've": "they'd've", "they'dve": "they'd've", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "twas": "'twas",
    "wasnt": "wasn't", "wed've": "we'd've", "we'dve": "we'd've",
    "weve": "we've", "werent": "weren't", "whatll": "what'll",
    "whatre": "what're", "whats": "what's", "whatve": "what've",
    "whens": "when's", "whered": "where'd", "wheres": "where's",
    "whereve": "where've", "whod": "who'd", "whod've": "who'd've",
    "who'dve": "who'd've", "wholl": "who'll", "whos": "who's",
    "whove": "who've", "whyll": "why'll", "whyre": "why're", "whys": "why's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "wouldnt've": "wouldn't've", "wouldn'tve": "wouldn't've",
    "yall": "y'all", "yall'll": "y'all'll", "y'allll": "y'all'll",
    "yall'd've": "y'all'd've", "y'alld've": "y'all'd've",
    "y'all'dve": "y'all'd've", "youd": "you'd", "youd've": "you'd've",
    "you'dve": "you'd've", "youll": "you'll", "youre": "you're",
    "youve": "you've",
}
MANUAL_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}
ARTICLES = {"a", "an", "the"}
PERIOD_STRIP = re.compile(r"(?!<=\d)(\.)(?!\d)")
COMMA_STRIP = re.compile(r"(\d)(,)(\d)")
PUNCT = [
    ";", r"/", "[", "]", '"', "{", "}", "(", ")", "=", "+", "\\", "_", "-",
    ">", "<", "@", "`", ",", "?", "!",
]


def process_punctuation(text: str) -> str:
    out = text
    for p in PUNCT:
        if (p + " " in text or " " + p in text) or (
            re.search(COMMA_STRIP, text) is not None
        ):
            out = out.replace(p, "")
        else:
            out = out.replace(p, " ")
    out = PERIOD_STRIP.sub("", out, re.UNICODE)
    return out


def process_digit_article(text: str) -> str:
    out: List[str] = []
    for word in text.lower().split():
        word = MANUAL_MAP.get(word, word)
        if word not in ARTICLES:
            out.append(word)
    for i, word in enumerate(out):
        if word in CONTRACTIONS:
            out[i] = CONTRACTIONS[word]
    return " ".join(out)


def normalize_answer(ans: str) -> str:
    ans = ans.replace("\n", " ").replace("\t", " ").strip()
    return process_digit_article(process_punctuation(ans))


def vqa_accuracy(pred: str, gt_answers: Sequence[str]) -> float:
    """Official VQA accuracy, oracle-locked against the reference's vendored
    VQAEval (vqa_eval.py:209-231; the JAX copy in tests/test_metric_oracles.py):

    * the *prediction* gets the full pipeline (punctuation + digit/article),
    * GT answers get ``processPunctuation`` ONLY, and only when the GT set
      has more than one distinct answer (vqa_eval.py:219-221) — this
      asymmetry (articles/digit-words survive in GTs) is load-bearing,
    * accuracy = mean over leave-one-out subsets of min(#matches/3, 1).
    """
    pred = normalize_answer(pred)
    if len(set(gt_answers)) > 1:
        gts = [process_punctuation(a) for a in gt_answers]
    else:
        gts = list(gt_answers)
    accs = []
    for i in range(len(gts)):
        others = gts[:i] + gts[i + 1:]
        matches = sum(1 for o in others if o == pred)
        accs.append(min(1.0, matches / 3.0))
    return sum(accs) / len(accs) if accs else 0.0


def score_vqa(results: Iterable[Dict]) -> Dict[str, float]:
    """results: [{"answer": pred, "gt_answers": [10 strings],
    "answer_type": optional}] -> overall acc percentage plus per-answer-type
    breakdown, rounded to 2 decimals exactly like VQAEval.setAccuracy
    (vqa_eval.py:276-290) reported through the task (vqa.py:156-176)."""
    scores: List[float] = []
    per_type: Dict[str, List[float]] = {}
    for r in results:
        acc = vqa_accuracy(r["answer"], r["gt_answers"])
        scores.append(acc)
        at = r.get("answer_type")
        if at is not None:
            per_type.setdefault(at, []).append(acc)
    overall = round(100.0 * sum(scores) / max(len(scores), 1), 2)
    out = {"agg_metrics": overall, "overall": overall}
    for at, vals in per_type.items():
        out[at] = round(100.0 * sum(vals) / len(vals), 2)
    return out


# --- GQA / exact match (vqa.py:185-251) ------------------------------------

def clean_gqa_answer(ans: str) -> str:
    ans = ans.lower().replace(",", "").replace("?", "").replace("'s", " 's")
    return ans.strip()


def score_gqa(results: Iterable[Dict]) -> Dict[str, float]:
    n = correct = 0
    for r in results:
        n += 1
        if clean_gqa_answer(r["answer"]) == clean_gqa_answer(r["gt"]):
            correct += 1
    return {"agg_metrics": 100.0 * correct / max(n, 1)}


@registry.register("task", "vqa")
class VQATask:
    """Batch loop: model predicts short answers; official scorer aggregates."""

    prompt = "Question: {} Short answer:"

    def __init__(self, predict_fn=None):
        self.predict_fn = predict_fn

    def evaluation(self, batches) -> Dict[str, float]:
        results = []
        for batch in batches:
            answers = self.predict_fn(batch)
            for ans, gt in zip(answers, batch["gt_answers"]):
                results.append({"answer": ans, "gt_answers": gt})
        return score_vqa(results)


@registry.register("task", "gqa")
class GQATask(VQATask):
    def evaluation(self, batches) -> Dict[str, float]:
        results = []
        for batch in batches:
            answers = self.predict_fn(batch)
            for ans, gt in zip(answers, batch["gt"]):
                results.append({"answer": ans, "gt": gt})
        return score_gqa(results)


registry.register("task", "aok_vqa", VQATask)
