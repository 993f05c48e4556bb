"""The port's task scorers (``ecoflap_tpu_torch/tasks``) against the JAX
package's: VQA accuracy over the reference's golden fixture, GQA exact
match, CIDEr-D, BLEU 1-4, ROUGE-L and the COCOEvalCap schema on seeded
random caption sets, the language-model tasks, the registry and the eval
loop's log."""

import json
import os

import numpy as np
import pytest

from ecoflap_tpu.tasks import captioning as jcap
from ecoflap_tpu.tasks import lm as jlm
from ecoflap_tpu.tasks import vqa as jvqa
from ecoflap_tpu_torch.runners.runner import Runner
from ecoflap_tpu_torch.tasks import captioning as tcap
from ecoflap_tpu_torch.tasks import classification as tcls
from ecoflap_tpu_torch.tasks import lm as tlm
from ecoflap_tpu_torch.tasks import mmlu as tmmlu
from ecoflap_tpu_torch.tasks import retrieval as tret
from ecoflap_tpu_torch.tasks import setup_task
from ecoflap_tpu_torch.tasks import vqa as tvqa

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures_vqa_golden.json")
WORDS = ["a", "the", "dog", "cat", "red", "two", "runs", "on", "grass", "ball",
         "man", "is", "sitting", "Dog!", "cat,", "2", "isn't", "bench"]


@pytest.fixture(scope="module")
def golden():
    with open(FIXTURES) as f:
        return json.load(f)


def test_vqa_accuracy_matches_the_fixture_and_jax(golden):
    for qid, case in enumerate(golden["cases"]):
        got = tvqa.vqa_accuracy(case["pred"], case["gts"])
        assert got == jvqa.vqa_accuracy(case["pred"], case["gts"])
        assert round(100.0 * got, 2) == pytest.approx(
            golden["golden"]["perQuestion"][str(qid)], abs=1e-9), qid


def test_score_vqa_matches_the_fixture_and_jax(golden):
    results = [{"answer": c["pred"], "gt_answers": c["gts"],
                "answer_type": c["answer_type"]} for c in golden["cases"]]
    got = tvqa.score_vqa(results)
    assert got == jvqa.score_vqa(results)
    assert got["agg_metrics"] == pytest.approx(golden["golden"]["overall"], abs=1e-9)
    for at, val in golden["golden"]["perAnswerType"].items():
        assert got[at] == pytest.approx(val, abs=1e-9)


def sentences(rng, n, lo=1, hi=9):
    return [" ".join(rng.choice(WORDS, size=rng.integers(lo, hi))) for _ in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_score_gqa_matches_jax(seed):
    rng = np.random.default_rng(seed)
    preds, gts = sentences(rng, 40, 1, 3), sentences(rng, 40, 1, 3)
    gts[::3] = [p.upper() + "?" for p in preds[::3]]  # matches after cleaning
    results = [{"answer": p, "gt": g} for p, g in zip(preds, gts)]
    got = tvqa.score_gqa(results)
    assert got == jvqa.score_gqa(results)
    assert got["agg_metrics"] > 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_caption_metrics_match_jax(seed):
    """Candidates and 1-5 references per image, a third of the candidates
    copied from a reference so every n-gram order scores."""
    rng = np.random.default_rng(seed)
    refs = [sentences(rng, int(rng.integers(1, 6)), 3, 12) for _ in range(30)]
    cands = sentences(rng, 30, 2, 12)
    cands[::3] = [r[0] for r in refs[::3]]
    assert tcap.cider_d(cands, refs) == jcap.cider_d(cands, refs)
    assert tcap.bleu_all(cands, refs) == jcap.bleu_all(cands, refs)
    assert tcap.rouge_l(cands, refs) == jcap.rouge_l(cands, refs)
    results = [{"caption": c, "gt_captions": r} for c, r in zip(cands, refs)]
    got = tcap.score_captions(results)
    assert got == jcap.score_captions(results)
    assert got["METEOR"] is None and "METEOR" in got["metric_notes"]
    assert got["agg_metrics"] == got["CIDEr"] + got["Bleu_4"] > 0


def test_caption_task_over_batches_matches_jax():
    rng = np.random.default_rng(4)
    batches = [{"gt_captions": [sentences(rng, 2, 3, 8) for _ in range(4)]}
               for _ in range(3)]

    def gen_fn(batch):
        return [caps[0] if i % 2 else "a dog runs" for i, caps in
                enumerate(batch["gt_captions"])]

    assert tcap.CaptionTask(gen_fn).evaluation(batches) == \
        jcap.CaptionTask(gen_fn).evaluation(batches)


def test_vqa_and_gqa_tasks_over_batches_match_jax():
    batches = [{"gt_answers": [["yes"] * 10, ["no"] * 9 + ["yes"], ["two"] * 10],
                "gt": ["yes", "No", "2"]} for _ in range(2)]
    answers = lambda batch: ["yes", "yes", "2"]  # noqa: E731
    assert tvqa.VQATask(answers).evaluation(batches) == \
        jvqa.VQATask(answers).evaluation(batches)
    assert tvqa.GQATask(answers).evaluation(batches) == \
        jvqa.GQATask(answers).evaluation(batches)


def test_lm_tasks_match_jax():
    stream = np.arange(100)
    assert tlm.PerplexityTask(lambda s: 17.25).evaluation(stream) == \
        jlm.PerplexityTask(lambda s: 17.25).evaluation(stream)
    rng = np.random.default_rng(3)
    batches = [rng.uniform(1, 5, size=(4,)).astype(np.float32) for _ in range(3)]
    got = tlm.PrefixLMLossTask(lambda b: b).evaluation(batches)
    assert got == jlm.PrefixLMLossTask(lambda b: b).evaluation(batches)
    assert got["ppl"] == pytest.approx(np.exp(np.concatenate(batches).mean()), rel=1e-6)


def test_setup_task_names_the_jax_registry_names():
    for name, cls in (("vqa", tvqa.VQATask), ("aok_vqa", tvqa.VQATask),
                      ("gqa", tvqa.GQATask), ("captioning", tcap.CaptionTask),
                      ("wikitext_ppl", tlm.PerplexityTask),
                      ("prefix_lm_loss", tlm.PrefixLMLossTask),
                      ("mmlu", tmmlu.MMLUTask),
                      ("multimodal_classification", tcls.ClassificationTask),
                      ("retrieval", tret.RetrievalTask)):
        assert type(setup_task(name)) is cls
    # every JAX task name is registered now; the error lists the known names
    with pytest.raises(KeyError, match="mmlu"):
        setup_task("video_retrieval")


def test_runner_evaluate_logs_each_split(tmp_path):
    runner = Runner(str(tmp_path), "eval")
    metrics = runner.evaluate(tlm.PerplexityTask(lambda s: 3.0), None)
    logs = runner.evaluate_splits(tlm.PerplexityTask(lambda s: 2.0),
                                  {"val": None, "test": None})
    assert metrics["ppl"] == 3.0 and "eval_time_s" in metrics
    assert set(logs) == {"val", "test"} and logs["test"]["epoch"] == "best"
    lines = [json.loads(x) for x in (tmp_path / "evaluate.txt").read_text().splitlines()]
    assert [list(x) for x in lines] == [["val"], ["val"], ["test"]]
    assert lines[0]["val"]["ppl"] == 3.0 and lines[2]["test"]["ppl"] == 2.0
