"""Retrieval scoring in the port (``ecoflap_tpu_torch/tasks/retrieval.py``)
against the JAX package's ``tasks/retrieval.py``: recall@k, the symmetric
and the asymmetric (ITM re-ranked) scores, ``RetrievalTask``, and the
evaluate CLI's blip1 retrieval, VQA and NLVR branches against the JAX CLI's
from the same weights. The metrics must be equal (numpy on both sides; the
model outputs agree to float32 rounding, and the rankings they feed are
equal)."""

import jax
import numpy as np
import pytest

from ecoflap_tpu.models import blip1 as jblip1
from ecoflap_tpu.tasks import retrieval as jret
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.tasks import retrieval as tret
from tests.torch_parity import BLIP1_JAX, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_recall_at_k_matches_jax():
    ranks = np.random.default_rng(0).integers(0, 20, size=50)
    assert tret.recall_at_k(ranks) == jret.recall_at_k(ranks)
    assert tret.recall_at_k(ranks, ks=(2, 3)) == jret.recall_at_k(ranks, ks=(2, 3))


@pytest.mark.parametrize("seed", [0, 1])
def test_scores_match_jax(seed):
    rng = np.random.default_rng(seed)
    sim = rng.normal(size=(12, 20)).astype(np.float32)
    sim_t2i = rng.normal(size=(20, 12)).astype(np.float32)
    txt2img = rng.integers(0, 12, size=20)
    img2txt = [list(np.where(txt2img == i)[0]) or [0] for i in range(12)]
    square = sim[:, :12]
    assert tret.score_retrieval(square) == jret.score_retrieval(square)
    assert (tret.score_retrieval(sim, txt2img, img2txt)
            == jret.score_retrieval(sim, txt2img, img2txt))
    assert (tret.score_retrieval_pair(sim, sim_t2i, txt2img, img2txt)
            == jret.score_retrieval_pair(sim, sim_t2i, txt2img, img2txt))


def test_retrieval_task_with_a_rerank_matches_jax():
    """Without an ITM scorer the task is the JAX ``RetrievalTask``; with one
    it is the JAX CLI's blip1 retrieval (cli/evaluate.py:311-360): each
    side's top k re-scored by ITM plus the similarity, the sides ranked
    apart by ``score_retrieval_pair``."""
    rng = np.random.default_rng(3)
    sim = rng.normal(size=(10, 10))
    itm = rng.normal(size=(10, 10))
    data = {"txt2img": np.arange(10), "img2txt": [[i] for i in range(10)]}
    assert (tret.RetrievalTask(lambda d: sim).evaluation(data)
            == jret.RetrievalTask(lambda d: sim).evaluation(data))

    k = 4
    score_i2t = np.full_like(sim, -np.inf)
    for i in range(10):
        top = np.argsort(-sim[i])[:k]
        score_i2t[i, top] = itm[i, top] + sim[i, top]
    score_t2i = np.full_like(sim.T, -np.inf)
    for j in range(10):
        top = np.argsort(-sim[:, j])[:k]
        score_t2i[j, top] = itm[top, j] + sim[top, j]
    want = jret.score_retrieval_pair(score_i2t, score_t2i)
    got = tret.RetrievalTask(lambda d: sim, lambda im, tx: itm[im, tx], k_test=k
                             ).evaluation(data)
    assert got == want
    assert got != tret.RetrievalTask(lambda d: sim).evaluation(data)


def test_rerank_pair_keeps_the_two_sides_apart():
    """Each side's top-k alone is re-scored; the rest of its row is -inf."""
    sim = np.random.default_rng(4).normal(size=(5, 6)).astype(np.float32)
    i2t, t2i = tret.rerank_pair(sim, lambda im, tx: 10.0 * (im == tx), k=2)
    assert np.isfinite(i2t).sum(axis=1).tolist() == [2] * 5
    assert np.isfinite(t2i).sum(axis=1).tolist() == [2] * 6
    for i in range(5):
        top = np.argsort(-sim[i])[:2]
        want = (10.0 * (top == i) + sim[i, top]).astype(np.float32)
        np.testing.assert_array_equal(i2t[i, top], want)


KINDS = {"retrieval": "blip_retrieval", "vqa": "blip_vqa", "nlvr": "blip_nlvr"}


@pytest.mark.parametrize("task", sorted(KINDS))
def test_evaluate_cli_blip1_branch_matches_the_jax_cli(tmp_path, task):
    """The JAX CLI's synthetic branch (its random init at ``--seed``) and
    the port's from that init's ``export_blip1`` ``.pth``: equal metrics."""
    from ecoflap_tpu.cli.evaluate import main as jmain
    from ecoflap_tpu_torch.cli.evaluate import main as tmain

    kind = KINDS[task]
    cfg = jblip1.tiny_config()
    params = getattr(jblip1, BLIP1_JAX[kind][0])(cfg, jax.random.PRNGKey(42))
    pth = str(tmp_path / f"{kind}.pth")
    jck.save_torch_checkpoint(jck.export_blip1(params, cfg, kind), pth)
    common = ["--model", "blip1", "--task", task, "--model_scale", "tiny",
              "--batch_size", "8", "--eval_batches", "2", "--seed", "42"]
    want = jmain(common + ["--platform", "cpu", "--output_dir", str(tmp_path / "j")])
    got = tmain(common + ["--device", "cpu", "--checkpoint", pth,
                          "--output_dir", str(tmp_path / "t")])
    want.pop("eval_time_s", None), got.pop("eval_time_s", None)
    print(task, got)
    assert got == want
