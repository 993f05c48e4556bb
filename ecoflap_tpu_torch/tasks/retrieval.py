"""Image-text retrieval: recall@{1,5,10} from similarity matrices (port of
``ecoflap_tpu/tasks/retrieval.py``, numpy only; reference
LAVIS/lavis/tasks/retrieval.py:32-113).

``score_retrieval_pair`` ranks text retrieval (image queries) on ``sim_i2t``
and image retrieval (text queries) on ``sim_t2i`` independently, as the
reference's ``_report_metrics`` does after an ITM re-rank.
``rerank_pair`` is that re-rank (the BLIP retrieval evaluation,
cli/evaluate.py:311-360): each image's top-k texts and each text's top-k
images by the ITC similarity are scored again by ITM, and every other entry
of the row drops to -inf; the two sides never mix. ``RetrievalTask`` scores
a similarity matrix, re-ranked so when it is given the ITM scorer.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import numpy as np

from ecoflap_tpu_torch.core.registry import registry


def recall_at_k(ranks: np.ndarray, ks=(1, 5, 10)) -> Dict[int, float]:
    return {k: 100.0 * float((ranks < k).mean()) for k in ks}


def score_retrieval(sim_i2t: np.ndarray, txt2img: Optional[np.ndarray] = None,
                    img2txt=None) -> Dict[str, float]:
    """``sim_i2t`` (N_img, N_txt); ``txt2img[j]`` the image of text j,
    ``img2txt[i]`` the texts of image i (default: the identity pairing)."""
    return score_retrieval_pair(sim_i2t, sim_i2t.T, txt2img, img2txt)


def score_retrieval_pair(sim_i2t: np.ndarray, sim_t2i: np.ndarray,
                         txt2img: Optional[np.ndarray] = None,
                         img2txt=None) -> Dict[str, float]:
    """TR@k from ``sim_i2t``, IR@k from ``sim_t2i``, their mean and the
    text-retrieval mean as ``agg_metrics`` (retrieval.py:30-72)."""
    n_img, n_txt = sim_i2t.shape
    if txt2img is None:
        txt2img = np.arange(n_txt)
    if img2txt is None:
        img2txt = [[i] for i in range(n_img)]
    tr_ranks = np.zeros(n_img)
    for i in range(n_img):
        order = np.argsort(-sim_i2t[i])
        tr_ranks[i] = min(int(np.where(order == t)[0][0]) for t in img2txt[i])
    ir_ranks = np.zeros(n_txt)
    for j in range(n_txt):
        order = np.argsort(-sim_t2i[j])
        ir_ranks[j] = int(np.where(order == txt2img[j])[0][0])
    tr, ir = recall_at_k(tr_ranks), recall_at_k(ir_ranks)
    out = {"txt_r1": tr[1], "txt_r5": tr[5], "txt_r10": tr[10],
           "img_r1": ir[1], "img_r5": ir[5], "img_r10": ir[10]}
    out["r_mean"] = sum(out.values()) / 6
    out["agg_metrics"] = (out["txt_r1"] + out["txt_r5"] + out["txt_r10"]) / 3
    return out


def rerank_pair(sim: np.ndarray, itm_match: Callable[[np.ndarray, np.ndarray], np.ndarray],
                k: int):
    """(score_i2t, score_t2i) after the ITM re-rank of each image's top
    ``k`` texts and each text's top ``k`` images (each side clipped to the
    candidates it has): ``itm_match(image rows, text rows)`` gives the match
    logit of each pair, which is added to the pair's similarity."""
    n_img, n_txt = sim.shape
    score_i2t = np.full_like(sim, -np.inf)
    for i in range(n_img):
        top = np.argsort(-sim[i])[:k]
        score_i2t[i, top] = itm_match(np.full(len(top), i), top) + sim[i, top]
    score_t2i = np.full_like(sim.T, -np.inf)
    for j in range(n_txt):
        top = np.argsort(-sim[:, j])[:k]
        score_t2i[j, top] = itm_match(top, np.full(len(top), j)) + sim[top, j]
    return score_i2t, score_t2i


@registry.register("task", "retrieval")
class RetrievalTask:
    """``sim_fn(dataset)`` gives the (N_img, N_txt) similarity; with
    ``itm_fn(image rows, text rows)`` each side's top ``k_test`` is
    re-ranked by ITM (``rerank_pair``) and the sides are ranked apart."""

    def __init__(self, sim_fn: Optional[Callable] = None,
                 itm_fn: Optional[Callable[[np.ndarray, np.ndarray], np.ndarray]] = None,
                 k_test: int = 128):
        self.sim_fn = sim_fn
        self.itm_fn = itm_fn
        self.k_test = k_test

    def evaluation(self, dataset) -> Dict[str, float]:
        sim = np.asarray(self.sim_fn(dataset))
        txt2img, img2txt = dataset.get("txt2img"), dataset.get("img2txt")
        if self.itm_fn is None:
            return score_retrieval(sim, txt2img, img2txt)
        k = min(self.k_test, *sim.shape)
        return score_retrieval_pair(*rerank_pair(sim, self.itm_fn, k), txt2img, img2txt)
