"""The port's MMLU harness (``tasks/mmlu.py``) against the JAX package's on
the same rows and fake logits, the FlanT5 first-token logits against the
JAX model's, and the evaluate CLI's synthetic ``t5 mmlu`` metric dict
against the JAX CLI's, the JAX CLI's random init carried across as a
``.pth``. Tolerance: RTOL 1e-5 on float32 logits (a few ulps through 2 + 2
blocks); the metric dicts are equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.cli.evaluate import main as jmain
from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.data.calibration import HashTokenizer as JHashTokenizer
from ecoflap_tpu.models import t5 as jt5
from ecoflap_tpu.tasks import mmlu as jmmlu
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.evaluate import main as tmain
from ecoflap_tpu_torch.cli.evaluate import mmlu_logits_fn
from ecoflap_tpu_torch.data.calibration import HashTokenizer
from ecoflap_tpu_torch.models import t5 as tt5
from ecoflap_tpu_torch.models.convert import load_jax_params
from ecoflap_tpu_torch.tasks import mmlu as tmmlu
from ecoflap_tpu_torch.tasks import setup_task
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5


def rows(n, seed, tag="q"):
    rng = np.random.default_rng(seed)
    return [[f"{tag}{i} what is {rng.integers(100)} plus {rng.integers(100)}?",
             str(rng.integers(100)), str(rng.integers(100)), str(rng.integers(100)),
             str(rng.integers(100)), "ABCD"[rng.integers(4)]] for i in range(n)]


def word_count(s):
    return len(s.split())


def test_tables_are_the_jax_packages():
    assert tmmlu.SUBCATEGORIES == jmmlu.SUBCATEGORIES and len(tmmlu.SUBCATEGORIES) == 57
    assert tmmlu.CATEGORIES == jmmlu.CATEGORIES and tmmlu.CHOICES == jmmlu.CHOICES


@pytest.mark.parametrize("k", [0, 1, 5])
def test_prompts_match_jax(k):
    dev, test = rows(5, 0), rows(3, 1, tag="t")
    assert tmmlu.format_subject("high_school_us_history") == "high school us history"
    assert tmmlu.gen_prompt(dev, "college_physics", k) == jmmlu.gen_prompt(
        dev, "college_physics", k)
    for r in test:
        for answer in (True, False):
            assert tmmlu.format_example(r, answer) == jmmlu.format_example(r, answer)
        end = tmmlu.format_example(r, include_answer=False)
        for budget in (10, 40, 80, 2048):
            assert tmmlu.crop_prompt("anatomy", dev, end, k, word_count, budget) == \
                jmmlu.crop_prompt("anatomy", dev, end, k, word_count, budget)


def fake_logits_fn(vocab, seed):
    """prompts -> (B, vocab) logits that depend only on each prompt's text."""
    def fn(prompts):
        out = []
        for p in prompts:
            rng = np.random.default_rng(abs(hash(p)) % 2 ** 32)
            out.append(rng.normal(size=(vocab,)).astype(np.float32) + seed)
        return np.stack(out)
    return fn


@pytest.mark.parametrize("crop", [False, True], ids=["whole", "cropped"])
def test_eval_subject_and_aggregate_match_jax(crop):
    """Per-subject correctness over three subjects of different categories,
    batches of 3 (one partial), then category and weighted accuracies; the
    port's logits callable may also return a tensor."""
    abcd = [3, 7, 11, 13]
    data = {s: {"dev": rows(5, i), "test": rows(7, 10 + i, tag="t")}
            for i, s in enumerate(("anatomy", "college_physics", "world_religions"))}
    kw = dict(k=5, batch_size=3, token_len_fn=word_count if crop else None, max_tokens=60)
    fn = fake_logits_fn(16, 0)
    per = {}
    for s, d in data.items():
        want = jmmlu.eval_subject(s, d["dev"], d["test"], fn, abcd, **kw)
        got = tmmlu.eval_subject(s, d["dev"], d["test"],
                                 lambda p: torch.from_numpy(fn(p)), abcd, **kw)
        np.testing.assert_array_equal(got, want)
        per[s] = got
    assert tmmlu.aggregate(per) == jmmlu.aggregate(per)
    task = setup_task("mmlu", lambda p: torch.from_numpy(fn(p)), abcd, **kw)
    assert task.evaluation(data) == jmmlu.MMLUTask(fn, abcd, **kw).evaluation(data)


def test_first_token_logits_match_jax():
    """What the CLI scores: the decoder's first step from
    ``decoder_start_token_id`` over hash-token prompts cut at 64 tokens."""
    cfg = jt5.tiny_config()
    params = jt5.init_params(cfg, jax.random.PRNGKey(5))
    model = tt5.build_model(tt5.tiny_config(), device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    prompts = [tmmlu.gen_prompt(rows(5, 2), "anatomy", 5) + tmmlu.format_example(r, False)
               for r in rows(4, 3, tag="t")]
    jtok = JHashTokenizer(vocab_size=cfg.vocab_size)
    ids, mask = jtok(prompts, max_length=64)
    enc = jt5.encode(cfg, params, jnp.asarray(ids), jnp.asarray(mask))
    dec_in = jnp.full((len(prompts), 1), cfg.decoder_start_token_id, jnp.int32)
    want = np.asarray(jt5.decode(cfg, params, enc, jnp.asarray(mask), dec_in)[:, 0])
    got = mmlu_logits_fn(model, HashTokenizer(vocab_size=cfg.vocab_size),
                         torch.device("cpu"))(prompts)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_first_token_logits_drop_the_shared_padding():
    """At a budget longer than every prompt the port drops the columns that
    are padding in every row (the encoder masks them); its logits are the
    JAX model's on the batch padded to the full budget."""
    cfg = jt5.tiny_config()
    params = jt5.init_params(cfg, jax.random.PRNGKey(6))
    model = tt5.build_model(tt5.tiny_config(), device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    prompts = [tmmlu.gen_prompt(rows(k, 4), "anatomy", k) + tmmlu.format_example(r, False)
               for k, r in zip((0, 1, 3, 5), rows(4, 7, tag="t"))]
    ids, mask = JHashTokenizer(vocab_size=cfg.vocab_size)(prompts, max_length=512)
    assert 0 < mask.sum(1).max() < 512 and mask.sum(1).min() < mask.sum(1).max()
    enc = jt5.encode(cfg, params, jnp.asarray(ids), jnp.asarray(mask))
    dec_in = jnp.full((len(prompts), 1), cfg.decoder_start_token_id, jnp.int32)
    want = np.asarray(jt5.decode(cfg, params, enc, jnp.asarray(mask), dec_in)[:, 0])
    got = mmlu_logits_fn(model, HashTokenizer(vocab_size=cfg.vocab_size),
                         torch.device("cpu"), max_length=512)(prompts)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * float(np.abs(want).max()))


def test_cli_metrics_equal_the_jax_clis(tmp_path):
    """The JAX CLI's synthetic ``t5 mmlu`` run at tiny size against the
    port's from the same parameters (the JAX CLI's init at seed 42, exported
    by ``export_t5``): every field but the wall."""
    cfg = jt5.tiny_config()
    ckpt = str(tmp_path / "t5.pth")
    jck.save_torch_checkpoint(jck.export_t5(
        jt5.init_params(cfg, jax.random.PRNGKey(42)), cfg), ckpt)
    want = jmain(["--platform", "cpu", "--model", "t5", "--task", "mmlu", "--synthetic",
                  "--output_dir", str(tmp_path / "jax")])
    got = tmain(["--device", "cpu", "--model", "t5", "--task", "mmlu", "--synthetic",
                 "--checkpoint", ckpt, "--output_dir", str(tmp_path / "torch")])
    want.pop("eval_time_s")
    got.pop("eval_time_s")
    assert got == want
    assert set(got) == {"acc/college_physics", "acc/category/STEM", "agg_metrics"}
