"""The port's generation (``ecoflap_tpu_torch/models/generation.py`` and
``Blip2T5.generate``) against the JAX package's, float32 on the CPU, token
for token: T5 beam search and greedy decoding at the reference's decode
points and the edge points of tests/test_generation_hf_parity.py, over
ragged right-padded prompts; the cached step against the teacher-forced
decoder; ``stable_topk`` against ``jax.lax.top_k`` on ties; and tiny
BLIP-2's generate."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import generation as jgen
from ecoflap_tpu.models import t5 as jt5
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import generation as tgen
from ecoflap_tpu_torch.models.convert import load_jax_params
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# (num_beams, max_new_tokens, min_length, length_penalty, repetition_penalty)
# the reference's points (tests/test_generation_hf_parity.py:109-114): VQA
# predict_answers, captioning, captioning with repetition penalty, greedy
REFERENCE_POINTS = [(5, 10, 1, -1.0, 1.0), (5, 30, 1, 1.0, 1.0), (5, 14, 1, 1.0, 1.5),
                    (1, 12, 1, 1.0, 1.0)]
# its edge points (:126-136, :139-145): min_length active with lp 0, beams 2
# and 3, max length reached before EOS, greedy with repetition penalty
EDGE_POINTS = [(3, 8, 5, 0.0, 1.0), (2, 4, 1, -1.0, 1.0), (5, 6, 1, 2.0, 1.0),
               (1, 10, 1, 1.0, 1.3)]


def make_prompts(seed, batch, length, vocab):
    """Ragged right-padded prompts, as tests/test_generation_hf_parity.py
    makes them."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, vocab, size=(batch, length))
    mask = np.ones((batch, length), np.int64)
    for i in range(batch):
        pad = rng.integers(0, length // 2)
        if pad:
            mask[i, length - pad:] = 0
            ids[i, length - pad:] = 0
    return ids, mask


@pytest.fixture(scope="module", params=[0.0, 0.3], ids=["random", "eos_boost"])
def pair(request):
    """Tiny BLIP-2 in both packages, float32, one set of weights. With
    ``eos_boost`` the lm_head's EOS column is raised by 0.3, so most rows
    finish early and beam search's finished set, its early stop and the
    post-EOS padding carry the comparison (at the random init EOS is rare)."""
    cfg = jblip2.tiny_config()
    params = jblip2.init_params(cfg, jax.random.PRNGKey(0), jnp.float32)
    head = params["t5_model"]["lm_head"]["kernel"]
    params["t5_model"]["lm_head"]["kernel"] = head.at[:, cfg.t5.eos_token_id].add(request.param)
    model = tblip2.build_model(tblip2.tiny_config(), device="cpu", dtype=torch.float32,
                               seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model, request.param


def both_generate(pair, ids, mask, point):
    cfg, params, model, _ = pair
    nb, max_new, min_len, lp, rp = point
    kw = dict(max_new_tokens=max_new, num_beams=nb, min_length=min_len,
              length_penalty=lp, repetition_penalty=rp)
    tp = params["t5_model"]
    enc = jt5.encode(cfg.t5, tp, jnp.asarray(ids, jnp.int32), jnp.asarray(mask, jnp.int32))
    want = np.asarray(jgen.t5_generate(cfg.t5, tp, enc, jnp.asarray(mask, jnp.int32),
                                       jgen.GenerateConfig(**kw), use_beam=nb > 1))
    with torch.no_grad():
        tenc = model.t5_model.encode(torch.from_numpy(ids), torch.from_numpy(mask))
    got = tgen.t5_generate(model.t5_model, tenc, torch.from_numpy(mask),
                           tgen.GenerateConfig(**kw), use_beam=nb > 1)
    return want, got


@pytest.mark.parametrize("point", REFERENCE_POINTS + EDGE_POINTS,
                         ids=lambda p: "nb{}_new{}_min{}_lp{}_rp{}".format(*p))
def test_t5_generate_matches_jax_token_for_token(pair, point):
    """Three prompt sets of 12 ragged rows at each point."""
    for seed in range(3):
        ids, mask = make_prompts(100 + seed, 12, 9, pair[0].t5.vocab_size)
        want, got = both_generate(pair, ids, mask, point)
        assert got.dtype == torch.long and got.shape == want.shape
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"prompt seed {seed}")


def test_eos_boost_exercises_finishing(pair):
    """The ``eos_boost`` weights finish most beams before the last step, the
    ``random`` ones almost none: the two fixtures cover both regimes."""
    ids, mask = make_prompts(100, 12, 9, pair[0].t5.vocab_size)
    _, got = both_generate(pair, ids, mask, REFERENCE_POINTS[1])
    finished = (got == 1).any(dim=1).float().mean().item()
    assert finished >= 0.4 if pair[3] else finished <= 0.25
    # after a row's first EOS there is only pad
    for row in got.tolist():
        if 1 in row:
            assert set(row[row.index(1) + 1:]) <= {0}


def test_cached_step_matches_the_teacher_forced_decoder(pair):
    """The KV-cache step, fed greedy's own tokens, gives the logits of the
    port's teacher-forced ``decode`` at every position (float32 scores in
    the step, activation-dtype scores in the full forward: the same in
    float32 up to summation order), and greedy picks their argmax up to the
    first EOS."""
    t5 = pair[2].t5_model
    ids, mask = make_prompts(7, 6, 9, t5.cfg.vocab_size)
    ids, mask = torch.from_numpy(ids), torch.from_numpy(mask)
    gen = tgen.GenerateConfig(max_new_tokens=12, num_beams=1)
    with torch.no_grad():
        enc = t5.encode(ids, mask)
        toks = tgen.t5_generate(t5, enc, mask, gen, use_beam=False)
        dec_in = torch.cat([torch.zeros_like(toks[:, :1]), toks[:, :-1]], dim=1)
        full = t5.decode(enc, mask, dec_in)
        cache = tgen.t5_init_cache(t5, enc, mask, 12)
        step = tgen.make_t5_step_fn(t5, 12)
        steps = []
        for pos in range(12):
            logits, cache = step(dec_in[:, pos], pos, cache)
            steps.append(logits)
    steps = torch.stack(steps, dim=1)
    assert full.dtype == steps.dtype == torch.float32
    torch.testing.assert_close(steps, full, rtol=1e-5, atol=1e-5)
    for row, logits in zip(toks.tolist(), full):
        n = row.index(1) + 1 if 1 in row else len(row)
        assert row[:n] == logits.argmax(-1)[:n].tolist()
        assert set(row[n:]) <= {0}


@pytest.mark.parametrize("k", [1, 5, 10])
def test_stable_topk_matches_lax_top_k_on_ties(k):
    """Equal values in index order, as ``jax.lax.top_k`` puts them: rows of
    small integers (many ties), and beam search's own ties, -1e9 + logp,
    which round to one float32 for every |logp| < 32."""
    rng = np.random.default_rng(k)
    ints = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    logp = np.log(rng.dirichlet(np.ones(40), size=6)).astype(np.float32)
    beams = (np.float32(-1e9) + logp).astype(np.float32)
    beams[:, :3] = logp[:, :3]
    for x in (ints, beams, np.concatenate([ints, -ints], axis=1)):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = tgen.stable_topk(torch.from_numpy(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    assert (beams[:, 3:] == np.float32(-1e9)).all()  # the ties are real


def test_expand_for_beams_is_jnp_repeat():
    x = np.arange(24, dtype=np.float32).reshape(3, 2, 4)
    got = tgen.expand_for_beams({"a": torch.from_numpy(x), "b": [torch.arange(3)]}, 5)
    np.testing.assert_array_equal(got["a"].numpy(), np.asarray(jnp.repeat(x, 5, axis=0)))
    assert got["b"][0].tolist() == np.repeat(np.arange(3), 5).tolist()


@pytest.mark.parametrize("point", [REFERENCE_POINTS[0], REFERENCE_POINTS[1], (1, 10, 1, 1.0, 1.0)],
                         ids=["vqa", "caption", "greedy"])
def test_blip2_generate_matches_jax(pair, point):
    """Images and ragged prompts through the whole model: ViT, Q-Former,
    the T5 encoder and the decode loop."""
    cfg, params, model, _ = pair
    nb, max_new, min_len, lp, rp = point
    rng = np.random.default_rng(5)
    img = cfg.vit.img_size
    images = rng.normal(size=(6, img, img, 3)).astype(np.float32)
    ids, mask = make_prompts(11, 6, 8, cfg.t5.vocab_size)
    kw = dict(max_new_tokens=max_new, num_beams=nb, min_length=min_len,
              length_penalty=lp, repetition_penalty=rp)
    want = np.asarray(jblip2.generate(cfg, params, jnp.asarray(images),
                                      jnp.asarray(ids, jnp.int32),
                                      jnp.asarray(mask, jnp.int32),
                                      jgen.GenerateConfig(**kw), use_beam=nb > 1))
    got = model.generate(torch.from_numpy(images), torch.from_numpy(ids),
                         torch.from_numpy(mask), tgen.GenerateConfig(**kw),
                         use_beam=nb > 1)
    np.testing.assert_array_equal(got.numpy(), want)
