"""BLIP-1 caption generation in the port (``models/generation.py:
bert_generate``, the BERT decode step over a self and cross K/V cache)
against the JAX package's ``blip1.generate``: tiny, float32, the same
weights, the CLI's prompt "a picture of" (hash tokens), beam 3 with min
length 5 and greedy. The tokens must be equal; the evaluate CLI's
captioning branch gives the JAX CLI's metrics from the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.models import blip1 as jblip1
from ecoflap_tpu.models.generation import GenerateConfig as JGen
from ecoflap_tpu_torch.data.calibration import HashTokenizer
from ecoflap_tpu_torch.models.generation import GenerateConfig
from tests.torch_parity import blip1_pair, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEP_BIAS = 0.3


@pytest.fixture(scope="module")
def pair():
    """Kernels 10x the init, so the logits spread, and a decoder bias on
    [SEP] that makes rows finish at different steps (EOS, the min-length
    mask and the finished beams all take part)."""
    from ecoflap_tpu.core.pytree import flatten_named
    from ecoflap_tpu_torch.models.convert import load_jax_params

    cfg, params, model = blip1_pair("blip_caption", seed=4, kernel_scale=10.0)
    bias = params["text_decoder"]["cls"]["decoder_bias"]
    params["text_decoder"]["cls"]["decoder_bias"] = bias.at[cfg.text.sep_token_id].set(SEP_BIAS)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def prompt(cfg, n):
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size)
    ids = np.asarray(tok(["a picture of"], max_length=8, add_eos=False, pad=False)[0])
    return np.repeat(ids, n, axis=0)


@pytest.mark.parametrize("beams,max_new,lp", [(3, 20, 1.0), (1, 12, 1.0), (3, 10, -1.0)],
                         ids=["beam3", "greedy", "beam3_lp-1"])
def test_tokens_match_jax(pair, beams, max_new, lp):
    cfg, params, model = pair
    rng = np.random.default_rng(7)
    images = rng.normal(size=(3, cfg.vit.img_size, cfg.vit.img_size, 3)).astype(np.float32)
    ids = prompt(cfg, 3)
    jgen = JGen(max_new_tokens=max_new, num_beams=beams, min_length=5, length_penalty=lp,
                eos_token_id=cfg.text.sep_token_id, pad_token_id=cfg.text.pad_token_id)
    want = np.asarray(jblip1.generate(cfg, params, jnp.asarray(images),
                                      jnp.asarray(ids, jnp.int32), jgen,
                                      use_beam=beams > 1))
    gen = GenerateConfig(max_new_tokens=max_new, num_beams=beams, min_length=5,
                         length_penalty=lp)
    got = model.generate(torch.from_numpy(images), torch.from_numpy(ids), gen,
                         use_beam=beams > 1).numpy()
    np.testing.assert_array_equal(got, want)
    finished = (want == cfg.text.sep_token_id).any(axis=1)
    print(want, finished)


def test_captioning_cli_matches_the_jax_cli(tmp_path):
    """Both CLIs' synthetic captioning (2 batches of 4, beam 3, 20 tokens)
    from the same weights: the JAX CLI's random init at ``--seed``, exported
    to the ``.pth`` the port reads."""
    from ecoflap_tpu.cli.evaluate import main as jmain
    from ecoflap_tpu.utils import checkpoint as jck
    from ecoflap_tpu_torch.cli.evaluate import main as tmain

    cfg = jblip1.tiny_config()
    params = jblip1.init_params(cfg, jax.random.PRNGKey(42))
    pth = str(tmp_path / "caption.pth")
    jck.save_torch_checkpoint(jck.export_blip1(params, cfg, "blip_caption"), pth)
    common = ["--model", "blip1", "--task", "captioning", "--model_scale", "tiny",
              "--batch_size", "4", "--eval_batches", "2", "--num_beams", "3",
              "--max_new_tokens", "20", "--length_penalty", "1.0", "--seed", "42"]
    want = jmain(common + ["--platform", "cpu", "--output_dir", str(tmp_path / "j")])
    got = tmain(common + ["--device", "cpu", "--checkpoint", pth,
                          "--output_dir", str(tmp_path / "t")])
    want.pop("eval_time_s"), got.pop("eval_time_s")
    assert got == want
