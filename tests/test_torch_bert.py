"""The port's BERT stack (``ecoflap_tpu_torch/models/bert.py``) against the
JAX package's ``models/bert.py``: one block (self-attention, cross-attention,
FFN) with its Wanda statistics, the whole forward in decoder, encoder and
text-only mode, and the LM head, tiny and float32 with the same weights
carried across by ``load_jax_params``. Tolerance: 1e-5 (relative and
absolute), float32 computed in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import bert as jbert
from ecoflap_tpu_torch.models import bert as tbert
from ecoflap_tpu_torch.models.convert import load_jax_params
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
MODES = {"decoder": dict(add_cross_attention=True, causal=True),
         "encoder": dict(add_cross_attention=True, causal=False),
         "text_only": dict(add_cross_attention=False, causal=False)}


def pair(mode, lm_head=True, seed=0):
    kw = MODES[mode]
    cfg = jbert.tiny_config(**kw)
    params = jbert.init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = tbert.tiny_config(**kw)
    model = (tbert.BertLMHeadModel(tcfg) if lm_head else tbert.BertModel(tcfg)).eval()
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def inputs(cfg, n=3, s=7, n_enc=5, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(2, cfg.vocab_size, size=(n, s))
    mask = np.ones((n, s), np.int64)
    mask[0, 5:] = 0
    enc = rng.normal(size=(n, n_enc, cfg.encoder_width)).astype(np.float32)
    enc_mask = np.ones((n, n_enc), np.int64)
    enc_mask[1, 3:] = 0
    return ids, mask, enc, enc_mask


def close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_block_and_its_wanda_statistics_match_jax(mode):
    cfg, params, model = pair(mode)
    ids, mask, enc, enc_mask = inputs(cfg)
    cross = cfg.add_cross_attention
    jcache = jbert.make_cache(cfg, jnp.asarray(mask), jnp.asarray(enc) if cross else None,
                              jnp.asarray(enc_mask) if cross else None, ids.shape[1])
    x = jbert.embed(cfg, params, jnp.asarray(ids))
    tx = model.bert.embed(torch.from_numpy(ids))
    close(tx, x)
    tcache = tbert.make_cache(model.cfg, torch.from_numpy(mask),
                              torch.from_numpy(enc) if cross else None,
                              torch.from_numpy(enc_mask) if cross else None)
    for i in range(cfg.num_layers):
        bp = jax.tree_util.tree_map(lambda a: a[i], params["blocks"])
        want, wstats = jbert.block_forward(cfg, bp, x, jcache, "wanda")
        got, gstats = model.bert.encoder.layer[i](tx, tcache, collect="wanda")
        close(got, want)
        names = tbert.LINEAR_NAMES if cross else tbert.LINEAR_NAMES_NO_CROSS
        assert set(gstats) == set(wstats) == set(names)
        for k in names:
            close(gstats[k], wstats[k])
        x, tx = want, torch.from_numpy(np.asarray(want))


@pytest.mark.parametrize("mode", sorted(MODES))
def test_forward_and_lm_logits_match_jax(mode):
    cfg, params, model = pair(mode, seed=1)
    ids, mask, enc, enc_mask = inputs(cfg, seed=2)
    cross = cfg.add_cross_attention
    want = jbert.forward(cfg, params, jnp.asarray(ids), jnp.asarray(mask),
                         jnp.asarray(enc) if cross else None,
                         jnp.asarray(enc_mask) if cross else None)
    with torch.no_grad():
        got = model(torch.from_numpy(ids), torch.from_numpy(mask),
                    torch.from_numpy(enc) if cross else None,
                    torch.from_numpy(enc_mask) if cross else None)
        close(got, want)
        logits = model.lm_logits(got)
    assert logits.dtype == torch.float32
    close(logits, jbert.lm_logits(cfg, params, want))


def test_encoder_tower_has_no_lm_head_and_the_reference_keys():
    """A bare ``BertModel`` (the VQA, retrieval and NLVR text encoders) holds
    the UPop ``text_encoder.`` keys: embeddings and encoder layers only."""
    cfg, params, model = pair("encoder", lm_head=False, seed=2)
    keys = set(model.state_dict())
    assert not any(k.startswith("cls.") for k in keys)
    assert "encoder.layer.1.crossattention.self.key.weight" in keys
    assert "embeddings.word_embeddings.weight" in keys
    ids, mask, enc, enc_mask = inputs(cfg, seed=3)
    want = jbert.forward(cfg, params, *(jnp.asarray(a) for a in (ids, mask, enc, enc_mask)))
    with torch.no_grad():
        close(model(*(torch.from_numpy(a) for a in (ids, mask, enc, enc_mask))), want)


def test_lm_head_decoder_is_tied_to_the_word_embedding():
    _, _, model = pair("decoder", seed=3)
    p = model.cls.predictions
    assert p.decoder.weight is model.bert.embeddings.word_embeddings.weight
    assert p.decoder.bias is p.bias
    sd = model.state_dict()
    assert torch.equal(sd["cls.predictions.decoder.weight"],
                       sd["bert.embeddings.word_embeddings.weight"])
