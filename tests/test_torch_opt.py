"""OPT and BLIP-2 OPT in the port against the JAX package, tiny and float32,
the same weights carried across by ``load_jax_params``: OPT's logits and
per-sample loss with a padding mask, the cached decode step against
teacher forcing, tiny BLIP-2 OPT's greedy and 5-beam tokens, the OPT and
BLIP-2 OPT checkpoints both ways, both adapters' losses (BLIP-2
OPT's LossPlan too), and the evaluate CLI's ``blip2_opt`` captioning branch
against the JAX CLI's.

For generation the tiny model's kernels are scaled 5x (so the tokens vary)
and its final LayerNorm bias and EOS embedding row are set so that rows
finish, some before the last step: beam search's finished set, the
min-length mask (8, counting the prompt's 3 tokens) and pad after EOS are
all exercised. Tokens must be equal; logits and losses within RTOL 1e-5 of
the largest magnitude (float32, the same operations in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import blip2_opt as jbo
from ecoflap_tpu.models import opt as jopt
from ecoflap_tpu.models.generation import GenerateConfig as JGen
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.models import blip2_opt as tbo
from ecoflap_tpu_torch.models import opt as topt
from ecoflap_tpu_torch.models.convert import load_jax_params
from ecoflap_tpu_torch.models.generation import GenerateConfig as TGen
from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, load_into
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
KERNEL_SCALE = 5.0
# one compiled program per config (the JAX package's eager init compiles
# every operation apart)
JIT_OPT_INIT = jax.jit(jopt.init_params, static_argnums=0)
JIT_B2O_INIT = jax.jit(jbo.init_params, static_argnums=0)
EOS_BOOST = 0.03


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def opt_pair(seed=0):
    cfg = jopt.tiny_config()
    params = JIT_OPT_INIT(cfg, jax.random.PRNGKey(seed))
    model = topt.build_model(topt.tiny_config(), device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def generating_params(params, seed=7):
    """BLIP-2 OPT params that generate: kernels x KERNEL_SCALE, a random
    final LayerNorm bias, the EOS row of the tied embedding moved along it."""
    params = jax.tree_util.tree_map_with_path(
        lambda path, a: a * KERNEL_SCALE if getattr(path[-1], "key", None) == "kernel" else a,
        params)
    v = np.random.default_rng(seed).normal(size=params["opt_model"]["final_ln"]["bias"].shape)
    op = params["opt_model"]
    op["final_ln"]["bias"] = jnp.asarray(0.5 * v, jnp.float32)
    op["embed_tokens"] = op["embed_tokens"].at[2].add(jnp.asarray(EOS_BOOST * v, jnp.float32))
    return params


def blip2_opt_pair(seed=1, generating=False):
    cfg = jbo.tiny_config()
    params = JIT_B2O_INIT(cfg, jax.random.PRNGKey(seed))
    if generating:
        params = generating_params(params)
    model = tbo.build_model(tbo.tiny_config(), device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def lm_inputs(cfg, n=3, s=10, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(3, cfg.vocab_size, size=(n, s))
    mask = np.ones((n, s), np.int64)
    mask[1, 7:] = 0
    return ids, mask


def vl_batch(cfg, n=4, seed=2):
    rng = np.random.default_rng(seed)
    img = cfg.vit.img_size
    mask = np.ones((n, 5), np.int64)
    mask[2, 3:] = 0
    return {"image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
            "text_ids": rng.integers(3, cfg.opt.vocab_size, size=(n, 5)), "text_mask": mask}


def T(b):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in b.items()}


def J(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def test_opt_logits_loss_and_adapter_match_jax():
    cfg, params, model = opt_pair()
    ids, mask = lm_inputs(cfg)
    close(model(torch.from_numpy(ids), torch.from_numpy(mask)),
          jax.jit(jopt.forward, static_argnums=0)(cfg, params, jnp.asarray(ids),
                                                  jnp.asarray(mask)))
    jloss = jax.jit(jopt.per_sample_loss, static_argnums=0)
    for m in (mask, None):
        want = jloss(cfg, params, jnp.asarray(ids), None if m is None else jnp.asarray(m))
        close(model.per_sample_loss(torch.from_numpy(ids),
                                    None if m is None else torch.from_numpy(m)), want)
    jad, tad = jopt.make_adapter(cfg, params), topt.make_adapter(model)
    batch = {"input_ids": ids, "attn_mask": mask}
    close(tad.loss_fn(model, T(batch)), jax.jit(jad.loss_fn)(params, J(batch)))
    assert [t.name for t in tad.targets()] == [t.name for t in jad.targets()]
    assert tad.model_prefixes == jad.model_prefixes
    assert [s.per_row_mask for s in tad.stacks] == [True]


def test_cached_step_matches_teacher_forcing():
    """Greedy tokens through the prefilled cache equal the argmax loop over
    full forwards, and every step's logits equal the full forward's at that
    position (a prompt of 4 tokens, 6 steps)."""
    cfg, params, model = opt_pair(seed=3)
    ids = torch.from_numpy(np.random.default_rng(4).integers(3, cfg.vocab_size, size=(2, 4)))
    gen = TGen(max_new_tokens=6, num_beams=1, eos_token_id=cfg.eos_token_id,
               pad_token_id=cfg.pad_token_id)
    prefix = model.embed(ids)[:, :-1]
    toks = topt.generate_from_embeds(model, prefix, torch.ones(2, 3, dtype=torch.long),
                                     ids[:, -1], gen, use_beam=False, pos0=3, len_offset=3)
    seq = ids
    for p in range(6):
        logits = model(seq)[:, -1]
        nxt = logits.argmax(-1)
        assert torch.equal(nxt, toks[:, p]), p
        seq = torch.cat([seq, nxt[:, None]], dim=1)
    cache = topt.init_gen_cache(model, prefix, torch.ones(2, 3, dtype=torch.long), 6)
    step = topt.make_opt_step_fn(model, 3, 3, 6)
    full = model(seq)
    tok = ids[:, -1]
    for p in range(6):
        logits, cache = step(tok, p, cache)
        torch.testing.assert_close(logits, full[:, 3 + p], rtol=1e-5, atol=1e-5)
        tok = toks[:, p]


@pytest.mark.parametrize("num_beams,length_penalty", [(1, 1.0), (5, 1.0), (5, -1.0)],
                         ids=["greedy", "beam5", "beam5_lp-1"])
def test_blip2_opt_generates_the_jax_tokens(num_beams, length_penalty):
    cfg, params, model = blip2_opt_pair(generating=True)
    rng = np.random.default_rng(8)
    images = rng.normal(size=(6, 16, 16, 3)).astype(np.float32)
    prompt = np.repeat(rng.integers(3, 64, size=(1, 3)), 6, axis=0)
    point = dict(max_new_tokens=12, num_beams=num_beams, min_length=8,
                 length_penalty=length_penalty, eos_token_id=2, pad_token_id=1)
    want = np.asarray(jbo.generate(cfg, params, jnp.asarray(images), jnp.asarray(prompt),
                                   jnp.ones(prompt.shape, jnp.int32), JGen(**point)))
    got = model.generate(torch.from_numpy(images), torch.from_numpy(prompt),
                         torch.ones(prompt.shape, dtype=torch.long), TGen(**point)).numpy()
    np.testing.assert_array_equal(got, want)
    rows = got.tolist()
    finished = [r.index(2) for r in rows if 2 in r]
    assert finished and min(finished) >= 8 - 3, finished  # min_length counts the prompt
    assert all(set(r[r.index(2) + 1:]) <= {1} for r in rows if 2 in r)


def test_blip2_opt_losses_and_adapter_match_jax():
    """The text LM loss, the adapter's stacks and targets, and its LossPlan:
    the OPT targets' loss from the precomputed query embeds equals the full
    loss."""
    cfg, params, model = blip2_opt_pair()
    b = vl_batch(cfg)
    want = jax.jit(jbo.per_sample_loss, static_argnums=0)(cfg, params, J(b))
    close(model.per_sample_loss(T(b)), want)
    jad, tad = jbo.make_adapter(cfg, params), tbo.make_adapter(model)
    close(tad.loss_fn(model, T(b)), jax.jit(jad.loss_fn)(params, J(b)))
    assert [(s.name, s.per_row_mask) for s in tad.stacks] == [
        (s.name, s.per_row_mask) for s in jad.stacks]
    assert [t.name for t in tad.targets()] == [t.name for t in jad.targets()]
    assert tad.model_prefixes == jad.model_prefixes
    (plan,) = tad.build_mezo_plans(model, T(b))
    assert plan.match("opt_model.model.decoder.layers.0.fc1.weight")
    assert not plan.match("visual_encoder.blocks.0.mlp.fc1.weight")
    close(plan.loss_fn(model, plan.prepare(model, "opt_model.x")), want)


def test_opt_and_blip2_opt_checkpoints_round_trip_with_jax():
    """HF's names are the port's own: the JAX exports read into the port by
    ``load_into`` give the JAX-loaded models' tensors (BLIP-2 OPT's tied
    ``opt_model.lm_head.weight`` the one key ignored); ``export_state_dict``
    writes the JAX exports' other keys and values, which read back through
    the JAX converters into the same params."""
    for build, pair, jexport, jconvert, tied in (
            (topt.build_model, opt_pair, jck.export_opt, jck.convert_opt, set()),
            (tbo.build_model, blip2_opt_pair, jck.export_blip2_opt, jck.convert_blip2_opt,
             {"opt_model.lm_head.weight"})):
        cfg, params, model = pair(seed=5)
        jstate = {k: torch.from_numpy(np.array(v)) for k, v in jexport(params, cfg).items()}
        got = build(model.cfg, device="cpu", seed=None)
        assert load_into(got, jstate) == len(tied)
        for k, v in model.state_dict().items():
            assert torch.equal(got.state_dict()[k], v), k
        state = export_state_dict(got)
        assert sorted(state) == sorted(set(jstate) - tied)
        for k in state:
            assert torch.equal(state[k], jstate[k]), k
        back = flatten_named(jconvert({k: v.numpy() for k, v in state.items()}, cfg))
        for k, v in flatten_named(params).items():
            np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)


def test_captioning_cli_matches_the_jax_cli(tmp_path, monkeypatch):
    """``--model blip2_opt --task captioning`` at tiny: the port's CLI on
    the JAX CLI's init (its ``init_params`` at ``--seed``, loaded into the
    port's model in place of the port's own init) gives the JAX CLI's
    tokens for every batch and its metrics."""
    from ecoflap_tpu.cli.evaluate import main as jmain
    from ecoflap_tpu_torch.cli.evaluate import main as tmain

    seen = {"jax": [], "port": []}
    jgen, tgen = jbo.generate, tbo.Blip2OPT.generate
    monkeypatch.setattr(jbo, "generate", lambda *a, **k: seen["jax"].append(
        np.asarray(jgen(*a, **k))) or seen["jax"][-1])
    monkeypatch.setattr(tbo.Blip2OPT, "generate", lambda *a, **k: seen["port"].append(
        tgen(*a, **k)) or seen["port"][-1])
    build = tbo.build_model

    def jax_weights(cfg, **kw):
        model = build(cfg, **{**kw, "seed": None})
        load_jax_params(model, flatten_named(JIT_B2O_INIT(jbo.tiny_config(),
                                                          jax.random.PRNGKey(42))))
        return model

    monkeypatch.setattr(tbo, "build_model", jax_weights)
    argv = ["--model", "blip2_opt", "--task", "captioning", "--batch_size", "3",
            "--eval_batches", "2", "--max_new_tokens", "10"]
    want = jmain(argv + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tmain(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    assert len(seen["port"]) == len(seen["jax"]) == 2
    for a, b in zip(seen["jax"], seen["port"]):
        np.testing.assert_array_equal(b.numpy(), a)
    for k in want:
        if k != "eval_time_s":
            assert got[k] == want[k], k
    with pytest.raises(SystemExit, match="no mid-scale preset for blip2_opt"):
        tmain(argv + ["--model_scale", "small", "--device", "cpu",
                      "--output_dir", str(tmp_path / "port")])
