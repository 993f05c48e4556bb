"""The port's LLaMA (``ecoflap_tpu_torch/models/llama.py``) and its prune
path against the JAX package's on tiny shapes, float32, same weights.

Tolerances: forward losses and logits rtol 1e-5 (float32, other reduction
orders); MeZO scores rtol 1e-3 plus a float32 floor of 2e-5 at eps = 0.2, as
tests/test_torch_mezo.py states it; sparsity ratios within 1e-9 and Wanda
masks equal, since equal scores feed one integer allocator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu.pruning.mezo import mezo_leaf_scores as jscores
from ecoflap_tpu.utils.checkpoint import export_llama
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.models.convert import jax_to_state_dict
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores as tscores
from tests.torch_parity import jax_noise, llama_pair, lm_batch, to_jax, to_torch

RTOL = 1e-5
EPS = 0.2
S_RTOL, S_ATOL = 1e-3, 2e-5
SPEC = "2-0.4-1.0-1.0"  # keep ratio 0.4: sparsity 0.6 (tests/test_llama.py:76)
COARSE = dict(prune_spec=SPEC, sparsity_ratio_granularity="block",
              max_sparsity_per_layer=0.7, score_method="MEZO-GradOnly_sum",
              num_data_first_stage=4, noise_eps=EPS, verbose=False)


@pytest.fixture(scope="module")
def pair():
    return llama_pair(seed=0)


@pytest.mark.parametrize("kv_heads", [4, 2])
@pytest.mark.parametrize("padded", [False, True])
def test_logits_and_per_sample_loss_match_jax(kv_heads, padded):
    """Pure causal (bias None) and a padding mask (the bias path), with and
    without grouped-query attention."""
    cfg, params, model = llama_pair(seed=1, num_kv_heads=kv_heads)
    ids = lm_batch(cfg, n=4, seqlen=12, seed=2)["input_ids"]
    mask = np.ones_like(ids)
    mask[1, 8:] = 0
    mask[3, 5:] = 0
    jm, tm = (jnp.asarray(mask), torch.from_numpy(mask)) if padded else (None, None)
    jids, tids = jnp.asarray(ids, jnp.int32), torch.from_numpy(ids)
    want = np.asarray(jllama.forward(cfg, params, jids, jm))
    got = model(tids, tm)
    assert got.dtype == torch.float32 and got.shape == (4, 12, cfg.vocab_size)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=1e-5)
    want_loss = np.asarray(jllama.per_sample_loss(cfg, params, jids, jm))
    np.testing.assert_allclose(model.per_sample_loss(tids, tm).numpy(), want_loss,
                               rtol=RTOL)


def test_causality(pair):
    """tests/test_llama.py:40-48 on the port: the last token moves no
    earlier logit."""
    cfg, _, model = pair
    ids = torch.from_numpy(lm_batch(cfg, n=4, seqlen=10)["input_ids"])
    ids2 = ids.clone()
    ids2[:, -1] = (ids2[:, -1] + 1) % cfg.vocab_size
    with torch.no_grad():
        a, b = model(ids), model(ids2)
    assert torch.equal(a[:, :-1], b[:, :-1])
    assert not torch.equal(a[:, -1], b[:, -1])


def test_rope_tables_match_jax_and_never_lead_with_the_batch():
    cfg = jllama.tiny_config()
    jc, js = jllama.rope_cos_sin(cfg, 32)
    tc, ts = tllama.rope_cos_sin(tllama.tiny_config(), 32)
    assert tc.shape == (1, 1, 32, cfg.head_dim)
    np.testing.assert_allclose(tc[0, 0].numpy(), np.asarray(jc), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ts[0, 0].numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)


def test_state_dict_names_are_the_hf_export_names(pair):
    """The port's parameter names are those ``export_llama`` writes, and the
    converted values are the exported ones."""
    cfg, params, model = pair
    want = export_llama(params, cfg)
    got = jax_to_state_dict({k: np.asarray(v) for k, v in flatten_named(params).items()},
                            model.cfg)
    assert set(got) == set(want) == set(model.state_dict())
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k], np.float32), want[k], err_msg=k)
    targets = [t.name for t in tllama.make_adapter(model).targets()]
    assert len(targets) == 7 * cfg.num_layers
    assert targets[0] == "model.layers.0.self_attn.q_proj.weight"


def test_suffix_plan_loss_from_hidden_matches_the_jax_plan(pair):
    """The rolling cache advanced to block 1 and the tail from there
    (``loss_from_hidden``), port plan vs JAX plan."""
    cfg, params, model = pair
    batch = lm_batch(cfg, n=4, seqlen=16, seed=3)
    jb, tb = to_jax(batch), to_torch(batch)
    jplan = jllama.make_adapter(cfg, params).build_mezo_plans(params, jb)[0]
    tplan = tllama.make_adapter(model).build_mezo_plans(model, tb)[0]
    for name in ("model.layers.0.mlp.up_proj.weight", "model.layers.1.self_attn.o_proj.weight"):
        want = np.asarray(jplan.loss_fn(params, jplan.prepare(params, name)))
        got = tplan.loss_fn(model, tplan.prepare(model, name))
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    with torch.no_grad():
        full = model.per_sample_loss(tb["input_ids"])
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=RTOL)


def test_perplexity_matches_jax(pair):
    cfg, params, model = pair
    stream = np.random.default_rng(2).integers(2, cfg.vocab_size, size=(64,))
    want = jllama.perplexity(cfg, params, jnp.asarray(stream, jnp.int32), seqlen=16,
                             batch_size=2)
    got = tllama.perplexity(model, torch.from_numpy(stream), seqlen=16, batch_size=2)
    assert np.isfinite(got) and got > 1.0
    assert abs(got - want) <= RTOL * want


@pytest.fixture(scope="module")
def scores(pair):
    cfg, params, model = pair
    batch = lm_batch(cfg, n=8, seqlen=16, seed=4)
    key = jax.random.PRNGKey(7)
    jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
    jb, tb = to_jax(batch), to_torch(batch)
    js = jscores(jad.loss_fn, params, jb, 2, jad.targets(), eps=EPS, key=key,
                 loss_plans=jad.build_mezo_plans(params, jb))
    ts = tscores(tad.loss_fn, model, tb, 2, tad.targets(), eps=EPS,
                 noise=jax_noise(key), loss_plans=tad.build_mezo_plans(model, tb))
    return {k: float(v) for k, v in js.items()}, ts


def test_mezo_leaf_scores_match_jax(scores):
    js, ts = scores
    assert list(ts) == list(js) and len(ts) == 14
    for k in js:
        assert abs(ts[k] - js[k]) <= S_RTOL * abs(js[k]) + S_ATOL, (k, ts[k], js[k])
    assert len(set(ts.values())) == len(ts)


def test_coarse_batch_equal_to_seqlen_scores_as_jax_does():
    """A coarse batch of exactly ``seqlen`` samples (32 windows of 32): the
    microbatch slicer must cut the windows and not the rotary tables. The
    JAX suffix plan cuts its (S, Dh) tables at this shape and fails, so the
    JAX reference here is its plain loss (no plan), which computes the same
    losses; the port runs its suffix plan."""
    cfg, params, model = llama_pair(seed=5)
    batch = lm_batch(cfg, n=32, seqlen=32, seed=6)
    key = jax.random.PRNGKey(8)
    jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
    jt, tt = jad.targets()[::3], tad.targets()[::3]
    js = jscores(jad.loss_fn, params, to_jax(batch), 4, jt, eps=EPS, key=key)
    tb = to_torch(batch)
    ts = tscores(tad.loss_fn, model, tb, 4, tt, eps=EPS, noise=jax_noise(key),
                 loss_plans=tad.build_mezo_plans(model, tb))
    assert list(ts) == [t.name for t in jt]
    for k in js:
        want = float(js[k])
        assert abs(ts[k] - want) <= S_RTOL * abs(want) + S_ATOL, (k, ts[k], want)


def _zero_patterns(jparams, jad, model, tad):
    jt = {t.name: t for t in jad.targets()}
    return {t.name: (np.asarray(jt[t.name].get(jparams)) == 0,
                     (t.weight(model) == 0).numpy())
            for t in tad.targets()}


@pytest.fixture(scope="module")
def pruned():
    """Both packages' two-stage prune of one tiny LLaMA with the flags of
    tests/test_llama.py:70-90 (eps 0.2 for float32 headroom)."""
    cfg, params, model = llama_pair(seed=0)
    batch = lm_batch(cfg, n=8, seqlen=10, seed=0)
    key = jax.random.PRNGKey(5)
    jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
    jp = jload("llama_wanda_pruner", jad, to_jax(batch), 2, {**COARSE, "key": key})
    jparams, jdict = jp.prune()
    tp = tload("llama_wanda_pruner", tad, to_torch(batch), 2,
               {**COARSE, "noise": jax_noise(key)})
    _, tdict = tp.prune()
    return jdict, tdict, _zero_patterns(jparams, jad, model, tad), tp


def test_two_stage_prune_gives_the_jax_sparsity_dict(pruned):
    jdict, tdict, _, _ = pruned
    assert list(tdict) == list(jdict) and len(tdict) == 14
    for k in jdict:
        assert abs(tdict[k] - float(jdict[k])) <= 1e-9, (k, tdict[k], jdict[k])
    assert max(tdict.values()) <= 0.7 + 1e-9


def test_two_stage_prune_gives_the_jax_masks(pruned):
    _, _, patterns, tp = pruned
    assert len(patterns) == 14
    for name, (want, got) in patterns.items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert 0.45 <= tp.check_sparsity() <= 0.75
    assert set(tp.phase_times) == {"coarse_s"} | {
        f"fine_model.layers_{part}" for part in ("s", "collect_s", "prune_s", "reforward_s")}


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_chunked_fine_stage_gives_the_whole_batch_masks(chunk):
    """The fine stage streamed ``chunk`` samples per forward (the pruner's
    microbatches) prunes exactly as one whole-batch forward does."""
    cfg, _, whole = llama_pair(seed=3)
    _, _, chunked = llama_pair(seed=3)
    batch = to_torch(lm_batch(cfg, n=8, seqlen=16, seed=7))
    rng = np.random.default_rng(9)
    names = [t.name for t in tllama.make_adapter(whole).targets()]
    sd = {n: float(rng.choice([0.3, 0.5, 0.6])) for n in names}
    given = dict(prune_spec=SPEC, sparsity_dict=sd, verbose=False)
    tload("llama_wanda_pruner", tllama.make_adapter(whole), batch, 1, given).prune()
    tload("llama_wanda_pruner", tllama.make_adapter(chunked), batch, 8 // chunk,
          given).prune()
    for n, p in whole.state_dict().items():
        assert torch.equal(p == 0, chunked.state_dict()[n] == 0), n
    with pytest.raises(ValueError, match="divide"):
        tload("llama_wanda_pruner", tllama.make_adapter(chunked), batch, 3,
              given).prune()


CLI = ["--model", "llama", "--model_scale", "tiny", "--seed", "3",
       "--pruning_method", "llama_wanda_pruner", "--prune_spec", SPEC,
       "--sparsity_ratio_granularity", "block", "--score_method", "MEZO-GradOnly_sum",
       "--max_sparsity_per_layer", "0.7", "--num_data_first_stage", "8",
       "--num_samples", "16", "--batch_size", "4"]


def test_cli_calibration_windows_equal_the_jax_clis():
    from ecoflap_tpu.cli import prune as jcli
    from ecoflap_tpu_torch.cli import prune as tcli

    _, jbatch, jnum, jspecs = jcli._configs(jcli.build_parser().parse_args(
        CLI + ["--platform", "cpu"]))
    _, tbatch, tnum, tspecs = tcli._llama(
        tcli.build_parser().parse_args(CLI + ["--device", "cpu"]),
        torch.device("cpu"), torch.float32)
    assert tbatch["input_ids"].shape == (16, 32)  # seqlen 32 at tiny
    np.testing.assert_array_equal(tbatch["input_ids"].numpy(),
                                  np.asarray(jbatch["input_ids"]))
    assert (tnum, tspecs) == (jnum, jspecs) == (4, {"model.layers": SPEC})


def test_cli_prunes_tiny_llama_on_the_cpu(tmp_path):
    from ecoflap_tpu_torch.cli.prune import main
    from ecoflap_tpu_torch.runners.runner import read_flat_yaml

    res = main(CLI + ["--device", "cpu", "--output_dir", str(tmp_path)])
    sd = read_flat_yaml(res["sparsity_dict"])
    assert len(sd) == 14 and "model.layers.1.mlp.down_proj.weight" in sd
    assert max(sd.values()) <= 0.7 + 1e-9
    # the allocator spends the 0.6 budget exactly, by parameter count; Wanda
    # then prunes floor(cols * ratio) weights of each row (the reference's
    # rounding), which at these 32- and 64-wide rows alone moves the pruned
    # share by up to 1/32, in a direction the noise draw decides. So the
    # realized sparsity is checked against that exact count
    shapes = {n: p.shape for n, p in tllama.build_model(
        tllama.tiny_config(), device="cpu", dtype=torch.float32, seed=3).state_dict().items()}
    sizes = {n: shapes[n] for n in sd}
    numel = sum(r * c for r, c in sizes.values())
    assert abs(sum(sd[n] * r * c for n, (r, c) in sizes.items()) / numel - 0.6) < 1e-6
    pruned = sum(r * int(np.float32(sd[n]) * np.float32(c)) for n, (r, c) in sizes.items())
    assert abs(res["prunable_sparsity"] - pruned / numel) <= 5e-5  # printed to 4 places
    assert len(res["leaf_scores"]) == 14
    assert set(res["phase_times"]) == {"coarse_s"} | {
        f"fine_model.layers_{part}" for part in ("s", "collect_s", "prune_s", "reforward_s")}
    assert res["peak_gib"] is None
