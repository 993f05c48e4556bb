"""CLIP (OpenAI ViT, CoOp) and EVA-CLIP in the port against the JAX package,
tiny and float32, the same weights carried across by ``load_jax_params``:
the towers, the losses, the zero-shot classifier and its logits, the causal
mask, MeZO scores with the JAX noise injected, both prune CLIs from one
``.pth``, the ``.pth`` names (OpenAI's, read back by the JAX
``convert_clip``) and EVA-CLIP's export without its last block.

Tolerances: RTOL 1e-5 on features, losses and logits (float32, a few ulps
through 2-3 blocks, the L2 normalisation and a softmax), with an absolute
floor of RTOL times the largest magnitude of the tensor; MeZO scores as
tests/test_torch_mezo.py (rtol 1e-3 beyond a floor of a few float32 ulps
of the losses over 2 eps)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.cli.prune import main as jmain
from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import clip as jclip
from ecoflap_tpu.models.layers import causal_bias as jcausal_bias
from ecoflap_tpu.pruning.mezo import mezo_leaf_scores as jscores
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.prune import main as tmain
from ecoflap_tpu_torch.models import clip as tclip
from ecoflap_tpu_torch.models.convert import load_jax_params
from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores as tscores
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from ecoflap_tpu_torch.utils.checkpoint import (
    export_eva_clip_visual,
    export_state_dict,
    load_into,
    save_torch_checkpoint,
)
from tests.torch_parity import jax_noise, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
EPS = 0.2
MEZO_RTOL, MEZO_ATOL = 1e-3, 2e-5
KINDS = ["clip", "eva_clip"]


def clip_pair(eva, seed=0):
    """(cfg, JAX params, port model with the same weights), float32."""
    cfg = jclip.tiny_config(eva=eva)
    params = jclip.init_params(cfg, jax.random.PRNGKey(seed))
    model = tclip.build_model(tclip.tiny_config(eva=eva), device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def clip_batch(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, cfg.text.vocab_size, size=(n, cfg.text.context_length))
    ids[:, -3:] = 0
    ids[np.arange(n), rng.integers(3, cfg.text.context_length - 3, size=n)] = (
        cfg.text.vocab_size - 1)  # the EOT id, the row's argmax, mid-sequence
    img = (cfg.eva_visual or cfg.visual).img_size
    return {"image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
            "text_ids": ids, "label": rng.integers(0, 5, size=(n,))}


def jax_of(b):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
            for k, v in b.items()}


def torch_of(b):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in b.items()}


@pytest.fixture(scope="module", params=KINDS)
def pair(request):
    return (request.param,) + clip_pair(request.param == "eva_clip")


def close(got, want, rtol=RTOL):
    """Elementwise rtol, with an absolute floor of rtol times the largest
    magnitude: entries near 0 (a cosine of 1e-3 scaled by 14) carry the
    rounding of the larger terms they were summed from."""
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


def test_towers_and_losses_match_jax(pair):
    _, cfg, params, model = pair
    b = clip_batch(cfg)
    jb, tb = jax_of(b), torch_of(b)
    close(model.encode_image(tb["image"]), jclip.encode_image(cfg, params, jb["image"]))
    close(model.encode_text(tb["text_ids"]), jclip.encode_text(cfg, params, jb["text_ids"]))
    per_image, per_text = model.logits(tb["image"], tb["text_ids"])
    want_image, want_text = jclip.logits(cfg, params, jb["image"], jb["text_ids"])
    close(per_image, want_image)
    close(per_text, want_text)
    close(model.contrastive_loss(tb), jclip.contrastive_loss(cfg, params, jb))


def test_zero_shot_classifier_predict_and_ce_match_jax(pair):
    _, cfg, params, model = pair
    b = clip_batch(cfg, seed=1)
    prompts = clip_batch(cfg, n=5 * 3, seed=2)["text_ids"]  # 5 classes x 3 templates
    want_cls = jclip.zero_shot_classifier(cfg, params, jnp.asarray(prompts, jnp.int32), 5)
    got_cls = model.zero_shot_classifier(torch.from_numpy(prompts), 5)
    close(got_cls, want_cls)
    # encoding the prompts a few at a time changes nothing
    torch.testing.assert_close(model.zero_shot_classifier(torch.from_numpy(prompts), 5,
                                                          chunk=4), got_cls)
    jb, tb = jax_of(b), torch_of(b)
    close(model.predict(tb["image"], got_cls), jclip.predict(cfg, params, jb["image"],
                                                              want_cls))
    close(model.zero_shot_ce_loss(tb, got_cls),
          jclip.zero_shot_ce_loss(cfg, params, jb, want_cls))


def test_text_tower_is_causal(pair):
    """The causal bias is the JAX one, and a text feature (pooled at the EOT
    id) does not move when tokens after it change."""
    _, cfg, params, model = pair
    s = cfg.text.context_length
    np.testing.assert_array_equal(tclip.causal_bias(s, "cpu").numpy(),
                                  np.asarray(jcausal_bias(s)))
    ids = torch.from_numpy(clip_batch(cfg, n=4, seed=3)["text_ids"])
    eot = ids.argmax(dim=-1)
    later = ids.clone()
    for r in range(4):
        later[r, eot[r] + 1:] = torch.randint(1, cfg.text.vocab_size - 1,
                                              (s - 1 - eot[r].item(),))
    torch.testing.assert_close(model.encode_text(later), model.encode_text(ids),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("with_classifier", [False, True], ids=["contrastive", "zero_shot"])
def test_mezo_leaf_scores_match_jax(pair, with_classifier):
    """The serial in-place cycle on the whole loss, the JAX draws injected:
    the contrastive loss over both towers (EVA-CLIP: the visual tower), or
    LAVIS's zero-shot CE over the visual tower."""
    kind, cfg, params, model = pair
    b = clip_batch(cfg, seed=4)
    jcls = tcls = None
    if with_classifier:
        prompts = clip_batch(cfg, n=5 * 2, seed=5)["text_ids"]
        jcls = jclip.zero_shot_classifier(cfg, params, jnp.asarray(prompts, jnp.int32), 5)
        tcls = model.zero_shot_classifier(torch.from_numpy(prompts), 5)
    include_text = kind == "clip"
    jad = jclip.make_adapter(cfg, params, include_text=include_text, classifier=jcls)
    tad = tclip.make_adapter(model, include_text=include_text, classifier=tcls)
    assert [s.name for s in tad.stacks] == [s.name for s in jad.stacks]
    assert [s.per_row_mask for s in tad.stacks] == [s.per_row_mask for s in jad.stacks]
    assert tad.model_prefixes == jad.model_prefixes
    key = jax.random.PRNGKey(13)
    js = jscores(jad.loss_fn, params, jax_of(b), 2, jad.targets(), eps=EPS, key=key)
    ts = tscores(tad.loss_fn, model, torch_of(b), 2, tad.targets(), eps=EPS,
                 noise=jax_noise(key))
    assert list(ts) == list(js) == [t.name for t in jad.targets()]
    for k in js:
        assert abs(ts[k] - float(js[k])) <= MEZO_RTOL * abs(float(js[k])) + MEZO_ATOL, k


@pytest.mark.parametrize("kind", KINDS)
def test_pth_names_are_openai_and_read_back_by_convert_clip(kind, tmp_path):
    """The state dict is OpenAI's (``attn.in_proj_weight``), and the JAX
    ``convert_clip`` reads the port's ``.pth`` into the same parameters;
    ``load_into`` reads it back into a fresh port model."""
    cfg, params, model = clip_pair(kind == "eva_clip", seed=3)
    state = export_state_dict(model)
    assert "transformer.resblocks.0.attn.in_proj_weight" in state
    assert not any(".in_proj." in k for k in state)
    path = str(tmp_path / f"{kind}.pth")
    save_torch_checkpoint(state, path)
    back = flatten_named(jck.convert_clip(jck.load_torch_checkpoint(path), cfg))
    want = flatten_named(params)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(want[k]), err_msg=k)
    fresh = tclip.build_model(model.cfg, device="cpu", seed=None)
    assert load_into(fresh, torch.load(path, weights_only=True)) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_eva_export_drops_the_last_block():
    cfg, params, model = clip_pair(eva=True, seed=1)
    got = export_eva_clip_visual(model)
    last = f"blocks.{cfg.eva_visual.depth - 1}."
    want = {k: v for k, v in jck.export_eva_vit(params["visual"], cfg.eva_visual,
                                                  prefix="visual.").items()
            if last not in k}
    assert sorted(got) == sorted(want)
    assert not any(last in k for k in got)
    assert f"visual.blocks.{cfg.eva_visual.depth - 2}.mlp.fc2.weight" in got
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(v), err_msg=k)


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    root = tmp_path_factory.mktemp("clip_ckpt")
    out = {}
    for kind in KINDS:
        _, _, model = clip_pair(kind == "eva_clip", seed=2)
        out[kind] = str(root / f"{kind}.pth")
        save_torch_checkpoint(export_state_dict(model), out[kind])
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_cli_prunes_as_the_jax_cli(tmp_path, ckpts, kind):
    """Both CLIs from one ``.pth`` with the CoOp launcher's flags at tiny
    size and a first-order coarse stage (the same scores on both sides): the
    same job id, sparsity dict (rtol 1e-5) and masks. The port writes the
    pruned model as a ``.pth`` where the JAX CLI writes CLIP's as an orbax
    checkpoint (``--save_pruned``) and EVA-CLIP's as a ``.pth`` of the
    visual tower without its last block."""
    from ecoflap_tpu.runners.runner import Runner as JRunner

    method = "clip_wanda_pruner" if kind == "clip" else "vit_wanda_pruner"
    common = ["--model", kind, "--model_scale", "tiny", "--ckpt", ckpts[kind],
              "--pruning_method", method, "--prune_spec", "2-0.6-1.0-1.0",
              "--sparsity_ratio_granularity", "block", "--max_sparsity_per_layer", "0.5",
              "--score_method", "GradOnly_sum", "--num_samples", "16", "--batch_size", "8",
              "--num_data_first_stage", "16"]
    jsave = "--save_pruned" if kind == "clip" else "--save_pruned_model"
    want = jmain(common + [jsave, "--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tmain(common + ["--save_pruned_model", "--device", "cpu",
                          "--output_dir", str(tmp_path / "torch")])
    assert got["job_id"] == want["job_id"] == f"{method}_2-0.6-1.0-1.0_GradOnly_sum_block"
    jd, td = read_flat_yaml(want["sparsity_dict"]), read_flat_yaml(got["sparsity_dict"])
    assert list(td) == list(jd) and len(td) == (16 if kind == "clip" else 12)
    for k in jd:
        assert td[k] == pytest.approx(jd[k], rel=RTOL), k
    assert got["prunable_sparsity"] == want["prunable_sparsity"]
    b = torch.load(got["pth"], weights_only=True)
    if kind == "eva_clip":
        a = torch.load(want["pth"], weights_only=True)
        assert sorted(a) == sorted(b)
        for k in a:
            assert torch.equal(a[k] == 0, b[k] == 0), k
        return
    cfg = jclip.tiny_config()
    pruned = flatten_named(JRunner(str(tmp_path / "jax")).load_checkpoint(
        jclip.init_params(cfg, jax.random.PRNGKey(0)), want["checkpoint"]))
    ours = flatten_named(jck.convert_clip({k: v.numpy() for k, v in b.items()}, cfg))
    kernels = [k for k in pruned if k.endswith(".kernel") and ".blocks." in k]
    assert len(kernels) == 8
    for k in kernels:
        np.testing.assert_array_equal(np.asarray(ours[k]) == 0, np.asarray(pruned[k]) == 0,
                                      err_msg=k)
