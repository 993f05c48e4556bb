"""The port's model zoo against the JAX zoo (``ecoflap_tpu/models/zoo.py``):
``load_model_and_preprocess`` at ``tiny`` for each of the twelve names, the
port model's calibration loss on the JAX bundle's converted weights, the
processors' classes, the registry, the errors, a ``.pth`` through ``ckpt``,
and the bundle driving ``load_pruner``."""

import concurrent.futures

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.data import processors as jproc
from ecoflap_tpu.models import zoo as jzoo
from ecoflap_tpu_torch.core.registry import registry
from ecoflap_tpu_torch.data import processors as tproc
from ecoflap_tpu_torch.models import ModelBundle, load_model, load_model_and_preprocess
from ecoflap_tpu_torch.models.convert import load_jax_params
from tests.torch_parity import np_batch, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NAMES = ("blip2_t5", "t5", "clip", "eva_clip", "blip_caption", "blip_vqa", "blip_nlvr",
         "blip_retrieval", "blip2_opt", "llama", "deit", "convnext")


def _batch(name, cfg, n=4):
    """A numpy calibration batch of the family's adapter, from seed 0."""
    from ecoflap_tpu_torch.cli.upop import build_batch

    rng = np.random.default_rng(0)
    if name == "blip2_t5":
        return np_batch(cfg, n=n)
    if name.startswith("blip_"):
        return build_batch(name[len("blip_"):], cfg, n)
    if name == "t5":
        labels = rng.integers(2, cfg.vocab_size, size=(n, 6))
        labels[:, 4:] = -100
        return {"input_ids": rng.integers(2, cfg.vocab_size, size=(n, 7)),
                "attn_mask": np.ones((n, 7), np.int64), "labels": labels}
    if name in ("clip", "eva_clip"):
        ids = rng.integers(1, cfg.text.vocab_size, size=(n, cfg.text.context_length))
        ids[:, -1] = cfg.text.vocab_size - 1
        img = (cfg.eva_visual or cfg.visual).img_size
        return {"image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
                "text_ids": ids, "label": rng.integers(0, 5, size=(n,))}
    if name == "blip2_opt":
        img = cfg.vit.img_size
        return {"image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
                "text_ids": rng.integers(3, cfg.opt.vocab_size, size=(n, 5)),
                "text_mask": np.ones((n, 5), np.int64)}
    if name == "llama":
        return {"input_ids": rng.integers(2, cfg.vocab_size, size=(n, 12))}
    ncls = cfg.num_classes if name == "convnext" else cfg.head_dim
    return {"image": rng.normal(size=(n, cfg.img_size, cfg.img_size, 3)).astype(np.float32),
            "label": rng.integers(0, ncls, size=(n,))}


def _jax(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


PROCESSOR_PAIRS = {jproc.ImageEvalProcessor: tproc.ImageEvalProcessor,
                   jproc.ImageTrainProcessor: tproc.ImageTrainProcessor,
                   jproc.BlipImageTrainProcessor: tproc.BlipImageTrainProcessor,
                   jproc.CaptionProcessor: tproc.CaptionProcessor,
                   jproc.QuestionProcessor: tproc.QuestionProcessor}


def _counterpart(jp, tp):
    if jp is None or jp is str:
        return tp is jp
    return type(tp) is PROCESSOR_PAIRS[type(jp)]


def _jax_side(name, cfg):
    """The JAX bundle of ``name`` at tiny and its calibration loss on the
    family's batch."""
    jb, jvis, jtxt = jzoo.load_model_and_preprocess(name, "tiny")
    jad = jb.make_adapter()
    want = np.asarray(jax.jit(jad.loss_fn)(jb.params, _jax(_batch(name, cfg))))
    return jb, jvis, jtxt, want, [s.name for s in jad.stacks]


@pytest.fixture(scope="module")
def jax_sides():
    """Every name's JAX side, traced and compiled on a few threads."""
    cfgs = {n: load_model(n, "tiny", device="cpu").cfg for n in NAMES}
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {n: pool.submit(_jax_side, n, cfgs[n]) for n in NAMES}
        return {n: f.result() for n, f in futs.items()}


@pytest.mark.parametrize("name", NAMES)
def test_tiny_bundle_computes_the_jax_bundles_loss(name, jax_sides):
    """The port model, given the JAX bundle's weights, computes its
    calibration loss (float32, 1e-5) and comes with the counterpart
    processors."""
    jb, jvis, jtxt, want, jstacks = jax_sides[name]
    tb, tvis, ttxt = load_model_and_preprocess(name, "tiny", device="cpu")
    assert isinstance(tb, ModelBundle) and (tb.name, tb.model_type) == (name, "tiny")
    assert not tb.model.training
    load_jax_params(tb.model, flatten_named(jb.params))
    batch = _batch(name, tb.cfg)
    with torch.no_grad():
        got = tb.make_adapter().loss_fn(tb.model, _torch(batch)).numpy()
    assert got.shape == want.shape == (4,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    for split in ("train", "eval"):
        assert _counterpart(jvis[split], tvis[split]), (split, jvis[split], tvis[split])
        assert _counterpart(jtxt[split], ttxt[split]), (split, jtxt[split], ttxt[split])
    assert [s.name for s in tb.make_adapter().stacks] == jstacks


def test_registry_has_the_twelve_names():
    assert set(NAMES) <= set(registry.list("model"))
    for name in NAMES:
        assert registry.get_model_class(name) is not None


def test_unknown_name_and_type_fail_loudly():
    with pytest.raises(KeyError, match="not registered"):
        load_model("nope")
    with pytest.raises(KeyError, match="unknown model_type"):
        load_model("t5", "flant5-27b", device="cpu")


def test_model_types_match_the_jax_zoo():
    """The widths behind the model types the port adds configs for."""
    import dataclasses

    from ecoflap_tpu.models import t5 as jt5
    from ecoflap_tpu_torch.models import t5 as tt5
    from ecoflap_tpu_torch.models import zoo as tzoo

    assert set(tzoo.LOADERS) == set(NAMES) == set(jzoo._LOADERS)
    assert dataclasses.asdict(tt5.flan_t5_xxl()) == dataclasses.asdict(jt5.flan_t5_xxl())


def test_processor_contract():
    bundle, vis, txt = load_model_and_preprocess("blip2_t5", "tiny", device="cpu")
    assert set(vis) == {"train", "eval"} and set(txt) == {"train", "eval"}
    s = bundle.cfg.vit.img_size
    img = (np.random.default_rng(0).random((s + 4, s + 4, 3)) * 255).astype(np.uint8)
    assert vis["eval"](img).shape == (s, s, 3)
    assert txt["eval"]("A Dog.") == "a dog"
    _, vis_c, _ = load_model_and_preprocess("clip", "tiny", device="cpu")
    assert vis_c["train"] is vis_c["eval"]
    _, _, txt_v = load_model_and_preprocess("blip_vqa", "tiny", device="cpu")
    assert txt_v["eval"]("Is it: a dog?") == "is it a dog?"


def test_is_eval_sets_the_module_mode():
    b, _, _ = load_model_and_preprocess("llama", "tiny", is_eval=False, device="cpu")
    assert b.model.training
    b, _, _ = load_model_and_preprocess("llama", "tiny", device="cpu")
    assert not b.model.training


def test_ckpt_loads_through_the_pth_loaders(tmp_path):
    from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, save_torch_checkpoint

    src = load_model("llama", "tiny", seed=3, device="cpu").model
    path = str(tmp_path / "llama.pth")
    save_torch_checkpoint(export_state_dict(src), path)
    got = load_model("llama", "tiny", ckpt=path, device="cpu").model
    for (k, a), (_, b) in zip(src.state_dict().items(), got.state_dict().items()):
        assert torch.equal(a, b), k
    other = load_model("llama", "tiny", seed=4, device="cpu").model
    assert not torch.equal(other.lm_head.weight, src.lm_head.weight)


def test_bundle_drives_load_pruner():
    """bundle -> adapter -> load_pruner (compression/__init__.py:29-46)."""
    from ecoflap_tpu_torch.pruning.loader import load_pruner

    bundle = load_model("t5", "tiny", device="cpu")
    batch = _torch(_batch("t5", bundle.cfg))
    pruner = load_pruner("t5_wanda_pruner", bundle.make_adapter(), batch, 2,
                         {"prune_spec": f"{bundle.cfg.num_layers}-0.5-1.0-1.0",
                          "verbose": False})
    with torch.no_grad():
        pruner.prune()
    assert abs(pruner.check_sparsity() - 0.5) < 0.05


def test_the_zoo_runs_on_the_card_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_model("llama", "tiny")
