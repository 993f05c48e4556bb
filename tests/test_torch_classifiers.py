"""The image classifiers in the port against the JAX package, tiny and
float32, the same weights carried across by ``load_jax_params``: DeiT
(``eva_vit`` with timm's full qkv bias, norm and head) and ConvNeXt, their
forwards and CE losses, the adapters' stacks, targets and sparsity keys,
a uniform Wanda prune's masks, a block-granularity MeZO prune's sparsity
dict with the JAX noise injected, and the ConvNeXt checkpoint converters.

ConvNeXt's layer scale is 1e-6 at the init, which leaves every block's
output 1e-6 of its residual: parity runs set ``gamma`` to values of order 1
in both packages (``with_gammas``), so each block matters. The converter
test adds a ConvNeXt whose channel counts (12, 20) and 7 classes make every
kernel non-square, so a transposed kernel or a (kh, kw, C) patch order
fails there, in the converted weights and in the forward.

Tolerances: RTOL 1e-5 on logits and losses (float32, the same operations
in another order, a few ulps through 2-3 blocks), with an absolute floor of
RTOL times the largest magnitude; masks equal; the MeZO dict's ratios equal
to 1e-9 (the scores agree to rtol 1e-3, tests/test_torch_mezo.py, and the
allocator's integer keep counts then come out equal)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import classifiers as jcls
from ecoflap_tpu.models import eva_vit as jvit
from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.models import classifiers as tcls
from ecoflap_tpu_torch.models.convert import load_jax_params
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, load_into
from tests.torch_parity import jax_noise, one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
EPS = 0.2
# one compiled program per config (the JAX package's eager init and forward
# compile every operation apart)
JIT_INIT_DEIT = jax.jit(jvit.init_params, static_argnums=0)
JIT_INIT_CONVNEXT = jax.jit(jcls.init_params, static_argnums=0)
JIT_FWD_DEIT = jax.jit(jvit.forward, static_argnums=0)
JIT_FWD_CONVNEXT = jax.jit(jcls.forward, static_argnums=0)
NONSQUARE = dict(depths=(1, 2), dims=(12, 20), num_classes=7, img_size=32)
KINDS = ["deit", "convnext"]


def configs(kind):
    """(JAX config, port config) of one kind."""
    if kind == "convnext_nonsquare":
        return jcls.ConvNeXtConfig(**NONSQUARE), tcls.ConvNeXtConfig(**NONSQUARE)
    return jcls.build(kind, "tiny")[0], tcls.build(kind, "tiny")


def with_gammas(params, seed=0):
    """ConvNeXt params with each block's layer scale drawn from U(0.5, 1.5)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map_with_path(
        lambda path, a: jnp.asarray(rng.uniform(0.5, 1.5, size=a.shape), a.dtype)
        if getattr(path[-1], "key", None) == "gamma" else a, params)


def pair(kind, seed=0):
    """(JAX cfg, JAX params, port model with the same weights), float32."""
    jcfg, tcfg = configs(kind)
    params = (JIT_INIT_DEIT if kind == "deit" else JIT_INIT_CONVNEXT)(
        jcfg, jax.random.PRNGKey(seed))
    if kind != "deit":
        params = with_gammas(params, seed)
    model = tcls.build_model(tcfg, device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    return jcfg, params, model


def jax_forward(kind, cfg, params, images):
    return (JIT_FWD_DEIT if kind == "deit" else JIT_FWD_CONVNEXT)(cfg, params, images)


def jax_adapter(kind, cfg, params):
    if kind == "deit":
        return jcls.make_vit_classifier_adapter(cfg, params)
    return jcls.make_convnext_adapter(cfg, params)


def image_batch(cfg, n=8, seed=0):
    rng = np.random.default_rng(seed)
    ncls = cfg.num_classes if isinstance(cfg, jcls.ConvNeXtConfig) else cfg.head_dim
    return {"image": rng.normal(size=(n, cfg.img_size, cfg.img_size, 3)).astype(np.float32),
            "label": rng.integers(0, ncls, size=(n,))}


def jax_of(b):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
            for k, v in b.items()}


def torch_of(b):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in b.items()}


def close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=rtol,
                               atol=rtol * max(1.0, float(np.abs(want).max())))


@pytest.fixture(scope="module", params=KINDS)
def both(request):
    return (request.param,) + pair(request.param)


def test_forward_and_loss_match_jax(both):
    kind, cfg, params, model = both
    b = image_batch(cfg)
    jb, tb = jax_of(b), torch_of(b)
    logits = model(tb["image"])
    assert logits.dtype == torch.float32
    close(logits, jax_forward(kind, cfg, params, jb["image"]))
    close(tcls.make_adapter(model).loss_fn(model, tb),
          jax.jit(jax_adapter(kind, cfg, params).loss_fn)(params, jb))


def test_adapter_mirrors_the_jax_adapter(both):
    """The same stacks (names, per-row flags, depths), targets in the same
    order, submodel prefixes and ``block`` sparsity keys; each target's
    weight is the JAX target's (out, in) weight."""
    kind, cfg, params, model = both
    jad, tad = jax_adapter(kind, cfg, params), tcls.make_adapter(model)
    assert [(s.name, s.per_row_mask, s.num_blocks) for s in tad.stacks] == [
        (s.name, s.per_row_mask, s.num_blocks) for s in jad.stacks]
    assert [t.name for t in tad.targets()] == [t.name for t in jad.targets()]
    assert tad.model_prefixes == jad.model_prefixes
    assert tad.group_mapping("block") == jad.group_mapping("block")
    jt = {t.name: t for t in jad.targets()}
    for t in tad.targets():
        np.testing.assert_array_equal(t.weight(model).numpy(), np.asarray(jt[t.name].get(params)),
                                      err_msg=t.name)
    if kind != "deit":
        assert tad.targets()[0].name == "stages.0.blocks.0.pwconv1.weight"


def _zeros(jparams, jad, model, tad):
    jt = {t.name: t for t in jad.targets()}
    return {t.name: (np.asarray(jt[t.name].get(jparams)) == 0, (t.weight(model) == 0).numpy())
            for t in tad.targets()}


@pytest.mark.parametrize("kind", ["deit", "convnext"])
def test_wanda_prune_gives_the_jax_masks(kind):
    """A uniform 0.5 Wanda prune: equal masks (no tie of the float32 metric
    at this size). The three pruner names are the JAX package's, all one
    class."""
    from ecoflap_tpu_torch.core.registry import registry
    from ecoflap_tpu_torch.pruning.pruners import TwoStagePruner

    assert all(registry.get_pruner_class(n) is TwoStagePruner for n in (
        "deit_wanda_pruner", "vit_classifier_wanda_pruner", "convnext_wanda_pruner"))
    name = f"{kind}_wanda_pruner"
    cfg, params, model = pair(kind, seed=1)
    b = image_batch(cfg, seed=2)
    jad, tad = jax_adapter(kind, cfg, params), tcls.make_adapter(model)
    given = dict(prune_spec="0-0.5-1.0-1.0", verbose=False)
    jparams, _ = jload(name, jad, jax_of(b), 2, given).prune()
    tload(name, tad, torch_of(b), 2, given).prune()
    for target, (want, got) in _zeros(jparams, jad, model, tad).items():
        np.testing.assert_array_equal(got, want, err_msg=f"{name} {target}")


def test_block_mezo_prune_gives_the_jax_sparsity_dict():
    """ECoFLaP's coarse stage on tiny ConvNeXt's two stage stacks
    (MEZO-GradOnly_sum, block granularity, cap 0.6) with the JAX draws
    injected, then Wanda: the same dict keys and ratios, and the same masks.
    DeiT's stack scores as EVA-CLIP's visual stack does
    (tests/test_torch_clip.py)."""
    kind = "convnext"
    cfg, params, model = pair(kind, seed=3)
    b = image_batch(cfg, seed=4)
    key = jax.random.PRNGKey(6)
    jad, tad = jax_adapter(kind, cfg, params), tcls.make_adapter(model)
    name = f"{kind}_wanda_pruner"
    coarse = dict(prune_spec="0-0.5-1.0-1.0", sparsity_ratio_granularity="block",
                  max_sparsity_per_layer=0.6, score_method="MEZO-GradOnly_sum",
                  num_data_first_stage=8, noise_eps=EPS, verbose=False)
    jparams, jdict = jload(name, jad, jax_of(b), 2, {**coarse, "key": key}).prune()
    _, tdict = tload(name, tad, torch_of(b), 2, {**coarse, "noise": jax_noise(key)}).prune()
    assert list(tdict) == list(jdict) == [t.name for t in tad.targets()]
    assert len(set(tdict.values())) > 1, "block ratios all alike: the scores carried nothing"
    for k in jdict:
        assert abs(tdict[k] - float(jdict[k])) <= 1e-9, (k, tdict[k], jdict[k])
    for target, (want, got) in _zeros(jparams, jad, model, tad).items():
        np.testing.assert_array_equal(got, want, err_msg=target)


@pytest.mark.parametrize("kind", ["convnext_nonsquare"])
def test_convnext_checkpoint_round_trips_and_matches_jax(kind):
    """One FB-named state dict (the JAX ``export_convnext`` of params with
    layer scales of order 1), FB's names being the port's own: ``load_into``
    reads it into the JAX converter's model, tensor for tensor;
    ``export_state_dict`` writes it back unchanged, and the JAX
    ``convert_convnext`` reads the port's export into the same params."""
    cfg, params, model = pair(kind, seed=5)
    state = {k: torch.from_numpy(np.array(v)) for k, v in
             jck.export_convnext(params, cfg).items()}
    assert "downsample_layers.1.1.weight" in state and "stages.1.1.gamma" in state
    got = tcls.build_model(configs(kind)[1], device="cpu", seed=None)
    assert load_into(got, state) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v), k
    back = export_state_dict(got)
    assert sorted(back) == sorted(state) == sorted(export_state_dict(model))
    for k in state:
        assert torch.equal(back[k], state[k]), k
    again = flatten_named(jck.convert_convnext({k: v.numpy() for k, v in back.items()}, cfg))
    for k, v in flatten_named(params).items():
        np.testing.assert_array_equal(np.asarray(again[k]), np.asarray(v), err_msg=k)
    b = image_batch(cfg, n=4, seed=7)
    close(got(torch_of(b)["image"]), jax_forward(kind, cfg, params, jax_of(b)["image"]))


def test_deit_state_dict_is_timm_and_read_by_convert_eva_vit():
    """DeiT's ``.pth`` is timm's names (``export_eva_vit``), and the JAX
    ``convert_eva_vit`` reads the port's export into the same params."""
    cfg, params, model = pair("deit", seed=8)
    state = export_state_dict(model)
    want = jck.export_eva_vit(params, cfg)
    assert sorted(state) == sorted(want)
    back = flatten_named(jck.convert_eva_vit({k: v.numpy() for k, v in state.items()}, cfg))
    for k, v in flatten_named(params).items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)


def test_the_convnext_init_keeps_the_jax_layer_scale():
    model = tcls.build_model(tcls.tiny_config(), device="cpu", seed=0)
    for stage in model.stages:
        for blk in stage:
            assert torch.all(blk.gamma == 1e-6)
            assert float(blk.pwconv1.weight.std()) == pytest.approx(0.02, rel=0.2)
