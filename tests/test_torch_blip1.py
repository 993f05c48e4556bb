"""BLIP-1's four heads in the port (``ecoflap_tpu_torch/models/blip1.py``)
against the JAX package, tiny and float32 with the same weights: each head's
per-sample loss, the UPop prune (the launchers' configuration: MEZO-GradOnly
with the block granularity, cap p + 0.1, then Wanda) with the JAX noise
injected, and the ``LossPlan`` of the caption and retrieval heads.

Tolerances: losses 1e-5 (relative and absolute, float32 in another order);
the prune's sparsity dict has the same keys and ratios within 1e-6, and the
masks are equal; the LossPlan's MeZO scores equal the full-loss scores
within 1e-5 relative (the image embeddings are the same computation, made
once instead of per perturbation)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.models import blip1 as jblip1
from ecoflap_tpu.pruning.pruners import WandaPruner
from ecoflap_tpu_torch.cli.upop import build_batch, stack_names
from ecoflap_tpu_torch.models import blip1 as tblip1
from ecoflap_tpu_torch.pruning.mezo import mezo_leaf_scores
from ecoflap_tpu_torch.pruning.pruners import TwoStagePruner
from tests.torch_parity import (BLIP1_HEADS, BLIP1_JAX, blip1_pair, jax_noise,  # noqa: F401
                                one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-5
N = 16  # two microbatches of 8
# the launchers' eps (1e-3) moves the tiny model's loss (init std 0.02) by
# a few float32 ulps, so its scores would be rounding counts on either side:
# the prune tests take kernels 10x the init and eps 0.2 (as
# tests/test_torch_t5_standalone.py raises eps), which moves it by many
EPS = 0.2
KERNEL_SCALE = 10.0


def to_jax(batch):
    return {k: jnp.asarray(v, jnp.float32 if v.dtype == np.float32 else jnp.int32)
            for k, v in batch.items()}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


@pytest.mark.parametrize("head", sorted(BLIP1_HEADS))
def test_per_sample_loss_matches_jax(head):
    kind = BLIP1_HEADS[head]
    cfg, params, model = blip1_pair(kind, seed=1)
    batch = build_batch(head, cfg, 4)
    if "caption_mask" in batch:
        batch["caption_mask"][0, 10:] = 0
    want = np.asarray(getattr(jblip1, BLIP1_JAX[kind][1])(cfg, params, to_jax(batch)))
    with torch.no_grad():
        got = model.per_sample_loss(to_torch(batch)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("head", sorted(BLIP1_HEADS))
def test_upop_prune_with_injected_noise_matches_jax(head):
    kind = BLIP1_HEADS[head]
    cfg, params, model = blip1_pair(kind, seed=2, kernel_scale=KERNEL_SCALE)
    batch = build_batch(head, cfg, N)
    specs = {name: f"{depth}-0.5-1.0-1.0" for name, depth in stack_names(head, cfg)}
    common = dict(num_microbatches=N // 8, stack_specs=specs,
                  sparsity_ratio_granularity="block", max_sparsity_per_layer=0.6,
                  score_method="MEZO-GradOnly_sum", num_data_first_stage=N, noise_eps=EPS,
                  verbose=False)
    jad = getattr(jblip1, BLIP1_JAX[kind][2])(cfg, params)
    jparams, jsd = WandaPruner(jad, to_jax(batch), **common).prune()
    tad = tblip1.make_adapter(model)
    with torch.no_grad():
        _, tsd = TwoStagePruner(tad, to_torch(batch), noise=jax_noise(jax.random.PRNGKey(0)),
                                **common).prune()
    assert sorted(tsd) == sorted(jsd)
    for k in jsd:
        assert abs(tsd[k] - float(jsd[k])) <= 1e-6, (k, tsd[k], jsd[k])
    for t, jt in zip(tad.targets(), jad.targets()):
        assert t.name == jt.name
        want = np.asarray(jt.get(jparams)) == 0
        assert np.array_equal(t.weight(model).numpy() == 0, want), t.name


@pytest.mark.parametrize("head", ["caption", "retrieval"])
def test_loss_plan_scores_equal_the_full_loss_scores(head):
    """The text targets scored by the plan (cached image embeddings) and by
    the full loss, the same injected z; and both against the JAX serial
    path with its own LossPlan."""
    from ecoflap_tpu.pruning.mezo import mezo_leaf_scores as jscores

    kind = BLIP1_HEADS[head]
    cfg, params, model = blip1_pair(kind, seed=3, kernel_scale=KERNEL_SCALE)
    batch = to_torch(build_batch(head, cfg, N))
    ad = tblip1.make_adapter(model)
    targets = ad.targets()
    noise = jax_noise(jax.random.PRNGKey(5))
    # the serial cycle restores each weight up to a rounding: both runs start
    # from the same weights, and the plan-vs-full comparison scores the text
    # targets alone (after the ViT's cycles the full loss would see ViT
    # weights a rounding away from those the plan's embeddings were made with)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    with torch.no_grad():
        plans = ad.build_mezo_plans(model, batch)
        planned = mezo_leaf_scores(ad.loss_fn, model, batch, 2, targets, eps=EPS,
                                   loss_plans=plans, noise=noise)
        text = [t for t in targets if plans[0].match(t.name)]
        assert len(text) == cfg.text.num_layers * len(ad.stacks[1].linear_names)
        first = targets.index(text[0])

        def offset(ti, b, n, shape):  # the same z as target ti of the whole list
            return noise(ti + first, b, n, shape)

        model.load_state_dict(start)
        text_planned = mezo_leaf_scores(ad.loss_fn, model, batch, 2, text, eps=EPS,
                                        loss_plans=plans, noise=offset)
        model.load_state_dict(start)
        text_full = mezo_leaf_scores(ad.loss_fn, model, batch, 2, text, eps=EPS,
                                     noise=offset)
    for k in text_full:
        np.testing.assert_allclose(text_planned[k], text_full[k], rtol=TOL, atol=1e-7,
                                   err_msg=k)
    jad = getattr(jblip1, BLIP1_JAX[kind][2])(cfg, params)
    jb = to_jax(build_batch(head, cfg, N))
    want = jscores(jad.loss_fn, params, jb, 2, jad.targets(), eps=EPS,
                   key=jax.random.PRNGKey(5), loss_plans=jad.build_mezo_plans(params, jb))
    for k in want:  # the JAX serial path with its LossPlan, every target
        np.testing.assert_allclose(planned[k], float(want[k]), rtol=1e-3, atol=2e-5,
                                   err_msg=k)
