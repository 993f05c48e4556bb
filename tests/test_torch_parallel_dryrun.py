"""The JAX package's multi-device dry run (``__graft_entry__._dryrun_impl``,
recorded in MULTICHIP_r05.json: mesh dp=4,tp=2, pruned sparsity 0.4966 over
52 ratio groups, SparseGPT sparsity 0.5000, fine-tune loss 6.7543) rebuilt
in the port on 8 gloo ranks at dp=4,tp=2: the same reduced BLIP-2, batch and
weights (converted from the JAX init), the MeZO noise injected as the JAX
draws; held against the record and against the JAX package run in one
process at the same inputs."""

import concurrent.futures
import dataclasses
import functools

import jax
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as graft
from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import eva_vit, qformer
from ecoflap_tpu_torch.models import t5 as tt5
from ecoflap_tpu_torch.models.convert import load_jax_params
from tests.torch_dist import Ranks
from tests.torch_parity import jax_noise, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RECORD = {"sparsity": 0.4966, "groups": 52, "sgpt_sparsity": 0.5000, "loss": 6.7543}


def _stack_specs(cfg):
    return {"visual_encoder.blocks": f"{cfg.vit.depth}-0.5-1.0-1.0",
            "t5_model.encoder.block": f"{cfg.t5.num_layers}-0.5-1.0-1.0",
            "t5_model.decoder.block": f"{cfg.t5.num_decoder_layers}-0.5-1.0-1.0"}


@functools.partial(jax.jit, static_argnums=3)
def _draw(key, ti, b, shape):
    """``tests.torch_parity.jax_noise``'s chain, jitted per shape: the z of
    (target ti, microbatch b, draw 0) in the JAX (in, out) layout."""
    k = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(key, ti), b), 0)
    return jax.random.normal(k, shape, jax.numpy.float32)


def _draws(shapes):
    """The JAX pruner's MeZO draws under its default key, (out, in)."""
    key = jax.random.PRNGKey(0)  # mezo.py:242
    return {(ti, b, 0): np.asarray(_draw(key, ti, b, (s[1], s[0]))).T.copy()
            for ti, s in enumerate(shapes) for b in range(2)}


@pytest.fixture(scope="module")
def inputs():
    cfg, params = graft._small_blip2(depth=4, qformer_layers=2)
    batch = {k: np.asarray(v) for k, v in graft._batch(cfg, n=16).items()}
    sub = {k: dataclasses.asdict(getattr(cfg, k)) for k in ("vit", "t5", "qformer")}
    tcfg = tblip2.Blip2Config(vit=eva_vit.EvaViTConfig(**sub["vit"]),
                              t5=tt5.T5Config(**sub["t5"]),
                              qformer=qformer.QFormerConfig(**sub["qformer"]))
    model = tblip2.build_model(tcfg, device="cpu", seed=None)
    load_jax_params(model, flatten_named(params))
    draws = _draws([tuple(t.weight(model).shape)
                    for t in tblip2.make_adapter(model).targets()])
    sd = {k: v.numpy().copy() for k, v in model.state_dict().items()}
    return cfg, params, batch, sub, sd, draws


@pytest.fixture(scope="module")
def runs(inputs, tmp_path_factory):
    """(the port's 8 ranks' results, the JAX package's run in one process);
    the JAX run computes while the ranks run."""
    cfg, _, batch, sub, sd, draws = inputs
    mezo = dict(stack_specs=_stack_specs(cfg), sparsity_ratio_granularity="block",
                score_method="MEZO-GradOnly_sum", num_data_first_stage=16,
                max_sparsity_per_layer=0.6)
    payload = {"cfg": sub, "sd": sd, "batch": batch, "draws": draws, "mezo": mezo,
               "dp": 4, "tp": 2}
    ranks = Ranks("blip2_dryrun", 8, payload, tmp_path_factory.mktemp("dry"),
                  timeout=240)
    jax_run = _jax_single(inputs)
    return ranks.wait(), jax_run


@pytest.fixture(scope="module")
def port(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_single(runs):
    return runs[1]


def _jax_single(inputs):
    """The JAX package's dry run in one process at the same inputs."""
    from ecoflap_tpu.pruning.pruners import SparseGPTPruner, WandaPruner
    from ecoflap_tpu.runners.finetune import make_sparsity_masks, make_train_step

    cfg, params, batch, _, _, _ = inputs
    jb = {k: jax.numpy.asarray(v) for k, v in batch.items()}
    common = dict(num_microbatches=2, stack_specs=_stack_specs(cfg), verbose=False)
    coarse = WandaPruner(jblip2.make_adapter(cfg, params), jb,
                         sparsity_ratio_granularity="block",
                         score_method="MEZO-GradOnly_sum", num_data_first_stage=16,
                         max_sparsity_per_layer=0.6, **common)
    # the coarse stage once; the two fine stages from its dict, side by side
    # (XLA leaves the GIL while it compiles and runs)
    sdict = coarse.get_sparsity(0.5, "block")

    def wanda_then_step():
        p = WandaPruner(jblip2.make_adapter(cfg, params), jb, sparsity_dict=sdict,
                        **common)
        pruned, _ = p.prune()
        opt = optax.adamw(1e-5, weight_decay=0.05)
        step = make_train_step(lambda q, b: jblip2.per_sample_loss(cfg, q, b), opt,
                               donate=False)
        _, _, loss = step(pruned, opt.init(pruned), make_sparsity_masks(pruned), jb)
        return float(p.check_sparsity()), float(loss)

    def sparsegpt():
        s = SparseGPTPruner(jblip2.make_adapter(cfg, params), jb, sparsity_dict=sdict,
                            **common)
        s.prune()
        return float(s.check_sparsity())

    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        first, sgpt = pool.submit(wanda_then_step), pool.submit(sparsegpt)
        (sparsity, loss), sgpt_sparsity = first.result(), sgpt.result()
    return {"dict": {k: float(v) for k, v in sdict.items()}, "sparsity": sparsity,
            "sgpt_sparsity": sgpt_sparsity, "loss": loss}


def test_dryrun_reads_the_multichip_record(port):
    for r in port:
        assert len(r["dict"]) == RECORD["groups"]
        assert abs(r["sparsity"] - RECORD["sparsity"]) <= 0.002, r["sparsity"]
        assert abs(r["sgpt_sparsity"] - RECORD["sgpt_sparsity"]) <= 0.005
        assert r["sgpt_dict_verbatim"]
        assert abs(r["loss"] - RECORD["loss"]) <= 1e-3 * RECORD["loss"], r["loss"]


def test_dryrun_matches_the_jax_package_in_one_process(port, jax_single):
    for r in port:
        assert set(r["dict"]) == set(jax_single["dict"])
        for k, v in jax_single["dict"].items():
            assert abs(r["dict"][k] - v) < 1e-4, k
        assert abs(r["sparsity"] - jax_single["sparsity"]) < 1e-3
        assert abs(r["sgpt_sparsity"] - jax_single["sgpt_sparsity"]) < 2e-3
        assert abs(r["loss"] - jax_single["loss"]) <= 1e-3 * abs(jax_single["loss"])


def test_every_rank_reads_the_same(port):
    for r in port[1:]:
        assert r["dict"] == port[0]["dict"]
        assert r["sparsity"] == port[0]["sparsity"]
        assert r["loss"] == port[0]["loss"]


def test_jitted_draws_are_the_hooks_draws(inputs):
    """The jitted chain above gives ``jax_noise``'s z, bit for bit."""
    draws = inputs[-1]
    noise = jax_noise(jax.random.PRNGKey(0))
    for key in [(0, 0, 0), (5, 1, 0), (51, 1, 0)]:
        z = draws[key]
        np.testing.assert_array_equal(noise(*key, z.shape).numpy(), z)
