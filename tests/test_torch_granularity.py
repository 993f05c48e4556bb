"""The coarse stage's remaining options in the port against the JAX
package's ``compute_layer_sparsity``: ``layer`` and ``model``
granularities, ``prune_per_model``, and the ``Real*`` score methods (which
must leave the model's weights as they were, bit for bit); and SparseGPT's
``hessian_bf16`` against the JAX fine stage.

Tolerances. First-order group sums agree to rtol 2e-4 (tests/
test_torch_first_order.py), and the allocator turns a score into a ratio
through a ceiling per group, so ratios agree within 5e-3, as in that file.
``Real*`` ratios are zero shares after three global steps: a mask entry that
flips on a near-tie of the threshold moves its tensor's share by 1/numel, at
most 1/1024 at these shapes; two such flips are allowed (2e-3)."""

import numpy as np
import pytest
import torch

from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu.pruning.sparsity import compute_layer_sparsity as jsparsity
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from ecoflap_tpu_torch.pruning.sparsity import compute_layer_sparsity as tsparsity
from tests.test_torch_sparsegpt_pipeline import _random_dict, _weights
from tests.torch_parity import (  # noqa: F401 (one_torch_thread: a fixture)
    llama_pair,
    lm_batch,
    np_batch,
    one_torch_thread,
    tiny_pair,
    to_jax,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NUM_MB = 2
DICT_TOL = 5e-3
REAL_TOL = 2e-3


def setup(model_name):
    if model_name == "blip2":
        cfg, params, model = tiny_pair(seed=0)
        batch = np_batch(cfg, n=4 * NUM_MB, seed=3)
        return (jblip2.make_adapter(cfg, params), tblip2.make_adapter(model),
                to_jax(batch), to_torch(batch))
    cfg, params, model = llama_pair(seed=2)
    batch = lm_batch(cfg, n=4 * NUM_MB, seqlen=16, seed=7)
    return (jllama.make_adapter(cfg, params), tllama.make_adapter(model),
            to_jax(batch), to_torch(batch))


def both_dicts(model_name, granularity, score_method="GradMagAbs_sum",
               prune_per_model=False, cap=0.8):
    jad, tad, jb, tb = setup(model_name)
    kw = dict(max_sparsity_per_layer=cap, score_method=score_method,
              prune_per_model=prune_per_model, verbose=False)
    want = jsparsity(jad.loss_fn, jad.params, jb, NUM_MB, jad.targets(), 0.5,
                     jad.group_mapping(granularity),
                     per_model_group=list(jad.model_prefixes.values()), **kw)
    got = tsparsity(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), 0.5,
                    tad.group_mapping(granularity),
                    per_model_group=list(tad.model_prefixes.values()),
                    loss_plans=tad.build_mezo_plans(tad.model, tb), **kw)
    return {k: float(v) for k, v in want.items()}, got, tad


@pytest.mark.parametrize("model_name", ["blip2", "llama"])
@pytest.mark.parametrize("granularity", ["layer", "block", "model"])
def test_group_mappings_match_jax(model_name, granularity):
    jad, tad, _, _ = setup(model_name)
    assert tad.group_mapping(granularity) == jad.group_mapping(granularity)
    assert tad.model_prefixes == jad.model_prefixes
    assert tad.group_mapping(None) == {}


@pytest.mark.parametrize("model_name, granularity",
                         [("llama", "layer"), ("blip2", "model")])
def test_granularity_dicts_match_jax(model_name, granularity):
    want, got, tad = both_dicts(model_name, granularity)
    assert list(got) == list(want) == [t.name for t in tad.targets()]
    for k in want:
        assert abs(got[k] - want[k]) <= DICT_TOL, (k, got[k], want[k])
    if granularity == "layer":
        assert len(set(got.values())) > 1 and max(got.values()) <= 0.8 + 1e-9


def test_prune_per_model_dict_matches_jax():
    """Block ratios allocated within ``visual_encoder`` and within
    ``t5_model``: each submodel keeps its own half."""
    want, got, tad = both_dicts("blip2", "block", prune_per_model=True, cap=0.6)
    for k in want:
        assert abs(got[k] - want[k]) <= DICT_TOL, (k, got[k], want[k])
    model = tad.model
    for prefix in ("visual_encoder", "t5_model"):
        ts = [t for t in tad.targets() if t.name.startswith(prefix)]
        kept = sum((1 - got[t.name]) * t.numel(model) for t in ts)
        assert abs(kept / sum(t.numel(model) for t in ts) - 0.5) < 1e-3, prefix


@pytest.mark.parametrize("method", ["Real-GradMagAbs_sum", "Real_sum"])
def test_real_scores_match_jax(method):
    """Three global |W| |G| steps (``Real`` alone means GradMagAbs), the
    per-target zero shares read off: a dict over the targets."""
    want, got, tad = both_dicts("llama", "block", score_method=method)
    assert list(got) == list(want) == [t.name for t in tad.targets()]
    for k in want:
        assert abs(got[k] - want[k]) <= REAL_TOL, (k, got[k], want[k])
    model = tad.model
    zeros = sum(got[t.name] * t.numel(model) for t in tad.targets())
    assert abs(zeros / sum(t.numel(model) for t in tad.targets()) - 0.5) < 1e-3
    assert len(set(got.values())) > 1


@pytest.mark.parametrize("model_name", ["blip2", "llama"])
def test_real_scores_leave_the_weights_as_they_were(model_name):
    _, tad, _, tb = setup(model_name)
    before = {k: v.clone() for k, v in tad.model.state_dict().items()}
    tsparsity(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), 0.5,
              tad.group_mapping("block"), score_method="Real-GradMagAbs_sum",
              loss_plans=tad.build_mezo_plans(tad.model, tb), verbose=False)
    after = tad.model.state_dict()
    for k, v in before.items():
        assert torch.equal(v.view(torch.int32), after[k].view(torch.int32)), k
    assert not any(p.requires_grad for p in tad.model.parameters())


def test_unknown_real_method_raises_as_jax():
    _, tad, _, tb = setup("llama")
    with pytest.raises(ValueError, match="first-order"):
        tsparsity(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), 0.5,
                  tad.group_mapping("block"), score_method="RealMag_sum",
                  verbose=False)
    with pytest.raises(ValueError):
        tad.group_mapping("stack")


def test_pruner_passes_per_model_and_layer_granularity():
    """``TwoStagePruner`` with ``layer`` granularity and ``prune_per_model``
    gives the dict ``compute_layer_sparsity`` gives (held against JAX
    above) with the adapter's prefixes, and prunes to it."""
    _, tad, _, tb = setup("blip2")
    want = tsparsity(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), 0.5,
                     tad.group_mapping("layer"), max_sparsity_per_layer=0.7,
                     score_method="GradMagAbs_sum", prune_per_model=True,
                     per_model_group=["visual_encoder", "t5_model"],
                     loss_plans=tad.build_mezo_plans(tad.model, tb), verbose=False)
    cfg = dict(stack_specs={"visual_encoder.blocks": "3-0.5-1.0-1.0",
                            "t5_model.encoder.block": "2-0.5-1.0-1.0",
                            "t5_model.decoder.block": "2-0.5-1.0-1.0"},
               sparsity_ratio_granularity="layer", prune_per_model=True,
               max_sparsity_per_layer=0.7, score_method="GradMagAbs_sum",
               num_data_first_stage=8, verbose=False)
    _, got = tload("blipt5_wanda_pruner", tad, tb, NUM_MB, cfg).prune()
    assert got == want
    for t in tad.targets():
        share = float((t.weight(tad.model) == 0).float().mean())
        # Wanda's per-row (T5) or per-tensor (ViT) floor of the ratio
        assert abs(share - got[t.name]) < 0.05, t.name


def test_hessian_bf16_matches_jax():
    """SparseGPT from summed Gram matrices rounded once to bf16, through both
    packages' pruners from one dict, on a one-layer LLaMA, so both sweeps
    see the same inputs: masks equal and weights within 1e-3 relative L2.
    The float32 sums agree to ~1e-7 relative, and where they straddle a bf16
    rounding boundary one H entry differs by a bf16 ulp (2^-8 relative),
    which moved the pruned weights by up to 3.2e-4 relative L2 here. The rounding is
    live: the port's weights are further than 1e-2 from its float32-Hessian
    prune."""
    out = {}
    for bf16 in (True, False):
        cfg, params, model = llama_pair(seed=1, num_layers=1)
        batch = lm_batch(cfg, n=8, seqlen=12, seed=2)
        jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
        given = dict(prune_spec="1-0.4-1.0-1.0", sparsity_dict=_random_dict(tad, 3),
                     hessian_bf16=bf16, verbose=False)
        tload("llama_sparsegpt_pruner", tad, to_torch(batch), 2, given).prune()
        out[bf16] = torch.cat([t.weight(model).reshape(-1) for t in tad.targets()])
        if bf16:
            jparams, _ = jload("llama_sparsegpt_pruner", jad, to_jax(batch), 2,
                               given).prune()
            weights = _weights(jparams, jad, model, tad)
            assert len(weights) == 7
            for name, (want, got) in weights.items():
                np.testing.assert_array_equal(got == 0, want == 0, err_msg=name)
                rel = np.linalg.norm(got - want) / np.linalg.norm(want)
                assert rel <= 1e-3, (name, rel)
    assert ((out[True] - out[False]).norm() / out[False].norm()).item() > 1e-2


def test_hessian_bf16_only_serves_sparsegpt():
    from ecoflap_tpu_torch.pruning.engine import stream_prune_stack

    _, tad, _, tb = setup("llama")
    with pytest.raises(ValueError, match="hessian_bf16"):
        stream_prune_stack(tad.stacks[0], tad.model, tb, {}, verbose=False,
                           method="wanda", collect="hessian_bf16")
