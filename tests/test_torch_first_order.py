"""The port's first-order coarse scoring (``pruning/first_order.py``) against
the JAX package's ``first_order_group_sums``, its two-stage prune with a
``Grad*`` method against the JAX ``WandaPruner``, and the CLI at tiny.

The same weights (``models/convert.py``) and numpy-made batches go to both
packages. Tolerance of the sums: rtol 2e-4, atol 1e-6, that of the JAX
package's own streamed-against-partitioned test (tests/test_scores.py): the
same float32 gradients reduced in other orders. The port's sums are taken
both ways it has: the streamed per-block backward when the adapter's plans
are given, one backward of the whole loss (the JAX ``rest`` path) when not.
BLIP-2's sums are in tests/test_torch_first_order_blip2.py, so that each
file's JAX compiles stay under a minute.
"""

import types

import numpy as np
import pytest
import torch

from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu_torch.models import layers as tlayers
from ecoflap_tpu_torch.pruning.first_order import first_order_group_sums as tsums
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from ecoflap_tpu_torch.pruning.sparsity import compute_layer_sparsity
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from tests.torch_parity import (FIRST_ORDER_METHODS, first_order_setup, first_order_sums,
                                to_jax, to_torch)

RTOL, ATOL = 2e-4, 1e-6
NUM_MB = 2


def check_sums_match(tad, out, method, jax_path, port_path):
    """The port's sums on ``port_path`` against JAX's on ``jax_path``."""
    want, got = out["jax", jax_path, method], out["port", port_path, method]
    assert list(got) == [t.name for t in tad.targets()]
    for k in got:
        np.testing.assert_allclose(got[k], float(want[k]), rtol=RTOL, atol=ATOL,
                                   err_msg=f"{method} {k}")
        assert got[k] > 0, k


@pytest.fixture(scope="module")
def llama_sums():
    return first_order_sums("llama", NUM_MB)


@pytest.mark.parametrize("method", FIRST_ORDER_METHODS)
@pytest.mark.parametrize("jax_path", ["partitioned", "streamed"])
@pytest.mark.parametrize("port_path", ["streamed", "plain"])
def test_llama_group_sums_match_jax(llama_sums, method, jax_path, port_path):
    """14 targets of the tiny LLaMA (tests/test_torch_first_order_blip2.py
    holds BLIP-2's 48)."""
    tad, out = llama_sums
    assert len(tad.targets()) == 14
    check_sums_match(tad, out, method, jax_path, port_path)


def test_scoring_leaves_the_model_frozen_and_runs_under_no_grad():
    """The CLI prunes under ``no_grad``; scoring turns grad on for itself,
    gives the same sums, and leaves every parameter frozen again."""
    _, _, tad, batch = first_order_setup("llama", NUM_MB)
    tb = to_torch(batch)
    plans = tad.build_mezo_plans(tad.model, tb)
    free = tsums(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), "GradOnly", plans=plans)
    with torch.no_grad():
        held = tsums(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), "GradOnly",
                     plans=plans)
    assert held == free  # same ops on the CPU: bit for bit
    assert not any(p.requires_grad for p in tad.model.parameters())
    assert all(p.grad is None for p in tad.model.parameters())


def test_unported_and_unknown_methods_raise():
    """Every score method of the JAX package is ported now (the ``Real*``
    ones are held against JAX in tests/test_torch_granularity.py), so what
    is left to raise is what the JAX package refuses: a ``Real`` method
    over an unknown first-order score, and unknown methods."""
    _, _, tad, batch = first_order_setup("llama", NUM_MB)
    tb = to_torch(batch)
    mapping = tad.group_mapping("block")
    for method in ("RealMag_sum", "Real-GradMag_sum"):
        with pytest.raises(ValueError, match="first-order"):
            compute_layer_sparsity(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(),
                                   0.5, mapping, score_method=method, verbose=False)
    with pytest.raises(ValueError, match="unknown score method"):
        compute_layer_sparsity(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(),
                               0.5, mapping, score_method="Magnitude_sum", verbose=False)
    with pytest.raises(ValueError, match="first-order"):
        tsums(tad.loss_fn, tad.model, tb, NUM_MB, tad.targets(), "GradMag")


def test_bf16_logits_backward_is_the_transpose_of_the_widened_product():
    """The card's bf16 lm_head product has no derivative of its own
    (``torch.mm(..., out_dtype=float32)``), so ``Bf16LogitsF32`` supplies
    one: the float32 cotangent against the widened weight, one rounding to
    bf16 -- what autograd gives through the CPU's widened ``F.linear``. The
    forward needs the card; the backward's formula runs here."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 3, 16)).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy(rng.normal(size=(10, 16)).astype(np.float32)).to(torch.bfloat16)
    g = torch.from_numpy(rng.normal(size=(2, 3, 10)).astype(np.float32))
    ctx = types.SimpleNamespace(saved_tensors=(w,), needs_input_grad=(True, False))
    gx, gw = tlayers.Bf16LogitsF32.backward(ctx, g)
    leaf = x.clone().requires_grad_()
    (want,) = torch.autograd.grad(tlayers.logits_f32(leaf, w), leaf, grad_outputs=g)
    assert gw is None and gx.dtype == torch.bfloat16
    assert torch.equal(gx, want)
    ctx.needs_input_grad = (True, True)
    with pytest.raises(NotImplementedError, match="lm_head"):
        tlayers.Bf16LogitsF32.backward(ctx, g)


BLIP2_SPECS = {"visual_encoder.blocks": "3-0.5-1.0-1.0",
               "t5_model.encoder.block": "2-0.5-1.0-1.0",
               "t5_model.decoder.block": "2-0.5-1.0-1.0"}


def _zero_patterns(jparams, jad, model, tad):
    jt = {t.name: t for t in jad.targets()}
    return {t.name: (np.asarray(jt[t.name].get(jparams)) == 0,
                     (t.weight(model) == 0).numpy())
            for t in tad.targets()}


@pytest.fixture(scope="module", params=["blip2", "llama"])
def pruned(request):
    """Both packages' two-stage prune of one tiny model with a first-order
    coarse stage: BLIP-2 with GradMagAbs_sum (scripts/blip2/ecoflap_first.py),
    LLaMA with GradOnly_sum (the reference LLaMA/main.py without
    --use_mezo)."""
    if request.param == "blip2":
        cfg = dict(stack_specs=BLIP2_SPECS, max_sparsity_per_layer=0.6,
                   score_method="GradMagAbs_sum")
        name, cap, n = "blipt5_wanda_pruner", 0.6, 48
    else:
        cfg = dict(prune_spec="2-0.4-1.0-1.0", max_sparsity_per_layer=0.7,
                   score_method="GradOnly_sum")
        name, cap, n = "llama_wanda_pruner", 0.7, 14
    cfg.update(sparsity_ratio_granularity="block", num_data_first_stage=8,
               verbose=False)
    jad, params, tad, batch = first_order_setup(request.param, NUM_MB)
    jparams, jdict = jload(name, jad, to_jax(batch), NUM_MB, cfg).prune()
    tp = tload(name, tad, to_torch(batch), NUM_MB, cfg)
    _, tdict = tp.prune()
    return jdict, tdict, _zero_patterns(jparams, jad, tad.model, tad), tp, cap, n


def test_two_stage_prune_gives_the_jax_sparsity_dict(pruned):
    """Sums within rtol 2e-4 feed one allocator: the ratios agree within
    5e-3 (a group near a keep-count boundary may move by one block's worth
    of rounding)."""
    jdict, tdict, _, tp, cap, n = pruned
    assert list(tdict) == list(jdict) and len(tdict) == n
    for k in jdict:
        assert abs(tdict[k] - float(jdict[k])) < 5e-3, (k, tdict[k], jdict[k])
    assert max(tdict.values()) <= cap + 1e-9
    assert list(tp.leaf_scores) == list(tdict)
    assert all(v > 0 for v in tp.leaf_scores.values())


def test_two_stage_prune_gives_the_jax_masks(pruned):
    """Equal ratios give equal masks; a ratio that differs moves only the
    count of pruned weights, never which weights rank lowest, so the
    masks are then nested within each other."""
    jdict, tdict, patterns, _, _, n = pruned
    assert len(patterns) == n
    for name, (want, got) in patterns.items():
        if tdict[name] == float(jdict[name]):
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            assert (got & ~want).sum() == 0 or (want & ~got).sum() == 0, name


@pytest.mark.parametrize("model_name", ["blip2_t5", "llama"])
def test_cli_prunes_tiny_first_order_on_the_cpu(tmp_path, model_name):
    from ecoflap_tpu_torch.cli.prune import main

    if model_name == "llama":
        argv = ["--model", "llama", "--pruning_method", "llama_wanda_pruner",
                "--prune_spec", "2-0.4-1.0-1.0", "--score_method", "GradOnly_sum",
                "--max_sparsity_per_layer", "0.7", "--num_samples", "16"]
        n, cap, target = 14, 0.7, 0.6
    else:
        argv = ["--model", "blip2_t5", "--pruning_method", "blipt5_wanda_pruner",
                "--vit_prune_spec", "3-0.5-1.0-1.0", "--t5_prune_spec", "2-0.5-1.0-1.0",
                "--score_method", "GradMagAbs_sum", "--max_sparsity_per_layer", "0.6",
                "--num_samples", "8"]
        n, cap, target = 48, 0.6, 0.5
    res = main(argv + ["--model_scale", "tiny", "--device", "cpu", "--seed", "3",
                       "--sparsity_ratio_granularity", "block",
                       "--num_data_first_stage", "8", "--batch_size", "4",
                       "--output_dir", str(tmp_path)])
    sd = read_flat_yaml(res["sparsity_dict"])
    assert len(sd) == n and sd.keys() == res["leaf_scores"].keys()
    assert max(sd.values()) <= cap + 1e-9
    assert abs(res["prunable_sparsity"] - target) < 0.02
    vals = list(res["leaf_scores"].values())
    assert all(np.isfinite(v) and v > 0 for v in vals) and len(set(vals)) == n
