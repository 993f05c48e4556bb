"""LFM2-MoE (``models/lfm2_moe.py``) against the benchmark's plain float32
reference (``portbench/reference/lfm2_moe.py``) on seeded random weights at
the test sizes (6 layers: conv, conv, attention, conv, attention, conv; 2
dense; 4 experts top-2; d 64, 4 heads of 16, 2 KV heads; vocabulary 512;
windows of 32): logits and losses, the Wanda masks of a whole
``lfm2_wanda_pruner`` prune, the ``GradOnly`` sums with an expert that no
token reaches, the CLI at tiny, the published sizes, and the per-block
target walk left as it was for the models that had one list a stack.
"""

import dataclasses
import hashlib
import json
from pathlib import Path

import pytest
import torch

from ecoflap_tpu_torch.cli import prune as prune_cli
from ecoflap_tpu_torch.data import calibration as cal
from ecoflap_tpu_torch.models import blip1, blip2, lfm2_moe, llama
from ecoflap_tpu_torch.pruning.engine import check_stack_sparsity
from ecoflap_tpu_torch.pruning.first_order import first_order_group_sums
from ecoflap_tpu_torch.pruning.loader import load_pruner
from portbench.reference import fine
from portbench.reference import lfm2_moe as R
from portbench.reference.numerics import Prec
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
WINDOWS, SEQ, MB = 16, 32, 4
F32 = Prec("f32")


def _setup(seed=7):
    cfg = lfm2_moe.tiny_config()
    model = lfm2_moe.build_model(cfg, device="cpu", seed=seed)
    stream = cal.synthetic_token_stream(WINDOWS, SEQ, cfg.vocab_size, seed)
    batch = cal.build_lm_calibration_batch(stream, WINDOWS, SEQ, seed)
    weights = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    return cfg, model, batch, weights, dataclasses.asdict(cfg)


@pytest.fixture(scope="module")
def tiny():
    return _setup()


def test_logits_and_losses_match_the_reference(tiny):
    """float32 on both sides, the same arithmetic in other orders (the
    conv1d against the explicit taps, naive attention against the full score
    matrix, the experts' sums): rounding only, so rtol 1e-4, atol 2e-5."""
    cfg, model, batch, w, rc = tiny
    ids = batch["input_ids"]
    with torch.no_grad():
        torch.testing.assert_close(model(ids), R.forward(w, rc, F32, ids), rtol=1e-4, atol=2e-5)
        torch.testing.assert_close(model.per_sample_loss(ids),
                                   R.per_sample_loss(w, rc, F32, ids), rtol=1e-5, atol=1e-6)
        # the seed's expert_bias changes which experts some tokens take
        moe = model.model.layers[3].feed_forward
        h = torch.randn(256, cfg.hidden_size, generator=torch.Generator().manual_seed(0))
        biased = moe.route(h)[0]
        plain = torch.topk(torch.sigmoid(h @ moe.gate.weight.T), 2, dim=-1).indices
        assert not torch.equal(biased.sort(-1).values, plain.sort(-1).values)


def test_wanda_masks_match_the_reference():
    """A whole ``lfm2_wanda_pruner`` prune with a given dict (a ratio a
    block) against the reference's Wanda, block by block from its own
    pruned state, its own routing choosing each expert's tokens. The
    statistics are the same float32 sums in other orders; no entry may
    differ."""
    cfg, model, batch, w, rc = _setup(seed=11)
    dense = {k: v.detach().clone() for k, v in w.items()}
    sd = {R.weight_key(i, ln): 0.3 + 0.08 * i
          for i in range(cfg.num_hidden_layers) for ln in R.block_linears(rc, i)}
    adapter = lfm2_moe.make_adapter(model)
    assert [t.name for t in adapter.targets()] == list(sd)
    with torch.no_grad():
        load_pruner("lfm2_wanda_pruner", adapter, batch, MB, dict(
            stack_specs={"model.layers": "6-0.5-1.0-1.0"}, sparsity_dict=sd,
            verbose=False)).prune()
        ids = batch["input_ids"]
        cache = R.rope(rc, SEQ, ids.device)
        W = dict(dense)
        xs = [R.embed(W, ids[c:c + 4]) for c in range(0, WINDOWS, 4)]
        for i in range(cfg.num_hidden_layers):
            stats = {}
            for x in xs:
                R.block(W, rc, F32, i, x, cache, stats, "wanda")
            for ln in R.block_linears(rc, i):
                key = R.weight_key(i, ln)
                mask = fine.wanda_mask(W[key], stats[ln], WINDOWS, sd[key], per_row=True)
                W[key] = W[key].masked_fill(mask, 0)
                assert torch.equal(w[key], W[key]), key
            xs = [R.block(W, rc, F32, i, x, cache) for x in xs]


@pytest.mark.parametrize("path", ["streamed", "plain"])
def test_gradonly_sums_with_an_idle_expert(path):
    """``GradOnly`` sums (the streamed per-block backward, and one backward
    of the whole loss) against plain autograd of the reference's whole
    float32 loss, with expert 1 of layer 3 given a bias no token's score
    can beat: its gradients are zero, not an exception. rtol 2e-4, atol
    1e-6: the same float32 gradients reduced in other orders (the JAX
    parity tests' tolerance)."""
    cfg, model, batch, w, rc = _setup(seed=5)
    model.model.layers[3].feed_forward.expert_bias[1] = -1e4
    data = {"input_ids": batch["input_ids"][:8]}
    ad = lfm2_moe.make_adapter(model)
    plans = ad.build_mezo_plans(model, data) if path == "streamed" else None
    got = first_order_group_sums(ad.loss_fn, model, data, 2, ad.targets(), "GradOnly",
                                 plans=plans)
    idle = [k for k in got if ".3.feed_forward.experts.1." in k]
    assert len(idle) == 3 and all(got[k] == 0.0 for k in idle)
    W = {k: (v.detach().clone().requires_grad_(True) if k in got else v) for k, v in w.items()}
    want = dict.fromkeys(got, 0.0)
    for m in range(2):
        loss = R.per_sample_loss(W, rc, F32, data["input_ids"][4 * m:4 * m + 4]).mean()
        grads = torch.autograd.grad(loss, [W[k] for k in got], allow_unused=True)
        for k, g in zip(got, grads):
            want[k] += 0.0 if g is None else float(g.abs().sum()) / 2
    for k in got:
        assert got[k] == pytest.approx(want[k], rel=2e-4, abs=1e-6), k


def test_cli_prunes_tiny(tmp_path):
    out = prune_cli.main([
        "--device", "cpu", "--model", "lfm2_moe", "--model_scale", "tiny",
        "--pruning_method", "lfm2_wanda_pruner", "--prune_spec", "6-0.4-1.0-1.0",
        "--sparsity_ratio_granularity", "block", "--score_method", "GradOnly_sum",
        "--max_sparsity_per_layer", "0.7", "--num_samples", "16", "--batch_size", "4",
        "--num_data_first_stage", "8", "--output_dir", str(tmp_path)])
    assert abs(out["prunable_sparsity"] - 0.6) < 0.02  # per-row floors at widths 48-192
    pt = out["phase_times"]
    # 4 sparse layers x 4 experts x (2 coarse microbatches x 2 forwards + 4 chunks x 2 passes)
    assert pt["moe_expert_calls_n"] + pt["moe_idle_experts_n"] == 4 * 4 * (2 * 2 + 4 * 2)
    assert 0 < pt["moe_s"] < pt["coarse_s"] + pt["fine_model.layers_s"]
    assert (tmp_path / "sparsity_dict").is_dir()


def test_published_sizes():
    """LFM2-8B-A1B as the benchmark's configuration file gives it, built on
    the meta device: 8.34B parameters, nothing cut."""
    cfg = lfm2_moe.Lfm2MoeConfig.from_dict(
        json.loads((ROOT / "portbench/configs/lfm2-8b-a1b.json").read_text()))
    assert cfg == lfm2_moe.lfm2_8b_a1b()
    with torch.device("meta"):
        m = lfm2_moe.Lfm2MoeForCausalLM(cfg)
    kinds = [b.attn for b in m.model.layers]
    assert [i for i, a in enumerate(kinds) if a] == [2, 6, 10, 14, 18, 21]
    assert len(kinds) == 24
    assert m.model.layers[1].feed_forward.w1.weight.shape == (7168, 2048)
    moe = m.model.layers[2].feed_forward
    assert len(moe.experts) == 32 and cfg.num_experts_per_tok == 4
    assert moe.experts[0].w2.weight.shape == (2048, 1792)
    assert m.model.embed_tokens.weight.shape == (65536, 2048)
    assert sum(p.numel() for p in m.parameters()) == pytest.approx(8.34e9, rel=2e-3)
    ad_blocks = [lfm2_moe.block_linears(cfg, i) for i in range(24)]
    assert sum(map(len, ad_blocks)) == 2178
    assert {len(b) for b in ad_blocks} == {5, 98, 100}


@pytest.mark.parametrize("key,value", [("conv_bias", True), ("use_expert_bias", False),
                                       ("norm_topk_prob", False),
                                       ("routed_scaling_factor", 2.5)])
def test_config_refuses_what_the_model_does_not_compute(key, value):
    """Keys that every published LFM2-MoE config sets one way are taken as
    given: a config that sets one otherwise is refused, not ignored."""
    d = json.loads((ROOT / "portbench/configs/lfm2-8b-a1b.json").read_text())
    with pytest.raises(ValueError, match=key):
        lfm2_moe.Lfm2MoeConfig.from_dict({**d, key: value})


# -- the per-block target walk leaves every other model's targets as they were --

def _names(adapter):
    names = [t.name for t in adapter.targets()]
    return len(names), hashlib.sha256("\n".join(names).encode()).hexdigest()[:16]


# (count, hash of the names in order), taken on the commit before per-block
# linear names
PINNED = {
    "blip2": (48, "ae52a0766d662e32"),
    "llama": (14, "82d89c4a44d9a56f"),
    "blip_caption": (32, "053c1c1a08fc444e"),
    "blip_nlvr": (42, "72d3ed1bd31e475b"),
}


@pytest.mark.parametrize("family", sorted(PINNED))
def test_targets_unchanged(family):
    if family == "blip2":
        ad = blip2.make_adapter(blip2.build_model(blip2.tiny_config(), device="cpu", seed=0))
    elif family == "llama":
        ad = llama.make_adapter(llama.build_model(llama.tiny_config(), device="cpu", seed=0))
    else:
        ad = blip1.make_adapter(blip1.build_model(blip1.tiny_config(), family, device="cpu",
                                                  seed=0))
    assert _names(ad) == PINNED[family]


def test_llama_sums_and_sparsity_unchanged():
    """Tiny LLaMA's streamed ``GradOnly`` sums and ``check_stack_sparsity``,
    pinned from the commit before per-block linear names (rtol 1e-5: the
    same float32 sums, whatever thread count reduces them)."""
    m = llama.build_model(llama.tiny_config(), device="cpu", seed=3)
    ad = llama.make_adapter(m)
    batch = cal.build_lm_calibration_batch(cal.synthetic_token_stream(8, 32, 64, 5), 8, 32, 5)
    s = first_order_group_sums(ad.loss_fn, m, batch, 2, ad.targets(), "GradOnly",
                               plans=ad.build_mezo_plans(m, batch))
    got = [s[t.name] for t in ad.targets()]
    want = [15.702231407165527, 16.67621612548828, 23.51541519165039, 23.40729331970215]
    assert got[:4] == pytest.approx(want, rel=1e-5)
    assert sum(got) == pytest.approx(207.23018836975098, rel=1e-5)
    with torch.no_grad():
        for i, blk in enumerate(m.model.layers):
            for ln in llama.LINEAR_NAMES:
                w = blk.get_submodule(ln).weight
                w.masked_fill_(w.abs() < 0.05 * (i + 1), 0)
    assert check_stack_sparsity(ad.stacks[0], m, verbose=False) == 0.34599609375
