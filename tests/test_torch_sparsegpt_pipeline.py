"""The port's SparseGPT fine stage end to end (``blipt5_sparsegpt_pruner``,
``llama_sparsegpt_pruner``) against the JAX package's from one given
sparsity dict, the CLI's ``--sparsity_dict`` re-entry, the reuse rules of
``_adapt_sparsity_dict``, and n:m pruning through both local methods.

Tolerance: both packages run float32 on the CPU with the same weights and
calibration batch. The Hessians come from forwards that agree to ~1e-6
relative (tests/test_torch_blip2.py), the sweeps from different linear
algebra libraries (tests/test_torch_sparsegpt.py), and each pruned block
feeds the next block's Hessian, so differences grow along a stack. Masks
must be equal outside exact ties of the saliency (there are none in
float32 at this size: any mismatch is a fault), and weights within rtol
1e-3 and atol 1e-4 of the JAX package's, well below the O(1e-2) weights'
own size and far below what a flipped mask entry moves.

Conditioning: SparseGPT factors each Hessian in float32, starting undamped,
so a Hessian near singularity leaves O(1) differences between any two
linear algebra libraries; the comparison is then of rounding, not of the
port. The tiny BLIP-2's init makes the ViT's singular: LayerNorm outputs
have zero mean while its biases are 0, and with q/k of N(0, 0.02) the
attention is uniform, so every attention output of a sample is one row
(eigenvalue ratios down to 1e-8). ``conditioned_pair`` draws the ViT's
LayerNorm biases, v bias and qkv weights wider (the spread trained weights
have) and the batches carry 16 target tokens, which brings every Hessian's
eigenvalue ratio above 2e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named, get_leaf, set_leaf
from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.models.convert import load_jax_params
from ecoflap_tpu_torch.pruning.engine import stream_prune_stack
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from ecoflap_tpu_torch.runners.runner import read_flat_yaml, write_flat_yaml
from tests.torch_parity import (
    llama_pair,
    lm_batch,
    np_batch,
    one_torch_thread,  # noqa: F401 (a fixture)
    tiny_pair,
    to_jax,
    to_torch,
)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL, ATOL = 1e-3, 1e-4
STACK_SPECS = {"visual_encoder.blocks": "3-0.5-1.0-1.0",
               "t5_model.encoder.block": "2-0.5-1.0-1.0",
               "t5_model.decoder.block": "2-0.5-1.0-1.0"}


# (leaf, std) of the tiny ViT drawn anew by conditioned_pair
WIDER = (("visual_encoder.blocks.norm1.bias", 0.5),
         ("visual_encoder.blocks.norm2.bias", 0.5),
         ("visual_encoder.blocks.attn.qkv.kernel", 0.35),
         ("visual_encoder.blocks.attn.v_bias", 0.5))


def conditioned_pair(seed):
    """Tiny BLIP-2 in both packages, float32, with the leaves of ``WIDER``
    drawn from N(0, std) (module docstring)."""
    cfg = jblip2.tiny_config()
    params = jblip2.init_params(cfg, jax.random.PRNGKey(seed), jnp.float32)
    rng = np.random.default_rng(seed)
    for path, std in WIDER:
        shape = get_leaf(params, path).shape
        params = set_leaf(params, path, jnp.asarray(rng.normal(0, std, shape),
                                                    jnp.float32))
    model = tblip2.build_model(tblip2.tiny_config(), device="cpu",
                               dtype=torch.float32, seed=None)
    load_jax_params(model, flatten_named(params))
    return cfg, params, model


def _weights(jparams, jad, model, tad):
    """{name: (JAX weight as (out, in), port weight)} as numpy."""
    jt = {t.name: t for t in jad.targets()}
    return {t.name: (np.asarray(jt[t.name].get(jparams)),
                     t.weight(model).detach().numpy())
            for t in tad.targets()}


def _random_dict(tad, seed):
    rng = np.random.default_rng(seed)
    return {t.name: float(rng.choice([0.3, 0.5, 0.6])) for t in tad.targets()}


def _assert_same_prune(weights):
    for name, (want, got) in weights.items():
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=name)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=name)


@pytest.fixture(scope="module")
def blip_pruned():
    cfg, params, model = conditioned_pair(seed=4)
    batch = np_batch(cfg, n=8, tgt=16, seed=6)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    sd = _random_dict(tad, 9)
    given = dict(stack_specs=STACK_SPECS, sparsity_dict=sd, verbose=False)
    jparams, jdict = jload("blipt5_sparsegpt_pruner", jad, to_jax(batch), 2,
                           given).prune()
    tp = tload("blipt5_sparsegpt_pruner", tad, to_torch(batch), 2, given)
    _, tdict = tp.prune()
    return sd, jdict, tdict, _weights(jparams, jad, model, tad), tp


def test_blip2_sparsegpt_matches_jax(blip_pruned):
    sd, jdict, tdict, weights, _ = blip_pruned
    assert dict(tdict) == {k: float(v) for k, v in jdict.items()} == sd
    assert len(weights) == 48
    _assert_same_prune(weights)


def test_blip2_sparsegpt_keeps_each_ratio_and_reports_its_split(blip_pruned):
    """Per weight at least the dict's share is zero (per 128-column block
    ``floor(n sp)`` entries and their ties); the fine stage's split per
    stack is in ``phase_times``."""
    sd, _, _, weights, tp = blip_pruned
    for name, (_, got) in weights.items():
        assert (got == 0).mean() >= sd[name] - 1e-6, name
        assert np.isfinite(got).all()
    for stack in STACK_SPECS:
        for part in ("s", "collect_s", "prune_s", "prepare_hinv_s", "sweep_s",
                     "reforward_s"):
            assert tp.phase_times[f"fine_{stack}_{part}"] >= 0.0


def test_llama_sparsegpt_matches_jax():
    """Tiny LLaMA: q/k/v/o and gate/up sweep as groups, down_proj alone."""
    cfg, params, model = llama_pair(seed=1)
    batch = lm_batch(cfg, n=8, seqlen=12, seed=2)
    jad, tad = jllama.make_adapter(cfg, params), tllama.make_adapter(model)
    sd = _random_dict(tad, 3)
    given = dict(prune_spec="2-0.4-1.0-1.0", sparsity_dict=sd, verbose=False)
    jparams, _ = jload("llama_sparsegpt_pruner", jad, to_jax(batch), 2, given).prune()
    tload("llama_sparsegpt_pruner", tad, to_torch(batch), 2, given).prune()
    weights = _weights(jparams, jad, model, tad)
    assert len(weights) == 14
    _assert_same_prune(weights)


@pytest.mark.parametrize("method", ["sparsegpt", "wanda"])
def test_two_four_fine_stage_matches_jax(method):
    """``prune_n``:``prune_m`` = 2:4 through both local methods: every group
    of four input columns keeps two, as the JAX package's stage does."""
    cfg, params, model = conditioned_pair(seed=1)
    batch = np_batch(cfg, n=8, tgt=16, seed=2)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    name = f"blipt5_{method}_pruner"
    given = dict(stack_specs=STACK_SPECS, sparsity_dict=_random_dict(tad, 4),
                 prune_n=2, prune_m=4, verbose=False)
    jparams, _ = jload(name, jad, to_jax(batch), 2, given).prune()
    tload(name, tad, to_torch(batch), 2, given).prune()
    weights = _weights(jparams, jad, model, tad)
    _assert_same_prune(weights)
    for name, (_, got) in weights.items():
        assert ((got.reshape(got.shape[0], -1, 4) == 0).sum(-1) == 2).all(), name


def test_grouped_and_serial_sweeps_give_one_prune():
    """``stream_prune_stack(sparsegpt_group=False)`` (one sweep per linear)
    gives the grouped stage's masks, and its weights to the batched
    products' rounding."""
    cfg, params, _ = tiny_pair(seed=3)
    batch = to_torch(np_batch(cfg, n=8, seed=4))
    out = []
    for group in (True, False):
        _, _, model = tiny_pair(seed=3)
        tad = tblip2.make_adapter(model)
        sd = _random_dict(tad, 5)
        for stack in tad.stacks:
            stream_prune_stack(stack, model, batch, sd, verbose=False, num_chunks=2,
                               method="sparsegpt", sparsegpt_group=group)
        out.append({t.name: t.weight(model).detach().clone() for t in tad.targets()})
    for name, w in out[0].items():
        assert torch.equal(w == 0, out[1][name] == 0), name
        torch.testing.assert_close(w, out[1][name], rtol=1e-4, atol=1e-5)


def test_hessian_statistics_are_shared_by_linears_of_one_input():
    """``collect="hessian"``: one (in, in) X^T X per distinct input, shared by
    the linears that read it (T5 self-attention q/k/v, cross-attention k/v,
    wi_0/wi_1; LLaMA q/k/v and gate/up), equal to the Wanda sums on its
    diagonal."""
    _, _, model = tiny_pair(seed=0)
    tb = to_torch(np_batch(model.cfg, n=4, seed=1))
    stack = tblip2.make_adapter(model).stacks[2]  # T5 decoder
    x, cache = stack.prepare_inputs(model, tb)
    block = stack.blocks(model)[0]
    _, hs = stack.block_forward(block, x, cache, "hessian")
    _, ws = stack.block_forward(block, x, cache, "wanda")
    sa, ca, ff = "layer.0.SelfAttention", "layer.1.EncDecAttention", "layer.2.DenseReluDense"
    assert hs[f"{sa}.q"] is hs[f"{sa}.k"] is hs[f"{sa}.v"]
    assert hs[f"{ca}.k"] is hs[f"{ca}.v"] and hs[f"{ca}.q"] is not hs[f"{ca}.k"]
    assert hs[f"{ff}.wi_0"] is hs[f"{ff}.wi_1"]
    for name in stack.linear_names:
        h = hs[name]
        assert h.shape == (h.shape[0], h.shape[0]) and torch.equal(h, h.T)
        torch.testing.assert_close(torch.diagonal(h), ws[name], rtol=1e-5, atol=1e-6)
    _, _, lmodel = llama_pair(seed=0)
    lstack = tllama.make_adapter(lmodel).stacks[0]
    lx, lcache = lstack.prepare_inputs(lmodel, {"input_ids": torch.ones(2, 8, dtype=torch.long)})
    _, lh = lstack.block_forward(lstack.blocks(lmodel)[0], lx, lcache, "hessian")
    assert lh["self_attn.q_proj"] is lh["self_attn.k_proj"] is lh["self_attn.v_proj"]
    assert lh["mlp.gate_proj"] is lh["mlp.up_proj"]


def test_cli_sparsity_dict_round_trip(tmp_path):
    """A zeroth-order run's YAML fed back with ``--sparsity_dict`` to the
    SparseGPT pruner gives the fine stage that the mapping gives: bit for
    bit the same weights, and the dict written again unchanged."""
    from ecoflap_tpu_torch.cli import prune as cli

    common = ["--model", "blip2_t5", "--model_scale", "tiny", "--device", "cpu",
              "--vit_prune_spec", "3-0.5-1.0-1.0", "--t5_prune_spec", "2-0.5-1.0-1.0",
              "--num_samples", "8", "--batch_size", "4", "--seed", "3",
              "--output_dir", str(tmp_path)]
    zeroth = cli.main(common + ["--sparsity_ratio_granularity", "block",
                                "--max_sparsity_per_layer", "0.6",
                                "--num_data_first_stage", "4", "--noise_eps", "0.05"])
    sd = read_flat_yaml(zeroth["sparsity_dict"])
    assert len(sd) == 48
    argv = common + ["--pruning_method", "blipt5_sparsegpt_pruner",
                     "--sparsity_dict", zeroth["sparsity_dict"], "--job_id", "sgpt"]
    res = cli.main(argv)
    assert read_flat_yaml(res["sparsity_dict"]) == sd
    assert abs(res["prunable_sparsity"] - 0.5) < 0.02

    # the same fine stage from the mapping: the CLI's own model and batch
    # for these flags, built afresh
    tad, batch, num_mb, specs = cli._blip2(cli.build_parser().parse_args(argv),
                                           torch.device("cpu"), torch.float32)
    tload("blipt5_sparsegpt_pruner", tad, batch, num_mb,
          dict(stack_specs=specs, sparsity_dict=dict(sd), verbose=False)).prune()
    cli_ad = tblip2.make_adapter(res["model"])
    for t, u in zip(tad.targets(), cli_ad.targets()):
        assert torch.equal(t.weight(tad.model), u.weight(res["model"])), t.name


def test_sparsity_dict_from_a_yaml_path_equals_the_mapping(tmp_path):
    _, _, model = tiny_pair(seed=0)
    tad = tblip2.make_adapter(model)
    sd = _random_dict(tad, 1)
    path = tmp_path / "sd.yaml"
    write_flat_yaml(str(path), sd)
    tp = tload("blipt5_sparsegpt_pruner", tad, None, 1,
               dict(stack_specs=STACK_SPECS, sparsity_dict=str(path)))
    assert tp.get_sparsity(0.5, None) == sd


def _adapt(pkg, sd, specs):
    """The package's ``_adapt_sparsity_dict`` through its pruner's dict
    handling, on tiny BLIP-2 with the given stack specs."""
    if pkg == "jax":
        cfg, params, _ = tiny_pair(seed=0)
        ad = jblip2.make_adapter(cfg, params)
        return jload("blipt5_sparsegpt_pruner", ad, None, 1,
                     dict(stack_specs=specs, sparsity_dict=sd, verbose=False)
                     ).get_sparsity(0.5, None)
    _, _, model = tiny_pair(seed=0)
    tad = tblip2.make_adapter(model)
    return tload("blipt5_sparsegpt_pruner", tad, None, 1,
                 dict(stack_specs=specs, sparsity_dict=sd, verbose=False)
                 ).get_sparsity(0.5, None)


def test_adapt_zero_fills_missing_targets_loudly(capsys):
    """A dict missing the last ViT block (the EVA block 39 case): the
    missing targets are kept dense (0.0), with a message, as in JAX."""
    _, _, model = tiny_pair(seed=0)
    names = [t.name for t in tblip2.make_adapter(model).targets()]
    sd = {k: 0.5 for k in names if not k.startswith("visual_encoder.blocks.2.")}
    got = _adapt("port", sd, STACK_SPECS)
    assert "zero-filling 4 targets" in capsys.readouterr().out
    assert got == _adapt("jax", sd, STACK_SPECS)
    assert {k for k, v in got.items() if v == 0.0} == {
        k for k in names if k.startswith("visual_encoder.blocks.2.")}


def test_adapt_remaps_visual_keys_and_scopes_to_pruned_stacks():
    """``visual.`` keys (an EVA-CLIP dict) serve ``visual_encoder.``
    targets, and only the stacks being pruned must be covered."""
    _, _, model = tiny_pair(seed=0)
    vit = [t.name for t in tblip2.make_adapter(model).targets()
           if t.name.startswith("visual_encoder.")]
    sd = {"visual." + k[len("visual_encoder."):]: 0.4 for k in vit}
    specs = {"visual_encoder.blocks": "3-0.5-1.0-1.0"}
    got = _adapt("port", sd, specs)
    assert got == _adapt("jax", sd, specs)
    assert all(got[k] == 0.4 for k in vit)


def test_adapt_refuses_a_dict_covering_under_half():
    _, _, model = tiny_pair(seed=0)
    names = [t.name for t in tblip2.make_adapter(model).targets()]
    sd = {k: 0.5 for k in names[:20]}  # 20 of 48
    with pytest.raises(KeyError, match="covers only 20/48"):
        _adapt("port", sd, STACK_SPECS)
    with pytest.raises(KeyError, match="covers only 20/48"):
        _adapt("jax", sd, STACK_SPECS)
