"""The port's whole prune (coarse MeZO stage + Wanda fine stage) against the
JAX package's on tiny BLIP-2, and the port's CLI against the JAX CLI.

Noise: the port's pruner takes the ``noise`` hook replaying the JAX draws of
``key`` (tests/torch_parity.py), so both coarse stages score with the same z.
"""

import jax
import numpy as np
import pytest

from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.pruning.loader import load_pruner as jload
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.pruning.loader import load_pruner as tload
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from tests.torch_parity import jax_noise, np_batch, tiny_pair, to_jax, to_torch

STACK_SPECS = {"visual_encoder.blocks": "3-0.5-1.0-1.0",
               "t5_model.encoder.block": "2-0.5-1.0-1.0",
               "t5_model.decoder.block": "2-0.5-1.0-1.0"}
COARSE = dict(stack_specs=STACK_SPECS, sparsity_ratio_granularity="block",
              max_sparsity_per_layer=0.6, score_method="MEZO-GradOnly_sum",
              num_data_first_stage=8, noise_eps=0.2, verbose=False)


def _zero_patterns(jparams, jad, model, tad):
    jt = {t.name: t for t in jad.targets()}
    return {t.name: (np.asarray(jt[t.name].get(jparams)) == 0,
                     (t.weight(model) == 0).numpy())
            for t in tad.targets()}


@pytest.fixture(scope="module")
def pruned():
    """Both packages' full two-stage prune of the same tiny model."""
    cfg, params, model = tiny_pair(seed=2)
    batch = np_batch(cfg, n=8, seed=3)
    key = jax.random.PRNGKey(5)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    jp = jload("blipt5_wanda_pruner", jad, to_jax(batch), 2, {**COARSE, "key": key})
    jparams, jdict = jp.prune()
    tp = tload("blipt5_wanda_pruner", tad, to_torch(batch), 2,
               {**COARSE, "noise": jax_noise(key)})
    _, tdict = tp.prune()
    return jdict, tdict, _zero_patterns(jparams, jad, model, tad), tp


def test_two_stage_prune_gives_the_jax_sparsity_dict(pruned):
    """Equal scores (rtol 1e-3, test_torch_mezo.py) feed one allocator; its
    integer keep counts come out equal, so the ratios do too."""
    jdict, tdict, _, _ = pruned
    assert list(tdict) == list(jdict) and len(tdict) == 48
    for k in jdict:
        assert abs(tdict[k] - float(jdict[k])) <= 1e-9, (k, tdict[k], jdict[k])
    assert max(tdict.values()) <= 0.6


def test_two_stage_prune_gives_the_jax_masks(pruned):
    _, _, patterns, tp = pruned
    assert len(patterns) == 48
    for name, (want, got) in patterns.items():
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert abs(tp.check_sparsity() - 0.5) < 0.02
    assert set(tp.phase_times) == {"coarse_s"} | {
        part for s in STACK_SPECS for part in (
            f"coarse_{s}_lanes_s", f"coarse_{s}_lanes_n", f"fine_{s}_s",
            f"fine_{s}_collect_s", f"fine_{s}_prune_s", f"fine_{s}_reforward_s")}


def test_one_sparsity_dict_gives_equal_masks():
    """The fine stage alone, from one given dict: the masks are equal and so
    are the per-row zero counts (any mismatch would have to sit at a tie of
    the metric; with float32 on the CPU there is none at this size)."""
    cfg, params, model = tiny_pair(seed=4)
    batch = np_batch(cfg, n=8, seed=6)
    jad, tad = jblip2.make_adapter(cfg, params), tblip2.make_adapter(model)
    rng = np.random.default_rng(9)
    sd = {t.name: float(rng.choice([0.3, 0.5, 0.6])) for t in tad.targets()}
    given = dict(stack_specs=STACK_SPECS, sparsity_dict=sd, verbose=False)
    jparams, jdict = jload("blipt5_wanda_pruner", jad, to_jax(batch), 2, given).prune()
    _, tdict = tload("blipt5_wanda_pruner", tad, to_torch(batch), 2, given).prune()
    assert dict(tdict) == {k: float(v) for k, v in jdict.items()}
    for name, (want, got) in _zero_patterns(jparams, jad, model, tad).items():
        np.testing.assert_array_equal(got.sum(axis=1), want.sum(axis=1), err_msg=name)
        np.testing.assert_array_equal(got, want, err_msg=name)


def test_unknown_pruner_name_lists_the_known_ones():
    with pytest.raises(KeyError, match="blipt5_wanda_pruner"):
        # a name neither package registers (OPT is evaluated, never pruned)
        tload("opt_wanda_pruner", None, None, 1)


def test_cli_writes_the_jax_cli_keys(tmp_path):
    """``--device cpu`` through the port's CLI: the sparsity-dict YAML has the
    48 reference keys the JAX CLI writes, under the ratio cap, and the result
    line has the JAX CLI's keys."""
    from ecoflap_tpu.cli.prune import main as jmain
    from ecoflap_tpu_torch.cli.prune import main as tmain

    common = ["--model", "blip2_t5", "--model_scale", "tiny",
              "--pruning_method", "blipt5_wanda_pruner",
              "--vit_prune_spec", "3-0.5-1.0-1.0", "--t5_prune_spec", "2-0.5-1.0-1.0",
              "--sparsity_ratio_granularity", "block",
              "--score_method", "MEZO-GradOnly_sum", "--max_sparsity_per_layer", "0.6",
              "--num_data_first_stage", "8", "--num_samples", "8", "--batch_size", "4",
              "--job_id", "tiny"]
    want = jmain(common + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tmain(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    assert set(want) <= set(got)
    jd, td = read_flat_yaml(want["sparsity_dict"]), read_flat_yaml(got["sparsity_dict"])
    assert sorted(td) == sorted(jd) and len(td) == 48
    assert max(td.values()) <= 0.6
    assert abs(got["prunable_sparsity"] - 0.5) < 0.02
    assert "spent_time" in read_flat_yaml(got["stats"])
    assert got["peak_gib"] is None  # no device memory is claimed for a CPU run
