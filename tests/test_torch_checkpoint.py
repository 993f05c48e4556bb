"""The port's ``.pth`` export and load (``utils/checkpoint.py``, the
runner's ``save_pruned_torch`` and the CLI's ``--ckpt``) against the JAX
package's ``export_blip2``/``export_llama`` and converters: the same keys
and values both ways, in float32."""

import numpy as np
import pytest
import torch

from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.prune import main as tmain
from ecoflap_tpu_torch.models import blip2 as tblip2
from ecoflap_tpu_torch.models import llama as tllama
from ecoflap_tpu_torch.runners.runner import Runner
from ecoflap_tpu_torch.utils import checkpoint as tck
from tests.torch_parity import llama_pair, tiny_pair


def exports():
    """{family: (JAX export, port export, JAX params, JAX cfg, port model)}."""
    cfg, params, model = tiny_pair(seed=1)
    lcfg, lparams, lmodel = llama_pair(seed=1)
    return {"blip2": (jck.export_blip2(params, cfg), tck.export_state_dict(model),
                      params, cfg, model),
            "llama": (jck.export_llama(lparams, lcfg), tck.export_state_dict(lmodel),
                      lparams, lcfg, lmodel)}


@pytest.fixture(scope="module")
def both():
    return exports()


@pytest.mark.parametrize("family", ["blip2", "llama"])
def test_export_matches_jax(both, family):
    want, got, _, _, model = both[family]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu", k
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
    # a copy: writing to an export leaves the model alone
    mine = tck.export_state_dict(model)
    k = next(iter(mine))
    mine[k].zero_()
    assert model.state_dict()[k].abs().sum() > 0


def test_export_of_a_bf16_model_is_float32():
    model = tblip2.build_model(tblip2.tiny_config(), device="cpu",
                               dtype=torch.bfloat16, seed=0)
    sd = tck.export_state_dict(model)
    assert all(v.dtype == torch.float32 for v in sd.values())
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k].to(torch.bfloat16), v), k


@pytest.mark.parametrize("family", ["blip2", "llama"])
def test_port_pth_loads_through_the_jax_converters(both, tmp_path, family):
    _, got, params, cfg, _ = both[family]
    path = Runner(str(tmp_path), "job").save_pruned_torch(got)
    assert path == str(tmp_path / "pruned_checkpoint" / "job.pth")
    state = jck.load_torch_checkpoint(path)
    convert = jck.convert_blip2 if family == "blip2" else jck.convert_llama
    back = flatten_named(convert(state, cfg))
    want = flatten_named(params)
    assert sorted(back) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(np.asarray(back[k]), np.asarray(v), err_msg=k)


@pytest.mark.parametrize("family", ["blip2", "llama"])
def test_jax_pth_loads_into_the_port(both, tmp_path, family):
    want, _, _, _, model = both[family]
    path = str(tmp_path / "jax.pth")
    jck.save_torch_checkpoint(want, path)
    mod = tblip2 if family == "blip2" else tllama
    fresh = mod.build_model(model.cfg, device="cpu", dtype=torch.float32, seed=None)
    assert tck.load_into(fresh, tck.load_torch_checkpoint(path)) == 0
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_model_wrapper_visual_remap_and_extra_keys(both, tmp_path):
    """A ``{"model": ...}`` training checkpoint is unwrapped; EVA-CLIP's
    ``visual.`` keys become BLIP-2's ``visual_encoder.``; keys the model
    lacks are counted, not loaded."""
    want, _, _, _, model = both["blip2"]
    state = {("visual." + k[len("visual_encoder."):] if k.startswith("visual_encoder.")
              else k): torch.from_numpy(v.copy()) for k, v in want.items()}
    state["text_proj.weight"] = torch.zeros(3, 3)
    path = str(tmp_path / "wrapped.pth")
    torch.save({"model": state, "epoch": 3}, path)
    loaded = tck.load_torch_checkpoint(path)
    assert "text_proj.weight" in loaded and "epoch" not in loaded
    assert set(tck.remap_eva_clip_to_blip2(loaded)) == set(want) | {"text_proj.weight"}
    fresh = tblip2.build_model(model.cfg, device="cpu", dtype=torch.float32, seed=None)
    assert tck.load_into(fresh, loaded) == 1
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_missing_keys_and_shapes_raise(both):
    want, _, _, _, model = both["llama"]
    state = {k: torch.from_numpy(v.copy()) for k, v in want.items()}
    fresh = tllama.build_model(model.cfg, device="cpu", dtype=torch.float32, seed=None)
    with pytest.raises(KeyError, match="lacks 1"):
        tck.load_into(fresh, {k: v for k, v in state.items() if k != "lm_head.weight"})
    state["lm_head.weight"] = state["lm_head.weight"][:, :-1]
    with pytest.raises(ValueError, match="lm_head"):
        tck.load_into(fresh, state)


def test_cli_ckpt_starts_from_the_checkpoint(both, tmp_path):
    """``--ckpt`` replaces the random init: a global magnitude prune of the
    JAX export through the CLI equals the pruner's on the original model,
    and its ``.pth`` holds the pruned weights."""
    want, _, params, cfg, _ = both["llama"]
    path = str(tmp_path / "llama.pth")
    jck.save_torch_checkpoint(want, path)
    res = tmain(["--device", "cpu", "--model", "llama", "--model_scale", "tiny",
                 "--ckpt", path, "--pruning_method", "llama_magnitude_pruner",
                 "--prune_spec", "2-0.5-1.0-1.0", "--num_samples", "8",
                 "--output_dir", str(tmp_path / "out"), "--save_pruned_model"])
    _, _, ref = llama_pair(seed=1)
    from ecoflap_tpu_torch.pruning.loader import load_pruner

    ad = tllama.make_adapter(ref)
    load_pruner("llama_magnitude_pruner", ad, {"input_ids": torch.zeros(8, 4)}, 1,
                dict(prune_spec="2-0.5-1.0-1.0", verbose=False)).prune()
    saved = torch.load(res["pth"], weights_only=True)
    for k, v in ref.state_dict().items():
        assert torch.equal(res["model"].state_dict()[k], v), k
        assert torch.equal(saved[k], v), k
    assert res["prunable_sparsity"] == 0.5


def test_dtype_flag_sets_the_weight_dtype(tmp_path):
    res = tmain(["--device", "cpu", "--model", "llama", "--model_scale", "tiny",
                 "--dtype", "bfloat16", "--pruning_method", "llama_magnitude_pruner",
                 "--prune_spec", "2-0.5-1.0-1.0", "--num_samples", "8",
                 "--output_dir", str(tmp_path)])
    assert all(p.dtype == torch.bfloat16 for p in res["model"].parameters())
