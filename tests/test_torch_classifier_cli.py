"""The image classifiers through both packages' CLIs, tiny and float32:
``cli.prune --model deit|convnext`` from one ``--ckpt`` (timm DeiT, FB
ConvNeXt with layer scales of order 1): DeiT with the launcher's flags
(Wanda alone) on the synthetic batch, ConvNeXt with a first-order coarse
stage (the same scores on both sides) and ``--calib`` on a 4-image folder,
both with ``--save_pruned_model``; then
``cli.evaluate --task classification`` from the pruned ``.pth``, on random
images and on the folder.

Expected: the same job id, sparsity dict (rtol 1e-5: float32 gradient sums
in another order), global sparsity and masks, and the same top-1 (argmax of
float32 logits that agree to a few ulps). The JAX evaluate CLI reads a
ConvNeXt checkpoint from orbax only, so its ConvNeXt run evaluates the
params its ``convert_convnext`` reads from the port's ``.pth``, put in place
of its random init."""

import numpy as np
import pytest
import torch

from ecoflap_tpu.cli import evaluate as jeval
from ecoflap_tpu.cli.prune import main as jprune
from ecoflap_tpu.models import classifiers as jcls
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.evaluate import main as teval
from ecoflap_tpu_torch.cli.prune import main as tprune
from ecoflap_tpu_torch.models import classifiers as tcls
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, save_torch_checkpoint
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

RTOL = 1e-5
# DeiT with the launcher's flags (Wanda alone), ConvNeXt with a coarse stage
COARSE = {"deit": [], "convnext": [
    "--sparsity_ratio_granularity", "block", "--max_sparsity_per_layer", "0.6",
    "--score_method", "GradOnly_sum", "--num_data_first_stage", "8"]}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """{"deit"/"convnext": a reference-named .pth of seeded weights (the
    port's init; ConvNeXt's layer scales from U(0.5, 1.5)), "folder": a
    class-subdirectory image folder of 2 x 2 images}."""
    from PIL import Image

    root = tmp_path_factory.mktemp("classifier_cli")
    out = {}
    g = torch.Generator().manual_seed(3)
    for seed, kind in enumerate(("deit", "convnext")):
        model = tcls.build_model(tcls.build(kind, "tiny"), device="cpu", seed=seed)
        if kind == "convnext":
            with torch.no_grad():
                for stage in model.stages:
                    for blk in stage:
                        blk.gamma.uniform_(0.5, 1.5, generator=g)
        out[kind] = str(root / f"{kind}.pth")
        save_torch_checkpoint(export_state_dict(model), out[kind])
    rng = np.random.default_rng(4)
    folder = root / "images"
    for cls in ("cat", "dog"):
        (folder / cls).mkdir(parents=True)
        for i in range(2):
            Image.fromarray(rng.integers(0, 255, size=(40, 36, 3), dtype=np.uint8)).save(
                folder / cls / f"{i}.png")
    out["folder"] = str(folder)
    return out


def _masks(state):
    return {k: torch.as_tensor(v) == 0 for k, v in state.items()
            if k.startswith(("blocks.", "stages.")) and k.endswith(".weight")
            and "norm" not in k and "dwconv" not in k}


@pytest.fixture(scope="module")
def pruned(files, tmp_path_factory):
    """Both prune CLIs per (kind, calibration): (JAX result, port result)."""
    root = tmp_path_factory.mktemp("classifier_prune")
    out = {}
    for kind, calib in (("deit", "synthetic"), ("convnext", files["folder"])):
        argv = ["--model", kind, "--model_scale", "tiny", "--ckpt", files[kind],
                "--pruning_method", f"{kind}_wanda_pruner", "--prune_spec", "0-0.5-1.0-1.0",
                "--num_samples", "8", "--batch_size", "4", "--calib", calib,
                "--save_pruned_model"] + COARSE[kind]
        out[kind] = (jprune(argv + ["--platform", "cpu", "--output_dir", str(root / "jax")]),
                     tprune(argv + ["--device", "cpu", "--output_dir", str(root / "port")]))
    return out


@pytest.mark.parametrize("kind", ["deit", "convnext"], ids=["deit_synthetic", "convnext_folder"])
def test_prune_cli_matches_the_jax_cli(pruned, kind):
    want, got = pruned[kind]
    assert got["job_id"] == want["job_id"] == f"{kind}_wanda_pruner_0-0.5-1.0-1.0_" + (
        "MEZO-GradOnly_sum_None" if kind == "deit" else "GradOnly_sum_block")
    assert got["prunable_sparsity"] == want["prunable_sparsity"]
    a, b = (torch.load(r["pth"], weights_only=True) for r in (want, got))
    assert sorted(a) == sorted(b)
    masks_a, masks_b = _masks(a), _masks(b)
    assert len(masks_a) == (12 if kind == "deit" else 8)
    if kind == "convnext":
        jd, td = read_flat_yaml(want["sparsity_dict"]), read_flat_yaml(got["sparsity_dict"])
        assert list(td) == list(jd) and len(td) == 8
        for k in jd:
            assert td[k] == pytest.approx(jd[k], rel=RTOL), k
    else:
        assert got["sparsity_dict"] is want["sparsity_dict"] is None
    for k in masks_a:
        assert torch.equal(masks_a[k], masks_b[k]), k


def test_the_folder_calibration_batch_is_the_jax_cli_one(files, monkeypatch):
    """``--calib <folder>``: the folder's images through the eval transform,
    cycled to ``--num_samples``, labels modulo the classes, in both CLIs."""
    from ecoflap_tpu.cli import prune as jp
    from ecoflap_tpu_torch.cli import prune as tp

    args = ["--model", "convnext", "--model_scale", "tiny", "--num_samples", "6",
            "--ckpt", files["convnext"], "--calib", files["folder"], "--device", "cpu"]
    _, tbatch, mb, _ = tp._classifier(tp.build_parser().parse_args(args), torch.device("cpu"),
                                      torch.float32)
    jargs = jp.build_parser().parse_args(args[:-2] + ["--platform", "cpu"])
    jbatch = jp._configs(jargs)[1]
    assert mb == 1
    np.testing.assert_array_equal(tbatch["label"].numpy(), np.asarray(jbatch["label"]))
    np.testing.assert_array_equal(tbatch["image"].numpy(), np.asarray(jbatch["image"]))
    assert tbatch["label"].tolist() == [0, 0, 1, 1, 0, 0]


@pytest.mark.parametrize("kind,where", [("deit", "synthetic"), ("convnext", "folder")])
def test_classification_from_the_pruned_pth_matches_the_jax_cli(pruned, files, kind, where,
                                                                 tmp_path, monkeypatch):
    pth = pruned[kind][1]["pth"]
    data = ["--synthetic"] if where == "synthetic" else ["--vis_root", files["folder"]]
    common = ["--model", kind, "--task", "classification", "--model_scale", "tiny",
              "--batch_size", "2"] + data
    jargs = common + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")]
    if kind == "deit":
        jargs += ["--checkpoint", pth]
    else:  # the JAX CLI reads ConvNeXt from orbax only: its params from the .pth
        cfg = jcls.build(kind, "tiny")[0]
        params = jck.convert_convnext(jck.load_torch_checkpoint(pth), cfg)
        monkeypatch.setattr(jeval, "_init_params", lambda *a, **k: params)
    want = jeval.main(jargs)
    got = teval(common + ["--checkpoint", pth, "--device", "cpu",
                          "--output_dir", str(tmp_path / "port")])
    assert got["agg_metrics"] == want["agg_metrics"]
    assert set(want) <= set(got)
