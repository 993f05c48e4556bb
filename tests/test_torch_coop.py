"""The CoOp surface of the port against the JAX package: the 11 dataset
builders, their class renames and prompt templates, the image folder's
items on a tiny folder written here, the prompt ensembles, and the
real-data legs of both CLIs on that folder (CLIP and EVA-CLIP zero-shot
classification with the CoOp and the 80-template prompts, and the CLIP
prune calibrated on the folder), from the same parameters: the same metric
dicts, sparsity dicts and masks. Images are RGB PNGs of 20 x 24 pixels, so
the eval transform resizes and crops them to the tiny models' 16."""

import jax
import numpy as np
import pytest
import torch

from ecoflap_tpu.cli.evaluate import main as jeval
from ecoflap_tpu.cli.prune import main as jprune
from ecoflap_tpu.core.pytree import flatten_named
from ecoflap_tpu.core.registry import registry as jregistry
from ecoflap_tpu.data import coop as jcoop
from ecoflap_tpu.data import datasets as jdatasets
from ecoflap_tpu.data import prompts as jprompts
from ecoflap_tpu.data.processors import ImageEvalProcessor as JImageEvalProcessor
from ecoflap_tpu.models import clip as jclip
from ecoflap_tpu_torch.cli.evaluate import main as teval
from ecoflap_tpu_torch.cli.prune import main as tprune
from ecoflap_tpu_torch.core.registry import registry as tregistry
from ecoflap_tpu_torch.data import coop as tcoop
from ecoflap_tpu_torch.data import datasets as tdatasets
from ecoflap_tpu_torch.data import prompts as tprompts
from ecoflap_tpu_torch.data.processors import ImageEvalProcessor
from ecoflap_tpu_torch.models import clip as tclip
from ecoflap_tpu_torch.models.convert import load_jax_params
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from ecoflap_tpu_torch.utils.checkpoint import export_state_dict, save_torch_checkpoint
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CLASSES = {
    "caltech101": ["airplanes", "BACKGROUND_Google", "Faces", "Leopards", "ant"],
    "eurosat": ["AnnualCrop", "Forest", "SeaLake"],
    "imagenet": ["goldfish", "great_white_shark", "tench"],
}


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("coop")
    rng = np.random.default_rng(0)
    out = {}
    for ds, classes in CLASSES.items():
        for c in classes:
            (root / ds / c).mkdir(parents=True)
            for i in range(3):
                Image.fromarray(rng.integers(0, 255, size=(20, 24, 3), dtype=np.uint8)).save(
                    root / ds / c / f"img{i}.png")
        (root / ds / "notes.txt").write_text("not a class")  # a file is skipped
        out[ds] = str(root / ds)
    return out


def test_tables_and_builders_are_the_jax_packages():
    assert tcoop.COOP_TEMPLATES == jcoop.COOP_TEMPLATES
    assert tcoop.COOP_DATASETS == jcoop.COOP_DATASETS and len(tcoop.COOP_DATASETS) == 11
    assert tcoop.CALTECH_RENAMES == jcoop.CALTECH_RENAMES
    assert tcoop.EUROSAT_RENAMES == jcoop.EUROSAT_RENAMES
    assert tcoop.CALTECH_IGNORED == jcoop.CALTECH_IGNORED
    for ds in tcoop.COOP_DATASETS + ["cifar100"]:
        tregistry.get("builder", ds)  # registered in the port
    for ds, names in (("caltech101", ["Faces", "Motorbikes", "yin_yang"]),
                      ("eurosat", ["SeaLake", "Highway"]), ("dtd", ["banded"])):
        for n in names:
            assert tcoop.normalize_classname(ds, n) == jcoop.normalize_classname(ds, n)
        assert tcoop.coop_prompts(ds, names) == jcoop.coop_prompts(ds, names)
    assert tprompts.TEMPLATE_SETS == jprompts.TEMPLATE_SETS
    names = ["great_white_shark", "tench"]
    for t in tprompts.TEMPLATE_SETS.values():
        assert tprompts.build_prompts(names, t) == jprompts.build_prompts(names, t)


@pytest.mark.parametrize("ds", sorted(CLASSES))
def test_image_folder_items_match_jax(folders, ds):
    """Classnames (CoOp-normalised, ignored folders dropped), labels and the
    transformed images of every item."""
    t = tregistry.get("builder", ds)({"vis_root": folders[ds]},
                                     vis_processor=ImageEvalProcessor(image_size=16))
    j = jregistry.get("builder", ds)({"vis_root": folders[ds]},
                                     vis_processor=JImageEvalProcessor(image_size=16))
    assert t.classnames == j.classnames and len(t) == len(j)
    if ds == "caltech101":
        # sorted folder names (upper case first), BACKGROUND_Google dropped
        assert t.classnames == ["face", "leopard", "airplane", "ant"]
    for i in range(len(j)):
        a, b = t[i], j[i]
        assert a["label"] == b["label"]
        assert a["image"].shape == (16, 16, 3)
        np.testing.assert_array_equal(a["image"], b["image"])
    raw = tdatasets.ImageFolderDataset({"vis_root": folders[ds]})[0]["image"]
    np.testing.assert_array_equal(raw, jdatasets.ImageFolderDataset(
        {"vis_root": folders[ds]})[0]["image"])


@pytest.fixture(scope="module")
def clip_ckpts(tmp_path_factory):
    """The JAX CLI's random init at seed 42 (tiny, float32) as a ``.pth``,
    so the port's ``--checkpoint`` starts where the JAX CLI does."""
    root = tmp_path_factory.mktemp("clip_ckpt")
    out = {}
    for kind in ("clip", "eva_clip"):
        eva = kind == "eva_clip"
        params = jclip.init_params(jclip.tiny_config(eva=eva), jax.random.PRNGKey(42))
        model = tclip.build_model(tclip.tiny_config(eva=eva), device="cpu", seed=None)
        load_jax_params(model, flatten_named(params))
        out[kind] = str(root / f"{kind}.pth")
        save_torch_checkpoint(export_state_dict(model), out[kind])
    return out


@pytest.mark.parametrize("kind,ds,templates", [
    ("clip", "caltech101", "coop"), ("clip", "eurosat", "coop"),
    ("clip", "imagenet", "full"), ("eva_clip", "imagenet", "subset")])
def test_zero_shot_classification_matches_the_jax_cli(tmp_path, folders, clip_ckpts,
                                                      kind, ds, templates):
    common = ["--model", kind, "--task", "classification", "--dataset", ds,
              "--vis_root", folders[ds], "--prompt_templates", templates,
              "--batch_size", "4"]
    want = jeval(common + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = teval(common + ["--device", "cpu", "--checkpoint", clip_ckpts[kind],
                          "--output_dir", str(tmp_path / "torch")])
    want.pop("eval_time_s")
    got.pop("eval_time_s")
    assert got == want and set(got) == {"agg_metrics"}


def test_clip_prune_calibrated_on_the_folder_matches_the_jax_cli(tmp_path, folders,
                                                                 clip_ckpts):
    """``--calib <folder> --dataset eurosat``: the folder's images paired
    with their class's CoOp prompt (cycled to 8 samples), a first-order
    coarse stage: the same sparsity dict (rtol 1e-5) and sparsity."""
    common = ["--model", "clip", "--model_scale", "tiny", "--ckpt", clip_ckpts["clip"],
              "--pruning_method", "clip_wanda_pruner", "--prune_spec", "2-0.6-1.0-1.0",
              "--sparsity_ratio_granularity", "block", "--max_sparsity_per_layer", "0.5",
              "--score_method", "GradOnly_sum", "--num_samples", "8", "--batch_size", "4",
              "--num_data_first_stage", "8", "--calib", folders["eurosat"],
              "--dataset", "eurosat"]
    want = jprune(common + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tprune(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    jd, td = read_flat_yaml(want["sparsity_dict"]), read_flat_yaml(got["sparsity_dict"])
    assert list(td) == list(jd) and len(td) == 16
    for k in jd:
        assert td[k] == pytest.approx(jd[k], rel=1e-5), k
    assert got["prunable_sparsity"] == want["prunable_sparsity"]
    assert got["job_id"] == want["job_id"]


def test_a_pruned_clip_pth_evaluates(tmp_path, folders):
    """The CoOp launcher's prune -> eval leg through a ``.pth`` (the JAX
    launcher chains an orbax checkpoint): ``--save_pruned_model``, then the
    evaluate CLI's ``--checkpoint``."""
    res = tprune(["--device", "cpu", "--model", "clip", "--pruning_method",
                  "clip_wanda_pruner", "--prune_spec", "2-0.6-1.0-1.0", "--num_samples", "8",
                  "--batch_size", "4", "--save_pruned_model",
                  "--output_dir", str(tmp_path / "prune")])
    metrics = teval(["--device", "cpu", "--model", "clip", "--task", "classification",
                     "--dataset", "imagenet", "--vis_root", folders["imagenet"],
                     "--prompt_templates", "coop", "--checkpoint", res["pth"],
                     "--batch_size", "3", "--output_dir", str(tmp_path / "eval")])
    assert set(metrics) == {"agg_metrics", "eval_time_s"}
    assert 0.0 <= metrics["agg_metrics"] <= 100.0
    state = torch.load(res["pth"], weights_only=True)
    weights = [v for k, v in state.items() if "resblocks" in k and (
        k.endswith("in_proj_weight") or (k.endswith(".weight") and (
            "out_proj" in k or "c_fc" in k or "c_proj" in k)))]
    assert len(weights) == 16
    zeros = sum(int((w == 0).sum()) for w in weights) / sum(w.numel() for w in weights)
    assert zeros == pytest.approx(res["prunable_sparsity"], abs=1e-4)
