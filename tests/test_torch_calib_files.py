"""The file-driven calibration branches of the prune CLI against the JAX
CLI's, from one ``--ckpt``, on tiny files written here: BLIP-2 with
``--calib <LAVIS caption annotations> --vis_root <images>`` (the
``coco_caption`` builder, the BLIP eval transform, cycled to
``--num_samples``, the repo's tiny tokenizer) and LLaMA with ``--calib
<C4-style jsonl>`` (documents tokenized with EOS, one stream, random
windows). The calibration batches are equal, and a first-order coarse stage
gives the same sparsity dict (rtol 1e-5) and masks; a stream too short for
the windows ends both runs with the same message. The dataset builders
(``c4``, ``wikitext2``, ``prefix_conceptual_caption_3m``, ``nlvr``,
``flickr30k``) yield the JAX builders' samples."""

import json

import jax
import numpy as np
import pytest
import torch

from ecoflap_tpu.cli import prune as jcli
from ecoflap_tpu.data import datasets as jds
from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli import prune as tcli
from ecoflap_tpu_torch.core.registry import registry as treg
from ecoflap_tpu_torch.data import datasets as tds
from ecoflap_tpu_torch.data.calibration import tiny_tokenizer_path
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

WORDS = ["a dog runs in the park", "two cats sit on a red house",
         "the girl throws a blue ball", "birds fly over the water"]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    from PIL import Image

    root = tmp_path_factory.mktemp("calib")
    rng = np.random.default_rng(0)
    anns = []
    for i, cap in enumerate(WORDS[:3]):
        Image.fromarray(rng.integers(0, 256, size=(24, 20, 3), dtype=np.uint8)).save(
            root / f"im{i}.png")
        anns.append({"image": f"im{i}.png", "caption": [cap, cap + " again"],
                     "image_id": i})
    (root / "caps.json").write_text(json.dumps(anns))
    (root / "prefix.json").write_text(json.dumps(
        [{"image": "im0.png", "caption": WORDS[0]}, {"image": "im1.png", "caption": WORDS[1]}]))
    (root / "nlvr.json").write_text(json.dumps(
        [{"images": ["im0.png", "im1.png"], "sentence": WORDS[2], "label": "True"},
         {"images": ["im2.png", "im0.png"], "sentence": WORDS[3], "label": "False"}]))
    docs = [" ".join(rng.choice(WORDS).split() * 6) for _ in range(12)]
    (root / "c4.jsonl").write_text("".join(json.dumps({"text": d}) + "\n" for d in docs))
    (root / "short.jsonl").write_text(json.dumps({"text": "a dog"}) + "\n")
    (root / "wiki.txt").write_text("\n".join(WORDS))
    cfg = jblip2.tiny_config()
    jck.save_torch_checkpoint(jck.export_blip2(
        jblip2.init_params(cfg, jax.random.PRNGKey(3)), cfg), str(root / "blip2.pth"))
    lcfg = jllama.tiny_config()
    jck.save_torch_checkpoint(jck.export_llama(
        jllama.init_params(lcfg, jax.random.PRNGKey(4)), lcfg), str(root / "llama.pth"))
    return root


def blip2_argv(root):
    return ["--model", "blip2_t5", "--model_scale", "tiny", "--ckpt", str(root / "blip2.pth"),
            "--calib", str(root / "caps.json"), "--vis_root", str(root),
            "--tokenizer_path", tiny_tokenizer_path(),
            "--pruning_method", "blipt5_wanda_pruner", "--vit_prune_spec", "3-0.5-1.0-1.0",
            "--t5_prune_spec", "2-0.5-1.0-1.0", "--sparsity_ratio_granularity", "block",
            "--score_method", "GradMagAbs_sum", "--max_sparsity_per_layer", "0.6",
            "--num_data_first_stage", "8", "--num_samples", "8", "--batch_size", "4",
            "--save_pruned_model"]


def llama_argv(root, calib="c4.jsonl"):
    return ["--model", "llama", "--model_scale", "tiny", "--ckpt", str(root / "llama.pth"),
            "--calib", str(root / calib), "--pruning_method", "llama_wanda_pruner",
            "--prune_spec", "2-0.5-1.0-1.0", "--sparsity_ratio_granularity", "block",
            "--score_method", "GradOnly_sum", "--max_sparsity_per_layer", "0.7",
            "--num_data_first_stage", "8", "--num_samples", "8", "--batch_size", "4",
            "--save_pruned_model"]


@pytest.mark.parametrize("model", ["blip2_t5", "llama"])
def test_calibration_batch_from_files_matches_jax(files, model):
    argv = blip2_argv(files) if model == "blip2_t5" else llama_argv(files)
    _, want, jmb, _ = jcli._configs(jcli.build_parser().parse_args(argv + ["--platform", "cpu"]))
    _, got, tmb, _ = tcli.SETUPS[model](tcli.build_parser().parse_args(argv + ["--device", "cpu"]),
                                        torch.device("cpu"), torch.float32)
    assert tmb == jmb and sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-6, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("model", ["blip2_t5", "llama"])
def test_prune_from_files_matches_the_jax_cli(files, tmp_path, model):
    argv = blip2_argv(files) if model == "blip2_t5" else llama_argv(files)
    want = jcli.main(argv + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tcli.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    assert got["job_id"] == want["job_id"]
    jd, td = read_flat_yaml(want["sparsity_dict"]), read_flat_yaml(got["sparsity_dict"])
    assert list(td) == list(jd) and len(td) > 0
    for k in jd:
        assert td[k] == pytest.approx(jd[k], rel=1e-5), k
    a = torch.load(want["pth"], weights_only=True)
    b = torch.load(got["pth"], weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k] == 0, b[k] == 0), k


def test_a_stream_too_short_ends_both_clis_with_the_jax_message(files, tmp_path):
    argv = llama_argv(files, "short.jsonl")
    with pytest.raises(SystemExit) as want:
        jcli.main(argv + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    with pytest.raises(SystemExit) as got:
        tcli.main(argv + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    assert str(got.value) == str(want.value)
    assert "need >= 288 for 8 windows of 32" in str(got.value)


def test_c4_without_a_jsonl_asks_for_one():
    with pytest.raises(RuntimeError, match="download"):
        treg.get("builder", "c4")({})


@pytest.mark.parametrize("name,cfg_of", [
    ("c4", lambda r: {"jsonl_path": str(r / "c4.jsonl")}),
    ("prefix_conceptual_caption_3m", lambda r: {"vis_root": str(r),
                                                "ann_paths": [str(r / "prefix.json")]}),
    ("prefix_conceptual_caption_12m", lambda r: {"vis_root": str(r),
                                                 "ann_paths": [str(r / "prefix.json")]}),
    ("nlvr", lambda r: {"vis_root": str(r), "ann_paths": [str(r / "nlvr.json")]}),
    ("flickr30k", lambda r: {"vis_root": str(r), "ann_paths": [str(r / "caps.json")]}),
    ("coco_retrieval", lambda r: {"vis_root": str(r), "ann_paths": [str(r / "caps.json")]}),
])
def test_builders_yield_the_jax_samples(files, name, cfg_of):
    from ecoflap_tpu.core.registry import registry as jreg

    want = jreg.get("builder", name)(cfg_of(files))
    got = treg.get("builder", name)(cfg_of(files))
    assert len(got) == len(want) > 0
    for i in range(len(want)):
        w, g = want[i], got[i]
        assert sorted(g) == sorted(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                np.testing.assert_array_equal(g[k], w[k])
            else:
                assert g[k] == w[k], k


def test_wikitext2_stream_matches_jax(files):
    from ecoflap_tpu.data.calibration import HashTokenizer as JTok
    from ecoflap_tpu_torch.data.calibration import HashTokenizer as TTok

    cfg = {"text_path": str(files / "wiki.txt")}
    want = jds.WikiTextDataset(cfg).token_stream(JTok(vocab_size=100))
    got = tds.WikiTextDataset(cfg).token_stream(TTok(vocab_size=100))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.int32 and len(got) > 10
