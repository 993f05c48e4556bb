"""The port's evaluate CLI (``ecoflap_tpu_torch.cli.evaluate``) on the CPU:
the planted-answer drill of tests/test_planted_eval.py through the port
(closed-form VQA 50.0, GQA 50.0 and captioning 5.5), the same metric dicts
as the JAX CLI on the same planted ``.pth`` files and annotations, a
``.pth`` pruned by the port's prune CLI, the synthetic BLIP-2 and LLaMA
runs, LLaMA perplexity against the JAX package, and the refusals."""

import json
import logging

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ecoflap_tpu.cli.evaluate import main as jmain
from ecoflap_tpu.models import blip2 as jblip2
from ecoflap_tpu.models import llama as jllama
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.evaluate import main as tmain
from ecoflap_tpu_torch.data.calibration import FileTokenizer, tiny_tokenizer_path
from ecoflap_tpu_torch.models import llama as tllama
from tests.torch_parity import llama_pair, one_torch_thread  # noqa: F401 (a fixture)
from tools.planted import make_planted_blip2

pytestmark = pytest.mark.usefixtures("one_torch_thread")

VQA_ANSWER = "no"
CAPTION = "the quick brown fox"
OTHER_CAPTION = "zebra stripes pattern here"


@pytest.fixture(scope="module")
def planted(tmp_path_factory):
    """Planted BLIP-2 ``.pth`` files made as tests/test_planted_eval.py makes
    them (tools/planted.py, the JAX ``export_blip2``), tiny images on disk,
    and the VQA, GQA and captioning annotation files."""
    tok = FileTokenizer(tiny_tokenizer_path())
    root = tmp_path_factory.mktemp("planted")
    cfg = jblip2.tiny_config(vocab_size=tok.vocab_size)
    ckpts = {}
    for name, text in (("vqa", VQA_ANSWER), ("cap", CAPTION)):
        state = jck.export_blip2(make_planted_blip2(cfg, tok._tok.encode(text).ids), cfg)
        ckpts[name] = str(root / f"planted_{name}.pth")
        jck.save_torch_checkpoint(state, ckpts[name])
    from PIL import Image

    vis_root = root / "images"
    vis_root.mkdir()
    rng = np.random.default_rng(0)
    for i in range(8):
        Image.fromarray(rng.integers(0, 255, size=(16, 16, 3), dtype=np.uint8)).save(
            vis_root / f"img{i}.png")
    anns = {
        "vqa": [{"image": f"img{i}.png", "question": "is it day?",
                 "answers": [VQA_ANSWER] * 10, "question_id": i} for i in range(4)]
        + [{"image": f"img{i}.png", "question": "is it night?",
            "answers": ["yes"] * 10, "question_id": i} for i in range(4, 8)],
        "gqa": [{"image": f"img{i}.png", "question": "is it day?",
                 "answer": VQA_ANSWER if i % 2 else "Yes", "question_id": i}
                for i in range(8)],
        "captioning": [{"image": f"img{i}.png", "caption": [CAPTION], "image_id": i}
                       for i in range(2)]
        + [{"image": f"img{i}.png", "caption": [OTHER_CAPTION], "image_id": i}
           for i in range(2, 4)],
    }
    paths = {}
    for task, ann in anns.items():
        paths[task] = str(root / f"{task}_ann.json")
        with open(paths[task], "w") as f:
            json.dump(ann, f)
    return {"root": root, "vis_root": str(vis_root), "ckpts": ckpts, "anns": paths,
            "vocab": tok.vocab_size}


def planted_args(planted, task, out):
    """The flags of tests/test_planted_eval.py's drills."""
    args = ["--model", "blip2_t5", "--task", task,
            "--checkpoint", planted["ckpts"]["cap" if task == "captioning" else "vqa"],
            "--tokenizer_path", tiny_tokenizer_path(),
            "--vocab_size", str(planted["vocab"]), "--ann", planted["anns"][task],
            "--vis_root", planted["vis_root"], "--num_beams", "5",
            "--output_dir", str(planted["root"] / out)]
    if task == "captioning":
        return args + ["--batch_size", "2", "--max_new_tokens", "16",
                       "--length_penalty", "1.0"]
    return args + ["--batch_size", "4"]


@pytest.fixture(scope="module")
def port_metrics(planted):
    return {task: tmain(["--device", "cpu"] + planted_args(planted, task, f"port_{task}"))
            for task in ("vqa", "gqa", "captioning")}


def test_planted_drill_gives_the_closed_form_values(port_metrics, planted):
    """VQA: "no" against 4 questions of "no" and 4 of "yes" is 50.0; GQA the
    same by exact match; captioning: the planted caption matches 2 of 4
    images, CIDEr-D (10 + 10 + 0 + 0) / 4 = 5.0, BLEU-4 0.5, 5.5 in all."""
    assert port_metrics["vqa"]["agg_metrics"] == pytest.approx(50.0, abs=1e-9)
    assert port_metrics["gqa"]["agg_metrics"] == pytest.approx(50.0, abs=1e-9)
    cap = port_metrics["captioning"]
    assert cap["CIDEr"] == pytest.approx(5.0, abs=1e-7)
    assert cap["Bleu_4"] == pytest.approx(0.5, abs=1e-7)
    assert cap["agg_metrics"] == pytest.approx(5.5, abs=1e-7)
    logged = (planted["root"] / "port_vqa" / "evaluate.txt").read_text().splitlines()
    assert json.loads(logged[-1])["val"]["agg_metrics"] == 50.0


@pytest.mark.parametrize("task", ["vqa", "gqa", "captioning"])
def test_planted_drill_matches_the_jax_cli(port_metrics, planted, task):
    """Every field of the result, COCOEvalCap's included, but the wall."""
    want = dict(jmain(["--platform", "cpu"] + planted_args(planted, task, f"jax_{task}")))
    got = dict(port_metrics[task])
    want.pop("eval_time_s")
    got.pop("eval_time_s")
    assert got == want


def test_a_pth_pruned_by_the_port_evaluates(planted, tmp_path, caplog):
    """``cli.prune --save_pruned_model`` (tiny BLIP-2, global magnitude) and
    that ``.pth`` through the real-data branch, with the hash tokenizer the
    JAX CLI also falls back to (loudly) without a tokenizer file."""
    from ecoflap_tpu_torch.cli.prune import main as prune

    res = prune(["--device", "cpu", "--model", "blip2_t5", "--model_scale", "tiny",
                 "--pruning_method", "blipt5_global_mag_pruner", "--prune_spec",
                 "2-0.5-1.0-1.0", "--is_global", "--num_samples", "8", "--batch_size",
                 "4", "--save_pruned_model", "--output_dir", str(tmp_path / "prune")])
    with caplog.at_level(logging.WARNING):
        metrics = tmain(["--device", "cpu", "--model", "blip2_t5", "--task", "vqa",
                         "--checkpoint", res["pth"], "--ann", planted["anns"]["vqa"],
                         "--vis_root", planted["vis_root"], "--batch_size", "4",
                         "--output_dir", str(tmp_path / "eval")])
    assert any("FALLING BACK" in r.message for r in caplog.records)
    assert set(metrics) == {"agg_metrics", "overall", "eval_time_s"}
    assert 0.0 <= metrics["agg_metrics"] <= 100.0


def test_synthetic_blip2_vqa_reports_batch_walls(tmp_path):
    metrics = tmain(["--device", "cpu", "--model", "blip2_t5", "--task", "vqa",
                     "--synthetic", "--batch_size", "4", "--eval_batches", "3",
                     "--output_dir", str(tmp_path)])
    assert len(metrics["batch_walls_s"]) == 3 and metrics["steady_qps"] > 0
    assert metrics["agg_metrics"] == metrics["overall"] == 0.0  # hash tokens: no "yes"


def test_synthetic_llama_perplexity_is_the_models(tmp_path):
    """The CLI's perplexity is ``llama.perplexity`` of the seed's model on
    the JAX CLI's stream (64 x 32 tokens in windows of 32 at tiny)."""
    metrics = tmain(["--device", "cpu", "--model", "llama", "--task", "wikitext_ppl",
                     "--synthetic", "--output_dir", str(tmp_path)])
    model = tllama.build_model(tllama.tiny_config(), device="cpu", seed=42)
    stream = np.random.default_rng(42).integers(2, model.cfg.vocab_size, size=(64 * 32,))
    want = tllama.perplexity(model, torch.from_numpy(stream), seqlen=32, batch_size=8)
    assert metrics["ppl"] == want and metrics["agg_metrics"] == -want
    assert 1.0 < want < 10 * model.cfg.vocab_size


def test_llama_perplexity_matches_jax_at_the_cli_shape():
    """The same weights and the CLI's stream and windows: float32, 1e-5."""
    cfg, params, model = llama_pair(seed=1)
    stream = np.random.default_rng(42).integers(2, cfg.vocab_size, size=(64 * 32,))
    want = jllama.perplexity(cfg, params, jnp.asarray(stream, jnp.int32), seqlen=32,
                             batch_size=8)
    got = tllama.perplexity(model, torch.from_numpy(stream), seqlen=32, batch_size=8)
    assert abs(got - want) <= 1e-5 * want


def test_without_a_card_the_default_device_raises(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tmain(["--model", "blip2_t5", "--task", "vqa", "--synthetic",
               "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("argv", [
    ["--model", "t5", "--task", "mmlu", "--ann", "x.json"],
    ["--model", "blip2_opt", "--task", "vqa", "--synthetic"],
    ["--model", "llama", "--task", "wikitext_ppl", "--ann", "x.json"],
], ids=["t5_mmlu", "blip2_opt", "llama_real"])
def test_unported_pairs_name_the_roadmap(tmp_path, argv):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmain(["--device", "cpu", "--output_dir", str(tmp_path)] + argv)


def test_a_checkpoint_that_is_not_a_pth_is_refused(planted, tmp_path):
    with pytest.raises(ValueError, match=r"\.pth"):
        tmain(["--device", "cpu", "--model", "blip2_t5", "--task", "vqa",
               "--checkpoint", str(tmp_path), "--ann", planted["anns"]["vqa"],
               "--vis_root", planted["vis_root"], "--output_dir", str(tmp_path)])
