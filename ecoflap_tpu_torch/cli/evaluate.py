"""Evaluation CLI for BLIP-2 FlanT5, LLaMA, standalone FlanT5 (MMLU), CLIP /
EVA-CLIP (zero-shot classification), BLIP-1, DeiT / ConvNeXt, BLIP-2 OPT
and the stage-1 Q-Former; port of ``ecoflap_tpu/cli/evaluate.py`` (reference
evaluate_blip.py:345-491, LLaMA/main.py:89-90, mmlu_eval/evaluate_flan.py,
CoOp/trainers/zsclip.py).
The JAX CLI's flags, so a pruned ``.pth`` from
``ecoflap_tpu_torch.cli.prune --save_pruned_model`` evaluates as

  python -m ecoflap_tpu_torch.cli.evaluate --model blip2_t5 --task vqa \\
      --model_scale full --checkpoint output/pruned_checkpoint/<job>.pth \\
      --tokenizer_path <tokenizer.json> --ann <vqa annotations.json> \\
      --vis_root <image dir> --num_beams 5 --max_new_tokens 10 \\
      --length_penalty -1

(``--task gqa`` and ``captioning`` likewise; captioning decodes from an
empty prompt). Without ``--ann`` and ``--vis_root``, or with
``--synthetic``, it runs the JAX CLI's synthetic evaluation from a random
init at ``--seed``: BLIP-2 on random images and ``"question {i}"`` prompts
(``--eval_batches`` batches; the result also holds each batch's wall and,
from 3 batches on, the steady rate after the first), and LLaMA's WikiText
perplexity on a random stream of 64 x 32 tokens:

  python -m ecoflap_tpu_torch.cli.evaluate --model blip2_t5 --task vqa \\
      --model_scale full --synthetic --batch_size 8 --eval_batches 3
  python -m ecoflap_tpu_torch.cli.evaluate --model llama \\
      --task wikitext_ppl --model_scale full --synthetic --seqlen 2048

BLIP-1 (``--model blip1``, ``blip_base`` at small and full) evaluates the
JAX CLI's synthetic retrieval, VQA, NLVR and captioning from a random init
or a UPop ``--checkpoint``:

  python -m ecoflap_tpu_torch.cli.evaluate --model blip1 --task captioning \
      --model_scale full --checkpoint pruned.pth --num_beams 3 --max_new_tokens 20

FlanT5's synthetic MMLU reads the first decoder step's logits at the ids of
A/B/C/D for 8 random questions of ``college_physics`` (5 shots, hash-token
prompts cut at 64 tokens); CLIP's synthetic zero-shot classification builds
the tiny model, as the JAX CLI does, whatever ``--model_scale`` says.
Zero-shot classification on an image folder (``--vis_root``) builds the
classifier from ``--prompt_templates`` (``full``: the 80 OpenAI ImageNet
templates; ``coop``: the dataset's CoOp prompt):

  python -m ecoflap_tpu_torch.cli.evaluate --model t5 --task mmlu \
      --model_scale full --synthetic
  python -m ecoflap_tpu_torch.cli.evaluate --cfg-path clip/exp_imnet_zs_eval.yaml \
      --vis_root <imagenet val folder> --checkpoint <pruned clip .pth> \
      --prompt_templates coop

DeiT and ConvNeXt report top-1 on random images (``--synthetic``) or on an
image folder (``--vis_root``, the ``imagenet`` builder), from the random
init or a pruned ``.pth``; BLIP-2 OPT-2.7B captions random images from the
prompt "a photo of" (min length 8); the stage-1 Q-Former's retrieval
(tiny only, as in the JAX CLI) ranks random ViT features against hash-token
captions:

  python -m ecoflap_tpu_torch.cli.evaluate --model deit --task classification \
      --model_scale full --synthetic --checkpoint pruned_deit.pth
  python -m ecoflap_tpu_torch.cli.evaluate --model blip2_opt --task captioning \
      --model_scale full --synthetic --batch_size 8 --num_beams 5 --max_new_tokens 30
  python -m ecoflap_tpu_torch.cli.evaluate --model blip2_qformer --task retrieval

A project YAML (``--cfg-path``, ``--options``) sets the flags as in the
prune CLI. A BLIP-2 ``.pth`` loads in bf16 whatever ``--dtype`` says, as the
JAX CLI converts it (evaluate.py:604-607); a T5 or CLIP ``.pth`` (the JAX
CLI reads an orbax directory there) loads in the ``--dtype``; a DeiT or
ConvNeXt ``.pth`` in float32 (the JAX CLI converts DeiT's so, and reads
ConvNeXt from orbax only). Runs on the card unless ``--device cpu``; the
result is one JSON line. Every model/task pair of the JAX CLI is ported; the
others raise, as there.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: --cfg-path's precedence reads the typed flags
    p = argparse.ArgumentParser(description="ECoFLaP evaluation (PyTorch/CUDA)",
                                allow_abbrev=False)
    p.add_argument("--cfg-path", dest="cfg_path", default=None,
                   help="project YAML (bare names resolve under "
                        "configs/projects/); explicit flags override the file")
    p.add_argument("--options", nargs="*", default=None,
                   help="dot-list overrides, e.g. run.batch_size_eval=16")
    p.add_argument("--model", default=None,
                   choices=["blip2_t5", "blip2_opt", "blip2_qformer", "t5", "eva_clip",
                            "clip", "llama", "blip1", "deit", "convnext"])
    p.add_argument("--model_scale", default="tiny", choices=["tiny", "small", "full"],
                   help="tiny = test shapes; small = ViT-B + flan-t5-base or "
                        "OpenLLaMA-3B; full = EVA ViT-g + FlanT5-XL or LLaMA-7B")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="weight dtype of a random init; auto = bf16 for small/full, "
                        "f32 for tiny (a .pth always loads in bf16)")
    p.add_argument("--task", default=None,
                   choices=["vqa", "gqa", "captioning", "classification", "retrieval",
                            "nlvr", "mmlu", "wikitext_ppl"])
    p.add_argument("--tokenizer_path", default=None,
                   help="local tokenizer.json (real subword vocab)")
    p.add_argument("--checkpoint", default=None, help="a reference-named torch .pth")
    p.add_argument("--ann", default=None, help="annotation json")
    p.add_argument("--vis_root", default="")
    p.add_argument("--prompt_templates", default="full",
                   choices=("full", "subset", "simple", "coop"),
                   help="zero-shot classifier prompts: full = the 80 OpenAI "
                        "ImageNet templates, subset = 7 of them, simple = one, "
                        "coop = the dataset's CoOp template (zsclip.py:13-43)")
    p.add_argument("--dataset", default="imagenet",
                   help="classification image-folder builder: imagenet, "
                        "cifar100 or any of the 11 CoOp dataset names")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--mesh", default="none",
                   help="'none' | 'dp' | 'dp=N,tp=M' over torchrun's ranks: each dp "
                        "rank predicts its slice of every batch (batch_size divisible "
                        "by dp) and rank 0 writes the metrics; tp > 1 splits the "
                        "weights the tp rules match")
    p.add_argument("--eval_batches", type=int, default=2,
                   help="synthetic eval: number of batches (>= 3 separates the "
                        "first batch from the steady rate)")
    p.add_argument("--num_beams", type=int, default=5)
    p.add_argument("--max_new_tokens", type=int, default=10)
    p.add_argument("--length_penalty", type=float, default=-1.0)
    p.add_argument("--seqlen", type=int, default=2048,
                   help="llama perplexity window (32 at --model_scale tiny)")
    p.add_argument("--output_dir", default="output")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--vocab_size", type=int, default=None,
                   help="tiny-scale T5 vocab override (e.g. to match a "
                        "--tokenizer_path vocab)")
    return p


# the tasks that score one prediction per sample: under --mesh dp each rank
# predicts its slice of a batch and the predictions are gathered
PER_SAMPLE_TASKS = ("vqa", "gqa", "captioning", "multimodal_classification")


def _task(name: str, fn, *args, **kwargs):
    """``tasks.setup_task``; a per-sample task's prediction callable runs on
    this rank's dp slice of each batch under an active mesh
    (``parallel.sharding.dp_map``)."""
    from ecoflap_tpu_torch.parallel.sharding import dp_map
    from ecoflap_tpu_torch.tasks import setup_task

    return setup_task(name, dp_map(fn) if name in PER_SAMPLE_TASKS else fn,
                      *args, **kwargs)


def _place(model):
    """The model's weights split over tp when the active mesh has tp > 1."""
    from ecoflap_tpu_torch.parallel.mesh import current
    from ecoflap_tpu_torch.parallel.sharding import shard_params

    mesh = current()
    return shard_params(model, mesh) if mesh is not None else model


def _decode_all(tok, out: torch.Tensor):
    return [tok.decode(row) for row in out.cpu().tolist()]


def _not_ported(args, where: str):
    return NotImplementedError(
        f"{args.model}/{args.task} {where} evaluation: neither ecoflap_tpu_torch nor "
        "the JAX CLI has it (ROADMAP.md, section 1)")


def _load_pth(model, path: str) -> None:
    from ecoflap_tpu_torch.utils.checkpoint import load_into, load_torch_checkpoint

    if not path.endswith(".pth"):
        raise ValueError(f"--checkpoint {path!r}: the port reads a torch .pth "
                         "(orbax directories are the JAX package's)")
    load_into(model, load_torch_checkpoint(path))


def _model(mod, cfg, args, device, dtype):
    """``mod.build_model`` from ``--checkpoint`` (a ``.pth``, in ``dtype``) or
    the random init at ``--seed``."""
    model = mod.build_model(cfg, device=device, dtype=dtype,
                            seed=None if args.checkpoint else args.seed)
    if args.checkpoint:
        _load_pth(model, args.checkpoint)
    return _place(model)


def _synthetic_eval(args, device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """The JAX CLI's smoke evaluation on random data (evaluate.py:206-265)."""
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.parallel.dist import is_main_process
    from ecoflap_tpu_torch.runners.runner import Runner

    rng = np.random.default_rng(args.seed)
    runner = Runner(args.output_dir, f"eval_{args.model}_{args.task}",
                    write=is_main_process())

    if args.model == "llama" and args.task == "wikitext_ppl":
        from ecoflap_tpu_torch.models import llama

        cfg = llama.config_for_scale(args.model_scale)
        model = _place(llama.build_model(cfg, device=device, dtype=dtype, seed=args.seed))
        stream = rng.integers(2, cfg.vocab_size, size=(64 * 32,))
        seqlen = args.seqlen if args.model_scale != "tiny" else 32
        task = _task(args.task, lambda s: llama.perplexity(
            model, torch.from_numpy(s).to(device), seqlen=seqlen,
            batch_size=args.batch_size))
        return runner.evaluate(task, stream)

    if args.model == "blip2_t5" and args.task in ("vqa", "gqa", "captioning"):
        from ecoflap_tpu_torch.models import blip2
        from ecoflap_tpu_torch.models.generation import GenerateConfig

        cfg = blip2.config_for_scale(args.model_scale, args.vocab_size)
        model = _place(blip2.build_model(cfg, device=device, dtype=dtype, seed=args.seed))
        tok = HashTokenizer(vocab_size=cfg.t5.vocab_size)
        gen = GenerateConfig(max_new_tokens=args.max_new_tokens,
                             num_beams=args.num_beams,
                             length_penalty=args.length_penalty)
        batch_walls = []

        def predict_fn(batch):
            t0 = time.time()
            ids, mask = tok(batch["text_input"], max_length=8)
            out = model.generate(torch.from_numpy(batch["image"]).to(device),
                                 torch.from_numpy(ids).to(device),
                                 torch.from_numpy(mask).to(device), gen)
            texts = _decode_all(tok, out)  # the one wait for the card
            batch_walls.append(time.time() - t0)
            return texts

        img = cfg.vit.img_size
        batches = [{
            "image": rng.normal(size=(args.batch_size, img, img, 3)).astype(np.float32),
            "text_input": [f"question {i}" for i in range(args.batch_size)],
            "gt_answers": [["yes"] * 10 for _ in range(args.batch_size)],
        } for _ in range(args.eval_batches)]
        # every synthetic task is scored as VQA, as the JAX CLI scores it
        metrics = runner.evaluate(_task("vqa", predict_fn), batches)
        # the first batch carries the warm-up; the rest are the steady rate
        metrics["batch_walls_s"] = [round(w, 2) for w in batch_walls]
        if len(batch_walls) >= 3:
            steady = batch_walls[1:]
            metrics["steady_qps"] = round(args.batch_size * len(steady) / sum(steady), 3)
        return metrics

    if args.model in ("clip", "eva_clip") and args.task == "classification":
        from ecoflap_tpu_torch.models import clip

        # the JAX CLI's smoke run: the tiny float32 model at any scale
        # (evaluate.py:500-526), 10 random prompts, 2 batches
        cfg = clip.tiny_config(eva=args.model == "eva_clip")
        model = _model(clip, cfg, args, device, torch.float32)
        prompts = rng.integers(1, cfg.text.vocab_size, size=(10, cfg.text.context_length))
        classifier = model.zero_shot_classifier(torch.from_numpy(prompts).to(device), 10)
        img = cfg.img_size
        batches = [{
            "image": rng.normal(size=(args.batch_size, img, img, 3)).astype(np.float32),
            "label": rng.integers(0, 10, size=(args.batch_size,)),
        } for _ in range(2)]
        return runner.evaluate(_task("multimodal_classification",
                                          zero_shot_predict_fn(model, classifier, device)),
                               batches)

    if args.model == "t5" and args.task == "mmlu":
        from ecoflap_tpu_torch.models import t5

        model = _model(t5, t5.config_for_scale(args.model_scale), args, device, dtype)
        tok = HashTokenizer(vocab_size=model.cfg.vocab_size)
        abcd = [tok._word_id(c) for c in "ABCD"]
        dev = [[f"q{i}", "w", "x", "y", "z", "B"] for i in range(5)]
        test = [[f"t{i}", "w", "x", "y", "z", "ABCD"[rng.integers(0, 4)]]
                for i in range(8)]
        task = _task("mmlu", mmlu_logits_fn(model, tok, device), abcd,
                          token_len_fn=lambda s: len(tok([s], max_length=10_000,
                                                         pad=False)[0][0]),
                          max_tokens=2048)
        return runner.evaluate(task, {"college_physics": {"dev": dev, "test": test}})

    if args.model == "blip1" and args.task in BLIP1_KINDS:
        return _blip1_eval(args, device, dtype, rng, runner)

    if args.model in ("deit", "convnext") and args.task == "classification":
        # top-1 on random images and labels, 2 batches (evaluate.py:528-548)
        from ecoflap_tpu_torch.models.classifiers import num_classes

        model = _classifier_model(args, device, dtype)
        img, ncls = model.cfg.img_size, num_classes(model.cfg)
        batches = [{
            "image": rng.normal(size=(args.batch_size, img, img, 3)).astype(np.float32),
            "label": rng.integers(0, ncls, size=(args.batch_size,)),
        } for _ in range(2)]
        return runner.evaluate(_task("multimodal_classification",
                                          classifier_predict_fn(model, device)), batches)

    if args.model == "blip2_opt" and args.task == "captioning":
        return _blip2_opt_captioning(args, device, dtype, rng, runner)

    if args.model == "blip2_qformer" and args.task == "retrieval":
        return _blip2_qformer_retrieval(args, device, rng, runner)

    raise _not_ported(args, "synthetic")


def _classifier_model(args, device, dtype):
    """DeiT or ConvNeXt at ``--model_scale`` (evaluate.py:171-195), from a
    ``--checkpoint`` ``.pth`` in float32 (the JAX CLI converts DeiT's in
    float32 and reads ConvNeXt only from orbax; the port reads ConvNeXt's
    FB-named ``.pth``, whose names are its own) or the random init at
    ``--seed`` in ``dtype``."""
    from ecoflap_tpu_torch.models import classifiers

    cfg = classifiers.build(args.model, args.model_scale)
    return _model(classifiers, cfg, args, device,
                  torch.float32 if args.checkpoint else dtype)


def classifier_predict_fn(model, device):
    """batch -> (B, classes) logits of ``batch["image"]``."""
    w = next(model.parameters())

    @torch.inference_mode()
    def predict(batch):
        return model(torch.from_numpy(np.asarray(batch["image"])).to(device, w.dtype))

    return predict


def _blip2_opt_captioning(args, device, dtype, rng, runner) -> Dict[str, Any]:
    """BLIP-2 OPT captioning on random images (evaluate.py:267-310): one
    shared unpadded prompt, "a photo of"; ``min_length`` 8
    (caption_coco_opt2.7b_eval.yaml), ``--num_beams``, ``--length_penalty``,
    OPT's EOS and pad ids; ``--model_scale small`` ends the run."""
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.models import blip2_opt
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    cfg = blip2_opt.config_for_scale(args.model_scale)
    model = _place(blip2_opt.build_model(cfg, device=device, dtype=dtype, seed=args.seed))
    tok = HashTokenizer(vocab_size=cfg.opt.vocab_size)
    gen = GenerateConfig(max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
                         min_length=8, length_penalty=args.length_penalty,
                         eos_token_id=cfg.opt.eos_token_id, pad_token_id=cfg.opt.pad_token_id)
    # unpadded: a padded prompt would feed the pad token to decode step 0
    prompt = np.asarray(tok(["a photo of"], max_length=8, add_eos=False, pad=False)[0],
                        np.int64)

    def gen_fn(batch):
        ids = torch.from_numpy(np.repeat(prompt, len(batch["image"]), axis=0)).to(device)
        out = model.generate(torch.from_numpy(batch["image"]).to(device), ids,
                             torch.ones_like(ids), gen)
        return _decode_all(tok, out)

    img, n = cfg.vit.img_size, args.batch_size
    batches = [{
        "image": rng.normal(size=(n, img, img, 3)).astype(np.float32),
        "image_id": list(range(i * n, (i + 1) * n)),
        "gt_captions": [["a photo"] for _ in range(n)],
    } for i in range(args.eval_batches)]
    return runner.evaluate(_task("captioning", gen_fn), batches)


def _blip2_qformer_retrieval(args, device, rng, runner) -> Dict[str, Any]:
    """Stage-1 Q-Former retrieval over random frozen ViT features
    (evaluate.py:361-383): ``compute_sim_matrix`` (the ITC similarity, then
    the ITM re-rank of each side's top min(8, N)), scored by
    ``score_retrieval_pair``. Only the tiny float32 model is configured, as
    in the JAX CLI."""
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.models import blip2_qformer as q1
    from ecoflap_tpu_torch.tasks.retrieval import score_retrieval_pair

    if args.model_scale != "tiny":
        raise SystemExit("blip2_qformer retrieval: only --model_scale tiny is configured "
                         "(stage-1 tower over pre-extracted ViT features)")
    cfg = q1.tiny_config()
    model = q1.build_model(cfg, device=device, seed=args.seed)
    tok = HashTokenizer(vocab_size=cfg.vocab_size)
    n = args.batch_size
    embeds = torch.from_numpy(rng.normal(size=(n, 8, cfg.qformer.encoder_width))
                              .astype(np.float32)).to(device)
    ids, mask = (torch.from_numpy(a).to(device) for a in tok(
        [f"caption {i}" for i in range(n)], max_length=8))
    t0 = time.time()
    metrics = score_retrieval_pair(*q1.compute_sim_matrix(model, embeds, ids, mask,
                                                          k_test=min(8, n)))
    metrics["eval_time_s"] = round(time.time() - t0, 2)
    runner.log_metrics(metrics)
    return metrics


BLIP1_KINDS = {"retrieval": "blip_retrieval", "vqa": "blip_vqa", "nlvr": "blip_nlvr",
               "captioning": "blip_caption"}


def _blip1_eval(args, device, dtype, rng, runner) -> Dict[str, Any]:
    """The JAX CLI's blip1 branches (evaluate.py:311-360, 385-499), on
    random images and hash-token texts: retrieval (ITC similarity, then an
    ITM re-rank of each side's top 8, the two sides ranked apart), VQA (rank
    inference over an 18-answer list, top 8 by the first token), NLVR (the
    2-way head's accuracy) and captioning (beam search from "a picture of",
    min length 5). ``--checkpoint`` loads a UPop ``.pth`` in ``--dtype``."""
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.models import blip1
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    cfg = blip1.config_for_scale(args.model_scale)
    model = blip1.build_model(cfg, BLIP1_KINDS[args.task], device=device, dtype=dtype,
                              seed=None if args.checkpoint else args.seed)
    if args.checkpoint:
        _load_pth(model, args.checkpoint)
    tok = HashTokenizer(vocab_size=cfg.text.vocab_size)
    img, n = cfg.vit.img_size, args.batch_size

    def dev(a):
        return torch.from_numpy(np.asarray(a)).to(device)

    def images():
        return rng.normal(size=(n, img, img, 3)).astype(np.float32)

    if args.task == "retrieval":
        ims = images()
        ids, mask = tok([f"caption {i}" for i in range(n)], max_length=8)

        @torch.inference_mode()
        def sim_fn(_):
            return model.sim_matrix(dev(ims), dev(ids), dev(mask)).cpu().numpy()

        @torch.inference_mode()
        def itm_match(img_rows, txt_rows):
            lg = model.itm_logits(dev(ims[img_rows]), dev(ids[txt_rows]), dev(mask[txt_rows]))
            return lg[:, 1].cpu().numpy()

        return runner.evaluate(_task("retrieval", sim_fn, itm_match, min(8, n)), {})

    if args.task == "vqa":
        answers = [f"answer {i}" for i in range(16)] + ["yes", "no"]
        a_ids, a_mask = tok(answers, max_length=6, add_eos=False)
        bos = np.full((len(answers), 1), 2, np.int64)  # the shared decoder bos
        a_ids = np.concatenate([bos, a_ids], 1)
        a_mask = np.concatenate([np.ones_like(bos), a_mask], 1)

        def predict_fn(batch):
            ids, mask = tok(batch["text_input"], max_length=12)
            idx = model.rank_answers(dev(batch["image"]), dev(ids), dev(mask), dev(a_ids),
                                     dev(a_mask), k=8)
            return [answers[i] for i in idx.cpu().tolist()]

        batches = [{"image": images(), "text_input": [f"question {i}" for i in range(n)],
                    "gt_answers": [["yes"] * 10 for _ in range(n)]}
                   for _ in range(args.eval_batches)]
        return runner.evaluate(_task("vqa", predict_fn), batches)

    if args.task == "nlvr":
        @torch.inference_mode()
        def predict_fn(batch):
            ids, mask = tok(batch["text_input"], max_length=12)
            return model.nlvr_forward({"image0": dev(batch["image0"]),
                                       "image1": dev(batch["image1"]),
                                       "text_ids": dev(ids), "text_mask": dev(mask)})

        batches = [{"image0": images(), "image1": images(),
                    "text_input": [f"statement {i}" for i in range(n)],
                    "label": rng.integers(0, 2, size=(n,))}
                   for _ in range(args.eval_batches)]
        return runner.evaluate(_task("multimodal_classification", predict_fn), batches)

    gen = GenerateConfig(max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
                         min_length=5, length_penalty=args.length_penalty)
    prompt = np.asarray(tok(["a picture of"], max_length=8, add_eos=False, pad=False)[0],
                        np.int64)  # unpadded: every row shares it

    def gen_fn(batch):
        ids = np.repeat(prompt, len(batch["image"]), axis=0)
        return _decode_all(tok, model.generate(dev(batch["image"]), dev(ids), gen))

    batches = [{"image": images(), "image_id": list(range(i * n, (i + 1) * n)),
                "gt_captions": [["a picture"] for _ in range(n)]}
               for i in range(args.eval_batches)]
    return runner.evaluate(_task("captioning", gen_fn), batches)


def mmlu_logits_fn(model, tok, device, max_length: int = 64):
    """prompts -> (B, vocab) float32 first-token logits of the T5 ``model``,
    prompts tokenized by ``tok`` and cut at ``max_length`` tokens
    (evaluate.py:560-571). The columns that are padding in every row are
    dropped: the encoder masks them, so the logits are those of the
    ``max_length`` batch, at the cost of the longest prompt."""
    @torch.inference_mode()
    def first_token_logits(prompts):
        ids, mask = tok(prompts, max_length=max_length)
        n = max(int(mask.sum(1).max()), 1)
        return model.first_token_logits(torch.from_numpy(ids[:, :n]).to(device),
                                        torch.from_numpy(mask[:, :n]).to(device))

    return first_token_logits


def zero_shot_predict_fn(model, classifier, device):
    """batch -> (B, C) float32 zero-shot logits of ``batch["image"]``."""
    w = next(model.parameters())

    @torch.inference_mode()
    def predict(batch):
        return model.predict(torch.from_numpy(batch["image"]).to(device, w.dtype),
                             classifier)

    return predict


def _real_eval(args, device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """File-driven evaluation: LAVIS-style annotations through the dataset
    builders, the BLIP image transform, beam search (evaluate.py:588-645)."""
    from ecoflap_tpu_torch.core.registry import registry
    from ecoflap_tpu_torch.data import datasets
    from ecoflap_tpu_torch.data.calibration import load_t5_tokenizer
    from ecoflap_tpu_torch.data.processors import ImageEvalProcessor
    from ecoflap_tpu_torch.parallel.dist import is_main_process
    from ecoflap_tpu_torch.runners.runner import Runner

    runner = Runner(args.output_dir, f"eval_{args.model}_{args.task}",
                    write=is_main_process())
    if args.model in ("clip", "eva_clip") and args.task == "classification":
        return runner.evaluate(*_zero_shot_setup(args, device, dtype))
    if args.model in ("deit", "convnext") and args.task == "classification":
        # top-1 on an image folder (evaluate.py:703-720)
        model = _classifier_model(args, device, dtype)
        ds = registry.get("builder", "imagenet")(
            {"vis_root": args.vis_root},
            vis_processor=ImageEvalProcessor(image_size=model.cfg.img_size))
        return runner.evaluate(_task("multimodal_classification",
                                          classifier_predict_fn(model, device)),
                               list(datasets.batch_iterator(ds, args.batch_size,
                                                            drop_last=True)))
    if not (args.model == "blip2_t5" and args.task in ("vqa", "gqa", "captioning")):
        raise _not_ported(args, "real-data")
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    cfg = blip2.config_for_scale(args.model_scale, args.vocab_size)
    # a .pth loads in bf16, as the JAX CLI converts it
    model = _model(blip2, cfg, args, device,
                   torch.bfloat16 if args.checkpoint else dtype)
    tok = load_t5_tokenizer(vocab_size=cfg.t5.vocab_size, path=args.tokenizer_path)
    gen = GenerateConfig(max_new_tokens=args.max_new_tokens, num_beams=args.num_beams,
                         length_penalty=args.length_penalty)

    def generate(batch, texts, max_length):
        ids, mask = tok(texts, max_length=max_length)
        out = model.generate(torch.from_numpy(batch["image"]).to(device),
                             torch.from_numpy(ids).to(device),
                             torch.from_numpy(mask).to(device), gen)
        return _decode_all(tok, out)

    name = {"vqa": "coco_vqa", "gqa": "gqa", "captioning": "coco_caption"}[args.task]
    ds = registry.get("builder", name)(
        {"vis_root": args.vis_root, "ann_paths": [args.ann]},
        vis_processor=ImageEvalProcessor(image_size=cfg.vit.img_size))
    batches = list(datasets.batch_iterator(ds, args.batch_size, drop_last=True))
    if args.task == "captioning":
        task = _task(args.task, lambda b: generate(b, [""] * len(b["image"]), 4))
    else:
        prompt = "Question: {} Short answer:"
        task = _task(args.task, lambda b: generate(
            b, [prompt.format(q) for q in b["text_input"]], 32))
    return runner.evaluate(task, batches)


def _zero_shot_setup(args, device, dtype):
    """(task, batches) of CLIP or EVA-CLIP zero-shot classification on an
    image folder (evaluate.py:653-701): the ``--dataset`` builder, the
    classifier from ``--prompt_templates`` in hash tokens, batches of
    ``--batch_size`` without the last partial one."""
    from ecoflap_tpu_torch.core.registry import registry
    from ecoflap_tpu_torch.data import datasets
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.data.processors import ImageEvalProcessor
    from ecoflap_tpu_torch.data.prompts import TEMPLATE_SETS, build_prompts
    from ecoflap_tpu_torch.models import clip

    cfg = clip.config_for_scale(args.model_scale, args.model == "eva_clip")
    model = _model(clip, cfg, args, device, dtype)
    ds = registry.get("builder", args.dataset)(
        {"vis_root": args.vis_root},
        vis_processor=ImageEvalProcessor(image_size=cfg.img_size))
    if args.prompt_templates == "coop":
        from ecoflap_tpu_torch.data.coop import coop_prompts

        prompts = coop_prompts(args.dataset, ds.classnames)
    else:
        prompts = build_prompts(ds.classnames, TEMPLATE_SETS[args.prompt_templates])
    ids, _ = HashTokenizer(vocab_size=cfg.text.vocab_size)(
        prompts, max_length=cfg.text.context_length)
    classifier = model.zero_shot_classifier(torch.from_numpy(ids).to(device),
                                            len(ds.classnames))
    task = _task("multimodal_classification",
                      zero_shot_predict_fn(model, classifier, device))
    return task, list(datasets.batch_iterator(ds, args.batch_size, drop_last=True))


def main(argv=None) -> Dict[str, Any]:
    """Evaluate, print the metrics as one JSON line and return them."""
    from ecoflap_tpu_torch.core.device import (exact_float32_matmuls, resolve_device,
                                               weight_dtype)
    from ecoflap_tpu_torch.core.project import apply_cfg_path
    from ecoflap_tpu_torch.parallel.dist import (destroy, init_distributed_mode,
                                                 is_dist_avail_and_initialized,
                                                 is_main_process, same_on_every_rank)
    from ecoflap_tpu_torch.parallel.mesh import mesh_from_flag, parse_mesh_spec, use_mesh

    parser = build_parser()
    args = parser.parse_args(argv)
    apply_cfg_path(args, sys.argv[1:] if argv is None else argv)
    if not args.model or not args.task:
        parser.error("--model and --task are required (directly or through --cfg-path)")
    device = resolve_device(args.device)
    if args.mesh != "none":  # a bad spec raises before any start-up
        parse_mesh_spec(args.mesh)
    # the process group of a torchrun launch, as the JAX CLI starts its own
    owned = not is_dist_avail_and_initialized() and init_distributed_mode(device)
    try:
        # TF32 off: float32 runs compute what the JAX package computes
        exact_float32_matmuls()
        # a random init's dtype; a .pth loads in bf16
        dtype = weight_dtype(args.dtype, args.model_scale)
        with use_mesh(mesh_from_flag(args.mesh, device)):
            if args.synthetic or not (args.ann or args.vis_root):
                metrics = _synthetic_eval(args, device, dtype)
            else:
                metrics = _real_eval(args, device, dtype)
        metrics = same_on_every_rank(metrics)
        if is_main_process():
            print(json.dumps(metrics))
        return metrics
    finally:
        if owned:
            destroy()


if __name__ == "__main__":
    main()
