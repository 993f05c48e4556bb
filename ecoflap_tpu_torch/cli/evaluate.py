"""Evaluation CLI for BLIP-2 FlanT5 and LLaMA (port of the blip2_t5 and llama
branches of ``ecoflap_tpu/cli/evaluate.py``; reference evaluate_blip.py:
345-491 and LLaMA/main.py:89-90). The JAX CLI's flags, so a pruned ``.pth``
from ``ecoflap_tpu_torch.cli.prune --save_pruned_model`` evaluates as

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

A ``.pth`` loads in bf16 whatever ``--dtype`` says, as the JAX CLI converts
it (evaluate.py:604-607). Runs on the card unless ``--device cpu``; the
result is one JSON line. Other model/task pairs are not ported yet
(ROADMAP.md, section 1).
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import numpy as np
import torch


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ECoFLaP evaluation (PyTorch/CUDA)",
                                allow_abbrev=False)
    p.add_argument("--model", required=True,
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
    p.add_argument("--task", required=True,
                   choices=["vqa", "gqa", "captioning", "classification", "retrieval",
                            "nlvr", "mmlu", "wikitext_ppl"])
    p.add_argument("--tokenizer_path", default=None,
                   help="local tokenizer.json (real subword vocab)")
    p.add_argument("--checkpoint", default=None, help="a reference-named torch .pth")
    p.add_argument("--ann", default=None, help="annotation json")
    p.add_argument("--vis_root", default="")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--batch_size", type=int, default=8)
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


def _decode_all(tok, out: torch.Tensor):
    return [tok.decode(row) for row in out.cpu().tolist()]


def _not_ported(args, where: str):
    return NotImplementedError(
        f"{args.model}/{args.task} {where} evaluation is not ported to "
        "ecoflap_tpu_torch yet (ROADMAP.md, section 1)")


def _synthetic_eval(args, device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """The JAX CLI's smoke evaluation on random data (evaluate.py:206-265)."""
    from ecoflap_tpu_torch.data.calibration import HashTokenizer
    from ecoflap_tpu_torch.runners.runner import Runner
    from ecoflap_tpu_torch.tasks import setup_task

    rng = np.random.default_rng(args.seed)
    runner = Runner(args.output_dir, f"eval_{args.model}_{args.task}")

    if args.model == "llama" and args.task == "wikitext_ppl":
        from ecoflap_tpu_torch.models import llama

        cfg = llama.config_for_scale(args.model_scale)
        model = llama.build_model(cfg, device=device, dtype=dtype, seed=args.seed)
        stream = rng.integers(2, cfg.vocab_size, size=(64 * 32,))
        seqlen = args.seqlen if args.model_scale != "tiny" else 32
        task = setup_task(args.task, lambda s: llama.perplexity(
            model, torch.from_numpy(s).to(device), seqlen=seqlen,
            batch_size=args.batch_size))
        return runner.evaluate(task, stream)

    if args.model == "blip2_t5" and args.task in ("vqa", "gqa", "captioning"):
        from ecoflap_tpu_torch.models import blip2
        from ecoflap_tpu_torch.models.generation import GenerateConfig

        cfg = blip2.config_for_scale(args.model_scale, args.vocab_size)
        model = blip2.build_model(cfg, device=device, dtype=dtype, seed=args.seed)
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
        metrics = runner.evaluate(setup_task("vqa", predict_fn), batches)
        # the first batch carries the warm-up; the rest are the steady rate
        metrics["batch_walls_s"] = [round(w, 2) for w in batch_walls]
        if len(batch_walls) >= 3:
            steady = batch_walls[1:]
            metrics["steady_qps"] = round(args.batch_size * len(steady) / sum(steady), 3)
        return metrics

    raise _not_ported(args, "synthetic")


def _real_eval(args, device: torch.device, dtype: torch.dtype) -> Dict[str, Any]:
    """File-driven evaluation: LAVIS-style annotations through the dataset
    builders, the BLIP image transform, beam search (evaluate.py:588-645)."""
    from ecoflap_tpu_torch.core.registry import registry
    from ecoflap_tpu_torch.data import datasets
    from ecoflap_tpu_torch.data.calibration import load_t5_tokenizer
    from ecoflap_tpu_torch.data.processors import ImageEvalProcessor
    from ecoflap_tpu_torch.runners.runner import Runner
    from ecoflap_tpu_torch.tasks import setup_task

    if not (args.model == "blip2_t5" and args.task in ("vqa", "gqa", "captioning")):
        raise _not_ported(args, "real-data")
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models.generation import GenerateConfig
    from ecoflap_tpu_torch.utils.checkpoint import load_into, load_torch_checkpoint

    runner = Runner(args.output_dir, f"eval_{args.model}_{args.task}")
    cfg = blip2.config_for_scale(args.model_scale, args.vocab_size)
    if args.checkpoint:
        if not args.checkpoint.endswith(".pth"):
            raise ValueError(f"--checkpoint {args.checkpoint!r}: the port reads a "
                             "torch .pth (orbax directories are the JAX package's)")
        model = blip2.build_model(cfg, device=device, dtype=torch.bfloat16, seed=None)
        load_into(model, load_torch_checkpoint(args.checkpoint))
    else:
        model = blip2.build_model(cfg, device=device, dtype=dtype, seed=args.seed)
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
        task = setup_task(args.task, lambda b: generate(b, [""] * len(b["image"]), 4))
    else:
        prompt = "Question: {} Short answer:"
        task = setup_task(args.task, lambda b: generate(
            b, [prompt.format(q) for q in b["text_input"]], 32))
    return runner.evaluate(task, batches)


def main(argv=None) -> Dict[str, Any]:
    """Evaluate, print the metrics as one JSON line and return them."""
    from ecoflap_tpu_torch.core.device import (exact_float32_matmuls, resolve_device,
                                               weight_dtype)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    # TF32 off: float32 runs compute what the JAX package computes
    exact_float32_matmuls()
    # a random init's dtype; a .pth loads in bf16
    dtype = weight_dtype(args.dtype, args.model_scale)
    if args.synthetic or not (args.ann or args.vis_root):
        metrics = _synthetic_eval(args, device, dtype)
    else:
        metrics = _real_eval(args, device, dtype)
    print(json.dumps(metrics))
    return metrics


if __name__ == "__main__":
    main()
