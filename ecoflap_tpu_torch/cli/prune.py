"""Prune CLI for BLIP-2 FlanT5, LLaMA, standalone FlanT5, CLIP, EVA-CLIP,
the image classifiers DeiT and ConvNeXt (port of ``ecoflap_tpu/cli/prune.py``,
every ``--model`` of it) and LFM2-MoE, which the port alone has. The
reference flag names, so ``scripts/blip2/ecoflap_zeroth.py``'s and
``scripts/llama/ecoflap_zero.sh``'s arguments carry over:

  python -m ecoflap_tpu_torch.cli.prune --model blip2_t5 --model_scale full \\
      --pruning_method blipt5_wanda_pruner \\
      --vit_prune_spec 39-0.5-1.0-1.0 --t5_prune_spec 24-0.5-1.0-1.0 \\
      --sparsity_ratio_granularity block --score_method MEZO-GradOnly_sum \\
      --max_sparsity_per_layer 0.6 --num_data_first_stage 128 \\
      --num_samples 128 --batch_size 8

  python -m ecoflap_tpu_torch.cli.prune --model llama --model_scale full \\
      --pruning_method llama_wanda_pruner --prune_spec 32-0.4-1.0-1.0 \\
      --sparsity_ratio_granularity block --score_method MEZO-GradOnly_sum \\
      --max_sparsity_per_layer 0.7 --num_data_first_stage 32 \\
      --num_samples 128 --batch_size 8 --seqlen 2048

and the first-order coarse stage in place of MeZO, LLaMA-7B with the
reference ``LLaMA/main.py --score_method GradOnly`` (no ``--use_mezo``) and
BLIP-2 with ``scripts/blip2/ecoflap_first.py``'s flags:

  python -m ecoflap_tpu_torch.cli.prune --model llama --model_scale full \\
      --pruning_method llama_wanda_pruner --prune_spec 32-0.4-1.0-1.0 \\
      --sparsity_ratio_granularity block --score_method GradOnly_sum \\
      --max_sparsity_per_layer 0.7 --num_data_first_stage 32 \\
      --num_samples 128 --batch_size 8 --seqlen 2048

  python -m ecoflap_tpu_torch.cli.prune --model blip2_t5 --model_scale full \\
      --pruning_method blipt5_wanda_pruner \\
      --vit_prune_spec 39-0.5-1.0-1.0 --t5_prune_spec 24-0.5-1.0-1.0 \\
      --sparsity_ratio_granularity block --score_method GradMagAbs_sum \\
      --max_sparsity_per_layer 0.6 --num_data_first_stage 128 \\
      --num_samples 128 --batch_size 8

SparseGPT as the local method, from the sparsity dict of an earlier
zeroth-order run (``scripts/blip2/ecoflap_sparsegpt_zeroth.py``):

  python -m ecoflap_tpu_torch.cli.prune --model blip2_t5 --model_scale full \\
      --pruning_method blipt5_sparsegpt_pruner \\
      --vit_prune_spec 39-0.5-1.0-1.0 --t5_prune_spec 24-0.5-1.0-1.0 \\
      --num_samples 128 --batch_size 8 \\
      --sparsity_dict output/sparsity_dict/<job>.yaml

The global-mask baselines, ``scripts/blip2/mag.py`` and
``scripts/blip2/iterative_global_gradient.py`` (``--is_global``: every
target pruned by one threshold, 3 iterations; ``--save_pruned_model``
writes ``pruned_checkpoint/<job>.pth``):

  python -m ecoflap_tpu_torch.cli.prune --model blip2_t5 --model_scale full \\
      --pruning_method blipt5_global_mag_pruner --prune_spec 24-0.5-1.0-1.0 \\
      --is_global --iteration 3 --num_samples 128 --batch_size 8 \\
      --save_pruned_model

(``blipt5_global_gradmagabs_pruner`` for |W| |G|). ``--coarse_only`` writes
the coarse stage's sparsity dict and stops; ``--ckpt`` starts from a
reference-named ``.pth`` instead of the random init.

A project YAML under ``configs/projects/`` gives a run in one file
(``--cfg-path``; ``--options`` overrides its keys, explicit flags override
both): ``scripts/t5/ecoflap.py``, ``scripts/eva_clip/ecoflap.py`` and the
CoOp launcher's CLIP prune are

  python -m ecoflap_tpu_torch.cli.prune --cfg-path t5/c4_prefix_derivative_compute.yaml
  python -m ecoflap_tpu_torch.cli.prune --cfg-path eva_clip/ecoflap.yaml \
      --options prune.num_data_first_stage=16
  python -m ecoflap_tpu_torch.cli.prune --model clip --model_scale full \
      --pruning_method clip_wanda_pruner --prune_spec 12-0.6-1.0-1.0 \
      --sparsity_ratio_granularity block --score_method MEZO-GradOnly_sum \
      --max_sparsity_per_layer 0.5 --num_samples 64 --batch_size 16 \
      --num_data_first_stage 64 --save_pruned_model

LFM2-8B-A1B (sparse experts, short convolutions and GQA) takes the LLaMA
first-order recipe's flags at its 24 layers, on synthetic windows:

  python -m ecoflap_tpu_torch.cli.prune --model lfm2_moe --model_scale full \
      --pruning_method lfm2_wanda_pruner --prune_spec 24-0.4-1.0-1.0 \
      --sparsity_ratio_granularity block --score_method GradOnly_sum \
      --max_sparsity_per_layer 0.7 --num_data_first_stage 32 \
      --num_samples 128 --batch_size 8 --seqlen 2048

The image classifiers take ``scripts/llama/image_classifiers.sh``'s flags
(``--ckpt`` a timm DeiT or an FB ConvNeXt ``.pth``; ``--calib <image folder>``
calibrates on the folder's images and labels):

  python -m ecoflap_tpu_torch.cli.prune --model deit --model_scale full \
      --pruning_method deit_wanda_pruner --prune_spec 12-0.5-1.0-1.0 \
      --num_samples 128 --batch_size 16
  python -m ecoflap_tpu_torch.cli.prune --model convnext --model_scale full \
      --pruning_method convnext_wanda_pruner --prune_spec 0-0.5-1.0-1.0 \
      --num_samples 128 --batch_size 16

(CLIP and EVA-CLIP calibrate on random images and text ids, or with
``--calib <image folder> --dataset <CoOp name>`` on the folder's images and
their class's CoOp prompt; the EVA-CLIP ``.pth`` holds the visual tower
without its last block, as the reference exports it). BLIP-2 calibrates on
files with ``--calib <LAVIS caption annotations> --vis_root <image root>``,
LLaMA with ``--calib <C4-style jsonl>`` (``--tokenizer_path`` for a real
vocabulary); standalone T5 refuses ``--calib``, which the JAX CLI ignores.

The MeZO coarse stage scores BLIP-2's targets a block at a time by the lane
ensemble and LLaMA's by the serial in-place cycle; standalone T5 and CLIP
and the classifiers have no suffix plans, so every target goes the serial
way.
``--mezo_ensemble 1`` or ``0`` sends every planned model one way.

``--mesh dp=N,tp=M`` runs the whole pipeline over N x M ranks started by
``torchrun`` (``python -m torch.distributed.run --nproc-per-node N*M -m
ecoflap_tpu_torch.cli.prune ... --mesh dp=N,tp=M``; NCCL on the card, gloo
with ``--device cpu``): the weights the tp rules match are split over tp,
each dp rank calibrates on its slice of every microbatch, and rank 0 alone
writes the sparsity dict, the statistics, the ``.pth`` (from the gathered
weights) and the result line. ``--stacks a,b`` prunes only the named stacks
(the others keep their weights; the coarse stage still scores every
target, as in the JAX CLI).

Runs on the card unless ``--device cpu``. Without ``--ckpt`` the model is
randomly initialised from ``--seed`` at ``--model_scale``; calibration is
synthetic unless said above (the JAX CLI's draws for one seed: LLaMA's token
stream, T5's random words, CLIP's images and ids).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Any, Dict

import numpy as np
import torch

# the JAX CLI's --model choices, every one ported, and LFM2-MoE
MODELS = ("blip2_t5", "t5", "eva_clip", "clip", "llama", "deit", "convnext", "lfm2_moe")


def build_parser() -> argparse.ArgumentParser:
    # allow_abbrev=False: --cfg-path's precedence reads the typed flags
    p = argparse.ArgumentParser(description="ECoFLaP pruning (PyTorch/CUDA)",
                                allow_abbrev=False)
    p.add_argument("--cfg-path", dest="cfg_path", default=None,
                   help="project YAML (bare names resolve under "
                        "configs/projects/): model/run trees and a prune: tree "
                        "of the flags below; explicit flags override the file")
    p.add_argument("--options", nargs="*", default=None,
                   help="dot-list overrides of the YAML, e.g. "
                        "prune.num_data_first_stage=8")
    p.add_argument("--model", default=None, choices=MODELS)
    p.add_argument("--model_scale", default="tiny",
                   choices=["tiny", "small", "full"],
                   help="tiny = test shapes; small = the mid-scale presets; full "
                        "= EVA ViT-g + FlanT5-XL, LLaMA-7B, FlanT5-XL, CLIP "
                        "ViT-B/16, EVA-CLIP-g, DeiT-B, ConvNeXt-T or LFM2-8B-A1B")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="weight dtype; auto = bf16 for small/full, f32 for tiny")
    p.add_argument("--ckpt", default=None,
                   help="a reference-named torch .pth to load instead of the "
                        "random init")
    p.add_argument("--pruning_method", default="blipt5_wanda_pruner")
    p.add_argument("--t5_prune_spec", default=None)
    p.add_argument("--vit_prune_spec", default=None)
    p.add_argument("--prune_spec", default=None,
                   help="llama: the spec of model.layers; blip2_t5: the T5 "
                        "stacks' unless --t5_prune_spec, and every stack's "
                        "without a spec of its own; t5, clip, eva_clip, deit, "
                        "convnext: every stack's")
    p.add_argument("--seqlen", type=int, default=2048,
                   help="llama and lfm2_moe calibration window (32 at "
                        "--model_scale tiny)")
    p.add_argument("--sparsity_ratio_granularity", default=None,
                   choices=[None, "layer", "block", "model"])
    p.add_argument("--prune_per_model", action="store_true",
                   help="allocate the budget within each submodel")
    p.add_argument("--max_sparsity_per_layer", type=float, default=0.8)
    p.add_argument("--score_method", default="MEZO-GradOnly_sum")
    p.add_argument("--num_data_first_stage", type=int, default=128)
    p.add_argument("--num_noise", type=int, default=1)
    p.add_argument("--noise_eps", type=float, default=1e-3)
    p.add_argument("--noise_mode", default="per_batch",
                   choices=["per_batch", "shared"],
                   help="MeZO sampling: per_batch = a fresh z per microbatch "
                        "(the reference's); shared = one z across all "
                        "microbatches (documented deviation, PARITY.md)")
    p.add_argument("--mezo_ensemble", type=int, default=None, choices=[0, 1],
                   help="1: score a block's targets together by the lane "
                        "ensemble (out-of-place perturbation kernel); 0: the "
                        "serial in-place cycle (in-place kernel); default: "
                        "the model's choice (BLIP-2 1, LLaMA 0)")
    p.add_argument("--sparsity_dict", default=None,
                   help="a saved sparsity-dict YAML: skip the coarse stage")
    p.add_argument("--sparsity_type", default="unstructured",
                   help="unstructured | N:M (e.g. 2:4)")
    p.add_argument("--hessian_bf16", action="store_true",
                   help="SparseGPT: round each summed Gram matrix once to bf16")
    p.add_argument("--is_global", action="store_true",
                   help="global-mask baseline pruners: their own configuration")
    p.add_argument("--iteration", type=int, default=1)
    p.add_argument("--coarse_only", action="store_true",
                   help="write the coarse stage's sparsity dict and stop")
    p.add_argument("--calib", default="synthetic",
                   help="synthetic; blip2_t5: LAVIS caption annotations (json, "
                        "images under --vis_root); llama: a C4-style jsonl of "
                        '{"text": ...} lines; clip/eva_clip/deit/convnext: an '
                        "image-folder root (class subdirectories)")
    p.add_argument("--vis_root", default="",
                   help="image root for blip2_t5 --calib annotations")
    p.add_argument("--tokenizer_path", default=None,
                   help="local tokenizer.json for the --calib text (without it "
                        "hash tokens, loudly)")
    p.add_argument("--dataset", default="imagenet",
                   help="clip/eva_clip --calib: the folder's builder and CoOp "
                        "prompt template (any of the 11 CoOp dataset names)")
    p.add_argument("--num_samples", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--output_dir", default="output")
    p.add_argument("--job_id", default=None)
    p.add_argument("--save_pruned_model", action="store_true",
                   help="write the pruned model, float32 under the reference "
                        "names, to pruned_checkpoint/<job>.pth")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--stacks", default=None,
                   help="comma-separated stack names to prune (others skip)")
    p.add_argument("--mesh", default=None,
                   help="run the whole pipeline over a (dp, tp) mesh of torchrun "
                        "ranks, e.g. 'dp=4' or 'dp=2,tp=2' ('dp': every rank on "
                        "dp); dp*tp must be the world size")
    return p


def _load_ckpt(model, path: str) -> None:
    from ecoflap_tpu_torch.utils.checkpoint import load_into, load_torch_checkpoint

    ignored = load_into(model, load_torch_checkpoint(path))
    print(f"--ckpt {path}: loaded {len(model.state_dict())} tensors, "
          f"ignored {ignored} keys the model does not have")


def _synthetic_only(args) -> None:
    if args.calib != "synthetic":
        raise NotImplementedError(
            f"--calib {args.calib!r}: {args.model} calibrates on synthetic data only "
            "in ecoflap_tpu_torch (the JAX CLI ignores it; ROADMAP.md, section 3)")


def _caption_samples(args, img_size: int):
    """--calib caption annotations through the ``coco_caption`` builder and
    the eval transform, each sample's first caption, cycled to
    ``--num_samples`` (cli/prune.py:223-246; the reference's count-limited
    loader, runner_base.py:645-693)."""
    from ecoflap_tpu_torch.core.registry import registry
    from ecoflap_tpu_torch.data import datasets  # noqa: F401 (registers builders)
    from ecoflap_tpu_torch.data.processors import ImageEvalProcessor

    ds = registry.get("builder", "coco_caption")(
        {"vis_root": args.vis_root, "ann_paths": [args.calib]},
        vis_processor=ImageEvalProcessor(image_size=img_size))
    samples = []
    for i in range(min(len(ds), args.num_samples)):
        item = ds[i]
        caps = item.get("gt_captions") or [item.get("text_input", "")]
        samples.append({"image": item["image"],
                        "caption": caps[0] if isinstance(caps, list) else caps})
    while len(samples) < args.num_samples:
        samples.append(samples[len(samples) % max(len(ds), 1)])
    return samples


def _jsonl_stream(args, vocab_size: int, seqlen: int) -> np.ndarray:
    """--calib C4-style jsonl: each document tokenized with EOS, all joined
    into one stream (cli/prune.py:475-497; wanda lib/data.py get_c4). A
    stream too short for ``--num_samples`` windows ends the run."""
    from ecoflap_tpu_torch.core.registry import registry
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.data import datasets  # noqa: F401 (registers builders)

    tok = cal.load_t5_tokenizer(vocab_size=vocab_size, path=args.tokenizer_path)
    ds = registry.get("builder", "c4")({"jsonl_path": args.calib})
    pieces = [np.asarray(tok([t], max_length=10 ** 9, add_eos=True, pad=False)[0][0],
                         np.int64) for t in ds.texts]
    stream = np.concatenate(pieces)
    need = args.num_samples * seqlen + seqlen
    if stream.shape[0] < need:
        raise SystemExit(
            f"--calib {args.calib}: {stream.shape[0]} tokens after "
            f"tokenization, need >= {need} for {args.num_samples} "
            f"windows of {seqlen}")
    return stream


def _blip2(args, device, dtype):
    """(adapter, batch, microbatches, stack specs)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import blip2

    cfg = blip2.config_for_scale(args.model_scale)
    model = blip2.build_model(cfg, device=device, dtype=dtype,
                              seed=None if args.ckpt else args.seed)
    if args.ckpt:
        _load_ckpt(model, args.ckpt)
    spec = cal.CalibrationSpec(args.num_samples, args.batch_size)
    if args.calib != "synthetic":
        samples = _caption_samples(args, cfg.vit.img_size)
        tok = cal.load_t5_tokenizer(vocab_size=cfg.t5.vocab_size,
                                    path=args.tokenizer_path)
    else:
        samples = cal.synthetic_vl_samples(args.num_samples, cfg.vit.img_size,
                                           args.seed)
        tok = cal.HashTokenizer(vocab_size=cfg.t5.vocab_size)
    batch = cal.build_vl_calibration_batch(samples, tok, spec, args.seed)
    if args.model_scale == "tiny":  # a file tokenizer's ids into the tiny vocab
        v = cfg.t5.vocab_size
        batch = {**batch, "text_input_ids": batch["text_input_ids"] % v,
                 "labels": torch.where(batch["labels"] == -100, -100, batch["labels"] % v)}
    stack_specs = {}
    if args.vit_prune_spec:
        stack_specs["visual_encoder.blocks"] = args.vit_prune_spec
    t5_spec = args.t5_prune_spec or args.prune_spec
    if t5_spec:
        stack_specs["t5_model.encoder.block"] = t5_spec
        stack_specs["t5_model.decoder.block"] = t5_spec
    return blip2.make_adapter(model), batch, spec.num_microbatches, stack_specs


def _llama(args, device, dtype):
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import llama

    cfg = llama.config_for_scale(args.model_scale)
    seqlen = args.seqlen if args.model_scale in ("full", "small") else 32
    model = llama.build_model(cfg, device=device, dtype=dtype,
                              seed=None if args.ckpt else args.seed)
    if args.ckpt:
        _load_ckpt(model, args.ckpt)
    if args.calib != "synthetic":
        stream = _jsonl_stream(args, cfg.vocab_size, seqlen)
    else:
        stream = cal.synthetic_token_stream(args.num_samples, seqlen, cfg.vocab_size,
                                            args.seed)
    batch = cal.build_lm_calibration_batch(stream, args.num_samples, seqlen,
                                           args.seed)
    stack_specs = {"model.layers": args.prune_spec} if args.prune_spec else {}
    return (llama.make_adapter(model), batch,
            max(1, args.num_samples // args.batch_size), stack_specs)


def _lfm2(args, device, dtype):
    """LFM2-MoE on the LLaMA branch's synthetic windows (``--model_scale full``
    LFM2-8B-A1B at ``--seqlen``, ``tiny`` the test shapes at 32)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import lfm2_moe

    _synthetic_only(args)
    cfg = lfm2_moe.config_for_scale(args.model_scale)
    seqlen = args.seqlen if args.model_scale == "full" else 32
    model = lfm2_moe.build_model(cfg, device=device, dtype=dtype,
                                 seed=None if args.ckpt else args.seed)
    if args.ckpt:
        _load_ckpt(model, args.ckpt)
    stream = cal.synthetic_token_stream(args.num_samples, seqlen, cfg.vocab_size, args.seed)
    batch = cal.build_lm_calibration_batch(stream, args.num_samples, seqlen, args.seed)
    stack_specs = {"model.layers": args.prune_spec} if args.prune_spec else {}
    return (lfm2_moe.make_adapter(model), batch,
            max(1, args.num_samples // args.batch_size), stack_specs)


def _t5(args, device, dtype):
    """Standalone FlanT5 on the C4-style prefix-LM batch of the JAX CLI's
    random words (cli/prune.py:265-297)."""
    from ecoflap_tpu_torch.data import calibration as cal
    from ecoflap_tpu_torch.models import t5

    _synthetic_only(args)
    cfg = t5.config_for_scale(args.model_scale)
    model = t5.build_model(cfg, device=device, dtype=dtype,
                           seed=None if args.ckpt else args.seed)
    if args.ckpt:
        _load_ckpt(model, args.ckpt)
    spec = cal.CalibrationSpec(args.num_samples, args.batch_size)
    texts = [" ".join(np.random.default_rng(args.seed + i)
                      .choice(["the", "a", "dog", "cat", "run"], 20))
             for i in range(args.num_samples)]
    batch = cal.build_text_calibration_batch(
        texts, cal.HashTokenizer(vocab_size=cfg.vocab_size), spec, args.seed)
    stack_specs = {}
    if args.prune_spec:
        stack_specs = {"encoder.block": args.prune_spec,
                       "decoder.block": args.prune_spec}
    return t5.make_adapter(model), batch, spec.num_microbatches, stack_specs


def _clip(args, device, dtype):
    """CLIP ViT-B/16 or EVA-CLIP-g on the contrastive loss
    (cli/prune.py:299-370): random images, text ids ending in the last id and
    labels of 10 classes, or an image folder with its CoOp prompts
    (trainers/zsclip.py:72-90). EVA-CLIP prunes its visual tower only."""
    from ecoflap_tpu_torch.models import clip

    eva = args.model == "eva_clip"
    cfg = clip.config_for_scale(args.model_scale, eva)
    model = clip.build_model(cfg, device=device, dtype=dtype,
                             seed=None if args.ckpt else args.seed)
    if args.ckpt:
        _load_ckpt(model, args.ckpt)
    n, img, ctx = args.num_samples, cfg.img_size, cfg.text.context_length
    if args.calib != "synthetic":
        from ecoflap_tpu_torch.core.registry import registry
        from ecoflap_tpu_torch.data import datasets  # noqa: F401 (registers builders)
        from ecoflap_tpu_torch.data.calibration import HashTokenizer
        from ecoflap_tpu_torch.data.coop import COOP_TEMPLATES, coop_prompts
        from ecoflap_tpu_torch.data.processors import ImageEvalProcessor

        folder = registry.get("builder", args.dataset)(
            {"vis_root": args.calib}, vis_processor=ImageEvalProcessor(image_size=img))
        items = [folder[i % len(folder)] for i in range(n)]
        labels = [it["label"] for it in items]
        per_class = coop_prompts(args.dataset if args.dataset in COOP_TEMPLATES
                                 else "imagenet", folder.classnames)
        ids, _ = HashTokenizer(vocab_size=cfg.text.vocab_size)(
            [per_class[lab] for lab in labels], max_length=ctx)
        images = np.stack([it["image"] for it in items])
    else:
        rng = np.random.default_rng(args.seed)
        ids = rng.integers(1, cfg.text.vocab_size, size=(n, ctx))
        ids[:, -1] = cfg.text.vocab_size - 1
        images = rng.normal(size=(n, img, img, 3))
        labels = rng.integers(0, 10, size=(n,))
    batch = {"image": torch.from_numpy(np.asarray(images)).to(dtype),
             "text_ids": torch.from_numpy(np.asarray(ids, np.int64)),
             "label": torch.from_numpy(np.asarray(labels, np.int64))}
    adapter = clip.make_adapter(model, include_text=not eva)
    stack_specs = ({s.name: args.prune_spec for s in adapter.stacks}
                   if args.prune_spec else {})
    return adapter, batch, max(1, n // args.batch_size), stack_specs


def _classifier(args, device, dtype):
    """DeiT or ConvNeXt on the CE loss (cli/prune.py:375-417; reference
    LLaMA/image_classifiers main.py): random images and labels from
    ``--seed``, or an image folder (``--calib``, the ``imagenet`` builder and
    the eval transform, cycled to ``--num_samples``, labels modulo the
    classes). ``--ckpt`` is a timm DeiT or an FB ConvNeXt ``.pth``."""
    from ecoflap_tpu_torch.models import classifiers

    cfg = classifiers.build(args.model, args.model_scale)
    model = classifiers.build_model(cfg, device=device, dtype=dtype,
                                    seed=None if args.ckpt else args.seed)
    if args.ckpt:
        _load_ckpt(model, args.ckpt)
    n, img, ncls = args.num_samples, cfg.img_size, classifiers.num_classes(cfg)
    if args.calib != "synthetic":
        from ecoflap_tpu_torch.core.registry import registry
        from ecoflap_tpu_torch.data import datasets  # noqa: F401 (registers builders)
        from ecoflap_tpu_torch.data.processors import ImageEvalProcessor

        folder = registry.get("builder", "imagenet")(
            {"vis_root": args.calib}, vis_processor=ImageEvalProcessor(image_size=img))
        items = [folder[i % len(folder)] for i in range(n)]
        images = np.stack([it["image"] for it in items])
        labels = [it["label"] % ncls for it in items]
    else:
        rng = np.random.default_rng(args.seed)
        images = rng.normal(size=(n, img, img, 3))
        labels = rng.integers(0, ncls, size=(n,))
    batch = {"image": torch.from_numpy(np.asarray(images)).to(dtype),
             "label": torch.from_numpy(np.asarray(labels, np.int64))}
    adapter = classifiers.make_adapter(model)
    stack_specs = ({s.name: args.prune_spec for s in adapter.stacks}
                   if args.prune_spec else {})
    return adapter, batch, max(1, n // args.batch_size), stack_specs


SETUPS = {"blip2_t5": _blip2, "llama": _llama, "t5": _t5, "clip": _clip,
          "eva_clip": _clip, "deit": _classifier, "convnext": _classifier,
          "lfm2_moe": _lfm2}


def main(argv=None) -> Dict[str, Any]:
    """Prune and print the result JSON line, which holds the run's
    ``phase_times`` (s) and ``peak_gib`` too (and with ``--save_pruned_model``
    the ``.pth``'s path and the seconds its export and write took). Returns
    that result plus the per-target ``leaf_scores``, the pruned ``model``
    and the ``pruner``. With
    ``--coarse_only`` it writes the sparsity dict, prints and returns the
    JAX CLI's short result (job id, wall, dict path) and stops."""
    from ecoflap_tpu_torch.core.device import resolve_device
    from ecoflap_tpu_torch.core.project import apply_cfg_path
    from ecoflap_tpu_torch.parallel.dist import (destroy, init_distributed_mode,
                                                 is_dist_avail_and_initialized)

    parser = build_parser()
    args = parser.parse_args(argv)
    apply_cfg_path(args, sys.argv[1:] if argv is None else argv, prune=True)
    if not args.model:
        parser.error("--model is required (directly or through --cfg-path)")
    if args.mesh and args.mesh != "none":  # a bad spec raises before any start-up
        from ecoflap_tpu_torch.parallel.mesh import parse_mesh_spec

        parse_mesh_spec(args.mesh)
    if args.model not in SETUPS:  # a --cfg-path model outside MODELS
        raise NotImplementedError(
            f"--model {args.model}: the JAX prune CLI has no such model, nor has "
            "ecoflap_tpu_torch (ROADMAP.md, section 1)")
    prune_n = prune_m = 0
    if args.sparsity_type != "unstructured" and ":" in args.sparsity_type:
        prune_n, prune_m = map(int, args.sparsity_type.split(":"))
    device = resolve_device(args.device)
    # under torchrun: the process group, torn down on exit if started here
    owned = not is_dist_avail_and_initialized() and init_distributed_mode(device)
    try:
        return _run(args, device, prune_n, prune_m)
    finally:
        if owned:
            destroy()


def _run(args, device, prune_n: int, prune_m: int) -> Dict[str, Any]:
    from ecoflap_tpu_torch.core.device import exact_float32_matmuls, weight_dtype
    from ecoflap_tpu_torch.core.spec import parse_prune_spec
    from ecoflap_tpu_torch.parallel.dist import is_main_process, same_on_every_rank
    from ecoflap_tpu_torch.parallel.mesh import mesh_from_flag, use_mesh
    from ecoflap_tpu_torch.parallel.sharding import shard_params, unshard_params
    from ecoflap_tpu_torch.pruning.loader import load_pruner
    from ecoflap_tpu_torch.runners.runner import Runner, global_sparsity
    from ecoflap_tpu_torch.utils.checkpoint import (export_eva_clip_visual,
                                                    export_state_dict)

    mesh = mesh_from_flag(args.mesh, device)
    # TF32 off for matmuls and convolutions, once, here: float32 runs must
    # compute what the JAX package computes
    exact_float32_matmuls()
    dtype = weight_dtype(args.dtype, args.model_scale)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)

    adapter, batch, num_microbatches, stack_specs = SETUPS[args.model](args, device,
                                                                       dtype)
    batch = {k: t.to(device) for k, t in batch.items()}
    if mesh is not None:
        shard_params(adapter.model, mesh)
    if args.stacks:
        # explicit None for the stacks not kept: a missing entry would fall
        # back to --prune_spec and prune them anyway (the JAX cli/prune.py:638-645)
        keep = set(args.stacks.split(","))
        stack_specs = {s.name: (stack_specs.get(s.name) if s.name in keep else None)
                       for s in adapter.stacks}

    job_id = args.job_id or (
        f"{args.pruning_method}_{args.prune_spec or 'none'}"
        f"_{args.score_method}_{args.sparsity_ratio_granularity}")
    runner = Runner(args.output_dir, job_id, write=is_main_process())
    if args.is_global:
        # the global pruners' own configuration (cli/prune.py:674-680): no
        # --num_samples, so they score the first 64 samples
        pruner_cfg = dict(
            stack_specs=stack_specs or None, prune_spec=args.prune_spec,
            is_global=True, iteration=args.iteration, num_noise=args.num_noise,
            noise_eps=args.noise_eps, noise_mode=args.noise_mode, seed=args.seed)
    else:
        pruner_cfg = dict(
            stack_specs=stack_specs,
            prune_spec=args.prune_spec,
            sparsity_ratio_granularity=args.sparsity_ratio_granularity,
            max_sparsity_per_layer=args.max_sparsity_per_layer,
            score_method=args.score_method,
            num_data_first_stage=args.num_data_first_stage,
            num_noise=args.num_noise,
            noise_eps=args.noise_eps,
            noise_mode=args.noise_mode,
            mezo_ensemble=(None if args.mezo_ensemble is None
                           else bool(args.mezo_ensemble)),
            sparsity_dict=args.sparsity_dict,
            prune_per_model=args.prune_per_model,
            prune_n=prune_n,
            prune_m=prune_m,
            hessian_bf16=args.hessian_bf16,
            seed=args.seed,
        )
    t0 = time.time()
    pruner = load_pruner(args.pruning_method, adapter, batch, num_microbatches,
                         pruner_cfg)
    if args.coarse_only:
        specs = [s for s in stack_specs.values() if s]
        ratio = parse_prune_spec(specs[0] if specs else args.prune_spec).sparsity
        with torch.no_grad(), use_mesh(mesh):
            sdict = pruner.get_sparsity(ratio, args.sparsity_ratio_granularity)
        result = same_on_every_rank({
            "job_id": job_id,
            "wall_clock_s": round(time.time() - t0, 1),
            "sparsity_dict": runner.save_sparsity_dict(sdict),
        })
        if runner.write:
            print(json.dumps(result))
        return result
    with torch.no_grad(), use_mesh(mesh):
        model, sparsity_dict = pruner.prune()
    if mesh is not None:
        unshard_params(model)  # every rank: the whole pruned weights
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    sd_path = runner.save_sparsity_dict(sparsity_dict)
    stats_path = runner.save_training_statistics(wall, device)
    sparsity = global_sparsity(t.weight(model) for t in adapter.targets())
    peak = (torch.cuda.max_memory_allocated(device) / 2 ** 30
            if device.type == "cuda" else None)
    result = {
        "job_id": job_id,
        "wall_clock_s": round(wall, 1),
        "prunable_sparsity": round(sparsity, 4),
        "sparsity_dict": sd_path,
        "stats": stats_path,
        "phase_times": dict(pruner.phase_times),
        "peak_gib": peak,
    }
    if args.save_pruned_model:
        ts = time.time()
        export = export_eva_clip_visual if args.model == "eva_clip" else export_state_dict
        result["pth"] = runner.save_pruned_torch(export(model), job_id)
        result["pth_write_s"] = time.time() - ts
    result = same_on_every_rank(result)
    if runner.write:
        print(json.dumps(result))
    return {**result, "leaf_scores": dict(pruner.leaf_scores), "model": model,
            "pruner": pruner}


if __name__ == "__main__":
    main()
