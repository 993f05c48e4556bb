"""The UPop runs: ECoFLaP on BLIP-1 with masked fine-tuning (the port's
launcher for ``scripts/upop/ecoflap_{caption,vqa,nlvr,retrieval_flickr}.py``
and their ``_shared.run``; reference UPop/ecoflap_compress_caption.py:231-311,
ecoflap_compression_vqa.py:264-266, ecoflap_compress_nlvr.py:242-250,
ecoflap_compression_retrieval_flickr.py:365-367).

  python -m ecoflap_tpu_torch.cli.upop --head caption --model_scale full \\
      --p 0.5 --num_samples 32 --finetune_steps 2 --save_pruned pruned.pth

All four heads share the pruning configuration: ``MEZO-GradOnly_sum`` with
the ``block`` granularity over the ViT and the head's BERT towers,
``num_data_first_stage = min(32, n)``, ``max_sparsity_per_layer = p + 0.1``,
microbatches of 8, then the Wanda fine stage. They differ in the head, its
batch (the launchers' synthetic batch, numpy seed 0) and the task loss that
drives both the coarse scores and the fine-tuning: the caption LM loss,
the answer LM loss, NLVR's CE or retrieval's ITM CE. ``--finetune_steps``
runs masked AdamW (lr 1e-5, weight decay 0.05) over the same batch.
``--ckpt`` starts from a UPop BLIP ``.pth`` (``convert_blip1``'s
semantics), ``--save_pruned`` writes the pruned model under the reference
names (``export_blip1``). ``tiny`` runs in float32, ``small``/``full``
(``blip_base``, 384 px) in bf16, as the JAX launcher. Runs on the card
unless ``--device cpu``. Prints one JSON line with the JAX launcher's keys
(``sparsity``, ``groups``, ``ft_loss_first``/``ft_loss_last``,
``pruned_checkpoint``) and the run's walls and peak memory.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Any, Dict

import numpy as np
import torch

HEADS = {"caption": "blip_caption", "vqa": "blip_vqa", "nlvr": "blip_nlvr",
         "retrieval": "blip_retrieval"}
MICROBATCH = 8


def build_batch(head: str, cfg, n: int) -> Dict[str, np.ndarray]:
    """The launchers' synthetic batch of ``n`` samples (numpy seed 0)."""
    rng = np.random.default_rng(0)
    s, v = cfg.vit.img_size, cfg.text.vocab_size

    def image():
        return rng.normal(size=(n, s, s, 3)).astype(np.float32)

    def ids(length):
        return rng.integers(2, v, size=(n, length))

    if head in ("caption", "retrieval"):
        return {"image": image(), "caption_ids": ids(16),
                "caption_mask": np.ones((n, 16), np.int64)}
    if head == "vqa":
        img = image()
        q = ids(12)
        return {"image": img, "question_ids": q, "question_mask": np.ones((n, 12), np.int64),
                "answer_ids": ids(6), "answer_mask": np.ones((n, 6), np.int64)}
    img0, img1 = image(), image()
    text = ids(16)
    return {"image0": img0, "image1": img1, "text_ids": text,
            "text_mask": np.ones((n, 16), np.int64),
            "label": rng.integers(0, 2, size=(n,))}


def stack_names(head: str, cfg):
    """(stack, depth) pairs the launcher prunes."""
    text = ("text_decoder.bert.encoder.layer" if head == "caption"
            else "text_encoder.encoder.layer")
    out = [("visual_encoder.blocks", cfg.vit.depth), (text, cfg.text.num_layers)]
    if head == "vqa":
        out.append(("text_decoder.bert.encoder.layer", cfg.text.num_layers))
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="ECoFLaP on BLIP-1 with masked fine-tuning "
                                            "(the UPop runs; PyTorch/CUDA)")
    p.add_argument("--head", default="caption", choices=sorted(HEADS))
    p.add_argument("--p", type=float, default=0.5, help="target sparsity")
    p.add_argument("--model_scale", default="tiny", choices=["tiny", "small", "full"])
    p.add_argument("--num_samples", type=int, default=32)
    p.add_argument("--finetune_steps", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a card) or cpu")
    p.add_argument("--ckpt", default=None,
                   help="UPop BLIP torch .pth to start from (the reference starts "
                        "from model_base_caption_capfilt_large.pth)")
    p.add_argument("--save_pruned", default=None,
                   help="write the pruned model as a reference-named .pth")
    p.add_argument("--noise_eps", type=float, default=1e-3,
                   help="MeZO perturbation scale (the reference's 1e-3)")
    p.add_argument("--seed", type=int, default=0, help="the random init's seed")
    return p


def main(argv=None, noise=None) -> Dict[str, Any]:
    """Prune (and fine-tune), print the result line, return it with the
    pruned ``model``, its ``adapter``, the ``pruner`` and the ``batch``.
    ``noise`` is the tests' MeZO hook (``pruning/mezo.py``)."""
    from ecoflap_tpu_torch.core.device import exact_float32_matmuls, resolve_device
    from ecoflap_tpu_torch.models import blip1
    from ecoflap_tpu_torch.pruning.pruners import TwoStagePruner
    from ecoflap_tpu_torch.runners.finetune import finetune
    from ecoflap_tpu_torch.utils.checkpoint import (export_state_dict, load_into,
                                                    load_torch_checkpoint,
                                                    save_torch_checkpoint)

    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    exact_float32_matmuls()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cfg = blip1.config_for_scale(args.model_scale)
    dtype = torch.float32 if args.model_scale == "tiny" else torch.bfloat16
    model = blip1.build_model(cfg, HEADS[args.head], device=device, dtype=dtype,
                              seed=None if args.ckpt else args.seed)
    if args.ckpt:
        load_into(model, load_torch_checkpoint(args.ckpt))
    adapter = blip1.make_adapter(model)
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in build_batch(args.head, cfg, args.num_samples).items()}
    keep = 1.0 - args.p
    pruner = TwoStagePruner(
        adapter, batch, num_microbatches=max(1, args.num_samples // MICROBATCH),
        stack_specs={name: f"{depth}-{keep}-1.0-1.0"
                     for name, depth in stack_names(args.head, cfg)},
        sparsity_ratio_granularity="block",
        max_sparsity_per_layer=min(args.p + 0.1, 1.0),
        score_method="MEZO-GradOnly_sum",
        num_data_first_stage=min(32, args.num_samples), noise_eps=args.noise_eps,
        noise=noise, verbose=False)
    t0 = time.time()
    with torch.no_grad():
        model, sd = pruner.prune()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out: Dict[str, Any] = {"sparsity": pruner.check_sparsity(), "groups": len(sd or {}),
                           "prune_s": time.time() - t0,
                           "phase_times": dict(pruner.phase_times)}
    if args.finetune_steps:
        t0 = time.time()
        _, losses = finetune(adapter.loss_fn, model, [batch] * args.finetune_steps)
        out["finetune_s_per_step"] = (time.time() - t0) / args.finetune_steps
        out["ft_loss_first"], out["ft_loss_last"] = losses[0], losses[-1]
    if args.save_pruned:
        save_torch_checkpoint(export_state_dict(model), args.save_pruned)
        out["pruned_checkpoint"] = args.save_pruned
    if device.type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated(device) / 2 ** 30
    print(json.dumps(out))
    return {**out, "model": model, "adapter": adapter, "pruner": pruner,
            "sparsity_dict": sd, "batch": batch}


if __name__ == "__main__":
    main()
