#!/usr/bin/env python3
"""The MeZO coarse stage by the lane ensemble and by the serial in-place
cycle, in turns, in one process on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:
    python3 tools/mezo_ensemble_ab.py [--blip2-order 1,0,1] [--llama-order 1,0]

Each entry of an order is one run of ``ecoflap_tpu_torch.cli.prune.main``
with ``--mezo_ensemble`` set to it: BLIP-2 FlanT5-XL with the flags of
``chip_smoke.py`` phase 4 (scripts/blip2/ecoflap_zeroth.py at the zeroth_pb
shape: 4 coarse microbatches of 8), and LLaMA-7B with the flags of its phase
5 (scripts/llama/ecoflap_zero.sh, one coarse microbatch of 8 windows of
2048). Random bf16 weights from seed 42, so every run of one model scores
the same weights with the same z per (target, microbatch). Per run it
prints the prune wall, the coarse wall, the peak device memory, the
perturbation and flash launches, and the median and worst relative
difference of its scores from the model's first run (bf16 losses: a score
is a whole number of loss ulps over 2 eps, and the serial cycle restores
each weight to one bf16 rounding, so small scores move by whole ulps). The
last line is one JSON object: {"runs": [...], "device": "name, power.limit"}.
"""

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

SEED = 42
BLIP2 = ["--model", "blip2_t5", "--pruning_method", "blipt5_wanda_pruner",
         "--vit_prune_spec", "39-0.5-1.0-1.0", "--t5_prune_spec", "24-0.5-1.0-1.0",
         "--max_sparsity_per_layer", "0.6", "--num_data_first_stage", "32"]
LLAMA = ["--model", "llama", "--pruning_method", "llama_wanda_pruner",
         "--prune_spec", "32-0.4-1.0-1.0", "--max_sparsity_per_layer", "0.7",
         "--num_data_first_stage", "8", "--seqlen", "2048"]
COMMON = ["--model_scale", "full", "--seed", str(SEED),
          "--sparsity_ratio_granularity", "block", "--score_method", "MEZO-GradOnly_sum",
          "--num_samples", "128", "--batch_size", "8", "--calib", "synthetic"]


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--blip2-order", default="1,0,1")
    parser.add_argument("--llama-order", default="1,0")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mezo_ensemble_ab: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from ecoflap_tpu_torch.cli import prune as cli
    from ecoflap_tpu_torch.ops import attention as A
    from ecoflap_tpu_torch.ops import perturb as P

    kernels = {"perturb_inplace": P.perturb_inplace, "perturb": P.perturb,
               "flash_attention": A.flash_attention}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    out_dir = tempfile.mkdtemp(prefix="mezo_ab_")
    runs, first = [], {}
    for model, flags, order in (("blip2_t5", BLIP2, args.blip2_order),
                                ("llama", LLAMA, args.llama_order)):
        for ens in [o for o in order.split(",") if o]:
            for fn in kernels.values():
                fn.launches = 0
            t0 = time.time()
            res = cli.main(flags + COMMON + ["--mezo_ensemble", ens,
                                             "--output_dir", out_dir])
            wall = time.time() - t0
            scores = res["leaf_scores"]
            ref = first.setdefault(model, scores)
            rel = sorted(abs(scores[k] - ref[k]) / max(abs(ref[k]), 1e-12) for k in ref)
            run = {"model": model, "mezo_ensemble": int(ens), "wall_s": wall,
                   "prune_s": res["wall_clock_s"], "coarse_s": res["phase_times"]["coarse_s"],
                   "peak_gib": res["peak_gib"],
                   "launches": {k: fn.launches for k, fn in kernels.items()},
                   "rel_score_diff_from_first_run": {"median": rel[len(rel) // 2],
                                                     "max": rel[-1]}}
            print(json.dumps(run), flush=True)
            runs.append(run)
            del res
            gc.collect()
            torch.cuda.empty_cache()
    print(smi)
    print(json.dumps({"runs": runs, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
