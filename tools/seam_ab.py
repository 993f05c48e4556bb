#!/usr/bin/env python3
"""Two host-bound steps of the port, timed in a parent checkout and in this
one by turns, each run in a fresh process on one card.

Run from the root of a checkout on a machine with an NVIDIA H100, with the
other checkout unpacked somewhere (``git archive <commit> | tar -x -C dir``):
    python3 tools/seam_ab.py --ab <other checkout> [--pairs 6]

A pair is one run of each checkout; the order alternates (other, this;
this, other; ...), so a drift of the host over the call falls on both. A
run (``--root <checkout>``, which imports ``ecoflap_tpu_torch`` from that
checkout) builds, from random bf16 weights at seed 42:

* OPT-2.7B's decode step at ``chip_smoke.py`` phase 21's point (8 images x
  beam 5 = 40 rows, a prefix of 34 positions, 10 new tokens): the prefill,
  then 10 steps, timed;
* DeiT-B's forward on 8 random 224 x 224 images.

Each is timed in ``ROUNDS`` rounds after one of warm-up, and the run
reports the median round in ms a step or a forward. Both are eager PyTorch
with some 1,700 (OPT) and 300 (DeiT-B) launches a step, so the host's
dispatch sets their time. The last line is one JSON object: every run's
medians, each side's median and spread, each pair's ratio (this / other),
and the card's ``name, power.limit``.

    python3 tools/seam_ab.py --per-call

times the seam itself in one process: ``models/layers.linear(x, lin)`` and
``F.linear(x, lin.weight, lin.bias)`` on the same small bf16 operands (the
card's work a few us, so the host's dispatch sets the time), in
interleaved rounds of ``CALLS`` calls; it prints the median us a call of
each and their difference.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

SEED = 42
ROUNDS = 7
OPT_ROWS, OPT_PREFIX, OPT_STEPS = 40, 34, 10
DEIT_BATCH = 8
CALLS = 2000
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(root, device="cuda"):
    """Median ms of OPT-2.7B's decode step and DeiT-B's forward, with the
    package of checkout ``root``."""
    sys.path.insert(0, root)
    import torch

    import ecoflap_tpu_torch
    from ecoflap_tpu_torch.models import classifiers
    from ecoflap_tpu_torch.models import opt as opt_mod

    assert os.path.realpath(ecoflap_tpu_torch.__file__).startswith(os.path.realpath(root))
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(SEED)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)

    def rounds(fn, n):
        times = []
        for _ in range(ROUNDS + 1):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) / n * 1e3)
        return statistics.median(times[1:])

    opt = opt_mod.build_model(opt_mod.opt_2_7b(), device=dev, dtype=torch.bfloat16, seed=SEED)
    d = opt.cfg.d_model
    prefix = torch.randn(OPT_ROWS, OPT_PREFIX, d, generator=g, device=dev).to(torch.bfloat16)
    mask = torch.ones(OPT_ROWS, OPT_PREFIX, dtype=torch.long, device=dev)
    tok = torch.full((OPT_ROWS,), 2, dtype=torch.long, device=dev)

    def decode():
        with torch.inference_mode():
            cache = opt_mod.init_gen_cache(opt, prefix, mask, OPT_STEPS)
            step = opt_mod.make_opt_step_fn(opt, OPT_PREFIX, OPT_PREFIX, OPT_STEPS)
            for pos in range(OPT_STEPS):
                _, cache = step(tok, pos, cache)

    out = {"opt_step_ms": rounds(decode, OPT_STEPS)}
    del opt, prefix
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    deit = classifiers.build_model(classifiers.build("deit", "full"), device=dev,
                                   dtype=torch.bfloat16, seed=SEED)
    img = deit.cfg.img_size
    images = torch.randn(DEIT_BATCH, img, img, 3, generator=g, device=dev).to(torch.bfloat16)

    def forward():
        with torch.inference_mode():
            deit(images)

    out["deit_forward_ms"] = rounds(forward, 1)
    return out


def per_call(device="cuda"):
    """Median us a call of ``linear()`` and of ``F.linear`` (8 x 256 by
    256 x 256, bf16, with a bias), interleaved rounds."""
    sys.path.insert(0, HERE)
    import torch
    import torch.nn.functional as F

    from ecoflap_tpu_torch.models.layers import linear

    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    lin = torch.nn.Linear(256, 256, device=dev, dtype=torch.bfloat16).requires_grad_(False)
    x = torch.randn(8, 256, device=dev).to(torch.bfloat16)

    def us(fn):
        sync()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        sync()
        return (time.perf_counter() - t0) / CALLS * 1e6

    seam, plain = [], []
    with torch.inference_mode():
        for _ in range(ROUNDS + 1):
            seam.append(us(lambda: linear(x, lin)))
            plain.append(us(lambda: F.linear(x, lin.weight, lin.bias)))
    out = {"linear_us": statistics.median(seam[1:]),
           "f_linear_us": statistics.median(plain[1:])}
    out["seam_us"] = out["linear_us"] - out["f_linear_us"]
    return out


def run(root):
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, os.path.join(HERE, "tools", "seam_ab.py"),
                           "--root", root], cwd=root, env=env, capture_output=True,
                          text=True, timeout=600)
    if proc.returncode:
        raise RuntimeError(f"run in {root} exited {proc.returncode}:\n{proc.stderr[-3000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--root", help="one run with the package of this checkout")
    p.add_argument("--ab", help="the other checkout, timed against this one")
    p.add_argument("--pairs", type=int, default=6)
    p.add_argument("--per-call", action="store_true", help="time linear() against F.linear")
    args = p.parse_args()
    if args.per_call:
        print(json.dumps(per_call()))
        return
    if args.root:
        print(json.dumps(measure(os.path.abspath(args.root))))
        return
    other, this = os.path.abspath(args.ab), HERE
    runs = []
    for i in range(args.pairs):
        for side in (("other", "this") if i % 2 == 0 else ("this", "other")):
            r = run(other if side == "other" else this)
            r.update(pair=i, side=side)
            runs.append(r)
            print(json.dumps(r), flush=True)
    summary = {}
    for key in ("opt_step_ms", "deit_forward_ms"):
        for side in ("other", "this"):
            vals = [r[key] for r in runs if r["side"] == side]
            summary[f"{key}_{side}"] = {"median": statistics.median(vals),
                                        "min": min(vals), "max": max(vals)}
        summary[f"{key}_ratio_by_pair"] = [
            next(r[key] for r in runs if r["pair"] == i and r["side"] == "this")
            / next(r[key] for r in runs if r["pair"] == i and r["side"] == "other")
            for i in range(args.pairs)]
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    summary["runs"], summary["device"] = runs, smi.stdout.strip()
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
