#!/usr/bin/env python3
"""Where the flash kernels' time goes: variant builds timed on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:
    python3 tools/flash_variants.py

Each variant is a copy of ``ecoflap_tpu_torch/csrc/flash_attn.cu`` or
``flash_attn_bwd.cu`` with one piece of work taken out by a text
substitution, built with the port's own ``nvcc`` flags into
``build/variants/`` and launched through the same C entry at the LLaMA-7B
calibration shape (8, 32, 2048, 128). A variant's outputs are wrong: only
its time means anything, against the unmodified build (``base``) timed in
turns with it, twice. A substitution replaces every occurrence of its text,
and one whose text is no longer in the source fails the run, so the tool
cannot silently time the unmodified kernel.
The last line is one JSON object: {kernel: {variant: [ms, ...]}}, the base's
times those taken just before each variant's.
"""

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

SHAPE = (8, 32, 2048, 128)
FWD_TURNS = [("named_sync(1 + cw, 256);", ""), ("named_arrive(2 - cw, 256);", ""),
             ("if (cw == 1) named_arrive(1, 256);", ""),
             ("if (cw == 0) named_sync(1, 256);", "")]
# kernel -> variant -> [(text, replacement), ...]
VARIANTS = {
    "flash_attn": {
        # every CTA runs one key tile: the cost a CTA pays whatever its length
        "one_key_tile": [("const int n_tiles = qt + 1;", "const int n_tiles = 1;")],
        "no_output_store": [("    tma_store_4d(&o_map, o_wg, 0, row0, h, b);\n", ""),
                            ("    tma_store_4d(&o_map, o_wg + kBoxBytes, 64, row0, h, b);\n",
                             "")],
        "no_softmax": [("online_softmax(sc, m_run, l_run, alpha, scale_log2, qt == 0, 0, r0, t);",
                        "alpha[0] = alpha[1] = 1.f;"),
                       ("online_softmax(sc, m_run, l_run, alpha, scale_log2, j == qt, "
                        "j * kBlockN, r0, t);", "alpha[0] = alpha[1] = 1.f;")],
        "no_pv": [("    issue_pv(acc, pf, sV + sp * kTileBytes);\n", "    wgmma_commit();\n")],
        "no_turns": FWD_TURNS,
    },
    "flash_attn_bwd": {
        "dq_kernel_only": [("  flash_bwd_dkv_kernel<<<", "  if (seq > 0) return 0;\n"
                            "  flash_bwd_dkv_kernel<<<")],
        # Di is then left unwritten: the time is all that counts
        "dkv_kernel_only": [("  flash_bwd_dq_kernel<<<", "  if (seq > 0) goto dkv;\n"
                             "  flash_bwd_dq_kernel<<<"),
                            ("  flash_bwd_dkv_kernel<<<", "dkv:\n  flash_bwd_dkv_kernel<<<")],
        "no_turns": [("{ named_sync(1 + cw, 256); }", "{}"),
                     ("{ named_arrive(2 - cw, 256); }", "{}"),
                     ("if (cw == 1) named_arrive(1, 256);", ""),
                     ("if (cw == 0) named_sync(1, 256);", "")],
    },
}


def build_all(root: Path, build):
    """Writes and compiles every variant and each kernel's base, one nvcc
    each, all at once; returns {kernel: {variant: library path}}."""
    csrc = root / "ecoflap_tpu_torch" / "csrc"
    out_dir = root / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for kernel, variants in VARIANTS.items():
        src = (csrc / f"{kernel}.cu").read_text()
        for name, subs in {"base": [], **variants}.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise RuntimeError(f"{kernel}/{name}: {old!r} is not in the source")
                text = text.replace(old, new)
            cu = out_dir / f"{kernel}-{name}.cu"
            cu.write_text(text)
            lib = out_dir / f"lib{kernel}-{name}.so"
            cmd = [build._nvcc(), *build.NVCC_FLAGS, f"-I{csrc}", "-o", str(lib), str(cu)]
            jobs[(kernel, name)] = (lib, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (kernel, name), (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {kernel}/{name}:\n{log}")
        libs.setdefault(kernel, {})[name] = lib
    return libs


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--iters", type=int, default=20, help="launches per timing")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no card", file=sys.stderr)
        return 1
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from ecoflap_tpu_torch.ops import attention as A
    from ecoflap_tpu_torch.ops import build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = {k: {n: A.bind(ctypes.CDLL(str(p))) for n, p in v.items()}
            for k, v in build_all(root, build).items()}

    g = torch.Generator(device="cuda").manual_seed(5)
    q, k, v, do = (torch.randn(SHAPE, generator=g, device="cuda").to(torch.bfloat16)
                   for _ in range(4))
    scale = SHAPE[-1] ** -0.5
    out, lse = A.flash_attention_lse(q, k, v, scale)
    o = torch.empty_like(q)
    di = torch.empty(SHAPE[:3], device="cuda")
    grads = [torch.empty_like(q) for _ in range(3)]
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def strides(*ts):
        return [st for t in ts for st in t.stride()[:3]]

    def fwd(lib):
        rc = lib.ecoflap_flash_attn_fwd(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                        None, *SHAPE, *strides(q, k, v, o),
                                        ctypes.c_float(scale), stream)
        if rc != 0:
            raise RuntimeError(f"flash forward variant launch failed: cudaError_t {rc}")

    def bwd(lib):
        ptrs = [t.data_ptr() for t in (q, k, v, out, do, lse, di, *grads)]
        rc = lib.ecoflap_flash_attn_bwd(*ptrs, *SHAPE, *strides(q, k, v, out, do, *grads),
                                        ctypes.c_float(scale), stream)
        if rc != 0:
            raise RuntimeError(f"flash backward variant launch failed: cudaError_t {rc}")

    def time_ms(fn):
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / args.iters

    result = {}
    for kernel, call in (("flash_attn", fwd), ("flash_attn_bwd", bwd)):
        variants = [name for name in libs[kernel] if name != "base"]
        times = {"base": [], **{name: [] for name in variants}}
        for _ in range(2):  # each variant right after a run of the base
            for name in variants:
                times["base"].append(time_ms(lambda: call(libs[kernel]["base"])))
                times[name].append(time_ms(lambda: call(libs[kernel][name])))
        for name, ms in times.items():
            print(f"{kernel} {name}: " + ", ".join(f"{t:.4f}" for t in ms) + " ms", flush=True)
        result[kernel] = times
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
