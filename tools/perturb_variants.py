#!/usr/bin/env python3
"""The perturbation kernel's builds timed in turns on one card.

Run from the root of a checkout on a machine with an NVIDIA H100:
    python3 tools/perturb_variants.py [--parent-source PATH]

Builds ``ecoflap_tpu_torch/csrc/perturb.cu`` as it is (``base``: four
elements per Philox counter, the cos and sin branches of both word pairs),
a copy with the sin branch taken out by a text substitution (``cos_only``:
two elements per counter, the cos branch of each pair; a substitution whose
text is no longer in the source fails the run), and ``--parent-source``, an
earlier ``perturb.cu`` with the same C entries, when given (``parent``);
each with the port's ``nvcc`` flags into ``build/variants/``. The base and cos_only
builds are held to the gates ``chip_smoke.py`` holds the port's kernel to,
each against a plain version of its own stream, and the base's stream to a
pair-correlation check (|rho| < 0.01 between the cos and sin draws of one
word pair, and between neighbouring elements). Then every build is timed in
bf16 at the 11 weight shapes of the two zeroth-order paths, in turns (each
build twice, in the order base, cos_only, parent, parent, cos_only, base),
by their C entries with the arguments prepared once (as ``chip_smoke.py``
times the kernel), and averaged over those paths' launches.
The last line is one JSON object: {build: {"shapes": {shape: [ms, ms]},
"weighted_ms": x}, "checks": {build: {...}}, "ptxas": {...}, "device": ...}.
"""

import argparse
import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CORR_MAX = 0.01
COS_ONLY = [
    ("constexpr int kPerCounter = 4;", "constexpr int kPerCounter = 2;"),
    ("""  const float r0 = radius(w.x), r1 = radius(w.z);
  float s0, c0, s1, c1;
  sincosf(angle(w.y), &s0, &c0);
  sincosf(angle(w.w), &s1, &c1);
  z[0] = __fmul_rn(r0, c0);
  z[1] = __fmul_rn(r0, s0);
  z[2] = __fmul_rn(r1, c1);
  z[3] = __fmul_rn(r1, s1);
""", """  z[0] = __fmul_rn(radius(w.x), cosf(angle(w.y)));
  z[1] = __fmul_rn(radius(w.z), cosf(angle(w.w)));
"""),
]


def build_all(build, parent):
    """{name: (library, ptxas log)}, one nvcc each, all started together."""
    out_dir = ROOT / "build" / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC_DIR / "perturb.cu").read_text()
    cos_only = src
    for old, new in COS_ONLY:
        if old not in cos_only:
            raise RuntimeError(f"cos_only: {old!r} is not in the source")
        cos_only = cos_only.replace(old, new)
    texts = {"base": src, "cos_only": cos_only}
    if parent:
        texts["parent"] = Path(parent).read_text()
    jobs = {}
    for name, text in texts.items():
        cu = out_dir / f"perturb-{name}.cu"
        cu.write_text(text)
        lib = out_dir / f"libperturb-{name}.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", str(lib), str(cu)]
        jobs[name] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = (lib, log)
    return libs


class Build:
    """One build behind the functions ``chip_smoke.check_perturb`` and
    ``chip_smoke.c_launch`` call: its library, in-place entry and raw words,
    and the plain version of its stream (``per_counter`` elements a Philox
    counter)."""

    def __init__(self, P, torch, lib, per_counter):
        self.P, self.torch, self.lib = P, torch, lib
        self.ELEMENTS_PER_COUNTER = per_counter

    def _lib(self):
        return self.lib

    def _stream(self, device):
        return self.P._stream(device)

    def philox_stream_cuda(self, m, seed, device):
        out = self.torch.empty(4 * m, dtype=self.torch.int32, device=device)
        rc = self.lib.ecoflap_philox_words(
            ctypes.c_void_p(out.data_ptr()), ctypes.c_uint64(m), ctypes.c_uint64(seed),
            ctypes.c_void_p(self.P._stream(out.device)))
        if rc != 0:
            raise RuntimeError(f"philox words launch failed: cudaError_t {rc}")
        words = out.to(self.torch.int64) & 0xFFFFFFFF
        return tuple(words[k::4] for k in range(4))

    def philox_stream_ref(self, m, seed, device):
        return self.P.philox_stream_ref(m, seed, device)

    def perturb_inplace(self, w, seed, scale):
        rc = self.lib.ecoflap_perturb_inplace(
            ctypes.c_void_p(w.data_ptr()), self.P._DTYPE_CODE[w.dtype],
            ctypes.c_uint64(w.numel()), ctypes.c_uint64(seed), ctypes.c_float(scale),
            ctypes.c_void_p(self.P._stream(w.device)))
        if rc != 0:
            raise RuntimeError(f"perturb launch failed: cudaError_t {rc}")
        return w

    def perturb_block_inplace(self, leaf, idx, seed, scale):
        self.perturb_inplace(leaf[idx], seed, scale)
        return leaf

    def normals(self, n, seed, device):
        """z of elements 0..n-1 in float32, as the build computes them."""
        if self.ELEMENTS_PER_COUNTER == 4:
            return self.P.normals_ref(n, seed, device)
        w0, w1, w2, w3 = self.P.philox_stream_ref((n + 1) // 2, seed, device)
        z = self.torch.stack((self.P.words_to_normal(w0, w1),
                              self.P.words_to_normal(w2, w3)), 1)
        return z.reshape(-1)[:n]

    def perturb_inplace_ref(self, w, seed, scale):
        z = self.normals(w.numel(), seed, w.device)
        out = w.reshape(-1).to(self.torch.float32) + z * float(scale)
        w.copy_(out.to(w.dtype).view(w.shape))
        return w


def correlations(b, torch, shape):
    """Pearson rho of the kernel's z between elements 4j and 4j + 1 (one
    word pair's cos and sin), 4j + 2 and 4j + 3, and neighbours i, i + 1."""
    z = torch.zeros(shape, device="cuda")
    b.perturb_inplace(z, 0xD1B54A32D192ED03, 1.0)
    z = z.reshape(-1).double()
    n = z.numel() // 4 * 4

    def rho(x, y):
        x, y = x - x.mean(), y - y.mean()
        return (x * y).sum().item() / math.sqrt((x * x).sum().item() * (y * y).sum().item())

    q = z[:n].view(-1, 4)
    return {"draws": z.numel(), "cos_sin_pair0": rho(q[:, 0], q[:, 1]),
            "cos_sin_pair1": rho(q[:, 2], q[:, 3]), "neighbours": rho(z[:-1], z[1:])}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--parent-source", help="an earlier perturb.cu to time beside")
    parser.add_argument("--iters", type=int, default=50, help="launches per timing")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("perturb_variants: no card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke as S
    from ecoflap_tpu_torch.ops import build
    from ecoflap_tpu_torch.ops import perturb as P

    smi = S.nvidia_smi_line()
    print(smi, flush=True)
    built = build_all(build, args.parent_source)
    ptxas = {name: S.ptxas_usage(log) for name, (_, log) in built.items()}
    for name, usage in ptxas.items():
        print(f"{name} ptxas: {usage}", flush=True)
    builds = {name: Build(P, torch, P.bind(ctypes.CDLL(str(lib))),
                          2 if name == "cos_only" else 4)
              for name, (lib, _) in built.items()}

    checks = {}
    for name in ("base", "cos_only"):
        c = checks[name] = {"cases": 0, "worst_err": 0.0, "worst_z_ulp": 0.0}
        for dtype in (torch.bfloat16, torch.float32):
            for shape in S.XL_SHAPES + [S.RAGGED]:
                err, ulps = S.check_perturb(builds[name], torch, shape, dtype)
                c["cases"] += 1
                c["worst_err"] = max(c["worst_err"], err)
                c["worst_z_ulp"] = max(c["worst_z_ulp"], ulps)
    corr = correlations(builds["base"], torch, S.XL_SHAPES[0])
    checks["base"]["correlations"] = corr
    assert corr["draws"] >= 1_000_000
    assert all(abs(v) < CORR_MAX for k, v in corr.items() if k != "draws"), corr
    print(f"each build vs the plain version of its stream: {checks}", flush=True)

    weights = S.perturb_launch_weights()
    order = [n for n in ("base", "cos_only", "parent") if n in builds]
    result = {n: {"shapes": {}} for n in order}
    for shape in sorted(weights):
        w = (torch.randn(shape, device="cuda") * 0.02).to(torch.bfloat16)
        times = {n: [] for n in order}
        launch = {n: S.c_launch(builds[n], "ecoflap_perturb_inplace", w, dev=w.device)
                  for n in order}
        for n in order + order[::-1]:
            times[n].append(S.time_cuda(torch, launch[n], args.iters))
        for n in order:
            result[n]["shapes"][f"{shape[0]}x{shape[1]}"] = times[n]
        print(f"{shape[0]}x{shape[1]}: " + " | ".join(
            f"{n} " + ", ".join(f"{t:.4f}" for t in times[n]) + " ms" for n in order),
            flush=True)
    total = sum(weights.values())
    for n in order:
        result[n]["weighted_ms"] = sum(
            sum(result[n]["shapes"][f"{s[0]}x{s[1]}"]) / 2 * c
            for s, c in weights.items()) / total
        print(f"{n}: launch-weighted {result[n]['weighted_ms']:.4f} ms over {total} launches",
              flush=True)
    result["checks"] = checks
    result["ptxas"] = ptxas
    result["device"] = smi
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
