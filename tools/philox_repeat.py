#!/usr/bin/env python3
"""The perturbation kernel's Philox words against the plain version's,
repeated at every in-place shape of ``chip_smoke.py``.

Run from the root of a checkout on a machine with an NVIDIA H100:
    python3 tools/philox_repeat.py [REPEATS]   (default 20)

Each repeat reads the kernel's four words of every counter an in-place
weight of each shape uses (``ops/perturb.py:philox_stream_cuda``) and the
plain version's (``philox_stream_ref``) for chip_smoke's seed of that shape,
and compares them bit for bit, as chip_smoke's phase 2 does once. A
mismatch prints what ``chip_smoke.philox_mismatch`` reports (how many
counters differ, whether each side repeats itself). The card's ECC counts,
clocks and temperature are printed before and after; the last line is
"<mismatches> mismatches in <comparisons> comparisons, <s> s". The exit
code is 1 if any comparison differed.
"""

import importlib.util
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from ecoflap_tpu_torch.ops import perturb as P  # noqa: E402


def main() -> int:
    repeats = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    if not torch.cuda.is_available():
        print("philox_repeat: no CUDA device", file=sys.stderr)
        return 2
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    dev = torch.device("cuda")
    print(cs.nvidia_smi_line())
    print(cs.card_health(), flush=True)
    bad = total = 0
    t0 = time.time()
    for rep in range(repeats):
        for shape in cs.IN_PLACE_SHAPES:
            seed = 0x9E3779B97F4A7C15 ^ (shape[0] << 20 | shape[1])
            m = -(-shape[0] * shape[1] // P.ELEMENTS_PER_COUNTER)
            kw = P.philox_stream_cuda(m, seed, dev)
            rw = P.philox_stream_ref(m, seed, dev)
            total += 1
            if not all(torch.equal(a, b) for a, b in zip(kw, rw)):
                bad += 1
                print(rep, shape, cs.philox_mismatch(P, torch, m, seed, dev, kw, rw),
                      flush=True)
            del kw, rw
    print(cs.card_health())
    print(f"{bad} mismatches in {total} comparisons, {time.time() - t0:.1f} s")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
