"""The readings that a cell's limits are set from, in one process:

    python3 portbench/readings.py --workload <cell> --seeds 1,2,3 \
        [--control 4,5,6] [--out file.json]

For each of ``--seeds``: set up the cell (which runs the program once on
the cell's own work: one whole prune job, or one eval batch, then the
window's work for ``--seconds``), and judge what it produced against the
float32 reference. For each of ``--control``: the control, the reference
computed with fp8 products in the program's place, judged the same way.
Prints one JSON line per seed and side; ``--out`` collects them.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from portbench.harness import Cell, Context, reading

    cell = Cell(ROOT, args.workload)
    dev = torch.device("cuda")
    rows = []

    def one(seed, side):
        t = time.time()
        ctx = Context(ROOT, cell.config, cell.mix, seed, dev)
        job = cell.job_module.Job(ctx)
        job.setup()
        if args.seconds > 0:
            job.window(args.seconds)
        ctx.sync()
        t_prog = time.time() - t
        numbers = reading(job, side)
        row = {"seed": seed, "side": side, "numbers": numbers, "program_s": t_prog,
               "total_s": time.time() - t, "detail": getattr(job, "detail", None)}
        print(json.dumps(row), flush=True)
        rows.append(row)
        del job
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    for side, seeds in (("program", args.seeds), ("control", args.control)):
        for s in filter(None, seeds.split(",")):
            one(int(s), side)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"workload": args.workload, "rows": rows,
                                              "wall_s": time.time() - T0}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
