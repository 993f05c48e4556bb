"""One run of one cell: resolve the cell's files by name, set up, measure
the window, judge what the window produced against the plain reference,
and build the result line.

Everything that belongs to one configuration, mix, cell or metric is a
file found by its name under ``portbench/``:

* ``configs/<config>.json``: the sizes, the init rules, the family;
* ``families/<family>.py``: builds the program's model at those sizes and
  makes the family's inputs from the seed;
* ``traffic/<mix>.json``: the job's flags or the eval batch; its ``job``
  names ``jobs/<job>.py``, the general driver of that kind of work;
* ``limits/<cell>.json``: the limit of each number compared;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(run)``,
  which returns a number or None when it finds nothing to read; a metric
  split by the end-to-end metric it moves (``device_idle.prune``,
  ``device_idle.eval``) may share one reader, ``metrics/device_idle.py``.

Every run measures its window untraced; the end-to-end metrics and the
per-layer metrics that time the program (phase times, MFU) read that
window. A ``--trace 1`` run then profiles one more, short window
(``TRACED_SECONDS``: one prune job, or some seconds of eval batches), from
which only what the trace alone gives is read: the device's idle share,
kernel rooflines and the breakdown.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

import torch

FORBIDDEN = ("jax", "jaxlib", "flax", "ecoflap_tpu")
TRACED_SECONDS = 10.0
_modules: Dict[str, ModuleType] = {}


def load_file(path: Path) -> ModuleType:
    """The module in ``path``, loaded once per process."""
    key = str(path)
    if key not in _modules:
        spec = importlib.util.spec_from_file_location(
            "portbench_" + path.stem.replace(".", "_").replace("-", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _modules[key] = mod
    return _modules[key]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is the
    JAX stack's or the JAX package's."""
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def spec_sparsity(spec: str) -> float:
    """``"<layers>-<keep>-<attn keep>-<ffn keep>"`` -> 1 - keep."""
    return 1.0 - float(spec.split("-")[1])


class Context:
    """What a job sees of its cell and run."""

    def __init__(self, root: Path, config: Dict, mix: Dict, seed: int,
                 device: torch.device) -> None:
        self.root, self.config, self.mix = root, config, mix
        self.seed, self.device = seed, device
        self.dtype = getattr(torch, config["dtype"])
        self.window_peak = 0

    def family(self) -> ModuleType:
        return load_file(self.root / "portbench" / "families" / f"{self.config['family']}.py")

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Cell:
    """A cell of ``BENCHMARK.json`` with its files."""

    def __init__(self, root: Path, name: str) -> None:
        self.root = root
        self.bench = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.spec = cells[name]
        entry = {c["name"]: c for c in self.bench["configs"]}[self.spec["config"]]
        self.config = json.loads((root / entry["file"]).read_text())
        base = root / "portbench"
        self.mix = json.loads((base / "traffic" / f"{self.spec['traffic']}.json").read_text())
        limits = base / "limits" / f"{name}.json"
        self.limits = json.loads(limits.read_text()) if limits.exists() else None
        self.job_module = load_file(base / "jobs" / f"{self.mix['job']}.py")

    def applies(self, metric: Dict) -> bool:
        return "workloads" not in metric or self.spec["name"] in metric["workloads"]

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self.applies(m)]

    def per_layer(self) -> List[Dict]:
        e2e = {m["name"] for m in self.end_to_end()}
        return [m for m in self.bench["per_layer"]
                if self.applies(m) and m["moves"] in e2e]

    def reader(self, name: str) -> ModuleType:
        """``metrics/<name>.py``, else the reader its family shares,
        ``metrics/<name before the first dot>.py``."""
        base = self.root / "portbench" / "metrics"
        own = base / f"{name}.py"
        return load_file(own if own.exists() else base / f"{name.split('.', 1)[0]}.py")


class Reading:
    """What a per-layer reader gets: the untraced window's record
    (``timed``: ``seconds``, ``work`` and, for prune jobs, each job's
    ``records``), the traced window's (``traced``) and the trace's summary
    (``trace``), the job's counts and the cell's mix."""

    def __init__(self, job, timed: Dict, traced: Optional[Dict],
                 trace: Optional[Dict]) -> None:
        self.job, self.mix = job, job.mix
        self.timed, self.traced, self.trace = timed, traced, trace
        self.counts = job.counts()


def judge(job, limits: Optional[Dict]) -> Dict[str, Dict[str, float]]:
    """{number: {value, limit}} of the program's outputs against the
    reference's. Every number of the limits file is judged (one the job did
    not give reads inf); a number the job gives with no limit, or any with
    no limits file, is judged against NaN, which nothing passes."""
    prog = job.program_outputs()
    from portbench.reference.numerics import Prec

    numbers = job.judge(prog, job.reference_outputs(Prec("f32"), dict_from=prog.get("dict"),
                                                    follow=prog.get("weights")))
    limits = (limits or {}).get("limits", {})
    return {k: {"value": float(numbers.get(k, math.inf)),
                "limit": float(limits.get(k, math.nan))}
            for k in list(limits) + [k for k in numbers if k not in limits]}


def reading(job, side: str) -> Dict[str, float]:
    """The numbers of one set-up job, its window run: the program's outputs
    (``side`` "program") or the control's (the reference with fp8 products
    in the program's place), judged against the float32 reference."""
    from portbench.reference.numerics import Prec, exact_float32

    job.release()
    exact_float32()
    prog = job.program_outputs()
    kw = {"dict_from": prog.get("dict")}
    if side == "control":
        ctrl = job.reference_outputs(Prec("fp8"), **kw)
        ref = job.reference_outputs(Prec("f32"), follow=ctrl.get("weights"), **kw)
        prog = job.as_program(ctrl, ref)
    else:
        ref = job.reference_outputs(Prec("f32"), follow=prog.get("weights"), **kw)
    return job.judge(prog, ref)


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", chips_needed: Optional[int] = None,
        t_start: Optional[float] = None) -> Dict:
    """One run; returns the result line's object (with ``checks`` last)."""
    from portbench.reference.numerics import exact_float32

    t_start = time.time() if t_start is None else t_start
    cell = Cell(root, workload)
    dev = torch.device(device)
    ctx = Context(root, cell.config, cell.mix, seed, dev)
    job = cell.job_module.Job(ctx)
    job.setup()
    ctx.sync()
    setup_s = time.time() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    timed = job.window(seconds)
    ctx.sync()
    ctx.window_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    summary = traced = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from portbench import trace as tr

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
        with profile(activities=acts) as prof:
            with record_function(tr.WINDOW):
                traced = job.window(min(seconds, TRACED_SECONDS))
                ctx.sync()
        summary = tr.summarize(prof)
        del prof
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the benchmark measures the "
                         "PyTorch port alone")
    e2e = job.end_to_end(timed)
    e2e["setup_s"] = setup_s
    metrics: Dict[str, Dict] = {}
    if trace:
        rd = Reading(job, timed, traced, summary)
        for m in cell.per_layer():
            v = cell.reader(m["name"]).read(rd)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
                   "count": chips_needed or 1,
                   "memory_peak_bytes": max(setup_peak, torch.cuda.max_memory_allocated(dev)
                                            if dev.type == "cuda" else 0)}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
    # the reference, once the window has closed, the peak is read and the
    # program's state is freed
    job.release()
    exact_float32()
    checks = judge(job, cell.limits)
    correct = bool(checks) and all(c["value"] <= c["limit"] for c in checks.values())
    out = {"correct": correct, "attempted": job.attempted,
           "failed": 0 if correct else job.attempted, "metrics": metrics,
           "device": device_info}
    if summary is not None:
        out["breakdown"] = {"device_ops": summary["device_ops"],
                            "idle_gaps": summary["idle_gaps"]}
    out["e2e_in_run"] = e2e
    if "records" in timed:
        out["jobs_s"] = [r["s"] for r in timed["records"]]
    out["checks"] = checks
    return out
