"""CPU tests of the benchmark at test sizes.

    python -m pytest portbench/tests -q

``tiny_root`` is a checkout of the benchmark in a temporary folder with
the test sizes' configurations, mixes, cells and limits added as files
and entries, and no file that was there edited: the way a later change
adds a cell. Tests marked ``card`` need a CUDA device and skip without
one, deciding inside the test.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
TINY_CONFIGS = ("tiny-blip2", "tiny-eva-clip")
TINY_CELLS = (("tiny-blip2", "tiny-zeroth"), ("tiny-blip2", "tiny-sparsegpt"),
              ("tiny-eva-clip", "tiny-zeroshot"))


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA device; skips without one")


def make_tiny_root(dest: Path) -> Path:
    """Copy BENCHMARK.json and portbench/ to ``dest`` and add the test
    cells by new files and new entries only."""
    shutil.copy(REPO / "BENCHMARK.json", dest)
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for c in TINY_CONFIGS:
        shutil.copy(DATA / f"{c}.json", dest / "portbench" / "configs")
        bench["configs"].append({"name": c, "source": "test sizes", "reduced": [],
                                 "file": f"portbench/configs/{c}.json", "why": "tests"})
    for c, m in TINY_CELLS:
        shutil.copy(DATA / f"{m}.json", dest / "portbench" / "traffic")
        name = f"{c}.{m}"
        shutil.copy(DATA / "limits" / f"{name}.json", dest / "portbench" / "limits")
        bench["workloads"].append({"name": name, "config": c, "traffic": m, "chips": 1,
                                   "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] += [f"{c}.{mm}" for c, mm in TINY_CELLS
                               if _kind(mm) == _kind_of_metric(m, bench)]
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


def _kind(mix: str) -> str:
    return json.loads((DATA / f"{mix}.json").read_text())["job"]


def _kind_of_metric(metric, bench) -> str:
    """The job kind of the cells a metric already lists."""
    cells = {w["name"]: w["traffic"] for w in bench["workloads"]}
    first = cells[metric["workloads"][0]]
    return json.loads((REPO / "portbench" / "traffic" / f"{first}.json").read_text())["job"]


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    import torch

    torch.set_num_threads(2)
    return make_tiny_root(tmp_path_factory.mktemp("bench"))
