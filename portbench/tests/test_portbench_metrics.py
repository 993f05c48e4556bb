"""The readers of the program's spans and counters: each gives its number
from the untraced window's ``phase_times`` records, and None from records
without its keys, as a parent commit's program gives them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.conftest import REPO

VIT, ENC = "visual_encoder.blocks", "t5_model.encoder.block"
MIX = {"stack_specs": {VIT: "39-0.5-1.0-1.0", ENC: "24-0.5-1.0-1.0",
                       "t5_model.decoder.block": None}}
# two jobs; the unpruned decoder's keys are not read
JOBS = [
    {"coarse_s": 9.0, f"coarse_{VIT}_lanes_s": 3.0, f"coarse_{VIT}_lanes_n": 78,
     f"coarse_{ENC}_lanes_s": 1.0, f"coarse_{ENC}_lanes_n": 48,
     f"fine_{VIT}_collect_s": 0.5, f"fine_{ENC}_collect_s": 0.25,
     f"fine_{VIT}_graph_build_s": 0.75, f"fine_{ENC}_graph_build_s": 0.25,
     f"fine_{VIT}_graph_builds_n": 156, f"fine_{ENC}_graph_builds_n": 4,
     "fine_t5_model.decoder.block_collect_s": 100.0},
    {"coarse_s": 8.0, f"coarse_{VIT}_lanes_s": 2.0, f"coarse_{VIT}_lanes_n": 78,
     f"coarse_{ENC}_lanes_s": 0.3, f"coarse_{ENC}_lanes_n": 48,
     f"fine_{VIT}_collect_s": 0.75, f"fine_{ENC}_collect_s": 0.5,
     f"fine_{VIT}_graph_build_s": 0.5, f"fine_{ENC}_graph_build_s": 0.5,
     f"fine_{VIT}_graph_builds_n": 156, f"fine_{ENC}_graph_builds_n": 4},
]
WANT = {
    "lane_forward_ms": 1000.0 * (3.0 + 1.0 + 2.0 + 0.3) / (2 * 126),
    "lane_forwards": 126.0,
    "fine_collect_s": (0.75 + 1.25) / 2,
    "sparsegpt_graph_build_s": (1.0 + 1.0) / 2,
    "sparsegpt_graph_builds": 160.0,
}
# what the parent's program records: the stage walls alone
PARENT = [{"coarse_s": 9.0, f"fine_{VIT}_s": 1.0, f"fine_{ENC}_s": 1.0}]


def _read(metric, records):
    reader = harness.Cell(REPO, "blip2-flant5xl.ecoflap-zeroth").reader(metric)
    run = SimpleNamespace(timed={"seconds": 51.0, "work": len(records),
                                 "records": [{"s": 17.0, "phase_times": pt}
                                             for pt in records]},
                          mix=MIX, traced=None, trace=None, counts={})
    return reader.read(run)


@pytest.mark.parametrize("metric", sorted(WANT))
def test_reader(metric):
    assert _read(metric, JOBS) == pytest.approx(WANT[metric])
    assert _read(metric, PARENT) is None
    assert _read(metric, []) is None
