"""The reader of the SparseGPT sweep kernel's launch count: the sum over the
pruned stacks of ``fine_<stack>_sweep_kernels_n``, the mean over the
untraced window's jobs; None from records without the key, as a parent
commit's program (CUDA graphs, no kernel) gives them."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from portbench import harness
from portbench.tests.conftest import REPO

VIT, ENC = "visual_encoder.blocks", "t5_model.encoder.block"
MIX = {"stack_specs": {VIT: "39-0.5-1.0-1.0", ENC: "24-0.5-1.0-1.0",
                       "t5_model.decoder.block": None}}
# two jobs; the unpruned decoder's key is not read
JOBS = [{f"fine_{VIT}_sweep_kernels_n": 3159, f"fine_{ENC}_sweep_kernels_n": 1728,
         "fine_t5_model.decoder.block_sweep_kernels_n": 100},
        {f"fine_{VIT}_sweep_kernels_n": 3159, f"fine_{ENC}_sweep_kernels_n": 1726}]
PARENT = [{f"fine_{VIT}_graph_builds_n": 156, f"fine_{ENC}_graph_builds_n": 4,
           f"fine_{VIT}_sweep_s": 17.0}]


def _read(records):
    reader = harness.Cell(REPO, "blip2-flant5xl.sparsegpt-vit").reader(
        "sparsegpt_sweep_kernels")
    run = SimpleNamespace(timed={"seconds": 51.0, "work": len(records),
                                 "records": [{"s": 7.0, "phase_times": pt}
                                             for pt in records]},
                          mix=MIX, traced=None, trace=None, counts={})
    return reader.read(run)


@pytest.mark.parametrize("records,want", [(JOBS, 3159 + 1727.0), (PARENT, None), ([], None)])
def test_reader(records, want):
    got = _read(records)
    assert got == (None if want is None else pytest.approx(want))
