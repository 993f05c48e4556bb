"""The decoder-LM prune cell (``jobs/lm_prune.py``) at test sizes on the CPU:
added by files and entries only, it runs and comes out correct; the control
and each fault the cell can have come out not correct; and the expert
layer's readers read their keys, and nothing from a program without them.
"""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import DATA, REPO, make_tiny_root

SEED = 2_200_000_123
CONFIG, MIX = "tiny-lfm2", "tiny-first-order"
CELL = f"{CONFIG}.{MIX}"
REAL = "lfm2-8b-a1b.first-order-wanda"


def make_lm_root(dest: Path) -> Path:
    """``make_tiny_root`` and the test-size LM cell, by new files and
    entries only; the cell joins the metrics that list the real LM cell."""
    make_tiny_root(dest)
    base = dest / "portbench"
    shutil.copy(DATA / f"{CONFIG}.json", base / "configs")
    shutil.copy(DATA / f"{MIX}.json", base / "traffic")
    shutil.copy(DATA / "limits" / f"{CELL}.json", base / "limits")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": CONFIG, "source": "test sizes", "reduced": [],
                             "file": f"portbench/configs/{CONFIG}.json", "why": "tests"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": MIX, "chips": 1,
                               "why": "tests"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="module")
def lm_root(tmp_path_factory) -> Path:
    torch.set_num_threads(2)
    return make_lm_root(tmp_path_factory.mktemp("lm"))


def _run(root, trace=False):
    return harness.run(root, CELL, SEED, 0.5, trace, device="cpu")


def test_cell_runs_correct_and_reads_its_metrics(lm_root):
    out = _run(lm_root, trace=True)
    assert out["correct"], out["checks"]
    assert set(out["checks"]) == {"route_gap", "grad_gap", "dict_gap", "mask_gap",
                                  "kept_changed"}
    m = out["metrics"]
    # 4 sparse layers x 4 experts x (2 coarse microbatches x 2 forwards + 4 chunks x 2)
    assert m["moe_expert_calls"]["value"] == 192.0
    assert 0 < m["moe_s"]["value"] and m["mfu.prune"]["value"] > 0
    assert {"coarse_s", "fine_s", "fine_collect_s", "device_idle.prune"} <= set(m)
    untraced = _run(lm_root)
    assert set(untraced["metrics"]) == {"prune_s", "peak_gib", "setup_s"}


def test_control_is_not_correct(lm_root):
    c = harness.Cell(lm_root, CELL)
    ctx = harness.Context(lm_root, c.config, c.mix, SEED, torch.device("cpu"))
    job = c.job_module.Job(ctx)
    job.setup()
    job.window(0.2)
    numbers = harness.reading(job, "control")
    assert any(numbers[k] > v for k, v in c.limits["limits"].items() if k in numbers), numbers


# -- faults of the program ---------------------------------------------------------

def _route(mp, bias=True, normalise=True):
    from ecoflap_tpu_torch.models import lfm2_moe

    def route(self, flat):
        probs = torch.sigmoid(flat.to(torch.float32) @ self.gate.weight.to(torch.float32).T)
        choice = probs + self.expert_bias if bias else probs
        sel = torch.topk(choice, self.cfg.num_experts_per_tok, dim=-1).indices
        wts = probs.gather(1, sel)
        return sel, (wts / wts.sum(dim=-1, keepdim=True) if normalise else wts)
    mp.setattr(lfm2_moe.SparseMoe, "route", route)


def _bias_ignored(mp):
    _route(mp, bias=False)


def _unnormalised(mp):
    _route(mp, normalise=False)


def _conv_not_causal(mp):
    """The conv's outputs taken from the end: each sees the next tokens."""
    import torch.nn.functional as F

    from ecoflap_tpu_torch.models import layers, lfm2_moe

    def forward(self, h, stats, collect):
        taps = self.conv.weight.shape[-1]
        layers.collect_stats(stats, "conv.in_proj", h, collect)
        b, c, x = layers.linear(h, self.in_proj).chunk(3, dim=-1)
        y = F.conv1d((b * x).transpose(1, 2), self.conv.weight, padding=taps - 1,
                     groups=self.conv.weight.shape[0])[..., taps - 1:]
        y = c * y.transpose(1, 2)
        layers.collect_stats(stats, "conv.out_proj", y, collect)
        return layers.linear(y, self.out_proj)
    mp.setattr(lfm2_moe.ShortConv, "forward", forward)


def _qk_norm_skipped(mp):
    from ecoflap_tpu_torch.models import lfm2_moe

    real = lfm2_moe.RMSNorm.forward

    def forward(self, x):  # q_layernorm and k_layernorm are the head-sized norms
        return x if self.weight.numel() == 16 else real(self, x)
    mp.setattr(lfm2_moe.RMSNorm, "forward", forward)


def _stats_over_all_tokens(mp):
    """Each expert's w1/w3 statistic folded over every token of the layer."""
    from ecoflap_tpu_torch.models import lfm2_moe

    real = lfm2_moe.SparseMoe.forward

    def forward(self, h, stats, collect):
        out = real(self, h, stats, collect)
        if stats is not None and collect == "wanda":
            every = h.reshape(-1, h.shape[-1]).to(torch.float32).square().sum(dim=0)
            for e in range(self.cfg.num_experts):
                for n in ("w1", "w3"):
                    stats[f"feed_forward.experts.{e}.{n}"] = every
        return out
    mp.setattr(lfm2_moe.SparseMoe, "forward", forward)


def _expert_grad_dropped(mp):
    """Expert 0's gradients in every sparse layer read as zeros."""
    from ecoflap_tpu_torch.pruning import first_order

    real = first_order._target_grads

    def target_grads(*a, **kw):
        for name, w, g in real(*a, **kw):
            yield name, w, (torch.zeros_like(g) if ".experts.0." in name else g)
    mp.setattr(first_order, "_target_grads", target_grads)


FAULTS = [_bias_ignored, _unnormalised, _conv_not_causal, _qk_norm_skipped,
          _stats_over_all_tokens, _expert_grad_dropped]


@pytest.mark.parametrize("fault", FAULTS, ids=[f.__name__.strip("_") for f in FAULTS])
def test_fault_is_not_correct(lm_root, monkeypatch, fault):
    fault(monkeypatch)
    out = _run(lm_root)
    assert not out["correct"], out["checks"]


# -- the expert layer's readers ----------------------------------------------------

@pytest.mark.parametrize("metric,key", [("moe_s", "moe_s"),
                                        ("moe_expert_calls", "moe_expert_calls_n")])
def test_reader(metric, key):
    reader = harness.Cell(REPO, REAL).reader(metric)

    def run(records):
        return reader.read(SimpleNamespace(
            timed={"seconds": 51.0, "work": len(records),
                   "records": [{"s": 20.0, "phase_times": pt} for pt in records]},
            mix={}, traced=None, trace=None, counts={}))
    assert run([{key: 3.0, "coarse_s": 1.0}, {key: 5.0}]) == pytest.approx(4.0)
    assert run([{"coarse_s": 1.0, "fine_model.layers_s": 2.0}]) is None  # a parent's records
    assert run([]) is None
