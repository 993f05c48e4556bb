"""Whole runs of the test-size cells on the CPU: a cell added by files only
runs and comes out correct; the result line has the contract's shape; the
control and each fault the cells can have come out not correct; and no
module the run loads is of the JAX stack or the JAX package."""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys

import pytest
import torch

from portbench import harness
from portbench.tests.conftest import REPO, TINY_CELLS, make_tiny_root

SEED = 2_200_000_123  # over 31 bits, as the driver's are
CELLS = [f"{c}.{m}" for c, m in TINY_CELLS]


def _run(root, cell, trace=False):
    return harness.run(root, cell, SEED, 0.5, trace, device="cpu")


def _digest(folder):
    return {p.relative_to(folder).as_posix(): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted(folder.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_added_cells_leave_every_file_as_it_was(tiny_root):
    have, was = _digest(tiny_root / "portbench"), _digest(REPO / "portbench")
    assert {k: v for k, v in have.items() if k in was} == was


@pytest.mark.parametrize("cell", CELLS)
def test_added_cell_runs_correct(tiny_root, cell):
    out = _run(tiny_root, cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_result_line_shape(tiny_root, cell):
    out = json.loads(json.dumps(_run(tiny_root, cell, trace=True)))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert {"platform", "kind", "count", "memory_peak_bytes", "busy_s",
            "window_s"} <= set(out["device"])
    for name, m in out["metrics"].items():
        assert set(m) == {"value", "unit"} and isinstance(m["value"], float), name
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    untraced = _run(tiny_root, cell)
    cellspec = harness.Cell(tiny_root, cell)
    assert set(untraced["metrics"]) == {m["name"] for m in cellspec.end_to_end()}


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(tiny_root, cell):
    """The reference with fp8 products in the program's place fails a limit."""
    c = harness.Cell(tiny_root, cell)
    ctx = harness.Context(tiny_root, c.config, c.mix, SEED, torch.device("cpu"))
    job = c.job_module.Job(ctx)
    job.setup()
    job.window(0.5)
    numbers = harness.reading(job, "control")
    limits = c.limits["limits"]
    assert any(numbers[k] > v for k, v in limits.items() if k in numbers), numbers


# -- the timed path broken underneath ------------------------------------------

def _unchanged(mp):
    from ecoflap_tpu_torch.pruning import pruners

    def prune(self):
        return self.adapter.model, ({t.name: 0.5 for t in self.adapter.targets()}
                                    if self.sparsity_ratio_granularity else None)
    mp.setattr(pruners.TwoStagePruner, "prune", prune)


def _half_batch(mp):
    from ecoflap_tpu_torch.pruning import mezo, pruners

    real_fine, real_scores = pruners.stream_prune_stack, mezo.mezo_leaf_scores

    def fine(stack, model, batch, *a, num_chunks=1, **kw):
        n = next(iter(batch.values())).shape[0] // 2
        return real_fine(stack, model, {k: v[:n] for k, v in batch.items()}, *a,
                         num_chunks=max(1, num_chunks // 2), **kw)
    mp.setattr(pruners, "stream_prune_stack", fine)

    def scores(loss_fn, *a, **kw):
        return real_scores(lambda m, b: loss_fn(m, b)[: max(1, len(loss_fn(m, b)) // 2)],
                           *a, **kw)
    import ecoflap_tpu_torch.pruning.sparsity as sp
    mp.setattr(sp, "mezo_leaf_scores", scores)


def _coarse_zero_noise(mp):
    """Kernel 2 returns the weight unchanged: the coarse stage's state."""
    from ecoflap_tpu_torch.pruning import mezo

    mp.setattr(mezo, "perturb", lambda w, seed, scale: w.clone())


def _coarse_half_batch(mp):
    """The lanes' losses of half the coarse microbatch, the mean taken over
    the rest."""
    from ecoflap_tpu_torch.pruning import plans

    real = plans.SuffixPlan.lane_losses

    def lane_losses(self, *a, **kw):
        out = real(self, *a, **kw)
        h = max(1, out.shape[1] // 2)
        return out[:, :h].repeat(1, 2)[:, :out.shape[1]]
    mp.setattr(plans.SuffixPlan, "lane_losses", lane_losses)


def _altered(mp):
    from ecoflap_tpu_torch.pruning import pruners

    real = pruners.TwoStagePruner.prune

    def prune(self):
        model, d = real(self)
        t = [t for t in self.adapter.targets() if self._spec_for_stack(t.stack.name)][-1]
        w = t.weight(model)
        w.view(-1)[: max(1, w.numel() // 100)] += 1.0  # an answer altered where made
        return model, d
    mp.setattr(pruners.TwoStagePruner, "prune", prune)


def _eval_unchanged(mp):
    from ecoflap_tpu_torch.cli import evaluate

    real = evaluate.zero_shot_predict_fn

    def fn(model, classifier, device):
        predict, first = real(model, classifier, device), []

        def stale(batch):
            if not first:
                first.append(predict(batch))
            return first[0]
        return stale
    mp.setattr(evaluate, "zero_shot_predict_fn", fn)


def _eval_half(mp):
    from ecoflap_tpu_torch.cli import evaluate

    real = evaluate.zero_shot_predict_fn

    def fn(model, classifier, device):
        predict = real(model, classifier, device)

        def half(batch):
            img = batch["image"]
            out = predict({"image": img[: len(img) // 2]})
            return torch.cat([out, out])
        return half
    mp.setattr(evaluate, "zero_shot_predict_fn", fn)


def _eval_altered(mp):
    from ecoflap_tpu_torch.cli import evaluate

    real = evaluate.zero_shot_predict_fn

    def fn(model, classifier, device):
        predict = real(model, classifier, device)

        def altered(batch):
            out = predict(batch).clone()
            out[0] += 0.5
            return out
        return altered
    mp.setattr(evaluate, "zero_shot_predict_fn", fn)


FAULTS = [("tiny-blip2.tiny-zeroth", f) for f in (_unchanged, _half_batch, _altered,
                                                  _coarse_zero_noise, _coarse_half_batch)] + \
    [("tiny-blip2.tiny-sparsegpt", f) for f in (_unchanged, _half_batch, _altered)] + \
    [("tiny-eva-clip.tiny-zeroshot", f) for f in (_eval_unchanged, _eval_half, _eval_altered)]


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__.strip('_')}" for c, f in FAULTS])
def test_fault_is_not_correct(tmp_path, monkeypatch, cell, fault):
    root = make_tiny_root(tmp_path)
    fault(monkeypatch)
    out = _run(root, cell)
    assert not out["correct"], out["checks"]


# -- what the run loads -----------------------------------------------------------

def test_forbidden_compares_whole_top_level_names(monkeypatch):
    import types

    monkeypatch.setitem(sys.modules, "ecoflap_tpu_torchish", types.ModuleType("x"))
    assert harness.forbidden_modules() == [] or "jax" in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "ecoflap_tpu.sub", types.ModuleType("y"))
    assert "ecoflap_tpu" in harness.forbidden_modules()


def test_a_run_loads_no_jax(tmp_path):
    root = make_tiny_root(tmp_path)
    code = (
        "import sys, json; sys.path.insert(0, sys.argv[1]); "
        "from pathlib import Path; from portbench.harness import run; "
        f"run(Path(sys.argv[1]), 'tiny-blip2.tiny-zeroth', {SEED}, 0.2, False, device='cpu'); "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code, str(root)], capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(REPO)})
    assert res.returncode == 0, res.stderr[-2000:]
    top = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "ecoflap_tpu_torch" in top
    assert not top & set(harness.FORBIDDEN)


def test_run_without_a_card_prints_no_result(tmp_path):
    root = make_tiny_root(tmp_path)
    res = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                          "tiny-blip2.tiny-zeroth", "--seed", str(SEED), "--seconds", "1",
                          "--trace", "0"], cwd=root, capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
                                           "PYTHONPATH": str(REPO)})
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_cells_on_the_card():
    """Each real cell once, briefly, on a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for cell in [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())[
            "workloads"]]:
        out = harness.run(REPO, cell, SEED, 1.0, False)
        assert out["correct"], (cell, out["checks"])
