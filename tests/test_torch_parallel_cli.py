"""The CLIs' ``--mesh`` under torchrun on the CPU (gloo): the prune CLI at
dp=2,tp=2 on 4 ranks against the single-process CLI (test_cli.py:181-213's
bounds), with one set of artifacts written by rank 0; the evaluate CLI's
``--mesh dp`` on tiny VQA and LLaMA perplexity against one process; and the
dp-sliced predictions those evaluations gather."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from ecoflap_tpu_torch.cli.evaluate import main as emain
from ecoflap_tpu_torch.cli.prune import main as pmain
from ecoflap_tpu_torch.runners.runner import read_flat_yaml
from tests.torch_dist import ROOT, free_port, run_ranks
from tests.torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PRUNE = ["--model", "blip2_t5", "--model_scale", "tiny",
         "--pruning_method", "blipt5_wanda_pruner", "--prune_spec", "2-0.5-1.0-1.0",
         "--vit_prune_spec", "3-0.5-1.0-1.0", "--sparsity_ratio_granularity", "block",
         "--score_method", "MEZO-GradOnly_sum", "--num_data_first_stage", "8",
         "--num_samples", "8", "--batch_size", "4", "--device", "cpu"]


def torchrun(nproc, module, argv, cwd):
    """``python -m torch.distributed.run`` on a free port, started at a
    lower priority; ``communicate()`` it for (stdout, stderr)."""
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    cmd = ["nice", "-n", "10", sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", str(nproc), "--master-addr", "127.0.0.1",
           "--master-port", str(free_port()), "-m", module] + argv
    return subprocess.Popen(cmd, cwd=str(cwd), env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def finished(proc):
    out, err = proc.communicate(timeout=240)
    assert proc.returncode == 0, err[-4000:]
    return out


def json_lines(text):
    return [json.loads(line) for line in text.splitlines() if line.startswith("{")]


EVALS = {
    "vqa": ["--model", "blip2_t5", "--task", "vqa", "--batch_size", "4",
            "--eval_batches", "2", "--max_new_tokens", "4", "--num_beams", "2"],
    "wikitext_ppl": ["--model", "llama", "--task", "wikitext_ppl", "--batch_size", "4"],
}
EVAL_COMMON = ["--device", "cpu", "--synthetic", "--model_scale", "tiny"]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three torchrun launches (prune on 4 ranks, the two evaluations on
    2), started together; the single-process runs compute meanwhile."""
    tmp = tmp_path_factory.mktemp("cli")
    procs = {"prune": torchrun(4, "ecoflap_tpu_torch.cli.prune",
                               PRUNE + ["--mesh", "dp=2,tp=2", "--output_dir", "mesh",
                                        "--save_pruned_model"], tmp)}
    for task, argv in EVALS.items():
        (tmp / task).mkdir()
        procs[task] = torchrun(2, "ecoflap_tpu_torch.cli.evaluate",
                               EVAL_COMMON + argv + ["--mesh", "dp", "--output_dir", "mesh"],
                               tmp / task)
    single = {"prune": pmain(PRUNE + ["--output_dir", str(tmp / "single")])}
    for task, argv in EVALS.items():
        single[task] = emain(EVAL_COMMON + argv + ["--output_dir", str(tmp / task / "single")])
    return tmp, single, {k: finished(p) for k, p in procs.items()}


@pytest.fixture(scope="module")
def prune_runs(runs):
    tmp, single, outs = runs
    return tmp, single["prune"], outs["prune"]


def test_torchrun_prune_matches_the_single_process_cli(prune_runs):
    tmp, single, out = prune_runs
    (meshed,) = json_lines(out)  # one result line, from rank 0
    sd_single = read_flat_yaml(single["sparsity_dict"])
    sd_mesh = read_flat_yaml(str(tmp / meshed["sparsity_dict"]))
    assert set(sd_single) == set(sd_mesh) and len(sd_mesh) == 48
    for k in sd_single:
        assert abs(sd_single[k] - sd_mesh[k]) < 5e-4, k
    assert abs(single["prunable_sparsity"] - meshed["prunable_sparsity"]) < 0.01


def test_torchrun_prune_writes_one_set_of_artifacts(prune_runs):
    """Rank 0 alone writes: one YAML, one statistics file, one ``.pth``
    exported from the gathered weights (whole shapes, the pruned zeros)."""
    tmp, _, out = prune_runs
    files = sorted(str(p.relative_to(tmp / "mesh")) for p in (tmp / "mesh").rglob("*")
                   if p.is_file())
    job = "blipt5_wanda_pruner_2-0.5-1.0-1.0_MEZO-GradOnly_sum_block"
    assert files == [f"pruned_checkpoint/{job}.pth", f"sparsity_dict/{job}.yaml",
                     f"training_statistics/{job}.yaml"]
    state = torch.load(tmp / "mesh" / f"pruned_checkpoint/{job}.pth", weights_only=True)
    q = state["t5_model.encoder.block.0.layer.0.SelfAttention.q.weight"]
    assert tuple(q.shape) == (32, 32) and 0.2 < float((q == 0).float().mean()) < 0.8
    assert tuple(state["t5_model.shared.weight"].shape) == (64, 32)


def test_bad_mesh_names_the_torchrun_it_needs(tmp_path):
    with pytest.raises(ValueError, match="torchrun --nproc-per-node 4"):
        pmain(PRUNE + ["--mesh", "dp=2,tp=2", "--output_dir", str(tmp_path)])
    with pytest.raises(ValueError, match="--mesh"):
        pmain(PRUNE + ["--mesh", "dp=2;tp=2", "--output_dir", str(tmp_path)])


@pytest.mark.parametrize("task", sorted(EVALS))
def test_torchrun_evaluate_dp_gives_the_single_process_metrics(task, runs):
    tmp, single, outs = runs
    (meshed,) = json_lines(outs[task])
    for k in ("agg_metrics", "overall", "ppl"):
        if k in single[task]:
            assert meshed[k] == pytest.approx(single[task][k], rel=1e-6), k
    logged = (tmp / task / "mesh" / "evaluate.txt").read_text().splitlines()
    assert len(logged) == 1  # rank 0's line only


def test_dp_sliced_generation_gathers_the_whole_batch(tmp_path):
    """The VQA path's predictions: each of 2 dp ranks generates its half of a
    batch of 4, and the gathered ids are the single-process ones."""
    from ecoflap_tpu_torch.models import blip2
    from ecoflap_tpu_torch.models.generation import GenerateConfig

    rng = np.random.default_rng(0)
    batch = {"image": rng.normal(size=(4, 16, 16, 3)).astype(np.float32),
             "ids": rng.integers(2, 64, size=(4, 6)), "mask": np.ones((4, 6), np.int64)}
    model = blip2.build_model(blip2.tiny_config(), device="cpu", seed=3)
    with torch.no_grad():
        want = model.generate(torch.from_numpy(batch["image"]),
                              torch.from_numpy(batch["ids"]),
                              torch.from_numpy(batch["mask"]),
                              GenerateConfig(max_new_tokens=4, num_beams=2)).tolist()
    got = run_ranks("blip2_dp_generate", 2, {"dp": 2, "seed": 3, "batch": batch}, tmp_path)
    assert got[0] == want and got[1] == want
