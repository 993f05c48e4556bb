"""The port's prune CLI against the JAX CLI, both started from one
checkpoint (a JAX export of tiny BLIP-2 weights, through ``--ckpt``) with
the same flags: ``--prune_spec`` alone, ``--coarse_only``, and the argument
lists of the two global-baseline launchers. Each run compares the result
line, the job id and the files written, and the pruned ``.pth`` that
``--save_pruned_model`` writes, tensor by tensor."""

import ast
import os

import pytest
import torch

from ecoflap_tpu.cli.prune import main as jmain
from ecoflap_tpu.utils import checkpoint as jck
from ecoflap_tpu_torch.cli.prune import main as tmain
from tests.torch_parity import one_torch_thread, tiny_pair  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    cfg, params, _ = tiny_pair(seed=0)
    path = str(tmp_path_factory.mktemp("ckpt") / "tiny_blip2.pth")
    jck.save_torch_checkpoint(jck.export_blip2(params, cfg), path)
    return path


def run_both(tmp_path, ckpt, flags):
    """(JAX result, port result, {relative path: bytes} of both output dirs)."""
    common = ["--model", "blip2_t5", "--model_scale", "tiny", "--ckpt", ckpt] + flags
    want = jmain(common + ["--platform", "cpu", "--output_dir", str(tmp_path / "jax")])
    got = tmain(common + ["--device", "cpu", "--output_dir", str(tmp_path / "torch")])
    files = {}
    for side in ("jax", "torch"):
        root = tmp_path / side
        files[side] = sorted(str(p.relative_to(root)) for p in root.rglob("*") if p.is_file())
    return want, got, files


def assert_same_pth(want, got):
    a = torch.load(want["pth"], weights_only=True)
    b = torch.load(got["pth"], weights_only=True)
    assert sorted(a) == sorted(b)
    for k in a:
        assert b[k].dtype == torch.float32, k
        assert torch.equal(a[k] == 0, b[k] == 0), k
        assert torch.equal(a[k], b[k]), k


def test_prune_spec_alone_prunes_as_the_jax_cli(tmp_path, ckpt):
    """``--prune_spec`` serves every stack without a spec of its own, the
    ViT included (the port's CLI once read only --vit/--t5_prune_spec and
    pruned nothing), and names the job with the spec."""
    want, got, files = run_both(tmp_path, ckpt, [
        "--prune_spec", "2-0.5-1.0-1.0", "--num_samples", "8", "--batch_size", "4",
        "--save_pruned_model"])
    assert got["prunable_sparsity"] == want["prunable_sparsity"] == 0.5002
    assert got["job_id"] == want["job_id"] == (
        "blipt5_wanda_pruner_2-0.5-1.0-1.0_MEZO-GradOnly_sum_None")
    assert files["torch"] == files["jax"] == [
        f"pruned_checkpoint/{want['job_id']}.pth",
        f"training_statistics/{want['job_id']}.yaml"]
    assert_same_pth(want, got)
    assert set(got["phase_times"]) == {f"fine_{s}_{part}" for s in (
        "visual_encoder.blocks", "t5_model.encoder.block", "t5_model.decoder.block")
        for part in ("s", "collect_s", "prune_s", "reforward_s")}


def test_coarse_only_writes_the_jax_cli_yaml(tmp_path, ckpt):
    """``--coarse_only`` with ``Real-GradMagAbs_sum`` scores, ``layer``
    granularity and ``--prune_per_model``: byte for byte the same YAML."""
    want, got, files = run_both(tmp_path, ckpt, [
        "--prune_spec", "2-0.5-1.0-1.0", "--num_samples", "16", "--batch_size", "4",
        "--num_data_first_stage", "8", "--coarse_only", "--sparsity_ratio_granularity",
        "layer", "--score_method", "Real-GradMagAbs_sum", "--prune_per_model"])
    assert set(got) == set(want) == {"job_id", "wall_clock_s", "sparsity_dict"}
    assert files["torch"] == files["jax"] == [f"sparsity_dict/{want['job_id']}.yaml"]
    with open(want["sparsity_dict"]) as a, open(got["sparsity_dict"]) as b:
        text = a.read()
        assert b.read() == text and text.count("\n") == 48


def launcher_args(script):
    """The prune flags a launcher under scripts/blip2/ passes (its ``args``
    list), read from its source."""
    with open(os.path.join(REPO, "scripts", "blip2", script)) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and getattr(node.targets[0], "id", None) == "args"):
            return ast.literal_eval(node.value)
    raise AssertionError(f"no args list in {script}")


@pytest.mark.parametrize("script", ["mag.py", "iterative_global_gradient.py"])
def test_global_launchers_prune_as_the_jax_cli(tmp_path, ckpt, script):
    """The launchers' own flags at tiny size: 16 samples in microbatches of
    4 (the global pruners score the first 64, so all 16 here), 3 steps."""
    args = launcher_args(script)
    assert "--is_global" in args and args[args.index("--iteration") + 1] == "3"
    for flag, value in (("--num_samples", "16"), ("--batch_size", "4")):
        args[args.index(flag) + 1] = value
    want, got, files = run_both(tmp_path, ckpt, args + ["--save_pruned_model"])
    assert got["prunable_sparsity"] == want["prunable_sparsity"]
    assert abs(got["prunable_sparsity"] - 0.5) < 1e-3
    assert files["torch"] == files["jax"]
    assert_same_pth(want, got)
    assert sorted(got["phase_times"]) == sorted(
        f"iteration_{i}_{part}" for i in (1, 2, 3) for part in ("s", "select_s"))
