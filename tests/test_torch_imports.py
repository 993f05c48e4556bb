"""The PyTorch port stands alone: no jax, no ecoflap_tpu module, and its
entry points refuse to run on a missing card unless asked for the CPU."""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "ecoflap_tpu_torch"


def _forbidden(name: str) -> bool:
    return (name == "jax" or name.startswith("jax.")
            or name == "ecoflap_tpu" or name.startswith("ecoflap_tpu."))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import ecoflap_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, 'ecoflap_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'ecoflap_tpu' or m.startswith('ecoflap_tpu.')]\n"
        "assert not bad, bad\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=str(ROOT), timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module of the package imported


@pytest.mark.parametrize("path", sorted(
    [p for p in PKG.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_do_not_import_jax_or_the_jax_package(path):
    bad = [m for m in _imports(path) if _forbidden(m)]
    assert not bad, f"{path}: {bad}"


def _module_level_imports(path: Path):
    """Imports at a module's top level (not inside a function or class)."""
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(
    [p for p in PKG.rglob("*.py")] + [ROOT / "chip_smoke.py"]),
    ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_yaml_or_pil_at_module_level(path):
    """The card's machine has neither: PIL is imported where an image is
    opened, and the port reads YAML itself (core/config.py)."""
    bad = [m for m in _module_level_imports(path)
           if m.split(".")[0] in ("yaml", "PIL")]
    assert not bad, f"{path}: {bad}"


def test_every_package_module_is_scanned():
    mods = {m.name for m in pkgutil.walk_packages([str(PKG)], "ecoflap_tpu_torch.")}
    for name in ("ops.perturb", "cli.prune", "cli.evaluate", "ops.attention",
                 "models.llama", "models.clip", "models.t5", "core.config",
                 "core.project", "data.coop", "data.prompts", "tasks.mmlu",
                 "tasks.classification", "models.bert", "models.blip1",
                 "runners.finetune", "tasks.retrieval", "cli.upop", "parallel.dist",
                 "parallel.mesh", "parallel.sharding", "models.zoo", "core.optims",
                 "data.loaders", "data.randaugment", "utils.logger", "utils.profiling"):
        assert f"ecoflap_tpu_torch.{name}" in mods, name


def test_cli_without_cpu_request_raises_when_there_is_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    from ecoflap_tpu_torch.cli.prune import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "blip2_t5", "--model_scale", "tiny",
              "--output_dir", str(tmp_path)])


def test_build_model_without_cpu_request_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    from ecoflap_tpu_torch.models import blip2

    with pytest.raises(RuntimeError, match="CUDA"):
        blip2.build_model(blip2.tiny_config())


def test_llama_build_model_without_cpu_request_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    from ecoflap_tpu_torch.models import llama

    with pytest.raises(RuntimeError, match="CUDA"):
        llama.build_model(llama.tiny_config())


def test_llama_cli_without_cpu_request_raises_when_there_is_no_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    from ecoflap_tpu_torch.cli.prune import main

    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--model", "llama", "--model_scale", "tiny",
              "--output_dir", str(tmp_path)])


def test_blip1_build_model_without_cpu_request_raises_when_there_is_no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    from ecoflap_tpu_torch.models import blip1

    with pytest.raises(RuntimeError, match="CUDA"):
        blip1.build_model(blip1.tiny_config(), "blip_caption")


@pytest.mark.parametrize("argv", [
    ["ecoflap_tpu_torch.cli.upop", "--head", "nlvr"],
    ["ecoflap_tpu_torch.cli.evaluate", "--model", "blip1", "--task", "retrieval"],
], ids=["upop", "evaluate_blip1"])
def test_new_entry_points_default_to_the_card(argv):
    """The UPop launcher and the blip1 evaluate branches run on ``cuda``
    unless ``--device cpu`` asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the no-card refusal is untestable")
    import importlib

    main = importlib.import_module(argv[0]).main
    assert main.__module__ == argv[0]
    with pytest.raises(RuntimeError, match="CUDA"):
        main(argv[1:] + ["--model_scale", "tiny"])


def test_importing_every_module_starts_no_process_group():
    """The parallel modules (and every other) start nothing at import: no
    process group, no card."""
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import torch, torch.distributed as dist\n"
        "import ecoflap_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, 'ecoflap_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from ecoflap_tpu_torch.parallel.mesh import current\n"
        "assert not dist.is_initialized() and current() is None\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=str(ROOT), timeout=120,
                         env={**os.environ, "RANK": "0", "WORLD_SIZE": "2",
                              "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"})
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
