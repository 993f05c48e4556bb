"""``--cfg-path`` / ``--options`` in the port: its own YAML reader against
PyYAML's ``yaml.safe_load`` on every shipped project file and on the YAML
1.1 scalars a flag value can be, ``apply_cfg_path`` on both port CLIs'
parsers against the JAX package's on the same argv (a YAML alone, with
``--options``, and with an explicit flag the file must not override), the
shipped YAMLs driving the port CLIs, and a YAML naming a family or task
the port lacks reaching the CLIs' "not ported" error."""

import math
from pathlib import Path

import pytest
import yaml

from ecoflap_tpu.cli.evaluate import build_parser as jeval_parser
from ecoflap_tpu.cli.prune import build_parser as jprune_parser
from ecoflap_tpu.core.config import Config as JConfig
from ecoflap_tpu.core.config import parse_dot_list as jparse_dot_list
from ecoflap_tpu.core.project import apply_cfg_path as japply
from ecoflap_tpu_torch.cli.evaluate import build_parser as teval_parser
from ecoflap_tpu_torch.cli.evaluate import main as teval
from ecoflap_tpu_torch.cli.prune import build_parser as tprune_parser
from ecoflap_tpu_torch.cli.prune import main as tprune
from ecoflap_tpu_torch.core.config import Config, parse_dot_list, safe_load
from ecoflap_tpu_torch.core.project import apply_cfg_path, projects_root, resolve_cfg_path
from tests.torch_parity import one_torch_thread  # noqa: F401 (a fixture)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ROOT = Path(__file__).resolve().parents[1]
PROJECT_FILES = sorted((ROOT / "configs" / "projects").rglob("*.yaml"))


def same(a, b):
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("path", PROJECT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT / "configs" / "projects")))
def test_reader_equals_pyyaml_on_every_project_file(path):
    text = path.read_text()
    assert safe_load(text) == yaml.safe_load(text)


SCALARS = ["1e-3", "1.0e-3", "0.5", "-2.5e+3", ".5", "1_000.0", ".inf", "-.Inf", ".nan",
           "yes", "No", "TRUE", "off", "On", "tRue", "~", "null", "NULL", "", "012", "09",
           "0x1F", "0b101", "-7", "+3", "1_000", "1:30", "0", "24-0.5-1.0-1.0",
           "1-0.6-1-1", "blipt5_wanda_pruner", "MEZO-GradOnly_sum", "a b c", "foo:bar",
           "2001-12-14", "'quoted: yes'", '"tab\\tand \\"q\\""', "'it''s'",
           "[1, 2.5, three, yes]", "[]", "{}", "{a: 1, b: [x, y], c: {d: ~}}",
           "[a, [b, c], {d: e}]", "[1, 2, ]", "k: v  # comment", "- a\n- b",
           "x:\n- 1\n- 2\ny: 3", "- a: 1\n  b: 2\n- c", "x:\n  - 1\n  - - 2\n    - 3"]


@pytest.mark.parametrize("text", SCALARS)
def test_reader_equals_pyyaml_on_scalars_and_collections(text):
    want, got = yaml.safe_load(text), safe_load(text)
    if isinstance(want, (list, dict)):
        assert got == want
    else:
        assert same(got, want), (got, want)


@pytest.mark.parametrize("text", ["a: &x 1", "a: *x", "a: !!str 1", "a: |\n  b",
                                  "a: [1,\n  2]", "plain\ncontinued"])
def test_reader_refuses_what_it_does_not_cover(text):
    with pytest.raises(ValueError):
        safe_load(text)


def test_dot_list_and_config_views_match_jax():
    opts = ["prune.num_data_first_stage=8", "run.seed=7", "model.arch=t5",
            "prune.noise_eps=1e-3", "prune.max_sparsity_per_layer=0.6", "a.b.c=[1, 2]"]
    assert parse_dot_list(opts) == jparse_dot_list(opts)
    path = str(ROOT / "configs" / "projects" / "t5" / "c4_prefix_derivative_compute.yaml")
    ours, theirs = Config(path, options=opts), JConfig(path, options=opts)
    assert ours.config == theirs.config
    assert ours.run_cfg == theirs.run_cfg and ours.model_cfg == theirs.model_cfg
    assert ours.datasets_cfg == theirs.datasets_cfg
    assert ours.get("prune.noise_eps") == "1e-3"  # YAML 1.1: no dot, no float
    assert ours.get("prune.num_data_first_stage") == 8 and ours.get("x.y", 5) == 5
    with pytest.raises(ValueError, match="key=value"):
        parse_dot_list(["novalue"])


def test_resolve_cfg_path():
    assert resolve_cfg_path("eva_clip/ecoflap.yaml") == str(
        Path(projects_root()) / "eva_clip" / "ecoflap.yaml")
    with pytest.raises(FileNotFoundError, match="not under"):
        resolve_cfg_path("no/such.yaml")


PRUNE_ARGVS = [
    ["--cfg-path", "t5/c4_prefix_derivative_compute.yaml"],
    ["--cfg-path", "eva_clip/ecoflap.yaml", "--options", "prune.num_data_first_stage=16",
     "run.seed=3", "model.model_scale=tiny"],
    ["--cfg-path", "clip/exp_imnet_zs_eval.yaml", "--prune_spec", "12-0.6-1.0-1.0",
     "--batch_size", "16", "--options", "prune.batch_size=4"],
    ["--cfg-path", "llama/ecoflap_zero.yaml", "--num_samples", "16"],
    ["--cfg-path", "blip2/eval/cc_prefix_derivative_compute.yaml", "--seed=5"],
]
EVAL_ARGVS = [
    ["--cfg-path", "eva_clip/exp_imnet_zs_eval.yaml"],
    ["--cfg-path", "clip/exp_imnet_zs_eval.yaml", "--options", "run.batch_size_eval=16"],
    ["--cfg-path", "blip2/eval/vqav2_zeroshot_flant5xl_eval.yaml", "--num_beams", "3",
     "--options", "run.max_len=5"],
    ["--cfg-path", "llama/wikitext_ppl_eval.yaml", "--task", "wikitext_ppl"],
]


def applied(parser, apply, argv, **kw):
    args = parser.parse_args(argv)
    apply(args, argv, **kw)
    return vars(args)


@pytest.mark.parametrize("argv", PRUNE_ARGVS, ids=lambda a: a[1].split("/")[-1])
def test_prune_cli_applies_the_yaml_as_the_jax_cli(argv):
    got = applied(tprune_parser(), apply_cfg_path, argv, prune=True)
    want = applied(jprune_parser(), japply, argv, prune=True)
    shared = set(got) & set(want)
    assert {"model", "model_scale", "seed", "pruning_method", "prune_spec",
            "num_data_first_stage", "batch_size", "num_samples", "calib"} <= shared
    for k in shared:
        assert got[k] == want[k], k
    # the keys whose flag the port lacks are skipped, not set
    assert "host_stream" not in got and "eval_chunk" not in got


def test_prune_precedence_flag_over_options_over_yaml():
    got = applied(tprune_parser(), apply_cfg_path, PRUNE_ARGVS[2], prune=True)
    assert got["prune_spec"] == "12-0.6-1.0-1.0"  # the flag, over the YAML's 1-0.6-1-1
    assert got["batch_size"] == 16  # the flag, over --options and the YAML's 8
    assert got["max_sparsity_per_layer"] == 0.5 and got["model"] == "clip"  # the YAML
    got = applied(tprune_parser(), apply_cfg_path, PRUNE_ARGVS[1], prune=True)
    assert got["num_data_first_stage"] == 16 and got["seed"] == 3  # --options
    assert got["model_scale"] == "tiny" and got["num_samples"] == 128


@pytest.mark.parametrize("argv", EVAL_ARGVS, ids=lambda a: a[1].split("/")[-1])
def test_eval_cli_applies_the_yaml_as_the_jax_cli(argv):
    got = applied(teval_parser(), apply_cfg_path, argv)
    want = applied(jeval_parser(), japply, argv)
    shared = set(got) & set(want)
    assert {"model", "task", "batch_size", "num_beams", "seed", "output_dir"} <= shared
    for k in shared:
        assert got[k] == want[k], k


def test_eval_cli_maps_tasks_and_build_info_paths(tmp_path):
    yml = tmp_path / "x.yaml"
    yml.write_text("model:\n  arch: clip\ndatasets:\n  imagenet:\n    build_info:\n"
                   "      vis_root: /data/val\n      ann_path: a.json\n"
                   "run:\n  task: multimodal_classification\n")
    got = applied(teval_parser(), apply_cfg_path, ["--cfg-path", str(yml)])
    assert got["task"] == "classification" and got["vis_root"] == "/data/val"
    assert got["ann"] == "a.json"
    got = applied(tprune_parser(), apply_cfg_path, ["--cfg-path", str(yml)], prune=True)
    assert got["calib"] == "a.json" and "task" not in got


def test_the_t5_yaml_prunes_through_the_port_cli(tmp_path):
    """The shipped standalone-T5 YAML, cut to tiny by ``--options``: the
    YAML's pruner, spec, granularity, score and cap reach the run."""
    res = tprune(["--cfg-path", "t5/c4_prefix_derivative_compute.yaml", "--options",
                  "model.model_scale=tiny", "prune.num_samples=8", "prune.batch_size=4",
                  "prune.num_data_first_stage=8", "--device", "cpu",
                  "--output_dir", str(tmp_path)])
    assert res["job_id"] == "t5_wanda_pruner_24-0.5-1.0-1.0_MEZO-GradOnly_avg_block"
    assert len(res["leaf_scores"]) == 2 * 7 + 2 * 11
    assert abs(res["prunable_sparsity"] - 0.5) < 0.02


@pytest.mark.parametrize("cfg,where", [
    ("blip2/eval/caption_coco_opt2.7b_eval.yaml", "no mid-scale preset for blip2_opt"),
    ("blip2/eval/ret_coco_eval.yaml", "blip2_qformer retrieval: only --model_scale tiny")])
def test_a_yaml_of_an_unported_family_reaches_the_not_ported_error(tmp_path, cfg, where):
    """The evaluation YAMLs of BLIP-2 OPT and the stage-1 Q-Former reach
    their evaluate branches (shown by the JAX CLI's refusals of a scale that
    branch has no model for, before any model is built); the prune CLI,
    which has neither family, names the roadmap."""
    with pytest.raises(SystemExit, match=where):
        teval(["--cfg-path", cfg, "--options", "model.model_scale=small", "--device", "cpu",
               "--output_dir", str(tmp_path)])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tprune(["--cfg-path", cfg, "--device", "cpu", "--output_dir", str(tmp_path)])


def test_without_a_model_the_clis_ask_for_one(tmp_path):
    with pytest.raises(SystemExit):
        tprune(["--device", "cpu", "--output_dir", str(tmp_path)])
    with pytest.raises(SystemExit):
        teval(["--device", "cpu", "--model", "t5", "--output_dir", str(tmp_path)])
