"""``--cfg-path``: the reference's file-level launch API (the port's own copy
of ``ecoflap_tpu/core/project.py``; reference LAVIS/lavis/common/config.py:
16-144).

A project YAML under ``configs/projects/`` (``model:``/``datasets:``/
``run:`` trees, and for the prune CLI an optional ``prune:`` tree of its
flags) is loaded through ``core.config.Config`` and mapped onto the parsed
args. Precedence: explicit CLI flag > ``--options`` dot-list > project YAML >
parser default. "Explicit" is read from argv, so the parsers are built with
``allow_abbrev=False``: an abbreviated flag would not count as typed.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional, Sequence

from ecoflap_tpu_torch.core.config import Config

# reference task registry names -> the CLIs' --task values
_TASK_ALIASES = {
    "multimodal_classification": "classification",
    "image_text_pretrain": None,  # calibration-only configs: no eval task
    "language_modeling": None,
}

# dotted YAML key -> args attribute, for both CLIs where the attribute exists
_COMMON_MAP = {
    "model.arch": "model",
    "model.model_scale": "model_scale",
    "run.seed": "seed",
    "run.output_dir": "output_dir",
    "run.batch_size_eval": "batch_size",
    "run.num_beams": "num_beams",
    "run.max_len": "max_new_tokens",
    "run.length_penalty": "length_penalty",
    "run.tokenizer_path": "tokenizer_path",
}

# the prune CLI's prune: tree (the reference passes these as flags)
_PRUNE_MAP = {
    "prune.pruning_method": "pruning_method",
    "prune.prune_spec": "prune_spec",
    "prune.t5_prune_spec": "t5_prune_spec",
    "prune.vit_prune_spec": "vit_prune_spec",
    "prune.sparsity_ratio_granularity": "sparsity_ratio_granularity",
    "prune.max_sparsity_per_layer": "max_sparsity_per_layer",
    "prune.score_method": "score_method",
    "prune.num_data_first_stage": "num_data_first_stage",
    "prune.num_noise": "num_noise",
    "prune.noise_eps": "noise_eps",
    "prune.sparsity_type": "sparsity_type",
    "prune.num_samples": "num_samples",
    "prune.batch_size": "batch_size",
    "prune.eval_chunk": "eval_chunk",
    "prune.host_stream": "host_stream",
}


def projects_root() -> str:
    """The shipped config tree, ``<repo>/configs/projects``."""
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "configs", "projects")


def resolve_cfg_path(path: str) -> str:
    """A path as given, or relative to the shipped tree
    (``t5/c4_prefix_derivative_compute.yaml`` works from anywhere)."""
    if os.path.exists(path):
        return path
    shipped = os.path.join(projects_root(), path)
    if os.path.exists(shipped):
        return shipped
    raise FileNotFoundError(
        f"--cfg-path {path!r}: not a file and not under {projects_root()!r}")


def _explicit_flags(argv: Optional[Sequence[str]]) -> set:
    out = set()
    for a in argv or []:
        if a.startswith("--"):
            out.add(a[2:].split("=", 1)[0].replace("-", "_"))
    return out


def apply_cfg_path(args, argv: Optional[Sequence[str]],
                   prune: bool = False) -> Optional[Config]:
    """Merge ``--cfg-path`` and ``--options`` into ``args`` in place and
    return the merged Config (None without ``--cfg-path``). A key whose
    attribute the CLI lacks is skipped."""
    if not getattr(args, "cfg_path", None):
        return None
    cfg = Config(resolve_cfg_path(args.cfg_path), options=getattr(args, "options", None))
    explicit = _explicit_flags(argv)

    mapping: Dict[str, str] = dict(_COMMON_MAP)
    if prune:
        mapping.update(_PRUNE_MAP)
    for dotted, attr in mapping.items():
        if not hasattr(args, attr) or attr in explicit:
            continue
        val = cfg.get(dotted)
        if val is not None:
            setattr(args, attr, val)

    task = cfg.get("run.task")
    if task is not None and hasattr(args, "task") and "task" not in explicit:
        mapped = _TASK_ALIASES.get(task, task)
        if mapped is not None:
            args.task = mapped

    # the first dataset's build_info carries local paths; each maps to the
    # first attribute the CLI defines (the evaluate CLI's --ann, the prune
    # CLI's --calib), never dropped silently
    ds_cfg: Dict[str, Any] = cfg.datasets_cfg or {}
    if ds_cfg:
        _, spec = next(iter(ds_cfg.items()))
        info = (spec or {}).get("build_info", {}) or {}
        path_map = (("ann_path", ("ann", "calib")),
                    ("text_path", ("ann", "calib")),
                    ("jsonl_path", ("ann", "calib")),
                    ("vis_root", ("vis_root",)))
        for key, attrs in path_map:
            if key not in info:
                continue
            attr = next((a for a in attrs if hasattr(args, a)), None)
            if attr is not None and attr not in explicit:
                setattr(args, attr, info[key])
    return cfg
