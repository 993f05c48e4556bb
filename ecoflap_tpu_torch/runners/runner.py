"""The evaluation loop and the pruning artifacts (port of
``ecoflap_tpu/runners/runner.py``'s evaluation and its three savers;
reference runner_base.py:419-428 and evaluate_blip.py:438-472): a task's
metrics, logged as one JSON line each to ``evaluate.txt``;
``sparsity_dict/<job>.yaml`` under the reference keys,
``training_statistics/<job>.yaml`` with the wall clock and the card's peak
memory, and the pruned model as ``pruned_checkpoint/<job>.pth``.

The files are flat ``key: value`` YAML written as PyYAML's ``safe_dump``
writes them (sorted keys, floats with a dot), so no YAML package is needed.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Mapping, Optional

import torch

from ecoflap_tpu_torch.utils.checkpoint import save_torch_checkpoint


def _yaml_scalar(v: Any) -> str:
    if isinstance(v, float):
        # PyYAML writes 1e-05 as 1.0e-05: YAML 1.1 reads a float only with a dot
        s = repr(v)
        return s.replace("e", ".0e", 1) if "." not in s and "e" in s else s
    return str(v)


def write_flat_yaml(path: str, data: Mapping[str, Any]) -> None:
    with open(path, "w") as f:
        for k in sorted(data):
            f.write(f"{k}: {_yaml_scalar(data[k])}\n")


def read_flat_yaml(path: str) -> Dict[str, float]:
    """Read a flat ``key: number`` YAML such as a saved sparsity dict."""
    out: Dict[str, float] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if line:
                k, v = line.split(":", 1)
                out[k.strip()] = float(v)
    return out


class Runner:
    def __init__(self, output_dir: str = "output", job_id: str = "job"):
        self.output_dir = output_dir
        self.job_id = job_id
        os.makedirs(output_dir, exist_ok=True)

    # -- evaluation (runner.py:38-66) -------------------------------------------

    def evaluate(self, task, data, split: str = "val", **extra: Any) -> Dict[str, Any]:
        """The task's metrics over ``data``, with the wall and ``extra``,
        logged under ``split``."""
        t0 = time.time()
        metrics = task.evaluation(data)
        metrics["eval_time_s"] = round(time.time() - t0, 2)
        metrics.update(extra)
        self.log_metrics(metrics, split=split)
        return metrics

    def evaluate_splits(self, task, split_data: Mapping[str, Any],
                        cur_epoch: Any = "best") -> Dict[str, Dict[str, Any]]:
        """One evaluation per test split, each logged under its split's
        name (RunnerBase.evaluate, runner_base.py:419-428)."""
        return {name: self.evaluate(task, data, split=name, epoch=cur_epoch)
                for name, data in split_data.items()}

    def log_metrics(self, metrics: Mapping[str, Any], split: str = "val") -> None:
        """Append ``{split: metrics}`` as a JSON line to ``evaluate.txt``
        (the reference's vqa.py:178-181 convention)."""
        with open(os.path.join(self.output_dir, "evaluate.txt"), "a") as f:
            f.write(json.dumps({split: dict(metrics)}) + "\n")

    # -- pruning artifacts --------------------------------------------------------

    def _path(self, sub: str) -> str:
        d = os.path.join(self.output_dir, sub)
        os.makedirs(d, exist_ok=True)
        return os.path.join(d, f"{self.job_id}.yaml")

    def save_sparsity_dict(self, sparsity_dict: Optional[Mapping[str, float]]
                           ) -> Optional[str]:
        if sparsity_dict is None:
            return None
        path = self._path("sparsity_dict")
        write_flat_yaml(path, {k: float(v) for k, v in sparsity_dict.items()})
        return path

    def save_pruned_torch(self, state_dict: Mapping[str, torch.Tensor],
                          name: Optional[str] = None) -> str:
        """The reference-named ``.pth`` under ``pruned_checkpoint/``
        (runner.py:117-126)."""
        d = os.path.join(self.output_dir, "pruned_checkpoint")
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"{name or self.job_id}.pth")
        save_torch_checkpoint(state_dict, path)
        return path

    def save_training_statistics(self, wall_clock_s: float,
                                 device: torch.device) -> str:
        stats: Dict[str, Any] = {"spent_time": round(wall_clock_s, 1)}
        if device.type == "cuda":
            stats["max_memory_GiB"] = round(
                torch.cuda.max_memory_allocated(device) / 2 ** 30, 2)
        path = self._path("training_statistics")
        write_flat_yaml(path, stats)
        return path


def global_sparsity(weights) -> float:
    """sum(w == 0) / sum(numel) over the given tensors (evaluate_blip.py:432-436)."""
    zeros = total = 0
    for w in weights:
        zeros += int((w == 0).sum())
        total += w.numel()
    return zeros / max(total, 1)
